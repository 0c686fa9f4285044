"""The pod's live ingest and host tail on the CPU, and the JAX pod faults
the port does not copy:

* a live shortfall: the JAX ``ChannelStore`` pulls the window start back
  into samples it already handed out (a late channel decodes stale
  data); the port's window stays put and is zero where nothing arrived;
* a slow file channel behind ``ThreadedIngest``: the JAX store reports a
  shortfall after its timeout; the port's waits for the reader;
* a BCH-dirty codeword after LDPC convergence: the JAX pod hands its
  bytes to the TS unrepaired; the port corrects it;
* ``PodMonitor`` on a freshly booted host: the JAX panel skips its first
  render; the port's renders.
"""
import threading
import time

import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.parallel import pod as jpod
from sdr_receiver_dvb_t2_tpu_torch.io.bbframe import BBFrameParser
from sdr_receiver_dvb_t2_tpu_torch.parallel import acquire, pod
from sdr_receiver_dvb_t2_tpu_torch.params.modes import SAMPLE_RATE

from _port_capture import ts_in_stream
from _torch_common import (POD_MODE, POD_RATE, assert_ts_match, collect_ts,
                           cpu_mesh, mode_pair, pod_channels, pod_tx)

DEV_PER_ELEM = POD_RATE / SAMPLE_RATE


def _ramp(n, c=0):
    return (np.arange(n) + 1j * c).astype(np.complex64)


@pytest.mark.parametrize("store_kind", ["channel_store", "array_store"])
def test_window_never_moves_into_consumed_samples(store_kind):
    """The window of a channel that is behind (its samples not all there
    yet) keeps its position: held samples at their offsets, zeros after
    them.  The JAX stores move it back and return samples from before the
    requested position."""
    data = _ramp(1000)
    if store_kind == "channel_store":
        stores = []
        for mod in (jpod, pod):
            st = mod.ChannelStore(1)
            st.append(0, data)
            stores.append(st)
    else:
        stores = [jpod._ArrayStore(data[None]), pod._ArrayStore(data[None])]
    jst, st = stores
    want = np.empty(200, np.complex64)
    got = np.empty(200, np.complex64)
    assert jst.window_into(0, 900, 200, want) == 200      # stale
    np.testing.assert_array_equal(want, data[800:1000])
    assert st.window_into(0, 900, 200, got) == 100
    np.testing.assert_array_equal(got[:100], data[900:])
    assert not got[100:].any()
    # wholly past the end: zeros; wholly inside: the samples
    assert st.window_into(0, 1500, 50, got) == 0 and not got[:50].any()
    assert st.window_into(0, 10, 50, got) == 50
    np.testing.assert_array_equal(got[:50], data[10:60])


def test_window_zero_before_trimmed_base():
    st = pod.ChannelStore(1)
    st.POOL_BLK = 256
    st.append(0, _ramp(1024))
    st.trim_before(0, 512)
    assert st.base(0) == 512 and st.held(0) == 512
    out = np.empty(100, np.complex64)
    assert st.window_into(0, 462, 100, out) == 50
    assert not out[:50].any()
    np.testing.assert_array_equal(out[50:], _ramp(1024)[512:562])


def _slow_reader(data, delay):
    pos = [0]

    def read(n):
        time.sleep(delay)
        a = pos[0]
        if a >= len(data):
            return None
        pos[0] = a + n
        return data[a:a + n]
    return read


def test_threaded_file_channel_waits_for_a_slow_reader():
    """eof_on_none=True (a file or capture): ensure() waits past its
    timeout for a slow reader and reports False only at the end."""
    data = _ramp(4096)
    kw = dict(fmts=["c64"], eof_on_none=True, timeout=0.05, chunk=1024)
    jst = jpod.ThreadedIngest([_slow_reader(data, 0.2)], **kw)
    st = pod.ThreadedIngest([_slow_reader(data, 0.2)], **kw)
    try:
        assert jst.ensure(0, 3000) and jst.end(0) < 3000   # the shortfall
        assert st.ensure(0, 3000) and st.end(0) >= 3000
        out = np.empty(3000, np.complex64)
        assert st.window_into(0, 0, 3000, out) == 3000
        np.testing.assert_array_equal(out, data[:3000])
        assert not st.ensure(0, 5000)                      # true end
        assert st.end(0) == 4096
    finally:
        jst.close()
        st.close()


def test_threaded_live_channel_reports_a_shortfall():
    """eof_on_none=False (a socket): a silent reader times out into a
    shortfall (True), so that the pod keeps running."""
    st = pod.ThreadedIngest([lambda n: None], fmts=["c64"],
                            eof_on_none=False, timeout=0.1)
    try:
        t0 = time.monotonic()
        assert st.ensure(0, 1000) and st.end(0) == 0
        assert time.monotonic() - t0 < 2.0
    finally:
        st.close()


def test_live_channel_store_stream():
    """LIVE ingest through ChannelStore readers: the pod pulls chunks on
    demand, trims consumed raw (bounded memory), and decodes TS-exact
    with tracking on."""
    iq, ts, _ = pod_tx(8, seed=29)
    raw = pod_channels(iq, 2, [500, 1200], cfo_hz=3e3, seed=6)
    lock = acquire.blind_acquire(raw[:, :1_000_000], POD_RATE,
                                 device="cpu")
    assert lock is not None
    rx = pod.MultiChannelReceiver(lock.cfg, cpu_mesh(2, 2))
    chunk, pos = 65536, [0, 0]

    def reader(c):
        def read():
            a = pos[c]
            if a >= raw.shape[1]:
                return None
            pos[c] = a + chunk
            return raw[c, a:a + chunk]
        return read

    store = pod.ChannelStore(2, readers=[reader(0), reader(1)])
    parsers = [BBFrameParser() for _ in range(2)]
    out, peak_held = [[], []], 0
    for hard, stats in rx.stream(store, lock.pos0 + lock.mu0, lock.step,
                                 freq=lock.freq, max_steps=3, track=True):
        assert stats["bch_dirty"] == 0, stats
        collect_ts(parsers, hard, lock.cfg.plp.k_bch, out)
        peak_held = max(peak_held, max(store.held(c) for c in range(2)))
    win = rx.rx.window_len(lock.step)
    assert peak_held <= (rx.n_time + 3) * win + 2 * chunk, peak_held
    for c in range(2):
        assert_ts_match(np.concatenate(out[c]).tobytes(), ts.tobytes(),
                        188 * 20, f"live ch{c}")


def test_threaded_ingest_silent_channel_relocks():
    """A live channel whose reader goes SILENT (None = receive timeout)
    neither stalls nor ends the pod: its windows fill with zeros, it is
    declared dead, and it relocks when delivery resumes, while the other
    channel streams TS-exact throughout."""
    iq, ts, _ = pod_tx(14, seed=61)
    fs = mode_pair(POD_MODE)[0].frame_samples
    raw = pod_channels(iq, 2, [600, 900], tail=60_000)
    lock = acquire.blind_acquire(raw[:, :3 * int(fs * DEV_PER_ELEM)],
                                 POD_RATE, device="cpu")
    assert lock is not None
    rx = pod.MultiChannelReceiver(lock.cfg, cpu_mesh(2, 1))
    silent_at = int(7 * fs * DEV_PER_ELEM)
    resume = threading.Event()
    pos = [0, 0]

    def reader(c):
        def read(n):
            a = pos[c]
            if a >= raw.shape[1]:
                return None                      # a true end
            if c == 1 and a >= silent_at and not resume.is_set():
                time.sleep(0.02)                 # like a socket timeout
                return None
            pos[c] = a + n
            return raw[c, a:a + n]
        return read

    store = pod.ThreadedIngest([reader(0), reader(1)], fmts=["c64"] * 2,
                               eof_on_none=[True, False], timeout=0.2)
    parsers = [BBFrameParser() for _ in range(2)]
    out, alive_hist, events, went_dead = [[], []], [], [], False
    try:
        for hard, stats in rx.stream(store, lock.pos0 + lock.mu0,
                                     lock.step, freq=lock.freq,
                                     relock=True, dead_after=2):
            alive_hist.append(stats["alive"].tolist())
            events += stats["events"]
            step_out = [[], []]
            collect_ts(parsers, hard, lock.cfg.plp.k_bch, step_out)
            if stats["alive"][0]:
                out[0] += step_out[0]
            if not stats["alive"][1] and not went_dead:
                went_dead = True
                resume.set()                     # the antenna comes back
    finally:
        store.close()
    assert went_dead, alive_hist
    assert all(a[0] for a in alive_hist), "live channel stalled"
    assert any(e.startswith("relock: ch1 dead") for e in events), events
    assert any(e.startswith("relock: ch1 reacquired") for e in events), \
        events
    assert alive_hist[-1][1], alive_hist
    assert_ts_match(np.concatenate(out[0]).tobytes(), ts.tobytes(),
                    188 * 40, "threaded ch0")


# ---------------------------------------------------------------------------
# a BCH-dirty codeword after LDPC convergence
# ---------------------------------------------------------------------------
FLIPS = (800, 1600, 2400)      # BB data-field bits of the codeword hit


def _dirty_codeword_llrs(bch_word: np.ndarray, table: str) -> np.ndarray:
    """Kernel-ordered int8 LLRs of the valid LDPC codeword whose BCH word
    is ``bch_word`` with the FLIPS bits inverted: the LDPC converges on
    it at once, and the BCH syndrome is not zero."""
    from sdr_receiver_dvb_t2_tpu_torch.ops.ldpc import kernel_bit_order
    from sdr_receiver_dvb_t2_tpu_torch.params import ldpc as ldpc_par
    word = bch_word.copy()
    word[list(FLIPS)] ^= 1
    cw = ldpc_par.get_code(table).encode(word[None])[0]
    llr = (1 - 2 * cw.astype(np.int16)) * 100
    return llr[kernel_bit_order(table)].astype(np.int8)


@pytest.fixture(scope="module")
def dirty_case():
    iq, ts, _ = pod_tx(4, seed=71)
    raw = pod_channels(iq, 2, [500, 800])
    lock = acquire.blind_acquire(raw, POD_RATE, device="cpu")
    assert lock is not None
    aligned = lock.aligned(raw)
    # the true BCH word of codeword 1 (channel 0, frame 0) from a clean run
    rx = pod.MultiChannelReceiver(lock.cfg, cpu_mesh(1, 1))
    hard, stats = next(rx.stream(aligned, lock.mu0, lock.step,
                                 freq=lock.freq, max_steps=1))
    assert stats["bch_dirty"] == 0
    plp = lock.cfg.plp
    row = _dirty_codeword_llrs(hard[0, 0, 1], plp.ldpc_table_name)
    return lock, aligned, ts, row


def _one_step(rx, lock, aligned, parser):
    parsers = [parser(), parser()]
    out = [[], []]
    hard, stats = next(rx.stream(aligned, lock.mu0, lock.step,
                                 freq=lock.freq, max_steps=1))
    collect_ts(parsers, np.asarray(hard), lock.cfg.plp.k_bch, out)
    return [np.concatenate(o) for o in out], stats


def test_bch_dirty_codeword_is_corrected(dirty_case, monkeypatch):
    from sdr_receiver_dvb_t2_tpu_torch.ops import rx_chain
    lock, aligned, ts, row = dirty_case
    orig = rx_chain.packed_to_llr

    def hit(*a, **kw):
        llr, snr = orig(*a, **kw)
        llr = llr.clone()
        llr[1] = torch.from_numpy(row)
        return llr, snr

    monkeypatch.setattr(rx_chain, "packed_to_llr", hit)
    rx = pod.MultiChannelReceiver(lock.cfg, cpu_mesh(1, 1))
    got, stats = _one_step(rx, lock, aligned, BBFrameParser)
    res = stats["plp_results"][0]
    assert res.ldpc_ok.all() and res.ldpc_iters[0, 0, 1] == 1
    assert not res.bch_clean[0, 0, 1] and res.bch_clean.sum() == 7
    assert res.bch_corrected[0, 0, 1] == len(FLIPS)
    assert stats["bch_dirty"] == 1
    for c in range(2):
        assert len(got[c]) >= 188 * 10 and ts_in_stream(got[c], ts), c


def test_jax_pod_passes_the_dirty_codeword_on(dirty_case, monkeypatch):
    """The same codeword through the JAX pod: its TS carries the three
    wrong bits (the fault the port does not copy)."""
    import dataclasses
    import enum
    import jax.numpy as jnp
    from sdr_receiver_dvb_t2_tpu.io.bbframe import BBFrameParser as JParser
    from sdr_receiver_dvb_t2_tpu.ops import rx_chain as jrc
    from sdr_receiver_dvb_t2_tpu.parallel import sharding as jsh
    from sdr_receiver_dvb_t2_tpu.params import modes as jm
    lock, aligned, ts, row = dirty_case
    orig = jrc.packed_to_llr_t

    def hit(*a, **kw):
        llr_t, snr = orig(*a, **kw)
        return llr_t.at[:, 1].set(jnp.asarray(row)), snr

    def to_jax(obj):
        """The port's mode or PLP config as the JAX package's class."""
        kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
        for k, v in kw.items():
            if isinstance(v, enum.Enum):
                kw[k] = getattr(jm, type(v).__name__)[v.name]
        return getattr(jm, type(obj).__name__)(**kw)

    monkeypatch.setattr(jrc, "packed_to_llr_t", hit)
    c = lock.cfg
    jcfg = jsh.ShardedConfig(
        mode=to_jax(c.mode), plp=to_jax(c.plp),
        n_fec_per_frame=c.n_fec_per_frame, n_ti=c.n_ti,
        l1_post_cells=c.l1_post_cells, plp_start=c.plp_start, sfn=c.sfn,
        use_pallas=False)
    rx = jpod.MultiChannelReceiver(jcfg, jsh.make_mesh(1, 1))
    got, stats = _one_step(rx, lock, aligned, JParser)
    res = stats["plp_results"][0]
    assert res.ldpc_ok.all() and not res.bch_clean[0, 0, 1]
    assert not ts_in_stream(got[0], ts)          # three bits wrong
    assert ts_in_stream(got[1], ts)


# ---------------------------------------------------------------------------
# the pod panel
# ---------------------------------------------------------------------------
def _pod_stats():
    return dict(snr_db=21.5, alive=np.array([True, False]),
                snr_db_ch=np.array([21.5, 0.0]),
                bch_dirty_ch=np.array([0, 7]),
                relock_fail=np.array([0, 3]),
                events=["relock: ch1 exhausted 3 blind searches"])


def test_pod_monitor_renders_at_its_first_call(monkeypatch):
    """On a host up for less than the interval (time.monotonic() small),
    the first call renders; the JAX PodMonitor skips it."""
    import io
    from sdr_receiver_dvb_t2_tpu.runtime import monitor as jmon
    from sdr_receiver_dvb_t2_tpu_torch.runtime import monitor as mon
    monkeypatch.setattr(time, "monotonic", lambda: 5.0)
    jm = jmon.PodMonitor(interval=60.0, out=io.StringIO(), clear=False)
    assert not jm.maybe_render(_pod_stats(), np.array([120, 0]), 5)
    pm = mon.PodMonitor(interval=60.0, out=io.StringIO(), clear=False)
    assert pm.maybe_render(_pod_stats(), np.array([120, 0]), 5)
    panel = pm.out.getvalue()
    assert "pod monitor" in panel and "alive=1/2" in panel
    assert "DOWN" in panel and "up" in panel and "exhausted" in panel
    assert "pod snr" in panel
    # interval gating: an immediate second call skips; history grows
    assert not pm.maybe_render(_pod_stats(), np.array([1, 1]), 6)
    assert len(pm.snr_history) == 2 and pm.refreshes == 1
