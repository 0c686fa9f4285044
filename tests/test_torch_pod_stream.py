"""The tracked pod stream (parallel/pod.MultiChannelReceiver.stream)
against the JAX package's on the CPU: tests/test_mesh_blind.py's capture
(two channels with their own CFO, sampling-clock error and noise-only
lead), blind acquisition, then a tracked stream on a (2, 1) grid.  Each
channel's TS must equal the JAX pod's and be a run of the transmitted
stream; the per-channel loops must apply the same corrections.  The JAX
pod runs once (module fixture), its LDPC through the Pallas kernel in
interpret mode."""
import dataclasses

import numpy as np
import pytest

from sdr_receiver_dvb_t2_tpu.io.bbframe import BBFrameParser
from sdr_receiver_dvb_t2_tpu.models.channel import ChannelConfig, impair
from sdr_receiver_dvb_t2_tpu.parallel import acquire as jacq
from sdr_receiver_dvb_t2_tpu.parallel import pod as jpod
from sdr_receiver_dvb_t2_tpu.parallel import sharding as jsh
from sdr_receiver_dvb_t2_tpu_torch.io.bbframe import (
    BBFrameParser as PortParser)
from sdr_receiver_dvb_t2_tpu_torch.parallel import acquire, pod

from _torch_common import (POD_RATE, assert_ts_match, collect_ts, cpu_mesh,
                           pod_tx)

N_FRAMES, N_STEPS = 9, 7
# (cfo Hz, sro ppm, noise-only lead) per channel, as test_mesh_blind.py
IMPS = [(70.0, 2.0, 1311), (-110.0, -2.5, 2897)]


@pytest.fixture(scope="module")
def capture():
    rng = np.random.default_rng(5)
    rows, ts_in = [], []
    for c, (cfo, sro, lead) in enumerate(IMPS):
        iq, ts, _ = pod_tx(N_FRAMES, seed=900 + c)
        dev = impair(iq, ChannelConfig(device_rate=POD_RATE, snr_db=30.0,
                                       cfo_hz=cfo, sro_ppm=sro,
                                       seed=40 + c))
        pre = (0.003 * (rng.standard_normal(lead)
                        + 1j * rng.standard_normal(lead))
               ).astype(np.complex64)
        rows.append(np.concatenate([pre, dev]))
        ts_in.append(ts)
    n = min(len(r) for r in rows)
    return np.stack([r[:n] for r in rows]), ts_in


def _run(rx, lock, raw, parser):
    out = [[], []]
    parsers = [parser(), parser()]
    steps = []
    k_bch = rx.rx.plps[0].plp.k_bch
    for hard, stats in rx.stream(lock.aligned(raw), lock.mu0, lock.step,
                                 freq=lock.freq, max_steps=N_STEPS,
                                 track=True):
        collect_ts(parsers, np.asarray(hard), k_bch, out)
        steps.append(stats)
    return [np.concatenate(o).tobytes() for o in out], steps


@pytest.fixture(scope="module")
def streams(capture):
    raw, _ = capture
    jlock = jacq.blind_acquire(raw, POD_RATE)
    jrx = jpod.MultiChannelReceiver(
        dataclasses.replace(jlock.cfg, use_pallas=True), jsh.make_mesh(2, 1))
    plock = acquire.blind_acquire(raw, POD_RATE, device="cpu")
    prx = pod.MultiChannelReceiver(plock.cfg, cpu_mesh(2, 1))
    return (jlock, _run(jrx, jlock, raw, BBFrameParser),
            plock, _run(prx, plock, raw, PortParser))


def test_tracked_stream_matches_jax(streams, capture):
    _, ts_in = capture
    jlock, (jts, jsteps), plock, (pts, psteps) = streams
    np.testing.assert_array_equal(plock.pos0, jlock.pos0)
    assert len(psteps) == len(jsteps) == N_STEPS
    for c in range(2):
        assert pts[c] == jts[c], f"ch{c}: TS differs from the JAX pod's"
        assert_ts_match(pts[c], ts_in[c].tobytes(), 188 * 40, f"ch{c}")
    for js, ps in zip(jsteps, psteps):
        assert set(ps) == set(js)
        assert ps["bch_dirty"] == js["bch_dirty"]
        assert ps["ldpc_failures"] == js["ldpc_failures"]
        # the loops read discriminators that JAX computes from bf16 planes
        np.testing.assert_allclose(ps["cfo_hz_applied"],
                                   js["cfo_hz_applied"], rtol=0, atol=0.5)
        np.testing.assert_allclose(ps["sro_ppm_applied"],
                                   js["sro_ppm_applied"], rtol=0, atol=0.05)
        np.testing.assert_array_equal(ps["alive"], js["alive"])
        for k in ("snr_db_ch", "bch_dirty_ch", "ldpc_failures_ch",
                  "gi_cfo", "sro"):
            assert np.shape(ps[k]) == (2,), k
    # the clock loops pulled toward each channel's own error
    sro = psteps[-1]["sro_ppm_applied"]
    assert sro[0] > 0.5 and sro[1] < -0.5, sro
    assert sum(s["bch_dirty"] for s in psteps[2:]) == 0


# ---------------------------------------------------------------------------
# bits or bytes, and the step launched ahead
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_lock(capture):
    raw, _ = capture
    lock = acquire.blind_acquire(raw, POD_RATE, device="cpu")
    assert lock is not None
    return lock, lock.aligned(raw)


def _port_steps(lock, raw, **kw):
    """The port's stream with tracking, dynamic L1 and relock on: per step
    (what it yielded, stats, plane launches made by then), and the plane
    launches of the whole run."""
    rx = pod.MultiChannelReceiver(lock.cfg, cpu_mesh(2, 1))
    launches = [0]
    plane = rx.rx.plane_step_windows

    def counted(*a, **k):
        launches[0] += 1
        return plane(*a, **k)
    rx.rx.plane_step_windows = counted
    steps = [(np.array(out), stats, launches[0]) for out, stats in rx.stream(
        raw, lock.mu0, lock.step, freq=lock.freq, track=True, track_l1=True,
        relock=True, **kw)]
    return steps, launches[0]


def _assert_same_stats(a, b, where):
    assert set(a) == set(b), where
    for k in a:
        if k == "plp_results":
            for ra, rb in zip(a[k], b[k], strict=True):
                for f in dataclasses.fields(ra):
                    va, vb = getattr(ra, f.name), getattr(rb, f.name)
                    if isinstance(va, np.ndarray):
                        np.testing.assert_array_equal(va, vb, err_msg=where)
                    else:
                        assert va == vb, (where, f.name)
        elif k == "l1_post":
            assert repr(a[k]) == repr(b[k]), where
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")


@pytest.mark.parametrize("case", ["whole", "max_steps", "store_ends"])
def test_stream_bytes_are_the_bits_packed(port_lock, case):
    """stream(bits=False) yields the BB frames' bytes whose bits
    stream(bits=True) yields, step by step, with equal stats (tracking,
    frame_idx, events), over the whole capture, cut by max_steps, and on
    a capture that ends inside step 4's window.  Each step's plane is
    launched before the step before it is yielded, and none in vain: the
    run launches as many planes as it yields steps."""
    lock, raw = port_lock
    kw = {}
    if case == "max_steps":
        kw["max_steps"] = 3
    elif case == "store_ends":
        # four frames after the first frame start and half of the fifth
        # (a frame a step): step 4's window lacks samples, step 3's is
        # whole
        frame_raw = lock.cfg.mode.frame_samples * 2.0 * float(
            np.max(lock.step))
        raw = raw[:, :int(np.max(lock.mu0) + 4.5 * frame_raw)]
    bits, n_bits = _port_steps(lock, raw, **kw)
    packed, n_packed = _port_steps(lock, raw, bits=False, **kw)
    n = len(bits)
    assert len(packed) == n and n_bits == n_packed == n
    want = {"max_steps": 3, "store_ends": 4}.get(case)
    assert n == want if want else n >= 5, n
    for k, ((hard, sa, la), (bb, sb, lb)) in enumerate(zip(bits, packed)):
        assert bb.dtype == np.uint8 and bb.shape[1] == hard.shape[1]
        np.testing.assert_array_equal(np.unpackbits(bb, axis=-1), hard,
                                      err_msg=f"step {k}")
        np.testing.assert_array_equal(bb, sb["plp_results"][0].bb_bytes)
        _assert_same_stats(sa, sb, f"step {k}")
        # step k + 1's plane was launched before step k was yielded
        assert la == lb == min(k + 2, n), (k, la, lb)
    assert sum(s["bch_dirty"] for _, s, _ in bits[2:]) == 0


def _window_store(kind, n_ch, rng):
    """A store of n_ch channels of random samples of their own lengths
    (ChannelStore: appended in blocks that do not fit its granules, the
    first granules of the even channels trimmed) and what it holds:
    (store, [C] samples from absolute 0, base, end)."""
    lens = rng.integers(3 * pod.ChannelStore.POOL_BLK,
                        4 * pod.ChannelStore.POOL_BLK, n_ch)
    data = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64) for n in lens]
    if kind == "array":
        n = int(lens.min())
        return (pod._ArrayStore(np.stack([d[:n] for d in data])),
                [d[:n] for d in data], [0] * n_ch, [n] * n_ch)
    st = pod.ChannelStore(n_ch)
    for c, d in enumerate(data):
        for a in range(0, len(d), 70_001):
            st.append(c, d[a:a + 70_001])
        if c % 2 == 0:
            st.trim_before(c, 2 * pod.ChannelStore.POOL_BLK + 5)
    assert st.bytes_copied == 8 * int(lens.sum())
    return st, data, [st.base(c) for c in range(n_ch)], \
        [st.end(c) for c in range(n_ch)]


@pytest.mark.parametrize("kind,n_ch,workers,reps", [
    ("channels", 4, 0, 1), ("channels", 4, 3, 1), ("array", 4, 3, 1),
    # more channels and workers than the host's cores, threads switched
    # as often as the interpreter allows: a lost count would show
    ("channels", 16, 12, 8)])
def test_parallel_window_copy_is_the_serial_one(kind, n_ch, workers, reps):
    """_copy_windows on a pool fills the staging buffer as window_into a
    window at a time does, from the samples held: a window across
    granules, one that runs past the store's end (short), one that starts
    before its base (short, zeros where trimmed); the store's
    bytes_copied counts exactly the samples copied."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.default_rng(n_ch + workers)
    st, data, base, end = _window_store(kind, n_ch, rng)
    win, blk = 150_000, pod.ChannelStore.POOL_BLK
    w0 = np.stack([[blk - 1000, end[c] - 1000, base[c] - 777, 3 * blk // 2]
                   for c in range(n_ch)]).astype(np.int64)
    want = np.zeros((n_ch, w0.shape[1], win), np.complex64)
    want_short = np.zeros(w0.shape, bool)
    held = 0
    for c in range(n_ch):
        for t, a in enumerate(w0[c]):
            lo, hi = max(a, base[c]), min(a + win, end[c])
            want[c, t, lo - a:hi - a] = data[c][lo:hi]
            want_short[c, t] = hi - lo < win
            held += max(0, hi - lo)
    # whole windows across granules, and short ones
    assert want_short.any() and not want_short.all()
    before = st.bytes_copied if kind == "channels" else 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max(1, workers)) as pool:
            for _ in range(reps):
                buf = np.full(want.shape, np.nan, np.complex64)
                short = pod._copy_windows(st, w0, win, buf,
                                          pool if workers else None)
                np.testing.assert_array_equal(buf, want)
                np.testing.assert_array_equal(short, want_short)
    finally:
        sys.setswitchinterval(old)
    if kind == "channels":
        assert st.bytes_copied - before == 8 * held * reps
