"""The port's sharded receive step (parallel/sharding.py) against the JAX
package's on the CPU: the host bookkeeping, the batched front end, the
plane stage on a (1, 2) grid with the halo and on a (2, 2) grid of
windows, and the fec stage.

Inputs: the JAX pod tests' 2K capture (tests/test_sharded.py,
test_pod_parity.py), made once by the JAX package's transmitter and
channel and fed as the same numpy arrays to both packages.  The JAX
receiver runs on the conftest's virtual CPU devices, its LDPC through the
Pallas kernel in interpret mode (``use_pallas=True``), so that hard bits,
``ok``, ``iters`` and ``clean`` can be held exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.models.channel import ChannelConfig, impair
from sdr_receiver_dvb_t2_tpu.ops import cplx, rx_chain as jrc
from sdr_receiver_dvb_t2_tpu.parallel import acquire as jacq
from sdr_receiver_dvb_t2_tpu.parallel import sharding as jsh
from sdr_receiver_dvb_t2_tpu.params.modes import SAMPLE_RATE
from sdr_receiver_dvb_t2_tpu.runtime import acquisition as jacquisition
from sdr_receiver_dvb_t2_tpu_torch.ops import frontend as fe, rx_chain
from sdr_receiver_dvb_t2_tpu_torch.parallel import acquire, sharding
from sdr_receiver_dvb_t2_tpu_torch.runtime import acquisition

from _torch_common import (POD_MODE, POD_PLP, POD_RATE, cpu_mesh,
                           mode_pair, plp_pair, pod_tx)

STEP = POD_RATE / (2 * SAMPLE_RATE)
RATIO = SAMPLE_RATE / POD_RATE


def _configs(l1_post_cells=0):
    jmode, tmode = mode_pair(POD_MODE)
    jplp, tplp = plp_pair(POD_PLP)
    base = dict(n_fec_per_frame=4, n_ti=1, l1_post_cells=l1_post_cells,
                frames_per_shard=1)
    return (jsh.ShardedConfig(mode=jmode, plp=jplp, use_pallas=True, **base),
            sharding.ShardedConfig(mode=tmode, plp=tplp, **base))


def _receivers(n_ch, n_time, l1_post_cells=0):
    jcfg, tcfg = _configs(l1_post_cells)
    return (jsh.ShardedReceiver(jcfg, jsh.make_mesh(n_ch, n_time)),
            sharding.ShardedReceiver(tcfg, cpu_mesh(n_ch, n_time)))


@pytest.mark.parametrize("n_ch,n_time", [(1, 4), (2, 2), (2, 1)])
def test_host_bookkeeping_equals_jax(n_ch, n_time):
    """raw_block_for, window_len, host_bases, host_bases_windows and the
    per-channel step split: float64 host numpy, held equal."""
    jrx, prx = _receivers(n_ch, n_time)
    assert (jrx.k_loc, jrx.n_up, jrx.hb_delay_grid) == (
        prx.k_loc, prx.n_up, prx.hb_delay_grid)
    step = STEP * (1 + 43e-6)
    rb = jrx.raw_block_for(step)
    assert rb == prx.raw_block_for(step)
    assert jrx.window_len(step) == prx.window_len(step)
    rng = np.random.default_rng(n_ch * 10 + n_time)
    c = 2 * n_ch                          # two channels a grid row
    cases = [(3.21, step, 1.0, 0.01, None),
             (rng.uniform(32, 40, c), STEP * (1 + rng.uniform(-2e-5, 2e-5, c)),
              rng.uniform(0, 6, c), rng.uniform(-0.03, 0.03, c), c)]
    for mu, st, ph, fr, nc in cases:
        for a, b in zip(jrx.host_bases(mu, st, ph, fr, rb, n_channels=nc),
                        prx.host_bases(mu, st, ph, fr, rb, n_channels=nc)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    r0 = rng.uniform(32, 2e6, (c, n_time))
    st = STEP * (1 + rng.uniform(-2e-5, 2e-5, c))
    args = (r0, st, rng.uniform(0, 6, c), rng.uniform(-0.03, 0.03, c))
    for a, b in zip(jrx.host_bases_windows(*args),
                    prx.host_bases_windows(*args)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jrx._normalize_state(c, args[3], st),
                    prx._normalize_state(c, args[3], st)):
        np.testing.assert_array_equal(a, b)


def test_make_mesh_and_pod_mesh():
    from sdr_receiver_dvb_t2_tpu_torch.parallel import pod
    mesh = cpu_mesh(2, 2)
    assert mesh.shape == {"ch": 2, "time": 2}
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    with pytest.raises(ValueError, match="4 devices needed, 3 available"):
        sharding.make_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="needed"):
        pod.pod_mesh(2, 1, devices=["cpu"])
    assert pod.pod_mesh(2, 1, devices=["cpu"] * 2).shape["ch"] == 2
    if not torch.cuda.is_available():
        # the grid's devices default to the visible CUDA devices
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh(1, 1)
        with pytest.raises(ValueError, match="64 devices needed"):
            pod.pod_64ch_mesh()


# ---------------------------------------------------------------------------
# the batched front end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def capture():
    """Two channels of a 4-frame signal, ch1 with a 2 kHz CFO; no lead, so
    that the frame starts where test_sharded.py's analytic alignment puts
    it.  Returns (raw [2, N], l1_post_cells, per-channel NCO freq)."""
    iq, _, tx = pod_tx(4, seed=100)
    rows = [impair(iq, ChannelConfig(device_rate=POD_RATE, snr_db=30.0,
                                     cfo_hz=cfo, seed=40 + c))
            for c, cfo in enumerate((0.0, 2e3))]
    n = min(len(r) for r in rows)
    freq = np.array([0.0, 2 * np.pi * 2e3 / POD_RATE])
    return (np.stack([r[:n] for r in rows]).astype(np.complex64),
            tx.l1_pre.l1_post_size, freq)


def _rows_case(capture, n_rows=4):
    """Raw windows with per-row NCO and resampler state."""
    raw, _, _ = capture
    _, prx = _receivers(1, 1)
    win = prx.window_len(STEP)
    rng = np.random.default_rng(5)
    w = rng.integers(0, raw.shape[1] - win, n_rows)
    x = np.stack([raw[r % 2, a:a + win] for r, a in enumerate(w)])
    r0 = 32 + rng.uniform(0, 1, (n_rows, 1))
    steps = STEP * (1 + rng.uniform(-2e-5, 2e-5, n_rows))
    freq = rng.uniform(-0.02, 0.02, n_rows)
    _, idx0, frac0, phase0 = prx.host_bases_windows(
        r0, steps, rng.uniform(0, 6, n_rows), freq)
    fq, s_hi, s_lo = (np.array(a) for a in
                      prx._normalize_state(n_rows, freq, steps))
    return prx, x, idx0[:, 0], frac0[:, 0], phase0[:, 0], fq, s_hi, s_lo


def test_front_end_matches_jax(capture):
    """The batched front end (one grouped conv1d over all rows, one
    Farrow gather) against the JAX per-shard front end (a vmapped plain
    function) on the same rows: within 1e-5 of the output's rms."""
    prx, x, idx0, frac0, phase0, fq, s_hi, s_lo = _rows_case(capture)
    jrx, _ = _receivers(1, 1)
    want = jrx._front_end(
        cplx.from_np(x), jnp.asarray(idx0), jnp.asarray(frac0),
        jnp.asarray(phase0), jnp.asarray(fq), jnp.asarray(s_hi),
        jnp.asarray(s_lo), jnp.asarray(jrx.taps), jnp.asarray(jrx.hb_taps))
    want = np.asarray(want.re) + 1j * np.asarray(want.im)
    t = torch.from_numpy
    got = sharding.front_end(
        t(x), t(idx0), t(frac0), t(phase0), t(fq), t(s_hi), t(s_lo),
        t(prx.taps), t(prx.hb_taps), prx.n_up, prx.k_loc).numpy()
    assert got.shape == want.shape == (len(x), prx.k_loc)
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert np.max(np.abs(got - want)) < 1e-5 * rms


def test_front_end_rows_equal_single_streams(capture):
    """Each row of the batched call is the 1-D stream calls on that row
    with its own scalar state (which the stream and P1 keep using)."""
    prx, x, idx0, frac0, phase0, fq, s_hi, s_lo = _rows_case(capture)
    t = torch.from_numpy
    fir, hb = t(prx.taps), t(prx.hb_taps)
    got = sharding.front_end(t(x), t(idx0), t(frac0), t(phase0), t(fq),
                             t(s_hi), t(s_lo), fir, hb, prx.n_up,
                             prx.k_loc).numpy()
    z = lambda n: torch.zeros(n, dtype=torch.complex64)  # noqa: E731
    for r in range(len(x)):
        y = fe.nco_derotate(t(x[r]), phase0[r], fq[r])[0]
        y = fe.upsample2(y, z(len(hb) - 1), hb)[0]
        y = fe.upsample2(y, z(len(hb) - 1), hb)[0]
        mu0 = np.float32(frac0[r]) + np.float32(idx0[r])
        up = fe.farrow_resample(y, mu0, s_hi[r], s_lo[r], prx.n_up)
        up = up[:2 * prx.k_loc + prx.n_taps - 1]
        e = fe.fir_decimate2(up[prx.n_taps - 1:], up[:prx.n_taps - 1],
                             fir)[0].numpy()
        np.testing.assert_allclose(got[r], e, rtol=0,
                                   atol=1e-6 * np.abs(e).max())


def test_frontend_elem_matches_jax(capture):
    raw, _, _ = capture
    args = (raw[1, 5000:200_000], 32.7, STEP * (1 + 1e-5), 0.013, 60_000)
    want = jacq.frontend_elem(*args)
    got = acquire.frontend_elem(*args, device="cpu")
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-5 * rms


# ---------------------------------------------------------------------------
# the plane and fec stages
# ---------------------------------------------------------------------------
def _unpack(packed) -> np.ndarray:
    """The JAX plane's u32 words (bf16 halves) as complex64."""
    g = np.asarray(packed).astype(np.uint32)
    re = ((g >> np.uint32(16)) << np.uint32(16)).view(np.float32)
    im = ((g & np.uint32(0xFFFF)) << np.uint32(16)).view(np.float32)
    return (re + 1j * im).astype(np.complex64)


@pytest.fixture(scope="module")
def planes(capture):
    """Both packages' plane stage on the contiguous (1, 2) grid (with the
    halo) and on the (2, 2) grid of windows, two channels each."""
    raw, l1_post, freq = capture
    out = {}
    # contiguous: test_sharded.py's alignment (elementary sample 0 is the
    # frame start of the impaired capture)
    jrx, prx = _receivers(1, 2, l1_post)
    rb = prx.raw_block_for(STEP)
    mu = ((prx.n_taps - 1) / 4.0 - 1.0) / RATIO
    bases = prx.host_bases(mu, STEP, 0.0, freq, rb, n_channels=2)
    x = np.ascontiguousarray(raw[:, :2 * rb])
    out["contiguous"] = (jrx.plane_step(x, *bases, freq, STEP),
                         prx.plane_step(x, *bases, freq, STEP), jrx, prx)
    # windows: frame 1 onwards (test_pod_parity.py's alignment)
    jrx, prx = _receivers(2, 2, l1_post)
    mu_base = ((prx.n_taps - 1) / 4.0 - 1.0) / RATIO
    r0 = mu_base + prx.mode.frame_samples / RATIO * np.array([[1.0, 2.0]])
    w0, idx0, frac0, phase0 = prx.host_bases_windows(
        np.repeat(r0, 2, axis=0), STEP, 0.0, freq)
    win = prx.window_len(STEP)
    xw = np.stack([[raw[c, a:a + win] for a in w0[c]] for c in range(2)])
    args = (idx0, frac0, phase0, freq, STEP)
    out["windows"] = (jrx.plane_step_windows(xw, *args),
                      prx.plane_step_windows(xw, *args), jrx, prx)
    out["capture"] = capture
    return out


@pytest.mark.parametrize("path", ["contiguous", "windows"])
def test_plane_stage_matches_jax(planes, path):
    """Per-channel discriminators, the L1 read from the plane, and the
    equalized planes themselves."""
    jp, pp, jrx, prx = planes[path]
    jd, pd = jp.diag_host(), pp.diag_host()
    # the pod mode's own pilots fall short of its guard: the Wiener-row
    # plan, with its delay profile and csi
    assert set(jd) == set(pd) == {"gi_cfo", "sro", "cir_p"}
    assert pd["gi_cfo"].shape == pd["sro"].shape == (2,)
    assert pd["cir_p"].shape == jd["cir_p"].shape
    assert pd["cir_p"].shape[0] == 2
    assert np.max(np.abs(pd["cir_p"] - jd["cir_p"])) < 2e-2 * np.max(
        jd["cir_p"])
    # gi_cfo reads the time-domain symbols (float32 in both); sro the
    # pilots, which the JAX plane reads after its bf16 FFT
    np.testing.assert_allclose(pd["gi_cfo"], jd["gi_cfo"], rtol=1e-3,
                               atol=1e-9)
    np.testing.assert_allclose(pd["sro"], jd["sro"], rtol=0, atol=1e-4)
    # the L1 cells decode to the same signalling on every channel
    assert pp.l1_cells().shape == (2, prx.n_sig)
    for c in range(2):
        jpre, jpost = jacquisition.decode_l1_cells(jp.l1_cells(c))
        pre, post = acquisition.decode_l1_cells(pp.l1_cells(c), "cpu")
        assert dataclasses.asdict(pre) == dataclasses.asdict(jpre)
        assert dataclasses.asdict(post) == dataclasses.asdict(jpost)
    # the planes: the JAX chain's FFT runs in bf16 and its plane is
    # rounded to bf16 halves (about -46 dB each); the port's is complex64
    # (the port's rows run over its shards in grid-cell order, s.cells)
    (s,) = pp.shards
    assert s.eq.shape[0] == 2 * prx.n_time
    for got, want in ((s.eq, _unpack(jp.packed)),
                      (s.csi, np.asarray(jp.csi, np.float32))):
        got = got.numpy()
        want = want.reshape(len(s.cells), -1)[s.cells].reshape(got.shape)
        err_db = 10 * np.log10(np.mean(np.abs(got - want) ** 2)
                               / np.mean(np.abs(want) ** 2))
        assert err_db < -38.0, err_db


@pytest.fixture(scope="module")
def fec(planes):
    jp, pp, jrx, prx = planes["windows"]
    return jrx.fec_step(jp, 0), prx.fec_step(pp, 0), planes["windows"]


def test_fec_stage_matches_jax(fec):
    """One LDPC + BCH-screen call over all channels' codewords: hard bits,
    ok, iters and clean of converged codewords and the BB bytes equal
    to the Pallas kernel's (run with interpret=True)."""
    jf, pf, _ = fec
    assert pf.bb_bytes.shape == jf.bb_bytes.shape == (2, 2, 4, 7200 // 8)
    conv = jf.ldpc_ok & pf.ldpc_ok
    assert conv.all(), (jf.ldpc_ok, pf.ldpc_ok)
    np.testing.assert_array_equal(pf.ldpc_ok, jf.ldpc_ok)
    np.testing.assert_array_equal(pf.ldpc_iters[conv], jf.ldpc_iters[conv])
    np.testing.assert_array_equal(pf.bch_clean[conv], jf.bch_clean[conv])
    np.testing.assert_array_equal(pf.bb_bytes[conv], jf.bb_bytes[conv])
    assert (pf.bch_corrected == 0).all()
    np.testing.assert_allclose(pf.snr_db, jf.snr_db, rtol=0, atol=0.3)


def test_fec_segments_are_the_jax_pods_device_calls(planes, monkeypatch):
    """The (1, 2) grid of two channels: each JAX device holds both channels
    of one time block and decodes their codewords in one Pallas call,
    whose tiles count from its start.  The port's one call a device has one
    segment a grid cell, of that cell's codewords in the JAX device's
    order (channel, frame, FEC block), and decodes as those calls would
    one by one."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    jp, pp, jrx, prx = planes["contiguous"]
    calls = []
    call = ldpc.LayeredDecoder.__call__
    monkeypatch.setattr(ldpc.LayeredDecoder, "__call__",
                        lambda self, llr, segments=None: calls.append(
                            (llr, segments)) or call(self, llr, segments))
    pf, jf = prx.fec_step(pp, 0), jrx.fec_step(jp, 0)
    (llr, segments), = calls
    # a JAX device's share of the [C, n_time * F, n_fec] codewords
    jax_cw = jf.ldpc_ok.size // jrx.mesh.devices.size
    assert segments == [jax_cw] * jrx.mesh.devices.size
    (s,) = pp.shards
    nt = prx.n_time
    cells = [[c * nt + t for c in range(2)] for t in range(nt)]
    assert s.cells.tolist() == sum(cells, [])
    dec = prx._decoder(prx.plps[0].plp)
    whole = call(dec, llr, segments)
    parts = [call(dec, x) for x in torch.split(llr, segments)]
    for i in range(4):
        torch.testing.assert_close(whole[i], torch.cat([p[i] for p in parts]),
                                   rtol=0, atol=0)
    conv = jf.ldpc_ok & pf.ldpc_ok
    assert conv.all()
    np.testing.assert_array_equal(pf.bb_bytes, jf.bb_bytes)


def test_fec_llrs_match_jax(fec):
    """The demap over the pod's [C * n_time * F] frames: the port's int8
    LLRs from the JAX plane against the JAX LLRs, within 1."""
    _, _, (jp, pp, jrx, prx) = fec
    s = pp.shards[0]
    plane = _unpack(jp.packed).reshape(s.eq.shape)
    consts = jrx._consts[0]
    want, _ = jax.jit(lambda p, k: jrc.packed_to_llr_t(
        p, jrx.plans[0], k))(jnp.asarray(np.asarray(jp.packed).reshape(
            s.eq.shape)), consts)
    got, _ = rx_chain.packed_to_llr(torch.from_numpy(plane), prx.plans[0],
                                    prx.plans[0].to_device("cpu"))
    want = np.asarray(want).T
    assert got.shape == want.shape == (16, 16200)
    assert int(np.max(np.abs(got.numpy().astype(np.int16)
                             - want.astype(np.int16)))) <= 1


def test_contiguous_step_decodes(planes, capture):
    """The combined step() on the (1, 2) grid: the JAX step's stats keys,
    per-channel shapes, and hard bits equal to JAX's on converged
    codewords."""
    raw, l1_post, freq = capture
    _, _, jrx, prx = planes["contiguous"]
    rb = prx.raw_block_for(STEP)
    mu = ((prx.n_taps - 1) / 4.0 - 1.0) / RATIO
    bases = prx.host_bases(mu, STEP, 0.0, freq, rb, n_channels=2)
    x = np.ascontiguousarray(raw[:, :2 * rb])
    hard, stats = prx.step(x, *bases, freq, STEP)
    jhard, jstats = jrx.step(x, *bases, freq, STEP)
    assert set(stats) == set(jstats)
    assert hard.shape == np.asarray(jhard).shape == (2, 2, 4, 7200)
    assert int(stats["ldpc_failures"]) == 0 and int(stats["bch_dirty"]) == 0
    for k in ("ldpc_failures_ch", "bch_dirty_ch", "snr_db_ch"):
        assert np.shape(stats[k]) == (2,)
    np.testing.assert_array_equal(hard, np.asarray(jhard))


def test_shards_split_over_devices_match_one_device(planes):
    """A (2, 2) grid whose time shards sit on two devices ("cpu" and
    "cpu:0" count as two): each device runs its shards as one batched
    step, and the assembled result is the one-device step's — the L1
    cells from the time-0 shards, the per-channel means over both
    devices' shards, the bytes."""
    _, one, _, prx = planes["windows"]
    split = sharding.ShardedReceiver(prx.cfg, sharding.make_mesh(
        2, 2, devices=["cpu", "cpu:0"] * 2))
    groups = split._groups(2)
    assert [d for d, _ in groups] == [torch.device("cpu"),
                                      torch.device("cpu", 0)]
    assert [c.tolist() for _, c in groups] == [[0, 2], [1, 3]]
    mu_base = ((prx.n_taps - 1) / 4.0 - 1.0) / RATIO
    r0 = mu_base + prx.mode.frame_samples / RATIO * np.array([[1.0, 2.0]])
    raw, _, freq = planes["capture"]
    w0, idx0, frac0, phase0 = prx.host_bases_windows(
        np.repeat(r0, 2, axis=0), STEP, 0.0, freq)
    win = prx.window_len(STEP)
    xw = np.stack([[raw[c, a:a + win] for a in w0[c]] for c in range(2)])
    got = split.plane_step_windows(xw, idx0, frac0, phase0, freq, STEP)
    assert len(got.shards) == 2 and got.shards[1].sig.shape[0] == 0
    np.testing.assert_allclose(got.l1_cells(), one.l1_cells(), rtol=0,
                               atol=1e-5)
    for k, v in one.diag_host().items():
        np.testing.assert_allclose(got.diag_host()[k], v, rtol=1e-5,
                                   atol=1e-9)
    fa, fb = split.fec_step(got), prx.fec_step(one)
    for a in ("bb_bytes", "ldpc_ok", "ldpc_iters", "bch_clean"):
        np.testing.assert_array_equal(getattr(fa, a), getattr(fb, a))
    np.testing.assert_allclose(fa.snr_db, fb.snr_db, rtol=1e-5)
