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
