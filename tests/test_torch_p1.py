"""The port's P1 detection (ops/p1_detect.py) against the JAX package's, on
the P1 of a 2K frame from the port's transmitter, with noise and CFO.

Tolerances: ``t0`` exact; the correlator metric to 1e-3 absolute (it lies
in [0, ~1]; both take differences of float32 cumulative sums, whose
rounding grows with the window); ``cfo_frac`` to 1e-4 rad/sample.  S1/S2
and the total CFO from ``decode_signalling`` (host numpy in both) equal.
"""
import functools

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one torch thread per worker)
from sdr_receiver_dvb_t2_tpu.ops import cplx
from sdr_receiver_dvb_t2_tpu.ops import p1_detect as jp1
from sdr_receiver_dvb_t2_tpu_torch.ops import p1_detect
from sdr_receiver_dvb_t2_tpu_torch.params import p1 as p1_mod

CARRIER = 2 * np.pi / 1024          # rad/sample of one P1 carrier


@functools.lru_cache(maxsize=1)
def _frame():
    """One 2K frame (GI 1/32, PP4, QAM16 SHORT r1/2) of the port's
    transmitter; it opens with its P1 symbol."""
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        CodeRate, Constellation, FecFrame, FftMode, GuardInterval,
        PilotPattern, PlpConfig, T2Mode)
    mode = T2Mode(fft_mode=FftMode.FFT_2K, guard=GuardInterval.G1_32,
                  pilot_pattern=PilotPattern.PP4, extended_carriers=False,
                  n_data_symbols=30)
    plp = PlpConfig(constellation=Constellation.QAM16,
                    code_rate=CodeRate.C1_2, fec_frame=FecFrame.SHORT)
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=4,
                              num_t2_frames=2))
    return tx.modulate(random_ts_stream(120, seed=0))[:mode.frame_samples]


def _capture(cfo_carriers, t0=3777, n=16384, snr_db=10.0, seed=5):
    rng = np.random.default_rng(seed)
    frame = _frame()
    sig = np.zeros(n, np.complex64)
    sig[t0:] = frame[:n - t0]
    p = np.mean(np.abs(frame[:2048]) ** 2) / 10 ** (snr_db / 10)
    x = sig + (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        * np.sqrt(p / 2)
    cfo = cfo_carriers * CARRIER
    return (x * np.exp(1j * cfo * np.arange(n))).astype(np.complex64), cfo


@pytest.mark.parametrize("cfo_carriers", [0.0, 0.31, -2.4, 7.62])
def test_detect_matches_jax_on_transmitter_p1(cfo_carriers):
    x, cfo = _capture(cfo_carriers)
    t0, peak, cfo_frac = p1_detect.detect(torch.from_numpy(x))
    jt0, jpeak, jcfo = jp1.detect(cplx.from_np(x))
    assert int(t0) == int(jt0)
    assert abs(int(t0) - 3777) <= 2
    assert abs(float(peak) - float(jpeak)) < 1e-3 and float(peak) > 0.3
    assert abs(float(cfo_frac) - float(jcfo)) < 1e-4
    res = p1_detect.decode_signalling(x[int(t0):int(t0) + 2048],
                                      float(cfo_frac))
    jres = jp1.decode_signalling(x[int(jt0):int(jt0) + 2048], float(jcfo))
    assert res is not None and jres is not None
    assert res[:2] == jres[:2] == (0, 0)         # T2 SISO, 2K
    assert abs(res[2] - jres[2]) < 1e-4
    assert abs(res[2] - cfo) < 0.05 * CARRIER


def test_correlate_matches_jax():
    x, _ = _capture(0.31, n=12288)
    metric, corr_c, corr_b = p1_detect.correlate(torch.from_numpy(x))
    jm, jc, jb = jp1.correlate(cplx.from_np(x))
    np.testing.assert_allclose(metric.numpy(), np.asarray(jm), atol=1e-3)
    for a, b in ((corr_c, jc), (corr_b, jb)):
        b = cplx.to_np(b)
        assert a.dtype == torch.complex64 and a.shape == b.shape
        scale = np.sqrt(np.mean(np.abs(b) ** 2))
        assert np.max(np.abs(a.numpy() - b)) < 1e-4 * scale


@pytest.mark.parametrize("s2", [0, 5])
def test_detect_matches_jax_on_generated_p1(s2):
    """The bare P1 of another FFT size (S2), as the JAX test builds it."""
    rng = np.random.default_rng(s2)
    x = (rng.standard_normal(12288) + 1j * rng.standard_normal(12288)
         ).astype(np.complex64) * np.sqrt(0.05)
    x[5000:5000 + 2048] += p1_mod.generate(0, s2)
    t0, peak, cfo = p1_detect.detect(torch.from_numpy(x))
    jt0, jpeak, jcfo = jp1.detect(cplx.from_np(x))
    assert int(t0) == int(jt0) and abs(int(t0) - 5000) <= 2
    assert abs(float(peak) - float(jpeak)) < 1e-3
    res = p1_detect.decode_signalling(x[int(t0):int(t0) + 2048], float(cfo))
    assert res is not None and res[:2] == (0, s2)


def test_no_false_alarm_on_noise():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
         ).astype(np.complex64)
    _, peak, _ = p1_detect.detect(torch.from_numpy(x))
    _, jpeak, _ = jp1.detect(cplx.from_np(x))
    assert float(peak) < 0.2 and abs(float(peak) - float(jpeak)) < 1e-3
