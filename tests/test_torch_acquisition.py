"""Blind acquisition (runtime/acquisition.py, host numpy with the soft L1
fallback on the caller's device) against the JAX package's, on the same
2K elementary-rate capture: the same mode, the same L1-pre and L1-post,
the same timing offset and SFN decision, P2 cells equal to float32
rounding.  Also the steady-state L1 read ``decode_l1_cells``.
"""
import dataclasses
import functools

import numpy as np
import pytest

import _torch_common  # noqa: F401  (one torch thread per worker)
from sdr_receiver_dvb_t2_tpu.runtime import acquisition as jacq
from sdr_receiver_dvb_t2_tpu_torch.ops import l1_soft
from sdr_receiver_dvb_t2_tpu_torch.params import p1 as p1_mod
from sdr_receiver_dvb_t2_tpu_torch.runtime import acquisition


@functools.lru_cache(maxsize=2)
def _frames(guard, pp):
    """Two 2K frames (QAM16 SHORT r1/2, 4 FEC blocks) of the port's
    transmitter, at the elementary rate."""
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        CodeRate, Constellation, FecFrame, FftMode, GuardInterval,
        PilotPattern, PlpConfig, T2Mode)
    mode = T2Mode(fft_mode=FftMode.FFT_2K, guard=GuardInterval[guard],
                  pilot_pattern=PilotPattern[pp], extended_carriers=False,
                  n_data_symbols=30)
    plp = PlpConfig(constellation=Constellation.QAM16,
                    code_rate=CodeRate.C1_2, fec_frame=FecFrame.SHORT,
                    rotation=True)
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=4,
                              num_t2_frames=2))
    iq = tx.modulate(random_ts_stream(120, seed=0))
    return iq[:2 * mode.frame_samples]


def _elem(guard, pp, snr_db, seed=1):
    """Samples right after the first P1, with seeded AWGN."""
    iq = _frames(guard, pp)
    rng = np.random.default_rng(seed)
    p = np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10)
    x = iq + (rng.standard_normal(len(iq))
              + 1j * rng.standard_normal(len(iq))) * np.sqrt(p / 2)
    return x.astype(np.complex64)[p1_mod.P1_LEN:]


def _names(mode):
    return (mode.fft_mode.name, mode.guard.name, mode.pilot_pattern.name,
            mode.extended_carriers, mode.papr.name, mode.miso, mode.lite,
            mode.n_data_symbols)


# (guard, pattern, SNR): clean linear-plan mode; the same at 6 dB, where
# the L1-post takes the soft fallback (flooding decoder); GI 1/8 PP7,
# whose measured delay spread makes both packages ask for the SFN plan
CASES = [("G1_32", "PP4", 20.0), ("G1_32", "PP4", 6.0),
         ("G1_8", "PP7", 20.0)]


@pytest.mark.parametrize("guard,pp,snr_db", CASES)
def test_acquire_mode_matches_jax(guard, pp, snr_db, monkeypatch):
    elem = _elem(guard, pp, snr_db)
    soft = []
    real_post = l1_soft.decode_l1_post_fec

    def spy(*a, **kw):
        soft.append(1)
        return real_post(*a, **kw)
    monkeypatch.setattr(l1_soft, "decode_l1_post_fec", spy)
    got = acquisition.acquire_mode(elem, 0, 0, device="cpu")
    want = jacq.acquire_mode(elem, 0, 0)
    assert got is not None and want is not None
    assert _names(got.mode) == _names(want.mode)
    assert (got.mode.guard.name, got.mode.pilot_pattern.name) == (guard, pp)
    assert dataclasses.asdict(got.l1_pre) == dataclasses.asdict(want.l1_pre)
    assert dataclasses.asdict(got.l1_post) == \
        dataclasses.asdict(want.l1_post)
    assert (got.timing_off, got.sfn) == (want.timing_off, want.sfn)
    assert got.sfn == (pp == "PP7")
    np.testing.assert_allclose(got.p2_cells, want.p2_cells, atol=1e-4)
    assert bool(soft) == (snr_db < 10)


def test_decode_l1_cells_matches_jax():
    got = acquisition.acquire_mode(_elem("G1_32", "PP4", 20.0), 0, 0,
                                   device="cpu")
    cells = got.p2_cells
    pre, post = acquisition.decode_l1_cells(cells, device="cpu")
    jpre, jpost = jacq.decode_l1_cells(cells)
    assert dataclasses.asdict(pre) == dataclasses.asdict(jpre)
    assert dataclasses.asdict(post) == dataclasses.asdict(jpost)
    assert post.dyn.plp[0].num_blocks == 4


def test_acquire_refuses_non_t2_signalling():
    elem = _elem("G1_32", "PP4", 20.0)
    assert acquisition.acquire_mode(elem, 2, 0, device="cpu") is None
    assert acquisition.acquire_mode(elem, 0, 7, device="cpu") is None
