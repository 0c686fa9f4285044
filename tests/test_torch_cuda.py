"""The port on the card: the CUDA LDPC kernel against its plain twin, and
the receiver on cuda against the receiver on the CPU.

These need an NVIDIA GPU with nvcc and skip without one.  On such a
machine (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("rate,frame,n_cw", [("C1_2", "SHORT", 64),
                                             ("C2_3", "SHORT", 64),
                                             ("C2_3", "NORMAL", 48)])
def test_kernel_matches_twin(cuda, rate, frame, n_cw):
    from chip_smoke import check_kernel_against_twin, coded_llrs
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    llr, plp = coded_llrs(rate, frame, n_cw, seed=9)
    before = ldpc.LayeredDecoder.launches
    res, got = check_kernel_against_twin(torch.from_numpy(llr).to(cuda), plp)
    assert ldpc.LayeredDecoder.launches == before + 1
    assert res["max_abs_err"] == 0
    assert got[0].device.type == "cuda"
    # the noise-free quarter decodes in one sweep, the hopeless quarter not
    assert got[1][0::4].all() and (got[2][0::4] == 1).all()
    assert not got[3][1::4].any()


def test_receiver_cuda_equals_cpu(cuda):
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import (
        RxConfig, TorchReceiver)
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        CodeRate, Constellation, FecFrame, FftMode, GuardInterval,
        PilotPattern, PlpConfig, T2Mode)
    mode = T2Mode(FftMode.FFT_8K, GuardInterval.G1_32, PilotPattern.PP3,
                  True, n_data_symbols=20)
    plp = PlpConfig(constellation=Constellation.QAM64,
                    code_rate=CodeRate.C2_3, fec_frame=FecFrame.SHORT,
                    num_blocks_max=10, time_il_length=3)
    ts = random_ts_stream(400)
    iq = Transmitter(TxConfig(mode=mode, plp=plp,
                              fec_blocks_per_frame=6)).modulate(ts)
    f = len(iq) // mode.frame_samples
    frames = iq[:f * mode.frame_samples].reshape(f, -1)
    rng = np.random.default_rng(7)
    sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / 10 ** 2.5 / 2)   # 25 dB
    frames = (frames + sigma * (rng.standard_normal(frames.shape) + 1j
                                * rng.standard_normal(frames.shape))
              ).astype(np.complex64)
    cfg = RxConfig(mode=mode, plp=plp, n_fec_per_frame=6, n_ti=3)
    a = TorchReceiver(cfg, device="cpu").prime(frames[0]).receive(frames)
    rx = TorchReceiver(cfg, device=cuda).prime(frames[0])
    b = rx.receive(frames)
    assert b.ldpc_ok.all() and b.bch_clean.all()
    assert np.array_equal(b.ts_bytes, a.ts_bytes)
    assert np.array_equal(b.ts_bytes, ts[:len(b.ts_bytes)])
    np.testing.assert_array_equal(b.ldpc_iters, a.ldpc_iters)
    # same float32 stages, summed in another order on the card
    assert abs(b.snr_db - a.snr_db) < 0.01
    outs = list(rx.receive_stream([frames, frames]))
    assert all(o.bch_clean.all() for o in outs)
