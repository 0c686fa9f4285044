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


# beside the flagship's table: the 64-bit state word (NORMAL and SHORT
# r5/6) and the largest state (NORMAL r1/2)
@pytest.mark.parametrize("rate,frame,n_cw", [("C1_2", "SHORT", 64),
                                             ("C2_3", "SHORT", 64),
                                             ("C2_3", "NORMAL", 48),
                                             ("C5_6", "NORMAL", 32),
                                             ("C5_6", "SHORT", 64),
                                             ("C1_2", "NORMAL", 32)])
def test_kernel_matches_twin(cuda, rate, frame, n_cw):
    from chip_smoke import check_kernel_against_twin, coded_llrs
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    llr, plp = coded_llrs(rate, frame, n_cw, seed=9)
    before = ldpc.LayeredDecoder.launches
    screens = ldpc.LayeredDecoder.screen_launches
    res, got = check_kernel_against_twin(torch.from_numpy(llr).to(cuda), plp)
    assert ldpc.LayeredDecoder.launches == before + 1
    assert ldpc.LayeredDecoder.screen_launches == screens + 1
    assert res["max_abs_err"] == 0
    assert got[0].device.type == "cuda"
    # the noise-free quarter decodes in one sweep, the hopeless quarter not
    assert got[1][0::4].all() and (got[2][0::4] == 1).all()
    assert not got[3][1::4].any()


def test_shared_memory_is_sized_alike_in_c_and_python(cuda):
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build, ldpc
    lib = _build.load_kernel("ldpc_layered")
    for table in ("NORMAL_C1_2", "NORMAL_C2_3", "NORMAL_C5_6", "SHORT_C1_4",
                  "SHORT_C3_4", "SHORT_C5_6"):
        dec = ldpc.LayeredDecoder(table)
        plan = dec.plan
        assert lib.ldpc_layered_shared_bytes(
            plan.k, plan.q, plan.cnl, int(dec.uniform)) == dec.shared_bytes


def test_kernel_refuses_a_table_it_has_no_room_for(cuda):
    """A code whose posteriors and state exceed a block's shared memory is
    refused with its sizes named, before any launch."""
    import ctypes
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build
    lib = _build.load_kernel("ldpc_layered")
    null = ctypes.c_void_p(0)
    err = lib.ldpc_layered_decode(null, null, null, null, null, null, null,
                                  null, null, 0, 0, 1, 360 * 600, 90, 5, 1,
                                  15, null)
    assert err != 0
    assert b"shared memory" in lib.last_error_detail()


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
