"""The port's frame-batch receiver end to end on the CPU, against the
transmitted stream and the JAX package's TpuReceiver on the e2e fixture
(8K, GI 1/32, PP3, 64QAM SHORT r2/3, 25 dB AWGN plus a 30 degree phase)."""
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.models import receiver as jrx
from sdr_receiver_dvb_t2_tpu_torch.models import receiver as trx

from _torch_common import FIXTURE_MODE, FIXTURE_PLP, fixture_frames, mode_pair, plp_pair


def _cfg(which):
    jmode, tmode = mode_pair(FIXTURE_MODE)
    jplp, tplp = plp_pair(FIXTURE_PLP)
    if which == "jax":
        return jrx.RxConfig(mode=jmode, plp=jplp, n_fec_per_frame=6,
                            n_ti=3, use_pallas=False)
    return trx.RxConfig(mode=tmode, plp=tplp, n_fec_per_frame=6, n_ti=3)


def test_receive_matches_transmitted_and_jax():
    frames, ts_in = fixture_frames()
    want = jrx.TpuReceiver(_cfg("jax")).prime(frames[0]).receive(frames)
    rx = trx.TorchReceiver(_cfg("torch"), device="cpu").prime(frames[0])
    res = rx.receive(frames)
    assert res.ldpc_ok.all() and res.bch_clean.all()
    assert len(res.ldpc_ok) == len(frames) * 6
    assert len(res.ts_bytes) > 50000
    assert np.array_equal(res.ts_bytes, ts_in[:len(res.ts_bytes)])
    assert np.array_equal(res.ts_bytes, want.ts_bytes)
    # the JAX stage demaps bf16-rounded cells (see test_torch_demap)
    assert abs(res.snr_db - want.snr_db) < 0.05
    assert 20.0 < res.snr_db < 30.0
    assert set(res.diag) >= {"phase_offset", "sro", "gi_cfo", "snr_db"}
    assert res.diag["phase_offset"].shape == (len(frames),
                                              rx.mode.frame_symbols)


def test_receive_stream_matches_receive():
    frames, ts_in = fixture_frames()
    ref = trx.TorchReceiver(_cfg("torch"), device="cpu"
                            ).prime(frames[0]).receive(frames)
    rx = trx.TorchReceiver(_cfg("torch"), device="cpu").prime(frames[0])
    outs = list(rx.receive_stream([frames, frames, frames]))
    assert len(outs) == 3
    assert np.array_equal(outs[0].ts_bytes, ref.ts_bytes)
    sync = ts_in.tobytes()
    for res in outs:
        assert res.bch_clean.all()
        np.testing.assert_array_equal(res.ldpc_iters, ref.ldpc_iters)
    for res in outs[1:]:
        got = res.ts_bytes.tobytes()
        at = sync.find(got[:376])
        assert at >= 0 and got == sync[at:at + len(got)]


def test_l1_cells_match_jax():
    frames, _ = fixture_frames()
    jr = jrx.TpuReceiver(_cfg("jax")).prime(frames[0])
    want = jr.l1_cells(jr.compute_plane(frames[:1])[0])
    rx = trx.TorchReceiver(_cfg("torch"), device="cpu").prime(frames[0])
    got = rx.l1_cells(rx.compute_plane(frames[:1])[0])
    assert got.shape == want.shape and got.dtype == np.complex64
    # JAX reads its cells from the bf16-packed plane
    assert np.max(np.abs(got - want)) < 2.0 ** -7 * (1 + np.abs(want)).max()


def test_config_from_l1_matches_jax():
    """The port's L1 acquisition and config_from_l1 give the configuration
    the JAX package's give, field by field."""
    frames, _ = fixture_frames()
    jr = jrx.TpuReceiver(_cfg("jax"))
    want = jrx.config_from_l1(jr.mode, *jr.acquire_l1(frames[0]))
    rx = trx.TorchReceiver(_cfg("torch"), device="cpu")
    got = trx.config_from_l1(rx.mode, *rx.acquire_l1(frames[0]))
    assert (got.n_fec_per_frame, got.n_ti, got.plp_start) == (
        want.n_fec_per_frame, want.n_ti, want.plp_start) == (6, 3, 0)
    def value(obj, field):                # enums of two packages
        v = getattr(obj, field)
        return getattr(v, "value", v)
    for field in ("fft_mode", "guard", "pilot_pattern", "extended_carriers",
                  "papr", "n_data_symbols"):
        assert value(got.mode, field) == value(want.mode, field), field
    for field in ("plp_id", "constellation", "rotation", "code_rate",
                  "fec_frame", "num_blocks_max", "time_il_length",
                  "time_il_type"):
        assert value(got.plp, field) == value(want.plp, field), field


def test_no_device_means_cuda(monkeypatch):
    """Without a GPU, an entry point called without device="cpu" raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trx.TorchReceiver(_cfg("torch"))
    with pytest.raises(RuntimeError, match="CUDA"):
        trx.plan_from_numpy({}, None)
    trx.TorchReceiver(_cfg("torch"), device="cpu")
