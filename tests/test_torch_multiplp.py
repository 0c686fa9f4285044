"""Multi-PLP on the port, on the CPU: two PLPs of different modulation and
coding in one T2 frame (tests/test_multiplp.py), each decoded by its PLP
index from one shared equalized plane, and the stream decoding every PLP
with one ``compute_plane`` a batch.  The TS of each PLP is held to the
transmitted stream (the JAX package's own multi-PLP receive tests are
marked slow); the L1-derived configurations to the JAX package's."""
import numpy as np

from sdr_receiver_dvb_t2_tpu.models import receiver as jrx
from sdr_receiver_dvb_t2_tpu_torch.io import sinks, sources
from sdr_receiver_dvb_t2_tpu_torch.models import receiver as trx
from sdr_receiver_dvb_t2_tpu_torch.models.channel import (ChannelConfig,
                                                          impair, quantize)
from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
    Transmitter, TxConfig, random_ts_stream)
from sdr_receiver_dvb_t2_tpu_torch.runtime import stream

from _port_capture import ts_in_stream
from _torch_common import mode_pair, plp_pair

MODE = dict(fft_mode="FFT_2K", guard="G1_8", pilot_pattern="PP7",
            extended_carriers=False, n_data_symbols=30)
PLP_A = dict(plp_id=0, constellation="QAM16", code_rate="C1_2",
             fec_frame="SHORT", rotation=True, time_il_length=1)
PLP_B = dict(plp_id=1, constellation="QAM64", code_rate="C2_3",
             fec_frame="SHORT", rotation=False, time_il_length=1)


def _two_plp_tx(fec_blocks, n_frames):
    _, tmode = mode_pair(MODE)
    plps = [plp_pair(PLP_A)[1], plp_pair(PLP_B)[1]]
    return tmode, Transmitter(TxConfig(mode=tmode, plps=plps,
                                       fec_blocks=fec_blocks,
                                       num_t2_frames=n_frames))


def test_two_plps_round_trip():
    """Frame level: L1 names both PLPs, config_from_l1 gives each its
    configuration as the JAX package's does, and both decode exactly from
    one compute_plane."""
    tmode, tx = _two_plp_tx([3, 4], 2)
    ts_a = random_ts_stream(160, seed=1)
    ts_b = random_ts_stream(320, seed=2)
    iq = tx.modulate_multi([ts_a, ts_b])[:2 * tmode.frame_samples]
    rng = np.random.default_rng(0)
    iq = iq + (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(
        len(iq))).astype(np.complex64) * np.sqrt(np.mean(np.abs(iq) ** 2)
                                                 / 2e3)
    frames = iq.reshape(2, tmode.frame_samples)
    probe = trx.TorchReceiver(trx.RxConfig(
        mode=tmode, plp=plp_pair(PLP_A)[1], n_fec_per_frame=3, n_ti=1),
        device="cpu")
    pre, post = probe.acquire_l1(frames[0])
    assert post.num_plp == 2
    jmode = mode_pair(MODE)[0]
    rxs = []
    for idx in (0, 1):
        cfg = trx.config_from_l1(tmode, pre, post, plp_idx=idx)
        want = jrx.config_from_l1(jmode, pre, post, plp_idx=idx)
        assert (cfg.n_fec_per_frame, cfg.plp_start, cfg.n_ti) == (
            want.n_fec_per_frame, want.plp_start, want.n_ti)
        assert cfg.plp.constellation.value == want.plp.constellation.value
        assert cfg.plp.code_rate.value == want.plp.code_rate.value
        rx = trx.TorchReceiver(cfg, device="cpu")
        rx._l1_post_cells = pre.l1_post_size
        rxs.append(rx)
    plane, diag = rxs[0].compute_plane(frames)
    for rx, ts_in in zip(rxs, (ts_a, ts_b)):
        res = rx.receive_plane(plane, diag)
        assert res.ldpc_ok.all() and res.bch_clean.all()
        assert len(res.ts_bytes) > 188 * 10
        assert ts_in_stream(res.ts_bytes, ts_in)


def test_stream_all_plps_one_plane_a_batch(tmp_path, monkeypatch):
    """plp_index=None decodes every PLP into its own sink, with one
    demod + equalize (compute_plane) a batch, not one a PLP."""
    tmode, tx = _two_plp_tx([2, 3], 8)
    ts_a = random_ts_stream(200, seed=11)
    ts_b = random_ts_stream(400, seed=12)
    dev = impair(tx.modulate_multi([ts_a, ts_b]), ChannelConfig(
        device_rate=10e6, cfo_hz=8e3, snr_db=28.0, seed=5))
    path = tmp_path / "multi_0_10000000_16.raw"
    quantize(dev, "s16", scale=0.4).tofile(path)

    calls = {"plane": 0}
    real = trx.TorchReceiver.compute_plane

    def counting(self, frames):
        calls["plane"] += 1
        return real(self, frames)
    monkeypatch.setattr(trx.TorchReceiver, "compute_plane", counting)
    cfg = stream.StreamConfig(frames_per_batch=1, plp_index=None,
                              acq_elem_samples=3 * tmode.frame_samples)
    sink0, sink1 = sinks.BufferTsSink(), sinks.BufferTsSink()
    rx = stream.StreamingReceiver(sources.RawFileSource(str(path)), sink0,
                                  cfg, device="cpu")
    rx.plp_sinks[1] = sink1
    stats = rx.run(max_frames=3)
    assert stats.state == "locked" and len(rx.rxs) == 2
    assert stats.frames == 3 and calls["plane"] == 3
    assert stats.ldpc_failures == 0
    for sink, ts_in in ((sink0, ts_a), (sink1, ts_b)):
        assert len(sink.data) > 188 * 10
        assert ts_in_stream(sink.data, ts_in)
