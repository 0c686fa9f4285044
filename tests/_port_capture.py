"""Captures for the port's streaming tests, made by the port's own
transmitter and channel.  Imports nothing of JAX, so the card tests
(tests/test_torch_cuda.py, run without the JAX package) use it too."""
from __future__ import annotations

import numpy as np

from sdr_receiver_dvb_t2_tpu_torch.params import modes as tm


def port_capture(tmp_dir, guard="G1_8", pilot_pattern="PP7", n_frames=9,
                 cfo_hz=31e3, sro_ppm=19.0, snr_db=26.0, fmt="8",
                 device_rate=10_000_000):
    """tests/test_stream_e2e.py's ``_make_capture`` made by the port's own
    transmitter and channel (2K, QAM16 SHORT r1/2 rotated, 4 FEC blocks a
    frame, 10 Msps u8 with CFO, SRO, DC and IQ imbalance); ``guard`` and
    ``pilot_pattern`` may differ from its GI 1/8 PP7.  Returns (path of
    the raw file, transmitted TS bytes, the port's T2Mode)."""
    from sdr_receiver_dvb_t2_tpu_torch.models.channel import (
        ChannelConfig, impair, quantize)
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    mode = tm.T2Mode(fft_mode=tm.FftMode.FFT_2K,
                     guard=tm.GuardInterval[guard],
                     pilot_pattern=tm.PilotPattern[pilot_pattern],
                     extended_carriers=False, n_data_symbols=30)
    plp = tm.PlpConfig(constellation=tm.Constellation.QAM16,
                       code_rate=tm.CodeRate.C1_2,
                       fec_frame=tm.FecFrame.SHORT, rotation=True,
                       time_il_length=1)
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=4,
                              num_t2_frames=n_frames))
    bytes_per_frame = 4 * (plp.k_bch // 8 - 10)
    ts = random_ts_stream((n_frames + 2) * bytes_per_frame // 188, seed=42)
    dev = impair(tx.modulate(ts), ChannelConfig(
        device_rate=device_rate, cfo_hz=cfo_hz, sro_ppm=sro_ppm,
        snr_db=snr_db, phase0=1.1, dc_offset=0.02 - 0.01j, iq_gain_db=0.2,
        iq_phase_deg=1.0, seed=3))
    raw = quantize(dev, {"8": "u8", "16": "s16", "fc": "f32"}[fmt],
                   scale=0.4)
    path = f"{tmp_dir}/capture_dvbt2_test_0_{device_rate}_{fmt}.raw"
    raw.tofile(path)
    return path, ts, mode


def ts_in_stream(got: np.ndarray, ts: np.ndarray) -> bool:
    """True if the received TS bytes are a run of the transmitted ones
    (the receiver starts mid-stream)."""
    sync, raw = got.tobytes(), ts.tobytes()
    idx = raw.find(sync[:376])
    return len(sync) > 0 and idx >= 0 and sync == raw[idx:idx + len(sync)]
