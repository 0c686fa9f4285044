#!/usr/bin/env python3
"""Does a sampling-clock error break 32K frames in the JAX receiver as it
does in the PyTorch port?  Both frame receivers, on the CPU, on the same
drifted frames.

    JAX_PLATFORMS=cpu python3 tools/sro_drift_witness.py [--symbols 8]
                                                         [--sro 0 1 3 19]

Two frames of the flagship's widths (32K, GI 1/128, PP7 extended, rotated
256QAM, LDPC 64800 r2/3, as many FEC blocks as the frame holds, 27 dB
AWGN) made by the port's transmitter, with the frame cut to ``--symbols``
data symbols so that both receivers run in seconds on the CPU.  For each
clock error the frames go through ``models/channel.impair`` at the
elementary rate (nothing but the clock error) and are cut at the nominal
frame length, as a receiver cuts them before its tracking loop has pulled
in.  Both receivers are primed with the undrifted first frame (the L1 is
the same); each then receives the drifted pair: LDPC ok and BCH clean
codewords, the receiver's SNR estimate, and whether the TS equals the
transmitted stream.  One JSON line a row.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def frames_of(n_symbols: int):
    """(mode, plp, n_fec, frames [2, frame_samples], ts) at 27 dB."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from sdr_receiver_dvb_t2_tpu_torch.params import l1 as l1_mod
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        CodeRate, Constellation, FecFrame, FftMode, GuardInterval,
        PilotPattern, PlpConfig, T2Mode)
    mode = T2Mode(fft_mode=FftMode.FFT_32K, guard=GuardInterval.G1_128,
                  pilot_pattern=PilotPattern.PP7, extended_carriers=True,
                  n_data_symbols=n_symbols)
    plp = PlpConfig(constellation=Constellation.QAM256, rotation=True,
                    code_rate=CodeRate.C2_3, fec_frame=FecFrame.NORMAL,
                    time_il_length=1, num_blocks_max=254)
    tmp = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=1,
                               num_t2_frames=2))
    n_fec = ((mode.frame_cells - l1_mod.L1_PRE_CELLS
              - tmp.l1_pre.l1_post_size) // plp.cells_per_fec_block)
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=n_fec,
                              num_t2_frames=2))
    ts = random_ts_stream(3 * n_fec * (plp.k_bch // 8) // 188, seed=7)
    fs = mode.frame_samples
    iq = tx.modulate(ts)[:2 * fs]
    rng = np.random.default_rng(11)
    npow = np.mean(np.abs(iq) ** 2) / 10 ** 2.7
    iq = iq + (rng.standard_normal(iq.shape)
               + 1j * rng.standard_normal(iq.shape)) * np.sqrt(npow / 2)
    return mode, plp, n_fec, iq.astype(np.complex64).reshape(2, fs), ts


def drifted(frames, sro_ppm: float):
    """The frames through the channel at the elementary rate with a clock
    error of ``sro_ppm``, cut at the nominal frame length from the first
    frame's start."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.models.channel import (
        ChannelConfig, impair)
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import SAMPLE_RATE
    fs = frames.shape[1]
    # impair's first output sits one input sample in: lead with a zero
    x = np.concatenate([np.zeros(1, np.complex64), frames.reshape(-1),
                        np.zeros(256, np.complex64)])
    y = impair(x, ChannelConfig(device_rate=SAMPLE_RATE, sro_ppm=sro_ppm))
    return y[:2 * fs].reshape(2, fs)


def jax_receiver(mode, plp, n_fec):
    from sdr_receiver_dvb_t2_tpu.models import receiver as jrx
    from sdr_receiver_dvb_t2_tpu.params import modes as jm
    jmode = jm.T2Mode(fft_mode=jm.FftMode[mode.fft_mode.name],
                      guard=jm.GuardInterval[mode.guard.name],
                      pilot_pattern=jm.PilotPattern[mode.pilot_pattern.name],
                      extended_carriers=mode.extended_carriers,
                      n_data_symbols=mode.n_data_symbols)
    jplp = jm.PlpConfig(constellation=jm.Constellation[plp.constellation.name],
                        rotation=plp.rotation,
                        code_rate=jm.CodeRate[plp.code_rate.name],
                        fec_frame=jm.FecFrame[plp.fec_frame.name],
                        time_il_length=plp.time_il_length,
                        num_blocks_max=plp.num_blocks_max)
    return jrx.TpuReceiver(jrx.RxConfig(mode=jmode, plp=jplp,
                                        n_fec_per_frame=n_fec, n_ti=1,
                                        use_pallas=False))


def port_receiver(mode, plp, n_fec):
    from sdr_receiver_dvb_t2_tpu_torch.models import receiver as trx
    return trx.TorchReceiver(trx.RxConfig(mode=mode, plp=plp,
                                          n_fec_per_frame=n_fec, n_ti=1),
                             device="cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--symbols", type=int, default=8,
                    help="data symbols a frame (the flagship has 59)")
    ap.add_argument("--sro", type=float, nargs="+",
                    default=[0.0, 1.0, 3.0, 19.0])
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    mode, plp, n_fec, frames, ts = frames_of(args.symbols)
    receivers = dict(jax=jax_receiver(mode, plp, n_fec).prime(frames[0]),
                     port=port_receiver(mode, plp, n_fec).prime(frames[0]))
    for sro in args.sro:
        got = drifted(frames, sro)
        for name, rx in receivers.items():
            t0 = time.perf_counter()
            res = rx.receive(got)
            n = len(res.ldpc_ok)
            print(json.dumps(dict(
                receiver=name, sro_ppm=sro, symbols=args.symbols,
                codewords=n, ldpc_ok=int(np.sum(res.ldpc_ok)),
                bch_clean=int(np.sum(res.bch_clean)),
                snr_db=float(res.snr_db), ts_bytes=int(len(res.ts_bytes)),
                ts_exact=bool(np.array_equal(res.ts_bytes,
                                             ts[:len(res.ts_bytes)])),
                seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
