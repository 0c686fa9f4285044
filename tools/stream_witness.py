#!/usr/bin/env python3
"""Whose are the BCH-dirty codewords of the streamed flagship capture: the
channel's, the decoder's at that SNR, or the port's front end's?

    python3 tools/stream_witness.py [--frames 6] [--sro 0.5 19]
                                    [--report PATH]

Makes chip_smoke's flagship frames once (32K, GI 1/128, PP7 extended,
rotated 256QAM, LDPC 64800 r2/3, 27 dB AWGN) and receives, on the GPU, in
batches of two frames:

1. ``awgn``: the frames tiled to ``--frames``, with fresh AWGN that brings
   the SNR to 27 (none added), 26, 25.5 and 25 dB, through the port's
   frame receiver: no channel and no front end;
2. ``bypass``: chip_smoke's stream capture at each ``--sro`` (u8, 10 Msps,
   CFO +31 kHz, DC and IQ imbalance) brought back to the elementary rate by
   the exact inverse of the channel (its known DC, IQ imbalance, CFO and
   clock error; the channel's own FFT-and-cubic resampler), then through
   the frame receiver: the port's front end bypassed;
3. ``stream``: the same capture through ``StreamingReceiver.run``, the
   port's front end and tracking included.

Prints, for each run, each batch's LDPC failures, BCH-dirty codewords,
codewords the host BCH corrected, SNR estimate and whether its TS equals
the transmitted stream; and the SNR of the u8 quantisation alone.  One JSON
line a run.  Needs a GPU, nvcc and g++.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def receive_batches(rx, frames, ts):
    """The frame receiver on consecutive pairs of frames: a record a
    batch."""
    import numpy as np
    out = []
    for i in range(0, len(frames) - 1, 2):
        res = rx.receive(frames[i:i + 2])
        out.append(dict(
            ldpc_failures=int(np.sum(~res.ldpc_ok)),
            bch_dirty=int(np.sum(~res.bch_clean)),
            bch_corrected=int(np.sum(res.bch_corrected > 0)),
            snr_db=float(res.snr_db), ts_bytes=int(len(res.ts_bytes)),
            ts_exact=bool(np.array_equal(res.ts_bytes,
                                         ts[:len(res.ts_bytes)]))))
    return out


def cubic_at(fine, p):
    """The channel's cubic interpolation of ``fine`` at positions ``p``."""
    import numpy as np
    idx = np.floor(p).astype(np.int64)
    d = p - idx
    dm1, dp1, dm2 = d - 1.0, d + 1.0, d - 2.0
    return (fine[idx - 1] * (-d * dm1 * dm2 / 6.0)
            + fine[idx] * (dp1 * dm1 * dm2 / 2.0)
            + fine[idx + 1] * (-dp1 * d * dm2 / 2.0)
            + fine[idx + 2] * (dp1 * d * dm1 / 6.0))


def inverse_channel(dev, ch):
    """Elementary-rate samples from the channel's output ``dev`` by the
    exact inverse of ``models/channel.impair`` under ``ch``: DC, IQ
    imbalance and CFO undone, then resampled back with the channel's own
    x8 FFT upsampling and cubic (its output sample k is input position
    1 + ratio k)."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import SAMPLE_RATE
    y = dev.astype(np.complex128) - ch.dc_offset
    g, phi = 10 ** (ch.iq_gain_db / 20), np.deg2rad(ch.iq_phase_deg)
    y = y.real + 1j * ((y.imag / g - y.real * np.sin(phi)) / np.cos(phi))
    n = np.arange(len(y))
    y *= np.exp(-1j * (ch.phase0 + 2 * np.pi * ch.cfo_hz / ch.device_rate
                       * n))
    ratio = SAMPLE_RATE / (ch.device_rate * (1.0 + ch.sro_ppm * 1e-6))
    up, n_in = 8, len(y)
    spec = np.fft.fft(y)
    fine_spec = np.zeros(n_in * up, np.complex128)
    half = n_in // 2
    fine_spec[:half], fine_spec[-(n_in - half):] = spec[:half], spec[half:]
    del spec
    fine = np.fft.ifft(fine_spec) * up
    del fine_spec
    m = np.arange(2, int((n_in - 4) * ratio))
    x = np.zeros(len(m) + 2, np.complex64)
    x[2:] = cubic_at(fine, (m - 1) / ratio * up)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=6,
                    help="frames a run (a multiple of 2)")
    ap.add_argument("--sro", type=float, nargs="+", default=[0.5, 19.0])
    ap.add_argument("--report", type=Path, default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("stream_witness: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sdr_receiver_dvb_t2_tpu_torch.io import native
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import (
        RxConfig, TorchReceiver)
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build, frontend, p1_detect
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    native.build()
    mode, plp = cs.flagship_config()
    frames, n_fec, ts = cs.make_signal(mode, plp)
    fs = mode.frame_samples
    rx = TorchReceiver(RxConfig(mode=mode, plp=plp, n_fec_per_frame=n_fec,
                                n_ti=1), device="cuda").prime(frames[0])
    rows = []

    def emit(row):
        row["smi"] = smi
        rows.append(row)
        print(json.dumps(row), flush=True)

    # 1. AWGN alone, at the SNRs around the stream's
    tiled = np.tile(frames, (args.frames // 2, 1))
    p_sig = np.mean(np.abs(frames) ** 2) / (1 + 10 ** -2.7)
    for snr in (27.0, 26.0, 25.5, 25.0):
        extra = p_sig * (10 ** (-snr / 10) - 10 ** -2.7)
        rng = np.random.default_rng(int(snr * 10))
        noisy = tiled + (rng.standard_normal(tiled.shape)
                         + 1j * rng.standard_normal(tiled.shape)
                         ) * np.sqrt(max(extra, 0.0) / 2)
        emit(dict(run="awgn", snr_db_target=snr, batches=receive_batches(
            rx, noisy.astype(np.complex64), ts)))

    out_dir = ROOT / "build" / "stream_witness"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"witness_0_{cs.STREAM_RATE}_8.raw"
    for sro in args.sro:
        ch = cs.stream_channel(sro)
        dev = cs.stream_capture(frames, path, args.frames, sro_ppm=sro)
        raw = torch.from_numpy(np.fromfile(path, np.uint8))
        deq = frontend.raw_to_iq(raw, "u8").numpy() / cs.STREAM_SCALE
        q_snr = float(10 * np.log10(np.mean(np.abs(dev) ** 2)
                                    / np.mean(np.abs(deq - dev) ** 2)))
        # 2. the front end bypassed
        t0 = time.perf_counter()
        elem = inverse_channel(deq, ch)
        inverse_s = time.perf_counter() - t0
        p1 = p1_detect.detect(torch.from_numpy(elem[:3_500_000]).cuda())
        start = int(p1[0]) % fs
        n = (len(elem) - start) // fs
        got = elem[start:start + n * fs].reshape(n, fs)[:args.frames]
        emit(dict(run="bypass", sro_ppm=sro, quantisation_snr_db=q_snr,
                  p1_t0=int(p1[0]), inverse_s=inverse_s,
                  batches=receive_batches(rx, got, ts)))
        # 3. the same capture through the streaming entry point
        srx, stats, ts_got, timing = cs.run_stream(path, "cuda")
        runs, missing = cs._ts_runs(ts_got, ts)
        emit(dict(run="stream", sro_ppm=sro, state=stats.state,
                  frames=stats.frames, ts_runs=runs, ts_missing=missing,
                  batches=[{k: b[k] for k in (
                      "ldpc_failures", "bch_dirty", "bch_bits_corrected",
                      "snr_db", "sro_ppm", "ts_bytes")}
                      for b in timing["batches"]]))
        path.unlink()
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
