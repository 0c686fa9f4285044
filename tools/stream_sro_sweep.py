#!/usr/bin/env python3
"""How much sampling-clock error does the streaming receiver take at 32K?

    python3 tools/stream_sro_sweep.py [--sro 0 0.5 1 2 5 19] [--frames 6]
                                      [--report PATH]

Makes the flagship frames once (chip_smoke.make_signal: 32K, GI 1/128,
PP7 extended, rotated 256QAM, LDPC 64800 r2/3, 27 dB AWGN), then for each
sampling-clock error builds the u8 10 Msps capture of chip_smoke's phase 4
(CFO +31 kHz, DC and IQ imbalance) and streams it through
``StreamingReceiver.run`` on the GPU.  Prints, per error, whether it
locked, and per batch of two frames the LDPC failures, the SNR, the
receiver's SRO estimate and the host time; one JSON line each.  Needs a
GPU, nvcc and g++.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sro", type=float, nargs="+",
                    default=[0.0, 0.5, 1.0, 2.0, 5.0, 19.0])
    ap.add_argument("--frames", type=int, default=6,
                    help="frames in each capture (a multiple of 2)")
    ap.add_argument("--report", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("stream_sro_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build
    from sdr_receiver_dvb_t2_tpu_torch.io import native
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    _build.build_all()
    native.build()
    mode, plp = cs.flagship_config()
    frames, _, ts = cs.make_signal(mode, plp)
    out_dir = ROOT / "build" / "stream_sro_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for sro in args.sro:
        path = out_dir / "sweep_0_10000000_8.raw"
        cs.stream_capture(frames, path, args.frames, sro_ppm=sro)
        t0 = time.perf_counter()
        try:
            rx, stats, got, timing = cs.run_stream(path, "cuda")
            err = None
        except NotImplementedError as e:          # a refused (SFN) plan
            stats, got, timing, err = None, b"", {}, str(e)
        runs, missing = (cs._ts_runs(got, ts) if len(got)
                         else ([], 0))
        row = dict(sro_ppm=sro, seconds=time.perf_counter() - t0,
                   error=err, smi=smi)
        if stats is not None:
            row.update(state=stats.state, frames=stats.frames,
                       ldpc_failures=stats.ldpc_failures,
                       bch_dirty=stats.bch_dirty, cfo_hz=stats.cfo_hz,
                       sro_estimate_ppm=float(stats.sro_ppm),
                       acquisitions_s=timing["acquire_s"],
                       batches=timing["batches"], ts_runs=runs,
                       ts_missing=missing)
        rows.append(row)
        print(json.dumps(row), flush=True)
        path.unlink()
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
