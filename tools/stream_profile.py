#!/usr/bin/env python3
"""Where does the streaming receiver spend a batch?

    python3 tools/stream_profile.py [--sro 0.5] [--frames 6] [--report PATH]

Streams chip_smoke's phase-4 capture (the flagship frames tiled, 10 Msps
u8, CFO +31 kHz), by default at a clock error of 0.5 ppm, which the
receiver holds from the first batch, so that the profile shows the steady
state and not the pull-in, through ``StreamingReceiver.run`` on the GPU three times:
once to warm up (kernel builds, cuFFT plans), once under
``torch.profiler`` for the device's busy time (the sum of its kernels' and
copies' device time against the run's wall time), and once under
``cProfile`` for the host's time by function.  Prints one JSON object.
Needs a GPU, nvcc and g++.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sro", type=float, default=0.5, help="ppm")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--report", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("stream_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from sdr_receiver_dvb_t2_tpu_torch.io import native
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    _build.build_all()
    native.build()
    mode, plp = cs.flagship_config()
    frames, _, _ = cs.make_signal(mode, plp)
    out_dir = ROOT / "build" / "stream_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "profile_0_10000000_8.raw"
    sro = args.sro
    cs.stream_capture(frames, path, args.frames, sro_ppm=sro)

    t0 = time.perf_counter()
    cs.run_stream(path, "cuda")                        # warm-up
    warm_s = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats, _, timing = cs.run_stream(path, "cuda")
        wall_s = time.perf_counter() - t0
    # the device's own rows (kernels, copies, sets): a CPU op's self device
    # time repeats the time of the kernels it launched, so only these add up
    from torch.autograd import DeviceType
    dev_time = lambda e: getattr(e, "self_device_time_total",          # noqa
                                 getattr(e, "self_cuda_time_total", 0))
    rows_dev = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_us = sum(dev_time(e) for e in rows_dev)
    by_kernel = sorted(((e.key, dev_time(e), e.count) for e in rows_dev),
                       key=lambda r: -r[1])[:args.top]

    prof_c = cProfile.Profile()
    t0 = time.perf_counter()
    prof_c.enable()
    _, stats_c, _, timing_c = cs.run_stream(path, "cuda")
    prof_c.disable()
    cprof_s = time.perf_counter() - t0
    st = pstats.Stats(prof_c)
    rows = []
    for (fname, line, func), (cc, nc, tt, ct, _) in st.stats.items():
        rows.append(dict(func=f"{Path(fname).name}:{line}:{func}",
                         calls=nc, tottime_s=tt, cumtime_s=ct))
    top_tot = sorted(rows, key=lambda r: -r["tottime_s"])[:args.top]
    top_cum = sorted(rows, key=lambda r: -r["cumtime_s"])[:args.top]
    path.unlink()

    out = dict(
        smi=smi, sro_ppm=sro, frames=stats.frames,
        ldpc_failures=stats.ldpc_failures, warm_run_s=warm_s,
        profiled_run=dict(wall_s=wall_s, device_rows=len(rows_dev),
                          device_busy_s=device_us / 1e6,
                          device_idle_share=1 - device_us / 1e6 / wall_s,
                          acquisitions_s=timing["acquire_s"],
                          batches_ms=[b["ms"] for b in timing["batches"]],
                          top_device=[dict(name=k, device_ms=v / 1e3,
                                           count=n)
                                      for k, v, n in by_kernel]),
        cprofile_run=dict(wall_s=cprof_s,
                          batches_ms=[b["ms"] for b in timing_c["batches"]],
                          top_tottime=top_tot, top_cumtime=top_cum))
    print(json.dumps(out), flush=True)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
