#!/usr/bin/env python3
"""How should the LDPC decoder's tile barrier wait, and who takes the last
codewords?

    python3 tools/ldpc_tile_barrier.py [--report PATH]

``ops/csrc/ldpc_layered.cu`` keeps the Pallas tile exit in one launch: a
persistent grid whose blocks take codewords by an in-order ticket, a
tile's codewords meeting after every sweep ("Tile exit" in its header).
This script builds three variants from the one source (two made here by
rewriting a copy; the package has no such switch), all with the same
outputs:

* ``lockstep`` -- the source as it is: every codeword waits at each sweep
  until all of its tile have come;
* ``tail_spread`` -- the same, but when fewer codewords are left than
  blocks, a block that is not the first of its SM (counted by ``%smid``
  at its start) waits 5 us for each block before it on the SM before it
  takes a ticket, so that the last tiles spread over the SMs (which block
  takes a ticket is free; their order is not);
* ``dirty_sweeps_on`` -- a dirty codeword does not wait (its tile cannot
  stop in that sweep); a clean one waits until a dirty one shows or all
  have come.

Each is held bit-exact against the plain twin under the tile contract,
then all are timed on one NVIDIA GPU in turns (each order and its reverse,
twice) on five loads: 1616 NORMAL r2/3 codewords that take two sweeps
each (as the flagship batch's do), 1616 where every tile holds codewords
that take three (as nearly every tile of the SFN batch does), the mixed
load of chip_smoke.py (a quarter hopeless), 1616 T2-Lite B8 codewords at
mixed noise, and the first load eight times over in 64 segments of 202
(the pod's per-shard tiles).
Needs nvcc and a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_ADD = """    const unsigned add = dirty ? 1u + DIRTY : 1u;
    unsigned v = atomicAdd(word, add) + add;
    while ((int)(v & (DIRTY - 1)) != members) {"""
# (text in the source, its replacement) for each rewritten variant
REWRITES = {
    "tail_spread": [
        ("  unsigned* ticket;   // the next codeword to take\n",
         "  unsigned* ticket;   // the next codeword to take\n"
         "  unsigned* on_sm;    // [1024] blocks counted on each SM\n"),
        ("  // row tables, once a block\n",
         "  int rank = 0;\n"
         "  if (threadIdx.x == 0) {\n"
         "    unsigned sm;\n"
         "    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
         "    rank = (int)atomicAdd(p.on_sm + (sm & 1023u), 1u);\n"
         "  }\n"
         "  // row tables, once a block\n"),
        ("    if (tid == 0) taken = (int)atomicAdd(p.ticket, 1u);",
         "    if (tid == 0) {\n"
         "      unsigned next;\n"
         "      asm volatile(\"ld.relaxed.gpu.u32 %0, [%1];\" : \"=r\"(next)\n"
         "                   : \"l\"(p.ticket) : \"memory\");\n"
         "      if (rank > 0 && p.W - (int)next < (int)gridDim.x)\n"
         "        __nanosleep(rank * 5000u);\n"
         "      taken = (int)atomicAdd(p.ticket, 1u);\n"
         "    }"),
        ("  const size_t counters = 1 + (size_t)p.n_tiles",
         "  const size_t counters = 1 + 1024 + (size_t)p.n_tiles"),
        ("  return W * SYN_WORDS + (W + SCR_TW - 1) / SCR_TW + 1 +\n",
         "  return W * SYN_WORDS + (W + SCR_TW - 1) / SCR_TW + 1 + 1024 +\n"),
        ("  p.barrier = ticket + 1;",
         "  p.on_sm = ticket + 1;\n  p.barrier = ticket + 1 + 1024;"),
    ],
    "dirty_sweeps_on": [
        ("  if (threadIdx.x == 0) {\n" + _ADD,
         "  if (dirty) {\n"
         "    if (threadIdx.x == 0) atomicAdd(word, 1u + DIRTY);\n"
         "    return false;\n"
         "  }\n"
         "  if (threadIdx.x == 0) {\n"
         "    unsigned v = atomicAdd(word, 1u) + 1u;\n"
         "    while (v < DIRTY && (int)v != members) {")],
}


def build_variants(out_dir: Path) -> dict:
    """Compile the source as it is and each rewritten variant, at once."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "ldpc_layered.cu").read_text()
    sources = {"lockstep": _build.CSRC / "ldpc_layered.cu"}
    for name, rewrites in REWRITES.items():
        text = src
        for old, new in rewrites:
            if text.count(old) != 1:
                raise RuntimeError(f"the kernel source changed: {old!r} "
                                   f"occurs {text.count(old)} times, not once")
            text = text.replace(old, new)
        sources[name] = out_dir / f"ldpc_layered_{name}.cu"
        sources[name].write_text(text)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / f"libldpc_{name}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"libldpc_{name}.so"))
        for fn, (args, res) in _build._SIGNATURES["ldpc_layered"].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        libs[name] = lib
    return libs


def sweep_load(n_cw: int, noise: float, seed: int):
    """int8 LLRs of NORMAL r2/3 codewords: the noise-free quarter of
    chip_smoke's mixed load, repeated, at amplitude 12 with Gaussian noise
    of the given deviation (4.2: two sweeps each; 5.4: two or three)."""
    import numpy as np
    from chip_smoke import mixed_load
    llr, plp = mixed_load()
    sign = np.sign(llr[:404:4].astype(np.float32))
    sign = np.tile(sign, (-(-n_cw // len(sign)), 1))[:n_cw]
    rng = np.random.default_rng(seed)
    noisy = sign * 12.0 + rng.normal(0.0, noise, sign.shape)
    return noisy.round().clip(-127, 127).astype(np.int8), plp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ldpc_tile_barrier: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (check_kernel_against_twin, coded_llrs, cuda_ms,
                            mixed_load, nvidia_smi_line)
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build, bch_ops, ldpc
    smi = nvidia_smi_line()
    libs = build_variants(_build.BUILD_DIR / "tile_barrier")
    two, plp = sweep_load(1616, 4.2, seed=5)
    three, _ = sweep_load(1616, 5.4, seed=6)
    b8, plp_b8 = coded_llrs("C1_3", "SHORT", 1616, seed=31)
    loads = {
        "two sweeps each": (two, plp, None),
        "every tile three sweeps": (three, plp, None),
        "mixed": (mixed_load()[0], plp, None),
        "B8 at mixed noise": (b8, plp_b8, None),
        "first load x8 in 64 segments of 202": (
            np.tile(two, (8, 1)), plp, [202] * 64),
    }
    names = list(libs)
    report = dict(device=smi, variants=names, loads={})
    for label, (x, lp, segs) in loads.items():
        llr = torch.from_numpy(x).cuda()
        h = bch_ops._h_matrix(lp.k_bch, lp.bch_m, lp.bch_t)
        dec = ldpc.LayeredDecoder(lp.ldpc_table_name, bch_h=h)
        times = {name: [] for name in names}
        parity = None
        for name in names:
            _build._loaded["ldpc_layered"] = libs[name]   # the wrapper's
            # the bytes, ok, iters and clean against the twin under the
            # tile contract (raises on a difference)
            parity = check_kernel_against_twin(llr, lp, segments=segs)[0]
        for order in (names, names[::-1]) * 2:
            for name in order:
                _build._loaded["ldpc_layered"] = libs[name]
                times[name].append(cuda_ms(
                    lambda: dec(llr, segments=segs), reps=10,
                    what=f"the {name} variant on {label}"))
        mean = {name: float(np.mean(t)) for name, t in times.items()}
        report["loads"][label] = dict(
            table=lp.ldpc_table_name, n_cw=int(llr.shape[0]),
            sweeps=parity["sweeps"], iters_hist=parity["iters_hist"],
            ms=times, mean_ms=mean)
        print(f"{label}: {lp.ldpc_table_name} W={llr.shape[0]}, "
              f"{parity['sweeps']} sweeps (iters {parity['iters_hist']}), "
              f"every variant bit-exact against the twin; mean call ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
              + f" (runs {times})", flush=True)
        del llr
    print(smi, flush=True)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
