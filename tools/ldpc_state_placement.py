#!/usr/bin/env python3
"""Where should the LDPC kernel keep its compressed check state?

    python3 tools/ldpc_state_placement.py [--report PATH]

``ops/csrc/ldpc_layered.cu`` keeps one state word per check in a per-thread
array (local memory), which leaves room for three blocks on an SM.  The
alternative is the same words in dynamic shared memory beside the
posteriors: 156.6 KB a block for NORMAL r2/3, one block on an SM.  This
script builds both from the one source (the shared-memory variant is made
here by rewriting five places of a copy; the package has no such switch),
holds each bit-exact against the plain twin, and times both on one NVIDIA
GPU in turns, on two loads of 1616 NORMAL r2/3 codewords: one where every
codeword takes two sweeps (as the flagship batch does) and the mixed load
of chip_smoke.py (a quarter hopeless, 15 sweeps).  Needs nvcc and a GPU.
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

# (text in the source, its replacement): the state array becomes a region
# of shared memory behind the posteriors, indexed [row][lane]
REWRITES = [
    ("  Word state[WIDE ? MAXQ_WIDE : MAXQ_NARROW];\n"
     "  int2* stab = reinterpret_cast<int2*>(smem + n16);",
     "  Word* state = reinterpret_cast<Word*>(smem + n16);\n"
     "  int2* stab = reinterpret_cast<int2*>(state + q * M);"),
    ("wnext = state[i + 1 < q ? i + 1 : 0];",
     "wnext = state[(i + 1 < q ? i + 1 : 0) * M + m];"),
    ("        state[i] = ", "        state[i * M + m] = "),
    ("__launch_bounds__(THREADS, MAXC <= 9 ? 3 : 2)",
     "__launch_bounds__(THREADS, 1)"),
    ("  return n16 + (size_t)q * cnl * sizeof(int2) + (size_t)q * 4;",
     "  return n16 + (size_t)q * cnl * sizeof(int2) + (size_t)q * 4 +\n"
     "         (size_t)q * M * (cnl > 13 ? 8 : 4);"),
]


def build_variants(out_dir: Path) -> dict:
    """Compile the source as it is ("local") and rewritten ("shared")."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "ldpc_layered.cu").read_text()
    shared = src
    for old, new in REWRITES:
        if shared.count(old) != 1:
            raise RuntimeError(f"the kernel source changed: {old!r} occurs "
                               f"{shared.count(old)} times, not once")
        shared = shared.replace(old, new)
    sources = {"local": _build.CSRC / "ldpc_layered.cu",
               "shared": out_dir / "ldpc_layered_shared.cu"}
    sources["shared"].write_text(shared)
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


def two_sweep_load(n_cw: int, seed: int):
    """int8 LLRs of NORMAL r2/3 codewords at a noise level where nearly
    every codeword is clean after its second sweep."""
    import numpy as np
    from chip_smoke import coded_llrs
    llr, plp = coded_llrs("C2_3", "NORMAL", 404, seed)
    sign = np.sign(llr[0::4].astype(np.float32))          # the noise-free ones
    sign = np.tile(sign, (-(-n_cw // len(sign)), 1))[:n_cw]
    rng = np.random.default_rng(seed)
    noisy = sign * 12.0 + rng.normal(0.0, 4.2, sign.shape)
    return noisy.round().clip(-127, 127).astype(np.int8), plp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ldpc_state_placement: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (check_kernel_against_twin, coded_llrs, cuda_ms,
                            nvidia_smi_line)
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build, bch_ops, ldpc
    smi = nvidia_smi_line()
    libs = build_variants(_build.BUILD_DIR / "state_placement")
    easy, plp = two_sweep_load(1616, seed=5)
    mixed, _ = coded_llrs("C2_3", "NORMAL", 404, seed=21)
    loads = {"two sweeps each": torch.from_numpy(easy).cuda(),
             "mixed": torch.from_numpy(np.tile(mixed, (4, 1))).cuda()}
    h = bch_ops._h_matrix(plp.k_bch, plp.bch_m, plp.bch_t)
    dec = ldpc.LayeredDecoder(plp.ldpc_table_name, bch_h=h)
    report = dict(device=smi, loads={})
    for label, llr in loads.items():
        times = {name: [] for name in libs}
        sweeps = None
        for name in ("local", "shared", "shared", "local"):
            _build._loaded["ldpc_layered"] = libs[name]   # the wrapper's library
            if len(times[name]) == 0:
                # the bytes, ok, iters and clean against the twin under the
                # tile contract, and the sweeps that contract runs
                sweeps = check_kernel_against_twin(llr, plp)[0]["sweeps"]
            times[name].append(cuda_ms(lambda: dec(llr), reps=10))
        report["loads"][label] = dict(n_cw=int(llr.shape[0]), sweeps=sweeps,
                                      ms=times)
        print(f"{label}: W={llr.shape[0]}, {sweeps} sweeps, both bit-exact "
              f"against the twin; call ms local {times['local']} shared "
              f"{times['shared']}", flush=True)
    print(smi, flush=True)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
