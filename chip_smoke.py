#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sdr_receiver_dvb_t2_tpu_torch/ops/csrc``
with nvcc and its native host runtime (``native/dvbt2_runtime.cc``) with
g++, all at once, then (one call of the LDPC kernels launches the decoder
once, ``ldpc.decoder_passes()``, and the screen once; the launch counts
below are held to that; phases 2, 5 and 9 wait on each LDPC call at most
``HANG_LIMIT_S`` and fail the run with the load's name if it hangs):

1. prints the card (name, power limit) and the build time;
2. holds the LDPC kernel and its BCH screen bit-exact (the BB bytes, ok,
   iters, clean) against their plain PyTorch twin under the Pallas tile
   contract (``exit_tile=128``) on all 15 code tables, the T2-Lite B8
   and B9 included (NORMAL_C2_3 with 256 codewords, the others 64),
   mixing noise-free, noisy and hopeless codewords: the tables differ in
   the width of the kernel's state word and in its unrolled slot count.
   Then on three SHORT r2/3 loads where the tile contract is not leaving
   per codeword (tests/test_torch_ldpc_tile.py): a noisy load on which
   some codewords' bits differ from the twin's with ``exit_tile=1`` (the
   kernel's must differ on the same rows), the same load as two segments,
   and a tile held past its largest first clean sweep by a codeword that
   relapsed; then on the persistent grid's hard shapes: NORMAL r3/4 (the
   template with two blocks an SM) at four times the card's resident
   decoder blocks or more, in segments of 202 (tiles of 128 + 74), and
   the mixed load of phase 5 in segments of 74;
3. receives two frames of the flagship mode (32K, GI 1/128, PP7 extended,
   rotated 256QAM, LDPC 64800 r2/3, 202 FEC blocks per frame) made by the
   port's transmitter with 27 dB AWGN, through ``TorchReceiver`` on the
   card: 404/404 LDPC ok and BCH clean, TS bytes equal to the transmitted
   stream, and both kernels launched, once each.  Then times an 8-frame
   batch (1616 codewords) stage by stage, reads its peak device memory,
   and times ``receive_stream`` over a few batches;
   It also times the native BB parser against the Python one on the
   batch's 1616 BB frames;
4. streams a raw SDR capture through the port's entry point
   (``StreamingReceiver.run`` on a ``RawFileSource``): the two frames of
   phase 3 tiled to sixteen (a consistent superframe, FRAME_IDX 0, 1, 0,
   ...), impaired by the port's channel as the JAX package's stream test
   impairs its capture (10 Msps, CFO +31 kHz, SRO +19 ppm, DC and IQ
   imbalance) and quantised to u8.  The receiver runs its front end and
   P1 search on the card, acquires the mode blind, tracks, and decodes
   batches of two frames.  Checks: locked on the flagship mode, every
   frame decoded, the SRO pull-in (the leading batches with failed
   codewords) at most four batches and no failed codeword after it, no
   TS packet that was not transmitted and, after the pull-in, every
   transmitted superframe's TS whole, CFO within 500 Hz, one decoder
   call a batch.  Holds one front-end block and the P1 search on the
   card against the CPU, and times acquisition, the front end, the P1
   search, each batch, and the raw input read over the whole run, after
   lock and after the pull-in;
5. (after phases 6-9) at the flagship batch's size holds the kernels
   against the twin again
   and times them: the whole call, the call without the screen (so the
   screen's own time), the twin, the bounds and the BCH product's
   ``torch.matmul``, and each kernel's device time and launches a call in
   torch.profiler's trace (a trace of 10 calls, opened by a small kernel
   since the profiler can lose the first records, must hold both kernels
   and every launch; up to ``TRACE_TRIES`` are taken); then the same on a
   second load of 1616 codewords of which a quarter are hopeless and run
   all 15 sweeps, so that unequal sweeps are on record;
   then times both kernels on 1616 codewords of each T2-Lite table;
6. receives two full-width SFN frames (bench.py ``_bench_sfn``: 32K, GI
   1/32, PP7 extended, whose own pilots fall short of the guard, so the
   Wiener-row plan) through a -10 dB echo at 0.6 of the guard and 27 dB
   AWGN: every codeword clean, the TS exact, one call of the kernels;
   holds one frame's equalized plane, csi and delay profile on the card
   against the CPU, and times an 8-frame batch stage by stage;
7. the same for MISO (bench.py ``_bench_miso``: 32K, GI 1/128, PP8
   extended, two transmit groups with their own two-path channels);
8. streams the 2K GI 1/8 PP7 u8 capture of tests/_port_capture.py
   through ``StreamingReceiver`` on the card: locked with the SFN plan,
   the TS exact, the first-path timing loop's moves reported, one decoder
   call a batch;
9. the multi-channel pod through the user's entry point,
   ``cli.main(["--pod", toml])``: eight u8 captures of the flagship
   superframe tiled to six frames (10 Msps), each channel behind its own
   noise-only lead (0.1-1.5 frames) with its own CFO (within +-45 kHz),
   SRO (within +-2 ppm) and 27 dB AWGN, written under ``build/``; one
   card, all eight channels a step (one frame each: 1616 codewords, one
   call of the kernels a step), tracking, L1 tracking and relock on.
   Checks: every channel locked, none mismatched, no TS packet that was
   not transmitted and every superframe's TS whole after at most one
   settling step, no failed codeword after it, each channel's applied
   CFO within 500 Hz of its truth, one call of the kernels a step.
   Holds the step's LDPC call against the twin (bytes, ok, iters, clean
   exact) at 8, 32 and 64 channels, with the grid's segments (one a grid
   cell: one on this one-card grid) and with one segment a shard.  Times blind acquisition (a channel and in all), each step's stages on
   the host clock (window assembly, plane, L1 decode, FEC on the card,
   host BCH, the entry point's parse and write) and in CUDA events (H2D
   copy, front end, demod + equalize, demap, the kernels with and without
   the screen beside the screen's torch.matmul; no packing), the step
   wall time and real-time factor, peak device memory; then the step at
   32 and at 64 channels (the eight windows repeated, no acquisition):
   how many flagship channels one card carries in real time.  Then the
   contiguous ``step()`` of a (2, 2) grid on the one card at 2K (the halo
   path), against the CPU;
10. the receive grid across processes at the flagship's width: two
   flagship channels (10 Msps, 27 dB AWGN, CFO 0 and +2 kHz) on a
   (2 channels, 2 time blocks) grid through the contiguous ``step()``,
   once in this process and once as two spawned rank processes on the
   one card (``torch.distributed`` with ``gloo`` through a ``file://``
   store, ``layout="time"``: each rank holds one time block of both
   channels, so the halo and the per-channel means cross ranks).
   Checks: the union of the ranks' hard bits equal to the one-process
   step's, every rank's stats equal to it, the TS exact, no failed
   codeword, one call of the kernels a rank.  Times both steps on the
   host clock.  A rank that fails or outlives its time limit fails the
   phase;
11. prints the kernel table as one JSON line (launches counted on the
   streaming path, and per path), the card's nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

The port's transmitter makes the 32K signals of phases 3, 6 and 7 in
worker processes started first, beside the builds and phases 1-2; the
same workers make phase 9's and phase 10's captures from phase 3's
noise-free frames while phases 4-8 run.

Any failed phase exits non-zero.  Without a GPU, or without the port's
package beside it, it exits non-zero before printing any result.
``--report PATH`` also writes every measurement as JSON to PATH.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "sdr_receiver_dvb_t2_tpu_torch"
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet): HBM rate and the non-tensor-core
# 32-bit rate, used for the kernel's bound
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# integer operations the layered update spends per edge and sweep:
# pass 1 (load, subtract, |t|, offset, clamp, compare, two selects, sign
# xor) and pass 2 (argmin compare, select, sign xor, negate, clip, add,
# clip, store)
OPS_PER_EDGE_SWEEP = 16
# the streamed capture (phase 4): the impairments of the JAX package's own
# stream test (tests/test_stream_e2e.py) at 10 Msps, u8 at scale 0.4, and
# its sampling-clock error of +19 ppm.  At 32K that error costs the first
# batches while the SRO loop pulls in (any receiver that samples the FFT
# window at the wrong rate: tools/sro_drift_witness.py), so the capture
# holds STREAM_FRAMES frames and the phase allows up to STREAM_PULL_IN_MAX
# leading batches with failed codewords (PERF.md section 6)
STREAM_RATE = 10_000_000
STREAM_SRO_PPM = 19.0
STREAM_FRAMES = 16
STREAM_PULL_IN_MAX = 4
STREAM_SCALE = 0.4

# the 13 T2 tables and the T2-Lite-only B8 (r1/3) and B9 (r2/5)
ALL_TABLES = [("NORMAL", r) for r in ("C1_2", "C3_5", "C2_3", "C3_4", "C4_5",
                                       "C5_6")] + [
    ("SHORT", r) for r in ("C1_4", "C1_2", "C3_5", "C2_3", "C3_4", "C4_5",
                           "C5_6", "C1_3", "C2_5")]
LITE_TABLES = [("SHORT", "C1_3"), ("SHORT", "C2_5")]
# the pod (phase 9): POD_CHANNELS flagship channels decoded a step on one
# card, the superframe tiled to POD_FRAMES frames; the step timed again at
# POD_CAPACITY_CHANNELS, the BASELINE's 64 among them (the channels
# decoded through the entry point are cut to POD_CHANNELS for the run's
# time limit: signal generation and blind acquisition grow with the
# channel count)
POD_CHANNELS = 8
POD_CAPACITY_CHANNELS = (32, 64)
POD_FRAMES = 6
POD_SNR_DB = 27.0
POD_CFO_MAX_ERR_HZ = 500.0
# the two-rank phase (10): two flagship channels with these CFOs on a
# (2 channels, 2 time blocks) grid, one time block a rank; a rank that
# waits longer than RANKS_GROUP_TIMEOUT_S in a collective raises, and the
# phase fails when the ranks have not ended after RANKS_JOIN_TIMEOUT_S
RANKS_CFO_HZ = (0.0, 2e3)
RANKS_WORLD = 2
RANKS_TIMING_REPS = 5
RANKS_GROUP_TIMEOUT_S = 240.0
RANKS_JOIN_TIMEOUT_S = 420.0
# card against CPU on one full-width frame (phases 6-7): the same float32
# stages summed in another order; relative rms of the plane and of csi,
# and the delay profile's largest difference over its peak
PLANE_REL_DB_MAX = -80.0
CIR_REL_MAX = 1e-4
# phases 2, 5 and 9 wait on each LDPC call at most this long: a kernel
# that deadlocks fails the run instead of holding it
HANG_LIMIT_S = 60.0
# torch.profiler traces of phase 5's calls taken before one that holds
# every launch fails the phase
TRACE_TRIES = 3


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sync():
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _hung(what, limit_s):
    """A kernel that never ends cannot be synchronized or interrupted:
    name ``what``, kill the worker processes and leave with exit code 1."""
    import multiprocessing
    log(f"chip_smoke: {what} did not finish within {limit_s:.0f} s on the "
        f"card: a hang")
    for proc in multiprocessing.active_children():
        proc.kill()
    os._exit(1)


def wait_card(what, limit_s=HANG_LIMIT_S):
    """Waits for the work queued on the current stream by polling a CUDA
    event, at most ``limit_s`` (then _hung)."""
    import torch
    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while not done.query():
        if time.monotonic() - t0 > limit_s:
            _hung(what, limit_s)
        time.sleep(0.0005)


class hang_guard:
    """``with hang_guard(what, limit_s):`` around code that waits for
    the card inside the port (a step that copies its results to the
    host): a timer thread calls _hung if the block outlives the limit."""

    def __init__(self, what, limit_s):
        import threading
        self.timer = threading.Timer(limit_s, _hung, (what, limit_s))
        self.timer.daemon = True

    def __enter__(self):
        self.timer.start()

    def __exit__(self, *exc):
        self.timer.cancel()


def cuda_ms(fn, reps=5, warmup=1, what="a timed call"):
    """Mean device milliseconds of fn() over reps, after warmup; a hang
    fails the run (wait_card)."""
    import torch
    for _ in range(warmup):
        fn()
    wait_card(what)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    wait_card(what)
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# test codewords
# ---------------------------------------------------------------------------
def coded_llrs(code_rate: str, fec_frame: str, n_cw: int, seed: int):
    """int8 channel LLRs [n_cw, N] in kernel bit order of random BCH+LDPC
    codewords: a quarter noise-free, a quarter hopeless (pure noise), the
    rest at noise levels from easy to marginal.  Returns (llr, plp); for
    SHORT C1_4, the L1-pre code that no PLP uses, plp is a stand-in with
    the table's name and BCH parameters."""
    import types
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.ops.ldpc import kernel_bit_order
    from sdr_receiver_dvb_t2_tpu_torch.params import bch, ldpc as ldpc_par
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        CodeRate, FecFrame, PlpConfig)
    if (fec_frame, code_rate) == ("SHORT", "C1_4"):
        plp = types.SimpleNamespace(ldpc_table_name="SHORT_C1_4", k_bch=3072,
                                    bch_m=14, bch_t=12)
    else:
        plp = PlpConfig(code_rate=CodeRate[code_rate],
                        fec_frame=FecFrame[fec_frame])
    code = ldpc_par.get_code(plp.ldpc_table_name)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (n_cw, plp.k_bch), dtype=np.uint8)
    cw = code.encode(bch.encode(payload, plp.bch_m, plp.bch_t))
    kind = np.arange(n_cw) % 4          # 0 clean, 1 hopeless, 2-3 noisy
    sigma = np.where(kind == 0, 0.0,
                     rng.choice([3.0, 5.0, 6.5, 8.0], n_cw))
    llr = (1 - 2 * cw.astype(np.float32)) * 12.0 + rng.normal(
        0.0, 1.0, cw.shape) * sigma[:, None]
    llr[kind == 1] = rng.normal(0.0, 20.0, (int(np.sum(kind == 1)), code.n))
    llr = llr[:, kernel_bit_order(plp.ldpc_table_name)]
    return np.ascontiguousarray(llr.round().clip(-127, 127).astype(np.int8)), plp


def unpack_bits(packed):
    """uint8 [W, k / 8] MSB-first bytes -> int8 hard bits [W, k], on their
    device (np.unpackbits)."""
    import torch
    shifts = torch.arange(7, -1, -1, device=packed.device, dtype=torch.uint8)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[0], -1).to(torch.int8)


def tile_sweeps(ok, iters, max_iters, segments=None) -> int:
    """Sweeps the tile contract runs on this load: each 128-codeword tile
    its largest (iters where ok, else max_iters) times its codewords.  A
    tile held past that by a codeword that relapsed counts less than it
    ran, so a bound from this stays a lower bound."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    ran = np.where(ok.cpu().numpy(), iters.cpu().numpy(), max_iters)
    tile = ldpc.tile_index(segments, len(ran))
    top = np.zeros(int(tile.max()) + 1 if len(ran) else 0, np.int64)
    np.maximum.at(top, tile, ran)
    return int(top[tile].sum())


def check_kernel_against_twin(llr, plp, max_iters=15, segments=None):
    """Kernel and twin under the tile contract (exit_tile=128, the
    segments' tiles) on the same int8 LLRs on the card: the BB bytes
    (the twin's bits packed by bch_ops.pack_bits), ok, iters and clean.
    Returns (result dict, kernel outputs, twin outputs); raises on any
    difference, and fails the run if the kernel hangs (wait_card)."""
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, ldpc
    h = bch_ops._h_matrix(plp.k_bch, plp.bch_m, plp.bch_t)
    dec = ldpc.LayeredDecoder(plp.ldpc_table_name, max_iters=max_iters,
                              bch_h=h)
    load = (f"the LDPC call on {plp.ldpc_table_name}, W={llr.shape[0]}, "
            f"segments {segments}")
    got = dec(llr, segments=segments)
    wait_card(load)
    want = ldpc.decode_plain(llr, plp.ldpc_table_name, max_iters, h,
                             exit_tile=ldpc.TILE, segments=segments)
    wait_card(f"the twin of {load}")
    names = ("bytes", "ok", "iters", "clean")
    diff = {n: int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
            for n, g, w in zip(names, got,
                               (bch_ops.pack_bits(want[0]), *want[1:]))}
    res = dict(table=plp.ldpc_table_name, n_cw=int(llr.shape[0]),
               segments=segments, max_abs_err=max(diff.values()),
               per_output=diff, ok=int(got[1].sum()), clean=int(got[3].sum()),
               iters_hist=torch.bincount(got[2].long().cpu()).tolist(),
               sweeps=tile_sweeps(got[1], got[2], max_iters, segments))
    if any(diff.values()):
        raise AssertionError(f"kernel differs from its twin: {res}")
    return res, got, want


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build(report):
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 products stay
    torch.backends.cudnn.allow_tf32 = False          # full float32
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    from concurrent.futures import ThreadPoolExecutor
    from sdr_receiver_dvb_t2_tpu_torch.io import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.build)     # g++ beside the nvcc runs
        logs = _build.build_all()
        host_lib = str(host_lib.result())
    build_s = time.perf_counter() - t0
    report["device"] = dict(name=name, smi=smi,
                            count=torch.cuda.device_count(),
                            torch=torch.__version__, cuda=torch.version.cuda)
    report["build"] = dict(seconds=build_s, ptxas=logs, host_lib=host_lib)
    log(f"phase 1 device+build: {name} | {smi} | nvcc and g++ "
        f"{build_s:.1f} s ({len(logs)} CUDA sources built; {host_lib})")


@functools.lru_cache(maxsize=1)
def mixed_load():
    """The mixed load (phases 2 and 5): 404 flagship-table codewords of
    coded_llrs (a quarter hopeless) four times over, 1616 rows."""
    import numpy as np
    llr, plp = coded_llrs("C2_3", "NORMAL", 404, seed=21)
    return np.tile(llr, (4, 1)), plp


def grid_load(rate, n_seg, seed):
    """n_seg segments of 202 codewords of a NORMAL table (tiles of 128 +
    74): the odd segments the 202 rows of coded_llrs (a quarter hopeless,
    so their tiles run every sweep), the even ones the same rows with the
    hopeless quarter replaced by the noise-free rows before them, so that
    their tiles may stop early."""
    import numpy as np
    llr, plp = coded_llrs(rate, "NORMAL", 202, seed=seed)
    easy = llr.copy()
    easy[1::4] = llr[0::4][:len(easy[1::4])]
    return np.concatenate([easy if s % 2 == 0 else llr
                           for s in range(n_seg)]), plp


def noisy_load(seed, lo, hi, w=128):
    """SHORT r2/3's all-zero codeword at noise sigma from lo to hi over the
    rows: LLR = round(4 y / sigma^2), y = 1 + sigma * N(0, 1), the noise
    one [w, 16200] draw from default_rng(seed).  All-zero is a codeword in
    any bit order, so these are kernel-ordered LLRs
    (tests/test_torch_ldpc_tile.py holds the twin against Pallas on
    them)."""
    import numpy as np
    s = np.linspace(lo, hi, w)[:, None]
    y = 1 + s * np.random.default_rng(seed).standard_normal((w, 16200))
    return np.clip(np.round(4 * y / s ** 2), -127, 127).astype(np.int8)


def phase_kernel_parity(report):
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, ldpc
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        CodeRate, FecFrame, PlpConfig)
    rows = []
    for frame, rate in ALL_TABLES:
        n_cw = 256 if (frame, rate) == ("NORMAL", "C2_3") else 64
        llr, plp = coded_llrs(rate, frame, n_cw, seed=len(rows) + 1)
        res, _, _ = check_kernel_against_twin(
            torch.from_numpy(llr).to(DEVICE), plp)
        rows.append(res)
    # SHORT r2/3 loads on which the tile contract is not leaving per
    # codeword: the noisy load (12 sweeps), where some codewords' bits
    # differ; the same as two segments; rows 0-31 of a quieter load, where
    # a codeword clean at sweep 3 is dirty at the tile's largest first
    # clean sweep, 4, and the tile leaves at 5
    plp = PlpConfig(code_rate=CodeRate.C2_3, fec_frame=FecFrame.SHORT)
    name = plp.ldpc_table_name
    noisy = torch.from_numpy(noisy_load(2, 0.6, 0.9)).to(DEVICE)
    res, got, want = check_kernel_against_twin(noisy, plp, max_iters=12)
    one = ldpc.decode_plain(noisy, name, 12, exit_tile=1)
    kernel_rows = torch.nonzero(
        (got[0] != bch_ops.pack_bits(one[0])).any(1)).flatten().tolist()
    twin_rows = torch.nonzero(
        (want[0] != one[0]).any(1)).flatten().tolist()
    res.update(label="noisy load", rows_differing_from_exit_tile_1=kernel_rows)
    rows.append(res)
    res, _, _ = check_kernel_against_twin(noisy, plp, max_iters=12,
                                          segments=[60, 68])
    rows.append(dict(res, label="noisy load, two segments"))
    relapse = torch.from_numpy(noisy_load(2, 0.5, 0.8)[:32]).to(DEVICE)
    res, got, _ = check_kernel_against_twin(relapse, plp)
    one = ldpc.decode_plain(relapse, name, 15, exit_tile=1)
    at_t0 = ldpc.decode_plain(relapse, name, 4, exit_tile=ldpc.TILE)
    res.update(label="relapsing tile", first_clean_max=int(one[2].max()),
               dirty_at_t0=int((~at_t0[1]).sum()))
    rows.append(res)
    relapsed = res
    # the persistent grid's hard shapes: a NORMAL table of the template
    # with two blocks an SM (MAXC > 9) at four times the blocks the card
    # holds at once or more, in segments of 202 (tiles of 128 + 74, so
    # tiles start mid-round); the mixed load in segments of 74
    grid = ldpc.LayeredDecoder("NORMAL_C3_4").resident_blocks()
    n_seg = -(-4 * grid // 202)
    llr, plp = grid_load("C3_4", n_seg, seed=41)
    res, _, _ = check_kernel_against_twin(torch.from_numpy(llr).to(DEVICE),
                                          plp, segments=[202] * n_seg)
    rows.append(dict(res, label=f"NORMAL_C3_4 in {n_seg} segments of 202"))
    llr, plp = mixed_load()
    w = llr.shape[0]
    res, _, _ = check_kernel_against_twin(
        torch.from_numpy(llr).to(DEVICE), plp,
        segments=[74] * (w // 74) + [w % 74] * (w % 74 > 0))
    rows.append(dict(res, label="mixed load in segments of 74"))
    report["kernel_parity"] = rows
    report["resident_blocks_normal_c3_4"] = grid
    log(f"phase 2 kernel vs twin under the tile contract (bytes, ok, iters, "
        f"clean exact) on {len(ALL_TABLES)} tables, 3 SHORT r2/3 loads and "
        f"2 segmented loads (NORMAL_C3_4: {grid} decoder blocks fit the "
        f"card at once): "
        + "; ".join(f"{r.get('label', r['table'])} W={r['n_cw']} ok={r['ok']} "
                    f"clean={r['clean']} iters={r['iters_hist']} sweeps "
                    f"{r['sweeps']}" for r in rows)
        + f"; noisy load rows whose bits differ from leaving per codeword: "
        f"kernel {kernel_rows}, twin {twin_rows}")
    if not (kernel_rows and kernel_rows == twin_rows
            and relapsed["ok"] == 32 and relapsed["first_clean_max"] == 4
            and relapsed["dirty_at_t0"] > 0 and n_seg * 202 >= 4 * grid):
        raise AssertionError(f"phase 2: the loads do not show the tile "
                             f"contract: {rows[-5:]}")


def flagship_config():
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        CodeRate, Constellation, FecFrame, FftMode, GuardInterval,
        PilotPattern, PlpConfig, T2Mode)
    mode = T2Mode(fft_mode=FftMode.FFT_32K, guard=GuardInterval.G1_128,
                  pilot_pattern=PilotPattern.PP7, extended_carriers=True,
                  n_data_symbols=59)
    plp = PlpConfig(constellation=Constellation.QAM256, rotation=True,
                    code_rate=CodeRate.C2_3, fec_frame=FecFrame.NORMAL,
                    time_il_length=1, num_blocks_max=254)
    return mode, plp


def sfn_config():
    """bench.py _bench_sfn: 32K, GI 1/32, PP7 extended (its data symbols'
    own pilots resolve less delay than the guard: the Wiener-row plan),
    rotated 256QAM, LDPC 64800 r2/3."""
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import GuardInterval
    mode, plp = flagship_config()
    return dataclasses.replace(mode, guard=GuardInterval.G1_32), plp


def miso_config():
    """bench.py _bench_miso: 32K, GI 1/128, PP8 extended MISO, rotated
    256QAM, LDPC 64800 r2/3."""
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import PilotPattern
    mode, plp = flagship_config()
    return dataclasses.replace(mode, pilot_pattern=PilotPattern.PP8,
                               miso=True), plp


def frame_capacity(mode, plp, n_frames):
    """(FEC blocks that fill a frame after L1, L1-post cells), as bench.py
    _frame_capacity computes them."""
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig)
    from sdr_receiver_dvb_t2_tpu_torch.params import l1 as l1_mod
    tmp = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=1,
                               num_t2_frames=n_frames))
    l1_post = tmp.l1_pre.l1_post_size
    n_fec = (mode.frame_cells - l1_mod.L1_PRE_CELLS - l1_post) \
        // plp.cells_per_fec_block
    return n_fec, l1_post


def _awgn(iq, snr_db, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    npow = np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10)
    return iq + ((rng.standard_normal(iq.shape)
                  + 1j * rng.standard_normal(iq.shape))
                 * np.sqrt(npow / 2)).astype(np.complex64)


def sfn_channel(n_frames=2, echo=0.32):
    """bench.py _bench_sfn's channel on the port's transmitter output,
    before the noise: n_frames + 1 frames (the first is the echo's
    warm-up) with a ``echo``-amplitude copy (0.32: -10 dB) at 0.6 of the
    guard (614 samples).  Returns (IQ, n_fec, TS, l1_post_size)."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    mode, plp = sfn_config()
    n_fec, l1_post = frame_capacity(mode, plp, n_frames + 1)
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=n_fec,
                              num_t2_frames=n_frames + 1))
    ts = random_ts_stream((n_frames + 2) * n_fec * (plp.k_bch // 8) // 188,
                          seed=13)
    iq = tx.modulate(ts)[:(n_frames + 1) * mode.frame_samples]
    d = int(0.6 * mode.guard_size)
    iq = iq + echo * np.concatenate([np.zeros(d, np.complex64), iq[:-d]])
    return iq, n_fec, ts, l1_post


def make_sfn_signal(n_frames=2, snr_db=27.0):
    """bench.py _bench_sfn's signal: sfn_channel, 27 dB AWGN, frame 0
    dropped.  Returns (frames, n_fec, TS, l1_post_size, transmitter
    seconds)."""
    import numpy as np
    t0 = time.perf_counter()
    mode, _ = sfn_config()
    iq, n_fec, ts, l1_post = sfn_channel(n_frames)
    frames = _awgn(iq, snr_db, 29)[mode.frame_samples:].reshape(
        n_frames, mode.frame_samples)
    return (frames.astype(np.complex64), n_fec, ts, l1_post,
            time.perf_counter() - t0)


def miso_channel(n_frames=2):
    """bench.py _bench_miso's channel on the port's transmitter output,
    before the noise: each transmit group through its own two-path
    channel, summed.  Returns (IQ, n_fec, TS, l1_post_size)."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    mode, plp = miso_config()
    n_fec, l1_post = frame_capacity(mode, plp, n_frames)
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=n_fec,
                              num_t2_frames=n_frames))
    ts = random_ts_stream((n_frames + 1) * n_fec * (plp.k_bch // 8) // 188,
                          seed=17)
    iq1, iq2 = tx.modulate(ts)
    n = n_frames * mode.frame_samples
    g1 = np.zeros(64, np.complex64)
    g1[0], g1[23] = 0.9 * np.exp(1j * 0.3), 0.22 * np.exp(-1j * 2.1)
    g2 = np.zeros(64, np.complex64)
    g2[4], g2[41] = 0.6 * np.exp(1j * 1.2), 0.18 * np.exp(1j * 0.4)
    iq = np.convolve(iq1[:n], g1)[:n] + np.convolve(iq2[:n], g2)[:n]
    return iq, n_fec, ts, l1_post


def make_miso_signal(n_frames=2, snr_db=27.0):
    """bench.py _bench_miso's signal: miso_channel and 27 dB AWGN.
    Returns (frames, n_fec, TS, l1_post_size, transmitter seconds)."""
    import numpy as np
    t0 = time.perf_counter()
    mode, _ = miso_config()
    iq, n_fec, ts, l1_post = miso_channel(n_frames)
    frames = _awgn(iq, snr_db, 31).reshape(n_frames, mode.frame_samples)
    return (frames.astype(np.complex64), n_fec, ts, l1_post,
            time.perf_counter() - t0)


def make_flagship_signal():
    """make_signal on the flagship, with the transmitter's seconds."""
    t0 = time.perf_counter()
    out = make_signal(*flagship_config())
    return out + (time.perf_counter() - t0,)


def make_signal(mode, plp, n_frames=2, snr_db=27.0):
    """Full frames from the port's transmitter plus seeded AWGN.  Returns
    (frames, n_fec, TS, the frames before the noise)."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from sdr_receiver_dvb_t2_tpu_torch.params import l1 as l1_mod
    tmp = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=1,
                               num_t2_frames=n_frames))
    l1_cells = l1_mod.L1_PRE_CELLS + tmp.l1_pre.l1_post_size
    n_fec = (mode.frame_cells - l1_cells) // plp.cells_per_fec_block
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=n_fec,
                              num_t2_frames=n_frames))
    ts = random_ts_stream((n_frames + 1) * n_fec * (plp.k_bch // 8) // 188,
                          seed=7)
    iq = tx.modulate(ts)[:n_frames * mode.frame_samples]
    iq = iq.reshape(n_frames, mode.frame_samples)
    rng = np.random.default_rng(11)
    npow = np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10)
    noise = (rng.standard_normal(iq.shape)
             + 1j * rng.standard_normal(iq.shape)) * np.sqrt(npow / 2)
    return (iq + noise).astype(np.complex64), n_fec, ts, iq


def phase_receive(report, signal):
    """Phase 3 on ``signal`` (make_flagship_signal's result)."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.io.bbframe import BBFrameParser
    from sdr_receiver_dvb_t2_tpu_torch.io.native import NativeBBFrameParser
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import (
        RxConfig, TorchReceiver)
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc

    mode, plp = flagship_config()
    frames, n_fec, ts, _, tx_s = signal
    rx = TorchReceiver(RxConfig(mode=mode, plp=plp, n_fec_per_frame=n_fec,
                                n_ti=1), device=DEVICE).prime(frames[0])
    _ = rx.consts

    # ---- the main path: counts from this run only ----
    ldpc.LayeredDecoder.launches = ldpc.LayeredDecoder.screen_launches = 0
    res = rx.receive(frames)
    launches = ldpc.LayeredDecoder.launches
    screen_launches = ldpc.LayeredDecoder.screen_launches
    n_cw = 2 * n_fec
    ts_ok = (len(res.ts_bytes) > 0
             and np.array_equal(res.ts_bytes, ts[:len(res.ts_bytes)]))
    finite = all(np.all(np.isfinite(v)) for v in res.diag.values())
    rec = dict(n_cw=n_cw, n_fec=n_fec, ldpc_ok=int(res.ldpc_ok.sum()),
               bch_clean=int(res.bch_clean.sum()),
               ts_bytes=int(len(res.ts_bytes)), ts_exact=bool(ts_ok),
               snr_db=res.snr_db, launches=launches,
               screen_launches=screen_launches, diag_finite=finite,
               iters_hist=np.bincount(res.ldpc_iters).tolist(),
               transmitter_s=tx_s)
    report["receive"] = rec
    log(f"phase 3 flagship receive (2 frames): ldpc_ok {rec['ldpc_ok']}/"
        f"{n_cw} bch_clean {rec['bch_clean']}/{n_cw} ts_bytes "
        f"{rec['ts_bytes']} exact={ts_ok} snr {res.snr_db:.2f} dB "
        f"kernel launches: decoder {launches}, screen {screen_launches}; "
        f"iters {rec['iters_hist']}")
    if not (rec["ldpc_ok"] == n_cw and rec["bch_clean"] == n_cw and ts_ok
            and screen_launches > 0
            and launches == ldpc.decoder_passes() * screen_launches and finite
            and rec["ts_bytes"] > 1000):
        raise AssertionError(f"flagship receive failed: {rec}")

    # ---- timing: an 8-frame batch of 1616 codewords ----
    tm, batch, dev_batch, llr = time_frame_batch(rx, frames)
    samples = batch.size
    dev_s = tm["device_batch_ms"] / 1e3
    # the host tail (Python BB de-encapsulation) takes seconds a batch:
    # few repetitions of the end-to-end calls
    host_reps = 2
    t0 = time.perf_counter()
    for _ in range(host_reps):
        r8 = rx.receive_plane(*rx.compute_plane(dev_batch))
    full_s = (time.perf_counter() - t0) / host_reps
    # BB de-encapsulation of the batch's 1616 BB frames: the native parser
    # (the receiver's) against its plain reference, the Python parser
    host, done = rx.receive_plane_async(*rx.compute_plane(dev_batch))
    if done is not None:
        done.synchronize()
    bb_bytes = np.ascontiguousarray(host["packed"].numpy()[:, :plp.k_bch // 8])
    native_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        ts_native = NativeBBFrameParser().parse_batch(bb_bytes)
        native_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ts_python = BBFrameParser().parse_batch(bb_bytes)
    parse_s = time.perf_counter() - t0
    if not (np.array_equal(ts_native, ts_python) and len(ts_native) > 0):
        raise AssertionError("native and Python BB parsers differ")
    n_stream = 3
    sync()
    t0 = time.perf_counter()
    outs = list(rx.receive_stream([batch] * n_stream))
    stream_s = (time.perf_counter() - t0) / n_stream
    if not (all(o.bch_clean.all() and o.ldpc_ok.all() for o in outs + [r8])
            and tm["ldpc_ok"] == tm["bch_clean"] == tm["batch_codewords"]):
        raise AssertionError("8-frame batches did not decode clean")
    timing = dict(
        tm, receive_plane_ms=full_s * 1e3,
        receive_plane_msps=samples / full_s / 1e6,
        host_tail_ms=(full_s - dev_s) * 1e3, bb_parse_ms=parse_s * 1e3,
        bb_parse_native_ms=min(native_s) * 1e3,
        bb_parse_native_runs_ms=[t * 1e3 for t in native_s],
        bb_frames=int(bb_bytes.shape[0]), ts_bytes_batch=int(len(ts_native)),
        receive_stream_ms_per_batch=stream_s * 1e3,
        receive_stream_msps=samples / stream_s / 1e6,
        realtime_factor_stream=samples / stream_s / (64e6 / 7))
    report["timing"] = timing
    log(f"phase 3 timing ({report['device']['smi']}), 8 frames / "
        f"{llr.shape[0]} codewords: " + ", ".join(
            f"{k} {v:.3f}" for k, v in tm["stages_ms"].items())
        + f", packing none (the decoder writes the BB bytes)"
        + f"; device pipeline {dev_s * 1e3:.2f} ms = "
        f"{timing['device_msps']:.1f} Msps; receive_plane "
        f"{timing['receive_plane_msps']:.1f} Msps (host tail "
        f"{timing['host_tail_ms']:.1f} ms); receive_stream "
        f"{timing['receive_stream_msps']:.1f} Msps = "
        f"{timing['realtime_factor_stream']:.2f}x real time")
    log(f"phase 3 BB de-encapsulation of {bb_bytes.shape[0]} BB frames "
        f"({len(ts_native)} TS bytes, equal): native "
        f"{timing['bb_parse_native_ms']:.2f} ms (runs "
        f"{', '.join(f'{t * 1e3:.2f}' for t in native_s)}), Python "
        f"{timing['bb_parse_ms']:.0f} ms ({report['device']['smi']})")
    log(f"phase 3 peak device memory of one batch "
        f"(torch.cuda.max_memory_allocated): {tm['peak_memory_bytes']} B, of "
        f"which {tm['resident_memory_bytes']} B resident between batches")
    return dict(llr=llr, frames=frames, ts=ts, ts_superframe=res.ts_bytes)


class _CountingSource:
    """A source that counts the raw samples it hands out and notes when it
    handed out the first."""

    def __init__(self, src):
        self.src, self.info, self.samples = src, src.info, 0
        self.t_first = None

    def read(self, n_samples):
        if self.t_first is None:
            self.t_first = time.perf_counter()
        blk = self.src.read(n_samples)
        if blk is not None:
            self.samples += len(blk) // 2
        return blk

    def close(self):
        self.src.close()


def _ts_runs(got, ts):
    """Split the received TS into runs of consecutive transmitted packets.
    Returns (run lengths in packets, packets not in the transmitted TS)."""
    import numpy as np
    index = {bytes(p): i for i, p in enumerate(ts.reshape(-1, 188))}
    runs, prev, missing = [], None, 0
    for p in got.reshape(-1, 188):
        i = index.get(bytes(p))
        if i is None:
            missing += 1
            prev = None
            continue
        if prev is not None and i == prev + 1:
            runs[-1] += 1
        else:
            runs.append(1)
        prev = i
    return runs, missing


def stream_channel(sro_ppm=STREAM_SRO_PPM, rate=STREAM_RATE):
    """The channel of the streamed capture, as tests/test_stream_e2e.py
    impairs its capture: CFO +31 kHz, DC and IQ imbalance, at ``sro_ppm``;
    no further noise."""
    from sdr_receiver_dvb_t2_tpu_torch.models.channel import ChannelConfig
    return ChannelConfig(device_rate=rate, cfo_hz=31e3, sro_ppm=sro_ppm,
                         phase0=1.1, dc_offset=0.02 - 0.01j, iq_gain_db=0.2,
                         iq_phase_deg=1.0, seed=3)


def stream_capture(frames, path, n_tile=STREAM_FRAMES,
                   sro_ppm=STREAM_SRO_PPM, rate=STREAM_RATE):
    """A raw u8 capture of ``frames`` (a superframe, FRAME_IDX 0, 1, ...)
    tiled to ``n_tile`` frames, through ``stream_channel`` and quantised to
    u8 at STREAM_SCALE, written to ``path``.  Zeros follow the last frame up
    to a multiple of an eighth of the next power of two, so that the
    channel's FFT resampler runs on a length with small factors.  Returns
    the impaired samples before quantisation."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.models.channel import impair, quantize
    iq = np.tile(frames.reshape(-1), n_tile // len(frames))
    pad = -len(iq) % (1 << max(len(iq).bit_length() - 3, 0))
    iq = np.concatenate([iq, np.zeros(pad, np.complex64)])
    dev = impair(iq, stream_channel(sro_ppm, rate))
    quantize(dev, "u8", scale=STREAM_SCALE).tofile(path)
    return dev


def run_stream(path, device=None):
    """``StreamingReceiver.run`` on a ``RawFileSource`` of ``path`` (the
    user's entry point), with acquisition and every batch timed on the
    host clock after a device synchronise.  Returns (receiver, stats, TS
    bytes, timing: acquisitions, lock time and raw samples read at the
    first lock, per-batch records with the raw samples read and the TS
    bytes written, first read and end times)."""
    from sdr_receiver_dvb_t2_tpu_torch.io import sinks, sources
    from sdr_receiver_dvb_t2_tpu_torch.runtime import stream
    src = _CountingSource(sources.RawFileSource(str(path)))
    sink = sinks.BufferTsSink()
    rx = stream.StreamingReceiver(src, sink, stream.StreamConfig(),
                                  device=device or DEVICE)
    timing = dict(acquire_s=[], batches=[])
    acquire, step_batch = rx.acquire, rx.step_batch

    def timed_acquire():
        t = time.perf_counter()
        ok = acquire()
        sync()
        timing["acquire_s"].append(time.perf_counter() - t)
        if ok and "lock_t" not in timing:
            timing["lock_t"] = time.perf_counter()
            timing["lock_raw"] = src.samples
        return ok

    def timed_step():
        st = rx.stats
        before = (st.frames, st.ldpc_failures, st.bch_dirty, st.bch_corrected)
        raw0, n_chunks = src.samples, len(sink.chunks)
        t = time.perf_counter()
        ok = step_batch()
        sync()
        if ok:
            timing["batches"].append(dict(
                t0=t, ms=(time.perf_counter() - t) * 1e3,
                raw_start=raw0, raw_end=src.samples,
                frames=st.frames - before[0],
                ldpc_failures=st.ldpc_failures - before[1],
                bch_dirty=st.bch_dirty - before[2],
                bch_bits_corrected=st.bch_corrected - before[3],
                ts_bytes=sum(len(c) for c in sink.chunks[n_chunks:]),
                snr_db=st.snr_db, sro_ppm=float(st.sro_ppm),
                cfo_hz=st.cfo_hz))
        return ok
    rx.acquire, rx.step_batch = timed_acquire, timed_step
    stats = rx.run()
    sync()
    timing["end_t"] = time.perf_counter()
    src.close()
    timing["raw_read"] = src.samples
    timing["first_read_t"] = src.t_first
    return rx, stats, sink.data, timing


def phase_stream(report, sig):
    """Phase 4: the streaming entry point on a raw u8 capture of the
    flagship mode at STREAM_SRO_PPM."""
    import numpy as np
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import frontend as fe
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc, p1_detect
    smi = report["device"]["smi"]
    mode, plp = flagship_config()
    rate = STREAM_RATE
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"flagship_stream_0_{rate}_8.raw"
    t0 = time.perf_counter()
    raw_samples = len(stream_capture(sig["frames"], path))
    capture_s = time.perf_counter() - t0

    # ---- the main path: counts from this run only
    ldpc.LayeredDecoder.launches = ldpc.LayeredDecoder.screen_launches = 0
    rx, stats, got, timing = run_stream(path)
    launches = ldpc.LayeredDecoder.launches
    screen_launches = ldpc.LayeredDecoder.screen_launches
    if "lock_t" not in timing:
        raise AssertionError(f"stream never acquired: {stats}")
    cfg = rx.cfg
    batches = timing["batches"]
    n_batches = len(batches)
    # the pull-in: the leading batches with failed codewords
    failed = [i for i, b in enumerate(batches) if b["ldpc_failures"]]
    n_pull = failed[-1] + 1 if failed else 0
    clean = batches[n_pull:]
    frames_clean = sum(b["frames"] for b in clean)
    # every pair of frames carries phase 3's superframe (FRAME_IDX 0, 1):
    # after the pull-in the TS is that superframe's packets, whole, once a
    # pair of frames
    pps = len(sig["ts_superframe"]) // 188
    runs, missing = _ts_runs(got, sig["ts"])
    after = got[sum(b["ts_bytes"] for b in batches[:n_pull]):]
    runs_after, missing_after = _ts_runs(after, sig["ts"])
    superframes_after = frames_clean // 2

    def rate_over(t_start, raw_start):
        """Raw input read from ``t_start`` to the end over that time."""
        secs = timing["end_t"] - t_start
        n = timing["raw_read"] - raw_start
        return dict(seconds=secs, raw_samples=int(n), msps=n / secs / 1e6,
                    realtime_factor=n / rate / secs)
    windows = dict(
        whole_run=rate_over(timing["first_read_t"], 0),
        after_lock=rate_over(timing["lock_t"], timing["lock_raw"]),
        after_pull_in=(rate_over(clean[0]["t0"], clean[0]["raw_start"])
                       if clean else None))
    batch_s = [b["ms"] / 1e3 for b in batches]
    acquire_s = timing["acquire_s"][0]
    m, p = rx.mode, rx.rx.plp if rx.rx is not None else None
    mode_ok = (m is not None and p is not None
               and (m.fft_mode, m.guard, m.pilot_pattern,
                    m.extended_carriers) == (mode.fft_mode, mode.guard,
                                             mode.pilot_pattern,
                                             mode.extended_carriers)
               and (p.constellation, p.code_rate, p.fec_frame, p.rotation)
               == (plp.constellation, plp.code_rate, plp.fec_frame,
                   plp.rotation))
    rec = dict(
        capture_frames=STREAM_FRAMES, raw_samples=int(raw_samples),
        capture_s=capture_s, state=stats.state,
        mode=None if m is None else f"{m.fft_size // 1024}K {m.guard.name} "
        f"{m.pilot_pattern.name}{' ext' if m.extended_carriers else ''}",
        plp=None if p is None else f"{p.constellation.name} "
        f"{p.code_rate.name} {p.fec_frame.name}",
        frames=stats.frames, batches=n_batches, pull_in_batches=n_pull,
        ldpc_failures=stats.ldpc_failures, bch_dirty=stats.bch_dirty,
        bch_bits_corrected=stats.bch_corrected,
        ldpc_failures_after_pull_in=sum(b["ldpc_failures"] for b in clean),
        bch_dirty_after_pull_in=sum(b["bch_dirty"] for b in clean),
        snr_db=stats.snr_db, cfo_hz=stats.cfo_hz,
        sro_ppm=float(stats.sro_ppm), ts_bytes=int(len(got)),
        ts_packets_per_superframe=pps, ts_runs=runs, ts_missing=missing,
        ts_runs_after_pull_in=runs_after,
        launches=launches, screen_launches=screen_launches,
        sro_ppm_channel=STREAM_SRO_PPM, acquire_s=acquire_s,
        acquisitions_s=timing["acquire_s"], batches_detail=batches,
        batch_s=batch_s, rates=windows)

    # ---- the front end and the P1 search on the card, against the CPU:
    # one block as _pump gives it (u8 to the device, converted there)
    n_in = rx.n_in
    raw = torch.from_numpy(np.fromfile(path, np.uint8, count=2 * n_in))
    hi, lo = fe.split_step(rx.step)
    hb = torch.from_numpy(np.asarray(fe.halfband_taps(), np.float32))
    fir = torch.from_numpy(fe.fir_taps(cfg.fir_preset))

    def block(device):
        z = lambda n: torch.zeros(n, dtype=torch.complex64,       # noqa
                                  device=device)
        return fe.frontend_block(
            fe.raw_to_iq(raw.to(device), "u8"), np.float32(0.0),
            np.float32(1.0), np.float32(0.0), np.float32(rx.freq),
            np.float32(1.0), hi, lo, z(len(fir) - 1), z(len(hb) - 1),
            z(len(hb) - 1), fir.to(device), hb.to(device), rx.n_up)
    on_card, on_cpu = block(DEVICE)[0].cpu().numpy(), block("cpu")[0].numpy()
    fe_err = float(np.max(np.abs(on_card - on_cpu))
                   / np.sqrt(np.mean(np.abs(on_cpu) ** 2)))
    fe_ms = cuda_ms(lambda: block(DEVICE), reps=10)
    window = torch.from_numpy(np.ascontiguousarray(
        sig["frames"].reshape(-1)[:cfg.acq_elem_samples]))
    win_dev = window.to(DEVICE)
    card_p1 = [float(v) for v in p1_detect.detect(win_dev)]
    cpu_p1 = [float(v) for v in p1_detect.detect(window)]
    p1_ms = cuda_ms(lambda: p1_detect.detect(win_dev), reps=10)
    rec.update(frontend_block=dict(n_in=int(n_in), n_out=rx.n_up // 2,
                                   ms=fe_ms, max_rel_err_vs_cpu=fe_err),
               p1_detect=dict(window=int(window.shape[0]), ms=p1_ms,
                              card=card_p1, cpu=cpu_p1))
    report["stream"] = rec
    log(f"phase 4 stream ({smi}): {STREAM_FRAMES}-frame u8 capture at "
        f"{rate / 1e6:g} Msps, SRO {STREAM_SRO_PPM:+g} ppm "
        f"({raw_samples} samples, made in {capture_s:.1f} s): {rec['state']} "
        f"on {rec['mode']} {rec['plp']}; {stats.frames} frames in "
        f"{n_batches} batches, of them {n_pull} pull-in batches; LDPC "
        f"failures / BCH-dirty codewords a batch "
        f"{[(b['ldpc_failures'], b['bch_dirty']) for b in batches]}; TS "
        f"{len(got)} bytes in runs {runs} of the transmitted stream "
        f"({missing} packets not in it; {pps} packets a superframe); CFO "
        f"{stats.cfo_hz:+.1f} Hz, SRO estimate a batch "
        f"{[round(b['sro_ppm'], 3) for b in batches]} ppm, SNR "
        f"{stats.snr_db:.2f} dB; decoder launches {launches}, screen "
        f"{screen_launches}")
    log(f"phase 4 stream timing ({smi}): acquisitions "
        f"{', '.join(f'{t * 1e3:.1f}' for t in timing['acquire_s'])} ms; "
        f"batches of 2 frames (host clock) "
        f"{', '.join(f'{t * 1e3:.1f}' for t in batch_s)} ms; raw input "
        f"read over time: " + "; ".join(
            f"{k} {w['raw_samples']} samples in {w['seconds'] * 1e3:.1f} ms "
            f"= {w['msps']:.3f} Msps = {w['realtime_factor']:.3f}x real "
            f"time" for k, w in windows.items() if w is not None)
        + f"; front-end block ({n_in} u8 samples -> {rx.n_up // 2}) "
        f"{fe_ms:.3f} ms, card vs CPU {fe_err:.2e} of rms; P1 detect on "
        f"{window.shape[0]} samples {p1_ms:.3f} ms, card {card_p1} CPU "
        f"{cpu_p1}")
    problems = []
    if not (stats.state == "locked" and mode_ok):
        problems.append("not locked on the flagship mode")
    if stats.frames != STREAM_FRAMES or any(b["frames"] != 2
                                            for b in batches):
        problems.append("not every frame decoded in batches of two")
    if n_pull > STREAM_PULL_IN_MAX or len(clean) < 2:
        problems.append(f"SRO pull-in took {n_pull} batches")
    if failed != list(range(n_pull)):
        problems.append("codewords failed after the pull-in")
    if missing:
        problems.append("TS holds packets that were not transmitted")
    if (missing_after or sum(runs_after) != superframes_after * pps
            or len(runs_after) > superframes_after + 1
            or any(r != pps for r in runs_after[1:-1])):
        problems.append("TS after the pull-in is not every transmitted "
                        "superframe, whole")
    if abs(stats.cfo_hz - 31e3) >= 500:
        problems.append("CFO off by 500 Hz or more")
    if (launches != ldpc.decoder_passes() * n_batches
            or screen_launches != n_batches):
        problems.append("not one decoder call a batch")
    if fe_err >= 2e-5:
        problems.append("front end on the card differs from the CPU")
    if card_p1[0] != cpu_p1[0] or abs(card_p1[1] - cpu_p1[1]) >= 1e-3 \
            or abs(card_p1[2] - cpu_p1[2]) >= 1e-4:
        problems.append("P1 search on the card differs from the CPU")
    if problems:
        raise AssertionError(f"stream phase: {problems}: {rec}")
    path.unlink()


def _ts_exact(got, ts):
    """At least 1000 bytes of TS, a run of the transmitted stream (the
    receiver may start mid-stream)."""
    from _port_capture import ts_in_stream      # tests/, on the path
    return len(got) >= 1000 and ts_in_stream(got, ts)


def _rel_db(got, want):
    import numpy as np
    return float(10 * np.log10(np.sum(np.abs(got - want) ** 2)
                               / np.sum(np.abs(want) ** 2)))


def card_against_cpu(rx, frame):
    """One frame's demod + equalize on the card and on the CPU with the
    same plan: the equalized plane's and csi's relative rms difference
    (dB), the delay profile's largest difference over its peak, and the
    first-path index of each."""
    import numpy as np
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import rx_chain
    x = torch.from_numpy(np.ascontiguousarray(frame[None]))
    eq_c, d_c = rx_chain.frames_to_eq(x, rx.plan, rx.plan.to_device("cpu"))
    eq_g, d_g = rx_chain.frames_to_eq(x.to(DEVICE), rx.plan, rx.consts)
    out = dict(plane_rel_db=_rel_db(eq_g.cpu().numpy(), eq_c.numpy()))
    for k in ("phase_offset", "sro"):
        out[f"{k}_max_abs_err"] = float(
            (d_g[k].cpu() - d_c[k]).abs().max())
    if "csi" in d_c:
        out["csi_rel_db"] = _rel_db(d_g["csi"].cpu().numpy(),
                                    d_c["csi"].numpy())
        cg, cc = d_g["cir_p"].cpu().numpy()[0], d_c["cir_p"].numpy()[0]
        first = lambda p: int(np.argmax(p >= 0.08 * p.max()))  # noqa
        out.update(cir_rel_max=float(np.max(np.abs(cg - cc)) / cc.max()),
                   cir_first=[first(cg), first(cc)],
                   cir_first_delay=int(rx.plan.eq.cir_d[first(cc)]))
    return out


def time_frame_batch(rx, frames):
    """An 8-frame batch (the frames tiled) on the card: the stages in
    CUDA-event ms, the device batch (host clock, with its copies to the
    host), device Msps and the batch's peak device memory above what is
    resident between batches (the frames, the plan's tables).  Returns
    (timing, the host batch, the device batch, its LLRs)."""
    import numpy as np
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import rx_chain
    batch = np.concatenate([frames] * (8 // len(frames)))
    dev_batch = torch.from_numpy(batch).to(DEVICE)
    plan, consts = rx.plan, rx.consts
    eq, diag = rx_chain.frames_to_eq(dev_batch, plan, consts)
    csi = diag.get("csi")
    llr, _ = rx_chain.packed_to_llr(eq, plan, consts, csi=csi)
    # no packing stage: the decoder kernel writes the BB bytes
    stages = dict(
        demod_eq_ms=cuda_ms(lambda: rx_chain.frames_to_eq(dev_batch, plan,
                                                          consts)),
        demap_ms=cuda_ms(lambda: rx_chain.packed_to_llr(eq, plan, consts,
                                                        csi=csi)),
        ldpc_bch_kernel_ms=cuda_ms(lambda: rx.decoder(llr)))

    def device_batch():
        out, done = rx.receive_plane_async(*rx.compute_plane(dev_batch))
        if done is not None:
            done.synchronize()
        return out
    device_batch()
    sync()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = device_batch()
    peak = torch.cuda.max_memory_allocated()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        device_batch()
    dev_s = (time.perf_counter() - t0) / reps
    timing = dict(batch_frames=int(batch.shape[0]),
                  batch_codewords=int(llr.shape[0]),
                  ldpc_ok=int(out["ok"].numpy().sum()),
                  bch_clean=int(out["clean"].numpy().sum()),
                  stages_ms=stages, peak_memory_bytes=int(peak),
                  resident_memory_bytes=int(resident),
                  device_batch_ms=dev_s * 1e3,
                  device_msps=batch.size / dev_s / 1e6)
    return timing, batch, dev_batch, llr


def phase_frame_batch(report, key, label, config, signal):
    """Phases 6-7: two full-width frames of an SFN or MISO configuration
    through ``TorchReceiver`` on the card (every codeword clean, the TS
    exact, one call of the kernels), one frame on the card against the
    CPU, and an 8-frame batch timed."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import (
        RxConfig, TorchReceiver)
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    smi = report["device"]["smi"]
    mode, plp = config()
    frames, n_fec, ts, l1_post, tx_s = signal
    t0 = time.perf_counter()
    rx = TorchReceiver(RxConfig(mode=mode, plp=plp, n_fec_per_frame=n_fec,
                                n_ti=1), device=DEVICE)
    rx._l1_post_cells = l1_post          # the transmitter's L1-post size
    _ = rx.consts
    plan_s = time.perf_counter() - t0

    # ---- the main path: counts from this run only ----
    ldpc.LayeredDecoder.launches = ldpc.LayeredDecoder.screen_launches = 0
    res = rx.receive(frames)
    launches = ldpc.LayeredDecoder.launches
    screen_launches = ldpc.LayeredDecoder.screen_launches
    n_cw = len(frames) * n_fec
    finite = all(np.all(np.isfinite(v)) for v in res.diag.values())
    eq = rx.plan.eq
    rec = dict(
        mode=f"{mode.fft_size // 1024}K {mode.guard.name} "
        f"{mode.pilot_pattern.name}{' ext' if mode.extended_carriers else ''}"
        f"{' MISO' if mode.miso else ''}",
        plan=("MISO" if mode.miso else "SFN" if eq.cir_tab is not None
              else "linear"),
        interp_groups=len(eq.weights) + len(getattr(eq, "weights_alt", ())),
        n_fec=n_fec, n_cw=n_cw, ldpc_ok=int(res.ldpc_ok.sum()),
        bch_clean=int(res.bch_clean.sum()),
        bch_bits_corrected=res.bch_corrected[~res.bch_clean].tolist(),
        bch_uncorrectable=int(np.sum(res.bch_corrected < 0)),
        ts_bytes=int(len(res.ts_bytes)),
        ts_exact=_ts_exact(res.ts_bytes, ts), snr_db=res.snr_db,
        diag_keys=sorted(res.diag), diag_finite=finite, launches=launches,
        screen_launches=screen_launches,
        iters_hist=np.bincount(res.ldpc_iters).tolist(),
        transmitter_s=tx_s, plan_s=plan_s)
    report[key] = rec
    log(f"phase {label} ({smi}) {rec['mode']}, {rec['plan']} plan with "
        f"{rec['interp_groups']} interpolation groups (tables "
        f"{plan_s:.1f} s): ldpc_ok {rec['ldpc_ok']}/{n_cw} bch_clean "
        f"{rec['bch_clean']}/{n_cw} ts_bytes {rec['ts_bytes']} "
        f"exact={rec['ts_exact']} snr {res.snr_db:.2f} dB (per frame "
        f"{[round(float(v), 2) for v in res.diag['snr_db']]}); kernel "
        f"launches: decoder {launches}, screen {screen_launches}; iters "
        f"{rec['iters_hist']}; BCH-dirty codewords' corrected bits "
        f"{rec['bch_bits_corrected']}")
    rec["card_vs_cpu"] = cvc = card_against_cpu(rx, frames[0])
    log(f"phase {label} card vs CPU on one frame: " + ", ".join(
        f"{k} {v}" for k, v in cvc.items()))
    rec["timing"] = tm = time_frame_batch(rx, frames)[0]
    log(f"phase {label} timing ({smi}), 8 frames / {tm['batch_codewords']} "
        f"codewords (ldpc_ok {tm['ldpc_ok']}, bch_clean {tm['bch_clean']}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in tm["stages_ms"].items())
        + ", packing none (the decoder writes the BB bytes)"
        + f"; device batch {tm['device_batch_ms']:.2f} ms = "
        f"{tm['device_msps']:.1f} Msps; peak device memory "
        f"{tm['peak_memory_bytes']} B, of which "
        f"{tm['resident_memory_bytes']} B resident")
    problems = []
    if not (rec["ldpc_ok"] == n_cw and tm["ldpc_ok"] == tm["batch_codewords"]
            and rec["bch_uncorrectable"] == 0):
        problems.append("not every codeword decoded")
    if not rec["ts_exact"]:
        problems.append("TS not a run of the transmitted stream")
    if not finite:
        problems.append("diagnostics not finite")
    if launches != ldpc.decoder_passes() or screen_launches != 1:
        problems.append("not one call of the kernels")
    if cvc["plane_rel_db"] >= PLANE_REL_DB_MAX:
        problems.append("equalized plane on the card differs from the CPU")
    if not mode.miso and not (
            "csi" not in res.diag and "cir_p" in res.diag
            and cvc["csi_rel_db"] < PLANE_REL_DB_MAX
            and cvc["cir_rel_max"] < CIR_REL_MAX
            and cvc["cir_first"][0] == cvc["cir_first"][1]):
        problems.append("csi / delay profile on the card differ from the "
                        "CPU, or csi reached the host")
    if problems:
        raise AssertionError(f"phase {label}: {problems}: {rec}")


def phase_sfn_stream(report):
    """Phase 8: the 2K GI 1/8 PP7 capture of tests/_port_capture.py (10
    Msps u8, CFO +31 kHz, SRO +19 ppm, 26 dB) through StreamingReceiver on
    the card, one frame a batch: locked with the SFN plan, every frame
    decoded, the TS exact, one decoder call a batch; the first-path
    timing loop's move after each batch is reported."""
    from sdr_receiver_dvb_t2_tpu_torch.io import sinks, sources
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    from sdr_receiver_dvb_t2_tpu_torch.runtime import stream
    from _port_capture import port_capture      # tests/, on the path
    smi = report["device"]["smi"]
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    path, ts, mode = port_capture(out_dir)
    capture_s = time.perf_counter() - t0
    sink = sinks.BufferTsSink()
    cfg = stream.StreamConfig(frames_per_batch=1,
                              acq_elem_samples=3 * mode.frame_samples)
    rx = stream.StreamingReceiver(sources.RawFileSource(path), sink, cfg,
                                  device=DEVICE)
    batches, step = [], rx.step_batch

    def recorded_step():
        st = rx.stats
        before = (st.frames, st.ldpc_failures, st.bch_dirty)
        t = time.perf_counter()
        ok = step()
        sync()
        if ok:
            batches.append(dict(
                ms=(time.perf_counter() - t) * 1e3,
                frames=st.frames - before[0],
                ldpc_failures=st.ldpc_failures - before[1],
                bch_dirty=st.bch_dirty - before[2],
                cir_nudge=st.cir_nudge, snr_db=st.snr_db))
        return ok
    rx.step_batch = recorded_step

    # ---- the main path: counts from this run only ----
    ldpc.LayeredDecoder.launches = ldpc.LayeredDecoder.screen_launches = 0
    t0 = time.perf_counter()
    stats = rx.run()
    sync()
    run_s = time.perf_counter() - t0
    launches = ldpc.LayeredDecoder.launches
    screen_launches = ldpc.LayeredDecoder.screen_launches
    got = sink.data
    r = rx.rx
    rec = dict(
        capture_s=capture_s, run_s=run_s, state=stats.state,
        mode=None if rx.mode is None else f"{rx.mode.fft_size // 1024}K "
        f"{rx.mode.guard.name} {rx.mode.pilot_pattern.name}",
        sfn=bool(r is not None and r.cfg.sfn),
        sfn_plan=bool(r is not None and r.plan.eq.cir_d is not None),
        frames=stats.frames, ldpc_failures=stats.ldpc_failures,
        bch_dirty=stats.bch_dirty, ts_bytes=int(len(got)),
        ts_exact=_ts_exact(got, ts), cfo_hz=stats.cfo_hz,
        sro_ppm=float(stats.sro_ppm), snr_db=stats.snr_db,
        cir_nudges=[b["cir_nudge"] for b in batches], batches=batches,
        launches=launches, screen_launches=screen_launches)
    report["sfn_stream"] = rec
    log(f"phase 8 SFN stream ({smi}): 2K GI 1/8 PP7 u8 capture "
        f"(made in {capture_s:.1f} s), {rec['state']} on {rec['mode']}, "
        f"sfn={rec['sfn']}; {stats.frames} frames in {len(batches)} "
        f"batches in {run_s:.2f} s; LDPC failures {stats.ldpc_failures}, "
        f"BCH-dirty {stats.bch_dirty}; TS {len(got)} bytes, "
        f"exact={rec['ts_exact']}; CFO {stats.cfo_hz:+.1f} Hz, SRO "
        f"{stats.sro_ppm:+.2f} ppm, SNR {stats.snr_db:.2f} dB; first-path "
        f"timing moves a batch {rec['cir_nudges']}; decoder launches "
        f"{launches}, screen {screen_launches}")
    problems = []
    if not (stats.state == "locked" and rec["sfn"] and rec["sfn_plan"]):
        problems.append("not locked with the SFN plan")
    if stats.frames < 6 or stats.ldpc_failures or not rec["ts_exact"]:
        problems.append("frames lost, failed codewords or TS not exact")
    if (launches != ldpc.decoder_passes() * len(batches)
            or screen_launches != len(batches)):
        problems.append("not one decoder call a batch")
    if any(abs(n) > 24 for n in rec["cir_nudges"]):
        problems.append("a first-path move beyond the loop's clamp")
    if problems:
        raise AssertionError(f"phase 8: {problems}: {rec}")
    Path(path).unlink()


def pod_impairments(n):
    """Each channel's (noise-only lead in frames, CFO Hz, SRO ppm, noise
    seed): leads over 0.1-1.5 frames, CFOs over +-45 kHz, SROs over +-2
    ppm, each spread evenly and shuffled from a seed."""
    import numpy as np
    rng = np.random.default_rng(91)
    leads, cfos, sros = (rng.permutation(np.linspace(lo, hi, n))
                         for lo, hi in ((0.1, 1.5), (-45e3, 45e3),
                                        (-2.0, 2.0)))
    return [(float(leads[c]), float(cfos[c]), float(sros[c]), 300 + c)
            for c in range(n)]


def make_pod_capture(clean, c, path):
    """Channel c's u8 capture (a worker task): the noise-free superframe
    ``clean`` tiled to POD_FRAMES frames through the port's channel at
    STREAM_RATE with the channel's CFO and SRO, behind its noise-only
    lead, padded to a length common to all channels, POD_SNR_DB of AWGN
    over the signal's power, quantised to u8 at STREAM_SCALE.  Returns the
    worker's seconds."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.models.channel import (
        ChannelConfig, impair, quantize)
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import SAMPLE_RATE
    t0 = time.perf_counter()
    lead_f, cfo, sro, seed = pod_impairments(POD_CHANNELS)[c]
    mode, _ = flagship_config()
    iq = np.tile(clean.reshape(-1), POD_FRAMES // len(clean))
    n_sig = len(iq)
    pad = -len(iq) % (1 << max(len(iq).bit_length() - 3, 0))
    iq = np.concatenate([iq, np.zeros(pad, np.complex64)])
    dev = impair(iq, ChannelConfig(device_rate=STREAM_RATE, cfo_hz=cfo,
                                   sro_ppm=sro, seed=seed))
    frame_raw = mode.frame_samples * STREAM_RATE / SAMPLE_RATE
    n_dev = int(n_sig * STREAM_RATE / SAMPLE_RATE)
    lead = int(lead_f * frame_raw)
    total = int((1.5 + POD_FRAMES + 0.3) * frame_raw)
    y = np.zeros(total, np.complex64)
    m = min(len(dev), total - lead)
    y[lead:lead + m] = dev[:m]
    npow = np.mean(np.abs(dev[:n_dev]) ** 2) / 10 ** (POD_SNR_DB / 10)
    rng = np.random.default_rng(seed)
    y += ((rng.standard_normal(total) + 1j * rng.standard_normal(total))
          * np.sqrt(npow / 2)).astype(np.complex64)
    quantize(y, "u8", scale=STREAM_SCALE).tofile(path)
    return time.perf_counter() - t0


class _PodProbe:
    """Host-clock probes around the pod's stages for one ``--pod`` run:
    each wrapped method adds its seconds (after a device synchronise, so
    that the card's work is inside) to the current step's record.  The
    methods are restored on exit."""

    def __init__(self):
        self.steps, self.acquire_one_s = [], []
        self.lock = self.acquire_s = self.saved = None
        self._acc: dict = {}
        self._undo = []

    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def _timed(self, key, keep=None):
        def make(orig):
            def fn(*a, **kw):
                sync()
                t = time.perf_counter()
                out = orig(*a, **kw)
                sync()
                self._acc[key] = self._acc.get(key, 0.0) + (
                    time.perf_counter() - t)
                if keep is not None:
                    keep(a, kw, out)
                return out
            return fn
        return make

    def __enter__(self):
        import numpy as np
        from sdr_receiver_dvb_t2_tpu_torch.parallel import (
            acquire, pod, sharding)
        probe = self

        def keep_lock(a, kw, out):
            probe.lock = out
            probe.acquire_s = probe._acc.pop("acquire")

        def keep_one(a, kw, out):
            # a channel of the blind acquisition; in the stream, a relock
            # search of a dark channel, which stays in the step's record
            if probe.lock is None:
                probe.acquire_one_s.append(probe._acc.pop("relock_search_s"))

        def keep_step(a, kw, out):
            # the last step's receiver and inputs, for the stage times
            rx, buf = a[0], a[1]
            probe.saved = (rx, buf.clone().pin_memory()
                           if buf.device.type == "cpu" else buf.clone(),
                           a[2:])
        self._wrap(acquire, "blind_acquire", self._timed("acquire",
                                                         keep_lock))
        self._wrap(acquire, "_acquire_one", self._timed("relock_search_s",
                                                        keep_one))
        S = sharding.ShardedReceiver
        self._wrap(S, "plane_step_windows", self._timed("plane_s",
                                                        keep_step))
        self._wrap(S, "fec_step_async", self._timed("fec_device_s"))
        self._wrap(S, "fec_finish", self._timed("fec_host_s"))
        M = pod.MultiChannelReceiver
        self._wrap(M, "_decode_l1", self._timed("l1_decode_s"))
        self._wrap(pod._ArrayStore, "window_into", self._timed("window_s"))
        # the hard bits stream() unpacks from the BB bytes each step (and
        # a dirty codeword's bits in fec_finish, inside fec_host_s too)
        self._wrap(np, "unpackbits", self._timed("unpack_s"))

        def make_stream(orig):
            def stream(rx, *a, **kw):
                gen = orig(rx, *a, **kw)
                t_yield = None
                while True:
                    t0 = time.perf_counter()
                    if t_yield is not None:
                        probe.steps[-1]["entry_tail_s"] = t0 - t_yield
                        probe.steps[-1]["wall_s"] = t0 - probe.steps[-1][
                            "t0"]
                    probe._acc = {}
                    try:
                        item = next(gen)
                    except StopIteration:
                        return
                    t_yield = time.perf_counter()
                    st = item[1]
                    probe.steps.append(dict(
                        probe._acc, t0=t0, stream_s=t_yield - t0,
                        ldpc_failures_ch=st["ldpc_failures_ch"].tolist(),
                        bch_dirty_ch=st["bch_dirty_ch"].tolist(),
                        bch_corrected=int(np.sum(
                            st["plp_results"][0].bch_corrected > 0)),
                        alive=st["alive"].tolist(),
                        snr_db_ch=st["snr_db_ch"].tolist(),
                        cfo_hz_applied=st["cfo_hz_applied"].tolist(),
                        sro_ppm_applied=st["sro_ppm_applied"].tolist(),
                        events=list(st["events"])))
                    yield item
            return stream
        self._wrap(M, "stream", make_stream)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)


def pod_stage_times(rx, buf, args, reps=5):
    """CUDA-event ms of one pod step's stages on ``buf`` (the staging
    buffer [C, n_time, win], pinned) with the step's bases ``args``: the
    H2D copy, the front end, demod + equalize, demap, the kernels (no
    packing: the decoder writes the BB bytes), the call without the
    screen and the screen's product in torch.matmul, and the whole step's
    device work (plane and FEC, with the copies back).  First holds the
    step's LDPC call against the twin (bytes, ok, iters, clean exact;
    raises on a difference) with the grid's segments and with one
    segment a shard."""
    import numpy as np
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc, rx_chain
    from sdr_receiver_dvb_t2_tpu_torch.parallel import sharding
    idx0, frac0, phase0, freq, step = args
    dev = rx.mesh.devices[0][0]
    n_ch, nt = buf.shape[0], buf.shape[1]
    x = buf.to(dev)
    fq, s_hi, s_lo = rx._normalize_state(n_ch, freq, step)
    t = lambda a: torch.from_numpy(                       # noqa: E731
        np.ascontiguousarray(a).reshape(-1)).to(dev)
    fir, hb = rx._taps_on(dev)
    ch = np.arange(n_ch * nt) // nt
    fe_args = (x.reshape(n_ch * nt, -1), t(idx0), t(frac0), t(phase0),
               t(fq[ch]), t(s_hi[ch]), t(s_lo[ch]), fir, hb, rx.n_up,
               rx.k_loc)
    elem = sharding.front_end(*fe_args)
    plan, consts = rx.plans[0], rx._consts_on(0, dev)
    frames = elem.reshape(-1, rx.mode.frame_samples)
    eq, diag = rx_chain.frames_to_eq(frames, plan, consts)
    csi = diag.get("csi")
    llr, _ = rx_chain.packed_to_llr(eq, plan, consts, csi=csi)
    plp = rx.plps[0].plp
    dec = rx._decoder(plp)
    dec_bare = ldpc.LayeredDecoder(plp.ldpc_table_name,
                                   max_iters=dec.max_iters)
    segments = rx.fec_segments(n_ch, n_ch * nt)
    # the step's call at the pod's sizes against the twin: with this
    # grid's segments (one a grid cell), and with one segment a shard, as
    # a grid of a cell a shard would call it (tiles of 128 + 74 at 202)
    parity, (packed, ok, iters, _), _ = check_kernel_against_twin(
        llr, plp, max_iters=dec.max_iters, segments=segments)
    per_shard, _, _ = check_kernel_against_twin(
        llr, plp, max_iters=dec.max_iters,
        segments=[int(llr.shape[0]) // (n_ch * nt)] * (n_ch * nt))
    h = torch.from_numpy(dec.bch_h).to(dev)
    hard_f = unpack_bits(packed).float()
    what = (f"the pod's LDPC call ({plp.ldpc_table_name}, "
            f"W={llr.shape[0]}, {len(segments)} segments)")
    call_ms, bare_ms, screen_ms, _, _ = call_less_call_without(
        lambda: dec(llr, segments=segments),
        lambda: dec_bare(llr, segments=segments), reps, what)
    whole, screen = kernel_bounds(
        dec.plan, int(llr.shape[0]),
        tile_sweeps(ok, iters, dec.max_iters, segments), h.shape[1])
    return dict(
        h2d_copy_ms=cuda_ms(lambda: buf.to(dev, non_blocking=True), reps),
        front_end_ms=cuda_ms(lambda: sharding.front_end(*fe_args), reps),
        demod_eq_ms=cuda_ms(lambda: rx_chain.frames_to_eq(frames, plan,
                                                          consts), reps),
        demap_ms=cuda_ms(lambda: rx_chain.packed_to_llr(eq, plan, consts,
                                                        csi=csi), reps),
        ldpc_bch_kernel_ms=call_ms, ldpc_without_screen_ms=bare_ms,
        screen_ms=screen_ms,
        screen_matmul_ms=cuda_ms(lambda: torch.matmul(hard_f, h), reps),
        ldpc_bch_bound_ms=whole["bound_ms"],
        screen_bound_ms=screen["bound_ms"],
        device_step_ms=cuda_ms(lambda: rx.fec_step_async(
            rx.plane_step_windows(buf, *args), 0), reps,
            what=f"the pod's device step ({n_ch} channels)"),
        codewords=int(llr.shape[0]), twin=parity, twin_per_shard=per_shard)


def pod_step_at(rx, buf, args, n_ch, reps=3):
    """The pod step with the staging buffer's channels repeated to n_ch:
    CUDA-event stage times, the host-clock step (plane, FEC with the host
    BCH, the hard bits unpacked as stream() does) and its peak device
    memory."""
    import numpy as np
    import torch
    k = n_ch // buf.shape[0]
    big = buf.repeat(k, 1, 1).pin_memory()
    idx0, frac0, phase0, freq, step = args
    tile = lambda a: np.tile(np.asarray(a), (k,) + (1,) * (  # noqa: E731
        np.ndim(a) - 1)) if np.ndim(a) else a
    big_args = (tile(idx0), tile(frac0), tile(phase0), tile(freq),
                tile(step))
    stages = pod_stage_times(rx, big, big_args, reps)
    sync()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        with hang_guard(f"the pod step at {n_ch} channels", HANG_LIMIT_S):
            fec = rx.fec_step(rx.plane_step_windows(big, *big_args), 0)
        np.unpackbits(fec.bb_bytes, axis=-1)
        walls.append(time.perf_counter() - t0)
    return dict(stages, channels=n_ch, host_step_ms=[w * 1e3 for w in walls],
                peak_memory_bytes=int(torch.cuda.max_memory_allocated()),
                ldpc_ok=int(fec.ldpc_ok.sum()),
                bch_clean=int(fec.bch_clean.sum()))


def phase_pod(report, sig, paths):
    """Phase 9: the pod through ``cli.main(["--pod", toml])`` on the
    captures ``paths`` (make_pod_capture's), then its stages and its
    capacity on the card."""
    import numpy as np
    import torch
    from sdr_receiver_dvb_t2_tpu_torch import cli
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import SAMPLE_RATE
    smi = report["device"]["smi"]
    mode, _ = flagship_config()
    frame_ms = mode.frame_samples / SAMPLE_RATE * 1e3
    imps = pod_impairments(POD_CHANNELS)
    out_dir = Path(paths[0]).parent
    outs = [out_dir / f"ch{c}.ts" for c in range(POD_CHANNELS)]
    toml = out_dir / "pod.toml"
    toml.write_text(
        "track = true\ntrack_l1 = true\nrelock = true\nstats = 0\n"
        + "".join(f"[[channel]]\ninput = \"{p}\"\nout = \"{o}\"\n"
                  for p, o in zip(paths, outs)))

    # ---- the main path: counts from this run only ----
    sync()
    torch.cuda.reset_peak_memory_stats()
    ldpc.LayeredDecoder.launches = ldpc.LayeredDecoder.screen_launches = 0
    t0 = time.perf_counter()
    with _PodProbe() as probe, hang_guard("the pod run (--pod)", 600):
        rc = cli.main(["--pod", str(toml)])
        wait_card("the pod run (--pod)")
    run_s = time.perf_counter() - t0
    launches = ldpc.LayeredDecoder.launches
    screen_launches = ldpc.LayeredDecoder.screen_launches
    peak = torch.cuda.max_memory_allocated()
    lock, steps = probe.lock, probe.steps
    if rc != 0 or lock is None or not steps:
        raise AssertionError(f"pod run failed: rc={rc}, lock={lock}, "
                             f"{len(steps)} steps")
    n_steps = len(steps)
    # each channel's TS against the transmitted stream: every superframe
    # (two frames) carries phase 3's TS, pps packets
    pps = len(sig["ts_superframe"]) // 188
    per_ch = []
    for c, (lead, cfo, sro, _) in enumerate(imps):
        got = np.fromfile(outs[c], np.uint8) if outs[c].exists() else \
            np.zeros(0, np.uint8)
        runs, missing = _ts_runs(got, sig["ts"])
        cfo_est = (float(lock.freq[c]) * STREAM_RATE / (2 * np.pi)
                   + steps[-1]["cfo_hz_applied"][c])
        per_ch.append(dict(
            lead_frames=lead, cfo_hz=cfo, sro_ppm=sro,
            pos0=int(lock.pos0[c]), locked=bool(lock.locked[c]),
            cfo_hz_estimate=cfo_est,
            sro_ppm_applied=steps[-1]["sro_ppm_applied"][c],
            ts_bytes=int(len(got)), ts_runs=runs, ts_missing=missing,
            ldpc_failures=[s["ldpc_failures_ch"][c] for s in steps],
            bch_dirty=[s["bch_dirty_ch"][c] for s in steps]))
    walls = [s["wall_s"] for s in steps if "wall_s" in s]
    wall_ms = float(np.median(walls)) * 1e3 if walls else float("nan")
    keys = ("window_s", "plane_s", "l1_decode_s", "fec_device_s",
            "fec_host_s", "unpack_s", "entry_tail_s", "stream_s", "wall_s")
    step_ms = {k: [s.get(k, 0.0) * 1e3 for s in steps] for k in keys}
    rec = dict(channels=POD_CHANNELS, frames=POD_FRAMES, rc=rc,
               run_s=run_s, steps=n_steps, launches=launches,
               screen_launches=screen_launches,
               acquire_s=probe.acquire_s, acquire_one_s=probe.acquire_one_s,
               mismatched=list(lock.mismatched), channels_detail=per_ch,
               step_host_ms=step_ms, step_wall_ms_median=wall_ms,
               realtime_factor_per_channel=frame_ms / wall_ms,
               channels_realtime_end_to_end=POD_CHANNELS * frame_ms / wall_ms,
               peak_memory_bytes=int(peak),
               events=[e for s in steps for e in s["events"]],
               bch_corrected=[s["bch_corrected"] for s in steps])
    report["pod"] = rec
    log(f"phase 9 pod ({smi}): {POD_CHANNELS} flagship channels, "
        f"{n_steps} steps of one frame each ({frame_ms:.1f} ms of signal); "
        f"exit {rc}; locked {[d['locked'] for d in per_ch]}, mismatched "
        f"{rec['mismatched']}; blind acquisition {probe.acquire_s:.2f} s "
        f"(a channel {', '.join(f'{t:.2f}' for t in probe.acquire_one_s)} "
        f"s); LDPC failures a step and channel "
        f"{[s['ldpc_failures_ch'] for s in steps]}; BCH-corrected "
        f"codewords a step {rec['bch_corrected']}; decoder launches "
        f"{launches}, screen {screen_launches}; peak device memory {peak} B")
    for c, d in enumerate(per_ch):
        log(f"phase 9 ch{c}: lead {d['lead_frames']:.2f} frames, CFO "
            f"{d['cfo_hz']:+.0f} Hz (estimate {d['cfo_hz_estimate']:+.1f}), "
            f"SRO {d['sro_ppm']:+.2f} ppm (applied "
            f"{d['sro_ppm_applied']:+.3f}); TS {d['ts_bytes']} bytes in runs "
            f"{d['ts_runs']} ({d['ts_missing']} packets not transmitted; "
            f"{pps} a superframe)")
    log(f"phase 9 step host clock ms ({smi}): " + "; ".join(
        f"{k[:-2]} {[round(v, 1) for v in vs]}" for k, vs in step_ms.items())
        + f"; median step wall {wall_ms:.1f} ms = "
        f"{rec['realtime_factor_per_channel']:.3f}x real time a channel, "
        f"{rec['channels_realtime_end_to_end']:.1f} channels end to end")

    # ---- the stages in CUDA events, at 8, 32 and 64 channels ----
    rx, buf, args = probe.saved
    cap = {}
    for n_ch in (POD_CHANNELS, *POD_CAPACITY_CHANNELS):
        cap[n_ch] = r = pod_step_at(rx, buf, args, n_ch)
        r["channels_realtime_device"] = (n_ch * frame_ms
                                         / r["device_step_ms"])
        r["channels_realtime_host_step"] = (
            n_ch * frame_ms / float(np.median(r["host_step_ms"])))
        segs = [r[k]["segments"] for k in ("twin", "twin_per_shard")]
        log(f"phase 9 stages at {n_ch} channels ({r['codewords']} "
            f"codewords; the call's bytes, ok, iters and clean equal to the "
            f"twin's over the grid's {len(segs[0])} segments of "
            f"{segs[0][0]} and over {len(segs[1])} of {segs[1][0]}, one a "
            f"shard; CUDA events, {smi}): " + ", ".join(
                f"{k} {r[k]:.3f}" for k in (
                    "h2d_copy_ms", "front_end_ms", "demod_eq_ms",
                    "demap_ms", "ldpc_bch_kernel_ms", "device_step_ms"))
            + f"; packing none (the decoder writes the BB bytes); the "
            f"call's bound {r['ldpc_bch_bound_ms']:.4f} ms, without the "
            f"screen {r['ldpc_without_screen_ms']:.3f} ms, so the screen "
            f"{r['screen_ms']:.3f} ms (bound {r['screen_bound_ms']:.4f} ms; "
            f"torch.matmul {r['screen_matmul_ms']:.3f} ms)"
            + f"; host-clock step {[round(v, 1) for v in r['host_step_ms']]}"
            f" ms; peak device memory {r['peak_memory_bytes']} B; channels "
            f"in real time: device {r['channels_realtime_device']:.1f}, "
            f"host step {r['channels_realtime_host_step']:.1f}")
    rec["capacity"] = {str(k): v for k, v in cap.items()}

    problems = []
    if not (lock.locked.all() and not lock.mismatched
            and all(steps[-1]["alive"])):
        problems.append("not every channel locked and alive")
    settled = steps[1:]
    if any(any(s["ldpc_failures_ch"]) for s in settled):
        problems.append("failed codewords after the settling step")
    for c, d in enumerate(per_ch):
        runs = d["ts_runs"]
        if d["ts_missing"]:
            problems.append(f"ch{c}: TS packets that were not transmitted")
        if (sum(runs) < pps * ((n_steps - 1) // 2)
                or len(runs) > (n_steps + 1) // 2 + 1
                or any(r != pps for r in runs[1:-1])):
            problems.append(f"ch{c}: TS not every superframe whole")
        if abs(d["cfo_hz_estimate"] - d["cfo_hz"]) >= POD_CFO_MAX_ERR_HZ:
            problems.append(f"ch{c}: CFO off by {POD_CFO_MAX_ERR_HZ} Hz")
    if (launches != ldpc.decoder_passes() * n_steps
            or screen_launches != n_steps):
        problems.append("not one call of the kernels a step")
    if any(r["ldpc_ok"] != r["codewords"] for r in cap.values()):
        problems.append("the repeated steps did not decode")
    if problems:
        raise AssertionError(f"phase 9: {problems}: {rec}")
    for p in list(paths) + outs:
        Path(p).unlink(missing_ok=True)


def phase_pod_halo(report):
    """Phase 9, the contiguous path: step() of a (2, 2) grid, all four
    shards on the one card, on two 2K channels (the second with a 2 kHz
    CFO), each time block behind its halo; against the same step on the
    CPU."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.io.bbframe import BBFrameParser
    from sdr_receiver_dvb_t2_tpu_torch.models.channel import (
        ChannelConfig, impair)
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    from sdr_receiver_dvb_t2_tpu_torch.parallel import sharding
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        SAMPLE_RATE, CodeRate, Constellation, FecFrame, FftMode,
        GuardInterval, PilotPattern, PlpConfig, T2Mode)
    mode = T2Mode(FftMode.FFT_2K, GuardInterval.G1_8, PilotPattern.PP7,
                  False, n_data_symbols=30)
    plp = PlpConfig(constellation=Constellation.QAM16,
                    code_rate=CodeRate.C1_2, fec_frame=FecFrame.SHORT,
                    rotation=True, time_il_length=1)
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=4,
                              num_t2_frames=3))
    ts = random_ts_stream(120, seed=12)
    iq = tx.modulate(ts)
    rate = float(STREAM_RATE)
    freq = np.array([0.0, 2 * np.pi * 2e3 / rate])
    rows = [impair(iq, ChannelConfig(device_rate=rate, cfo_hz=f, snr_db=30.0,
                                     seed=50 + c))
            for c, f in enumerate((0.0, 2e3))]
    cfg = sharding.ShardedConfig(mode=mode, plp=plp, n_fec_per_frame=4,
                                 l1_post_cells=tx.l1_pre.l1_post_size)
    step = rate / (2 * SAMPLE_RATE)
    out = {}
    for dev in (DEVICE, "cpu"):
        rx = sharding.ShardedReceiver(
            cfg, sharding.make_mesh(2, 2, devices=[dev] * 4))
        rb = rx.raw_block_for(step)
        mu = ((rx.n_taps - 1) / 4.0 - 1.0) / (SAMPLE_RATE / rate)
        bases = rx.host_bases(mu, step, 0.0, freq, rb, n_channels=2)
        x = np.stack([r[:2 * rb] for r in rows])
        before = (ldpc.LayeredDecoder.launches,
                  ldpc.LayeredDecoder.screen_launches)
        sync()
        t0 = time.perf_counter()
        hard, stats = rx.step(x, *bases, freq, step)
        sync()
        out[dev] = (hard, stats, ldpc.LayeredDecoder.launches - before[0],
                    ldpc.LayeredDecoder.screen_launches - before[1],
                    (time.perf_counter() - t0) * 1e3)
    hard, stats, launches, screens, ms = out[DEVICE]
    hard_c = out["cpu"][0]
    ts_ok = []
    for c in range(2):
        p = BBFrameParser()
        got = np.concatenate([p.parse(hard[c, f, k, :plp.k_bch])
                              for f in range(hard.shape[1])
                              for k in range(hard.shape[2])])
        ts_ok.append(bool(_ts_exact(got, ts)))
    rec = dict(grid=[2, 2], channels=2, ldpc_failures=int(
        stats["ldpc_failures"]), bch_dirty=int(stats["bch_dirty"]),
        launches=launches, screen_launches=screens, step_ms=ms,
        ts_exact=ts_ok,
        equal_to_cpu=bool(np.array_equal(hard, hard_c)))
    report["pod_halo"] = rec
    log(f"phase 9 contiguous step, (2, 2) grid on one card, 2K: LDPC "
        f"failures {rec['ldpc_failures']}, BCH-dirty {rec['bch_dirty']}, "
        f"TS exact {ts_ok}, hard bits equal to the CPU's "
        f"{rec['equal_to_cpu']}, decoder launches {launches}, "
        f"{ms:.1f} ms (first call)")
    if not (rec["ldpc_failures"] == 0 and all(ts_ok) and rec["equal_to_cpu"]
            and launches == ldpc.decoder_passes() and screens == 1):
        raise AssertionError(f"phase 9 contiguous step: {rec}")


def make_rank_capture(clean, n_fec, path):
    """Phase 10's input (a worker task): the noise-free superframe
    ``clean`` tiled to three frames through the port's channel at
    STREAM_RATE, channel c with CFO RANKS_CFO_HZ[c] and POD_SNR_DB of AWGN
    over the signal's power, saved as complex64 [2, N] with the L1-post
    size.  Returns the worker's seconds."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.models.channel import (
        ChannelConfig, impair)
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig)
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import SAMPLE_RATE
    t0 = time.perf_counter()
    mode, plp = flagship_config()
    l1_post = Transmitter(TxConfig(mode=mode, plp=plp,
                                   fec_blocks_per_frame=n_fec,
                                   num_t2_frames=len(clean))
                          ).l1_pre.l1_post_size
    iq = np.tile(clean.reshape(-1), 2)[:3 * mode.frame_samples]
    n_dev = int(len(iq) * STREAM_RATE / SAMPLE_RATE)
    pad = -len(iq) % (1 << max(len(iq).bit_length() - 3, 0))
    iq = np.concatenate([iq, np.zeros(pad, np.complex64)])
    rows = []
    for c, cfo in enumerate(RANKS_CFO_HZ):
        dev = impair(iq, ChannelConfig(device_rate=STREAM_RATE, cfo_hz=cfo,
                                       seed=60 + c))[:n_dev]
        npow = np.mean(np.abs(dev) ** 2) / 10 ** (POD_SNR_DB / 10)
        rng = np.random.default_rng(60 + c)
        rows.append((dev + (rng.standard_normal(n_dev)
                            + 1j * rng.standard_normal(n_dev))
                     * np.sqrt(npow / 2)).astype(np.complex64))
    np.savez(path, raw=np.stack(rows), l1_post=l1_post, n_fec=n_fec)
    return time.perf_counter() - t0


def _ranks_receiver(cap, mesh):
    """The flagship ShardedReceiver of phase 10 on ``mesh`` and the
    contiguous step's inputs: the whole grid's raw [2, 2 * raw_block],
    its bases and the per-channel NCO frequencies."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.parallel import sharding
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import SAMPLE_RATE
    mode, plp = flagship_config()
    cfg = sharding.ShardedConfig(mode=mode, plp=plp,
                                 n_fec_per_frame=int(cap["n_fec"]),
                                 l1_post_cells=int(cap["l1_post"]))
    rx = sharding.ShardedReceiver(cfg, mesh)
    rate = float(STREAM_RATE)
    step = rate / (2 * SAMPLE_RATE)
    freq = 2 * np.pi * np.asarray(RANKS_CFO_HZ) / rate
    rb = rx.raw_block_for(step)
    # elementary sample 0 at the capture's first frame start
    mu = ((rx.n_taps - 1) / 4.0 - 1.0) / (SAMPLE_RATE / rate)
    bases = rx.host_bases(mu, step, 0.0, freq, rb, n_channels=2)
    x = np.ascontiguousarray(cap["raw"][:, :2 * rb])
    return rx, x, (*bases, freq, step)


def _timed_steps(rx, x, args, reps):
    """The host-clock ms of ``reps`` contiguous steps, each ended by a
    device synchronise, and of their stages, each between synchronises:
    the plane (with the halo), the FEC on the card and on the host, and
    the collectives (the ring and the reductions, inside the others and
    after them).  Returns (step ms, {stage: ms a step})."""
    from sdr_receiver_dvb_t2_tpu_torch.parallel import distributed
    acc: dict = {}

    def timed(key, fn):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            acc[key][-1] += (time.perf_counter() - t0) * 1e3
            return out
        return run
    stages = dict(plane_ms=(rx, "plane_step"),
                  fec_device_ms=(rx, "fec_step_async"),
                  fec_host_ms=(rx, "fec_finish"),
                  collectives_ms=(distributed.Mesh, "_all_reduce"),
                  ring_ms=(distributed.Mesh, "ring_halo"))
    saved = [(owner, name, getattr(owner, name))
             for owner, name in stages.values()]
    for key, (owner, name) in stages.items():
        acc[key] = []
        setattr(owner, name, timed(key, getattr(owner, name)))
    walls = []
    try:
        for _ in range(reps):
            for v in acc.values():
                v.append(0.0)
            sync()
            t0 = time.perf_counter()
            rx.step(x, *args)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        for owner, name, fn in saved:
            if owner is rx:
                delattr(rx, name)
            else:
                setattr(owner, name, fn)
    return walls, acc


def run_rank(rank, init_method, cap_path, out_path):
    """One rank of phase 10 (a spawned process): join the group, run the
    contiguous step on this rank's time block of both channels with the
    kernel counts set to 0 just before it and read just after, time
    RANKS_TIMING_REPS more steps, and save the rank's hard bits (packed),
    stats, counts and times."""
    import numpy as np
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    from sdr_receiver_dvb_t2_tpu_torch.parallel import distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // RANKS_WORLD))
    distributed.init(RANKS_WORLD, rank, init_method,
                     timeout_s=RANKS_GROUP_TIMEOUT_S)
    try:
        mesh = distributed.rank_mesh(2, 2, "time")     # the visible card
        rx, x, args = _ranks_receiver(np.load(cap_path), mesh)
        rows, t0, t1 = mesh.block
        x = x.reshape(2, 2, -1)[:, t0:t1].reshape(2, -1)
        ldpc.LayeredDecoder.launches = ldpc.LayeredDecoder.screen_launches = 0
        sync()
        hard, stats = rx.step(x, *args)
        sync()
        launches = (ldpc.LayeredDecoder.launches,
                    ldpc.LayeredDecoder.screen_launches)
        walls, stages = _timed_steps(rx, x, args, RANKS_TIMING_REPS)
        np.savez(out_path, hard=np.packbits(hard, axis=-1),
                 chans=mesh.channels(2), block=np.array([t0, t1]),
                 launches=np.array(launches), step_ms=np.array(walls),
                 **{f"stage_{k}": np.array(v) for k, v in stages.items()},
                 **{f"stat_{k}": np.asarray(v) for k, v in stats.items()})
    finally:
        distributed.shutdown()


def phase_pod_ranks(report, sig, cap_path):
    """Phase 10: the flagship's contiguous step on a (2, 2) grid in this
    process, then across two spawned ranks on the one card; held equal."""
    import multiprocessing
    import numpy as np
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.io.native import NativeBBFrameParser
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    from sdr_receiver_dvb_t2_tpu_torch.parallel import sharding
    smi = report["device"]["smi"]
    _, plp = flagship_config()
    cap = np.load(cap_path)
    rx, x, args = _ranks_receiver(cap, sharding.make_mesh(
        2, 2, devices=[DEVICE] * 4))
    hard, stats = rx.step(x, *args)
    one_ms, one_stages = _timed_steps(rx, x, args, RANKS_TIMING_REPS)
    del rx
    torch.cuda.empty_cache()            # the card's memory to the ranks

    out_dir = Path(cap_path).parent
    store = out_dir / "store"
    store.unlink(missing_ok=True)
    outs = [out_dir / f"rank{r}.npz" for r in range(RANKS_WORLD)]
    for o in outs:
        o.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_rank, args=(r, f"file://{store}",
                                                str(cap_path), str(outs[r])))
             for r in range(RANKS_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, RANKS_JOIN_TIMEOUT_S
                       - (time.perf_counter() - t0)))
    finally:
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise AssertionError(f"phase 10: ranks {codes} (hung: {hung})")
    got = [dict(np.load(o)) for o in outs]
    union = np.zeros_like(np.packbits(hard, axis=-1))
    cells = np.zeros(union.shape[:2], int)
    for d in got:
        t0_, t1_ = d["block"]
        idx = np.ix_(d["chans"], np.arange(t0_, t1_))
        union[idx] = d["hard"]
        cells[idx] += 1
    equal = bool((cells == 1).all()
                 and np.array_equal(np.unpackbits(union, axis=-1), hard))
    # the float stats come from batches of other sizes on the card (four
    # shards in one call against two), so they are reported, not held
    stats_diff = {k: max(float(np.max(np.abs(d[f"stat_{k}"] - np.asarray(v))))
                         for d in got) for k, v in stats.items()}
    ts_ok = []
    for c in range(2):
        bits = np.unpackbits(union[c], axis=-1).reshape(-1, plp.n_bch)
        bb = np.ascontiguousarray(np.packbits(bits[:, :plp.k_bch], axis=-1))
        ts_ok.append(bool(_ts_exact(NativeBBFrameParser().parse_batch(bb),
                                    sig["ts"])))
    launches = [d["launches"].tolist() for d in got]
    rank_ms = [d["step_ms"].tolist() for d in got]
    rank_med = max(float(np.median(m)) for m in rank_ms)
    med = lambda v: round(float(np.median(v)), 3)            # noqa: E731
    stage_ms = dict(one_process={k: med(v) for k, v in one_stages.items()},
                    ranks=[{k[6:]: med(v) for k, v in d.items()
                            if k.startswith("stage_")} for d in got])
    rec = dict(grid=[2, 2], layout="time", channels=2,
               codewords=int(hard.shape[1] * hard.shape[2] * 2),
               ldpc_failures=int(stats["ldpc_failures"]),
               ldpc_failures_ranks=[int(d["stat_ldpc_failures"])
                                    for d in got],
               bch_dirty=int(stats["bch_dirty"]), ts_exact=ts_ok,
               equal_to_one_process=equal, stats_max_abs_diff=stats_diff,
               launches_per_rank=launches,
               launches=sum(a for a, _ in launches),
               screen_launches=sum(b for _, b in launches),
               one_process_step_ms=one_ms, rank_step_ms=rank_ms,
               one_process_step_ms_median=float(np.median(one_ms)),
               rank_step_ms_median=rank_med, ranks_run_s=ranks_s,
               stage_ms_median=stage_ms)
    report["pod_ranks"] = rec
    log(f"phase 10 two ranks on one card ({smi}): flagship (2, 2) grid, "
        f"layout time, {rec['codewords']} codewords; union of the ranks' "
        f"hard bits equal to one process {equal}, stats' largest "
        f"difference {stats_diff}; LDPC failures {rec['ldpc_failures']} "
        f"(ranks {rec['ldpc_failures_ranks']}), BCH-dirty {rec['bch_dirty']}; TS "
        f"exact {ts_ok}; launches a rank (decoder, screen) {launches}; "
        f"host-clock step: one process "
        f"{[round(v, 1) for v in one_ms]} ms (median "
        f"{rec['one_process_step_ms_median']:.1f}), two ranks "
        f"{[[round(v, 1) for v in m] for m in rank_ms]} ms (slower rank's "
        f"median {rank_med:.1f}); stage medians, ms a step {stage_ms}; "
        f"ranks ran {ranks_s:.1f} s")
    if not (equal and all(ts_ok)
            and rec["ldpc_failures"] == 0
            and all(d["stat_ldpc_failures"] == 0 for d in got)
            and all(a == ldpc.decoder_passes() and b == 1
                    for a, b in launches)):
        raise AssertionError(f"phase 10: {rec}")
    for p in [cap_path, *outs, store]:
        Path(p).unlink(missing_ok=True)


def call_less_call_without(call, bare, reps, what):
    """CUDA-event ms of the LDPC call and of the call without the screen,
    in turns (call, without, without, call; three rounds) so that both see
    the same card state: (call ms, without ms, the screen's ms as the
    median of the rounds' differences, the call's runs, the runs
    without).  ``what`` names the load should a call hang."""
    import numpy as np
    runs, bare_runs = [], []
    for _ in range(3):
        runs.append(cuda_ms(call, reps, what=what))
        bare_runs += [cuda_ms(bare, reps, what=f"{what} without the screen")
                      for _ in range(2)]
        runs.append(cuda_ms(call, reps, what=what))
    return (float(np.mean(runs)), float(np.mean(bare_runs)),
            float(np.median(np.subtract(runs, bare_runs))), runs, bare_runs)


def kernel_device_ms(fn, what, reps=10):
    """Device time of each of the LDPC call's kernels in torch.profiler's
    CUDA trace of reps calls of fn(): {kernel: dict(ms=total ms,
    launches=its records in the trace)}; None where this torch cannot
    trace the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities
    if ProfilerActivity.CUDA not in supported_activities():
        return None
    fn()
    wait_card(what)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the trace can lose the records of the first kernels after it
        # starts (the first call's memset and decoder on the T2-Lite
        # loads, PERF.md section 6): a small kernel, waited for, goes first
        torch.ones(1, device=DEVICE).add_(1)
        wait_card(what)
        for _ in range(reps):
            fn()
        wait_card(what)
    out = {}
    for e in prof.events():
        for name in ("ldpc_layered_kernel", "bch_screen_kernel"):
            if name in e.name:
                o = out.setdefault(name, dict(ms=0.0, launches=0))
                o["ms"] += e.time_range.elapsed_us() / 1e3
                o["launches"] += 1
    return out


def kernel_bounds(plan, w, sweeps, n_syn):
    """Least times (ms) the card could take for the decoder with its screen
    and for the screen alone, from this run's sizes and sweeps (those the
    tile contract runs, tile_sweeps): each input read once and each output
    written once at the HBM rate, against the decoder's operations at the
    32-bit rate.  The screen's AND-popcounts run on the tensor cores (mma
    .b1 .and.popc), whose 1-bit rate the data sheet does not give; they are
    counted, not timed, so the screen is bound by its bytes."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    edges = plan.q * (plan.cnl + 2) * ldpc.M
    h_bytes = n_syn * -(-plan.k // 8)                 # H as bytes, read once
    # LLRs in; BB bytes, ok (1), iters (4) and clean (1) out
    whole = dict(bytes=w * (plan.n + plan.k // 8 + 6) + h_bytes,
                 ops=OPS_PER_EDGE_SWEEP * edges * sweeps)
    # the screen alone: the BB bytes and H in, one flag a codeword out;
    # an AND and a popcount a bit pair
    screen = dict(bytes=w * plan.k // 8 + h_bytes + w,
                  bit_ops=2 * w * n_syn * plan.k)
    for b in (whole, screen):
        b["bytes_ms"] = b["bytes"] / HBM_BYTES_PER_S * 1e3
    whole["ops_ms"] = whole["ops"] / SCALAR_OPS_PER_S * 1e3
    whole["bound_ms"] = max(whole["bytes_ms"], whole["ops_ms"])
    whole["bound_by"] = ("bytes" if whole["bytes_ms"] >= whole["ops_ms"]
                         else "operations")
    screen.update(ops_ms=None, bound_ms=screen["bytes_ms"], bound_by="bytes")
    return whole, screen


def time_kernels(llr, plp, label):
    """Parity with the twin, then the times of one load [W, N]: the whole
    call, the call without the screen (the screen's time is the
    difference), the twin, the screen's plain version and its library
    product, and each kernel's device time in torch.profiler's trace
    (which must hold whole calls where torch can trace the card)."""
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, ldpc
    parity, got, _ = check_kernel_against_twin(llr, plp)
    h = bch_ops._h_matrix(plp.k_bch, plp.bch_m, plp.bch_t)
    name = plp.ldpc_table_name
    dec = ldpc.LayeredDecoder(name, bch_h=h)
    dec_bare = ldpc.LayeredDecoder(name, bch_h=None)
    what = f"the LDPC call on the {label} ({name}, W={llr.shape[0]})"
    ms, bare_ms, screen_ms, runs, bare_runs = call_less_call_without(
        lambda: dec(llr), lambda: dec_bare(llr), 10, what)
    plain_ms = cuda_ms(lambda: ldpc.decode_plain(
        llr, name, 15, h, exit_tile=ldpc.TILE), reps=1,
        what=f"the twin of {what}")
    hard = unpack_bits(got[0])
    screen_plain_ms = cuda_ms(lambda: bch_ops.syndrome_flags(hard, h), reps=3)
    hard_f = hard.float()
    h_t = torch.from_numpy(h).to(DEVICE)
    library_ms = cuda_ms(lambda: torch.matmul(hard_f, h_t), reps=10)
    clean_err = int((got[3].int() - bch_ops.syndrome_flags(hard, h).int())
                    .abs().max())
    w, sweeps = int(llr.shape[0]), parity["sweeps"]
    whole, screen = kernel_bounds(ldpc.get_plan(name), w, sweeps, h.shape[1])
    # a trace of 10 calls must hold both kernels and every launch; should
    # the profiler lose a record all the same, up to TRACE_TRIES traces
    # are taken, and what each held is kept
    per_call = {"ldpc_layered_kernel": ldpc.decoder_passes(),
                "bch_screen_kernel": 1}
    trace_tries = []
    for _ in range(TRACE_TRIES):
        traced = kernel_device_ms(lambda: dec(llr), what, reps=10)
        if traced is None:
            break
        for k, v in traced.items():
            v["expected"] = per_call.get(k, 0) * 10
            v["ms_per_call"] = v["ms"] / 10
        trace_tries.append({k: v["launches"] for k, v in traced.items()})
        if set(traced) == set(per_call) and all(
                v["launches"] == v["expected"] for v in traced.values()):
            break
    else:
        raise AssertionError(f"phase 5 {label}: no torch.profiler trace of "
                             f"{TRACE_TRIES} held both kernels and every "
                             f"launch: {trace_tries}")
    res = dict(label=label, parity=parity, n_cw=w, sweeps=sweeps, ms=ms,
               traced=traced, trace_tries=trace_tries, ms_runs=runs,
               without_screen_ms=bare_ms, without_screen_runs=bare_runs,
               screen_ms=screen_ms,
               plain_ms=plain_ms, screen_plain_ms=screen_plain_ms,
               library_ms=library_ms, screen_max_abs_err=clean_err,
               bound=whole, screen_bound=screen)
    log(f"phase 5 {label}, W={w}, {sweeps} sweeps, bit-exact: call {ms:.3f} "
        f"ms (bound {whole['bound_ms']:.4f} ms by {whole['bound_by']}), "
        f"without the screen {bare_ms:.3f} ms, so the screen "
        f"{screen_ms:.4f} ms (median of {len(runs)} rounds' differences "
        f"{[round(a - b, 4) for a, b in zip(runs, bare_runs)]}; bound "
        f"{screen['bound_ms']:.4f} ms by {screen['bound_by']}; torch.matmul "
        f"{library_ms:.3f} ms; plain {screen_plain_ms:.2f} ms); twin "
        f"{plain_ms:.1f} ms; traced a call: "
        + (", ".join(f"{k} {v['ms_per_call']} ms ({v['launches']} of its "
                     f"{v['expected']} launches in the trace of 10 calls)"
                     for k, v in traced.items())
           + f" (launches a try: {trace_tries})" if traced is not None
           else "not measured (torch cannot trace the card)"))
    return res


def phase_kernel_table(report, llr):
    """The decoder kernel and the screen kernel at the main path's shape
    (the 1616 codewords of the flagship batch) and on a second load of as
    many codewords with unequal sweeps.  Returns the kernel table's rows,
    taken from the main path's load."""
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    _, plp = flagship_config()
    main = time_kernels(llr, plp, "flagship batch")
    mixed = time_kernels(torch.from_numpy(mixed_load()[0]).to(DEVICE), plp,
                         "mixed load (a quarter hopeless)")
    lite = {}
    for i, (frame, rate) in enumerate(LITE_TABLES):
        llr_l, plp_l = coded_llrs(rate, frame, 1616, seed=31 + i)
        lite[plp_l.ldpc_table_name] = time_kernels(
            torch.from_numpy(llr_l).to(DEVICE), plp_l,
            f"T2-Lite table {plp_l.ldpc_table_name}")
    source = f"{PKG}/ops/csrc/ldpc_layered.cu"
    recv, strm = report["receive"], report["stream"]
    paths = dict(stream="stream", receive="receive", sfn_receive="sfn",
                 miso_receive="miso", sfn_stream="sfn_stream", pod="pod",
                 pod_halo="pod_halo", pod_ranks="pod_ranks")

    def by_path(count):
        return {name: report[key][count] for name, key in paths.items()}

    def traced(r, kernel, key="ms_per_call"):
        return (None if r["traced"] is None
                else r["traced"][kernel][key])

    def lite_rows(screen):
        return {t: dict(n_cw=r["n_cw"], sweeps=r["sweeps"],
                        ms=r["screen_ms"] if screen else r["ms"],
                        plain_ms=(r["screen_plain_ms"] if screen
                                  else r["plain_ms"]),
                        bound_ms=r["screen_bound" if screen
                                   else "bound"]["bound_ms"],
                        library_ms=r["library_ms"] if screen else None,
                        traced_ms=traced(r, "bch_screen_kernel" if screen
                                         else "ldpc_layered_kernel"),
                        max_abs_err=(r["screen_max_abs_err"] if screen
                                     else r["parity"]["max_abs_err"]))
                for t, r in lite.items()}
    rows = [
        dict(name="ldpc_layered_bch", route="cuda", source=source,
             replaces="sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py:169",
             launches=strm["launches"],
             launches_by_path=by_path("launches"), lite=lite_rows(False),
             max_abs_err=main["parity"]["max_abs_err"], ms=main["ms"],
             plain_ms=main["plain_ms"], bound_ms=main["bound"]["bound_ms"],
             bound_by=main["bound"]["bound_by"], library_ms=None,
             traced_ms=traced(main, "ldpc_layered_kernel"),
             traced_launches=traced(main, "ldpc_layered_kernel",
                                    "launches"),
             resident_blocks=ldpc.LayeredDecoder(
                 plp.ldpc_table_name).resident_blocks(),
             resident_blocks_normal_c3_4=report[
                 "resident_blocks_normal_c3_4"],
             note="decoder kernel and screen kernel, one call; ms is both "
                  "(CUDA events); the decoder is one cooperative launch a "
                  "call; traced_ms is its device time a call in "
                  "torch.profiler's trace of 10 calls, traced_launches the "
                  "launches that trace holds; resident_blocks caps the "
                  "persistent grid on this card for the main path's table "
                  "(and for NORMAL r3/4, two blocks an SM, phase 2)"),
        dict(name="bch_screen", route="cuda", source=source,
             replaces="sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py:369",
             launches=strm["screen_launches"],
             launches_by_path=by_path("screen_launches"),
             lite=lite_rows(True),
             max_abs_err=main["screen_max_abs_err"], ms=main["screen_ms"],
             plain_ms=main["screen_plain_ms"],
             bound_ms=main["screen_bound"]["bound_ms"],
             bound_by=main["screen_bound"]["bound_by"],
             library_ms=main["library_ms"],
             traced_ms=traced(main, "bch_screen_kernel"),
             traced_launches=traced(main, "bch_screen_kernel", "launches"),
             note="second kernel of the same call; ms is the call's time "
                  "less its time without the screen (CUDA events); "
                  "traced_ms is its device time a launch (one a call) in "
                  "torch.profiler's trace of 10 calls; "
                  "bound by its bytes (no published 1-bit tensor rate)"),
    ]
    report["kernel_table"] = dict(rows=rows, flagship=main, mixed=mixed,
                                  lite=lite)
    return rows


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on a GPU")
    ap.add_argument("--report", type=Path, default=None,
                    help="write every measurement as JSON to this file")
    args = ap.parse_args(argv)
    if not (ROOT / PKG / "__init__.py").is_file():
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))     # _port_capture
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    report = {}
    # the 32K signals, made by the port's transmitter in worker processes
    # (spawned before this process touches the card) beside the builds;
    # then the pod's captures from the flagship's noise-free frames,
    # beside phases 4-8
    with ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn")) as pool:
        signals = {name: pool.submit(fn) for name, fn in (
            ("flagship", make_flagship_signal), ("sfn", make_sfn_signal),
            ("miso", make_miso_signal))}
        phase_build(report)
        phase_kernel_parity(report)
        flagship = signals["flagship"].result()
        sig = phase_receive(report, flagship)
        pod_dir = ROOT / "build" / "chip_smoke" / "pod"
        pod_dir.mkdir(parents=True, exist_ok=True)
        pod_paths = [str(pod_dir / f"ch{c}_pod_0_{STREAM_RATE}_8.raw")
                     for c in range(POD_CHANNELS)]
        pod_caps = [pool.submit(make_pod_capture, flagship[3], c, p)
                    for c, p in enumerate(pod_paths)]
        rank_dir = ROOT / "build" / "chip_smoke" / "ranks"
        rank_dir.mkdir(parents=True, exist_ok=True)
        rank_cap = rank_dir / "capture.npz"
        rank_cap_s = pool.submit(make_rank_capture, flagship[3],
                                 flagship[1], rank_cap)
        del flagship
        sfn_signal = signals["sfn"].result()
        miso_signal = signals["miso"].result()
        phase_stream(report, sig)
        phase_frame_batch(report, "sfn", "6 SFN frame batch", sfn_config,
                          sfn_signal)
        del sfn_signal
        phase_frame_batch(report, "miso", "7 MISO frame batch", miso_config,
                          miso_signal)
        del miso_signal
        phase_sfn_stream(report)
        report["pod_capture_s"] = [f.result() for f in pod_caps]
        report["rank_capture_s"] = rank_cap_s.result()
    phase_pod(report, sig, pod_paths)
    phase_pod_halo(report)
    phase_pod_ranks(report, sig, rank_cap)
    rows = phase_kernel_table(report, sig["llr"])
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(report["device"]["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
