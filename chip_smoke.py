#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sdr_receiver_dvb_t2_tpu_torch/ops/csrc``
with nvcc and its native host runtime (``native/dvbt2_runtime.cc``) with
g++, all at once, then:

1. prints the card (name, power limit) and the build time;
2. holds the LDPC kernel and its BCH screen bit-exact against their plain
   PyTorch twin (``exit_tile=1``) on all 15 code tables, the T2-Lite B8
   and B9 included (NORMAL_C2_3 with 256 codewords, the others 64),
   mixing noise-free, noisy and hopeless codewords: the tables differ in
   the width of the kernel's state word and in its unrolled slot count;
3. receives two frames of the flagship mode (32K, GI 1/128, PP7 extended,
   rotated 256QAM, LDPC 64800 r2/3, 202 FEC blocks per frame) made by the
   port's transmitter with 27 dB AWGN, through ``TorchReceiver`` on the
   card: 404/404 LDPC ok and BCH clean, TS bytes equal to the transmitted
   stream, and both kernels launched.  Then times an 8-frame batch (1616
   codewords) stage by stage, reads its peak device memory, and times
   ``receive_stream`` over a few batches;
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
   launch a batch.  Holds one front-end block and the P1 search on the
   card against the CPU, and times acquisition, the front end, the P1
   search, each batch, and the raw input read over the whole run, after
   lock and after the pull-in;
5. (after phases 6-8) at the flagship batch's size holds the kernels
   against the twin again
   and times them: the whole call, the call without the screen (so the
   screen's own time), the twin, the bounds and the BCH product's
   ``torch.matmul``; then the same on a second load of 1616 codewords of
   which a quarter are hopeless and run all 15 sweeps, so that unequal
   sweeps are on record;
   then times both kernels on 1616 codewords of each T2-Lite table;
6. receives two full-width SFN frames (bench.py ``_bench_sfn``: 32K, GI
   1/32, PP7 extended, whose own pilots fall short of the guard, so the
   Wiener-row plan) through a -10 dB echo at 0.6 of the guard and 27 dB
   AWGN: every codeword clean, the TS exact, one launch of each kernel;
   holds one frame's equalized plane, csi and delay profile on the card
   against the CPU, and times an 8-frame batch stage by stage;
7. the same for MISO (bench.py ``_bench_miso``: 32K, GI 1/128, PP8
   extended, two transmit groups with their own two-path channels);
8. streams the 2K GI 1/8 PP7 u8 capture of tests/_port_capture.py
   through ``StreamingReceiver`` on the card: locked with the SFN plan,
   the TS exact, the first-path timing loop's moves reported, one decoder
   launch a batch;
9. prints the kernel table as one JSON line (launches counted on the
   streaming path, and per path), the card's nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

The port's transmitter makes the 32K signals of phases 3, 6 and 7 in
worker processes started first, beside the builds and phases 1-2.

Any failed phase exits non-zero.  Without a GPU, or without the port's
package beside it, it exits non-zero before printing any result.
``--report PATH`` also writes every measurement as JSON to PATH.
"""
from __future__ import annotations

import dataclasses
import json
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
# card against CPU on one full-width frame (phases 6-7): the same float32
# stages summed in another order; relative rms of the plane and of csi,
# and the delay profile's largest difference over its peak
PLANE_REL_DB_MAX = -80.0
CIR_REL_MAX = 1e-4


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


def cuda_ms(fn, reps=5, warmup=1):
    """Mean device milliseconds of fn() over reps, after warmup."""
    import torch
    for _ in range(warmup):
        fn()
    sync()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
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


def check_kernel_against_twin(llr, plp, max_iters=15):
    """Kernel and twin (exit_tile=1) on the same int8 LLRs on the card.
    Returns (result dict, kernel outputs); raises on any difference."""
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, ldpc
    h = bch_ops._h_matrix(plp.k_bch, plp.bch_m, plp.bch_t)
    dec = ldpc.LayeredDecoder(plp.ldpc_table_name, max_iters=max_iters,
                              bch_h=h)
    got = dec(llr)
    sync()
    want = ldpc.decode_plain(llr, plp.ldpc_table_name, max_iters, h,
                             exit_tile=1)
    sync()
    names = ("hard", "ok", "iters", "clean")
    diff = {n: int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
            for n, g, w in zip(names, got, want)}
    res = dict(table=plp.ldpc_table_name, n_cw=int(llr.shape[0]),
               max_abs_err=max(diff.values()), per_output=diff,
               ok=int(got[1].sum()), clean=int(got[3].sum()),
               iters_hist=torch.bincount(got[2].long().cpu()).tolist())
    if any(diff.values()):
        raise AssertionError(f"kernel differs from its twin: {res}")
    return res, got


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


def phase_kernel_parity(report):
    import torch
    rows = []
    for frame, rate in ALL_TABLES:
        n_cw = 256 if (frame, rate) == ("NORMAL", "C2_3") else 64
        llr, plp = coded_llrs(rate, frame, n_cw, seed=len(rows) + 1)
        res, _ = check_kernel_against_twin(
            torch.from_numpy(llr).to(DEVICE), plp)
        rows.append(res)
    report["kernel_parity"] = rows
    log(f"phase 2 kernel vs twin (bit-exact hard/ok/iters/clean) on "
        f"{len(rows)} tables: " + "; ".join(
        f"{r['table']} W={r['n_cw']} ok={r['ok']} clean={r['clean']} "
        f"iters={r['iters_hist']}" for r in rows))


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
    """Full frames from the port's transmitter plus seeded AWGN."""
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
    return (iq + noise).astype(np.complex64), n_fec, ts


def phase_receive(report, signal):
    """Phase 3 on ``signal`` (make_flagship_signal's result)."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch.io.bbframe import BBFrameParser
    from sdr_receiver_dvb_t2_tpu_torch.io.native import NativeBBFrameParser
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import (
        RxConfig, TorchReceiver)
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc

    mode, plp = flagship_config()
    frames, n_fec, ts, tx_s = signal
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
            and launches > 0 and screen_launches > 0 and finite
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
    if launches != n_batches or screen_launches != n_batches:
        problems.append("not one decoder launch a batch")
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
    from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, rx_chain
    batch = np.concatenate([frames] * (8 // len(frames)))
    dev_batch = torch.from_numpy(batch).to(DEVICE)
    plan, consts = rx.plan, rx.consts
    eq, diag = rx_chain.frames_to_eq(dev_batch, plan, consts)
    csi = diag.get("csi")
    llr, _ = rx_chain.packed_to_llr(eq, plan, consts, csi=csi)
    hard = rx.decoder(llr)[0]
    stages = dict(
        demod_eq_ms=cuda_ms(lambda: rx_chain.frames_to_eq(dev_batch, plan,
                                                          consts)),
        demap_ms=cuda_ms(lambda: rx_chain.packed_to_llr(eq, plan, consts,
                                                        csi=csi)),
        ldpc_bch_kernel_ms=cuda_ms(lambda: rx.decoder(llr)),
        pack_ms=cuda_ms(lambda: bch_ops.pack_bits(hard[:, :rx.plp.n_bch])))

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
    exact, one launch of each kernel), one frame on the card against the
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
    if launches != 1 or screen_launches != 1:
        problems.append("not one launch of each kernel")
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
    decoded, the TS exact, one decoder launch a batch; the first-path
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
    if launches != len(batches) or screen_launches != len(batches):
        problems.append("not one decoder launch a batch")
    if any(abs(n) > 24 for n in rec["cir_nudges"]):
        problems.append("a first-path move beyond the loop's clamp")
    if problems:
        raise AssertionError(f"phase 8: {problems}: {rec}")
    Path(path).unlink()


def kernel_bounds(plan, w, sweeps, n_syn):
    """Least times (ms) the card could take for the decoder with its screen
    and for the screen alone, from this run's sizes and sweeps: each input
    read once and each output written once at the HBM rate, against the
    operations at the 32-bit rate."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    edges = plan.q * (plan.cnl + 2) * ldpc.M
    words = -(-plan.k // 32)
    h_bytes = n_syn * words * 4                       # packed H, read once
    screen_ops = 2 * w * n_syn * words                # and + popcount a word
    whole = dict(bytes=w * (plan.n + plan.k + 6) + h_bytes,
                 ops=OPS_PER_EDGE_SWEEP * edges * sweeps + screen_ops)
    # the screen alone: packed hard bits and H in, one flag a codeword out
    screen = dict(bytes=w * words * 4 + h_bytes + w, ops=screen_ops)
    for b in (whole, screen):
        b["bytes_ms"] = b["bytes"] / HBM_BYTES_PER_S * 1e3
        b["ops_ms"] = b["ops"] / SCALAR_OPS_PER_S * 1e3
        b["bound_ms"] = max(b["bytes_ms"], b["ops_ms"])
        b["bound_by"] = ("bytes" if b["bytes_ms"] >= b["ops_ms"]
                         else "operations")
    return whole, screen


def time_kernels(llr, plp, label):
    """Parity with the twin, then the times of one load [W, N]: the whole
    call, the call without the screen, the twin, the screen's plain version
    and its library product."""
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, ldpc
    parity, got = check_kernel_against_twin(llr, plp)
    h = bch_ops._h_matrix(plp.k_bch, plp.bch_m, plp.bch_t)
    name = plp.ldpc_table_name
    dec = ldpc.LayeredDecoder(name, bch_h=h)
    dec_bare = ldpc.LayeredDecoder(name, bch_h=None)
    # in turns, so that both see the same card state
    ms_a, bare_a = cuda_ms(lambda: dec(llr), reps=10), cuda_ms(
        lambda: dec_bare(llr), reps=10)
    bare_b, ms_b = cuda_ms(lambda: dec_bare(llr), reps=10), cuda_ms(
        lambda: dec(llr), reps=10)
    ms, bare_ms = (ms_a + ms_b) / 2, (bare_a + bare_b) / 2
    plain_ms = cuda_ms(lambda: ldpc.decode_plain(llr, name, 15, h,
                                                 exit_tile=1), reps=1)
    hard = got[0]
    screen_plain_ms = cuda_ms(lambda: bch_ops.syndrome_flags(hard, h), reps=3)
    hard_f = hard[:, :h.shape[0]].float()
    h_t = torch.from_numpy(h).to(DEVICE)
    library_ms = cuda_ms(lambda: torch.matmul(hard_f, h_t), reps=10)
    clean_err = int((got[3].int() - bch_ops.syndrome_flags(hard, h).int())
                    .abs().max())
    w, sweeps = int(llr.shape[0]), int(got[2].sum())   # iters sweeps each
    whole, screen = kernel_bounds(ldpc.get_plan(name), w, sweeps, h.shape[1])
    res = dict(label=label, parity=parity, n_cw=w, sweeps=sweeps, ms=ms,
               ms_runs=[ms_a, ms_b], without_screen_ms=bare_ms,
               without_screen_runs=[bare_a, bare_b], screen_ms=ms - bare_ms,
               plain_ms=plain_ms, screen_plain_ms=screen_plain_ms,
               library_ms=library_ms, screen_max_abs_err=clean_err,
               bound=whole, screen_bound=screen)
    log(f"phase 5 {label}, W={w}, {sweeps} sweeps, bit-exact: call {ms:.3f} "
        f"ms (bound {whole['bound_ms']:.4f} ms by {whole['bound_by']}), "
        f"without the screen {bare_ms:.3f} ms, so the screen "
        f"{ms - bare_ms:.3f} ms (bound {screen['bound_ms']:.4f} ms by "
        f"{screen['bound_by']}; torch.matmul {library_ms:.3f} ms; plain "
        f"{screen_plain_ms:.2f} ms); twin {plain_ms:.1f} ms")
    return res


def phase_kernel_table(report, llr):
    """The decoder kernel and the screen kernel at the main path's shape
    (the 1616 codewords of the flagship batch) and on a second load of as
    many codewords with unequal sweeps.  Returns the kernel table's rows,
    taken from the main path's load."""
    import numpy as np
    import torch
    _, plp = flagship_config()
    main = time_kernels(llr, plp, "flagship batch")
    mixed_llr, _ = coded_llrs("C2_3", "NORMAL", 404, seed=21)
    mixed = time_kernels(
        torch.from_numpy(np.tile(mixed_llr, (4, 1))).to(DEVICE), plp,
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
                 miso_receive="miso", sfn_stream="sfn_stream")

    def by_path(count):
        return {name: report[key][count] for name, key in paths.items()}

    def lite_rows(screen):
        return {t: dict(n_cw=r["n_cw"], sweeps=r["sweeps"],
                        ms=r["screen_ms"] if screen else r["ms"],
                        plain_ms=(r["screen_plain_ms"] if screen
                                  else r["plain_ms"]),
                        bound_ms=r["screen_bound" if screen
                                   else "bound"]["bound_ms"],
                        library_ms=r["library_ms"] if screen else None,
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
             note="decoder kernel and screen kernel, one call; ms is both"),
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
             note="second kernel of the same call; ms is the call's time "
                  "less its time without the screen"),
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
    # (spawned before this process touches the card) beside the builds
    with ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        signals = {name: pool.submit(fn) for name, fn in (
            ("flagship", make_flagship_signal), ("sfn", make_sfn_signal),
            ("miso", make_miso_signal))}
        phase_build(report)
        phase_kernel_parity(report)
        sig = phase_receive(report, signals["flagship"].result())
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
