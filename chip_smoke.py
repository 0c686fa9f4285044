#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sdr_receiver_dvb_t2_tpu_torch/ops/csrc``
with nvcc and its native host runtime (``native/dvbt2_runtime.cc``) with
g++, all at once, then:

1. prints the card (name, power limit) and the build time;
2. holds the LDPC kernel and its BCH screen bit-exact against their plain
   PyTorch twin (``exit_tile=1``) on all 13 code tables (NORMAL_C2_3 with
   256 codewords, the others 64), mixing noise-free, noisy and hopeless
   codewords: the tables differ in the width of the kernel's state word
   and in its unrolled slot count;
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
5. at the flagship batch's size holds the kernels against the twin again
   and times them: the whole call, the call without the screen (so the
   screen's own time), the twin, the bounds and the BCH product's
   ``torch.matmul``; then the same on a second load of 1616 codewords of
   which a quarter are hopeless and run all 15 sweeps, so that unequal
   sweeps are on record;
6. prints the kernel table as one JSON line (launches counted on the
   streaming path, and per path), the card's nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero.  Without a GPU, or without the port's
package beside it, it exits non-zero before printing any result.
``--report PATH`` also writes every measurement as JSON to PATH.
"""
from __future__ import annotations

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

ALL_TABLES = [("NORMAL", r) for r in ("C1_2", "C3_5", "C2_3", "C3_4", "C4_5",
                                       "C5_6")] + [
    ("SHORT", r) for r in ("C1_4", "C1_2", "C3_5", "C2_3", "C3_4", "C4_5",
                           "C5_6")]


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


def phase_receive(report):
    import numpy as np
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.io.bbframe import BBFrameParser
    from sdr_receiver_dvb_t2_tpu_torch.io.native import NativeBBFrameParser
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import (
        RxConfig, TorchReceiver)
    from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, ldpc, rx_chain

    mode, plp = flagship_config()
    t0 = time.perf_counter()
    frames, n_fec, ts = make_signal(mode, plp)
    tx_s = time.perf_counter() - t0
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
    batch = np.concatenate([frames] * 4)
    dev_batch = torch.from_numpy(batch).to(DEVICE)
    plan, consts = rx.plan, rx.consts
    samples = batch.shape[0] * mode.frame_samples
    eq, diag = rx_chain.frames_to_eq(dev_batch, plan, consts)
    llr, _ = rx_chain.packed_to_llr(eq, plan, consts)
    hard = rx.decoder(llr)[0]
    stages = dict(
        demod_eq_ms=cuda_ms(lambda: rx_chain.frames_to_eq(dev_batch, plan,
                                                          consts)),
        demap_ms=cuda_ms(lambda: rx_chain.packed_to_llr(eq, plan, consts)),
        ldpc_bch_kernel_ms=cuda_ms(lambda: rx.decoder(llr)),
        pack_ms=cuda_ms(lambda: bch_ops.pack_bits(hard[:, :plp.n_bch])),
    )

    def device_batch():
        out, done = rx.receive_plane_async(*rx.compute_plane(dev_batch))
        if done is not None:
            done.synchronize()
    device_batch()
    # peak device memory of one batch, above what is resident between
    # batches (the frames, the plan's tables)
    sync()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    device_batch()
    peak = torch.cuda.max_memory_allocated()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        device_batch()
    dev_s = (time.perf_counter() - t0) / reps
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
    if not all(o.bch_clean.all() and o.ldpc_ok.all() for o in outs + [r8]):
        raise AssertionError("8-frame batches did not decode clean")
    timing = dict(
        batch_frames=int(batch.shape[0]), batch_codewords=int(llr.shape[0]),
        stages_ms=stages, peak_memory_bytes=int(peak),
        resident_memory_bytes=int(resident),
        device_batch_ms=dev_s * 1e3, device_msps=samples / dev_s / 1e6,
        receive_plane_ms=full_s * 1e3,
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
            f"{k} {v:.3f}" for k, v in stages.items())
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
        f"(torch.cuda.max_memory_allocated): {peak} B, of which {resident} B "
        f"resident between batches")
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
    source = f"{PKG}/ops/csrc/ldpc_layered.cu"
    recv, strm = report["receive"], report["stream"]
    rows = [
        dict(name="ldpc_layered_bch", route="cuda", source=source,
             replaces="sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py:169",
             launches=strm["launches"],
             launches_by_path=dict(stream=strm["launches"],
                                   receive=recv["launches"]),
             max_abs_err=main["parity"]["max_abs_err"], ms=main["ms"],
             plain_ms=main["plain_ms"], bound_ms=main["bound"]["bound_ms"],
             bound_by=main["bound"]["bound_by"], library_ms=None,
             note="decoder kernel and screen kernel, one call; ms is both"),
        dict(name="bch_screen", route="cuda", source=source,
             replaces="sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py:369",
             launches=strm["screen_launches"],
             launches_by_path=dict(stream=strm["screen_launches"],
                                   receive=recv["screen_launches"]),
             max_abs_err=main["screen_max_abs_err"], ms=main["screen_ms"],
             plain_ms=main["screen_plain_ms"],
             bound_ms=main["screen_bound"]["bound_ms"],
             bound_by=main["screen_bound"]["bound_by"],
             library_ms=main["library_ms"],
             note="second kernel of the same call; ms is the call's time "
                  "less its time without the screen"),
    ]
    report["kernel_table"] = dict(rows=rows, flagship=main, mixed=mixed)
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
    report = {}
    phase_build(report)
    phase_kernel_parity(report)
    sig = phase_receive(report)
    phase_stream(report, sig)
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
