"""Frame-batch receiver on the GPU: the device data plane + host control.

  device (one pass per frame batch, PyTorch on the receiver's device):
      symbol framing -> batched FFT -> pilot equalization (linear, SFN
      or MISO plan) -> composed frequency/time/cell deinterleave +
      rotated-QAM soft demap -> int8 LLR codewords          [ops/rx_chain]
  device (CUDA kernel):
      layered min-sum LDPC with the BCH syndrome screen     [ops/ldpc]
      fused into its epilogue; bit packing to bytes
  host:
      L1 acquisition (once per configuration), rare BCH corrections, BB
      frame de-encapsulation to TS bytes (the C++ runtime of
      io/native.py; the Python parser only when asked for).

Every entry point runs on ``cuda`` unless ``device="cpu"`` is passed; on a
CPU tensor the decoder is the kernel's plain PyTorch twin.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import resolve_device
from ..io.bbframe import HEADER_BITS
from ..io.native import make_bb_parser
from ..ops import bch_ops, rx_chain
from ..ops.ldpc import LayeredDecoder
from ..params import l1 as l1_mod
from ..params.modes import (T2Mode, PlpConfig, Constellation, CodeRate,
                            FecFrame, PilotPattern, GuardInterval, Papr)
from . import receiver_ref


@dataclasses.dataclass
class RxConfig:
    mode: T2Mode
    plp: PlpConfig
    n_fec_per_frame: int
    n_ti: int
    plp_start: int = 0                  # cell address after L1 (multi-PLP)
    ldpc_max_iters: int = 15
    sfn: bool = False                   # Wiener rows on a mode whose
    #                                     default plan is linear (a long
    #                                     echo measured at acquisition)


@dataclasses.dataclass
class FrameBatchResult:
    ts_bytes: np.ndarray
    ldpc_ok: np.ndarray
    bch_clean: np.ndarray
    bch_corrected: np.ndarray
    snr_db: float
    ldpc_iters: np.ndarray          # per-codeword first-clean iteration
    diag: dict
    # (bb_frame_index, padding-field bits) for each first-BB-frame-of-an-
    # interleaving-frame whose DFL left a padding field (in-band signalling)
    padding: list = dataclasses.field(default_factory=list)


def config_from_l1(mode_hint: T2Mode, pre: l1_mod.L1Pre,
                   post: l1_mod.L1Post, plp_idx: int = 0,
                   sfn: bool = False) -> RxConfig:
    """Build the receiver configuration from decoded L1 signalling.

    ``sfn=True``: acquisition measured a delay spread that needs the
    Wiener-row (SFN) plan."""
    p = post.plp[plp_idx]
    mode = T2Mode(
        fft_mode=mode_hint.fft_mode,
        guard=GuardInterval(pre.guard_interval),
        pilot_pattern=PilotPattern(pre.pilot_pattern),
        extended_carriers=bool(pre.bwt_ext),
        papr=Papr(pre.papr),
        miso=mode_hint.miso,        # from the P1 S1 field (acquisition)
        lite=mode_hint.lite,
        n_data_symbols=pre.num_data_symbols,
    )
    plp = PlpConfig(
        plp_id=p.id,
        constellation=Constellation(p.plp_mod),
        rotation=bool(p.plp_rotation),
        code_rate=CodeRate(p.plp_cod),
        fec_frame=FecFrame(p.plp_fec_type),
        num_blocks_max=p.plp_num_blocks_max,
        time_il_length=p.time_il_length,
        time_il_type=p.time_il_type,
    )
    n_fec = post.dyn.plp[plp_idx].num_blocks
    n_ti = max(1, p.time_il_length if p.time_il_type == 0 else 1)
    return RxConfig(mode=mode, plp=plp, n_fec_per_frame=n_fec, n_ti=n_ti,
                    plp_start=post.dyn.plp[plp_idx].start, sfn=sfn)


def plan_from_numpy(arrays: dict, device) -> dict:
    """The receiver's device plan from plan arrays given as numpy, keyed as
    :meth:`ops.rx_chain.ChainPlan.arrays` keys them (the same tables the JAX
    package's ChainPlan holds)."""
    return rx_chain.consts_from_arrays(arrays, resolve_device(device))


class TorchReceiver:
    """Steady-state frame-batch receiver for one PLP.

    ``bb_parser``: "native" (the C++ de-encapsulator, built at first use;
    a failed build raises) or "python" (its plain reference)."""

    def __init__(self, cfg: RxConfig, device=None, bb_parser: str = "native"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mode = cfg.mode.validate()
        self.plp = cfg.plp
        self.oracle = receiver_ref.ReferenceReceiver(self.mode)
        self.bb = make_bb_parser(bb_parser)
        self.decoder = LayeredDecoder(
            self.plp.ldpc_table_name, max_iters=cfg.ldpc_max_iters,
            bch_h=bch_ops._h_matrix(self.plp.k_bch, self.plp.bch_m,
                                    self.plp.bch_t))
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    # ------------------------------------------------------------------
    @functools.cached_property
    def plan(self) -> rx_chain.ChainPlan:
        return rx_chain.get_plan(
            self.mode, self.plp, self.cfg.n_fec_per_frame, self.cfg.n_ti,
            l1_mod.L1_PRE_CELLS + self._l1_post_cells + self.cfg.plp_start,
            sfn=self.cfg.sfn)

    @functools.cached_property
    def consts(self) -> dict:
        """The plan's tables on the receiver's device, moved there once."""
        return self.plan.to_device(self.device)

    def compute_plane(self, frames_iq):
        """Demod + equalize once; the result feeds every PLP's demap.
        ``frames_iq``: [F, frame_samples] complex, numpy or a tensor (one
        already on the device is used in place).  Returns (eq planes
        [F, L, K] complex64 on the device, diag)."""
        if not isinstance(frames_iq, torch.Tensor):
            frames_iq = torch.from_numpy(np.asarray(frames_iq, np.complex64))
        frames = frames_iq.to(self.device, torch.complex64)
        return rx_chain.frames_to_eq(frames, self.plan, self.consts)

    def l1_cells(self, eq) -> np.ndarray:
        """L1 signalling cells (complex) of the batch's first frame, read
        from the equalized plane (compute_plane output)."""
        n_sig = l1_mod.L1_PRE_CELLS + self._l1_post_cells
        idx = self.consts["sig_idx"][:n_sig]
        return eq[0].reshape(-1)[idx].cpu().numpy()

    def equalized_cells(self, frames_iq) -> np.ndarray:
        """Deinterleaved constellation cells (complex, [F*n_fec, n_cells])
        for diagnostics: the reference's constellation plot data
        (main_window.cpp:416-476)."""
        eq, _ = self.compute_plane(frames_iq)
        return rx_chain.eq_to_cells(eq, self.consts).cpu().numpy()

    # ------------------------------------------------------------------
    def acquire_l1(self, frame_iq: np.ndarray):
        """Host path: demodulate one frame and decode L1 (oracle logic)."""
        carriers = self.oracle.demod_symbols(np.asarray(frame_iq))
        payload = self.oracle.equalize_deinterleave(carriers)
        pre, post, _ = self.oracle.decode_l1(payload)
        return pre, post

    @functools.cached_property
    def _l1_post_cells(self) -> int:
        pre, _post = self.acquire_l1(self._first_frame)
        assert pre is not None, "L1-pre CRC failed during acquisition"
        return pre.l1_post_size

    def prime(self, first_frame_iq: np.ndarray):
        """Provide one frame for L1 acquisition before streaming."""
        self._first_frame = np.asarray(first_frame_iq)
        _ = self._l1_post_cells
        return self

    # ------------------------------------------------------------------
    def receive(self, frames_iq: np.ndarray) -> FrameBatchResult:
        """[F, frame_samples] complex ndarray -> decoded TS + statistics."""
        return self.receive_plane(*self.compute_plane(frames_iq))

    def receive_stream(self, batches):
        """Double-buffered receive over an iterable of frame batches.

        Enqueues batch N+1's device work before waiting for batch N's
        device-to-host copy (which runs on a side stream into pinned host
        memory) and assembling its TS on the host.  Yields one
        FrameBatchResult per batch, in order.
        """
        pending = None
        for frames in batches:
            nxt = self.receive_plane_async(*self.compute_plane(frames))
            if pending is not None:
                yield self.finish(pending)
            pending = nxt
        if pending is not None:
            yield self.finish(pending)

    def receive_plane(self, eq, diags) -> FrameBatchResult:
        """Decode this PLP from a shared eq plane (compute_plane)."""
        return self.finish(self.receive_plane_async(eq, diags))

    def receive_plane_async(self, eq, diags):
        """Device half: enqueue demap + FEC + bit packing, and start the
        device-to-host copies without blocking; finish() completes them.

        No padding of the codeword count is needed: the kernel gives each
        codeword its own thread block (the TPU kernel took 128-codeword
        tiles).  An SFN plan's ``csi`` plane weights the demap and stays on
        the device (8 frames of it at 32K are 53 MB)."""
        llr, snr = rx_chain.packed_to_llr(eq, self.plan, self.consts,
                                          csi=diags.get("csi"))
        diags = {k: v for k, v in diags.items() if k != "csi"}
        hard, ok, iters, clean = self.decoder(llr)
        # pack to bytes on the device: the copy to the host shrinks 8x and
        # the host receives BB-frame bytes (n_bch, so that the rare dirty
        # codewords can be BCH-corrected without another round trip)
        packed = bch_ops.pack_bits(hard[:, :self.plp.n_bch])
        out = dict(packed=packed, clean=clean, ok=ok, iters=iters,
                   snr_db=snr, **diags)
        if self._copy_stream is None:
            return out, None
        main = torch.cuda.current_stream(self.device)
        side = self._copy_stream
        side.wait_stream(main)
        host = {}
        with torch.cuda.stream(side):
            for k, v in out.items():
                v.record_stream(side)
                host[k] = torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=True)
                host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
        return host, done

    def finish(self, pending) -> FrameBatchResult:
        """Host half: wait for the copies and assemble TS bytes."""
        out, done = pending
        if done is not None:
            done.synchronize()
        out = {k: v.numpy() for k, v in out.items()}
        packed_np = out.pop("packed")                     # [n_cw, n_bch/8]
        clean_np = out.pop("clean")
        ok, iters = out.pop("ok"), out.pop("iters")
        n_cw = packed_np.shape[0]
        corrected = np.zeros(n_cw, dtype=np.int64)
        kb = self.plp.k_bch // 8
        frames_bytes = np.ascontiguousarray(packed_np[:, :kb])
        for i in np.nonzero(~clean_np)[0]:
            bits = np.unpackbits(packed_np[i])[:self.plp.n_bch]
            fixed, nerr = bch_ops.correct_host(bits, self.plp)
            corrected[i] = nerr
            # a codeword the BCH could not correct reaches the parser as a
            # frame it drops, not as its own bytes: those pass the header's
            # CRC-8 now and then and come out as TS packets that were never
            # sent (the JAX receiver passes them on, receiver.py:305-309)
            frames_bytes[i] = (np.packbits(fixed) if nerr >= 0
                               else self._dropped_frame)
        ts_bytes = self.bb.parse_batch(frames_bytes)
        return FrameBatchResult(
            ts_bytes=ts_bytes,
            ldpc_ok=ok,
            bch_clean=clean_np,
            bch_corrected=corrected,
            snr_db=float(np.mean(out["snr_db"])),
            ldpc_iters=iters,
            diag=out,
            padding=self._collect_padding(frames_bytes),
        )

    @functools.cached_property
    def _dropped_frame(self) -> np.ndarray:
        """A scrambled BB frame whose header fails its CRC-8, so that a
        parser drops it and resynchronises as after any damaged header."""
        frame = np.zeros(self.plp.k_bch // 8, np.uint8)
        # after nine zero bytes a CRC byte of 0x00 checks as NM and 0x01
        # as HEM; 0x02 checks as neither
        frame[9] = 0x02
        return frame ^ self._scrambler_bytes

    @functools.cached_property
    def _scrambler_bytes(self) -> np.ndarray:
        from ..params import prbs
        return np.packbits(prbs.bb_scrambler(self.plp.k_bch))

    def _collect_padding(self, frames_bytes: np.ndarray) -> list:
        """Padding-field bits of each interleaving frame's first BB frame
        (where in-band signalling rides, EN 302 755 clause 5.2.3).  Only
        frames whose DFL leaves padding are descrambled."""
        out = []
        scr = self._scrambler_bytes
        kb = self.plp.k_bch // 8
        for j in range(0, len(frames_bytes), self.cfg.n_fec_per_frame):
            hdr = frames_bytes[j, :10] ^ scr[:10]
            dfl = int(hdr[4]) << 8 | int(hdr[5])
            if dfl <= 0 or dfl % 8 or HEADER_BITS + dfl >= kb * 8:
                continue
            pad = np.unpackbits(
                frames_bytes[j, 10 + dfl // 8:] ^ scr[10 + dfl // 8:])
            out.append((j, pad))
        return out
