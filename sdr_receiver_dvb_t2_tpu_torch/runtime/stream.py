"""Streaming receiver: raw SDR samples in, MPEG transport stream out.

Host control loop around the device data plane.  Stages and their
reference counterparts:

  front end (device, one plain tensor function per raw block)
      conditioning -> NCO -> x4 half-band -> Farrow -> FIR  [ops/frontend]
      = convert_iq + derotation + resample + decimate
        (dvbt2_demodulator.cpp:151-192), block-recurrent instead of
        sample-serial: corrections measured on batch N apply to batch N+1.
  acquisition (host, rare)
      P1 search (device correlator) -> S1/S2 -> GI/EXT scan -> L1
      (runtime/acquisition.py) = p1_symbol + GI brute force + L1 decode.
  steady state (device)
      frame batches -> rx_chain -> LDPC kernel -> BCH -> TS  [models/receiver]
  tracking (host, per batch)
      residual CFO from the guard-interval discriminator, sampling-rate
      trim from the pilot-drift discriminator, P1-anchored frame timing
      (on SFN plans steered to the channel's first path by the
      equalizer's delay profile), replacing the reference's per-sample
      PI loops (dvbt2_demodulator.h:267-277) with block-wise
      estimate->apply.

The host keeps its sample rings in numpy (raw samples in the source's wire
format, elementary-rate output); each raw block goes to the device as it
came off the wire, is converted there (``ops/frontend.raw_to_iq``), and
its output comes back.  Everything on the device runs on ``device`` (cuda
unless the caller passes "cpu").
"""
from __future__ import annotations

import copy
import dataclasses
import sys

import numpy as np
import torch

from .. import resolve_device
from ..io.sources import WIRE_DTYPES
from ..models import receiver as receiver_mod
from ..ops import equalizer as eq_mod
from ..ops import frontend as fe, p1_detect
from ..params import l1 as l1_lib
from ..params import p1 as p1_mod
from ..params.modes import SAMPLE_RATE
from . import acquisition
from .agc import Agc
from .diagnostics import LdpcStats

UPSAMPLE = 2.0                      # Farrow output rate / elementary rate


def raw_to_complex_np(block: np.ndarray, fmt: str, out=None):
    """Host-side twin of ops/frontend.raw_to_iq (same scaling), for the
    pod's host stores.

    Interleaved I/Q ints -> complex64 in ONE scaled write pass: a
    complex64 array's memory IS interleaved float32 (re, im) pairs, so
    the conversion writes straight into the destination's float32 view
    (no deinterleave, no temporaries).  With ``out=`` (complex64, at
    least len(block)//2 samples — e.g. pod.ChannelStore.borrow space)
    the samples land in place and the count written is returned;
    otherwise a fresh array is returned.
    """
    n = len(block) // 2
    dst = np.empty(n, np.complex64) if out is None else out[:n]
    v = dst.view(np.float32)
    if fmt == "u8":
        np.subtract(block[:2 * n], np.float32(127.5), out=v)
        v *= np.float32(1.0 / 128.0)
    elif fmt == "s8":
        np.multiply(block[:2 * n], np.float32(1.0 / 128.0), out=v)
    elif fmt == "s16":
        np.multiply(block[:2 * n], np.float32(1.0 / 32768.0), out=v)
    elif fmt == "f32":
        v[:] = block[:2 * n]
    else:
        raise ValueError(f"unknown IQ format {fmt!r}")
    return dst if out is None else n


@dataclasses.dataclass
class StreamConfig:
    fir_preset: str = "medium"
    frames_per_batch: int = 2
    ldpc_max_iters: int = 15
    plp_index: int | None = 0       # None = decode ALL PLPs
    cfo_gain: float = 0.3           # residual-CFO loop gain per batch
    sro_gain: float = 0.5           # sampling-rate trim gain per batch
    cond_alpha: float = 0.1         # DC / IQ-imbalance smoothing
    n_up_block: int = 1 << 19       # farrow outputs per front-end block
    acq_elem_samples: int = 3_500_000   # covers one max-size frame + P1
    notch_spur: bool = False        # track + notch a CW spur (anti-spur)
    hw_retune: bool = True          # push coarse CFO into the tuner when
                                    # the source supports set_center_freq
    retune_settle_s: float = 0.05   # samples to discard after a retune


@dataclasses.dataclass
class RunStats:
    frames: int = 0
    ts_packets: int = 0
    ldpc_failures: int = 0
    bch_dirty: int = 0
    bch_corrected: int = 0
    snr_db: float = 0.0
    cfo_hz: float = 0.0
    sro_ppm: float = 0.0
    inband_a_blocks: int = 0     # in-band type A blocks harvested (5.2.3.1)
    cir_nudge: int = 0           # last batch's first-path timing move
    state: str = "init"


class StreamingReceiver:
    """source -> (front end, acquire, track) -> sink."""

    def __init__(self, source, sink, cfg: StreamConfig | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.src = source
        self.sink = sink
        self.cfg = cfg or StreamConfig()
        self.stats = RunStats()

        rate = source.info.sample_rate
        # the Farrow runs on a x4 pre-upsampled grid (two half-band stages)
        # so its cubic alias images stay ~45 dB down; ``step`` is grid
        # samples per Farrow output
        self.step = float(4.0 * rate / (UPSAMPLE * SAMPLE_RATE))
        self.n_up = self.cfg.n_up_block
        # raw samples per block: grid needs step*n_up -> /4, +margins
        self.n_in = int(np.ceil(self.step * self.n_up / 4.0)) + 8
        self.taps = fe.fir_taps(self.cfg.fir_preset)
        self.hb_taps = np.asarray(fe.halfband_taps(), np.float32)
        self._fir_dev = torch.from_numpy(self.taps).to(self.device)
        self._hb_dev = torch.from_numpy(self.hb_taps).to(self.device)

        # carried front-end state
        self.cond = fe.IqCondState()
        self.mu = 4.0                 # farrow position on the x4 grid
        self.phase = 0.0              # NCO phase at window start (rad)
        self.freq = 0.0               # NCO rad per raw sample
        self.fir_hist = self._czeros(len(self.taps) - 1)
        self.hb1_hist = self._czeros(len(self.hb_taps) - 1)
        self.hb2_hist = self._czeros(len(self.hb_taps) - 1)

        # host raw ring in the wire format; ``_w`` ring entries a sample
        fmt = source.info.fmt
        self._raw = np.empty(0, WIRE_DTYPES[fmt])
        self._w = 1 if fmt == "c64" else 2
        self.spur = None                         # anti-spur tracker state
        self._elem = np.empty(0, np.complex64)  # elementary-rate buffer
        self.agc = Agc(source)                  # active only for live SDRs
        self.ldpc_stats = LdpcStats(max_iters=self.cfg.ldpc_max_iters)

        # per-PLP sinks for plp_index=None (PLP ordinal i -> plp_sinks[i]);
        # mirrors the reference's per-PLP output table (port 7654+i).
        # sink_factory(ordinal, plp_id) -> sink|None creates them lazily so
        # EVERY PLP announced in L1 gets an output, whatever their count
        self.plp_sinks: dict = {}
        self.sink_factory = None
        # set after acquisition
        self.rx = None
        self.rxs: list = []
        self.mode = None
        self.frame_pos = None          # index of next frame start in _elem

    def _czeros(self, n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.complex64, device=self.device)

    def _new_rx(self, rx_cfg, l1_post_cells: int):
        """One PLP's frame receiver on this receiver's device; its L1-post
        size is known from acquisition, so it needs no priming frame."""
        rx_cfg.ldpc_max_iters = self.cfg.ldpc_max_iters
        rx = receiver_mod.TorchReceiver(rx_cfg, device=self.device)
        rx._l1_post_cells = l1_post_cells
        return rx

    # ------------------------------------------------------------------
    def _pump(self) -> bool:
        """Read one raw block, run the front end, append elementary IQ."""
        w = self._w
        while len(self._raw) < w * self.n_in:
            blk = self.src.read(self.n_in)
            if blk is None:
                return False
            self._raw = np.concatenate([self._raw, blk])
        raw = self._raw[:w * self.n_in]

        if self.cfg.notch_spur and self._spur_redetect_due():
            det = fe.detect_spur(self._iq(torch.from_numpy(raw)).numpy())
            if det or self.spur is None:
                # arm the tracker even without a detection (amp 0 = no-op);
                # re-detection runs on relock and periodically while the
                # tracked amplitude stays ~0 (late-appearing spurs)
                self.spur = dict(omega=det[0] if det else 0.0,
                                 amp=det[1] if det else 0j,
                                 phase=0.0, m_prev=None)
        spur = None
        if self.cfg.notch_spur:
            sp = self.spur
            spur = (np.float32(sp["phase"]), np.float32(sp["omega"]),
                    np.float32(sp["amp"].real), np.float32(sp["amp"].imag))
        # the block crosses to the device in its wire format (a quarter of
        # complex64's bytes for u8) and is converted there
        window = self._iq(torch.from_numpy(raw).to(self.device))
        s_hi, s_lo = fe.split_step(self.step)
        elem, hist2, hb1n, hb2n, cond_stats, spur_m = fe.frontend_block(
            window, np.float32(self.cond.c1), np.float32(self.cond.c2),
            np.float32(self.phase), np.float32(self.freq),
            np.float32(self.mu), s_hi, s_lo, self.fir_hist, self.hb1_hist,
            self.hb2_hist, self._fir_dev, self._hb_dev, self.n_up, spur)
        self.fir_hist, self.hb1_hist, self.hb2_hist = hist2, hb1n, hb2n
        self.cond = fe.fold_iq_stats(self.cond, cond_stats.cpu().numpy(),
                                     alpha=self.cfg.cond_alpha)
        self.agc.update(self.cond.level)

        # advance on the x4 grid, consuming whole raw samples only
        p_next = self.mu + self.step * self.n_up
        consumed_raw = (int(np.floor(p_next)) - 4) // 4
        self.mu = p_next - 4 * consumed_raw
        self.phase = float((self.phase + self.freq * consumed_raw)
                           % (2 * np.pi))
        if spur_m is not None:
            # spur tracking: smooth the measured amplitude, refine omega
            # from the block-to-block rotation of the residual phasor
            m_re, m_im = spur_m.cpu().numpy()
            m = complex(float(m_re), float(m_im))
            sp = self.spur
            sp["amp"] += 0.5 * (m - sp["amp"])
            # residual frequency error rotates m by delta*consumed between
            # consecutive (continuously-phased) windows
            if sp["m_prev"] is not None and abs(sp["m_prev"]) > 0:
                rot = m * np.conj(sp["m_prev"])
                if abs(rot) > 0:
                    sp["omega"] += 0.5 * float(np.angle(rot)) / consumed_raw
            sp["m_prev"] = m
            sp["phase"] = float((sp["phase"] + sp["omega"] * consumed_raw)
                                % (2 * np.pi))
        self._raw = self._raw[w * consumed_raw:]
        self._elem = np.concatenate([self._elem, elem.cpu().numpy()])
        return True

    def _iq(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw ring samples as complex64, converted where they lie."""
        fmt = self.src.info.fmt
        return raw if fmt == "c64" else fe.raw_to_iq(raw, fmt)

    def _spur_redetect_due(self) -> bool:
        """True when the anti-spur detector should (re)run on this block:
        never armed yet, or armed-but-idle (|amp| ~ 0, i.e. nothing is being
        notched) for 64 consecutive blocks, so a spur that appears mid-run
        is acquired without waiting for a full relock."""
        if self.spur is None:
            return True
        if abs(self.spur["amp"]) > 1e-4:
            self._spur_idle_blocks = 0
            return False
        self._spur_idle_blocks = getattr(self, "_spur_idle_blocks", 0) + 1
        if self._spur_idle_blocks >= 64:
            self._spur_idle_blocks = 0
            return True
        return False

    def _need_elem(self, n: int) -> bool:
        while len(self._elem) < n:
            if not self._pump():
                return False
        return True

    def _detect(self, elem: np.ndarray):
        """P1 search on host samples, on the device: (t0, peak, cfo)."""
        t0, peak, cfo = p1_detect.detect(
            torch.from_numpy(np.ascontiguousarray(elem)).to(self.device))
        return int(t0), float(peak), float(cfo)

    # ------------------------------------------------------------------
    def acquire(self) -> bool:
        """P1 search + CFO correction + L1 decode; sets up the receiver."""
        n_acq = self.cfg.acq_elem_samples or (1 << 21)
        self._need_elem(n_acq)               # best effort; short files OK
        n_acq = min(n_acq, len(self._elem))
        if n_acq < 4 * p1_mod.P1_LEN:
            self.stats.state = "no_signal"
            return False
        # P1 search; a mixed stream (S2 field 2) interleaves FEF parts that
        # open with their OWN P1 carrying a non-T2 S1: skip past those and
        # keep searching for the T2 preamble (EN 302 755 clause 8.4; the
        # reference has no FEF handling and would fail its L1 decode here)
        search0 = 0
        for _ in range(6):
            if n_acq - search0 < 4 * p1_mod.P1_LEN:
                self.stats.state = "no_signal"
                return False
            t0, peak, cfo_frac = self._detect(self._elem[search0:n_acq])
            t0 += search0
            if peak < 0.3:
                self.stats.state = "no_signal"
                return False
            res = p1_detect.decode_signalling(
                self._elem[t0:t0 + p1_mod.P1_LEN], cfo_frac)
            if res is None:
                self.stats.state = "p1_decode_failed"
                return False
            s1, s2, cfo_total = res
            if s1 in (0, 1, 3, 4):      # T2 / T2-Lite, SISO / MISO
                break
            search0 = t0 + p1_mod.P1_LEN    # non-T2 P1: a FEF part; skip
        else:
            self.stats.state = "p1_decode_failed"
            return False

        # retune the NCO (raw domain) and reprocess from the raw ring:
        # the buffered elementary samples were produced without the CFO
        # correction, so correct them in place (equivalent rotation).
        n = np.arange(len(self._elem))
        self._elem = (self._elem * np.exp(-1j * cfo_total * n)
                      ).astype(np.complex64)
        # rad/elem-sample -> rad/raw-sample (grid step is x4 the raw step)
        self.freq += cfo_total * 4.0 / (self.step * UPSAMPLE)
        # start the NCO where the elementary-domain rotation left off (plus
        # the front-end group delay) so the symbol straddling the buffer
        # boundary sees a continuous phase ramp; any residual constant
        # offset is absorbed by the pilot equalizer
        delay_elem = (3 * (len(self.hb_taps) - 1) / 2 / (2 * self.step)
                      + (len(self.taps) - 1) / 4)
        self.phase = float((self.phase
                            + cfo_total * (len(self._elem) + delay_elem))
                           % (2 * np.pi))
        self.stats.cfo_hz += cfo_total * SAMPLE_RATE / (2 * np.pi)

        acq = acquisition.acquire_mode(
            self._elem[t0 + p1_mod.P1_LEN:], s1, s2 // 2, self.device)
        if acq is None:
            self.stats.state = "l1_failed"
            return False
        self.mode = acq.mode
        self._l1_pre = acq.l1_pre
        self._l1_post = acq.l1_post
        plp_indices = (range(acq.l1_post.num_plp)
                       if self.cfg.plp_index is None
                       else [self.cfg.plp_index])
        self.rxs = [self._new_rx(receiver_mod.config_from_l1(
            acq.mode, acq.l1_pre, acq.l1_post, i, sfn=acq.sfn),
            acq.l1_pre.l1_post_size) for i in plp_indices]
        self.rx = self.rxs[0]
        self._sro_coeff = eq_mod.sro_coefficient(self.mode)
        self.frame_pos = max(0, t0 + acq.timing_off)
        # FEF geometry (mixed streams): fef_length elementary samples are
        # inserted after every fef_interval-th T2 frame; the frame stepper
        # skips them by L1-dynamic FRAME_IDX arithmetic (clause 8.4)
        post = acq.l1_post
        fef_len = post.fef_length + (post.fef_length_msb << 22)
        self._fef = ((post.fef_interval, fef_len)
                     if acq.l1_pre.s2_field2 and post.fef_interval > 0
                     and fef_len > 0 else None)
        self._num_t2 = max(1, acq.l1_pre.num_t2_frames)
        self._frame_idx = post.dyn.frame_idx % self._num_t2
        self.stats.state = "locked"
        return True

    # ------------------------------------------------------------------
    def _hw_retune_if_coarse(self) -> bool:
        """Push a coarse CFO into the front-end tuner (reference
        rx_base.cpp:146-152 update_gain_frequency + settle :72-95).

        After acquisition the whole CFO is known digitally in
        ``self.freq``; when it exceeds one carrier spacing and the
        source can retune (RemoteSdrSource.set_center_freq), move the
        RF center by that amount, discard a settle period, and zero the
        NCO: the re-acquisition then runs with the tuner doing the
        coarse work and only the residual stays digital.  Returns True
        when a retune happened (caller must re-acquire)."""
        if not self.cfg.hw_retune or self.mode is None:
            return False
        set_freq = getattr(self.src, "set_center_freq", None)
        center = getattr(self.src, "center_freq_hz", None)
        if set_freq is None or center is None:
            return False
        dev_rate = self.src.info.sample_rate
        cfo_hz = self.freq * dev_rate / (2.0 * np.pi)
        spacing = SAMPLE_RATE / self.mode.fft_size
        if abs(cfo_hz) <= spacing:
            return False
        if set_freq(center + cfo_hz) is None:   # daemon predates FREQ
            return False
        # settle: drop everything buffered pre-retune plus the settle
        # period, then restart the NCO at zero
        self._raw = self._raw[:0]
        self._elem = np.empty(0, np.complex64)
        flush = getattr(self.src, "flush", None)
        if flush is not None:
            flush()                 # ingest ring holds pre-retune samples
        n_settle = int(self.cfg.retune_settle_s * dev_rate)
        while n_settle > 0:
            blk = self.src.read(min(n_settle, self.n_in))
            if blk is None:
                break
            n_settle -= len(blk) // self._w
        self.freq = 0.0
        self.rx = None
        self.spur = None            # a baseband spur moves under retune
        return True

    # ------------------------------------------------------------------
    def _refine_timing(self):
        """P1-anchored timing: re-detect the preamble near the expected
        frame start (replaces the reference's sample-clock PI loop edge).
        Repeated misses mark the lock as lost (reference analogue:
        signal_estimate.reset on post-init L1 CRC failure,
        dvbt2_demodulator.cpp:387-394)."""
        w0 = max(self.frame_pos - 64, 0)
        w1 = self.frame_pos + p1_mod.P1_LEN + 192
        if w1 > len(self._elem):
            return
        t0, peak, _ = self._detect(self._elem[w0:w1])
        if peak > 0.25:
            # snap only for small corrections: under an SFN echo the P1
            # metric is ambiguous between the transmitters, and a bare
            # snap would jump frame_pos by the echo delay batch-to-batch
            nudge = w0 + t0 - self.frame_pos
            if abs(nudge) <= 12:
                self.frame_pos = w0 + t0
            self._p1_misses = 0
        else:
            self._p1_misses = getattr(self, "_p1_misses", 0) + 1

    def _check_l1_dynamic(self, plane):
        """Per-batch L1-dynamic tracking (the reference re-reads dynamic L1
        every frame, dvbt2_demodulator.cpp:328-346): if PLP_NUM_BLOCKS or
        the start address changed, rebuild the frame receivers for the new
        configuration.  Reads the L1 cells straight off the equalized
        device plane (no host P2 re-demod) and falls back to the soft FEC
        path near threshold; a failure only bumps the l1_dyn_errors stat:
        actual lock loss shows up as dead batches and is handled there."""
        post = None
        try:
            got = acquisition.decode_l1_cells(self.rx.l1_cells(plane),
                                              self.device)
            if got is not None:
                post = got[1]
        except l1_lib.L1DecodeError:
            # malformed-but-CRC-valid signalling: an erasure, repairable
            # below.  Anything else (a parser bug, a device failure) must
            # raise: silently "repairing" a programming error every batch
            # would mask it forever.
            post = None
        if post is None:
            # Repair sources, preferred first: in-band type A (EN 302 755
            # clause 5.2.3.1: the previous batch's DATA path carried
            # next-frame schedules in the BB padding field, so as long as
            # data decodes the dynamic configuration survives P2 erasure
            # indefinitely), then L1 repetition (clause 7.2.3.1: the
            # previous batch's L1-post carried dyn_next, one frame of
            # time diversity on the dynamic signalling).
            post = self._repair_dyn_from_inband()
            if post is not None:
                self._l1_post_cache = post     # fresh dyn: next batch's
                #                                in-band chains from it
            nxt = getattr(self, "_l1_dyn_next", None)
            cache = getattr(self, "_l1_post_cache", None)
            if post is None and nxt is not None and cache is not None:
                post = copy.copy(cache)
                post.dyn = copy.copy(nxt)
                # dyn_next indexes the frame AFTER the previous batch's
                # first; this batch's first frame is F-1 further on
                post.dyn.frame_idx = (
                    (nxt.frame_idx + self.cfg.frames_per_batch - 1)
                    % max(1, getattr(self, "_num_t2", 1)))
                self._l1_dyn_next = None            # single-use
                self._l1_dyn_repaired = getattr(
                    self, "_l1_dyn_repaired", 0) + 1
            elif post is None:
                self._l1_dyn_errors = getattr(self, "_l1_dyn_errors", 0) + 1
                return
        else:
            self._l1_post_cache = post
            # _l1_pre is unset on a warm (checkpoint) restart: the resume
            # path relocks from P1 alone and never re-reads L1-pre
            rep = getattr(getattr(self, "_l1_pre", None),
                          "l1_repetition_flag", 0)
            self._l1_dyn_next = (post.dyn_next
                                 if rep and post.dyn_next.plp else None)
        # the broadcast FRAME_IDX of this batch's first frame anchors the
        # FEF-gap arithmetic (drift would misplace the skip and kill the
        # following batch); step_batch folds it into the next prediction
        self._frame_idx0_l1 = post.dyn.frame_idx
        for j, rx in enumerate(self.rxs):
            idx = j if self.cfg.plp_index is None else self.cfg.plp_index
            dyn = post.dyn.plp[idx]
            cfg = rx.cfg
            if (dyn.num_blocks != cfg.n_fec_per_frame
                    or dyn.start != cfg.plp_start):
                new_rx = self._new_rx(receiver_mod.config_from_l1(
                    self.mode, self._l1_pre, post, idx, sfn=cfg.sfn),
                    self._l1_pre.l1_post_size)
                self.rxs[j] = new_rx
                if j == 0:
                    self.rx = new_rx

    def _repair_dyn_from_inband(self):
        """Rebuild this batch's L1-post from the last harvested in-band
        type A block (single-use; _harvest_inband re-arms it every batch
        the data path decodes).  Returns None when no block is armed."""
        blk = getattr(self, "_inband_next", None)
        cache = getattr(self, "_l1_post_cache", None)
        if blk is None or cache is None:
            return None
        post = copy.copy(cache)
        post.dyn = copy.deepcopy(cache.dyn)
        sb = blk.starts_blocks(self.rx.plp.plp_id)
        for dp in post.dyn.plp:
            if dp.id in sb:
                dp.start, dp.num_blocks = sb[dp.id]
        post.dyn.sub_slice_interval = blk.sub_slice_interval
        post.dyn.start_rf_idx = blk.start_rf_idx
        # the in-band block rode the previous batch's LAST interleaving
        # frame and describes the one after it == this batch's first;
        # FRAME_IDX itself is not signalled in-band: _frame_idx tracks it
        post.dyn.frame_idx = (getattr(self, "_frame_idx", 0)
                              % max(1, getattr(self, "_num_t2", 1)))
        self._inband_next = None                # single-use until re-armed
        self._inband_repaired = getattr(self, "_inband_repaired", 0) + 1
        return post

    def _harvest_inband(self, result):
        """Keep the newest in-band type A block (EN 302 755 clause
        5.2.3.1) from this batch's padding fields: the LAST interleaving
        frame's block describes the next batch's first frame, which is
        exactly what _check_l1_dynamic needs if the next P2 read fades."""
        post = getattr(self, "_l1_post_cache", None)
        if post is None or not result.padding:
            return
        idx = 0 if self.cfg.plp_index is None else self.cfg.plp_index
        if not post.plp[idx].in_band_a_flag:
            return
        from ..io import inband
        for _, pad in reversed(result.padding):
            blk = inband.parse_inband_a(pad)
            if blk is not None:
                self._inband_next = blk
                self.stats.inband_a_blocks += 1
                return

    def _frame_starts(self, f: int):
        """Start positions of the next f T2 frames in the elementary stream
        plus (end position, frame_idx after the batch): consecutive frames
        with fef_length-sample skips after every fef_interval-th frame
        (FRAME_IDX arithmetic per EN 302 755 clause 8.4)."""
        fs = self.mode.frame_samples
        fef = getattr(self, "_fef", None)
        n_t2 = getattr(self, "_num_t2", 1)
        starts, pos, idx = [], self.frame_pos, getattr(self, "_frame_idx", 0)
        for _ in range(f):
            starts.append(pos)
            pos += fs
            if fef is not None and (idx + 1) % fef[0] == 0:
                pos += fef[1]
            idx = (idx + 1) % n_t2
        return starts, pos, idx

    def step_batch(self) -> bool:
        """Receive one batch of frames; returns False when out of samples."""
        fs = self.mode.frame_samples
        f = self.cfg.frames_per_batch
        starts, _, _ = self._frame_starts(f)
        if not self._need_elem(starts[-1] + fs + 256):
            return False
        self._refine_timing()            # may nudge frame_pos
        starts, pos_next, idx_next = self._frame_starts(f)
        if starts[-1] + fs > len(self._elem):
            if not self._need_elem(starts[-1] + fs):
                return False
        if getattr(self, "_fef", None) is None:
            frames = self._elem[self.frame_pos:self.frame_pos + f * fs]
            frames = frames.reshape(f, fs)
        else:                            # gather around the FEF gaps
            frames = np.stack([self._elem[s:s + fs] for s in starts])
        # demod+equalize ONCE; every PLP demaps from the same plane (the
        # plane is most of the chain and is PLP-independent)
        plane, diag = self.rx.compute_plane(frames)
        # the plane is mode-only, so it stays valid even if the L1-dynamic
        # check rebuilds the per-PLP receivers below
        self._check_l1_dynamic(plane)
        result = self.rx.receive_plane(plane, diag)
        self._harvest_inband(result)
        if self.sink is None and self.sink_factory is not None:
            self.sink = self.sink_factory(0, self.rx.plp.plp_id)
        if self.sink is not None:
            self.sink.write(result.ts_bytes)
        # additional PLPs (plp_index=None): route to lazily-created per-PLP
        # sinks: every PLP in L1 gets one (reference: main_window.cpp's
        # per-PLP output table routes each PLP to UDP or file)
        for extra_i, rx in enumerate(self.rxs[1:], start=1):
            res_i = rx.receive_plane(plane, diag)
            sink_i = self.plp_sinks.get(extra_i)
            if sink_i is None and self.sink_factory is not None:
                sink_i = self.sink_factory(extra_i, rx.plp.plp_id)
                self.plp_sinks[extra_i] = sink_i
            if sink_i is not None:
                sink_i.write(res_i.ts_bytes)
            self.stats.ldpc_failures += int(np.sum(~res_i.ldpc_ok))
            self.stats.bch_dirty += int(np.sum(~res_i.bch_clean))
            self.stats.ts_packets += len(res_i.ts_bytes) // 188

        # ---- tracking: apply batch-N estimates to batch N+1 ----------
        cfo_res = float(np.mean(result.diag["gi_cfo"]))   # rad/elem sample
        self.freq += (self.cfg.cfo_gain * cfo_res * 4.0
                      / (self.step * UPSAMPLE))
        self.stats.cfo_hz += (self.cfg.cfo_gain * cfo_res
                              * SAMPLE_RATE / (2 * np.pi))
        # the discriminator measures the receiver's residual timing slip
        # (= minus the uncompensated clock offset); normalize by the
        # mode-specific coefficient and trim the resample step against it
        slip = float(np.mean(result.diag["sro"])) / self._sro_coeff
        trim = np.clip(-self.cfg.sro_gain * slip, -2e-5, 2e-5)
        self.step *= (1.0 + trim)
        # first-path timing (SFN plans): the diag carries each frame's
        # delay profile; steer frame_pos so the FIRST path (the earliest
        # delay within -11 dB of the peak) sits near delay 0, keeping every
        # echo inside [0, GI] and inside the Wiener prior.  The P1 snap is
        # clamped to +-12 samples, so larger moves come from here only
        cir_nudge = 0
        cir_p = result.diag.get("cir_p")
        if cir_p is not None:
            prof = np.mean(np.asarray(cir_p), axis=0)
            d = self.rx.plan.eq.cir_d
            first = int(d[int(np.argmax(prof >= 0.08 * float(prof.max())))])
            if abs(first) > 6:
                cir_nudge = int(np.clip(first // 2, -24, 24))
        self.stats.cir_nudge = cir_nudge
        self.stats.sro_ppm = (self.step * UPSAMPLE * SAMPLE_RATE
                              / (4.0 * self.src.info.sample_rate) - 1.0) * 1e6

        # ---- bookkeeping / stats -------------------------------------
        self.frame_pos = pos_next + cir_nudge
        fi0 = getattr(self, "_frame_idx0_l1", None)
        if fi0 is not None:              # L1-dynamic resync (see above)
            idx_next = (fi0 + f) % getattr(self, "_num_t2", 1)
            self._frame_idx0_l1 = None
        self._frame_idx = idx_next
        drop = self.frame_pos - 4096
        if drop > 0:
            self._elem = self._elem[drop:]
            self.frame_pos -= drop
        st = self.stats
        self.ldpc_stats.update(result.ldpc_iters, result.ldpc_ok)
        report = self.ldpc_stats.maybe_report()
        if report:
            print(report, file=sys.stderr)
        if not np.any(result.ldpc_ok) and not np.any(result.bch_clean):
            self._dead_batches = getattr(self, "_dead_batches", 0) + 1
        else:
            self._dead_batches = 0
        st.frames += f
        st.ts_packets += len(result.ts_bytes) // 188
        st.ldpc_failures += int(np.sum(~result.ldpc_ok))
        st.bch_dirty += int(np.sum(~result.bch_clean))
        st.bch_corrected += int(np.sum(result.bch_corrected))
        st.snr_db = result.snr_db
        return True

    # ------------------------------------------------------------------
    def _lock_lost(self) -> bool:
        """Three consecutive P1 misses, or three batches in which nothing
        decodes (e.g. the mux reconfigured under us), force a relock."""
        return (getattr(self, "_p1_misses", 0) >= 3
                or getattr(self, "_dead_batches", 0) >= 3)

    def run(self, max_frames: int | None = None) -> RunStats:
        if self.rx is None and not self.acquire():
            return self.stats
        if self._hw_retune_if_coarse() and not self.acquire():
            return self.stats
        while max_frames is None or self.stats.frames < max_frames:
            if self._lock_lost():
                # drop the stale buffer tail and re-acquire from the stream
                # (the reference resets the whole front end; here only the
                # framing/L1 state is rebuilt)
                self.stats.state = "reacquiring"
                self._elem = self._elem[self.frame_pos:]
                self._p1_misses = 0
                self._dead_batches = 0
                self.rx = None
                self.spur = None        # re-run spur detection on relock
                if not self.acquire():
                    break
                if self._hw_retune_if_coarse() and not self.acquire():
                    break
            if not self.step_batch():
                break
        if self.sink is not None:
            self.sink.close()
        for s in self.plp_sinks.values():
            if s is not None:
                s.close()
        return self.stats


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def save_state(rx: StreamingReceiver) -> dict:
    """Serializable warm-start state: tuning loops + decoded configuration.

    The reference has no resume story; here a restarted receiver skips the
    blind GI/L1 scan and re-locks from a P1 search alone, keeping its
    calibrated CFO/SRO/conditioner state.
    """
    if rx.rx is None:
        raise RuntimeError("nothing to save before lock")
    m = rx.mode
    plps = []
    for r in rx.rxs:
        c = r.cfg
        plps.append(dict(
            constellation=int(c.plp.constellation), rotation=c.plp.rotation,
            code_rate=int(c.plp.code_rate), fec_frame=int(c.plp.fec_frame),
            num_blocks_max=c.plp.num_blocks_max,
            time_il_length=c.plp.time_il_length,
            time_il_type=c.plp.time_il_type, plp_id=c.plp.plp_id,
            n_fec=c.n_fec_per_frame, n_ti=c.n_ti, plp_start=c.plp_start,
            sfn=c.sfn))
    return dict(
        mode=dict(fft_mode=int(m.fft_mode), guard=int(m.guard),
                  pilot_pattern=int(m.pilot_pattern),
                  extended=m.extended_carriers, papr=int(m.papr),
                  miso=m.miso, lite=m.lite,
                  n_data_symbols=m.n_data_symbols),
        plps=plps,
        l1_post_cells=rx.rxs[0]._l1_post_cells,
        freq=rx.freq, step=rx.step,
        cond=dataclasses.asdict(rx.cond),
        fef=getattr(rx, "_fef", None),
        num_t2=getattr(rx, "_num_t2", 1),
    )


def load_state(rx: StreamingReceiver, state: dict) -> bool:
    """Warm start from :func:`save_state`; returns True once re-locked."""
    from ..params.modes import (T2Mode, PlpConfig, FftMode, GuardInterval,
                                PilotPattern, Papr, Constellation, CodeRate,
                                FecFrame)
    md = state["mode"]
    rx.mode = T2Mode(fft_mode=FftMode(md["fft_mode"]),
                     guard=GuardInterval(md["guard"]),
                     pilot_pattern=PilotPattern(md["pilot_pattern"]),
                     extended_carriers=md["extended"], papr=Papr(md["papr"]),
                     miso=md.get("miso", False), lite=md.get("lite", False),
                     n_data_symbols=md["n_data_symbols"])
    rx.freq = state["freq"]
    rx.step = state["step"]
    rx.cond = fe.IqCondState(**state["cond"])
    rx.rxs = []
    for p in state["plps"]:
        plp = PlpConfig(plp_id=p["plp_id"],
                        constellation=Constellation(p["constellation"]),
                        rotation=p["rotation"],
                        code_rate=CodeRate(p["code_rate"]),
                        fec_frame=FecFrame(p["fec_frame"]),
                        num_blocks_max=p["num_blocks_max"],
                        time_il_length=p["time_il_length"],
                        time_il_type=p["time_il_type"])
        cfg = receiver_mod.RxConfig(
            mode=rx.mode, plp=plp, n_fec_per_frame=p["n_fec"],
            n_ti=p["n_ti"], plp_start=p["plp_start"],
            sfn=p.get("sfn", False))
        rx.rxs.append(rx._new_rx(cfg, state["l1_post_cells"]))
    rx.rx = rx.rxs[0]
    rx._sro_coeff = eq_mod.sro_coefficient(rx.mode)

    fef = state.get("fef")
    rx._fef = tuple(fef) if fef else None
    rx._num_t2 = state.get("num_t2", 1)
    # the resumed stream position within the superframe is unknown; the
    # first batch's L1-dynamic decode resyncs FRAME_IDX (a mispredicted
    # FEF gap in the very first multi-frame batch relocks like any
    # dead batch)
    rx._frame_idx = 0

    # re-anchor frame timing with a P1 search (fast; no GI/L1 scan);
    # mixed streams: skip FEF P1s (non-T2 S1) like acquire() does
    need = rx.mode.frame_samples + 3 * p1_mod.P1_LEN
    if rx._fef is not None:
        need += rx._fef[1] + p1_mod.P1_LEN
    if not rx._need_elem(need):
        return False
    search0 = 0
    for _ in range(4):
        t0, peak, cfo_frac = rx._detect(rx._elem[search0:need])
        t0 += search0
        if peak < 0.3:
            rx.stats.state = "no_signal"
            return False
        if rx._fef is None:
            break
        res = p1_detect.decode_signalling(
            rx._elem[t0:t0 + p1_mod.P1_LEN], cfo_frac)
        if res is not None and res[0] in (0,):
            break
        search0 = t0 + p1_mod.P1_LEN
    else:
        rx.stats.state = "p1_decode_failed"
        return False
    rx.frame_pos = t0
    rx.stats.state = "locked"
    return True
