"""Blind acquisition onto the device grid: cold-start a pod from raw IQ.

The sharded/pod path (parallel.sharding / parallel.pod) runs steady-state
frame-aligned steps; this module derives that alignment BLIND — P1 search,
CFO, GI/L1 scan — like the single-channel cold start
(runtime/acquisition.py; reference analogue: P1-triggered init at
/root/reference/src/DVB_T2/dvbt2_demodulator.cpp:210-237), then converts
the lock into `pod.MultiChannelReceiver.stream()` inputs:

* `ShardedConfig` (mode + PLP + FEC geometry from the decoded L1),
* per-channel `pos0` (whole raw samples to drop from each channel's
  stream) and `mu0` (fractional frame alignment inside stream()'s
  warm-up band),
* per-channel NCO `freq` (rad/raw-sample, from the P1 CFO estimate).

The front end of the acquisition head is the sharded step's own
(`sharding.front_end`, one row, on the device) with the same base
arithmetic as host_bases with t = 0, so an elementary-domain P1 position
maps exactly onto the step's resampler grid: elementary sample e sits at
raw position ``mu + 2 * step * e``.  The P1 search runs on the device;
the GI/L1 scan on the host (its soft L1 fallback on the device).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..models.receiver import config_from_l1
from ..ops import frontend as fe, p1_detect
from ..params import l1 as l1_mod
from ..params import p1 as p1_mod
from ..params.modes import SAMPLE_RATE
from ..runtime import acquisition
from . import sharding

# stream()'s warm-up band (pod.MultiChannelReceiver._MU_LO)
_MU_LO = 32.0


def _frontend_elem_t(raw, mu: float, step: float, freq: float, n_elem: int,
                     fir_preset: str, device) -> torch.Tensor:
    """frontend_elem, leaving the elementary samples on ``device``."""
    device = resolve_device(device)
    taps = fe.fir_taps(fir_preset)
    hb_taps = np.asarray(fe.halfband_taps(), np.float32)
    n_taps = len(taps)
    hb_delay_grid = 3 * (len(hb_taps) - 1) // 2
    # base math = sharding.ShardedReceiver.host_bases with t=0, halo=0
    p = mu + step * (-(n_taps - 1))
    g = 4.0 * p + hb_delay_grid
    if g < 1.0:
        raise ValueError(f"mu={mu} too small for the FIR warm-up; feed "
                         "later raw")
    need = 2 * n_elem + n_taps - 1
    n_up = -(-need // 1024) * 1024
    s_hi, s_lo = fe.split_step(4.0 * step)
    x = torch.from_numpy(np.ascontiguousarray(raw, np.complex64))[None]
    one = lambda v, dt=torch.float32: torch.tensor(  # noqa: E731
        [v], dtype=dt, device=device)
    elem = sharding.front_end(
        x.to(device), one(int(np.floor(g)), torch.int32),
        one(np.float32(g - np.floor(g))), one(0.0), one(np.float32(freq)),
        one(s_hi), one(s_lo), torch.from_numpy(taps).to(device),
        torch.from_numpy(hb_taps).to(device), n_up, n_elem)
    return elem[0]


def frontend_elem(raw: np.ndarray, mu: float, step: float, freq: float,
                  n_elem: int, fir_preset: str = "medium",
                  device=None) -> np.ndarray:
    """Raw complex64 -> ``n_elem`` elementary-rate samples, with the grid
    front end's exact convention: elementary e sits at raw position
    ``mu + 2 * step * e`` (NCO at ``freq`` rad/raw-sample from raw[0]).

    One-shot (zero history) use of the sharded front end, one row on
    ``device`` (cuda unless "cpu" is passed)."""
    return _frontend_elem_t(raw, mu, step, freq, n_elem, fir_preset,
                            device).cpu().numpy()


@dataclasses.dataclass
class MeshLock:
    """Blind-acquisition result, ready for pod.MultiChannelReceiver."""
    cfg: sharding.ShardedConfig
    l1_pre: "l1_mod.L1Pre"
    l1_post: "l1_mod.L1Post"
    pos0: np.ndarray          # [C] int64: raw samples to drop per channel
    mu0: np.ndarray           # [C] float64: alignment in the warm-up band
    freq: np.ndarray          # [C] float64: NCO rad/raw-sample
    step: float               # raw-domain resample step (shared nominal)
    # per-channel lock state (partial acquisition): False = no P1 lock /
    # no L1 decode / locked to a DIFFERENT mux (mismatched names those) —
    # masked channels stream dark and are re-acquired by
    # pod.stream(relock=True)
    locked: np.ndarray = None            # [C] bool
    mismatched: list = dataclasses.field(default_factory=list)
    frame_idx0: np.ndarray = None        # [C] int64: FRAME_IDX at pos0

    def __post_init__(self):
        c = len(self.pos0)
        if self.locked is None:
            self.locked = np.ones(c, bool)
        if self.frame_idx0 is None:
            self.frame_idx0 = np.zeros(c, np.int64)

    def aligned(self, raw: np.ndarray) -> np.ndarray:
        """[C, N] capture -> per-channel streams starting at pos0."""
        n = int(min(raw.shape[1] - p for p in self.pos0))
        return np.stack([raw[c, self.pos0[c]:self.pos0[c] + n]
                         for c in range(raw.shape[0])])


def _acquire_one(raw_row: np.ndarray, step: float, head_elem: int,
                 fir_preset: str, device=None):
    """One channel: (r0_raw, freq_raw, AcquisitionResult) or None."""
    mu_acq = _MU_LO + 0.5
    n_avail = int((len(raw_row) - mu_acq) / (2.0 * step)) - 8
    n_elem = min(head_elem, n_avail)
    if n_elem < 4 * p1_mod.P1_LEN:
        return None
    elem_t = _frontend_elem_t(raw_row, mu_acq, step, 0.0, n_elem,
                              fir_preset, device)
    elem = elem_t.cpu().numpy()
    # mixed T2+FEF streams interleave FEF parts opening with their OWN P1
    # carrying a non-T2 S1 — skip past those and keep searching (clause
    # 8.4; the same loop as the single-channel acquire, runtime/stream.py)
    search0 = 0
    for _ in range(6):
        if n_elem - search0 < 4 * p1_mod.P1_LEN:
            return None
        t0, peak, cfo_frac = (float(v) for v in
                              p1_detect.detect(elem_t[search0:]))
        t0 = int(t0) + search0
        if peak < 0.3:
            return None
        res = p1_detect.decode_signalling(elem[t0:t0 + p1_mod.P1_LEN],
                                          cfo_frac)
        if res is None:
            return None
        s1, s2, cfo_total = res
        if s1 in (0, 1, 3, 4):          # T2 / T2-Lite, SISO / MISO
            break
        search0 = t0 + p1_mod.P1_LEN    # non-T2 P1: a FEF part; skip
    else:
        return None
    # CFO-correct the head (host rotation == retuning the NCO) and decode
    # the L1 from the first frame (GI/EXT scan, hard + soft paths)
    n = np.arange(len(elem))
    elem = (elem * np.exp(-1j * cfo_total * n)).astype(np.complex64)
    acq = acquisition.acquire_mode(elem[t0 + p1_mod.P1_LEN:], s1, s2 // 2,
                                   device=elem_t.device)
    if acq is None:
        return None
    # raw position of frame start (+ first-path re-anchor, SFN channels)
    r0 = mu_acq + 2.0 * step * (t0 + acq.timing_off)
    freq_raw = cfo_total / (2.0 * step)     # rad/elem -> rad/raw
    return r0, freq_raw, acq


def _l1_signature(acq) -> tuple:
    """The configuration fields every channel of one mux must agree on.
    A channel locked to a DIFFERENT mux (adjacent-channel leak) passes its
    own CRCs, so only a cross-channel equality check catches it."""
    pre, post = acq.l1_pre, acq.l1_post
    return (acq.mode.fft_mode, pre.guard_interval, pre.pilot_pattern,
            pre.bwt_ext, pre.cell_id, pre.network_id, pre.t2_system_id,
            post.num_plp,
            tuple((p.id, p.plp_cod, p.plp_mod, p.plp_fec_type)
                  for p in post.plp))


def blind_acquire(raw: np.ndarray, device_rate: float,
                  frames_per_shard: int = 1, fir_preset: str = "medium",
                  plp_index: int = 0, head_elem: int = 3_500_000,
                  ldpc_max_iters: int = 15, all_plps: bool = False,
                  allow_partial: bool = False,
                  device=None) -> MeshLock | None:
    """[C, N] raw capture -> MeshLock, fully blind (no impairment oracle).

    Each channel is acquired independently (channels have independent
    timing and LO error), its front end and P1 search on ``device`` (cuda
    unless "cpu" is passed); all channels must carry the same T2
    configuration (the broadcast-network case MultiChannelReceiver
    serves) — channels whose decoded L1 DISAGREES with the pod consensus
    (a receiver parked on the wrong mux) are flagged in
    ``lock.mismatched`` rather than silently decoding garbage.

    allow_partial=False (default): returns None if any channel fails to
    lock or mismatches.  allow_partial=True: returns a MeshLock whenever
    at least one channel locks; failed/mismatched channels are masked out
    in ``lock.locked`` and can come alive later via
    pod.stream(relock=True).  all_plps=True: configure every PLP in L1
    (multi-PLP decode from the shared plane).
    """
    device = resolve_device(device)
    raw = np.atleast_2d(raw)
    C = raw.shape[0]
    step = device_rate / (2.0 * SAMPLE_RATE)
    locks = []
    for c in range(C):
        got = _acquire_one(raw[c], step, head_elem, fir_preset, device)
        if got is None and not allow_partial:
            return None
        locks.append(got)
    locked = np.array([g is not None for g in locks], bool)
    if not locked.any():
        return None

    # cross-channel configuration trust: majority signature wins; a
    # channel locked to a different mux is masked, not averaged in
    sigs = [None if g is None else _l1_signature(g[2]) for g in locks]
    counts: dict = {}
    for s in sigs:
        if s is not None:
            counts[s] = counts.get(s, 0) + 1
    consensus = max(counts, key=counts.get)
    mismatched = [c for c in range(C)
                  if sigs[c] is not None and sigs[c] != consensus]
    if mismatched and not allow_partial:
        return None
    for c in mismatched:
        locked[c] = False

    ref = next(c for c in range(C) if locked[c])
    acq0 = locks[ref][2]
    r0s = np.array([locks[c][0] if locked[c] else _MU_LO + 0.5
                    for c in range(C)])
    freqs = np.array([locks[c][1] if locked[c] else 0.0
                      for c in range(C)])
    # frame alignment: fold whole raw samples into pos0, keep mu0 in the
    # warm-up band [_MU_LO, _MU_LO + 1)
    pos0 = np.floor(r0s - _MU_LO).astype(np.int64)
    mu0 = r0s - pos0
    frame_idx0 = np.array(
        [locks[c][2].l1_post.dyn.frame_idx if locked[c] else 0
         for c in range(C)], np.int64)

    # one chain plan serves every channel: escalate to the Wiener rows if
    # ANY channel's measured delay spread demands them
    sfn = any(acq.sfn for _, _, acq in
              (locks[c] for c in range(C) if locked[c]))
    pre, post = acq0.l1_pre, acq0.l1_post
    rx_cfg = config_from_l1(acq0.mode, pre, post, plp_index, sfn=sfn)
    extra = ()
    if all_plps:
        extra = tuple(
            sharding.PlpState(
                config_from_l1(acq0.mode, pre, post, i, sfn=sfn).plp,
                post.dyn.plp[i].num_blocks,
                max(1, post.plp[i].time_il_length
                    if post.plp[i].time_il_type == 0 else 1),
                post.dyn.plp[i].start)
            for i in range(post.num_plp) if i != plp_index)
    # FEF geometry (mixed streams, EN 302 755 clause 8.4)
    fef_len = post.fef_length + (post.fef_length_msb << 22)
    fef = ((post.fef_interval, fef_len)
           if pre.s2_field2 and post.fef_interval > 0 and fef_len > 0
           else None)
    cfg = sharding.ShardedConfig(
        mode=rx_cfg.mode, plp=rx_cfg.plp,
        n_fec_per_frame=rx_cfg.n_fec_per_frame, n_ti=rx_cfg.n_ti,
        l1_post_cells=pre.l1_post_size, plp_start=rx_cfg.plp_start,
        frames_per_shard=frames_per_shard, fir_preset=fir_preset,
        ldpc_max_iters=ldpc_max_iters, sfn=rx_cfg.sfn,
        extra_plps=extra, fef=fef, num_t2=max(1, pre.num_t2_frames))
    return MeshLock(cfg=cfg, l1_pre=pre, l1_post=post,
                    pos0=pos0, mu0=mu0, freq=freqs, step=step,
                    locked=locked, mismatched=mismatched,
                    frame_idx0=frame_idx0)
