"""The receive pipeline over a (channel x time-block) grid of devices.

The TPU package maps the stream onto a 2-D device mesh with ``shard_map``
and collectives.  On GPUs the mesh is a small grid of ``torch.device``s,
``[n_ch, n_time]``, in which a device may appear more than once:

* **"ch" — RF-channel sharding**: independent 8 MHz channels are
  embarrassingly parallel (the pod-scale configuration in BASELINE.md);
  channel c of C sits on mesh row ``c // (C / n_ch)``.
* **"time" — time-block sharding**: the continuous IQ stream of one
  channel splits into consecutive blocks.  The Farrow resampler and the
  FIR decimator need history across block boundaries: the contiguous path
  puts the tail of block t-1 in front of block t (a halo; zeros before
  block 0), the window path takes windows that carry their own left
  context.

All (channel, time-block) shards that sit on one device run as ONE
batched call, with the shards as the leading dimension: one front end,
one demod + equalize, one demap and one LDPC kernel launch a PLP and
step.  Per-channel statistics (the tracking discriminators, the SNR) are
means over a channel's time shards; the L1 signalling cells come from
time shard 0.

The receive step is two stages, as in the frame receiver
(models/receiver.py):

* **plane stage** — front end + OFDM demod + pilot equalization; PLP- and
  L1-dynamic-independent.  It also reads the first frame's L1 signalling
  cells per channel, so that the host can track dynamic L1 every step
  without demodulating again.
* **fec stage** — per PLP: demap + the LDPC kernel with its BCH screen +
  bit packing on the device, then on the host the BCH correction of the
  rare codewords the screen flags.

Alignment contract (host-managed, float64): the contiguous path feeds
``n_time * raw_block`` raw samples per step with the resampler position
carried in the warm-up band (``host_bases``); the window path
(``plane_step_windows``) takes one raw window per (channel, time-shard) at
host-chosen positions (``host_bases_windows``) — which is what lets the
pod hop FEF gaps, steer first-path timing and re-seed a relocked channel
without changing any device shape (parallel/pod.py).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..models.receiver import correct_bb_frames, host_copies
from ..ops import bch_ops, rx_chain
from ..ops import frontend as fe
from ..ops.ldpc import LayeredDecoder
from ..params import l1 as l1_mod
from ..params.modes import T2Mode, PlpConfig
from .distributed import Mesh, visible_devices


def make_mesh(n_ch: int, n_time: int, devices=None) -> Mesh:
    """2-D (channel x time-block) device grid in this process.  ``devices``
    defaults to every visible CUDA device (raises without one); a device
    may be listed more than once, e.g. ``["cpu"] * 4`` or four times one
    card.  A grid over several processes: ``distributed.rank_mesh``."""
    devices = visible_devices(devices)
    need = n_ch * n_time
    if len(devices) < need:
        raise ValueError(f"{need} devices needed, {len(devices)} available")
    return Mesh(tuple(tuple(devices[c * n_time:(c + 1) * n_time])
                      for c in range(n_ch)))


def default_mesh(n_devices: int | None = None) -> Mesh:
    """Factor the visible CUDA devices (or ``n_devices`` of them) into
    (ch, time)."""
    n = (n_devices if n_devices is not None
         else torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if n < 1:
        raise RuntimeError("no CUDA device")
    n_ch = 2 if n % 2 == 0 and n > 1 else 1
    return make_mesh(n_ch, n // n_ch)


@dataclasses.dataclass(frozen=True)
class PlpState:
    """One decodable PLP sharing the equalized plane (multi-PLP)."""
    plp: PlpConfig
    n_fec_per_frame: int
    n_ti: int = 1
    plp_start: int = 0


@dataclasses.dataclass
class ShardedConfig:
    mode: T2Mode
    plp: PlpConfig
    n_fec_per_frame: int
    n_ti: int = 1
    l1_post_cells: int = 0           # from decoded L1-pre (pre.l1_post_size)
    plp_start: int = 0               # L1-dynamic start cell of the PLP
    frames_per_shard: int = 1
    fir_preset: str = "medium"
    halo: int = 1024                 # raw-sample left halo per time shard
    ldpc_max_iters: int = 15
    sfn: bool = False                # force Wiener rows (long measured
    #                                  echoes) on reach-ungated modes
    # additional PLPs decoded from the same plane (tuple of PlpState);
    # the primary PLP above is index 0
    extra_plps: tuple = ()
    # FEF geometry from L1 (mixed T2+FEF streams, EN 302 755 clause 8.4):
    # (fef_interval, fef_length in elementary samples), or None.  The
    # window streaming path (parallel/pod.py) hops the gaps by FRAME_IDX
    # arithmetic; requires frames_per_shard == 1.
    fef: tuple | None = None
    num_t2: int = 1                  # T2 frames per superframe (FRAME_IDX
    #                                  modulus for the FEF arithmetic)


# raw samples of left context per host-sliced window: covers the FIR
# warm-up look-back plus the half-band transient, the same margin the
# acquisition front end uses (parallel/acquire.frontend_elem)
WINDOW_LEAD = 32


def front_end(x: torch.Tensor, idx0, frac0, phase0, freq, s_hi, s_lo,
              taps: torch.Tensor, hb: torch.Tensor, n_up: int,
              k_out: int) -> torch.Tensor:
    """Raw rows [R, n_raw] complex64 -> elementary rows [R, k_out].

    Every row has its own NCO start phase and frequency (``phase0``,
    ``freq``), resampler base (``idx0`` + ``frac0`` on the x4 grid) and step
    (``s_hi`` + ``s_lo``), each [R] on x's device; the half-band and FIR
    histories start at zero."""
    x = fe.nco_derotate(x, phase0, freq)[0]
    hbz = torch.zeros(x.shape[0], hb.shape[0] - 1, dtype=x.dtype,
                      device=x.device)
    x = fe.upsample2(x, hbz, hb)[0]
    x = fe.upsample2(x, hbz, hb)[0]
    # float32 like the TPU front end, so both see the same positions
    mu0 = frac0 + idx0.to(torch.float32)
    up = fe.farrow_resample(x, mu0, s_hi, s_lo, n_up)
    n_taps = taps.shape[0]
    up = up[:, :2 * k_out + n_taps - 1]
    return fe.fir_decimate2(up[:, n_taps - 1:], up[:, :n_taps - 1], taps)[0]


@dataclasses.dataclass
class PlaneShards:
    """The plane stage's output for the shards on one device."""
    device: torch.device
    cells: np.ndarray        # flat shard indices c * n_time + t, in order
    eq: torch.Tensor         # [len(cells) * F, L, K] equalized planes
    csi: torch.Tensor | None  # like eq, SFN plans only
    stats: dict              # per shard: gi_cfo, sro [n]; cir_p [n, nd]
    sig: torch.Tensor        # [n0, n_sig] L1 cells of the t = 0 shards


class ShardedReceiver:
    """The full receive step over a (ch, time) device grid.

    Combined entry (the contiguous path):

      step(raw, idx0, frac0, phase0, freq, step_raw) where
        raw    [C, n_time * raw_block] complex64
        idx0   [C, n_time] int32 — per-(ch, time-shard) resampler integer
                                  base (local to the shard's raw block,
                                  incl. halo)
        frac0  [C, n_time] float32 — fractional position per (ch, shard)
        phase0 [C, n_time] float32 — NCO start phase per (ch, shard)
        freq   [C] float32      — per-CHANNEL NCO frequency (rad/raw-sample)
        step_raw [C] float64    — per-CHANNEL resampler step (host doubles)
      returns (hard_bits [C, F_total, n_fec, n_bch], stats dict).

    Split entries (the steady-state pod path, parallel/pod.py):

      plane_step(...)          -> PlaneResult (planes stay on the devices)
      plane_step_windows(...)  -> PlaneResult from per-shard raw windows
      fec_step(plane, i)       -> per-PLP decoded bytes + per-channel stats

    C may be any multiple of the grid's "ch" extent.  The host computes
    idx0/frac0/phase0 in float64 from the global stream position
    (host_bases / host_bases_windows), so that device float32 never sees
    large absolute sample indices.
    """

    def __init__(self, cfg: ShardedConfig, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.mode = cfg.mode.validate()
        self.plp = cfg.plp
        self.n_time = mesh.shape["time"]
        self.n_ch = mesh.shape["ch"]
        self.plps: list[PlpState] = [
            PlpState(cfg.plp, cfg.n_fec_per_frame, cfg.n_ti, cfg.plp_start)
        ] + list(cfg.extra_plps)
        self.n_sig = l1_mod.L1_PRE_CELLS + cfg.l1_post_cells
        self.plans = [self._plan_for(s) for s in self.plps]
        self.taps = fe.fir_taps(cfg.fir_preset)
        self.n_taps = len(self.taps)
        self.hb_taps = np.asarray(fe.halfband_taps(), np.float32)
        # two half-band stages delay the x4 grid by (N-1)/2 each: stage 1's
        # 14 samples at x2 = 28 at x4, plus stage 2's 14 at x4
        self.hb_delay_grid = 3 * (len(self.hb_taps) - 1) // 2

        # per-shard geometry
        self.k_loc = cfg.frames_per_shard * self.mode.frame_samples
        # farrow outputs per shard: 2x elementary + FIR warm-up, padded to
        # the resampler's chunk granularity
        need = 2 * self.k_loc + self.n_taps - 1
        self.n_up = -(-need // 1024) * 1024
        self._consts: dict = {}      # (plp index, device) -> plan tables
        self._taps: dict = {}        # device -> (FIR taps, half-band taps)
        self._groups_by_c: dict = {}
        self._decoders: dict = {}    # (table, k_bch, t) -> LayeredDecoder
        # side streams for the device-to-host copies, one a card
        self._copy_streams: dict = {}

    def _plan_for(self, s: PlpState):
        return rx_chain.get_plan(
            self.mode, s.plp, s.n_fec_per_frame, s.n_ti,
            l1_mod.L1_PRE_CELLS + self.cfg.l1_post_cells + s.plp_start,
            sfn=self.cfg.sfn)

    # ------------------------------------------------------------------
    def replace_plp(self, i: int, state: PlpState):
        """L1-dynamic reconfiguration: PLP i's NUM_BLOCKS / START changed.
        The plane stage (mode-only) is untouched; only PLP i's plan is
        rebuilt (reference analogue: the per-frame dynamic L1 re-read,
        dvbt2_demodulator.cpp:328-346)."""
        self.plps[i] = state
        self.plans[i] = self._plan_for(state)
        self._consts = {k: v for k, v in self._consts.items() if k[0] != i}

    def _consts_on(self, i: int, device) -> dict:
        if (i, device) not in self._consts:
            self._consts[(i, device)] = self.plans[i].to_device(device)
        return self._consts[(i, device)]

    def _taps_on(self, device):
        if device not in self._taps:
            self._taps[device] = (torch.from_numpy(self.taps).to(device),
                                  torch.from_numpy(self.hb_taps).to(device))
        return self._taps[device]

    def _decoder(self, plp: PlpConfig) -> LayeredDecoder:
        """The LDPC kernel with its BCH screen for this PLP's code."""
        key = (plp.ldpc_table_name, plp.k_bch, plp.bch_t)
        if key not in self._decoders:
            self._decoders[key] = LayeredDecoder(
                plp.ldpc_table_name, max_iters=self.cfg.ldpc_max_iters,
                bch_h=bch_ops._h_matrix(plp.k_bch, plp.bch_m, plp.bch_t))
        return self._decoders[key]

    def _groups(self, n_ch: int) -> list:
        """[(device, flat shard indices c * n_time + t on it, in order)]
        for this rank's cells (all cells on a one-process grid)."""
        if n_ch % self.n_ch:
            raise ValueError(f"{n_ch} channels on a grid of {self.n_ch} "
                             "channel rows: need a multiple")
        if n_ch not in self._groups_by_c:
            per = n_ch // self.n_ch
            by_dev: dict = {}
            for c in range(n_ch):
                for t in range(self.n_time):
                    dev = self.mesh.devices[c // per][t]
                    if dev is not None:
                        by_dev.setdefault(dev, []).append(c * self.n_time + t)
            self._groups_by_c[n_ch] = [(d, np.asarray(v, np.int64))
                                       for d, v in by_dev.items()]
        return self._groups_by_c[n_ch]

    def _local(self, n_loc: int, nt_loc: int) -> tuple:
        """This rank's input [n_loc channels, nt_loc time blocks] ->
        (C, its channels' global indices, the local flat row of each
        global shard c * n_time + t: -1 where another rank holds it)."""
        rows, t0, t1 = self.mesh.block
        if n_loc % len(rows) or nt_loc != t1 - t0:
            raise ValueError(
                f"input of {n_loc} channels x {nt_loc} time blocks: this "
                f"rank holds grid rows {rows} x time blocks [{t0}, {t1})")
        n_ch = n_loc // len(rows) * self.n_ch
        chans = self.mesh.channels(n_ch)
        loc = np.full((n_ch, self.n_time), -1, np.int64)
        loc[np.ix_(chans, np.arange(t0, t1))] = np.arange(
            n_loc * nt_loc).reshape(n_loc, nt_loc)
        return n_ch, chans, loc.reshape(-1)

    # ------------------------------------------------------------------
    def raw_block_for(self, step: float) -> int:
        """Raw samples consumed per time shard per step (host helper).

        ``step`` is the raw-domain ratio device_rate / (2 * elementary);
        the Farrow itself runs on a x4 half-band-upsampled grid internally.
        """
        return int(np.ceil(2 * self.k_loc * step)) + 32

    def window_len(self, step: float) -> int:
        """Raw window per (channel, shard) for the window streaming path."""
        return WINDOW_LEAD + self.raw_block_for(step)

    # ------------------------------------------------------------------
    def _normalize_state(self, n_ch, freq, step_raw):
        freq = np.broadcast_to(np.asarray(freq, np.float32), (n_ch,))
        step_raw = np.broadcast_to(np.asarray(step_raw, np.float64),
                                   (n_ch,))
        s_hi = np.empty(n_ch, np.float32)
        s_lo = np.empty(n_ch, np.float32)
        for c in range(n_ch):
            s_hi[c], s_lo[c] = fe.split_step(4.0 * float(step_raw[c]))
        return freq, s_hi, s_lo

    def _plane(self, x, idx0, frac0, phase0, freq, step_raw):
        """x [C_r, n_time_r, n_raw], this rank's shards (numpy or a
        tensor; a pinned host tensor goes to the card without blocking);
        the bases [C, n_time] and freq, step_raw [C] cover the whole grid
        -> PlaneResult."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.complex64))
        nt = self.n_time
        n_ch, _, loc = self._local(x.shape[0], x.shape[1])
        freq, s_hi, s_lo = self._normalize_state(n_ch, freq, step_raw)
        bases = [np.broadcast_to(np.asarray(a, dt), (n_ch, nt)).reshape(-1)
                 for a, dt in ((idx0, np.int32), (frac0, np.float32),
                               (phase0, np.float32))]
        per_c = (freq, s_hi, s_lo)
        rows = x.reshape(x.shape[0] * x.shape[1], -1)
        mode, fs = self.mode, self.mode.frame_samples
        plan = self.plans[0]
        shards = []
        for dev, cells in self._groups(n_ch):
            whole = len(cells) == len(rows)
            xr = (rows if whole else rows[torch.from_numpy(loc[cells])]).to(
                dev, non_blocking=True)
            ch = cells // nt
            col = lambda a, idx: torch.from_numpy(      # noqa: E731
                np.ascontiguousarray(a[idx])).to(dev)
            fir, hb = self._taps_on(dev)
            elem = front_end(xr, *(col(a, cells) for a in bases),
                             *(col(a, ch) for a in per_c), fir, hb,
                             self.n_up, self.k_loc)
            consts = self._consts_on(0, dev)
            eq, diag = rx_chain.frames_to_eq(elem.reshape(-1, fs), plan,
                                             consts)
            n = len(cells)
            stats = dict(gi_cfo=diag["gi_cfo"].reshape(n, -1).mean(1),
                         sro=diag["sro"].reshape(n, -1).mean(1))
            if "cir_p" in diag:
                cp = diag["cir_p"]
                stats["cir_p"] = cp.reshape(n, -1, cp.shape[-1]).mean(1)
            first = torch.from_numpy(np.nonzero(cells % nt == 0)[0]).to(dev)
            sig = eq.reshape(n, -1, mode.frame_symbols * mode.k_total)[
                first, 0][:, consts["sig_idx"][:self.n_sig]]
            shards.append(PlaneShards(dev, cells, eq, diag.get("csi"),
                                      stats, sig))
        return PlaneResult(self, shards, n_ch)

    def plane_step(self, raw, idx0, frac0, phase0, freq, step_raw):
        """Contiguous input [C_r, n_time_r * raw_block], this rank's time
        blocks (all of them on a one-process grid): each block gets the
        tail of the block before it as its left halo, through the ring
        where that block lives on another rank, zeros before block 0 ->
        PlaneResult."""
        if not isinstance(raw, torch.Tensor):
            raw = torch.from_numpy(np.ascontiguousarray(raw, np.complex64))
        rows, t0, t1 = self.mesh.block
        halo = self.cfg.halo
        blocks = raw.reshape(raw.shape[0], t1 - t0, -1)
        left = torch.zeros(*blocks.shape[:2], halo, dtype=raw.dtype,
                           device=raw.device)
        left[:, 1:] = blocks[:, :-1, -halo:]
        left[:, 0] = self.mesh.ring_halo(blocks[:, -1, -halo:])
        return self._plane(torch.cat([left, blocks], dim=2), idx0, frac0,
                           phase0, freq, step_raw)

    def plane_step_windows(self, raw_w, idx0, frac0, phase0, freq,
                           step_raw):
        """Per-shard raw windows [C_r, n_time_r, win] (this rank's shards)
        -> PlaneResult.

        Each window carries its own WINDOW_LEAD of left context at a
        host-chosen raw position (host_bases_windows), so no halo crosses
        ranks.  A pinned host tensor goes to the card in one copy that
        does not block."""
        return self._plane(raw_w, idx0, frac0, phase0, freq, step_raw)

    # ------------------------------------------------------------------
    def fec_step(self, plane: "PlaneResult", i: int = 0,
                 correct=None) -> "FecResult":
        """Decode PLP i from the shared plane: returns FecResult.

        ``correct``: [C] bool, the channels whose BCH-dirty codewords the
        host corrects (default all); a dirty codeword of another channel
        is dropped unread, as one the BCH could not correct."""
        return self.fec_finish(self.fec_step_async(plane, i), correct)

    def fec_step_async(self, plane: "PlaneResult", i: int = 0):
        """Device half of fec_step: demap, ONE LDPC + BCH-screen kernel
        launch and bit packing a device, and the copies to the host
        started without blocking.  fec_finish completes them."""
        state, plan = self.plps[i], self.plans[i]
        decoder = self._decoder(state.plp)
        parts = []
        for s in plane.shards:
            llr, snr = rx_chain.packed_to_llr(
                s.eq, plan, self._consts_on(i, s.device), csi=s.csi)
            hard, ok, iters, clean = decoder(llr)
            packed = bch_ops.pack_bits(hard[:, :state.plp.n_bch])
            out = dict(packed=packed, ok=ok, iters=iters, clean=clean,
                       snr=snr)
            side = None
            if s.device.type == "cuda":
                side = self._copy_streams.setdefault(
                    s.device, torch.cuda.Stream(s.device))
            parts.append((s.cells, host_copies(out, side)))
        return i, plane.n_ch, parts

    def fec_finish(self, pending, correct=None) -> "FecResult":
        """Host half of fec_step: wait for the copies, assemble this
        rank's [C_r, ...] arrays, correct the BCH-dirty codewords and
        take each channel's SNR over its time shards."""
        i, n_ch, parts = pending
        state = self.plps[i]
        rows, t0, t1 = self.mesh.block
        f, nt, nt_loc = self.cfg.frames_per_shard, self.n_time, t1 - t0
        nf, nb = state.n_fec_per_frame, state.plp.n_bch // 8
        n_loc = n_ch // self.n_ch * len(rows)
        _, chans, loc = self._local(n_loc, nt_loc)
        n = n_loc * nt_loc
        bb = np.empty((n, f, nf, nb), np.uint8)
        ok = np.empty((n, f, nf), bool)
        iters = np.empty((n, f, nf), np.int32)
        clean = np.empty((n, f, nf), bool)
        snr = np.zeros(n_ch * nt, np.float32)
        for cells, (host, done) in parts:
            if done is not None:
                done.synchronize()
            h = {k: v.numpy() for k, v in host.items()}
            m, lc = len(cells), loc[cells]
            bb[lc] = h["packed"].reshape(m, f, nf, nb)
            ok[lc] = h["ok"].reshape(m, f, nf)
            iters[lc] = h["iters"].reshape(m, f, nf)
            clean[lc] = h["clean"].reshape(m, f, nf)
            snr[cells] = h["snr"].reshape(m, f).mean(1)
        # the host BCH for the codewords the screen flagged, in place
        attempt = (None if correct is None else
                   np.repeat(np.asarray(correct, bool)[chans],
                             nt_loc * f * nf))
        corrected = correct_bb_frames(bb.reshape(-1, nb), clean.reshape(-1),
                                      state.plp, attempt)
        shape = (n_loc, nt_loc * f, nf)
        return FecResult(bb.reshape(*shape, nb), ok.reshape(shape),
                         iters.reshape(shape), clean.reshape(shape),
                         self.mesh.time_mean(snr.reshape(n_ch, nt)), state,
                         corrected.reshape(shape))

    # ------------------------------------------------------------------
    def step(self, raw, idx0, frac0, phase0, freq, step_raw):
        """Contiguous plane + primary-PLP fec.  step_raw: raw-domain
        resample ratio(s), host float64 — scalar (all channels share a
        clock) or [C] (independent clocks); likewise freq.
        idx0/frac0/phase0: [C, n_time] (host_bases output).

        On a grid over ranks ``raw`` is this rank's blocks and the hard
        bits are this rank's [C_r, n_time_r * F, ...]; the stats are the
        whole grid's, the same on every rank."""
        plane = self.plane_step(raw, idx0, frac0, phase0, freq, step_raw)
        fec = self.fec_step(plane, 0)
        hard = np.unpackbits(fec.bb_bytes, axis=-1)
        diag = plane.diag_host()
        mesh, n_ch = self.mesh, len(fec.snr_db)
        chans = mesh.channels(n_ch)

        def per_channel(bad):               # [C_r, F, n_fec] -> [C]
            out = np.zeros(n_ch, np.int64)
            out[chans] = np.sum(bad, axis=(1, 2))
            return mesh.world_sum(out)
        fail_ch = per_channel(~fec.ldpc_ok)
        dirty_ch = per_channel(~fec.bch_clean)
        stats = dict(
            ldpc_failures=np.sum(fail_ch),
            bch_dirty=np.sum(dirty_ch),
            snr_db=float(np.mean(fec.snr_db)),
            gi_cfo=diag["gi_cfo"], sro=diag["sro"],
            ldpc_iters=int(mesh.world_max(np.max(fec.ldpc_iters))),
            # per-channel health
            ldpc_failures_ch=fail_ch,
            bch_dirty_ch=dirty_ch,
            snr_db_ch=fec.snr_db)
        if "cir_p" in diag:
            stats["cir_p"] = diag["cir_p"]
        return hard, stats

    # ------------------------------------------------------------------
    def host_bases(self, mu_global, step, phase_global, freq,
                   raw_block: int, n_channels: int | None = None):
        """float64 host bookkeeping -> per-shard device bases.

        mu_global: resampler position (in raw samples) of this step's first
        output, relative to the first raw sample fed this step.  Every
        argument may be a scalar (shared by all channels) or a [C] vector
        (per-channel front-end state).  n_channels: total data channels
        (defaults to the grid's "ch" extent; pass C when running several
        channels per device).
        Returns (idx0, frac0, phase0), each [C, n_time], local to each
        shard's haloed raw block.
        """
        nt, halo = self.n_time, self.cfg.halo
        nc = n_channels if n_channels is not None else max(
            self.n_ch, *(np.size(a) for a in (mu_global, step,
                                              phase_global, freq)))
        mu_global = np.broadcast_to(np.asarray(mu_global, np.float64), (nc,))
        step = np.broadcast_to(np.asarray(step, np.float64), (nc,))
        phase_global = np.broadcast_to(
            np.asarray(phase_global, np.float64), (nc,))
        freq = np.broadcast_to(np.asarray(freq, np.float64), (nc,))
        idx0 = np.empty((nc, nt), np.int32)
        frac0 = np.empty((nc, nt), np.float32)
        phase0 = np.empty((nc, nt), np.float32)
        for t in range(nt):
            # global raw-sample position of this shard's first farrow output;
            # the FIR window looks back taps-1 upsampled samples, so each
            # shard starts its farrow stream that much early (warm-up)
            p = mu_global + step * (2 * self.k_loc * t - (self.n_taps - 1))
            p_shard = p - t * raw_block + halo      # local incl. halo (raw)
            # x4 grid position, shifted by the half-band group delay
            g = 4.0 * p_shard + self.hb_delay_grid
            idx0[:, t] = np.floor(g).astype(np.int32)
            frac0[:, t] = (g - np.floor(g)).astype(np.float32)
            phase0[:, t] = ((phase_global + freq * (t * raw_block - halo))
                            % (2 * np.pi)).astype(np.float32)
        return idx0, frac0, phase0

    def host_bases_windows(self, r0, step, phase_origin, freq):
        """Per-shard window bases for plane_step_windows.

        r0: [C, n_time] float64 — raw position (relative to the raw array
        the windows will be sliced from) of each shard's first elementary
        output (= the shard's frame start).  phase_origin: [C] NCO phase
        at raw index 0 of that array.  Returns (w0 [C, n_time] int64
        window starts, idx0, frac0, phase0) with w0 = floor(r0) -
        WINDOW_LEAD.
        """
        r0 = np.asarray(r0, np.float64)
        nc, nt = r0.shape
        step = np.broadcast_to(np.asarray(step, np.float64), (nc,))
        phase_origin = np.broadcast_to(
            np.asarray(phase_origin, np.float64), (nc,))
        freq = np.broadcast_to(np.asarray(freq, np.float64), (nc,))
        w0 = np.floor(r0).astype(np.int64) - WINDOW_LEAD
        mu_local = r0 - w0                        # in [LEAD, LEAD + 1)
        p = mu_local + step[:, None] * (-(self.n_taps - 1))
        g = 4.0 * p + self.hb_delay_grid
        idx0 = np.floor(g).astype(np.int32)
        frac0 = (g - np.floor(g)).astype(np.float32)
        phase0 = ((phase_origin[:, None] + freq[:, None] * w0)
                  % (2 * np.pi)).astype(np.float32)
        return w0, idx0, frac0, phase0


@dataclasses.dataclass
class PlaneResult:
    """Plane-stage output: the equalized planes (and CSI) stay on their
    devices; the L1 signalling cells and the discriminators come to the
    host when asked for."""
    rx: ShardedReceiver
    shards: list                      # PlaneShards, one a device
    n_ch: int

    @functools.cached_property
    def _host(self) -> tuple:
        # this rank's shards, zeros elsewhere; on a grid over ranks the
        # reductions below are collectives, so every rank reads them
        mesh, nt = self.rx.mesh, self.rx.n_time
        n = self.n_ch * nt
        sig = np.zeros((n, self.rx.n_sig), np.complex64)
        per_shard: dict = {}
        for s in self.shards:
            for k, v in s.stats.items():
                a = per_shard.setdefault(
                    k, np.zeros((n,) + tuple(v.shape[1:]), np.float32))
                a[s.cells] = v.cpu().numpy()
            sig[s.cells[s.cells % nt == 0]] = s.sig.cpu().numpy()
        # the L1 cells from each channel's time-0 shard; per-channel means
        # over the channel's time shards
        sig = mesh.time_sum(sig.reshape(self.n_ch, nt, -1))
        diag = {k: mesh.time_mean(a.reshape(self.n_ch, nt, *a.shape[1:]))
                for k, a in per_shard.items()}
        return sig, diag

    @property
    def sig(self) -> np.ndarray:
        """L1 signalling cells, complex [C, n_sig] on the host."""
        return self._host[0]

    def diag_host(self) -> dict:
        """gi_cfo, sro [C] (and cir_p [C, n_delays] on SFN plans)."""
        return self._host[1]

    def l1_cells(self, channel: int | None = None) -> np.ndarray:
        """Equalized L1 signalling cells as complex — per channel, or
        [C, n_sig] for all."""
        return self.sig if channel is None else self.sig[channel]


@dataclasses.dataclass
class FecResult:
    """Per-PLP decode output; everything host numpy, bytes packed 8x."""
    bb_bytes: np.ndarray              # u8 [C, F, n_fec, n_bch/8]
    ldpc_ok: np.ndarray               # bool [C, F, n_fec]
    ldpc_iters: np.ndarray            # [C, F, n_fec]
    bch_clean: np.ndarray             # bool [C, F, n_fec], the screen's
    snr_db: np.ndarray                # [C]
    state: PlpState
    # bits the host BCH corrected in each codeword: 0 where the screen
    # found it clean, -1 where the BCH could not correct it (its BB frame
    # is then one the parser drops)
    bch_corrected: np.ndarray         # int64 [C, F, n_fec]
