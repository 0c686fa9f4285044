"""Pod-scale deployment: many RF channels received in lockstep.

The BASELINE north star is 64 concurrent 8 MHz channels.  RF channels are
embarrassingly parallel, so the recipe is a (ch, time) grid of devices
(parallel/sharding.py): channels spread over the cards, several channels
a card, and optionally a "time" split of one channel's stream.  On one
card every channel's shards run as one batched step.

``MultiChannelReceiver.stream`` is the steady-state loop.  It runs on the
WINDOW front-end path (one raw window per (channel, time-shard) at
host-chosen float64 positions, sharding.plane_step_windows), which is
what makes the following possible without any device-shape change:

* **L1-dynamic tracking** (``track_l1=True``): the plane stage returns the
  first frame's equalized L1 cells per channel; the host re-reads dynamic
  L1 every step (reference: per-frame dyn L1 re-read,
  /root/reference/src/DVB_T2/dvbt2_demodulator.cpp:328-346) and rebuilds
  only the per-PLP plans when PLP_NUM_BLOCKS / PLP_START move.
* **FEF hops** (ShardedConfig.fef): per-channel FRAME_IDX arithmetic
  places each shard's window after the gaps (EN 302 755 clause 8.4).
* **multi-PLP**: every configured PLP decodes from the same plane.
* **per-channel health + relock** (``relock=True``): a channel whose BCH
  stays dirty is re-acquired blind from its own recent raw while the
  other channels keep decoding (single-channel analogue: dead-batch
  relock, runtime/stream.py; reference: per-instance reset,
  rx_base.cpp:163-167).

Single-PLP static muxes can also use the fixed-cadence step() (contiguous
raw with a halo in front of each time block).  Across processes, one a
host, ``distributed.rank_mesh`` lays the grid over ``torch.distributed``
ranks and step() runs there unchanged; stream() feeds host numpy to one
process's grid, as the TPU package's pod does.
"""
from __future__ import annotations

import bisect
import copy
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from . import acquire, sharding
from ..io import inband
from ..io.bbframe import HEADER_BITS
from ..models.receiver import config_from_l1, dropped_frame, scrambler_bytes
from ..ops import equalizer as eq_mod
from ..params import l1 as l1_mod
from ..params.modes import SAMPLE_RATE
from ..runtime import acquisition
from ..runtime.stream import raw_to_complex_np


def pod_mesh(n_channels: int, time_per_channel: int = 1, devices=None):
    """Device grid for n_channels concurrent receivers, one device each.

    time_per_channel > 1 splits each channel's stream over that many
    devices; total devices needed = n_channels * time_per_channel.
    ``devices`` defaults to the visible CUDA devices.  (Several channels a
    card need no grid row each: ShardedReceiver takes any multiple of the
    grid's "ch" extent.)
    """
    if devices is None:
        devices = (list(range(torch.cuda.device_count()))
                   if torch.cuda.is_available() else [])
    need = n_channels * time_per_channel
    if len(devices) < need:
        raise ValueError(f"{need} devices needed, {len(devices)} available")
    return sharding.make_mesh(n_channels, time_per_channel,
                              devices=devices[:need])


def pod_64ch_mesh(devices=None):
    """The BASELINE 64-channel configuration (64 devices, one a channel)."""
    return pod_mesh(64, 1, devices=devices)


class ChannelStore:
    """Growable per-channel raw store: LIVE pod ingest.

    ``stream()`` addresses raw samples at ABSOLUTE positions; a
    ChannelStore lets those samples arrive incrementally instead of as
    one [C, N] capture array — from ``readers[c]() -> complex64 block or
    None`` (pulled on demand; a live reader blocks until data, returns
    None at end-of-stream), or pushed with :meth:`append`.  Consumed
    data is trimmed (stream() calls :meth:`trim_before` as it advances),
    so a 24/7 pod holds only a bounded tail per channel — the window
    plus the relock search depth.  Arriving data is copied into RECYCLED
    pool granules (callers keep ownership of what they pass in), so the
    store's working set stays page-warm: holding arriving blocks by
    reference makes every fresh allocation an mmap that is returned to
    the OS on free and page-faulted again on the next arrival.

    Wiring a live pod: one ``io.sources`` reader per channel (e.g.
    ``UdpIqSource``), converted to complex64
    (``runtime.stream.raw_to_complex_np``), handed here as ``readers``;
    run blind acquisition on a recorded head and pass
    ``lock.pos0 + lock.mu0`` as stream()'s ABSOLUTE ``mu0``.
    """

    # pool granule, samples (1 MB): >= the common SDR block size, small
    # enough that trim granularity stays a fraction of a window
    POOL_BLK = 1 << 17

    def __init__(self, n_channels: int, readers=None):
        self.n_ch = n_channels
        # Per-channel block list: each entry is a filled view of a pool
        # granule (the tail view grows in place as data arrives).
        # window_into() copies the spanning slices straight into the
        # caller's staging buffer; trim_before drops whole expired
        # granules back onto the free list (no copy), so steady state
        # touches only warm pages.
        self._blocks: list[list[np.ndarray]] = [[] for _ in
                                                range(n_channels)]
        self._starts: list[list[int]] = [[] for _ in range(n_channels)]
        self._fill = np.zeros(n_channels, np.int64)  # tail granule fill
        self._end = np.zeros(n_channels, np.int64)
        self._eof = np.zeros(n_channels, bool)
        self._free: list[np.ndarray] = []  # recycled granules (all chans)
        self.bytes_copied = 0          # diagnostics: host copy churn
        self.readers = readers

    def _tail_space(self, c: int) -> tuple[np.ndarray, int]:
        """(tail granule, fill) with at least one writable sample, opening
        a fresh granule from the free list when the tail is full."""
        blocks, starts = self._blocks[c], self._starts[c]
        fill = int(self._fill[c])
        if not blocks or fill == self.POOL_BLK:
            buf = (self._free.pop() if self._free
                   else np.empty(self.POOL_BLK, np.complex64))
            blocks.append(buf[:0])
            starts.append(int(self._end[c]))
            self._fill[c] = fill = 0
        return blocks[-1].base, fill

    def append(self, c: int, blk: np.ndarray) -> None:
        blk = np.asarray(blk)
        n, done = len(blk), 0
        while done < n:
            base, fill = self._tail_space(c)
            take = min(n - done, self.POOL_BLK - fill)
            base[fill:fill + take] = blk[done:done + take]
            self.commit(c, take)
            done += take
        self.bytes_copied += n * 8

    def borrow(self, c: int) -> np.ndarray:
        """Writable complex64 scratch at the channel's tail (page-warm
        recycled pool memory).  Fill a prefix, then :meth:`commit` the
        count actually written — the zero-copy ingest path: a reader
        that supports ``read_into`` lands samples directly in the store.
        Between borrow and commit no other store call may touch
        channel c."""
        base, fill = self._tail_space(c)
        return base[fill:]

    def commit(self, c: int, n: int) -> None:
        """Publish n samples written into :meth:`borrow` space."""
        if n == 0:
            return
        blocks = self._blocks[c]
        fill = len(blocks[-1])      # filled view length == tail fill
        base = blocks[-1].base
        if fill + n > len(base):
            raise ValueError("commit exceeds borrowed space")
        blocks[-1] = base[:fill + n]
        self._fill[c] = fill + n
        self._end[c] += n

    def end(self, c: int) -> int:
        """Absolute position one past the last available sample."""
        return int(self._end[c])

    def base(self, c: int) -> int:
        starts = self._starts[c]
        return starts[0] if starts else int(self._end[c])

    def held(self, c: int) -> int:
        """Samples currently held (bounded-memory diagnostics)."""
        return int(self._end[c]) - self.base(c)

    def ensure(self, c: int, abs_end: int) -> bool:
        """Pull from the channel's reader until abs_end is available.

        A plain callable reader returns a block (copied into the pool);
        a reader exposing ``read_into(buf) -> count | None`` writes
        straight into borrowed pool space — zero store-added copies."""
        while self.end(c) < abs_end:
            if self._eof[c] or self.readers is None:
                return False
            into = getattr(self.readers[c], "read_into", None)
            if into is not None:
                got = into(self.borrow(c))
                if not got:
                    self._eof[c] = True
                    return False
                self.commit(c, got)
                continue
            blk = self.readers[c]()
            if blk is None or len(blk) == 0:
                self._eof[c] = True
                return False
            self.append(c, blk)
        return True

    def _copy_span(self, c: int, a: int, m: int, out: np.ndarray) -> None:
        """Copy m held samples starting at absolute a into out[:m]."""
        blocks, starts = self._blocks[c], self._starts[c]
        i = bisect.bisect_right(starts, a) - 1
        done = 0
        while done < m:
            b = blocks[i]
            off = a + done - starts[i]
            take = min(m - done, len(b) - off)
            out[done:done + take] = b[off:off + take]
            done += take
            i += 1
        self.bytes_copied += m * 8

    def window_into(self, c: int, a: int, n: int, out: np.ndarray) -> int:
        """The n samples at absolute a into out[:n]: the held ones at
        their own offsets, zeros where none is held (before base(c):
        consumed and trimmed; from end(c) on: not arrived).  The window
        never moves, so a late channel gets zeros, not samples it already
        decoded.  Returns the count copied."""
        return _positioned_copy(a, n, out, self.base(c), self.end(c),
                                lambda lo, m, dst: self._copy_span(
                                    c, lo, m, dst))

    def available(self, c: int, a: int, n: int) -> np.ndarray:
        """Up to n samples from absolute a (shorter near the end; a
        zero-copy view when one granule spans the request — valid until
        the next trim_before)."""
        a = max(int(a), self.base(c))
        m = max(0, min(n, self.end(c) - a))
        blocks, starts = self._blocks[c], self._starts[c]
        if m:
            i = bisect.bisect_right(starts, a) - 1
            off = a - starts[i]
            if off + m <= len(blocks[i]):
                return blocks[i][off:off + m]
        out = np.empty(m, np.complex64)
        self._copy_span(c, a, m, out)
        return out

    def trim_before(self, c: int, abs_pos: int) -> None:
        """Drop whole granules that end at or before abs_pos, recycling
        them onto the free list (invalidates views handed out by
        available() before this call)."""
        blocks, starts = self._blocks[c], self._starts[c]
        k = 0
        while k < len(blocks) and starts[k] + len(blocks[k]) <= abs_pos:
            k += 1
        if k:
            # a partially-filled tail granule can only be dropped when
            # it holds everything up to end(); appends then start fresh
            if k == len(blocks):
                self._fill[c] = 0
            self._free.extend(b.base for b in blocks[:k])
            del blocks[:k]
            del starts[:k]
            # steady state self-bounds (appends drain the free list);
            # cap it so a config change that SHRINKS usage releases the
            # now-oversized pool back to the OS
            cap = max(64, sum(len(b) for b in self._blocks))
            del self._free[cap:]


def _positioned_copy(a: int, n: int, out: np.ndarray, base: int, end: int,
                     copy_span) -> int:
    """out[:n] = samples [a, a + n) of a store holding [base, end): the
    overlap through ``copy_span(lo, m, dst)``, zeros elsewhere."""
    lo, hi = max(int(a), base), min(int(a) + n, end)
    if hi <= lo:
        out[:n] = 0
        return 0
    out[:lo - a] = 0
    copy_span(lo, hi - lo, out[lo - a:hi - a])
    out[hi - a:n] = 0
    return hi - lo


class ThreadedIngest:
    """Per-channel ingest threads in front of a :class:`ChannelStore`
    (the reference dedicates an ingest QThread per receiver,
    rx_base.h:44-45; at pod scale this is what keeps one dead antenna
    from stalling the others).

    Each thread loops over its blocking reader and queues raw blocks
    (bounded queue = backpressure, like the reference's 128-1024-block
    ingest ring); the CONSUMER thread drains queues inside
    :meth:`ensure`, scale-converting straight into borrowed pool space —
    the store itself stays single-threaded, so no locking is needed
    anywhere.

    Semantics per channel: ``eof_on_none=True`` (files/captures) treats
    a None read as end-of-stream — ensure() waits as long as the reader
    takes and reports False only once the channel has ended.  With
    ``eof_on_none=False`` (live sockets: a None read is just a receive
    timeout) the thread keeps trying and ensure() instead returns True
    after ``timeout`` with a data SHORTFALL — the window is zero where
    nothing arrived, the channel decodes dirty, and the dead-channel
    relock machinery owns it from there; the pod never terminates because
    one antenna went quiet.

    Presents the ChannelStore interface stream() consumes (ensure /
    window_into / available / base / end / held / trim_before).
    """

    def __init__(self, readers, fmts=None, eof_on_none=True,
                 timeout: float = 2.0, queue_blocks: int = 128,
                 chunk: int = 65536):
        C = len(readers)
        self.n_ch = C
        self.store = ChannelStore(C)
        self._fmts = (fmts if fmts is not None else ["c64"] * C)
        self._eof_on_none = (list(eof_on_none)
                             if not isinstance(eof_on_none, bool)
                             else [eof_on_none] * C)
        self.timeout = timeout
        self._q = [queue_mod.Queue(maxsize=queue_blocks)
                   for _ in range(C)]
        self._eof = [False] * C
        self._stop = False
        self._threads = []
        for c in range(C):
            t = threading.Thread(target=self._pull, name=f"ingest-ch{c}",
                                 args=(c, readers[c], chunk), daemon=True)
            t.start()
            self._threads.append(t)

    def _pull(self, c: int, reader, chunk: int) -> None:
        while not self._stop:
            try:
                blk = reader(chunk) if callable(reader) \
                    else reader.read(chunk)
            except Exception:   # the source died: its channel ends here
                blk = None
                self._eof_on_none[c] = True
            if blk is None or len(blk) == 0:
                if self._eof_on_none[c]:
                    self._q[c].put(None)
                    return
                # receive timeout: keep trying (sockets block in read;
                # the sleep only guards a misbehaved instant-None source
                # from spinning a core)
                time.sleep(0.01)
                continue
            self._q[c].put(blk)

    def _drain(self, c: int, block_s: float) -> None:
        """Move queued raw blocks into the store, converting into
        borrowed pool space (one write pass); optionally wait up to
        block_s for the first block."""
        q, st = self._q[c], self.store
        while True:
            try:
                blk = q.get(timeout=block_s) if block_s > 0 else \
                    q.get_nowait()
            except queue_mod.Empty:
                return
            block_s = 0.0
            if blk is None:
                self._eof[c] = True
                return
            fmt = self._fmts[c]
            if fmt == "c64" or getattr(blk, "dtype", None) == np.complex64:
                st.append(c, blk)
                continue
            done = 0
            while done < len(blk) // 2 * 2:
                dst = st.borrow(c)
                got = raw_to_complex_np(blk[done:done + 2 * len(dst)], fmt,
                                        out=dst)
                st.commit(c, got)
                done += 2 * got

    def ensure(self, c: int, abs_end: int) -> bool:
        deadline = time.monotonic() + self.timeout
        while True:
            self._drain(c, 0.0)
            if self.store.end(c) >= abs_end:
                return True
            if self._eof[c]:
                return False
            wait = deadline - time.monotonic()
            if wait <= 0 and not self._eof_on_none[c]:
                # live shortfall: window_into zero-fills what has not
                # arrived and the relock machinery owns the channel
                return True
            # a file channel waits for its reader, however slow
            self._drain(c, min(wait, 0.1) if wait > 0 else 0.1)

    def close(self) -> None:
        self._stop = True

    # ---- store interface passthrough ---------------------------------
    def window_into(self, c, a, n, out):
        return self.store.window_into(c, a, n, out)

    def available(self, c, a, n):
        return self.store.available(c, a, n)

    def base(self, c):
        return self.store.base(c)

    def end(self, c):
        return self.store.end(c)

    def held(self, c):
        return self.store.held(c)

    def trim_before(self, c, abs_pos):
        self.store.trim_before(c, abs_pos)

    @property
    def bytes_copied(self):
        return self.store.bytes_copied


class _ArrayStore:
    """ChannelStore interface over one in-memory [C, N] capture."""

    def __init__(self, raw: np.ndarray):
        self._raw = raw
        self.n_ch = raw.shape[0]

    def end(self, c):
        return self._raw.shape[1]

    def base(self, c):
        return 0

    def ensure(self, c, abs_end):
        return abs_end <= self._raw.shape[1]

    def window_into(self, c, a, n, out):
        def span(lo, m, dst):
            dst[:] = self._raw[c, lo:lo + m]
        return _positioned_copy(a, n, out, 0, self._raw.shape[1], span)

    def available(self, c, a, n):
        a = max(int(a), 0)
        return self._raw[c, a:a + n]

    def trim_before(self, c, abs_pos):
        pass


def _drop_shards(res: "sharding.FecResult", short: np.ndarray) -> None:
    """Mark every codeword of the (channel, shard)s in ``short``
    ([C, n_time] bool) failed and give it a BB frame that fails its
    header check: their windows were partly zeros, and zero LLRs decode
    to the all-zero codeword, which passes LDPC and the BCH screen."""
    if not short.any():
        return
    c_n, nt = short.shape
    shp = (c_n, nt, -1, res.ldpc_ok.shape[-1])
    cw = np.broadcast_to(short[:, :, None, None], (c_n, nt)
                         + res.ldpc_ok.reshape(shp).shape[2:])
    for a, v in ((res.ldpc_ok, False), (res.bch_clean, False),
                 (res.bch_corrected, -1)):
        a.reshape(shp)[cw] = v
    kb = res.state.plp.k_bch // 8
    bb = res.bb_bytes.reshape(*shp, res.bb_bytes.shape[-1])
    bb[cw, :kb] = dropped_frame(res.state.plp.k_bch)


class MultiChannelReceiver:
    """One ShardedReceiver serving C channels in lockstep.

    All channels share a T2 configuration (the broadcast-network case:
    one mux transmitted from many sites / received on many antennas);
    heterogeneous configs would use one ShardedReceiver per group.
    """

    # minimum raw position of any window start (sharding.WINDOW_LEAD of
    # left context per window); acquisition folds whole raw samples into
    # pos0 to land mu0 just past this
    _MU_LO = float(sharding.WINDOW_LEAD)

    def __init__(self, cfg: sharding.ShardedConfig, mesh):
        self.rx = sharding.ShardedReceiver(cfg, mesh)
        self.n_ch = mesh.shape["ch"]
        self.n_time = mesh.shape["time"]

    def raw_block_for(self, step: float) -> int:
        return self.rx.raw_block_for(step)

    def step(self, raw_per_channel: np.ndarray, mu, step,
             phase=0.0, freq=0.0):
        """raw_per_channel: [C, n_time * raw_block] complex64.

        mu/step/phase/freq: scalar or [C] (per-channel front-end state);
        C may be any multiple of the grid's "ch" extent (channels share
        devices when C exceeds it)."""
        rb = self.rx.raw_block_for(float(np.max(step)))
        idx0, frac0, phase0 = self.rx.host_bases(
            mu, step, phase, freq, rb,
            n_channels=raw_per_channel.shape[0])
        return self.rx.step(raw_per_channel, idx0, frac0, phase0, freq, step)

    # ------------------------------------------------------------------
    def _frame_offsets(self, frame_idx: np.ndarray):
        """Per-channel elementary offsets of each shard's frame start for
        one step, plus (elementary consumed, frame_idx after the step).

        FRAME_IDX arithmetic (EN 302 755 clause 8.4): fef_length
        elementary samples follow every fef_interval-th T2 frame.
        """
        rx = self.rx
        fs = rx.mode.frame_samples
        fps = rx.cfg.frames_per_shard
        fef = rx.cfg.fef
        n_t2 = max(1, rx.cfg.num_t2)
        C = len(frame_idx)
        e_off = np.zeros((C, self.n_time), np.float64)
        e_total = np.zeros(C, np.float64)
        idx_next = frame_idx.copy()
        if fef is None:
            off = np.arange(self.n_time) * fps * fs
            e_off[:] = off[None, :]
            e_total[:] = self.n_time * fps * fs
            return e_off, e_total, idx_next
        if fps != 1:
            raise ValueError("FEF streaming needs frames_per_shard == 1")
        interval, fef_len = fef
        for c in range(C):
            idx, pos = int(frame_idx[c]), 0.0
            for t in range(self.n_time):
                e_off[c, t] = pos
                pos += fs
                if interval > 0 and (idx + 1) % interval == 0:
                    pos += fef_len
                idx = (idx + 1) % n_t2
            e_total[c] = pos
            idx_next[c] = idx
        return e_off, e_total, idx_next

    def _harvest_inband(self, fec, post_cache, channel: int):
        """Newest in-band type A block (EN 302 755 clause 5.2.3.1) from
        one live channel's BB padding fields this step — the data path
        carries next-frame schedules, so the dynamic configuration
        survives P2 erasure indefinitely (pod twin of the single-channel
        harvest, runtime/stream.py)."""
        st = self.rx.plps[0]
        if post_cache is None:
            return None
        plp_l1 = next((p for p in post_cache.plp
                       if p.id == st.plp.plp_id), None)
        if plp_l1 is None or not plp_l1.in_band_a_flag:
            return None
        kb = st.plp.k_bch // 8
        scr = scrambler_bytes(st.plp.k_bch)
        bb = fec.bb_bytes                       # [C, F, n_fec, nb/8]
        for f in reversed(range(bb.shape[1])):  # newest block wins
            frame = bb[channel, f, 0, :kb]
            hdr = frame[:10] ^ scr[:10]
            dfl = int(hdr[4]) << 8 | int(hdr[5])
            if dfl <= 0 or dfl % 8 or HEADER_BITS + dfl >= kb * 8:
                continue
            pad = np.unpackbits(frame[10 + dfl // 8:]
                                ^ scr[10 + dfl // 8:])
            blk = inband.parse_inband_a(pad)
            if blk is not None:
                return blk
        return None

    def _repair_from_inband(self, blk, post_cache, frame_idx0: int):
        """Rebuild this step's L1-post dynamic block from an in-band type
        A block harvested from the PREVIOUS step's data path."""
        post = copy.copy(post_cache)
        post.dyn = copy.deepcopy(post_cache.dyn)
        sb = blk.starts_blocks(self.rx.plps[0].plp.plp_id)
        for dp in post.dyn.plp:
            if dp.id in sb:
                dp.start, dp.num_blocks = sb[dp.id]
        post.dyn.sub_slice_interval = blk.sub_slice_interval
        post.dyn.start_rf_idx = blk.start_rf_idx
        # FRAME_IDX is not signalled in-band; the tracked counter stands in
        post.dyn.frame_idx = frame_idx0 % max(1, self.rx.cfg.num_t2)
        return post

    def _decode_l1(self, plane, channel: int):
        try:
            return acquisition.decode_l1_cells(
                plane.l1_cells(channel), device=self._device_of(channel,
                                                                plane.n_ch))
        except l1_mod.L1DecodeError:
            return None

    def _device_of(self, c: int, n_ch: int):
        """The device of channel c's first time shard."""
        return self.rx.mesh.devices[c // (n_ch // self.n_ch)][0]

    def _apply_l1_dyn(self, post, events: list) -> None:
        """Rebuild the per-PLP plans if dynamic L1 moved the PLPs
        (PLP_NUM_BLOCKS / PLP_START).  The plane stage is untouched."""
        rx = self.rx
        for i, st in enumerate(list(rx.plps)):
            dyn = next((d for d in post.dyn.plp if d.id == st.plp.plp_id),
                       None)
            if dyn is None:
                continue
            if (dyn.num_blocks != st.n_fec_per_frame
                    or dyn.start != st.plp_start):
                events.append(
                    f"l1_dyn: plp{st.plp.plp_id} num_blocks "
                    f"{st.n_fec_per_frame}->{dyn.num_blocks} start "
                    f"{st.plp_start}->{dyn.start}")
                rx.replace_plp(i, sharding.PlpState(
                    st.plp, dyn.num_blocks, st.n_ti, dyn.start))

    def _try_relock(self, store, c: int, r_lo: float,
                    step_c: float, events: list):
        """Blind re-acquisition of one dark channel from its recent raw
        (a FULL blind search: P1 correlation + CFO + FFT/GI scan + L1
        decode) while the rest of the pod keeps decoding.  Returns
        ("ok", (r_frame, freq, frame_idx)), ("mismatch", None) when the
        channel locked to a DIFFERENT configuration (the mux was
        reconfigured or the tuner drifted onto another mux), or
        ("nolock", None).

        The search depth is bounded (~4 frames + a FEF gap): the channel
        relocks within a few steps of signal appearing, and a channel
        that stays dark costs a bounded scan per step instead of the
        whole remaining capture."""
        rx = self.rx
        depth_elem = 4 * rx.mode.frame_samples
        if rx.cfg.fef is not None:
            depth_elem += rx.cfg.fef[1]
        lo = max(store.base(c), int(r_lo))
        depth_raw = int(depth_elem * 2.0 * step_c) + 64
        store.ensure(c, lo + depth_raw)      # best effort (live feeds)
        head = store.available(c, lo, depth_raw)
        if len(head) < 200_000:
            return "nolock", None
        got = acquire._acquire_one(head, step_c, depth_elem,
                                   rx.cfg.fir_preset,
                                   self._device_of(c, store.n_ch))
        if got is None:
            return "nolock", None
        r0, freq_raw, acq = got
        if acq.mode != rx.mode:
            events.append(
                f"relock: ch{c} CONFIG CHANGED — locked to a different "
                f"mode ({acq.mode.fft_size // 1024}K GI "
                f"{acq.mode.guard.name} vs pod "
                f"{rx.mode.fft_size // 1024}K GI {rx.mode.guard.name}); "
                "staying dark")
            return "mismatch", None
        new = config_from_l1(acq.mode, acq.l1_pre, acq.l1_post,
                             min(rx.plps[0].plp.plp_id,
                                 acq.l1_post.num_plp - 1))
        if new.plp != rx.plps[0].plp:
            events.append(
                f"relock: ch{c} CONFIG CHANGED — same mode but different "
                f"PLP configuration ({new.plp.constellation.name} "
                f"r={new.plp.code_rate.name} vs pod "
                f"{rx.plps[0].plp.constellation.name} "
                f"r={rx.plps[0].plp.code_rate.name}); staying dark")
            return "mismatch", None
        events.append(f"relock: ch{c} reacquired")
        return "ok", (lo + r0, freq_raw,
                      acq.l1_post.dyn.frame_idx % max(1, rx.cfg.num_t2))

    # ------------------------------------------------------------------
    def stream(self, raw, mu0, step,
               freq=0.0, max_steps: int | None = None,
               track: bool = False, cfo_gain: float = 0.3,
               sro_gain: float = 0.5, track_l1: bool = False,
               relock: bool = False, locked=None, frame_idx0=0,
               dead_after: int = 3, relock_exhausted: int = 8):
        """Generator over consecutive steps of a continuous capture.

        raw: [C, N] complex64 (one continuous stream per channel) OR a
        :class:`ChannelStore` / :class:`ThreadedIngest` for LIVE ingest
        (blocks pulled from per-channel readers on demand, consumed raw
        trimmed as the pod advances — a 24/7 deployment holds only a
        bounded tail).
        mu0: raw-domain position of the first frame start relative to
        raw[:, 0] — scalar or [C] (parallel.acquire derives it blind per
        channel), must be >= sharding.WINDOW_LEAD.  step/freq likewise
        scalar or [C].

        Yields (hard, stats) per step until the capture is exhausted;
        ``hard`` is the primary PLP's bits [C, n_time*F, n_fec, n_bch],
        with every BCH-dirty codeword of a live channel corrected on the
        host (one the BCH cannot correct, and any dirty codeword of a
        dark channel, reaches it as a BB frame whose header fails).

        ``track=True`` closes the CFO / sampling-rate loops PER CHANNEL:
        the [C] guard-interval and pilot-drift discriminators (means over
        each channel's time shards) trim each channel's NCO frequency and
        resample step between steps, like the single-channel loop
        (runtime/stream.py) — independent RF channels have independent
        LO/clock errors, so a 64-channel pod holds lock per channel
        without a shared clock.  SFN plans additionally steer first-path
        timing from the CIR profile.  Host-applied corrections are
        reported in stats as cfo_hz_applied / sro_ppm_applied ([C]).

        ``track_l1=True`` re-reads dynamic L1 every step and rebuilds the
        per-PLP plans when the schedule moves; ``relock=True`` (with
        ``locked`` an optional [C] bool mask from partial acquisition)
        re-acquires dark/dead channels mid-stream.  FEF-mixed streams
        (ShardedConfig.fef) hop the gaps by per-channel FRAME_IDX
        arithmetic seeded from ``frame_idx0``.

        A dark channel is never silently dark forever: each relock
        attempt is a FULL blind search, so a channel that came back
        carrying a different mode or PLP configuration is reported as a
        distinct "CONFIG CHANGED" event, and after ``relock_exhausted``
        consecutive failed searches an "exhausted" event flags that the
        channel's configuration may have changed in a way blind search
        cannot resolve (repeated every ``relock_exhausted`` further
        failures; ``stats["relock_fail"]`` carries the running count).
        """
        rx = self.rx
        store = raw if not isinstance(raw, np.ndarray) else _ArrayStore(raw)
        C = store.n_ch
        mu = np.broadcast_to(np.asarray(mu0, np.float64), (C,)).copy()
        step = np.broadcast_to(np.asarray(step, np.float64), (C,)).copy()
        freq = np.broadcast_to(np.asarray(freq, np.float64), (C,)).copy()
        frame_idx = np.broadcast_to(
            np.asarray(frame_idx0, np.int64), (C,)).copy()
        alive = (np.ones(C, bool) if locked is None
                 else np.asarray(locked, bool).copy())
        if not (mu[alive] >= self._MU_LO).all():
            raise ValueError("mu0 must be >= WINDOW_LEAD; fold whole raw "
                             "samples into pos0")

        sro_coeff = eq_mod.sro_coefficient(rx.mode)
        raw_per_elem0 = 2.0 * step.copy()    # raw samples per elementary
        # window size is FIXED from the initial steps (SRO trims <= 2e-5)
        win = rx.window_len(float(np.max(step)))
        r_frame = mu.copy()                  # raw position of next frame 0
        phase_origin = np.zeros(C, np.float64)   # NCO phase at raw[:, 0]
        cfo_hz_applied = np.zeros(C, np.float64)
        dead_steps = np.zeros(C, np.int64)
        relock_fail = np.zeros(C, np.int64)
        post_cache = None
        dyn_next = None
        inband_next = None
        inband_blocks = 0
        inband_repaired = 0
        l1_dyn_errors = 0
        n = 0
        # the windows' staging buffer, pinned when a card reads it: one
        # copy a step that does not block.  Reusing it is safe because
        # each step's fec_finish waits for all device work queued before
        # its copies to the host, this buffer's copy included.
        on_card = any(d.type == "cuda" for row in rx.mesh.devices
                      for d in row)
        buf_t = torch.empty((C, self.n_time, win), dtype=torch.complex64,
                            pin_memory=on_card)
        buf = buf_t.numpy()
        while True:
            e_off, e_total, idx_next = self._frame_offsets(frame_idx)
            r0 = r_frame[:, None] + raw_per_elem0[:, None] * e_off
            w0, idx0, frac0, phase0 = rx.host_bases_windows(
                r0, step, phase_origin, freq)
            live = alive if alive.any() else np.ones(C, bool)
            # pull/verify availability per LIVE channel (a ChannelStore
            # blocks in its readers; an array store just bounds-checks)
            for c in np.nonzero(live)[0]:
                if not store.ensure(c, int(w0[c].max()) + win):
                    return
            # per-(channel, shard) contiguous copies into the staging
            # buffer, a memcpy each; a window not all held (a live
            # shortfall, a dark channel's thin store) is zero where its
            # samples are missing, and decodes nothing this step
            short = np.zeros((C, self.n_time), bool)
            for c in range(C):
                for t in range(self.n_time):
                    short[c, t] = store.window_into(
                        c, int(w0[c, t]), win, buf[c, t]) < win

            plane = rx.plane_step_windows(buf_t, idx0, frac0, phase0,
                                          freq, step)
            events: list = []
            post = None
            if track_l1:
                # decode from the first ALIVE channel, falling back across
                # alive channels on erasure — a dark channel 0 must not
                # blind the whole pod to schedule changes
                got = None
                for c in np.nonzero(alive)[0]:
                    got = self._decode_l1(plane, int(c))
                    if got is not None:
                        break
                if got is not None:
                    pre, post = got
                    post_cache = post
                    dyn_next = (post.dyn_next
                                if pre.l1_repetition_flag
                                and post.dyn_next.plp else None)
                elif inband_next is not None and post_cache is not None:
                    # preferred repair: the previous step's data path
                    # carried next-frame schedules in the BB padding
                    # (in-band type A re-arms every step; repetition's
                    # dyn_next is single-use)
                    post = self._repair_from_inband(
                        inband_next, post_cache, int(frame_idx[0]))
                    post_cache = post
                    inband_next = None
                    inband_repaired += 1
                    events.append("l1_dyn: repaired from in-band type A")
                elif dyn_next is not None and post_cache is not None:
                    post = copy.copy(post_cache)
                    post.dyn = dyn_next          # one frame of diversity
                    dyn_next = None
                    events.append("l1_dyn: repaired from L1 repetition")
                else:
                    l1_dyn_errors += int(alive.any())
                if post is not None:
                    self._apply_l1_dyn(post, events)
                    # broadcast FRAME_IDX re-anchors the FEF arithmetic
                    # (drift would misplace the gap hop); per-channel
                    # resync when channels are offset captures
                    if rx.cfg.fef is not None:
                        n_t2 = max(1, rx.cfg.num_t2)
                        frame_idx[0] = post.dyn.frame_idx % n_t2
                        for c in range(1, C):
                            if not alive[c]:
                                continue
                            gc = self._decode_l1(plane, c)
                            if gc is not None:
                                frame_idx[c] = gc[1].dyn.frame_idx % n_t2
                        e_off, e_total, idx_next = self._frame_offsets(
                            frame_idx)

            # every PLP's device work queued before the host waits
            pending = [rx.fec_step_async(plane, i)
                       for i in range(len(rx.plps))]
            results = [rx.fec_finish(p, correct=alive) for p in pending]
            for res in results:
                _drop_shards(res, short)
            fec = results[0]
            hard = np.unpackbits(fec.bb_bytes, axis=-1)
            diag = plane.diag_host()
            if track_l1 and alive.any():
                blk = self._harvest_inband(fec, post_cache,
                                           int(np.argmax(alive)))
                if blk is not None:
                    inband_next = blk
                    inband_blocks += 1

            # ---- per-channel health / relock -------------------------
            ch_clean = fec.bch_clean.reshape(C, -1).any(axis=1)
            dead_steps = np.where(ch_clean, 0, dead_steps + 1)
            just_relocked = np.zeros(C, bool)
            if relock:
                newly_dead = alive & (dead_steps >= dead_after)
                if newly_dead.any():
                    for c in np.nonzero(newly_dead)[0]:
                        events.append(f"relock: ch{c} dead "
                                      f"({dead_steps[c]} dirty steps)")
                    alive &= ~newly_dead
                for c in np.nonzero(~alive)[0]:
                    status, got = self._try_relock(store, c, r_frame[c],
                                                   float(step[c]), events)
                    if status != "ok":
                        relock_fail[c] += 1
                        if (status == "nolock"
                                and relock_fail[c] % relock_exhausted == 0):
                            events.append(
                                f"relock: ch{c} exhausted "
                                f"{relock_fail[c]} blind searches — "
                                "channel config may have changed or "
                                "signal lost")
                    else:
                        # fresh lock: this channel's r_frame now points at
                        # its NEXT frame; don't advance it again below
                        r_frame[c], freq[c], frame_idx[c] = got
                        phase_origin[c] = 0.0
                        cfo_hz_applied[c] = (freq[c] * 2.0 * SAMPLE_RATE
                                             * step[c] / (2 * np.pi))
                        alive[c] = True
                        dead_steps[c] = 0
                        relock_fail[c] = 0
                        just_relocked[c] = True

            stats = dict(
                ldpc_failures=int(np.sum(~fec.ldpc_ok[alive])),
                bch_dirty=int(np.sum(~fec.bch_clean[alive])),
                snr_db=float(np.mean(fec.snr_db[alive]))
                if alive.any() else 0.0,
                gi_cfo=diag["gi_cfo"], sro=diag["sro"],
                ldpc_iters=int(np.max(fec.ldpc_iters)),
                ldpc_failures_ch=np.sum(~fec.ldpc_ok, axis=(1, 2)),
                bch_dirty_ch=np.sum(~fec.bch_clean, axis=(1, 2)),
                snr_db_ch=fec.snr_db, alive=alive.copy(),
                l1_dyn_errors=l1_dyn_errors,
                inband_a_blocks=inband_blocks,
                inband_repaired=inband_repaired, events=events,
                relock_fail=relock_fail.copy(),
                plp_results=results,
                l1_post=post if post is not None else post_cache,
                frame_idx=frame_idx.copy())

            # ---- tracking: apply step-N estimates to step N+1 --------
            if track:
                cfo_res = np.asarray(diag["gi_cfo"], np.float64)  # [C]
                dfreq = np.where(alive & ~just_relocked,
                                 cfo_gain * cfo_res / raw_per_elem0, 0.0)
                # keep the NCO phase continuous at the current stream
                # position when the frequency moves:
                # phase(r) = origin + freq*r  must be invariant at r_frame
                phase_origin = (phase_origin - dfreq * r_frame) % (2 * np.pi)
                freq = freq + dfreq
                cfo_hz_applied += np.where(
                    alive & ~just_relocked,
                    cfo_gain * cfo_res * SAMPLE_RATE / (2 * np.pi), 0.0)
                slip = np.asarray(diag["sro"], np.float64) / sro_coeff
                trim = np.where(alive & ~just_relocked,
                                np.clip(-sro_gain * slip, -2e-5, 2e-5),
                                0.0)
                step *= (1.0 + trim)
                stats["cfo_hz_applied"] = cfo_hz_applied.copy()
                stats["sro_ppm_applied"] = (step * 2.0 / raw_per_elem0
                                            - 1.0) * 1e6
                # CIR-anchored first-path timing (SFN plans): keep every
                # echo inside [0, GI] like the single-channel loop
                cir_p = diag.get("cir_p")
                if cir_p is not None:
                    d = rx.plans[0].eq.cir_d
                    # just_relocked channels' cir_p came from pre-relock
                    # (dark/zeroed) windows — never steer from it
                    for c in np.nonzero(alive & ~just_relocked)[0]:
                        prof = cir_p[c]
                        first = int(d[int(np.argmax(
                            prof >= 0.08 * float(prof.max())))])
                        if abs(first) > 6:
                            nudge = int(np.clip(first // 2, -24, 24))
                            r_frame[c] += nudge * 2.0 * step[c]
                            events.append(f"timing: ch{c} cir nudge "
                                          f"{nudge}")

            yield hard, stats
            n += 1
            if max_steps is not None and n >= max_steps:
                return
            r_frame = np.where(just_relocked, r_frame,
                               r_frame + 2.0 * step * e_total)
            frame_idx = np.where(just_relocked, frame_idx, idx_next)
            # live stores: drop consumed raw, keeping a window of context
            # (the next step's left lead plus relock look-back headroom)
            for c in range(C):
                store.trim_before(c, int(r_frame[c]) - 2 * win)
