"""Layered offset-min-sum LDPC decoder with the fused BCH syndrome screen.

Counterpart of the JAX package's Pallas kernel (``ops/ldpc_pallas.py``):
the same message algebra on the DVB-T2 QC-IRA codes, in two forms that
compute the same function:

* ``ops/csrc/ldpc_layered.cu``: the CUDA kernels (the decoder, one thread
  block a codeword at a time on a persistent grid, which writes the BB
  frame's bytes, and the BCH screen over those bytes), launched by
  :class:`LayeredDecoder` on a CUDA tensor;
* :func:`decode_plain`: the plain PyTorch twin, the same integer algebra on
  [W, 360] slabs with ``torch.roll``, used for a CPU tensor and to check
  the kernel.

Algebra (both forms): offset min-sum with beta = 1; messages clipped to
[-32, 31]; posteriors to +-127; channel LLRs clamped to +-56 first (the
weakest bits, the degree-2 staircase parities, can be corrected only while
|channel| < 2 * 31).  Each check row runs pass 1 (min1 / min2 / argmin /
sign parity over the data slots, the parity self slot and the staircase
prev slot, which wraps at row 0) and pass 2 (fused rolled write for slots
that are a first occurrence of their group in every row, read-modify-write
for the duplicate-group tail slots).  Uniform tables take the syndrome
from the post-update signs; non-uniform tables from the pre-update signs
with per-slot masks.  All values are integers below 256, so int8 storage
and int32 arithmetic are exact, as the TPU's bf16 is.

Compressed check state.  The cnl + 2 check-to-variable messages of one
check differ only in sign and in which of two magnitudes they carry, so
the kernel keeps one word per check instead of cnl + 2 bytes
(:func:`compress_row` / :func:`expand_row`): bits 0-5 min(m1, 32), bits
6-11 min(m2, 32), bits 12-16 the slot of the smallest magnitude, bit
17 + slot the sign of that slot's message.  The cap at 32 is exact because
a message is clipped to [-32, 31] anyway: a negative one is -min(mag, 32),
a positive one min(mag, 31).  The word has 17 + cnl + 2 bits: 32 bits hold
every table with cnl <= 13, the others take 64 (:func:`state_word_bits`).
The all-zero word is the all-zero message row, so a first sweep starts
from zeroed state.  (The kernel's unrolled slot count is cnl or the next
size up; it keeps the two parity slots' sign bits behind that count.)  ``decode_plain(state="compressed")`` runs on these
words, ``state="explicit"`` on the message array; both give the same bits.

Early exit contract.  The Pallas kernel leaves its sweep loop in the first
sweep in which every codeword of its 128-codeword tile is clean (or after
max_iters); the clean codewords of a tile that is not done sweep on.  That
is not the same as leaving per codeword: the syndrome is counted from the
posteriors as a sweep updates them, so a sweep without an unsatisfied
check can end on bits that are no codeword, which the next sweeps repair,
and a codeword clean in one sweep can be dirty in the next.  Both forms
keep the tile contract.  The tiles count 128 codewords from the start of
each *segment*: one call of :class:`LayeredDecoder` can stand for several
Pallas calls (the pod decodes one per device), and ``segments`` gives
their codeword counts.  The twin also takes ``exit_tile`` (``1``: each
codeword leaves at its first clean sweep, which the tests use to show
that the contracts differ).  The CUDA kernel keeps the contract in one
launch: a tile's codewords sweep in lockstep and meet after every sweep
at a counter in device memory (its header, "Tile exit", with the proof
that the meeting cannot deadlock); it finds a codeword's tile in the
table of :func:`tile_starts`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .ldpc_decode import get_plan

M = 360
_BIG = 30000
_CLAMP = 56


def _build_tables(plan):
    """Per-row edge tables, slot-permuted so that within every check row a
    repeated variable group (the tables have up to two edges into the same
    360-group per row) lands in the LAST slots.  Slot order is free — the
    min-sum row update is commutative — and this permutation lets pass 2
    use the fused rolled write for every slot that is a FIRST occurrence in
    all rows; only the tail slots fall back to the read-modify-write.

    Returns (g_tab, s_tab, cnt, rmw): rmw = sorted slot indices that are a
    second occurrence of their group in at least one row.
    """
    q, cnl = plan.q, plan.cnl
    g_tab = np.zeros((q, cnl), dtype=np.int32)
    s_tab = np.zeros((q, cnl), dtype=np.int32)
    cnt = np.zeros((q,), dtype=np.int32)
    rmw = set()
    for i, es in enumerate(plan.edges_by_row):
        seen, first, dups = set(), [], []
        for g, s, _ in es:
            (dups if g in seen else first).append((g, s))
            seen.add(g)
        es2 = first + dups
        cnt[i] = len(es2)
        for slot, (g, s) in enumerate(es2):
            g_tab[i, slot] = g
            s_tab[i, slot] = s
        rmw.update(range(len(first), len(es2)))
    return g_tab, s_tab, cnt, sorted(rmw)


def _row_info(g_tab, cnt):
    """Per-row schedule of the kernel, from the slot-permuted tables.

    Returns (nfirst, sync): nfirst[i] = number of leading slots of row i
    that are the first occurrence of their group in that row (the slots
    from nfirst[i] to cnt[i] read-modify-write a group written earlier in
    the row); sync[i] = 1 where row i shares a variable group with a row
    since the last such mark, so that the block must meet before it.  Rows
    between two marks touch disjoint data groups, and their parity slots
    stay within one thread, so they need no barrier between them.  Row 0's
    staircase slot crosses lanes: lane m updates the last row's parity bit
    of lane m - 1, which that lane reads in the last row.  So row 0 and the
    last row are always marked.
    """
    q = g_tab.shape[0]
    nfirst = np.zeros(q, np.int32)
    sync = np.zeros(q, np.int32)
    run = set()
    for i in range(q):
        groups = [int(g) for g in g_tab[i, :cnt[i]]]
        seen = set()
        nfirst[i] = cnt[i]
        for slot, g in enumerate(groups):
            if g in seen:
                nfirst[i] = min(nfirst[i], slot)
            seen.add(g)
        if i == 0 or i == q - 1 or seen & run:
            sync[i] = 1
            run = set()
        run |= seen
    return nfirst, sync


def state_word_bits(cnl: int) -> int:
    """Width of the compressed check-state word: 6 + 6 bits of magnitudes,
    5 of argmin, one sign bit for each of the cnl + 2 slots."""
    return 32 if 17 + cnl + 2 <= 32 else 64


def slot_mask(i: int, cnt_i: int, cnl: int, device=None) -> torch.Tensor:
    """[cnl + 2, M] bool: which (slot, lane) of check row i carry a
    message.  Data slots from cnt_i on do not (non-uniform rows), and
    neither does the staircase slot of row 0 in lane 0, which has no
    previous parity bit."""
    mask = torch.ones((cnl + 2, M), dtype=torch.bool, device=device)
    mask[cnt_i:cnl] = False
    if i == 0:
        mask[cnl + 1, 0] = False
    return mask


def compress_row(m1, m2, idx, neg):
    """The messages of one check row as one word per check.

    m1, m2 [..., M]: the two smallest offset magnitudes; idx [..., M]: the
    slot of the smallest; neg [..., C, M] bool: the sign of each slot's
    message (False where the slot carries none).  Returns int64 [..., M]
    in the layout of the module docstring."""
    word = (torch.clamp(m1, max=32).long()
            | torch.clamp(m2, max=32).long() << 6 | idx.long() << 12)
    shifts = 17 + torch.arange(neg.shape[-2], device=neg.device)
    return word | (neg.long() << shifts[:, None]).sum(dim=-2)


def expand_row(word, n_slots: int, mask=None):
    """Inverse of :func:`compress_row`: int64 words [..., M] -> the
    messages int32 [..., n_slots, M]; ``mask`` (:func:`slot_mask`) zeroes
    the slots that carry no message."""
    word = word.long().unsqueeze(-2)
    slots = torch.arange(n_slots, device=word.device)[:, None]
    mag = torch.where((word >> 12 & 31) == slots, word >> 6 & 63, word & 63)
    neg = (word >> (17 + slots) & 1).bool()
    msg = torch.where(neg, -mag, torch.clamp(mag, max=31))
    if mask is not None:
        msg = torch.where(mask, msg, 0)
    return msg.to(torch.int32)


def pad_bch_h(bch_h: np.ndarray) -> np.ndarray:
    """[n_bch, n_syn_bits] GF(2) parity-check matrix -> the transposed
    layout [n_syn padded to 8, n_bch] float32."""
    n_syn = -(-bch_h.shape[1] // 8) * 8
    h_pad = np.zeros((n_syn, bch_h.shape[0]), np.float32)
    h_pad[:bch_h.shape[1]] = np.asarray(bch_h, np.float32).T
    return h_pad


def packed_row_bytes(k: int) -> int:
    """Bytes of one row of the kernel's packed hard bits: k / 8, padded
    to 16 (the screen reads 16 bytes a copy)."""
    return -(-k // 128) * 16


def pack_bch_h(bch_h: np.ndarray) -> np.ndarray:
    """[n_bch, n_syn] GF(2) matrix -> the screen's packed rows [n_syn,
    packed_row_bytes(n_bch) / 4] uint32: each syndrome row packed as the
    kernel packs the hard bits (bytes MSB first, np.packbits order, zero
    padded), read as little-endian 32-bit words.  The parity of
    popc(bits & h) over a row's words is the syndrome bit whatever the
    order of bits in a word, as long as both sides share it."""
    h = np.asarray(bch_h).astype(bool).T                 # [n_syn, n_bch]
    row = packed_row_bytes(h.shape[1])
    packed = np.zeros((h.shape[0], row), np.uint8)
    packed[:, :-(-h.shape[1] // 8)] = np.packbits(h, axis=1)
    return packed.view("<u4")


def kernel_bit_order(table_name: str) -> np.ndarray:
    """Natural codeword bit index for each kernel input row.

    Kernel rows: [0, k) = data bits in natural order (group-major, which IS
    the natural order), [k, n) = parity rows x where row k + i*M + m holds
    parity bit m*q + i (the staircase interleave).  The demap folds this
    into its final bit-deinterleave gather, so the decoder input needs no
    relayout.
    """
    plan = get_plan(table_name)
    k, q, n = plan.k, plan.q, plan.n
    rows = np.arange(n)
    out = rows.copy()
    x = rows[k:] - k
    i, m = x // M, x % M
    out[k:] = k + m * q + i
    return out


# ---------------------------------------------------------------------------
# plain PyTorch twin
# ---------------------------------------------------------------------------
def _sweep(lam, par, c2v, tabs):
    """One layered sweep over all check rows, in place.  lam [A, G, M],
    par [A, q, M]; c2v is the check state, either the messages themselves
    [A, q, C, M] int32 or their compressed words [A, q, M] int64.
    Returns unsat [A]."""
    g_tab, s_tab, cnt, rmw, uniform = tabs
    q, cnl = g_tab.shape
    a = lam.shape[0]
    compressed = c2v.dim() == 3
    dev = lam.device
    lane_valid0 = torch.arange(M, device=dev) != 0
    unsat = torch.zeros(a, dtype=torch.int64, device=dev)
    big = torch.full((a, M), _BIG, dtype=torch.int32, device=dev)

    def take_min(m1, m2, idx, mag, slot):
        better = mag < m1
        m2 = torch.where(better, m1, torch.minimum(m2, mag))
        idx = torch.where(better, slot, idx)
        return torch.minimum(m1, mag), m2, idx

    for i in range(q):
        n_slots = cnl if uniform else int(cnt[i])
        m1, m2 = big, big
        idx = torch.zeros((a, M), dtype=torch.int32, device=dev)
        spar = torch.zeros((a, M), dtype=torch.bool, device=dev)
        syn = torch.zeros((a, M), dtype=torch.bool, device=dev)
        ts, negs = {}, {}
        # the row's old messages; a slot is read before it is written
        old = (expand_row(c2v[:, i], cnl + 2,
                          slot_mask(i, n_slots, cnl, dev))
               if compressed else c2v[:, i])
        # ---------------- pass 1: gather, mins, signs ----------------
        for slot in range(n_slots):
            g, s = int(g_tab[i, slot]), int(s_tab[i, slot])
            slab = torch.roll(lam[:, g], s, dims=-1)
            t = slab - old[:, slot]
            if not uniform:
                syn ^= slab < 0
            spar ^= t < 0
            m1, m2, idx = take_min(m1, m2, idx,
                                   torch.clamp(t.abs() - 1, min=0), slot)
            ts[slot] = t
        p_self = par[:, i]
        t = p_self - old[:, cnl]
        if not uniform:
            syn ^= p_self < 0
        spar ^= t < 0
        m1, m2, idx = take_min(m1, m2, idx, torch.clamp(t.abs() - 1, min=0),
                               cnl)
        ts[cnl] = t
        ip = i - 1 if i > 0 else q - 1
        p_prev_raw = par[:, ip]
        if i > 0:
            p_prev, valid_prev = p_prev_raw, None
        else:
            p_prev_roll1 = torch.roll(p_prev_raw, 1, dims=-1)
            valid_prev = lane_valid0
            p_prev = torch.where(valid_prev, p_prev_roll1, _BIG)
        t = p_prev - old[:, cnl + 1]
        mag = torch.clamp(t.abs() - 1, min=0)
        if valid_prev is not None:
            t = torch.where(valid_prev, t, _BIG)
            mag = torch.where(valid_prev, mag, _BIG)
        if not uniform:
            syn ^= p_prev < 0 if valid_prev is None else valid_prev & (p_prev < 0)
        spar ^= t < 0
        m1, m2, idx = take_min(m1, m2, idx, mag, cnl + 1)
        ts[cnl + 1] = t

        # ---------------- pass 2: emit messages, update -------------
        def emit(slot):
            t = ts[slot]
            mag_out = torch.where(idx == slot, m2, m1)
            out_neg = negs[slot] = spar ^ (t < 0)
            return t, torch.clamp(torch.where(out_neg, -mag_out, mag_out),
                                  -32, 31)

        for slot in range(n_slots):
            t, msg = emit(slot)
            g, s = int(g_tab[i, slot]), int(s_tab[i, slot])
            if slot in rmw:
                # a later duplicate of a group already updated this row:
                # accumulate via the posterior (delta form)
                upd = lam[:, g] + torch.roll(msg - old[:, slot], -s, dims=-1)
                upd = torch.clamp(upd, -127, 127)
                lam[:, g] = upd
                sign = torch.roll(upd, s, dims=-1) < 0
            else:
                # fused write in the rolled domain: lam + msg - old = t + msg
                upd = torch.clamp(t + msg, -127, 127)
                lam[:, g] = torch.roll(upd, -s, dims=-1)
                sign = upd < 0
            if not compressed:
                c2v[:, i, slot] = msg
            if uniform:
                syn ^= sign
        t, msg = emit(cnl)
        upd_self = torch.clamp(t + msg, -127, 127)
        par[:, i] = upd_self
        if not compressed:
            c2v[:, i, cnl] = msg
        if uniform:
            syn ^= upd_self < 0
        t, msg = emit(cnl + 1)
        upd_prev = torch.clamp(t + msg, -127, 127)
        if valid_prev is None:
            par[:, ip] = upd_prev
            if not compressed:
                c2v[:, i, cnl + 1] = msg
            if uniform:
                syn ^= upd_prev < 0
        else:
            # the wrapped lane 0 of row 0 keeps its value
            par[:, ip] = torch.roll(torch.where(valid_prev, upd_prev,
                                                p_prev_roll1), -1, dims=-1)
            if not compressed:
                c2v[:, i, cnl + 1] = torch.where(valid_prev, msg, 0)
            negs[cnl + 1] = negs[cnl + 1] & valid_prev
            if uniform:
                syn ^= valid_prev & (upd_prev < 0)
        if compressed:
            none = torch.zeros_like(spar)
            c2v[:, i] = compress_row(m1, m2, idx, torch.stack(
                [negs.get(slot, none) for slot in range(cnl + 2)], dim=1))
        unsat += syn.sum(dim=-1)
    return unsat


TILE = 128    # codewords of a Pallas tile


def segment_starts(segments, w: int) -> list:
    """Codeword counts of the segments of a call of W codewords (None: one
    segment) -> their first codewords, then W."""
    counts = [w] if segments is None else [int(c) for c in segments]
    if any(c < 0 for c in counts) or sum(counts) != w:
        raise ValueError(f"segments {counts} do not split {w} codewords")
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64).tolist()


def tile_index(segments, w: int, exit_tile: int = TILE) -> np.ndarray:
    """[W] the exit tile of each codeword: ``exit_tile`` codewords from the
    start of each segment."""
    starts = segment_starts(segments, w)
    tile, base = np.zeros(w, np.int64), 0
    for a, b in zip(starts[:-1], starts[1:]):
        tile[a:b] = base + np.arange(b - a) // exit_tile
        base += -(-(b - a) // exit_tile)
    return tile


def tile_starts(segments, w: int, exit_tile: int = TILE) -> list:
    """The kernel's tile table: the first codeword of each exit tile of a
    call of W codewords (``exit_tile`` codewords from the start of each
    segment), then W.  Codeword c lies in the last tile starting at or
    before it: the tiles of :func:`tile_index`."""
    starts = segment_starts(segments, w)
    firsts = [c for a, b in zip(starts[:-1], starts[1:])
              for c in range(a, b, exit_tile)]
    return firsts + [w]


def decoder_passes() -> int:
    """Launches of the decoder kernel one call on the card makes (one:
    ``ldpc_layered.cu`` "Tile exit"); builds the kernel."""
    from ._build import load_kernel
    return load_kernel("ldpc_layered").ldpc_layered_passes()


def decode_plain(llr: torch.Tensor, table_name: str, max_iters: int = 15,
                 bch_h: np.ndarray | None = None, exit_tile: int = 1,
                 state: str = "compressed", segments=None):
    """Plain PyTorch layered decoder.

    llr int8 [W, N] in kernel bit order (positive = bit 0) -> (hard [W, k]
    int8, ok [W] bool, iters [W] int32, clean [W] bool or None).
    ``exit_tile`` codewords, counted from the start of each of the
    ``segments`` (codeword counts; None: one), leave the sweep loop
    together (see the module docstring); ``clean`` is the BCH syndrome
    screen when ``bch_h`` is given.  ``state`` chooses the form of the
    check state between sweeps, ``"compressed"`` (one word per check, as
    the kernel keeps it) or ``"explicit"`` (every message); the results
    are the same.
    """
    if state not in ("compressed", "explicit"):
        raise ValueError(f"state must be compressed or explicit, got {state!r}")
    from .bch_ops import syndrome_flags
    max_iters = int(min(max_iters, 127))
    plan = get_plan(table_name)
    k, q, g_data, cnl = plan.k, plan.q, plan.g_data, plan.cnl
    g_tab, s_tab, cnt, rmw = _build_tables(plan)
    tabs = (g_tab, s_tab, cnt, set(rmw), bool((cnt == cnl).all()))
    w = llr.shape[0]
    dev = llr.device
    x = torch.clamp(llr.to(torch.int32), -_CLAMP, _CLAMP)
    lam = x[:, :k].reshape(w, g_data, M).clone()
    par = x[:, k:].reshape(w, q, M).clone()
    c2v = (torch.zeros((w, q, M), dtype=torch.int64, device=dev)
           if state == "compressed" else
           torch.zeros((w, q, cnl + 2, M), dtype=torch.int32, device=dev))
    unsat = torch.zeros(w, dtype=torch.int64, device=dev)
    first = torch.zeros(w, dtype=torch.int32, device=dev)
    tile = torch.from_numpy(tile_index(segments, w, exit_tile)).to(dev)
    n_tiles = int(tile.max()) + 1 if w else 0
    done = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    for it in range(max_iters):
        act = torch.nonzero(~done[tile]).squeeze(1)
        if act.numel() == 0:
            break
        la, pa, ca = lam[act], par[act], c2v[act]
        u = _sweep(la, pa, ca, tabs)
        lam[act], par[act], c2v[act], unsat[act] = la, pa, ca, u
        newly = (first[act] == 0) & (u == 0)
        first[act] = torch.where(newly, it + 1, first[act])
        dirty = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
        dirty.index_add_(0, tile[act], u)
        done |= torch.zeros_like(done).index_fill_(0, tile[act], True) \
            & (dirty == 0)
    hard = (lam < 0).reshape(w, k).to(torch.int8)
    ok = unsat == 0
    iters = torch.where(ok, first, max_iters).to(torch.int32)
    clean = None if bch_h is None else syndrome_flags(hard, bch_h)
    return hard, ok, iters, clean


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------
class LayeredDecoder:
    """decode(llr int8 [W, N], segments=None) -> (packed uint8 [W, k / 8],
    ok [W] bool, iters [W] int32, clean [W] bool or None).

    ``packed`` is the hard bits of the information part, MSB first per
    byte (np.packbits order): the BB frame with its BCH parity.  The tiles
    of the early exit count 128 codewords from the start of each segment
    (``segments``: the codeword counts of the Pallas calls this call
    stands for; None, one).  On a CUDA tensor it launches
    ``ldpc_layered.cu`` (or raises), and ``packed`` is a view of rows
    padded to 16 bytes; on a CPU tensor it runs :func:`decode_plain` with
    the same tiles and packs its bits with ``bch_ops.pack_bits``.
    ``launches`` counts the decoder kernel's launches (a call on the card
    makes :func:`decoder_passes` of them, one), ``screen_launches`` those
    of the BCH screen kernel behind it, one a call when ``bch_h`` is
    given.  A device on which fewer decoder blocks fit at once than a
    tile has codewords (:meth:`resident_blocks`) is refused: the call
    raises.
    """

    launches = 0
    screen_launches = 0

    def __init__(self, table_name: str, max_iters: int = 15,
                 bch_h: np.ndarray | None = None):
        if max_iters < 1:
            raise ValueError(f"max_iters must be at least 1, got {max_iters}")
        self.table_name = table_name
        self.max_iters = int(min(max_iters, 127))
        self.plan = plan = get_plan(table_name)
        self.bch_h = bch_h
        g_tab, s_tab, cnt, _ = _build_tables(plan)
        self.uniform = bool((cnt == plan.cnl).all())
        nfirst, sync = _row_info(g_tab, cnt)
        # per slot (its group's first posterior, shift); per row its counts
        self._host_tabs = (
            np.stack([g_tab * M, s_tab], axis=-1).astype(np.int32),
            (cnt | nfirst << 8 | sync << 16).astype(np.int32))
        if bch_h is not None and bch_h.shape[0] != plan.k:
            raise ValueError(f"bch_h must have {plan.k} rows, one per "
                             f"information bit, got {bch_h.shape}")
        self._dev = {}
        self._tiles = {}

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory of one block of the decoder kernel:
        posteriors and row tables (as the C entry point sizes it).  The
        check state is not in it: each thread keeps its lane's words in
        local memory."""
        plan = self.plan
        return -(-plan.n // 16) * 16 + plan.q * plan.cnl * 8 + plan.q * 4

    def _device_tabs(self, device):
        if device not in self._dev:
            h = (pack_bch_h(self.bch_h) if self.bch_h is not None
                 else np.zeros((0, packed_row_bytes(self.plan.k) // 4),
                               np.uint32))
            self._dev[device] = tuple(
                torch.as_tensor(a, device=device)
                for a in (*self._host_tabs, h.view(np.int32)))
        return self._dev[device]

    def _device_tiles(self, starts: list, device):
        key = (tuple(starts), device)
        if key not in self._tiles:
            self._tiles[key] = torch.tensor(starts, dtype=torch.int32,
                                            device=device)
        return self._tiles[key]

    def resident_blocks(self) -> int:
        """Decoder blocks of this table that fit the current card at once
        (the persistent grid of a call is the smaller of this and W);
        builds the kernel."""
        from ._build import load_kernel
        plan = self.plan
        n = load_kernel("ldpc_layered").ldpc_layered_capacity(
            plan.k, plan.q, plan.cnl, int(self.uniform))
        if n < 0:
            raise RuntimeError(f"no decoder kernel for {self.table_name} on "
                               f"this device (code {n})")
        return n

    def __call__(self, llr: torch.Tensor, segments=None):
        plan = self.plan
        if llr.dtype != torch.int8 or llr.dim() != 2 or llr.shape[1] != plan.n:
            raise ValueError(f"llr must be int8 [W, {plan.n}], got "
                             f"{llr.dtype} {tuple(llr.shape)}")
        if llr.device.type == "cpu":
            from .bch_ops import pack_bits
            hard, ok, iters, clean = decode_plain(
                llr, self.table_name, self.max_iters, self.bch_h,
                exit_tile=TILE, segments=segments)
            return pack_bits(hard), ok, iters, clean
        if llr.device.type != "cuda":
            raise ValueError(f"unsupported device {llr.device}")
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        return self._launch(llr, segments)

    def _launch(self, llr, segments):
        from ._build import load_kernel
        lib = load_kernel("ldpc_layered")
        plan = self.plan
        w, dev = llr.shape[0], llr.device
        slot_tab, row_tab, h = self._device_tabs(dev)
        tiles = self._device_tiles(tile_starts(segments, w), dev)
        screen = self.bch_h is not None
        packed = torch.empty((w, packed_row_bytes(plan.k)), dtype=torch.uint8,
                             device=dev)
        ok = torch.empty(w, dtype=torch.int8, device=dev)
        iters = torch.empty(w, dtype=torch.int32, device=dev)
        clean = torch.empty(w, dtype=torch.int8, device=dev)
        scratch = torch.empty(
            lib.ldpc_layered_scratch_words(w, tiles.numel() - 1,
                                           self.max_iters),
            dtype=torch.int32, device=dev)
        p = ctypes.c_void_p
        err = lib.ldpc_layered_decode(
            p(llr.data_ptr()), p(packed.data_ptr()), packed.shape[1] // 4,
            p(ok.data_ptr()), p(iters.data_ptr()), p(clean.data_ptr()),
            p(scratch.data_ptr()), p(tiles.data_ptr()), tiles.numel() - 1,
            p(slot_tab.data_ptr()), p(row_tab.data_ptr()), p(h.data_ptr()),
            h.shape[0], w, plan.k, plan.q, plan.cnl, int(self.uniform),
            self.max_iters, p(torch.cuda.current_stream(dev).cuda_stream))
        if err != 0:
            raise RuntimeError(
                f"ldpc_layered_decode({self.table_name}, W={w}) failed: CUDA "
                f"error {err} ({lib.last_error_string(err).decode()}) "
                f"{lib.last_error_detail().decode()}")
        LayeredDecoder.launches += lib.ldpc_layered_passes()
        LayeredDecoder.screen_launches += int(screen)
        return (packed[:, :plan.k // 8], ok.bool(), iters,
                clean.bool() if screen else None)
