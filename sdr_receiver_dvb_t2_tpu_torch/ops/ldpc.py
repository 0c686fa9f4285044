"""Layered offset-min-sum LDPC decoder with the fused BCH syndrome screen.

Counterpart of the JAX package's Pallas kernel (``ops/ldpc_pallas.py``):
the same message algebra on the DVB-T2 QC-IRA codes, in two forms that
compute the same function:

* ``ops/csrc/ldpc_layered.cu``: the CUDA kernel (one thread block per
  codeword), launched by :class:`LayeredDecoder` on a CUDA tensor;
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

Early exit contract.  The Pallas kernel leaves its sweep loop once every
codeword of its 128-codeword tile is clean.  CUDA blocks cannot wait on
each other, so the kernel exits per codeword.  The twin takes
``exit_tile``: ``exit_tile=1`` matches the CUDA kernel, ``exit_tile=128``
matches Pallas.  ``iters`` (the first clean sweep) is the same under both;
``ok`` and the hard bits can differ only when a codeword that was already
clean changes in a later sweep of its tile.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .ldpc_decode import get_plan

M = 360
_BIG = 30000
_CLAMP = 56
_THREADS = 384
_TILE_SLOTS = (8, 12, 20)       # kernel template sizes for the data slots


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


def pad_bch_h(bch_h: np.ndarray) -> np.ndarray:
    """[n_bch, n_syn_bits] GF(2) parity-check matrix -> the transposed
    layout [n_syn padded to 8, n_bch] float32."""
    n_syn = -(-bch_h.shape[1] // 8) * 8
    h_pad = np.zeros((n_syn, bch_h.shape[0]), np.float32)
    h_pad[:bch_h.shape[1]] = np.asarray(bch_h, np.float32).T
    return h_pad


def pack_bch_h(bch_h: np.ndarray) -> np.ndarray:
    """[n_bch, n_syn] GF(2) matrix -> the kernel's packed rows
    [n_syn, ceil(n_bch / 32)] uint32: bit b of word w is codeword bit
    32 * w + b of the syndrome row."""
    h = np.asarray(bch_h).astype(bool).T                 # [n_syn, n_bch]
    words = -(-h.shape[1] // 32)
    padded = np.zeros((h.shape[0], words * 32), bool)
    padded[:, :h.shape[1]] = h
    bits = padded.reshape(h.shape[0], words, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


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
    par [A, q, M], c2v [A, q, C, M] int32.  Returns unsat [A]."""
    g_tab, s_tab, cnt, rmw, uniform = tabs
    q, cnl = g_tab.shape
    a = lam.shape[0]
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
        ts = {}
        # ---------------- pass 1: gather, mins, signs ----------------
        for slot in range(n_slots):
            g, s = int(g_tab[i, slot]), int(s_tab[i, slot])
            slab = torch.roll(lam[:, g], s, dims=-1)
            t = slab - c2v[:, i, slot]
            if not uniform:
                syn ^= slab < 0
            spar ^= t < 0
            m1, m2, idx = take_min(m1, m2, idx,
                                   torch.clamp(t.abs() - 1, min=0), slot)
            ts[slot] = t
        p_self = par[:, i]
        t = p_self - c2v[:, i, cnl]
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
        t = p_prev - c2v[:, i, cnl + 1]
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
            out_neg = spar ^ (t < 0)
            return t, torch.clamp(torch.where(out_neg, -mag_out, mag_out),
                                  -32, 31)

        for slot in range(n_slots):
            t, msg = emit(slot)
            g, s = int(g_tab[i, slot]), int(s_tab[i, slot])
            if slot in rmw:
                # a later duplicate of a group already updated this row:
                # accumulate via the posterior (delta form)
                upd = lam[:, g] + torch.roll(msg - c2v[:, i, slot], -s, dims=-1)
                upd = torch.clamp(upd, -127, 127)
                lam[:, g] = upd
                sign = torch.roll(upd, s, dims=-1) < 0
            else:
                # fused write in the rolled domain: lam + msg - old = t + msg
                upd = torch.clamp(t + msg, -127, 127)
                lam[:, g] = torch.roll(upd, -s, dims=-1)
                sign = upd < 0
            c2v[:, i, slot] = msg
            if uniform:
                syn ^= sign
        t, msg = emit(cnl)
        upd_self = torch.clamp(t + msg, -127, 127)
        par[:, i] = upd_self
        c2v[:, i, cnl] = msg
        if uniform:
            syn ^= upd_self < 0
        t, msg = emit(cnl + 1)
        upd_prev = torch.clamp(t + msg, -127, 127)
        if valid_prev is None:
            par[:, ip] = upd_prev
            c2v[:, i, cnl + 1] = msg
            if uniform:
                syn ^= upd_prev < 0
        else:
            # the wrapped lane 0 of row 0 keeps its value
            par[:, ip] = torch.roll(torch.where(valid_prev, upd_prev,
                                                p_prev_roll1), -1, dims=-1)
            c2v[:, i, cnl + 1] = torch.where(valid_prev, msg, 0)
            if uniform:
                syn ^= valid_prev & (upd_prev < 0)
        unsat += syn.sum(dim=-1)
    return unsat


def decode_plain(llr: torch.Tensor, table_name: str, max_iters: int = 15,
                 bch_h: np.ndarray | None = None, exit_tile: int = 1):
    """Plain PyTorch layered decoder.

    llr int8 [W, N] in kernel bit order (positive = bit 0) -> (hard [W, k]
    int8, ok [W] bool, iters [W] int32, clean [W] bool or None).
    ``exit_tile`` codewords leave the sweep loop together (see the module
    docstring); ``clean`` is the BCH syndrome screen when ``bch_h`` is given.
    """
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
    c2v = torch.zeros((w, q, cnl + 2, M), dtype=torch.int32, device=dev)
    unsat = torch.zeros(w, dtype=torch.int64, device=dev)
    first = torch.zeros(w, dtype=torch.int32, device=dev)
    tile = torch.arange(w, device=dev) // exit_tile
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
    """decode(llr int8 [W, N]) -> (hard [W, k] int8, ok [W] bool,
    iters [W] int32, clean [W] bool or None).

    On a CUDA tensor it launches ``ldpc_layered.cu`` (or raises); on a CPU
    tensor it runs :func:`decode_plain` with ``exit_tile=1``, which is what
    the kernel computes.  ``launches`` counts kernel launches.
    """

    launches = 0

    def __init__(self, table_name: str, max_iters: int = 15,
                 bch_h: np.ndarray | None = None):
        self.table_name = table_name
        self.max_iters = int(min(max_iters, 127))
        self.plan = plan = get_plan(table_name)
        self.bch_h = bch_h
        g_tab, s_tab, cnt, rmw = _build_tables(plan)
        self.uniform = bool((cnt == plan.cnl).all())
        self.rmw_mask = sum(1 << s for s in rmw)
        self._host_tabs = (g_tab, s_tab, cnt)
        if bch_h is not None:
            assert bch_h.shape[0] == plan.k, (bch_h.shape, plan.k)
        self._dev = {}

    def _device_tabs(self, device):
        if device not in self._dev:
            g_tab, s_tab, cnt = self._host_tabs
            h = (pack_bch_h(self.bch_h) if self.bch_h is not None
                 else np.zeros((0, 1), np.uint32))
            self._dev[device] = tuple(
                torch.as_tensor(a, device=device)
                for a in (g_tab, s_tab, cnt, h.view(np.int32)))
        return self._dev[device]

    def __call__(self, llr: torch.Tensor):
        plan = self.plan
        if llr.dtype != torch.int8 or llr.dim() != 2 or llr.shape[1] != plan.n:
            raise ValueError(f"llr must be int8 [W, {plan.n}], got "
                             f"{llr.dtype} {tuple(llr.shape)}")
        if llr.device.type == "cpu":
            return decode_plain(llr, self.table_name, self.max_iters,
                                self.bch_h, exit_tile=1)
        if llr.device.type != "cuda":
            raise ValueError(f"unsupported device {llr.device}")
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        return self._launch(llr)

    def _launch(self, llr):
        from ._build import load_kernel
        lib = load_kernel("ldpc_layered")
        plan = self.plan
        w, dev = llr.shape[0], llr.device
        g_tab, s_tab, cnt, h = self._device_tabs(dev)
        hard = torch.empty((w, plan.k), dtype=torch.int8, device=dev)
        c2v = torch.empty((w, plan.q, plan.cnl + 2, M), dtype=torch.int8,
                          device=dev)
        ok = torch.empty(w, dtype=torch.int8, device=dev)
        iters = torch.empty(w, dtype=torch.int32, device=dev)
        clean = torch.empty(w, dtype=torch.int8, device=dev)
        n_syn = h.shape[0] if self.bch_h is not None else 0
        p = ctypes.c_void_p
        err = lib.ldpc_layered_decode(
            p(llr.data_ptr()), p(hard.data_ptr()), p(c2v.data_ptr()),
            p(ok.data_ptr()), p(iters.data_ptr()), p(clean.data_ptr()),
            p(g_tab.data_ptr()), p(s_tab.data_ptr()), p(cnt.data_ptr()),
            p(h.data_ptr()), n_syn, h.shape[1],
            w, plan.k, plan.q, plan.cnl, int(self.uniform), self.rmw_mask,
            self.max_iters, p(torch.cuda.current_stream(dev).cuda_stream))
        if err != 0:
            raise RuntimeError(f"ldpc_layered_decode launch failed: CUDA "
                               f"error {err} ({lib.last_error_string(err)})")
        LayeredDecoder.launches += 1
        return (hard, ok.bool(), iters,
                clean.bool() if self.bch_h is not None else None)
