"""The compressed check state of the port's layered LDPC decoder, on the CPU.

The CUDA kernel keeps one word per check (min1, min2, argmin, one sign bit
per slot) instead of the cnl + 2 messages.  Its plain form lives in
ops/ldpc.py (``compress_row`` / ``expand_row``) and the twin
``decode_plain`` runs on either form.  Everything here is exact
(tolerance 0): integers in, integers out.
"""
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, ldpc
from sdr_receiver_dvb_t2_tpu_torch.ops.ldpc_decode import get_plan
from sdr_receiver_dvb_t2_tpu_torch.params import ldpc as ldpc_par

import _torch_common  # noqa: F401  (pins torch to one thread per worker)

TABLES = ["NORMAL_C1_2", "NORMAL_C3_5", "NORMAL_C2_3", "NORMAL_C3_4",
          "NORMAL_C4_5", "NORMAL_C5_6", "SHORT_C1_4", "SHORT_C1_2",
          "SHORT_C3_5", "SHORT_C2_3", "SHORT_C3_4", "SHORT_C4_5",
          "SHORT_C5_6", "B8", "B9"]
WIDE = {"NORMAL_C4_5", "NORMAL_C5_6", "SHORT_C5_6"}
M = ldpc.M
# edge values of the algebra: posterior clip, message clip (asymmetric),
# the channel clamp, zero, and +-1 (offset magnitude 0, like zero)
EDGE_VALUES = np.array([-127, 127, -32, 32, 31, -31, 33, -33, 0, 1, -1, 56,
                        -56, 2, -2])


def _tabs(table):
    plan = get_plan(table)
    g_tab, s_tab, cnt, rmw = ldpc._build_tables(plan)
    return plan, (g_tab, s_tab, cnt, set(rmw), bool((cnt == plan.cnl).all()))


def _posteriors(plan, seed):
    """Three codewords of posteriors: one drawn half from EDGE_VALUES (ties
    of the two minima everywhere) and half from +-127, one of large values
    only (every message saturates, at 31 or at -32), one uniform."""
    rng = np.random.default_rng(seed)
    shape = (3, plan.g_data + plan.q, M)
    x = np.where(rng.random(shape) < 0.5, rng.choice(EDGE_VALUES, shape),
                 rng.integers(-127, 128, shape))
    x[1] = rng.choice([-127, 127, -90, 90, -60, 60], shape[1:])
    x[2] = rng.integers(-127, 128, shape[1:])
    x = torch.from_numpy(x.astype(np.int32))
    return x[:, :plan.g_data].clone(), x[:, plan.g_data:].clone()


def _two_states(plan, a):
    c = plan.cnl + 2
    return (torch.zeros((a, plan.q, c, M), dtype=torch.int32),
            torch.zeros((a, plan.q, M), dtype=torch.int64))


@pytest.mark.parametrize("table", TABLES)
def test_expand_of_compress_is_the_explicit_row(table):
    """Two sweeps on edge-heavy posteriors, once on explicit messages and
    once on compressed words: after each, every row's expanded word equals
    its explicit messages, and the posteriors agree."""
    plan, tabs = _tabs(table)
    lam_e, par_e = _posteriors(plan, seed=TABLES.index(table))
    lam_c, par_c = lam_e.clone(), par_e.clone()
    explicit, words = _two_states(plan, lam_e.shape[0])
    cnt = tabs[2]
    for sweep in range(2):
        u_e = ldpc._sweep(lam_e, par_e, explicit, tabs)
        u_c = ldpc._sweep(lam_c, par_c, words, tabs)
        assert torch.equal(u_e, u_c)
        assert torch.equal(lam_e, lam_c) and torch.equal(par_e, par_c)
        for i in range(plan.q):
            got = ldpc.expand_row(words[:, i], plan.cnl + 2, ldpc.slot_mask(
                i, int(cnt[i]), plan.cnl))
            assert torch.equal(got, explicit[:, i]), (sweep, i)
    # the edges were reached: saturated messages of both signs, and zeros
    assert explicit.max() == 31 and explicit.min() == -32
    assert (explicit == 0).any()


def _noisy_codewords(table, seed):
    """int8 LLRs in kernel bit order: noise-free, noisy, hopeless."""
    code = ldpc_par.get_code(table)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (3, code.k), dtype=np.uint8)
    cw = np.stack([code.encode(b) for b in bits]).astype(np.float32)
    llr = (1 - 2 * cw) * 12.0
    llr[1] += rng.normal(0.0, 5.0, code.n)
    llr[2] = rng.normal(0.0, 20.0, code.n)
    llr = llr[:, ldpc.kernel_bit_order(table)]
    return torch.from_numpy(llr.round().clip(-127, 127).astype(np.int8))


@pytest.mark.parametrize("table", TABLES)
def test_compressed_twin_equals_explicit_twin(table):
    llr = _noisy_codewords(table, seed=100 + TABLES.index(table))
    max_iters = 3 if table.startswith("NORMAL") else 8
    want = ldpc.decode_plain(llr, table, max_iters, state="explicit")
    got = ldpc.decode_plain(llr, table, max_iters, state="compressed")
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert got[3] is None and want[3] is None
    ok, iters = got[1].tolist(), got[2].tolist()
    assert ok[0] and iters[0] == 1            # noise-free: one sweep
    assert not ok[2] and iters[2] == max_iters   # hopeless: all of them


def test_compressed_twin_keeps_the_bch_screen():
    table, k_bch, m, t = "SHORT_C2_3", 10632, 14, 12
    h = bch_ops._h_matrix(k_bch, m, t)
    llr = _noisy_codewords(table, seed=5)
    want = ldpc.decode_plain(llr, table, 6, h, state="explicit")
    got = ldpc.decode_plain(llr, table, 6, h, state="compressed")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("table", TABLES)
def test_state_word_holds_its_fields(table):
    """17 + cnl + 2 bits fit the chosen width, 64 bits are taken only where
    32 do not do, and the largest word a row can produce stays inside."""
    cnl = get_plan(table).cnl
    bits = ldpc.state_word_bits(cnl)
    assert bits in (32, 64)
    assert 17 + cnl + 2 <= bits
    assert (bits == 64) == (table in WIDE) == (17 + cnl + 2 > 32)
    big = torch.full((1, M), 30000)
    word = ldpc.compress_row(big, big, torch.full((1, M), cnl + 1),
                             torch.ones((1, cnl + 2, M), dtype=torch.bool))
    assert 0 < int(word.max()) < 2 ** (17 + cnl + 2)


@pytest.mark.parametrize("cnl", [2, 8, 13, 20])
def test_zero_word_is_the_zero_row(cnl):
    word = torch.zeros((3, M), dtype=torch.int64)
    assert not ldpc.expand_row(word, cnl + 2).any()
    none = torch.zeros((3, cnl + 2, M), dtype=torch.bool)
    zero = torch.zeros((3, M), dtype=torch.int32)
    assert not ldpc.compress_row(zero, zero, zero, none).any()


@pytest.mark.parametrize("table", ["SHORT_C1_4", "SHORT_C2_3", "NORMAL_C2_3",
                                   "SHORT_C5_6"])
def test_wrapped_lane_of_row_0_expands_to_zero(table):
    """Check (row 0, lane 0) has no previous parity bit: its staircase slot
    carries no message in either form, although the check's other slots
    do."""
    plan, tabs = _tabs(table)
    lam, par = _posteriors(plan, seed=3)
    lam, par = lam.clamp(min=5), par.clamp(min=5)     # no zero magnitudes
    explicit, words = _two_states(plan, lam.shape[0])
    ldpc._sweep(lam.clone(), par.clone(), explicit, tabs)
    ldpc._sweep(lam, par, words, tabs)
    cnl = plan.cnl
    mask = ldpc.slot_mask(0, int(tabs[2][0]), cnl)
    got = ldpc.expand_row(words[:, 0], cnl + 2, mask)
    assert not got[:, cnl + 1, 0].any() and not explicit[:, 0, cnl + 1, 0].any()
    assert got[:, cnl + 1, 1:].all() and got[:, cnl, 0].all()
    assert not mask[cnl + 1, 0] and mask[cnl + 1, 1:].all()
    assert ldpc.slot_mask(1, int(tabs[2][1]), cnl)[cnl + 1].all()


@pytest.mark.parametrize("m1,m2,neg,want", [
    (40, 50, False, 31), (40, 50, True, -32), (32, 32, False, 31),
    (32, 33, True, -32), (31, 40, True, -31), (31, 40, False, 31),
    (0, 7, True, 0), (5, 9, True, -5), (30000, 30000, False, 31)])
def test_clip_is_exact_under_the_cap(m1, m2, neg, want):
    """min(m, 32) keeps the message: clip(+-m, -32, 31) saturates at 31 on
    one side and at -32 on the other."""
    shape = (1, M)
    negs = torch.full((1, 4, M), neg)
    word = ldpc.compress_row(torch.full(shape, m1), torch.full(shape, m2),
                             torch.full(shape, 2), negs)
    msg = ldpc.expand_row(word, 4)
    ref = lambda mag: int(np.clip(-mag if neg else mag, -32, 31))
    assert (msg[:, [0, 1, 3]] == want).all() and want == ref(m1)
    assert (msg[:, 2] == ref(m2)).all()       # the argmin slot carries m2


@pytest.mark.parametrize("table", TABLES)
def test_row_schedule(table):
    """nfirst: the slots before it are first occurrences of their group,
    those from it on are repeats.  sync: rows between two marks share no
    variable group, so they can run without a barrier between them."""
    plan, (g_tab, _, cnt, rmw, _) = _tabs(table)
    nfirst, sync = ldpc._row_info(g_tab, cnt)
    assert sync[0] == 1 and sync[plan.q - 1] == 1   # the staircase wrap
    tail = set()
    run = set()
    for i in range(plan.q):
        groups = g_tab[i, :cnt[i]].tolist()
        assert len(set(groups[:nfirst[i]])) == nfirst[i]
        assert all(g in groups[:slot] for slot, g in enumerate(groups)
                   if slot >= nfirst[i])
        tail.update(range(nfirst[i], cnt[i]))
        if sync[i]:
            run = set()
        assert not run & set(groups)
        run |= set(groups)
    assert tail == rmw


@pytest.mark.parametrize("table", TABLES)
def test_block_sizes(table):
    """A block's shared memory (posteriors and row tables) fits the 227 KB
    a Hopper block may take, three times over for the flagship's table;
    the compressed state is no larger than the explicit messages."""
    dec = ldpc.LayeredDecoder(table)
    plan = dec.plan
    assert plan.n <= dec.shared_bytes <= plan.n + 16 + plan.q * (8 * plan.cnl + 4)
    assert dec.shared_bytes <= 232448
    state_bytes = plan.q * M * ldpc.state_word_bits(plan.cnl) // 8
    if table == "NORMAL_C2_3":
        assert 3 * (dec.shared_bytes + 1024) <= 233472
        assert state_bytes == 86400
    assert state_bytes <= plan.q * (plan.cnl + 2) * M


@pytest.mark.parametrize("bad", [0, -3])
def test_wrapper_rejects_no_sweeps(bad):
    with pytest.raises(ValueError):
        ldpc.LayeredDecoder("SHORT_C1_2", max_iters=bad)


def test_wrapper_rejects_a_bch_matrix_of_another_code():
    with pytest.raises(ValueError):
        ldpc.LayeredDecoder("SHORT_C1_2", bch_h=np.zeros((100, 168), np.uint8))


def test_twin_rejects_unknown_state():
    with pytest.raises(ValueError):
        ldpc.decode_plain(torch.zeros((1, 16200), dtype=torch.int8),
                          "SHORT_C1_2", 1, state="packed")
