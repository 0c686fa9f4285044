"""The port's layered LDPC decoder against the Pallas kernel (interpret mode).

The plain PyTorch twin (ops/ldpc.decode_plain) with ``exit_tile=128`` must
be bit-exact against ``make_pallas_decoder(..., interpret=True)`` on hard
bits, ok, iters and the fused BCH clean flag, on the cases of
tests/test_ldpc_pallas_interpret.py.  The edge tables, the kernel bit order
and the kernel's packed BCH screen are held against the JAX package too.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.ops import bch_ops as jbch
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas
from sdr_receiver_dvb_t2_tpu.params import bch as bch_par
from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, ldpc
from sdr_receiver_dvb_t2_tpu_torch.ops.ldpc_decode import get_plan

from _torch_common import LDPC_CASES, LDPC_W as W, ldpc_case


def _pallas(table, x, max_iters, bch_h):
    dec = ldpc_pallas.make_pallas_decoder(table, batch=W, n_tiles=1,
                                          max_iters=max_iters,
                                          interpret=True, bch_h=bch_h)
    out = dec(jnp.asarray(np.ascontiguousarray(x.T)))
    hard, ok, iters = (np.asarray(out[0]).T, np.asarray(out[1]),
                       np.asarray(out[2]))
    clean = np.asarray(out[3]) if bch_h is not None else None
    return hard, ok, iters, clean


@pytest.mark.parametrize("name", LDPC_CASES)
def test_twin_matches_pallas_interpret(name):
    table, x, max_iters, bch_h, n_cw = ldpc_case(name)
    want = _pallas(table, x, max_iters, bch_h)
    got = ldpc.decode_plain(torch.from_numpy(x), table, max_iters, bch_h,
                            exit_tile=W)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    if bch_h is not None:
        np.testing.assert_array_equal(got[3].numpy(), want[3])
        assert want[3][:2].all() and not want[3][2]
    assert want[1][:n_cw].all() == (name != "BCH")


def test_kernel_bch_layout_matches_plain_screen():
    """The kernel's epilogue: hard bits packed 32 to a word (bit b of word w
    = bit 32w+b) against H rows packed the same way (pack_bch_h); syndrome
    bit = parity of the popcount of their AND.  Emulated in numpy, it must
    equal the plain screen on clean and dirty words, with k not a multiple
    of 32 (SHORT r2/3: k = 10800)."""
    rng = np.random.default_rng(11)
    k_bch, m, t = 10632, 14, 12
    h = jbch._h_matrix(k_bch, m, t)
    assert h.shape[0] % 32 != 0
    payload = rng.integers(0, 2, (4, k_bch), dtype=np.uint8)
    cw = np.stack([bch_par.encode(p, m) for p in payload]).astype(np.int8)
    cw[1, 17] ^= 1
    cw[3, 5000] ^= 1
    words = -(-cw.shape[1] // 32)
    padded = np.zeros((4, words * 32), np.uint64)
    padded[:, :cw.shape[1]] = cw
    hbits = (padded.reshape(4, words, 32)
             << np.arange(32, dtype=np.uint64)).sum(-1)
    hp = ldpc.pack_bch_h(h).astype(np.uint64)          # [n_syn, words]
    anded = hbits[:, None, :] & hp[None]
    pop = np.vectorize(lambda v: bin(int(v)).count("1"))(anded).sum(-1)
    emulated = ~(pop & 1).astype(bool).any(-1)
    plain = bch_ops.syndrome_flags(torch.from_numpy(cw), h).numpy()
    np.testing.assert_array_equal(emulated, plain)
    np.testing.assert_array_equal(plain, [True, False, True, False])


@pytest.mark.parametrize("table", [
    "NORMAL_C1_2", "NORMAL_C3_5", "NORMAL_C2_3", "NORMAL_C3_4", "NORMAL_C4_5",
    "NORMAL_C5_6", "SHORT_C1_4", "SHORT_C1_2", "SHORT_C3_5", "SHORT_C2_3",
    "SHORT_C3_4", "SHORT_C4_5", "SHORT_C5_6", "B8", "B9"])
def test_tables_match_jax(table):
    """The slot order of every table: the kernel's state word keeps one
    sign bit per slot in this order."""
    ours, theirs = get_plan(table), ldpc_pallas.get_plan(table)
    assert ours.edges_by_row == theirs.edges_by_row
    for a, b in zip(ldpc._build_tables(ours), ldpc_pallas._build_tables(theirs)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ldpc.kernel_bit_order(table),
                                  ldpc_pallas.kernel_bit_order(table))


