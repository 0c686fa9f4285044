"""The port's layered LDPC decoder against the Pallas kernel (interpret mode).

The plain PyTorch twin (ops/ldpc.decode_plain) with ``exit_tile=128`` must
be bit-exact against ``make_pallas_decoder(..., interpret=True)`` on hard
bits, ok, iters and the fused BCH clean flag, on the cases of
tests/test_ldpc_pallas_interpret.py, and ``LayeredDecoder``'s bytes must be
``np.packbits`` of the Pallas hard bits.  The edge tables, the kernel bit
order and the kernel's BCH screen over the byte rows are held against the
JAX package too.
"""
import functools

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


@functools.lru_cache(maxsize=None)
def _pallas_case(name):
    table, x, max_iters, bch_h, _ = ldpc_case(name)
    return _pallas(table, x, max_iters, bch_h)


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
    want = _pallas_case(name)
    got = ldpc.decode_plain(torch.from_numpy(x), table, max_iters, bch_h,
                            exit_tile=W)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    if bch_h is not None:
        np.testing.assert_array_equal(got[3].numpy(), want[3])
        assert want[3][:2].all() and not want[3][2]
    assert want[1][:n_cw].all() == (name != "BCH")


@pytest.mark.parametrize("name", LDPC_CASES)
def test_wrapper_bytes_match_pallas(name):
    """The wrapper's output on a CPU tensor: the information bits as bytes,
    MSB first, equal to np.packbits of the Pallas hard bits, with its ok,
    iters and clean."""
    table, x, max_iters, bch_h, _ = ldpc_case(name)
    want = _pallas_case(name)
    dec = ldpc.LayeredDecoder(table, max_iters=max_iters, bch_h=bch_h)
    packed, ok, iters, clean = dec(torch.from_numpy(x))
    assert packed.dtype == torch.uint8
    assert packed.shape == (W, get_plan(table).k // 8)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.packbits(want[0].astype(np.uint8), 1))
    np.testing.assert_array_equal(ok.numpy(), want[1])
    np.testing.assert_array_equal(iters.numpy(), want[2])
    if bch_h is not None:
        np.testing.assert_array_equal(clean.numpy(), want[3])


@pytest.mark.parametrize("k_bch,m,t", [(10632, 14, 12), (43040, 16, 10),
                                       (3072, 14, 12)])
def test_kernel_bch_layout_matches_plain_screen(k_bch, m, t):
    """The screen kernel's arithmetic: the hard bits as the decoder writes
    them (bytes MSB first, rows zero-padded to 16 bytes) and H packed the
    same way (pack_bch_h), both read as 32-bit words; syndrome bit =
    parity of the popcount of their AND.  Emulated in numpy, it must equal
    the plain screen on clean and dirty words, with k / 8 not a multiple of
    4 (SHORT r2/3: 1350 bytes; SHORT r1/4: 405) and NORMAL r2/3's."""
    rng = np.random.default_rng(11)
    h = jbch._h_matrix(k_bch, m, t)
    k = h.shape[0]
    payload = rng.integers(0, 2, (4, k_bch), dtype=np.uint8)
    cw = np.stack([bch_par.encode(p, m, t) for p in payload]).astype(np.int8)
    cw[1, 17] ^= 1
    cw[3, k - 1] ^= 1
    row = ldpc.packed_row_bytes(k)
    assert row % 16 == 0 and row >= k // 8
    rows = np.zeros((4, row), np.uint8)
    rows[:, :k // 8] = np.packbits(cw.astype(np.uint8), axis=1)
    words = rows.view("<u4").astype(np.uint64)             # [4, row / 4]
    hp = ldpc.pack_bch_h(h).astype(np.uint64)              # [n_syn, row / 4]
    assert hp.shape == (h.shape[1], row // 4)
    # the parity of a sum of popcounts is that of the xor of the words
    acc = np.bitwise_xor.reduce(words[:, None, :] & hp[None], axis=-1)
    for s in (16, 8, 4, 2, 1):
        acc ^= acc >> np.uint64(s)
    emulated = ~(acc & np.uint64(1)).astype(bool).any(-1)
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


