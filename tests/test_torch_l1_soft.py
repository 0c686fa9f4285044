"""The L1 soft path of the port: the flooding min-sum decoder
(ops/ldpc_decode.make_decoder) bit-exact against the JAX package's on
integer-valued LLRs (float32 sums of integers are exact in any order), and
the L1-pre / L1-post soft FEC (ops/l1_soft.py) decoding the same bits as
the JAX package's.
"""
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one torch thread per worker)
from sdr_receiver_dvb_t2_tpu.ops import l1_soft as jl1
from sdr_receiver_dvb_t2_tpu.ops import ldpc_decode as jdec
from sdr_receiver_dvb_t2_tpu_torch.ops import l1_soft, ldpc_decode
from sdr_receiver_dvb_t2_tpu_torch.params import l1_fec, ldpc, qam
from sdr_receiver_dvb_t2_tpu_torch.params.modes import Constellation


def _llrs(table, seed):
    """Integer LLRs [8, N] in natural bit order: two clean codewords, four
    noisy ones from easy to marginal, one with saturated wrong bits, one
    hopeless."""
    code = ldpc.get_code(table)
    rng = np.random.default_rng(seed)
    cw = code.encode(rng.integers(0, 2, (8, code.k), dtype=np.uint8))
    llr = (1 - 2 * cw.astype(np.float32)) * 12.0
    sig = np.array([0, 0, 3.0, 5.0, 6.5, 8.0, 0, 0])[:, None]
    llr += rng.normal(0.0, 1.0, llr.shape) * sig
    llr[6] *= 127 / 12.0
    flip = rng.choice(code.n, 8, replace=False)
    llr[6, flip] = -llr[6, flip]
    llr[7] = rng.normal(0.0, 20.0, code.n)
    return np.round(llr).clip(-127, 127).astype(np.float32), cw


@pytest.mark.parametrize("table", ["SHORT_C1_4", "SHORT_C1_2"])
@pytest.mark.parametrize("max_iters", [6, 30])
def test_flooding_decoder_bit_exact_against_jax(table, max_iters):
    llr, cw = _llrs(table, seed=len(table) + max_iters)
    hard, ok, iters = ldpc_decode.make_decoder(table, max_iters)(
        torch.from_numpy(llr))
    jhard, jok, jiters = jdec.make_decoder(table, max_iters)(llr)
    assert hard.dtype == torch.int8 and iters.dtype == torch.int32
    np.testing.assert_array_equal(hard.numpy(), np.asarray(jhard))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    # the clean pair decodes in no sweep, the hopeless one never
    assert ok[:2].all() and (iters[:2] == 0).all()
    assert not ok[7] and iters[7] == max_iters
    assert (hard[ok.numpy()].numpy() == cw[ok.numpy()]).all()


def test_flooding_decoder_leaves_when_all_are_clean():
    """No sweep runs once every codeword checks: one codeword at a time
    reports its own first clean sweep."""
    llr, _ = _llrs("SHORT_C1_2", seed=3)
    dec = ldpc_decode.make_decoder("SHORT_C1_2", 30)
    _, _, iters = dec(torch.from_numpy(llr[2:6]))
    for i in range(2, 6):
        _, ok, it = dec(torch.from_numpy(llr[i:i + 1]))
        assert bool(ok[0]) and int(it[0]) == int(iters[i - 2])


def _bpsk_llr(bits, snr_db, rng, scale=24.0):
    x = 1.0 - 2.0 * bits.astype(np.float32)
    y = x + 10 ** (-snr_db / 20) * rng.standard_normal(len(x)).astype(
        np.float32)
    return y * scale, (y < 0).astype(np.uint8)


@pytest.mark.parametrize("snr_db", [5.0, 8.0])
def test_l1_pre_fec_decodes_the_same_bits(snr_db):
    rng = np.random.default_rng(4)
    info = rng.integers(0, 2, 200).astype(np.uint8)
    llr, hard = _bpsk_llr(l1_fec.encode_l1_pre(info), snr_db, rng)
    got = l1_soft.decode_l1_pre_fec(llr, device="cpu")
    want = jl1.decode_l1_pre_fec(llr)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, info)
    if snr_db == 5.0:               # where the hard slice is already wrong
        assert (l1_fec.decode_l1_pre_systematic(hard) != info).any()


def test_l1_pre_fec_flags_garbage_alike():
    llr = np.random.default_rng(9).normal(0, 24, l1_fec.L1_PRE_TX_BITS
                                          ).astype(np.float32)
    assert l1_soft.decode_l1_pre_fec(llr, device="cpu") is None
    assert jl1.decode_l1_pre_fec(llr) is None


@pytest.mark.parametrize("l1_post_mod,const,snr_db", [
    (1, Constellation.QPSK, 6.0), (2, Constellation.QAM16, 12.0)])
def test_l1_post_fec_decodes_the_same_bits(l1_post_mod, const, snr_db):
    rng = np.random.default_rng(6)
    k_sig = 350
    info = rng.integers(0, 2, k_sig).astype(np.uint8)
    coded = l1_fec.encode_l1_post(info, l1_post_mod=l1_post_mod, n_p2=1)
    cells = qam.map_bits(coded, const)
    noisy = cells + 10 ** (-snr_db / 20) * (
        rng.standard_normal(len(cells))
        + 1j * rng.standard_normal(len(cells))) / np.sqrt(2)
    llr_stream = l1_soft.cell_llrs(noisy, l1_post_mod)
    np.testing.assert_array_equal(llr_stream,
                                  jl1.cell_llrs(noisy, l1_post_mod))
    llr_coded = l1_fec.undo_l1_post_interleave_soft(llr_stream, l1_post_mod)
    got = l1_soft.decode_l1_post_fec(llr_coded, k_sig, device="cpu")
    want = jl1.decode_l1_post_fec(llr_coded, k_sig)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, info)


def test_soft_path_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        l1_soft.decode_l1_pre_fec(np.zeros(l1_fec.L1_PRE_TX_BITS,
                                           np.float32))
