"""The port's deinterleave + soft demap (packed_to_llr) against the JAX
``packed_to_llr_t``, on synthetic equalized planes made from a seed.

The JAX stage reads its plane as bf16 pairs; the port reads complex64.  An
int8 LLR is round(x * precision) with precision up to 8 * norm * SNR, so
bf16's 2^-9 relative rounding of x moves an LLR by at most one step, and
only where x * precision sits near a rounding boundary: |diff| <= 1 on at
least 99.9% of the LLRs.  The SNR estimate averages the same rounding
away: within 0.05 dB.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.ops import cplx
from sdr_receiver_dvb_t2_tpu.ops import rx_chain as jrc
from sdr_receiver_dvb_t2_tpu_torch.ops import rx_chain

from _torch_common import FIXTURE_MODE, mode_pair, plp_pair

F = 2
L1_CELLS = 3000
# (plp spec, n_fec, n_ti): the fixture's 64QAM SHORT r2/3 decomposes into
# strided bit blocks; rotated 16QAM NORMAL r3/5 needs the bit_rows gather
PLPS = {
    "bit_blocks": (dict(constellation="QAM64", code_rate="C2_3",
                        fec_frame="SHORT", num_blocks_max=10,
                        time_il_length=3), 6, 3),
    "bit_rows": (dict(constellation="QAM16", code_rate="C3_5",
                      fec_frame="NORMAL", rotation=True, num_blocks_max=10,
                      time_il_length=1), 4, 1),
}


def _planes(tmode, tplp, seed=3, snr_db=20.0):
    """Random rotated-QAM points plus AWGN on every carrier [F, L, K]."""
    rng = np.random.default_rng(seed)
    side = 1 << (tplp.bits_per_cell // 2)
    shape = (F, tmode.frame_symbols, tmode.k_total)
    lv = lambda: (2 * rng.integers(0, side, shape) - (side - 1))
    x = (lv() + 1j * lv()) * tplp.norm_factor
    x = x * np.exp(1j * tplp.rotation_angle)
    sigma = np.sqrt(np.mean(np.abs(x) ** 2) / 10 ** (snr_db / 10) / 2)
    x = x + sigma * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))
    return x.astype(np.complex64)


@pytest.mark.parametrize("path", list(PLPS))
def test_packed_to_llr_matches_jax(path):
    spec, n_fec, n_ti = PLPS[path]
    jmode, tmode = mode_pair(FIXTURE_MODE)
    jplp, tplp = plp_pair(spec)
    plan = rx_chain.get_plan(tmode, tplp, n_fec, n_ti, L1_CELLS)
    jplan = jrc.get_plan(jmode, jplp, n_fec, n_ti, L1_CELLS)
    assert (plan.bit_blocks is not None) == (path == "bit_blocks")
    assert (jplan.bit_blocks is not None) == (path == "bit_blocks")
    x = _planes(tmode, tplp)
    packed = jrc._pack_bf16(cplx.C(jnp.asarray(x.real), jnp.asarray(x.imag)))
    want_llr, want_snr = jrc.packed_to_llr_t(packed, jplan,
                                             jplan.device_consts())
    want = np.asarray(want_llr).T                       # [W, N]
    llr, snr = rx_chain.packed_to_llr(torch.from_numpy(x), plan,
                                      plan.to_device("cpu"))
    llr = llr.numpy()
    assert llr.dtype == np.int8 and llr.shape == want.shape
    assert llr.shape == (F * n_fec, tplp.fec_size)
    diff = np.abs(llr.astype(np.int32) - want.astype(np.int32))
    assert np.mean(diff <= 1) >= 0.999, np.mean(diff <= 1)
    np.testing.assert_allclose(snr.numpy(), np.asarray(want_snr), atol=0.05)


def test_packed_to_llr_rounded_planes_agree_exactly():
    """Fed the very bf16 values the JAX stage reads, the port's gather,
    demap and bit order reproduce the JAX LLRs up to float summation order
    in the SNR estimate (which moves no LLR here)."""
    spec, n_fec, n_ti = PLPS["bit_blocks"]
    jmode, tmode = mode_pair(FIXTURE_MODE)
    jplp, tplp = plp_pair(spec)
    plan = rx_chain.get_plan(tmode, tplp, n_fec, n_ti, L1_CELLS)
    jplan = jrc.get_plan(jmode, jplp, n_fec, n_ti, L1_CELLS)
    x = _planes(tmode, tplp, seed=4)
    xr = (torch.from_numpy(x.real).to(torch.bfloat16).float().numpy()
          + 1j * torch.from_numpy(x.imag).to(torch.bfloat16).float().numpy())
    packed = jrc._pack_bf16(cplx.C(jnp.asarray(x.real), jnp.asarray(x.imag)))
    want, _ = jrc.packed_to_llr_t(packed, jplan, jplan.device_consts())
    llr, _ = rx_chain.packed_to_llr(torch.from_numpy(xr.astype(np.complex64)),
                                    plan, plan.to_device("cpu"))
    np.testing.assert_array_equal(llr.numpy(), np.asarray(want).T)
