"""The port's copied host tables against the JAX package's, and its device
plan (plan_from_numpy) against its own plan builder."""
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.models import transmitter as jtx
from sdr_receiver_dvb_t2_tpu.ops import bch_ops as jbch
from sdr_receiver_dvb_t2_tpu.ops import ldpc_decode as jldpc
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas
from sdr_receiver_dvb_t2_tpu.ops import rx_chain as jrc
from sdr_receiver_dvb_t2_tpu.params import bit_interleaver as jbi
from sdr_receiver_dvb_t2_tpu.params import freq_interleaver as jfi
from sdr_receiver_dvb_t2_tpu.params import pilots as jpil
from sdr_receiver_dvb_t2_tpu_torch.models import transmitter as ttx
from sdr_receiver_dvb_t2_tpu_torch.models.receiver import plan_from_numpy
from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, ldpc, rx_chain
from sdr_receiver_dvb_t2_tpu_torch.ops.ldpc_decode import get_plan
from sdr_receiver_dvb_t2_tpu_torch.params import bit_interleaver as tbi
from sdr_receiver_dvb_t2_tpu_torch.params import freq_interleaver as tfi
from sdr_receiver_dvb_t2_tpu_torch.params import pilots as tpil

from _torch_common import (FIXTURE_MODE, FIXTURE_PLP, FLAGSHIP_MODE,
                           FLAGSHIP_PLP, fixture_frames, jax_plan_arrays,
                           mode_pair, plp_pair)

CASES = {
    # (mode spec, plp spec, n_fec, n_ti, l1 cells)
    "fixture": (FIXTURE_MODE, FIXTURE_PLP, 6, 3, 3000),
    "flagship": (FLAGSHIP_MODE, FLAGSHIP_PLP, 202, 1, 3000),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pilots_and_frequency_interleaver(case):
    jmode, tmode = mode_pair(CASES[case][0])
    for l in range(tmode.frame_symbols):
        np.testing.assert_array_equal(tpil.reference_symbol(tmode, l),
                                      jpil.reference_symbol(jmode, l))
        didx = tpil.data_cell_indices(tmode, l)
        np.testing.assert_array_equal(didx, jpil.data_cell_indices(jmode, l))
        np.testing.assert_array_equal(
            tfi.tx_permutation(tmode, len(didx), l),
            jfi.tx_permutation(jmode, len(didx), l))


@pytest.mark.parametrize("case", list(CASES))
def test_bit_interleaver_ldpc_and_bch_tables(case):
    jplp, tplp = plp_pair(CASES[case][1])
    np.testing.assert_array_equal(
        tbi.rx_gather(tplp.constellation, tplp.fec_frame, tplp.code_rate),
        jbi.rx_gather(jplp.constellation, jplp.fec_frame, jplp.code_rate))
    name = tplp.ldpc_table_name
    ours, theirs = get_plan(name), jldpc.get_plan(name)
    assert (ours.n, ours.k, ours.q, ours.cnl) == (theirs.n, theirs.k,
                                                   theirs.q, theirs.cnl)
    assert ours.edges_by_row == theirs.edges_by_row
    assert ours.edges_by_group == theirs.edges_by_group
    for a, b in zip(ldpc._build_tables(ours),
                    ldpc_pallas._build_tables(theirs)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ldpc.kernel_bit_order(name),
                                  ldpc_pallas.kernel_bit_order(name))
    h = bch_ops._h_matrix(tplp.k_bch, tplp.bch_m, tplp.bch_t)
    np.testing.assert_array_equal(
        h, jbch._h_matrix(jplp.k_bch, jplp.bch_m, jplp.bch_t))
    np.testing.assert_array_equal(ldpc.pad_bch_h(h), ldpc_pallas.pad_bch_h(h))


@pytest.mark.parametrize("case", list(CASES))
def test_chain_plan_arrays_equal_jax(case):
    mode_spec, plp_spec, n_fec, n_ti, l1 = CASES[case]
    jmode, tmode = mode_pair(mode_spec)
    jplp, tplp = plp_pair(plp_spec)
    theirs = jax_plan_arrays(jrc.get_plan(jmode, jplp, n_fec, n_ti, l1))
    ours = rx_chain.get_plan(tmode, tplp, n_fec, n_ti, l1)
    arrays = ours.arrays()
    assert sorted(arrays) == sorted(theirs)
    for k in arrays:
        assert np.array_equal(arrays[k], theirs[k]), k
    assert ours.bit_blocks == jrc.get_plan(jmode, jplp, n_fec, n_ti,
                                           l1).bit_blocks


def test_plan_from_numpy_drives_the_same_chain():
    """The device plan built from the JAX package's arrays and the port's
    own device plan are the same tables: the chain gives identical LLRs."""
    mode_spec, plp_spec, n_fec, n_ti, l1 = CASES["fixture"]
    jmode, tmode = mode_pair(mode_spec)
    jplp, tplp = plp_pair(plp_spec)
    plan = rx_chain.get_plan(tmode, tplp, n_fec, n_ti, l1)
    own = plan.to_device("cpu")
    theirs = plan_from_numpy(
        jax_plan_arrays(jrc.get_plan(jmode, jplp, n_fec, n_ti, l1)), "cpu")
    for k, v in own.items():
        if k == "w":
            for a, b in zip(v, theirs["w"]):
                assert a[3] is None and b[3] is None      # linear rows
                assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
        else:
            assert torch.equal(v, theirs[k]), k
    frames, _ = fixture_frames()
    x = torch.from_numpy(frames[:2])
    a, _ = rx_chain.frames_to_llr(x, plan, own)
    b, _ = rx_chain.frames_to_llr(x, plan, theirs)
    assert torch.equal(a, b)


def test_transmitter_copy_is_bit_exact():
    """The port's transmitter (used by chip_smoke.py for its full-width
    signal) modulates exactly what the JAX package's does."""
    jmode, tmode = mode_pair(FIXTURE_MODE)
    jplp, tplp = plp_pair(FIXTURE_PLP)
    ts = jtx.random_ts_stream(120, seed=5)
    np.testing.assert_array_equal(ttx.random_ts_stream(120, seed=5), ts)
    a = jtx.Transmitter(jtx.TxConfig(mode=jmode, plp=jplp,
                                     fec_blocks_per_frame=6,
                                     num_t2_frames=1)).modulate(ts)
    b = ttx.Transmitter(ttx.TxConfig(mode=tmode, plp=tplp,
                                     fec_blocks_per_frame=6,
                                     num_t2_frames=1)).modulate(ts)
    assert len(a) >= tmode.frame_samples
    np.testing.assert_array_equal(a, b)
