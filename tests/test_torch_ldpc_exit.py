"""The port's LDPC wrapper and its early-exit contract, on the CPU.

With ``exit_tile=1`` (what the CUDA kernel computes) the twin's first clean
sweep of every codeword must equal that with ``exit_tile=128`` (the Pallas
tile, held bit-exact against Pallas in tests/test_torch_ldpc.py).  On a
CPU tensor ``LayeredDecoder`` is that twin and launches nothing; it refuses
malformed input and other devices.
"""
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc

from _torch_common import LDPC_CASES, LDPC_W as W, ldpc_case


@pytest.mark.parametrize("name", LDPC_CASES)
def test_per_codeword_exit_keeps_iters(name):
    """exit_tile=1 (the CUDA kernel's contract) against exit_tile=128 (the
    Pallas tile): the first clean sweep of every codeword is unchanged."""
    table, x, max_iters, bch_h, n_cw = ldpc_case(name)
    xt = torch.from_numpy(x)
    tile = ldpc.decode_plain(xt, table, max_iters, bch_h, exit_tile=W)
    one = ldpc.decode_plain(xt, table, max_iters, bch_h, exit_tile=1)
    np.testing.assert_array_equal(one[2].numpy(), tile[2].numpy())
    # hard bits of codewords that stayed clean agree too
    both = (one[1] & tile[1]).numpy()
    np.testing.assert_array_equal(one[0].numpy()[both], tile[0].numpy()[both])


def test_wrapper_on_cpu_is_twin_with_exit_tile_1():
    table, x, max_iters, bch_h, _ = ldpc_case("BCH")
    dec = ldpc.LayeredDecoder(table, max_iters=max_iters, bch_h=bch_h)
    before = ldpc.LayeredDecoder.launches
    got = dec(torch.from_numpy(x))
    want = ldpc.decode_plain(torch.from_numpy(x), table, max_iters, bch_h,
                             exit_tile=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert ldpc.LayeredDecoder.launches == before     # no kernel on the CPU


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank"])
def test_wrapper_rejects_bad_input(bad):
    dec = ldpc.LayeredDecoder("SHORT_C1_2")
    x = torch.zeros((4, 16200), dtype=torch.int8)
    x = dict(dtype=x.float(), shape=x[:, :-1], rank=x[0])[bad]
    with pytest.raises(ValueError):
        dec(x)


def test_wrapper_rejects_other_devices():
    """Only a CPU tensor reaches the twin; a tensor on any device other than
    cpu or cuda is refused rather than decoded."""
    dec = ldpc.LayeredDecoder("SHORT_C1_2")
    with pytest.raises(ValueError):
        dec(torch.zeros((2, 16200), dtype=torch.int8, device="meta"))
