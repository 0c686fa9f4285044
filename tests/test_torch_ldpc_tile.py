"""The early-exit contract of the port's LDPC call, on the CPU.

The Pallas kernel leaves its sweep loop when every codeword of its
128-codeword tile is clean in the same sweep; the clean codewords of a
tile that is not done sweep on, and that can change their bits.  On a
noisy SHORT r2/3 load (noise from sigma 0.6 to 0.9 over the rows) leaving
per codeword (``exit_tile=1``) gives other bits than the tile, and
``LayeredDecoder`` on the CPU must give the tile's, held here against
``make_pallas_decoder(..., interpret=True)``: the hard bits (unpacked from
the wrapper's bytes), ok, iters and the BCH screen's clean flag, exactly.
A second load holds a codeword that is clean at sweep 3, dirty at sweep 4
and clean again from sweep 5, in a tile whose other codewords are first
clean by sweep 4: the tile leaves at sweep 5, not at the largest first
clean sweep.  Segments (the codeword counts of the Pallas calls one call
stands for) tile as those calls would one by one.
"""
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.ops import bch_ops as jbch
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc

import _torch_common  # noqa: F401  (pins torch to one thread per worker)
import chip_smoke

TABLE = "SHORT_C2_3"
BCH_H = jbch._h_matrix(10632, 14, 12)      # SHORT r2/3: k_bch, m, t


# the loads of chip_smoke.py phase 2, made once a worker
noisy_load = functools.lru_cache(maxsize=None)(chip_smoke.noisy_load)


def _pallas(x, max_iters):
    """Pallas (interpret) on x padded with zero codewords to one tile."""
    xp = np.zeros((128, x.shape[1]), np.int8)
    xp[:len(x)] = x
    dec = ldpc_pallas.make_pallas_decoder(TABLE, batch=128, n_tiles=1,
                                          max_iters=max_iters,
                                          interpret=True, bch_h=BCH_H)
    hard, ok, iters, clean = dec(jnp.asarray(np.ascontiguousarray(xp.T)))
    n = len(x)
    return (np.asarray(hard).T[:n], np.asarray(ok)[:n],
            np.asarray(iters)[:n], np.asarray(clean)[:n])


def _assert_wrapper_is(got, want):
    packed, ok, iters, clean = (v.numpy() for v in got)
    np.testing.assert_array_equal(np.unpackbits(packed, axis=1),
                                  want[0].astype(np.uint8))
    np.testing.assert_array_equal(ok, want[1])
    np.testing.assert_array_equal(iters, want[2])
    np.testing.assert_array_equal(clean, want[3])


def test_tile_exit_differs_from_per_codeword_exit():
    """The fault the tile contract repairs: on the noisy load (seed 2, 12
    sweeps) some codeword's hard bits differ between the two contracts,
    though it is LDPC-clean under both."""
    x = torch.from_numpy(noisy_load(2, 0.6, 0.9))
    one = ldpc.decode_plain(x, TABLE, 12, exit_tile=1)
    tile = ldpc.decode_plain(x, TABLE, 12, exit_tile=128)
    rows = np.nonzero((one[0] != tile[0]).any(1).numpy())[0]
    assert len(rows) > 0
    assert one[1][rows].all() and tile[1][rows].all()
    np.testing.assert_array_equal(one[2].numpy(), tile[2].numpy())


def test_wrapper_equals_pallas_interpret_on_noisy_load():
    """LayeredDecoder on the CPU against Pallas in interpret mode on the
    noisy load: bits, ok, iters and clean exact, where the per-codeword
    exit gives other bits."""
    x = noisy_load(2, 0.6, 0.9)
    want = _pallas(x, 12)
    dec = ldpc.LayeredDecoder(TABLE, max_iters=12, bch_h=BCH_H)
    _assert_wrapper_is(dec(torch.from_numpy(x)), want)
    one = ldpc.decode_plain(torch.from_numpy(x), TABLE, 12, exit_tile=1)
    assert (one[0].numpy() != want[0]).any()


def test_relapsing_codeword_holds_its_tile():
    """Rows 0-31 of the sigma 0.5-0.8 load (seed 2): row 29 is clean at
    sweep 3, dirty at sweep 4 and clean from sweep 5; the other rows are
    first clean by sweep 4.  The tile leaves at sweep 5 (stopped at sweep
    4, row 29 would fail), as Pallas does."""
    x = noisy_load(2, 0.5, 0.8)[:32]
    xt = torch.from_numpy(x)
    one = ldpc.decode_plain(xt, TABLE, 15, exit_tile=1)
    assert one[1].all() and int(one[2].max()) == 4 and int(one[2][29]) == 3
    at_t0 = ldpc.decode_plain(xt, TABLE, 4, exit_tile=128)
    assert not bool(at_t0[1][29])
    want = _pallas(x, 15)
    assert want[1].all()
    dec = ldpc.LayeredDecoder(TABLE, max_iters=15, bch_h=BCH_H)
    _assert_wrapper_is(dec(xt), want)


def test_segments_tile_as_separate_calls():
    """Two segments of unequal length: one call with ``segments`` equals
    one call per segment, and differs from one segment over both (the
    early-clean segment then sweeps on with the hopeless one)."""
    x = noisy_load(2, 0.6, 0.9)
    one = ldpc.decode_plain(torch.from_numpy(x), TABLE, 12, exit_tile=1)
    ok, iters = one[1].numpy(), one[2].numpy()
    early = np.nonzero(ok & (iters <= 5))[0]
    hopeless = np.nonzero(~ok)[0][:7]
    assert len(early) > 3 and len(early) != len(hopeless)
    xs = torch.from_numpy(np.concatenate([x[early], x[hopeless]]))
    dec = ldpc.LayeredDecoder(TABLE, max_iters=12, bch_h=BCH_H)
    segs = [len(early), len(hopeless)]
    got = dec(xs, segments=segs)
    parts = [dec(p) for p in torch.split(xs, segs)]
    for i in range(4):
        torch.testing.assert_close(got[i], torch.cat([p[i] for p in parts]),
                                   rtol=0, atol=0)
    assert not torch.equal(dec(xs)[0], got[0])


@pytest.mark.parametrize("segments", [[3, 2], [5, -1], [2, 2]])
def test_segments_must_split_the_call(segments):
    dec = ldpc.LayeredDecoder("SHORT_C1_2")
    x = torch.zeros((5, 16200), dtype=torch.int8)
    if sum(segments) == 5 and min(segments) >= 0:
        assert dec(x, segments=segments)[1].all()
    else:
        with pytest.raises(ValueError):
            dec(x, segments=segments)


def test_tile_index_counts_from_each_segment():
    np.testing.assert_array_equal(
        ldpc.tile_index([3, 0, 5], 8, exit_tile=2),
        [0, 0, 1, 2, 2, 3, 3, 4])
    np.testing.assert_array_equal(ldpc.tile_index(None, 300),
                                  np.arange(300) // 128)


def _kernel_tile_of(starts, cw):
    """The decoder kernel's lookup (ldpc_layered.cu): the last tile that
    starts at or before codeword cw, by bisection over the table."""
    tile, past = 0, len(starts) - 1
    while past - tile > 1:
        mid = (tile + past) // 2
        if starts[mid] <= cw:
            tile = mid
        else:
            past = mid
    return tile


@pytest.mark.parametrize("segments,w", [
    (None, 1616),                       # one segment: the flagship batch
    ([202] * 64, 12928),                # the pod's 64 segments of 202
    ([1, 127, 128, 129, 0, 1], 386),    # around a tile, and an empty one
])
def test_kernel_tile_table_equals_tile_index(segments, w):
    """The table the kernel finds a codeword's tile in gives the tiles of
    tile_index, which the twin exits by; no tile is empty or longer than
    128 codewords."""
    starts = ldpc.tile_starts(segments, w)
    tile = ldpc.tile_index(segments, w)
    assert starts[0] == 0 and starts[-1] == w
    assert len(starts) == int(tile.max()) + 2
    assert all(1 <= b - a <= ldpc.TILE for a, b in zip(starts, starts[1:]))
    np.testing.assert_array_equal(
        [_kernel_tile_of(starts, c) for c in range(w)], tile)
