"""Blind pod acquisition (parallel/acquire.py) against the JAX package's on
the CPU: two channels of one mux behind different noise-only leads, a
dark channel (noise only) and a channel parked on another mux, from the
same numpy capture.  The JAX acquisition runs once (module fixture)."""
import dataclasses

import numpy as np
import pytest

from sdr_receiver_dvb_t2_tpu.parallel import acquire as jacq
from sdr_receiver_dvb_t2_tpu_torch.parallel import acquire

from _torch_common import (POD_PLP, POD_RATE, plp_pair, pod_channels,
                           pod_tx)


@pytest.fixture(scope="module")
def capture():
    """[A, A, dark, B]: mux A (QAM16 r1/2) at leads 400 and 1300 with a
    3 kHz CFO, noise alone, mux B (QAM64 r2/3) at lead 600."""
    iq_a, _, _ = pod_tx(4, seed=1)
    jplp_b, _ = plp_pair({**POD_PLP, "constellation": "QAM64",
                          "code_rate": "C2_3"})
    iq_b, _, _ = pod_tx(4, seed=2, plp=jplp_b)
    raw_a = pod_channels(iq_a, 3, [400, 1300, 0], cfo_hz=3e3)
    raw_b = pod_channels(iq_b, 1, [600], seed=8)
    n = min(raw_a.shape[1], raw_b.shape[1])
    raw = np.concatenate([raw_a[:, :n], raw_b[:, :n]], axis=0)
    rng = np.random.default_rng(23)
    raw[2] = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
              ).astype(np.complex64) * np.sqrt(
                  np.mean(np.abs(raw[0]) ** 2) / 400.0)
    return raw


@pytest.fixture(scope="module")
def locks(capture):
    return (jacq.blind_acquire(capture, POD_RATE, allow_partial=True),
            acquire.blind_acquire(capture, POD_RATE, allow_partial=True,
                                  device="cpu"))


def test_blind_acquire_matches_jax(locks):
    want, got = locks
    assert want is not None and got is not None
    assert got.locked.tolist() == want.locked.tolist() == [True, True,
                                                           False, False]
    assert got.mismatched == want.mismatched == [3]
    np.testing.assert_array_equal(got.pos0, want.pos0)
    np.testing.assert_array_equal(got.frame_idx0, want.frame_idx0)
    np.testing.assert_allclose(got.mu0, want.mu0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.freq, want.freq, rtol=0, atol=1e-7)
    assert got.step == want.step
    # the same configuration, field by field (the packages share no class)
    jc, pc = want.cfg, got.cfg
    for f in ("n_fec_per_frame", "n_ti", "l1_post_cells", "plp_start",
              "frames_per_shard", "fir_preset", "halo", "ldpc_max_iters",
              "sfn", "fef", "num_t2", "extra_plps"):
        assert getattr(pc, f) == getattr(jc, f), f
    assert dataclasses.asdict(pc.mode) == dataclasses.asdict(jc.mode)
    assert dataclasses.asdict(pc.plp) == dataclasses.asdict(jc.plp)
    assert pc.plp.constellation.name == "QAM16"
    assert dataclasses.asdict(got.l1_pre) == dataclasses.asdict(want.l1_pre)
    # the two locked channels were offset differently
    assert got.pos0[0] != got.pos0[1]


def test_blind_acquire_without_partial_refuses(capture):
    """allow_partial=False: a dark or mismatched channel fails the pod."""
    assert acquire.blind_acquire(capture[:3], POD_RATE,
                                 device="cpu") is None
    lock = acquire.blind_acquire(capture[:2], POD_RATE, device="cpu")
    assert lock is not None and lock.locked.all()


def test_mesh_lock_aligned(locks, capture):
    _, got = locks
    al = got.aligned(capture)
    n = int(min(capture.shape[1] - p for p in got.pos0))
    assert al.shape == (4, n)
    for c in range(4):
        np.testing.assert_array_equal(
            al[c], capture[c, got.pos0[c]:got.pos0[c] + n])
