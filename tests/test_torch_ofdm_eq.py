"""The port's OFDM demod and SISO equalizer against the JAX stages.

Inputs: the e2e fixture (8K, GI 1/32, PP3, 25 dB AWGN plus a 30 degree
channel phase), the same numpy frames into both packages.
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.ops import cplx, ofdm as jofdm
from sdr_receiver_dvb_t2_tpu.ops import rx_chain as jrc
from sdr_receiver_dvb_t2_tpu_torch.ops import ofdm, rx_chain
from sdr_receiver_dvb_t2_tpu_torch.params.p1 import P1_LEN

from _torch_common import (FIXTURE_MODE, FIXTURE_PLP, fixture_frames,
                           mode_pair, plp_pair)

N_FRAMES = 3


def _jax_demod(frames, jmode):
    fn = jax.jit(lambda f: jofdm.demod_frame(f, jmode))
    out = [fn(cplx.from_np(f)) for f in frames]
    car = np.stack([np.asarray(c.re) + 1j * np.asarray(c.im) for c, _ in out])
    return car.astype(np.complex64), np.stack([np.asarray(g) for _, g in out])


def test_demod_frame_matches_jax():
    frames, _ = fixture_frames()
    frames = frames[:N_FRAMES]
    jmode, tmode = mode_pair(FIXTURE_MODE)
    want_car, want_cfo = _jax_demod(frames, jmode)
    car, cfo = ofdm.demod_frame(torch.from_numpy(frames), tmode)
    car = car.numpy()
    rms = np.sqrt(np.mean(np.abs(want_car) ** 2))
    # the port's FFT is float32: within 1e-5 of the rms of a float64 numpy
    # transform of the same symbols (fftshift + crop as the reference does)
    sym = frames[:, P1_LEN:P1_LEN + tmode.frame_symbols * tmode.symbol_size]
    sym = sym.reshape(N_FRAMES, tmode.frame_symbols, tmode.symbol_size)
    spec = np.fft.fftshift(np.fft.fft(sym[..., tmode.guard_size:]
                                      .astype(np.complex128)), axes=-1)
    ref = spec[..., tmode.left_nulls:tmode.left_nulls + tmode.k_total] * (
        np.sqrt(tmode.k_total) / tmode.fft_size)
    assert np.max(np.abs(car - ref)) < 1e-5 * rms
    # JAX's four-step matmul FFT runs in bf16 (its documented floor is
    # ~-48 dB): the port must sit at that distance from it, not further
    err_db = 10 * np.log10(np.mean(np.abs(car - want_car) ** 2) / rms ** 2)
    assert err_db < -44.0, err_db
    # gi_cfo is an angle of a 200-sample float32 correlation over 2*8192
    np.testing.assert_allclose(cfo.numpy(), want_cfo, rtol=0, atol=1e-7)


def test_equalize_plane_matches_jax():
    frames, _ = fixture_frames()
    jmode, tmode = mode_pair(FIXTURE_MODE)
    jplp, tplp = plp_pair(FIXTURE_PLP)
    car, _ = _jax_demod(frames[:N_FRAMES], jmode)
    jplan = jrc.get_plan(jmode, jplp, 6, 3, 3000)
    consts = jplan.device_consts()
    fn = jax.jit(lambda c, k: jrc.equalize_plane(c, jplan, k))
    want = [fn(cplx.C(jnp.asarray(c.real), jnp.asarray(c.imag)), consts)
            for c in car]
    want_eq = np.stack([np.asarray(e.re) + 1j * np.asarray(e.im)
                        for e, _ in want])
    plan = rx_chain.get_plan(tmode, tplp, 6, 3, 3000)
    eq, diag = rx_chain.equalize_plane(torch.from_numpy(car), plan,
                                       plan.to_device("cpu"))
    eq = eq.numpy()
    # the JAX equalizer interpolates from bf16-rounded carriers (2^-9
    # relative); the port stays in complex64.  The channel estimate is a
    # 2-tap average of such pilots, so the equalized cells differ by about
    # that relative error: bound it at 2^-7 of each cell's magnitude plus a
    # floor for the near-zero cells.
    err = np.abs(eq - want_eq)
    assert np.all(err <= 2.0 ** -7 * np.abs(want_eq) + 1e-3)
    assert np.median(err / np.maximum(np.abs(want_eq), 1e-3)) < 2.0 ** -9
    # the diagnostics read the carriers themselves, in float32 in both
    np.testing.assert_allclose(
        diag["phase_offset"].numpy(),
        np.stack([np.asarray(d["phase_offset"]) for _, d in want]),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        diag["sro"].numpy(), np.stack([np.asarray(d["sro"]) for _, d in want]),
        rtol=1e-4, atol=1e-9)


def test_frames_to_eq_is_demod_then_equalize():
    frames, _ = fixture_frames()
    _, tmode = mode_pair(FIXTURE_MODE)
    _, tplp = plp_pair(FIXTURE_PLP)
    plan = rx_chain.get_plan(tmode, tplp, 6, 3, 3000)
    consts = plan.to_device("cpu")
    x = torch.from_numpy(frames[:2])
    eq, diag = rx_chain.frames_to_eq(x, plan, consts)
    car, cfo = ofdm.demod_frame(x, tmode)
    eq2, _ = rx_chain.equalize_plane(car, plan, consts)
    assert torch.equal(eq, eq2) and torch.equal(diag["gi_cfo"], cfo)
    assert eq.shape == (2, tmode.frame_symbols, tmode.k_total)
