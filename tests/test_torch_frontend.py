"""The port's streaming front end (ops/frontend.py) against the JAX
package's, function by function, on the same seeded numpy inputs (CPU).

Tolerances: both run float32, so outputs agree to a few float32 roundings
of their scale (stated per test, relative to the rms of the signal); the
Farrow resampler's integer positions agree exactly, its fractions to
float32 rounding.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import _torch_common  # noqa: F401  (one torch thread per worker)
from sdr_receiver_dvb_t2_tpu.models import channel as jchannel
from sdr_receiver_dvb_t2_tpu.ops import cplx
from sdr_receiver_dvb_t2_tpu.ops import frontend as jfe
from sdr_receiver_dvb_t2_tpu_torch.models import channel
from sdr_receiver_dvb_t2_tpu_torch.ops import frontend as fe


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(y):
    """JAX real-pair, torch or numpy complex -> numpy complex128."""
    if isinstance(y, cplx.C):
        y = cplx.to_np(y)
    elif isinstance(y, torch.Tensor):
        y = y.numpy()
    return np.asarray(y, np.complex128)


def _rel_err(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / np.sqrt(np.mean(np.abs(b) ** 2)))


def _noise(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def _bandlimited(n, seed, bw=0.4):
    rng = np.random.default_rng(seed)
    spec = np.zeros(n, dtype=np.complex128)
    k = int(n * bw / 2)
    spec[:k] = rng.standard_normal(k) + 1j * rng.standard_normal(k)
    spec[-k:] = rng.standard_normal(k) + 1j * rng.standard_normal(k)
    return (np.fft.ifft(spec) * np.sqrt(n / (2 * k))).astype(np.complex64)


@pytest.mark.parametrize("fmt", ["u8", "s8", "s16", "f32"])
def test_raw_to_iq_matches_jax(fmt):
    """Exact: one subtraction and one power-of-two scale in float32."""
    iq = _noise(4096, 0, 0.3)
    raw = channel.quantize(iq, fmt, scale=1.0)
    np.testing.assert_array_equal(raw, jchannel.quantize(iq, fmt, scale=1.0))
    got = fe.raw_to_iq(_t(raw), fmt)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(
        _np(got), _np(jfe.raw_to_iq(jnp.asarray(raw), fmt)))


def test_iq_condition_and_fold_match_jax():
    """Corrected samples to 1e-6 of the rms, the six statistics to 1e-5
    relative; the host fold of those statistics is the same code, and the
    loop of 8 blocks converges to the same correction."""
    clean = _noise(1 << 15, 1, np.sqrt(0.5))
    g, phi = 10 ** (0.6 / 20), np.deg2rad(3.0)
    x = (clean.real + 1j * g * (clean.imag * np.cos(phi)
                                + clean.real * np.sin(phi))
         + (0.05 - 0.02j)).astype(np.complex64)
    st, jst = fe.IqCondState(), jfe.IqCondState()
    for _ in range(8):
        y, stats = fe.iq_condition(_t(x), np.float32(st.c1),
                                   np.float32(st.c2))
        jy, jstats = jfe.iq_condition(cplx.from_np(x), jnp.float32(jst.c1),
                                      jnp.float32(jst.c2))
        assert _rel_err(y, jy) < 1e-6
        jvals = np.array([float(s) for s in jstats])
        np.testing.assert_allclose(stats.numpy(), jvals, rtol=1e-5,
                                   atol=1e-7)
        st = fe.fold_iq_stats(st, stats.numpy(), alpha=0.5)
        jst = jfe.fold_iq_stats(jst, list(jvals), alpha=0.5)
    for f in ("dc_re", "dc_im", "c1", "c2", "level"):
        assert abs(getattr(st, f) - getattr(jst, f)) < 1e-5, f
    assert abs(st.c2 - g * np.cos(phi)) < 0.01      # the imbalance found


def test_nco_derotate_matches_jax_and_carries_phase():
    x = _noise(1 << 16, 2)
    y, ph = fe.nco_derotate(_t(x), np.float32(0.5), np.float32(0.0123))
    jy, jph = jfe.nco_derotate(cplx.from_np(x), jnp.float32(0.5),
                               jnp.float32(0.0123))
    assert _rel_err(y, jy) < 2e-6
    assert abs(float(ph) - float(jph)) < 1e-6
    # two blocks with the carried phase equal one (to the float32 ramp)
    y1, p1 = fe.nco_derotate(_t(x[:4096]), np.float32(0.5), np.float32(0.01))
    y2, _ = fe.nco_derotate(_t(x[4096:8192]), p1, np.float32(0.01))
    y12, _ = fe.nco_derotate(_t(x[:8192]), np.float32(0.5), np.float32(0.01))
    assert _rel_err(torch.cat([y1, y2]), y12) < 1e-4


def test_spur_notch_matches_jax():
    x = _noise(1 << 16, 3) + (0.3 * np.exp(1j * (0.7 + 0.21 * np.arange(
        1 << 16)))).astype(np.complex64)
    args = (0.7, 0.21, 0.28, 0.05)
    y, m = fe.spur_notch(_t(x), *(np.float32(a) for a in args))
    jy, (jm_re, jm_im) = jfe.spur_notch(cplx.from_np(x),
                                        *(jnp.float32(a) for a in args))
    assert _rel_err(y, jy) < 2e-6
    np.testing.assert_allclose(m.numpy(), [float(jm_re), float(jm_im)],
                               rtol=1e-4, atol=1e-6)
    assert abs(complex(*m.numpy()) - 0.3) < 0.02     # the spur measured


def test_detect_spur_is_the_same_host_code():
    x = _noise(1 << 17, 4, 0.1) + (0.05 * np.exp(1j * 0.0311 * np.arange(
        1 << 17))).astype(np.complex64)
    got, want = fe.detect_spur(x), jfe.detect_spur(x)
    assert got == want and abs(got[0] - 0.0311) < 1e-6
    assert fe.detect_spur(_noise(1 << 16, 5)) is None


def test_farrow_positions_and_output_match_jax(monkeypatch):
    """10 Msps -> 4 x 64/7 Msps grid with a 37 ppm SRO over 64 chunks:
    the integer sample index of every output equals JAX's exactly (read
    from the indices JAX's resampler gathers), the outputs agree to 1e-5
    of the rms, and both match a float64 oracle to 2e-3."""
    n_out = 64 * 1024
    step = 0.546875 * (1 + 37e-6)
    mu0 = 1.37
    x = _bandlimited(int(np.ceil(mu0 + step * n_out)) + 4, 6, bw=0.42)
    hi, lo = fe.split_step(step)
    assert (hi, lo) == jfe.split_step(step)
    assert hi.dtype == lo.dtype == np.float32

    gathered = []
    real_take = cplx.take

    def spy(c, idx, **kw):
        gathered.append(np.asarray(idx))
        return real_take(c, idx, **kw)
    monkeypatch.setattr(cplx, "take", spy)
    jy = jfe.farrow_resample(cplx.from_np(x), jnp.float32(mu0),
                             jnp.float32(hi), jnp.float32(lo), n_out)
    jidx = gathered[1]                             # the x0 tap's indices

    idx, d = fe.farrow_positions(np.float32(mu0), hi, lo, n_out)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert float(d.min()) >= 0.0 and float(d.max()) < 1.0
    y = fe.farrow_resample(_t(x), np.float32(mu0), hi, lo, n_out)
    assert _rel_err(y, jy) < 1e-5

    p = mu0 + step * np.arange(n_out)
    i0 = np.floor(p).astype(np.int64)
    np.testing.assert_array_less(np.abs(idx.numpy() + d.numpy() - p), 2e-4)
    f = p - i0
    x64 = x.astype(np.complex128)
    oracle = (x64[i0 - 1] * (-f * (f - 1) * (f - 2) / 6)
              + x64[i0] * ((f + 1) * (f - 1) * (f - 2) / 2)
              + x64[i0 + 1] * (-(f + 1) * f * (f - 2) / 2)
              + x64[i0 + 2] * ((f + 1) * f * (f - 1) / 6))
    assert _rel_err(y, oracle) < 2e-3
    with pytest.raises(ValueError):
        fe.farrow_positions(np.float32(0), hi, lo, 1000)


def test_design_tables_equal_jax():
    assert fe.FIR_PRESETS == jfe.FIR_PRESETS
    for name in fe.FIR_PRESETS:
        np.testing.assert_array_equal(fe.fir_taps(name), jfe.fir_taps(name))
    assert fe.halfband_taps() == jfe.halfband_taps()
    assert fe.design_lowpass(48, 0.2, 6.0) == jfe.design_lowpass(48, 0.2, 6.0)


def test_upsample2_matches_jax_and_streams():
    x = _bandlimited(8192, 7)
    hb = np.asarray(fe.halfband_taps(), np.float32)
    t = len(hb)
    h0 = np.zeros(t - 1, np.complex64)
    y, hist = fe.upsample2(_t(x), _t(h0), _t(hb))
    jy, jhist = jfe.upsample2(cplx.from_np(x), cplx.from_np(h0),
                              jnp.asarray(hb))
    assert y.shape == (2 * len(x),)
    assert _rel_err(y, jy) < 2e-6
    assert _rel_err(hist, jhist) == 0.0
    ya, ha = fe.upsample2(_t(x[:4096]), _t(h0), _t(hb))
    yb, _ = fe.upsample2(_t(x[4096:]), ha, _t(hb))
    assert _rel_err(torch.cat([ya, yb]), y) < 1e-6


@pytest.mark.parametrize("preset", ["soft", "medium", "sharp"])
def test_fir_decimate2_matches_jax_and_oracle(preset):
    taps = fe.fir_taps(preset)
    t = len(taps)
    x = _noise(8192, 8)
    h0 = np.zeros(t - 1, np.complex64)
    y, _ = fe.fir_decimate2(_t(x), _t(h0), _t(taps))
    jy, _ = jfe.fir_decimate2(cplx.from_np(x), cplx.from_np(h0),
                              jnp.asarray(taps))
    assert y.shape == (len(x) // 2,)
    assert _rel_err(y, jy) < 2e-6
    full = np.convolve(np.concatenate([h0, x]).astype(np.complex128),
                       taps.astype(np.float64), mode="valid")
    assert _rel_err(y, full[::2]) < 2e-6
    ya, ha = fe.fir_decimate2(_t(x[:4096]), _t(h0), _t(taps))
    yb, _ = fe.fir_decimate2(_t(x[4096:]), ha, _t(taps))
    assert _rel_err(torch.cat([ya, yb]), y) < 1e-6


@pytest.mark.parametrize("notch", [False, True])
def test_frontend_block_matches_jax_chain(notch):
    """One ingest block through condition -> [notch] -> NCO -> x2 -> x2 ->
    Farrow -> FIR/2, as the JAX stream's jitted step composes it, twice in
    a row with the carried histories: within 2e-5 of the rms."""
    rate = 10e6
    step = rate / (4 * 64e6 / 7) * (1 + 19e-6)
    n_up = 64 * 1024
    n_in = int(n_up * step) + 64
    hi, lo = fe.split_step(step)
    hb = np.asarray(fe.halfband_taps(), np.float32)
    fir = fe.fir_taps("medium")
    spur = ((np.float32(0.3), np.float32(0.05), np.float32(0.01),
             np.float32(-0.02)) if notch else None)
    z = lambda n: np.zeros(n, np.complex64)               # noqa: E731
    hists = [_t(z(len(fir) - 1)), _t(z(len(hb) - 1)), _t(z(len(hb) - 1))]
    jh = [cplx.from_np(z(len(fir) - 1)), cplx.from_np(z(len(hb) - 1)),
          cplx.from_np(z(len(hb) - 1))]
    for blk in range(2):
        raw = (_bandlimited(n_in, 9 + blk, bw=0.8) * 0.3
               + (0.02 - 0.01j)).astype(np.complex64)
        args = (np.float32(0.01), np.float32(1.02), np.float32(0.4),
                np.float32(0.0213), np.float32(1.3))
        elem, f_h, h1, h2, stats, m = fe.frontend_block(
            _t(raw), *args, hi, lo, *hists, _t(fir), _t(hb), n_up, spur)
        hists = [f_h, h1, h2]

        x, jstats = jfe.iq_condition(cplx.from_np(raw), *map(jnp.float32,
                                                            args[:2]))
        if notch:
            x, jm = jfe.spur_notch(x, *map(jnp.float32, spur))
        x, _ = jfe.nco_derotate(x, jnp.float32(args[2]),
                                jnp.float32(args[3]))
        x, j1 = jfe.upsample2(x, jh[1], jnp.asarray(hb))
        x, j2 = jfe.upsample2(x, jh[2], jnp.asarray(hb))
        up = jfe.farrow_resample(x, jnp.float32(args[4]), jnp.float32(hi),
                                 jnp.float32(lo), n_up)
        jelem, jf = jfe.fir_decimate2(up, jh[0], jnp.asarray(fir))
        jh = [jf, j1, j2]

        assert elem.shape == (n_up // 2,) and elem.dtype == torch.complex64
        assert _rel_err(elem, jelem) < 2e-5
        np.testing.assert_allclose(stats.numpy(),
                                   [float(s) for s in jstats], rtol=1e-5,
                                   atol=1e-7)
        assert (m is None) == (not notch)
        for a, b in zip(hists, jh):
            assert _rel_err(a, b) < 2e-5
