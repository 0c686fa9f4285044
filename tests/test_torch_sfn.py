"""The port's SFN equalizer (Wiener rows, temporal-union pilots, ph_rot
derotation, csi, cir_p) and CSI-weighted demap against the JAX package.

The same numpy inputs go through both.  Tables are held equal exactly,
including at full 32K width; planes, csi and the delay profile to the
stated tolerances (the JAX chain rounds its pilots, planes and csi
through bf16, the port keeps float32); int8 LLRs to one step on 99.99% of
values and two everywhere; hard bits and TS bytes exactly.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.models import receiver as jrx
from sdr_receiver_dvb_t2_tpu.ops import cplx
from sdr_receiver_dvb_t2_tpu.ops import rx_chain as jrc
from sdr_receiver_dvb_t2_tpu_torch.models import receiver as trx
from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
    Transmitter, TxConfig, random_ts_stream)
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc, rx_chain
from sdr_receiver_dvb_t2_tpu_torch.params import l1 as l1_mod, pilots

from _torch_common import FLAGSHIP_MODE, FLAGSHIP_PLP, mode_pair, plp_pair

# tests/test_sfn_channel.py's mode: 2K GI 1/8 PP3, whose data symbols'
# own pilots resolve less delay than the guard (an SFN plan by default)
SFN_MODE = dict(fft_mode="FFT_2K", guard="G1_8", pilot_pattern="PP3",
                extended_carriers=False, n_data_symbols=30)
SFN_PLP = dict(constellation="QAM16", code_rate="C1_2", fec_frame="SHORT",
               rotation=True, time_il_length=1)
# bench.py _bench_sfn: 32K GI 1/32 PP7 extended (SFN-gated), and the
# flagship (32K GI 1/128 PP7) when acquisition measures an echo
SFN_32K = dict(fft_mode="FFT_32K", guard="G1_32", pilot_pattern="PP7",
               extended_carriers=True, n_data_symbols=59)
# tests/test_sfn_channel.py MODE_UNGATED: linear by default, SFN on demand
UNGATED = dict(fft_mode="FFT_2K", guard="G1_32", pilot_pattern="PP4",
               extended_carriers=False, n_data_symbols=30)
N_FEC = 4
# the channel power below which the JAX reference's bf16 rounding of its
# estimate, amplified by 1/|h|, dominates the plane difference (-30 dB of
# the frame's mean channel power)
CSI_FLOOR = 1e-3


def _plan_pair(mode_spec, plp_spec, n_fec, l1, sfn):
    """Both packages' plans; ``n_fec=None`` fills the frame after l1."""
    jmode, tmode = mode_pair(mode_spec)
    jplp, tplp = plp_pair(plp_spec)
    if n_fec is None:
        n_fec = (tmode.frame_cells - l1) // tplp.cells_per_fec_block
    return (jrc.get_plan(jmode, jplp, n_fec, 1, l1, sfn=sfn),
            rx_chain.get_plan(tmode, tplp, n_fec, 1, l1, sfn=sfn))


@pytest.mark.parametrize("case", [
    (SFN_MODE, SFN_PLP, N_FEC, 2000, False),
    (UNGATED, SFN_PLP, N_FEC, 2000, True),
    (SFN_32K, FLAGSHIP_PLP, None, 9000, False),
    (FLAGSHIP_MODE, FLAGSHIP_PLP, None, 9000, True),
], ids=["2K_PP3_gated", "2K_PP4_sfn", "32K_GI1_32_PP7_gated",
        "32K_flagship_sfn"])
def test_sfn_tables_equal_jax(case):
    """Every plan table, the Wiener weights built in float64 included, is
    the JAX one exactly: same keys, dtypes and values."""
    from _torch_common import jax_plan_arrays
    jplan, plan = _plan_pair(*case)
    theirs, ours = jax_plan_arrays(jplan), plan.arrays()
    assert sorted(ours) == sorted(theirs)
    assert {"ph_rot", "cir_tab_re", "cir_tab_im", "cir_d"} <= set(ours)
    assert any(k.endswith("_si_im") for k in ours)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        assert np.array_equal(ours[k], theirs[k]), k
    assert plan.bit_blocks == jplan.bit_blocks
    assert [list(g) for g in plan.eq.group_syms] == \
        [list(g) for g in jplan.eq.group_syms]


def test_sfn_flag_dedups_on_gated_modes():
    """A mode whose default plan is already SFN-grade shares one table set
    whether or not acquisition asks for it; an ungated mode keeps its
    linear plan until asked."""
    _, tmode = mode_pair(SFN_MODE)
    _, ung = mode_pair(UNGATED)
    assert rx_chain.get_eq_tables(tmode, True) is rx_chain.get_eq_tables(
        tmode, False)
    assert rx_chain.get_eq_tables(ung, False).ph_rot is None
    assert rx_chain.get_eq_tables(ung, True).ph_rot is not None


def _two_path_planes(tmode, n_frames=2, seed=0):
    """tests/test_sfn_channel.py's 0 dB two-path channel (an echo at 200
    samples) on unit-modulus random cells with the reference pilots, 30 dB
    of noise, and a per-symbol and per-frame common phase (residual CFO)
    for the ph_rot derotation to remove."""
    rng = np.random.default_rng(seed)
    L, K = tmode.frame_symbols, tmode.k_total
    k = np.arange(K)
    H = 1.0 + 1.0j * np.exp(-2j * np.pi * k * 200 / tmode.fft_size)
    eq = rx_chain.get_eq_tables(tmode)
    planes = np.empty((n_frames, L, K), np.complex128)
    for f in range(n_frames):
        for l in range(L):
            x = rng.standard_normal(K) + 1j * rng.standard_normal(K)
            x /= np.abs(x)
            n = int(eq.eq_plan.n_pilots[l])
            pidx = np.asarray(eq.eq_plan.pilot_idx[l][:n])
            x[pidx] = pilots.reference_symbol(tmode, l)[pidx]
            planes[f, l] = H * x * np.exp(1j * (0.4 + 0.07 * l + 1.3 * f))
    planes += (rng.standard_normal(planes.shape) + 1j
               * rng.standard_normal(planes.shape)) * np.sqrt(1e-3 / 2)
    return planes.astype(np.complex64), H


def _jax_equalize(jplan, planes):
    fn = jax.jit(lambda c, k: jrc.equalize_plane(c, jplan, k))
    consts = jplan.device_consts()
    out = [fn(cplx.C(jnp.asarray(p.real), jnp.asarray(p.imag)), consts)
           for p in planes]
    eq = np.stack([np.asarray(e.re) + 1j * np.asarray(e.im) for e, _ in out])
    diag = {k: np.stack([np.asarray(d[k]).astype(np.float32)
                         for _, d in out]) for k in out[0][1]}
    return eq, diag


def _rel_db(got, want, weight=None):
    w = np.ones(got.shape) if weight is None else weight
    return 10 * np.log10(np.sum(w * np.abs(got - want) ** 2)
                         / np.sum(w * np.abs(want) ** 2))


def test_sfn_equalize_plane_matches_jax():
    """The 0 dB echo of test_wiener_interp_resolves_guard_length_echo, two
    frames with different common phases: the equalized plane, csi, the
    delay profile and the discriminators against the JAX stage.

    At the channel's nulls the JAX plane is its bf16-rounded estimate
    divided by a near-zero |h|; there the two planes differ by that
    rounding, amplified, and the port's estimate is the closer one to the
    true channel.  The plane is held to -40 dB wherever the channel power
    is within 30 dB of its mean (CSI_FLOOR), and CSI-weighted (the weight
    the demapper gives each cell) everywhere."""
    jplan, plan = _plan_pair(SFN_MODE, SFN_PLP, N_FEC, 2000, False)
    _, tmode = mode_pair(SFN_MODE)
    planes, H = _two_path_planes(tmode)
    want_eq, want = _jax_equalize(jplan, planes)
    eq, diag = rx_chain.equalize_plane(torch.from_numpy(planes), plan,
                                       plan.to_device("cpu"))
    eq = eq.numpy()
    csi = diag["csi"].numpy()
    keep = csi >= CSI_FLOOR
    msg = (f"plane: {_rel_db(eq, want_eq):.2f} dB unweighted, "
           f"{_rel_db(eq[keep], want_eq[keep]):.2f} dB on the "
           f"{keep.mean():.4%} of cells above the floor, "
           f"{_rel_db(eq, want_eq, csi):.2f} dB CSI-weighted")
    assert keep.mean() > 0.98, msg
    assert _rel_db(eq[keep], want_eq[keep]) < -40.0, msg
    assert _rel_db(eq, want_eq, csi) < -40.0, msg
    # csi within 1% (relative rms), cir_p within 1% of its peak with the
    # same first path, the discriminators as on the SISO plan
    assert _rel_db(csi, want["csi"]) < -40.0, _rel_db(csi, want["csi"])
    cir, want_cir = diag["cir_p"].numpy(), want["cir_p"]
    assert cir.shape == want_cir.shape == (2, len(plan.eq.cir_d))
    assert np.max(np.abs(cir - want_cir)) < 0.01 * want_cir.max()
    first = lambda p: np.argmax(p >= 0.08 * p.max(axis=-1, keepdims=True),
                                axis=-1)
    np.testing.assert_array_equal(first(cir), first(want_cir))
    np.testing.assert_allclose(diag["phase_offset"].numpy(),
                               want["phase_offset"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(diag["sro"].numpy(), want["sro"], rtol=1e-3,
                               atol=1e-7)
    # the port's channel estimate resolves the echo: each frame's mean
    # profile peaks at its strongest path, the csi follows |H|^2
    h2 = np.abs(H) ** 2 / np.mean(np.abs(H) ** 2)
    assert _rel_db(csi[:, 4:-4].mean(axis=1), h2[None].repeat(2, 0)) < -25


def _echo_frames(tmode, tplp, n_frames=2, snr_db=24.0, seed=17):
    """Frames of the port's transmitter through tests/test_sfn_channel.py's
    0 dB echo at 200 samples and AWGN, timed on the first path; frame 0
    (the echo's warm-up) dropped.  Returns (frames, TS, l1_post_size)."""
    tx = Transmitter(TxConfig(mode=tmode, plp=tplp,
                              fec_blocks_per_frame=N_FEC,
                              num_t2_frames=n_frames + 1))
    ts = random_ts_stream((n_frames + 3) * N_FEC * (tplp.k_bch // 8 - 10)
                          // 188, seed=seed)
    iq = tx.modulate(ts)[:(n_frames + 1) * tmode.frame_samples]
    taps = np.zeros(201, np.complex128)
    taps[0], taps[200] = 1.0, 1.0j
    iq = np.convolve(iq, taps)[:len(iq)]
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10) / 2)
    iq = iq + sigma * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))
    frames = iq[tmode.frame_samples:].reshape(n_frames, tmode.frame_samples)
    return frames.astype(np.complex64), ts, tx.l1_pre.l1_post_size


def _llr_counts(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return dict(n=diff.size, by_1=int(np.sum(diff == 1)),
                over_1=int(np.sum(diff > 1)), over_2=int(np.sum(diff > 2)),
                max=int(diff.max()))


def _bf16(x):
    """Round float32 values (or complex64 parts) to bf16, as the JAX chain
    stores its equalized plane and csi; the result is float32/complex64."""
    import ml_dtypes
    r = lambda v: v.astype(ml_dtypes.bfloat16).astype(np.float32)  # noqa
    return (r(x.real) + 1j * r(x.imag)).astype(np.complex64) \
        if np.iscomplexobj(x) else r(x)


def demap_parity(jr, rx, eq, csi):
    """The port's and the JAX receiver's demap (its jitted per-PLP half) on
    one equalized plane and csi, twice: on the values as the port holds
    them (float32; the JAX stage rounds plane and csi through bf16) and on
    bf16-representable values, which both stages read alike.  Returns the
    two count dicts; the second must meet |diff| <= 1 on 99.99% and <= 2
    everywhere, the first <= 2 everywhere (the port's LLRs at full
    precision against the JAX LLRs of rounded cells)."""
    out = []
    for plane, c in ((eq, csi), (_bf16(eq), None if csi is None
                                 else _bf16(csi))):
        packed = jrc._pack_bf16(cplx.C(jnp.asarray(plane.real),
                                       jnp.asarray(plane.imag)))
        want = np.asarray(jr._demap_fn(
            packed, None if c is None
            else jnp.asarray(c).astype(jnp.bfloat16))[0]).T
        got = rx_chain.packed_to_llr(
            torch.from_numpy(plane), rx.plan, rx.consts,
            csi=None if c is None else torch.from_numpy(c))[0].numpy()
        assert got.shape == want.shape
        out.append(_llr_counts(got, want))
    full, rounded = out
    msg = f"float32 planes: {full}; bf16 planes: {rounded}"
    assert full["over_2"] == 0, msg
    assert rounded["over_1"] <= 1e-4 * rounded["n"], msg
    assert rounded["over_2"] == 0, msg
    return full, rounded


def test_sfn_frames_llr_bits_and_ts_match_jax():
    """Two frames through a 0 dB echo: the CSI-weighted int8 LLRs against
    the JAX receiver's demap on the same plane and csi, the hard bits
    decoded from each package's whole chain, and both receivers' TS bytes
    against the transmitted stream."""
    jmode, tmode = mode_pair(SFN_MODE)
    jplp, tplp = plp_pair(SFN_PLP)
    frames, ts, l1_post = _echo_frames(tmode, tplp)
    jr = jrx.TpuReceiver(jrx.RxConfig(mode=jmode, plp=jplp,
                                      n_fec_per_frame=N_FEC, n_ti=1,
                                      use_pallas=False))
    jr._l1_post_cells = l1_post
    rx = trx.TorchReceiver(trx.RxConfig(mode=tmode, plp=tplp,
                                        n_fec_per_frame=N_FEC, n_ti=1),
                           device="cpu")
    rx._l1_post_cells = l1_post
    eq, diag = rx.compute_plane(frames)
    assert set(diag) == {"phase_offset", "sro", "gi_cfo", "csi", "cir_p"}
    demap_parity(jr, rx, eq.numpy(), diag["csi"].numpy())
    # each package's whole chain (its own FFT, plane, csi and demap), the
    # same decoder on both: the same hard bits, every codeword clean
    packed, jdiag = jr.compute_plane(frames)
    want = np.array(jr._demap_fn(packed, jdiag["csi"])[0]).T
    llr = rx_chain.packed_to_llr(eq, rx.plan, rx.consts,
                                 csi=diag["csi"])[0].numpy()
    assert llr.shape == want.shape == (2 * N_FEC, tplp.fec_size)
    a = ldpc.decode_plain(torch.from_numpy(llr), tplp.ldpc_table_name, 15)
    b = ldpc.decode_plain(torch.from_numpy(want), tplp.ldpc_table_name, 15)
    assert a[1].all() and b[1].all()
    assert torch.equal(a[0], b[0])
    # TS bytes: the port's receiver (csi kept off the host copies), the
    # JAX receiver, the transmitted stream
    res = rx.receive_plane(eq, diag)
    jres = jr.receive_plane(packed, jdiag)
    assert res.ldpc_ok.all() and res.bch_clean.all()
    assert "csi" not in res.diag and res.diag["cir_p"].shape == (
        2, len(rx.plan.eq.cir_d))
    assert len(res.ts_bytes) > 188 * 20
    np.testing.assert_array_equal(res.ts_bytes, jres.ts_bytes)
    got, sync = res.ts_bytes.tobytes(), ts.tobytes()
    at = sync.find(got[:376])
    assert at >= 0 and got == sync[at:at + len(got)]


def test_frames_to_llr_weights_by_csi():
    """frames_to_llr pops csi off the diag and demaps with it: the same
    LLRs as packed_to_llr given the csi, and not those without it."""
    _, tmode = mode_pair(SFN_MODE)
    _, tplp = plp_pair(SFN_PLP)
    frames, _, l1_post = _echo_frames(tmode, tplp, n_frames=1)
    plan = rx_chain.get_plan(tmode, tplp, N_FEC, 1,
                             l1_mod.L1_PRE_CELLS + l1_post)
    consts = plan.to_device("cpu")
    x = torch.from_numpy(frames)
    llr, diag = rx_chain.frames_to_llr(x, plan, consts)
    assert "csi" not in diag and {"cir_p", "snr_db"} <= set(diag)
    eq, d2 = rx_chain.frames_to_eq(x, plan, consts)
    assert torch.equal(llr, rx_chain.packed_to_llr(eq, plan, consts,
                                                   csi=d2["csi"])[0])
    assert not torch.equal(llr, rx_chain.packed_to_llr(eq, plan, consts)[0])
