"""The port's MISO (Alamouti) equalizer and the T2-Lite receive path
against the JAX package, on the CPU.

MISO: two transmit groups with different multipath (tests/test_miso.py's
``_two_path_mix``), the h1/h2 separation from the inverted pilots and the
pair combine, whose partner the port takes with one gather over
``pair_idx``.  T2-Lite: tests/test_miso.py's rate-2/5 (table B9) frame
receive at 12 dB.  Tables exactly (the 32K MISO mode of bench.py
``_bench_miso`` included), planes to -40 dB, int8 LLRs to one step on
99.99% and two everywhere on the same plane, hard bits and TS exactly.
The blind MISO and Lite streams are held to the transmitted TS (the JAX
package's own are marked slow).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sdr_receiver_dvb_t2_tpu.models import receiver as jrx
from sdr_receiver_dvb_t2_tpu.ops import cplx
from sdr_receiver_dvb_t2_tpu.ops import rx_chain as jrc
from sdr_receiver_dvb_t2_tpu_torch.io import sinks, sources
from sdr_receiver_dvb_t2_tpu_torch.models import receiver as trx
from sdr_receiver_dvb_t2_tpu_torch.models.channel import (ChannelConfig,
                                                          impair, quantize)
from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
    Transmitter, TxConfig, random_ts_stream)
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc, ofdm, rx_chain
from sdr_receiver_dvb_t2_tpu_torch.params import pilots
from sdr_receiver_dvb_t2_tpu_torch.runtime import stream

from _port_capture import ts_in_stream
from _torch_common import FLAGSHIP_PLP, jax_plan_arrays, mode_pair, plp_pair
from test_miso import _two_path_mix
from test_torch_sfn import _rel_db, demap_parity

MISO_MODE = dict(fft_mode="FFT_2K", guard="G1_8", pilot_pattern="PP3",
                 extended_carriers=False, n_data_symbols=30, miso=True)
PLP = dict(constellation="QAM16", code_rate="C1_2", fec_frame="SHORT",
           rotation=True, time_il_length=1)
# bench.py _bench_miso: 32K GI 1/128 PP8 extended MISO
MISO_32K = dict(fft_mode="FFT_32K", guard="G1_128", pilot_pattern="PP8",
                extended_carriers=True, n_data_symbols=59, miso=True)
LITE_MODE = dict(fft_mode="FFT_2K", guard="G1_8", pilot_pattern="PP7",
                 extended_carriers=False, n_data_symbols=30, lite=True)
N_FEC = 4


@pytest.mark.parametrize("spec,plp_spec,l1", [
    (MISO_MODE, PLP, 2000), (MISO_32K, FLAGSHIP_PLP, 9000),
    (LITE_MODE, dict(PLP, code_rate="C2_5"), 2000)],
    ids=["2K_PP3_miso", "32K_PP8_miso", "2K_PP7_lite"])
def test_miso_and_lite_tables_equal_jax(spec, plp_spec, l1):
    jmode, tmode = mode_pair(spec)
    jplp, tplp = plp_pair(plp_spec)
    n_fec = (tmode.frame_cells - l1) // tplp.cells_per_fec_block
    jplan = jrc.get_plan(jmode, jplp, n_fec, 1, l1)
    plan = rx_chain.get_plan(tmode, tplp, n_fec, 1, l1)
    theirs, ours = jax_plan_arrays(jplan), plan.arrays()
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        assert np.array_equal(ours[k], theirs[k]), k
    assert plan.bit_blocks == jplan.bit_blocks
    if tmode.miso:
        assert {"walt0_win_idx", "o_sign", "pair_idx", "pair_sign",
                "ph_rot"} <= set(ours)
        # the pairing: an involution, in-row, pilots self-paired with
        # sign 0 (so they add nothing to the combine)
        pair, sign = plan.eq.pair_idx.astype(np.int64), plan.eq.pair_sign
        L, K = tmode.frame_symbols, tmode.k_total
        assert np.array_equal(pair[pair], np.arange(L * K))
        assert np.array_equal(pair // K, np.arange(L * K) // K)
        for l in (0, tmode.n_p2, L - 1):
            data = np.zeros(K, bool)
            data[pilots.data_cell_indices(tmode, l)] = True
            assert np.all(sign[l, ~data] == 0)
            assert np.all(pair.reshape(L, K)[l, ~data]
                          == l * K + np.arange(K)[~data])
            assert np.all(np.abs(sign[l, data]) == 1)
    else:
        assert plan.eq.ph_rot is not None           # GI 1/8 PP7: SFN plan


def _miso_frames(tmode, tplp, n_frames=2, snr_db=25.0, seed=8):
    """tests/test_miso.py's MISO frames from the port's transmitter:
    (group 1 + group 2 through _two_path_mix, their clean sum, TS,
    l1_post_size)."""
    tx = Transmitter(TxConfig(mode=tmode, plp=tplp,
                              fec_blocks_per_frame=N_FEC,
                              num_t2_frames=n_frames))
    n_pkts = (n_frames + 2) * N_FEC * (tplp.k_bch // 8 - 10) // 188
    ts = random_ts_stream(n_pkts, seed=seed)
    iq1, iq2 = tx.modulate(ts)
    F = tmode.frame_samples
    mixed = _two_path_mix(iq1, iq2, snr_db=snr_db)[:n_frames * F]
    clean = (iq1 + iq2)[:n_frames * F]
    return (mixed.reshape(n_frames, F), clean.reshape(n_frames, F), ts,
            tx.l1_pre.l1_post_size)


def _receivers(spec, plp_spec, l1_post=None):
    jmode, tmode = mode_pair(spec)
    jplp, tplp = plp_pair(plp_spec)
    jr = jrx.TpuReceiver(jrx.RxConfig(mode=jmode, plp=jplp,
                                      n_fec_per_frame=N_FEC, n_ti=1,
                                      use_pallas=False))
    rx = trx.TorchReceiver(trx.RxConfig(mode=tmode, plp=tplp,
                                        n_fec_per_frame=N_FEC, n_ti=1),
                           device="cpu")
    if l1_post is not None:                # known: no priming frame needed
        jr._l1_post_cells = rx._l1_post_cells = l1_post
    return jr, rx


def _assert_ts(res, ts, min_pkts=20):
    assert res.ldpc_ok.all() and res.bch_clean.all()
    got, sync = res.ts_bytes.tobytes(), ts.tobytes()
    assert len(got) > 188 * min_pkts
    at = sync.find(got[:376])
    assert at >= 0 and got == sync[at:at + len(got)]


def test_miso_equalize_and_receive_match_jax():
    """The two-group multipath mix at 25 dB: the Alamouti plane on the same
    carriers against the JAX stage, the demap against the JAX demap on
    that plane, the hard bits decoded from each package's whole chain, and
    the TS bytes of both receivers against the transmitted stream."""
    _, tmode = mode_pair(MISO_MODE)
    _, tplp = plp_pair(PLP)
    frames, _, ts, l1_post = _miso_frames(tmode, tplp)
    jr, rx = _receivers(MISO_MODE, PLP, l1_post)
    # equalize_plane on one set of carriers (the port's float32 FFT)
    car, _ = ofdm.demod_frame(torch.from_numpy(frames), tmode)
    fn = jax.jit(lambda c, k: jrc.equalize_plane(c, jr._plan, k))
    car_np = car.numpy()
    want = [fn(cplx.C(jnp.asarray(c.real), jnp.asarray(c.imag)),
               jr._consts) for c in car_np]
    want_eq = np.stack([np.asarray(e.re) + 1j * np.asarray(e.im)
                        for e, _ in want])
    eq, diag = rx_chain.equalize_plane(car, rx.plan, rx.consts)
    assert set(diag) == {"phase_offset", "sro"}          # no csi for MISO
    err = _rel_db(eq.numpy(), want_eq)
    assert err < -40.0, f"MISO plane {err:.2f} dB from the JAX plane"
    np.testing.assert_allclose(
        diag["phase_offset"].numpy(),
        np.stack([np.asarray(d["phase_offset"]) for _, d in want]),
        rtol=0, atol=1e-4)
    # the demap on the plane of the whole port chain
    eq, diag = rx.compute_plane(frames)
    demap_parity(jr, rx, eq.numpy(), None)
    packed, jdiag = jr.compute_plane(frames)
    want_llr = np.array(jr._demap_fn(packed)[0]).T
    llr = rx_chain.packed_to_llr(eq, rx.plan, rx.consts)[0].numpy()
    a = ldpc.decode_plain(torch.from_numpy(llr), tplp.ldpc_table_name, 15)
    b = ldpc.decode_plain(torch.from_numpy(want_llr), tplp.ldpc_table_name,
                          15)
    assert a[1].all() and b[1].all() and torch.equal(a[0], b[0])
    res = rx.receive_plane(eq, diag)
    _assert_ts(res, ts)
    assert res.snr_db > 15.0
    np.testing.assert_array_equal(res.ts_bytes,
                                  jr.receive_plane(packed, jdiag).ts_bytes)


def test_miso_prime_ideal_sum():
    """prime() acquires L1 from the clean sum of both groups through the
    host reference path's ideal Alamouti combine (JAX
    test_miso_prime_ideal_sum), and the receiver decodes the mix."""
    _, tmode = mode_pair(MISO_MODE)
    _, tplp = plp_pair(PLP)
    frames, clean, ts, l1_post = _miso_frames(tmode, tplp)
    rx = trx.TorchReceiver(trx.RxConfig(mode=tmode, plp=tplp,
                                        n_fec_per_frame=N_FEC, n_ti=1),
                           device="cpu").prime(clean[0])
    assert rx._l1_post_cells == l1_post
    _assert_ts(rx.receive(clean), ts)
    _assert_ts(rx.receive(frames), ts)


def test_t2_lite_rate_2_5_frame_receive_matches_jax():
    """JAX test_t2_lite_rate_2_5_frame_receive: T2-Lite (annex I) 16QAM at
    the Lite-only rate 2/5 (table B9) at 12 dB, primed from frame 0; the
    port's and the JAX receiver's TS bytes, equal to the transmitted."""
    _, tmode = mode_pair(LITE_MODE)
    plp_spec = dict(PLP, code_rate="C2_5")
    _, tplp = plp_pair(plp_spec)
    assert tplp.ldpc_table_name == "B9"
    tx = Transmitter(TxConfig(mode=tmode, plp=tplp, fec_blocks_per_frame=4,
                              num_t2_frames=2))
    assert tx.l1_pre.s1 == 3
    ts = random_ts_stream(4 * 4 * (tplp.k_bch // 8 - 10) // 188, seed=32)
    iq = tx.modulate(ts)
    F = tmode.frame_samples
    rng = np.random.default_rng(2)
    n = np.sqrt(np.mean(np.abs(iq) ** 2) / 10 ** 1.2 / 2)   # 12 dB SNR
    sig = (iq + n * (rng.standard_normal(len(iq))
                     + 1j * rng.standard_normal(len(iq)))).astype(np.complex64)
    frames = sig[:2 * F].reshape(2, F)
    jr, rx = _receivers(LITE_MODE, plp_spec)
    jres = jr.prime(frames[0]).receive(frames)
    res = rx.prime(frames[0]).receive(frames)
    _assert_ts(res, ts, min_pkts=10)
    np.testing.assert_array_equal(res.ts_bytes, jres.ts_bytes)
    assert rx.decoder.plan.cnl == 4              # B9: the 5-slot kernel


def _blind(path, mode, max_frames=4):
    sink = sinks.BufferTsSink()
    cfg = stream.StreamConfig(frames_per_batch=1,
                              acq_elem_samples=3 * mode.frame_samples)
    rx = stream.StreamingReceiver(sources.RawFileSource(str(path)), sink,
                                  cfg, device="cpu")
    return rx, rx.run(max_frames=max_frames), sink.data


def test_miso_blind_stream(tmp_path):
    """JAX test_miso_blind_stream on the port: a u8 capture of the
    two-group mix with CFO and SRO acquires MISO from the S1 field, tracks
    and recovers the transmitted TS."""
    _, tmode = mode_pair(MISO_MODE)
    _, tplp = plp_pair(PLP)
    tx = Transmitter(TxConfig(mode=tmode, plp=tplp, fec_blocks_per_frame=4,
                              num_t2_frames=7))
    ts = random_ts_stream(9 * 4 * (tplp.k_bch // 8 - 10) // 188, seed=8)
    iq1, iq2 = tx.modulate(ts)
    dev = impair(_two_path_mix(iq1, iq2, snr_db=27.0), ChannelConfig(
        device_rate=10_000_000, cfo_hz=12e3, sro_ppm=9.0, snr_db=40.0,
        phase0=0.7, seed=3))
    path = tmp_path / "capture_dvbt2_miso_0_10000000_8.raw"
    quantize(dev, "u8", scale=0.4).tofile(path)
    rx, stats, got = _blind(path, tmode)
    assert stats.state == "locked", stats
    assert rx.mode.miso and rx.mode.pilot_pattern.name == "PP3"
    assert stats.ldpc_failures == 0 and stats.bch_dirty == 0, stats
    assert abs(stats.cfo_hz - 12e3) < 500, stats.cfo_hz
    assert len(got) > 188 * 40 and ts_in_stream(got, ts)


def test_t2_lite_blind_stream(tmp_path):
    """JAX test_t2_lite_blind_stream on the port: a T2-Lite mux at the
    Lite-only rate 1/3 (table B8), QPSK at 11 dB, acquires blind from the
    S1=3 preamble and recovers the transmitted TS."""
    _, tmode = mode_pair(LITE_MODE)
    _, tplp = plp_pair(dict(PLP, constellation="QPSK", code_rate="C1_3"))
    tx = Transmitter(TxConfig(mode=tmode, plp=tplp, fec_blocks_per_frame=4,
                              num_t2_frames=6))
    ts = random_ts_stream(8 * 4 * (tplp.k_bch // 8 - 10) // 188, seed=31)
    dev = impair(tx.modulate(ts), ChannelConfig(
        device_rate=10_000_000, cfo_hz=-7e3, sro_ppm=6.0, snr_db=11.0,
        phase0=0.2, seed=12))
    path = tmp_path / "capture_dvbt2_lite_0_10000000_8.raw"
    quantize(dev, "u8", scale=0.4).tofile(path)
    rx, stats, got = _blind(path, tmode)
    assert stats.state == "locked", stats
    assert rx.mode.lite and not rx.mode.miso
    assert rx.rx.plp.ldpc_table_name == "B8"
    assert stats.ldpc_failures == 0 and stats.bch_dirty == 0, stats
    assert len(got) > 188 * 20 and ts_in_stream(got, ts)
