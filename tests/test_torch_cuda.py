"""The port on the card: the CUDA LDPC kernel against its plain twin, and
the receiver on cuda against the receiver on the CPU.

These need an NVIDIA GPU with nvcc and skip without one.  On such a
machine (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# beside the flagship's table: the 64-bit state word (NORMAL and SHORT
# r5/6), the largest state (NORMAL r1/2) and the T2-Lite-only B8 (r1/3)
# and B9 (r2/5), served by the 5-slot kernel with predicated slots
@pytest.mark.parametrize("rate,frame,n_cw", [("C1_2", "SHORT", 64),
                                             ("C2_3", "SHORT", 64),
                                             ("C2_3", "NORMAL", 48),
                                             ("C5_6", "NORMAL", 32),
                                             ("C5_6", "SHORT", 64),
                                             ("C1_2", "NORMAL", 32),
                                             ("C1_3", "SHORT", 64),
                                             ("C2_5", "SHORT", 64)])
def test_kernel_matches_twin(cuda, rate, frame, n_cw):
    from chip_smoke import check_kernel_against_twin, coded_llrs
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    llr, plp = coded_llrs(rate, frame, n_cw, seed=9)
    before = ldpc.LayeredDecoder.launches
    screens = ldpc.LayeredDecoder.screen_launches
    res, got = check_kernel_against_twin(torch.from_numpy(llr).to(cuda), plp)
    assert ldpc.LayeredDecoder.launches == before + 1
    assert ldpc.LayeredDecoder.screen_launches == screens + 1
    assert res["max_abs_err"] == 0
    assert got[0].device.type == "cuda"
    # the noise-free quarter decodes in one sweep, the hopeless quarter not
    assert got[1][0::4].all() and (got[2][0::4] == 1).all()
    assert not got[3][1::4].any()


def test_shared_memory_is_sized_alike_in_c_and_python(cuda):
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build, ldpc
    lib = _build.load_kernel("ldpc_layered")
    for table in ("NORMAL_C1_2", "NORMAL_C2_3", "NORMAL_C5_6", "SHORT_C1_4",
                  "SHORT_C3_4", "SHORT_C5_6"):
        dec = ldpc.LayeredDecoder(table)
        plan = dec.plan
        assert lib.ldpc_layered_shared_bytes(
            plan.k, plan.q, plan.cnl, int(dec.uniform)) == dec.shared_bytes


def test_kernel_refuses_a_table_it_has_no_room_for(cuda):
    """A code whose posteriors and state exceed a block's shared memory is
    refused with its sizes named, before any launch."""
    import ctypes
    from sdr_receiver_dvb_t2_tpu_torch.ops import _build
    lib = _build.load_kernel("ldpc_layered")
    null = ctypes.c_void_p(0)
    err = lib.ldpc_layered_decode(null, null, null, null, null, null, null,
                                  null, null, 0, 0, 1, 360 * 600, 90, 5, 1,
                                  15, null)
    assert err != 0
    assert b"shared memory" in lib.last_error_detail()


def test_receiver_cuda_equals_cpu(cuda):
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import (
        RxConfig, TorchReceiver)
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        CodeRate, Constellation, FecFrame, FftMode, GuardInterval,
        PilotPattern, PlpConfig, T2Mode)
    mode = T2Mode(FftMode.FFT_8K, GuardInterval.G1_32, PilotPattern.PP3,
                  True, n_data_symbols=20)
    plp = PlpConfig(constellation=Constellation.QAM64,
                    code_rate=CodeRate.C2_3, fec_frame=FecFrame.SHORT,
                    num_blocks_max=10, time_il_length=3)
    ts = random_ts_stream(400)
    iq = Transmitter(TxConfig(mode=mode, plp=plp,
                              fec_blocks_per_frame=6)).modulate(ts)
    f = len(iq) // mode.frame_samples
    frames = iq[:f * mode.frame_samples].reshape(f, -1)
    rng = np.random.default_rng(7)
    sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / 10 ** 2.5 / 2)   # 25 dB
    frames = (frames + sigma * (rng.standard_normal(frames.shape) + 1j
                                * rng.standard_normal(frames.shape))
              ).astype(np.complex64)
    cfg = RxConfig(mode=mode, plp=plp, n_fec_per_frame=6, n_ti=3)
    a = TorchReceiver(cfg, device="cpu").prime(frames[0]).receive(frames)
    rx = TorchReceiver(cfg, device=cuda).prime(frames[0])
    b = rx.receive(frames)
    assert b.ldpc_ok.all() and b.bch_clean.all()
    assert np.array_equal(b.ts_bytes, a.ts_bytes)
    assert np.array_equal(b.ts_bytes, ts[:len(b.ts_bytes)])
    np.testing.assert_array_equal(b.ldpc_iters, a.ldpc_iters)
    # same float32 stages, summed in another order on the card
    assert abs(b.snr_db - a.snr_db) < 0.01
    outs = list(rx.receive_stream([frames, frames]))
    assert all(o.bch_clean.all() for o in outs)


# ---------------------------------------------------------------------------
# the streaming slice on the card against the CPU
# ---------------------------------------------------------------------------
def _bandlimited(n, seed, bw=0.8):
    rng = np.random.default_rng(seed)
    spec = np.zeros(n, dtype=np.complex128)
    k = int(n * bw / 2)
    spec[:k] = rng.standard_normal(k) + 1j * rng.standard_normal(k)
    spec[-k:] = rng.standard_normal(k) + 1j * rng.standard_normal(k)
    return (np.fft.ifft(spec) * np.sqrt(n / (2 * k))).astype(np.complex64)


def _rel(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float(np.max(np.abs(a - b)) / np.sqrt(np.mean(np.abs(b) ** 2)))


def test_frontend_block_cuda_equals_cpu(cuda):
    """One front-end block at the stream's size (2^19 Farrow outputs,
    10 Msps in) with cuDNN's TF32 switch left on, as PyTorch ships it: the
    convolutions stay float32 (TF32 would round their inputs to ~1e-3),
    so every output is within 2e-5 of the CPU's rms, the conditioner's
    statistics within 1e-5 relative.  The Farrow positions may move by
    FMA contraction at a floor boundary, so the samples are compared, not
    the indices."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import frontend as fe
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        step = 10e6 / (4 * 64e6 / 7) * (1 + 19e-6)
        n_up = 1 << 19
        hi, lo = fe.split_step(step)
        raw = torch.from_numpy(_bandlimited(int(n_up * step) + 64, 1) * 0.3
                               + np.complex64(0.02 - 0.01j))
        hb = torch.from_numpy(np.asarray(fe.halfband_taps(), np.float32))
        fir = torch.from_numpy(fe.fir_taps("medium"))
        hist = _bandlimited(64, 2)
        outs = {}
        for dev in ("cpu", cuda):
            h = [torch.from_numpy(hist[:len(fir) - 1]).to(dev),
                 torch.from_numpy(hist[:len(hb) - 1]).to(dev),
                 torch.from_numpy(hist[1:len(hb)]).to(dev)]
            outs[str(dev)] = fe.frontend_block(
                raw.to(dev), np.float32(0.01), np.float32(1.02),
                np.float32(0.4), np.float32(0.0213), np.float32(1.3), hi, lo,
                *h, fir.to(dev), hb.to(dev), n_up,
                (np.float32(0.3), np.float32(0.05), np.float32(0.01),
                 np.float32(-0.02)))
        a, b = outs["cuda"], outs["cpu"]
        assert a[0].device.type == "cuda" and a[0].shape == (n_up // 2,)
        for got, want in zip(a[:4], b[:4]):          # elem and histories
            assert _rel(got, want) < 2e-5
        np.testing.assert_allclose(a[4].cpu().numpy(), b[4].numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(a[5].cpu().numpy(), b[5].numpy(),
                                   rtol=1e-3, atol=1e-6)
        # the convolutions alone, against a float64 oracle
        x = torch.from_numpy(_bandlimited(1 << 20, 3))
        y = fe._conv_f32(x.to(cuda), fir.to(cuda), 2)
        want = np.convolve(x.numpy().astype(np.complex128),
                           fe.fir_taps("medium").astype(np.float64),
                           mode="valid")[::2]
        assert _rel(y, torch.from_numpy(want)) < 2e-6
        assert cudnn.allow_tf32                       # restored after
    finally:
        cudnn.allow_tf32 = saved


def test_p1_detect_cuda_equals_cpu(cuda):
    """P1 search over an acquisition window of the flagship's size (3.5 M
    samples) with the P1 near its end, where the float32 cumulative sums
    have grown most: t0 equal, the peak metric within 1e-3, cfo_frac within
    1e-4 rad/sample."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import p1_detect
    from sdr_receiver_dvb_t2_tpu_torch.params import p1 as p1_mod
    rng = np.random.default_rng(4)
    n = 3_500_000
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
         * np.sqrt(0.05)).astype(np.complex64)
    x[3_100_000:3_100_000 + 2048] += p1_mod.generate(0, 5)
    x *= np.exp(1j * 0.0021 * np.arange(n)).astype(np.complex64)
    xt = torch.from_numpy(x)
    t0, peak, cfo = p1_detect.detect(xt.to(cuda))
    ct0, cpeak, ccfo = p1_detect.detect(xt)
    assert t0.device.type == "cuda"
    assert int(t0) == int(ct0) and abs(int(t0) - 3_100_000) <= 2
    assert abs(float(peak) - float(cpeak)) < 1e-3 and float(peak) > 0.3
    assert abs(float(cfo) - float(ccfo)) < 1e-4


@pytest.mark.parametrize("table", ["SHORT_C1_4", "SHORT_C1_2"])
def test_flooding_decoder_cuda_equals_cpu(cuda, table):
    """The L1 soft path's flooding decoder: bit-exact hard/ok/iters on
    integer LLRs (index_add_ sums integers exactly in any order)."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_decode
    from sdr_receiver_dvb_t2_tpu_torch.params import ldpc as ldpc_par
    code = ldpc_par.get_code(table)
    rng = np.random.default_rng(5)
    cw = code.encode(rng.integers(0, 2, (6, code.k), dtype=np.uint8))
    llr = (1 - 2 * cw.astype(np.float32)) * 12 + rng.normal(
        0, 1, cw.shape) * np.array([0, 3, 5, 6.5, 8, 20])[:, None]
    llr = torch.from_numpy(llr.round().clip(-127, 127).astype(np.float32))
    dec = ldpc_decode.make_decoder(table, 30)
    got, want = dec(llr.to(cuda)), dec(llr)
    assert got[0].device.type == "cuda"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert bool(want[1][0]) and not bool(want[1][5])


def test_stream_cuda_equals_cpu(cuda, tmp_path):
    """The 2K u8 capture (10 Msps, CFO 31 kHz, SRO 19 ppm) through the
    streaming receiver on the card and on the CPU: locked on the same mode,
    the same TS bytes, equal to the transmitted stream, one decoder launch
    a batch."""
    from _port_capture import port_capture, ts_in_stream
    from sdr_receiver_dvb_t2_tpu_torch.io import sinks, sources
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    from sdr_receiver_dvb_t2_tpu_torch.runtime import stream
    path, ts, mode = port_capture(tmp_path, guard="G1_32",
                                  pilot_pattern="PP4")
    out = {}
    for dev in ("cpu", cuda):
        sink = sinks.BufferTsSink()
        cfg = stream.StreamConfig(frames_per_batch=1,
                                  acq_elem_samples=3 * mode.frame_samples)
        rx = stream.StreamingReceiver(sources.RawFileSource(path), sink, cfg,
                                      device=dev)
        before = ldpc.LayeredDecoder.launches
        st = rx.run(max_frames=4)
        out[str(dev)] = (st, sink.data, rx.mode,
                         ldpc.LayeredDecoder.launches - before)
    (st, got, m, launches), (cst, cgot, cm, _) = out["cuda"], out["cpu"]
    assert st.state == cst.state == "locked" and m == cm
    assert st.frames == cst.frames >= 4 and launches == st.frames
    assert st.ldpc_failures == st.bch_dirty == 0
    assert abs(st.cfo_hz - 31e3) < 500
    assert got.tobytes() == cgot.tobytes() and ts_in_stream(got, ts)


# ---------------------------------------------------------------------------
# the SFN and MISO equalizers on the card against the CPU
# ---------------------------------------------------------------------------
def _eq_frames(miso):
    """Two 2K GI 1/8 PP3 frames (QAM16 SHORT r1/2 rotated) of the port's
    transmitter: SISO through a 0 dB echo at 200 samples (the SFN plan),
    or MISO with each transmit group through its own two-path channel;
    24 dB AWGN.  Returns (receiver on cuda, receiver on the CPU, frames)."""
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import (
        RxConfig, TorchReceiver)
    from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        CodeRate, Constellation, FecFrame, FftMode, GuardInterval,
        PilotPattern, PlpConfig, T2Mode)
    mode = T2Mode(FftMode.FFT_2K, GuardInterval.G1_8, PilotPattern.PP3,
                  False, n_data_symbols=30, miso=miso)
    plp = PlpConfig(constellation=Constellation.QAM16,
                    code_rate=CodeRate.C1_2, fec_frame=FecFrame.SHORT,
                    rotation=True, time_il_length=1)
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=4,
                              num_t2_frames=3))
    iq = tx.modulate(random_ts_stream(120, seed=4))
    n = 3 * mode.frame_samples
    if miso:
        g1 = np.zeros(40, np.complex64)
        g1[0], g1[17] = 0.9 * np.exp(1j * 0.3), 0.25 * np.exp(-1j * 2.1)
        g2 = np.zeros(40, np.complex64)
        g2[3], g2[29] = 0.55 * np.exp(1j * 1.2), 0.2 * np.exp(1j * 0.4)
        iq = np.convolve(iq[0][:n], g1)[:n] + np.convolve(iq[1][:n], g2)[:n]
    else:
        iq = iq[:n] + 1j * np.concatenate([np.zeros(200), iq[:n - 200]])
    rng = np.random.default_rng(5)
    sigma = np.sqrt(np.mean(np.abs(iq) ** 2) / 10 ** 2.4 / 2)
    iq = iq + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    frames = iq[mode.frame_samples:].reshape(2, -1).astype(np.complex64)
    cfg = RxConfig(mode=mode, plp=plp, n_fec_per_frame=4, n_ti=1)
    rxs = []
    for dev in ("cuda", "cpu"):
        rx = TorchReceiver(cfg, device=dev)
        rx._l1_post_cells = tx.l1_pre.l1_post_size
        rxs.append(rx)
    return rxs[0], rxs[1], frames


def _rel_db(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return 10 * np.log10(np.sum(np.abs(a - b) ** 2) / np.sum(np.abs(b) ** 2))


@pytest.mark.parametrize("miso", [False, True], ids=["sfn", "miso"])
def test_sfn_and_miso_planes_cuda_equal_cpu(cuda, miso):
    """The equalized plane (and on the SFN plan csi and the delay profile)
    on the card within -80 dB (relative rms) of the CPU's, the same
    float32 stages summed in another order; both decode every codeword
    to the same TS."""
    g, c, frames = _eq_frames(miso)
    eq_g, d_g = g.compute_plane(frames)
    eq_c, d_c = c.compute_plane(frames)
    assert eq_g.device.type == "cuda"
    assert _rel_db(eq_g, eq_c) < -80.0
    if not miso:
        assert _rel_db(d_g["csi"], d_c["csi"]) < -80.0
        cir_g, cir_c = d_g["cir_p"].cpu(), d_c["cir_p"]
        assert float((cir_g - cir_c).abs().max()) < 1e-4 * float(cir_c.max())
    a, b = g.receive_plane(eq_g, d_g), c.receive_plane(eq_c, d_c)
    assert a.ldpc_ok.all() and a.bch_clean.all() and len(a.ts_bytes) > 0
    np.testing.assert_array_equal(a.ts_bytes, b.ts_bytes)
    assert "csi" not in a.diag


def test_sfn_plane_holds_float32_with_tf32_allowed(cuda):
    """With cuBLAS's TF32 switch on (the process's choice, which would
    round the banded products' and the delay profile's inputs to ~1e-3),
    the SFN plane, csi and delay profile stay within the float32
    tolerance of the CPU, and the switch is restored afterwards."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    mm.allow_tf32 = True
    try:
        g, c, frames = _eq_frames(False)
        eq_g, d_g = g.compute_plane(frames)
        eq_c, d_c = c.compute_plane(frames)
        assert _rel_db(eq_g, eq_c) < -80.0
        assert _rel_db(d_g["csi"], d_c["csi"]) < -80.0
        assert _rel_db(d_g["cir_p"], d_c["cir_p"]) < -80.0
        assert mm.allow_tf32
    finally:
        mm.allow_tf32 = saved
