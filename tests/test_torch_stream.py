"""The whole slice on the CPU: a raw u8 SDR capture through the port's
``StreamingReceiver(..., device="cpu")`` (front end, P1, blind acquisition,
tracking, the frame receiver with the LDPC twin and the native BB parser)
against the JAX package's ``StreamingReceiver`` on the same file: the same
mode, frame count and TS bytes, equal to the transmitted stream.

The capture is tests/test_stream_e2e.py's ``_make_capture`` made by the
port's own transmitter and channel, byte for byte the JAX one.  At its GI
1/8 PP7 both packages' acquisition choose the SFN (Wiener-row) plan, and
both receivers give the same TS bytes; most checks below run the same
capture at GI 1/32 PP4, where both run the linear plan.

Also: checkpoint and resume, the UDP source across a timeout, the sinks,
the threaded source, the AGC, the diagnostics and the monitor.
"""
import dataclasses
import io
import socket
import struct
import types

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one torch thread per worker)
from _port_capture import port_capture, ts_in_stream
from sdr_receiver_dvb_t2_tpu.io import sinks as jsinks
from sdr_receiver_dvb_t2_tpu.io import sources as jsources
from sdr_receiver_dvb_t2_tpu.runtime import stream as jstream
from sdr_receiver_dvb_t2_tpu_torch.io import sinks, sources
from sdr_receiver_dvb_t2_tpu_torch.models import receiver
from sdr_receiver_dvb_t2_tpu_torch.runtime import (agc, diagnostics,
                                                   monitor, stream)


def _cfg(mode, module=stream, **kw):
    extra = dict(use_pallas=False) if module is jstream else {}
    return module.StreamConfig(frames_per_batch=1,
                               acq_elem_samples=3 * mode.frame_samples,
                               **extra, **kw)


@pytest.fixture(scope="module")
def parity_run(tmp_path_factory):
    """The GI 1/32 PP4 capture through both receivers (4 frames each)."""
    tmp = tmp_path_factory.mktemp("stream")
    path, ts, mode = port_capture(tmp, guard="G1_32", pilot_pattern="PP4")
    sink = sinks.BufferTsSink()
    rx = stream.StreamingReceiver(sources.RawFileSource(path), sink,
                                  _cfg(mode), device="cpu")
    stats = rx.run(max_frames=4)
    jsink = jsinks.BufferTsSink()
    jrx = jstream.StreamingReceiver(jsources.RawFileSource(path), jsink,
                                    _cfg(mode, jstream))
    jstats = jrx.run(max_frames=4)
    return dict(path=path, ts=ts, mode=mode, rx=rx, stats=stats,
                got=sink.data, jrx=jrx, jstats=jstats, jgot=jsink.data)


@pytest.fixture(scope="module")
def sfn_run(tmp_path_factory):
    """_make_capture's GI 1/8 PP7 capture through both receivers (4 frames
    each): the SFN plan, chosen by both acquisitions."""
    tmp = tmp_path_factory.mktemp("sfn_stream")
    path, ts, mode = port_capture(tmp)
    sink = sinks.BufferTsSink()
    rx = stream.StreamingReceiver(sources.RawFileSource(path), sink,
                                  _cfg(mode), device="cpu")
    stats = rx.run(max_frames=4)
    jsink = jsinks.BufferTsSink()
    jrx = jstream.StreamingReceiver(jsources.RawFileSource(path), jsink,
                                    _cfg(mode, jstream))
    jstats = jrx.run(max_frames=4)
    return dict(path=path, ts=ts, mode=mode, rx=rx, stats=stats,
                got=sink.data, jrx=jrx, jstats=jstats, jgot=jsink.data)


def test_capture_is_the_jax_capture(tmp_path, sfn_run):
    from test_stream_e2e import _make_capture
    (tmp_path / "jax").mkdir()
    jpath, jts, _ = _make_capture(tmp_path / "jax")
    path, ts = sfn_run["path"], sfn_run["ts"]
    assert path.rsplit("/", 1)[1] == jpath.rsplit("/", 1)[1]
    np.testing.assert_array_equal(ts, jts)
    a, b = np.fromfile(path, np.uint8), np.fromfile(jpath, np.uint8)
    assert len(a) > 1_000_000
    np.testing.assert_array_equal(a, b)
    assert sources.parse_raw_filename(path) == (10_000_000, "u8")
    # both acquisitions measure a spread that asks for the SFN plan, and
    # both receivers give the same TS, a run of the transmitted stream
    r = sfn_run
    st, jst = r["stats"], r["jstats"]
    assert st.state == jst.state == "locked"
    assert r["rx"].rx.cfg.sfn and r["jrx"].rx.cfg.sfn
    assert r["rx"].rx.plan.eq.cir_tab is not None
    assert st.frames == jst.frames >= 4
    assert st.ldpc_failures == jst.ldpc_failures == 0
    assert len(r["got"]) > 188 * 40
    assert r["got"].tobytes() == r["jgot"].tobytes()
    assert ts_in_stream(r["got"], ts)


def test_stream_matches_jax_receiver(parity_run):
    r = parity_run
    st, jst = r["stats"], r["jstats"]
    assert st.state == jst.state == "locked"
    m, jm = r["rx"].mode, r["jrx"].mode
    assert (m.fft_size, m.guard.name, m.pilot_pattern.name,
            m.n_data_symbols) == (jm.fft_size, jm.guard.name,
                                  jm.pilot_pattern.name, jm.n_data_symbols)
    assert st.frames == jst.frames >= 4
    assert st.ldpc_failures == jst.ldpc_failures == 0
    assert st.bch_dirty == jst.bch_dirty == 0
    assert abs(st.cfo_hz - 31e3) < 500 and abs(jst.cfo_hz - 31e3) < 500
    assert abs(st.cfo_hz - jst.cfo_hz) < 50
    assert abs(st.snr_db - jst.snr_db) < 1.0
    assert st.ts_packets == jst.ts_packets
    assert len(r["got"]) > 188 * 40
    assert r["got"].tobytes() == r["jgot"].tobytes()
    assert ts_in_stream(r["got"], r["ts"])


def test_stream_of_complex_samples_matches_raw(parity_run):
    """An in-memory complex64 source (its ring holds complex64, nothing to
    convert) gives the TS of the same capture read as u8."""
    r = parity_run
    raw = np.fromfile(r["path"], np.uint8)
    iq = jstream.raw_to_complex_np(raw, "u8")
    sink = sinks.BufferTsSink()
    rx = stream.StreamingReceiver(sources.ArraySource(iq, 10e6), sink,
                                  _cfg(r["mode"]), device="cpu")
    assert rx._raw.dtype == np.complex64 and rx._w == 1
    rx.run(max_frames=4)
    assert sink.data.tobytes() == r["got"].tobytes()


def test_stream_uses_native_parser_and_twin_decoder(parity_run):
    from sdr_receiver_dvb_t2_tpu_torch.io import native
    rx = parity_run["rx"]
    assert rx.device.type == "cpu"
    assert isinstance(rx.rx.bb, native.NativeBBFrameParser)
    assert rx.rx.cfg.ldpc_max_iters == 15


def test_monitor_renders_at_first_call(parity_run):
    """The port's monitor starts its clock at -inf: the first call renders
    whatever the host's uptime, later calls wait out ``interval``."""
    buf = io.StringIO()
    mon = monitor.Monitor(interval=3600.0, out=buf, clear=False)
    assert mon._t_last == -float("inf")
    assert mon.maybe_render(parity_run["rx"])
    assert not mon.maybe_render(parity_run["rx"])
    panel = buf.getvalue()
    for token in ("spectrum", "constellation", "ldpc:", "L1:", "PLP 0"):
        assert token in panel, token


def test_checkpoint_resume(parity_run):
    """save_state/load_state: a fresh receiver re-locks from a P1 search
    alone and decodes the rest of the stream exactly."""
    path, mode = parity_run["path"], parity_run["mode"]
    src = sources.RawFileSource(path)
    rx1 = stream.StreamingReceiver(src, sinks.BufferTsSink(), _cfg(mode),
                                   device="cpu")
    with pytest.raises(RuntimeError):
        stream.save_state(rx1)
    assert rx1.acquire()
    rx1.step_batch()
    state = stream.save_state(rx1)
    src.close()
    sink2 = sinks.BufferTsSink()
    rx2 = stream.StreamingReceiver(sources.RawFileSource(path), sink2,
                                   _cfg(mode), device="cpu")
    assert stream.load_state(rx2, state)
    assert rx2.mode.fft_size == mode.fft_size and rx2.stats.state == "locked"
    stats = rx2.run(max_frames=3)
    assert stats.frames >= 3
    assert stats.ldpc_failures == 0 and stats.bch_dirty == 0
    assert ts_in_stream(sink2.data, parity_run["ts"])


def test_config_from_l1_refuses_sfn(parity_run):
    """config_from_l1(sfn=True) no longer refuses: it carries sfn into the
    configuration and the receiver's plan takes the Wiener rows, on a mode
    whose default plan is linear."""
    rx = parity_run["rx"]
    cfg = receiver.config_from_l1(rx.mode, rx._l1_pre, rx._l1_post, 0)
    assert cfg.n_fec_per_frame == 4 and cfg.mode == rx.mode
    assert not cfg.sfn and rx.rx.plan.eq.ph_rot is None
    sfn = receiver.config_from_l1(rx.mode, rx._l1_pre, rx._l1_post, 0,
                                  sfn=True)
    assert sfn.sfn and sfn.n_fec_per_frame == 4
    r = receiver.TorchReceiver(sfn, device="cpu")
    r._l1_post_cells = rx.rx._l1_post_cells
    assert r.plan.eq.sfn and r.plan.eq.ph_rot is not None
    assert "cir_tab" in r.consts and len(r.plan.eq.cir_d) > 0


def test_checkpoint_resume_keeps_sfn(sfn_run):
    """save_state/load_state on the SFN capture: the restored receivers
    keep sfn, re-lock from a P1 search and decode the rest exactly, with
    the first-path timing loop running."""
    path, mode = sfn_run["path"], sfn_run["mode"]
    src = sources.RawFileSource(path)
    rx1 = stream.StreamingReceiver(src, sinks.BufferTsSink(), _cfg(mode),
                                   device="cpu")
    assert rx1.acquire()
    rx1.step_batch()
    state = stream.save_state(rx1)
    src.close()
    assert [p["sfn"] for p in state["plps"]] == [True]
    sink2 = sinks.BufferTsSink()
    rx2 = stream.StreamingReceiver(sources.RawFileSource(path), sink2,
                                   _cfg(mode), device="cpu")
    assert stream.load_state(rx2, state)
    assert rx2.rx.cfg.sfn
    stats = rx2.run(max_frames=3)
    assert stats.frames >= 3 and stats.ldpc_failures == 0
    assert abs(stats.cir_nudge) <= 24
    assert ts_in_stream(sink2.data, sfn_run["ts"])


@pytest.mark.parametrize("fmt", ["u8", "s8", "s16", "f32"])
def test_raw_to_complex_np_matches_jax(fmt):
    """The stream converts its raw ring with ``frontend.raw_to_iq`` where
    the block lies: the same complex64 values, bit for bit, as the JAX
    stream's host conversion ``raw_to_complex_np``."""
    rng = np.random.default_rng(0)
    dt = sources.WIRE_DTYPES[fmt]
    block = (rng.standard_normal(4096).astype(np.float32) if fmt == "f32"
             else rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, 4096,
                               dtype=dt))
    src = types.SimpleNamespace(info=sources.SourceInfo(10e6, fmt))
    rx = stream.StreamingReceiver(src, None, device="cpu")
    got = rx._iq(torch.from_numpy(block)).numpy()
    assert got.dtype == np.complex64 and rx._raw.dtype == dt
    np.testing.assert_array_equal(got, jstream.raw_to_complex_np(block, fmt))


_HDR = struct.Struct("<4sIQ")


def _udp_pair(seq):
    src = sources.UdpIqSource(0, 10e6, "u8", host="127.0.0.1", timeout=0.2,
                              seq=seq)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    return src, tx, ("127.0.0.1", src._sock.getsockname()[1])


@pytest.mark.parametrize("seq", [False, True])
def test_udp_source_keeps_partial_payload_across_timeout(seq):
    """A read that times out keeps what arrived (and the zero fill of a
    gap) for the next read, so no later byte shifts."""
    src, tx, addr = _udp_pair(seq)
    data = np.random.default_rng(2).integers(0, 256, 4000, np.uint8)
    chunks = [(0, data[:1000]), (1000, data[1000:1500]),
              (2000, data[2000:4000])]      # 1500:2000 is lost
    if not seq:
        chunks = [(0, data[:1500]), (1500, data[1500:4000])]

    def send(off, payload):
        hdr = _HDR.pack(sources.SEQ_MAGIC, 0, off) if seq else b""
        tx.sendto(hdr + payload.tobytes(), addr)
    try:
        for off, payload in chunks[:-1]:
            send(off, payload)
        assert src.read(2000) is None        # 4000 bytes asked, 1500 came
        send(*chunks[-1])
        got = src.read(2000)
        want = data.copy()
        if seq:
            want[1500:2000] = 0x80            # u8 zero level
            assert src.gap_events == 1 and src.gap_bytes == 500
        np.testing.assert_array_equal(got, want)
        assert src.read(1) is None            # nothing more
    finally:
        tx.close()
        src.close()


def test_sinks(tmp_path):
    data = np.resize(np.arange(256, dtype=np.uint8), 188 * 15)
    f = sinks.make_sink(str(tmp_path / "out.ts"))
    f.write(data[:188 * 7])
    f.write(data[188 * 7:])
    f.close()
    assert (tmp_path / "out.ts").read_bytes() == data.tobytes()
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2.0)
    u = sinks.make_sink(f"udp://127.0.0.1:{rx.getsockname()[1]}")
    u.write(data)
    got = rx.recv(65536) + rx.recv(65536)
    assert len(got) == 188 * 14               # two 7-packet datagrams
    u.close()                                 # flushes the remainder
    got += rx.recv(65536)
    rx.close()
    assert got == data.tobytes()
    b = sinks.BufferTsSink()
    b.write(data)
    np.testing.assert_array_equal(b.data, data)


def test_threaded_source_roundtrip(tmp_path):
    raw = np.random.default_rng(0).integers(0, 256, 2 * 18 * (1 << 14),
                                            dtype=np.uint8)
    path = tmp_path / "x_1000000_8.raw"
    raw.tofile(path)
    src = sources.ThreadedSource(sources.RawFileSource(str(path)),
                                 block_samples=1 << 14)
    got = []
    while (blk := src.read(50_000)) is not None:
        got.append(blk)
    src.close()
    out = np.concatenate(got)
    assert len(out) == len(raw) and src.dropped_samples == 0
    np.testing.assert_array_equal(out, raw)


class _FakeSdr:
    def __init__(self):
        self.gain = 20.0

    def gain_min(self):
        return 0.0

    def gain_max(self):
        return 40.0

    def set_gain_db(self, g):
        self.gain = g


def test_agc_and_diagnostics():
    a = agc.Agc(_FakeSdr(), agc.AgcConfig(settle_s=0.0))
    assert a.enabled
    assert [a.update(0.5), a.update(0.2), a.update(0.01)] == [19.0, None,
                                                             20.0]
    assert not agc.Agc(object()).enabled
    fs = 10e6
    tone = np.exp(2j * np.pi * 1.25e6 * np.arange(1 << 14) / fs)
    freqs, db = diagnostics.power_spectrum(tone.astype(np.complex64),
                                           nfft=4096, sample_rate=fs)
    assert abs(freqs[np.argmax(db)] - 1.25e6) < 2 * fs / 4096
    st = diagnostics.LdpcStats(max_iters=15, period=8)
    for _ in range(2):
        st.update(3, np.array([True, True, False, True]))
    assert st.failures == 2 and "25.00% failed" in st.summary()
    assert dataclasses.is_dataclass(stream.RunStats())


@pytest.mark.parametrize("reply,ok", [
    ("INFO 10000000 u8 0 40 20 SEQ1", True), ("ERR busy", False)])
def test_remote_sdr_source_reads_the_daemon_info(reply, ok):
    """The control channel's INFO reply sets rate, format and gain range;
    a reply that is not one raises instead of asserting."""
    import threading
    srv = socket.create_server(("127.0.0.1", 0))

    def serve():
        conn, _ = srv.accept()
        with conn, conn.makefile("rw") as f:
            f.readline()
            f.write(reply + "\n")
            f.flush()
            f.readline()                      # QUIT, or the close
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        if ok:
            src = sources.RemoteSdrSource(0, "127.0.0.1",
                                          srv.getsockname()[1],
                                          host="127.0.0.1")
            assert (src.info.sample_rate, src.info.fmt) == (10e6, "u8")
            assert (src.gain_min(), src.gain_max(), src.gain_db) == \
                (0.0, 40.0, 20.0)
            assert src._seq
            src.close()
        else:
            with pytest.raises(ConnectionError, match="ERR"):
                sources.RemoteSdrSource(0, "127.0.0.1",
                                        srv.getsockname()[1])
    finally:
        t.join(timeout=10)
        srv.close()
    assert not t.is_alive()
