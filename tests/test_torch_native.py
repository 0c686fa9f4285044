"""The port's native BB de-encapsulator (io/native.py, the C++ runtime in
sdr_receiver_dvb_t2_tpu_torch/native/) against its plain reference, the
port's Python ``BBFrameParser``, and against the JAX package's Python
parser: TS bytes equal byte for byte and every counter equal, on HEM and
NM, with NPD and ISSY.  Also the build (a temporary name moved into place,
a failed build raises) and the SPSC ring.
"""
import ctypes
import threading

import numpy as np
import pytest

import _torch_common  # noqa: F401  (one torch thread per worker)
from sdr_receiver_dvb_t2_tpu.io import bbframe as jbb
from sdr_receiver_dvb_t2_tpu_torch.io import bbframe, native
from sdr_receiver_dvb_t2_tpu_torch.models.transmitter import random_ts_stream
from sdr_receiver_dvb_t2_tpu_torch.params import prbs

COUNTERS = ("header_errors", "crc_errors", "unsupported", "null_reinserted",
            "truncated", "issy_stripped", "last_issy", "mode_hem", "matype")


def _null_ts_mix(n_pkts, null_every, seed=0):
    """Random TS with pairs of null packets (PID 0x1FFF) interleaved."""
    base = random_ts_stream(n_pkts, seed=seed).reshape(-1, 188)
    null = np.concatenate([np.array([0x47, 0x1F, 0xFF, 0x10], np.uint8),
                           np.full(184, 0xFF, np.uint8)])
    out = []
    for i, p in enumerate(base):
        out.append(p)
        if (i + 1) % null_every == 0:
            out += [null, null]
    return np.concatenate(out)


def _pack(ts, **kw):
    """The same TS through the port's and the JAX package's packers; the
    frames (scrambled bits) must agree."""
    frames = bbframe.BBFramePacker(k_bch=7032, **kw).pack(ts)
    jframes = jbb.BBFramePacker(k_bch=7032, **kw).pack(ts)
    assert len(frames) == len(jframes)
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)
    return frames


def _three_parsers(frames):
    """parse_batch of the packed frames by the native parser, the port's
    Python parser and the JAX package's Python parser."""
    packed = np.stack([np.packbits(f) for f in frames])
    parsers = (native.NativeBBFrameParser(), bbframe.BBFrameParser(),
               jbb.BBFrameParser())
    outs = [p.parse_batch(packed) for p in parsers]
    return parsers, outs


def _assert_same(parsers, outs):
    nat = parsers[0]
    for p, o in zip(parsers[1:], outs[1:]):
        assert o.dtype == np.uint8
        np.testing.assert_array_equal(outs[0], o)
        for name in COUNTERS:
            assert getattr(nat, name) == getattr(p, name), name


def _in_stream(got, ts):
    sync, raw = got.tobytes(), ts.tobytes()
    idx = raw.find(sync[:376])
    return idx >= 0 and sync == raw[idx:idx + len(sync)]


CASES = {
    "hem": dict(hem=True),
    "nm": dict(hem=False),
    "hem_npd": dict(hem=True, npd=True),
    "nm_npd": dict(hem=False, npd=True),
    "nm_issy2": dict(hem=False, issyi=True, issy_len=2),
    "nm_issy3": dict(hem=False, issyi=True, issy_len=3),
    "nm_issy3_npd": dict(hem=False, issyi=True, issy_len=3, npd=True),
    "hem_issy": dict(hem=True, issyi=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_batch_equals_python_and_jax(case):
    kw = CASES[case]
    ts = (_null_ts_mix(80, null_every=5) if kw.get("npd")
          else random_ts_stream(120, seed=1))
    frames = _pack(ts, **kw)
    parsers, outs = _three_parsers(frames)
    _assert_same(parsers, outs)
    assert len(outs[0]) > 188 * 40 and _in_stream(outs[0], ts)
    nat = parsers[0]
    assert nat.header_errors == nat.crc_errors == nat.unsupported == 0
    assert nat.mode_hem == kw["hem"]
    if kw.get("npd"):
        assert nat.matype["npd"] == 1 and nat.null_reinserted > 0
    if kw.get("issyi"):
        assert nat.matype["issyi"] == 1 and nat.issy_stripped > 0


def test_parse_one_frame_at_a_time_equals_batch():
    ts = random_ts_stream(120, seed=2)
    frames = _pack(ts, hem=True)
    packed = np.stack([np.packbits(f) for f in frames])
    seq = native.NativeBBFrameParser()
    ref = np.concatenate([seq.parse(f) for f in frames])
    np.testing.assert_array_equal(
        ref, native.NativeBBFrameParser().parse_batch(packed))
    bytewise = native.NativeBBFrameParser()
    np.testing.assert_array_equal(
        ref, np.concatenate([bytewise.parse_bytes(p) for p in packed]))


@pytest.mark.parametrize("hem", [True, False])
def test_corrupt_header_and_garbage_counted_alike(hem):
    """A destroyed header, a dirty frame and pure garbage between good
    frames: the same TS and the same error counters from all three."""
    rng = np.random.default_rng(3)
    frames = _pack(random_ts_stream(200, seed=3), hem=hem)
    bad = [f.copy() for f in frames]
    bad[2][:40] ^= 1                                  # header
    bad[4][500:900] ^= 1                              # data field
    bad.insert(6, rng.integers(0, 2, len(frames[0]), dtype=np.uint8))
    parsers, outs = _three_parsers(bad)
    _assert_same(parsers, outs)
    assert parsers[0].header_errors >= 2
    assert len(outs[0]) % 188 == 0


def test_malformed_issy_rejected_alike():
    """NM frames with the ISSYI bit set but no room for an ISSY field are
    counted as unsupported and yield nothing, in every parser."""
    frames = _pack(random_ts_stream(60, seed=1), hem=False)
    sc = prbs.bb_scrambler(7032)
    bad = []
    for f in frames:
        bits = (np.asarray(f) ^ sc).astype(np.uint8)
        bits[4] = 1                                   # MATYPE-1 ISSYI bit
        bits[72:80] = np.unpackbits(np.uint8(
            bbframe._mode_field(bits[:72], hem=False)))
        bad.append(bits ^ sc)
    parsers, outs = _three_parsers(bad)
    _assert_same(parsers, outs)
    assert len(outs[0]) == 0 and parsers[0].unsupported == len(bad)


def test_crc8_matches_python():
    rng = np.random.default_rng(0)
    lib = native.load()
    for n in (1, 7, 187, 1024):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        assert lib.dvbt2_crc8_bytes(native._as_u8p(data), n) == \
            bbframe.crc8_bytes(data)


def test_make_bb_parser_kinds():
    assert isinstance(native.make_bb_parser(), native.NativeBBFrameParser)
    assert isinstance(native.make_bb_parser("python"), bbframe.BBFrameParser)
    with pytest.raises(ValueError):
        native.make_bb_parser("fastest")


def _small_rx_cfg():
    """A 2K receiver configuration whose code (SHORT r1/2) has the packers'
    K_bch = 7032."""
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import RxConfig
    from sdr_receiver_dvb_t2_tpu_torch.params.modes import (
        CodeRate, Constellation, FecFrame, FftMode, GuardInterval,
        PilotPattern, PlpConfig, T2Mode)
    return RxConfig(
        mode=T2Mode(fft_mode=FftMode.FFT_2K, guard=GuardInterval.G1_32,
                    pilot_pattern=PilotPattern.PP4, extended_carriers=False,
                    n_data_symbols=30),
        plp=PlpConfig(constellation=Constellation.QAM16,
                      code_rate=CodeRate.C1_2, fec_frame=FecFrame.SHORT),
        n_fec_per_frame=4, n_ti=1)


@pytest.mark.parametrize("hem", [True, False])
def test_uncorrectable_codeword_yields_no_ts(hem):
    """A codeword whose BCH parity is beyond repair while its BB frame
    would still parse: the receiver hands the parser a frame that fails
    the header check, so its packets, which the receiver cannot vouch
    for, never reach the TS."""
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import TorchReceiver
    from sdr_receiver_dvb_t2_tpu_torch.params import bch
    rx = TorchReceiver(_small_rx_cfg(), device="cpu")
    plp = rx.plp
    frames = np.stack(_pack(random_ts_stream(120, seed=5), hem=hem)[:4])
    cw = bch.encode(frames, plp.bch_m, plp.bch_t)
    cw[1, plp.k_bch:plp.k_bch + 2 * plp.bch_t + 2] ^= 1   # parity only
    clean = np.array([True, False, True, True])
    out = dict(packed=torch.from_numpy(np.packbits(cw, axis=1)),
               clean=torch.from_numpy(clean),
               ok=torch.ones(4, dtype=torch.bool),
               iters=torch.full((4,), 3, dtype=torch.int8),
               snr_db=torch.zeros(1))
    res = rx.finish((out, None))
    assert res.bch_corrected.tolist() == [0, -1, 0, 0]
    broken = frames.copy()
    broken[1, :40] ^= 1                               # header destroyed
    want = bbframe.BBFrameParser().parse_batch(np.packbits(broken, axis=1))
    whole = bbframe.BBFrameParser().parse_batch(np.packbits(frames, axis=1))
    np.testing.assert_array_equal(res.ts_bytes, want)
    assert 0 < len(want) < len(whole)
    assert rx.bb.header_errors == 1


def test_receiver_takes_the_native_parser_by_default():
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import TorchReceiver
    cfg = _small_rx_cfg()
    assert isinstance(TorchReceiver(cfg, device="cpu").bb,
                      native.NativeBBFrameParser)
    assert isinstance(TorchReceiver(cfg, device="cpu", bb_parser="python").bb,
                      bbframe.BBFrameParser)


def test_build_writes_a_temporary_name_then_replaces(tmp_path, monkeypatch):
    """The library appears under its hashed name only whole: g++ writes a
    temporary file in the same directory and os.replace moves it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    moves = []
    real_replace = native.os.replace

    def spy(src, dst):
        moves.append((str(src), str(dst)))
        real_replace(src, dst)
    monkeypatch.setattr(native.os, "replace", spy)
    out = native.build()
    assert out.parent == tmp_path / "torch_native"
    assert out.name.startswith("libdvbt2_runtime.") and out.suffix == ".so"
    assert len(out.name.split(".")[1]) == 16          # sha256 prefix
    (src, dst), = moves
    assert dst == str(out) and src.endswith(".tmp")
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]
    assert native.build() == out and len(moves) == 1  # built once
    ctypes.CDLL(str(out)).bb_parser_new               # loads


def test_concurrent_builds_never_expose_a_partial_library(tmp_path,
                                                          monkeypatch):
    """Several builders at once (as several test workers import the port)
    each load a whole library; no temporary file is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    paths, errors = [], []

    def worker():
        try:
            p = native.build()
            ctypes.CDLL(str(p)).bb_parser_new
            paths.append(p)
        except Exception as e:                        # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(set(paths)) == 1 and len(paths) == 4
    assert [p.name for p in (tmp_path / "torch_native").iterdir()] == \
        [paths[0].name]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "dvbt2_runtime.cc"
    broken.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "out").iterdir())     # no partial output


def test_iq_ring_spsc():
    ring = native.IqRing(1 << 16)
    rng = np.random.default_rng(1)
    src = rng.integers(0, 256, 1 << 18, dtype=np.uint8)
    out = []

    def producer():
        pos = 0
        while pos < len(src):
            blk = src[pos:pos + 4096]
            if ring.push(blk):
                pos += len(blk)

    t = threading.Thread(target=producer)
    t.start()
    got = 0
    while got < len(src):
        blk = ring.pop(8192)
        if len(blk):
            out.append(blk)
            got += len(blk)
    t.join(timeout=60)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate(out), src)
    assert ring.fill == 0


def test_iq_ring_overrun_drops_whole_pushes():
    ring = native.IqRing(1024)
    blk = np.arange(800, dtype=np.int32).astype(np.uint8)
    assert ring.push(blk)
    assert not ring.push(blk)         # would overflow: dropped whole
    assert ring.dropped == 800 and ring.fill == 800
    np.testing.assert_array_equal(ring.pop(2000), blk)
