"""The pod's entry point, ``python -m sdr_receiver_dvb_t2_tpu_torch --pod
channels.toml --cpu``: per-channel u8 capture files, blind acquisition,
the pod stream, per-channel TS sinks and stats lines (the counterparts of
tests/test_pod_cli.py's slow JAX tests), and a silent live channel that
does not stop the pod."""
import socket

import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.models.channel import (ChannelConfig, impair,
                                                    quantize)
from sdr_receiver_dvb_t2_tpu_torch import cli

from _torch_common import (POD_PLP, POD_RATE, assert_ts_match, plp_pair,
                           pod_tx)


def _write_channels(tmp_path, iq, n_ch, seed, cfo=True):
    """One u8 capture file a channel (own CFO, lead and noise) and its
    TOML [[channel]] lines."""
    rng = np.random.default_rng(seed)
    lines = []
    for c in range(n_ch):
        dev = impair(iq, ChannelConfig(
            device_rate=POD_RATE, snr_db=29.0, seed=c,
            cfo_hz=float(rng.uniform(-5e3, 5e3)) if cfo else 0.0))
        off = int(rng.integers(300, 2000))
        dev = np.concatenate([np.zeros(off, np.complex64), dev])
        path = tmp_path / f"ch{c}_dvbt2_0_{POD_RATE}_8.raw"
        quantize(dev, "u8", scale=0.4).tofile(path)
        lines.append(f"[[channel]]\ninput = \"{path}\"\n"
                     f"out = \"{tmp_path / f'ch{c}.ts'}\"\n")
    return lines


def test_pod_cli_two_channels(tmp_path, capfd):
    iq, ts, _ = pod_tx(6, seed=3)
    lines = _write_channels(tmp_path, iq, 2, seed=5)
    toml = tmp_path / "channels.toml"
    toml.write_text("track = true\ntrack_l1 = true\nrelock = false\n"
                    "max_steps = 3\nmesh = [2, 1]\nstats = 0\n"
                    + "\n".join(lines))
    assert cli.main(["--pod", str(toml), "--cpu"]) == 0
    err = capfd.readouterr().err
    assert "pod config: 2K FFT GI G1_8 QAM16 r=C1_2; 2 channels; " \
           "device: cpu" in err
    assert "ch0:" in err and "-> locked" in err and "done: 3 steps" in err
    for c in range(2):
        got = (tmp_path / f"ch{c}.ts").read_bytes()
        assert_ts_match(got, ts.tobytes(), 188 * 20, f"ch{c}")


def test_pod_cli_plp_all_with_monitor(tmp_path, capfd):
    """plp = "all": every PLP decodes to its own per-channel sink (file
    -plp<id>), and monitor = SECS renders the pod panel in-run."""
    from sdr_receiver_dvb_t2_tpu.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from _torch_common import POD_MODE, mode_pair
    jmode, _ = mode_pair(POD_MODE)
    plp_a, _ = plp_pair({**POD_PLP, "plp_id": 0})
    plp_b, _ = plp_pair({**POD_PLP, "plp_id": 1, "constellation": "QAM64",
                         "code_rate": "C2_3", "rotation": False})
    tx = Transmitter(TxConfig(mode=jmode, plps=[plp_a, plp_b],
                              fec_blocks=[3, 4], num_t2_frames=6))
    ts_a = random_ts_stream(7 * 3 * (plp_a.k_bch // 8 - 10) // 188, seed=1)
    ts_b = random_ts_stream(7 * 4 * (plp_b.k_bch // 8 - 10) // 188, seed=2)
    lines = _write_channels(tmp_path, tx.modulate_multi([ts_a, ts_b]), 2,
                            seed=7, cfo=False)
    toml = tmp_path / "channels.toml"
    toml.write_text("plp = \"all\"\nrelock = false\nmax_steps = 2\n"
                    "monitor = 0.01\n" + "\n".join(lines))
    assert cli.main(["--pod", str(toml), "--cpu"]) == 0
    err = capfd.readouterr().err
    assert "pod monitor" in err and "ch state" in err
    for c in range(2):
        for plp_id, ts in ((0, ts_a), (1, ts_b)):
            got = (tmp_path / f"ch{c}-plp{plp_id}.ts").read_bytes()
            assert_ts_match(got, ts.tobytes(), 188 * 10, f"ch{c} plp{plp_id}")


@pytest.mark.parametrize("threaded", [False, True])
def test_pod_cli_live_store(tmp_path, capfd, threaded):
    """live = true: the captures stream chunk-wise through a pooled
    ChannelStore (the readers convert u8 straight into pool space) or
    through ThreadedIngest, with blind acquisition on a recorded head and
    absolute positions after it; TS-exact as from the whole files."""
    iq, ts, _ = pod_tx(6, seed=3)
    lines = _write_channels(tmp_path, iq, 2, seed=5)
    toml = tmp_path / "live.toml"
    toml.write_text(f"live = true\nthreaded_ingest = "
                    f"{str(threaded).lower()}\nacquire_samples = 400000\n"
                    "max_steps = 4\nstats = 0\n" + "\n".join(lines))
    assert cli.main(["--pod", str(toml), "--cpu"]) == 0
    assert "done: 4 steps" in capfd.readouterr().err
    for c in range(2):
        assert_ts_match((tmp_path / f"ch{c}.ts").read_bytes(),
                        ts.tobytes(), 188 * 20, f"live ch{c}")


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pod_cli_silent_live_channel_does_not_abort(tmp_path, capfd):
    """Live mode with one channel a UDP feed that never sends: its
    acquisition head is zeros, it is marked dark and searched for each
    step, and the file channel decodes TS-exact to its end (exit 0).  The
    JAX pod takes the head as the shortest channel's and exits 1."""
    from sdr_receiver_dvb_t2_tpu import cli as jcli
    iq, ts, _ = pod_tx(6, seed=3)
    (line,) = _write_channels(tmp_path, iq, 1, seed=5)

    def toml():
        # a port of its own for each run: a closed source's socket stays
        # bound while its ingest thread waits out its receive timeout
        path = tmp_path / "live.toml"
        path.write_text(
            f"live = true\nrate = {POD_RATE}\nformat = \"u8\"\n"
            "ingest_timeout = 0.3\nacquire_samples = 400000\nstats = 0\n"
            + line + f"[[channel]]\ninput = \"udp://127.0.0.1:"
            f"{_free_udp_port()}\"\nout = \"{tmp_path / 'ch1.ts'}\"\n")
        return str(path)

    assert cli.main(["--pod", toml(), "--cpu"]) == 0
    err = capfd.readouterr().err
    assert "-> locked" in err and "-> dark" in err, err
    assert_ts_match((tmp_path / "ch0.ts").read_bytes(), ts.tobytes(),
                    188 * 20, "ch0")
    assert not (tmp_path / "ch1.ts").exists()
    assert jcli.main(["--pod", toml(), "--cpu"]) == 1
    assert "not enough samples" in capfd.readouterr().err


def test_pod_cli_without_cpu_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    iq, _, _ = pod_tx(2, seed=3)
    lines = _write_channels(tmp_path, iq, 1, seed=5)
    toml = tmp_path / "channels.toml"
    toml.write_text("\n".join(lines))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--pod", str(toml)])


def _two_plp_iq():
    """Two PLPs of their own constellations and rates in one mux, and each
    PLP's transmitted TS."""
    from sdr_receiver_dvb_t2_tpu.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from _torch_common import POD_MODE, mode_pair
    jmode, _ = mode_pair(POD_MODE)
    plp_a, _ = plp_pair({**POD_PLP, "plp_id": 0})
    plp_b, _ = plp_pair({**POD_PLP, "plp_id": 1, "constellation": "QAM64",
                         "code_rate": "C2_3", "rotation": False})
    tx = Transmitter(TxConfig(mode=jmode, plps=[plp_a, plp_b],
                              fec_blocks=[3, 4], num_t2_frames=6))
    ts_a = random_ts_stream(7 * 3 * (plp_a.k_bch // 8 - 10) // 188, seed=1)
    ts_b = random_ts_stream(7 * 4 * (plp_b.k_bch // 8 - 10) // 188, seed=2)
    return tx.modulate_multi([ts_a, ts_b])


@pytest.mark.parametrize("plps", [1, 2])
def test_pod_cli_ts_from_bytes_is_the_bits_ts(tmp_path, monkeypatch, plps):
    """run_pod parses each step's BB bytes from stream(bits=False): its TS
    files are byte for byte those of the same run with the stream made to
    unpack the bits, and the TS that the port's Python parser reads from
    those bits (a PLP's bits as fec_finish gives them), for one PLP and
    for two."""
    from sdr_receiver_dvb_t2_tpu_torch.io.bbframe import BBFrameParser
    from sdr_receiver_dvb_t2_tpu_torch.parallel import pod
    from _torch_common import collect_ts
    iq = pod_tx(6, seed=3)[0] if plps == 1 else _two_plp_iq()
    lines = _write_channels(tmp_path, iq, 2, seed=5, cfo=plps == 1)
    names = [f"ch{c}.ts" for c in range(2)] if plps == 1 else [
        f"ch{c}-plp{p}.ts" for c in range(2) for p in range(2)]
    toml = tmp_path / "channels.toml"
    toml.write_text(("plp = \"all\"\n" if plps == 2 else "")
                    + "track = true\ntrack_l1 = true\nrelock = false\n"
                    "max_steps = 3\nmesh = [2, 1]\nstats = 0\n"
                    + "\n".join(lines))
    assert cli.main(["--pod", str(toml), "--cpu"]) == 0
    from_bytes = {n: (tmp_path / n).read_bytes() for n in names}

    stream, seen = pod.MultiChannelReceiver.stream, []

    def with_bits(self, *a, **kw):
        for hard, stats in stream(self, *a, **dict(kw, bits=True)):
            seen.append((hard, stats))
            yield hard, stats
    monkeypatch.setattr(pod.MultiChannelReceiver, "stream", with_bits)
    for n in names:
        (tmp_path / n).unlink()
    assert cli.main(["--pod", str(toml), "--cpu"]) == 0
    assert len(seen) == 3
    for n in names:
        assert (tmp_path / n).read_bytes() == from_bytes[n], n
        assert len(from_bytes[n]) >= 188 * 10, n
    for p in range(plps):
        out, parsers = [[], []], [BBFrameParser(), BBFrameParser()]
        for hard, stats in seen:
            res = stats["plp_results"][p]
            bits = hard if p == 0 else np.unpackbits(res.bb_bytes, axis=-1)
            collect_ts(parsers, bits, res.state.plp.k_bch, out)
        for c in range(2):
            name = f"ch{c}.ts" if plps == 1 else f"ch{c}-plp{p}.ts"
            assert np.concatenate(out[c]).tobytes() == from_bytes[name], name
