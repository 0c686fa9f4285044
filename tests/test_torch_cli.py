"""The port's command-line entry (cli.main, ``python -m
sdr_receiver_dvb_t2_tpu_torch``) on a raw capture file, on the CPU."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one torch thread per worker)
from _port_capture import port_capture, ts_in_stream
from sdr_receiver_dvb_t2_tpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return port_capture(tmp_path_factory.mktemp("cli"), guard="G1_32",
                        pilot_pattern="PP4")


def test_cli_receives_a_file(capture, tmp_path, capsys):
    path, ts, _ = capture
    out = tmp_path / "out.ts"
    npz = tmp_path / "diag.npz"
    rc = cli.main(["--input", path, "--out", str(out), "--cpu",
                   "--frames-per-batch", "1", "--max-frames", "3",
                   "--stats", "0", "--dump-l1", "--dump-constellation",
                   str(npz), "--profile", str(tmp_path / "prof")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "locked: 2K FFT, GI G1_32, PP4" in err and "device: cpu" in err
    got = np.fromfile(out, np.uint8)
    assert len(got) > 188 * 40 and len(got) % 188 == 0
    assert ts_in_stream(got, ts)
    z = np.load(npz)
    assert {"frame_iq", "spectrum", "constellation", "p1_metric"} <= \
        set(z.files)
    assert len(z["constellation"]) > 100
    assert np.isfinite(z["p1_metric"]).all()
    assert list((tmp_path / "prof").glob("*.json"))      # the trace


def test_cli_refuses_an_sfn_capture(tmp_path, capsys):
    """On _make_capture's GI 1/8 PP7 capture the acquisition asks for the
    SFN equalizer: the entry point no longer refuses it, it locks with the
    SFN plan and writes the transmitted TS."""
    path, ts, _ = port_capture(tmp_path)
    out = tmp_path / "o.ts"
    assert cli.main(["--input", path, "--out", str(out), "--cpu",
                     "--stats", "0", "--frames-per-batch", "1",
                     "--max-frames", "3"]) == 0
    assert "GI G1_8, PP7, equalizer SFN" in capsys.readouterr().err
    got = np.fromfile(out, np.uint8)
    assert len(got) > 188 * 40 and ts_in_stream(got, ts)


def test_cli_without_cpu_needs_a_card(capture, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--input", capture[0], "--out", str(tmp_path / "o.ts")])


@pytest.mark.parametrize("argv,message", [
    (["--pod", "pod.toml"], "item 15"),
    ([], "--input is required"),
    (["--input", "udp://:4950"], "--rate is required"),
])
def test_cli_refusals_exit_2(argv, message, capsys):
    assert cli.main(argv + ["--cpu"]) == 2
    assert message in capsys.readouterr().err


def test_module_entry_point():
    proc = subprocess.run(
        [sys.executable, "-m", "sdr_receiver_dvb_t2_tpu_torch", "--pod",
         "x.toml"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "not ported yet" in proc.stderr
