"""The BASELINE pod-scale configuration in the port: 64 concurrent RF
channels decoding in lockstep (parallel/pod.py), counterpart of
tests/test_pod_scale.py.

The deployment puts 64 channels on 64 devices (``pod.pod_64ch_mesh``);
here the grid is eight CPU devices with 8 channels each, as the JAX test
runs it on 8 virtual devices: the same batched step, per-channel
tracking state and host fan-in and fan-out, only the device count
differs.  The capture is the JAX test's, made by the JAX package's
transmitter and channel (each channel its own timing offset, CFO and
noise) and fed as numpy; acquisition is blind per channel.
"""
import numpy as np
import pytest

from sdr_receiver_dvb_t2_tpu.models.channel import ChannelConfig, impair
from sdr_receiver_dvb_t2_tpu.models.transmitter import (Transmitter,
                                                        TxConfig,
                                                        random_ts_stream)
from sdr_receiver_dvb_t2_tpu_torch.io.bbframe import BBFrameParser
from sdr_receiver_dvb_t2_tpu_torch.parallel import acquire, pod, sharding

from _torch_common import POD_MODE, POD_PLP, mode_pair, plp_pair

N_CH = 64


def test_pod_64ch_mesh_needs_64_devices():
    """pod_64ch_mesh is the 64-device layout; on fewer devices it says so
    instead of shrinking the configuration."""
    with pytest.raises(ValueError, match="64 devices"):
        pod.pod_64ch_mesh(devices=["cpu"] * 8)
    assert pod.pod_64ch_mesh(devices=["cpu"] * 64).shape == {"ch": 64,
                                                            "time": 1}


@pytest.mark.slow
def test_pod_64_concurrent_channels_blind():
    """64 channels, each with its own delay, CFO and noise, acquired
    blind and streamed with per-channel tracking: every 7th channel's TS
    a run of the transmitted stream, CFO seeds within 60 Hz."""
    mode, _ = mode_pair(POD_MODE)
    plp, _ = plp_pair(POD_PLP)
    device_rate = 10e6
    n_frames = 5
    bytes_per_frame = 4 * (plp.k_bch // 8 - 10)
    n_pkts = (n_frames + 2) * bytes_per_frame // 188
    ts = random_ts_stream(n_pkts, seed=77)
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=4,
                              num_t2_frames=n_frames))
    clean = tx.modulate(ts)

    rng = np.random.default_rng(9)
    offs = rng.integers(100, 4000, N_CH)
    cfos = np.linspace(-180.0, 180.0, N_CH)
    rows = []
    for c in range(N_CH):
        dev = impair(clean, ChannelConfig(device_rate=device_rate,
                                          snr_db=30.0, cfo_hz=float(cfos[c]),
                                          seed=500 + c))
        pre = (0.003 * (rng.standard_normal(offs[c])
                        + 1j * rng.standard_normal(offs[c])
                        )).astype(np.complex64)
        rows.append(np.concatenate([pre, dev]))
    n_min = min(len(r) for r in rows)
    raw = np.stack([r[:n_min] for r in rows])

    # blind per-channel acquisition (head bounded: offsets + ~2 frames)
    lock = acquire.blind_acquire(raw, device_rate, head_elem=260_000,
                                 device="cpu")
    assert lock is not None, "blind acquisition failed"
    assert lock.cfg.mode.fft_mode.name == mode.fft_mode.name
    assert len(np.unique(lock.pos0)) > 32      # channels truly independent

    mesh = sharding.make_mesh(8, 1, devices=["cpu"] * 8)   # 8 a device
    rx = pod.MultiChannelReceiver(lock.cfg, mesh)
    steps = list(rx.stream(lock.aligned(raw), lock.mu0, lock.step,
                           freq=lock.freq, max_steps=3, track=True))
    assert len(steps) == 3
    dirty = [int(s["bch_dirty"]) for _, s in steps]
    assert sum(dirty[1:]) == 0, dirty

    # the blind per-channel CFO seeds follow each channel's own LO error,
    # and the tracked state stays per-channel shaped
    seed_hz = lock.freq * device_rate / (2 * np.pi)
    strong = np.abs(cfos) > 60
    assert (np.sign(seed_hz[strong]) == np.sign(cfos[strong])).all()
    assert np.abs(seed_hz - cfos).max() < 60.0, seed_hz - cfos
    assert np.asarray(steps[-1][1]["cfo_hz_applied"]).shape == (N_CH,)

    # every 7th channel's TS round-trips
    k_bch = lock.cfg.plp.k_bch
    for c in range(0, N_CH, 7):
        bb = BBFrameParser()
        chunks = [bb.parse(np.asarray(hard[c, f, i, :k_bch], np.uint8))
                  for hard, _ in steps[1:] for f in range(hard.shape[1])
                  for i in range(hard.shape[2])]
        got = np.concatenate([x for x in chunks if len(x)]).tobytes()
        sync = ts.tobytes()
        at = sync.find(got[:376])
        assert at >= 0 and got == sync[at:at + len(got)], c
