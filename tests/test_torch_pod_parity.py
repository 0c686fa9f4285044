"""The port's pod on a real mux and a real deployment, on the CPU: the
counterparts of tests/test_pod_parity.py's (slow) JAX tests, each held
against the transmitted TS — L1-dynamic schedule changes, FEF gaps,
multi-PLP, a dark antenna that relocks, and the in-band type A repair of
an erased L1.  The captures come from the JAX package's transmitter and
channel (numpy), as the JAX tests make them."""
import numpy as np

from sdr_receiver_dvb_t2_tpu_torch.io.bbframe import BBFrameParser
from sdr_receiver_dvb_t2_tpu_torch.parallel import acquire, pod
from sdr_receiver_dvb_t2_tpu_torch.params.modes import SAMPLE_RATE

from _torch_common import (POD_MODE, POD_PLP, POD_RATE, assert_ts_match,
                           collect_ts, cpu_mesh, mode_pair, plp_pair,
                           pod_channels, pod_tx)

DEV_PER_ELEM = POD_RATE / SAMPLE_RATE


def _acquire(raw, **kw):
    lock = acquire.blind_acquire(raw, POD_RATE, device="cpu", **kw)
    assert lock is not None
    return lock


def test_l1_dynamic_change():
    """PLP_NUM_BLOCKS changes mid-stream (4 -> 3 on a step boundary): the
    tracker re-reads dynamic L1 from the plane every step, rebuilds only
    the PLP's plan, and both segments decode TS-exact on both channels."""
    from sdr_receiver_dvb_t2_tpu.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    jmode, _ = mode_pair(POD_MODE)
    jplp, _ = plp_pair(POD_PLP)
    segs, ts_segs = [], []
    for n_fec, seed in ((4, 31), (3, 32)):
        tx = Transmitter(TxConfig(mode=jmode, plp=jplp,
                                  fec_blocks_per_frame=n_fec,
                                  num_t2_frames=4))
        ts = random_ts_stream(5 * n_fec * (jplp.k_bch // 8 - 10) // 188,
                              seed=seed)
        segs.append(tx.modulate(ts)[:4 * jmode.frame_samples])
        ts_segs.append(ts)
    raw = pod_channels(np.concatenate(segs), 2, [700, 1400])
    lock = _acquire(raw)
    assert lock.cfg.n_fec_per_frame == 4
    rx = pod.MultiChannelReceiver(lock.cfg, cpu_mesh(2, 2))
    parsers = [BBFrameParser() for _ in range(2)]
    out, events, dirty = [[], []], [], []
    for hard, stats in rx.stream(lock.aligned(raw), lock.mu0, lock.step,
                                 freq=lock.freq, max_steps=4,
                                 track_l1=True):
        events += stats["events"]
        dirty.append(stats["bch_dirty"])
        collect_ts(parsers, hard, jplp.k_bch, out)
    assert any(e.startswith("l1_dyn: plp0 num_blocks 4->3")
               for e in events), events
    assert rx.rx.plps[0].n_fec_per_frame == 3
    assert sum(dirty) == 0, dirty
    for c in range(2):
        got = np.concatenate(out[c]).tobytes()
        a, b = ts_segs[0].tobytes(), ts_segs[1].tobytes()
        cut = got.find(b[:188])
        assert cut > 0, f"ch{c}: segment B never appeared"
        assert_ts_match(got[:cut], a, 188 * 20, f"ch{c} segment A",
                        prefix_only=True)
        assert_ts_match(got[cut:], b, 188 * 10, f"ch{c} segment B",
                        prefix_only=True)


def test_fef_stream():
    """An FEF-mixed capture: blind acquisition reads the FEF geometry from
    L1 and the window path hops the gaps by per-channel FRAME_IDX
    arithmetic — TS-exact on both channels."""
    from sdr_receiver_dvb_t2_tpu.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    jmode, _ = mode_pair(POD_MODE)
    jplp, _ = plp_pair(POD_PLP)
    n_frames, fef_len = 8, 3 * 2048 + 1234
    tx = Transmitter(TxConfig(mode=jmode, plp=jplp, fec_blocks_per_frame=4,
                              num_t2_frames=n_frames, fef_interval=2,
                              fef_length=fef_len))
    ts = random_ts_stream(
        (n_frames + 2) * 4 * (jplp.k_bch // 8 - 10) // 188, seed=21)
    iq = np.concatenate([tx.build_fef_part(), tx.modulate(ts)])
    raw = pod_channels(iq, 2, [500, 1100], cfo_hz=4e3, seed=5)
    lock = _acquire(raw)
    assert lock.cfg.fef == (2, fef_len) and lock.cfg.num_t2 == n_frames
    rx = pod.MultiChannelReceiver(lock.cfg, cpu_mesh(2, 2))
    parsers = [BBFrameParser() for _ in range(2)]
    out, n_dirty = [[], []], 0
    for hard, stats in rx.stream(lock.aligned(raw), lock.mu0, lock.step,
                                 freq=lock.freq, max_steps=3, track=True,
                                 track_l1=True, frame_idx0=lock.frame_idx0):
        n_dirty += stats["bch_dirty"]
        collect_ts(parsers, hard, jplp.k_bch, out)
    assert n_dirty == 0
    for c in range(2):
        assert_ts_match(np.concatenate(out[c]).tobytes(), ts.tobytes(),
                        188 * 40, f"ch{c}")


def test_multi_plp(monkeypatch):
    """Two PLPs decode from ONE equalized plane per channel, each with one
    decoder call a step for all channels (on a card, one launch of each
    kernel)."""
    from sdr_receiver_dvb_t2_tpu.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc
    jmode, _ = mode_pair(POD_MODE)
    plp_a, _ = plp_pair({**POD_PLP, "plp_id": 0})
    plp_b, _ = plp_pair({**POD_PLP, "plp_id": 1, "constellation": "QAM64",
                         "code_rate": "C2_3", "rotation": False})
    tx = Transmitter(TxConfig(mode=jmode, plps=[plp_a, plp_b],
                              fec_blocks=[3, 4], num_t2_frames=6))
    ts_a = random_ts_stream(7 * 3 * (plp_a.k_bch // 8 - 10) // 188, seed=1)
    ts_b = random_ts_stream(7 * 4 * (plp_b.k_bch // 8 - 10) // 188, seed=2)
    raw = pod_channels(tx.modulate_multi([ts_a, ts_b]), 2, [900, 300])
    lock = _acquire(raw, all_plps=True)
    assert len(lock.cfg.extra_plps) == 1
    rx = pod.MultiChannelReceiver(lock.cfg, cpu_mesh(2, 2))
    parsers = {i: [BBFrameParser() for _ in range(2)] for i in (0, 1)}
    out = {i: [[], []] for i in (0, 1)}
    calls = []
    call = ldpc.LayeredDecoder.__call__
    monkeypatch.setattr(ldpc.LayeredDecoder, "__call__",
                        lambda self, llr, segments=None: calls.append(
                            (tuple(llr.shape), segments)) or
                        call(self, llr, segments))
    n_steps = 0
    for _, stats in rx.stream(lock.aligned(raw), lock.mu0, lock.step,
                              freq=lock.freq, max_steps=2, track_l1=True):
        n_steps += 1
        assert stats["bch_dirty"] == 0, stats
        for i, res in enumerate(stats["plp_results"]):
            assert np.all(res.bch_clean), (i, res.bch_clean)
            collect_ts(parsers[i], np.unpackbits(res.bb_bytes, axis=-1),
                       res.state.plp.k_bch, out[i])
    # per step: PLP A's 2 channels x 2 shards x 3 codewords, then B's x 4,
    # each shard a segment of its own (the JAX pod's Pallas call a device)
    assert calls == [((12, 16200), [3] * 4), ((16, 16200), [4] * 4)] * 2
    assert n_steps == 2
    for i, ts_in in ((0, ts_a), (1, ts_b)):
        for c in range(2):
            assert_ts_match(np.concatenate(out[i][c]).tobytes(),
                            ts_in.tobytes(), 188 * 10, f"plp{i} ch{c}")


def test_dark_channel_relock():
    """One channel starts dark (noise only) and comes alive mid-capture:
    partial acquisition, the dark channel masked, a blind relock while the
    live channel never stalls — then both decode TS-exact."""
    iq, ts, _ = pod_tx(10, seed=9)
    fs = mode_pair(POD_MODE)[0].frame_samples
    raw = pod_channels(iq, 2, [600, 600], tail=60_000)
    dark = int(4 * fs * DEV_PER_ELEM)
    rng = np.random.default_rng(23)
    raw[1, :dark] = (rng.standard_normal(dark)
                     + 1j * rng.standard_normal(dark)
                     ).astype(np.complex64) * np.sqrt(
                         np.mean(np.abs(raw[0]) ** 2) / 400.0)
    lock = _acquire(raw[:, :3 * int(fs * DEV_PER_ELEM)], allow_partial=True)
    assert lock.locked.tolist() == [True, False]
    rx = pod.MultiChannelReceiver(lock.cfg, cpu_mesh(2, 1))
    parsers = [BBFrameParser() for _ in range(2)]
    out, alive_hist, events = [[], []], [], []
    k_bch = lock.cfg.plp.k_bch
    for hard, stats in rx.stream(raw, lock.mu0, lock.step, freq=lock.freq,
                                 max_steps=8, relock=True,
                                 locked=lock.locked, dead_after=2):
        alive_hist.append(stats["alive"].tolist())
        events += stats["events"]
        step_out = [[], []]
        collect_ts(parsers, hard, k_bch, step_out)
        for c in range(2):
            if stats["alive"][c]:
                out[c] += step_out[c]
        # a dark channel's dirty codewords are dropped, not corrected
        res = stats["plp_results"][0]
        for c in np.nonzero(~stats["alive"])[0]:
            dirty = ~res.bch_clean[c]
            assert (res.bch_corrected[c][dirty] == -1).all()
    assert any(e.startswith("relock: ch1 reacquired") for e in events), \
        events
    first_up = next(i for i, a in enumerate(alive_hist) if a[1])
    assert 0 < first_up < len(alive_hist) - 1, alive_hist
    assert alive_hist[-1] == [True, True], alive_hist
    assert all(a[0] for a in alive_hist)
    assert_ts_match(np.concatenate(out[0]).tobytes(), ts.tobytes(),
                    188 * 40, "ch0")
    assert_ts_match(np.concatenate(out[1]).tobytes(), ts.tobytes(),
                    188 * 10, "ch1 (late)")


def test_inband_repair_survives_l1_erasure():
    """With the per-step L1 read knocked out for two steps, the pod keeps
    repairing the dynamic configuration from in-band type A blocks in the
    data path's padding and stays clean."""
    iq, ts, tx = pod_tx(8, seed=31, in_band_a=True)
    assert tx.l1_post.plp[0].in_band_a_flag == 1
    raw = pod_channels(iq, 2, [400, 900])
    lock = _acquire(raw)
    rx = pod.MultiChannelReceiver(lock.cfg, cpu_mesh(2, 1))
    orig = rx._decode_l1
    calls = {"n": 0}

    def flaky(plane, channel):
        # step 1 = call 1 (ok); steps 2 and 3 = calls 2-5 (both channels
        # erased); later steps decode normally
        calls["n"] += 1
        return None if calls["n"] in (2, 3, 4, 5) else orig(plane, channel)

    rx._decode_l1 = flaky
    parsers = [BBFrameParser() for _ in range(2)]
    out, last = [[], []], None
    for hard, stats in rx.stream(lock.aligned(raw), lock.mu0, lock.step,
                                 freq=lock.freq, max_steps=5,
                                 track_l1=True):
        assert stats["bch_dirty"] == 0, stats["events"]
        collect_ts(parsers, hard, lock.cfg.plp.k_bch, out)
        last = stats
    assert last["inband_a_blocks"] >= 3, last
    assert last["inband_repaired"] == 2, last
    assert last["l1_dyn_errors"] == 0, last
    for c in range(2):
        assert_ts_match(np.concatenate(out[c]).tobytes(), ts.tobytes(),
                        188 * 30, f"ch{c}")
