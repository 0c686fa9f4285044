"""The port's receive grid across processes (parallel/distributed.py) on
the CPU: two ranks under ``torch.distributed`` with ``gloo``, joined
through a ``file://`` store under the test's tmp_path (no port, so xdist
workers cannot collide).

Counterpart of tests/test_distributed.py (two JAX processes, a psum over
both grid axes and a ppermute ring over "time"), then the contiguous
``step()`` and the windows path of tests/test_torch_pod_sharding.py split
over the two ranks in both layouts.  Each rank runs tests/_torch_ranks.py
in its own process; every process has a ``communicate`` time limit and
its process group a timeout (GROUP_TIMEOUT_S there), so a hung rank fails
its test.

Tolerances: the ring, the reductions of cell-coded values, hard bits,
``ok``, ``iters``, ``clean``, bytes and BCH corrections exact; the L1
cells, the discriminators and the SNR within 1e-5 relative of the
one-process step (the ranks gather each shard's value exactly and reduce
in the one-process order).  Against the JAX step (Pallas LDPC in
interpret mode, the conftest's virtual devices): hard bits equal on
converged codewords, as test_contiguous_step_decodes holds them.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.models.channel import ChannelConfig, impair
from sdr_receiver_dvb_t2_tpu.parallel import sharding as jsh
from sdr_receiver_dvb_t2_tpu.params.modes import SAMPLE_RATE
from sdr_receiver_dvb_t2_tpu_torch.parallel import distributed, sharding

from _torch_common import (POD_MODE, POD_PLP, POD_RATE, cpu_mesh, mode_pair,
                           plp_pair, pod_tx)

WORKER = Path(__file__).resolve().parent / "_torch_ranks.py"
PROC_TIMEOUT_S = 150
STEP = POD_RATE / (2 * SAMPLE_RATE)
RATIO = SAMPLE_RATE / POD_RATE
REL = 1e-5


def _spawn(job, tmp_path, inp=None, world=2, started=None):
    """Run ``job`` as the first ``started`` (default all) of ``world``
    rank processes; returns each one's (returncode, output, results)."""
    init = f"file://{tmp_path / f'store_{job}'}"
    outs = [tmp_path / f"{job}_{r}.npz" for r in range(world)]
    # one BLAS thread a rank, as tests/_torch_common.py pins the workers
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), job, str(world), str(r), init,
         str(inp), str(outs[r])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world if started is None else started)]
    res = []
    try:
        for p, o in zip(procs, outs):
            log, _ = p.communicate(timeout=PROC_TIMEOUT_S)
            res.append((p.returncode, log,
                        dict(np.load(o)) if p.returncode == 0 else None))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _ok(res):
    for r, (rc, log, _) in enumerate(res):
        assert rc == 0, f"rank {r} failed:\n{log}"
    return [d for _, _, d in res]


# ---------------------------------------------------------------------------
# the process group and the collectives
# ---------------------------------------------------------------------------
def test_collectives_two_processes(tmp_path):
    """The ring over "time" and the sums over the (ch, time) grid on a
    (2, 2) grid in both layouts and a (1, 4) grid of two time columns a
    rank: values that name their cell, checked exactly on every rank."""
    ranks = _ok(_spawn("collectives", tmp_path))
    for name, (n_ch, n_t) in dict(time22=(2, 2), time14=(1, 4),
                                  ch22=(2, 2)).items():
        c_total = 2 * n_ch
        full = np.array([[c * 10 + t for t in range(n_t)]
                         for c in range(c_total)], np.float32)
        held = set()
        for rank, d in enumerate(ranks):
            t0, t1 = d[f"{name}_block"]
            chans = d[f"{name}_chans"]
            held |= {(c, t) for c in chans for t in range(t0, t1)}
            want = np.zeros((len(chans), 8), np.complex64)
            if t0 > 0:
                want[:] = (chans[:, None] * 10 + t0 - 1
                           + 1j * np.arange(8)[None, :])
            np.testing.assert_array_equal(d[f"{name}_left"], want)
            np.testing.assert_array_equal(d[f"{name}_grid"], full)
            np.testing.assert_array_equal(d[f"{name}_time_sum"],
                                          full.sum(axis=1))
            np.testing.assert_array_equal(d[f"{name}_time_mean"],
                                          full.mean(axis=1))
            assert int(d[f"{name}_world_sum"]) == 3
            assert int(d[f"{name}_world_max"]) == 1
        assert held == {(c, t) for c in range(c_total) for t in range(n_t)}
    # "time" crosses ranks, "ch" keeps each channel on one rank
    assert [list(d["time22_block"]) for d in ranks] == [[0, 1], [1, 2]]
    assert [list(d["time14_block"]) for d in ranks] == [[0, 2], [2, 4]]
    assert [d["ch22_chans"].tolist() for d in ranks] == [[0, 1], [2, 3]]


def test_rank_without_peers_raises(tmp_path):
    """Rank 0 of a group of two whose rank 1 never starts raises when
    its timeout runs out; it does not go on alone."""
    ((rc, log, _),) = _spawn("alone", tmp_path, started=1)
    assert rc != 0 and "timeout" in log.lower(), log


def test_rank_mesh_layouts():
    """The cells of each layout, this rank's block and channels, on
    grids built by hand (no process group needed)."""
    cpu = torch.device("cpu")
    ranks_t = ((0, 1), (0, 1))
    m = distributed.Mesh(((None, cpu), (None, cpu)), ranks_t, rank=1)
    assert m.block == ((0, 1), 1, 2)
    assert m.channels(4).tolist() == [0, 1, 2, 3]
    m = distributed.Mesh(((None, None), (cpu, cpu)), ((0, 0), (1, 1)), 1)
    assert m.block == ((1,), 0, 2)
    assert m.channels(4).tolist() == [2, 3]
    with pytest.raises(ValueError, match="no rectangle"):
        _ = distributed.Mesh(((cpu, None), (None, cpu)),
                             ((0, 1), (1, 0)), 0).block
    # a one-process grid reduces locally and rings in zeros
    one = sharding.make_mesh(2, 2, devices=["cpu"] * 4)
    assert one.block == ((0, 1), 0, 2)
    x = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    np.testing.assert_array_equal(one.time_sum(x), x.sum(axis=1))
    tail = torch.ones(2, 4, dtype=torch.complex64)
    assert not one.ring_halo(tail).any()
    with pytest.raises(RuntimeError, match="distributed.init"):
        distributed.rank_mesh(2, 2, "time", devices=["cpu"])


# ---------------------------------------------------------------------------
# the receive step over two ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """test_torch_pod_sharding.py's capture (two 2K channels, the second
    with a 2 kHz CFO) as the ranks' input file, and the one-process port
    step, planes and FEC on the (2, 2) grid of the CPU."""
    iq, _, tx = pod_tx(4, seed=100)
    rows = [impair(iq, ChannelConfig(device_rate=POD_RATE, snr_db=30.0,
                                     cfo_hz=cfo, seed=40 + c))
            for c, cfo in enumerate((0.0, 2e3))]
    n = min(len(r) for r in rows)
    raw = np.stack([r[:n] for r in rows]).astype(np.complex64)
    freq = np.array([0.0, 2 * np.pi * 2e3 / POD_RATE])
    base = dict(n_fec_per_frame=4, n_ti=1,
                l1_post_cells=tx.l1_pre.l1_post_size, frames_per_shard=1)
    _, tmode = mode_pair(POD_MODE)
    _, tplp = plp_pair(POD_PLP)
    rx = sharding.ShardedReceiver(
        sharding.ShardedConfig(mode=tmode, plp=tplp, **base), cpu_mesh(2, 2))
    # the contiguous grid: elementary sample 0 at the capture's frame start
    rb = rx.raw_block_for(STEP)
    mu = ((rx.n_taps - 1) / 4.0 - 1.0) / RATIO
    bases = rx.host_bases(mu, STEP, 0.0, freq, rb, n_channels=2)
    x = np.ascontiguousarray(raw[:, :2 * rb])
    # the windows: frames 1 and 2 of each channel
    r0 = mu + rx.mode.frame_samples / RATIO * np.array([[1.0, 2.0]])
    w0, *wbases = rx.host_bases_windows(np.repeat(r0, 2, axis=0), STEP, 0.0,
                                        freq)
    win = rx.window_len(STEP)
    xw = np.stack([[raw[c, a:a + win] for a in w0[c]] for c in range(2)])
    hard, stats = rx.step(x, *bases, freq, STEP)
    plane = rx.plane_step(x, *bases, freq, STEP)
    wplane = rx.plane_step_windows(xw, *wbases, freq, STEP)
    one = dict(hard=hard, stats=stats, contiguous=(plane, rx.fec_step(plane)),
               windows=(wplane, rx.fec_step(wplane)))
    inp = tmp_path_factory.mktemp("ranks") / "input.npz"
    spec = dict(mode=POD_MODE, plp=POD_PLP, cfg=base)
    np.savez(inp, spec=json.dumps(spec), raw=x, idx0=bases[0],
             frac0=bases[1], phase0=bases[2], freq=freq, step=STEP,
             windows=xw, w_idx0=wbases[0], w_frac0=wbases[1],
             w_phase0=wbases[2])
    return dict(one=one, inp=inp, x=x, bases=bases, freq=freq, base=base,
                base_halo=rx.cfg.halo)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """Both layouts' two-rank runs, the four processes at once."""
    tmp = tmp_path_factory.mktemp("groups")
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        runs = {lay: pool.submit(_spawn, f"step-{lay}", tmp, case["inp"])
                for lay in ("ch", "time")}
        return {lay: _ok(f.result()) for lay, f in runs.items()}


def _union(ranks, key, shape):
    """The ranks' [C_r, n_time_r * F, ...] arrays placed in the grid's
    [C, n_time * F, ...]: every cell from exactly one rank."""
    out = np.zeros(shape, ranks[0][key].dtype)
    seen = np.zeros(shape[:2], int)
    for d in ranks:
        t0, t1 = d["block"]
        idx = np.ix_(d["chans"], np.arange(t0, t1))
        out[idx] = d[key]
        seen[idx] += 1
    assert (seen == 1).all(), seen
    return out


@pytest.mark.parametrize("layout", ["ch", "time"])
def test_two_rank_step_matches_one_process(ranks, case, layout):
    """The contiguous step() over two ranks: the union of the ranks' hard
    bits and FEC arrays equals the one-process step's, and every rank
    reports the one-process stats, L1 cells, discriminators and SNR."""
    got = ranks[layout]
    one = case["one"]
    # each time block behind the tail of the block before it (zeros
    # before block 0), wherever that block was held
    halo = case["base_halo"]
    blocks = case["x"].reshape(2, 2, -1)
    left = np.zeros((2, 2, halo), np.complex64)
    left[:, 1] = blocks[:, 0, -halo:]
    want = np.concatenate([left, blocks], axis=2)
    np.testing.assert_array_equal(_union(got, "haloed", want.shape), want)
    hard = _union(got, "hard", one["hard"].shape)
    np.testing.assert_array_equal(hard, one["hard"])
    plane, fec = one["contiguous"]
    for k in ("bb_bytes", "ldpc_ok", "ldpc_iters", "bch_clean",
              "bch_corrected"):
        np.testing.assert_array_equal(
            _union(got, f"contiguous_{k}", getattr(fec, k).shape),
            getattr(fec, k))
    if layout == "time":
        # each channel's time blocks on two ranks: the halo crossed
        assert [list(d["block"]) for d in got] == [[0, 1], [1, 2]]
    for d in got:
        for k, v in one["stats"].items():
            np.testing.assert_allclose(d[f"stat_{k}"], v, rtol=REL, atol=0,
                                       err_msg=k)
        np.testing.assert_allclose(d["contiguous_sig"], plane.sig, rtol=REL,
                                   atol=REL * np.abs(plane.sig).max())
        for k, v in plane.diag_host().items():
            np.testing.assert_allclose(d[f"contiguous_diag_{k}"], v,
                                       rtol=REL, atol=1e-9)
        np.testing.assert_allclose(d["contiguous_snr_db"], fec.snr_db,
                                   rtol=REL)
    assert int(got[0]["stat_ldpc_failures"]) == 0


@pytest.mark.parametrize("layout", ["ch", "time"])
def test_two_rank_step_matches_jax(ranks, case, layout):
    """The union of the ranks' hard bits against the JAX package's step
    on a (2, 2) grid of virtual devices: equal on converged codewords."""
    jmode, _ = mode_pair(POD_MODE)
    jplp, _ = plp_pair(POD_PLP)
    jrx = jsh.ShardedReceiver(
        jsh.ShardedConfig(mode=jmode, plp=jplp, use_pallas=True,
                          **case["base"]), jsh.make_mesh(2, 2))
    jhard, jstats = jrx.step(case["x"], *case["bases"], case["freq"], STEP)
    jhard = np.asarray(jhard)
    got = ranks[layout]
    hard = _union(got, "hard", jhard.shape)
    ok = _union(got, "contiguous_ldpc_ok", jhard.shape[:3])
    assert ok.all() and int(jstats["ldpc_failures"]) == 0
    np.testing.assert_array_equal(hard, jhard)


def test_two_rank_windows_match_one_process(ranks, case):
    """The windows path with each channel's time shards on two ranks
    (no halo): the L1 cells from the time-0 shards, the per-channel
    means over both ranks' shards, and the FEC output, as
    test_shards_split_over_devices_match_one_device holds them."""
    plane, fec = case["one"]["windows"]
    got = ranks["time"]
    for d in got:
        np.testing.assert_allclose(d["windows_sig"], plane.l1_cells(),
                                   rtol=0, atol=1e-5)
        for k, v in plane.diag_host().items():
            np.testing.assert_allclose(d[f"windows_diag_{k}"], v, rtol=REL,
                                       atol=1e-9)
        np.testing.assert_allclose(d["windows_snr_db"], fec.snr_db,
                                   rtol=REL)
    for k in ("bb_bytes", "ldpc_ok", "ldpc_iters", "bch_clean"):
        np.testing.assert_array_equal(
            _union(got, f"windows_{k}", getattr(fec, k).shape),
            getattr(fec, k))
