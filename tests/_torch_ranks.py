"""One rank of the port's receive grid across processes, for
tests/test_torch_distributed.py (CPU, ``gloo``):

    python tests/_torch_ranks.py JOB WORLD RANK INIT_METHOD IN.npz OUT.npz

JOB ``collectives`` runs the ring and the reductions on grids of both
layouts with values that name their cell; ``step-ch`` / ``step-time``
run the contiguous ``step()`` (and its plane and FEC stages) on a (2, 2)
grid of that layout, ``step-time`` also the windows path; ``alone`` joins
a group whose peer never comes.  Each job writes what the rank saw to
OUT.npz; the test holds it against the one-process step.  Imports the
port only (no JAX), one torch thread.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from sdr_receiver_dvb_t2_tpu_torch.parallel import distributed, sharding  # noqa: E402
from sdr_receiver_dvb_t2_tpu_torch.params import modes  # noqa: E402

# a hung peer fails the job well inside the test's own time limit
GROUP_TIMEOUT_S = 60.0
HALO = 8


def collectives(world, rank):
    """For each grid: the ring's left halos, time_sum, time_mean and the
    world reductions of values coded by cell (c * 10 + t)."""
    out = {}
    for name, (n_ch, n_t, layout) in dict(
            time22=(2, 2, "time"), time14=(1, 4, "time"),
            ch22=(2, 2, "ch")).items():
        mesh = distributed.rank_mesh(n_ch, n_t, layout, devices=["cpu"])
        rows, t0, t1 = mesh.block
        c_total = 2 * n_ch                      # two channels a grid row
        chans = mesh.channels(c_total)
        tail = torch.tensor([[c * 10 + t1 - 1 + 1j * k for k in range(HALO)]
                             for c in chans], dtype=torch.complex64)
        cells = np.zeros((c_total, n_t), np.float32)
        for c in chans:
            cells[c, t0:t1] = c * 10 + np.arange(t0, t1)
        out.update({
            f"{name}_chans": chans, f"{name}_block": np.array([t0, t1]),
            f"{name}_left": mesh.ring_halo(tail).numpy(),
            f"{name}_time_sum": mesh.time_sum(cells),
            f"{name}_time_mean": mesh.time_mean(cells),
            f"{name}_grid": mesh.world_sum(cells),
            f"{name}_world_sum": mesh.world_sum(np.int64(rank + 1)),
            f"{name}_world_max": mesh.world_max(np.int32(rank))})
    return out


# the enum-valued keys of a mode or PLP spec (tests/_torch_common.py)
_ENUMS = dict(fft_mode="FftMode", guard="GuardInterval",
              pilot_pattern="PilotPattern", constellation="Constellation",
              code_rate="CodeRate", fec_frame="FecFrame")


def _kw(spec):
    return {k: getattr(getattr(modes, _ENUMS[k]), v) if k in _ENUMS else v
            for k, v in spec.items()}


def _receiver(spec, layout):
    cfg = sharding.ShardedConfig(mode=modes.T2Mode(**_kw(spec["mode"])),
                                 plp=modes.PlpConfig(**_kw(spec["plp"])),
                                 **spec["cfg"])
    mesh = distributed.rank_mesh(2, 2, layout, devices=["cpu"])
    return sharding.ShardedReceiver(cfg, mesh), mesh


def _plane_fec(prefix, plane, fec):
    return {f"{prefix}_sig": plane.sig,
            **{f"{prefix}_diag_{k}": v for k, v in plane.diag_host().items()},
            **{f"{prefix}_{k}": getattr(fec, k) for k in (
                "bb_bytes", "ldpc_ok", "ldpc_iters", "bch_clean", "snr_db",
                "bch_corrected")}}


def step(world, rank, layout, inp):
    spec = json.loads(str(inp["spec"]))
    rx, mesh = _receiver(spec, layout)
    rows, t0, t1 = mesh.block
    chans = mesh.channels(2)
    x = inp["raw"][chans]
    x = x.reshape(len(chans), 2, -1)[:, t0:t1].reshape(len(chans), -1)
    bases = (inp["idx0"], inp["frac0"], inp["phase0"], inp["freq"],
             float(inp["step"]))
    # keep the haloed blocks, the plane and the FEC results that step()
    # makes on its way
    seen = {}
    plane, plane_step, fec_step = rx._plane, rx.plane_step, rx.fec_step

    def keep_plane(blocks, *a):
        seen["haloed"] = blocks.numpy().copy()
        return plane(blocks, *a)
    rx._plane = keep_plane
    rx.plane_step = lambda *a: seen.setdefault("plane", plane_step(*a))
    rx.fec_step = lambda *a: seen.setdefault("fec", fec_step(*a))
    hard, stats = rx.step(x, *bases)
    del rx._plane, rx.plane_step, rx.fec_step
    out = dict(chans=chans, block=np.array([t0, t1]), hard=hard,
               haloed=seen["haloed"],
               **{f"stat_{k}": np.asarray(v) for k, v in stats.items()},
               **_plane_fec("contiguous", seen["plane"], seen["fec"]))
    if layout == "time":
        xw = inp["windows"][chans][:, t0:t1]
        wargs = (inp["w_idx0"], inp["w_frac0"], inp["w_phase0"],
                 inp["freq"], float(inp["step"]))
        wplane = rx.plane_step_windows(xw, *wargs)
        out.update(_plane_fec("windows", wplane, rx.fec_step(wplane)))
    return out


def main(argv):
    job, world, rank, init_method, inp, outp = argv
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    timeout = 2.0 if job == "alone" else GROUP_TIMEOUT_S
    distributed.init(world, rank, init_method, timeout_s=timeout)
    try:
        if job == "collectives":
            out = collectives(world, rank)
        else:
            out = step(world, rank, job.split("-")[1], np.load(inp))
        np.savez(outp, **out)
    finally:
        distributed.shutdown()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
