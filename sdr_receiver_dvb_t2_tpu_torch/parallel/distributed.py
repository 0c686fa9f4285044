"""The receive grid across processes: ``torch.distributed`` ranks.

The TPU package builds its receive step as ``shard_map`` programs over a
device mesh that may span processes (``jax.distributed.initialize``, one
process a host).  Their collectives are the halo ring (``ppermute`` over
"time"), the L1 cells and the per-channel means (``psum`` / ``pmean`` over
"time") and the SNR's ``pmean`` in the FEC body.  Here a grid cell names
``(rank, torch.device)`` and the collectives run over a
``torch.distributed`` process group.

Everything that crosses ranks is host data: the raw halo (the tail of the
previous time block of a host capture), the per-shard discriminators and
SNRs, the L1 signalling cells and the decode totals.  No device tensor
crosses, so ``gloo`` serves every layout, two ranks that share one card
included (NCCL refuses a GPU that two ranks name).

A one-process grid (``sharding.make_mesh``) is a :class:`Mesh` without
ranks: its collectives reduce locally and its ring gives zeros.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

LAYOUTS = ("ch", "time")


def init(world_size: int, rank: int, init_method: str, backend: str = "gloo",
         timeout_s: float = 300.0) -> None:
    """Join the process group as ``rank`` of ``world_size``.

    ``init_method`` is the rendezvous (``tcp://host:port`` or
    ``file:///path``); nothing is read from the environment.  A rank that
    cannot reach its peers within ``timeout_s`` raises, and so does a
    collective that waits longer: no rank carries on alone."""
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group (after the last collective of every rank)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _device(d) -> torch.device:
    """``d`` as a device of this process; a bare ``cuda`` names the
    current card.  Raises for a card on a machine without one."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(devices=None) -> list:
    """``devices`` as torch devices, defaulting to every visible card
    (raises without one)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * n to "
                               "run the plain PyTorch path")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    return [_device(d) for d in devices]


def _real(t: torch.Tensor) -> torch.Tensor:
    """A view that gloo can carry: complex as (re, im) pairs."""
    return torch.view_as_real(t) if t.is_complex() else t


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid [n_ch][n_time] of torch devices (a device may repeat).

    On a grid that spans ranks, ``ranks`` names each cell's rank, and
    ``devices`` holds None where a cell belongs to another rank.  Each
    rank holds a rectangle of the grid: whole rows (``layout="ch"``) or
    a run of time columns of every row (``layout="time"``).  Every rank
    of the group makes the collective calls below in the same order."""
    devices: tuple
    ranks: tuple | None = None
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {"ch": len(self.devices), "time": len(self.devices[0])}

    @functools.cached_property
    def block(self) -> tuple:
        """(rows, t0, t1): the grid rows and the time columns [t0, t1)
        whose cells this rank holds."""
        n_ch, n_t = self.shape["ch"], self.shape["time"]
        if self.ranks is None:
            return tuple(range(n_ch)), 0, n_t
        own = [(c, t) for c in range(n_ch) for t in range(n_t)
               if self.ranks[c][t] == self.rank]
        rows = tuple(sorted({c for c, _ in own}))
        cols = sorted({t for _, t in own})
        t0, t1 = cols[0], cols[-1] + 1
        if own != [(c, t) for c in rows for t in range(t0, t1)]:
            raise ValueError(f"rank {self.rank}'s cells are no rectangle")
        return rows, t0, t1

    def channels(self, n_ch: int) -> np.ndarray:
        """The global indices of this rank's channels, in order, when
        ``n_ch`` channels sit on the grid (channel c on row
        c // (n_ch / rows))."""
        per = n_ch // self.shape["ch"]
        return np.concatenate([np.arange(r * per, (r + 1) * per)
                               for r in self.block[0]]).astype(np.int64)

    # -- collectives on host data --------------------------------------
    def _all_reduce(self, a, op) -> np.ndarray:
        a = np.asarray(a)
        if self.ranks is None:
            return a
        t = torch.from_numpy(np.array(a, copy=True))
        dist.all_reduce(_real(t), op)
        return t.numpy()

    def world_sum(self, a) -> np.ndarray:
        """Sum of ``a`` over every rank (the step's totals)."""
        return self._all_reduce(a, dist.ReduceOp.SUM)

    def world_max(self, a) -> np.ndarray:
        return self._all_reduce(a, dist.ReduceOp.MAX)

    def time_sum(self, x) -> np.ndarray:
        """``psum`` over "time": x [C, n_time, ...] holds this rank's
        cells and zeros elsewhere; returns [C, ...], each channel's sum
        over its time shards, the same on every rank.  The cells are
        gathered exactly (a value plus zeros) and summed here, so every
        rank reduces in the one-process order."""
        return self.world_sum(x).sum(axis=1)

    def time_mean(self, x) -> np.ndarray:
        """``pmean`` over "time", as :meth:`time_sum`."""
        return self.world_sum(x).mean(axis=1)

    def ring_halo(self, tail: torch.Tensor) -> torch.Tensor:
        """``ppermute`` ring over "time": ``tail`` [C_r, halo] is the end
        of this rank's last time block of each of its channels; returns
        the end of the block before its first one, zeros before block 0
        (the exchange runs on host copies)."""
        rows, t0, t1 = self.block
        if self.ranks is None:
            return torch.zeros_like(tail)
        dev, tail = tail.device, tail.cpu()
        left = torch.zeros_like(tail)
        per = tail.shape[0] // len(rows)
        n_t = self.shape["time"]
        send: dict = {}
        recv: dict = {}
        for i, r in enumerate(rows):
            sl = slice(i * per, (i + 1) * per)
            if t1 < n_t:
                send.setdefault(self.ranks[r][t1], []).append(sl)
            if t0 > 0:
                recv.setdefault(self.ranks[r][t0 - 1], []).append(sl)
        reqs, got = [], []
        for src, sls in recv.items():
            buf = tail.new_empty((len(sls) * per,) + tuple(tail.shape[1:]))
            reqs.append(dist.irecv(_real(buf), src))
            got.append((buf, sls))
        sent = [torch.cat([tail[s] for s in sls]) for sls in send.values()]
        reqs += [dist.isend(_real(m), dst) for dst, m in zip(send, sent)]
        for req in reqs:
            req.wait()
        for buf, sls in got:
            for j, s in enumerate(sls):
                left[s] = buf[j * per:(j + 1) * per]
        return left.to(dev)


def rank_mesh(n_ch: int, n_time: int, layout: str, devices=None) -> Mesh:
    """The (channel x time-block) grid over the process group's ranks.

    ``layout="ch"``: each rank holds whole channel rows (the pod's
    layout: channels are independent, so "ch" may span hosts);
    ``layout="time"``: each rank holds a run of time columns of every
    row, so a channel's halo and its per-channel means cross ranks.
    ``devices``: this rank's devices (default: its visible cards); its
    cells take them in turn, in contiguous runs, repeating a device when
    the rank holds more cells than it has devices."""
    if not dist.is_initialized():
        raise RuntimeError("rank_mesh needs distributed.init first")
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is none of {LAYOUTS}")
    world, rank = dist.get_world_size(), dist.get_rank()
    span = n_ch if layout == "ch" else n_time
    if span % world:
        raise ValueError(f"{world} ranks do not divide the grid's {span} "
                         f"{'rows' if layout == 'ch' else 'time columns'}")
    ranks = tuple(tuple((c if layout == "ch" else t) * world // span
                        for t in range(n_time)) for c in range(n_ch))
    devs = visible_devices(devices)
    own = [(c, t) for c in range(n_ch) for t in range(n_time)
           if ranks[c][t] == rank]
    grid = [[None] * n_time for _ in range(n_ch)]
    for k, (c, t) in enumerate(own):
        grid[c][t] = devs[k * len(devs) // len(own)]
    return Mesh(tuple(tuple(row) for row in grid), ranks, rank)
