#!/usr/bin/env python3
"""Where the host spends an untraced pod step: host clocks around the
calls of ``MultiChannelReceiver.stream`` and of ``cli.run_pod``'s parse
and write, with no synchronise added.

    python3 tools/pod_step_split.py --workload uk_hd_32k.pod8 --seed 0
    python3 tools/pod_step_split.py --workload uk_hd_32k.pod64 --out s.json

Runs one pass of a pod cell of BENCHMARK.json through
``cli.main(["--pod", toml])`` on its bench_cuda.py inputs (made from the
seed, or found in bench_cuda.py's cache).  A step is the interval between
two of the consumer's calls for the next step, as bench_cuda.py's
``wall_s``; it is split into the host time of each wrapped call made on
the consumer's thread at the top level (a call inside another wrapped
call counts as its caller's), the rest of the stream's body
(``stream_other``) and the rest of the consumer's loop
(``consumer_other``).  The parts of a step add up to its time.  A call
that waits for the card (a copy to the host, a copy to the card from
pageable memory, which synchronises its stream) shows that wait as its
own time.  Window copies made on worker threads are summed apart as
``window_into_work`` (the copy work beside the window phase's wall).

Prints one JSON line: the card (``nvidia-smi``), the steps, and each
part's mean and median over the steps after the first (ms); ``--out``
keeps every step.  With ``--profile`` the pass runs instead under
torch.profiler from the stream's start, with no clock around any stage,
and the line holds the device's idle share over the stream (bench_cuda's
breakdown; its traced runs synchronise around every stage, so they
cannot show work on the card overlapping the host's).  Off the card
(``--device cpu``) the figures are the CPU's, for rehearsal only.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


class Split:
    """Host clocks around named calls: per step, each part's seconds on
    the consumer's thread (top-level calls only), and the seconds of the
    calls made on other threads."""

    def __init__(self):
        self.main = threading.get_ident()
        self.depth = 0
        self.acc: dict = {}
        self.steps: list = []
        self._lock = threading.Lock()
        self._undo = []

    def wrap(self, owner, name, label):
        orig = getattr(owner, name, None)
        if orig is None:
            return
        split = self

        def fn(*a, **kw):
            if threading.get_ident() != split.main:
                t = time.perf_counter()
                try:
                    return orig(*a, **kw)
                finally:
                    with split._lock:
                        k = f"{label}_work"
                        split.acc[k] = split.acc.get(k, 0.0) + (
                            time.perf_counter() - t)
            if split.depth:
                return orig(*a, **kw)
            split.depth += 1
            t = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                split.depth -= 1
                split.acc[label] = split.acc.get(label, 0.0) + (
                    time.perf_counter() - t)
        setattr(owner, name, fn)
        self._undo.append((owner, name, orig))

    def wrap_object(self, obj, name, label):
        """Wraps a method of one object (an instance attribute)."""
        orig = getattr(obj, name)
        split = self

        def fn(*a, **kw):
            t = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                split.acc[label] = split.acc.get(label, 0.0) + (
                    time.perf_counter() - t)
        setattr(obj, name, fn)

    def restore(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)


# the calls of a step, by the part they are counted in
STREAM_CALLS = [
    ("pod._ArrayStore", "ensure", "ensure"),
    ("pod.ChannelStore", "ensure", "ensure"),
    ("pod", "_copy_windows", "window"),
    ("pod._ArrayStore", "window_into", "window_into"),
    ("pod.ChannelStore", "window_into", "window_into"),
    ("pod._ArrayStore", "trim_before", "trim"),
    ("pod.MultiChannelReceiver", "_frame_offsets", "bases"),
    ("sharding.ShardedReceiver", "host_bases_windows", "bases"),
    ("sharding.ShardedReceiver", "plane_step_windows", "plane_launch"),
    ("pod.MultiChannelReceiver", "_decode_l1", "l1_decode"),
    ("pod.MultiChannelReceiver", "_apply_l1_dyn", "l1_apply"),
    ("sharding.ShardedReceiver", "fec_step_async", "fec_launch"),
    ("sharding.ShardedReceiver", "fec_finish", "fec_finish"),
    ("pod", "_drop_shards", "drop_shards"),
    ("np", "unpackbits", "unpack"),
    ("sharding.PlaneResult", "diag_host", "diag"),
    ("pod.MultiChannelReceiver", "_harvest_inband", "inband"),
    ("pod.MultiChannelReceiver", "_try_relock", "relock"),
]


def run_split(toml, device="cuda"):
    """One ``--pod`` run of ``toml`` with the step split on: (exit code,
    [per-step dict of seconds])."""
    import numpy as np
    from sdr_receiver_dvb_t2_tpu_torch import cli
    from sdr_receiver_dvb_t2_tpu_torch.io import native, sinks
    from sdr_receiver_dvb_t2_tpu_torch.parallel import pod, sharding
    where = {"pod": pod, "sharding": sharding, "np": np}
    split = Split()
    for path, name, label in STREAM_CALLS:
        head, _, cls = path.partition(".")
        owner = getattr(where[head], cls) if cls else where[head]
        split.wrap(owner, name, label)

    make_parser, make_sink = native.make_bb_parser, sinks.make_sink

    def parser(*a, **kw):
        p = make_parser(*a, **kw)
        split.wrap_object(p, "parse_batch", "parse")
        return p

    def sink(*a, **kw):
        s = make_sink(*a, **kw)
        split.wrap_object(s, "write", "write")
        return s
    native.make_bb_parser, sinks.make_sink = parser, sink

    orig_stream = pod.MultiChannelReceiver.stream

    def stream(rx, *a, **kw):
        gen = orig_stream(rx, *a, **kw)
        t_yield = None
        while True:
            t0 = time.perf_counter()
            if t_yield is not None:
                rec = split.steps[-1]
                rec["consumer"] = t0 - t_yield
                rec["wall"] = t0 - rec.pop("t0")
                rec.update(split.acc)
            split.acc = {}
            try:
                item = next(gen)
            except StopIteration:
                return
            t_yield = time.perf_counter()
            split.steps.append(dict(split.acc, t0=t0, stream=t_yield - t0))
            split.acc = {}
            yield item
    pod.MultiChannelReceiver.stream = stream
    argv = ["--pod", str(toml)] + (["--cpu"] if device == "cpu" else [])
    try:
        rc = cli.main(argv)
    finally:
        pod.MultiChannelReceiver.stream = orig_stream
        native.make_bb_parser, sinks.make_sink = make_parser, make_sink
        split.restore()
    return rc, split.steps


def run_profiled(toml, device="cuda"):
    """One ``--pod`` run of ``toml`` under torch.profiler from the
    stream's start, with no clock or probe around any stage: (exit code,
    bench_cuda's breakdown of the trace: the device's idle share from its
    first operation to its last, its busiest operations; None off the
    card)."""
    import bench_cuda as bc
    from sdr_receiver_dvb_t2_tpu_torch import cli
    from sdr_receiver_dvb_t2_tpu_torch.parallel import pod
    trace = bc.Trace(device)
    orig_stream = pod.MultiChannelReceiver.stream

    def stream(rx, *a, **kw):
        trace.start()
        yield from orig_stream(rx, *a, **kw)
    pod.MultiChannelReceiver.stream = stream
    argv = ["--pod", str(toml)] + (["--cpu"] if device == "cpu" else [])
    try:
        rc = cli.main(argv)
    finally:
        pod.MultiChannelReceiver.stream = orig_stream
        trace.stop()
    return rc, trace.breakdown()


CONSUMER_PARTS = ("parse", "write")


def summarize(steps) -> dict:
    """Each part's mean and median (ms) over the whole steps after the
    first, with ``stream_other`` and ``consumer_other`` the rest of the
    stream's and the consumer's time.  A step's parts are counted in the
    step whose interval they fall in."""
    import numpy as np
    done = [s for s in steps if "wall" in s][1:]
    stream_parts = sorted({k for s in done for k in s} - {
        "wall", "stream", "consumer", *CONSUMER_PARTS}
        - {k for s in done for k in s if k.endswith("_work")})
    rows = []
    for s in done:
        r = {k: s.get(k, 0.0) for k in stream_parts + list(CONSUMER_PARTS)}
        r["stream_other"] = s["stream"] - sum(s.get(k, 0.0)
                                              for k in stream_parts)
        r["consumer_other"] = s["consumer"] - sum(
            s.get(k, 0.0) for k in CONSUMER_PARTS)
        r["wall"] = s["wall"]
        for k in s:
            if k.endswith("_work"):
                r[k] = s[k]
        rows.append(r)
    keys = sorted({k for r in rows for k in r})
    return {k: dict(mean_ms=float(np.mean([r.get(k, 0.0) for r in rows]))
                    * 1e3,
                    median_ms=float(np.median([r.get(k, 0.0) for r in rows]))
                    * 1e3)
            for k in keys} if rows else {}


def main(argv=None) -> int:
    import bench_cuda as bc
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="uk_hd_32k.pod8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps of the pass (0: the whole capture)")
    ap.add_argument("--cache", type=Path, default=bc.CACHE)
    ap.add_argument("--out", type=Path, help="every step's split, JSON")
    ap.add_argument("--profile", action="store_true",
                    help="instead of the split, the device's idle share "
                    "under torch.profiler (no clock around any stage)")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("pod_step_split: no CUDA device", file=sys.stderr)
        return 2
    cells = {w["name"]: w for w in bc.load_benchmark()["workloads"]}
    cell = cells[args.workload]
    tr = bc.Traffic(**cell["traffic"])
    if tr.kind != "pod":
        print(f"pod_step_split: {args.workload} is not a pod cell",
              file=sys.stderr)
        return 2
    configs = {cell["config"]: bc.CONFIGS[cell["config"]]()}
    where = "cpu"
    if args.device == "cuda":
        from sdr_receiver_dvb_t2_tpu_torch.io import native
        from sdr_receiver_dvb_t2_tpu_torch.ops import _build
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build_all()
        native.build()
        where = bc.nvidia_smi_line()
    _, captures = bc.make_inputs([(args.workload, cell["config"], tr)],
                                 args.seed, args.cache, bc.WORKERS, configs)
    paths = captures[args.workload]
    outs = [Path(p).with_suffix(".split.ts") for p in paths]
    toml = Path(paths[0]).with_suffix(".split.toml")
    bc._pod_toml(paths, outs, toml, args.steps)
    t0 = time.perf_counter()
    if args.profile:
        rc, breakdown = run_profiled(toml, args.device)
        steps = []
    else:
        rc, steps = run_split(toml, args.device)
    run_s = time.perf_counter() - t0
    ts_bytes = [o.stat().st_size if o.exists() else 0 for o in outs]
    for o in outs:
        o.unlink(missing_ok=True)
    line = dict(tool="pod_step_split", workload=args.workload,
                seed=args.seed, device=where, rc=rc, run_s=run_s,
                ts_bytes=ts_bytes)
    if args.profile:
        line.update(profiled=True, breakdown=breakdown)
    else:
        line.update(steps=len(steps), parts=summarize(steps))
    print(json.dumps(line), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(line, every_step=steps)))
    return 0 if rc == 0 and all(ts_bytes) else 1


if __name__ == "__main__":
    sys.exit(main())
