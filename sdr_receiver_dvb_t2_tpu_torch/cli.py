"""Command-line receiver: the port's user-facing entry point.

Raw IQ in (a capture file or UDP datagrams), MPEG-TS out, on an NVIDIA
GPU unless ``--cpu`` is given.  The reference's plots and text views map
to the --stats interval printout, --monitor and --dump-constellation.

Examples:
  python -m sdr_receiver_dvb_t2_tpu_torch --input capture_10000000_8.raw \
      --out udp://127.0.0.1:7654
  python -m sdr_receiver_dvb_t2_tpu_torch --input iq.raw --rate 10e6 \
      --format s16 --out ts:out.ts --max-frames 100 --stats 10
  python -m sdr_receiver_dvb_t2_tpu_torch --pod channels.toml
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdr_receiver_dvb_t2_tpu_torch",
        description="DVB-T2 receiver on an NVIDIA GPU (PyTorch/CUDA): raw "
                    "IQ in, MPEG-TS out.")
    p.add_argument("--pod", metavar="TOML", default=None,
                   help="multi-channel pod mode: decode every channel of a "
                        "TOML config (per-channel inputs/sinks) on a "
                        "(ch x time) device grid with blind per-channel "
                        "acquisition, L1-dynamic tracking and relock; see "
                        "cli.run_pod")
    src = p.add_argument_group("input")
    src.add_argument("--input", required=False,
                     help="raw IQ capture file ('*_<rate>_<8|16|fc>.raw'), "
                          "or 'udp://:<port>' for live IQ datagrams")
    src.add_argument("--rate", type=float, default=None,
                     help="sample rate in Hz (overrides filename)")
    src.add_argument("--format", choices=["u8", "s8", "s16", "f32"],
                     default=None, help="raw sample format (overrides "
                                        "filename)")
    src.add_argument("--loop", action="store_true",
                     help="loop the input file at EOF (like the reference "
                          "rx_raw player)")
    src.add_argument("--control-port", type=int, default=None,
                     help="TCP gain-control port of an sdr_daemon bridge "
                          "(with udp:// input: enables live AGC/biastee; "
                          "rate and format come from the daemon)")
    out = p.add_argument_group("output")
    out.add_argument("--out", default="udp://127.0.0.1:7654",
                     help="TS sink: udp://host:port or a file path")
    rxg = p.add_argument_group("receiver")
    rxg.add_argument("--plp", default="0",
                     help="PLP index to decode, or 'all' to decode every "
                          "PLP (UDP sinks use port+i per PLP, like the "
                          "reference's per-PLP output table)")
    rxg.add_argument("--fir", choices=["soft", "medium", "sharp", "test1",
                                       "test2"],
                     default="medium", help="channel filter preset")
    rxg.add_argument("--frames-per-batch", type=int, default=2)
    rxg.add_argument("--ldpc-iters", type=int, default=15)
    rxg.add_argument("--max-frames", type=int, default=None)
    rxg.add_argument("--cpu", action="store_true",
                     help="run on the CPU (device='cpu'); without it the "
                          "receiver needs a CUDA device")
    rxg.add_argument("--notch-spur", action="store_true",
                     help="detect, track and notch a CW spur in the raw "
                          "spectrum (the reference's anti-spur option)")
    rxg.add_argument("--biastee", action="store_true",
                     help="enable the antenna bias tee on sources that "
                          "support it (live SDR daemons)")
    rxg.add_argument("--threaded-ingest", action="store_true",
                     help="read the source from a background thread via "
                          "the native lock-free ring (live inputs)")
    dbg = p.add_argument_group("diagnostics")
    dbg.add_argument("--stats", type=float, default=5.0,
                     help="statistics print interval in seconds (0=off)")
    dbg.add_argument("--monitor", type=float, metavar="SECS", default=0.0,
                     help="live in-run view refreshed every SECS: spectrum "
                          "sparkline, constellation density grid, LDPC "
                          "trials histogram, L1/PLP summary")
    dbg.add_argument("--monitor-npz", metavar="NPZ", default=None,
                     help="with --monitor: also refresh an .npz of the "
                          "current views each interval (render with "
                          "tools/plot_dumps.py)")
    dbg.add_argument("--dump-constellation", metavar="NPZ", default=None,
                     help="save diagnostics of the first locked frame to a "
                          ".npz: equalized constellation cells, spectrum, "
                          "P1 correlation trace (the reference's plot set)")
    dbg.add_argument("--dump-l1", action="store_true",
                     help="print the parsed L1-pre/post signalling (the "
                          "reference's L1 text display)")
    dbg.add_argument("--profile", metavar="DIR", default=None,
                     help="write a torch.profiler trace (Chrome trace JSON) "
                          "of the steady-state loop to DIR")
    return p


def _plp_sink_factory(out_spec: str):
    """Per-PLP sink factory for --plp all (every PLP is routed to UDP or
    file from its table, like the reference's main_window.cpp:608-632).

    udp://host:port      -> PLP ordinal i gets port+i
    path with '%d'       -> '%d' replaced by the PLP id
    'ts:dir/' (trailing /) -> dir/plp<id>.ts, one file per PLP
    other file path      -> '<stem>-plp<id><suffix>'
    """
    import os
    from .io import sinks

    def factory(ordinal: int, plp_id: int):
        if out_spec.startswith("udp://"):
            host, _, port = out_spec[6:].rpartition(":")
            return sinks.UdpTsSink(host or "127.0.0.1", int(port) + ordinal)
        path = out_spec.split(":", 1)[1] if out_spec.startswith(
            ("file:", "ts:")) else out_spec
        if "%d" in path:
            return sinks.FileTsSink(path % plp_id)
        if path.endswith(os.sep) or os.path.isdir(path):
            os.makedirs(path, exist_ok=True)
            return sinks.FileTsSink(os.path.join(path, f"plp{plp_id}.ts"))
        stem, dot, suffix = path.rpartition(".")
        return sinks.FileTsSink(f"{stem}-plp{plp_id}.{suffix}" if dot
                                else f"{path}-plp{plp_id}")

    return factory


def _open_source(args):
    """The IQ source of --input; None (after a message) when the options
    do not name one."""
    from .io import sources
    if args.input.startswith("udp://"):
        host, _, port = args.input[6:].rpartition(":")
        if args.control_port is not None:
            return sources.RemoteSdrSource(int(port), host or "127.0.0.1",
                                           args.control_port)
        if args.rate is None:
            print("--rate is required for UDP input without --control-port",
                  file=sys.stderr)
            return None
        return sources.UdpIqSource(int(port), args.rate, args.format or "s16")
    return sources.RawFileSource(args.input, sample_rate=args.rate,
                                 fmt=args.format, loop=args.loop)


def _dump_constellation(rx, path: str):
    import numpy as np
    import torch
    from .ops import p1_detect
    from .runtime import diagnostics
    m = rx.mode
    fs = m.frame_samples
    rx._need_elem(rx.frame_pos + fs)
    frame = rx._elem[rx.frame_pos:rx.frame_pos + fs]
    spec = np.fft.fftshift(np.fft.fft(frame[:m.fft_size]))
    # equalized constellation of the first locked frame (the reference's
    # constellation view, main_window.cpp:416-476)
    cells = rx.rx.equalized_cells(frame[None, :])
    metric, _, _ = p1_detect.correlate(
        torch.from_numpy(np.ascontiguousarray(frame[:4 * 2048]))
        .to(rx.device))
    np.savez(path, frame_iq=frame, spectrum=spec,
             constellation=diagnostics.constellation(cells),
             p1_metric=metric.cpu().numpy())
    print(f"diagnostics written to {path}", file=sys.stderr)


def run_pod(args) -> int:
    """Pod deployment entry: N channels on one device grid.

    The TOML config maps per-channel inputs onto blind acquisition +
    MultiChannelReceiver with per-channel TS sinks and stats lines::

        rate = 10e6          # device sample rate (Hz); or per channel
        format = "u8"        # raw format (u8/s8/s16/f32) for files
        mesh = [4, 1]        # optional [ch, time]; default: auto
        track = true         # close CFO/SRO loops per channel
        track_l1 = true      # per-step dynamic-L1 tracking
        relock = true        # partial acquisition + mid-stream relock
        max_steps = 0        # 0 = until the captures run out
        plp = 0              # PLP index, or "all" (per-PLP sinks)
        live = false         # stream via ChannelStore (bounded memory);
                             # auto-on when any input is udp://
        acquire_samples = 3000000   # blind-acquisition head (live mode)
        threaded_ingest = true      # per-channel ingest threads (live):
                                    # a silent antenna goes through the
                                    # relock path instead of stalling
        ingest_timeout = 2.0        # s to wait for a live channel's data
                                    # before zero-filling its window
        monitor = 0                 # SECS: the per-channel pod panel
        stats = 5.0                 # stats line interval, s (0 = off)

        [[channel]]
        input = "ch0_10000000_8.raw"
        out = "udp://127.0.0.1:7654"

        [[channel]]
        input = "udp://:4950"       # live daemon feed (needs rate/format)
        out = "ch1.ts"

    The pod runs on the visible CUDA devices (the default grid is one row
    a card, as many as divide the channel count) unless ``--cpu`` is
    given.  Live mode pulls each channel chunk-wise through a
    ``pod.ChannelStore`` (recycled-granule pool, consumed raw trimmed —
    a 24/7 pod holds only a bounded tail even on endless feeds), runs
    blind acquisition on a recorded head of each channel, and streams
    from absolute positions.  A channel that delivered too little for
    its head is acquired on zeros, fails, and streams dark until it
    relocks; only when no channel delivered enough does the pod stop.
    udp:// inputs use the daemon's seq-framed datagrams so drops are
    zero-filled, not time-shifting.
    """
    import os
    import tomllib
    import numpy as np
    import torch
    from . import resolve_device
    from .io import sources, sinks
    from .io.native import make_bb_parser
    from .parallel import acquire, pod, sharding
    from .runtime.stream import raw_to_complex_np

    with open(args.pod, "rb") as f:
        cfg = tomllib.load(f)
    chans = cfg.get("channel", [])
    if not chans:
        print("pod config has no [[channel]] entries", file=sys.stderr)
        return 2
    device = resolve_device("cpu" if args.cpu else None)
    C = len(chans)
    rate = float(cfg.get("rate", 0)) or None
    fmt = cfg.get("format")

    live = bool(cfg.get("live", False)) or any(
        str(ch["input"]).startswith("udp://") for ch in chans)
    store = None
    srcs: list = []
    if live:
        # LIVE ingest: per-channel chunked readers through a pooled
        # ChannelStore — bounded memory on endless feeds; blind
        # acquisition runs on a recorded head kept in the store
        chunk = 65536

        class _PoolReader:
            """Chunked read_into adapter: raw ints from an io.sources
            reader are scale-converted STRAIGHT into borrowed pool
            space (ChannelStore.ensure) — live ingest costs exactly one
            write pass per sample."""

            def __init__(self, src):
                self.src, self.fmt = src, src.info.fmt

            def read_into(self, buf):
                blk = self.src.read(min(len(buf), chunk))
                if blk is None or len(blk) == 0:
                    return None
                if blk.dtype == np.complex64:
                    buf[:len(blk)] = blk
                    return len(blk)
                return raw_to_complex_np(blk, self.fmt, out=buf)

        readers = []
        for ch in chans:
            inp = str(ch["input"])
            if inp.startswith("udp://"):
                if rate is None:
                    print("udp:// pod channels need rate = in the TOML",
                          file=sys.stderr)
                    return 2
                host, _, port = inp[6:].rpartition(":")
                src = sources.UdpIqSource(int(port), rate, fmt or "s16",
                                          host=host or "0.0.0.0", seq=True)
            else:
                src = sources.RawFileSource(inp, sample_rate=rate, fmt=fmt)
            rate = src.info.sample_rate
            srcs.append(src)
            readers.append(_PoolReader(src))
        if bool(cfg.get("threaded_ingest", True)):
            # per-channel ingest threads: one silent antenna must not
            # stall (or terminate) the other channels — its blocking
            # reads are absorbed and the shortfall goes through the
            # dead-channel relock machinery instead
            store = pod.ThreadedIngest(
                srcs, fmts=[s.info.fmt for s in srcs],
                eof_on_none=[not str(ch["input"]).startswith("udp://")
                             for ch in chans],
                timeout=float(cfg.get("ingest_timeout", 2.0)))
        else:
            store = pod.ChannelStore(C, readers=readers)
        acq_n = int(cfg.get("acquire_samples", 3_000_000))
        for c in range(C):
            store.ensure(c, acq_n)           # best effort on live feeds
        # each channel's head is what its reader delivered (a short
        # capture is not padded into a longer one's acquisition); a
        # channel that delivered too little is zero-filled, fails its
        # acquisition and streams dark
        heads = [min(acq_n, store.end(c)) for c in range(C)]
        if max(heads) < 200_000:
            print("not enough samples for blind acquisition",
                  file=sys.stderr)
            return 1
        raw = np.zeros((C, max(heads)), np.complex64)
        for c in range(C):
            store.window_into(c, 0, heads[c], raw[c])
    else:
        # recorded captures loaded whole (simplest path for short files)
        rows = []
        for ch in chans:
            src = sources.RawFileSource(ch["input"], sample_rate=rate,
                                        fmt=fmt)
            item = {"u8": 1, "s8": 1, "s16": 2, "f32": 4}[src.info.fmt]
            n_samp = os.path.getsize(ch["input"]) // (2 * item)
            blk = src.read(n_samp)
            src.close()
            if blk is None or n_samp == 0:
                print(f"empty capture: {ch['input']}", file=sys.stderr)
                return 2
            rows.append(blk if blk.dtype == np.complex64
                        else raw_to_complex_np(blk, src.info.fmt))
            rate = src.info.sample_rate
        n = min(len(r) for r in rows)
        raw = np.stack([r[:n] for r in rows])

    relock = bool(cfg.get("relock", True))
    plp = cfg.get("plp", 0)
    all_plps = plp == "all"
    lock = acquire.blind_acquire(
        raw, rate, plp_index=0 if all_plps else int(plp),
        all_plps=all_plps, allow_partial=relock, device=device)
    if lock is None:
        print("pod acquisition failed on every channel", file=sys.stderr)
        return 1
    for c in range(C):
        state = ("locked" if lock.locked[c]
                 else "MISMATCHED MUX" if c in lock.mismatched else "dark")
        print(f"ch{c}: {chans[c]['input']} -> {state}", file=sys.stderr)
    m = lock.cfg.mode
    print(f"pod config: {m.fft_size//1024}K FFT GI {m.guard.name} "
          f"{lock.cfg.plp.constellation.name} r="
          f"{lock.cfg.plp.code_rate.name}; {C} channels; device: "
          f"{device.type}", file=sys.stderr)

    mesh_shape = cfg.get("mesh")
    if mesh_shape:
        n_ch, n_time = int(mesh_shape[0]), int(mesh_shape[1])
    else:
        nd = torch.cuda.device_count() if device.type == "cuda" else 1
        n_ch = max(d for d in range(1, min(C, nd) + 1) if C % d == 0)
        n_time = 1
    try:
        mesh = sharding.make_mesh(
            n_ch, n_time,
            devices=None if device.type == "cuda"
            else [device] * (n_ch * n_time))
    except ValueError as e:
        print(f"pod mesh {[n_ch, n_time]}: {e}", file=sys.stderr)
        return 2
    rx = pod.MultiChannelReceiver(lock.cfg, mesh)

    out_specs = [ch.get("out", f"udp://127.0.0.1:{7654 + c}")
                 for c, ch in enumerate(chans)]
    # single PLP: one sink per channel from its out spec.  plp = "all":
    # every PLP gets its own per-channel sink from the same factory the
    # single-channel CLI uses (UDP port+i / file -plp<id> suffix)
    out_sinks: dict = {}                     # (channel, plp ordinal) -> sink
    parsers: dict = {}

    def sink_for(c: int, i: int, plp_id: int):
        key = (c, i)
        if key not in out_sinks:
            out_sinks[key] = (sinks.make_sink(out_specs[c]) if not all_plps
                              else _plp_sink_factory(out_specs[c])(i, plp_id))
            parsers[key] = make_bb_parser()
        return out_sinks[key], parsers[key]

    max_steps = int(cfg.get("max_steps", 0)) or None
    if live:
        stream_src, mu0 = store, lock.pos0 + lock.mu0   # ABSOLUTE
    else:
        stream_src, mu0 = lock.aligned(raw), lock.mu0
    pkts = np.zeros(C, np.int64)
    stats_s = float(cfg.get("stats", 5.0))
    t_last = time.monotonic()
    n_steps = 0
    mon = None
    if cfg.get("monitor"):
        from .runtime.monitor import PodMonitor
        mon = PodMonitor(interval=float(cfg["monitor"]))
    try:
        # each PLP's TS is parsed from its BB frames' bytes, so the
        # stream unpacks no bits
        for _, stats in rx.stream(
                stream_src, mu0, lock.step, freq=lock.freq,
                max_steps=max_steps, track=bool(cfg.get("track", True)),
                track_l1=bool(cfg.get("track_l1", True)), relock=relock,
                locked=lock.locked, frame_idx0=lock.frame_idx0, bits=False):
            if mon is not None:
                mon.maybe_render(stats, pkts, n_steps)
            for e in stats["events"]:
                print(f"event: {e}", file=sys.stderr)
            for i, res in enumerate(stats["plp_results"]):
                # BB frames with every BCH-dirty codeword corrected (or
                # dropped where the BCH could not), packed 8x
                bb = res.bb_bytes
                kb = res.state.plp.k_bch // 8
                for c in range(C):
                    if not stats["alive"][c]:
                        continue
                    sink, parser = sink_for(c, i, res.state.plp.plp_id)
                    ts = parser.parse_batch(
                        bb[c].reshape(-1, bb.shape[-1])[:, :kb])
                    if len(ts):
                        sink.write(ts)
                        pkts[c] += len(ts) // 188
            n_steps += 1
            if stats_s and time.monotonic() - t_last >= stats_s:
                line = " ".join(
                    f"ch{c}:{'up' if stats['alive'][c] else 'DOWN'}"
                    f"/{pkts[c]}pkt/{stats['bch_dirty_ch'][c]}dirty"
                    for c in range(C))
                print(f"step {n_steps} snr={stats['snr_db']:.1f}dB {line}",
                      file=sys.stderr)
                t_last = time.monotonic()
    finally:
        for s in out_sinks.values():
            s.close()
        if hasattr(store, "close"):
            store.close()
        for s in srcs:
            s.close()
    print(f"done: {n_steps} steps, per-channel TS packets: "
          f"{pkts.tolist()}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.pod is not None:
        return run_pod(args)
    if args.input is None:
        print("--input is required (or --pod)", file=sys.stderr)
        return 2

    from .io import sources, sinks
    from .runtime import stream as stream_mod

    from . import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    src = _open_source(args)
    if src is None:
        return 2
    if args.biastee and hasattr(src, "set_biastee"):
        src.set_biastee(True)
    if args.threaded_ingest:
        src = sources.ThreadedSource(src)
    plp_index = None if args.plp == "all" else int(args.plp)
    # --plp all: ALL sinks (the primary too) come from the per-PLP factory
    # so directory/pattern outputs can name files by the decoded PLP id
    sink = None if plp_index is None else sinks.make_sink(args.out)
    cfg = stream_mod.StreamConfig(
        fir_preset=args.fir, frames_per_batch=args.frames_per_batch,
        ldpc_max_iters=args.ldpc_iters, plp_index=plp_index,
        notch_spur=args.notch_spur)
    rx = stream_mod.StreamingReceiver(src, sink, cfg, device=device)
    if plp_index is None:
        # lazily create one sink per PLP announced in L1, whatever their
        # count: UDP gets port+i (the reference's per-PLP port table,
        # main_window.cpp:608-632), files get a %d pattern or a directory
        rx.sink_factory = _plp_sink_factory(args.out)

    print(f"input: {args.input} @ {src.info.sample_rate/1e6:.3f} Msps "
          f"({src.info.fmt}); output: {args.out}; device: {rx.device}",
          file=sys.stderr)
    try:
        return _receive(rx, args)
    finally:
        if rx.sink is not None:
            rx.sink.close()
        for extra in rx.plp_sinks.values():
            if extra is not None:
                extra.close()
        src.close()


def _receive(rx, args) -> int:
    """Acquire, then step batches until the input ends or --max-frames."""
    if not rx.acquire():
        print(f"acquisition failed: {rx.stats.state}", file=sys.stderr)
        return 1
    m = rx.mode
    eq = rx.rx.plan.eq
    plan = ("MISO" if m.miso else "SFN" if eq.cir_tab is not None
            else "linear")
    print(f"locked: {m.fft_size//1024}K FFT{' T2-Lite' if m.lite else ''}, "
          f"GI {m.guard.name}, {m.pilot_pattern.name}, equalizer {plan}, "
          f"L1: {rx.rx.plp.constellation.name} "
          f"r={rx.rx.plp.code_rate.name} {rx.rx.plp.fec_frame.name}; "
          f"CFO {rx.stats.cfo_hz:+.0f} Hz", file=sys.stderr)

    if args.dump_l1:
        from .runtime import diagnostics
        print(diagnostics.format_l1(rx._l1_pre, rx._l1_post),
              file=sys.stderr)
    if args.dump_constellation:
        _dump_constellation(rx, args.dump_constellation)

    prof = None
    if args.profile:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if rx.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                args.profile))
        prof.start()
    mon = None
    if args.monitor:
        from .runtime.monitor import Monitor
        mon = Monitor(interval=args.monitor, npz_path=args.monitor_npz)
    t_last = time.monotonic()
    try:
        while args.max_frames is None or rx.stats.frames < args.max_frames:
            if not rx.step_batch():
                break
            if mon is not None:
                mon.maybe_render(rx)
            if args.stats and time.monotonic() - t_last >= args.stats:
                s = rx.stats
                print(f"frames={s.frames} ts_pkts={s.ts_packets} "
                      f"snr={s.snr_db:.1f} dB ldpc_fail={s.ldpc_failures} "
                      f"bch_fix={s.bch_corrected} cfo={s.cfo_hz:+.0f} Hz "
                      f"sro={s.sro_ppm:+.1f} ppm", file=sys.stderr)
                t_last = time.monotonic()
    finally:
        if prof is not None:
            prof.stop()
            print(f"profiler trace written to {args.profile}",
                  file=sys.stderr)
    s = rx.stats
    print(f"done: frames={s.frames} ts_packets={s.ts_packets} "
          f"ldpc_failures={s.ldpc_failures} bch_dirty={s.bch_dirty}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
