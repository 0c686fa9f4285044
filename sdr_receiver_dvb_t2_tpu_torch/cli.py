"""Command-line receiver: the port's user-facing entry point.

Raw IQ in (a capture file or UDP datagrams), MPEG-TS out, on an NVIDIA
GPU unless ``--cpu`` is given.  The reference's plots and text views map
to the --stats interval printout, --monitor and --dump-constellation.

Examples:
  python -m sdr_receiver_dvb_t2_tpu_torch --input capture_10000000_8.raw \
      --out udp://127.0.0.1:7654
  python -m sdr_receiver_dvb_t2_tpu_torch --input iq.raw --rate 10e6 \
      --format s16 --out ts:out.ts --max-frames 100 --stats 10
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
                   help="multi-channel pod mode: not ported yet (ROADMAP.md "
                        "section 1 item 15); exits 2")
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.pod is not None:
        print("--pod: the multi-channel pod is not ported yet (ROADMAP.md "
              "section 1 item 15)", file=sys.stderr)
        return 2
    if args.input is None:
        print("--input is required", file=sys.stderr)
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
