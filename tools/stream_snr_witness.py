#!/usr/bin/env python3
"""Does the JAX streaming receiver lose the same SNR to its front end and
tracking as the PyTorch port?  Both packages on the CPU, on one capture.

    JAX_PLATFORMS=cpu python3 tools/stream_snr_witness.py [--frames 12]

The 2K u8 capture of the port's stream parity test
(tests/test_torch_stream.py: tests/test_stream_e2e.py's impairments at
10 Msps, CFO +31 kHz, SRO +19 ppm, DC and IQ imbalance, 26 dB AWGN, at GI
1/32 PP4) goes through

1. ``stream``: the JAX and the port's ``StreamingReceiver`` (front end,
   acquisition, tracking, frame receiver);
2. ``bypass``: the exact inverse of the channel (tools/stream_witness.py's
   ``inverse_channel``) and then the JAX and the port's frame receivers,
   primed with the first frame: no front end.

Prints each receiver's SNR estimate a batch, its LDPC failures and
BCH-dirty codewords.  One JSON line a run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "tools")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from _port_capture import port_capture
    from sdr_receiver_dvb_t2_tpu.io import sinks as jsinks
    from sdr_receiver_dvb_t2_tpu.io import sources as jsources
    from sdr_receiver_dvb_t2_tpu.models import receiver as jrx
    from sdr_receiver_dvb_t2_tpu.runtime import stream as jstream
    from sdr_receiver_dvb_t2_tpu_torch.io import sinks, sources
    from sdr_receiver_dvb_t2_tpu_torch.models import receiver as trx
    from sdr_receiver_dvb_t2_tpu_torch.models.channel import ChannelConfig
    from sdr_receiver_dvb_t2_tpu_torch.ops import frontend
    from sdr_receiver_dvb_t2_tpu_torch.runtime import stream
    from stream_witness import inverse_channel
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    tmp = tempfile.mkdtemp()
    path, ts, mode = port_capture(tmp, guard="G1_32", pilot_pattern="PP4",
                                  n_frames=args.frames)
    fs = mode.frame_samples
    runs = {}
    for name, mod, src_mod, sink_mod, kw, extra in (
            ("port", stream, sources, sinks, dict(device="cpu"), {}),
            ("jax", jstream, jsources, jsinks, {},
             dict(use_pallas=False))):
        rx = mod.StreamingReceiver(
            src_mod.RawFileSource(path), sink_mod.BufferTsSink(),
            mod.StreamConfig(acq_elem_samples=3 * fs, **extra), **kw)
        snrs, step = [], rx.step_batch

        def timed(step=step, rx=rx, snrs=snrs):
            ok = step()
            if ok:
                snrs.append(float(rx.stats.snr_db))
            return ok
        rx.step_batch = timed
        st = rx.run()
        runs[name] = rx
        print(json.dumps(dict(run="stream", receiver=name, frames=st.frames,
                              ldpc_failures=st.ldpc_failures,
                              bch_dirty=st.bch_dirty, snr_db=snrs)),
              flush=True)

    # the channel of port_capture, inverted exactly (its noise stays)
    ch = ChannelConfig(device_rate=10_000_000, cfo_hz=31e3, sro_ppm=19.0,
                       phase0=1.1, dc_offset=0.02 - 0.01j, iq_gain_db=0.2,
                       iq_phase_deg=1.0)
    raw = torch.from_numpy(np.fromfile(path, np.uint8))
    elem = inverse_channel(frontend.raw_to_iq(raw, "u8").numpy() / 0.4, ch)
    prx = runs["port"]
    n = (len(elem) - 256) // fs
    frames = elem[:n * fs].reshape(n, fs)
    plp = prx.rx.plp
    rxs = dict(
        port=trx.TorchReceiver(prx.rx.cfg, device="cpu"),
        jax=jrx.TpuReceiver(jrx.RxConfig(
            mode=runs["jax"].mode, plp=runs["jax"].rx.plp,
            n_fec_per_frame=prx.rx.cfg.n_fec_per_frame,
            n_ti=prx.rx.cfg.n_ti, use_pallas=False)))
    for name, rx in rxs.items():
        rx.prime(frames[0])
        res = [rx.receive(frames[i:i + 2]) for i in range(0, n - 1, 2)]
        print(json.dumps(dict(
            run="bypass", receiver=name, plp=plp.ldpc_table_name,
            ldpc_failures=int(sum(np.sum(~r.ldpc_ok) for r in res)),
            bch_dirty=int(sum(np.sum(~r.bch_clean) for r in res)),
            snr_db=[float(r.snr_db) for r in res])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
