#!/usr/bin/env python3
"""How often the port's SFN and MISO frame receive leaves a BCH-dirty
codeword at 27 dB, on the card, and what such a codeword looks like.

    python3 tools/bch_dirty_witness.py [--seeds 6] [--out PATH]

Needs an NVIDIA GPU (nvcc builds the LDPC kernel at first use).  The
full-width signals of ``chip_smoke.py`` phases 6-7 (bench.py
``_bench_sfn``: 32K GI 1/32 PP7 with a -10 dB echo; ``_bench_miso``: 32K
PP8 MISO with two two-path channels) are made once by the port's
transmitter, noise-free; each seed then adds its own 27 dB of AWGN and
``TorchReceiver`` receives two frames.  A control row runs the SFN mode
without the echo.  For every codeword whose LDPC converged but whose BCH
syndrome is not zero it reports the information bits the host BCH
corrected, the channel LLRs at those bits, its sweeps, and whether the
twin with the Pallas kernel's 128-codeword exit tile ends clean.  Prints
one JSON object, and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEVICE = "cuda"


def _dirty_detail(rx, llr, res, i):
    """One BCH-dirty codeword: the bits the BCH corrected (their count; the
    positions and channel LLRs of those among the BB-frame bits), sweeps,
    and the twin with exit_tile=128 on the same LLRs."""
    import numpy as np
    import torch
    from sdr_receiver_dvb_t2_tpu_torch.ops import bch_ops, ldpc
    plp = rx.plp
    hard = np.unpackbits(rx.decoder(llr[i:i + 1])[0][0].cpu().numpy())
    fixed, nerr = bch_ops.correct_host(hard.astype(np.uint8), plp)
    pos = np.nonzero(fixed != hard[:plp.k_bch])[0]    # BB-frame bits only
    h = bch_ops._h_matrix(plp.k_bch, plp.bch_m, plp.bch_t)
    tile = ldpc.decode_plain(llr[i:i + 1].cpu(), plp.ldpc_table_name, 15, h,
                             exit_tile=128)
    return dict(codeword=int(i), bits_corrected=int(nerr),
                positions=pos.tolist(),
                channel_llr=llr[i, torch.from_numpy(pos).to(llr.device)]
                .cpu().tolist(),
                sent_bits=fixed[pos].tolist(), iters=int(res.ldpc_iters[i]),
                tile_exit_clean=bool(tile[3][0]))


def run_case(name, config, iq, n_fec, l1_post, drop, seeds, snr_db):
    import numpy as np
    import torch
    import chip_smoke as cs
    from sdr_receiver_dvb_t2_tpu_torch.models.receiver import (
        RxConfig, TorchReceiver)
    from sdr_receiver_dvb_t2_tpu_torch.ops import rx_chain
    mode, plp = config()
    rx = TorchReceiver(RxConfig(mode=mode, plp=plp, n_fec_per_frame=n_fec,
                                n_ti=1), device=DEVICE)
    rx._l1_post_cells = l1_post
    rows = []
    for seed in seeds:
        x = cs._awgn(iq, snr_db, seed)[drop * mode.frame_samples:]
        frames = x.reshape(-1, mode.frame_samples).astype(np.complex64)
        eq, diag = rx.compute_plane(frames)
        llr, _ = rx_chain.packed_to_llr(eq, rx.plan, rx.consts,
                                        csi=diag.get("csi"))
        res = rx.receive_plane(eq, diag)
        dirty = np.nonzero(res.ldpc_ok & ~res.bch_clean)[0]
        rows.append(dict(
            seed=seed, codewords=int(len(res.ldpc_ok)),
            ldpc_failed=int(np.sum(~res.ldpc_ok)), bch_dirty=int(len(dirty)),
            uncorrectable=int(np.sum(res.bch_corrected < 0)),
            snr_db=res.snr_db,
            dirty=[_dirty_detail(rx, llr, res, i) for i in dirty]))
    n = sum(r["codewords"] for r in rows)
    d = sum(r["bch_dirty"] for r in rows)
    return dict(case=name, codewords=n, bch_dirty=d,
                ldpc_failed=sum(r["ldpc_failed"] for r in rows),
                uncorrectable=sum(r["uncorrectable"] for r in rows),
                dirty_per_1000=1000.0 * d / n, seeds=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--snr-db", type=float, default=27.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bch_dirty_witness: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = [29 + s for s in range(args.seeds)]
    t0 = time.perf_counter()
    iq, n_fec, _ts, l1_post = cs.sfn_channel()
    iq0, _, _, _ = cs.sfn_channel(echo=0.0)
    miq, m_fec, _mts, m_l1 = cs.miso_channel()
    tx_s = time.perf_counter() - t0
    out = dict(device=cs.nvidia_smi_line(), snr_db=args.snr_db,
               transmitter_s=tx_s, cases=[
                   run_case("sfn 32K GI 1/32 PP7, -10 dB echo at 614",
                            cs.sfn_config, iq, n_fec, l1_post, 1, seeds,
                            args.snr_db),
                   run_case("sfn 32K GI 1/32 PP7, no echo", cs.sfn_config,
                            iq0, n_fec, l1_post, 1, seeds, args.snr_db),
                   run_case("miso 32K GI 1/128 PP8, two two-path channels",
                            cs.miso_config, miq, m_fec, m_l1, 0, seeds,
                            args.snr_db)])
    text = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
