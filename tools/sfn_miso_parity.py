#!/usr/bin/env python3
"""The numbers behind the port's SFN and MISO parity tests, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/sfn_miso_parity.py

Runs the inputs of tests/test_torch_sfn.py and tests/test_torch_miso.py
through both packages and prints one JSON object: the SFN plane's
distance from the JAX plane (unweighted, above the -30 dB channel-power
floor, CSI-weighted), csi and the delay profile; both packages' channel
estimates against the true two-path channel and against each other; the
MISO plane; and the int8 LLR differences of the JAX demap on float32 and
on bf16-representable planes.  About a minute, a few hundred MB.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def sfn_numbers():
    import numpy as np
    import torch
    import jax.numpy as jnp
    import test_torch_sfn as T
    from sdr_receiver_dvb_t2_tpu.ops import rx_chain as jrc
    from sdr_receiver_dvb_t2_tpu.ops.cplx import C
    from sdr_receiver_dvb_t2_tpu_torch.ops import rx_chain
    jplan, plan = T._plan_pair(T.SFN_MODE, T.SFN_PLP, T.N_FEC, 2000, False)
    _, tmode = T.mode_pair(T.SFN_MODE)
    planes, H = T._two_path_planes(tmode)
    want_eq, want = T._jax_equalize(jplan, planes)
    consts = plan.to_device("cpu")
    eq, diag = rx_chain.equalize_plane(torch.from_numpy(planes), plan, consts)
    eq, csi = eq.numpy(), diag["csi"].numpy()
    keep = csi >= T.CSI_FLOOR
    cir, want_cir = diag["cir_p"].numpy(), want["cir_p"]
    # the channel estimates alone, on one frame without per-symbol phase
    # (the interpolation of tests/test_sfn_channel.py), against the truth
    p = planes[0] * np.exp(-1j * (0.4 + 0.07 * np.arange(len(planes[0]))
                                  ))[:, None].astype(np.complex64)
    L, K = tmode.frame_symbols, tmode.k_total
    packed = jrc._pack_bf16(C(jnp.asarray(p.real), jnp.asarray(p.imag)))
    eqj = jplan.eq
    hj = jrc._grouped_interp(packed.reshape(-1), eqj.device_consts()["w"],
                             eqj.group_syms, eqj.regroup, K)
    est_j = np.asarray(hj.re) + 1j * np.asarray(hj.im)
    est_p = rx_chain._grouped_interp(torch.from_numpy(p).reshape(1, -1),
                                     consts["w"], consts["regroup"],
                                     K)[0].numpy()
    h = H                     # the per-symbol phase is removed above
    mid = slice(4, L - 4)
    return dict(
        plane_db=T._rel_db(eq, want_eq),
        plane_above_floor_db=T._rel_db(eq[keep], want_eq[keep]),
        cells_above_floor=float(keep.mean()),
        plane_csi_weighted_db=float(T._rel_db(eq, want_eq, csi)),
        csi_db=T._rel_db(csi, want["csi"]),
        cir_max_over_peak=float(np.max(np.abs(cir - want_cir))
                                / want_cir.max()),
        estimate_jax_vs_truth_db=T._rel_db(est_j[mid], h[None]),
        estimate_port_vs_truth_db=T._rel_db(est_p[mid], h[None]),
        estimate_port_vs_jax_db=T._rel_db(est_p, est_j))


def llr_numbers(counts):
    """Each test's demap_parity counts, recorded as the tests run."""
    import test_torch_miso as M
    import test_torch_sfn as T
    orig = T.demap_parity

    def record(name):
        def spy(*args):
            counts[name] = orig(*args)
            return counts[name]
        return spy
    T.demap_parity = record("sfn")
    T.test_sfn_frames_llr_bits_and_ts_match_jax()
    M.demap_parity = record("miso")
    M.test_miso_equalize_and_receive_match_jax()
    return {k: dict(float32_planes=v[0], bf16_planes=v[1])
            for k, v in counts.items()}


def miso_plane():
    import numpy as np
    import torch
    import jax
    import jax.numpy as jnp
    import test_torch_miso as M
    from sdr_receiver_dvb_t2_tpu.ops import cplx
    from sdr_receiver_dvb_t2_tpu.ops import rx_chain as jrc
    from sdr_receiver_dvb_t2_tpu_torch.ops import ofdm, rx_chain
    _, tmode = M.mode_pair(M.MISO_MODE)
    _, tplp = M.plp_pair(M.PLP)
    frames, _, _, l1 = M._miso_frames(tmode, tplp)
    jr, rx = M._receivers(M.MISO_MODE, M.PLP, l1)
    car, _ = ofdm.demod_frame(torch.from_numpy(frames), tmode)
    fn = jax.jit(lambda c, k: jrc.equalize_plane(c, jr._plan, k))
    want = [fn(cplx.C(jnp.asarray(c.real), jnp.asarray(c.imag)), jr._consts)
            for c in car.numpy()]
    weq = np.stack([np.asarray(e.re) + 1j * np.asarray(e.im)
                    for e, _ in want])
    eq, _ = rx_chain.equalize_plane(car, rx.plan, rx.consts)
    return dict(plane_db=M._rel_db(eq.numpy(), weq))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import conftest  # noqa: F401  (JAX on the CPU, as the tests run it)
    out = dict(sfn=sfn_numbers(), miso=miso_plane(),
               llr=llr_numbers({}))
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
