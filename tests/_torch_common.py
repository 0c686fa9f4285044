"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Each case is built twice, once from each package's own ``params.modes``
(the two packages share no classes), from one numpy seed.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from threadpoolctl import threadpool_limits

from sdr_receiver_dvb_t2_tpu.ops import bch_ops as jbch
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas
from sdr_receiver_dvb_t2_tpu.params import bch as bch_par
from sdr_receiver_dvb_t2_tpu.params import ldpc as ldpc_mod
from sdr_receiver_dvb_t2_tpu.params import modes as jm
from sdr_receiver_dvb_t2_tpu_torch.params import modes as tm

# The suite runs in several pytest-xdist workers at once.  PyTorch's CPU
# pool takes every core in each of them, and the workers' spinning pools
# then slow the small int32 ops of the LDPC twin some twentyfold; one
# thread per worker keeps each file near its single-process time.
torch.set_num_threads(1)
# numpy's OpenBLAS likewise: the SFN plans solve one small LMMSE system
# per 256-carrier segment, and eight spinning BLAS threads a worker slow
# those solves a hundredfold while the other workers hold the cores
threadpool_limits(1)

# tests/test_receiver_e2e.py's fixture: 8K, GI 1/32, PP3, 64QAM SHORT r2/3
FIXTURE_MODE = dict(fft_mode="FFT_8K", guard="G1_32", pilot_pattern="PP3",
                    extended_carriers=True, n_data_symbols=20)
FIXTURE_PLP = dict(constellation="QAM64", code_rate="C2_3",
                   fec_frame="SHORT", num_blocks_max=10, time_il_length=3)
# bench.py's flagship: 32K, GI 1/128, PP7 ext, rotated 256QAM NORMAL r2/3
FLAGSHIP_MODE = dict(fft_mode="FFT_32K", guard="G1_128", pilot_pattern="PP7",
                     extended_carriers=True, n_data_symbols=59)
FLAGSHIP_PLP = dict(constellation="QAM256", rotation=True, code_rate="C2_3",
                    fec_frame="NORMAL", time_il_length=1, num_blocks_max=254)

_ENUMS = dict(fft_mode="FftMode", guard="GuardInterval",
              pilot_pattern="PilotPattern", constellation="Constellation",
              code_rate="CodeRate", fec_frame="FecFrame")


def _kw(mod, spec):
    return {k: getattr(getattr(mod, _ENUMS[k]), v) if k in _ENUMS else v
            for k, v in spec.items()}


def mode_pair(spec):
    """(JAX T2Mode, port T2Mode) of one spec."""
    return jm.T2Mode(**_kw(jm, spec)), tm.T2Mode(**_kw(tm, spec))


def plp_pair(spec):
    return jm.PlpConfig(**_kw(jm, spec)), tm.PlpConfig(**_kw(tm, spec))


@functools.lru_cache(maxsize=4)
def fixture_frames(snr_db=25.0, phase=np.pi / 6, seed=7, n_packets=400):
    """The e2e fixture's frames (JAX package's transmitter) and TS input."""
    from sdr_receiver_dvb_t2_tpu.models.transmitter import (
        Transmitter, TxConfig, random_ts_stream)
    mode, _ = mode_pair(FIXTURE_MODE)
    plp, _ = plp_pair(FIXTURE_PLP)
    tx = Transmitter(TxConfig(mode=mode, plp=plp, fec_blocks_per_frame=6))
    ts_in = random_ts_stream(n_packets)
    iq = tx.modulate(ts_in)
    f = len(iq) // mode.frame_samples
    frames = iq[:f * mode.frame_samples].reshape(f, mode.frame_samples)
    if phase:
        frames = frames * np.exp(1j * phase).astype(np.complex64)
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        sigma = np.sqrt(np.mean(np.abs(frames) ** 2)
                        / 10 ** (snr_db / 10) / 2)
        frames = frames + sigma * (rng.standard_normal(frames.shape)
                                   + 1j * rng.standard_normal(frames.shape))
    return frames.astype(np.complex64), ts_in


def jax_plan_arrays(jplan) -> dict:
    """A JAX ChainPlan's tables as numpy, keyed like the port's
    ChainPlan.arrays(): linear, Wiener (SFN) and MISO plans alike."""
    eq = jplan.eq
    out = dict(cell_idx=jplan.cell_idx, bit_rows=jplan.bit_rows,
               sig_idx=jplan.sig_idx, ph_mask1=eq.ph_mask[0],
               ph_mask2=eq.ph_mask[1], regroup=eq.regroup,
               sro_idx=eq.eq_plan.sro_idx, sro_ref=eq.eq_plan.sro_ref,
               sro_first_half=eq.eq_plan.sro_first_half)

    def put(prefix, weights):
        for j, (wi, si_re, si_im, wb, rot) in enumerate(weights):
            out[f"{prefix}{j}_win_idx"] = wi
            out[f"{prefix}{j}_si_re"] = si_re
            out[f"{prefix}{j}_wband"] = wb
            if si_im is not None:
                out[f"{prefix}{j}_si_im"] = si_im
            if rot is not None:
                out[f"{prefix}{j}_rot_re"], out[f"{prefix}{j}_rot_im"] = rot
    put("w", eq.weights)
    if eq.ph_rot is not None:
        out["ph_rot"] = eq.ph_rot
    if eq.cir_tab is not None:
        out["cir_tab_re"], out["cir_tab_im"] = eq.cir_tab
        out["cir_d"] = eq.cir_d
    if jplan.mode.miso:
        put("walt", eq.weights_alt)
        out.update(regroup_alt=eq.regroup_alt, o_sign=eq.o_sign,
                   pair_idx=eq.pair_idx, pair_sign=eq.pair_sign)
    return {k: np.asarray(v) for k, v in out.items()}


def register_tiny_uniform():
    """The synthetic NORMAL-shaped code of tests/test_ldpc_pallas_interpret
    (q=2, k % r == 0, uniform weight with duplicate groups per row),
    registered in both packages' table registries."""
    from sdr_receiver_dvb_t2_tpu.params import tables as jt
    from sdr_receiver_dvb_t2_tpu_torch.params import tables as tt
    name = "TINY_UNIFORM_T"
    pos = np.array([10, 34, 19, 6, 23, 59, 14, 50, 27, 4, 17, 61],
                   dtype=np.int64)
    for tables in (jt, tt):
        if name not in tables._REGISTERED:
            tables.register_table(tables.LdpcTable(
                name, M=360, N=2160, K=1440, links_total=12, links_max_cn=8,
                deg=[3], length=[4], pos=pos))
    return name


LDPC_W = 128    # one Pallas tile


def ldpc_case(name):
    """(table, kernel-ordered int8 llr [LDPC_W, N], max_iters, bch_h or None,
    n_cw) — the interpret-mode test cases, padded with zero codewords to
    the Pallas tile as those tests pad them."""
    if name == "TINY_UNIFORM_T":
        register_tiny_uniform()
    rng = np.random.default_rng(dict(SHORT_C1_2=1, SHORT_C2_3=1,
                                     TINY_UNIFORM_T=3, BCH=5, TRIALS=7,
                                     B8=9, B9=11)[name])
    table = {"BCH": "SHORT_C1_2", "TRIALS": "SHORT_C1_2"}.get(name, name)
    code = ldpc_mod.get_code(table)
    bch_h, max_iters = None, 30
    if name == "BCH":
        k_bch, m = 7032, 14
        payload = rng.integers(0, 2, (3, k_bch), dtype=np.uint8)
        cws = np.stack([code.encode(bch_par.encode(p, m)) for p in payload])
        llr = ((1 - 2 * cws.astype(np.float32)) * 12
               + rng.normal(0, 4.0, cws.shape))
        llr[2] = rng.normal(0, 20.0, code.n)              # hopeless
        bch_h = jbch._h_matrix(k_bch, m, 12)
    elif name == "TRIALS":
        bits = rng.integers(0, 2, size=(3, code.k), dtype=np.uint8)
        cws = np.stack([code.encode(b) for b in bits])
        llr = (1 - 2 * cws.astype(np.float32)) * 24.0
        llr[1:] += rng.normal(0, 6.0, llr[1:].shape)
        max_iters = 20
    else:
        n_cw, sigma = (6, 5.0) if name == "TINY_UNIFORM_T" else (4, 4.0)
        bits = rng.integers(0, 2, size=(n_cw, code.k), dtype=np.uint8)
        cws = np.stack([code.encode(b) for b in bits])
        llr = ((1 - 2 * cws.astype(np.float32)) * 12
               + rng.normal(0, sigma, cws.shape))
    llr = llr.round().clip(-127, 127)
    ko = ldpc_pallas.kernel_bit_order(table)
    x = np.zeros((LDPC_W, code.n), np.int8)
    x[:len(llr)] = llr[:, ko]
    return table, x, max_iters, bch_h, len(llr)


# B8 / B9: the T2-Lite-only rate-1/3 and 2/5 tables (annex I)
LDPC_CASES = ["SHORT_C1_2", "SHORT_C2_3", "TINY_UNIFORM_T", "BCH", "TRIALS",
              "B8", "B9"]
