"""BCH syndrome screen, byte packing and host correction.

The all-but-certain case after a successful LDPC decode is "no residual
errors"; checking that is a GF(2) product of the codeword with the
parity-check matrix.  On the GPU that product is fused into the LDPC
kernel's epilogue (ops/csrc/ldpc_layered.cu); :func:`syndrome_flags` is its
plain version.  Only flagged codewords take the host Berlekamp-Massey path
(params/bch.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import bch
from ..params.modes import PlpConfig


@functools.lru_cache(maxsize=None)
def _h_matrix(k_bch: int, m: int, t: int):
    """[n_bch, m*t] GF(2) parity-check matrix, float32 0/1."""
    return np.asarray(bch.parity_check_matrix(k_bch, m, t).astype(np.float32))


def syndrome_flags(hard: torch.Tensor, bch_h: np.ndarray) -> torch.Tensor:
    """[W, >= n_bch] hard bits (0/1) -> [W] bool, True = syndrome zero.

    float32 products of 0/1 values are exact (sums <= n_bch < 2^24)."""
    h = torch.as_tensor(np.asarray(bch_h, np.float32), device=hard.device)
    s = hard[:, :h.shape[0]].to(torch.float32) @ h
    return ~torch.any(torch.remainder(s, 2.0) > 0.5, dim=1)


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[W, n] hard bits (0/1 int8) -> [W, n//8] uint8, MSB first per byte
    (np.packbits convention), on the bits' device.  n must be a multiple
    of 8 (every DVB-T2 K_bch/N_bch is)."""
    w, n = bits.shape
    assert n % 8 == 0, n
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32,
                           device=bits.device)
    x = bits.reshape(w, n // 8, 8).to(torch.int32)
    return (x * weights).sum(dim=-1).to(torch.uint8)


def correct_host(cw_bits: np.ndarray, plp: PlpConfig):
    """Host-side BM/Chien correction; [n_bch] -> (k_bch bits, n_err)."""
    fixed, nerr = bch.decode(cw_bits, plp.bch_m, plp.bch_t)
    return fixed[:plp.k_bch], nerr
