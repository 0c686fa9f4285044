"""Soft demapper for the FEC chain.

demap_cells_planes turns already time/cell-deinterleaved cells (the
composed gather lives in ops/rx_chain) into int8-scaled LLR bit planes:

1. cyclic Q-delay removal (roll of the imaginary part within FEC blocks),
2. constellation derotation,
3. SNR estimate from hard-decision error power -> adaptive LLR scale
   ("precision"), like the reference (llr_demapper.cpp:178-192,241-281),
4. per-bit LLRs via the iterated |x|-fold (llr_demapper.cpp:296-352).

DemapPlan also builds the TI/cell-deinterleave and bit-deinterleave index
tables that rx_chain composes into its gathers.  On SFN plans the demap
weights each cell by its channel power (``csi``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import bit_interleaver, time_interleaver
from ..params.modes import PlpConfig


class DemapPlan:
    def __init__(self, plp: PlpConfig, n_fec: int, n_ti: int):
        self.plp = plp
        self.n_fec = n_fec
        n_cells = plp.cells_per_fec_block
        self.n_cells = n_cells
        per_ti, extra = divmod(n_fec, n_ti)
        gathers, base = [], 0
        for j in range(n_ti):
            f = per_ti + (1 if j >= n_ti - extra else 0)
            plan = time_interleaver.ti_block_plan(n_cells, f)
            gathers.append(base + plan["rx_gather"])
            base += f * n_cells
        self.ti_gather = np.concatenate(gathers, axis=0)   # [n_fec, n_cells]
        self.bit_gather = np.asarray(bit_interleaver.rx_gather(
            plp.constellation, plp.fec_frame, plp.code_rate))
        self.derot = complex(np.float32(np.cos(plp.rotation_angle)),
                             np.float32(-np.sin(plp.rotation_angle)))
        self.eta = plp.bits_per_cell
        self.norm = plp.norm_factor
        self.levels_max = (1 << (self.eta // 2)) - 1


@functools.lru_cache(maxsize=8)
def get_plan(plp: PlpConfig, n_fec: int, n_ti: int) -> DemapPlan:
    return DemapPlan(plp, n_fec, n_ti)


def _axis_llrs(v, per_axis, norm, precision):
    """LLRs of the bits carried by one axis value v: list of tensors."""
    out = []
    x = v
    t = (1 << (per_axis - 1)) * norm
    for _ in range(per_axis):
        out.append(torch.round(x * precision))
        x = torch.abs(x) - t
        t = t / 2
    return out


def demap_cells_planes(cells: torch.Tensor, n_frames: int, plan: DemapPlan,
                       csi: torch.Tensor | None = None):
    """Multi-frame demap: complex cells [W, n_cells] -> (list of eta int8
    [W, n_cells] bit planes in stream-stack order [i0, q0, i1, q1, ...],
    snr_db [F]).

    W = n_frames * n_fec codeword rows; SNR/precision is computed per frame
    over its row block (the reference adapts per frame too).

    ``csi`` (optional, [W, n_cells], mean-normalised |h|^2 per cell):
    per-cell LLR reliability for frequency-selective (SFN) channels, where
    a zero-forced cell at a channel null carries amplified noise.  The
    rotated constellation's Q delay puts a cell's I and Q on different
    carriers; after derotation each axis sees the variance mix
    c^2/csi_I + s^2/csi_Q, and takes the reciprocal of that mix as its
    weight (the max-log separable approximation of the 2-D demap).
    """
    w, n_cells = cells.shape
    # undo the cyclic Q delay (within each codeword = along the cell axis)
    cells = torch.complex(cells.real, torch.roll(cells.imag, -1, dims=1))
    cells = cells * plan.derot
    re, im = cells.real, cells.imag

    per_axis = plan.eta // 2
    step = 2 * plan.norm
    lim = plan.levels_max * plan.norm
    csi_x = csi_y = None
    if csi is not None:
        c2 = float(plan.derot.real) ** 2
        v_i = 1.0 / torch.clamp(csi.to(torch.float32), min=1e-5)
        v_q = torch.roll(v_i, -1, dims=1)       # the Q delay's roll
        csi_x = 1.0 / (c2 * v_i + (1.0 - c2) * v_q)
        csi_y = 1.0 / ((1.0 - c2) * v_i + c2 * v_q)
    # SNR / precision from a 1/8 stride sample of the cells: the estimate
    # still averages over >1M cells per frame at the flagship size
    sub_re, sub_im = re[:, ::8], im[:, ::8]
    hard_i = torch.clamp(torch.round((sub_re - plan.norm) / step) * step
                         + plan.norm, -lim, lim)
    hard_q = torch.clamp(torch.round((sub_im - plan.norm) / step) * step
                         + plan.norm, -lim, lim)
    err_i = (sub_re - hard_i) ** 2
    err_q = (sub_im - hard_q) ** 2
    if csi is not None:
        # reliability-weighted error: E[err * csi] = sigma^2 / mean|h|^2,
        # so the precision keeps the flat-channel scale and precision * csi
        # is each cell's matched scale
        err_i = err_i * csi_x[:, ::8]
        err_q = err_q * csi_y[:, ::8]
    err = err_i + err_q
    sig = hard_i ** 2 + hard_q ** 2
    sum_s = torch.sum(sig.reshape(n_frames, -1), dim=1)
    sum_e = torch.clamp(torch.sum(err.reshape(n_frames, -1), dim=1),
                        min=1e-12)
    snr_db = 10.0 * torch.log10(sum_s / sum_e)
    precision = torch.clamp(8.0 * plan.norm * sum_s / sum_e, 0.0, 512.0)
    prec_row = torch.repeat_interleave(precision, w // n_frames)[:, None]

    i_llrs = _axis_llrs(re, per_axis, plan.norm,
                        prec_row if csi is None else prec_row * csi_x)
    q_llrs = _axis_llrs(im, per_axis, plan.norm,
                        prec_row if csi is None else prec_row * csi_y)
    bits = []
    for a, b in zip(i_llrs, q_llrs):
        bits.append(torch.clamp(a, -127, 127).to(torch.int8))
        bits.append(torch.clamp(b, -127, 127).to(torch.int8))
    return bits, snr_db
