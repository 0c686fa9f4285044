"""Time interleaver + cell interleaver + cyclic-Q-delay index plans.

ETSI EN 302 755 clauses 6.3.3 (cyclic Q delay), 6.4 (cell interleaver) and
6.5 (time interleaver).  The transmit chain per TI block of ``n_fec`` FEC
blocks with ``n_cells`` cells each is:

1. cyclic Q delay: within each FEC block, the Q component is delayed by one
   cell cyclically;
2. cell interleaver: per-block pseudo-random permutation (cell_interleaver);
3. time interleaver: write the TI block column-wise into Nr x Nc memory
   (Nr = n_cells/5, Nc = 5*n_fec), read row-wise.

For the receiver we precompute a single gather index array undoing 2+3 in one
shot; the Q-delay removal is a roll of the imaginary part within each FEC
block (fused into the same stage on device).  The reference implements the
fused loop at reference/src/DVB_T2/time_deinterleaver.cpp:299-317.
"""
from __future__ import annotations

import functools
import numpy as np

from . import cell_interleaver

N_SPLIT = 5


@functools.lru_cache(maxsize=None)
def ti_block_plan(n_cells: int, n_fec: int) -> dict:
    """Index plans for one TI block of n_fec FEC blocks of n_cells cells.

    Returns dict with:
      tx_order:  [n_fec*n_cells] int32, tx_stream[t] = ci_cells[tx_order[t]]
                 where ci_cells is the cell-interleaved TI block flattened
                 (block-major) and tx_stream is what goes over the air.
      rx_gather: [n_fec, n_cells] int32, natural_cells[r, w] =
                 rx_stream[rx_gather[r, w]] undoing both interleavers.
    """
    assert n_cells % N_SPLIT == 0
    n_rows = n_cells // N_SPLIT
    n_cols = N_SPLIT * n_fec
    total = n_fec * n_cells

    # cell interleaver: ci[r, P[r, w]] = cells[r, w]
    perm = cell_interleaver.tx_permutations(n_cells, n_fec)
    # position in flattened ci stream of natural cell (r, w):
    ci_pos = perm + np.arange(n_fec)[:, None] * n_cells      # [n_fec, n_cells]

    # time interleaver: column-major write of the flat ci stream into
    # (n_rows x n_cols), row-major read.
    c = np.arange(total)
    row, col = c % n_rows, c // n_rows
    t_of_c = row * n_cols + col          # ci stream index c appears at time t
    tx_order_inv = t_of_c                # tx_stream[t_of_c[c]] = ci_flat[c]
    tx_order = np.empty(total, dtype=np.int64)
    tx_order[tx_order_inv] = c

    rx_gather = t_of_c[ci_pos]
    return dict(tx_order=tx_order.astype(np.int32),
                rx_gather=rx_gather.astype(np.int32))


def tx_interleave(cells: np.ndarray, n_fec: int) -> np.ndarray:
    """Forward TI: cells [n_fec, n_cells] complex -> tx stream [n_fec*n_cells].

    Applies cyclic Q delay, cell interleave and time interleave.
    """
    n_cells = cells.shape[1]
    # cyclic Q delay within each FEC block
    delayed = cells.real + 1j * np.roll(cells.imag, 1, axis=1)
    plan = ti_block_plan(n_cells, n_fec)
    perm = cell_interleaver.tx_permutations(n_cells, n_fec)
    ci = np.empty_like(delayed)
    np.put_along_axis(ci, perm, delayed, axis=1)
    flat = ci.reshape(-1)
    return flat[plan["tx_order"]]


def rx_deinterleave(stream: np.ndarray, n_cells: int, n_fec: int) -> np.ndarray:
    """Inverse TI: rx stream [n_fec*n_cells] -> cells [n_fec, n_cells]."""
    plan = ti_block_plan(n_cells, n_fec)
    deint = stream[plan["rx_gather"]]
    # undo cyclic Q delay: Q_w = deint_{(w+1) mod n_cells}.Q
    return deint.real + 1j * np.roll(deint.imag, -1, axis=1)
