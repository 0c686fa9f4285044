"""Bit interleaver: parity interleave + column twist + bit-to-cell demux.

ETSI EN 302 755 clauses 6.3.1 (parity and column-twist interleaving) and
6.3.2 (demultiplexing of bits onto constellation cells).  We compute one
combined permutation per (constellation, FEC size, code rate):

    ``cell_bit_stream[i] = codeword[TX[i]]``

where ``codeword`` is the LDPC codeword in natural order (systematic bits
followed by staircase parity bits) and ``cell_bit_stream`` is the sequence of
constellation bits in transmission order (bits_per_cell consecutive bits form
one cell, MSB first).  The receiver uses the inverse as a single gather:

    ``llr_codeword[b] = llr_stream[RX[b]]``.

Column-twist parameters tc and demux orders are the ETSI table constants
(extracted); the same combined-LUT construction is used by the reference at
reference/src/DVB_T2/llr_demapper.cpp:96-116 (twist+demux only — its
parity de-interleave happens later, reference/src/DVB_T2/
ldpc_decoder.cpp:226-238; here we fold everything into one map).
"""
from __future__ import annotations

import functools
import numpy as np

from . import tables
from .modes import Constellation, CodeRate, FecFrame, FEC_SIZE_NORMAL


def _twist_demux_tables(constellation, fec_frame, code_rate):
    t = tables.carriers()
    normal = fec_frame == FecFrame.NORMAL
    if constellation == Constellation.QAM16:
        n_sub = 8
        tc = t["tc_qam16_normal"] if normal else t["tc_qam16_short"]
        if normal and code_rate == CodeRate.C3_5:
            demux = t["demux_16_fec_size_normal_code_3_5"]
        else:
            demux = t["demux_16"]
    elif constellation == Constellation.QAM64:
        n_sub = 12
        tc = t["tc_qam64_normal"] if normal else t["tc_qam64_short"]
        if normal and code_rate == CodeRate.C3_5:
            demux = t["demux_64_fec_size_normal_code_3_5"]
        else:
            demux = t["demux_64"]
    elif constellation == Constellation.QAM256:
        if normal:
            n_sub = 16
            tc = t["tc_qam256_normal"]
            if code_rate == CodeRate.C3_5:
                demux = t["demux_256_fec_size_normal_3_5"]
            elif code_rate == CodeRate.C2_3:
                demux = t["demux_256_fec_size_normal_2_3"]
            else:
                demux = t["demux_256_fec_size_normal"]
        else:
            n_sub = 8
            tc = t["tc_qam256_short"]
            demux = t["demux_256_fec_size_short"]
    else:
        raise ValueError(constellation)
    return n_sub, tc, demux


@functools.lru_cache(maxsize=None)
def parity_interleave_map(n_ldpc: int, k_ldpc: int) -> np.ndarray:
    """P with u[i] = c[P[i]]: u[K+360t+s] = c[K+q*s+t] (clause 6.3.1)."""
    r = n_ldpc - k_ldpc
    q = r // 360
    p = np.arange(n_ldpc, dtype=np.int64)
    t_idx = np.arange(r) // 360          # t of parity position K+360t+s
    s_idx = np.arange(r) % 360
    p[k_ldpc:] = k_ldpc + q * s_idx + t_idx
    return p


@functools.lru_cache(maxsize=None)
def tx_map(constellation: Constellation, fec_frame: FecFrame,
           code_rate: CodeRate) -> np.ndarray:
    """[N] int32: cell_bit_stream[i] = codeword[tx_map[i]]."""
    n_ldpc = FEC_SIZE_NORMAL if fec_frame == FecFrame.NORMAL else 16200
    from .modes import BCH_PARAMS
    k_ldpc = BCH_PARAMS[(fec_frame, code_rate)][0]
    pmap = parity_interleave_map(n_ldpc, k_ldpc)
    if constellation == Constellation.QPSK:
        return pmap.astype(np.int32)

    n_sub, tc, demux = _twist_demux_tables(constellation, fec_frame, code_rate)
    n_rows = n_ldpc // n_sub             # column length Nr (spec notation)
    # read-stream index i = row*Nsub + col reads u[col*Nr + (row - tc[col]) % Nr]
    rows = np.arange(n_ldpc) // n_sub
    cols = np.arange(n_ldpc) % n_sub
    read_of_u = cols * n_rows + (rows - tc[cols]) % n_rows
    # demux: bit n of each cell group takes read-stream slot demux[n]
    groups = np.arange(n_ldpc) // n_sub * n_sub
    n_in_group = np.arange(n_ldpc) % n_sub
    stream_of_read = groups + demux[n_in_group]
    combined = pmap[read_of_u[stream_of_read]]
    return combined.astype(np.int32)


@functools.lru_cache(maxsize=None)
def rx_gather(constellation: Constellation, fec_frame: FecFrame,
              code_rate: CodeRate) -> np.ndarray:
    """[N] int32: llr_codeword[b] = llr_stream[rx_gather[b]]."""
    tx = tx_map(constellation, fec_frame, code_rate)
    inv = np.empty_like(tx)
    inv[tx] = np.arange(len(tx), dtype=np.int32)
    return inv
