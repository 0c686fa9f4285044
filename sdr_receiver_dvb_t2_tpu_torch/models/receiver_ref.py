"""NumPy reference receiver (oracle).

A bit-exact, host-only model of the receive chain used to validate both the
transmit fixture and the device pipeline stage by stage.  Assumes an ideal
channel and known frame alignment (impairment handling lives in the device
pipeline); still exercises every standard-defined inverse: OFDM demod,
pilot-referenced equalization, frequency/time/cell/bit deinterleaving,
rotated-QAM demapping, LDPC/BCH decoding and BB de-encapsulation.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from ..io.bbframe import BBFrameParser
from ..params import (bch, bit_interleaver, freq_interleaver, l1, l1_fec,
                      ldpc, pilots, prbs, qam, time_interleaver)
from ..params.modes import (T2Mode, PlpConfig, Constellation, FecFrame,
                            CodeRate, FEC_SIZE_NORMAL)
from ..params import p1 as p1_mod


@dataclasses.dataclass
class RxFrameResult:
    l1_pre: l1.L1Pre
    l1_post: l1.L1Post
    ts_bytes: np.ndarray
    ldpc_ok: np.ndarray          # [n_fec] bool: parity satisfied pre-BCH
    bch_errors: np.ndarray       # [n_fec] corrected error counts (-1 = fail)


class ReferenceReceiver:
    """Demodulates frames produced by :class:`..models.transmitter.Transmitter`."""

    def __init__(self, mode: T2Mode):
        self.mode = mode.validate()
        self.bb = BBFrameParser()

    # -- OFDM demod ---------------------------------------------------------
    def demod_symbols(self, frame_iq: np.ndarray) -> np.ndarray:
        """Frame IQ (incl. P1) -> [L_F, k_total] active-carrier cells."""
        mode = self.mode
        pos = p1_mod.P1_LEN
        out = np.empty((mode.frame_symbols, mode.k_total), dtype=np.complex64)
        for sym in range(mode.frame_symbols):
            s = frame_iq[pos:pos + mode.symbol_size]
            pos += mode.symbol_size
            spec = np.fft.fft(s[mode.guard_size:]) / (
                mode.fft_size / np.sqrt(mode.k_total))
            spec = np.fft.fftshift(spec)
            out[sym] = spec[mode.left_nulls:mode.left_nulls + mode.k_total]
        return out

    def equalize_deinterleave(self, carriers: np.ndarray) -> np.ndarray:
        """[L_F, k_total] -> concatenated payload cell sequence.

        Ideal-channel version: divides by the known pilot reference only to
        keep the data path identical; channel estimation proper lives in
        ops/equalizer.py.
        """
        mode = self.mode
        payload = []
        for sym in range(mode.frame_symbols):
            didx = pilots.data_cell_indices(mode, sym)
            data = carriers[sym][didx]
            if mode.miso:
                # ideal-channel Alamouti combine (h1 = h2 = 1): the frame
                # is the clean sum of both transmit groups
                a, b = data[0::2], data[1::2]
                data = np.empty_like(data)
                data[0::2] = 0.5 * (a + np.conj(b))
                data[1::2] = 0.5 * (b - np.conj(a))
            n_cells = len(data)
            h = freq_interleaver.tx_permutation(mode, n_cells, sym)
            cells = data[h]
            if mode.has_fc and sym == mode.frame_symbols - 1:
                cells = cells[:mode.c_fc]
            payload.append(cells)
        return np.concatenate(payload)

    # -- L1 -----------------------------------------------------------------
    def decode_l1(self, payload: np.ndarray):
        pre_bits = (payload[:l1.L1_PRE_CELLS].real < 0).astype(np.uint8)
        pre = l1.parse_l1_pre(l1_fec.decode_l1_pre_systematic(pre_bits))
        if pre is None:
            return None, None, 0
        mod = pre.l1_post_mod
        eta = l1_fec.ETA_L1[mod]
        cells = payload[l1.L1_PRE_CELLS:l1.L1_PRE_CELLS + pre.l1_post_size]
        if mod == 0:
            stream = (cells.real < 0).astype(np.uint8)
        else:
            const = {1: Constellation.QPSK, 2: Constellation.QAM16,
                     3: Constellation.QAM64}[mod]
            stream = qam.hard_bits(cells, const)
        coded = l1_fec.undo_l1_post_interleave(stream, mod)
        k_sig = pre.l1_post_info_size + 32
        info = coded[:k_sig]
        if pre.l1_post_scrambled:
            info = info ^ prbs.l1_scrambler(k_sig)
        post = l1.parse_l1_post_info(info, pre)
        return pre, post, l1.L1_PRE_CELLS + pre.l1_post_size

    # -- PLP payload --------------------------------------------------------
    def plp_cells_to_codeword_llr_bits(self, plp_cells: np.ndarray,
                                       plp: PlpConfig, n_fec: int,
                                       n_ti: int) -> np.ndarray:
        """PLP cell sequence -> hard bits [n_fec, N] in codeword order."""
        n_cells = plp.cells_per_fec_block
        per_ti = n_fec // n_ti
        extra = n_fec % n_ti
        pos, blocks = 0, []
        for j in range(n_ti):
            f = per_ti + (1 if j >= n_ti - extra else 0)
            stream = plp_cells[pos:pos + f * n_cells]
            pos += f * n_cells
            blocks.append(time_interleaver.rx_deinterleave(stream, n_cells, f))
        cells = np.concatenate(blocks, axis=0)
        if plp.rotation:
            cells = cells * np.exp(-1j * plp.rotation_angle)
        stream_bits = qam.hard_bits(cells, plp.constellation)
        rx = bit_interleaver.rx_gather(plp.constellation, plp.fec_frame,
                                       plp.code_rate)
        return stream_bits[:, rx]

    # -- FEC ----------------------------------------------------------------
    def fec_decode(self, cw_bits: np.ndarray, plp: PlpConfig):
        code = ldpc.get_code(plp.ldpc_table_name)
        m, t = plp.bch_m, plp.bch_t
        n_fec = len(cw_bits)
        ldpc_ok = np.zeros(n_fec, dtype=bool)
        bch_err = np.zeros(n_fec, dtype=np.int64)
        bb_frames = []
        for i in range(n_fec):
            ldpc_ok[i] = code.check(cw_bits[i])
            fixed, nerr = bch.decode(cw_bits[i, :plp.k_ldpc], m, t)
            bch_err[i] = nerr
            bb_frames.append(fixed[:plp.k_bch])
        return bb_frames, ldpc_ok, bch_err

    # -- full frame ---------------------------------------------------------
    def receive_frame(self, frame_iq: np.ndarray, plp: PlpConfig
                      ) -> RxFrameResult | None:
        carriers = self.demod_symbols(frame_iq)
        payload = self.equalize_deinterleave(carriers)
        pre, post, plp_start = self.decode_l1(payload)
        if pre is None or post is None:
            return None
        n_fec = post.dyn.plp[0].num_blocks
        n_ti = max(1, post.plp[0].time_il_length if post.plp[0].time_il_type == 0 else 1)
        plp_cells = payload[plp_start:plp_start + n_fec * plp.cells_per_fec_block]
        cw_bits = self.plp_cells_to_codeword_llr_bits(plp_cells, plp, n_fec, n_ti)
        bb_frames, ldpc_ok, bch_err = self.fec_decode(cw_bits, plp)
        ts = [self.bb.parse(f) for f in bb_frames]
        ts_bytes = np.concatenate([t for t in ts if len(t)]) if ts else np.empty(0, np.uint8)
        return RxFrameResult(pre, post, ts_bytes, ldpc_ok, bch_err)
