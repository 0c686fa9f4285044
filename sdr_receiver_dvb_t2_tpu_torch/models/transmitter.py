"""DVB-T2 modulator (transmit fixture): TS bytes -> baseband IQ.

A complete EN 302 755 modulator used as the framework's closed-loop test
fixture and golden-vector generator (the reference receiver has no TX; its
pilot/address/LDPC tables mirror the TX spec, see SURVEY.md section 4).
Covers: BB framing/scrambling -> BCH -> LDPC -> bit interleaving -> (rotated)
QAM mapping -> cyclic Q delay + cell/time interleaving -> L1 generation/FEC
-> frame building with pilots + frequency interleaving -> OFDM IFFT + guard
insertion -> P1 preamble.

Pure NumPy: runs at test/fixture time; the receive path is the device side.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from ..io.bbframe import BBFramePacker
from ..params import (bch, bit_interleaver, freq_interleaver, l1, l1_fec,
                      ldpc, modes, p1, pilots, qam, time_interleaver)
from ..params.modes import (T2Mode, PlpConfig, Constellation, CodeRate,
                            FecFrame, FftMode, GuardInterval, Papr,
                            PilotPattern)


@dataclasses.dataclass
class TxConfig:
    mode: T2Mode
    plp: PlpConfig | None = None
    hem: bool = True
    issyi: bool = False           # carry ISSY timestamps (clause 5.1.8)
    npd: bool = False             # null-packet deletion with DNP counts
    l1_post_mod: int = 1          # QPSK
    fec_blocks_per_frame: int = 9  # PLP_NUM_BLOCKS per interleaving frame
    num_t2_frames: int = 2
    # Future Extension Frames (EN 302 755 clause 8.4): a FEF part of
    # fef_length elementary samples (starting with its own non-T2 P1)
    # follows every fef_interval-th T2 frame.  0 = no FEFs (pure T2).
    fef_interval: int = 0
    fef_length: int = 0
    fef_type: int = 0
    # L1 repetition (EN 302 755 clause 7.2.3.1): append the NEXT frame's
    # L1-dynamic block to every L1-post, giving receivers one frame of
    # time diversity on the dynamic signalling
    l1_repetition: bool = False
    # In-band type A signalling (EN 302 755 clause 5.2.3.1): the first BB
    # frame of each interleaving frame carries the NEXT frame's dynamic
    # schedule in its padding field, for every PLP
    in_band_a: bool = False
    # multi-PLP: parallel lists override (plp, fec_blocks_per_frame)
    plps: list = None
    fec_blocks: list = None

    def __post_init__(self):
        if self.plps is None:
            assert self.plp is not None
            self.plps = [self.plp]
            self.fec_blocks = [self.fec_blocks_per_frame]
        else:
            self.plp = self.plps[0]
            self.fec_blocks_per_frame = self.fec_blocks[0]
        for p, f in zip(self.plps, self.fec_blocks):
            assert f <= p.num_blocks_max * max(1, p.time_il_length)


class Transmitter:
    def __init__(self, cfg: TxConfig):
        self.cfg = cfg
        self.mode = cfg.mode.validate()
        self.plp = cfg.plp
        self.packer = BBFramePacker(k_bch=self.plp.k_bch, hem=cfg.hem,
                                    issyi=cfg.issyi, npd=cfg.npd)
        self.packers = [BBFramePacker(k_bch=p.k_bch, hem=cfg.hem,
                                      issyi=cfg.issyi, npd=cfg.npd)
                        for p in cfg.plps]
        self.code = ldpc.get_code(self.plp.ldpc_table_name)
        self._bch_m = self.plp.bch_m
        self._bch_t = self.plp.bch_t
        self._frame_idx = 0
        # ACE PAPR applies only to non-rotated, non-MISO configurations
        # (see _ace_reduce); with Papr.BOTH the TR half still applies
        self._ace_ok = (not self.mode.miso
                        and all(not p.rotation for p in cfg.plps))
        if self.mode.papr == Papr.ACE and not self._ace_ok:
            raise ValueError(
                "PAPR=ACE is invalid with rotated constellations or MISO "
                "(EN 302 755 clause 9.3.1); use TR or disable rotation")
        self._build_l1()
        if cfg.in_band_a:
            self._arm_inband_hooks()

    def _arm_inband_hooks(self):
        """In-band type A (EN 302 755 clause 5.2.3.1): every PLP's first BB
        frame per interleaving frame carries the next frame's schedule in
        its padding field.  The fixture's schedule is static, so the block
        is built once per PLP; the hook fires on every n_fec-th BB frame."""
        from ..io import inband
        dyn = self.l1_post.dyn
        for i, (packer, n_fec) in enumerate(zip(self.packers,
                                                self.cfg.fec_blocks)):
            blk = inband.InBandA(
                sub_slice_interval=dyn.sub_slice_interval,
                current_plp_start=dyn.plp[i].start,
                current_plp_num_blocks=dyn.plp[i].num_blocks,
                other=[inband.InBandOtherPlp(
                    plp_id=dyn.plp[j].id, plp_start=dyn.plp[j].start,
                    plp_num_blocks=dyn.plp[j].num_blocks)
                    for j in range(len(dyn.plp)) if j != i])
            bits = inband.build_inband_a(blk)
            packer.padding_hook = (
                lambda k, b=bits, n=n_fec: b if k % n == 0 else None)

    # ------------------------------------------------------------------
    def _build_l1(self):
        mode, plp, cfg = self.mode, self.plp, self.cfg
        s2_map = {1024: 3, 2048: 0, 4096: 2, 8192: 1, 16384: 4, 32768: 5}
        for pc in cfg.plps:
            if pc.code_rate in (CodeRate.C1_3, CodeRate.C2_5):
                assert mode.lite and pc.fec_frame == FecFrame.SHORT, (
                    "rates 1/3 and 2/5 are T2-Lite SHORT-frame only "
                    "(EN 302 755 annex I)")
        # P1 S1 preamble format: 0/1 = T2 SISO/MISO, 3/4 = T2-Lite
        pre = l1.L1Pre(
            s1=(3 if mode.lite else 0) + (1 if mode.miso else 0),
            s2_field1=s2_map[mode.fft_size],
            s2_field2=0,
            guard_interval=mode.guard.value,
            papr=mode.papr.value,
            l1_post_mod=cfg.l1_post_mod,
            pilot_pattern=mode.pilot_pattern.value,
            bwt_ext=int(mode.extended_carriers),
            num_data_symbols=mode.n_data_symbols,
            num_t2_frames=cfg.num_t2_frames,
            l1_repetition_flag=int(cfg.l1_repetition),
        )
        if cfg.fef_interval:
            assert cfg.fef_length >= p1.P1_LEN, cfg.fef_length
            pre.s2_field2 = 1            # "mixed" — FEF parts present
        post = l1.L1Post()
        if cfg.fef_interval:
            post.fef_type = cfg.fef_type
            post.fef_interval = cfg.fef_interval
            post.fef_length = cfg.fef_length & ((1 << 22) - 1)
            post.fef_length_msb = cfg.fef_length >> 22
        post.num_plp = len(cfg.plps)
        post.plp = [l1.L1PostPlp() for _ in cfg.plps]
        post.dyn.plp = []
        start = 0
        for i, (pc, n_fec) in enumerate(zip(cfg.plps, cfg.fec_blocks)):
            p = post.plp[i]
            p.id = pc.plp_id if pc.plp_id or i == 0 else i
            p.plp_cod = pc.code_rate.value
            p.plp_mod = pc.constellation.value
            p.plp_rotation = int(pc.rotation)
            p.plp_fec_type = pc.fec_frame.value
            p.plp_num_blocks_max = pc.num_blocks_max
            p.time_il_length = pc.time_il_length
            p.time_il_type = pc.time_il_type
            p.plp_mode = 2 if cfg.hem else 1
            p.in_band_a_flag = int(cfg.in_band_a)
            post.dyn.plp.append(l1.L1DynPlp(id=p.id, start=start,
                                            num_blocks=n_fec))
            start += n_fec * pc.cells_per_fec_block
        if cfg.l1_repetition:
            import copy
            post.dyn_next = copy.deepcopy(post.dyn)
        # size the L1-post: build once with zero sizes to learn K_sig
        tmp = l1.build_l1_post_info(post, pre)
        k_sig = len(tmp)
        n_post, _ = l1_fec.l1_post_sizes(k_sig, cfg.l1_post_mod, mode.n_p2)
        pre.l1_post_info_size = k_sig - 32
        pre.l1_post_size = n_post // l1_fec.ETA_L1[cfg.l1_post_mod]
        self.l1_pre, self.l1_post = pre, post

    # ------------------------------------------------------------------
    def fec_encode(self, bb_frames: list[np.ndarray],
                   plp: PlpConfig | None = None) -> np.ndarray:
        """BB frames (scrambled K_bch bits each) -> LDPC codewords [n, N]."""
        plp = plp or self.plp
        code = ldpc.get_code(plp.ldpc_table_name)
        out = np.empty((len(bb_frames), plp.fec_size), dtype=np.uint8)
        for i, frame in enumerate(bb_frames):
            bch_cw = bch.encode(frame, plp.bch_m, plp.bch_t)
            assert len(bch_cw) == plp.k_ldpc
            out[i] = code.encode(bch_cw)
        return out

    def map_cells(self, codewords: np.ndarray,
                  plp: PlpConfig | None = None) -> np.ndarray:
        """LDPC codewords [n, N] -> rotated cells [n, cells_per_fec]."""
        plp = plp or self.plp
        tx = bit_interleaver.tx_map(plp.constellation, plp.fec_frame,
                                    plp.code_rate)
        stream = codewords[:, tx]
        return qam.map_bits(stream, plp.constellation, rotated=plp.rotation)

    def interleave_frame_cells(self, cells: np.ndarray,
                               plp: PlpConfig | None = None) -> np.ndarray:
        """[n_fec, cells] -> PLP cell sequence for one T2 frame (TI applied)."""
        plp, n_fec = plp or self.plp, len(cells)
        n_ti = max(1, plp.time_il_length if plp.time_il_type == 0 else 1)
        per_ti = n_fec // n_ti
        extra = n_fec % n_ti
        blocks, start = [], 0
        for j in range(n_ti):
            f = per_ti + (1 if j >= n_ti - extra else 0)
            blk = cells[start:start + f]
            start += f
            blocks.append(time_interleaver.tx_interleave(blk, f))
        return np.concatenate(blocks)

    # ------------------------------------------------------------------
    def l1_cells(self) -> np.ndarray:
        """L1-pre + L1-post cells for the current frame."""
        pre_bits = l1.build_l1_pre(self.l1_pre)
        coded_pre = l1_fec.encode_l1_pre(pre_bits)
        pre_cells = (1.0 - 2.0 * coded_pre.astype(np.float32)).astype(np.complex64)

        self.l1_post.dyn.frame_idx = self._frame_idx % self.cfg.num_t2_frames
        if self.l1_pre.l1_repetition_flag:
            import copy
            nxt = copy.deepcopy(self.l1_post.dyn)
            nxt.frame_idx = (self._frame_idx + 1) % self.cfg.num_t2_frames
            self.l1_post.dyn_next = nxt
        post_bits = l1.build_l1_post_info(self.l1_post, self.l1_pre)
        coded_post = l1_fec.encode_l1_post(post_bits, self.cfg.l1_post_mod,
                                           self.mode.n_p2)
        mod = self.cfg.l1_post_mod
        if mod == 0:
            post_cells = (1.0 - 2.0 * coded_post.astype(np.float32)).astype(np.complex64)
        else:
            const = {1: Constellation.QPSK, 2: Constellation.QAM16,
                     3: Constellation.QAM64}[mod]
            post_cells = qam.map_bits(coded_post, const, rotated=False)
        return np.concatenate([pre_cells, post_cells])

    @staticmethod
    def _miso_pair_encode(cells: np.ndarray) -> np.ndarray:
        """Alamouti encoding of transmit group 2 (EN 302 755 clause 6.4):
        carrier-order payload pairs (c1, c2) -> (-c2*, c1*); group 1
        transmits the cells unmodified."""
        out = np.empty_like(cells)
        out[0::2] = -np.conj(cells[1::2])
        out[1::2] = np.conj(cells[0::2])
        return out

    def build_frame(self, plp_cells: np.ndarray, rng=None):
        """Assemble one T2 frame of OFDM symbols -> time-domain samples.

        plp_cells: interleaved PLP cell sequence (starts at dyn start 0).
        MISO modes return (tx_group1, tx_group2) sample arrays; the P1
        preamble is transmitted identically from both groups.
        """
        mode = self.mode
        miso = mode.miso
        rng = rng or np.random.default_rng(self._frame_idx)
        l1c = self.l1_cells()
        total = mode.frame_cells
        payload = np.zeros(total, dtype=np.complex64)
        payload[:len(l1c)] = l1c
        end = len(l1c) + len(plp_cells)
        assert end <= total, (end, total)
        payload[len(l1c):end] = plp_cells
        # dummy cells: scrambled pseudo-random QPSK (clause 8.3.6.2 analogue)
        n_dummy = total - end
        if n_dummy:
            payload[end:] = ((1 - 2 * rng.integers(0, 2, n_dummy))
                             + 1j * (1 - 2 * rng.integers(0, 2, n_dummy))
                             ).astype(np.complex64) / np.sqrt(2)

        # slice payload into per-symbol cell groups
        sym_samples = []
        sym_samples2 = []
        pos = 0
        ref = pilots.reference_frame(mode)
        for sym in range(mode.frame_symbols):
            if sym < mode.n_p2:
                n_cells = mode.c_p2
                cells = payload[pos:pos + n_cells]
                pos += n_cells
            elif mode.has_fc and sym == mode.frame_symbols - 1:
                # FC symbol maps N_FC cells of which only C_FC are payload;
                # the rest are bias-balancing cells (zeros here)
                n_cells = mode.n_fc
                cells = np.zeros(n_cells, dtype=np.complex64)
                cells[:mode.c_fc] = payload[pos:pos + mode.c_fc]
                pos += mode.c_fc
            else:
                n_cells = mode.c_data
                cells = payload[pos:pos + n_cells]
                pos += n_cells
            h = freq_interleaver.tx_permutation(mode, n_cells, sym)
            interleaved = np.zeros(n_cells, dtype=np.complex64)
            interleaved[h] = cells
            didx = pilots.data_cell_indices(mode, sym)
            carriers = ref[sym].astype(np.complex64)
            carriers[didx] = interleaved
            if (mode.papr in (Papr.ACE, Papr.BOTH) and self._ace_ok
                    and sym >= mode.n_p2
                    and not (mode.has_fc
                             and sym == mode.frame_symbols - 1)):
                carriers = self._ace_reduce(carriers, didx)
            if mode.papr in (Papr.TR, Papr.BOTH):
                carriers = self._tr_reduce(carriers, sym)
            sym_samples.append(self._ofdm_symbol(carriers))
            if miso:
                carriers2 = pilots.reference_symbol_tx(mode, sym, 2
                                                       ).astype(np.complex64)
                carriers2[didx] = self._miso_pair_encode(interleaved)
                if mode.papr in (Papr.TR, Papr.BOTH):
                    carriers2 = self._tr_reduce(carriers2, sym)
                sym_samples2.append(self._ofdm_symbol(carriers2))
        assert pos == total
        self._frame_idx += 1
        head = p1.generate(self.l1_pre.s1,
                           self.l1_pre.s2_field1 * 2 + self.l1_pre.s2_field2)
        tx1 = np.concatenate([head] + sym_samples)
        if not miso:
            return tx1
        return tx1, np.concatenate([head] + sym_samples2)

    def build_fef_part(self, rng=None) -> np.ndarray:
        """One Future Extension Frame part (EN 302 755 clause 8.4): its own
        P1 with a non-T2 S1 (the receiver must recognise and skip it;
        fef_type selects the payload format, opaque to a T2 receiver)
        followed by filler to fef_length elementary samples.  Filler is
        noise-like QPSK at OFDM-comparable power so AGC/tracking loops see
        realistic energy, not silence."""
        cfg = self.cfg
        rng = rng or np.random.default_rng(0x4EF ^ self._frame_idx)
        head = p1.generate(2, cfg.fef_type & 0xF)     # S1=010: non-T2
        n_fill = cfg.fef_length - len(head)
        fill = ((rng.standard_normal(n_fill) + 1j * rng.standard_normal(
            n_fill)) * np.sqrt(0.5)).astype(np.complex64)
        return np.concatenate([head, fill])

    def _carrier_bins(self) -> np.ndarray:
        mode = self.mode
        return np.mod(mode.left_nulls + np.arange(mode.k_total)
                      - mode.fft_size // 2, mode.fft_size)

    def _tr_reduce(self, carriers: np.ndarray, sym: int,
                   v_clip: float = 2.2, iters: int = 12) -> np.ndarray:
        """Tone-reservation PAPR reduction (EN 302 755 clause 9.3.2).

        Iterative peak cancellation: the kernel is the IFFT of a unit
        spectrum on the symbol's reserved carriers (a near-impulse, so a
        circular shift of it cancels one time-domain peak while touching
        ONLY reserved tones); each iteration shaves the largest residual
        peak down to ``v_clip`` times the RMS.  The accumulated
        correction is read back off the reserved bins and clipped to the
        spec's amplitude limit of 5.  The reference transmits nothing (it
        is a receiver); gr-dvbt2 implements the same clause at TX."""
        mode = self.mode
        tr = pilots.tr_cell_indices(mode, sym)
        if len(tr) == 0:
            return carriers
        N = mode.fft_size
        bins = self._carrier_bins()
        spec = np.zeros(N, dtype=np.complex128)
        spec[bins] = carriers
        kern_spec = np.zeros(N, dtype=np.complex128)
        kern_spec[bins[tr]] = 1.0
        kern = np.fft.ifft(kern_spec) * (N / len(tr))      # kern[0] = 1
        x = np.fft.ifft(spec)
        clip = v_clip * np.sqrt(np.mean(np.abs(x) ** 2))
        c = np.zeros(N, dtype=np.complex128)
        for _ in range(iters):
            y = x + c
            m = int(np.argmax(np.abs(y)))
            pk = y[m]
            if abs(pk) <= clip:
                break
            c -= (pk * (1.0 - clip / abs(pk))) * np.roll(kern, m)
        c_tr = np.fft.fft(c)[bins[tr]]
        mag = np.abs(c_tr)
        c_tr = np.where(mag > 5.0, c_tr * (5.0 / np.maximum(mag, 1e-12)),
                        c_tr)
        out = carriers.copy()
        out[tr] = c_tr.astype(np.complex64)
        return out

    def _ace_reduce(self, carriers: np.ndarray, didx: np.ndarray,
                    v_clip: float = 2.4, gain: float = 2.0,
                    ext_max: float = 0.6, iters: int = 3) -> np.ndarray:
        """Active constellation extension (EN 302 755 clause 9.3.1).

        Clip the time-domain symbol, take the clipping noise back to the
        carrier domain, and keep only the components that push OUTER
        constellation points further OUTWARD on each axis (inner points
        and inward pushes would cross decision boundaries and are
        dropped), scaled by ``gain`` and capped at ``ext_max`` of the
        outer amplitude.  Receivers need no cooperation: outward
        extension only increases demap margin.  Not applied to rotated
        constellations (the spec forbids it: the Q component rides a
        different carrier, so a per-carrier extension would corrupt the
        paired axis) nor to MISO (an independent per-transmitter
        extension breaks the exact Alamouti pair structure)."""
        N = self.mode.fft_size
        bins = self._carrier_bins()
        base = carriers[didx].copy()
        amax_r = float(np.max(np.abs(base.real)))
        amax_i = float(np.max(np.abs(base.imag)))
        outer_r = np.abs(base.real) >= 0.98 * amax_r
        outer_i = np.abs(base.imag) >= 0.98 * amax_i
        lo_r = np.where(base.real > 0, 0.0, -ext_max * amax_r)
        hi_r = np.where(base.real > 0, ext_max * amax_r, 0.0)
        lo_i = np.where(base.imag > 0, 0.0, -ext_max * amax_i)
        hi_i = np.where(base.imag > 0, ext_max * amax_i, 0.0)
        out = carriers.copy()
        spec = np.zeros(N, dtype=np.complex128)
        for _ in range(iters):
            spec[:] = 0.0
            spec[bins] = out
            x = np.fft.ifft(spec)
            mag = np.abs(x)
            clip = v_clip * np.sqrt(np.mean(mag ** 2))
            if mag.max() <= clip:
                break
            xc = np.where(mag > clip, x * (clip / np.maximum(mag, 1e-12)),
                          x)
            e = np.fft.fft(xc - x)[bins[didx]]
            er = np.where(outer_r & (np.sign(e.real) == np.sign(base.real)),
                          e.real * gain, 0.0)
            ei = np.where(outer_i & (np.sign(e.imag) == np.sign(base.imag)),
                          e.imag * gain, 0.0)
            cur = out[didx]
            ext_r = np.clip(cur.real + er - base.real, lo_r, hi_r)
            ext_i = np.clip(cur.imag + ei - base.imag, lo_i, hi_i)
            out[didx] = ((base.real + ext_r)
                         + 1j * (base.imag + ext_i)).astype(np.complex64)
        return out

    def _ofdm_symbol(self, carriers: np.ndarray) -> np.ndarray:
        mode = self.mode
        spec = np.zeros(mode.fft_size, dtype=np.complex64)
        spec[self._carrier_bins()] = carriers
        x = np.fft.ifft(spec).astype(np.complex64)
        x *= mode.fft_size / np.sqrt(mode.k_total)
        return np.concatenate([x[-mode.guard_size:], x])

    # ------------------------------------------------------------------
    def modulate(self, ts_bytes: np.ndarray) -> np.ndarray:
        """TS stream -> IQ for as many complete T2 frames as data allows."""
        return self.modulate_multi([ts_bytes] * len(self.cfg.plps))

    def modulate_multi(self, ts_streams: list):
        """One TS stream per PLP -> IQ frames (multi-PLP frame building).

        MISO modes return a (tx_group1, tx_group2) pair of IQ arrays."""
        cfg = self.cfg
        miso = self.mode.miso
        bb_per_plp = [packer.pack(ts) for packer, ts in
                      zip(self.packers, ts_streams)]
        n_frames = min(len(bb) // f for bb, f in
                       zip(bb_per_plp, cfg.fec_blocks))
        frames_iq = []
        frames_iq2 = []
        for f in range(n_frames):
            parts = []
            for plp, n_fec, bb in zip(cfg.plps, cfg.fec_blocks, bb_per_plp):
                cw = self.fec_encode(bb[f * n_fec:(f + 1) * n_fec], plp)
                cells = self.map_cells(cw, plp)
                parts.append(self.interleave_frame_cells(cells, plp))
            fr = self.build_frame(np.concatenate(parts))
            if miso:
                frames_iq.append(fr[0])
                frames_iq2.append(fr[1])
            else:
                frames_iq.append(fr)
            # a FEF part follows every fef_interval-th T2 frame
            # (build_frame already advanced _frame_idx past this frame)
            if cfg.fef_interval and self._frame_idx % cfg.fef_interval == 0:
                fef = self.build_fef_part()
                frames_iq.append(fef)
                frames_iq2.append(fef)
        if not frames_iq:
            empty = np.empty(0, np.complex64)
            return (empty, empty) if miso else empty
        if miso:
            return np.concatenate(frames_iq), np.concatenate(frames_iq2)
        return np.concatenate(frames_iq)


def random_ts_stream(n_packets: int, seed: int = 0) -> np.ndarray:
    """Synthetic TS packets: sync byte + PID header-ish + random payload."""
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, size=(n_packets, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    cc = np.arange(n_packets) % 16
    pkts[:, 1] = 0x00
    pkts[:, 2] = 0x64
    pkts[:, 3] = (0x10 | cc).astype(np.uint8)
    return pkts.reshape(-1)
