"""DVB-T2 mode parameters (ETSI EN 302 755 clauses 8-10).

This is the receiver's equivalent of the reference's mode tables
(reference/src/DVB_T2/dvbt2_definition.{h,cpp}): enumerations for every
T2 transmission mode plus the derived per-mode constants (carrier counts,
P2/data cell capacities, guard sizes).  All values are standard constants
(EN 302 755 tables 42-48); the representation here is data-driven dicts and a
frozen dataclass instead of switch statements.

Everything is plain Python/NumPy, evaluated at configuration time.
"""
from __future__ import annotations

import dataclasses
import enum
from fractions import Fraction


# -- elementary timing -------------------------------------------------------
# 8 MHz profile: elementary period T = 7/64 us  (EN 302 755 table 65)
T_PERIOD = 7.0 / 64.0e6
SAMPLE_RATE = 1.0 / T_PERIOD          # = 64/7 MHz ~ 9.142857 Msps

FEC_SIZE_NORMAL = 64800
FEC_SIZE_SHORT = 16200
L1_PRE_CELL = 1840                    # L1-pre always occupies 1840 P2 cells
CHIPS = 2624                          # frame-level PN sequence length
TS_PACKET_LEN = 188


class FftMode(enum.IntEnum):
    """S2 field-1 encoding of FFT sizes (EN 302 755 table 16)."""
    FFT_2K = 0
    FFT_8K = 1
    FFT_4K = 2
    FFT_1K = 3
    FFT_16K = 4
    FFT_32K = 5
    FFT_8K_T2GI = 6
    FFT_32K_T2GI = 7
    FFT_16K_T2GI = 11


class GuardInterval(enum.IntEnum):
    G1_32 = 0
    G1_16 = 1
    G1_8 = 2
    G1_4 = 3
    G1_128 = 4
    G19_128 = 5
    G19_256 = 6


class PilotPattern(enum.IntEnum):
    PP1 = 0
    PP2 = 1
    PP3 = 2
    PP4 = 3
    PP5 = 4
    PP6 = 5
    PP7 = 6
    PP8 = 7


class Constellation(enum.IntEnum):
    QPSK = 0
    QAM16 = 1
    QAM64 = 2
    QAM256 = 3


class CodeRate(enum.IntEnum):
    C1_2 = 0
    C3_5 = 1
    C2_3 = 2
    C3_4 = 3
    C4_5 = 4
    C5_6 = 5
    # T2-Lite-only rates (EN 302 755 annex I): SHORT frames only; the
    # values are the L1 PLP_COD codepoints 110/111, which base T2 keeps
    # reserved (4/5 and 5/6 are in turn not allowed in T2-Lite)
    C1_3 = 6
    C2_5 = 7


class FecFrame(enum.IntEnum):
    SHORT = 0
    NORMAL = 1


class Preamble(enum.IntEnum):
    T2_SISO = 0
    T2_MISO = 1
    NON_T2 = 2
    T2_LITE_SISO = 3
    T2_LITE_MISO = 4


class Papr(enum.IntEnum):
    OFF = 0
    ACE = 1
    TR = 2
    BOTH = 3


GUARD_FRACTION = {
    GuardInterval.G1_32: Fraction(1, 32),
    GuardInterval.G1_16: Fraction(1, 16),
    GuardInterval.G1_8: Fraction(1, 8),
    GuardInterval.G1_4: Fraction(1, 4),
    GuardInterval.G1_128: Fraction(1, 128),
    GuardInterval.G19_128: Fraction(19, 128),
    GuardInterval.G19_256: Fraction(19, 256),
}

# canonical FFT size per mode (T2GI variants share the size)
FFT_SIZE = {
    FftMode.FFT_1K: 1024, FftMode.FFT_2K: 2048, FftMode.FFT_4K: 4096,
    FftMode.FFT_8K: 8192, FftMode.FFT_8K_T2GI: 8192,
    FftMode.FFT_16K: 16384, FftMode.FFT_16K_T2GI: 16384,
    FftMode.FFT_32K: 32768, FftMode.FFT_32K_T2GI: 32768,
}

# number of P2 symbols per frame (EN 302 755 table 58)
N_P2 = {1024: 16, 2048: 8, 4096: 4, 8192: 2, 16384: 1, 32768: 1}

# data cells per P2 symbol, SISO / MISO  (EN 302 755 table 42)
C_P2_SISO = {1024: 558, 2048: 1118, 4096: 2236, 8192: 4472, 16384: 8944, 32768: 22432}
C_P2_MISO = {1024: 546, 2048: 1098, 4096: 2198, 8192: 4398, 16384: 8814, 32768: 17612}

# pilot patterns allowed in MISO per FFT size (EN 302 755 table 58 —
# MISO needs denser scattered pilots than SISO because two channels are
# estimated from alternating-polarity pilots; matches exactly the combos
# whose continual pilots carry the MISO inversion branch in the reference
# generator, pilot_generator.cpp cp_mappinng)
MISO_PILOT_PATTERNS = {
    1024: {PilotPattern.PP1, PilotPattern.PP3},
    2048: {PilotPattern.PP1, PilotPattern.PP3, PilotPattern.PP4,
           PilotPattern.PP5},
    4096: {PilotPattern.PP1, PilotPattern.PP3, PilotPattern.PP4,
           PilotPattern.PP5},
    8192: {PilotPattern.PP1, PilotPattern.PP3, PilotPattern.PP4,
           PilotPattern.PP5, PilotPattern.PP8},
    16384: {PilotPattern.PP1, PilotPattern.PP3, PilotPattern.PP4,
            PilotPattern.PP5, PilotPattern.PP8},
    32768: {PilotPattern.PP2, PilotPattern.PP4, PilotPattern.PP6,
            PilotPattern.PP8},
}

# total carriers K_total, extension carriers K_ext per side, and offset of the
# normal-mode spectrum inside extended numbering (EN 302 755 table 57)
# fft_size -> (normal K_total, extended K_total, K_ext)
K_TOTAL = {
    1024: (853, 853, 0),
    2048: (1705, 1705, 0),
    4096: (3409, 3409, 0),
    8192: (6817, 6913, 48),
    16384: (13633, 13921, 144),
    32768: (27265, 27841, 288),
}

# data cells per regular data symbol C_data, and the frame-closing symbol's
# N_FC (cells incl. bias-balancing) and C_FC (useful cells)
# (EN 302 755 tables 43-48); key: (fft_size, extended, pilot_pattern)
# value: (c_data, n_fc, c_fc); zeros = combination not allowed.
_CDATA = {
    # 1K (normal only)
    (1024, False): {
        PilotPattern.PP1: (764, 568, 402), PilotPattern.PP2: (768, 710, 654),
        PilotPattern.PP3: (798, 710, 490), PilotPattern.PP4: (804, 780, 707),
        PilotPattern.PP5: (818, 780, 544), PilotPattern.PP6: (0, 0, 0),
        PilotPattern.PP7: (0, 0, 0), PilotPattern.PP8: (0, 0, 0),
    },
    (2048, False): {
        PilotPattern.PP1: (1522, 1136, 804), PilotPattern.PP2: (1532, 1420, 1309),
        PilotPattern.PP3: (1596, 1420, 980), PilotPattern.PP4: (1602, 1562, 1415),
        PilotPattern.PP5: (1632, 1562, 1088), PilotPattern.PP6: (0, 0, 0),
        PilotPattern.PP7: (1646, 1632, 1396), PilotPattern.PP8: (0, 0, 0),
    },
    (4096, False): {
        PilotPattern.PP1: (3084, 2272, 1609), PilotPattern.PP2: (3092, 2840, 2619),
        PilotPattern.PP3: (3228, 2840, 1961), PilotPattern.PP4: (3234, 3124, 2831),
        PilotPattern.PP5: (3298, 3124, 2177), PilotPattern.PP6: (0, 0, 0),
        PilotPattern.PP7: (3328, 3266, 2792), PilotPattern.PP8: (0, 0, 0),
    },
    (8192, False): {
        PilotPattern.PP1: (6208, 4544, 3218), PilotPattern.PP2: (6214, 5680, 5238),
        PilotPattern.PP3: (6494, 5680, 3922), PilotPattern.PP4: (6498, 6248, 5662),
        PilotPattern.PP5: (6634, 6248, 4354), PilotPattern.PP6: (0, 0, 0),
        PilotPattern.PP7: (6698, 6532, 5585), PilotPattern.PP8: (6698, 0, 0),
    },
    (8192, True): {
        PilotPattern.PP1: (6296, 4608, 3264), PilotPattern.PP2: (6298, 5760, 5312),
        PilotPattern.PP3: (6584, 5760, 3978), PilotPattern.PP4: (6588, 6336, 5742),
        PilotPattern.PP5: (6728, 6336, 4416), PilotPattern.PP6: (0, 0, 0),
        PilotPattern.PP7: (6788, 6624, 5664), PilotPattern.PP8: (6788, 0, 0),
    },
    (16384, False): {
        PilotPattern.PP1: (12418, 9088, 6437), PilotPattern.PP2: (12436, 11360, 10476),
        PilotPattern.PP3: (12988, 11360, 7845), PilotPattern.PP4: (13002, 12496, 11324),
        PilotPattern.PP5: (13272, 12496, 8709), PilotPattern.PP6: (13288, 13064, 11801),
        PilotPattern.PP7: (13416, 13064, 11170), PilotPattern.PP8: (13406, 0, 0),
    },
    (16384, True): {
        PilotPattern.PP1: (12678, 9280, 6573), PilotPattern.PP2: (12698, 11600, 10697),
        PilotPattern.PP3: (13262, 11600, 8011), PilotPattern.PP4: (13276, 12760, 11563),
        PilotPattern.PP5: (13552, 12760, 8893), PilotPattern.PP6: (13568, 13340, 12051),
        PilotPattern.PP7: (13698, 13340, 11406), PilotPattern.PP8: (13688, 0, 0),
    },
    (32768, False): {
        PilotPattern.PP1: (0, 0, 0), PilotPattern.PP2: (24886, 22720, 20952),
        PilotPattern.PP3: (0, 0, 0), PilotPattern.PP4: (26022, 24992, 22649),
        PilotPattern.PP5: (0, 0, 0), PilotPattern.PP6: (26592, 26128, 23603),
        PilotPattern.PP7: (26836, 0, 0), PilotPattern.PP8: (26812, 0, 0),
    },
    (32768, True): {
        PilotPattern.PP1: (0, 0, 0), PilotPattern.PP2: (25412, 23200, 21395),
        PilotPattern.PP3: (0, 0, 0), PilotPattern.PP4: (26572, 25520, 23127),
        PilotPattern.PP5: (0, 0, 0), PilotPattern.PP6: (27152, 26680, 24102),
        PilotPattern.PP7: (27404, 0, 0), PilotPattern.PP8: (27376, 0, 0),
    },
}
_CDATA[(1024, True)] = _CDATA[(1024, False)]
_CDATA[(2048, True)] = _CDATA[(2048, False)]
_CDATA[(4096, True)] = _CDATA[(4096, False)]

# number of TR-PAPR reserved carriers per FFT size (EN 302 755 table 59)
N_TR = {1024: 10, 2048: 18, 4096: 36, 8192: 72, 16384: 144, 32768: 288}

# scattered-pilot pattern geometry (EN 302 755 table 58): pattern -> (dx, dy)
SP_PATTERN = {
    PilotPattern.PP1: (3, 4), PilotPattern.PP2: (6, 2), PilotPattern.PP3: (6, 4),
    PilotPattern.PP4: (12, 2), PilotPattern.PP5: (12, 4), PilotPattern.PP6: (24, 2),
    PilotPattern.PP7: (24, 4), PilotPattern.PP8: (6, 16),
}

# pilot boost amplitudes (EN 302 755 tables 61-63)
SP_AMPLITUDE = {
    PilotPattern.PP1: 4.0 / 3.0, PilotPattern.PP2: 4.0 / 3.0,
    PilotPattern.PP3: 7.0 / 4.0, PilotPattern.PP4: 7.0 / 4.0,
    PilotPattern.PP5: 7.0 / 3.0, PilotPattern.PP6: 7.0 / 3.0,
    PilotPattern.PP7: 7.0 / 3.0, PilotPattern.PP8: 7.0 / 3.0,
}
CP_AMPLITUDE = {1024: 4.0 / 3.0, 2048: 4.0 / 3.0, 4096: 4.0 * 2 ** 0.5 / 3.0,
                8192: 8.0 / 3.0, 16384: 8.0 / 3.0, 32768: 8.0 / 3.0}

# constellation rotation angles in radians (EN 302 755 table 12:
# QPSK 29.0 deg, 16QAM 16.8 deg, 64QAM 8.6 deg, 256QAM atan(1/16))
import math
ROTATION = {
    Constellation.QPSK: math.radians(29.0),
    Constellation.QAM16: math.radians(16.8),
    Constellation.QAM64: math.radians(8.6),
    Constellation.QAM256: math.atan(1.0 / 16.0),
}
NORM_FACTOR = {
    Constellation.QPSK: 1.0 / math.sqrt(2.0),
    Constellation.QAM16: 1.0 / math.sqrt(10.0),
    Constellation.QAM64: 1.0 / math.sqrt(42.0),
    Constellation.QAM256: 1.0 / math.sqrt(170.0),
}
BITS_PER_CELL = {Constellation.QPSK: 2, Constellation.QAM16: 4,
                 Constellation.QAM64: 6, Constellation.QAM256: 8}

# BCH (N_bch, K_bch) per (FecFrame, CodeRate)  (EN 302 755 table 6a/6b)
BCH_PARAMS = {
    (FecFrame.NORMAL, CodeRate.C1_2): (32400, 32208),
    (FecFrame.NORMAL, CodeRate.C3_5): (38880, 38688),
    (FecFrame.NORMAL, CodeRate.C2_3): (43200, 43040),
    (FecFrame.NORMAL, CodeRate.C3_4): (48600, 48408),
    (FecFrame.NORMAL, CodeRate.C4_5): (51840, 51648),
    (FecFrame.NORMAL, CodeRate.C5_6): (54000, 53840),
    (FecFrame.SHORT, CodeRate.C1_2): (7200, 7032),
    (FecFrame.SHORT, CodeRate.C3_5): (9720, 9552),
    (FecFrame.SHORT, CodeRate.C2_3): (10800, 10632),
    (FecFrame.SHORT, CodeRate.C3_4): (11880, 11712),
    (FecFrame.SHORT, CodeRate.C4_5): (12600, 12432),
    (FecFrame.SHORT, CodeRate.C5_6): (13320, 13152),
    # T2-Lite (annex I): k_ldpc from the annex C tables (B8/B9, bundled
    # in etsi_ldpc.npz and pinned against the table archive by
    # test_params), K_bch = k_ldpc - 168 like every SHORT rate (t=12
    # over GF(2^14))
    (FecFrame.SHORT, CodeRate.C1_3): (5400, 5232),
    (FecFrame.SHORT, CodeRate.C2_5): (6480, 6312),
}

LDPC_TABLE_NAME = {
    (FecFrame.NORMAL, CodeRate.C1_2): "NORMAL_C1_2",
    (FecFrame.NORMAL, CodeRate.C3_5): "NORMAL_C3_5",
    (FecFrame.NORMAL, CodeRate.C2_3): "NORMAL_C2_3",
    (FecFrame.NORMAL, CodeRate.C3_4): "NORMAL_C3_4",
    (FecFrame.NORMAL, CodeRate.C4_5): "NORMAL_C4_5",
    (FecFrame.NORMAL, CodeRate.C5_6): "NORMAL_C5_6",
    (FecFrame.SHORT, CodeRate.C1_2): "SHORT_C1_2",
    (FecFrame.SHORT, CodeRate.C3_5): "SHORT_C3_5",
    (FecFrame.SHORT, CodeRate.C2_3): "SHORT_C2_3",
    (FecFrame.SHORT, CodeRate.C3_4): "SHORT_C3_4",
    (FecFrame.SHORT, CodeRate.C4_5): "SHORT_C4_5",
    (FecFrame.SHORT, CodeRate.C5_6): "SHORT_C5_6",
    (FecFrame.SHORT, CodeRate.C1_3): "B8",      # T2-Lite (annex C)
    (FecFrame.SHORT, CodeRate.C2_5): "B9",
}


@dataclasses.dataclass(frozen=True)
class T2Mode:
    """One complete OFDM-level T2 configuration with derived constants.

    Supported end-to-end: SISO and MISO base profile plus T2-Lite (the
    reference receiver only exercises SISO base,
    reference/README:29-41 — its MISO path is vestigial and its
    T2-Lite-only code rates are never wired up).
    """
    fft_mode: FftMode = FftMode.FFT_32K
    guard: GuardInterval = GuardInterval.G1_128
    pilot_pattern: PilotPattern = PilotPattern.PP7
    extended_carriers: bool = True
    papr: Papr = Papr.OFF
    miso: bool = False
    lite: bool = False                # T2-Lite profile (annex I; P1 S1=3/4)
    n_data_symbols: int = 59          # L_data = L_F - N_P2 (signalled in L1)

    # -- derived ------------------------------------------------------------
    @property
    def fft_size(self) -> int:
        return FFT_SIZE[self.fft_mode]

    @property
    def guard_size(self) -> int:
        f = GUARD_FRACTION[self.guard]
        return self.fft_size * f.numerator // f.denominator

    @property
    def symbol_size(self) -> int:
        return self.fft_size + self.guard_size

    @property
    def k_total(self) -> int:
        n, e, _ = K_TOTAL[self.fft_size]
        return e if self.extended_carriers else n

    @property
    def k_ext(self) -> int:
        return K_TOTAL[self.fft_size][2] if self.extended_carriers else 0

    @property
    def k_offset(self) -> int:
        """Offset of carrier 0 in extended numbering when in normal mode."""
        return 0 if self.extended_carriers else K_TOTAL[self.fft_size][2]

    @property
    def left_nulls(self) -> int:
        return (self.fft_size - self.k_total) // 2 + 1

    @property
    def n_p2(self) -> int:
        return N_P2[self.fft_size]

    @property
    def c_p2(self) -> int:
        c = (C_P2_MISO if self.miso else C_P2_SISO)[self.fft_size]
        return c

    def _cdata_raw(self):
        return _CDATA[(self.fft_size, self.extended_carriers)][self.pilot_pattern]

    @property
    def c_data(self) -> int:
        c = self._cdata_raw()[0]
        if c and self.papr in (Papr.TR, Papr.BOTH):
            c -= N_TR[self.fft_size]
        return c

    @property
    def n_fc(self) -> int:
        """Cells mapped in the frame-closing symbol (0 = no FC symbol)."""
        n = self._cdata_raw()[1]
        if n and self.papr in (Papr.TR, Papr.BOTH):
            n -= N_TR[self.fft_size]
        # combinations where the FC symbol is absent in SISO
        # (EN 302 755 clause 8.3.4 note; dvbt2_definition.cpp:601-618)
        if not self.miso:
            bad = {(GuardInterval.G1_128, PilotPattern.PP7),
                   (GuardInterval.G1_32, PilotPattern.PP4),
                   (GuardInterval.G1_16, PilotPattern.PP2),
                   (GuardInterval.G19_256, PilotPattern.PP2)}
            if (self.guard, self.pilot_pattern) in bad:
                return 0
        return n

    @property
    def c_fc(self) -> int:
        c = self._cdata_raw()[2]
        if c and self.papr in (Papr.TR, Papr.BOTH):
            c -= N_TR[self.fft_size]
        return 0 if self.n_fc == 0 else c

    @property
    def has_fc(self) -> bool:
        return self.n_fc > 0

    @property
    def frame_symbols(self) -> int:
        """L_F: OFDM symbols per T2 frame excluding P1."""
        return self.n_p2 + self.n_data_symbols

    @property
    def n_regular_data_symbols(self) -> int:
        return self.n_data_symbols - (1 if self.has_fc else 0)

    @property
    def frame_cells(self) -> int:
        """Total active data cells per frame (P2 + data + FC)."""
        return (self.n_p2 * self.c_p2
                + self.n_regular_data_symbols * self.c_data
                + (self.c_fc if self.has_fc else 0))

    @property
    def frame_samples(self) -> int:
        """Samples per T2 frame including the P1 preamble (at 64/7 Msps)."""
        return 2048 + self.frame_symbols * self.symbol_size

    @property
    def dx(self) -> int:
        return SP_PATTERN[self.pilot_pattern][0]

    @property
    def dy(self) -> int:
        return SP_PATTERN[self.pilot_pattern][1]

    @property
    def sp_amplitude(self) -> float:
        return SP_AMPLITUDE[self.pilot_pattern]

    @property
    def cp_amplitude(self) -> float:
        return CP_AMPLITUDE[self.fft_size]

    @property
    def p2_amplitude(self) -> float:
        if self.fft_size == 32768 and not self.miso:
            return math.sqrt(37.0) / 5.0
        return math.sqrt(31.0) / 5.0

    def validate(self):
        if self.c_data == 0:
            raise ValueError(
                f"pilot pattern {self.pilot_pattern.name} not allowed for "
                f"{self.fft_size}-pt FFT (EN 302 755 table 56)")
        if self.miso and (self.pilot_pattern
                          not in MISO_PILOT_PATTERNS[self.fft_size]):
            raise ValueError(
                f"pilot pattern {self.pilot_pattern.name} not allowed in "
                f"MISO for {self.fft_size}-pt FFT (EN 302 755 table 58)")
        if self.lite and self.fft_size not in (2048, 4096, 8192, 16384):
            raise ValueError(
                f"{self.fft_size}-pt FFT not allowed in T2-Lite "
                "(EN 302 755 annex I: 2K/4K/8K/16K only)")
        return self


@dataclasses.dataclass(frozen=True)
class PlpConfig:
    """Per-PLP modulation/coding configuration (subset of L1-post fields)."""
    plp_id: int = 0
    constellation: Constellation = Constellation.QAM256
    rotation: bool = True
    code_rate: CodeRate = CodeRate.C2_3
    fec_frame: FecFrame = FecFrame.NORMAL
    num_blocks_max: int = 10          # PLP_NUM_BLOCKS_MAX
    time_il_length: int = 3           # N_TI
    time_il_type: int = 0

    @property
    def fec_size(self) -> int:
        return FEC_SIZE_NORMAL if self.fec_frame == FecFrame.NORMAL else FEC_SIZE_SHORT

    @property
    def bits_per_cell(self) -> int:
        return BITS_PER_CELL[self.constellation]

    @property
    def cells_per_fec_block(self) -> int:
        return self.fec_size // self.bits_per_cell

    @property
    def n_bch(self) -> int:
        return BCH_PARAMS[(self.fec_frame, self.code_rate)][0]

    @property
    def k_bch(self) -> int:
        return BCH_PARAMS[(self.fec_frame, self.code_rate)][1]

    @property
    def k_ldpc(self) -> int:
        return self.n_bch

    @property
    def bch_m(self) -> int:
        """Galois field degree: GF(2^16) normal, GF(2^14) short."""
        return 16 if self.fec_frame == FecFrame.NORMAL else 14

    @property
    def bch_t(self) -> int:
        """Error-correcting capability (12 for most rates, 10 for normal
        2/3 and 5/6 whose parity field is 160 bits; EN 302 755 table 6a)."""
        return (self.n_bch - self.k_bch) // self.bch_m

    @property
    def ldpc_table_name(self) -> str:
        return LDPC_TABLE_NAME[(self.fec_frame, self.code_rate)]

    @property
    def rotation_angle(self) -> float:
        return ROTATION[self.constellation] if self.rotation else 0.0

    @property
    def norm_factor(self) -> float:
        return NORM_FACTOR[self.constellation]
