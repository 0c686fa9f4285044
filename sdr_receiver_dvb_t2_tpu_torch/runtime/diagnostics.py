"""Diagnostics: the data behind the reference's live plots, as arrays.

The reference renders spectrograph / constellation / P1-correlation /
equalizer-response / LDPC-statistics views with QCustomPlot
(reference/src/plot.h:26-33, main_window.cpp:416-476) and prints an
LDPC trials histogram every 256 frames (ldpc_decoder.cpp:242-270).  A
headless framework exports the same quantities as NumPy arrays — dump them
with ``--dump-constellation`` or consume them programmatically.
"""
from __future__ import annotations

import dataclasses
import numpy as np


def power_spectrum(iq: np.ndarray, nfft: int = 4096,
                   sample_rate: float | None = None):
    """Welch-style averaged PSD of an IQ block -> (freqs, dB)."""
    n = (len(iq) // nfft) * nfft
    if n == 0:
        raise ValueError(f"need at least {nfft} samples")
    segs = iq[:n].reshape(-1, nfft) * np.hanning(nfft)[None]
    psd = np.mean(np.abs(np.fft.fftshift(np.fft.fft(segs, axis=1),
                                         axes=1)) ** 2, axis=0)
    db = 10 * np.log10(np.maximum(psd, 1e-20))
    freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / (sample_rate or 1.0)))
    return freqs, db


def constellation(eq_cells: np.ndarray, max_points: int = 8192) -> np.ndarray:
    """Equalized cells subsampled for a scatter view (complex array)."""
    cells = np.asarray(eq_cells).reshape(-1)
    if len(cells) > max_points:
        idx = np.linspace(0, len(cells) - 1, max_points).astype(np.int64)
        cells = cells[idx]
    return cells


def p1_correlation_trace(metric: np.ndarray) -> np.ndarray:
    """The P1 detection metric over candidate positions (null indicator)."""
    return np.asarray(metric)


def format_l1(pre, post) -> str:
    """Parsed L1-pre/post as a text dump — the reference's L1 display
    (p2_symbol.cpp:482-509, 680-699) for a headless CLI."""
    lines = ["L1-pre:"]
    for f in dataclasses.fields(pre):
        lines.append(f"  {f.name:<22}= {getattr(pre, f.name)}")
    lines.append("L1-post:")
    for f in dataclasses.fields(post):
        v = getattr(post, f.name)
        if f.name in ("plp", "rf", "aux") and isinstance(v, (list, tuple)):
            lines.append(f"  {f.name} ({len(v)}):")
            for i, item in enumerate(v):
                for g in dataclasses.fields(item):
                    lines.append(f"    [{i}].{g.name:<18}= "
                                 f"{getattr(item, g.name)}")
        elif f.name == "dyn":
            lines.append("  dyn:")
            for g in dataclasses.fields(v):
                w = getattr(v, g.name)
                if isinstance(w, (list, tuple)):
                    for i, item in enumerate(w):
                        for h in dataclasses.fields(item):
                            lines.append(f"    plp[{i}].{h.name:<16}= "
                                         f"{getattr(item, h.name)}")
                else:
                    lines.append(f"    {g.name:<20}= {w}")
        else:
            lines.append(f"  {f.name:<22}= {v}")
    return "\n".join(lines)


@dataclasses.dataclass
class LdpcStats:
    """Trials histogram + failure counter, printed every ``period`` frames
    like the reference (ldpc_decoder.cpp:256-270)."""
    max_iters: int = 15
    period: int = 256
    hist: np.ndarray = None
    failures: int = 0
    total: int = 0
    _last_report: int = 0

    def __post_init__(self):
        if self.hist is None:
            self.hist = np.zeros(self.max_iters + 1, dtype=np.int64)

    def update(self, iters, ok: np.ndarray):
        """``iters``: per-codeword first-clean iteration array (scalar also
        accepted); builds the same per-codeword trials histogram the
        reference prints (ldpc_decoder.cpp:242-270)."""
        ok = np.asarray(ok)
        iters = np.broadcast_to(np.asarray(iters), ok.shape)
        # clip both ends: a decoder configured beyond the kernel's int8
        # trials range reports wrapped values; never feed bincount negatives
        self.hist += np.bincount(np.clip(iters, 0, self.max_iters),
                                 minlength=self.max_iters + 1)
        self.failures += int(np.sum(~ok))
        self.total += len(ok)

    def summary(self) -> str:
        pct = 100.0 * self.failures / max(self.total, 1)
        bars = " ".join(f"{i}:{c}" for i, c in enumerate(self.hist) if c)
        return f"ldpc: {self.total} frames, {pct:.2f}% failed, trials {bars}"

    def maybe_report(self) -> str | None:
        """Report each time another ``period`` frames have accumulated
        (boundary-crossing, so any batch size triggers it)."""
        if self.total // self.period > self._last_report // self.period:
            self._last_report = self.total
            return self.summary()
        return None
