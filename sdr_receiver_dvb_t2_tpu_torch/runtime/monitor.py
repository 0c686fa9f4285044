"""Live in-run monitor: watch a running receiver converge without
stopping it.

The reference shows spectrum / constellation / equalizer / LDPC views and
the L1 text live while receiving (reference/src/main_window.cpp:
416-476, plot.cpp); a headless framework renders the same four views as a
periodically refreshed TERMINAL panel (``dvbt2-rx-torch --monitor SECS``):
PSD sparkline, constellation density grid, LDPC trials histogram, L1/PLP
summary and the tracking-loop state — and can mirror each refresh to an
.npz (``--monitor-npz``) consumable by ``tools/plot_dumps.py`` for a full
graphical render.

All rendering is pure string building over NumPy arrays (no curses / no
plotting dependency); the only device work per refresh is one
single-frame ``equalized_cells`` plane.  (The multi-channel pod's panel
comes with the pod, which is not ported yet.)
"""
from __future__ import annotations

import sys
import time

import numpy as np

_BLOCKS = " ▁▂▃▄▅▆▇█"
_DENSITY = " .:-=+*#%@"


def sparkline(values: np.ndarray, width: int = 64,
              lo: float | None = None, hi: float | None = None) -> str:
    """Array -> one line of block characters (min-max normalized)."""
    v = np.asarray(values, np.float64)
    if len(v) == 0:
        return " " * width
    if len(v) != width:                      # resample by bin-mean
        edges = np.linspace(0, len(v), width + 1).astype(np.int64)
        v = np.array([v[a:b].mean() if b > a else v[min(a, len(v) - 1)]
                      for a, b in zip(edges[:-1], edges[1:])])
    lo = float(np.min(v)) if lo is None else lo
    hi = float(np.max(v)) if hi is None else hi
    span = max(hi - lo, 1e-12)
    idx = np.clip(((v - lo) / span) * (len(_BLOCKS) - 1), 0,
                  len(_BLOCKS) - 1).astype(np.int64)
    return "".join(_BLOCKS[i] for i in idx)


def scatter_grid(cells: np.ndarray, width: int = 56, height: int = 21,
                 span: float = 1.7) -> list[str]:
    """Complex constellation points -> density-grid lines (a terminal
    scatter plot; the reference's constellation view)."""
    c = np.asarray(cells).reshape(-1)
    if len(c) == 0:
        return [" " * width for _ in range(height)]
    x = np.clip((c.real / span + 1.0) * 0.5 * (width - 1), 0, width - 1)
    y = np.clip((1.0 - c.imag / span) * 0.5 * (height - 1), 0, height - 1)
    grid = np.zeros((height, width), np.int64)
    np.add.at(grid, (y.astype(np.int64), x.astype(np.int64)), 1)
    peak = max(int(grid.max()), 1)
    lvl = np.ceil(np.sqrt(grid / peak) * (len(_DENSITY) - 1)).astype(
        np.int64)
    return ["".join(_DENSITY[i] for i in row) for row in lvl]


def hist_bars(hist: np.ndarray, width: int = 40) -> list[str]:
    """LDPC trials histogram -> horizontal bar lines (the reference's
    per-256-frames trials printout, ldpc_decoder.cpp:242-270)."""
    h = np.asarray(hist, np.int64)
    total = max(int(h.sum()), 1)
    out = []
    for i, n in enumerate(h):
        if n == 0:
            continue
        bar = "#" * max(1, int(round(width * n / total)))
        out.append(f"  {i:2d} iters |{bar:<{width}}| {n}")
    return out or ["  (no codewords decoded yet)"]


class Monitor:
    """Periodic renderer bound to a StreamingReceiver.

    ``maybe_render(rx)`` is called once per batch from the CLI loop; every
    ``interval`` seconds it writes the panel (ANSI home+clear when ``out``
    is a tty, plain append otherwise, so piping to a file keeps a
    history) and optionally refreshes ``npz_path``.
    """

    def __init__(self, interval: float = 2.0, out=None,
                 npz_path: str | None = None, clear: bool | None = None):
        self.interval = float(interval)
        self.out = out if out is not None else sys.stderr
        self.npz_path = npz_path
        # -inf, so that the first call renders whatever the host's uptime
        # (time.monotonic() may be below ``interval`` on a fresh host)
        self._t_last = -float("inf")
        self._t0 = time.monotonic()
        self.clear = (clear if clear is not None
                      else bool(getattr(self.out, "isatty", lambda: False)()))
        self.refreshes = 0

    def maybe_render(self, rx) -> bool:
        now = time.monotonic()
        if now - self._t_last < self.interval:
            return False
        self._t_last = now
        panel, arrays = self.render(rx)
        if self.clear:
            self.out.write("\x1b[H\x1b[2J")
        self.out.write(panel + "\n")
        self.out.flush()
        if self.npz_path:
            np.savez(self.npz_path + ".tmp.npz", **arrays)
            import os
            os.replace(self.npz_path + ".tmp.npz", self.npz_path)
        self.refreshes += 1
        return True

    # ------------------------------------------------------------------
    def render(self, rx) -> tuple[str, dict]:
        """StreamingReceiver -> (panel text, npz-able arrays)."""
        from . import diagnostics
        s = rx.stats
        lines = []
        t = time.monotonic() - self._t0
        lines.append(
            f"── dvbt2-rx monitor ── t={t:6.1f}s  state={s.state}  "
            f"frames={s.frames}  ts_pkts={s.ts_packets}")
        lines.append(
            f"   snr={s.snr_db:5.1f} dB  cfo={s.cfo_hz:+8.1f} Hz  "
            f"sro={s.sro_ppm:+6.2f} ppm  ldpc_fail={s.ldpc_failures}  "
            f"bch_dirty={s.bch_dirty}  bch_fix={s.bch_corrected}")
        arrays: dict = {}

        # spectrum of the current elementary buffer (around frame_pos)
        elem = getattr(rx, "_elem", None)
        if elem is not None and len(elem) >= 2048:
            pos = rx.frame_pos or 0
            blk = np.asarray(elem[max(0, pos):max(0, pos) + 16384])
            if len(blk) < 2048:
                blk = np.asarray(elem[-2048:])
            nfft = 1024 if len(blk) >= 1024 else 256
            _, db = diagnostics.power_spectrum(blk, nfft=nfft)
            arrays["spectrum_db"] = db
            lines.append(f"   spectrum [{db.min():6.1f}, {db.max():6.1f}] "
                         "dB (elementary rate)")
            lines.append("   " + sparkline(db, 72))

        # equalized constellation of the CURRENT frame (one-frame plane)
        if (rx.rx is not None and rx.frame_pos is not None and elem is not
                None and len(elem) >= (rx.frame_pos or 0)
                + rx.mode.frame_samples):
            frame = np.asarray(
                elem[rx.frame_pos:rx.frame_pos + rx.mode.frame_samples])
            try:
                cells = rx.rx.equalized_cells(frame[None, :])
                cells = diagnostics.constellation(cells, max_points=4096)
                arrays["constellation"] = cells
                lines.append(f"   constellation "
                             f"({rx.rx.plp.constellation.name}"
                             f"{' rotated' if rx.rx.plp.rotation else ''}, "
                             f"{len(cells)} cells)")
                lines.extend("   " + g for g in scatter_grid(cells))
            except Exception as e:          # monitor must never kill RX
                lines.append(f"   constellation unavailable: {e}")

        # LDPC trials histogram
        lines.append("   " + rx.ldpc_stats.summary())
        lines.extend(hist_bars(rx.ldpc_stats.hist))
        arrays["ldpc_hist"] = np.asarray(rx.ldpc_stats.hist)

        # L1 / PLP summary (the reference's L1 text view, condensed)
        if rx.mode is not None:
            m = rx.mode
            lines.append(
                f"   L1: {m.fft_size // 1024}K GI {m.guard.name} "
                f"{m.pilot_pattern.name}"
                f"{' ext' if m.extended_carriers else ''}"
                f"{' MISO' if m.miso else ''}")
        post = getattr(rx, "_l1_post", None)
        if post is not None:
            for i, p in enumerate(post.plp):
                dyn = next((d for d in post.dyn.plp if d.id == p.id), None)
                nb = dyn.num_blocks if dyn is not None else "?"
                lines.append(
                    f"   PLP {p.id}: mod={p.plp_mod} cod={p.plp_cod} "
                    f"fec={p.plp_fec_type} num_blocks={nb}"
                    + (" <- decoding" if p.id == rx.rx.plp.plp_id else ""))
        return "\n".join(lines), arrays
