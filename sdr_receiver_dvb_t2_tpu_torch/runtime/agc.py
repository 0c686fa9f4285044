"""AGC: hysteresis gain stepper for hardware sources.

Mirrors the reference's software AGC state machine
(reference/src/rx_base.cpp:97-131): measure the conditioned signal
level, step the front-end gain by +-1 dB when it leaves the target window,
and wait a settle period after each step.  File playback has fixed gain;
live sources expose ``set_gain_db``/``gain_min``/``gain_max`` (the same
contract as the reference's rx_interface) and get driven per block.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class AgcConfig:
    level_min: float = 0.08        # mean(|I|+|Q|) lower threshold
    level_max: float = 0.35        # upper threshold (clipping headroom)
    settle_s: float = 0.01         # reference: 10 ms after each step
    step_db: float = 1.0


class Agc:
    def __init__(self, source, cfg: AgcConfig | None = None,
                 gain_db: float | None = None):
        self.cfg = cfg or AgcConfig()
        self.src = source
        self.enabled = all(hasattr(source, a) for a in
                           ("set_gain_db", "gain_min", "gain_max"))
        self.gain_db = gain_db
        self._last_step = 0.0
        if self.enabled and gain_db is None:
            self.gain_db = (source.gain_min() + source.gain_max()) / 2
            source.set_gain_db(self.gain_db)

    def update(self, level: float) -> float | None:
        """Feed the per-block level observable; returns the new gain if a
        step was taken."""
        if not self.enabled:
            return None
        now = time.monotonic()
        if now - self._last_step < self.cfg.settle_s:
            return None
        step = 0.0
        if level > self.cfg.level_max:
            step = -self.cfg.step_db
        elif level < self.cfg.level_min:
            step = self.cfg.step_db
        if not step:
            return None
        new = min(max(self.gain_db + step, self.src.gain_min()),
                  self.src.gain_max())
        if new == self.gain_db:
            return None
        self.gain_db = new
        self.src.set_gain_db(new)
        self._last_step = now
        return new
