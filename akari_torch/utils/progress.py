"""Progress reporting (``akari_tpu/utils/progress.py``): a counter and an
ASCII bar with elapsed time and ETA, redrawn at most every 0.1 s.
Host-side; driven once per spp chunk."""

from __future__ import annotations

import sys
import threading
import time


class ProgressReporter:
    def __init__(self, total, label="render", stream=sys.stderr, width=40):
        self.total = max(int(total), 1)
        self.label = label
        self.count = 0
        self._lock = threading.Lock()
        self._stream = stream
        self._width = width
        self._start = time.monotonic()
        self._last_draw = 0.0

    def update(self, n=1):
        with self._lock:
            self.count += n
            now = time.monotonic()
            if now - self._last_draw < 0.1 and self.count < self.total:
                return
            self._last_draw = now
            frac = min(self.count / self.total, 1.0)
            filled = int(frac * self._width)
            bar = "=" * filled + " " * (self._width - filled)
            elapsed = now - self._start
            eta = elapsed / frac - elapsed if frac > 0 else 0.0
            self._stream.write(
                f"\r{self.label} [{bar}] {100 * frac:5.1f}% "
                f"({elapsed:6.1f}s, eta {eta:6.1f}s)"
            )
            if self.count >= self.total:
                self._stream.write("\n")
            self._stream.flush()
