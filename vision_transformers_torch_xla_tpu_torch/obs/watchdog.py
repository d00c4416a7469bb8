"""Training stall watchdog.

Counterpart of vision_transformers_torch_xla_tpu/obs/watchdog.py
(`StepWatchdog`, :21-65), copied: a background thread that notices when
the train loop stops making progress (a hung kernel, a wedged device, a
stuck input pipeline) and dumps every thread's stack so the hang can be
diagnosed.
"""
from __future__ import annotations

import faulthandler
import logging
import sys
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)


class StepWatchdog:
    """Call .beat() every step; if no beat for `timeout_s`, logs a warning
    with full stack dumps (once per stall)."""

    def __init__(self, timeout_s: float = 600.0, name: str = "train",
                 on_stall=None):
        self.timeout_s = timeout_s
        self.name = name
        self.on_stall = on_stall
        self._last = time.monotonic()
        self._steps = 0
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"watchdog-{self.name}")
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()
        self._steps += 1
        self._stalled = False

    def _run(self):
        while not self._stop.wait(min(self.timeout_s / 4, 60.0)):
            age = time.monotonic() - self._last
            if age > self.timeout_s and not self._stalled:
                self._stalled = True
                log.warning(
                    "[watchdog:%s] no progress for %.0fs (last step %d) — "
                    "dumping stacks", self.name, age, self._steps)
                faulthandler.dump_traceback(file=sys.stderr)
                if self.on_stall is not None:
                    try:
                        self.on_stall(age, self._steps)
                    except Exception:  # pragma: no cover
                        pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
