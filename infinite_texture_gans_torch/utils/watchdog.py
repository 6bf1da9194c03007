"""Training stall watchdog.

Port of ``infinite_texture_gans_tpu/utils/watchdog.py``. A run whose device
stops making progress (a hung kernel, a wedged device, a stuck collective)
hangs silently: no exception, no output, no more checkpoints.
``StallWatchdog`` keeps the stall arithmetic (``check``, testable with an
injected clock) apart from a small daemon-thread wrapper (``start`` /
``stop``). The train loop calls ``beat()`` after every real device sync
(the epoch-end read of the loss sums); the watchdog learns the typical
interval and warns, to stderr and once per stall, when progress stops for
``max(min_grace_s, factor * median interval)``. It never kills the run: a
stalled launch cannot be cancelled from Python, and the remedy (probe the
card from another process, then kill and ``--resume``) needs the operator.
"""

from __future__ import annotations

import statistics
import sys
import threading
import time
from typing import Callable, List, Optional


class StallWatchdog:
    def __init__(
        self,
        min_grace_s: float = 300.0,
        factor: float = 20.0,
        poll_s: float = 15.0,
        warn: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.min_grace_s = float(min_grace_s)
        self.factor = float(factor)
        self.poll_s = float(poll_s)
        self._warn = warn or (lambda msg: print(msg, file=sys.stderr, flush=True))
        self._clock = clock
        self._lock = threading.Lock()
        self._last_beat: Optional[float] = None
        self._intervals: List[float] = []
        self._warned_for: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- the stall arithmetic ---------------------------------------
    def beat(self) -> None:
        """Record one unit of real progress (a completed device sync)."""
        now = self._clock()
        with self._lock:
            if self._last_beat is not None:
                self._intervals.append(now - self._last_beat)
                if len(self._intervals) > 64:  # rolling window
                    del self._intervals[0]
            self._last_beat = now
            self._warned_for = None  # a new episode's baseline

    def threshold_s(self) -> float:
        with self._lock:
            if not self._intervals:
                return self.min_grace_s
            return max(self.min_grace_s, self.factor * statistics.median(self._intervals))

    def check(self, now: Optional[float] = None) -> Optional[str]:
        """A warning if progress has stalled, once per episode; else None.
        Touches no thread: safe to call from tests."""
        if now is None:
            now = self._clock()
        with self._lock:
            last = self._last_beat
            warned = self._warned_for
        if last is None:
            return None  # not started (the first epoch's builds and captures may take minutes)
        stalled_s = now - last
        thr = self.threshold_s()
        if stalled_s < thr or warned == last:
            return None
        with self._lock:
            self._warned_for = last
        med = statistics.median(self._intervals) if self._intervals else float("nan")
        return (
            f"[watchdog] no training progress for {stalled_s:.0f} s "
            f"(typical epoch {med:.1f} s, threshold {thr:.0f} s). The device may be hung: "
            "probe it from a SEPARATE process with `python -c \"import torch; "
            "print(torch.ones(1, device='cuda') + 1)\"`. If the probe succeeds but this run "
            "stays stuck, kill this process and restart with --resume <last checkpoint>."
        )

    # ---- the thread wrapper -----------------------------------------
    def start(self) -> "StallWatchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="stall-watchdog",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            msg = self.check()
            if msg is not None:
                self._warn(msg)
