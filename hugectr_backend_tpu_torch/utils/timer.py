"""Periodic / one-shot task scheduling for cache refresh.

A copy of the JAX package's utils/timer.py. Mirrors the reference's
``Timer`` (reference hps_backend/include/timer.hpp:71-99):
``start(interval, task)`` runs task every interval seconds until stopped;
``startonce(delay, task)`` runs it once after delay. Unlike the reference's
detached thread + condition-variable loop (which contains a predicate bug,
timer.hpp:64 assigns instead of comparing), this uses a joinable thread with
an Event so ``stop()`` is prompt and exceptions are logged, not fatal
(matching the reference's intent: refresh failures must not kill serving).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

log = logging.getLogger("hps_tpu.timer")


class Timer:
    def __init__(self):
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()

    def _arm(self) -> threading.Event:
        """Fresh stop-event when restarting after stop() (a shared set
        Event made a restarted Timer silently never run its task) and
        prune finished threads so long-lived timers don't accumulate dead
        Thread objects."""
        with self._lock:
            if self._stop.is_set():
                self._stop = threading.Event()
            self._threads = [t for t in self._threads if t.is_alive()]
            return self._stop

    def start(self, interval_s: float, task: Callable[[], None]) -> None:
        """Run ``task`` every ``interval_s`` seconds until :meth:`stop`."""
        stop = self._arm()

        def loop():
            while not stop.wait(interval_s):
                try:
                    task()
                except Exception:
                    log.exception("periodic task failed")

        t = threading.Thread(target=loop, daemon=True, name="hps-timer-periodic")
        with self._lock:
            self._threads.append(t)
        t.start()

    def startonce(self, delay_s: float, task: Callable[[], None]) -> None:
        """Run ``task`` once after ``delay_s`` seconds (async, pooled in the
        reference via ThreadPool, timer.hpp:92-99)."""

        stop = self._arm()

        def once():
            if stop.wait(delay_s):
                return
            try:
                task()
            except Exception:
                log.exception("one-shot task failed")

        t = threading.Thread(target=once, daemon=True, name="hps-timer-once")
        with self._lock:
            self._threads.append(t)
        t.start()

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        if join:
            with self._lock:
                threads = list(self._threads)
            me = threading.current_thread()
            for t in threads:
                if t is not me:  # a task calling stop() cannot join itself
                    t.join(timeout=5)
