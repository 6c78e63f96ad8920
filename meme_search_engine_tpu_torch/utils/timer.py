"""RAII-style phase timer (reference: diskann/src/lib.rs:389-401 Timer).

A copy of ``meme_search_engine_tpu/utils/timer.py``, which the port keeps
rather than imports.
"""

from __future__ import annotations

import time


class Timer:
    """Context manager printing elapsed seconds for a named phase."""

    def __init__(self, name: str, quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if not self.quiet:
            print(f"{self.name}: {self.elapsed:.2f}s")
        return False
