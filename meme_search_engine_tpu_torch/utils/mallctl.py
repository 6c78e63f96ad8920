"""glibc malloc arena control for long-running build processes.

A copy of ``meme_search_engine_tpu/utils/mallctl.py``, which the port
keeps rather than imports. The scale tool's shard loop calls
:func:`malloc_trim` once per built shard (the trim is sub-millisecond) to
hand reclaimable glibc arena pages back to the OS, and logs
:func:`rss_kb` so the build's host growth stays measurable; the process
cap (``--max-build-records``) is the backstop for growth that no trim
returns.
"""

from __future__ import annotations

import ctypes

_libc = None


def malloc_trim() -> bool:
    """Release free glibc heap pages back to the OS. Safe no-op on
    non-glibc platforms. Returns True if memory was released."""
    global _libc
    try:
        if _libc is None:
            _libc = ctypes.CDLL("libc.so.6")
        return bool(_libc.malloc_trim(0))
    except (OSError, AttributeError):
        return False


def rss_kb() -> int:
    """Current process resident set size in KB (0 if unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0
