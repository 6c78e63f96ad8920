"""Cooperative TPU handoff between a long-running build and short jobs.

Only one TPU job can run at a time on this host, and a 1e7-scale
``scale_bench`` run holds the chip for hours. Without a handoff, a
short job that needs exclusive chip time (``bench.py`` — the headline
is meaningless under contention) would either wait for the whole build
or silently measure a shared chip.

Protocol (all plain files, no daemons):

- The **holder** (scale_bench) calls :func:`advertise` once, which
  records ``{pid, workdir}`` in ``BUSY_PATH``, then calls
  :func:`pause_point` at safe points — between shard builds, between
  pipeline stages, per pack batch, per eval slab. When a
  ``<workdir>/PAUSE`` file exists, ``pause_point`` writes a
  ``<workdir>/PAUSED`` ack and sleeps until PAUSE is removed. On full
  completion the holder calls :func:`clear`.
- A **client** (bench.py) calls :func:`acquire`, which creates PAUSE
  atomically (O_EXCL) with its own pid as the content and waits for
  the ack (or holder death), then runs its chip work and calls the
  returned ``release()``. The pid content serialises concurrent
  clients (a second client waits for the first's release) and lets a
  dead client's leftover token be reclaimed; an *operator* hold
  (`touch PAUSE`, empty file) is never removed by a client.

The PAUSE file doubles as the between-pass hold used by the build
wrapper scripts (``run_build.sh`` sleeps while it exists), so a client
acquiring during a wrapper restart window also blocks the next pass
from starting. A stale BUSY file (holder crashed) is detected by pid
liveness and costs the client one poll interval.

The reference has no analogue — its GPU services own their device for
life (clip_server.py:91-123); this exists because the build pipeline
and the serving bench share one chip in this deployment.

A copy of ``meme_search_engine_tpu/utils/tpu_lease.py``, which the port
keeps rather than imports: the same protocol, names and ``BUSY_PATH``
(``.tpu_busy.json`` at the repository root), so a holder and a client of
either package see each other. "Chip" is the card here. In the port the
holder is ``tools/scale_bench.py`` (its safe points are the JAX tool's,
and ``pipeline/processor.pack_index``'s per batch, ``index/opq.train_opq``'s
every 16 steps). The port has no client yet: :func:`acquire` waits for a
benchmark script of its own to call it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

BUSY_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".tpu_busy.json",
)

_holder_workdir: Optional[str] = None


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except (OSError, TypeError):
        return False


# --- holder side -----------------------------------------------------------


def advertise(workdir: str) -> None:
    """Record this process as the current long-lived TPU holder."""
    global _holder_workdir
    _holder_workdir = os.path.abspath(workdir)
    tmp = BUSY_PATH + f".{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "workdir": _holder_workdir}, f)
    os.replace(tmp, BUSY_PATH)


def pause_point(log: Optional[Callable[[str], None]] = None) -> None:
    """Safe point: if a client requested the chip, ack and hold here."""
    if _holder_workdir is None:
        return
    pause = os.path.join(_holder_workdir, "PAUSE")
    if not os.path.exists(pause):
        return
    ack = os.path.join(_holder_workdir, "PAUSED")
    if log:
        log("tpu_lease: PAUSE requested, holding at safe point")
    with open(ack, "w"):
        pass
    try:
        while os.path.exists(pause):
            time.sleep(2.0)
    finally:
        try:
            os.remove(ack)
        except OSError:
            pass
    if log:
        log("tpu_lease: resuming")


def clear() -> None:
    """Drop the busy advertisement (call on full completion)."""
    global _holder_workdir
    _holder_workdir = None
    try:
        os.remove(BUSY_PATH)
    except OSError:
        pass


# --- client side -----------------------------------------------------------


def acquire(
    timeout_s: float = 900.0,
    poll_s: float = 2.0,
    log: Optional[Callable[[str], None]] = None,
) -> Callable[[], None]:
    """Pause any advertised holder; returns release() (no-op if none).

    Returns as soon as the holder acks (it sits at a safe point, chip
    idle), the holder process is dead, or ``timeout_s`` elapses (then
    the caller proceeds under possible contention — logged).
    """
    try:
        with open(BUSY_PATH) as f:
            info = json.load(f)
        workdir = info["workdir"]
        pid = int(info["pid"])
    except (OSError, ValueError, KeyError):
        return lambda: None

    pause = os.path.join(workdir, "PAUSE")
    ack = os.path.join(workdir, "PAUSED")
    t0 = time.time()
    # PAUSE ownership disambiguates three parties writing one file:
    # - a *client* creates it atomically (O_EXCL) with its pid as the
    #   content, so a second concurrent client sees a live-pid PAUSE
    #   and WAITS instead of treating the parked holder as acquirable
    #   (two clients sharing the chip would corrupt both measurements);
    # - an *operator* hold (`touch PAUSE`) is an
    #   empty file — clients leave it in place on release and may run
    #   under it once the holder has acked it (chip parked idle);
    # - a dead client's leftover token (stale pid) is reclaimed.
    created_pause = False
    while time.time() - t0 < timeout_s:
        try:
            fd = os.open(pause, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            created_pause = True
            break
        except FileExistsError:
            try:
                with open(pause) as f:
                    txt = f.read().strip()
                owner = int(txt) if txt else None
            except (OSError, ValueError):
                owner = None
            if owner is None:
                # empty/unreadable: operator hold — handled below
                break
            if not _alive(owner):
                try:
                    os.remove(pause)
                except OSError:
                    pass
                continue
            if log:
                log(f"tpu_lease: waiting on client pid {owner} holding PAUSE")
            time.sleep(poll_s)
        except OSError:
            # stale busy file whose advertised workdir is gone (e.g. a
            # cleaned-up .scale1e7): nothing can be holding the chip
            # through it — treat as no holder rather than crashing the
            # caller before it measures
            if not _alive(pid):
                try:
                    os.remove(BUSY_PATH)
                except OSError:
                    pass
            elif log:
                log(
                    f"tpu_lease: holder pid {pid} alive but workdir "
                    f"{workdir} unwritable; proceeding unpaused"
                )
            return lambda: None
    operator_hold = not created_pause
    if log:
        log(f"tpu_lease: pausing holder pid {pid} ({workdir})")
    acquired = False
    while time.time() - t0 < timeout_s:
        try:
            ack_mtime = os.path.getmtime(ack)
            # fresh ack (holder parked in response to our PAUSE), or a
            # pre-existing manual hold: PAUSE predates us and the live
            # holder acked it *after* the hold was requested — it sits
            # at a safe point, and a sleeping holder never refreshes
            # the ack's mtime, so a freshness-vs-t0 test alone would
            # poll the full timeout with the chip idle. The
            # ack-after-pause check rejects a stale PAUSED leaked by a
            # kill -9 while parked (holder restarted, not yet parked).
            if created_pause and ack_mtime >= t0 - 1.0:
                acquired = True
                break
            if operator_hold and _alive(pid):
                try:
                    if ack_mtime >= os.path.getmtime(pause) - 1.0:
                        acquired = True
                        break
                except OSError:
                    pass
        except OSError:
            pass
        if not _alive(pid):
            # wrapper scripts may restart the holder under a new pid;
            # re-read before concluding the chip is free
            try:
                with open(BUSY_PATH) as f:
                    pid = int(json.load(f)["pid"])
            except (OSError, ValueError, KeyError):
                acquired = True
                break
            if not _alive(pid):
                acquired = True
                break
        time.sleep(poll_s)
    if log:
        if acquired:
            log(f"tpu_lease: chip free after {time.time() - t0:.0f}s")
        else:
            log(
                "tpu_lease: acquire timed out; proceeding under possible "
                "contention"
            )

    def release() -> None:
        # leave a manual operator hold in place: removing a PAUSE this
        # client didn't create would resume a build the operator wanted
        # held; only remove our own token (content = our pid)
        if not created_pause:
            return
        try:
            with open(pause) as f:
                if f.read().strip() != str(os.getpid()):
                    return
            os.remove(pause)
        except OSError:
            pass

    return release
