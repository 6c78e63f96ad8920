"""Device time of copies and memsets a call (the uint8 pictures' H2D,
the embeddings' D2H), from the profiler's memcpy events in the window."""


def read(run):
    if run.dtrace is None or not run.calls:
        return None
    t = sum(max(0.0, min(e, run.t1) - max(s, run.t0)) for s, e, _ in run.dtrace.copies)
    return 1e3 * t / len(run.calls)
