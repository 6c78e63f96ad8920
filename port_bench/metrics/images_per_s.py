"""Inputs of the img tower whose call completed in the window, over the
window's time (from its start to the end of the last call that started
in it): all the work over all the time. Host clock."""


def read(run):
    n = sum(c.get("img", 0) for _, _, c in run.calls)
    return n / (run.t1 - run.t0) if n else None
