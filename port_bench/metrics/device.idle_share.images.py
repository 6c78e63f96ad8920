"""Share of the window in which no kernel ran (the union of the traced
kernel intervals against the window), in %; read in the cells whose
calls run the img tower."""


def read(run):
    if run.dtrace is None or not any(c.get("img") for _, _, c in run.calls):
        return None
    return 100.0 * (1.0 - run.dtrace.busy(run.t0, run.t1) / (run.t1 - run.t0))
