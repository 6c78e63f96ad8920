"""The NaFlex image tower's roofline share: the sum over the window's
calls of each operation's least time (``flops_naflex.call_bound_s``,
each picture at its own valid length) over the time a kernel ran in the
window (the union of the traced kernels), in %."""

from port_bench import flops_naflex


def read(run):
    if run.dtrace is None:
        return None
    busy = run.dtrace.busy(run.t0, run.t1)
    bound = sum(flops_naflex.call_bound_s(run.ctx.model, c)
                for _, _, c in run.calls if c.get("img") and "patches" in c)
    return 100.0 * bound / busy if bound and busy > 0 else None
