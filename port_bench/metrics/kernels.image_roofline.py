"""The image tower's roofline share: the sum over the window's calls of
each operation's least time (``flops.image_ops``: the patch embedding,
each layer's LN + QKV, attention, o + residual and LN + MLP + residual,
the MAP head; each bound by operations at the bf16 peak or bytes at the
HBM rate) over the time a kernel ran in the window (the union of the
traced kernels), in %."""

from port_bench import flops


def read(run):
    if run.dtrace is None:
        return None
    busy = run.dtrace.busy(run.t0, run.t1)
    bound = sum(sum(flops.bound_s(f, b) for _, f, b in flops.image_ops(run.ctx.model, c["img"]))
                for _, _, c in run.calls if c.get("img"))
    return 100.0 * bound / busy if bound and busy > 0 else None
