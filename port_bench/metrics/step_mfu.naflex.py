"""The whole step's share of the card's peak in the NaFlex ingest window:
the image tower's model operations for the pictures completed, each at
its own valid length (``flops_naflex.call_flops`` from the counts the
system recorded of the pictures it sent), over the window's time at the
bf16 peak, in %. All the time of the window counts."""

from port_bench import flops, flops_naflex


def read(run):
    calls = [c for _, _, c in run.calls if c.get("img") and "patches" in c]
    if not calls:
        return None
    ops = sum(flops_naflex.call_flops(run.ctx.model, c) for c in calls)
    return 100.0 * ops / ((run.t1 - run.t0) * flops.PEAK_BF16)
