"""The whole step's share of the card's peak in the ingest window: the
image tower's model operations for the images completed (counted by
``flops.image_flops`` from the configuration: 729 real tokens, unpadded
widths) over the window's time at the bf16 peak, in %. All the time of
the window counts (the copies, the host's bucketing, idle gaps), so it
bounds what any kernel's roofline share can claim end to end."""

from port_bench import flops


def read(run):
    n = sum(c.get("img", 0) for _, _, c in run.calls)
    if not n:
        return None
    return 100.0 * n * flops.image_flops(run.ctx.model) / ((run.t1 - run.t0) * flops.PEAK_BF16)
