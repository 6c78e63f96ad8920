"""The control of each cell's comparison: the reference put in the
program's place, one precision below what the configuration states.

    python3 port_bench/control.py --workload CELL --seeds N1,N2,...

The configuration states bf16 towers; the control is the reference
towers with every dense layer's inputs and weights rounded to float8
e4m3 (one scale a tensor). For each seed it draws the inputs a run of
the cell draws (the same pool of requests and a sample of the same size
over it) and prints one JSON line with ``emb_err`` as the control gives
it. Run it on the card at the cell's size; a limit lies below every
reading it gives (``PERF.md``). The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(ctx) -> dict:
    """The control's numbers for one run's inputs (``ctx`` from
    ``harness.setup`` with its ``device``)."""
    from port_bench import generate, judge

    t = generate.make(ctx.traffic, ctx.seed, model=ctx.model, device=ctx.device)
    picks = judge.sample_rows(len(t.inputs), min(len(x) for x in t.inputs),
                              ctx.workload["sample"], ctx.seed)
    items = [(t.kinds[c], t.inputs[c][row]) for c, row in picks]
    want = judge.reference_rows(ctx, items)
    return {"emb_err": judge.emb_err(judge.reference_rows(ctx, items, precision="fp8"), want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    from port_bench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.setup(["--workload", args.workload, "--seed", str(seed), "--seconds", "1"])
        ctx.device = harness.card_device(ctx)
        t = time.perf_counter()
        out = readings(ctx)
        print(json.dumps({"cell": args.workload, "seed": seed, "control": out,
                          "seconds": time.perf_counter() - t}), flush=True)
        harness.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
