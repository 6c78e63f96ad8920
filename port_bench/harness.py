"""One run of one cell: find its files by name, run it, judge it, print it.

``BENCHMARK.json`` defines the cell (its configuration, mix and chips);
the rest is found by name:

- ``configs/<config>.json``: the configuration (the model's shapes, the
  engine's largest batch, the source);
- ``workloads/<cell>.json``: the cell's own numbers: its ``system``
  (``systems/<system>.py``, the program as the cell drives it), the size
  of the checked sample and the limits of the comparison with the
  reference;
- ``traffic/<mix>.json``: the mix, read by ``generate.py``;
- ``metrics/<metric>.py``: one reader a metric, ``read(run)`` returning
  its value or ``None`` where it finds nothing to read.

With ``--trace 0`` the run reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (spans and the device trace on). The
last line of standard output is the result; the numbers compared with the
reference, each beside its limit, are the last lines of standard error
and the result's last key.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))

# compared by whole top-level name: the port's own name begins with the
# JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "meme_search_engine_tpu")


def _load(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_start() -> Optional[float]:
    """The process's start on ``time.perf_counter``'s clock (from
    /proc/self/stat and CLOCK_BOOTTIME), or None where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        now = time.clock_gettime(time.CLOCK_BOOTTIME)
        return time.perf_counter() - (now - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def selected(bench: dict, key: str, cell: str) -> list:
    """The metrics of ``bench[key]`` that ``cell`` reports."""
    return [m for m in bench[key] if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, run) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _merge(base: dict, over: Optional[dict]) -> dict:
    return {**base, **(over or {})}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def setup(argv, t_start: Optional[float] = None, *, cpu: bool = False,
          overrides: Optional[dict] = None):
    """The run's context: its arguments, the cell's files and the device.
    ``cpu`` and ``overrides`` (dicts merged into ``config``, ``model``,
    ``workload`` and ``traffic``) are for the tests' dry runs."""
    args = parse(argv)
    bench = _load("..", "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    overrides = overrides or {}
    config = _merge(_load("configs", cell["config"] + ".json"), overrides.get("config"))
    ctx = SimpleNamespace(
        args=args, bench=bench, cell=cell, name=cell["name"], config=config,
        model=_merge(config["model"], overrides.get("model")), max_batch=config["max_batch"],
        workload=_merge(_load("workloads", cell["name"] + ".json"), overrides.get("workload")),
        traffic=_merge(_load("traffic", cell["traffic"] + ".json"), overrides.get("traffic")),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        t_start=t_start if t_start is not None else time.perf_counter(), cpu=cpu)
    return ctx


def card_device(ctx):
    """The card the run uses; exits without a result where there is none."""
    import torch

    if ctx.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < ctx.cell["chips"]:
        print(f"needs {ctx.cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda:0")


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def execute(argv, t_start: Optional[float] = None, *, cpu: bool = False,
            overrides: Optional[dict] = None):
    """Run the cell once: its context and what the run recorded."""
    ctx = setup(argv, t_start, cpu=cpu, overrides=overrides)
    ctx.device = card_device(ctx)
    system = importlib.import_module(f"port_bench.systems.{ctx.workload['system']}")
    return ctx, system.run(ctx)


def report(ctx, run) -> dict:
    """The result line: the cell's metrics for the run's mode, the
    device, and the numbers compared with the reference, last."""
    key = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in selected(ctx.bench, key, ctx.name):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # every answer due comes, and every sampled one is compared: exact
    limits = {**ctx.workload["limits"], "failed": 0, "unchecked": 0}
    values = {**run.checks, "failed": run.failed, "unchecked": run.unchecked}
    checks = {name: {"value": values[name], "limit": limits[name]} for name in limits}
    device = {"platform": "cpu" if ctx.cpu else "gpu", "kind": run.device_kind, "count": 1,
              "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": device}
    if ctx.trace and run.dtrace is not None:
        device["busy_s"] = run.dtrace.busy(run.t0, run.t1)
        device["window_s"] = run.t1 - run.t0
        from .trace import breakdown

        result["breakdown"] = breakdown(run.dtrace, run.spans, run.t0, run.t1)
    result["generator"] = run.generator
    result["checks"] = checks
    return result


def main(argv, t_start: Optional[float] = None, *, cpu: bool = False,
         overrides: Optional[dict] = None) -> int:
    ctx, run = execute(argv, t_start, cpu=cpu, overrides=overrides)
    result = report(ctx, run)
    bad = forbidden_modules()
    if bad:
        print(f"refusing to report: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in run.notes:
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
