"""The embedding engine in process, under a closed loop of batches of
pictures at their own sizes (SigLIP 2 NaFlex).

The loop of ``systems/engine.py`` over the mix's terms (their
``ENGINE_CALL``, ``EmbeddingEngine.embed_image_list``), with three
differences:

- each call's record holds, beside its ``img`` count, the call's valid
  patches (``patches``) and the sum of their squares (``patches_sq``),
  taken from the pictures it sends, not from the program
  (``metrics/step_mfu.naflex``, ``metrics/kernels.naflex_roofline``);
- with ``--trace 1`` it records the program's own spans
  (``utils/profiling.py``) from before the engine is built to the end of
  the window, adds them to its ``Spans`` so that the breakdown's idle
  gaps name them, and keeps them on the run as ``program``
  (``metrics/engine.pack_ms``); where a recording is on already
  (``program_trace.py``), it reads that one's spans and leaves the
  recording, and the adding to the spans, to its owner;
- a program without the NaFlex route (no ``max_num_patches`` in
  ``SigLIPConfig``, no ``embed_image_list``) is refused at once, before
  any weight is drawn: exit 2, no result.
"""

from __future__ import annotations

import sys
import time
from collections import Counter
from types import SimpleNamespace

from .. import data, generate, judge
from ..harness import free_device
from ..trace import DeviceTrace, Spans

__all__ = ["run"]

NS = 1_000_000_000


def _counts(term, inputs, patch: int) -> dict:
    s = [(x.shape[0] // patch) * (x.shape[1] // patch) for x in inputs]
    return {term.TOWER: len(inputs), "patches": sum(s), "patches_sq": sum(v * v for v in s)}


def run(ctx):
    import torch

    from meme_search_engine_tpu_torch.models.siglip import SigLIPConfig
    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

    if ("max_num_patches" not in getattr(SigLIPConfig, "__dataclass_fields__", {})
            or not hasattr(EmbeddingEngine, "embed_image_list")):
        print("this program has no SigLIP 2 NaFlex route (SigLIPConfig.max_num_patches, "
              "EmbeddingEngine.embed_image_list)", file=sys.stderr)
        raise SystemExit(2)
    from meme_search_engine_tpu_torch.utils import profiling

    own = ctx.trace and not profiling.is_recording()
    if own:
        profiling.start_recording()
    try:
        m, dev = ctx.model, ctx.device
        cfg = SigLIPConfig(**m)
        engine = EmbeddingEngine(data.siglip_params(m, ctx.seed, dev), cfg,
                                 max_batch=ctx.max_batch, device=dev)
        traffic = generate.make(ctx.traffic, ctx.seed, model=m, device=dev)
        terms = [generate.term(k) for k in traffic.kinds]
        feeds = [t.engine_input(x) for t, x in zip(terms, traffic.inputs)]
        counts = [_counts(t, x, m["patch_size"]) for t, x in zip(terms, feeds)]
        seen: set = set()
        for t, x in zip(terms, feeds):  # each shape twice: built, then steady
            if (t.ENGINE_CALL, len(x)) not in seen:
                seen.add((t.ENGINE_CALL, len(x)))
                getattr(engine, t.ENGINE_CALL)(x)
                getattr(engine, t.ENGINE_CALL)(x)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        spans = dtrace = None
        if ctx.trace:
            spans = Spans()
            for name in sorted({t.ENGINE_CALL for t in terms}):
                spans.patch(EmbeddingEngine, name, "EmbeddingEngine." + name)
            if dev.type == "cuda":
                dtrace = DeviceTrace()
                dtrace.start()
        calls = [getattr(engine, t.ENGINE_CALL) for t in terms]
        perm = generate.closed_order(len(feeds), ctx.seed)
        record, outs = [], []
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            if s >= t0 + ctx.seconds:
                break
            r = perm[len(record) % len(perm)]
            outs.append(calls[r](feeds[r]))
            record.append((s, time.perf_counter(), dict(counts[r])))
        t1 = record[-1][1]
        if dtrace is not None:
            dtrace.stop()
        if spans is not None:
            spans.restore()
    finally:
        program = profiling.stop_recording() if own else None
    if ctx.trace and not own:
        program = profiling.recorded()
    elif spans is not None:  # the breakdown's idle gaps name the program's spans too
        for p in program:
            spans.add(p.name, p.start_ns / NS, p.end_ns / NS)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    del engine, calls
    free_device()

    t_ref = time.perf_counter()
    batch = min(len(x) for x in feeds)
    picks = judge.sample_rows(len(record), batch, ctx.workload["sample"], ctx.seed)
    sent = [perm[c % len(perm)] for c, _ in picks]
    items = [(traffic.kinds[r], traffic.inputs[r][row]) for r, (_, row) in zip(sent, picks)]
    want = judge.reference_rows(ctx, items)
    err = judge.emb_err([outs[c][row] for c, row in picks], want)
    attempted = sum(c[terms[0].TOWER] for _, _, c in record)
    notes = [f"reference: {len(picks)} rows in {time.perf_counter() - t_ref:.2f} s; "
             f"{len(record)} calls, {attempted} inputs in {t1 - t0:.3f} s; "
             f"{sum(c['patches'] for _, _, c in record)} valid patches"]
    return SimpleNamespace(
        ctx=ctx, t0=t0, t1=t1, setup_s=t0 - ctx.t_start, calls=record, spans=spans,
        dtrace=dtrace, program=program, attempted=attempted, failed=0, unchecked=0,
        checks={"emb_err": err}, memory_peak_bytes=int(peak), device_kind=kind, notes=notes,
        generator={"kind": "closed loop, 1 client, in process", "calls": len(record),
                   "kinds": dict(Counter(traffic.kinds[perm[c % len(perm)]]
                                         for c in range(len(record))))})
