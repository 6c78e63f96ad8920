"""The embedding engine in process, under a closed loop of batches.

Set-up: the weights from the seed (``data.siglip_params``) into the
port's ``EmbeddingEngine``; the mix's pool of requests
(``generate.make``); each shape the window runs, twice. The window: one
client calling the engine back to back, round the pool in a seeded order
(``generate.closed_order``), until ``--seconds`` have passed; every call
that started in the window counts, with its time. After it: the peak
memory, the engine freed, then a seeded sample of the window's rows
against the reference (``judge.py``).
"""

from __future__ import annotations

import time
from collections import Counter
from types import SimpleNamespace

from .. import data, generate, judge
from ..harness import free_device
from ..trace import DeviceTrace, Spans

__all__ = ["run"]


def run(ctx):
    import torch

    from meme_search_engine_tpu_torch.models.siglip import SigLIPConfig
    from meme_search_engine_tpu_torch.serving.engine import EmbeddingEngine

    m, dev = ctx.model, ctx.device
    engine = EmbeddingEngine(data.siglip_params(m, ctx.seed, dev), SigLIPConfig(**m),
                             max_batch=ctx.max_batch, device=dev)
    traffic = generate.make(ctx.traffic, ctx.seed, model=m, device=dev)
    terms = [generate.term(k) for k in traffic.kinds]
    feeds = [t.engine_input(x) for t, x in zip(terms, traffic.inputs)]
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
        record.append((s, time.perf_counter(), {terms[r].TOWER: len(feeds[r])}))
    t1 = record[-1][1]
    if dtrace is not None:
        dtrace.stop()
    if spans is not None:
        spans.restore()
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
    attempted = sum(sum(n.values()) for _, _, n in record)
    notes = [f"reference: {len(picks)} rows in {time.perf_counter() - t_ref:.2f} s; "
             f"{len(record)} calls, {attempted} inputs in {t1 - t0:.3f} s"]
    return SimpleNamespace(
        ctx=ctx, t0=t0, t1=t1, setup_s=t0 - ctx.t_start, calls=record, spans=spans,
        dtrace=dtrace, attempted=attempted, failed=0, unchecked=0, checks={"emb_err": err},
        memory_peak_bytes=int(peak), device_kind=kind, notes=notes,
        generator={"kind": "closed loop, 1 client, in process", "calls": len(record),
                   "kinds": dict(Counter(traffic.kinds[perm[c % len(perm)]]
                                         for c in range(len(record))))})
