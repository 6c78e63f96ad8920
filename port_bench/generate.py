"""The one traffic generator: a mix's data file in, a cell's requests out.

A mix is ``traffic/<name>.json``. It says how requests come and what each
one carries; the code of each kind of term and of each arrival process
sits in a file of its own, found by its name, so a mix made of kinds that
exist is a data file alone, and a new kind is one new file:

- ``terms``: a list of ``{"kind": K, "weight": w, "batch": b, ...}``. A
  request carries ``b`` inputs of one term; the terms' weights are the
  shares of requests (the same multiset of kinds for every seed, in an
  order the mix fixes). ``terms/<K>.py`` draws the inputs from the seed
  (:func:`term`).
- ``loop``: ``"closed"``: a client calling back to back on a pool of
  ``pool`` requests, round and round in an order drawn from the seed
  (:func:`closed_order`); ``"open"``: the requests come at due
  times that ``arrivals/<process>.py`` works out from ``arrivals`` and
  the cell's ``rate_per_s`` (the same for every seed).

Every system takes the same :func:`make` result and branches on no kind:
what a kind needs (the engine's call, its wire form, its reference) is
in its own file.
"""

from __future__ import annotations

import importlib.util
import os
from types import ModuleType, SimpleNamespace
from typing import Dict, Optional

import numpy as np

from .data import sub_seed

__all__ = ["plugin", "term", "allot", "make", "closed_order"]

HERE = os.path.dirname(os.path.abspath(__file__))
_loaded: Dict[tuple, ModuleType] = {}


def plugin(folder: str, name: str) -> ModuleType:
    """``port_bench/<folder>/<name>.py``, loaded once."""
    key = (folder, name)
    if key not in _loaded:
        path = os.path.join(HERE, folder, name + ".py")
        if not os.path.isfile(path):
            raise SystemExit(f"no {folder} file {name!r} (port_bench/{folder}/)")
        spec = importlib.util.spec_from_file_location(
            f"port_bench_{folder}_{name}".replace("-", "_").replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]


def term(kind: str) -> ModuleType:
    """The code of one kind of term: ``terms/<kind>.py``."""
    return plugin("terms", kind)


def allot(weights: Dict[str, float], n: int) -> np.ndarray:
    """n values in the proportions of ``weights`` (the keys, as numbers)
    by largest remainder: the same multiset for every seed."""
    keys = list(weights)
    w = np.asarray([weights[k] for k in keys], float)
    exact = w / w.sum() * n
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return np.repeat(np.asarray([float(k) for k in keys]), counts)


def make(mix: dict, seed: int, *, model: dict, device, rate: Optional[float] = None,
         seconds: Optional[float] = None) -> SimpleNamespace:
    """The cell's requests: ``kinds[i]`` and ``inputs[i]`` (a batch of the
    term's inputs) of request i, and ``due`` (offsets in s, open loop) or
    None (closed loop, where the requests are the pool)."""
    specs = mix["terms"]
    if mix["loop"] == "closed":
        due = None
        n = int(mix["pool"])
    else:
        arrivals = mix["arrivals"]
        due = plugin("arrivals", arrivals["process"]).due(arrivals, rate, seconds)
        n = len(due)
    which = allot({str(j): s["weight"] for j, s in enumerate(specs)}, n).astype(int)
    which = np.random.default_rng(int(mix["order_seed"])).permutation(which)
    inputs: list = [None] * n
    for j, spec in enumerate(specs):
        mine = np.flatnonzero(which == j)
        if not len(mine):
            continue
        b = int(spec["batch"])
        drawn = term(spec["kind"]).draw(spec, len(mine) * b, sub_seed(seed, f"term-{j}"),
                                        model, device)
        for r, i in enumerate(mine):
            inputs[i] = drawn[r * b:(r + 1) * b]
    return SimpleNamespace(kinds=[specs[j]["kind"] for j in which], inputs=inputs, due=due)


def closed_order(n_pool: int, seed: int) -> np.ndarray:
    """The pool's requests in the order a closed loop sends them: call i
    sends request ``order[i % n_pool]`` of a permutation the seed draws."""
    return np.random.default_rng(sub_seed(seed, "closed-order")).permutation(n_pool)
