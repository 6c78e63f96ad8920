"""The port does all that the JAX package does: every public top-level
function and class of every module of ``meme_search_engine_tpu/`` has a
counterpart of the same name in the same module of
``meme_search_engine_tpu_torch/``, but for the stated map below. Both
packages' sources are read with ``ast``; neither is imported.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "meme_search_engine_tpu", ROOT / "meme_search_engine_tpu_torch"

# JAX name -> (port module, port name, why)
MAP = {
    ("ops/attention.py", "fused_mha_pallas"): (
        "ops/attention.py", "fused_mha",
        "the Pallas kernel's wrapper; the port's wrapper launches csrc/mha.cu on the card",
    ),
    ("ops/gather.py", "use_pallas_gather"): (
        "ops/gather.py", "gather_rows",
        "an opt-in switch to a Pallas gather that lost to XLA's on a TPU; the port's build "
        "takes its gathers into gather_dot and gather_gram and keeps gather_rows as the op",
    ),
}


def _public(path: pathlib.Path) -> list:
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _defined(path: pathlib.Path) -> set:
    """Names a module defines at its top level (functions, classes and
    assignments; not imports)."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return out


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py") if _public(p))


def test_the_jax_package_has_modules_to_port():
    assert len(MODULES) > 50 and "models/siglip.py" in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_port_has_each_public_name(module):
    port = PORT / module
    assert port.exists(), f"{module} has no counterpart in the port"
    have = _defined(port)
    missing = []
    for name in _public(JAX / module):
        target = MAP.get((module, name))
        if target is not None:
            assert target[1] in _defined(PORT / target[0]), target
        elif name not in have:
            missing.append(name)
    assert not missing, f"{module}: no counterpart of {missing}"


def test_the_map_names_jax_names():
    for (module, name), (_, _, why) in MAP.items():
        assert name in _public(JAX / module) and why
