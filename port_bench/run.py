"""Run one cell of the port's benchmark once; print its result as the last line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``meme_search_engine_tpu_torch``.
It runs on the machine it is started on and needs as many CUDA devices as
the cell asks for (it exits with 2, printing no result, where there are
fewer). Caches stay inside the checkout: the port builds its kernels
into ``build/kernels/``, and CUDA's and Triton's caches go to
``build/bench_cache/``. See ``harness.py`` for what a run does.
"""

import time

T_IMPORT = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    sys.path[0] = ROOT  # the package by name, not this folder's modules
    from port_bench import harness

    start = harness.process_start()
    return harness.main(sys.argv[1:], T_IMPORT if start is None else start)


if __name__ == "__main__":
    sys.exit(main())
