"""PyTorch + CUDA port of the meme search engine for NVIDIA Hopper (sm_90a).

The JAX package ``meme_search_engine_tpu`` is the reference this port is
held against; nothing here imports it or JAX. Modules mirror its layout
(``ops/``, ``models/``, ``serving/``, ``utils/``) so each counterpart is
easy to find. Kernels are hand-written CUDA under ``ops/csrc/``, built by
``nvcc`` at first use (``ops/_build.py``).
"""
