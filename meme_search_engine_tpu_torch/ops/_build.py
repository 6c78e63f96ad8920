"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds rather than minutes). The
library's file name carries a hash of the flags and of every source in
``csrc/``, so an edit forces a rebuild. Builds go to ``build/kernels/``
at the repository root (listed in ``.gitignore``) and run under an
exclusive file lock, so two processes starting at once never race on a
half-written library: the second waits, then loads the first's result.

All libraries are built together, one ``nvcc`` per source started in
parallel, on the first call to :func:`library`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["library", "build_all", "check", "stream_ptr", "BUILD_DIR", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_i64 = ctypes.c_longlong

# C signature of every entry point: (library, function) -> argtypes
_SIGNATURES = {
    ("gemm", "mse_ln_matmul"): [c_ptr] * 7 + [c_int] * 9 + [c_ptr],
    ("gemm", "mse_matmul_residual"): [c_ptr] * 5 + [c_int] * 3 + [c_ptr],
    ("fat_attention", "mse_fat_attention"): (
        [c_ptr] * 4 + [c_int] * 5 + [c_i64] * 6 + [c_ptr]
    ),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # name -> nvcc's output (ptxas register report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    return "nvcc"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (if stale) and load every kernel library; returns them by name."""
    with _lock:
        if _libs:
            return _libs
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA kernels requested but torch.cuda.is_available() is False"
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = _digest()
        with open(BUILD_DIR / ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                procs = {}
                for name in _sources():
                    so = BUILD_DIR / f"lib{name}-{tag}.so"
                    if so.exists():
                        continue
                    tmp = BUILD_DIR / f".lib{name}-{tag}.{os.getpid()}.so"
                    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                    procs[name] = (
                        subprocess.Popen(
                            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True,
                        ),
                        tmp,
                        so,
                    )
                failed = []
                for name, (proc, tmp, so) in procs.items():
                    out, _ = proc.communicate()
                    build_log[name] = out
                    if proc.returncode != 0:
                        failed.append(f"{name}:\n{out}")
                        tmp.unlink(missing_ok=True)
                    else:
                        os.replace(tmp, so)
                if failed:
                    raise RuntimeError("nvcc failed for " + "\n".join(failed))
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
        for name in _sources():
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}-{tag}.so"))
            for (lname, fn), argtypes in _SIGNATURES.items():
                if lname == name:
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = c_int
            _libs[name] = lib
        return _libs


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (launch refused etc.)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed (cudaError {err})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
