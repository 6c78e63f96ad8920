"""Read and write ``.safetensors`` files with numpy alone.

The format: an 8-byte little-endian header length N, N bytes of JSON
mapping each tensor's name to its dtype, shape and ``data_offsets``
(begin and end, relative to the end of the header; an optional
``__metadata__`` entry holds strings), then the raw little-endian
buffers. The ``safetensors`` package is not needed: the file is mapped
with ``numpy.memmap`` and each tensor copied out once. BF16 buffers are
read as int16 and viewed as ``torch.bfloat16``, so no value changes.
:func:`write_safetensors` is the inverse: the tensors in name order,
each buffer right after the last, the header padded with spaces to a
multiple of 8 bytes, as the ``safetensors`` package writes them.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

__all__ = ["read_safetensors", "write_safetensors"]

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": np.int16,  # viewed as torch.bfloat16 below
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items() if k != "BF16"}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, by name, as a CPU tensor of its own."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    if raw.size < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    n = int(raw[:8].view("<u8")[0])
    if 8 + n > raw.size:
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(bytes(raw[8 : 8 + n]).decode("utf-8"))
    data = raw[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype}")
        np_dtype = np.dtype(_DTYPES[dtype]).newbyteorder("<")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np_dtype.itemsize or end > data.size:
            raise ValueError(f"{path}: tensor {name!r} has inconsistent data_offsets")
        a = np.array(data[begin:end].view(np_dtype).reshape(shape), dtype=np_dtype.newbyteorder("="))
        t = torch.from_numpy(a)
        out[name] = t.view(torch.bfloat16) if dtype == "BF16" else t
    return out


def write_safetensors(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write numpy ``arrays`` to ``path`` (any dtype of the table but bf16,
    which numpy has no type for)."""
    header: Dict[str, object] = {}
    buffers = []
    offset = 0
    for name in sorted(arrays):
        a = np.asarray(arrays[name])
        if a.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has unsupported dtype {a.dtype}")
        raw = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<")).tobytes()
        header[name] = {
            "dtype": _NAMES[a.dtype],
            "shape": list(a.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        buffers.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(np.uint64(len(blob)).astype("<u8").tobytes())
        f.write(blob)
        for raw in buffers:
            f.write(raw)
