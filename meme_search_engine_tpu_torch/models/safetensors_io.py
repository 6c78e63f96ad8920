"""Read a ``.safetensors`` file with numpy alone.

The format: an 8-byte little-endian header length N, N bytes of JSON
mapping each tensor's name to its dtype, shape and ``data_offsets``
(begin and end, relative to the end of the header; an optional
``__metadata__`` entry holds strings), then the raw little-endian
buffers. The ``safetensors`` package is not needed: the file is mapped
with ``numpy.memmap`` and each tensor copied out once. BF16 buffers are
read as int16 and viewed as ``torch.bfloat16``, so no value changes.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

__all__ = ["read_safetensors"]

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
