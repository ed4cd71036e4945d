"""Minimal safetensors reader and writer on torch tensors, reading through mmap.

Counterpart of ``nunchaku_tpu/utils/safetensors.py`` (``SafeTensors``,
``load_safetensors``, ``save_safetensors``). The file is mapped copy-on-write
(nothing is written back) and each tensor is a zero-copy CPU view of its
bytes, ``BF16`` and the fp8 types included (``torch.bfloat16``,
``torch.float8_e4m3fn``, ``torch.float8_e5m2`` over the raw bytes, where the
JAX package goes through ``ml_dtypes``). Files written by either package
read back bit for bit in the other. Metadata follows nunchaku's convention:
``__metadata__`` string keys such as ``config`` and ``quantization_config``.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


class SafeTensors:
    """Lazy zero-copy view over a .safetensors file."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen))
            # copy-on-write: writable for torch.frombuffer, never written back
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata: dict[str, str] = header.pop("__metadata__", {}) or {}
        self._entries = header
        self._data_offset = 8 + hlen

    def keys(self):
        return self._entries.keys()

    def __contains__(self, name):
        return name in self._entries

    def tensor(self, name: str) -> torch.Tensor:
        """Zero-copy CPU view of one tensor."""
        e = self._entries[name]
        dt = DTYPES[e["dtype"]]
        start, end = e["data_offsets"]
        if end == start:
            return torch.empty(e["shape"], dtype=dt)
        at = self._data_offset + start
        raw = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - start, offset=at)
        if at % dt.itemsize:  # a misaligned tensor is copied once, to aligned memory
            raw = raw.clone()
        return raw.view(dt).reshape(e["shape"])

    def items(self):
        for k in self._entries:
            yield k, self.tensor(k)


def load_safetensors(path) -> tuple[dict[str, torch.Tensor], dict[str, str]]:
    st = SafeTensors(path)
    return dict(st.items()), st.metadata


def save_safetensors(path, tensors: dict[str, torch.Tensor], metadata: dict[str, str] | None = None):
    """Write a .safetensors file (little-endian, C-contiguous), one tensor
    at a time: a tensor on the card is copied to the host as it is written."""
    entries = {}
    offset = 0
    for name, t in tensors.items():
        nb = t.numel() * t.element_size()
        entries[name] = {"dtype": DTYPE_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nb]}
        offset += nb
    header: dict = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    header.update(entries)
    hjson = json.dumps(header).encode()
    hjson += b" " * ((-len(hjson)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)
