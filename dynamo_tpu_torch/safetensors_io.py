"""Reading safetensors checkpoints on the standard library (the port's
stand-in for the ``safetensors`` package that the JAX package's loader
uses).

The format: an 8-byte little-endian header length ``n``, ``n`` bytes of
JSON mapping each tensor name to ``{"dtype", "shape", "data_offsets":
[begin, end]}`` (offsets relative to the first byte after the header;
an optional ``"__metadata__"`` entry of strings), then the raw
little-endian bytes. Tensors are returned as zero-copy views of a
private (copy-on-write) ``mmap`` of the file, so reading a checkpoint
costs mapped pages of the page cache, not a second copy in memory.

The file is input from a user: the header's length, every dtype, shape
and offset pair are checked against the file before any tensor is made,
and a header that runs past the file, a tensor whose bytes lie outside
it or do not match its shape, or a dtype other than BF16, F16 and F32
raises ``ValueError`` naming what is wrong.

A checkpoint directory is read through ``model.safetensors.index.json``
when it has one (its ``weight_map`` names each tensor's shard), else
every ``*.safetensors`` file in it.
"""
from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Iterator, Mapping

import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
INDEX_FILE = "model.safetensors.index.json"
# a header larger than this is not a checkpoint's (the reference library
# caps it at 100 MB too)
MAX_HEADER_BYTES = 100 * 1024 * 1024


class SafetensorsFile(Mapping[str, torch.Tensor]):
    """One ``.safetensors`` file: ``f[name]`` is a tensor viewing the
    mapped bytes (read-only use: writes would stay private to the view)."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        if size < 8:
            raise ValueError(f"{path}: truncated safetensors file "
                             f"({size} bytes, no header length)")
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            if n > MAX_HEADER_BYTES:
                raise ValueError(f"{path}: header length {n} is implausible")
            if 8 + n > size:
                raise ValueError(f"{path}: header of {n} bytes runs past the "
                                 f"end of the file ({size} bytes)")
            raw = f.read(n)
            try:
                header = json.loads(raw)
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}: header is not JSON ({e})") from None
            if not isinstance(header, dict):
                raise ValueError(f"{path}: header is not a JSON object")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._data = 8 + n
        self.metadata = header.pop("__metadata__", None) or {}
        self._entries: dict[str, tuple[torch.dtype, tuple, int, int]] = {}
        for name, e in header.items():
            self._entries[name] = self._check(name, e, size - self._data)

    def _check(self, name: str, e, data_size: int):
        if not isinstance(e, dict):
            raise ValueError(f"{self.path}: entry {name!r} is not an object")
        dt = e.get("dtype")
        if dt not in DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{dt!r} (BF16, F16 and F32 are read)")
        shape = e.get("shape")
        offs = e.get("data_offsets")
        if (not isinstance(shape, list)
                or not all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError(f"{self.path}: tensor {name!r} has shape "
                             f"{shape!r}")
        if (not isinstance(offs, list) or len(offs) != 2
                or not all(isinstance(o, int) for o in offs)):
            raise ValueError(f"{self.path}: tensor {name!r} has "
                             f"data_offsets {offs!r}")
        begin, end = offs
        if not 0 <= begin <= end <= data_size:
            raise ValueError(
                f"{self.path}: tensor {name!r} data_offsets [{begin}, {end}] "
                f"lie outside the file's {data_size} data bytes")
        dtype = DTYPES[dt]
        nbytes = math.prod(shape) * dtype.itemsize
        if end - begin != nbytes:
            raise ValueError(
                f"{self.path}: tensor {name!r} spans {end - begin} bytes, "
                f"its shape {shape} in {dt} needs {nbytes}")
        return dtype, tuple(shape), self._data + begin, math.prod(shape)

    def __getitem__(self, name: str) -> torch.Tensor:
        dtype, shape, offset, numel = self._entries[name]
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._mm, dtype=dtype, count=numel,
                                offset=offset).view(shape)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


def checkpoint_files(model_dir: str) -> dict[str, list[str]]:
    """Shard path -> the tensor names it is asked for: the index's
    ``weight_map`` when there is one (every shard inside ``model_dir``),
    else every ``*.safetensors`` file with None (all of its tensors)."""
    index = os.path.join(model_dir, INDEX_FILE)
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f).get("weight_map")
        if not isinstance(weight_map, dict) or not weight_map:
            raise ValueError(f"{index}: no weight_map")
        shards: dict[str, list[str]] = {}
        for name, shard in weight_map.items():
            if (not isinstance(shard, str) or os.path.basename(shard) != shard
                    or not shard.endswith(".safetensors")):
                raise ValueError(f"{index}: shard {shard!r} of {name!r} is "
                                 "not a .safetensors file beside the index")
            shards.setdefault(os.path.join(model_dir, shard), []).append(name)
        return shards
    files = sorted(
        os.path.join(model_dir, n) for n in os.listdir(model_dir)
        if n.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors in {model_dir}")
    return {p: None for p in files}


class Checkpoint(Mapping[str, torch.Tensor]):
    """Every tensor of a checkpoint directory by name, each a view of its
    shard's mapping. A name found in two shards is refused."""

    def __init__(self, model_dir: str):
        self._where: dict[str, SafetensorsFile] = {}
        for path, names in checkpoint_files(model_dir).items():
            st = SafetensorsFile(path)
            for name in (st if names is None else names):
                if name not in st:
                    raise ValueError(f"{path}: the index names {name!r}, "
                                     "which the shard does not hold")
                if name in self._where:
                    raise ValueError(f"tensor {name!r} is in both "
                                     f"{self._where[name].path} and {path}")
                self._where[name] = st

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name][name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)
