"""The safetensors format, read and written with the standard library and torch.

The `safetensors` package is not needed (the card's machine has none). A file
is an 8-byte little-endian header length, a JSON header that maps each name to
{"dtype", "shape", "data_offsets": [begin, end]} (byte offsets into the data
that follows; an optional "__metadata__" maps strings to strings), then the
raw little-endian bytes of every tensor.

`SafetensorsFile` maps a file copy-on-write (`mmap`) and hands out each
tensor as a CPU view of those pages (`torch.frombuffer`: nothing is read
before it is used), or copied to a device one tensor at a time. `save_file`
writes tensors from any device one at a time, so a model on the card is
written without a second whole copy on the host.
"""

from __future__ import annotations

import json
import math
import mmap
import struct

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
    "I8": torch.int8, "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}


class SafetensorsFile:
    """One .safetensors file, mapped. Tensors handed out without a device
    share the mapped pages: writing into them changes this process's copy
    only, never the file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.path = path
        self.metadata = header.pop("__metadata__", None) or {}
        self._header = header
        self._data_start = 8 + n

    def keys(self) -> list[str]:
        return list(self._header)

    def get_tensor(self, name: str, device=None) -> torch.Tensor:
        info = self._header[name]
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{self.path}: {name} has dtype {info['dtype']}, which this "
                             f"reader does not handle ({', '.join(DTYPES)})")
        dtype = DTYPES[info["dtype"]]
        shape = info["shape"]
        begin, end = info["data_offsets"]
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize:
            raise ValueError(f"{self.path}: {name} holds {end - begin} bytes for shape {shape} "
                             f"of {info['dtype']}")
        offset = self._data_start + begin
        if count == 0:
            t = torch.empty(shape, dtype=dtype)
        elif offset % itemsize:  # unaligned: the view would be too, so copy the bytes
            t = torch.frombuffer(bytearray(self._map[offset:offset + end - begin]), dtype=dtype)
        else:
            t = torch.frombuffer(self._map, dtype=dtype, count=count, offset=offset)
        t = t.reshape(shape)
        return t if device is None else t.to(device)


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of the file, as CPU views of the mapped file."""
    f = SafetensorsFile(path)
    return {k: f.get_tensor(k) for k in f.keys()}


def save_file(tensors: dict[str, torch.Tensor], path: str) -> int:
    """Write `tensors` (on any devices) as one safetensors file; returns its
    size in bytes. The data are laid out by element size, largest first, so
    that each tensor starts at a multiple of its element size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name]
            if t.numel():
                f.write(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset
