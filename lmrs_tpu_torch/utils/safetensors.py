"""Reader and writer of the safetensors format, written by hand (the card's
machine has no ``safetensors`` package).

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the raw tensor bytes.  The JSON maps each tensor name to ``{"dtype",
"shape", "data_offsets": [begin, end]}`` (offsets count from the end of the
header) and may hold a ``"__metadata__"`` dict of strings.  Values are
little-endian, rows row-major.

``SafeFile`` maps a file with ``mmap`` and reads one tensor at a time
straight onto the caller's device (``torch.frombuffer`` over the map, one
copy), so a file larger than host memory streams; ``save_file`` writes one
tensor at a time.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "I8": torch.int8, "I32": torch.int32, "I64": torch.int64}
_NAMES = {dt: name for name, dt in DTYPES.items()}
_MAX_HEADER = 100 * 2**20  # the format's own cap on the header


class SafeFile:
    """One safetensors file, mapped read-only (copy-on-write: nothing is
    ever written back).  ``keys()``, ``shape(name)``, ``metadata`` and
    ``get(name, device)``; a context manager."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: not a safetensors file "
                                 "(shorter than its header length)")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise ValueError(f"{self.path}: header of {n} bytes")
            header = json.loads(f.read(n))
            size = self.path.stat().st_size
            self._base = 8 + n
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata: dict[str, str] = header.pop("__metadata__", None) or {}
        self._entries = header
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                                 f"{e['dtype']}; the reader takes "
                                 f"{sorted(DTYPES)}")
            begin, end = e["data_offsets"]
            numel = 1
            for d in e["shape"]:
                numel *= d
            want = numel * DTYPES[e["dtype"]].itemsize
            if end - begin != want or self._base + end > size:
                raise ValueError(f"{self.path}: tensor {name!r} spans bytes "
                                 f"[{begin}, {end}) of a {size - self._base}-"
                                 f"byte body; shape {e['shape']} needs {want}")

    def keys(self) -> list[str]:
        return list(self._entries)

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def get(self, name: str, device=None) -> torch.Tensor:
        """Tensor ``name`` as a new tensor on ``device`` (the CPU by
        default), sharing nothing with the map.  A missing name raises
        ``KeyError`` naming it and the file."""
        if name not in self._entries:
            raise KeyError(f"tensor {name!r} is not in {self.path}")
        e = self._entries[name]
        dt, shape = DTYPES[e["dtype"]], tuple(e["shape"])
        begin, end = e["data_offsets"]
        device = torch.device("cpu" if device is None else device)
        if end == begin:
            return torch.empty(shape, dtype=dt, device=device)
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=end - begin,
                               offset=self._base + begin)
        # one copy, off the map (and aligned, whatever the file's offsets)
        out = raw.to(device, copy=True)
        del raw
        return out.view(dt).reshape(shape)

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
            self._map = None

    def __enter__(self) -> "SafeFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_file(tensors: dict[str, torch.Tensor], path: str | Path,
              metadata: dict[str, str] | None = None) -> int:
    """Write ``tensors`` (any device; copied to the host one at a time) to
    ``path``; returns the bytes written.  Tensors go in order of element
    size, largest first, then name, so every tensor starts at a multiple of
    its element size (the header is padded to 8 bytes with spaces)."""
    header: dict = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in metadata.items()):
            raise ValueError("safetensors metadata maps strings to strings")
        header["__metadata__"] = dict(metadata)
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; the "
                             f"writer takes {sorted(_NAMES.values(), key=str)}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name]
            if t.numel():
                host = t.detach().to("cpu").contiguous().reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
    return 8 + len(blob) + offset
