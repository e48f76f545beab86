"""Read and write the safetensors format, with no package but torch.

The GPU machine has no ``safetensors``, so the port keeps its own reader
and writer of the format (a file is an 8-byte little-endian header length,
a JSON header mapping each tensor's name to its ``dtype``, ``shape`` and
``data_offsets`` into the byte buffer that follows, plus an optional
``__metadata__`` map of strings, then that buffer).

:class:`SafeTensorsFile` maps a file copy-on-write and hands out each
tensor as a view of the mapping: nothing is read from disk until the
tensor's bytes are touched, so a loader that consumes one tensor at a time
holds one tensor's pages at a time (``hf_loader.iter_param_groups``'
``peak_host_bytes`` counts exactly these). bfloat16 needs no numpy type:
the bytes are viewed as ``torch.bfloat16``, bit for bit. A header whose
offsets overlap, leave a hole, run past the buffer, or disagree with a
tensor's shape, and a truncated file, raise ``ValueError`` naming the file.

:func:`save_file` writes a file that ``safetensors.safe_open`` reads
tensor for tensor (the header padded with spaces to a multiple of 8 bytes,
tensors laid out back to back in name order).
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I8": torch.int8,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# a header longer than this is not a checkpoint's (the reference reader's bound)
MAX_HEADER_BYTES = 100_000_000


class SafeTensorsFile:
    """One ``.safetensors`` file, its header checked at open; tensors are
    views of a copy-on-write mapping (writing one never reaches the
    file)."""

    def __init__(self, path: str) -> None:
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            head = fh.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: truncated safetensors file ({size} bytes, no header length)")
            (n,) = struct.unpack("<Q", head)
            if n > MAX_HEADER_BYTES or 8 + n > size:
                raise ValueError(f"{path}: header of {n} bytes does not fit the file's {size} bytes")
            raw = fh.read(n)
            try:
                header = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, ValueError) as exc:
                raise ValueError(f"{path}: header is not JSON ({exc})") from None
            if not isinstance(header, dict):
                raise ValueError(f"{path}: header is not a JSON object")
            self._meta: Dict[str, str] = header.pop("__metadata__", None) or {}
            self._start = 8 + n
            self._entries = self._check(header, size - self._start)
            self._map = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY) if size else None

    def _check(self, header: Mapping, nbytes: int) -> Dict[str, Tuple[torch.dtype, List[int], int, int]]:
        """Each entry's (dtype, shape, begin, end), validated: known dtype,
        offsets inside the buffer and equal to the shape's bytes, and the
        entries tiling the buffer with no overlap and no hole."""
        entries = {}
        for name, info in header.items():
            try:
                dtype = DTYPES[info["dtype"]]
                shape = [int(d) for d in info["shape"]]
                begin, end = (int(o) for o in info["data_offsets"])
            except (KeyError, TypeError, ValueError) as exc:
                raise ValueError(f"{self.path}: bad header entry {name!r} ({exc!r})") from None
            count = 1
            for d in shape:
                if d < 0:
                    raise ValueError(f"{self.path}: {name!r} has a negative dimension {shape}")
                count *= d
            if not 0 <= begin <= end <= nbytes:
                raise ValueError(
                    f"{self.path}: {name!r} offsets [{begin}, {end}) out of range of the "
                    f"{nbytes}-byte buffer (truncated file?)"
                )
            width = _width(dtype)
            if end - begin != count * width:
                raise ValueError(
                    f"{self.path}: {name!r} spans {end - begin} bytes, its shape {shape} "
                    f"of {info['dtype']} needs {count * width}"
                )
            entries[name] = (dtype, shape, begin, end)
        cursor = 0
        for name, (_, _, begin, end) in sorted(entries.items(), key=lambda kv: (kv[1][2], kv[1][3])):
            if begin != cursor:
                what = "overlaps the tensor before it" if begin < cursor else "leaves a hole before it"
                raise ValueError(f"{self.path}: {name!r} at offset {begin} {what} (ends at {cursor})")
            cursor = end
        if cursor != nbytes:
            raise ValueError(
                f"{self.path}: tensors end at byte {cursor} of a {nbytes}-byte buffer"
            )
        return entries

    def keys(self) -> List[str]:
        """Tensor names in the order they lie in the file."""
        return sorted(self._entries, key=lambda k: self._entries[k][2])

    def metadata(self) -> Dict[str, str]:
        return dict(self._meta)

    def get_tensor(self, name: str) -> torch.Tensor:
        """A CPU tensor viewing the tensor's bytes in the mapping."""
        dtype, shape, begin, end = self._entries[name]
        if begin == end:
            return torch.empty(shape, dtype=dtype)
        flat = torch.frombuffer(self._map, dtype=dtype, count=(end - begin) // _width(dtype),
                                offset=self._start + begin)
        return flat.view(shape)


def _width(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def iter_tensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for every tensor of one file, in file order."""
    f = SafeTensorsFile(path)
    for name in f.keys():
        yield name, f.get_tensor(name)


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (on any device) as one safetensors file, streamed
    tensor by tensor; the file appears whole under its name or not at
    all (a temporary name, then a rename)."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-(8 + len(raw)) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                fh.write(t.reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)
