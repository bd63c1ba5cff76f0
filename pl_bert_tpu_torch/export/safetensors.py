"""A ``.safetensors`` reader and writer of the port's own.

The format: an 8-byte little-endian header length, a JSON header that
maps each tensor's name to its ``dtype``, ``shape`` and ``data_offsets``
(begin and end in the byte buffer that follows the header) and carries
``"__metadata__"``, then the raw little-endian bytes. Transformers
refuses a file whose metadata names no format it knows, so the writer
always records ``{"format": "pt"}``. The header is padded with spaces to
a multiple of 8 bytes, as the ``safetensors`` package pads it.

Neither ``safetensors`` nor ``transformers`` is imported: the export and
the serving path need neither on the card.
"""

from __future__ import annotations

import json
import math
import os
import struct

import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}
# a header larger than this is no header (the package's own limit)
_MAX_HEADER = 100_000_000


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (CPU or not; copied to the host) to ``path``, in
    name order, with ``{"format": "pt"}`` and ``metadata`` in the header.
    The file is written under a temporary name and renamed into place."""
    header: dict = {"__metadata__": {"format": "pt", **(metadata or {})}}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of {sorted(DTYPES)}")
        raw = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
    os.replace(tmp, path)


def read(path: str) -> tuple[dict[str, torch.Tensor], dict[str, str]]:
    """``(tensors, metadata)`` of a ``.safetensors`` file, the tensors
    writable and on the CPU. Raises ``ValueError`` on a header that does
    not describe the file: a length past its end, a dtype not in
    :data:`DTYPES`, offsets that overlap, leave gaps or disagree with the
    shape."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if n > min(_MAX_HEADER, len(data) - 8):
        raise ValueError(f"{path}: header length {n} runs past the file")
    header = json.loads(data[8:8 + n])
    metadata = header.pop("__metadata__", None) or {}
    buffer = memoryview(data)[8 + n:]
    tensors, end = {}, 0
    for name, spec in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
        dtype = DTYPES.get(spec["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {spec['dtype']}, not one of "
                             f"{sorted(DTYPES)}")
        begin, stop = spec["data_offsets"]
        shape = [int(s) for s in spec["shape"]]
        count = math.prod(shape)
        if begin != end or stop - begin != count * dtype.itemsize or stop > len(buffer):
            raise ValueError(f"{path}: {name}'s offsets {spec['data_offsets']} do not "
                             f"describe a {spec['dtype']} tensor of shape {shape}")
        end = stop
        if not count:
            tensors[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(bytearray(buffer[begin:stop]), dtype=torch.uint8)
        tensors[name] = flat.view(dtype).reshape(shape)
    if end != len(buffer):
        raise ValueError(f"{path}: {len(buffer) - end} bytes after the last tensor")
    return tensors, metadata
