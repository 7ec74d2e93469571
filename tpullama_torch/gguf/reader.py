"""GGUF v3 reader.

Parses the header/KV/tensor-index of a GGUF file and exposes lazy,
zero-copy access to tensor data. Format semantics follow the reference
parser (ggml/src/gguf.cpp:391-770): magic "GGUF", u32 version, i64
n_tensors, i64 n_kv; strings are u64-length-prefixed; KV values typed by
i32 enum; tensor infos are (name, u32 n_dims, i64 ne[], i32 type, u64
offset-into-data-section); the data section starts at the first multiple
of `general.alignment` (default 32) after the index, with every tensor
offset itself aligned.

Like the fork's `gguf_init_from_buffer` (ggml/include/gguf.h:205), the
reader accepts in-memory buffers and file-like streams, not just paths —
the substrate for the memory-buffer / split-future model loading API.

Shapes: GGUF stores ggml `ne[]` order (ne[0] fastest-varying). We expose
numpy/JAX row-major shapes, i.e. reversed: a Linear(in->out) stored as
ne=[n_in, n_out] (src/llama-model.cpp:2639-2642) appears here as
shape (n_out, n_in) with rows contiguous along n_in.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Union

import numpy as np

from .constants import (
    GGML_TYPE_TRAITS,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_SCALAR_FMT,
    GGMLType,
    GGUFValueType,
    row_nbytes,
)
from .quants import dequantize

Source = Union[str, os.PathLike, bytes, bytearray, memoryview, BinaryIO]


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy order (reversed ne)
    ggml_type: GGMLType
    offset: int  # relative to data section start
    nbytes: int = field(init=False)

    def __post_init__(self):
        n_row = self.shape[-1] if self.shape else 1
        rows = 1
        for d in self.shape[:-1]:
            rows *= d
        self.nbytes = rows * row_nbytes(self.ggml_type, n_row)

    @property
    def ne(self) -> tuple[int, ...]:
        """ggml ne[] order (fastest-varying first)."""
        return tuple(reversed(self.shape))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


class _Cursor:
    """Sequential little-endian reader over a bytes-like region."""

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise EOFError(
                f"gguf: truncated file (need {n} bytes at offset {self.pos}, "
                f"have {len(self.buf) - self.pos})"
            )
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def scalar(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.read(size))[0]

    def string(self) -> str:
        n = self.scalar("<Q")
        if n > 1 << 32:
            raise ValueError(f"gguf: implausible string length {n}")
        return bytes(self.read(n)).decode("utf-8", errors="replace")


def _read_value(cur: _Cursor, vtype: GGUFValueType) -> Any:
    if vtype == GGUFValueType.STRING:
        return cur.string()
    if vtype == GGUFValueType.ARRAY:
        etype = GGUFValueType(cur.scalar("<i"))
        n = cur.scalar("<Q")
        if etype == GGUFValueType.STRING:
            return [cur.string() for _ in range(n)]
        if etype == GGUFValueType.ARRAY:
            raise ValueError("gguf: nested arrays are not allowed")
        fmt = GGUF_SCALAR_FMT[etype]
        size = struct.calcsize(fmt)
        raw = cur.read(n * size)
        arr = np.frombuffer(raw, dtype=np.dtype(fmt[1:]).newbyteorder("<"), count=n)
        return arr
    fmt = GGUF_SCALAR_FMT[vtype]
    return cur.scalar(fmt)


class GGUFReader:
    """Parsed GGUF file with lazy tensor-data access.

    The whole file stays as a single memoryview (mmap for paths); tensor
    bytes are zero-copy slices of it.
    """

    def __init__(self, source: Source):
        self._mmap = None
        self._owned_file = None
        if isinstance(source, (str, os.PathLike)):
            f = open(source, "rb")
            self._owned_file = f
            self._mmap = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            buf = memoryview(self._mmap)
        elif isinstance(source, (bytes, bytearray, memoryview)):
            buf = memoryview(source)
        elif hasattr(source, "read"):
            data = source.read()
            buf = memoryview(data)
        else:
            raise TypeError(f"gguf: unsupported source type {type(source)}")
        self.buf = buf
        self.kv: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self._parse()

    def close(self):
        self.buf = None
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                # tensor views handed out are still alive; the mapping is
                # released when they are garbage-collected
                pass
            self._mmap = None
        if self._owned_file is not None:
            self._owned_file.close()
            self._owned_file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- parsing ----------------------------------------------------------

    def _parse(self):
        cur = _Cursor(self.buf)
        magic = cur.scalar("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"gguf: invalid magic 0x{magic:08x}, expected 'GGUF'")
        self.version = cur.scalar("<I")
        if self.version == 1:
            raise ValueError("gguf: GGUFv1 is no longer supported")
        if self.version & 0xFFFF == 0:
            raise ValueError(
                f"gguf: version {self.version} is implausible — endianness mismatch?"
            )
        if self.version > 3:
            raise ValueError(f"gguf: unsupported version {self.version} (max 3)")
        n_tensors = cur.scalar("<q")
        n_kv = cur.scalar("<q")
        for _ in range(n_kv):
            key = cur.string()
            vtype = GGUFValueType(cur.scalar("<i"))
            value = _read_value(cur, vtype)
            if key in self.kv:
                raise ValueError(f"gguf: duplicate key {key!r}")
            self.kv[key] = value

        infos: list[TensorInfo] = []
        for _ in range(n_tensors):
            name = cur.string()
            n_dims = cur.scalar("<I")
            if n_dims > 4:
                raise ValueError(f"gguf: tensor {name!r} has {n_dims} dims (max 4)")
            ne = [cur.scalar("<q") for _ in range(n_dims)]
            ttype = GGMLType(cur.scalar("<i"))
            offset = cur.scalar("<Q")
            info = TensorInfo(name, tuple(reversed(ne)), ttype, offset)
            if name in self.tensors:
                raise ValueError(f"gguf: duplicate tensor name {name!r}")
            self.tensors[name] = info
            infos.append(info)

        self.alignment = int(self.kv.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        if self.alignment == 0 or (self.alignment & (self.alignment - 1)) != 0:
            raise ValueError(f"gguf: alignment {self.alignment} is not a power of 2")
        pos = cur.pos
        self.data_offset = (pos + self.alignment - 1) // self.alignment * self.alignment
        # validate offsets are monotonic and aligned, as the reference does
        expect = 0
        for info in infos:
            if info.offset != expect:
                raise ValueError(
                    f"gguf: tensor {info.name!r} has offset {info.offset}, "
                    f"expected {expect}"
                )
            pad = info.nbytes % self.alignment
            expect += info.nbytes + (self.alignment - pad if pad else 0)
        self.data_size = expect
        # the final tensor need not be padded out to the alignment at EOF;
        # tensor-less files (e.g. vocab-only) may end right at the header
        end = (infos[-1].offset + infos[-1].nbytes) if infos else -self.data_offset
        if self.data_offset + end > len(self.buf):
            raise ValueError(
                f"gguf: data section extends past end of file "
                f"({self.data_offset + end} > {len(self.buf)})"
            )

    # -- access -----------------------------------------------------------

    @property
    def architecture(self) -> str:
        return self.kv.get("general.architecture", "")

    def get_kv(self, key: str, default=None):
        return self.kv.get(key, default)

    def tensor_raw(self, name: str) -> np.ndarray:
        """Raw block bytes of a tensor (zero-copy uint8 view)."""
        info = self.tensors[name]
        start = self.data_offset + info.offset
        return np.frombuffer(self.buf, dtype=np.uint8, count=info.nbytes, offset=start)

    def tensor_f32(self, name: str) -> np.ndarray:
        """Dequantized float32 tensor in numpy (row-major) shape."""
        info = self.tensors[name]
        return dequantize(self.tensor_raw(name), info.ggml_type, info.shape)

    def __repr__(self):
        return (
            f"GGUFReader(v{self.version}, arch={self.architecture!r}, "
            f"{len(self.tensors)} tensors, {len(self.kv)} kv)"
        )
