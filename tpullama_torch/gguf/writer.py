"""GGUF v3 writer.

Emits files readable by both our reader and the reference's parser
(ggml/src/gguf.cpp:1318-1460 writer semantics): same header layout,
u64-length strings, i32 type tags, aligned data section. Used by the
quantize tool, the model saver (llama_model_save_to_file analog), test
model construction, and gguf-split.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Sequence

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_SCALAR_FMT,
    GGMLType,
    GGUFValueType,
    row_nbytes,
)
from .quants import quantize


def _infer_vtype(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, int):
        return GGUFValueType.UINT32 if 0 <= value < 2**32 else GGUFValueType.INT64
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    raise TypeError(f"gguf: cannot infer KV type for {type(value)}")


_NP_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
    np.dtype(np.bool_): GGUFValueType.BOOL,
}


class GGUFWriter:
    def __init__(self, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self.kv: list[tuple[str, GGUFValueType, Any]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []
        self._names: set[str] = set()

    # -- KV ----------------------------------------------------------------

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        if vtype is None:
            if isinstance(value, np.ndarray):
                vtype = GGUFValueType.ARRAY
            elif isinstance(value, (list, tuple)):
                vtype = GGUFValueType.ARRAY
            else:
                vtype = _infer_vtype(value)
        self.kv.append((key, vtype, value))

    def add_u32(self, key: str, value: int):
        self.kv.append((key, GGUFValueType.UINT32, int(value)))

    def add_i32(self, key: str, value: int):
        self.kv.append((key, GGUFValueType.INT32, int(value)))

    def add_f32(self, key: str, value: float):
        self.kv.append((key, GGUFValueType.FLOAT32, float(value)))

    def add_bool(self, key: str, value: bool):
        self.kv.append((key, GGUFValueType.BOOL, bool(value)))

    def add_str(self, key: str, value: str):
        self.kv.append((key, GGUFValueType.STRING, str(value)))

    def add_array(self, key: str, values: Sequence | np.ndarray):
        self.kv.append((key, GGUFValueType.ARRAY, values))

    # -- tensors -----------------------------------------------------------

    def add_tensor(
        self,
        name: str,
        data: np.ndarray,
        ggml_type: GGMLType | None = None,
        raw: np.ndarray | None = None,
    ):
        """Add a tensor. `data` is a float/int numpy array in numpy (row-major)
        shape; it is quantized to `ggml_type` (default: F32). Pass `raw`
        (uint8 block bytes) with an explicit ggml_type to store pre-quantized
        data."""
        if name in self._names:
            raise ValueError(f"gguf: duplicate tensor {name!r}")
        self._names.add(name)
        if raw is not None:
            if ggml_type is None:
                raise ValueError("gguf: raw data requires explicit ggml_type")
            shape = tuple(data.shape) if hasattr(data, "shape") else tuple(data)
            expected = (
                int(np.prod(shape[:-1], dtype=np.int64)) * row_nbytes(ggml_type, shape[-1])
                if shape
                else 0
            )
            raw_b = np.ascontiguousarray(raw, dtype=np.uint8).tobytes()
            if len(raw_b) != expected:
                raise ValueError(
                    f"gguf: tensor {name!r} raw size {len(raw_b)} != expected {expected}"
                )
            self._tensors.append((name, shape, ggml_type, raw_b))
            return
        if ggml_type is None:
            ggml_type = GGMLType.F32
        if np.issubdtype(data.dtype, np.integer) and ggml_type == GGMLType.I32:
            raw_b = np.ascontiguousarray(data, dtype="<i4").tobytes()
        else:
            raw_b = quantize(np.asarray(data, dtype=np.float32), ggml_type).tobytes()
        self._tensors.append((name, tuple(data.shape), ggml_type, raw_b))

    # -- emit --------------------------------------------------------------

    def _write_str(self, f: BinaryIO, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f: BinaryIO, vtype: GGUFValueType, value: Any):
        if vtype == GGUFValueType.STRING:
            self._write_str(f, value)
            return
        if vtype == GGUFValueType.ARRAY:
            if isinstance(value, np.ndarray):
                etype = _NP_VTYPE[value.dtype]
                f.write(struct.pack("<i", int(etype)))
                f.write(struct.pack("<Q", value.size))
                f.write(np.ascontiguousarray(value).tobytes())
            else:
                values = list(value)
                if values and isinstance(values[0], str):
                    f.write(struct.pack("<i", int(GGUFValueType.STRING)))
                    f.write(struct.pack("<Q", len(values)))
                    for s in values:
                        self._write_str(f, s)
                elif values and isinstance(values[0], float):
                    f.write(struct.pack("<i", int(GGUFValueType.FLOAT32)))
                    f.write(struct.pack("<Q", len(values)))
                    f.write(np.asarray(values, dtype="<f4").tobytes())
                else:
                    f.write(struct.pack("<i", int(GGUFValueType.INT32)))
                    f.write(struct.pack("<Q", len(values)))
                    f.write(np.asarray(values, dtype="<i4").tobytes())
            return
        f.write(struct.pack(GGUF_SCALAR_FMT[vtype], value))

    def write(self, path_or_file) -> None:
        if hasattr(path_or_file, "write"):
            self._emit(path_or_file)
        else:
            with open(path_or_file, "wb") as f:
                self._emit(f)

    def _emit(self, f: BinaryIO):
        f.write(struct.pack("<I", GGUF_MAGIC))
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<q", len(self._tensors)))
        f.write(struct.pack("<q", len(self.kv)))
        for key, vtype, value in self.kv:
            self._write_str(f, key)
            f.write(struct.pack("<i", int(vtype)))
            self._write_value(f, vtype, value)
        # tensor index; offsets are relative to the aligned data section
        offset = 0
        offsets = []
        for name, shape, ttype, raw in self._tensors:
            offsets.append(offset)
            offset += len(raw)
            pad = offset % self.alignment
            if pad:
                offset += self.alignment - pad
        for (name, shape, ttype, raw), off in zip(self._tensors, offsets):
            self._write_str(f, name)
            ne = tuple(reversed(shape))
            f.write(struct.pack("<I", len(ne)))
            for d in ne:
                f.write(struct.pack("<q", d))
            f.write(struct.pack("<i", int(ttype)))
            f.write(struct.pack("<Q", off))
        pos = f.tell()
        pad = pos % self.alignment
        if pad:
            f.write(b"\x00" * (self.alignment - pad))
        for i, (name, shape, ttype, raw) in enumerate(self._tensors):
            f.write(raw)
            end = len(raw)
            pad = end % self.alignment
            if pad:
                f.write(b"\x00" * (self.alignment - pad))
