"""Native (C++) host library of the loader: build on demand and ctypes
bindings. A copy of tpullama/native.py.

Compiles csrc/tpullama_native.cpp with g++ -O3 -fopenmp into csrc/build/
(listed in .gitignore), keyed by a hash of the source, and exposes threaded dequantization and
planar repacking. It is host code: no nvcc builds it and it is not one of
ops/cuda/build.py's sources. Where no compiler exists (or the library
does not load), `native_dequantize` and `native_repack` return None and
the loader keeps the numpy codecs, which give the same bytes.

The loader's `native=` keyword decides whether it is used; its default is
the TPULLAMA_NO_NATIVE environment variable (`resolve_native`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .gguf.constants import GGMLType

_SRC = Path(__file__).resolve().parent / "csrc" / "tpullama_native.cpp"
BUILD_DIR = _SRC.parent / "build"
_lock = threading.Lock()
_lib = None
_tried = False


def resolve_native(value: bool | None) -> bool:
    """Whether the loader uses the native library: `value`, else on unless
    the TPULLAMA_NO_NATIVE environment variable is set (as the JAX package
    reads it)."""
    if value is not None:
        return bool(value)
    return not os.environ.get("TPULLAMA_NO_NATIVE")


def _build() -> str | None:
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"tpullama_native_{digest}.so"
    if out.exists():
        return str(out)
    # no -march=native: the library may be built on one machine and run on
    # another of the same architecture
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-o", tmp, str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    os.replace(tmp, out)
    return str(out)


def get_lib():
    """The loaded library, built on first call; None where it cannot be."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.tpn_dequant.argtypes = [ctypes.c_int, p, p, i64]
        lib.tpn_dequant.restype = ctypes.c_int
        lib.tpn_repack.argtypes = [ctypes.c_int, p, i64, i64, p, p, p, p, p, p,
                                   ctypes.POINTER(i64)]
        lib.tpn_repack.restype = ctypes.c_int
        _lib = lib
        return _lib


_NATIVE_DEQ_TYPES = {
    GGMLType.F32, GGMLType.F16, GGMLType.BF16, GGMLType.Q4_0, GGMLType.Q4_1,
    GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0, GGMLType.MXFP4,
    GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
}

_NATIVE_REPACK_TYPES = {
    GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
    GGMLType.MXFP4, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
}


def native_dequantize(raw: np.ndarray, ggml_type: GGMLType, n_elems: int,
                      out: np.ndarray | None = None):
    """Threaded dequantize; returns None if unavailable for this type.
    `out`: a contiguous f32 array of n_elems to write into (default: a new
    one)."""
    lib = get_lib()
    if lib is None or ggml_type not in _NATIVE_DEQ_TYPES:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if out is None:
        out = np.empty(n_elems, np.float32)
    elif out.dtype != np.float32 or out.size != n_elems or not out.flags.c_contiguous:
        raise ValueError("native_dequantize: out must be a contiguous f32 array of n_elems")
    rc = lib.tpn_dequant(
        ctypes.c_int(int(ggml_type)),
        raw.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_elems),
    )
    if rc != 0:
        return None
    return out


def native_repack(raw: np.ndarray, ggml_type: GGMLType, n_rows: int, n_cols: int):
    """Threaded planar repack; returns (fields, group) or None.
    Field layout matches tpullama_torch.ops.qweights.repack exactly."""
    lib = get_lib()
    if lib is None or ggml_type not in _NATIVE_REPACK_TYPES or n_cols > 16384:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    t = ggml_type
    N, K = n_rows, n_cols
    group = 16 if t == GGMLType.Q6_K else 32
    Kg = K // group
    q4 = q1 = q2 = q8 = None
    if t == GGMLType.Q8_0:
        q8 = np.empty((N, K), np.int8)
    elif t in (GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q5_K):
        q4 = np.empty((N, K // 2), np.uint8)
        q1 = np.empty((N, K // 8), np.uint8)
    elif t == GGMLType.Q6_K:
        q4 = np.empty((N, K // 2), np.uint8)
        q2 = np.empty((N, K // 4), np.uint8)
    else:
        q4 = np.empty((N, K // 2), np.uint8)
    scale = np.empty((N, Kg), np.float32)
    minv = np.empty((N, Kg), np.float32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    group_out = ctypes.c_int64(0)
    rc = lib.tpn_repack(
        ctypes.c_int(int(t)),
        raw.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(N), ctypes.c_int64(K),
        ptr(q4), ptr(q1), ptr(q2), ptr(q8), ptr(scale), ptr(minv),
        ctypes.byref(group_out),
    )
    if rc != 0:
        return None
    fields = {}
    if t == GGMLType.Q8_0:
        fields["q8"] = q8
    elif t == GGMLType.MXFP4:
        fields["q4_lut"] = q4
    else:
        fields["q4"] = q4
        if q1 is not None:
            fields["q1"] = q1
        if q2 is not None:
            fields["q2"] = q2
    fields["scale"] = scale
    if t not in (GGMLType.Q8_0, GGMLType.MXFP4):
        fields["minv"] = minv
    return fields, int(group_out.value)
