"""Build and load the port's CUDA kernels.

The sources in tpullama_torch/csrc/ are compiled with nvcc for sm_90a
(one nvcc process per source, all started together), linked into one
shared library with a plain C interface, and loaded with ctypes. Nothing
is built when the package is imported: the first kernel launch calls
`library()`, which builds into tpullama_torch/csrc/build/ (listed in
.gitignore) unless a library built from the same sources and flags is
already there. Each C entry point returns cudaGetLastError(); `check`
turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("qmm.cu", "qmm_ktiled.cu", "qmm_gathered.cu", "flash_attention.cu",
           "flash_decode.cu", "fused_layer.cu")
HEADERS = ("qmm_dequant.cuh", "qmm_gemv.cuh", "qmm_mma.cuh", "qmm_group_mma.cuh",
           "attn_tile.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# wall seconds the last build took in this process (0.0 when the library
# was already built)
build_seconds = 0.0
# nvcc's -Xptxas -v report per source (registers, shared memory, spills)
ptxas_report: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of tpullama_torch are built from "
        "tpullama_torch/csrc on first use and need the CUDA toolkit"
    )


def _build(out: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, _obj, p in procs:
            log, _ = p.communicate()
            ptxas_report[src] = log
            if p.returncode != 0:
                failed.append(f"nvcc {src} (exit {p.returncode}):\n{log}")
        if failed:
            raise RuntimeError("kernel build failed\n" + "\n".join(failed))
        so_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so_tmp), *[str(o) for _s, o, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"kernel link failed:\n{link.stdout}")
        os.replace(so_tmp, out)
    build_seconds = time.perf_counter() - t0


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"libtpullama_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path = _library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpl_qmm_gemv.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, p]
    lib.tpl_qmm_gemv.restype = i
    lib.tpl_qmm_tiled.argtypes = [i, i, i, p, p, p, p, p, p, p, i, i, i, p]
    lib.tpl_qmm_tiled.restype = i
    lib.tpl_qmm_ktiled.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, i, p]
    lib.tpl_qmm_ktiled.restype = i
    lib.tpl_fused_postattn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, f, p]
    lib.tpl_fused_postattn.restype = i
    lib.tpl_qmm_gathered.argtypes = [i, i, i, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.tpl_qmm_gathered.restype = i
    lib.tpl_qmm_gathered_t.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.tpl_qmm_gathered_t.restype = i
    lib.tpl_flash_decode.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p,
                                     i, i, i, i, i, i, f, f, p]
    lib.tpl_flash_decode.restype = i
    lib.tpl_flash_attention.argtypes = [i, i, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, f, f, p]
    lib.tpl_flash_attention.restype = i
    lib.tpl_error_string.argtypes = [i]
    lib.tpl_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a tpl_* entry point returned a CUDA error code."""
    if code != 0:
        msg = library().tpl_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for an absent optional input)."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
