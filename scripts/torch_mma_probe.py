#!/usr/bin/env python3
"""Where the time of the port's tensor-core qmm routes goes, on one CUDA card.

    python3 scripts/torch_mma_probe.py

Builds copies of qmm.cu, qmm_gathered.cu and qmm_ktiled.cu (from
tpullama_torch/csrc) in which phases of the tile body's slice loop
(`mma_tile` in qmm_mma.cuh) are removed, and times each copy at the served
shapes of chip_smoke.py's kernels phase: qmm_gathered over Mixtral's
[gate | up] (28672 x 4096 x 8 experts, bf16 scales) at 2048 and 512 slots
and over 320-row experts at 512 slots, and qmm_ktiled over ChatGLM3-6B's
attn_qkv (4608 x 4096, T = 256, nk = 4). Variants:
  full      the kernels as they are
  nomma     without the products (copies and dequantization)
  nosplit   without the dequantization (copies and products)
  nocopy    without the loop's copies (dequantization and products)
  mma_only  products only
  empty     the loop's barriers alone
A variant's outputs are wrong by construction; only its time means
anything. Prints the card's name and power limit (nvidia-smi) and one
line per (variant, shape) with three timed rounds (ms, CUDA events, L2
flushed before each launch).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MMA1 = "    mma_steps<KIND, XLO, ST, BN, 0, 2>(smem, sl & 1, sl % MMA_XBUF, j0, j1, acc);\n"
MMA2 = "    mma_steps<KIND, XLO, ST, BN, 2, MMA_BK / 16>(smem, sl & 1, sl % MMA_XBUF, j0, j1, acc);\n"
SPLIT = ("    if (wt && sl + 1 < n) split_w(sl + 1);\n", "")
COPY_W = ("    copy_w(sl + 3);  // GW, into the stage just consumed\n", "    cp_async_commit();\n")
COPY_X = ("    copy_x(sl + 2);  // GX\n", "    cp_async_commit();\n")
VARIANTS = {
    "full": [],
    "nomma": [(MMA1, ""), (MMA2, "")],
    "nosplit": [SPLIT],
    "nocopy": [COPY_W, COPY_X],
    "mma_only": [SPLIT, COPY_W, COPY_X],
    "empty": [(MMA1, ""), (MMA2, ""), SPLIT, COPY_W, COPY_X],
}
SOURCES = ("qmm.cu", "qmm_gathered.cu", "qmm_ktiled.cu")


def start_build(name: str, patches: list, root: str):
    """Patch a copy of the sources and start its nvcc processes."""
    from tpullama_torch.ops.cuda import build

    d = os.path.join(root, name)
    os.makedirs(d)
    for f in os.listdir(build.CSRC):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(build.CSRC / f, d)
    path = os.path.join(d, "qmm_mma.cuh")
    with open(path) as f:
        text = f.read()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"{name}: qmm_mma.cuh no longer holds {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    flags = [a for a in build.NVCC_FLAGS if a not in ("-Xptxas", "-v")]
    return d, [subprocess.Popen([build._nvcc(), *flags, "-c", os.path.join(d, s), "-o",
                                 os.path.join(d, s + ".o")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
               for s in SOURCES]


def load(d: str) -> ctypes.CDLL:
    from tpullama_torch.ops.cuda import build

    so = os.path.join(d, "lib.so")
    subprocess.run([build._nvcc(), "-shared", "-o", so,
                    *[os.path.join(d, s + ".o") for s in SOURCES]], check=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpl_qmm_ktiled.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, i, p]
    lib.tpl_qmm_gathered.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.tpl_error_string.argtypes = [i]
    lib.tpl_error_string.restype = ctypes.c_char_p
    return lib


def shapes(device):
    import torch

    import chip_smoke as cs
    from tpullama_torch.gguf import GGMLType
    from tpullama_torch.ops.cuda import qmm, qmm_gathered
    from tpullama_torch.ops.moe import moe_dispatch

    gen = torch.Generator(device=device).manual_seed(0)
    Q4, bf16, E, K = GGMLType.Q4_K, torch.bfloat16, 8, 4096
    out = []
    for N, S in ((2 * 14336, 2048), (2 * 14336, 512), (320, 512)):
        R = -(-N // 128) * 128
        f = cs.random_planes(Q4, E * R, K, bf16, gen, device)
        f = {k: v.reshape(E, R, -1) for k, v in f.items()}
        sel = torch.rand((S // 2, E), generator=gen, device=device).argsort(-1)[:, :2]
        perm, tiles, _, _ = moe_dispatch(sel.reshape(S).int(), E, 8)
        xs = torch.randn((S, K), generator=gen, device=device)
        x = torch.cat([xs, xs.new_zeros((1, K))])[perm]
        out.append((f"qmm_gathered N={N} slots={S}",
                    lambda x=x, f=f, t=tiles, N=N: qmm_gathered.quantized_matmul_gathered(
                        x, f, t, Q4, 32, N, K, tile_t=8)))
    f = cs.random_planes(Q4, 4608, K, bf16, gen, device)
    x = torch.randn((256, K), generator=gen, device=device).to(bf16)
    out.append(("qmm_ktiled N=4608 T=256 nk=4",
                lambda: qmm.quantized_matmul(x, f, Q4, 32, 4608, K, tile_k=4)))
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpullama_torch.ops.cuda import build

    if not torch.cuda.is_available():
        print("torch_mma_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        built = {n: start_build(n, p, root) for n, p in VARIANTS.items()}
        for n, (_d, procs) in built.items():
            for proc in procs:
                log, _ = proc.communicate()
                if proc.returncode:
                    print(f"{n}: nvcc failed\n{log}", file=sys.stderr)
                    return 1
        timer = cs.Timer(device)
        cases = shapes(device)
        times: dict = {}
        for _round in range(3):
            for n, (d, _procs) in built.items():
                lib = load(d)
                build.library = lambda lib=lib: lib  # the wrappers launch this copy
                for name, fn in cases:
                    times.setdefault((n, name), []).append(timer.ms(fn, 10))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for (n, name), t in times.items():
        print(f"{n:9s} {name:30s} " + " ".join(f"{v:.4f}" for v in t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
