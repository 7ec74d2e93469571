"""Quantized matmul over planar packed weights: the CUDA kernel's wrapper
and its plain PyTorch version.

Port of tpullama/ops/pallas/qmm.py:quantized_matmul. y = x @ W^T with W
kept packed in the planar layout of ops/qweights.py. On a CUDA tensor the
wrapper launches csrc/qmm.cu (qmm_gemv for T <= 8, qmm_tiled above); on a
CPU tensor it computes the plain version. The group permutation of x into
the stored element order (qweights.group_permute) runs here in the
wrapper, as one PyTorch copy, for both.

Not ported, because only the TPU needed them: N padded to 128 rows, T
padded to the tile, the layer-stacked `layer=` scalar prefetch, the
K-chunked grid and the fourblock order.
"""

from __future__ import annotations

import torch

from ...gguf.constants import GGMLType
from ...gguf.quants import KVALUES_MXFP4
from ..qweights import PACKED_TYPES

# launches per kernel since the last reset (plain integers; chip_smoke.py
# reads them to show the served path went through the kernels)
LAUNCHES = {"qmm_gemv": 0, "qmm_tiled": 0}
GEMV_MAX_T = 8

# kernel field sets: (kind id in csrc/qmm.cu, required K multiple)
_KINDS = {
    frozenset({"q4", "scale", "minv"}): (0, 512),
    frozenset({"q4", "q2", "scale", "minv"}): (1, 256),
    frozenset({"q8", "scale"}): (2, 1024),
}


def permute_x(x: torch.Tensor, group: int) -> torch.Tensor:
    """Natural element order -> stored order (qweights.group_permute) along
    the last axis: stored position p holds element (p % (K/g)) * g + p // (K/g)."""
    T, K = x.shape
    return x.reshape(T, K // group, group).transpose(1, 2).reshape(T, K)


def _unpack(plane: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of qweights._stripe_pack: (N, K*bits/8) uint8 -> (N, K) int32
    in stored order."""
    p = plane.to(torch.int32)
    mask = (1 << bits) - 1
    return torch.cat([(p >> (bits * j)) & mask for j in range(8 // bits)], dim=-1)


def dequant_stored(fields: dict, ggml_type: GGMLType, group: int) -> torch.Tensor:
    """Exact f32 dequantization of planar fields, in STORED element order
    (N, K): value * tile(scale) - tile(minv), the arithmetic of
    qweights.dequant_planar_np before its unpermute."""
    f = fields

    def tile(plane):
        return plane.float().repeat(1, group)

    if "q8" in f:
        return f["q8"].view(torch.int8).float() * tile(f["scale"])
    if "q4_lut" in f:
        lut = torch.from_numpy(KVALUES_MXFP4).to(f["q4_lut"].device, torch.float32)
        return lut[_unpack(f["q4_lut"], 4)] * tile(f["scale"])
    val = None
    if "q4" in f:
        val = _unpack(f["q4"], 4)
    if "q2" in f:
        q2 = _unpack(f["q2"], 2)
        val = q2 if val is None else (val | (q2 << 4))
    if "q1" in f:
        shift = 4 if ggml_type in (GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q5_K) else 2
        val = val | (_unpack(f["q1"], 1) << shift)
    out = val.float() * tile(f["scale"])
    if "minv" in f:
        out = out - tile(f["minv"])
    return out


def quantized_matmul_plain(x: torch.Tensor, fields: dict, ggml_type: GGMLType,
                           group: int, n_out: int, n_in: int) -> torch.Tensor:
    """Plain version: exact f32 dequantization of the whole matrix and an
    f32 matmul against the permuted activations (the reference's exact
    mode). x: (T, n_in). Returns (T, n_out) f32."""
    if ggml_type not in PACKED_TYPES:
        raise NotImplementedError(f"quantized_matmul: {ggml_type.name}")
    w = dequant_stored(fields, ggml_type, group)
    return permute_x(x.float(), group) @ w.T


def quantized_matmul(x: torch.Tensor, fields: dict, ggml_type: GGMLType,
                     group: int, n_out: int, n_in: int) -> torch.Tensor:
    """y = x @ W^T with W packed. x: (T, n_in) f32 or bf16. Returns (T,
    n_out) f32. CUDA tensors launch the kernel (or raise); CPU tensors take
    the plain version."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, fields, ggml_type, group, n_out, n_in)
    if x.device.type != "cuda":
        raise RuntimeError(f"quantized_matmul: unsupported device {x.device}")
    from .build import check, library, ptr, stream

    T, K = x.shape
    N = n_out
    if K != n_in:
        raise ValueError(f"quantized_matmul: x has {K} columns, weight has {n_in}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantized_matmul: x dtype {x.dtype} (f32 or bf16)")
    kind_k = _KINDS.get(frozenset(fields))
    if kind_k is None:
        raise NotImplementedError(
            f"quantized_matmul kernel: {ggml_type.name} fields {sorted(fields)} "
            "are not covered yet (Q4_0/Q4_1/Q4_K, Q6_K and Q8_0 are)")
    kind, k_mult = kind_k
    if K % k_mult:
        raise ValueError(f"quantized_matmul kernel: K={K} must be a multiple of {k_mult}")
    sdt = fields["scale"].dtype
    if sdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantized_matmul: scale dtype {sdt} (f32 or bf16)")
    bits = {"q4": 4, "q2": 2, "q8": 8}
    for name, a in fields.items():
        want = (N, K // group) if name in ("scale", "minv") else (N, K * bits[name] // 8)
        if a.device != x.device or tuple(a.shape) != want or not a.is_contiguous():
            raise ValueError(
                f"quantized_matmul: field {name} {tuple(a.shape)} on {a.device} "
                f"(contiguous={a.is_contiguous()}); want {want} on {x.device}")
        if name in ("scale", "minv") and a.dtype != sdt:
            raise TypeError("quantized_matmul: scale and minv dtypes differ")
    xp = permute_x(x, group).contiguous()
    y = torch.empty((T, N), dtype=torch.float32, device=x.device)
    qa = fields["q8"] if kind == 2 else fields["q4"]
    qb = fields.get("q2")
    lib = library()
    gemv = T <= GEMV_MAX_T
    fn = lib.tpl_qmm_gemv if gemv else lib.tpl_qmm_tiled
    check(fn(kind, int(x.dtype == torch.bfloat16), int(sdt == torch.bfloat16),
             ptr(xp), ptr(qa), ptr(qb), ptr(fields["scale"]), ptr(fields.get("minv")),
             ptr(y), T, N, K, stream()), "qmm")
    LAUNCHES["qmm_gemv" if gemv else "qmm_tiled"] += 1
    return y
