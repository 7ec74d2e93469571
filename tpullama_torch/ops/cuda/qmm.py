"""Quantized matmul over planar packed weights: the CUDA kernels'
wrapper and their plain PyTorch versions.

Port of tpullama/ops/pallas/qmm.py:quantized_matmul. y = x @ W^T with W
kept packed in the planar layout of ops/qweights.py, in either stored
order ("stripe" or "fourblock"). Both orders map stored column p mod K/g
to one scale group, so the kernels do not depend on the order; the
wrapper arranges x for each route, as one PyTorch copy at most.

The route is the reference's own choice (choose_kchunks): nk > 1 valid
K-chunks send the call to the K-chunked kernel (csrc/qmm_ktiled.cu,
Pallas kernel _qmm_ktiled: the decode body of csrc/qmm_gemv.cuh over each
chunk's byte rows for T <= 8, the tensor-core body of csrc/qmm_mma.cuh on
x in stored order above), otherwise it goes to csrc/qmm.cu: qmm_gemv for
T <= 8 (the decode body), qmm_tiled above (the group-scaled tensor-core
body of csrc/qmm_group_mma.cuh). The decode body and the group body read
x in column order (`column_x`: natural order for stripe planes, so x is
read in place; one copy for fourblock planes). On a CUDA tensor the
wrapper launches that kernel or raises; on a CPU tensor it computes that
route's plain version.

Not ported: N padded to 128 rows and T padded to the tile (the kernels
mask their edges), the layer-stacked `layer=` scalar prefetch (the port
holds per-layer views), and the TPULLAMA_QMM_VMEM_FIT rule, which picks
K-chunks only to fit Mosaic's scoped-VMEM default on the TPU.
"""

from __future__ import annotations

import os

import torch

from ...gguf.constants import GGMLType
from ...gguf.quants import KVALUES_MXFP4
from ..qweights import PACKED_TYPES

# launches per kernel since the last reset (plain integers; chip_smoke.py
# reads them to show the served path went through the kernels)
LAUNCHES = {"qmm_gemv": 0, "qmm_tiled": 0, "qmm_ktiled": 0}
GEMV_MAX_T = 8

# kernel field sets: (kind id in csrc/qmm.cu, the K multiple of its quant
# blocks: Q4_0, Q4_1 and Q8_0 blocks hold 32 values, Q6_K blocks 256; a
# Q4_K matrix has K % 256 by its own blocks). The decode bodies (qmm_gemv,
# qmm_ktiled at T <= 8, one-row gathered tiles) take any such K.
_KINDS = {
    frozenset({"q4", "scale", "minv"}): (0, 32),
    frozenset({"q4", "q2", "scale", "minv"}): (1, 256),
    frozenset({"q8", "scale"}): (2, 32),
}
# The K multiple of the tensor-core routes (qmm_tiled, and qmm_ktiled and
# row-major qmm_gathered above one row): a row's scales are whole 16-byte
# runs and its byte runs start on 8-byte boundaries, which those bodies copy
# by tensor copies and cp.async. It is every K the loader packs
# (models/loader.py packs a matrix iff K % 256 == 0).
MMA_K_MULTIPLE = 256


def route(kernel: str, T: int) -> str:
    """The body a launch of `kernel` runs for T activation rows: "mma", a
    tensor-core tile body (qmm_tiled at T > 8: csrc/qmm_group_mma.cuh;
    qmm_ktiled at T > 8: csrc/qmm_mma.cuh); else "gemv", the CUDA-core
    decode body of csrc/qmm_gemv.cuh (qmm_gemv and qmm_tiled's T <= 8;
    qmm_ktiled's T <= 8 over each K-chunk's byte rows)."""
    return "mma" if kernel in ("qmm_tiled", "qmm_ktiled") and T > GEMV_MAX_T else "gemv"


def resolve_tile_k(value: int | None) -> int | None:
    """The K-chunk count a caller asked for: `value`, else the
    TPULLAMA_QMM_TILE_K environment variable, else None (the tile table)."""
    if value is not None:
        return int(value)
    env = os.environ.get("TPULLAMA_QMM_TILE_K")
    return int(env) if env is not None else None


def _table_nk(N: int, K: int) -> int:
    """nk of the (N padded to 128, K) row of the tile table, as the
    reference's _tile_cfg reads it: a TPULLAMA_QMM_TILES row
    ("N,K=tn:nk;..."), else 0. The JAX package's default rows
    (qmm.py:103-107) all hold nk = 1, which runs no K-chunks, so only the
    variable's rows can ask for them."""
    for row in os.environ.get("TPULLAMA_QMM_TILES", "").split(";"):
        row = row.strip()
        if not row:
            continue
        shp, _, cfg = row.partition("=")
        n_s, _, k_s = shp.partition(",")
        if int(n_s) == N and int(k_s) == K:
            return int(cfg.partition(":")[2])
    return 0


def kchunks_valid(nk: int, K: int, group: int, field_names) -> bool:
    """nk K-chunks are realizable iff every field's packed columns split
    evenly and each chunk covers whole tile-repeats of the scale plane
    (the reference's _kchunks_valid)."""
    if nk <= 1:
        return False
    if not (set(field_names) <= {"q4", "q4_lut", "q8", "scale", "minv"}):
        return False  # multi-stripe-width types (Q5/Q6/Q3/Q2_K) stay untiled
    stripes = 1 if "q8" in field_names else 2
    ce = K // stripes  # elements per stripe
    if ce % nk:
        return False
    ce //= nk
    return ce % (K // group) == 0 and ce % 128 == 0


def choose_kchunks(n_out: int, n_in: int, T: int, field_names, group: int,
                   order: str = "stripe", tile_k: int | None = None) -> int:
    """The K-chunk count the reference's quantized_matmul runs
    (qmm.py:206-214, 254, 258): `tile_k`, else TPULLAMA_QMM_TILE_K, else
    the tile table's row for T <= 32; the fourblock order forces 1.
    Returns nk > 1 where the K-chunked kernel runs, else 1."""
    if order == "fourblock":
        return 1
    nk = resolve_tile_k(tile_k)
    if nk is None:
        nk = _table_nk(-(-n_out // 128) * 128, n_in) if T <= 32 else 0
    return nk if kchunks_valid(nk, n_in, group, field_names) else 1


def permute_x(x: torch.Tensor, group: int, order: str = "stripe") -> torch.Tensor:
    """Natural element order -> stored order along the last axis. Stripe
    (qweights.group_permute): stored position p holds element
    (p % (K/g)) * g + p // (K/g). Fourblock (qweights.fourblock_permute):
    p = a*(K/g) + m*R + s holds element s*128 + m*g + a (R = K/128)."""
    T, K = x.shape
    if order == "fourblock":
        return (x.reshape(T, K // 128, 128 // group, group).permute(0, 3, 2, 1)
                .reshape(T, K))
    if order != "stripe":
        raise ValueError(f"permute_x: unknown stored order {order!r}")
    return x.reshape(T, K // group, group).transpose(1, 2).reshape(T, K)


def column_x(x: torch.Tensor, group: int, order: str = "stripe") -> torch.Tensor:
    """Natural element order -> the scale-column order qmm_tiled's group
    body reads: x_col[t, c*g + a] = x[t, nu(c)*g + a], nu(c) being the
    natural group of stored scale column c (c itself in stripe order;
    (c % R)*(128/g) + c // R in fourblock order, R = K/128). Stripe order
    returns x itself."""
    if order == "stripe":
        return x
    if order != "fourblock":
        raise ValueError(f"column_x: unknown stored order {order!r}")
    T, K = x.shape
    return x.reshape(T, K // 128, 128 // group, group).transpose(1, 2).reshape(T, K)


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
                           group: int, n_out: int, n_in: int,
                           order: str = "stripe") -> torch.Tensor:
    """Plain version: exact f32 dequantization of the whole matrix and an
    f32 matmul against the permuted activations (the reference's exact
    mode). x: (T, n_in). Returns (T, n_out) f32."""
    if ggml_type not in PACKED_TYPES:
        raise NotImplementedError(f"quantized_matmul: {ggml_type.name}")
    w = dequant_stored(fields, ggml_type, group)
    return permute_x(x.float(), group, order) @ w.T


def quantized_matmul_ktiled_plain(x: torch.Tensor, fields: dict, ggml_type: GGMLType,
                                  group: int, n_out: int, n_in: int,
                                  nk: int) -> torch.Tensor:
    """Plain version of the K-chunked product (stripe order): the same
    exact f32 weights, K split as the reference's _qmm_ktiled splits it
    (chunk k holds stored elements [k*ce, (k+1)*ce) of each stripe, ce =
    K/stripes/nk), the nk chunk products summed in chunk order. Returns
    (T, n_out) f32."""
    if ggml_type not in PACKED_TYPES:
        raise NotImplementedError(f"quantized_matmul: {ggml_type.name}")
    T, K = x.shape
    stripes = 1 if "q8" in fields else 2
    ce = K // stripes // nk
    w = dequant_stored(fields, ggml_type, group).reshape(n_out, stripes, nk, ce)
    xp = permute_x(x.float(), group).reshape(T, stripes, nk, ce)
    y = None
    for k in range(nk):
        part = xp[:, :, k].reshape(T, -1) @ w[:, :, k].reshape(n_out, -1).T
        y = part if y is None else y + part
    return y


def quantized_matmul(x: torch.Tensor, fields: dict, ggml_type: GGMLType,
                     group: int, n_out: int, n_in: int, order: str = "stripe",
                     tile_k: int | None = None) -> torch.Tensor:
    """y = x @ W^T with W packed in `order`. x: (T, n_in) f32 or bf16.
    Returns (T, n_out) f32. `tile_k` is the reference's tile_k_chunks (see
    choose_kchunks). CUDA tensors launch the route's kernel (or raise); CPU
    tensors take its plain version."""
    T, K = x.shape
    nk = choose_kchunks(n_out, n_in, T, fields, group, order, tile_k)
    if x.device.type == "cpu":
        if nk > 1:
            return quantized_matmul_ktiled_plain(x, fields, ggml_type, group, n_out, n_in, nk)
        return quantized_matmul_plain(x, fields, ggml_type, group, n_out, n_in, order)
    if x.device.type != "cuda":
        raise RuntimeError(f"quantized_matmul: unsupported device {x.device}")
    from .build import check, library, ptr, stream

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
    sdt = fields["scale"].dtype
    if sdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantized_matmul: scale dtype {sdt} (f32 or bf16)")
    if T > GEMV_MAX_T:
        k_mult = MMA_K_MULTIPLE
    if K % k_mult:
        raise ValueError(f"quantized_matmul kernel: K={K} must be a multiple of {k_mult}"
                         f" at T={T}")
    bits = {"q4": 4, "q2": 2, "q8": 8}
    for name, a in fields.items():
        want = (N, K // group) if name in ("scale", "minv") else (N, K * bits[name] // 8)
        if a.device != x.device or tuple(a.shape) != want or not a.is_contiguous():
            raise ValueError(
                f"quantized_matmul: field {name} {tuple(a.shape)} on {a.device} "
                f"(contiguous={a.is_contiguous()}); want {want} on {x.device}")
        if name in ("scale", "minv") and a.dtype != sdt:
            raise TypeError("quantized_matmul: scale and minv dtypes differ")
    y = torch.empty((T, N), dtype=torch.float32, device=x.device)
    qa = fields["q8"] if kind == 2 else fields["q4"]
    qb = fields.get("q2")
    x_bf16, s_bf16 = int(x.dtype == torch.bfloat16), int(sdt == torch.bfloat16)
    lib = library()
    if nk > 1:
        # per-chunk partial products, summed in chunk order by the kernel's
        # second pass (no float atomics: the sum does not depend on timing).
        # T <= 8: the decode body reads x in place in column order (natural
        # for the stripe planes K-chunks run on); above, the permutation
        # copies x (K/group > 1), so the mma route may split f32 xp in place
        if T <= GEMV_MAX_T:
            xp = column_x(x, group, order).contiguous()
            if xp.data_ptr() % 16:
                xp = xp.clone()  # the body's 16-byte loads
        else:
            xp = permute_x(x, group, order).contiguous()
        ws = torch.empty((nk, T, N), dtype=torch.float32, device=x.device)
        check(lib.tpl_qmm_ktiled(kind, x_bf16, s_bf16, ptr(xp), ptr(qa), ptr(fields["scale"]),
                                 ptr(fields.get("minv")), ptr(ws), ptr(y), T, N, K, nk,
                                 stream()), "qmm_ktiled")
        LAUNCHES["qmm_ktiled"] += 1
        return y
    if T <= GEMV_MAX_T:
        xc = column_x(x, group, order).contiguous()
        if xc.data_ptr() % 16:
            xc = xc.clone()  # the kernel's 16-byte loads
        check(lib.tpl_qmm_gemv(kind, x_bf16, s_bf16, ptr(xc), ptr(qa), ptr(qb),
                               ptr(fields["scale"]), ptr(fields.get("minv")), ptr(y), T, N, K,
                               stream()), "qmm_gemv")
        LAUNCHES["qmm_gemv"] += 1
        return y
    xc = column_x(x, group, order).contiguous()
    if x_bf16 == 0 and xc.data_ptr() == x.data_ptr():
        xc = xc.clone()  # the kernel splits f32 x in place: never the caller's tensor
    # xgsum's bf16 hi and lo planes for the min term (Q8_0 has none)
    xg = (torch.empty((2, T, K // group), dtype=torch.bfloat16, device=x.device)
          if "minv" in fields else None)
    check(lib.tpl_qmm_tiled(kind, x_bf16, s_bf16, ptr(xc), ptr(qa), ptr(qb),
                            ptr(fields["scale"]), ptr(fields.get("minv")), ptr(xg), ptr(y), T,
                            N, K, stream()), "qmm_tiled")
    LAUNCHES["qmm_tiled"] += 1
    return y
