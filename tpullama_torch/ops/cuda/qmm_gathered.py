"""Gathered quantized matmul for MoE experts: the CUDA kernels' wrappers
and their plain PyTorch versions.

Port of tpullama/ops/pallas/qmm.py:quantized_matmul_gathered and
_qmm_gathered_t. y[t*tt:(t+1)*tt] = x[t*tt:(t+1)*tt] @ W[sel[t]]^T: each
tile of `tile_t` rows shares one expert, sel holds it per tile. The expert
planes are one layer's stack, row-major (M, R, kcols) or, with
planes_t=True, transposed (M, kcols, R) with the scale/minv group rows
padded to 16 (qweights.transpose_planes); R >= n_out is the stored rows
per expert. On a CUDA tensor the wrapper launches csrc/qmm_gathered.cu
(qmm_gathered or qmm_gathered_t) and leaves sel on the card; on a CPU
tensor it computes the plain version.

Routes (`route`): row-major one-row tiles run the decode body of
csrc/qmm_gemv.cuh over runs of tiles that share an expert (`run_plan`),
each expert's rows read once per run, x (f32 or bf16) read in place in
natural order; row-major tiles of more than one row run the tensor-core
body of csrc/qmm_mma.cuh on x in stored order (the group permutation runs
here, as one PyTorch copy). The transposed kernel takes f32 x in natural
order and sums its groups for the hoisted min term itself: one-row tiles
run the decode body's arithmetic on the transposed planes over the same
runs, each expert's rows read once per run, its columns split over blocks
whose parts meet in a workspace (`t_splits`), larger tiles the
group-scaled body of csrc/qmm_group_mma.cuh. Outputs are batch-invariant
within a route, but the one-row and tile routes sum in other orders.

Not ported: the expert-parallel 4-D planes (L, E_local, R, kcols), the
N tiling and padding, and the bf16 fast mode (the kernels compute the
exact f32 mode).
"""

from __future__ import annotations

import torch

from ...gguf.constants import GGMLType
from .qmm import _KINDS, MMA_K_MULTIPLE, dequant_stored, permute_x

# launches per kernel since the last reset (chip_smoke.py reads them)
LAUNCHES = {"qmm_gathered": 0, "qmm_gathered_t": 0}
MAX_TILE_T = 8
# one-row tiles of one expert that both one-row kernels give one pass over
# its rows (GATHER_RUN in csrc/qmm_gathered.cu)
RUN_CAP = 4
# scale columns of one block of the transposed one-row kernel (GT_COLS in
# csrc/qmm_gathered.cu): its column splits, each a part of every output
T_SPLIT_COLS = 32

# field sets of the transposed kernel: kind id in csrc/qmm_gathered.cu
_KINDS_T = {frozenset({"q4", "scale", "minv"}): 0, frozenset({"q8", "scale"}): 2}
_BITS = {"q4": 4, "q2": 2, "q8": 8}
# field sets the JAX package may store transposed (one stripe width)
PLANES_T_FIELDS = {"q4", "q4_lut", "q4a", "q1r", "q8", "scale", "minv"}


def route(tile_t: int, planes_t: bool = False) -> str:
    """The body a launch runs: "mma", a tensor-core route for tiles of more
    than one row (row-major planes: csrc/qmm_mma.cuh; transposed planes:
    csrc/qmm_group_mma.cuh), else "gemv", a CUDA-core decode body for
    one-row tiles over runs of tiles that share an expert (`run_plan`),
    each expert's rows read once per run (row-major planes: the decode body
    of csrc/qmm_gemv.cuh; transposed planes: its unpacking and fold on a
    thread mapping for R-contiguous planes, qmm_gathered_t_gemv_kernel)."""
    return "mma" if tile_t > 1 else "gemv"


def t_splits(K: int) -> int:
    """Column splits of the transposed one-row kernel at width K: blocks
    of T_SPLIT_COLS scale columns each, whose parts the kernel's second pass
    sums in split order."""
    return -(-(K // 32) // T_SPLIT_COLS)


def run_plan(sel) -> list[list[int]]:
    """The runs both one-row kernels compute, as their blocks find them on
    the card: tile t starts a run iff its rank among the tiles of
    its expert sel[t], in tile order, is a multiple of RUN_CAP; the run is
    that tile and the next tiles of the same expert, at most RUN_CAP in
    all. Every tile lies in exactly one run, any sel, sorted or not."""
    sel = [int(e) for e in sel]
    plan, seen = [], {}
    for t, e in enumerate(sel):
        rank = seen.get(e, 0)
        seen[e] = rank + 1
        if rank % RUN_CAP == 0:
            plan.append([u for u in range(t, len(sel)) if sel[u] == e][:RUN_CAP])
    return plan


def _check_shapes(x, sel, tile_t, n_in, fields, planes_t):
    rows, K = x.shape
    if K != n_in:
        raise ValueError(f"gathered qmm: x has {K} columns, weight has {n_in}")
    if tile_t < 1 or rows % tile_t or tuple(sel.shape) != (rows // tile_t,):
        raise ValueError(f"gathered qmm: {rows} rows, tile_t={tile_t}, sel {tuple(sel.shape)}")
    if planes_t and not set(fields) <= PLANES_T_FIELDS:
        raise ValueError(f"gathered qmm: field set {sorted(fields)} is never stored transposed")
    if "q4a" in fields:
        raise NotImplementedError("gathered qmm: the A/r re-coded MXFP4 planes are not ported")


def quantized_matmul_gathered_plain(x, fields, sel, ggml_type: GGMLType, group: int,
                                    n_out: int, n_in: int, tile_t: int = 1,
                                    planes_t: bool = False) -> torch.Tensor:
    """Plain version: exact f32 dequantization of each selected expert
    once, then one f32 product per tile of `tile_t` rows, as the
    reference's grid runs one tile per step (qmm.py:727): a row's output
    depends on its own tile alone, never on how many other tiles or rows
    the call holds. The transposed layout hoists the min term as the JAX
    package does: x . (q * scale) - xgsum . minv. Returns (rows, n_out)
    f32."""
    _check_shapes(x, sel, tile_t, n_in, fields, planes_t)
    rows, K = x.shape
    G = K // group
    xs = x.float()
    xp = permute_x(xs, group).reshape(-1, tile_t, K)
    y = torch.zeros((rows // tile_t, tile_t, n_out), dtype=torch.float32, device=x.device)
    xgsum = (xs.reshape(-1, tile_t, G, group).sum(-1)
             if planes_t and "minv" in fields else None)
    sel_l = sel.long()
    for e in torch.unique(sel_l).tolist():
        f = {k: v[e] for k, v in fields.items()}
        minv = None
        if planes_t:
            # (kcols, R) -> (R, kcols); scale/minv keep their G true group rows
            f = {k: (v[:G] if k in ("scale", "minv") else v).T for k, v in f.items()}
            minv = f.pop("minv", None)
        w = dequant_stored(f, ggml_type, group)[:n_out].T
        m = None if minv is None else minv[:n_out].float().T
        for t in torch.nonzero(sel_l == e)[:, 0].tolist():
            yt = xp[t] @ w
            if m is not None:
                yt = yt - xgsum[t] @ m
            y[t] = yt
    return y.reshape(rows, n_out)


def quantized_matmul_gathered(x, fields, sel, ggml_type: GGMLType, group: int,
                              n_out: int, n_in: int, tile_t: int = 1,
                              planes_t: bool = False) -> torch.Tensor:
    """x: (n_tiles * tile_t, n_in) f32 or bf16 rows grouped by tile; sel:
    (n_tiles,) int expert per tile; fields: one layer's expert planes.
    Returns (rows, n_out) f32. CUDA tensors launch a kernel (or raise); CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return quantized_matmul_gathered_plain(x, fields, sel, ggml_type, group, n_out,
                                               n_in, tile_t, planes_t)
    if x.device.type != "cuda":
        raise RuntimeError(f"gathered qmm: unsupported device {x.device}")
    from .build import check, library, ptr, stream

    _check_shapes(x, sel, tile_t, n_in, fields, planes_t)
    rows, K = x.shape
    name = "qmm_gathered_t" if planes_t else "qmm_gathered"
    if tile_t > MAX_TILE_T:
        raise ValueError(f"{name} kernel: tile_t={tile_t} (at most {MAX_TILE_T})")
    if planes_t:
        kind = _KINDS_T.get(frozenset(fields))
        k_mult = 32
    else:
        kind, k_mult = _KINDS.get(frozenset(fields), (None, 0))
    if kind is None:
        raise NotImplementedError(
            f"{name} kernel: {ggml_type.name} fields {sorted(fields)} are not covered yet "
            f"(Q4_0/Q4_1/Q4_K{'' if planes_t else ', Q6_K'} and Q8_0 are)")
    sdt = fields["scale"].dtype
    if sdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: scale dtype {sdt} (f32 or bf16)")
    if not planes_t and tile_t > 1:
        k_mult = MMA_K_MULTIPLE  # the tensor-core tile body
    if K % k_mult:
        raise ValueError(f"{name} kernel: K={K} must be a multiple of {k_mult}"
                         f" at tile_t={tile_t}")
    G = K // group
    q0 = fields["q8" if "q8" in fields else "q4"]
    M, R = q0.shape[0], q0.shape[2 if planes_t else 1]
    for k, a in fields.items():
        kc = K * _BITS[k] // 8 if k in _BITS else G
        if planes_t:
            ok = (a.dim() == 3 and a.shape[0] == M and a.shape[2] == R
                  and (a.shape[1] == kc if k in _BITS else a.shape[1] >= -(-G // 4) * 4))
        else:
            ok = tuple(a.shape) == (M, R, kc)
        if not ok or a.device != x.device or not a.is_contiguous():
            raise ValueError(f"{name}: field {k} {tuple(a.shape)} on {a.device} "
                             f"(contiguous={a.is_contiguous()}) does not fit M={M} R={R} K={K}")
        if k in ("scale", "minv") and a.dtype != sdt:
            raise TypeError(f"{name}: scale and minv dtypes differ")
    if n_out > R or (planes_t and R % 128):
        raise ValueError(f"{name}: n_out={n_out} rows of R={R} stored rows")
    one_row = not planes_t and tile_t == 1
    if tile_t == 1 and rows > 65535:  # the one-row kernels' tile grid axis
        raise ValueError(f"{name}: {rows} one-row tiles (at most 65535)")
    if planes_t and any(a.data_ptr() % 16 for a in fields.values()):
        raise ValueError(f"{name}: the planes must start on 16-byte boundaries")
    if one_row:
        # the decode body reads x in place: natural order is its column
        # order for stripe planes
        xp = x if x.dtype in (torch.float32, torch.bfloat16) else x.float()
        xp = xp.contiguous()
        if xp.data_ptr() % 16:
            xp = xp.clone()  # the body's 16-byte loads
    elif planes_t:
        # the transposed route gets its own copy: the mma route splits f32
        # x in place; the one-row body reads x by 16 bytes
        xs = x.float()
        xp = xs.clone(memory_format=torch.contiguous_format) if tile_t > 1 else xs.contiguous()
        if xp.data_ptr() % 16:
            xp = xp.clone()
    else:
        # the permutation copies x (K/group > 1), which the mma route splits
        xp = permute_x(x.float(), group).contiguous()
    sel_d = sel.to(device=x.device, dtype=torch.int32).contiguous()
    y = torch.empty((rows, n_out), dtype=torch.float32, device=x.device)
    lib = library()
    s_bf16 = int(sdt == torch.bfloat16)
    if planes_t:
        # one-row tiles: the column splits' parts of every output; tiles of
        # more rows: xgsum's bf16 hi and lo planes for the mma route's min
        # term (its columns rounded up to whole 4-column slices)
        if tile_t == 1:
            xg = torch.empty((t_splits(K), rows, n_out), dtype=torch.float32, device=x.device)
        else:
            xg = (torch.empty((2, rows, -(-G // 4) * 4), dtype=torch.bfloat16, device=x.device)
                  if "minv" in fields else None)
        code = lib.tpl_qmm_gathered_t(
            kind, s_bf16, ptr(xp), ptr(xg), ptr(sel_d), ptr(q0), ptr(fields["scale"]),
            ptr(fields.get("minv")), ptr(y), rows // tile_t, tile_t, n_out, R, K,
            fields["scale"].shape[1], stream())
    else:
        code = lib.tpl_qmm_gathered(
            kind, int(xp.dtype == torch.bfloat16), s_bf16, ptr(xp), ptr(sel_d), ptr(q0),
            ptr(fields.get("q2")), ptr(fields["scale"]), ptr(fields.get("minv")), ptr(y),
            rows // tile_t, tile_t, n_out, R, K, stream())
    check(code, name)
    LAUNCHES[name] += 1
    return y
