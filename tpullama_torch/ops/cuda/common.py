"""Checks and the plain version shared by the two attention kernels."""

from __future__ import annotations

import torch

from ..attention import attention

NEG_HALF = -5e29  # half the TPU kernels' NEG_INF: a mask value at or below it hides
ROWS = 64   # query rows per flash_attention block (csrc/flash_attention.cu)
CELLS = 64  # key cells per flash_attention tile and per flash_decode chunk
# the widest head dim the kernels take: their instances pad D to 64, 128
# or 256 (csrc/attn_tile.cuh)
MAX_HEAD_DIM = 256


def row_plan(Tq: int, G: int, rows: int):
    """The kernels' query-row tiles: a kv head's Tq * G query rows in
    (position, head) order, row r = position * G + head, cut into tiles of
    `rows`. Returns (positions, heads), two (n_tiles, rows) int64 tensors,
    -1 past the last row. flash_attention runs tiles of ROWS rows,
    flash_decode tiles of 16."""
    R = Tq * G
    r = torch.arange(-(-R // rows) * rows).reshape(-1, rows)
    valid = r < R
    return torch.where(valid, r // G, -1), torch.where(valid, r % G, -1)


def flash_plain(q, k, v, mask, scale, softcap=0.0, sinks=None, alibi_slopes=None,
                k_scale=None, v_scale=None):
    """The function both attention kernels compute, in plain f32 PyTorch:
    reference attention (an int8 cache dequantized by its scales, as
    attention() applies them), except that a query row whose mask hides
    every key returns zeros (the kernels' guarded online softmax) instead
    of the mean of V."""
    B, Tq, Hq, D = q.shape
    out = attention(q, k, v, mask=mask, scale=scale, softcap=softcap,
                    sinks=sinks, alibi_slopes=alibi_slopes, k_scale=k_scale,
                    v_scale=v_scale)
    m = mask.float().expand(B, 1, Tq, k.shape[2])
    hidden = ~(m > NEG_HALF).any(dim=-1)  # (B, 1, Tq)
    return out.masked_fill(hidden.permute(0, 2, 1)[..., None], 0.0)


def route(q, k) -> str:
    """The attention kernels' body for these operands: "mma" (bf16 q over
    bf16 or int8 K/V: the tensor cores) or "fma" (any f32 operand: f32
    FMAs)."""
    mma = q.dtype == torch.bfloat16 and k.dtype in (torch.bfloat16, torch.int8)
    return "mma" if mma else "fma"


def launch_name(kernel: str, int8: bool, slopes) -> str:
    """The launch counter of an attention kernel's route: the kernel's
    name, then "_int8" for an int8 cache and "_alibi" for a launch with
    ALiBi slopes."""
    return kernel + ("_int8" if int8 else "") + ("_alibi" if slopes is not None else "")


def kv_code(k) -> int:
    """The kernels' K/V type flag: 0 f32, 1 bf16, 2 int8."""
    return {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[k.dtype]


def check_inputs(name, q, k, v, mask, sinks, alibi_slopes):
    """Validate the kernels' inputs; returns (mask (B, Tq, S) f32 contiguous,
    sinks, slopes as f32 contiguous or None). K and V are f32, bf16 or int8
    (whose scales check_scales takes)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Tq, Hq, D = q.shape
    Bk, Hkv, S, Dk = k.shape
    if Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} (the kernels take 1 to {MAX_HEAD_DIM})")
    floats = (torch.float32, torch.bfloat16)
    for t, what, types in ((q, "q", floats), (k, "k", floats + (torch.int8,)),
                           (v, "v", floats + (torch.int8,))):
        if t.device != q.device or t.dtype not in types:
            raise TypeError(f"{name}: {what} is {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if k.dtype != v.dtype:
        raise TypeError(f"{name}: k {k.dtype} and v {v.dtype} differ")
    if mask.dim() != 4 or mask.shape[1] != 1:
        raise ValueError(f"{name}: mask {tuple(mask.shape)}; want (B, 1, Tq, S)")
    m = mask.to(device=q.device, dtype=torch.float32).expand(B, 1, Tq, S)
    m = m.reshape(B, Tq, S).contiguous()

    def vec(a, what):
        if a is None:
            return None
        a = a.to(device=q.device, dtype=torch.float32).contiguous()
        if a.shape != (Hq,):
            raise ValueError(f"{name}: {what} {tuple(a.shape)}; want ({Hq},)")
        return a

    return m, vec(sinks, "sinks"), vec(alibi_slopes, "alibi_slopes")


def check_scales(name, k, k_scale, v_scale) -> bool:
    """Validate an int8 cache's scales: both given, f32 contiguous
    (B, Hkv, S) on k's device; a float cache takes none. Returns whether
    the cache is int8."""
    B, Hkv, S = k.shape[:3]
    for a, what in ((k_scale, "k_scale"), (v_scale, "v_scale")):
        if k.dtype != torch.int8:
            if a is not None:
                raise ValueError(f"{name}: {what} given with a {k.dtype} cache (scales go "
                                 "with an int8 cache only)")
            continue
        if a is None:
            raise ValueError(f"{name}: an int8 cache needs {what}")
        if a.device != k.device or a.dtype != torch.float32 or a.shape != (B, Hkv, S) \
                or not a.is_contiguous():
            raise ValueError(f"{name}: {what} is {a.dtype} {tuple(a.shape)} on {a.device}; "
                             f"want f32 contiguous ({B}, {Hkv}, {S})")
    return k.dtype == torch.int8
