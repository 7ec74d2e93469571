"""Split-S flash-decoding: the CUDA kernel's wrapper and its plain version.

Port of tpullama/ops/pallas/flash_decode.py:flash_decode and its
batch-major variant _flash_decode_batched. One wrapper serves both: on a
CUDA tensor it launches csrc/flash_decode.cu (one launch: chunks of 64
cells, merged by the last block of each query-row tile) for any B, and
counts B = 1 and B > 1 calls apart so a run shows which of the two TPU
kernels' roles it exercised. Any GQA group Hq % Hkv == 0 and any Tq is
taken, and any head dim up to common.MAX_HEAD_DIM: the kernel cuts the
(position, head) query rows of a kv head into tiles of 16
(common.row_plan). On a CPU tensor it computes the plain
version (ops/cuda/common.flash_plain). An int8 cache comes with its
per-(head, token) f32 scales (k_scale, v_scale): bf16 q runs it on the
tensor cores (the chunk's int8 rows converted to bf16 in shared memory),
f32 q as f32 FMAs; its launches count apart (flash_decode_int8,
flash_decode_batched_int8), and so do those with ALiBi slopes, with
"_alibi" after the name.
"""

from __future__ import annotations

import torch

from .common import CELLS, check_inputs, check_scales, flash_plain, kv_code, launch_name

LAUNCHES = {f"{name}{route}": 0 for name in ("flash_decode", "flash_decode_batched")
            for route in ("", "_int8", "_alibi", "_int8_alibi")}
ROW_TILE = 16  # query rows per block in csrc/flash_decode.cu

# per device: the kernel's int32 tickets, one per (row tile, kv head, batch
# row). Zeroed once here; each launch leaves them 0 again.
_TICKETS: dict = {}


def _tickets(device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def flash_decode(q, k, v, mask, scale: float, softcap: float = 0.0,
                 sinks=None, alibi_slopes=None, k_scale=None, v_scale=None):
    """q: (B, Tq, Hq, D), Tq <= 4 on the decode path; k, v: (B, Hkv, S, D)
    head-major cache, read in place (int8 with k_scale, v_scale (B, Hkv,
    S) f32); mask: additive f32 broadcastable to (B, 1, Tq, S). Returns
    (B, Tq, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_plain(q, k, v, mask, scale, softcap, sinks, alibi_slopes,
                           k_scale, v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_decode: unsupported device {q.device}")
    from .build import check, library, ptr, stream

    m, sinks, slopes = check_inputs("flash_decode", q, k, v, mask, sinks, alibi_slopes)
    int8 = check_scales("flash_decode", k, k_scale, v_scale)
    B, Tq, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    R = (Hq // Hkv) * Tq
    NC = -(-S // CELLS)
    # the chunks' partial rows: D rounded up to 4 values (16-byte reads)
    part_o = torch.empty((B, Hkv, NC, R, -(-D // 4) * 4), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((B, Hkv, NC, R, 2), dtype=torch.float32, device=q.device)
    tickets = _tickets(q.device, B * Hkv * -(-R // ROW_TILE))
    out = torch.empty_like(q)
    check(library().tpl_flash_decode(
        int(q.dtype == torch.bfloat16), kv_code(k),
        ptr(q), ptr(k), ptr(v), ptr(m), ptr(slopes), ptr(sinks), ptr(k_scale), ptr(v_scale),
        ptr(part_o), ptr(part_ml), ptr(tickets), ptr(out), B, Tq, Hq, Hkv, S, D,
        float(scale), float(softcap), stream()), "flash_decode")
    LAUNCHES[launch_name("flash_decode" if B == 1 else "flash_decode_batched", int8, slopes)] += 1
    return out
