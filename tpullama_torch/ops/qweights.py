"""Packed quantized weights in the planar layout (a copy of
tpullama/ops/qweights.py: the port keeps weights byte-identical to the
JAX package's, so its CUDA kernel reads the same planes).

The GGUF block formats (ggml-common.h) are byte-interleaved structs —
hostile to vector loads. At load time we repack each weight matrix
(n_out, n_in) into separate planes (the analog of the reference's own
runtime repack, ggml/src/ggml-cpu/repack.cpp, but designed for 128-lane
vectors):

  - sub-byte fields are packed in "global stripes": a w-bit field with
    k = 8/w values per byte stores, in byte c bits [w*j, w*(j+1)),
    the value of element j*(K/k) + c. In-kernel unpack is then just
    `concat([(q >> w*j) & mask for j in range(k)], axis=-1)` — shifts and
    a lane-aligned concat, no sub-128 reshapes.
  - `scale` / `minv` are f32 effective planes per quantization group
    (32 or 16 elements): scale = d * sub_scale, minv = dmin * sub_min,
    both computed exactly in f32 from the fp16/6-bit originals, so
    dequantization y = q * scale - minv is bit-exact vs the reference
    formulas (SURVEY.md A.2).

Supported: Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, MXFP4, Q2_K, Q3_K, Q4_K, Q5_K,
Q6_K.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.quants import (
    KVALUES_MXFP4,
    _blocks,
    _fp16,
    _unpack_q3_k_scales,
    _unpack_scale_min_k4,
    e8m0_to_fp32_half,
)


@dataclass
class PlanarQuant:
    """One weight matrix in planar packed form. Arrays are numpy at repack
    time; the loader moves them to device."""

    ggml_type: GGMLType
    shape: tuple[int, int]  # (n_out, n_in)
    fields: dict  # name -> array
    group: int  # elements per scale group (32 or 16)
    # stored element order: "stripe" (group_permute — the canonical
    # layout every kernel consumes) or "fourblock" (fourblock_permute —
    # the fused post-attention kernel's order; see to_fourblock)
    order: str = "stripe"

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.fields.values())


def group_permute(vals: np.ndarray, g: int) -> np.ndarray:
    """Natural element order -> stored order.

    Stored position p holds element (p % (K/g)) * g + p // (K/g), i.e. the
    (K/g, g) matrix transposed. With this order, a *tile*-repeat of the
    per-group scale plane (which is what pltpu.repeat lowers to) aligns
    scales with elements: scale[stored p] = scale_plane[p % (K/g)].
    The activation vector gets the same permutation inside
    quantized_matmul (dot products are order-invariant)."""
    N, K = vals.shape[0], vals.shape[-1]
    return np.ascontiguousarray(
        vals.reshape(N, K // g, g).swapaxes(1, 2).reshape(N, K)
    )


def group_unpermute(vals: np.ndarray, g: int) -> np.ndarray:
    N, K = vals.shape[0], vals.shape[-1]
    return np.ascontiguousarray(
        vals.reshape(N, g, K // g).swapaxes(1, 2).reshape(N, K)
    )


def fourblock_permute(vals: np.ndarray, g: int) -> np.ndarray:
    """Natural element order -> "fourblock" stored order.

    Stored position p = a*(K/g) + m*R + s (a < g, m < 128/g, s < R=K/128)
    holds element s*128 + m*g + a. Like group_permute, each stored column
    p mod K/g maps to exactly one quant group, so the tile-repeated scale
    plane still aligns; the JAX package chose this order because its
    activation permutation is legal inside a Mosaic kernel. The group
    living at column b = m*R + s is s*(128/g) + m: scale/min planes are
    column-permuted by fourblock_scale_perm."""
    N, K = vals.shape[0], vals.shape[-1]
    R, nb = K // 128, 128 // g
    v = vals.reshape(N, R, nb, g)          # element s*128+m*g+a -> [s,m,a]
    return np.ascontiguousarray(v.transpose(0, 3, 2, 1).reshape(N, K))


def fourblock_unpermute(vals: np.ndarray, g: int) -> np.ndarray:
    N, K = vals.shape[0], vals.shape[-1]
    R, nb = K // 128, 128 // g
    v = vals.reshape(N, g, nb, R)
    return np.ascontiguousarray(v.transpose(0, 3, 2, 1).reshape(N, K))


def fourblock_scale_perm(K: int, g: int) -> np.ndarray:
    """Column permutation for scale/min planes in fourblock order:
    stored column b holds the scale of natural group (b % R)*(128/g) +
    b // R (R = K/128)."""
    R, nb = K // 128, 128 // g
    b = np.arange(K // g)
    return (b % R) * nb + b // R


def to_fourblock(pq: PlanarQuant) -> PlanarQuant:
    """Re-encode a stripe-order {q4, scale, minv} PlanarQuant into
    fourblock stored order (same bytes per weight; a load-time numpy
    transform). Only the 4-bit single-plane layouts are supported — the
    set the fused post-attention kernel consumes."""
    if pq.order != "stripe":
        return pq
    if set(pq.fields) - {"q4", "scale", "minv"}:
        raise ValueError(f"fourblock unsupported for fields {set(pq.fields)}")
    N, K = pq.shape
    g = pq.group
    if K % 128 or 128 % g:
        raise ValueError(f"fourblock needs K%128==0 and g|128, got {K}, {g}")
    vals_nat = group_unpermute(stripe_unpack_np(pq.fields["q4"], 4), g)
    perm = fourblock_scale_perm(K, g)
    fields = {"q4": _stripe_pack(fourblock_permute(vals_nat, g), 4)}
    for name in ("scale", "minv"):
        if name in pq.fields:
            fields[name] = np.ascontiguousarray(pq.fields[name][..., perm])
    return PlanarQuant(pq.ggml_type, pq.shape, fields, g, order="fourblock")


def _stripe_pack(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack (N, K) small ints into (N, K*bits//8) global-stripe bytes."""
    N, K = values.shape
    k = 8 // bits
    Kc = K // k
    v = values.reshape(N, k, Kc).astype(np.uint8)
    out = np.zeros((N, Kc), np.uint8)
    for j in range(k):
        out |= (v[:, j] & ((1 << bits) - 1)) << (bits * j)
    return out


def stripe_unpack_np(packed: np.ndarray, bits: int) -> np.ndarray:
    """Inverse of _stripe_pack (numpy reference for tests)."""
    k = 8 // bits
    mask = (1 << bits) - 1
    return np.concatenate([(packed >> (bits * j)) & mask for j in range(k)], axis=-1)


def repack(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, int]) -> PlanarQuant:
    """GGUF raw block bytes -> planar packed form."""
    N, K = int(np.prod(shape[:-1])), shape[-1]
    t = ggml_type

    if t == GGMLType.Q8_0:
        b = _blocks(raw, 34)
        d = _fp16(b[:, 0:2]).reshape(N, K // 32)
        q = group_permute(b[:, 2:34].view(np.int8).reshape(N, K), 32)
        return PlanarQuant(t, (N, K), {"q8": q, "scale": d.astype(np.float32)}, 32)

    if t in (GGMLType.Q4_0, GGMLType.Q4_1):
        ts = 18 if t == GGMLType.Q4_0 else 20
        b = _blocks(raw, ts)
        off = 2 if t == GGMLType.Q4_0 else 4
        d = _fp16(b[:, 0:2]).reshape(N, K // 32).astype(np.float32)
        qs = b[:, off : off + 16]
        lo = (qs & 0x0F).reshape(N, -1, 16)
        hi = (qs >> 4).reshape(N, -1, 16)
        # ggml element order: per block [lo(16), hi(16)]
        vals = group_permute(np.concatenate([lo, hi], axis=2).reshape(N, K), 32)
        q4 = _stripe_pack(vals, 4)
        if t == GGMLType.Q4_0:
            minv = 8.0 * d  # y = d*q - 8d
        else:
            m = _fp16(b[:, 2:4]).reshape(N, K // 32).astype(np.float32)
            minv = -m  # y = d*q + m
        return PlanarQuant(t, (N, K), {"q4": q4, "scale": d, "minv": minv}, 32)

    if t in (GGMLType.Q5_0, GGMLType.Q5_1):
        ts = 22 if t == GGMLType.Q5_0 else 24
        b = _blocks(raw, ts)
        off = 2 if t == GGMLType.Q5_0 else 4
        d = _fp16(b[:, 0:2]).reshape(N, K // 32).astype(np.float32)
        qh = b[:, off : off + 4].copy().view("<u4").reshape(-1)
        qs = b[:, off + 4 : off + 20]
        lo = (qs & 0x0F).astype(np.int32)
        hi = (qs >> 4).astype(np.int32)
        j = np.arange(16)
        xl = lo | (((qh[:, None] >> j) & 1) << 4).astype(np.int32)
        xh = hi | (((qh[:, None] >> (j + 16)) & 1) << 4).astype(np.int32)
        vals = group_permute(
            np.concatenate([xl.reshape(N, -1, 16), xh.reshape(N, -1, 16)], axis=2).reshape(N, K), 32
        )
        q4 = _stripe_pack(vals & 0x0F, 4)
        q1 = _stripe_pack(vals >> 4, 1)
        if t == GGMLType.Q5_0:
            minv = 16.0 * d
        else:
            m = _fp16(b[:, 2:4]).reshape(N, K // 32).astype(np.float32)
            minv = -m
        return PlanarQuant(t, (N, K), {"q4": q4, "q1": q1, "scale": d, "minv": minv}, 32)

    if t == GGMLType.MXFP4:
        b = _blocks(raw, 17)
        d = e8m0_to_fp32_half(b[:, 0]).reshape(N, K // 32)
        qs = b[:, 1:17]
        lo = (qs & 0x0F).reshape(N, -1, 16)
        hi = (qs >> 4).reshape(N, -1, 16)
        vals = group_permute(np.concatenate([lo, hi], axis=2).reshape(N, K), 32)
        q4 = _stripe_pack(vals, 4)
        return PlanarQuant(t, (N, K), {"q4_lut": q4, "scale": d}, 32)

    if t == GGMLType.Q4_K:
        b = _blocks(raw, 144)
        d = _fp16(b[:, 0:2]).astype(np.float32)
        dmin = _fp16(b[:, 2:4]).astype(np.float32)
        sc, mn = _unpack_scale_min_k4(b[:, 4:16])
        qs = b[:, 16:144].reshape(-1, 4, 32)
        lo = qs & 0x0F
        hi = qs >> 4
        vals = group_permute(np.stack([lo, hi], axis=2).reshape(-1, 256).reshape(N, K), 32)
        q4 = _stripe_pack(vals, 4)
        scale = (d[:, None] * sc.astype(np.float32)).reshape(N, K // 32)
        minv = (dmin[:, None] * mn.astype(np.float32)).reshape(N, K // 32)
        return PlanarQuant(t, (N, K), {"q4": q4, "scale": scale, "minv": minv}, 32)

    if t == GGMLType.Q5_K:
        b = _blocks(raw, 176)
        d = _fp16(b[:, 0:2]).astype(np.float32)
        dmin = _fp16(b[:, 2:4]).astype(np.float32)
        sc, mn = _unpack_scale_min_k4(b[:, 4:16])
        qh = b[:, 16:48]
        qs = b[:, 48:176].reshape(-1, 4, 32)
        lo = (qs & 0x0F).astype(np.int32)
        hi = (qs >> 4).astype(np.int32)
        j64 = np.arange(4)
        bit_lo = ((qh[:, None, :] >> (2 * j64)[None, :, None]) & 1).astype(np.int32)
        bit_hi = ((qh[:, None, :] >> (2 * j64 + 1)[None, :, None]) & 1).astype(np.int32)
        vals = group_permute(
            np.stack([lo | (bit_lo << 4), hi | (bit_hi << 4)], axis=2).reshape(-1, 256).reshape(N, K),
            32,
        )
        q4 = _stripe_pack(vals & 0x0F, 4)
        q1 = _stripe_pack(vals >> 4, 1)
        scale = (d[:, None] * sc.astype(np.float32)).reshape(N, K // 32)
        minv = (dmin[:, None] * mn.astype(np.float32)).reshape(N, K // 32)
        return PlanarQuant(t, (N, K), {"q4": q4, "q1": q1, "scale": scale, "minv": minv}, 32)

    if t == GGMLType.Q6_K:
        b = _blocks(raw, 210)
        ql = b[:, 0:128].reshape(-1, 2, 64)
        qh = b[:, 128:192].reshape(-1, 2, 32)
        scales8 = b[:, 192:208].view(np.int8)
        d = _fp16(b[:, 208:210]).astype(np.float32)
        l = np.arange(32)
        q1 = (ql[:, :, l] & 0x0F) | (((qh[:, :, l] >> 0) & 3) << 4)
        q2 = (ql[:, :, l + 32] & 0x0F) | (((qh[:, :, l] >> 2) & 3) << 4)
        q3 = (ql[:, :, l] >> 4) | (((qh[:, :, l] >> 4) & 3) << 4)
        q4v = (ql[:, :, l + 32] >> 4) | (((qh[:, :, l] >> 6) & 3) << 4)
        vals = group_permute(
            np.stack([q1, q2, q3, q4v], axis=2).reshape(-1, 256).reshape(N, K), 16
        )  # 6-bit in 0..63
        q4 = _stripe_pack(vals & 0x0F, 4)
        q2p = _stripe_pack(vals >> 4, 2)
        # per-16 effective scale; y = scale*(q-32) = scale*q - 32*scale
        scale = (d[:, None] * scales8.astype(np.float32)).reshape(N, K // 16)
        minv = 32.0 * scale
        return PlanarQuant(t, (N, K), {"q4": q4, "q2": q2p, "scale": scale, "minv": minv}, 16)

    if t == GGMLType.Q2_K:
        b = _blocks(raw, 84)
        scales = b[:, 0:16]
        qs = b[:, 16:80].reshape(-1, 2, 32)
        d = _fp16(b[:, 80:82]).astype(np.float32)
        dmin = _fp16(b[:, 82:84]).astype(np.float32)
        l = np.arange(32)
        j = np.arange(4)
        q = ((qs[:, :, None, :] >> (2 * j)[None, None, :, None]) & 3).astype(np.uint8)
        vals = group_permute(q.reshape(-1, 256).reshape(N, K), 16)
        sidx = (np.arange(2)[:, None, None] * 8 + 2 * j[None, :, None] + (l >= 16)[None, None, :])
        sc = scales[:, sidx]  # (nb, 2, 4, 32) in element order
        dl = (d[:, None, None, None] * (sc & 0xF)).reshape(-1, 256)
        ml = (dmin[:, None, None, None] * (sc >> 4)).reshape(-1, 256)
        # per-16 groups are uniform within element order? No — q2_K scales
        # change per 16 elements in element order, so K//16 planes hold
        q2p = _stripe_pack(vals, 2)
        scale = dl.reshape(N, K)[:, ::16].copy()
        minv = ml.reshape(N, K)[:, ::16].copy()
        return PlanarQuant(t, (N, K), {"q2": q2p, "scale": scale, "minv": minv}, 16)

    if t == GGMLType.Q3_K:
        b = _blocks(raw, 110)
        hmask = b[:, 0:32]
        qs = b[:, 32:96].reshape(-1, 2, 32)
        scales = _unpack_q3_k_scales(b[:, 96:108])
        d = _fp16(b[:, 108:110]).astype(np.float32)
        l = np.arange(32)
        j = np.arange(4)
        half = np.arange(2)
        q = ((qs[:, :, None, :] >> (2 * j)[None, None, :, None]) & 3).astype(np.int32)
        mbit = half[:, None, None] * 4 + j[None, :, None]
        hi = ((hmask[:, None, None, :] >> mbit[None]) & 1).astype(np.int32)
        vals = group_permute((q + hi * 4).reshape(-1, 256).reshape(N, K), 16)  # value+4 in 0..7
        sidx = half[:, None, None] * 8 + 2 * j[None, :, None] + (l >= 16)[None, None, :]
        sc = (scales[:, sidx].astype(np.float32) - 32) * d[:, None, None, None]
        scf = sc.reshape(-1, 256).reshape(N, K)[:, ::16].copy()
        q2p = _stripe_pack(vals & 3, 2)
        q1p = _stripe_pack(vals >> 2, 1)
        # y = scale * ((q | hi<<2) - 4) = scale*q3 - 4*scale
        return PlanarQuant(
            t, (N, K), {"q2": q2p, "q1": q1p, "scale": scf, "minv": 4.0 * scf}, 16
        )

    raise NotImplementedError(f"repack: {t.name}")


PACKED_TYPES = {
    GGMLType.Q4_0,
    GGMLType.Q4_1,
    GGMLType.Q5_0,
    GGMLType.Q5_1,
    GGMLType.Q8_0,
    GGMLType.MXFP4,
    GGMLType.Q2_K,
    GGMLType.Q3_K,
    GGMLType.Q4_K,
    GGMLType.Q5_K,
    GGMLType.Q6_K,
}


def dequant_planar_np(pq: PlanarQuant) -> np.ndarray:
    """Numpy reference dequantization of the planar form (must equal the
    block codec's dequantize()). Scales expand by *tile* repeat matching
    the stored group-transposed order, then the result is unpermuted back
    to natural element order."""
    f = pq.fields
    N, K = pq.shape
    g = pq.group

    def tile_scale(plane):
        return np.tile(plane, (1, g))

    unperm = group_unpermute if pq.order == "stripe" else fourblock_unpermute

    if pq.ggml_type == GGMLType.Q8_0:
        out = f["q8"].astype(np.float32) * tile_scale(f["scale"])
        return unperm(out, g)
    val = None
    if "q4" in f:
        val = stripe_unpack_np(f["q4"], 4).astype(np.int32)
    if "q2" in f:
        q2 = stripe_unpack_np(f["q2"], 2).astype(np.int32)
        val = q2 if val is None else (val | (q2 << 4))
    if "q1" in f:
        q1 = stripe_unpack_np(f["q1"], 1).astype(np.int32)
        val = val | (q1 << (4 if pq.ggml_type in (GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q5_K) else 2))
    if "q4_lut" in f:
        idx = stripe_unpack_np(f["q4_lut"], 4)
        out = KVALUES_MXFP4[idx].astype(np.float32) * tile_scale(f["scale"])
        return unperm(out, g)
    if "q4a" in f:  # A/r re-coded MXFP4 (mxfp4_to_ar)
        a = stripe_unpack_np(f["q4a"], 4).astype(np.int32)
        r = stripe_unpack_np(f["q1r"], 1).astype(np.int32)
        v = ((a - 8) << 1) + r
        out = v.astype(np.float32) * tile_scale(f["scale"])
        return unperm(out, g)
    out = val.astype(np.float32) * tile_scale(f["scale"])
    if "minv" in f:
        out = out - tile_scale(f["minv"])
    return unperm(out, g)


def transpose_planes(fields: dict, sublane_pad: int = 16) -> dict:
    """Planar fields (..., rows, kcols) -> transposed (..., kcols, rows),
    the layout of the transposed gathered kernel (ops/cuda/qmm_gathered.py).
    scale/minv group rows are zero-padded to a multiple of `sublane_pad`,
    as the JAX package stores them; the kernel reads only the true groups."""
    out = {}
    for k, v in fields.items():
        a = np.swapaxes(np.asarray(v), -1, -2)
        if k in ("scale", "minv"):
            pad = (-a.shape[-2]) % sublane_pad
            if pad:
                width = [(0, 0)] * (a.ndim - 2) + [(0, pad), (0, 0)]
                a = np.pad(a, width)
        out[k] = np.ascontiguousarray(a)
    return out
