"""GGML block codecs used by the port (numpy, vectorized).

A subset of tpullama/gguf/quants.py, copied so the port imports nothing of
the JAX package: dequantization of F32/F16/BF16/Q8_0/Q4_K/Q6_K (the types
the llama-family slice loads), the block helpers ops/qweights.py uses to
repack every packed type, and quantization of the plain float types the
GGUF writer needs. The codecs match the C semantics of ggml-quants.c
(dequantize_row_*) and the block layouts of ggml-common.h exactly.
"""

from __future__ import annotations

import numpy as np

from .constants import GGML_TYPE_TRAITS, GGMLType


def _fp16(b: np.ndarray) -> np.ndarray:
    """View little-endian byte pairs as fp16 → fp32 (exact)."""
    return b.view(np.uint8).reshape(-1, 2).copy().view("<f2").astype(np.float32).reshape(-1)


def _blocks(data: np.ndarray, type_size: int) -> np.ndarray:
    data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    if data.size % type_size != 0:
        raise ValueError(f"data size {data.size} not a multiple of block size {type_size}")
    return data.reshape(-1, type_size)


def e8m0_to_fp32_half(e: np.ndarray) -> np.ndarray:
    """ggml_e8m0_to_fp32_half (ggml/src/ggml-impl.h): 2^(e-127)/2, with
    e==0 mapping to 2^-127 (then halved)."""
    eu = e.astype(np.uint32)
    bits = (np.maximum(eu, 1) - 1) << 23  # normal: 2^(e-127-1) for e >= 2
    bits = np.where(eu == 1, np.uint32(0x00400000), bits)  # 2^-127 subnormal
    bits = np.where(eu == 0, np.uint32(0x00200000), bits)  # 2^-128 subnormal
    return bits.astype(np.uint32).view(np.float32)


KVALUES_MXFP4 = np.array(
    [0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12], dtype=np.int8
)


def dequant_q8_0(data: np.ndarray) -> np.ndarray:
    b = _blocks(data, 34)
    d = _fp16(b[:, 0:2])[:, None]
    q = b[:, 2:34].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


def _unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """get_scale_min_k4 (ggml-quants.c:703-710), vectorized over blocks.

    scales: (nb, 12) uint8 → (sc, m): each (nb, 8) uint8 6-bit values.
    """
    q = scales.astype(np.uint8)
    sc = np.empty((q.shape[0], 8), dtype=np.uint8)
    m = np.empty((q.shape[0], 8), dtype=np.uint8)
    sc[:, :4] = q[:, 0:4] & 63
    m[:, :4] = q[:, 4:8] & 63
    sc[:, 4:] = (q[:, 8:12] & 0x0F) | ((q[:, 0:4] >> 6) << 4)
    m[:, 4:] = (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)
    return sc, m


def dequant_q4_k(data: np.ndarray) -> np.ndarray:
    # block: fp16 d, dmin; u8 scales[12]; u8 qs[128]  (ggml-common.h:295-312)
    b = _blocks(data, 144)
    d = _fp16(b[:, 0:2])
    dmin = _fp16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qs = b[:, 16:144].reshape(-1, 4, 32)  # 4 groups of 32 bytes (64 elems each)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    # element order per 64: 32 low nibbles then 32 high nibbles (ggml-quants.c:1352-1374)
    q = np.stack([lo, hi], axis=2).reshape(-1, 8, 32)  # (nb, 8 sub-blocks, 32)
    dl = d[:, None] * sc.astype(np.float32)  # (nb, 8)
    ml = dmin[:, None] * mn.astype(np.float32)
    return (q * dl[:, :, None] - ml[:, :, None]).reshape(-1)


def dequant_q6_k(data: np.ndarray) -> np.ndarray:
    # block: ql[128]; qh[64]; i8 scales[16]; fp16 d  (ggml-common.h:330-337)
    b = _blocks(data, 210)
    ql = b[:, 0:128].reshape(-1, 2, 64)  # per 128-elem half: 64 ql bytes
    qh = b[:, 128:192].reshape(-1, 2, 32)  # per half: 32 qh bytes
    scales = b[:, 192:208].view(np.int8).reshape(-1, 2, 8)
    d = _fp16(b[:, 208:210])
    l = np.arange(32)
    # (nb, half, 4 quarters, 32) following ggml-quants.c:1762-1791
    q1 = ((ql[:, :, l] & 0x0F) | (((qh[:, :, l] >> 0) & 3) << 4)).astype(np.int8) - 32
    q2 = ((ql[:, :, l + 32] & 0x0F) | (((qh[:, :, l] >> 2) & 3) << 4)).astype(np.int8) - 32
    q3 = ((ql[:, :, l] >> 4) | (((qh[:, :, l] >> 4) & 3) << 4)).astype(np.int8) - 32
    q4 = ((ql[:, :, l + 32] >> 4) | (((qh[:, :, l] >> 6) & 3) << 4)).astype(np.int8) - 32
    q = np.stack([q1, q2, q3, q4], axis=2).astype(np.float32)  # (nb,2,4,32)
    # scale idx within half = quarter_offset{0,2,4,6} + l//16  (8 scales/half)
    sc_idx = np.array([0, 2, 4, 6])[:, None] + (l // 16)[None, :]  # (4,32)
    scale = scales[:, :, sc_idx].astype(np.float32)  # (nb,2,4,32)
    y = d[:, None, None, None] * scale * q
    return y.reshape(-1)


def _unpack_q3_k_scales(scales: np.ndarray) -> np.ndarray:
    """12 bytes → 16 signed 6-bit scales (ggml-quants.c:1128-1152)."""
    a = scales.copy().view("<u4").reshape(-1, 3)  # aux[0], aux[1], tmp
    kmask1, kmask2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    tmp = a[:, 2]
    out = np.empty((scales.shape[0], 4), dtype=np.uint32)
    out[:, 0] = (a[:, 0] & kmask2) | (((tmp >> 0) & kmask1) << 4)
    out[:, 1] = (a[:, 1] & kmask2) | (((tmp >> 2) & kmask1) << 4)
    out[:, 2] = ((a[:, 0] >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4)
    out[:, 3] = ((a[:, 1] >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4)
    return out.view(np.int8).reshape(-1, 16)  # 16 int8 (6-bit) scales


def dequant_f32(data: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(data).view(np.uint8).copy().view("<f4")


def dequant_f16(data: np.ndarray) -> np.ndarray:
    return _fp16(np.ascontiguousarray(data).view(np.uint8))


def dequant_bf16(data: np.ndarray) -> np.ndarray:
    u16 = np.ascontiguousarray(data).view(np.uint8).reshape(-1, 2).copy().view("<u2").reshape(-1)
    return (u16.astype(np.uint32) << 16).view(np.float32)


DEQUANT_FNS = {
    GGMLType.F32: dequant_f32,
    GGMLType.F16: dequant_f16,
    GGMLType.BF16: dequant_bf16,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q6_K: dequant_q6_k,
}


def dequantize(data: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Dequantize raw tensor bytes to float32. `shape` is the numpy (row-major)
    shape; blocks run along the last axis."""
    if ggml_type == GGMLType.I8:
        out = np.ascontiguousarray(data).view(np.int8).astype(np.float32)
    elif ggml_type == GGMLType.I32:
        out = np.ascontiguousarray(data).view(np.uint8).copy().view("<i4").astype(np.float32)
    else:
        fn = DEQUANT_FNS.get(ggml_type)
        if fn is None:
            raise NotImplementedError(f"dequantize: {ggml_type.name}")
        # fp16 block scales decoded from arbitrary bytes can be inf/NaN
        # (random-bit oracle tests); inf*0 -> NaN raises a numpy warning
        # but the NaN itself is the bit-exact behavior the C reference
        # has, so silence only this scope instead of masking values
        with np.errstate(invalid="ignore", over="ignore"):
            out = fn(data)
    return out.reshape(shape) if shape is not None else out


def quant_f16(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32).astype("<f2").view(np.uint8).reshape(-1)


def quant_bf16(x: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    # round-to-nearest-even like ggml_compute_fp32_to_bf16
    rounded = ((u >> 16) + ((u & 0xFFFF) + 0x7FFF + ((u >> 16) & 1) >> 16)).astype("<u2")
    return rounded.view(np.uint8).reshape(-1)


def quant_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype="<f4").view(np.uint8).reshape(-1)


QUANT_FNS = {
    GGMLType.F32: quant_f32,
    GGMLType.F16: quant_f16,
    GGMLType.BF16: quant_bf16,
}


def quantize(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """Quantize a float32 array to raw block bytes (uint8). Only the plain
    float types are encoded here; quantized tensors reach the writer as
    raw block bytes (GGUFWriter.add_tensor(raw=...))."""
    t = GGML_TYPE_TRAITS[ggml_type]
    if x.shape[-1] % t.block_size != 0:
        raise ValueError(
            f"{ggml_type.name}: row length {x.shape[-1]} not a multiple of {t.block_size}"
        )
    fn = QUANT_FNS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"quantize: {ggml_type.name}")
    return fn(np.ascontiguousarray(x, dtype=np.float32).reshape(-1))
