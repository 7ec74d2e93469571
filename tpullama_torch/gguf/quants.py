"""GGML block codecs (numpy, vectorized): a copy of tpullama/gguf/quants.py,
so the port imports nothing of the JAX package.

Every dequantizer (DEQUANT_FNS, `dequantize`) and quantizer (QUANT_FNS,
the IQ encoders of iq_encode.py, `quantize`) of the original, matching
the C semantics of llama.cpp's ggml/src/ggml-quants.c (dequantize_row_*,
quantize_row_*_ref) and the block layouts of ggml/src/ggml-common.h
exactly, including IEEE fp16 scale decoding (GGML_FP16_TO_FP32). The
loader decodes every tensor it does not pack through these, and
ops/qweights.py repacks with their block helpers.

Layout conventions: a quantized tensor of shape (..., n) is stored as
contiguous blocks along the last axis; block structs are little-endian and
packed (no padding).
"""

from __future__ import annotations

import numpy as np

from .constants import GGML_TYPE_TRAITS, GGMLType, K_SCALE_SIZE, QK_K

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _fp16(b: np.ndarray) -> np.ndarray:
    """View little-endian byte pairs as fp16 → fp32 (exact)."""
    return b.view(np.uint8).reshape(-1, 2).copy().view("<f2").astype(np.float32).reshape(-1)


def _fp32_to_fp16_bytes(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype("<f2")).view(np.uint8)


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

# ---------------------------------------------------------------------------
# dequantize: raw block bytes -> float32 (flat, multiple of block size)
# ---------------------------------------------------------------------------


def dequant_q4_0(data: np.ndarray) -> np.ndarray:
    # block: fp16 d; u8 qs[16]   (ggml-common.h:170-175; ggml-quants.c:307)
    b = _blocks(data, 18)
    d = _fp16(b[:, 0:2])[:, None]
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d).reshape(-1)


def dequant_q4_1(data: np.ndarray) -> np.ndarray:
    b = _blocks(data, 20)
    d = _fp16(b[:, 0:2])[:, None]
    m = _fp16(b[:, 2:4])[:, None]
    qs = b[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.concatenate([lo, hi], axis=1)
    return (q * d + m).reshape(-1)


def _q5_unpack(qh_bytes: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Return int32 5-bit quants in element order for q5_0/q5_1 blocks."""
    qh = qh_bytes.copy().view("<u4").reshape(-1)  # (nb,)
    j = np.arange(16)
    lo = (qs & 0x0F).astype(np.int32)
    hi = (qs >> 4).astype(np.int32)
    # element j gets bit j; element j+16 gets bit j+16 (ggml-quants.c:348-374)
    xh_0 = ((qh[:, None] >> j) << 4) & 0x10
    xh_1 = (qh[:, None] >> (j + 12)) & 0x10
    return np.concatenate([lo | xh_0, hi | xh_1], axis=1)


def dequant_q5_0(data: np.ndarray) -> np.ndarray:
    b = _blocks(data, 22)
    d = _fp16(b[:, 0:2])[:, None]
    q = _q5_unpack(b[:, 2:6], b[:, 6:22]) - 16
    return (q.astype(np.float32) * d).reshape(-1)


def dequant_q5_1(data: np.ndarray) -> np.ndarray:
    b = _blocks(data, 24)
    d = _fp16(b[:, 0:2])[:, None]
    m = _fp16(b[:, 2:4])[:, None]
    q = _q5_unpack(b[:, 4:8], b[:, 8:24])
    return (q.astype(np.float32) * d + m).reshape(-1)


def dequant_q8_0(data: np.ndarray) -> np.ndarray:
    b = _blocks(data, 34)
    d = _fp16(b[:, 0:2])[:, None]
    q = b[:, 2:34].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


def dequant_mxfp4(data: np.ndarray) -> np.ndarray:
    # block: u8 e (E8M0); u8 qs[16]  (ggml-common.h:190-195; ggml-quants.c:417)
    b = _blocks(data, 17)
    d = e8m0_to_fp32_half(b[:, 0])[:, None]
    qs = b[:, 1:17]
    lo = KVALUES_MXFP4[qs & 0x0F]
    hi = KVALUES_MXFP4[qs >> 4]
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d).reshape(-1)


# non-linear 4-bit codebook (ggml-common.h:1088 kvalues_iq4nl)
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.int8,
)
_IQ4NL_F32 = KVALUES_IQ4NL.astype(np.float32)


def dequant_iq4_nl(data: np.ndarray) -> np.ndarray:
    # block: fp16 d; u8 qs[16] (ggml-quants.c dequantize_row_iq4_nl)
    b = _blocks(data, 18)
    d = _fp16(b[:, 0:2])[:, None]
    qs = b[:, 2:18]
    q = np.concatenate([KVALUES_IQ4NL[qs & 0x0F], KVALUES_IQ4NL[qs >> 4]], axis=1)
    return (q.astype(np.float32) * d).reshape(-1)


def dequant_iq4_xs(data: np.ndarray) -> np.ndarray:
    # block: fp16 d; u16 scales_h; u8 scales_l[4]; u8 qs[128]
    # (ggml-quants.c dequantize_row_iq4_xs)
    b = _blocks(data, 136)
    d = _fp16(b[:, 0:2])
    sh = b[:, 2:4].copy().view("<u2")[:, 0].astype(np.uint32)
    sl = b[:, 4:8]
    qs = b[:, 8:136].reshape(-1, 8, 16)
    ib = np.arange(8)
    ls = ((sl[:, ib // 2] >> (4 * (ib % 2)[None, :])) & 0x0F) | (
        ((sh[:, None] >> (2 * ib)[None, :]) & 3) << 4
    ).astype(np.uint8)
    dl = d[:, None] * (ls.astype(np.float32) - 32.0)  # (nb, 8)
    lo = KVALUES_IQ4NL[qs & 0x0F].astype(np.float32)
    hi = KVALUES_IQ4NL[qs >> 4].astype(np.float32)
    y = np.concatenate([lo, hi], axis=2) * dl[:, :, None].astype(np.float32)
    return y.reshape(-1)


# --- IQ grid-codebook formats (dequant; ggml-quants.c dequantize_row_iq*) --

IQ1_DELTA = np.float32(0.125)  # IQ1S_DELTA / IQ1M_DELTA (ggml-common.h:1099)


def _iq_grids():
    from . import _iq_grids as g

    return g


def _signs_from_mask(sign_bytes):
    """Expand packed sign bytes -> (+1/-1) per element (kmask_iq2xs bits)."""
    bits = (sign_bytes[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return np.where(bits > 0, np.float32(-1.0), np.float32(1.0))


def dequant_iq2_xxs(data: np.ndarray) -> np.ndarray:
    g = _iq_grids()
    b = _blocks(data, 34 * 2 - 2)  # 2 + 64
    d = _fp16(b[:, 0:2])
    qs = b[:, 2:66].copy().view("<u2").reshape(-1, 8, 4).astype(np.uint32)
    # per 32-group: aux32[0] = qs[0] | qs[1]<<16 (grid idx bytes);
    # aux32[1] = qs[2] | qs[3]<<16 (signs + 4-bit scale)
    aux0 = qs[:, :, 0] | (qs[:, :, 1] << 16)
    aux1 = qs[:, :, 2] | (qs[:, :, 3] << 16)
    db = d[:, None] * (0.5 + (aux1 >> 28).astype(np.float32)) * np.float32(0.25)
    idx = (aux0[..., None] >> (8 * np.arange(4))) & 0xFF  # (nb, 8, 4)
    grid = g.IQ2XXS_GRID.view(np.uint8).reshape(256, 8)[idx]  # (nb,8,4,8)
    sgn = g.KSIGNS_IQ2XS[(aux1[..., None] >> (7 * np.arange(4))) & 127]
    y = grid.astype(np.float32) * _signs_from_mask(sgn) * db[..., None, None]
    return y.reshape(-1)


def dequant_iq2_xs(data: np.ndarray) -> np.ndarray:
    g = _iq_grids()
    b = _blocks(data, 74)
    d = _fp16(b[:, 0:2])
    qs = b[:, 2:66].copy().view("<u2").reshape(-1, 8, 4)
    scales = b[:, 66:74]
    db = np.stack([
        (scales & 0x0F).astype(np.float32), (scales >> 4).astype(np.float32)
    ], axis=2)  # (nb, 8, 2)
    db = d[:, None, None] * (0.5 + db) * np.float32(0.25)
    grid = g.IQ2XS_GRID.view(np.uint8).reshape(512, 8)[qs & 511]
    sgn = g.KSIGNS_IQ2XS[qs >> 9]
    l_half = np.arange(4) // 2
    y = (grid.astype(np.float32) * _signs_from_mask(sgn)
         * db[:, :, l_half][..., None])
    return y.reshape(-1)


def dequant_iq2_s(data: np.ndarray) -> np.ndarray:
    g = _iq_grids()
    b = _blocks(data, 82)
    d = _fp16(b[:, 0:2])
    qs = b[:, 2:34].reshape(-1, 8, 4).astype(np.uint16)
    signs = b[:, 34:66].reshape(-1, 8, 4)
    qh = b[:, 66:74].astype(np.uint16)
    scales = b[:, 74:82]
    db = np.stack([
        (scales & 0x0F).astype(np.float32), (scales >> 4).astype(np.float32)
    ], axis=2)
    db = d[:, None, None] * (0.5 + db) * np.float32(0.25)
    shift = (8 - 2 * np.arange(4)).astype(np.uint16)
    idx = qs | ((qh[:, :, None] << shift) & 0x300)
    grid = g.IQ2S_GRID.view(np.uint8).reshape(1024, 8)[idx]
    l_half = np.arange(4) // 2
    y = (grid.astype(np.float32) * _signs_from_mask(signs)
         * db[:, :, l_half][..., None])
    return y.reshape(-1)


def dequant_iq3_xxs(data: np.ndarray) -> np.ndarray:
    g = _iq_grids()
    b = _blocks(data, 98)
    d = _fp16(b[:, 0:2])
    qs = b[:, 2:66].reshape(-1, 8, 8)  # (nb, ib32, 8 grid-bytes)
    aux = b[:, 66:98].copy().view("<u4").reshape(-1, 8).astype(np.uint32)
    db = d[:, None] * (0.5 + (aux >> 28).astype(np.float32)) * np.float32(0.5)
    grid = g.IQ3XXS_GRID.view(np.uint8).reshape(256, 4)[qs]  # (nb,8,8,4)
    sgn = g.KSIGNS_IQ2XS[(aux[..., None] >> (7 * np.arange(4))) & 127]  # (nb,8,4)
    smask = _signs_from_mask(sgn).reshape(-1, 8, 4, 8)  # 8 signs per l
    y = (grid.reshape(-1, 8, 4, 8).astype(np.float32) * smask
         * db[..., None, None])
    return y.reshape(-1)


def dequant_iq3_s(data: np.ndarray) -> np.ndarray:
    g = _iq_grids()
    b = _blocks(data, 110)
    d = _fp16(b[:, 0:2])
    qs = b[:, 2:66].reshape(-1, 8, 8).astype(np.uint16)  # 8 per ib32
    qh = b[:, 66:74].astype(np.uint16)  # one per ib32
    signs = b[:, 74:106].reshape(-1, 8, 4)
    scales = b[:, 106:110]
    dbs = np.stack([
        (scales & 0x0F).astype(np.float32), (scales >> 4).astype(np.float32)
    ], axis=2).reshape(-1, 8)  # (nb, 8) per-ib32 scale nibble
    db = d[:, None] * (1.0 + 2.0 * dbs)
    # grid index: qs[2l+e] | ((qh[ib32] << (8-2l-e)) & 256)
    sh = (8 - np.arange(8)).astype(np.uint16)  # e interleaved: 8-2l, 7-2l
    idx = qs | ((qh[:, :, None] << sh) & 256)
    grid = g.IQ3S_GRID.view(np.uint8).reshape(512, 4)[idx]  # (nb,8,8,4)
    smask = _signs_from_mask(signs).reshape(-1, 8, 4, 8)
    y = (grid.reshape(-1, 8, 4, 8).astype(np.float32) * smask
         * db[..., None, None])
    return y.reshape(-1)


def dequant_iq1_s(data: np.ndarray) -> np.ndarray:
    g = _iq_grids()
    b = _blocks(data, 50)
    d = _fp16(b[:, 0:2])
    qs = b[:, 2:34].reshape(-1, 8, 4).astype(np.uint16)
    qh = b[:, 34:50].copy().view("<u2").reshape(-1, 8).astype(np.uint16)
    dl = d[:, None] * (2.0 * ((qh >> 12) & 7).astype(np.float32) + 1.0)
    delta = np.where(qh & 0x8000, -IQ1_DELTA, IQ1_DELTA)  # (nb, 8)
    idx = qs | (((qh[:, :, None] >> (3 * np.arange(4))) & 7) << 8)
    grid = g.IQ1S_GRID.view(np.int8).reshape(2048, 8)[idx]  # (nb,8,4,8)
    y = dl[..., None, None] * (grid.astype(np.float32) + delta[..., None, None])
    return y.reshape(-1)


def dequant_iq1_m(data: np.ndarray) -> np.ndarray:
    g = _iq_grids()
    b = _blocks(data, 56)
    qs = b[:, 0:32].reshape(-1, 8, 4)
    qh = b[:, 32:48].reshape(-1, 8, 2).astype(np.uint16)
    sc = b[:, 48:56].copy().view("<u2").astype(np.uint32)  # (nb, 4)
    # fp16 scale reassembled from the 4 high nibbles (iq1m_scale_t)
    du16 = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0)
            | ((sc[:, 2] >> 4) & 0x0F00) | (sc[:, 3] & 0xF000)).astype("<u2")
    d = du16.view("<f2").astype(np.float32)
    ib = np.arange(8)
    dl1 = d[:, None] * (2.0 * ((sc[:, ib // 2] >> (6 * (ib % 2))) & 7).astype(np.float32) + 1.0)
    dl2 = d[:, None] * (2.0 * ((sc[:, ib // 2] >> (6 * (ib % 2) + 3)) & 7).astype(np.float32) + 1.0)
    dl = np.stack([dl1, dl1, dl2, dl2], axis=2)  # (nb, 8, 4)
    idx = np.empty(qs.shape, np.uint16)
    idx[:, :, 0] = qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700)
    idx[:, :, 1] = qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700)
    idx[:, :, 2] = qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700)
    idx[:, :, 3] = qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700)
    hbit = np.stack([qh[:, :, 0] & 0x08, qh[:, :, 0] & 0x80,
                     qh[:, :, 1] & 0x08, qh[:, :, 1] & 0x80], axis=2)
    delta = np.where(hbit > 0, -IQ1_DELTA, IQ1_DELTA)
    grid = g.IQ1S_GRID.view(np.int8).reshape(2048, 8)[idx]
    y = dl[..., None] * (grid.astype(np.float32) + delta[..., None])
    return y.reshape(-1)


_POW3 = np.array([1, 3, 9, 27, 81, 243], dtype=np.uint16)


def _tq1_trits(q: np.ndarray, n: int) -> np.ndarray:
    """Decode trit n (0=most significant) from a tq1_0 fixed-point byte:
    uint8 wrap-around multiply then mul-shift (dequantize_row_tq1_0)."""
    qq = (q.astype(np.uint16) * _POW3[n]) & 0xFF
    return ((qq * 3) >> 8).astype(np.int8) - 1


def dequant_tq1_0(data: np.ndarray) -> np.ndarray:
    # block: u8 qs[48]; u8 qh[4]; fp16 d (trailing!) — ggml-common.h:241-248
    b = _blocks(data, 54)
    d = _fp16(b[:, 52:54])[:, None]
    y = np.empty((b.shape[0], 256), np.float32)
    qs32 = b[:, 0:32]  # elems 0..159: y[n*32+m] <- trit n of qs[m]
    for n in range(5):
        y[:, n * 32 : (n + 1) * 32] = _tq1_trits(qs32, n)
    qs16 = b[:, 32:48]  # elems 160..239
    for n in range(5):
        y[:, 160 + n * 16 : 160 + (n + 1) * 16] = _tq1_trits(qs16, n)
    qh = b[:, 48:52]  # elems 240..255
    for n in range(4):
        y[:, 240 + n * 4 : 240 + (n + 1) * 4] = _tq1_trits(qh, n)
    return (y * d).reshape(-1)


def dequant_tq2_0(data: np.ndarray) -> np.ndarray:
    # block: u8 qs[64]; fp16 d — ggml-common.h:251-255
    b = _blocks(data, 66)
    d = _fp16(b[:, 64:66])[:, None]
    qs = b[:, 0:64].reshape(-1, 2, 32)  # (nb, j-group, m)
    l = np.arange(4)
    q = (qs[:, :, None, :] >> (2 * l)[None, None, :, None]) & 3  # (nb, 2, 4, 32)
    return ((q.astype(np.float32) - 1.0).reshape(-1, 256) * d).reshape(-1)


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


def dequant_q5_k(data: np.ndarray) -> np.ndarray:
    # block: fp16 d, dmin; scales[12]; qh[32]; qs[128]  (ggml-common.h:312-324)
    b = _blocks(data, 176)
    d = _fp16(b[:, 0:2])
    dmin = _fp16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]  # 32 bytes; bit (2*j64 + half) of qh[l]
    qs = b[:, 48:176].reshape(-1, 4, 32)
    lo = (qs & 0x0F).astype(np.int32)
    hi = (qs >> 4).astype(np.int32)
    j64 = np.arange(4)
    bit_lo = ((qh[:, None, :] >> (2 * j64)[None, :, None]) & 1).astype(np.int32) * 16
    bit_hi = ((qh[:, None, :] >> (2 * j64 + 1)[None, :, None]) & 1).astype(np.int32) * 16
    q = np.stack([lo + bit_lo, hi + bit_hi], axis=2).reshape(-1, 8, 32).astype(np.float32)
    dl = d[:, None] * sc.astype(np.float32)
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


def dequant_q2_k(data: np.ndarray) -> np.ndarray:
    # block: scales[16]; qs[64]; fp16 d, dmin  (ggml-common.h:266-281)
    b = _blocks(data, 84)
    scales = b[:, 0:16]
    qs = b[:, 16:80].reshape(-1, 2, 32)  # per 128-half: 32 bytes
    d = _fp16(b[:, 80:82])
    dmin = _fp16(b[:, 82:84])
    l = np.arange(32)
    j = np.arange(4)
    # value[half, j, l] = (qs[half, l] >> 2j) & 3   (ggml-quants.c:784-830)
    q = ((qs[:, :, None, :] >> (2 * j)[None, None, :, None]) & 3).astype(np.float32)
    # scale idx = half*8 + 2j + (l>=16)
    sidx = (np.arange(2)[:, None, None] * 8 + 2 * j[None, :, None] + (l >= 16)[None, None, :])
    sc = scales[:, sidx]  # (nb, 2, 4, 32)
    dl = d[:, None, None, None] * (sc & 0xF).astype(np.float32)
    ml = dmin[:, None, None, None] * (sc >> 4).astype(np.float32)
    return (dl * q - ml).reshape(-1)


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


def dequant_q3_k(data: np.ndarray) -> np.ndarray:
    # block: hmask[32]; qs[64]; scales[12]; fp16 d  (ggml-common.h:283-293)
    b = _blocks(data, 110)
    hmask = b[:, 0:32]
    qs = b[:, 32:96].reshape(-1, 2, 32)
    scales = _unpack_q3_k_scales(b[:, 96:108])
    d = _fp16(b[:, 108:110])
    l = np.arange(32)
    j = np.arange(4)
    half = np.arange(2)
    q = ((qs[:, :, None, :] >> (2 * j)[None, None, :, None]) & 3).astype(np.int32)
    mbit = half[:, None, None] * 4 + j[None, :, None]  # (2,4,1)
    hi = ((hmask[:, None, None, :] >> mbit[None]) & 1).astype(np.int32)
    q = q - np.where(hi != 0, 0, 4)
    sidx = half[:, None, None] * 8 + 2 * j[None, :, None] + (l >= 16)[None, None, :]
    sc = scales[:, sidx].astype(np.float32) - 32  # (nb,2,4,32)
    y = d[:, None, None, None] * sc * q.astype(np.float32)
    return y.reshape(-1)


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
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q4_1: dequant_q4_1,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q5_1: dequant_q5_1,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.MXFP4: dequant_mxfp4,
    GGMLType.Q2_K: dequant_q2_k,
    GGMLType.Q3_K: dequant_q3_k,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q5_K: dequant_q5_k,
    GGMLType.Q6_K: dequant_q6_k,
    GGMLType.IQ2_XXS: dequant_iq2_xxs,
    GGMLType.IQ2_XS: dequant_iq2_xs,
    GGMLType.IQ2_S: dequant_iq2_s,
    GGMLType.IQ3_XXS: dequant_iq3_xxs,
    GGMLType.IQ3_S: dequant_iq3_s,
    GGMLType.IQ1_S: dequant_iq1_s,
    GGMLType.IQ1_M: dequant_iq1_m,
    GGMLType.IQ4_NL: dequant_iq4_nl,
    GGMLType.IQ4_XS: dequant_iq4_xs,
    GGMLType.TQ1_0: dequant_tq1_0,
    GGMLType.TQ2_0: dequant_tq2_0,
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


# ---------------------------------------------------------------------------
# quantize: float32 -> raw block bytes (reference semantics)
# ---------------------------------------------------------------------------


def _trunc_i8(x: np.ndarray) -> np.ndarray:
    """C (int8_t)(float) conversion: truncate toward zero."""
    return np.trunc(x).astype(np.int32)


def quant_q4_0(x: np.ndarray) -> np.ndarray:
    # quantize_row_q4_0_ref (ggml-quants.c:30-70)
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax_i = np.argmax(np.abs(x), axis=1)
    mx = x[np.arange(x.shape[0]), amax_i]
    d = mx / -8.0
    id_ = np.where(d != 0, np.divide(1.0, d, where=d != 0), 0.0).astype(np.float32)
    d16 = d.astype("<f2")
    # quantize with the fp32 d (reference uses unrounded d for id)
    q = np.minimum(15, _trunc_i8(x * id_[:, None] + 8.5)).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    qs = lo | (hi << 4)
    out = np.empty((x.shape[0], 18), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = qs
    return out.reshape(-1)


def quant_q4_1(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 15.0
    id_ = np.where(d != 0, np.divide(1.0, d, where=d != 0), 0.0).astype(np.float32)
    q = np.minimum(15, _trunc_i8((x - mn[:, None]) * id_[:, None] + 0.5)).astype(np.uint8)
    qs = q[:, :16] | (q[:, 16:] << 4)
    out = np.empty((x.shape[0], 20), dtype=np.uint8)
    out[:, 0:2] = d.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = mn.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 4:] = qs
    return out.reshape(-1)


def quant_q5_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax_i = np.argmax(np.abs(x), axis=1)
    mx = x[np.arange(x.shape[0]), amax_i]
    d = mx / -16.0
    id_ = np.where(d != 0, np.divide(1.0, d, where=d != 0), 0.0).astype(np.float32)
    q = np.minimum(31, _trunc_i8(x * id_[:, None] + 16.5)).astype(np.uint32)
    lo, hi = q[:, :16], q[:, 16:]
    qs = ((lo & 0x0F) | ((hi & 0x0F) << 4)).astype(np.uint8)
    j = np.arange(16)
    qh = (((lo >> 4) & 1) << j).sum(axis=1, dtype=np.uint64) | (
        ((hi >> 4) & 1) << (j + 16)
    ).sum(axis=1, dtype=np.uint64)
    out = np.empty((x.shape[0], 22), dtype=np.uint8)
    out[:, 0:2] = d.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 2:6] = qh.astype("<u4").view(np.uint8).reshape(-1, 4)
    out[:, 6:] = qs
    return out.reshape(-1)


def quant_q5_1(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 31.0
    id_ = np.where(d != 0, np.divide(1.0, d, where=d != 0), 0.0).astype(np.float32)
    q = _trunc_i8((x - mn[:, None]) * id_[:, None] + 0.5).astype(np.uint32)
    lo, hi = q[:, :16], q[:, 16:]
    qs = ((lo & 0x0F) | ((hi & 0x0F) << 4)).astype(np.uint8)
    j = np.arange(16)
    qh = (((lo >> 4) & 1) << j).sum(axis=1, dtype=np.uint64) | (
        ((hi >> 4) & 1) << (j + 16)
    ).sum(axis=1, dtype=np.uint64)
    out = np.empty((x.shape[0], 24), dtype=np.uint8)
    out[:, 0:2] = d.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = mn.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = qh.astype("<u4").view(np.uint8).reshape(-1, 4)
    out[:, 8:] = qs
    return out.reshape(-1)


def quant_q8_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0
    id_ = np.where(d != 0, np.divide(1.0, d, where=d != 0), 0.0).astype(np.float32)
    # roundf = round half away from zero
    v = x * id_[:, None]
    q = np.sign(v) * np.floor(np.abs(v) + 0.5)
    out = np.empty((x.shape[0], 34), dtype=np.uint8)
    out[:, 0:2] = d.astype("<f2").view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.astype(np.int8).view(np.uint8)
    return out.reshape(-1)


def quant_mxfp4(x: np.ndarray) -> np.ndarray:
    # quantize_row_mxfp4_ref (ggml-quants.c:272-305)
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1)
    with np.errstate(divide="ignore"):
        e = np.where(amax > 0, np.floor(np.log2(amax)) - 2 + 127, 0.0)
    e = np.clip(e, 0, 255).astype(np.uint8)
    d = e8m0_to_fp32_half(e)
    # best_index_mxfp4: argmin |kvalues[i]*d - x|
    err = np.abs(
        KVALUES_MXFP4.astype(np.float32)[None, None, :] * d[:, None, None] - x[:, :, None]
    )
    idx = np.argmin(err, axis=2).astype(np.uint8)  # first minimum wins, matches C loop
    lo, hi = idx[:, :16], idx[:, 16:]
    out = np.empty((x.shape[0], 17), dtype=np.uint8)
    out[:, 0] = e
    out[:, 1:] = lo | (hi << 4)
    return out.reshape(-1)


def quant_f16(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32).astype("<f2").view(np.uint8).reshape(-1)


def quant_bf16(x: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    # round-to-nearest-even like ggml_compute_fp32_to_bf16
    rounded = ((u >> 16) + ((u & 0xFFFF) + 0x7FFF + ((u >> 16) & 1) >> 16)).astype("<u2")
    return rounded.view(np.uint8).reshape(-1)


def quant_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype="<f4").view(np.uint8).reshape(-1)


# --- K-quants (super-block 256). Reference: quantize_row_*_ref -----------


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """ggml's nearest_int: round-half-to-even via the 12582912.0 trick."""
    val = (x.astype(np.float32) + np.float32(12582912.0)).view(np.uint32)
    return ((val & 0x007FFFFF).astype(np.int32) - 0x00400000)


def _seqsum_f32(a: np.ndarray) -> np.ndarray:
    """Sequential (C-ordered) f32 summation along axis 1.

    numpy's pairwise summation differs from C's left-to-right accumulation
    by ~1 ulp, which flips strict comparisons in the reference's quantizer
    search loops; bit-exactness requires matching the accumulation order."""
    acc = np.zeros(a.shape[0], np.float32)
    for i in range(a.shape[1]):
        acc = acc + a[:, i]
    return acc


def _make_qx_quants(x: np.ndarray, nmax: int, qw: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """make_qx_quants with rmse_type=1 (ggml-quants.c:699-780 region),
    vectorized over rows of sub-blocks. x: (n_sub, n); qw: optional
    importance weights (imatrix). Returns (scale, L) where L already
    includes the +nmax offset (as in the C code)."""
    n_sub, n = x.shape
    amax = np.abs(x).max(axis=1)
    maxi = np.argmax(np.abs(x), axis=1)
    mx = x[np.arange(n_sub), maxi]
    zero = amax < 1e-15  # GROUP_MAX_EPS
    iscale = np.where(mx != 0, -nmax / np.where(mx == 0, 1, mx), 0.0)
    # rmse_type 1: weighted fit w = qw or x^2 (f32, matching C accumulation)
    L = np.clip(_nearest_int(iscale[:, None].astype(np.float32) * x), -nmax, nmax - 1)
    w = (qw.astype(np.float32) if qw is not None else (x * x)).astype(np.float32)
    Lf = L.astype(np.float32)
    sumlx = _seqsum_f32(w * x * Lf)
    suml2 = _seqsum_f32(w * Lf * Lf)
    scale = np.where(suml2 > 0, sumlx / np.where(suml2 == 0, 1, suml2), 0.0).astype(np.float32)
    best = (scale * sumlx).astype(np.float32)
    # try 18 nudged iscales (-9..9 excluding 0) like the C loop (f32 math)
    for is_ in range(-9, 10):
        if is_ == 0:
            continue
        isc = np.float32(-(np.float32(nmax) + np.float32(0.1) * np.float32(is_))) / np.where(
            mx == 0, 1, mx
        ).astype(np.float32)
        Lc = np.clip(_nearest_int(isc[:, None] * x), -nmax, nmax - 1)
        Lcf = Lc.astype(np.float32)
        sl = _seqsum_f32(w * x * Lcf)
        s2 = _seqsum_f32(w * Lcf * Lcf)
        better = (s2 > 0) & ((sl * sl).astype(np.float32) > (best * s2).astype(np.float32))
        new_scale = np.where(s2 == 0, 0.0, sl / np.where(s2 == 0, 1, s2)).astype(np.float32)
        L = np.where(better[:, None], Lc, L)
        scale = np.where(better, new_scale, scale)
        best = np.where(better, (new_scale * sl).astype(np.float32), best)
    scale = np.where(zero, 0.0, scale)
    L = np.where(zero[:, None], 0, L)
    return scale.astype(np.float32), (L + nmax).astype(np.int32)


def _make_qkx2_quants(
    x: np.ndarray, weights: np.ndarray, nmax: int, rmin: float, rdelta: float, nstep: int, use_mad: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """make_qkx2_quants vectorized: x,(weights): (n_sub, n). Returns
    (scale, the_min, L)."""
    x = x.astype(np.float32)
    weights = weights.astype(np.float32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    sum_w = _seqsum_f32(weights)
    sum_x = _seqsum_f32(weights * x)
    mn = np.minimum(mn, 0.0).astype(np.float32)
    flat = mx <= mn  # max == min (after clamp) → all zeros
    span = np.where(flat, 1.0, mx - mn).astype(np.float32)
    iscale = (np.float32(nmax) / span).astype(np.float32)
    scale = (np.float32(1.0) / iscale).astype(np.float32)
    L = np.clip(_nearest_int(iscale[:, None] * (x - mn[:, None])), 0, nmax)
    diff = scale[:, None] * L.astype(np.float32) + mn[:, None] - x
    diff = np.abs(diff) if use_mad else diff * diff
    best_mad = _seqsum_f32(weights * diff)
    cur_min = mn
    for is_ in range(nstep + 1):
        # C reuses the updated `min` on subsequent iterations
        span_i = np.where(flat, 1.0, mx - cur_min).astype(np.float32)
        isc = (np.float32(rmin + rdelta * is_ + nmax) / span_i).astype(np.float32)
        Lc = np.clip(_nearest_int(isc[:, None] * (x - cur_min[:, None])), 0, nmax)
        Lf = Lc.astype(np.float32)
        sum_l = _seqsum_f32(weights * Lf)
        sum_l2 = _seqsum_f32(weights * Lf * Lf)
        sum_xl = _seqsum_f32(weights * Lf * x)
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = (sum_w * sum_xl - sum_x * sum_l) / D
            this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D
            # C: this_min>0 → min=0, scale=sum_xl/sum_l2 (NaN when sum_l2==0,
            # which poisons mad and rejects the step — keep that behavior)
            alt_scale = sum_xl / sum_l2
        pos_min = this_min > 0
        this_scale = np.where(pos_min, alt_scale, this_scale)
        this_min = np.where(pos_min, 0.0, this_min)
        diff = this_scale[:, None] * Lf + this_min[:, None] - x
        diff = np.abs(diff) if use_mad else diff * diff
        mad = _seqsum_f32(weights * diff)
        with np.errstate(invalid="ignore"):
            better = (D > 0) & (mad < best_mad)  # NaN mad → False
        L = np.where(better[:, None], Lc, L)
        best_mad = np.where(better, mad, best_mad)
        scale = np.where(better, this_scale, scale)
        cur_min = np.where(better, this_min, cur_min)
    scale = np.where(flat, 0.0, scale)
    L = np.where(flat[:, None], 0, L)
    return scale.astype(np.float32), (-cur_min).astype(np.float32), L.astype(np.int32)


def _make_qp_quants(x: np.ndarray, nmax: int, sw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """make_qp_quants (ggml-quants.c): weighted non-negative fit of
    per-sub-block scale values to an n-bit grid with coordinate
    refinement. Vectorized over super-blocks; x: (nb, n) >= 0, sw: (nb, n)
    weights. Returns (scale, L)."""
    x = x.astype(np.float32)
    sw = sw.astype(np.float32)
    nb, n = x.shape
    mx = x.max(axis=1)
    zero = mx < 1e-15  # GROUP_MAX_EPS
    mxs = np.where(zero, 1, mx).astype(np.float32)
    iscale = (np.float32(nmax) / mxs).astype(np.float32)
    L0 = _nearest_int(iscale[:, None] * x)
    scale0 = (1.0 / iscale).astype(np.float32)
    diff = x - scale0[:, None] * L0.astype(np.float32)
    best_mse = _seqsum_f32(sw * diff * diff)
    best_iscale = iscale
    for is_ in range(-4, 5):
        if is_ == 0:
            continue
        isc = (np.float32(0.1 * is_ + nmax) / mxs).astype(np.float32)
        sc = (1.0 / isc).astype(np.float32)
        Lc = np.minimum(nmax, _nearest_int(isc[:, None] * x))
        diff = x - sc[:, None] * Lc.astype(np.float32)
        mse = _seqsum_f32(sw * diff * diff)
        better = mse < best_mse
        best_mse = np.where(better, mse, best_mse)
        best_iscale = np.where(better, isc, best_iscale)
    L = np.minimum(nmax, _nearest_int(best_iscale[:, None] * x)).astype(np.int32)
    Lf = L.astype(np.float32)
    sumlx = _seqsum_f32(sw * x * Lf)
    suml2 = _seqsum_f32(sw * Lf * Lf)
    for _ in range(5):
        n_changed = np.zeros(nb, bool)
        for i in range(n):
            w = sw[:, i]
            Li = L[:, i].astype(np.float32)
            slx = sumlx - w * x[:, i] * Li
            sl2 = suml2 - w * Li * Li
            ok = (slx > 0) & (sl2 > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                new_l = np.minimum(
                    nmax, _nearest_int(x[:, i] * sl2 / np.where(slx == 0, 1, slx))
                )
            changed = ok & (new_l != L[:, i])
            nlf = new_l.astype(np.float32)
            slx2 = slx + w * x[:, i] * nlf
            sl22 = sl2 + w * nlf * nlf
            accept = changed & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(accept, new_l, L[:, i])
            sumlx = np.where(accept, slx2, sumlx)
            suml2 = np.where(accept, sl22, suml2)
            n_changed |= accept
        if not n_changed.any():
            break
    with np.errstate(divide="ignore", invalid="ignore"):
        out_scale = np.where(suml2 > 0, sumlx / np.where(suml2 == 0, 1, suml2), 0.0)
    out_scale = np.where(zero, 0.0, out_scale).astype(np.float32)
    L = np.where(zero[:, None], 0, L)
    return out_scale, np.clip(L, 0, nmax).astype(np.int32)


def _pack_k_scales(scales, mins, max_scale, max_min):
    """Shared 6-bit scale/min packing of quantize_row_q{4,5}_K_ref."""
    nb = scales.shape[0]
    inv_scale = np.where(max_scale > 0, 63.0 / np.where(max_scale == 0, 1, max_scale), 0.0)
    inv_min = np.where(max_min > 0, 63.0 / np.where(max_min == 0, 1, max_min), 0.0)
    # C: uint8_t ls = nearest_int(...); ls = MIN(63, ls); — the cast wraps
    # negatives mod 256 BEFORE the min
    ls = np.minimum(63, (_nearest_int(inv_scale[:, None] * scales) & 0xFF)).astype(np.uint8)
    lm = np.minimum(63, (_nearest_int(inv_min[:, None] * mins) & 0xFF)).astype(np.uint8)
    d = (max_scale / np.float32(63.0)).astype("<f2")
    dmin = (max_min / np.float32(63.0)).astype("<f2")
    sc_b = np.empty((nb, 12), dtype=np.uint8)
    sc_b[:, 0:4] = (ls[:, 0:4] & 63) | ((ls[:, 4:8] >> 4) << 6)
    sc_b[:, 4:8] = (lm[:, 0:4] & 63) | ((lm[:, 4:8] >> 4) << 6)
    sc_b[:, 8:12] = (ls[:, 4:8] & 0x0F) | ((lm[:, 4:8] & 0x0F) << 4)
    return ls, lm, sc_b, d, dmin


def quant_q4_k(x: np.ndarray) -> np.ndarray:
    """quantize_row_q4_K_ref semantics (ggml-quants.c:1280-1350)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    # weights = |x| heuristic: reference uses av_x + |x|
    sum_x2 = (sub * sub).sum(axis=2)
    av_x = np.sqrt(sum_x2 / 32.0)
    weights = av_x[:, :, None] + np.abs(sub)
    scales, mins, L = _make_qkx2_quants(
        sub.reshape(-1, 32), weights.reshape(-1, 32), 15, -1.0, 0.1, 20, False
    )
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    L = L.reshape(nb, 8, 32)
    L = L.reshape(nb, 8, 32)
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    ls, lm, sc_b, d, dmin = _pack_k_scales(scales, mins, max_scale, max_min)
    # requantize with the fp16-rounded d; d==0 sub-blocks keep make_qkx2's L
    d_f = d.astype(np.float32)
    dmin_f = dmin.astype(np.float32)
    dl = d_f[:, None] * ls.astype(np.float32)  # (nb, 8)
    ml = dmin_f[:, None] * lm.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _nearest_int((sub + ml[:, :, None]) / np.where(dl == 0, 1, dl)[:, :, None])
    Lq = np.where((dl != 0)[:, :, None], np.clip(Lq, 0, 15), L).astype(np.uint8)
    pair = Lq.reshape(nb, 4, 2, 32)
    qs = (pair[:, :, 0] | (pair[:, :, 1] << 4)).reshape(nb, 128)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = sc_b
    out[:, 16:] = qs
    return out.reshape(-1)


def quant_q5_k(x: np.ndarray) -> np.ndarray:
    """quantize_row_q5_K_ref semantics."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    sum_x2 = (sub * sub).sum(axis=2)
    av_x = np.sqrt(sum_x2 / 32.0)
    weights = av_x[:, :, None] + np.abs(sub)
    scales, mins, L = _make_qkx2_quants(
        sub.reshape(-1, 32), weights.reshape(-1, 32), 31, -0.5, 0.1, 15, False
    )
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    L = L.reshape(nb, 8, 32)
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    ls, lm, sc_b, d, dmin = _pack_k_scales(scales, mins, max_scale, max_min)
    d_f = d.astype(np.float32)
    dmin_f = dmin.astype(np.float32)
    dl = d_f[:, None] * ls.astype(np.float32)
    ml = dmin_f[:, None] * lm.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _nearest_int((sub + ml[:, :, None]) / np.where(dl == 0, 1, dl)[:, :, None])
    Lq = np.where((dl != 0)[:, :, None], np.clip(Lq, 0, 31), L).astype(np.uint8)
    # pack: per 64-group j64: low nibbles of L[2*j64], high of L[2*j64+1];
    # qh bit 2*j64 for first sub-block, 2*j64+1 for second
    pair = Lq.reshape(nb, 4, 2, 32)
    qs = ((pair[:, :, 0] & 0x0F) | ((pair[:, :, 1] & 0x0F) << 4)).reshape(nb, 128)
    j64 = np.arange(4)
    qh = (
        ((pair[:, :, 0] >> 4).astype(np.uint8) << (2 * j64)[None, :, None]).sum(axis=1)
        | ((pair[:, :, 1] >> 4).astype(np.uint8) << (2 * j64 + 1)[None, :, None]).sum(axis=1)
    ).astype(np.uint8)
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = sc_b
    out[:, 16:48] = qh
    out[:, 48:] = qs
    return out.reshape(-1)


def quant_q6_k(x: np.ndarray) -> np.ndarray:
    """quantize_row_q6_K_ref semantics (ggml-quants.c:1694-1760)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    scales, L = _make_qx_quants(sub.reshape(-1, 16), 32)
    scales = scales.reshape(nb, 16)
    L = L.reshape(nb, 16, 16)
    amax_sc = np.abs(scales).max(axis=1)
    maxi = np.argmax(np.abs(scales), axis=1)
    max_sc = scales[np.arange(nb), maxi]
    zero = amax_sc < 1e-15  # GROUP_MAX_EPS → whole block zeroed
    iscale = np.where(zero, 0.0, np.float32(-128.0) / np.where(max_sc == 0, 1, max_sc)).astype(
        np.float32
    )
    d16 = np.where(zero, 0.0, 1.0 / np.where(iscale == 0, 1, iscale)).astype("<f2")
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)).astype(np.int8)
    sc8 = np.where(zero[:, None], 0, sc8).astype(np.int8)
    d_f = d16.astype(np.float32)
    dl = d_f[:, None] * sc8.astype(np.float32)  # (nb, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _nearest_int(sub / np.where(dl == 0, 1, dl)[:, :, None])
    # d==0 sub-blocks keep make_qx_quants' L (already offset by +32)
    Lq = np.where((dl != 0)[:, :, None], np.clip(Lq, -32, 31) + 32, L.reshape(nb, 16, 16))
    Lq = np.where(zero[:, None, None], 0, Lq)
    Lq = Lq.astype(np.uint8).reshape(nb, 2, 128)  # per 128-half
    # pack (inverse of dequant_q6_k): per half, l in 0..31:
    # ql[l] = (L[l]&0xF) | ((L[l+64]&0xF)<<4); ql[l+32] = (L[l+32]&0xF)|((L[l+96]&0xF)<<4)
    # qh[l] = (L[l]>>4) | ((L[l+32]>>4)<<2) | ((L[l+64]>>4)<<4) | ((L[l+96]>>4)<<6)
    Lh = Lq.reshape(nb, 2, 4, 32)
    ql = np.empty((nb, 2, 64), dtype=np.uint8)
    ql[:, :, 0:32] = (Lh[:, :, 0] & 0x0F) | ((Lh[:, :, 2] & 0x0F) << 4)
    ql[:, :, 32:64] = (Lh[:, :, 1] & 0x0F) | ((Lh[:, :, 3] & 0x0F) << 4)
    qh = (
        (Lh[:, :, 0] >> 4)
        | ((Lh[:, :, 1] >> 4) << 2)
        | ((Lh[:, :, 2] >> 4) << 4)
        | ((Lh[:, :, 3] >> 4) << 6)
    ).astype(np.uint8)
    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, 0:128] = ql.reshape(nb, 128)
    out[:, 128:192] = qh.reshape(nb, 64)
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = d16.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)




def _quant_q45_k_weighted(x: np.ndarray, qw: np.ndarray, five: bool) -> np.ndarray:
    """quantize_row_q{4,5}_K_impl with quant_weights (imatrix):
    weights = qw * sqrt(sigma2 + x^2); qkx3 search (-0.9, 0.05, 36);
    super-block scale/min fitted by make_qp_quants with sw = sub-block
    weight sums."""
    nmax = 31 if five else 15
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    qw = np.ascontiguousarray(qw, dtype=np.float32).reshape(-1, QK_K)
    if qw.shape[0] == 1 and x.shape[0] != 1:
        qw = np.broadcast_to(qw, x.shape)
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    sum_x2 = _seqsum_f32((x * x).reshape(-1, QK_K)).reshape(nb)
    sigma2 = 2.0 * sum_x2 / QK_K
    weights = (qw.reshape(nb, 8, 32)
               * np.sqrt(sigma2[:, None, None] + sub * sub)).astype(np.float32)
    sw = _seqsum_f32(weights.reshape(-1, 32)).reshape(nb, 8)
    scales, mins, L = _make_qkx2_quants(
        sub.reshape(-1, 32), weights.reshape(-1, 32), nmax, -0.9, 0.05, 36, False
    )
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    L = L.reshape(nb, 8, 32)
    d_block, Ls = _make_qp_quants(scales, 63, sw)
    m_block, Lm = _make_qp_quants(mins, 63, sw)
    ls = Ls.astype(np.uint8)
    lm = Lm.astype(np.uint8)
    d = d_block.astype("<f2")
    dmin = m_block.astype("<f2")
    sc_b = np.empty((nb, 12), dtype=np.uint8)
    sc_b[:, 0:4] = (ls[:, 0:4] & 63) | ((ls[:, 4:8] >> 4) << 6)
    sc_b[:, 4:8] = (lm[:, 0:4] & 63) | ((lm[:, 4:8] >> 4) << 6)
    sc_b[:, 8:12] = (ls[:, 4:8] & 0x0F) | ((lm[:, 4:8] & 0x0F) << 4)
    d_f = d.astype(np.float32)
    dmin_f = dmin.astype(np.float32)
    dl = d_f[:, None] * ls.astype(np.float32)
    ml = dmin_f[:, None] * lm.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _nearest_int((sub + ml[:, :, None]) / np.where(dl == 0, 1, dl)[:, :, None])
    Lq = np.where((dl != 0)[:, :, None], np.clip(Lq, 0, nmax), L).astype(np.uint8)
    pair = Lq.reshape(nb, 4, 2, 32)
    if five:
        qs = ((pair[:, :, 0] & 0x0F) | ((pair[:, :, 1] & 0x0F) << 4)).reshape(nb, 128)
        j64 = np.arange(4)
        qh = (
            ((pair[:, :, 0] >> 4).astype(np.uint8) << (2 * j64)[None, :, None]).sum(axis=1)
            | ((pair[:, :, 1] >> 4).astype(np.uint8) << (2 * j64 + 1)[None, :, None]).sum(axis=1)
        ).astype(np.uint8)
        out = np.empty((nb, 176), dtype=np.uint8)
        out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
        out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
        out[:, 4:16] = sc_b
        out[:, 16:48] = qh
        out[:, 48:] = qs
    else:
        qs = (pair[:, :, 0] | (pair[:, :, 1] << 4)).reshape(nb, 128)
        out = np.empty((nb, 144), dtype=np.uint8)
        out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
        out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
        out[:, 4:16] = sc_b
        out[:, 16:] = qs
    return out.reshape(-1)


def _quant_q6_k_weighted(x: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """quantize_row_q6_K_impl with quant_weights: make_qx_quants gets the
    raw imatrix weights per 16-group."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    qw = np.ascontiguousarray(qw, dtype=np.float32).reshape(-1, QK_K)
    if qw.shape[0] == 1 and x.shape[0] != 1:
        qw = np.broadcast_to(qw, x.shape)
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    scales, L = _make_qx_quants(sub.reshape(-1, 16), 32, qw.reshape(-1, 16))
    scales = scales.reshape(nb, 16)
    L = L.reshape(nb, 16, 16)
    amax_sc = np.abs(scales).max(axis=1)
    maxi = np.argmax(np.abs(scales), axis=1)
    max_sc = scales[np.arange(nb), maxi]
    zero = amax_sc < 1e-15
    iscale = np.where(zero, 0.0, np.float32(-128.0) / np.where(max_sc == 0, 1, max_sc)).astype(np.float32)
    d16 = np.where(zero, 0.0, 1.0 / np.where(iscale == 0, 1, iscale)).astype("<f2")
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)).astype(np.int8)
    sc8 = np.where(zero[:, None], 0, sc8).astype(np.int8)
    d_f = d16.astype(np.float32)
    dl = d_f[:, None] * sc8.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _nearest_int(sub / np.where(dl == 0, 1, dl)[:, :, None])
    Lq = np.where((dl != 0)[:, :, None], np.clip(Lq, -32, 31) + 32, L.reshape(nb, 16, 16))
    Lq = np.where(zero[:, None, None], 0, Lq)
    Lq = Lq.astype(np.uint8).reshape(nb, 2, 128)
    Lh = Lq.reshape(nb, 2, 4, 32)
    ql = np.empty((nb, 2, 64), dtype=np.uint8)
    ql[:, :, 0:32] = (Lh[:, :, 0] & 0x0F) | ((Lh[:, :, 2] & 0x0F) << 4)
    ql[:, :, 32:64] = (Lh[:, :, 1] & 0x0F) | ((Lh[:, :, 3] & 0x0F) << 4)
    qh = (
        (Lh[:, :, 0] >> 4)
        | ((Lh[:, :, 1] >> 4) << 2)
        | ((Lh[:, :, 2] >> 4) << 4)
        | ((Lh[:, :, 3] >> 4) << 6)
    ).astype(np.uint8)
    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, 0:128] = ql.reshape(nb, 128)
    out[:, 128:192] = qh.reshape(nb, 64)
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = d16.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


def _best_index_iq4nl(x: np.ndarray) -> np.ndarray:
    """best_index_int8 over the kvalues_iq4nl codebook, vectorized.
    Nearest codebook index; ties round up (matches the C comparison)."""
    x = x.astype(np.float32)
    idx = np.clip(np.searchsorted(_IQ4NL_F32, x, side="right"), 1, 15)
    lo, hi = _IQ4NL_F32[idx - 1], _IQ4NL_F32[idx]
    out = np.where((x - lo) < (hi - x), idx - 1, idx)
    out = np.where(x <= _IQ4NL_F32[0], 0, out)
    out = np.where(x >= _IQ4NL_F32[15], 15, out)
    return out.astype(np.uint8)


def _iq4_fit_scales(xb: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Per-32-block scale search of quantize_row_iq4_nl_impl (ntry=7).
    xb, w: (nblk, 32) f32. Returns per-block scale d (f32), 0 for
    all-zero blocks."""
    nblk = xb.shape[0]
    amax = np.abs(xb).max(axis=1)
    mx = xb[np.arange(nblk), np.argmax(np.abs(xb), axis=1)]
    zero = amax < 1e-15  # GROUP_MAX_EPS
    safe_mx = np.where(zero, 1.0, mx).astype(np.float32)

    def sums(idv):
        L = _best_index_iq4nl(idv[:, None].astype(np.float32) * xb)
        q = _IQ4NL_F32[L]
        return _seqsum_f32((w * q) * xb), _seqsum_f32((w * q) * q)

    with np.errstate(divide="ignore", invalid="ignore"):
        d0 = (-safe_mx / _IQ4NL_F32[0]).astype(np.float32)
        sumqx, sumq2 = sums((np.float32(1.0) / d0).astype(np.float32))
        d = (sumqx / sumq2).astype(np.float32)
        best = (d * sumqx).astype(np.float32)
        for itry in range(-7, 8):
            idv = ((np.float32(itry) + _IQ4NL_F32[0]) / safe_mx).astype(np.float32)
            sumqx, sumq2 = sums(idv)
            better = (sumq2 > 0) & (sumqx * sumqx > best * sumq2)
            new_d = np.where(better, sumqx / np.where(sumq2 == 0, 1.0, sumq2), d).astype(
                np.float32
            )
            d = new_d
            best = np.where(better, d * sumqx, best).astype(np.float32)
    return np.where(zero, np.float32(0.0), d).astype(np.float32)


def quant_iq4_nl(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """quantize_iq4_nl (ggml-quants.c:4750): 32-elem blocks, non-linear
    4-bit codebook, ntry=7 scale search."""
    xb = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    if qw is not None:
        sigma2 = (np.float32(2.0 / 32.0) * _seqsum_f32(xb * xb)).astype(np.float32)
        w = (qw.reshape(-1, 32).astype(np.float32) * np.sqrt(sigma2[:, None] + xb * xb)).astype(
            np.float32
        )
    else:
        w = xb * xb
    d = _iq4_fit_scales(xb, w)
    with np.errstate(divide="ignore"):
        idv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)
    L = _best_index_iq4nl(idv[:, None] * xb)
    out = np.empty((xb.shape[0], 18), np.uint8)
    out[:, 0:2] = _fp32_to_fp16_bytes(d).reshape(-1, 2)
    out[:, 2:18] = L[:, :16] | (L[:, 16:] << 4)
    return out.reshape(-1)


def quant_iq4_xs(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """quantize_iq4_xs (ggml-quants.c:4788): 256-elem super-blocks of
    eight 32-blocks, 6-bit block scales over the iq4nl codebook."""
    xs = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 256)
    nsb = xs.shape[0]
    xb = xs.reshape(-1, 32)  # (nsb*8, 32)
    if qw is not None:
        sigma2 = (np.float32(2.0 / 256.0) * _seqsum_f32(xs * xs)).astype(np.float32)
        s2 = np.repeat(sigma2, 8)[:, None]
        w = (qw.reshape(-1, 32).astype(np.float32) * np.sqrt(s2 + xb * xb)).astype(np.float32)
    else:
        w = xb * xb
    scales = _iq4_fit_scales(xb, w).reshape(nsb, 8)
    max_sc = scales[np.arange(nsb), np.argmax(np.abs(scales), axis=1)]
    d = (-max_sc / np.float32(32.0)).astype(np.float32)
    with np.errstate(divide="ignore"):
        idv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)
    l = np.clip(_nearest_int(idv[:, None] * scales), -32, 31)  # (nsb, 8)
    dl = (d[:, None] * l.astype(np.float32)).astype(np.float32)
    with np.errstate(divide="ignore"):
        idl = np.where(dl != 0, np.float32(1.0) / dl, np.float32(0.0)).astype(np.float32)
    L = _best_index_iq4nl(idl.reshape(-1)[:, None] * xb).reshape(nsb, 8, 32)
    lq = (l + 32).astype(np.uint8)
    out = np.empty((nsb, 136), np.uint8)
    out[:, 0:2] = _fp32_to_fp16_bytes(d).reshape(-1, 2)
    sh = np.zeros(nsb, np.uint32)
    for ib in range(8):
        sh |= (lq[:, ib].astype(np.uint32) >> 4) << (2 * ib)
    out[:, 2:4] = sh.astype("<u2").view(np.uint8).reshape(nsb, 2)
    out[:, 4:8] = (lq[:, 0::2] & 0x0F) | ((lq[:, 1::2] & 0x0F) << 4)
    out[:, 8:136] = (L[:, :, :16] | (L[:, :, 16:] << 4)).reshape(nsb, 128)
    return out.reshape(-1)


def _tq_trits(x: np.ndarray) -> np.ndarray:
    """lroundf(x*id)+1 ternary digits in {0,1,2} (round half away from 0)."""
    return (np.sign(x) * np.floor(np.abs(x) + np.float32(0.5))).astype(np.int32) + 1


def _tq1_pack(tr: np.ndarray) -> np.ndarray:
    """Pack trit groups (n_bytes, k<=5) big-endian base-3 into the
    fixed-point byte encoding q = ceil(q3 * 256 / 243)."""
    q = np.zeros(tr.shape[0], np.uint16)
    for n in range(tr.shape[1]):
        q = q * 3 + tr[:, n].astype(np.uint16)
    if tr.shape[1] < 5:
        q = q * (3 ** (5 - tr.shape[1]))
    return ((q * 256 + 242) // 243).astype(np.uint8)


def quant_tq1_0(x: np.ndarray) -> np.ndarray:
    """quantize_row_tq1_0_ref: ternary 1.6875 bpw, 5 trits/byte base-243."""
    xs = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 256)
    nb = xs.shape[0]
    amax = np.abs(xs).max(axis=1).astype(np.float32)
    with np.errstate(divide="ignore"):
        idv = np.where(amax != 0, np.float32(1.0) / amax, np.float32(0.0)).astype(np.float32)
    t = _tq_trits(xs * idv[:, None])
    out = np.empty((nb, 54), np.uint8)
    # qs[m] packs x[m + n*32] for trit position n (see dequant_tq1_0)
    g = t[:, 0:160].reshape(nb, 5, 32).transpose(0, 2, 1).reshape(-1, 5)
    out[:, 0:32] = _tq1_pack(g).reshape(nb, 32)
    g = t[:, 160:240].reshape(nb, 5, 16).transpose(0, 2, 1).reshape(-1, 5)
    out[:, 32:48] = _tq1_pack(g).reshape(nb, 16)
    g = t[:, 240:256].reshape(nb, 4, 4).transpose(0, 2, 1).reshape(-1, 4)
    out[:, 48:52] = _tq1_pack(g).reshape(nb, 4)
    out[:, 52:54] = _fp32_to_fp16_bytes(amax).reshape(-1, 2)
    return out.reshape(-1)


def quant_tq2_0(x: np.ndarray) -> np.ndarray:
    """quantize_row_tq2_0_ref: ternary 2.0625 bpw, 2 bits/elem."""
    xs = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 256)
    nb = xs.shape[0]
    amax = np.abs(xs).max(axis=1).astype(np.float32)
    with np.errstate(divide="ignore"):
        idv = np.where(amax != 0, np.float32(1.0) / amax, np.float32(0.0)).astype(np.float32)
    t = _tq_trits(xs * idv[:, None]).astype(np.uint8)  # {0,1,2}
    g = t.reshape(nb, 2, 4, 32)  # (nb, j-group, bitpos, m)
    q = np.zeros((nb, 2, 32), np.uint8)
    for n in range(4):
        q |= (g[:, :, n, :] & 3) << (2 * n)
    out = np.empty((nb, 66), np.uint8)
    out[:, 0:64] = q.reshape(nb, 64)
    out[:, 64:66] = _fp32_to_fp16_bytes(amax).reshape(-1, 2)
    return out.reshape(-1)


QUANT_FNS = {
    GGMLType.F32: quant_f32,
    GGMLType.F16: quant_f16,
    GGMLType.BF16: quant_bf16,
    GGMLType.Q4_0: quant_q4_0,
    GGMLType.Q4_1: quant_q4_1,
    GGMLType.Q5_0: quant_q5_0,
    GGMLType.Q5_1: quant_q5_1,
    GGMLType.Q8_0: quant_q8_0,
    GGMLType.MXFP4: quant_mxfp4,
    GGMLType.Q4_K: quant_q4_k,
    GGMLType.Q5_K: quant_q5_k,
    GGMLType.Q6_K: quant_q6_k,
    GGMLType.IQ4_NL: quant_iq4_nl,
    GGMLType.IQ4_XS: quant_iq4_xs,
    GGMLType.TQ1_0: quant_tq1_0,
    GGMLType.TQ2_0: quant_tq2_0,
}


# grid-codebook encoders (iq_encode.py; imatrix-weighted full projection)
_IQ_ENCODERS = {
    GGMLType.IQ2_XXS: "iq2_xxs",
    GGMLType.IQ2_XS: "iq2_xs",
    GGMLType.IQ2_S: "iq2_s",
    GGMLType.IQ3_XXS: "iq3_xxs",
    GGMLType.IQ3_S: "iq3_s",
    GGMLType.IQ1_S: "iq1_s",
    GGMLType.IQ1_M: "iq1_m",
}


def quantize(x: np.ndarray, ggml_type: GGMLType, quant_weights: np.ndarray | None = None) -> np.ndarray:
    """Quantize a float32 array to raw block bytes (uint8).

    quant_weights: optional per-column importance weights (imatrix) of
    shape (n_per_row,); used by the K-quant weighted fitting
    (quantize_row_*_impl semantics)."""
    t = GGML_TYPE_TRAITS[ggml_type]
    if x.shape[-1] % t.block_size != 0:
        raise ValueError(
            f"{ggml_type.name}: row length {x.shape[-1]} not a multiple of {t.block_size}"
        )
    if quant_weights is not None:
        n_per_row = x.shape[-1]
        rows = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, n_per_row)
        qw = np.broadcast_to(
            np.asarray(quant_weights, np.float32).reshape(1, n_per_row), rows.shape
        )
        if ggml_type == GGMLType.Q4_K:
            return _quant_q45_k_weighted(rows, qw, five=False)
        if ggml_type == GGMLType.Q5_K:
            return _quant_q45_k_weighted(rows, qw, five=True)
        if ggml_type == GGMLType.Q6_K:
            return _quant_q6_k_weighted(rows, qw)
        if ggml_type == GGMLType.IQ4_NL:
            return quant_iq4_nl(rows, qw)
        if ggml_type == GGMLType.IQ4_XS:
            return quant_iq4_xs(rows, qw)
        # other types ignore the weights (matching the reference's
        # unweighted fallbacks)
    if ggml_type in _IQ_ENCODERS:
        from . import iq_encode

        rows = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, x.shape[-1])
        fn = getattr(iq_encode, f"quant_{_IQ_ENCODERS[ggml_type]}")
        return fn(rows, quant_weights)
    fn = QUANT_FNS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"quantize: {ggml_type.name}")
    return fn(np.ascontiguousarray(x, dtype=np.float32).reshape(-1))
