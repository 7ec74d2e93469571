"""The port's attention kernels' plain versions held against the JAX
package: flash_attention and flash_decode (tpullama_torch/ops/cuda)
against the Pallas kernels run in interpret mode and against the jnp
reference attention, on the same numpy inputs: GQA, B in {1, 2, 8},
fully-masked query rows, softcap, sinks and ALiBi. The CUDA kernels
themselves run only on the card (marked cuda).

Tolerances:
  - against Pallas flash_attention and jnp attention: both compute in f32,
    so rtol = atol = 1e-5 (f32 rounding of another summation order);
  - against Pallas flash_decode: that kernel casts q/k/v and the
    probabilities to bf16 before its dots (flash_decode.py:85-90), so
    rtol = atol = 2e-2, the JAX package's own flash-decode tolerance.
  - the tensor-core route's arithmetic (_tile_arithmetic: bf16 q, k, v,
    f32 sums, P split into bf16 hi + lo) against flash_plain and the Pallas
    kernel, on inputs already rounded to bf16: hi + lo keeps 16 of P's
    bits, so each probability is within 2^-16 of itself and rtol = atol =
    1e-4 bounds the output;
  - the kernels on the card against flash_plain: 2^-7 of the output's max
    for a bf16 output (one bf16 rounding), 1e-5 for f32.
Rows whose mask hides every key are zeros in the flash kernels (their
guarded online softmax); the jnp reference is compared on the other rows.
"""

import numpy as np
import pytest
import torch

from tpullama_torch.ops.cuda.common import CELLS, NEG_HALF, ROWS, row_plan
from tpullama_torch.ops.cuda.flash_attention import flash_attention
from tpullama_torch.ops.cuda.flash_decode import flash_decode

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
TILE_TOL = dict(rtol=1e-4, atol=1e-4)
# GQA groups the reference serves beyond powers of two: Qwen2-1.5B's 12/2
# (G = 6), Qwen2-7B's 28/4 (G = 7), 12/1 (G = 12: 64 % 12 != 0, and
# G * Tq = 48 at Tq = 4) and Falcon-7B's 71/1 MQA (head dim 64)
GROUPS = [(12, 2, 128), (28, 4, 128), (12, 1, 128), (71, 1, 64)]
GROUP_IDS = ["G6", "G7", "G12", "G71"]


def _case(B, Tq, Hq, Hkv, D, S, n_filled, seed, hidden_rows=(), alibi=False):
    """q/k/v, kv and q positions, and the Context's additive mask (0 or
    -|dpos| where visible, -1e30 where hidden). hidden_rows get position -1
    (a padded prompt token or an inactive decode lane)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    kv_pos = np.full((B, S), -1, np.int32)
    q_pos = np.zeros((B, Tq), np.int32)
    for b in range(B):
        n = n_filled - 3 * b
        kv_pos[b, :n] = np.arange(n)
        q_pos[b] = np.arange(n - Tq, n)
    for b, t in hidden_rows:
        q_pos[b, t] = -1
    vis = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if alibi:
        dist = -np.abs(kv_pos[:, None, :] - q_pos[:, :, None]).astype(np.float32)
        mask = np.where(vis, dist, np.float32(-1e30))
    else:
        mask = np.where(vis, np.float32(0), np.float32(-1e30))
    mask = mask[:, None].astype(np.float32)
    return q, k, v, mask, vis.any(-1)  # (B, Tq) rows with a visible key


def _extras(Hq, seed, softcap, sinks, alibi):
    rng = np.random.default_rng(seed + 1000)
    kw = {}
    if softcap:
        kw["softcap"] = 30.0
    if sinks:
        kw["sinks"] = rng.standard_normal(Hq).astype(np.float32)
    if alibi:
        kw["alibi_slopes"] = (2.0 ** -np.arange(1, Hq + 1, dtype=np.float32) * 4)
    return kw


def _tile_arithmetic(q, k, v, mask, scale, softcap=0.0, sinks=None, alibi_slopes=None,
                     rows: int = ROWS, cells: int = CELLS):
    """The tensor-core route's arithmetic, in plain PyTorch: q, k and v
    rounded to bf16; per tile of `rows` query rows (row_plan) and kv head,
    key tiles of `cells` that the mask hides for every row of the tile are
    skipped; S from the bf16 values with f32 sums (their products are exact
    in f32); the online softmax per key tile; P split into bf16 hi and lo,
    each multiplied by bf16 v: how far the kernel's arithmetic may sit
    from flash_plain. Returns (B, Tq, Hq, D) f32."""
    B, Tq, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bf = torch.bfloat16
    qb, kb, vb = (t.to(bf).float() for t in (q, k, v))
    m_all = mask.float().expand(B, 1, Tq, S)[:, 0]
    out = torch.zeros((B, Tq, Hq, D), dtype=torch.float32, device=q.device)
    positions, heads = row_plan(Tq, G, rows)
    for b in range(B):
        for h in range(Hkv):
            for pos, head in zip(positions, heads):
                pos, hq = pos[pos >= 0], h * G + head[head >= 0]
                qr, mr = qb[b, pos, hq], m_all[b, pos]
                m = torch.full((len(pos),), -1e30, device=q.device)
                l = torch.zeros(len(pos), device=q.device)
                o = torch.zeros((len(pos), D), device=q.device)
                for s0 in range(0, S, cells):
                    mk = mr[:, s0:s0 + cells]
                    vis = mk > NEG_HALF
                    if not bool(vis.any()):
                        continue
                    s = (qr @ kb[b, h, s0:s0 + cells].T) * scale
                    if softcap:
                        s = softcap * torch.tanh(s / softcap)
                    if alibi_slopes is not None:
                        mk = mk * alibi_slopes.float()[hq][:, None]
                    s = torch.where(vis, s + mk, torch.tensor(-1e30))
                    m_new = torch.maximum(m, s.max(-1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.where(vis, torch.exp(s - m_new[:, None]), torch.tensor(0.0))
                    l = l * alpha + p.sum(-1)
                    hi = p.to(bf).float()
                    lo = (p - hi).to(bf).float()
                    vt = vb[b, h, s0:s0 + cells]
                    o = o * alpha[:, None] + hi @ vt + lo @ vt
                    m = m_new
                corr = torch.ones_like(m)
                if sinks is not None:
                    sk = sinks.float()[hq]
                    mf = torch.maximum(m, sk)
                    corr = torch.exp(m - mf)
                    l = l * corr + torch.exp(sk - mf)
                out[b, pos, hq] = o * (corr / torch.clamp(l, min=1e-30))[:, None]
    return out


def _torch_args(arrs, kw):
    return ([torch.from_numpy(a) for a in arrs],
            {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})


def _jax_args(arrs, kw):
    import jax.numpy as jnp

    return ([jnp.asarray(a) for a in arrs],
            {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})


def _check_against_jnp(got, arrs, kw, scale, visible):
    from tpullama.ops.attention import attention

    (q, k, v, mask), jkw = _jax_args(arrs, kw)
    want = np.asarray(attention(q, k, v, mask=mask, scale=scale, **jkw))
    np.testing.assert_allclose(got[visible], want[visible], **F32_TOL)
    assert np.all(got[~visible] == 0.0)


FEATURES = [(False, False, False), (True, False, False), (False, True, False),
            (False, False, True), (True, True, True)]
FEATURE_IDS = ["plain", "softcap", "sinks", "alibi", "all"]
# each option alone on the first shape, then no option and all of them on
# the others
SHAPE_FEATURES = [(0, f) for f in range(5)] + [(1, 0), (1, 4), (2, 0), (2, 4)]


def _cases(shapes, shape_ids):
    return [pytest.param(*shapes[s], *FEATURES[f], id=f"{shape_ids[s]}-{FEATURE_IDS[f]}")
            for s, f in SHAPE_FEATURES]


@pytest.mark.parametrize("B,Tq,Hq,Hkv,softcap,sinks,alibi", _cases(
    [(1, 40, 8, 2), (2, 17, 4, 4), (8, 9, 8, 2)], ["B1-gqa", "B2-mha", "B8-gqa"]))
def test_flash_attention_plain(B, Tq, Hq, Hkv, softcap, sinks, alibi):
    from tpullama.ops.pallas.flash_attention import flash_attention as jax_fa

    D, S, scale = 64, 256, 0.125
    *arrs, visible = _case(B, Tq, Hq, Hkv, D, S, n_filled=200, seed=B * 10 + Tq,
                           hidden_rows=[(0, Tq - 1), (B - 1, Tq - 2)], alibi=alibi)
    kw = _extras(Hq, B, softcap, sinks, alibi)
    targs, tkw = _torch_args(arrs, kw)
    got = flash_attention(*targs, scale, **tkw)
    assert got.shape == (B, Tq, Hq, D) and got.dtype == torch.float32
    got = got.numpy()
    jargs, jkw = _jax_args(arrs, kw)
    want = np.asarray(jax_fa(*jargs, scale, block_q=32, block_s=128, interpret=True, **jkw))
    np.testing.assert_allclose(got, want, **F32_TOL)
    _check_against_jnp(got, arrs, kw, scale, visible)


@pytest.mark.parametrize("B,Tq,Hq,Hkv,softcap,sinks,alibi", _cases(
    [(1, 1, 8, 2), (2, 2, 4, 4), (8, 1, 8, 2)], ["B1-gqa", "B2-mha-tq2", "B8-gqa"]))
def test_flash_decode_plain(B, Tq, Hq, Hkv, softcap, sinks, alibi):
    from tpullama.ops.pallas.flash_decode import flash_decode as jax_fd

    D, S, scale = 64, 256, 0.125
    # the last lane is inactive (position -1), as decode_batch parks it
    *arrs, visible = _case(B, Tq, Hq, Hkv, D, S, n_filled=230, seed=B * 7 + Tq,
                           hidden_rows=[(B - 1, t) for t in range(Tq)] if B > 1 else [],
                           alibi=alibi)
    kw = _extras(Hq, B, softcap, sinks, alibi)
    targs, tkw = _torch_args(arrs, kw)
    got = flash_decode(*targs, scale, **tkw)
    assert got.shape == (B, Tq, Hq, D) and got.dtype == torch.float32
    got = got.numpy()
    jargs, jkw = _jax_args(arrs, kw)
    want = np.asarray(jax_fd(*jargs, scale, interpret=True, **jkw))
    np.testing.assert_allclose(got, want, **BF16_TOL)
    _check_against_jnp(got, arrs, kw, scale, visible)


@pytest.mark.parametrize("rows", [16, 64])
@pytest.mark.parametrize("Tq", [1, 4, 256])
@pytest.mark.parametrize("G", [1, 4, 6, 7, 12, 71])
def test_row_plan_covers_each_row_once(G, Tq, rows):
    """The kernels' row tiles: every (position, head) of a kv head exactly
    once, in (position, head) order, padding only at the end."""
    pos, head = row_plan(Tq, G, rows)
    assert pos.shape == head.shape == (-(-Tq * G // rows), rows)
    valid = pos >= 0
    assert torch.equal(valid, head >= 0)
    assert int(valid.sum()) == Tq * G and bool(valid.flatten()[:Tq * G].all())
    assert int(pos.max()) == Tq - 1 and int(head.max()) == G - 1
    assert (pos[valid] * G + head[valid]).tolist() == list(range(Tq * G))


@pytest.mark.parametrize("features", [0, 4], ids=["plain", "all"])
@pytest.mark.parametrize("Hq,Hkv", [(12, 2), (14, 2), (12, 1)], ids=["G6", "G7", "G12"])
def test_tile_arithmetic_matches_plain_and_reference(Hq, Hkv, features):
    """The tensor-core route's arithmetic, emulated with its 64-row tiles
    spanning heads and positions, against flash_plain and the Pallas
    kernel in interpret mode."""
    from tpullama.ops.pallas.flash_attention import flash_attention as jax_fa
    from tpullama_torch.ops.cuda.common import flash_plain

    softcap, sinks, alibi = FEATURES[features]
    B, Tq, D, S, scale = 2, 24, 64, 192, 0.125
    q, k, v, mask, visible = _case(B, Tq, Hq, Hkv, D, S, n_filled=150, seed=Hq + Hkv,
                                   hidden_rows=[(0, Tq - 1)], alibi=alibi)
    arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v)] + [mask]
    kw = _extras(Hq, B, softcap, sinks, alibi)
    targs, tkw = _torch_args(arrs, kw)
    got = _tile_arithmetic(*targs, scale, **tkw)
    torch.testing.assert_close(got, flash_plain(*targs, scale, **tkw), **TILE_TOL)
    jargs, jkw = _jax_args(arrs, kw)
    want = np.asarray(jax_fa(*jargs, scale, block_q=8, block_s=128, interpret=True, **jkw))
    np.testing.assert_allclose(got.numpy(), want, **TILE_TOL)
    assert np.all(got.numpy()[~visible] == 0.0)


@pytest.mark.parametrize("Hq,Hkv,D", GROUPS, ids=GROUP_IDS)
def test_plain_any_group_matches_reference(Hq, Hkv, D):
    """Both wrappers' CPU route at the groups the card kernels now take:
    prefill and decode (Tq 1 and 4) against the Pallas kernels in
    interpret mode."""
    from tpullama.ops.pallas.flash_attention import flash_attention as jax_fa
    from tpullama.ops.pallas.flash_decode import flash_decode as jax_fd

    for fn, jfn, Tq, tol in ((flash_attention, jax_fa, 9, F32_TOL),
                             (flash_decode, jax_fd, 1, BF16_TOL),
                             (flash_decode, jax_fd, 4, BF16_TOL)):
        *arrs, visible = _case(1, Tq, Hq, Hkv, D, 128, n_filled=100, seed=Hq + Tq)
        targs, _ = _torch_args(arrs, {})
        got = fn(*targs, 0.1)
        jargs, _ = _jax_args(arrs, {})
        kw = dict(block_q=8, block_s=128) if jfn is jax_fa else {}
        want = np.asarray(jfn(*jargs, 0.1, interpret=True, **kw))
        np.testing.assert_allclose(got.numpy(), want, **tol)
        _check_against_jnp(got.numpy(), arrs, {}, 0.1, visible)


def test_attention_auto_cpu_is_reference():
    """On CPU tensors attention_auto is the plain reference op for every
    Tq (the kernels' dispatch applies to CUDA tensors only)."""
    from tpullama.ops.attention import attention as jax_attention
    from tpullama_torch.ops.attention import attention, attention_auto

    for Tq in (1, 4, 5, 33):
        *arrs, _ = _case(2, Tq, 8, 2, 64, 128, n_filled=100, seed=Tq)
        targs, _ = _torch_args(arrs, {})
        got = attention_auto(*targs[:3], mask=targs[3], scale=0.2)
        torch.testing.assert_close(got, attention(*targs[:3], mask=targs[3], scale=0.2),
                                   rtol=0, atol=0)
        jargs, _ = _jax_args(arrs, {})
        want = np.asarray(jax_attention(*jargs[:3], mask=jargs[3], scale=0.2))
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the attention kernels run on a CUDA card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("softcap,sinks,alibi", FEATURES, ids=FEATURE_IDS)
def test_kernels_match_plain(cuda, dtype, softcap, sinks, alibi):
    """Both sides compute in f32; a bf16 output may round one step apart."""
    from tpullama_torch.ops.cuda.common import flash_plain

    for fn, B, Tq in ((flash_attention, 2, 40), (flash_decode, 3, 1), (flash_decode, 1, 4)):
        *arrs, _ = _case(B, Tq, 8, 2, 128, 384, n_filled=300, seed=Tq,
                         hidden_rows=[(0, Tq - 1)], alibi=alibi)
        targs, tkw = _torch_args(arrs, _extras(8, B, softcap, sinks, alibi))
        q, k, v = (t.to(cuda, dtype) for t in targs[:3])
        mask = targs[3].to(cuda)
        tkw = {kk: (vv.to(cuda) if torch.is_tensor(vv) else vv) for kk, vv in tkw.items()}
        got = fn(q, k, v, mask, 0.09, **tkw).float()
        want = flash_plain(q, k, v, mask, 0.09, **tkw).float()
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        assert float((got - want).abs().max()) <= rel * float(want.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Hq,Hkv,D", GROUPS, ids=GROUP_IDS)
def test_kernels_any_group(cuda, Hq, Hkv, D, dtype):
    """Prefill (Tq = 70: row tiles spanning heads and positions, ragged at
    the end) and decode at Tq = 1 and 4 (G * Tq up to 284 rows in tiles of
    16) at groups the kernels refused before, with a padded query row and
    a cache tail no query sees."""
    from tpullama_torch.ops.cuda.common import flash_plain

    for fn, B, Tq in ((flash_attention, 2, 70), (flash_decode, 1, 1), (flash_decode, 3, 1),
                      (flash_decode, 2, 4)):
        *arrs, _ = _case(B, Tq, Hq, Hkv, D, 320, n_filled=250, seed=Hq + Tq,
                         hidden_rows=[(0, Tq - 1)])
        targs, _ = _torch_args(arrs, {})
        q, k, v = (t.to(cuda, dtype) for t in targs[:3])
        mask = targs[3].to(cuda)
        got = fn(q, k, v, mask, 0.09).float()
        torch.cuda.synchronize()
        want = flash_plain(q, k, v, mask, 0.09).float()
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        assert float((got - want).abs().max()) <= rel * float(want.abs().max()) + 1e-6, \
            (fn.__name__, B, Tq)


@pytest.mark.cuda
def test_decode_merge_repeats_bit_for_bit(cuda):
    """flash_decode merges its chunks in the kernel (the last block of each
    row tile, in chunk order): two calls give identical bits, also after a
    call at another shape has used the tickets."""
    *arrs, _ = _case(4, 1, 32, 8, 128, 4224, n_filled=4000, seed=5)
    targs, _ = _torch_args(arrs, {})
    q, k, v = (t.to(cuda, torch.bfloat16) for t in targs[:3])
    mask = targs[3].to(cuda)
    a = flash_decode(q, k, v, mask, 0.09)
    flash_decode(q[:1, :, :12].contiguous(), k[:1, :2], v[:1, :2], mask[:1], 0.09)
    b = flash_decode(q, k, v, mask, 0.09)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_odd_cache_length(cuda, dtype):
    """A cache of 301 cells: mask rows that are no whole 16-byte runs (the
    kernels' 4-byte mask paths) and a last key tile of 45 cells."""
    from tpullama_torch.ops.cuda.common import flash_plain

    for fn, B, Tq in ((flash_attention, 2, 33), (flash_decode, 2, 1), (flash_decode, 1, 4)):
        *arrs, _ = _case(B, Tq, 8, 2, 128, 301, n_filled=290, seed=Tq, hidden_rows=[(0, Tq - 1)])
        targs, _ = _torch_args(arrs, {})
        q, k, v = (t.to(cuda, dtype) for t in targs[:3])
        mask = targs[3].to(cuda)
        got = fn(q, k, v, mask, 0.09).float()
        torch.cuda.synchronize()
        want = flash_plain(q, k, v, mask, 0.09).float()
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        assert float((got - want).abs().max()) <= rel * float(want.abs().max()) + 1e-6, \
            (fn.__name__, B, Tq)
