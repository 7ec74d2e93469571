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
Rows whose mask hides every key are zeros in the flash kernels (their
guarded online softmax); the jnp reference is compared on the other rows.
"""

import numpy as np
import pytest
import torch

from tpullama_torch.ops.cuda.flash_attention import flash_attention
from tpullama_torch.ops.cuda.flash_decode import flash_decode

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


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
