"""The port's int8 KV cache (ContextParams(kv_dtype=torch.int8): int8 rows
and per-(head, token) f32 scales, quantized on write) held against the JAX
package's (kv_dtype=jnp.int8) on the CPU, on the same seeded numpy inputs
and the same tiny GGUF (make_tiny_llama_gguf: n_embd 64, 2 layers, 4/2
heads of 16, dense F32, no rope_freqs; f32 activations, n_ctx <= 96).

Tolerances:
  - the quantizer (models/llama.quantize_q8 against the JAX package's q8
    expression, llama.py:566-575): int8 values and scales bit for bit,
    round-half-to-even ties included;
  - attention with scales against tpullama.ops.attention.attention at f32,
    and the kernels' plain versions (flash_plain, the CPU route of both
    wrappers) against it: rtol = atol = 1e-5 (f32 rounding of another
    summation order); against the Pallas flash_attention in interpret
    mode, which casts q, k and v to bf16 when it takes scales
    (flash_attention.py:83-86): rtol = atol = 2e-2;
  - a whole-model int8 Context: prefill logits within 1e-4 of their
    largest magnitude (the K/V projections sum in another order), cache
    rows equal except at most 1 in 200 values 1 apart (a projection that
    lands a value on the other side of a rounding tie; 0 on this fixture),
    scales within 1e-5 relative, positions exact, 16 greedy tokens
    identical;
  - decode_batch logits of two lanes, the greedy burst's ids, and seq_add /
    seq_div / seq_cp caches (dequantize, rotate, quantize again): the same
    rules; embeddings within 1e-5.
"""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.models.testing import make_tiny_llama_gguf

PROMPT = "Once upon a time there was a cat"
LOGIT_TOL = 1e-4
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
HUGE = (1 << 30) - 1


def _jax_q8(a):
    """The JAX package's quantizer, as written in its forward pass."""
    import jax.numpy as jnp

    amax = jnp.max(jnp.abs(a.astype(jnp.float32)), axis=-1, keepdims=True)
    s = amax / 127.0
    qv = jnp.round(a.astype(jnp.float32) / jnp.maximum(s, 1e-12))
    return jnp.clip(qv, -127, 127).astype(jnp.int8), s[..., 0]


def _ties():
    """Rows whose values sit exactly on rounding ties (amax 127: s = 1),
    a zero row (s = 0, the 1e-12 floor) and a negative amax."""
    a = np.zeros((3, 8), np.float32)
    a[0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -2.5]
    a[2] = [-3.0, 1.0, 0.25, -0.75, 2.9, 0.0, 1e-3, -1e-3]
    return a


@pytest.mark.parametrize("case", ["normal", "scaled", "bf16", "ties"])
def test_quantizer_is_the_reference_bit_for_bit(case):
    from tpullama_torch.models.llama import quantize_q8

    rng = np.random.default_rng(5)
    a = {"normal": lambda: rng.standard_normal((2, 7, 4, 64)).astype(np.float32),
         "scaled": lambda: (rng.standard_normal((3, 5, 2, 100)) * 40).astype(np.float32),
         "bf16": lambda: rng.standard_normal((2, 9, 2, 128)).astype(np.float32),
         "ties": _ties}[case]()
    t = torch.from_numpy(a)
    if case == "bf16":
        import jax.numpy as jnp

        t = t.bfloat16()
        jq, js = _jax_q8(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
    else:
        jq, js = _jax_q8(a)
    q, s = quantize_q8(t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if case == "ties":
        assert q[0].tolist() == [127, 0, 2, 2, 0, -2, 126, -2]  # half to even
        assert q[1].tolist() == [0] * 8 and float(s[1]) == 0.0


def _int8_case(B, Tq, Hq, Hkv, D, S, n_filled, seed, softcap, sinks, alibi):
    """q, int8 k/v with f32 scales (quantized by the port's quantizer from
    seeded normal rows), the Context's mask (ALiBi distances where
    visible) and optional softcap, sinks and slopes, as numpy."""
    from tpullama_torch.models.llama import quantize_q8

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    kq, ks = (t.numpy() for t in quantize_q8(torch.from_numpy(
        rng.standard_normal((B, Hkv, S, D)).astype(np.float32))))
    vq, vs = (t.numpy() for t in quantize_q8(torch.from_numpy(
        rng.standard_normal((B, Hkv, S, D)).astype(np.float32) * 3)))
    kv_pos = np.full((B, S), -1, np.int32)
    q_pos = np.zeros((B, Tq), np.int32)
    for b in range(B):
        n = n_filled - 5 * b
        kv_pos[b, :n] = np.arange(n)
        q_pos[b] = np.arange(n - Tq, n)
    vis = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= q_pos[:, :, None])
    dist = -np.abs(kv_pos[:, None, :] - q_pos[:, :, None]).astype(np.float32)
    mask = np.where(vis, dist if alibi else np.float32(0), np.float32(-1e30))
    kw = {}
    if softcap:
        kw["softcap"] = 20.0
    if sinks:
        kw["sinks"] = rng.standard_normal(Hq).astype(np.float32)
    if alibi:
        kw["alibi_slopes"] = (2.0 ** -np.arange(1, Hq + 1, dtype=np.float32))
    return [q, kq, vq, mask[:, None].astype(np.float32)], [ks, vs], kw


CASES = [  # B, Tq, Hq, Hkv, D, S, softcap, sinks, alibi
    pytest.param(1, 1, 8, 2, 64, 128, False, False, False, id="decode-gqa"),
    pytest.param(2, 4, 4, 4, 16, 96, True, False, False, id="decode4-softcap"),
    pytest.param(2, 1, 12, 2, 100, 128, False, True, False, id="decode-g6-d100-sinks"),
    pytest.param(1, 24, 8, 2, 64, 128, False, False, True, id="prefill-alibi"),
    pytest.param(2, 17, 8, 1, 32, 80, True, True, True, id="prefill-mqa-all"),
]


@pytest.mark.parametrize("B,Tq,Hq,Hkv,D,S,softcap,sinks,alibi", CASES)
def test_attention_with_scales_matches_reference(B, Tq, Hq, Hkv, D, S, softcap, sinks, alibi):
    """attention() with k_scale / v_scale, and both kernels' plain
    versions, against the JAX package's reference attention."""
    import jax.numpy as jnp

    from tpullama.ops.attention import attention as j_attention
    from tpullama_torch.ops.attention import attention, attention_auto
    from tpullama_torch.ops.cuda.common import NEG_HALF
    from tpullama_torch.ops.cuda.flash_attention import flash_attention
    from tpullama_torch.ops.cuda.flash_decode import flash_decode

    arrs, scales, kw = _int8_case(B, Tq, Hq, Hkv, D, S, S - 20, B + Tq + D, softcap, sinks,
                                  alibi)
    scale = D ** -0.5
    jt = [jnp.asarray(a) for a in arrs]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = np.asarray(j_attention(*jt[:3], mask=jt[3], scale=scale, k_scale=jnp.asarray(
        scales[0]), v_scale=jnp.asarray(scales[1]), **jkw))
    tt = [torch.from_numpy(a) for a in arrs]
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ks, vs = (torch.from_numpy(s) for s in scales)
    got = attention(*tt[:3], mask=tt[3], scale=scale, k_scale=ks, v_scale=vs, **tkw)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    auto = attention_auto(*tt[:3], mask=tt[3], scale=scale, k_scale=ks, v_scale=vs, **tkw)
    assert torch.equal(auto, got)
    visible = (arrs[3][:, 0] > NEG_HALF).any(-1)
    fn = flash_decode if Tq <= 4 else flash_attention
    plain = fn(*tt, scale, k_scale=ks, v_scale=vs, **tkw).numpy()
    np.testing.assert_allclose(plain[visible], want[visible], **F32_TOL)


def test_plain_int8_prefill_matches_pallas_kernel():
    """flash_attention's CPU route over an int8 cache against the Pallas
    kernel's has_kv_scale branches in interpret mode."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.flash_attention import flash_attention as jax_fa
    from tpullama_torch.ops.cuda.flash_attention import flash_attention

    arrs, scales, kw = _int8_case(2, 24, 8, 2, 64, 256, 200, 11, True, True, True)
    tt = [torch.from_numpy(a) for a in arrs]
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = flash_attention(*tt, 0.125, k_scale=torch.from_numpy(scales[0]),
                          v_scale=torch.from_numpy(scales[1]), **tkw).numpy()
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = np.asarray(jax_fa(*[jnp.asarray(a) for a in arrs], 0.125, block_q=8, block_s=128,
                             interpret=True, k_scale=jnp.asarray(scales[0]),
                             v_scale=jnp.asarray(scales[1]), **jkw))
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_kernel_checks_take_int8_with_scales_only():
    """The wrappers' checks: int8 K/V need both f32 contiguous (B, Hkv, S)
    scales, and a float cache takes none, each refusal naming its input."""
    from tpullama_torch.ops.cuda.common import check_inputs, check_scales, route

    q = torch.zeros((2, 1, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 2, 32, 64), dtype=torch.int8)
    s = torch.zeros((2, 2, 32))
    mask = torch.zeros((2, 1, 1, 32))
    check_inputs("flash_decode", q, k, k, mask, None, None)
    assert check_scales("flash_decode", k, s, s)
    assert route(q, k) == "mma" and route(q.float(), k) == "fma"
    with pytest.raises(ValueError, match="needs v_scale"):
        check_scales("flash_decode", k, s, None)
    with pytest.raises(ValueError, match="k_scale given with a torch.bfloat16 cache"):
        check_scales("flash_decode", k.bfloat16(), s, s)
    for bad in (s.double(), s[:, :, :16], s.transpose(0, 1)):
        with pytest.raises(ValueError, match="k_scale is"):
            check_scales("flash_attention", k, bad, s)
    assert not check_scales("flash_decode", k.float(), None, None)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from tpullama.models import load_model as j_load
    from tpullama_torch.models import load_model as t_load

    p = str(tmp_path_factory.mktemp("kv8") / "m.gguf")
    make_tiny_llama_gguf(p, n_layer=2, seed=140)
    return j_load(p), t_load(p, device="cpu")


def _pair(models, n_ctx=96, n_seqs=1):
    import jax.numpy as jnp

    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    jm, tm = models
    return (JC(jm, JCP(n_ctx=n_ctx, n_seqs=n_seqs, kv_dtype=jnp.int8)),
            TC(tm, TCP(n_ctx=n_ctx, n_seqs=n_seqs, kv_dtype=torch.int8)))


def _same_int8_cache(jc, tc):
    """The rules of the module docstring: int8 rows equal but for at most 1
    in 200 values 1 apart, scales within 1e-5 relative, positions exact."""
    n_diff = 0
    for j, t in ((jc.kv_k, tc.kv_k), (jc.kv_v, tc.kv_v)):
        assert isinstance(t, tuple) and t[0].dtype == torch.int8 and t[1].dtype == torch.float32
        d = t[0].numpy().astype(np.int32) - np.asarray(j["q"]).astype(np.int32)
        assert np.abs(d).max() <= 1 and np.count_nonzero(d) <= d.size // 200
        n_diff += int(np.count_nonzero(d))
        js = np.asarray(j["s"])
        assert np.abs(t[1].numpy() - js).max() <= 1e-5 * np.abs(js).max()
    np.testing.assert_array_equal(tc.kv_pos.numpy(), np.asarray(jc.kv_pos))
    np.testing.assert_array_equal(tc._pos_host, jc._pos_host)
    np.testing.assert_array_equal(tc.n_past, jc.n_past)
    return n_diff


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(b).max()


def test_int8_context_prefill_cache_and_greedy(models):
    jc, tc = _pair(models)
    toks = models[1].vocab.tokenize(PROMPT, add_special=True)
    lj = jc.decode(np.asarray(toks), n_logits=len(toks))
    lt = tc.decode(np.asarray(toks), n_logits=len(toks))
    _close(lt, lj)
    assert _same_int8_cache(jc, tc) == 0
    a, b = _pair(models)
    want = a.generate(toks, n_predict=16)
    assert b.generate(toks, n_predict=16) == want
    assert b.generate(toks, n_predict=0) == []


def test_int8_context_memory_breakdown(models):
    """values + scales: (L, B, Hkv, S) f32 beside each int8 (L, B, Hkv, S, D)."""
    from tpullama_torch.runtime import Context, ContextParams

    c8 = Context(models[1], ContextParams(n_ctx=64, n_seqs=2, kv_dtype=torch.int8))
    c32 = Context(models[1], ContextParams(n_ctx=64, n_seqs=2))
    hp = models[1].hparams
    cells = hp.n_layer * 2 * hp.n_head_kv * c8._S
    assert c8.memory_breakdown()["kv_cache"] == 2 * cells * (hp.n_embd_head_k + 4)
    assert c32.memory_breakdown()["kv_cache"] == 2 * cells * hp.n_embd_head_k * 4
    with pytest.raises(ValueError, match="kv_dtype"):
        Context(models[1], ContextParams(n_ctx=64, kv_dtype=torch.uint8))


def test_int8_decode_batch_and_greedy_burst(models):
    """Two lanes of different prompts: 4 decode_batch steps with lane 1
    inactive in the second, then a greedy decode_batch_burst of 6."""
    jc, tc = _pair(models, n_seqs=2)
    vocab = models[1].vocab
    prompts = [vocab.tokenize(PROMPT, add_special=True), vocab.tokenize("abc", add_special=True)]
    for c in (jc, tc):
        for s, p in enumerate(prompts):
            c.decode(np.asarray(p), seq_id=s)
    tok = np.asarray([65, 66], np.int32)
    for i in range(4):
        active = np.asarray([True, i != 1])
        lj, lt = jc.decode_batch(tok, active), tc.decode_batch(tok, active)
        _close(lt[active], lj[active])
        tok = np.argmax(lj, axis=-1).astype(np.int32)
        assert np.array_equal(np.argmax(lt, axis=-1)[active], tok[active])
    ids_j = jc.decode_batch_burst(tok, np.ones(2, bool), 6)
    ids_t = tc.decode_batch_burst(tok, np.ones(2, bool), 6)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    assert _same_int8_cache(jc, tc) == 0


SEQ_OPS = {
    "shift": lambda c: (c.seq_rm(1, 4), c.seq_add(4, HUGE, -3)),
    "add_range": lambda c: c.seq_add(2, 6, 5),
    "div": lambda c: c.seq_div(2, 7, 2),
    "cp": lambda c: c.seq_cp(0, 1),
}


@pytest.mark.parametrize("op", list(SEQ_OPS))
def test_int8_seq_ops_match_reference(models, op):
    """seq_add / seq_div re-rotate an int8 lane by dequantizing, rotating
    and quantizing again with fresh scales; seq_cp copies rows and scales.
    Then 4 greedy tokens on lane 0 (and lane 1 after a copy)."""
    jc, tc = _pair(models, n_seqs=2)
    vocab = models[1].vocab
    toks = vocab.tokenize(PROMPT, add_special=True)
    for c in (jc, tc):
        c.decode(np.asarray(toks), seq_id=0)
        c.decode(np.asarray(toks[:5]), seq_id=1)
        SEQ_OPS[op](c)
    _same_int8_cache(jc, tc)
    for lane in (0, 1) if op == "cp" else (0,):
        lj = jc.decode(np.asarray([toks[-1]]), seq_id=lane)
        lt = tc.decode(np.asarray([toks[-1]]), seq_id=lane)
        _close(lt, lj)
        for _ in range(3):
            t = int(np.argmax(lj[-1]))
            assert int(np.argmax(lt[-1])) == t
            lj = jc.decode(np.asarray([t]), seq_id=lane)
            lt = tc.decode(np.asarray([t]), seq_id=lane)


def test_int8_embeddings_match_reference(models):
    jc, tc = _pair(models)
    toks = models[1].vocab.tokenize(PROMPT, add_special=True)
    for pooling in ("mean", "none"):
        np.testing.assert_allclose(tc.embeddings(toks, pooling=pooling),
                                   np.asarray(jc.embeddings(toks, pooling=pooling)),
                                   rtol=1e-5, atol=1e-5)
