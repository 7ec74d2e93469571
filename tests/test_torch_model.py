"""The port's model path held against the JAX package on the tiny fixtures
(make_tiny_llama_gguf at n_embd=256, n_ff=256, 2 layers, and the same
with 4 experts, 2 per token: a Mixtral-style MoE; chatglm at n_embd=64,
and one chatglm layer at n_embd=4096 with the fused post-attention path
and 4 K-chunks on): load_model dense and packed, params_from_numpy both
ways, prefill logits, greedy Context.generate, decode_batch and its greedy
burst, and a ServerEngine request script. Everything runs on the CPU, where the port takes its
kernels' plain versions and the JAX package runs its Pallas kernels in
interpret mode, whose qmm defaults to the exact f32 mode.

Tolerances: weights and planes are compared exactly (both packages decode
the same bytes with the same numpy code); logits within rtol = atol = 1e-4
(f32 sums in another order, over two layers); greedy tokens, burst ids,
completions and stop reasons exactly."""

import numpy as np
import pytest
import torch

from tpullama.gguf import GGMLType
from tpullama.models.testing import make_tiny_llama_gguf

QTYPES = [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = "Once upon a time"
# 40 tokens: 80 (token, expert) slots, so MoE prefill takes the dispatch path
LONG_PROMPT = "The quick brown fox jumps over the lazy dog, twice."
MOE = dict(n_embd=256, n_ff=256, n_layer=2, n_expert=4, n_expert_used=2)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    out = {}
    for qt in QTYPES + [GGMLType.F32]:
        p = str(tmp_path_factory.mktemp(qt.name) / "m.gguf")
        make_tiny_llama_gguf(p, n_embd=256, n_ff=256, n_layer=2, qtype=qt, seed=21)
        out[qt] = p
    return out


@pytest.fixture(scope="module")
def glm_small(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("glm64") / "m.gguf")
    make_tiny_llama_gguf(p, arch="chatglm", n_embd=64, n_head=4, n_head_kv=2, n_ff=128,
                         seed=41)
    return p


@pytest.fixture(scope="module")
def glm_4096(tmp_path_factory):
    """One ChatGLM3-6B-wide layer (n_embd 4096, 32 heads, 2 KV heads:
    attn_qkv 4608 x 4096) with a narrow FFN (n_ff 256), Q4_K: the widths
    at which the fused post-attention path and 4 K-chunks apply."""
    p = str(tmp_path_factory.mktemp("glm4096") / "m.gguf")
    make_tiny_llama_gguf(p, arch="chatglm", n_embd=4096, n_head=32, n_head_kv=2, n_ff=256,
                         n_layer=1, qtype=GGMLType.Q4_K, seed=41)
    return p


@pytest.fixture(scope="module")
def moe_gguf(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("moe") / "m.gguf")
    make_tiny_llama_gguf(p, qtype=GGMLType.Q4_K, seed=21, **MOE)
    return p


def _jax_load(path, **kw):
    from tpullama.models import load_model

    return load_model(path, **kw)


def _port_load(path, **kw):
    from tpullama_torch.models import load_model

    return load_model(path, device="cpu", **kw)


def _to_numpy(t):
    if isinstance(t, dict):
        return {k: _to_numpy(v) for k, v in t.items()}
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _jax_numpy(t):
    import jax

    def conv(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    return jax.tree.map(conv, t)


def _assert_same_tree(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("qtype", [GGMLType.F32, GGMLType.Q4_K], ids=lambda t: t.name)
def test_load_dense_matches(ggufs, qtype):
    j = _jax_load(ggufs[qtype])
    t = _port_load(ggufs[qtype])
    assert t.quant_meta is None and j.quant_meta is None
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    assert vars(t.hparams) == {k: getattr(j.hparams, k) for k in vars(t.hparams)}


def test_load_refuses_moe(tmp_path):
    # a Mixtral-style llama GGUF with group-limited routing (an MoE option
    # not ported yet) loads in the JAX package; the port refuses it, with
    # the loaded hparams carried across too
    from tpullama_torch.models import params_from_numpy

    p = str(tmp_path / "moe.gguf")
    make_tiny_llama_gguf(p, n_embd=64, n_ff=128, n_expert=4, seed=3,
                         extra_kv={"llama.expert_group_count": 2,
                                   "llama.expert_group_used_count": 1})
    j = _jax_load(p)
    assert j.hparams.n_expert_groups == 2
    with pytest.raises(NotImplementedError, match="MoE with group-limited routing"):
        _port_load(p)
    with pytest.raises(NotImplementedError, match="MoE with group-limited routing"):
        params_from_numpy({}, None, j.hparams, device="cpu")


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
def test_load_packed_matches(ggufs, qtype, scale_dtype):
    j = _jax_load(ggufs[qtype], packed=True, packed_scale_dtype=np.dtype(scale_dtype)
                  if scale_dtype == "float32" else "bfloat16")
    t = _port_load(ggufs[qtype], packed=True, packed_scale_dtype=getattr(torch, scale_dtype))
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    for key, jm in j.quant_meta["layers"].items():
        tm = t.quant_meta["layers"][key]
        assert (tm.ggml_type, tm.group, tm.n_out, tm.n_in) == \
               (jm.ggml_type, jm.group, jm.n_out, jm.n_in)
    assert set(t.quant_meta) == set(j.quant_meta)


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
def test_params_from_numpy(ggufs, qtype):
    """A JAX-loaded model carried across equals the port's own load, and
    the port's tensors carried back equal the JAX arrays."""
    import jax

    from tpullama_torch.models import params_from_numpy

    j = _jax_load(ggufs[qtype], packed=True)
    t = _port_load(ggufs[qtype], packed=True)
    carried = params_from_numpy(jax.tree.map(np.asarray, j.params), j.quant_meta, j.hparams,
                                device="cpu")
    _assert_same_tree(_to_numpy(carried.params), _to_numpy(t.params))
    assert carried.quant_meta == t.quant_meta
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))


@pytest.mark.parametrize("mode", ["dense", "packed-f32", "packed-bf16"])
def test_load_moe_matches(moe_gguf, mode):
    """The MoE model's load tree: router and expert stacks (flat
    (n_layer * n_expert, rows_p, kcols) planes, transposed by the planes_t
    rule, gate and up fused) and every QuantMeta field equal the JAX
    package's."""
    kw = {} if mode == "dense" else dict(packed=True)
    jkw, tkw = dict(kw), dict(kw)
    if mode == "packed-f32":
        jkw["packed_scale_dtype"], tkw["packed_scale_dtype"] = np.float32, torch.float32
    j = _jax_load(moe_gguf, **jkw)
    t = _port_load(moe_gguf, **tkw)
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    assert vars(t.hparams) == {k: getattr(j.hparams, k) for k in vars(t.hparams)}
    if mode == "dense":
        assert t.quant_meta is None and j.quant_meta is None
        return
    jm, tm = j.quant_meta["layers"], t.quant_meta["layers"]
    assert set(tm) == set(jm)
    for key, m in jm.items():
        assert (int(tm[key].ggml_type), tm[key].group, tm[key].n_out, tm[key].n_in,
                tm[key].planes_t) == (int(m.ggml_type), m.group, m.n_out, m.n_in, m.planes_t)
    # K = 256 gives 8 scale groups, not a multiple of 128: both stacks transposed
    assert tm["ffn_gateup_exps"].planes_t and tm["ffn_down_exps"].planes_t


@pytest.mark.parametrize("planes_t_env", ["auto", "0"])
def test_params_from_numpy_moe(moe_gguf, planes_t_env, monkeypatch):
    """A JAX-loaded MoE model carried across equals the port's own load and
    the JAX arrays; loaded with TPULLAMA_MOE_PLANES_T=0 (the JAX package's
    switch) it carries row-major expert planes, which the port runs to the
    same logits."""
    import jax

    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.models import params_from_numpy
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    monkeypatch.setenv("TPULLAMA_MOE_PLANES_T", planes_t_env)
    j = _jax_load(moe_gguf, packed=True, packed_scale_dtype=np.float32)
    carried = params_from_numpy(jax.tree.map(np.asarray, j.params), j.quant_meta, j.hparams,
                                device="cpu", vocab=None)
    _assert_same_tree(_to_numpy(carried.params), _jax_numpy(j.params))
    lm = carried.quant_meta["layers"]
    assert lm["ffn_gateup_exps"].planes_t == lm["ffn_down_exps"].planes_t == \
        (planes_t_env == "auto")
    if planes_t_env == "auto":
        t = _port_load(moe_gguf, packed=True, packed_scale_dtype=torch.float32)
        assert carried.quant_meta == t.quant_meta
        _assert_same_tree(_to_numpy(carried.params), _to_numpy(t.params))
    toks = np.asarray(j.vocab.tokenize(LONG_PROMPT, add_special=True))
    lj = JC(j, JCP(n_ctx=96)).decode(toks, n_logits=len(toks))
    lt = TC(carried, TCP(n_ctx=96)).decode(toks, n_logits=len(toks))
    np.testing.assert_allclose(lt, lj, **LOGIT_TOL)


def _contexts(path, n_seqs=1, n_ctx=96, **load_kw):
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    jm = _jax_load(path, **load_kw)
    scale = load_kw.get("packed_scale_dtype")
    t_kw = dict(load_kw)
    if scale is not None:
        t_kw["packed_scale_dtype"] = torch.float32
    tm = _port_load(path, **t_kw)
    return (JC(jm, JCP(n_ctx=n_ctx, n_seqs=n_seqs)), TC(tm, TCP(n_ctx=n_ctx, n_seqs=n_seqs)),
            tm.vocab.tokenize(PROMPT, add_special=True))


def _check_prefill_and_generate(path, prompt=PROMPT, **load_kw):
    jc, tc, _ = _contexts(path, **load_kw)
    toks = tc.model.vocab.tokenize(prompt, add_special=True)
    lj = jc.decode(np.asarray(toks), n_logits=len(toks))
    lt = tc.decode(np.asarray(toks), n_logits=len(toks))
    assert lt.shape == lj.shape
    np.testing.assert_allclose(lt, lj, **LOGIT_TOL)
    jc, tc, _ = _contexts(path, **load_kw)
    out_j = jc.generate(toks, n_predict=12)
    out_t = tc.generate(toks, n_predict=12)
    assert out_t == out_j
    assert int(tc.n_past[0]) == int(jc.n_past[0])
    np.testing.assert_array_equal(tc._pos_host, jc._pos_host)


@pytest.mark.parametrize("qtype", QTYPES + [GGMLType.F32], ids=lambda t: t.name)
def test_prefill_logits_and_greedy_generate(ggufs, qtype):
    load_kw = {} if qtype == GGMLType.F32 else dict(packed=True, packed_scale_dtype=np.float32)
    _check_prefill_and_generate(ggufs[qtype], **load_kw)


@pytest.mark.parametrize("prompt", [PROMPT, LONG_PROMPT], ids=["short", "long"])
@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_moe_prefill_logits_and_greedy_generate(moe_gguf, mode, prompt):
    """The short prompt's prefill runs one-row expert tiles, the long one
    (40 tokens, 80 slots) the dispatch; greedy decode one-row tiles."""
    load_kw = {} if mode == "dense" else dict(packed=True, packed_scale_dtype=np.float32)
    _check_prefill_and_generate(moe_gguf, prompt, **load_kw)


def test_llama_forward_functional(ggufs):
    """The functional llama_forward (the JAX package's signature) on a
    fresh cache gives the JAX logits and writes the same cache rows."""
    import jax.numpy as jnp

    from tpullama.models.llama import llama_forward as j_forward
    from tpullama_torch.models.llama import llama_forward as t_forward

    j = _jax_load(ggufs[GGMLType.Q4_K], packed=True, packed_scale_dtype=np.float32)
    t = _port_load(ggufs[GGMLType.Q4_K], packed=True, packed_scale_dtype=torch.float32)
    hp = t.hparams
    T, S = 7, 128
    toks = np.arange(3, 3 + T, dtype=np.int32)[None]
    pos = np.arange(T, dtype=np.int32)[None]
    slots = pos.copy()
    kv_pos = np.full((1, S), -1, np.int32)
    kv_pos[0, :T] = pos[0]
    vis = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= pos[:, :, None])
    mask = np.where(vis, 0.0, -1e30).astype(np.float32)[:, None]
    shape = (hp.n_layer, 1, hp.n_head_kv, S, hp.n_embd_head_k)
    lj, (kj, vj) = j_forward(j.params, j.hparams, jnp.asarray(toks), jnp.asarray(pos),
                             jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(slots),
                             jnp.asarray(mask), quant_meta=j.quant_meta)
    kt, vt = torch.zeros(shape), torch.zeros(shape)
    lt, (kt2, vt2) = t_forward(t.params, hp, torch.from_numpy(toks), torch.from_numpy(pos),
                               kt, vt, torch.from_numpy(slots), torch.from_numpy(mask),
                               quant_meta=t.quant_meta)
    assert kt2 is kt and vt2 is vt  # written in place
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **LOGIT_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **LOGIT_TOL)


def test_decode_batch_and_burst(ggufs):
    """Multi-sequence prefill (decode_multi), one batched step with an
    inactive lane, then a greedy burst: same logits, same burst ids, same
    cache bookkeeping; rollback_to and seq_rm move both the same way."""
    _check_decode_batch_and_burst(ggufs[GGMLType.Q4_K])


def test_moe_decode_batch_and_burst(moe_gguf):
    """test_decode_batch_and_burst on the MoE model."""
    _check_decode_batch_and_burst(moe_gguf)


def _check_decode_batch_and_burst(path):
    jc, tc, toks = _contexts(path, n_seqs=3, packed=True, packed_scale_dtype=np.float32)
    chunks = [(0, toks), (2, toks[:3] + [70, 71, 72, 73])]
    mj = jc.decode_multi(chunks)
    mt = tc.decode_multi(chunks)
    for s, _ in chunks:
        np.testing.assert_allclose(mt[s], mj[s], **LOGIT_TOL)
    first = np.asarray([int(np.argmax(mj[0])), 0, int(np.argmax(mj[2]))], np.int32)
    active = np.asarray([True, False, True])
    bj = jc.decode_batch(first, active)
    bt = tc.decode_batch(first, active)
    np.testing.assert_allclose(bt[active], bj[active], **LOGIT_TOL)
    nxt = np.argmax(bj, axis=-1).astype(np.int32)
    out_j = jc.decode_batch_burst(nxt, active, 6)
    out_t = tc.decode_batch_burst(nxt, active, 6)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(tc.n_past, jc.n_past)
    np.testing.assert_array_equal(tc._pos_host, jc._pos_host)
    for c in (jc, tc):
        c.rollback_to(int(c.n_past[0]) - 2, seq_id=0)
        c.seq_rm(3, 5, seq_id=2)
    np.testing.assert_array_equal(tc.n_past, jc.n_past)
    np.testing.assert_array_equal(tc._pos_host, jc._pos_host)
    np.testing.assert_array_equal(tc.kv_pos.numpy(), np.asarray(jc.kv_pos))
    again = np.asarray(out_j[-1], np.int32)
    np.testing.assert_allclose(tc.decode_batch(again, active)[active],
                               jc.decode_batch(again, active)[active], **LOGIT_TOL)
    tc.reset()
    assert int(tc.n_past.sum()) == 0 and bool((tc.kv_pos == -1).all())


def _serve(pkg, model, script, n_slots=2, **engine_kw):
    """Run `script` (a list of rounds, each a list of request kwargs) through
    the package's ServerEngine in synchronous mode; every round's requests
    are submitted together. Returns each task's outcome."""
    if pkg == "jax":
        from tpullama.runtime.sampling import SamplerChain
        from tpullama.server.engine import ServerEngine, Task
    else:
        from tpullama_torch.runtime.sampling import SamplerChain
        from tpullama_torch.server import ServerEngine, Task

    eng = ServerEngine(model, n_slots=n_slots, n_ctx=128, n_ubatch=16, **engine_kw)
    outcomes = []
    for round_ in script:
        tasks = []
        for req in round_:
            req = dict(req)
            seed = req.pop("seed", None)
            sampler = None if seed is None else SamplerChain.from_params(seed=seed, temp=0.9)
            prompt = model.vocab.tokenize(req.pop("prompt"), add_special=True)
            tasks.append(eng.submit(Task(prompt_tokens=prompt, sampler=sampler, **req)))
        while not all(t.done.is_set() for t in tasks):
            eng.step()
        outcomes += [(t.out_tokens, t.out_text, t.stop_reason, t.stop_word, t.error)
                     for t in tasks]
    return outcomes, eng


def test_server_engine_script(ggufs):
    """Concurrent greedy and sampled requests with prompt chunks, a stop
    string, a prompt-cache reuse, a too-long prompt and a burst-decoded
    tail: the same completions and stop reasons as the JAX engine."""
    _check_server_script(ggufs[GGMLType.Q4_K])


def test_moe_server_engine_script(moe_gguf):
    """test_server_engine_script on the MoE model."""
    _check_server_script(moe_gguf)


def _check_server_script(path):
    jm = _jax_load(path, packed=True, packed_scale_dtype=np.float32)
    tm = _port_load(path, packed=True, packed_scale_dtype=torch.float32)
    long_prompt = "The quick brown fox jumps over the lazy dog. " * 2
    first, _ = _serve("jax", jm, [[dict(prompt=long_prompt, n_predict=12)]])
    stop = first[0][1][4:6]  # a piece of the greedy text: ends a request early
    script = [
        [dict(prompt=long_prompt, n_predict=12), dict(prompt=PROMPT, n_predict=9, seed=5),
         dict(prompt="x" * 200, n_predict=4)],
        [dict(prompt=long_prompt, n_predict=12, stop=[stop])],
        [dict(prompt=long_prompt + "again", n_predict=20)],
    ]
    out_j, eng_j = _serve("jax", jm, script)
    out_t, eng_t = _serve("torch", tm, script)
    assert out_t == out_j
    assert out_t[0][2] == "length" and out_t[3][2] == "stop" and out_t[2][4]
    assert eng_t.metrics == {k: eng_j.metrics[k] for k in eng_t.metrics}
    assert eng_t.ctx.perf.n_reused == eng_j.ctx.perf.n_reused > 0


# ------------------------------------------------------------ qwen2


@pytest.fixture(scope="module")
def qwen_g7(tmp_path_factory):
    """qwen2 (q/k/v biases) with 7 query heads on one kv head, head dim 64:
    GQA group 7, Qwen2-7B's group (28/4), which the card kernels take now."""
    p = str(tmp_path_factory.mktemp("qwen7") / "m.gguf")
    make_tiny_llama_gguf(p, arch="qwen2", n_embd=448, n_head=7, n_head_kv=1, n_ff=256,
                         seed=17)
    return p


def test_qwen2_group7_prefill_logits_and_greedy_generate(qwen_g7):
    _check_prefill_and_generate(qwen_g7)


# ------------------------------------------------------------ chatglm


def test_glm_prefill_logits_and_greedy_generate(glm_small):
    """chatglm F32: fused biased [Q|K|V], fused [gate|up] SwiGLU and NORM
    rope over half the head dim."""
    _check_prefill_and_generate(glm_small)


def _glm_pair(path, monkeypatch, scale=np.float32):
    """The JAX model loaded under TPULLAMA_FUSED_LAYER=1 (fourblock planes;
    on the CPU its forward keeps the unfused exact qmm path) and the port's
    with fused_layer=True."""
    monkeypatch.setenv("TPULLAMA_FUSED_LAYER", "1")
    j = _jax_load(path, packed=True, packed_scale_dtype=scale)
    t = _port_load(path, packed=True, fused_layer=True,
                   packed_scale_dtype=torch.float32 if scale == np.float32 else torch.bfloat16)
    return j, t


def test_glm_fourblock_load_and_params_from_numpy(glm_4096, monkeypatch):
    """Under the fused layer both loaders store attn_output, ffn_up and
    ffn_down in fourblock order and attn_qkv in stripe order; the JAX
    fourblock params carried across equal the port's load byte for byte."""
    import jax

    from tpullama_torch.models import params_from_numpy

    j, t = _glm_pair(glm_4096, monkeypatch, scale="bfloat16")
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    orders = {k: m.order for k, m in t.quant_meta["layers"].items()}
    assert orders == {k: m.order for k, m in j.quant_meta["layers"].items()} == {
        "attn_qkv": "stripe", "attn_output": "fourblock", "ffn_up": "fourblock",
        "ffn_down": "fourblock"}
    assert t.hparams.ffn_fused_up and t.hparams.rope_type == 0 and t.hparams.n_rot == 64
    carried = params_from_numpy(jax.tree.map(np.asarray, j.params), j.quant_meta, j.hparams,
                                device="cpu")
    _assert_same_tree(_to_numpy(carried.params), _to_numpy(t.params))
    assert carried.quant_meta == t.quant_meta


def test_glm_fused_ktiled_greedy_matches_jax(glm_4096, monkeypatch):
    """The port's CPU path with the fused layer and 4 K-chunks (the plain
    versions of both kernels) against the JAX exact path: prefill logits
    within LOGIT_TOL, 8 greedy tokens identical; every decode step took the
    fused path and attn_qkv the K-chunked product."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.ops.cuda import fused_layer, qmm
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    j, t = _glm_pair(glm_4096, monkeypatch)
    toks = np.asarray(t.vocab.tokenize(PROMPT, add_special=True))
    tc = TC(t, TCP(n_ctx=64), fused_layer=True, qmm_tile_k=4)
    assert [layer.fused for layer in tc.net.layers] == [True]
    lj = JC(j, JCP(n_ctx=64)).decode(toks, n_logits=len(toks))
    lt = tc.decode(toks, n_logits=len(toks))
    np.testing.assert_allclose(lt, lj, **LOGIT_TOL)

    calls = {"fused": 0, "ktiled": 0}
    plain_fused, plain_kt = fused_layer.fused_postattn_plain, qmm.quantized_matmul_ktiled_plain

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fused_layer, "fused_postattn_plain", count("fused", plain_fused))
    monkeypatch.setattr(qmm, "quantized_matmul_ktiled_plain", count("ktiled", plain_kt))
    out_t = TC(t, TCP(n_ctx=64), fused_layer=True, qmm_tile_k=4).generate(toks, n_predict=8)
    out_j = JC(j, JCP(n_ctx=64)).generate(toks, n_predict=8)
    assert out_t == out_j
    # the prefill, then one one-token step per generated token; attn_qkv and
    # the Q4_K lm_head (K = 4096) take the K-chunks at every step
    assert calls == {"fused": len(out_t), "ktiled": 2 * (len(out_t) + 1)}


def test_glm_server_script(glm_4096, monkeypatch):
    """ServerEngine with one slot (every decode step B = 1: the fused path
    and the K-chunked attn_qkv) against the JAX engine: the same greedy and
    sampled completions and stop reasons."""
    j, t = _glm_pair(glm_4096, monkeypatch)
    script = [[dict(prompt=PROMPT, n_predict=10)],
              [dict(prompt="The quick brown fox", n_predict=6, seed=3)]]
    out_j, _ = _serve("jax", j, script, n_slots=1)
    out_t, eng = _serve("torch", t, script, n_slots=1, fused_layer=True, qmm_tile_k=4)
    assert out_t == out_j
    assert [layer.fused for layer in eng.ctx.net.layers] == [True]
    assert eng.ctx.net.qmm_tile_k == 4


def test_model_options_read_env_once(glm_small, monkeypatch):
    """LlamaModel reads TPULLAMA_FUSED_LAYER and TPULLAMA_QMM_TILE_K when it
    is built and not afterwards; explicit arguments win."""
    from tpullama_torch.models.llama import LlamaModel

    t = _port_load(glm_small)
    monkeypatch.setenv("TPULLAMA_FUSED_LAYER", "1")
    monkeypatch.setenv("TPULLAMA_QMM_TILE_K", "4")
    net = LlamaModel(t.params, t.hparams, t.quant_meta)
    assert (net.fused_layer, net.qmm_tile_k) == (True, 4)
    monkeypatch.setenv("TPULLAMA_FUSED_LAYER", "0")
    monkeypatch.delenv("TPULLAMA_QMM_TILE_K")
    assert (net.fused_layer, net.qmm_tile_k) == (True, 4)
    net = LlamaModel(t.params, t.hparams, t.quant_meta, fused_layer=True, qmm_tile_k=2)
    assert (net.fused_layer, net.qmm_tile_k) == (True, 2)
    net = LlamaModel(t.params, t.hparams, t.quant_meta)
    assert (net.fused_layer, net.qmm_tile_k) == (False, None)
    # dense weights: the fused path does not apply
    assert not any(layer.fused for layer in
                   LlamaModel(t.params, t.hparams, t.quant_meta, fused_layer=True).layers)
