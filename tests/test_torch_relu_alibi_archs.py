"""The squared-relu / xIELU archs and the first ALiBi archs, held against
the JAX package on the CPU on the JAX oracle's fixtures and seeds
(tests/test_e2e_oracle.py; F32): nemotron (LayerNorm with biases, the
non-gated squared-relu FFN with biases, NEOX rope), arcee (the non-gated
squared relu over RMS norms, NORM rope), apertus (the non-gated xIELU
with per-layer coefficients, per-head q/k RMS norms), mpt (ALiBi, the
qkv clamp, LayerNorms, a non-gated GELU FFN, no rope, tied) and bloom
(ALiBi, the embedding LayerNorm, tied). This file holds those five, the
activations and their refusal, mpt's full-width q/k norms and the packed
files; tests/test_torch_relu_alibi_archs_b.py jais, refact and baichuan
at both of its layouts, the ALiBi mask and slopes, the engines and the
card's cases.

Cases per arch: the hparams equal the JAX package's field by field; the
loaded params equal the JAX package's, and so do the JAX params carried
across by params_from_numpy; the prefill logits within LOGIT_TOL; 8
greedy tokens from a fresh Context identical to the JAX Context's.

Tolerances: trees exactly; logits within rtol = atol = 1e-4 (f32 sums in
another order); tokens exactly; the activations within 1e-6 of their
largest magnitude (one f32 expression against the same one in XLA)."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_flag_archs import check_greedy, check_load, check_prefill, reference
from tests.test_torch_model import _assert_same_tree, _edit_gguf, _jax_numpy, _port_load, _to_numpy
from tpullama.gguf import GGMLType
from tpullama.models.testing import make_tiny_llama_gguf

# the JAX oracle's settings per case (tests/test_e2e_oracle.py:271-330,
# 354-368, 505-514): baichuan at its 7B layout (32 layers) and its 13B one
# (40 layers, where ALiBi replaces rope)
FIXTURES = {
    "nemotron": dict(seed=31), "arcee": dict(seed=31), "apertus": dict(seed=67, n_head_kv=2),
    "mpt": dict(seed=29, n_head_kv=4, tied_output=True),
    "bloom": dict(seed=29, n_head_kv=4, tied_output=True),
    "jais": dict(seed=43, n_head_kv=2), "refact": dict(seed=37, n_head_kv=4),
    "baichuan": dict(seed=37, n_head_kv=4, n_layer=32),
    "baichuan-13b": dict(seed=37, n_head_kv=4, n_layer=40),
}
FIRST = ("nemotron", "arcee", "apertus", "mpt", "bloom")
ALIBI = ("mpt", "bloom", "jais", "refact", "baichuan-13b")
PACKED = dict(n_embd=256, n_ff=256, qtype=GGMLType.Q4_K)
PACKED_LOAD = dict(packed=True, packed_scale_dtype=np.float32)


def arch_of(case: str) -> str:
    return "baichuan" if case.startswith("baichuan") else case


def fixture_file(tmp_path_factory, case, tag="", **kw):
    """The case's oracle fixture (2 layers unless it says), `kw` over its
    settings."""
    p = str(tmp_path_factory.mktemp(f"{case}{tag}") / "m.gguf")
    opts = {"n_layer": 2, **FIXTURES[case], **kw}
    make_tiny_llama_gguf(p, arch=arch_of(case), **opts)
    return p


def check_case_tensors(case, t):
    """What each case's file gives the loader, beside the JAX package's."""
    hp, layers, top = t.hparams, t.params["layers"], t.params
    assert hp.act == {"nemotron": "relu_sqr", "arcee": "relu_sqr", "apertus": "xielu",
                      "mpt": "gelu", "bloom": "gelu"}.get(case, "silu")
    assert hp.ffn_gated == (case in ("jais", "refact", "baichuan", "baichuan-13b"))
    assert (hp.f_max_alibi_bias > 0) == (case in ALIBI)
    assert hp.rope_type == {"nemotron": 2, "apertus": 2, "arcee": 0, "baichuan": 0}.get(case, -1)
    assert hp.norm_type == ("layer" if case in ("nemotron", "mpt", "bloom", "jais") else "rms")
    assert hp.f_clamp_kqv == (2.0 if case == "mpt" else 0.0)
    assert hp.qk_norm_full == (case == "mpt")
    assert ("token_embd_norm" in top) == ("token_embd_norm_bias" in top) == (case == "bloom")
    assert ("output" in top) == (case not in ("mpt", "bloom"))
    assert len(hp.xielu_params) == (hp.n_layer if case == "apertus" else 0)
    if case == "jais":
        assert hp.f_attention_scale == 1.0 / hp.n_embd_head_v
        assert {"ffn_gate_bias", "ffn_up_bias", "ffn_down_bias", "attn_qkv_bias"} <= set(layers)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return {case: reference(fixture_file(tmp_path_factory, case)) for case in FIRST}


@pytest.mark.parametrize("case", FIRST)
def test_load_matches_jax(refs, case):
    check_case_tensors(case, check_load(refs[case]))


@pytest.mark.parametrize("case", FIRST)
def test_prefill_logits_match_jax(refs, case):
    check_prefill(refs[case], _port_load(refs[case]["path"]))


@pytest.mark.parametrize("case", FIRST)
def test_greedy_tokens_match_jax(refs, case):
    check_greedy(refs[case], _port_load(refs[case]["path"]))


def jax_branch(act: str, up: np.ndarray, coeffs=None) -> np.ndarray:
    """The JAX package's non-gated activation branch on f32 values
    (tpullama/models/llama.py:850-863), as it stands there."""
    import jax.numpy as jnp

    uf = jnp.asarray(up, jnp.float32)
    if act == "relu_sqr":
        return np.asarray(jnp.maximum(uf, 0) ** 2)
    a_n, a_p, b_, e_ = (jnp.float32(c) for c in coeffs)
    return np.asarray(jnp.where(uf > 0, a_p * uf * uf + b_ * uf,
                                (jnp.expm1(jnp.minimum(uf, e_)) - uf) * a_n + b_ * uf))


@pytest.mark.parametrize("act", ["relu_sqr", "xielu"])
def test_activations_match_the_jax_branch(refs, act):
    """relu_sqr and xIELU (with apertus's layer-1 coefficients, read by both
    packages) over values across zero, eps and far below: the port's
    FFN_ACTS entry against the JAX branch."""
    from tpullama_torch.models.llama import FFN_ACTS

    x = np.concatenate([np.linspace(-30, 30, 601), [-1e-6, -2e-6, -5e-7, 0.0, 5e-7],
                        np.random.default_rng(4).standard_normal(400) * 3]).astype(np.float32)
    coeffs = refs["apertus"]["model"].hparams.xielu_params[1] if act == "xielu" else None
    w = {"_xielu": torch.tensor(coeffs, dtype=torch.float32)} if coeffs else {}
    got = FFN_ACTS[act](torch.from_numpy(x), w).numpy()
    want = jax_branch(act, x, coeffs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    if act == "xielu":
        # the negative side runs on expm1(min(x, eps)): both sides of eps
        assert (x < coeffs[3]).any() and ((x > coeffs[3]) & (x <= 0)).any()


def test_xielu_rows_match_jax(refs):
    """apertus's per-layer (alpha_n', alpha_p', beta, eps) rows: the
    JAX package's softplus'd values bit for bit, one row a layer, each
    layer's FFN reading its own."""
    from tpullama_torch.models.llama import LlamaModel

    t = _port_load(refs["apertus"]["path"])
    want = refs["apertus"]["model"].hparams.xielu_params
    assert t.hparams.xielu_params == want and len(want) == 2 and want[0] != want[1]
    net = LlamaModel(t.params, t.hparams)
    for li, layer in enumerate(net.layers):
        assert layer.w["_xielu"].tolist() == list(np.float32(want[li]))
        assert not layer.fused
    assert "_xielu" not in t.params["layers"]


@pytest.mark.parametrize("act", ["relu", "swiglu_oai", "geglu"])
def test_unknown_activation_is_refused(refs, act):
    """An FFN activation outside gelu, silu, relu_sqr and xielu is refused by
    the arch and the name, by the loader's check, the model and the
    Context; nothing maps it to SiLU."""
    from tpullama_torch.models.loader import check_supported
    from tpullama_torch.models.llama import LlamaModel
    from tpullama_torch.runtime import Context, ContextParams

    t = _port_load(refs["arcee"]["path"])
    t.hparams.act = act
    msg = rf"arch 'arcee' with FFN activation '{act}' is not ported"
    for build in (lambda: check_supported(t.hparams), lambda: LlamaModel(t.params, t.hparams),
                  lambda: Context(t, ContextParams(n_ctx=32))):
        with pytest.raises(NotImplementedError, match=msg):
            build()


def test_mpt_full_width_qk_norm_matches_jax(tmp_path_factory):
    """mpt's q/k LayerNorms with biases over the full projection width
    (attn_q_norm (n_embd,), attn_k_norm (n_head_kv * head_dim,)), after
    the biases and the clamp and before the reshape: both packages map
    and apply them, and they move the logits."""
    from tpullama.gguf import GGUFReader

    src = fixture_file(tmp_path_factory, "mpt", "_qk_src")
    r = GGUFReader(src)
    n_embd = r.tensors["blk.0.attn_norm.weight"].shape[0]
    kv = (r.tensors["blk.0.attn_qkv.weight"].shape[0] - n_embd) // 2
    rng = np.random.default_rng(8)
    extra = {}
    for il in range(2):
        for nm, n in (("attn_q_norm", n_embd), ("attn_k_norm", kv)):
            extra[f"blk.{il}.{nm}.weight"] = (1 + 0.3 * rng.standard_normal(n)).astype(np.float32)
            extra[f"blk.{il}.{nm}.bias"] = (0.3 * rng.standard_normal(n)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("mpt_qk") / "m.gguf")
    _edit_gguf(src, path, tensors=extra)
    ref = reference(path)
    t = check_load(ref)
    layers = t.params["layers"]
    assert tuple(layers["attn_q_norm"].shape) == (2, n_embd)
    assert tuple(layers["attn_k_norm_bias"].shape) == (2, kv)
    check_prefill(ref, t)
    check_greedy(ref, t)
    plain = reference(src)
    assert np.abs(plain["logits"] - ref["logits"]).max() > 1e-3


@pytest.mark.parametrize("case", ["mpt", "bloom"])
def test_alibi_moves_the_logits(refs, case):
    """The slopes reach the scores: the same weights with ALiBi off (a plain
    causal mask, no slopes) give other logits than the JAX package's, which
    the port's with ALiBi match (the prefill test)."""
    from tpullama_torch.runtime import Context, ContextParams

    t = _port_load(refs[case]["path"])
    assert Context(t, ContextParams(n_ctx=64)).net.alibi is not None
    t.hparams.f_max_alibi_bias = 0.0
    ctx = Context(t, ContextParams(n_ctx=64))
    assert ctx.net.alibi is None
    toks = np.asarray(refs[case]["toks"])
    plain = ctx.decode(toks, n_logits=len(toks))
    assert np.abs(plain - refs[case]["logits"]).max() > 1e-2


@pytest.mark.parametrize("case", ["nemotron", "apertus", "bloom"])
def test_packed_q4k_matches_jax(tmp_path_factory, case):
    """n_embd 256, every layer matrix Q4_K, packed in both packages: the
    same planes, then the JAX package's prefill logits and greedy tokens
    (bloom's tied lm_head the dense token table in both)."""
    path = fixture_file(tmp_path_factory, case, "_q4k", **PACKED)
    ref = reference(path, **PACKED_LOAD)
    tm = _port_load(path, packed=True, packed_scale_dtype=torch.float32)
    _assert_same_tree(_to_numpy(tm.params), _jax_numpy(ref["model"].params))
    check_prefill(ref, tm)
    check_greedy(ref, tm)
    qkv = {"attn_qkv"} if case == "bloom" else {"attn_q", "attn_k", "attn_v"}
    assert set(tm.quant_meta["layers"]) == qkv | {"attn_output", "ffn_up", "ffn_down"}
    assert ("output" in tm.quant_meta) == (case != "bloom")
