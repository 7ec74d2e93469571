"""The post-norm archs and their neighbours, held against the JAX package
on the CPU on the JAX oracle's fixtures and seeds (tests/test_e2e_oracle.py;
F32): olmo (LayerNorms without tensors, the qkv clamp, NORM rope, tied),
olmo2 (post-norm blocks: attention and FFN read the residual stream,
post_attention_norm and post_ffw_norm norm their outputs; full-width q/k
RMS norms; NEOX rope), exaone4 (post-norm blocks, per-head q/k RMS norms;
at exactly 64 layers SWA layers with NoPE full layers), chameleon (per-head
LayerNorm q/k norms with biases, the image rows of the logits at the f32
minimum; its swin variant's norms on the block outputs), bitnet (one-element
projection scales, the attention and FFN sub-norms) and olmoe (MoE with
full-width q/k norms and un-normalised top-k weights). This file holds
olmo, olmo2, exaone4 at 2 layers and olmoe, the pre-norm flag, olmo's
clamp, a packed olmo2 through decode_batch, a burst and a shift, and the
fused path's gate; tests/test_torch_postnorm_archs_b.py chameleon (both
variants), bitnet (F32 and TQ2_0), exaone4's 64-layer layout, the
engines and the card's cases.

Cases per arch: the hparams equal the JAX package's field by field; the
loaded params equal the JAX package's, and so do the JAX params carried
across by params_from_numpy; the prefill logits within LOGIT_TOL; 8
greedy tokens from a fresh Context identical to the JAX Context's.

Tolerances: trees exactly; logits within rtol = atol = 1e-4 (f32 sums in
another order); tokens exactly; shifted K rows within 1e-5 of their
largest magnitude (one f32 rotation in each package)."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_flag_archs import check_greedy, check_load, check_prefill, reference
from tests.test_torch_model import (LOGIT_TOL, PROMPT, _assert_same_tree,
                                    _check_decode_batch_and_burst, _edit_gguf, _jax_numpy,
                                    _port_load, _to_numpy)
from tpullama.gguf import GGMLType
from tpullama.models.testing import make_tiny_llama_gguf

# the JAX oracle's settings per case (tests/test_e2e_oracle.py:144-158,
# 293-310, 355-373, 398-428, 526-535); exaone4-64 is exaone4's at its 32B
# layout, 64 layers, with a window of 32 so that the ring wraps
FIXTURES = {
    "olmo": dict(seed=31, tied_output=True), "olmo2": dict(seed=17),
    "olmoe": dict(seed=31, n_expert=4, n_head_kv=4), "exaone4": dict(seed=43, n_head_kv=2),
    "exaone4-64": dict(seed=43, n_head_kv=2, n_layer=64,
                       extra_kv={"exaone4.attention.sliding_window": 32}),
    "chameleon": dict(seed=53, n_head_kv=2),
    "chameleon-swin": dict(seed=54, n_head_kv=2, extra_kv={"swin_norm": True}),
    "bitnet": dict(seed=85, n_head_kv=2, tied_output=True),
    "bitnet-tq2": dict(seed=85, n_head_kv=2, tied_output=True, n_embd=256, n_ff=256,
                       qtype=GGMLType.TQ2_0),
}
FIRST = ("olmo", "olmo2", "exaone4", "olmoe")
PACKED = dict(n_embd=256, n_ff=256, qtype=GGMLType.Q4_K)
PACKED_LOAD = dict(packed=True, packed_scale_dtype=np.float32)
POST_NORM = ("olmo2", "exaone4", "exaone4-64", "chameleon-swin")
HUGE = (1 << 30) - 1


def arch_of(case: str) -> str:
    return case.split("-")[0]


def fixture_file(tmp_path_factory, case, tag="", **kw):
    """The case's oracle fixture (2 layers unless it says), `kw` over its
    settings."""
    p = str(tmp_path_factory.mktemp(f"{case}{tag}") / "m.gguf")
    make_tiny_llama_gguf(p, arch=arch_of(case), **{"n_layer": 2, **FIXTURES[case], **kw})
    return p


def check_case_tensors(case, t):
    """What each case's file gives the loader, beside the JAX package's."""
    hp, layers, top = t.hparams, t.params["layers"], t.params
    assert hp.pre_norm == (case not in POST_NORM)
    assert hp.swin_norm == (case == "chameleon-swin")
    assert hp.norm_nonparam == (case == "olmo")
    assert hp.norm_type == ("layer" if case == "olmo" else "rms")
    assert hp.f_clamp_kqv == (2.0 if case == "olmo" else 0.0)
    assert hp.qk_norm_full == (case in ("olmo2", "olmoe"))
    assert hp.qk_norm_ln == arch_of(case).startswith("chameleon")
    assert hp.rope_type == (0 if case in ("olmo", "chameleon", "chameleon-swin") else 2)
    assert hp.moe_norm_topk == (case != "olmoe")
    # no pre-norm tensor where the block has none (olmo: no norm tensor at all)
    assert ("attn_norm" in layers) == ("ffn_norm" in layers) == (
        case not in POST_NORM and case != "olmo")
    assert ("output_norm" in top) == (case != "olmo")
    post = case in ("olmo2", "exaone4", "exaone4-64", "chameleon-swin")
    assert ("post_attn_norm" in layers) == ("post_ffn_norm" in layers) == post
    n_embd, kv = hp.n_embd, hp.n_head_kv * hp.n_embd_head_k
    if case in ("olmo2", "olmoe"):
        assert tuple(layers["attn_q_norm"].shape[1:]) == (n_embd,)
        assert tuple(layers["attn_k_norm"].shape[1:]) == (kv,)
    if arch_of(case) == "chameleon":
        for k, h in (("attn_q_norm", hp.n_head), ("attn_k_norm", hp.n_head_kv)):
            assert tuple(layers[k].shape[1:]) == tuple(layers[k + "_bias"].shape[1:]) == (
                h, hp.n_embd_head_k)
    bitnet = ("attn_q_scale", "attn_k_scale", "attn_v_scale", "attn_output_scale",
              "ffn_gate_scale", "ffn_up_scale", "ffn_down_scale")
    for k in bitnet:
        assert (k in layers) == (arch_of(case) == "bitnet")
        if k in layers:
            assert tuple(layers[k].shape) == (hp.n_layer, 1)
    assert ("attn_sub_norm" in layers) == (arch_of(case) == "bitnet")


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


@pytest.mark.parametrize("case", ["olmo2", "olmo"])
def test_pre_norm_flag_decides(refs, tmp_path_factory, case):
    """hp.pre_norm decides whether a block norms its input, not the tensors
    the file holds. olmo2 (post-norm) with attn_norm and ffn_norm tensors
    added to its file: both packages load them and neither reads them, so
    the logits stay the plain file's. olmo (pre-norm, no norm tensor at
    all): its LayerNorms run without weights; a file with weights of ones
    and biases of zeros added gives the same logits in both packages."""
    from tpullama.gguf import GGUFReader

    src = refs[case]["path"]
    n_embd = GGUFReader(src).kv[f"{case}.embedding_length"]
    ones, zeros = np.ones(n_embd, np.float32), np.zeros(n_embd, np.float32)
    extra = {f"blk.{il}.{nm}.weight": 0.5 + ones if case == "olmo2" else ones
             for il in range(2) for nm in ("attn_norm", "ffn_norm")}
    if case == "olmo":
        extra.update({f"blk.{il}.{nm}.bias": zeros for il in range(2)
                      for nm in ("attn_norm", "ffn_norm")})
        extra.update({"output_norm.weight": ones, "output_norm.bias": zeros})
    path = str(tmp_path_factory.mktemp(f"{case}_prenorm") / "m.gguf")
    _edit_gguf(src, path, tensors=extra)
    ref = reference(path)
    t = check_load(ref)
    assert t.hparams.pre_norm == (case == "olmo")
    assert {"attn_norm", "ffn_norm"} <= set(t.params["layers"])
    check_prefill(ref, t)
    np.testing.assert_allclose(ref["logits"], refs[case]["logits"], rtol=1e-5, atol=1e-5)


def test_olmo_clamp_bites(refs):
    """The fixture's clamp of 2.0 cuts q: layer 0's q projection of the
    prompt (LayerNorm without weights, then attn_q) exceeds it somewhere.
    With the clamp off in both models' hparams the logits move, and the
    port's still match the JAX package's."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.ops.norms import layer_norm

    ref = refs["olmo"]
    t = _port_load(ref["path"])
    hp = t.hparams
    x = t.params["tok_embd"][torch.as_tensor(ref["toks"]).long()]
    q = layer_norm(x, None, None, hp.f_norm_eps) @ t.params["layers"]["attn_q"][0].T
    assert float(q.abs().max()) > hp.f_clamp_kqv == 2.0
    jm = ref["model"]
    try:
        hp.f_clamp_kqv = jm.hparams.f_clamp_kqv = 0.0
        toks = np.asarray(ref["toks"])
        lj = np.asarray(JC(jm, JCP(n_ctx=64)).decode(toks, n_logits=len(toks)))
        check_prefill({**ref, "logits": lj}, t)
    finally:
        jm.hparams.f_clamp_kqv = 2.0
    assert float(np.abs(lj - ref["logits"]).max()) > 1e-3


@pytest.fixture(scope="module")
def olmo2_q4k(tmp_path_factory):
    """olmo2 at n_embd 256, every layer matrix Q4_K."""
    return fixture_file(tmp_path_factory, "olmo2", "_q4k", **PACKED)


def test_packed_olmo2_matches_jax(olmo2_q4k):
    """The served arch packed in both packages: the same planes (every
    layer matrix and the output), prefill logits, greedy tokens; then
    decode_multi over two lanes, a batched step with an inactive lane and
    a greedy burst against the JAX Context."""
    ref = reference(olmo2_q4k, **PACKED_LOAD)
    tm = _port_load(olmo2_q4k, packed=True, packed_scale_dtype=torch.float32)
    _assert_same_tree(_to_numpy(tm.params), _jax_numpy(ref["model"].params))
    assert set(tm.quant_meta["layers"]) == {"attn_q", "attn_k", "attn_v", "attn_output",
                                            "ffn_gate", "ffn_up", "ffn_down"}
    assert "output" in tm.quant_meta
    check_prefill(ref, tm)
    check_greedy(ref, tm)
    _check_decode_batch_and_burst(olmo2_q4k)


def test_packed_olmo2_shift_matches_jax(olmo2_q4k):
    """seq_rm of the first 3 tokens and seq_add(-3) on the packed olmo2:
    layer 0's K rows (their token and position alone: the full-width k
    norm sits before rope) equal a fresh prefill of the kept tokens and
    the JAX package's shifted rows; the next tokens' logits after the
    shift equal the JAX Context's."""
    from tpullama.models import load_model as j_load
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.runtime import Context, ContextParams

    tm = _port_load(olmo2_q4k, packed=True, packed_scale_dtype=torch.float32)
    jm = j_load(olmo2_q4k, **PACKED_LOAD)
    toks = np.asarray(tm.vocab.tokenize(PROMPT + " there was", add_special=True))
    n = len(toks) - 3
    shifted, fresh = (Context(tm, ContextParams(n_ctx=64)) for _ in range(2))
    jc = JC(jm, JCP(n_ctx=64))
    for c in (shifted, jc):
        c.decode(toks)
        c.seq_rm(0, 3)
        c.seq_add(3, HUGE, -3)
    fresh.decode(toks[3:])
    np.testing.assert_array_equal(shifted._pos_host, jc._pos_host)
    pos = shifted._pos_host[0]
    cells = np.argsort(np.where(pos >= 0, pos, 1 << 20))[:n]
    got, want = shifted.kv_k[0, 0][:, cells], fresh.kv_k[0, 0][:, :n]
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    j_rows = torch.from_numpy(np.asarray(jc.kv_k[0, 0])[:, cells])
    assert float((got - j_rows).abs().max()) <= tol
    for tok in (65, 66):
        np.testing.assert_allclose(shifted.decode(np.asarray([tok])),
                                   np.asarray(jc.decode(np.asarray([tok]))), **LOGIT_TOL)


def test_fused_path_stays_off(tmp_path_factory):
    """With the fused layer asked for, no layer of the six archs takes the
    fused post-attention path: a post-norm block is outside its gate, as in
    the JAX package (llama.py:661-663), olmo's LayerNorm too, bitnet's
    sub-norms and scales are in _FUSED_EXCLUDE, olmoe's layers are MoE;
    packed Q4_K files at n_embd 256 (exaone4's 2-layer layout: the 64-layer
    one has the same blocks)."""
    from tests._torch_fixtures import quick_seqsum
    from tpullama_torch.models.llama import LlamaModel

    for case in ("olmo", "olmo2", "exaone4", "olmoe", "chameleon", "chameleon-swin", "bitnet"):
        with quick_seqsum():
            path = fixture_file(tmp_path_factory, case, "_fused", **PACKED)
        tm = _port_load(path, packed=True, fused_layer=True)
        net = LlamaModel(tm.params, tm.hparams, tm.quant_meta, fused_layer=True)
        assert net.fused_layer and not any(layer.fused for layer in net.layers), case
