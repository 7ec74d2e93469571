"""gpt-oss and bailingmoe2 held against the JAX package on the CPU.

gpt-oss (make_tiny_llama_gguf(arch="gpt-oss"): q/k/v/o biases, per-head
attention sinks, the router bias, per-expert gate/up/down biases,
swiglu_oai experts under post-top-k softmax gating, a sliding window of 32
on the even layers) at n_embd = n_ff = 256 and 2 layers (one SWA layer,
one full), F32 and Q4_K, 4 experts, 2 a token: swiglu_oai; moe_ffn with
the biases on its three routes (dense per pair, dense sorted by expert,
and packed through the gathered product's plain version, one-row tiles
and dispatched tiles); the loaded hparams and trees; prefill logits
through a prompt longer than the ring (n_ubatch 16, so the ring's 49
cells wrap) and greedy tokens, dense and packed; the CLI's greedy text and
a 2-slot ServerEngine's requests on the two-stack cache.
Group-limited routing: moe_ffn with n_expert_groups=4, n_group_used=2, and
a Mixtral-style model with those fields set on both packages' HParams.
bailingmoe2 on the JAX oracle's batch-j fixture (tests/test_e2e_oracle.py:
4 layers of which the last is its NextN layer, 4 experts, 2 KV heads):
greedy tokens, and the NextN layer skipped unread.

Tolerances: logits within rtol = atol = 1e-4 (f32 sums in another order,
as tests/test_torch_model.py); moe_ffn within rtol = atol = 1e-5 (one
layer of f32 products, as tests/test_torch_hetero_moe.py); swiglu_oai
within 1e-6 (one f32 expression); token ids, text and trees exactly."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_model import (LOGIT_TOL, LONG_PROMPT, PROMPT, _assert_same_tree,
                                    _jax_load, _jax_numpy, _port_load, _serve, _to_numpy)
from tpullama.gguf import GGMLType
from tpullama.models.testing import make_tiny_llama_gguf

QTYPES = [GGMLType.F32, GGMLType.Q4_K]
N_UBATCH = 16
MOE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    out = {}
    for qt in QTYPES:
        p = str(tmp_path_factory.mktemp(f"gptoss-{qt.name}") / "m.gguf")
        make_tiny_llama_gguf(p, arch="gpt-oss", n_embd=256, n_ff=256, n_layer=2, n_expert=4,
                             qtype=qt, seed=11)
        out[qt] = p
    return out


def _load_kw(qtype, scale=np.float32):
    return {} if qtype == GGMLType.F32 else dict(packed=True, packed_scale_dtype=scale)


def test_swiglu_oai_matches_jax():
    """Values past both clamps (|up| and gate above 7) and below."""
    import jax.numpy as jnp

    from tpullama.ops.activations import swiglu_oai as j_act
    from tpullama_torch.ops.activations import swiglu_oai as t_act

    rng = np.random.default_rng(3)
    gate, up = (6.0 * rng.standard_normal((64, 96))).astype(np.float32), \
        (6.0 * rng.standard_normal((64, 96))).astype(np.float32)
    assert (gate > 7).any() and (np.abs(up) > 7).any()
    want = np.asarray(j_act(jnp.asarray(gate), jnp.asarray(up)))
    got = t_act(torch.from_numpy(gate), torch.from_numpy(up)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _biased_experts(rng, E, F, D):
    w = dict(gate_inp=rng.standard_normal((E, D)).astype(np.float32) * 0.3,
             gate_exps=rng.standard_normal((E, F, D)).astype(np.float32) / 4,
             up_exps=rng.standard_normal((E, F, D)).astype(np.float32) / 4,
             down_exps=rng.standard_normal((E, D, F)).astype(np.float32) / 10)
    b = dict(gate_inp_b=rng.standard_normal(E).astype(np.float32),
             gate_exps_b=rng.standard_normal((E, F)).astype(np.float32),
             up_exps_b=rng.standard_normal((E, F)).astype(np.float32),
             down_exps_b=rng.standard_normal((E, D)).astype(np.float32))
    return w, b


GPTOSS_MOE = dict(gating=3, norm_w=False, act="swiglu_oai")


@pytest.mark.parametrize("route", ["pair", "sorted"])
def test_dense_expert_routes_with_biases_match_jax(route):
    """gpt-oss's expert FFN on dense stacks (router bias, per-expert
    biases, swiglu_oai, post-top-k softmax, weights not renormalized): per
    pair (T == 1, each token alone) and sorted by expert (the tokens
    together), 12 tokens of 2 sequences, 8 experts, 4 a token."""
    import jax.numpy as jnp

    from tpullama.ops.moe import moe_ffn as j_moe
    from tpullama_torch.ops.moe import moe_ffn as t_moe

    rng = np.random.default_rng(5)
    B, T, D, F, E, K = 2, 6, 64, 96, 8, 4
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w, b = _biased_experts(rng, E, F, D)
    want = np.asarray(j_moe(jnp.asarray(x), *(jnp.asarray(v) for v in w.values()),
                            n_expert_used=K, **{k: jnp.asarray(v) for k, v in b.items()},
                            **GPTOSS_MOE))
    tx = torch.from_numpy(x) if route == "sorted" else torch.from_numpy(x).reshape(B * T, 1, D)
    got = t_moe(tx, *(torch.from_numpy(v) for v in w.values()), n_expert_used=K,
                **{k: torch.from_numpy(v) for k, v in b.items()}, **GPTOSS_MOE)
    np.testing.assert_allclose(got.reshape(B, T, D).numpy(), want, **MOE_TOL)
    # each bias moves the result
    for name in b:
        other = t_moe(tx, *(torch.from_numpy(v) for v in w.values()), n_expert_used=K,
                      **{k: torch.from_numpy(v) for k, v in b.items() if k != name},
                      **GPTOSS_MOE)
        assert float((other - got).abs().max()) > 1e-3, name


@pytest.mark.parametrize("T", [1, 40], ids=["one_row_tiles", "dispatched"])
def test_packed_expert_route_with_biases_matches_jax(ggufs, T):
    """Layer 0's packed Q4_K experts (transposed planes, the [gate | up]
    stack) with its router, router bias and expert biases, through both
    packages' moe_ffn: at T = 1 every (token, k) slot is a one-row tile,
    at T = 40 (80 slots) the slots are dispatched into 8-row tiles."""
    import jax.numpy as jnp

    from tpullama.ops.moe import moe_ffn as j_moe
    from tpullama_torch.ops.moe import moe_ffn as t_moe

    path = ggufs[GGMLType.Q4_K]
    j = _jax_load(path, **_load_kw(GGMLType.Q4_K))
    t = _port_load(path, **_load_kw(GGMLType.Q4_K, torch.float32))
    jl, tl = j.params["layers"], t.params["layers"]
    jm, tm = j.quant_meta["layers"], t.quant_meta["layers"]
    E = t.hparams.n_expert
    x = np.random.default_rng(6).standard_normal((1, T, 256)).astype(np.float32)
    keys = ("ffn_gate_inp_b", "ffn_gate_exps_b", "ffn_up_exps_b", "ffn_down_exps_b")
    names = ("gate_inp_b", "gate_exps_b", "up_exps_b", "down_exps_b")
    kw = dict(n_expert_used=2, **GPTOSS_MOE)
    want = np.asarray(j_moe(
        jnp.asarray(x), jl["ffn_gate_inp"][0], None, (jl["ffn_gateup_exps"], 0),
        (jl["ffn_down_exps"], 0), **{n: jl[k][0] for n, k in zip(names, keys)},
        quant_meta_exps={"gateup": jm["ffn_gateup_exps"], "down": jm["ffn_down_exps"]}, **kw))
    got = t_moe(torch.from_numpy(x), tl["ffn_gate_inp"][0], None,
                {k: v[:E] for k, v in tl["ffn_gateup_exps"].items()},
                {k: v[:E] for k, v in tl["ffn_down_exps"].items()},
                **{n: tl[k][0] for n, k in zip(names, keys)},
                quant_meta_exps={"gateup": tm["ffn_gateup_exps"], "down": tm["ffn_down_exps"]},
                **kw)
    assert tm["ffn_gateup_exps"].planes_t
    np.testing.assert_allclose(got.numpy(), want, **MOE_TOL)


def test_group_limited_routing_matches_jax(tmp_path):
    """n_expert_groups=4, n_group_used=2 over 16 experts, 4 a token: moe_ffn
    against the JAX package's (the same experts with the same weights give
    the same sums; the groups change them), then a Mixtral-style model (8
    experts, 2 a token) with those fields set on both packages' HParams:
    the same prefill logits and greedy tokens."""
    import jax.numpy as jnp

    from tpullama.ops.moe import moe_ffn as j_moe
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.ops.moe import moe_ffn as t_moe
    from tpullama_torch.ops.moe import route
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    rng = np.random.default_rng(8)
    B, T, D, F, E, K = 2, 5, 32, 48, 16, 4
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w, _ = _biased_experts(rng, E, F, D)
    groups = dict(n_expert_groups=4, n_group_used=2)
    want = np.asarray(j_moe(jnp.asarray(x), *(jnp.asarray(v) for v in w.values()),
                            n_expert_used=K, **groups))
    tw = [torch.from_numpy(v) for v in w.values()]
    got = t_moe(torch.from_numpy(x), *tw, n_expert_used=K, **groups)
    np.testing.assert_allclose(got.numpy(), want, **MOE_TOL)
    ungrouped = t_moe(torch.from_numpy(x), *tw, n_expert_used=K)
    assert float((ungrouped - got).abs().max()) > 1e-3
    sel, _ = route(torch.from_numpy(x), tw[0], K, **groups)
    # each token's experts come from at most n_group_used groups of E / 4
    assert all(len(set((s // (E // 4)).tolist())) <= 2 for s in sel.reshape(-1, K))

    p = str(tmp_path / "moe8.gguf")
    make_tiny_llama_gguf(p, n_embd=64, n_ff=128, n_layer=2, n_expert=8, n_expert_used=2,
                         seed=9)
    jm, tm = _jax_load(p), _port_load(p)
    for m in (jm, tm):
        m.hparams.n_expert_groups, m.hparams.n_group_used = 4, 2
    jc, tc = JC(jm, JCP(n_ctx=64)), TC(tm, TCP(n_ctx=64))
    toks = tm.vocab.tokenize(LONG_PROMPT, add_special=True)
    np.testing.assert_allclose(tc.decode(np.asarray(toks), n_logits=len(toks)),
                               jc.decode(np.asarray(toks), n_logits=len(toks)), **LOGIT_TOL)
    jc, tc = JC(jm, JCP(n_ctx=64)), TC(tm, TCP(n_ctx=64))
    assert tc.generate(toks, n_predict=8) == jc.generate(toks, n_predict=8)


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
def test_gptoss_load_matches(ggufs, qtype):
    """The JAX package's hparams (the SWA layers and their rope base, the
    gating, swiglu_oai, the 1/sqrt(n_rot) scale) and parameter tree: the
    biases, sinks and post_attention_norm as ffn_norm; Q4_K packs the
    attention matrices and the [gate | up] and down experts. A JAX-loaded
    model carried across (params_from_numpy) equals the port's own load."""
    import jax

    from tpullama_torch.models import params_from_numpy

    j = _jax_load(ggufs[qtype], **_load_kw(qtype))
    t = _port_load(ggufs[qtype], **_load_kw(qtype, torch.float32))
    assert vars(t.hparams) == {k: getattr(j.hparams, k) for k in vars(t.hparams)}
    hp = t.hparams
    assert (hp.swa_layers, hp.n_swa, hp.expert_gating_func, hp.moe_norm_topk, hp.moe_act) == (
        (True, False), 32, 3, False, "swiglu_oai")
    assert hp.f_attention_scale == 1.0 / 8.0 and hp.rope_freq_base_swa == hp.rope_freq_base
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    layers = t.params["layers"]
    assert {"attn_sinks", "attn_output_bias", "ffn_gate_inp_b", "ffn_gate_exps_b",
            "ffn_up_exps_b", "ffn_down_exps_b", "ffn_norm"} <= set(layers)
    if qtype != GGMLType.F32:
        assert set(t.quant_meta["layers"]) == {"attn_q", "attn_k", "attn_v", "attn_output",
                                               "ffn_gateup_exps", "ffn_down_exps"}
    carried = params_from_numpy(jax.tree.map(np.asarray, j.params), j.quant_meta, j.hparams,
                                device="cpu")
    _assert_same_tree(_to_numpy(carried.params), _to_numpy(t.params))
    assert vars(carried.hparams) == vars(t.hparams) and carried.quant_meta == t.quant_meta


def _ring_contexts(j, t, n_seqs=1):
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    kw = dict(n_ctx=96, n_ubatch=N_UBATCH, n_seqs=n_seqs)
    jc, tc = JC(j, JCP(**kw)), TC(t, TCP(**kw))
    assert tc._S_swa == jc._S_swa == 32 + N_UBATCH + 1
    return jc, tc


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
def test_gptoss_logits_through_the_ring(ggufs, qtype):
    """A 60-token prompt (past the 49-cell ring, in n_ubatch chunks): the
    JAX package's logits for its last 20 tokens, then 8 greedy tokens
    (Context.generate) and both stacks' positions equal."""
    j = _jax_load(ggufs[qtype], **_load_kw(qtype))
    t = _port_load(ggufs[qtype], **_load_kw(qtype, torch.float32))
    jc, tc = _ring_contexts(j, t)
    toks = np.random.default_rng(12).integers(3, 259, 60).astype(np.int32)
    np.testing.assert_allclose(tc.decode(toks, n_logits=20), jc.decode(toks, n_logits=20),
                               **LOGIT_TOL)
    jc, tc = _ring_contexts(j, t)
    assert tc.generate(toks, n_predict=8) == jc.generate(toks, n_predict=8)
    for stack in ("full", "swa"):
        np.testing.assert_array_equal(tc.kv_pos[stack].numpy(), np.asarray(jc.kv_pos[stack]))


def test_gptoss_cli_prints_the_reference_text(ggufs, capsys):
    """The port's CLI (--device cpu, its default n_ubatch of 512: a ring of
    32 + 128 + 1 cells at -c 128) prints the JAX CLI's greedy text."""
    from tpullama.tools.cli import main as j_main
    from tpullama_torch.tools.cli import main as t_main

    argv = ["-m", ggufs[GGMLType.F32], "-p", PROMPT, "-n", "12", "--dtype", "float32",
            "-c", "128", "--temp", "0"]
    capsys.readouterr()
    rc_j, out_j = j_main(argv), capsys.readouterr().out
    rc_t, out_t = t_main(argv + ["--device", "cpu"]), capsys.readouterr().out
    assert rc_j == rc_t == 0
    assert out_t.startswith(PROMPT) and len(out_t) > len(PROMPT) + 1
    assert out_t == out_j


def test_gptoss_server_engine_script(ggufs):
    """A 2-slot ServerEngine (n_ctx 128, n_ubatch 16: two stacks, the ring
    wrapping in the long prompts) on the dense model: two greedy requests
    together, their prompts prefilled in packed chunks, then a prompt-cache
    reuse: the JAX engine's completions, stop reasons and metrics."""
    j, t = _jax_load(ggufs[GGMLType.F32]), _port_load(ggufs[GGMLType.F32])
    long_prompt = "The quick brown fox jumps over the lazy dog. " * 2
    script = [[dict(prompt=long_prompt, n_predict=10), dict(prompt=LONG_PROMPT, n_predict=8)],
              [dict(prompt=long_prompt + "again", n_predict=10)]]
    out_j, eng_j = _serve("jax", j, script)
    out_t, eng_t = _serve("torch", t, script)
    assert eng_t.ctx._S_swa == eng_j.ctx._S_swa == 32 + N_UBATCH + 1
    assert out_t == out_j and all(o[2] == "length" for o in out_t)
    assert eng_t.metrics == {k: eng_j.metrics[k] for k in eng_t.metrics}
    assert eng_t.ctx.perf.n_reused == eng_j.ctx.perf.n_reused > 0


BAILING = dict(arch="bailingmoe2", n_expert=4, n_head_kv=2, n_layer=4, seed=67)


@pytest.fixture(scope="module")
def bailing_gguf(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("bailing") / "m.gguf")
    make_tiny_llama_gguf(p, **BAILING)
    return p


def test_bailingmoe2_matches_jax(bailing_gguf):
    """The JAX oracle's batch-j bailingmoe2 fixture: a heterogeneous stack
    (dense lead, fused [Q|K|V], per-head q/k norms, sigmoid routing with
    the selection bias and the applied weights scale, a shared expert) of
    3 layers plus its NextN layer: the same hparams and tree, prefill
    logits and 12 greedy tokens."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    j, t = _jax_load(bailing_gguf), _port_load(bailing_gguf)
    assert vars(t.hparams) == {k: getattr(j.hparams, k) for k in vars(t.hparams)}
    assert (t.hparams.n_layer, t.hparams.nextn_layers) == (3, 1)
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    toks = t.vocab.tokenize(LONG_PROMPT, add_special=True)
    jc, tc = JC(j, JCP(n_ctx=96)), TC(t, TCP(n_ctx=96))
    np.testing.assert_allclose(tc.decode(np.asarray(toks), n_logits=len(toks)),
                               jc.decode(np.asarray(toks), n_logits=len(toks)), **LOGIT_TOL)
    jc, tc = JC(j, JCP(n_ctx=96)), TC(t, TCP(n_ctx=96))
    assert tc.generate(toks, n_predict=12) == jc.generate(toks, n_predict=12)


def test_bailingmoe2_nextn_layer_is_skipped_unread(bailing_gguf, monkeypatch):
    """The trailing NextN layer (blk.3, with its nextn.* extras and
    layer_output_norm) is in the file but never read."""
    from tpullama_torch.gguf import GGUFReader
    from tpullama_torch.models import load_model

    names = list(GGUFReader(bailing_gguf).tensors)
    nextn = {n for n in names if n.startswith("blk.3.")}
    assert "blk.3.layer_output_norm.weight" in nextn and {n for n in nextn if ".nextn." in n}
    read = []
    raw = GGUFReader.tensor_raw
    monkeypatch.setattr(GGUFReader, "tensor_raw",
                        lambda self, name: read.append(name) or raw(self, name))
    m = load_model(bailing_gguf, device="cpu", native=False)
    assert m.hparams.n_layer == 3 and len(m.params["layer_list"]) == 3
    assert set(read) == set(names) - nextn
