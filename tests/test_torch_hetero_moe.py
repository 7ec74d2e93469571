"""The heterogeneous dense/MoE layer stacks (glm4moe, dots1, ernie4_5-moe)
held against the JAX package on the CPU, on the fixtures of the JAX
package's oracle batch g (tests/test_e2e_oracle.py: dots1 with 4 KV heads
and 3 layers, glm4moe with 2 KV heads and 3 layers of which the last is its
NextN layer, ernie4_5-moe with 2 KV heads and 4 layers; 4 experts, 2 a
token, a dense lead layer), at n_embd = n_ff = 256 so that Q4_K applies:
the same hparams and parameter trees (the per-layer list, dense in both
packages even when packed; only the output packs), params_from_numpy,
prefill logits, greedy tokens through Context, decode_batch and its
burst, the CLI and ServerEngine, in F32 and in Q4_K with packed=True on
both sides. Also: glm4moe without per-head q/k norms (GLM-4.5-Air has
none), the NextN layer skipped unread, the dense expert branch's two
routes (per pair at T == 1, sorted by expert at T > 1) against the JAX
moe_ffn, and a glm4moe state file crossing between the packages.

Tolerances as tests/test_torch_model.py's: logits within rtol = atol =
1e-4 (f32 sums in another order), tokens, text and trees exactly; the
expert branch within rtol = atol = 1e-5 (one layer of f32 products)."""

import numpy as np
import pytest
import torch

from tests._torch_fixtures import tiny_gguf
from tests.test_torch_model import (LOGIT_TOL, LONG_PROMPT, PROMPT, _assert_same_tree,
                                    _check_decode_batch_and_burst,
                                    _check_prefill_and_generate,
                                    _jax_load, _jax_numpy, _port_load, _to_numpy)
from tpullama.gguf import GGMLType

# batch g's archs and their fixture options (tests/test_e2e_oracle.py)
HETERO = {"dots1": dict(n_head_kv=4, n_layer=3), "glm4moe": dict(n_head_kv=2, n_layer=3),
          "ernie4_5-moe": dict(n_head_kv=2, n_layer=4)}
ARCHS = list(HETERO)
QTYPES = [GGMLType.F32, GGMLType.Q4_K]


def _load_kw(qtype, scale=np.float32):
    return {} if qtype == GGMLType.F32 else dict(packed=True, packed_scale_dtype=scale)


@pytest.fixture(scope="module")
def hetero_ggufs(tmp_path_factory):
    # the run's cached files (tests/test_torch_moe_server.py reads them too)
    return {(arch, qt): tiny_gguf(tmp_path_factory, arch=arch, n_expert=4, n_embd=256,
                                  n_ff=256, qtype=qt, seed=47, **kw)
            for arch, kw in HETERO.items() for qt in QTYPES}


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("arch", ARCHS)
def test_hetero_load_matches(hetero_ggufs, arch, qtype):
    """The same hparams (the dense lead, NextN and interleave fields, the
    arch's gating and rope) and parameter tree as the JAX package: a
    layer_list of per-layer dicts, every tensor dense f32 (packed or not),
    the dense lead with a SwiGLU FFN, the MoE layers with the router, the
    selection bias (dots1, glm4moe) and the shared expert; only the output
    packed. A JAX-loaded model carried across equals the port's own
    load."""
    import jax

    from tpullama_torch.models import params_from_numpy

    path = hetero_ggufs[arch, qtype]
    j = _jax_load(path, **_load_kw(qtype))
    t = _port_load(path, **_load_kw(qtype, torch.float32))
    assert vars(t.hparams) == {k: getattr(j.hparams, k) for k in vars(t.hparams)}
    hp = t.hparams
    assert hp.has_heterogeneous_layers and hp.n_layer_dense_lead == 1
    assert hp.n_layer == HETERO[arch]["n_layer"] - (arch == "glm4moe")
    assert (hp.nextn_layers, hp.n_moe_layer_step) == {
        "dots1": (0, 0), "glm4moe": (1, 0), "ernie4_5-moe": (0, 1)}[arch]
    assert hp.rope_type == (0 if arch == "ernie4_5-moe" else 2)
    assert hp.expert_gating_func == (1 if arch == "ernie4_5-moe" else 2)
    assert "layers" not in t.params and len(t.params["layer_list"]) == hp.n_layer
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    lead, moe = t.params["layer_list"][0], t.params["layer_list"][1]
    assert {"ffn_gate", "ffn_up", "ffn_down"} <= set(lead) and "ffn_gate_inp" not in lead
    assert {"ffn_gate_inp", "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps",
            "ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"} <= set(moe)
    assert ("exp_probs_b" in moe) == (arch != "ernie4_5-moe")
    assert ("attn_q_bias" in moe) == (arch == "glm4moe")
    assert all(v.dtype == torch.float32 for w in t.params["layer_list"] for v in w.values())
    if qtype == GGMLType.F32:
        assert t.quant_meta is None and j.quant_meta is None
    else:
        assert set(t.quant_meta) == set(j.quant_meta) == {"output"}
        m, jm = t.quant_meta["output"], j.quant_meta["output"]
        assert (int(m.ggml_type), m.group, m.n_out, m.n_in) == (
            int(jm.ggml_type), jm.group, jm.n_out, jm.n_in)
    carried = params_from_numpy(jax.tree.map(np.asarray, j.params), j.quant_meta, j.hparams,
                                device="cpu")
    _assert_same_tree(_to_numpy(carried.params), _to_numpy(t.params))
    assert carried.quant_meta == t.quant_meta
    assert carried.nbytes() == t.nbytes() == sum(
        np.asarray(a).nbytes for a in jax.tree.leaves(j.params))


@pytest.mark.parametrize("prompt", [PROMPT, LONG_PROMPT], ids=["short", "long"])
@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("arch", ARCHS)
def test_hetero_prefill_logits_and_greedy_generate(hetero_ggufs, arch, qtype, prompt):
    """Prefill logits (the sorted expert route) and 12 greedy tokens (the
    per-pair route) equal the JAX package's."""
    _check_prefill_and_generate(hetero_ggufs[arch, qtype], prompt, **_load_kw(qtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_hetero_decode_batch_and_burst(hetero_ggufs, arch):
    _check_decode_batch_and_burst(hetero_ggufs[arch, GGMLType.Q4_K])


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("arch", ARCHS)
def test_hetero_cli_prints_the_reference_text(hetero_ggufs, capsys, arch, qtype):
    """`--model` on the file: the port's CLI (--device cpu) prints the JAX
    CLI's greedy text."""
    from tpullama.tools.cli import main as j_main
    from tpullama_torch.tools.cli import main as t_main

    argv = ["-m", hetero_ggufs[arch, qtype], "-p", PROMPT, "-n", "12", "--dtype", "float32",
            "-c", "128", "--temp", "0"]
    capsys.readouterr()
    rc_j, out_j = j_main(argv), capsys.readouterr().out
    rc_t, out_t = t_main(argv + ["--device", "cpu"]), capsys.readouterr().out
    assert rc_j == rc_t == 0
    assert out_t.startswith(PROMPT) and len(out_t) > len(PROMPT) + 1
    assert out_t == out_j


def _without_qk_norms(src, dst):
    """Rewrite a GGUF with the port's GGUF writer, every tensor's bytes as
    they were but the per-head q/k norms dropped."""
    from tpullama_torch.gguf import GGUFReader, GGUFWriter

    r = GGUFReader(src)
    w = GGUFWriter(alignment=r.alignment)
    for k, v in r.kv.items():
        w.add_kv(k, v)
    dropped = 0
    for name, info in r.tensors.items():
        if name.endswith(("attn_q_norm.weight", "attn_k_norm.weight")):
            dropped += 1
            continue
        w.add_tensor(name, tuple(info.shape), ggml_type=info.ggml_type, raw=r.tensor_raw(name))
    w.write(dst)
    return dropped


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
def test_glm4moe_without_qk_norms(hetero_ggufs, tmp_path, qtype):
    """GLM-4.5-Air has no per-head q/k norms (use_qk_norm false): the same
    file without them loads in both packages to the same tree, and the
    prefill logits and greedy tokens match."""
    path = str(tmp_path / "noqk.gguf")
    assert _without_qk_norms(hetero_ggufs["glm4moe", qtype], path) == 2 * 3
    t = _port_load(path, **_load_kw(qtype, torch.float32))
    assert not any("attn_q_norm" in w or "attn_k_norm" in w for w in t.params["layer_list"])
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(_jax_load(path, **_load_kw(qtype)).params))
    _check_prefill_and_generate(path, LONG_PROMPT, **_load_kw(qtype))


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
def test_nextn_layer_is_skipped_unread(hetero_ggufs, monkeypatch, qtype):
    """glm4moe's trailing NextN layer (blk.2, with its blk.2.nextn.* extras)
    is in the file but never read: the loader reads the bytes of every
    other tensor and of none of the NextN layer's, and its progress
    reaches 1 over the tensors it loads."""
    from tpullama_torch.gguf import GGUFReader
    from tpullama_torch.models import load_model

    path = hetero_ggufs["glm4moe", qtype]
    names = list(GGUFReader(path).tensors)
    nextn = {n for n in names if n.startswith("blk.2.")}
    assert {n for n in nextn if ".nextn." in n} and len(nextn) > 6
    read = []
    raw = GGUFReader.tensor_raw
    monkeypatch.setattr(GGUFReader, "tensor_raw",
                        lambda self, name: read.append(name) or raw(self, name))
    fracs = []
    m = load_model(path, device="cpu", native=False, **_load_kw(qtype, torch.float32),
                   progress_callback=lambda f: fracs.append(f) or True)
    assert m.hparams.n_layer == 2
    assert set(read) == set(names) - nextn
    assert fracs[-1] == 1.0


@pytest.mark.parametrize("gating", ["softmax", "sigmoid"])
def test_dense_expert_routes_match_jax(gating):
    """The dense expert branch's two routes, per pair (T == 1: each token
    alone) and sorted by expert (T > 1: the tokens together), against the
    JAX moe_ffn, with the selection bias exp_probs_b, w_scale 2.5 and
    renormalized weights: 6 tokens of 2 sequences, 8 experts, 3 a token."""
    import jax.numpy as jnp

    from tpullama.ops.moe import moe_ffn as j_moe
    from tpullama_torch.ops.moe import moe_ffn as t_moe

    rng = np.random.default_rng(5)
    B, T, D, F, E, K = 2, 6, 64, 96, 8, 3
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = dict(gate_inp=rng.standard_normal((E, D)).astype(np.float32) * 0.3,
             gate_exps=rng.standard_normal((E, F, D)).astype(np.float32) / 8,
             up_exps=rng.standard_normal((E, F, D)).astype(np.float32) / 8,
             down_exps=rng.standard_normal((E, D, F)).astype(np.float32) / 10)
    bias = (0.3 * rng.standard_normal(E)).astype(np.float32)
    kw = dict(n_expert_used=K, gating=1 if gating == "softmax" else 2, norm_w=True,
              w_scale=2.5)
    want = np.asarray(j_moe(jnp.asarray(x), *(jnp.asarray(v) for v in w.values()),
                            exp_probs_b=jnp.asarray(bias), **kw))
    tw = [torch.from_numpy(v) for v in w.values()]
    together = t_moe(torch.from_numpy(x), *tw, exp_probs_b=torch.from_numpy(bias), **kw)
    alone = t_moe(torch.from_numpy(x).reshape(B * T, 1, D), *tw,
                  exp_probs_b=torch.from_numpy(bias), **kw).reshape(B, T, D)
    np.testing.assert_allclose(together.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alone.numpy(), want, rtol=1e-5, atol=1e-5)
    # the bias moved the selection
    unbiased = t_moe(torch.from_numpy(x), *tw, **kw)
    assert float((unbiased - together).abs().max()) > 1e-2


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_glm4moe_state_crosses_packages(hetero_ggufs, tmp_path, writer, reader):
    """A glm4moe Context prefilled and 5 greedy tokens on, saved by one
    package (runtime/state.py), restored by the other into a fresh
    Context, continues with the writer's 6 next tokens."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama.runtime import state as j_state
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP
    from tpullama_torch.runtime import state as t_state

    path = hetero_ggufs["glm4moe", GGMLType.F32]
    pkgs = {"jax": (lambda: JC(_jax_load(path), JCP(n_ctx=96)), j_state),
            "torch": (lambda: TC(_port_load(path), TCP(n_ctx=96)), t_state)}

    def greedy(ctx, tok, n):
        out = []
        for _ in range(n):
            tok = int(np.argmax(ctx.decode(np.asarray([tok], np.int32))[-1]))
            out.append(tok)
        return out

    src = pkgs[writer][0]()
    toks = src.model.vocab.tokenize(PROMPT, add_special=True)
    part = src.generate(toks, n_predict=5)
    f = str(tmp_path / "s.bin")
    pkgs[writer][1].state_save(src, f, tokens=toks + part)
    want = greedy(src, part[-1], 6)
    dst = pkgs[reader][0]()
    assert [int(t) for t in pkgs[reader][1].state_load(dst, f)] == toks + part
    assert greedy(dst, part[-1], 6) == want
    np.testing.assert_allclose(
        np.asarray(dst.decode(np.asarray([want[-1]], np.int32))),
        np.asarray(src.decode(np.asarray([want[-1]], np.int32))), **LOGIT_TOL)


def test_glm4moe_http_bodies_equal_the_reference(hetero_ggufs):
    """Both packages' serve() on the glm4moe file (dense f32 weights and an
    f32 engine, as the servers' main() loads a --model): greedy
    /v1/completions, a streamed chat and /metrics answer the same bodies."""
    from tests.test_torch_server_http import CHAT, _parsed, _request
    from tpullama.models import load_model as j_load
    from tpullama.server.http import serve as j_serve
    from tpullama_torch.models import load_model as t_load
    from tpullama_torch.server.http import serve as t_serve

    path = hetero_ggufs["glm4moe", GGMLType.Q4_K]
    script = [("POST", "/v1/completions", {"prompt": LONG_PROMPT, "max_tokens": 10,
                                            "temperature": 0}),
               ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 8,
                                                 "temperature": 0, "stream": True}),
               ("GET", "/metrics", None)]
    httpds = [j_serve(j_load(path), port=0, n_slots=2, n_ctx=128, block=False),
              t_serve(t_load(path, device="cpu"), port=0, n_slots=2, n_ctx=128, block=False)]
    try:
        bases = [f"http://127.0.0.1:{h.server_address[1]}" for h in httpds]
        for method, route, body in script:
            (cj, tj, xj), (ct, tt, xt) = (_request(b, method, route, body) for b in bases)
            assert (ct, tt) == (cj, tj) == (200, tj), route
            assert _parsed(tt, xt) == _parsed(tj, xj), route
    finally:
        for h in httpds:
            h.shutdown()
            h.engine.stop()
            h.server_close()
