"""The chatglm cases of tests/test_torch_model.py, moved whole into a file
of their own so that no one file sets tier-1's wall: chatglm at n_embd 64
(F32: fused biased [Q|K|V], fused [gate|up] SwiGLU, NORM rope over half
the head dim), and one chatglm layer at n_embd 4096 (Q4_K) with the fused
post-attention path and 4 K-chunks on, against the JAX package under
TPULLAMA_FUSED_LAYER=1: the fourblock planes and params_from_numpy,
prefill logits and greedy tokens, a one-slot ServerEngine script; and the
two opt-ins read once when LlamaModel is built.

Tolerances as tests/test_torch_model.py's: planes and trees exactly;
logits within rtol = atol = 1e-4; tokens and completions exactly."""

import numpy as np
import pytest
import torch

from tests._torch_fixtures import tiny_gguf
from tests.test_torch_model import (LOGIT_TOL, PROMPT, _assert_same_tree,
                                    _check_prefill_and_generate, _jax_load, _jax_numpy,
                                    _port_load, _serve, _to_numpy)
from tpullama.gguf import GGMLType


@pytest.fixture(scope="module")
def glm_small(tmp_path_factory):
    return tiny_gguf(tmp_path_factory, arch="chatglm", n_embd=64, n_head=4, n_head_kv=2,
                     n_ff=128, seed=41)


@pytest.fixture(scope="module")
def glm_4096(tmp_path_factory):
    """One ChatGLM3-6B-wide layer (n_embd 4096, 32 heads, 2 KV heads:
    attn_qkv 4608 x 4096) with a narrow FFN (n_ff 256), Q4_K: the widths
    at which the fused post-attention path and 4 K-chunks apply."""
    return tiny_gguf(tmp_path_factory, arch="chatglm", n_embd=4096, n_head=32, n_head_kv=2,
                     n_ff=256, n_layer=1, qtype=GGMLType.Q4_K, seed=41)


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
