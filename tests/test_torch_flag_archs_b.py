"""The second half of the flag archs (tests/test_torch_flag_archs.py holds
the first and the fixtures of all sixteen): minicpm, qwen v1, xverse,
ernie4_5, glm4, seed_oss, plamo and pangu-embedded, on the JAX oracle's
fixtures, with the same cases; then

- qwen3 and phi3 packed Q4_K at n_embd 256 (fused [Q|K|V] and fused
  [gate|up] through the plain qmm): the same planes, prefill logits and
  greedy tokens as the JAX package's packed model;
- phi3 packed once more with the port's fused_layer=True against the JAX
  package under TPULLAMA_FUSED_LAYER=1 (fourblock planes in both): both
  packages take the fused path, or both skip it (at n_embd 256 both skip:
  fused_ok wants n_embd a multiple of 128 * 32), and the logits and
  tokens match;
- stablelm's decode_multi and decode_batch over 2 lanes (LayerNorms with
  biases on a batched step);
- a context shift on glm4 (NORM rope over half the head dim): the port
  re-rotates the kept K rows with the table its forward takes, so they
  equal a fresh prefill of the kept tokens at their new positions, and
  the JAX package's shifted rows.

Tolerances: trees exactly; logits within rtol = atol = 1e-4; tokens
exactly; shifted K rows within 1e-5 of their largest magnitude (one f32
rotation against another)."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_flag_archs import (FIRST, FIXTURES, check_greedy, check_load, check_prefill,
                                         port_context, reference, write_and_reference)
from tests.test_torch_gemma import check_decode_batch
from tests.test_torch_model import PROMPT, _assert_same_tree, _jax_numpy, _port_load, _to_numpy
from tpullama.gguf import GGMLType
from tpullama.models.testing import make_tiny_llama_gguf

SECOND = tuple(a for a in FIXTURES if a not in FIRST)
PACKED = dict(n_embd=256, n_ff=256, qtype=GGMLType.Q4_K)
PACKED_LOAD = dict(packed=True, packed_scale_dtype=np.float32)
HUGE = 2**30 - 1


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return {arch: write_and_reference(tmp_path_factory, arch, **FIXTURES[arch])
            for arch in SECOND}


@pytest.mark.parametrize("arch", SECOND)
def test_load_matches_jax(refs, arch):
    t = check_load(refs[arch])
    hp, layers = t.hparams, t.params["layers"]
    if arch == "minicpm":
        assert (hp.embd_scale, hp.f_residual_scale, hp.final_logit_scale) == (
            12.0, 1.4 / np.sqrt(2), hp.n_embd / 256.0)
        assert "output" not in t.params
    if arch == "glm4":
        assert hp.ffn_fused_up and (hp.rope_type, hp.n_rot) == (0, 8)
        assert {"post_attn_norm", "post_ffn_norm"} <= set(layers) and "output" not in t.params
    if arch == "seed_oss":
        assert "ffn_norm" in layers and "post_attn_norm" not in layers
    if arch == "plamo":
        assert hp.parallel_residual and "ffn_norm" not in layers
    if arch == "pangu-embedded":
        assert {"attn_q_bias", "attn_k_bias", "attn_v_bias", "attn_output_bias"} <= set(layers)
    if arch == "qwen":
        assert "attn_qkv_bias" in layers and layers["ffn_gate"].shape[1] == hp.n_ff // 2


@pytest.mark.parametrize("arch", SECOND)
def test_prefill_logits_match_jax(refs, arch):
    check_prefill(refs[arch], _port_load(refs[arch]["path"]))


@pytest.mark.parametrize("arch", SECOND)
def test_greedy_tokens_match_jax(refs, arch):
    check_greedy(refs[arch], _port_load(refs[arch]["path"]))


@pytest.fixture(scope="module")
def packed_paths(tmp_path_factory):
    out = {}
    for arch in ("qwen3", "phi3"):
        out[arch] = str(tmp_path_factory.mktemp(f"{arch}_q4k") / "m.gguf")
        make_tiny_llama_gguf(out[arch], n_layer=2, arch=arch, seed=17, **PACKED)
    return out


@pytest.mark.parametrize("arch", ["qwen3", "phi3"])
def test_packed_q4k_matches_jax(packed_paths, arch):
    """Every layer matrix packed (phi3's attn_qkv and 2·n_ff-row ffn_up
    among them): the JAX planes, prefill logits and greedy tokens."""
    ref = reference(packed_paths[arch], **PACKED_LOAD)
    tm = _port_load(packed_paths[arch], packed=True, packed_scale_dtype=torch.float32)
    want = {"attn_output", "ffn_down"} | ({"attn_qkv", "ffn_up"} if arch == "phi3" else
                                           {"attn_q", "attn_k", "attn_v", "ffn_gate", "ffn_up"})
    assert set(tm.quant_meta["layers"]) == want
    _assert_same_tree(_to_numpy(tm.params), _jax_numpy(ref["model"].params))
    check_prefill(ref, tm)
    check_greedy(ref, tm)


def test_phi3_fused_layer_matches_jax(packed_paths, monkeypatch):
    """phi3 under the fused layer in both packages (the JAX package under
    TPULLAMA_FUSED_LAYER=1, the port with fused_layer=True): the same
    fourblock planes; the JAX package's fused_ok and the port's layers
    agree on the fused path; logits and tokens match."""
    from tpullama.ops.pallas.fused_layer import fused_ok as j_fused_ok

    monkeypatch.setenv("TPULLAMA_FUSED_LAYER", "1")
    path = packed_paths["phi3"]
    ref = reference(path, **PACKED_LOAD)
    tm = _port_load(path, packed=True, fused_layer=True, packed_scale_dtype=torch.float32)
    jm = ref["model"]
    orders = {k: m.order for k, m in tm.quant_meta["layers"].items()}
    assert orders == {k: m.order for k, m in jm.quant_meta["layers"].items()} == {
        "attn_qkv": "stripe", "attn_output": "fourblock", "ffn_up": "fourblock",
        "ffn_down": "fourblock"}
    _assert_same_tree(_to_numpy(tm.params), _jax_numpy(jm.params))
    stacks = jm.params["layers"]
    j_fused = j_fused_ok(jm.hparams, {k: (stacks[k], 0) for k in ("attn_output", "ffn_up")},
                         jm.quant_meta["layers"])
    tc = port_context(tm, fused_layer=True)
    assert [layer.fused for layer in tc.net.layers] == [j_fused] * 2
    assert not j_fused  # n_embd 256 is no multiple of 128 * 32
    check_prefill(ref, tm, fused_layer=True)
    check_greedy(ref, tm, fused_layer=True)


def test_stablelm_decode_batch_matches_jax(tmp_path_factory):
    """stablelm's biased LayerNorms on two lanes prefilled together and
    six batched steps: the JAX Context's logits and cells."""
    from tests.test_torch_gemma import load_pair

    check_decode_batch(load_pair(tmp_path_factory, "stablelm", n_layer=2, **FIXTURES["stablelm"]))


def test_glm4_shift_rotates_half_dim_norm_rope(refs):
    """glm4 rotates adjacent pairs over half the head dim (n_rot 8 of 16):
    seq_rm of the first 3 tokens and seq_add(-3) leave layer 0's K rows
    (which depend on their token and position alone) equal to a fresh
    prefill of the kept tokens, and to the JAX package's shifted rows."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP

    ref = refs["glm4"]
    tm = _port_load(ref["path"])
    toks = np.asarray(tm.vocab.tokenize(PROMPT + " there was", add_special=True))
    n = len(toks) - 3
    shifted, fresh = port_context(tm), port_context(tm)
    jc = JC(ref["model"], JCP(n_ctx=64))
    for c in (shifted, jc):
        c.decode(toks)
        c.seq_rm(0, 3)
        c.seq_add(3, HUGE, -3)
    fresh.decode(toks[3:])
    np.testing.assert_array_equal(shifted._pos_host, jc._pos_host)
    pos = shifted._pos_host[0]
    cells = np.argsort(np.where(pos >= 0, pos, 1 << 20))[:n]
    got = shifted.kv_k[0, 0][:, cells]
    want = fresh.kv_k[0, 0][:, :n]
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    j_rows = torch.from_numpy(np.asarray(jc.kv_k[0, 0])[:, cells])
    assert float((got - j_rows).abs().max()) <= tol


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("serving on the card needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def card_paths(tmp_path_factory):
    """Written per test, after `cuda` (its one user is the card test)."""
    out = {}
    for arch in ("qwen3", "stablelm"):
        out[arch] = str(tmp_path_factory.mktemp(f"{arch}_card") / "m.gguf")
        make_tiny_llama_gguf(out[arch], n_layer=2, arch=arch, seed=17, **PACKED)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3", "stablelm"])
def test_card_context_matches_the_cpu(cuda, card_paths, arch):
    """qwen3 (per-head q/k norms) and stablelm (biased LayerNorms), every
    layer matrix Q4_K, f32 activations: the card's Context (qmm kernels,
    flash_attention, the replayed one-token steps through flash_decode)
    against the CPU's plain versions: prefill logits within 1e-3 of their
    largest magnitude plus 1e-4 (f32 sums in the kernels' order), and 8
    identical greedy tokens."""
    from tpullama_torch.models import load_model
    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts

    kw = dict(packed=True, packed_scale_dtype=torch.float32)
    gm = load_model(card_paths[arch], device="cuda", **kw)
    cm = load_model(card_paths[arch], device="cpu", **kw)
    toks = cm.vocab.tokenize(PROMPT, add_special=True)
    reset_launch_counts()
    lg = port_context(gm).decode(np.asarray(toks), n_logits=len(toks))
    lc = port_context(cm).decode(np.asarray(toks), n_logits=len(toks))
    assert np.isfinite(lg).all() and lg.shape == lc.shape
    assert np.abs(lg - lc).max() <= 1e-3 * np.abs(lc).max() + 1e-4
    assert port_context(gm).generate(toks, n_predict=8) == port_context(cm).generate(
        toks, n_predict=8)
    counts = launch_counts()
    assert all(counts[k] > 0 for k in ("qmm_gemv", "qmm_tiled", "flash_attention",
                                       "flash_decode")), counts
