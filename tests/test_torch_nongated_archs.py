"""The non-gated FFN archs (up (+bias) -> GELU -> down (+bias), LayerNorm
with biases), held against the JAX package on the CPU on the JAX oracle's
fixtures and seeds (tests/test_e2e_oracle.py; F32, 2 layers): phi2
(parallel residual from the attention norm, fused biased [Q|K|V], a
biased lm_head), falcon (parallel residual, fused [Q|K|V] without bias,
no FFN biases), gptneox (parallel residual with its own ffn_norm, every
bias) and starcoder2 (separate biased q/k/v, sequential). This file holds
those four and their special cases; tests/test_torch_nongated_archs_b.py
codeshell, gpt2 and starcoder (learned positions), the cases shared with
other archs and the card's.

Cases per arch: the hparams equal the JAX package's field by field; the
loaded params equal the JAX package's, and so do the JAX params carried
across by params_from_numpy; the prefill logits within LOGIT_TOL; 8
greedy tokens from a fresh Context identical to the JAX Context's; the
same at n_embd 256 with every layer matrix Q4_K, packed in both packages
(the same planes). Special cases: phi2 and gptneox with rope over 8 of
their 16 head dims (NEOX, the rest passed through); gptneox with
use_parallel_residual false (the sequential block); falcon with
falcon-40b's attn_norm_2 (+bias), which its FFN reads when the file has no
ffn_norm. Each variant file is the oracle fixture rewritten with the JAX
package's GGUF writer (_edit_gguf: keys replaced, tensors added).

Tolerances: trees exactly; logits within rtol = atol = 1e-4 (f32 sums in
another order over two layers); tokens exactly."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_flag_archs import (check_greedy, check_load, check_prefill, reference,
                                         write_and_reference)
from tests.test_torch_model import _assert_same_tree, _edit_gguf, _jax_numpy, _port_load, _to_numpy
from tpullama.gguf import GGMLType
from tpullama.models.testing import make_tiny_llama_gguf

# the JAX oracle's settings per arch (tests/test_e2e_oracle.py:145-180,
# 276, 321, 403)
FIXTURES = {
    "phi2": dict(seed=17, n_head_kv=4), "falcon": dict(seed=17, n_head_kv=4),
    "gptneox": dict(seed=29, n_head_kv=4), "starcoder2": dict(seed=17),
    "codeshell": dict(seed=53, n_head_kv=2), "gpt2": dict(seed=17, n_head_kv=4),
    "starcoder": dict(seed=37, n_head_kv=4, tied_output=True),
}
FIRST = ("phi2", "falcon", "gptneox", "starcoder2")
PACKED = dict(n_embd=256, n_ff=256, qtype=GGMLType.Q4_K)
PACKED_LOAD = dict(packed=True, packed_scale_dtype=np.float32)
PARTIAL_ROT = 8  # of the fixtures' head dim 16


def fixture_file(tmp_path_factory, arch, tag="", **kw):
    """The arch's oracle fixture (2 layers), `kw` over its settings."""
    p = str(tmp_path_factory.mktemp(f"{arch}{tag}") / "m.gguf")
    make_tiny_llama_gguf(p, n_layer=2, arch=arch, **{**FIXTURES[arch], **kw})
    return p


def edited(tmp_path_factory, arch, tag, kv=None, tensors=None):
    """The arch's F32 oracle fixture rewritten: keys in `kv` replaced or
    added, tensors in `tensors` (a function of the source's reader) added."""
    from tpullama.gguf import GGUFReader

    src = fixture_file(tmp_path_factory, arch, tag + "_src")
    dst = str(tmp_path_factory.mktemp(f"{arch}{tag}") / "m.gguf")
    _edit_gguf(src, dst, kv=kv, tensors=tensors(GGUFReader(src)) if tensors else None)
    return dst


def check_packed(path):
    """Every layer matrix packed in both packages: the same planes, then the
    JAX package's prefill logits and greedy tokens."""
    ref = reference(path, **PACKED_LOAD)
    tm = _port_load(path, packed=True, packed_scale_dtype=torch.float32)
    _assert_same_tree(_to_numpy(tm.params), _jax_numpy(ref["model"].params))
    check_prefill(ref, tm)
    check_greedy(ref, tm)
    return tm


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return {arch: write_and_reference(tmp_path_factory, arch, **FIXTURES[arch])
            for arch in FIRST}


def check_arch_tensors(arch, t):
    """What each arch's file gives the loader, beside the JAX package's."""
    hp, layers, top = t.hparams, t.params["layers"], t.params
    assert not hp.ffn_gated and hp.act == "gelu" and hp.norm_type == "layer"
    assert "ffn_gate" not in layers and "output_norm_bias" in top
    assert hp.rope_type == (-1 if arch in ("gpt2", "starcoder") else 2)
    assert hp.parallel_residual == (arch in ("phi2", "falcon", "gptneox"))
    biased = arch != "falcon"
    assert {"ffn_up_bias", "ffn_down_bias"} <= set(layers) if biased else not (
        {"ffn_up_bias", "ffn_down_bias", "attn_qkv_bias", "attn_output_bias"} & set(layers))
    assert ("ffn_norm" in layers) == (arch not in ("phi2", "falcon"))
    assert ("output_bias" in top) == (arch == "phi2")
    assert ("position_embd" in top) == (arch in ("gpt2", "starcoder"))
    assert ("output" in top) == (arch != "starcoder")


@pytest.mark.parametrize("arch", FIRST)
def test_load_matches_jax(refs, arch):
    check_arch_tensors(arch, check_load(refs[arch]))


@pytest.mark.parametrize("arch", FIRST)
def test_prefill_logits_match_jax(refs, arch):
    check_prefill(refs[arch], _port_load(refs[arch]["path"]))


@pytest.mark.parametrize("arch", FIRST)
def test_greedy_tokens_match_jax(refs, arch):
    check_greedy(refs[arch], _port_load(refs[arch]["path"]))


@pytest.mark.parametrize("arch", FIRST)
def test_packed_q4k_matches_jax(tmp_path_factory, arch):
    """n_embd 256, every layer matrix and the lm_head Q4_K: attn_qkv (or
    q/k/v), attn_output, ffn_up and ffn_down packed, the biases and norms
    dense."""
    tm = check_packed(fixture_file(tmp_path_factory, arch, "_q4k", **PACKED))
    qkv = {"attn_q", "attn_k", "attn_v"} if arch == "starcoder2" else {"attn_qkv"}
    assert set(tm.quant_meta["layers"]) == qkv | {"attn_output", "ffn_up", "ffn_down"}
    assert "output" in tm.quant_meta


@pytest.mark.parametrize("arch", ["phi2", "gptneox"])
def test_partial_rotary_matches_jax(tmp_path_factory, arch):
    """rope.dimension_count 8 of head dim 16 (phi-2 rotates 32 of 80, gpt-neox-20b
    24 of 96): NEOX pairs (i, i + 4) rotate, dims 8-15 pass through, in
    both packages: hparams, params, logits and tokens."""
    path = edited(tmp_path_factory, arch, "_rot",
                  kv={f"{arch}.rope.dimension_count": PARTIAL_ROT})
    ref = reference(path)
    t = check_load(ref)
    assert (t.hparams.n_rot, t.hparams.n_embd_head_k, t.hparams.rope_type) == (PARTIAL_ROT, 16, 2)
    check_prefill(ref, t)
    check_greedy(ref, t)


def test_gptneox_sequential_residual_matches_jax(tmp_path_factory):
    """use_parallel_residual false: the FFN reads ffn_norm of the
    attention's residual sum (gpt-neox's sequential block)."""
    path = edited(tmp_path_factory, "gptneox", "_seq",
                  kv={"gptneox.use_parallel_residual": False})
    ref = reference(path)
    t = check_load(ref)
    assert not t.hparams.parallel_residual and "ffn_norm" in t.params["layers"]
    check_prefill(ref, t)
    check_greedy(ref, t)
    # the block differs from the parallel one on the same weights
    par = reference(fixture_file(tmp_path_factory, "gptneox", "_par"))
    assert np.abs(par["logits"] - ref["logits"]).max() > 1e-3


def test_falcon_attn_norm_2_matches_jax(tmp_path_factory):
    """falcon-40b's second attention norm (+bias) and no ffn_norm: the FFN
    reads attn_norm_2 of the layer input, the attention attn_norm's."""
    rng = np.random.default_rng(5)

    def norms(r):
        n_embd = r.tensors["blk.0.attn_norm.weight"].shape[0]
        out = {}
        for il in range(2):
            out[f"blk.{il}.attn_norm_2.weight"] = (1 + 0.1 * rng.standard_normal(n_embd)
                                                   ).astype(np.float32)
            out[f"blk.{il}.attn_norm_2.bias"] = (0.1 * rng.standard_normal(n_embd)
                                                 ).astype(np.float32)
        return out

    path = edited(tmp_path_factory, "falcon", "_n2", tensors=norms)
    ref = reference(path)
    t = check_load(ref)
    layers = t.params["layers"]
    assert {"attn_norm_2", "attn_norm_2_bias"} <= set(layers) and "ffn_norm" not in layers
    check_prefill(ref, t)
    check_greedy(ref, t)
