"""The dense archs that run through the llama forward on flags the port
already has, held against the JAX package on the CPU on the JAX oracle's
fixtures and seeds (tests/test_e2e_oracle.py; F32, 2 layers, each with
the fixture's own kwargs): qwen3 (per-head q/k RMS norms), mistral3,
internlm2, xverse and ernie4_5 (plain llama blocks, NORM rope), exaone
(NEOX rope), phi3 (fused [Q|K|V] without bias, fused [gate|up]), glm4
(chatglm's fused up and half-dim NORM rope, gemma2's post norms, tied
output), granite and minicpm (the scale stack; minicpm's legacy
defaults), orion and stablelm (LayerNorm pre-norms with biases), plamo
(parallel residual, the FFN reading the attention norm's output),
seed_oss (post_attention_norm as the FFN norm), pangu-embedded (q/k/v
and attn_output biases) and qwen v1 (fused biased [Q|K|V], gate and up at
half the metadata's n_ff).

This file holds the first eight; tests/test_torch_flag_archs_b.py the
other eight, the packed and fused cases, stablelm's decode_batch and
glm4's context shift.

Cases per arch: the hparams equal the JAX package's field by field for
the fields the port has; the loaded params equal the JAX package's, and
so do the JAX params carried across by params_from_numpy; the prefill
logits of the prompt within LOGIT_TOL; 8 greedy tokens from a fresh
Context identical to the JAX Context's. The JAX side runs once per arch
(a module fixture) and every case compares with it.

Beside them, one parametrised case over every arch the JAX oracle runs
(read from tests/test_e2e_oracle.py): check_arch passes the archs the
port loads and refuses every other one by name with its ROADMAP item,
never with the bare "is not ported yet".

Tolerances: trees exactly; logits within rtol = atol = 1e-4 (f32 sums in
another order over two layers); tokens exactly."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_model import (LOGIT_TOL, PROMPT, _assert_same_tree, _jax_load, _jax_numpy,
                                    _port_load, _to_numpy)
from tpullama.models.testing import make_tiny_llama_gguf

# the JAX oracle's settings per arch (tests/test_e2e_oracle.py:142-156,
# 290-345, 468-481)
FIXTURES = {
    "qwen3": dict(seed=17), "phi3": dict(seed=17), "granite": dict(seed=17),
    "internlm2": dict(seed=17), "orion": dict(seed=17), "stablelm": dict(seed=17),
    "mistral3": dict(seed=17),
    "exaone": dict(seed=31), "minicpm": dict(tied_output=True, seed=31),
    "qwen": dict(n_head_kv=4, seed=37), "xverse": dict(n_head_kv=4, seed=37),
    "ernie4_5": dict(n_head_kv=2, seed=37),
    "glm4": dict(n_head_kv=2, tied_output=True, seed=41), "seed_oss": dict(n_head_kv=2, seed=41),
    "plamo": dict(n_head_kv=4, seed=63), "pangu-embedded": dict(n_head_kv=2, seed=63),
}
FIRST = ("qwen3", "phi3", "granite", "internlm2", "orion", "stablelm", "mistral3", "exaone")
N_PREDICT = 8


def oracle_archs() -> list:
    """Every arch tests/test_e2e_oracle.py writes a fixture for: arch=
    keywords, (arch, kwargs) and arch-list parametrizations, the
    make_tiny_<arch>_gguf writers of their own, and llama by default."""
    src = (Path(__file__).parent / "test_e2e_oracle.py").read_text()
    archs = {"llama"} | set(re.findall(r'arch="([^"]+)"', src))
    archs |= set(re.findall(r'\(\s*"([a-z][a-z0-9_.-]*)",\s*dict\(', src))
    for lst in re.findall(r'parametrize\(\s*"arch",\s*\[([^\]]*)\]', src):
        archs |= set(re.findall(r'"([^"]+)"', lst))
    archs |= set(re.findall(r"make_tiny_([a-z0-9]+)_gguf", src)) - {"llama", "mla"}
    return sorted(archs)


ORACLE_ARCHS = oracle_archs()


def reference(path, prompt=PROMPT, n_ctx=64, **load_kw):
    """The JAX model and what its Context gives on `path`: the prompt's
    tokens, its prefill logits and N_PREDICT greedy tokens from a fresh
    Context."""
    from tpullama.runtime import Context, ContextParams

    jm = _jax_load(path, **load_kw)
    toks = jm.vocab.tokenize(prompt, add_special=True)
    logits = Context(jm, ContextParams(n_ctx=n_ctx)).decode(np.asarray(toks),
                                                            n_logits=len(toks))
    greedy = Context(jm, ContextParams(n_ctx=n_ctx)).generate(toks, n_predict=N_PREDICT)
    return {"model": jm, "toks": toks, "logits": np.asarray(logits), "greedy": greedy,
            "path": path}


def write_and_reference(tmp_path_factory, arch, **kw):
    p = str(tmp_path_factory.mktemp(arch) / "m.gguf")
    make_tiny_llama_gguf(p, n_layer=2, arch=arch, **kw)
    return reference(p)


def port_context(tm, n_ctx=64, **kw):
    from tpullama_torch.runtime import Context, ContextParams

    return Context(tm, ContextParams(n_ctx=n_ctx), **kw)


def check_load(ref):
    """Equal hparams, equal params, and the JAX params carried across."""
    from tpullama_torch.models import params_from_numpy

    j, t = ref["model"], _port_load(ref["path"])
    assert vars(t.hparams) == {k: getattr(j.hparams, k) for k in vars(t.hparams)}
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    carried = params_from_numpy(jax.tree.map(np.asarray, j.params), j.quant_meta, j.hparams,
                                device="cpu")
    _assert_same_tree(_to_numpy(carried.params), _to_numpy(t.params))
    return t


def check_prefill(ref, tm, **ctx_kw):
    lt = port_context(tm, **ctx_kw).decode(np.asarray(ref["toks"]), n_logits=len(ref["toks"]))
    assert lt.shape == ref["logits"].shape
    np.testing.assert_allclose(lt, ref["logits"], **LOGIT_TOL)


def check_greedy(ref, tm, **ctx_kw):
    assert port_context(tm, **ctx_kw).generate(ref["toks"], n_predict=N_PREDICT) == ref["greedy"]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return {arch: write_and_reference(tmp_path_factory, arch, **FIXTURES[arch])
            for arch in FIRST}


@pytest.mark.parametrize("arch", FIRST)
def test_load_matches_jax(refs, arch):
    t = check_load(refs[arch])
    hp, layers = t.hparams, t.params["layers"]
    if arch == "qwen3":
        assert {"attn_q_norm", "attn_k_norm"} <= set(layers) and hp.rope_type == 2
    if arch == "phi3":
        assert {"attn_qkv", "ffn_up"} <= set(layers) and "attn_qkv_bias" not in layers
        assert hp.ffn_fused_up and "ffn_gate" not in layers
    if arch == "granite":
        assert (hp.embd_scale, hp.f_residual_scale, hp.final_logit_scale,
                hp.f_attention_scale) == (12.0, 0.5, 1 / 8, 0.0078125)
    if arch in ("orion", "stablelm"):
        assert hp.norm_type == "layer" and "output_norm_bias" in t.params
        assert {"attn_norm_bias", "ffn_norm_bias"} <= set(layers)
    if arch in ("internlm2", "mistral3"):
        assert hp.rope_type == 0
    if arch == "exaone":
        assert hp.rope_type == 2


@pytest.mark.parametrize("arch", FIRST)
def test_prefill_logits_match_jax(refs, arch):
    check_prefill(refs[arch], _port_load(refs[arch]["path"]))


@pytest.mark.parametrize("arch", FIRST)
def test_greedy_tokens_match_jax(refs, arch):
    check_greedy(refs[arch], _port_load(refs[arch]["path"]))


def test_oracle_archs_are_read():
    assert len(ORACLE_ARCHS) >= 75 and set(FIXTURES) <= set(ORACLE_ARCHS)
    assert {"deci", "plm", "minicpm3", "openelm", "gemma3n"} <= set(ORACLE_ARCHS)


@pytest.mark.parametrize("arch", ORACLE_ARCHS)
def test_check_arch_loads_or_names_its_item(arch):
    from tpullama_torch.models.hparams import LLAMA_FAMILY, check_arch

    if arch in LLAMA_FAMILY:
        check_arch(arch)
        return
    with pytest.raises(NotImplementedError,
                       match=rf"arch '{re.escape(arch)}' is not ported yet "
                             r"\(ROADMAP\.md Queue 1 item (5|7)\)$"):
        check_arch(arch)
