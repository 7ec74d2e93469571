"""The MoE archs that run through the llama forward (qwen2moe, qwen3moe,
granitemoe) held against the JAX package on make_tiny_llama_gguf fixtures
at n_embd=256, n_ff=256, 2 layers, 4 experts and 2 per token: the same
hparams and parameter trees (dense F32, packed Q4_K) and params_from_numpy,
prefill logits, greedy Context.generate, decode_batch and its burst, a
ServerEngine script on qwen3moe, qwen3moe with Hq * Dk != n_embd, and
expert stacks in the q1/q2 sets (Q5_K, Q3_K, Q2_K) that the row-major
gathered kernel takes. Everything runs on the CPU, where the port takes
its kernels' plain versions and the JAX package runs its Pallas kernels in
interpret mode. Tolerances as tests/test_torch_model.py's: logits within
rtol = atol = 1e-4, tokens and trees exactly."""

import numpy as np
import pytest
import torch

from tests._torch_fixtures import tiny_gguf
from tests.test_torch_model import (LONG_PROMPT, MOE, PROMPT, _assert_same_tree,
                                    _check_decode_batch_and_burst,
                                    _check_prefill_and_generate,
                                    _edit_gguf, _jax_load, _jax_numpy, _port_load,
                                    _retype_gguf, _to_numpy)
from tpullama.gguf import GGMLType
from tpullama.models.testing import make_tiny_llama_gguf

MOE_ARCHS = ("qwen2moe", "qwen3moe", "granitemoe")


@pytest.fixture(scope="module")
def moe_arch_ggufs(tmp_path_factory):
    """Each MoE arch at MOE's widths (n_embd 256, n_ff 256, 2 layers, 4
    experts, 2 per token), dense F32 and Q4_K: qwen2moe with a shared
    expert and its sigmoid gate, qwen3moe with per-head q/k norms,
    granitemoe with the scale stack and a shared expert."""
    return {(arch, qt): tiny_gguf(tmp_path_factory, arch=arch, qtype=qt, seed=21, **MOE)
            for arch in MOE_ARCHS for qt in (GGMLType.F32, GGMLType.Q4_K)}


@pytest.mark.parametrize("qtype", [GGMLType.F32, GGMLType.Q4_K], ids=lambda t: t.name)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_arch_load_matches(moe_arch_ggufs, arch, qtype):
    """The same hparams and parameter trees as the JAX package (dense F32;
    packed Q4_K with f32 scales, q/k norms, routers and the shared expert's
    gate dense), and a JAX-loaded packed model carried across equals the
    port's own load."""
    import jax

    from tpullama_torch.models import params_from_numpy

    path = moe_arch_ggufs[arch, qtype]
    kw = {} if qtype == GGMLType.F32 else dict(packed=True)
    j = _jax_load(path, **(dict(kw, packed_scale_dtype=np.float32) if kw else {}))
    t = _port_load(path, **(dict(kw, packed_scale_dtype=torch.float32) if kw else {}))
    assert vars(t.hparams) == {k: getattr(j.hparams, k) for k in vars(t.hparams)}
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    want = {"qwen2moe": {"ffn_gate_inp_shexp", "ffn_gate_shexp"}, "qwen3moe": {"attn_q_norm"},
            "granitemoe": {"ffn_gate_shexp"}}[arch]
    assert want <= set(t.params["layers"])
    if qtype == GGMLType.F32:
        assert t.quant_meta is None
        return
    lm = t.quant_meta["layers"]
    assert {"ffn_gateup_exps", "ffn_down_exps"} <= set(lm)
    assert ("ffn_down_shexp" in lm) == (arch != "qwen3moe")
    carried = params_from_numpy(jax.tree.map(np.asarray, j.params), j.quant_meta, j.hparams,
                                device="cpu")
    _assert_same_tree(_to_numpy(carried.params), _to_numpy(t.params))
    assert carried.quant_meta == t.quant_meta


@pytest.mark.parametrize("qtype", [GGMLType.F32, GGMLType.Q4_K], ids=lambda t: t.name)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_arch_prefill_logits_and_greedy_generate(moe_arch_ggufs, arch, qtype):
    load_kw = {} if qtype == GGMLType.F32 else dict(packed=True, packed_scale_dtype=np.float32)
    _check_prefill_and_generate(moe_arch_ggufs[arch, qtype], **load_kw)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_arch_decode_batch_and_burst(moe_arch_ggufs, arch):
    _check_decode_batch_and_burst(moe_arch_ggufs[arch, GGMLType.Q4_K])


def test_qwen3moe_wide_heads(tmp_path):
    """Hq * Dk != n_embd, as in Qwen3-30B-A3B (32 heads x 128 on a 2048
    hidden): attention.key_length = value_length = 2 n_embd / n_head, so the
    q projection is twice as wide as the hidden, the cache rows and the
    q/k norms 2 head widths; the same hparams, prefill logits and greedy
    tokens as the JAX package, dense and packed."""
    base = str(tmp_path / "base.gguf")
    n_embd, n_head, n_head_kv, hd = 256, 4, 2, 128
    make_tiny_llama_gguf(base, arch="qwen3moe", seed=5, **MOE)
    rng = np.random.default_rng(6)

    def mat(n_out, n_in):
        return (rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)).astype(np.float32)

    tensors = {}
    for il in range(MOE["n_layer"]):
        p = f"blk.{il}."
        tensors.update({p + "attn_q.weight": mat(n_head * hd, n_embd),
                        p + "attn_k.weight": mat(n_head_kv * hd, n_embd),
                        p + "attn_v.weight": mat(n_head_kv * hd, n_embd),
                        p + "attn_output.weight": mat(n_embd, n_head * hd),
                        p + "attn_q_norm.weight": (1 + 0.1 * rng.standard_normal(hd))
                        .astype(np.float32),
                        p + "attn_k_norm.weight": (1 + 0.1 * rng.standard_normal(hd))
                        .astype(np.float32)})
    path = str(tmp_path / "wide.gguf")
    _edit_gguf(base, path, kv={"qwen3moe.attention.key_length": hd,
                               "qwen3moe.attention.value_length": hd,
                               "qwen3moe.rope.dimension_count": hd}, tensors=tensors)
    t = _port_load(path)
    assert (t.hparams.n_embd_head_k, t.hparams.n_embd_head_v, t.hparams.n_rot) == (hd, hd, hd)
    assert t.hparams.n_head * t.hparams.n_embd_head_k == 2 * t.hparams.n_embd
    q4k = str(tmp_path / "wide-q4k.gguf")
    _retype_gguf(path, q4k, lambda name: GGMLType.Q4_K if name.endswith(
        ("attn_q.weight", "attn_k.weight", "attn_v.weight", "attn_output.weight")) else None)
    _check_prefill_and_generate(path)
    _check_prefill_and_generate(q4k, packed=True, packed_scale_dtype=np.float32)
    assert set(_port_load(q4k, packed=True).quant_meta["layers"]) == {
        "attn_q", "attn_k", "attn_v", "attn_output"}


# the q1/q2 field sets as expert stacks: the row-major gathered kernel's
# new sets on the CPU (plain versions) against the JAX package
LOWBIT_EXPERTS = [GGMLType.Q5_K, GGMLType.Q3_K, GGMLType.Q2_K]


@pytest.fixture(scope="module")
def lowbit_expert_ggufs(tmp_path_factory):
    """qwen3moe at MOE's widths with every expert stack in a q1/q2 type
    (the rest F32, so only the experts pack)."""
    d = tmp_path_factory.mktemp("lowbit-experts")
    base = str(d / "f32.gguf")
    make_tiny_llama_gguf(base, arch="qwen3moe", seed=31, **MOE)
    out = {}
    for qt in LOWBIT_EXPERTS:
        out[qt] = str(d / f"{qt.name}.gguf")
        _retype_gguf(base, out[qt], lambda name, qt=qt: qt if "_exps." in name else None,
                     seed=qt.value)
    return out


@pytest.mark.parametrize("qtype", LOWBIT_EXPERTS, ids=lambda t: t.name)
def test_lowbit_experts_prefill_logits_and_greedy_generate(lowbit_expert_ggufs, qtype):
    """Expert stacks in Q5_K / Q3_K / Q2_K load packed and row-major (their
    field sets have two stripe widths or a q2 plane, which the planes_t
    rule never transposes), with the same planes as the JAX package's, and
    the prefill logits (one-row tiles for the short prompt, the dispatch's
    8-row tiles for the long one) and greedy tokens match it."""
    path = lowbit_expert_ggufs[qtype]
    j = _jax_load(path, packed=True, packed_scale_dtype=np.float32)
    t = _port_load(path, packed=True, packed_scale_dtype=torch.float32)
    lm = t.quant_meta["layers"]
    assert set(lm) == {"ffn_gateup_exps", "ffn_down_exps"}
    assert not lm["ffn_gateup_exps"].planes_t and not lm["ffn_down_exps"].planes_t
    assert lm["ffn_down_exps"].ggml_type == qtype
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    for prompt in (PROMPT, LONG_PROMPT):
        _check_prefill_and_generate(path, prompt, packed=True, packed_scale_dtype=np.float32)
