"""Every GGUF type the loaders read, end to end (the cases of
tests/test_torch_model.py moved whole into a file of their own so that no
one file sets tier-1's wall): each of TYPE_CASES loads in both packages to
the same parameters (packed where it packs, the token table dense), with
the JAX package's prefill logits and greedy tokens; a tensor whose type
differs between layers loads dense in both.

Tolerances as tests/test_torch_model.py's: trees exactly, logits within
rtol = atol = 1e-4, tokens exactly."""

import numpy as np
import pytest
import torch

from tests._torch_fixtures import cached_file, tiny_gguf
from tests.test_torch_model import (TYPE_CASES, _assert_same_tree, _check_prefill_and_generate,
                                    _jax_load, _jax_numpy, _port_load, _retype_gguf,
                                    _to_numpy)
from tpullama.gguf import GGMLType


@pytest.fixture(scope="module")
def type_ggufs(tmp_path_factory):
    base = tiny_gguf(tmp_path_factory, n_embd=256, n_ff=256, n_layer=2, seed=33)
    out = {}
    for qt in TYPE_CASES:
        out[qt] = cached_file(tmp_path_factory, "retype", dict(base=base, qtype=qt),
                              lambda p, qt=qt: _retype_gguf(base, p, lambda name: qt,
                                                            seed=qt.value))
    # llama.cpp's K-quant mixes give a tensor other types in some layers
    # (Q5_K_M: attn_v and ffn_down Q6_K where use_more_bits): ffn_down Q6_K
    # in layer 0 and Q5_K in layer 1, everything else Q5_K
    out["mixed"] = cached_file(tmp_path_factory, "retype", dict(base=base, qtype="mixed"),
                               lambda p: _retype_gguf(
                                   base, p, lambda name: GGMLType.Q6_K
                                   if name == "blk.0.ffn_down.weight" else GGMLType.Q5_K))
    return out


@pytest.mark.parametrize("qtype", TYPE_CASES, ids=lambda t: t.name)
def test_every_type_prefill_logits_and_greedy_generate(type_ggufs, qtype):
    """Each type loads in both packages (packed where it packs, the token
    table dense) to the same parameters, and the prefill logits and greedy
    tokens match the JAX package's."""
    from tpullama.ops.qweights import PACKED_TYPES

    packed = qtype in PACKED_TYPES
    load_kw = dict(packed=True, packed_scale_dtype=np.float32) if packed else {}
    j = _jax_load(type_ggufs[qtype], **load_kw)
    t = _port_load(type_ggufs[qtype], **dict(load_kw, packed_scale_dtype=torch.float32)
                   if packed else {})
    lm = (t.quant_meta or {}).get("layers", {})
    assert set(lm) == ({"attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
                        "ffn_down"} if packed else set())
    _assert_same_tree(_to_numpy(t.params), _jax_numpy({k: j.params[k] for k in t.params}))
    _check_prefill_and_generate(type_ggufs[qtype], **load_kw)


def test_mixed_layer_types_load_dense(type_ggufs):
    """A tensor whose type differs between layers is loaded dense in both
    packages (the layer-uniform packing rule); the rest stays packed."""
    path = type_ggufs["mixed"]
    j = _jax_load(path, packed=True, packed_scale_dtype=np.float32)
    t = _port_load(path, packed=True, packed_scale_dtype=torch.float32)
    lm = t.quant_meta["layers"]
    assert "ffn_down" not in lm and set(lm) == set(j.quant_meta["layers"])
    assert not isinstance(t.params["layers"]["ffn_down"], dict)
    _assert_same_tree(_to_numpy(t.params["layers"]["ffn_down"]),
                      _jax_numpy(j.params["layers"]["ffn_down"]))
    _check_prefill_and_generate(path, packed=True, packed_scale_dtype=np.float32)
