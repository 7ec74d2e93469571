"""The cohere family (command-r, cohere2) held against the JAX package on
the CPU, on the JAX oracle's fixtures (tests/test_e2e_oracle.py:273-287):
command-r with 2 layers and a tied output (LayerNorm without biases, the
FFN reading the attention norm's output and both branches added to the
layer input at once, logits times logit_scale 0.5); cohere2 with 5
layers, tied, window 32 on three layers of four, whose full layers take
no rope.

Cases: the loaded hparams and parameter trees; prefill logits of a
60-token prompt and 16 greedy tokens (n_ctx 128, n_ubatch 16: cohere2's
ring of 49 cells wraps), both stacks' positions and the host mirror after;
decode_multi and decode_batch over 2 lanes; a state file crossing between
the packages; the two-stack rule at a window the ring cannot
undercut (cohere2's window raised to 120 on both packages: a ring of 137
cells stands at n_ctx 256, not at 96, whose 128 cells it exceeds, as
CohereForAI/c4ai-command-r7b's window of 4096 needs n_ctx 8192);
command-r with per-head q/k norms, which are LayerNorms there; and a
cohere2 context shift, which leaves the full layers' K rows (no rope) as
they were, where the JAX package rotates them (ROADMAP.md Queue 3 item
12).

Tolerances: logits within 1e-4 of their largest magnitude plus 1e-5 (f32
sums in another order); the shifted ring's K rows within 1e-5 (one f32
rotation in each package); token ids, positions, trees and the unrotated
rows exactly."""

import numpy as np
import pytest

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_gemma import (RING, assert_logits_close, check_decode_batch, check_load,
                                    check_prefill_and_greedy, check_state_crosses, contexts,
                                    load_pair, prompt, same_cells)

FIXTURES = {"command-r": dict(n_layer=2, tied_output=True, seed=29),
            "cohere2": dict(n_layer=5, tied_output=True, n_ctx=256, seed=29)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return {arch: load_pair(tmp_path_factory, arch, **kw) for arch, kw in FIXTURES.items()}


@pytest.mark.parametrize("arch", list(FIXTURES))
def test_load_matches_jax(models, arch):
    """The JAX package's hparams (LayerNorm and its epsilon, the parallel
    residual, logit_scale as the final scale, NORM rope; cohere2's SWA
    layers and NoPE full layers) and tree (no ffn_norm, no output)."""
    check_load(models[arch])
    hp, p = models[arch]["torch"].hparams, models[arch]["torch"].params
    assert (hp.norm_type, hp.parallel_residual, hp.final_logit_scale, hp.rope_type) == (
        "layer", True, 0.5, 0)
    assert "ffn_norm" not in p["layers"] and "output" not in p
    if arch == "cohere2":
        assert hp.swa_layers == (True, True, True, False, True) and hp.rope_swa_only


@pytest.mark.parametrize("arch", list(FIXTURES))
def test_prefill_and_greedy_match_jax(models, arch):
    tc = check_prefill_and_greedy(models[arch])
    assert tc._S_swa == (RING if arch == "cohere2" else 0)


@pytest.mark.parametrize("arch", list(FIXTURES))
def test_decode_batch_matches_jax(models, arch):
    check_decode_batch(models[arch])


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("arch", list(FIXTURES))
def test_state_file_crosses(models, tmp_path, arch, writer, reader):
    check_state_crosses(models[arch], tmp_path, writer, reader)


@pytest.mark.parametrize("n_ctx,two_stacks", [(96, False), (256, True)])
def test_cohere2_two_stack_rule(models, n_ctx, two_stacks):
    """With the window at 120 (both packages' hparams), the ring of 120 +
    16 + 1 = 137 cells is no smaller than n_ctx 96's 128 cells, so one
    stack stands; at n_ctx 256 (384 cells) two do. The JAX Context's
    choice, logits and cells either way."""
    pair = models["cohere2"]
    for pkg in ("jax", "torch"):
        pair[pkg].hparams.n_swa = 120
    try:
        jc, tc = contexts(pair, n_ctx=n_ctx)
        assert (tc._S_swa, isinstance(tc.kv_k, dict)) == ((137, True) if two_stacks
                                                          else (0, False))
        toks = prompt(80, seed=5)
        assert_logits_close(tc.decode(toks, n_logits=8), jc.decode(toks, n_logits=8))
        same_cells(tc, jc)
    finally:
        for pkg in ("jax", "torch"):
            pair[pkg].hparams.n_swa = 32


def test_command_r_qk_norms_are_layer_norms(models):
    """Per-head q/k norms of shape (n_head, head_dim) added to both
    packages' command-r parameters (the tensors a Command R+ file holds):
    the JAX logits, which move with the norms (the JAX package takes them
    as LayerNorms under norm_type "layer")."""
    import jax.numpy as jnp
    import torch

    pair = models["command-r"]
    hp = pair["torch"].hparams
    rng = np.random.default_rng(6)
    norms = {k: (1.0 + 0.1 * rng.standard_normal((hp.n_layer, h, hp.n_embd_head_k))
                 ).astype(np.float32)
             for k, h in (("attn_q_norm", hp.n_head), ("attn_k_norm", hp.n_head_kv))}
    for k, v in norms.items():
        pair["jax"].params["layers"][k] = jnp.asarray(v)
        pair["torch"].params["layers"][k] = torch.from_numpy(v)
    toks = prompt(30, seed=7)
    try:
        jc, tc = contexts(pair)
        lj, lt = jc.decode(toks, n_logits=30), tc.decode(toks, n_logits=30)
        assert_logits_close(lt, lj)
    finally:
        for k in norms:
            del pair["jax"].params["layers"][k], pair["torch"].params["layers"][k]
    _, plain = contexts(pair)
    assert float(np.abs(plain.decode(toks, n_logits=30) - lj).max()) > 1e-2


HUGE = (1 << 30) - 1  # seq_add's upper bound for "to the end"


def test_cohere2_shift_keeps_the_nope_layers(models):
    """A context shift (seq_rm of 4 tokens, seq_add of the rest by -4) on
    cohere2's two stacks: the full layers take no rope, so their K rows
    stay as they were, bit for bit; the ring's SWA rows re-rotate as the
    JAX package rotates them. The JAX package rotates the full layers' rows
    too (ROADMAP.md Queue 3 item 12), which moves them."""
    pair = models["cohere2"]
    jc, tc = contexts(pair)
    toks = prompt(40, seed=9)
    jc.decode(toks)
    tc.decode(toks)
    before = {"jax": np.asarray(jc.kv_k["full"]).copy(), "torch": tc.kv_k["full"].clone().numpy()}
    for c in (jc, tc):
        c.seq_rm(0, 4)
        c.seq_add(4, HUGE, -4)
    same_cells(tc, jc)
    np.testing.assert_array_equal(tc.kv_k["full"].numpy(), before["torch"])
    assert float(np.abs(np.asarray(jc.kv_k["full"]) - before["jax"]).max()) > 1e-3
    np.testing.assert_allclose(tc.kv_k["swa"].numpy(), np.asarray(jc.kv_k["swa"]),
                               rtol=1e-5, atol=1e-5)
