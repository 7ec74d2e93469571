"""The second half of the non-gated FFN archs (tests/test_torch_nongated_archs.py
holds the first and the fixtures of all seven): codeshell (gpt2's blocks
with NEOX rope), gpt2 and starcoder (learned absolute positions, no rope;
starcoder's tied lm_head), on the JAX oracle's fixtures, with the same
cases; then

- a gated FFN (the llama fixture) whose gate, up and down carry biases:
  both packages add each after its projection;
- gpt2's decode_multi and decode_batch over 2 lanes (each lane's learned
  position rows on a batched step);
- a context shift on gpt2 (learned positions: the cached rows keep their
  old positions' rows, no rotation) and on phi2 with rope over 8 of its 16
  head dims: seq_rm of the first 3 tokens and seq_add(-3) in both
  packages; phi2's kept K rows equal a fresh prefill of the kept tokens
  at their new positions and the JAX package's rows; gpt2's next tokens
  read the position rows of their shifted positions, as a fresh prefill
  does, and give the logits of the JAX package, whose seq_add raises on a
  model without rope unless its rotation is made the identity
  (ROADMAP.md Queue 3 item 15);
- the learned position table's range: the port's Context (and
  make_context) refuses an n_ctx above position_embd's rows by name,
  where the JAX package's Context runs on and a prompt past the table
  gives NaN logits (jnp.take fills the rows past it; ROADMAP.md Queue 3
  item 14).

On the card (`cuda`): each of the seven archs at n_embd 256 with every
layer matrix Q4_K, a card Context against the CPU's; and the paths no
other card test held: gpt-oss's sinks on the windowed ring (wrapped), and
the gemma3 and cohere2 forwards on their two stacks.

Tolerances: trees exactly; logits within rtol = atol = 1e-4; tokens
exactly; shifted K rows within 1e-5 of their largest magnitude (one f32
rotation against another); card against CPU within 1e-3 of the CPU
logits' largest magnitude plus 1e-4 (f32 sums in the kernels' order)."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_flag_archs import (check_greedy, check_load, check_prefill, port_context,
                                         reference, write_and_reference)
from tests.test_torch_gemma import check_decode_batch, load_pair
from tests.test_torch_model import LOGIT_TOL, PROMPT, _edit_gguf, _jax_load, _port_load
from tests.test_torch_nongated_archs import (FIXTURES, FIRST, PACKED, PARTIAL_ROT,
                                             check_arch_tensors, check_packed, edited,
                                             fixture_file)
from tpullama.models.testing import make_tiny_llama_gguf

SECOND = tuple(a for a in FIXTURES if a not in FIRST)
HUGE = 2**30 - 1


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return {arch: write_and_reference(tmp_path_factory, arch, **FIXTURES[arch])
            for arch in SECOND}


@pytest.mark.parametrize("arch", SECOND)
def test_load_matches_jax(refs, arch):
    t = check_load(refs[arch])
    check_arch_tensors(arch, t)
    if arch in ("gpt2", "starcoder"):
        # the table's rows: make_tiny_llama_gguf's n_ctx 256
        assert tuple(t.params["position_embd"].shape) == (256, t.hparams.n_embd)
        assert t.params["position_embd"].dtype == torch.float32


@pytest.mark.parametrize("arch", SECOND)
def test_prefill_logits_match_jax(refs, arch):
    check_prefill(refs[arch], _port_load(refs[arch]["path"]))


@pytest.mark.parametrize("arch", SECOND)
def test_greedy_tokens_match_jax(refs, arch):
    check_greedy(refs[arch], _port_load(refs[arch]["path"]))


@pytest.mark.parametrize("arch", SECOND)
def test_packed_q4k_matches_jax(tmp_path_factory, arch):
    """n_embd 256, every layer matrix Q4_K (starcoder's tied lm_head the
    dense token table in both packages)."""
    tm = check_packed(fixture_file(tmp_path_factory, arch, "_q4k", **PACKED))
    assert set(tm.quant_meta["layers"]) == {"attn_qkv", "attn_output", "ffn_up", "ffn_down"}
    assert ("output" in tm.quant_meta) == (arch != "starcoder")


def test_gated_ffn_biases_match_jax(tmp_path_factory):
    """The llama fixture with ffn_gate.bias, ffn_up.bias and ffn_down.bias in
    every layer: both loaders map them, both forwards add them."""
    from tpullama.gguf import GGUFReader

    src = str(tmp_path_factory.mktemp("llama_fb_src") / "m.gguf")
    make_tiny_llama_gguf(src, n_layer=2, seed=19)
    r = GGUFReader(src)
    n_ff, n_embd = r.tensors["blk.0.ffn_gate.weight"].shape
    rng = np.random.default_rng(6)
    biases = {f"blk.{il}.ffn_{nm}.bias": (0.1 * rng.standard_normal(n)).astype(np.float32)
              for il in range(2) for nm, n in (("gate", n_ff), ("up", n_ff), ("down", n_embd))}
    path = str(tmp_path_factory.mktemp("llama_fb") / "m.gguf")
    _edit_gguf(src, path, tensors=biases)
    ref = reference(path)
    t = check_load(ref)
    assert t.hparams.ffn_gated
    assert {"ffn_gate_bias", "ffn_up_bias", "ffn_down_bias"} <= set(t.params["layers"])
    check_prefill(ref, t)
    check_greedy(ref, t)
    plain = reference(src)
    assert np.abs(plain["logits"] - ref["logits"]).max() > 1e-3


def test_gpt2_decode_batch_matches_jax(tmp_path_factory):
    """Two gpt2 lanes prefilled together and six batched steps: each lane's
    tokens take the position rows of their own positions; the JAX
    Context's logits and cells."""
    check_decode_batch(load_pair(tmp_path_factory, "gpt2", n_layer=2, **FIXTURES["gpt2"]))


def shifted_pair(tm, jm, toks, n_ctx=64):
    """Port and JAX Contexts that prefilled `toks`, dropped the first 3
    tokens and shifted the rest down by 3."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP

    tc, jc = port_context(tm, n_ctx=n_ctx), JC(jm, JCP(n_ctx=n_ctx))
    for c in (tc, jc):
        c.decode(toks)
        c.seq_rm(0, 3)
        c.seq_add(3, HUGE, -3)
    np.testing.assert_array_equal(tc._pos_host, jc._pos_host)
    assert int(tc.n_past[0]) == int(jc.n_past[0]) == len(toks) - 3
    return tc, jc


def cells_by_position(ctx, n):
    pos = ctx._pos_host[0]
    return np.argsort(np.where(pos >= 0, pos, 1 << 20))[:n]


def test_phi2_partial_rope_shift_matches_a_fresh_prefill(tmp_path_factory):
    """phi2 rotating 8 of 16 head dims: after the shift, layer 0's kept K
    rows (which depend on their token and position alone) equal a fresh
    prefill of the kept tokens, and the JAX package's shifted rows; the
    next token's logits equal the JAX package's."""
    path = edited(tmp_path_factory, "phi2", "_rot_b",
                  kv={"phi2.rope.dimension_count": PARTIAL_ROT})
    tm, jm = _port_load(path), _jax_load(path)
    assert tm.hparams.n_rot == PARTIAL_ROT
    toks = np.asarray(tm.vocab.tokenize(PROMPT + " there was", add_special=True))
    n = len(toks) - 3
    tc, jc = shifted_pair(tm, jm, toks)
    fresh = port_context(tm)
    fresh.decode(toks[3:])
    cells = cells_by_position(tc, n)
    got, want = tc.kv_k[0, 0][:, cells], fresh.kv_k[0, 0][:, :n]
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    j_rows = torch.from_numpy(np.asarray(jc.kv_k[0, 0])[:, cells])
    assert float((got - j_rows).abs().max()) <= tol
    np.testing.assert_allclose(tc.decode(np.asarray([65])), jc.decode(np.asarray([65])),
                               **LOGIT_TOL)


def test_gpt2_shift_reads_the_shifted_position_rows(refs, monkeypatch):
    """gpt2 has no rope: the port's shift leaves the cached rows as they
    were, and the next tokens take position_embd at their shifted
    positions: layer 0's K row of each is a fresh prefill's of the kept
    tokens plus them. The JAX package's seq_add raises on a model without
    rope (its rotation asks apply_rope for mode -1; ROADMAP.md Queue 3
    item 15, a fault of the reference); with that rotation as the identity
    its rows and next logits are the port's."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama.runtime import context as j_context

    ref = refs["gpt2"]
    tm, jm = _port_load(ref["path"]), ref["model"]
    toks = np.asarray(tm.vocab.tokenize(PROMPT + " there was", add_special=True))
    n = len(toks) - 3
    jc = JC(jm, JCP(n_ctx=64))
    jc.decode(toks)
    jc.seq_rm(0, 3)
    with pytest.raises(NotImplementedError, match="rope mode -1"):
        jc.seq_add(3, HUGE, -3)
    monkeypatch.setattr(j_context, "_shift_k_rows", lambda kv_k, *a: kv_k)
    plain = port_context(tm)
    plain.decode(toks)
    tc, jc = shifted_pair(tm, jm, toks)
    kept = cells_by_position(tc, n)
    assert torch.equal(tc.kv_k[:, 0][:, :, kept], plain.kv_k[:, 0][:, :, kept])
    j_rows = np.asarray(jc.kv_k)[:, 0]
    assert np.abs(tc.kv_k[:, 0].numpy() - j_rows).max() <= 1e-5 * np.abs(j_rows).max()
    new = [65, 66, 67, 68]
    for tok in new:
        np.testing.assert_allclose(tc.decode(np.asarray([tok])), jc.decode(np.asarray([tok])),
                                   **LOGIT_TOL)
    fresh = port_context(tm)
    fresh.decode(np.concatenate([toks[3:], new]))
    cells = cells_by_position(tc, n + len(new))[n:]
    got, want = tc.kv_k[0, 0][:, cells], fresh.kv_k[0, 0][:, n:n + len(new)]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_position_table_bounds_n_ctx(refs):
    """ROADMAP.md Queue 3 item 14 (a fault of the reference): gpt2's table
    has 256 rows. The port's Context and make_context refuse n_ctx 257 by
    the table's name and size and take 256; the JAX package's Context at
    n_ctx 300 runs a 256-token prompt to finite logits, but a 260-token
    one to NaN in every row: jnp.take fills the rows past the table with
    NaN, their K/V cells hold NaN, and every query's masked product with
    them (0 * NaN) is NaN."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.runtime import ContextParams, make_context

    ref = refs["gpt2"]
    tm = _port_load(ref["path"])
    for make in (port_context, lambda m, n_ctx: make_context(m, ContextParams(n_ctx=n_ctx))):
        with pytest.raises(ValueError, match=r"n_ctx=257 exceeds .*position_embd\) of 256 rows"):
            make(tm, n_ctx=257)
        assert make(tm, n_ctx=256).p.n_ctx == 256
    toks = np.random.default_rng(3).integers(3, 250, 260).astype(np.int32)
    for n, finite in ((256, True), (260, False)):
        lj = np.asarray(JC(ref["model"], JCP(n_ctx=300)).decode(toks[:n], n_logits=n))
        assert np.isfinite(lj).all() if finite else np.isnan(lj).all()


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the card's Context needs a CUDA card")
    return torch.device("cuda")


def card_against_cpu(path, toks, n_ctx, n_logits, n_ubatch=512, kernels=()):
    """`path` loaded packed (f32 scales) on the card and on the CPU: the
    card's Context (kernels) against the CPU's (plain versions): the last
    n_logits prefill logits within 1e-3 of their largest magnitude plus
    1e-4, then 8 greedy tokens (the replayed one-token steps) identical,
    with equal cache positions; each of `kernels` launched."""
    from tpullama_torch.models import load_model
    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts
    from tpullama_torch.runtime import Context, ContextParams

    kw = dict(packed=True, packed_scale_dtype=torch.float32)
    gm, cm = load_model(path, device="cuda", **kw), load_model(path, device="cpu", **kw)
    cp = ContextParams(n_ctx=n_ctx, n_ubatch=n_ubatch)
    toks = np.asarray(toks, np.int32)
    reset_launch_counts()
    cg, cc = Context(gm, cp), Context(cm, cp)
    lg, lc = cg.decode(toks, n_logits=n_logits), cc.decode(toks, n_logits=n_logits)
    assert np.isfinite(lg).all() and lg.shape == lc.shape
    assert np.abs(lg - lc).max() <= 1e-3 * np.abs(lc).max() + 1e-4
    cg, cc = Context(gm, cp), Context(cm, cp)
    assert cg.generate(list(toks), n_predict=8) == cc.generate(list(toks), n_predict=8)
    for stack in (cg.kv_pos if isinstance(cg.kv_pos, dict) else {"one": cg.kv_pos}):
        got = cg.kv_pos[stack] if stack != "one" else cg.kv_pos
        want = cc.kv_pos[stack] if stack != "one" else cc.kv_pos
        assert torch.equal(got.cpu(), want)
    counts = launch_counts()
    assert all(counts[k] > 0 for k in kernels), counts
    return cg


@pytest.fixture
def card_file(cuda, tmp_path):
    """A writer of the card tests' files, written per test after `cuda`."""
    def write(name, **kw):
        p = str(tmp_path / f"{name}.gguf")
        make_tiny_llama_gguf(p, **kw)
        return p
    return write


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(FIXTURES))
def test_card_context_matches_the_cpu(card_file, arch):
    """Each non-gated arch at n_embd 256, every layer matrix Q4_K: prefill
    (qmm_tiled, flash_attention) and greedy steps (qmm_gemv, flash_decode)
    on the card against the CPU."""
    path = card_file(arch, n_layer=2, arch=arch, **{**FIXTURES[arch], **PACKED})
    toks = _port_load(path).vocab.tokenize(PROMPT, add_special=True)
    card_against_cpu(path, toks, n_ctx=64, n_logits=len(toks),
                     kernels=("qmm_gemv", "qmm_tiled", "flash_attention", "flash_decode"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gpt-oss", "gemma3", "cohere2"])
def test_card_two_stack_forwards_match_the_cpu(card_file, arch):
    """The forwards the card held only in chip_smoke.py: gpt-oss's per-head
    sinks on the windowed ring of 32 + 16 + 1 cells, gemma3's (q/k norms,
    sandwich norms, GELU, 7 SWA layers of 8) and cohere2's (LayerNorm,
    parallel residual, NoPE full layers) on their two stacks, every layer
    matrix Q4_K at n_embd 256: a 60-token prompt in 16-token chunks wraps
    each ring; card against CPU."""
    kw = {"gpt-oss": dict(n_layer=2, n_expert=4, seed=11),
          "gemma3": dict(n_layer=8, seed=70),
          "cohere2": dict(n_layer=5, tied_output=True, seed=29)}[arch]
    path = card_file(arch, arch=arch, **PACKED, **kw)
    toks = np.random.default_rng(12).integers(3, 259, 60)
    cg = card_against_cpu(path, toks, n_ctx=256, n_logits=20, n_ubatch=16,
                          kernels=("qmm_gemv", "qmm_tiled", "flash_attention", "flash_decode"))
    assert cg._S_swa == cg.hp.n_swa + 16 + 1 and isinstance(cg.kv_k, dict)
    if arch == "gpt-oss":
        assert "attn_sinks" in cg.model.params["layers"]
