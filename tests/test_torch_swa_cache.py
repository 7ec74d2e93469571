"""The iswa two-stack cache (runtime/context.py) held against the JAX
package on the CPU: the port's counterpart of tests/test_swa_cache.py, on
make_tiny_llama_gguf(arch="gpt-oss", n_layer=4, n_expert=4) (sliding window
32 on the even layers, so two stacks of two layers; n_ctx 96 and n_ubatch
16, so a ring of 32 + 16 + 1 = 49 cells beside the full stack's 128).

Cases: the ring is smaller than swa_full's one stack, with the JAX
package's cell count and byte counts; prefill of a prompt longer than the
ring and decode past the window equal the JAX Context's, both stacks'
kv_pos equal cell for cell; the ring equals swa_full; greedy bursts (one
lane and a batch); an int8 ring; rollback and redecode; a context shift
(seq_rm + seq_add moving ring rows) with kv_pos equal to the JAX
package's; state and seq files round-trip and cross both ways between the
packages; seq_div raises the text that names swa_full; a prompt longer
than n_ubatch is split, and decode_multi refuses such a chunk;
speculative decoding (the model drafting for itself) on the ring.

Tolerances: logits within rtol = atol = 1e-4 against the JAX package (f32
sums in another order over four layers, as tests/test_torch_model.py); an
int8 cache's within 1e-4 of their largest magnitude (a K/V projection
summed in another order may land a value on the other side of a rounding
tie, as tests/test_torch_kv_int8.py states); 2e-5 against swa_full (the
same arithmetic over other cells, as the JAX file's); token ids and
positions exactly."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_model import LOGIT_TOL, _jax_load, _port_load
from tpullama.models.testing import make_tiny_llama_gguf

N_SWA = 32  # the fixture's sliding_window
N_CTX = 96
N_UBATCH = 16
RING_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The fixture loaded once by each package (f32, dense)."""
    p = str(tmp_path_factory.mktemp("gptoss") / "m.gguf")
    make_tiny_llama_gguf(p, arch="gpt-oss", n_embd=64, n_layer=4, n_head=4, n_head_kv=2,
                         n_ff=128, n_expert=4, n_ctx=N_CTX, seed=7)
    return {"jax": _jax_load(p), "torch": _port_load(p)}


def _ctx(models, pkg, swa_full=False, kv_dtype=None, n_seqs=1):
    if pkg == "jax":
        import jax.numpy as jnp

        from tpullama.runtime.context import Context, ContextParams

        kv = jnp.int8 if kv_dtype == "int8" else None
    else:
        from tpullama_torch.runtime import Context, ContextParams

        kv = torch.int8 if kv_dtype == "int8" else None
    return Context(models[pkg], ContextParams(n_ctx=N_CTX, n_ubatch=N_UBATCH, n_seqs=n_seqs,
                                              swa_full=swa_full, kv_dtype=kv))


def _close(got, want, kv_dtype=None):
    """Logits against the JAX package's, by the tolerance of the cache."""
    if kv_dtype == "int8":
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, **LOGIT_TOL)


def _same_positions(tc, jc):
    for stack in ("full", "swa"):
        np.testing.assert_array_equal(tc.kv_pos[stack].numpy(), np.asarray(jc.kv_pos[stack]),
                                      err_msg=stack)
    np.testing.assert_array_equal(tc._pos_host, jc._pos_host)
    np.testing.assert_array_equal(tc.n_past, jc.n_past)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(3, 250, size=n).astype(np.int32)


def test_ring_is_smaller_than_swa_full(models):
    """Two stacks of two layers: the full layers' 128 cells and the SWA
    layers' ring of n_swa + n_ubatch + 1 cells, the JAX package's count;
    swa_full keeps one stack; the byte counts are the JAX package's."""
    hp = models["torch"].hparams
    assert hp.n_swa == N_SWA and hp.swa_layers == (True, False, True, False)
    small, full = _ctx(models, "torch"), _ctx(models, "torch", swa_full=True)
    jsmall = _ctx(models, "jax")
    assert small._S_swa == jsmall._S_swa == N_SWA + N_UBATCH + 1
    assert tuple(small.kv_k["swa"].shape) == (2, 1, 2, N_SWA + N_UBATCH + 1, 16)
    assert tuple(small.kv_k["full"].shape) == (2, 1, 2, 128, 16)
    assert tuple(small.kv_pos["swa"].shape) == (1, N_SWA + N_UBATCH + 1)
    assert not isinstance(full.kv_k, dict) and full._S_swa == 0
    bs, bf = small.memory_breakdown(), full.memory_breakdown()
    assert bs["kv_cache"] < bf["kv_cache"]
    assert bs["kv_cache_swa_layers"] < bs["kv_cache_full_layers"]
    assert bs["kv_cache"] == bs["kv_cache_swa_layers"] + bs["kv_cache_full_layers"]
    jb = jsmall.memory_breakdown()
    assert {k: bs[k] for k in jb if k != "weights"} == {k: jb[k] for k in jb if k != "weights"}


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_prefill_and_decode_match_jax(models, kv_dtype):
    """A 70-token prompt (past the ring, prefilled in n_ubatch chunks) and
    20 one-token steps past the window: the JAX package's logits, and both
    stacks' positions cell for cell after each."""
    tc, jc = _ctx(models, "torch", kv_dtype=kv_dtype), _ctx(models, "jax", kv_dtype=kv_dtype)
    prompt = _prompt(70)
    _close(tc.decode(prompt, n_logits=3), jc.decode(prompt, n_logits=3), kv_dtype)
    _same_positions(tc, jc)
    for t in _prompt(20, seed=1):
        _close(tc.decode(np.asarray([t])), jc.decode(np.asarray([t])), kv_dtype)
    _same_positions(tc, jc)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_ring_matches_swa_full(models, kv_dtype):
    """The same prompt and steps on the ring and on swa_full's one stack."""
    small = _ctx(models, "torch", kv_dtype=kv_dtype)
    full = _ctx(models, "torch", swa_full=True, kv_dtype=kv_dtype)
    prompt = _prompt(41)
    np.testing.assert_allclose(small.decode(prompt, n_logits=3), full.decode(prompt, n_logits=3),
                               **RING_TOL)
    for t in _prompt(40, seed=2):
        np.testing.assert_allclose(small.decode(np.asarray([t])), full.decode(np.asarray([t])),
                                   **RING_TOL)


def test_bursts_match(models):
    """decode_burst (one lane) and decode_batch_burst (three lanes, one
    inactive) on the ring: the ids of swa_full and of the JAX package, and
    the JAX package's positions after."""
    ctxs = {"ring": _ctx(models, "torch"), "full": _ctx(models, "torch", swa_full=True),
            "jax": _ctx(models, "jax")}
    ids = {}
    for name, ctx in ctxs.items():
        first = int(np.argmax(ctx.decode(_prompt(20))[-1]))
        ids[name] = ctx.decode_burst(first, 40)
    _same_positions(ctxs["ring"], ctxs["jax"])
    np.testing.assert_array_equal(ids["ring"], ids["full"])
    np.testing.assert_array_equal(ids["ring"], ids["jax"])
    tc, jc = _ctx(models, "torch", n_seqs=3), _ctx(models, "jax", n_seqs=3)
    chunks = [(0, _prompt(12)), (2, _prompt(9, seed=3))]
    mt, mj = tc.decode_multi(chunks), jc.decode_multi(chunks)
    first = np.asarray([int(np.argmax(mj[0])), 0, int(np.argmax(mj[2]))], np.int32)
    active = np.asarray([True, False, True])
    np.testing.assert_array_equal(tc.decode_batch_burst(first, active, 45),
                                  jc.decode_batch_burst(first, active, 45))
    _same_positions(tc, jc)


def test_rollback_and_redecode(models):
    """A rolled-back tail (speculative decoding's) on the ring: the JAX
    package's positions and the logits of swa_full and of the JAX package
    on the redecoded tail."""
    ctxs = [_ctx(models, "torch"), _ctx(models, "torch", swa_full=True), _ctx(models, "jax")]
    out = []
    for c in ctxs:
        c.decode(_prompt(44))
        c.decode(np.arange(40, 52))
        c.rollback_to(44)
        out.append(c.decode(np.arange(50, 56), n_logits=6))
    _same_positions(ctxs[0], ctxs[2])
    np.testing.assert_allclose(out[0], out[1], **RING_TOL)
    np.testing.assert_allclose(out[0], out[2], **LOGIT_TOL)


def test_context_shift(models):
    """seq_rm + seq_add (the CLI's context shift) on the ring: K rows
    re-rotate and move to their new positions' cells; the JAX package's
    positions on both stacks, and the next steps' logits equal swa_full's
    and the JAX package's."""
    ctxs = [_ctx(models, "torch"), _ctx(models, "torch", swa_full=True), _ctx(models, "jax")]
    n_keep, n_discard, n = 4, 16, 60
    for c in ctxs:
        c.decode(_prompt(n))
        c.seq_rm(n_keep, n_keep + n_discard)
        c.seq_add(n_keep + n_discard, n, -n_discard)
        c.n_past[0] = n - n_discard
    _same_positions(ctxs[0], ctxs[2])
    for t in (60, 61, 62):
        ls, lf, lj = (c.decode(np.asarray([t])) for c in ctxs)
        np.testing.assert_allclose(ls, lf, rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(ls, lj, **LOGIT_TOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("kind", ["state", "seq"])
@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("jax", "torch"),
                                           ("torch", "jax")],
                         ids=["roundtrip", "jax-to-torch", "torch-to-jax"])
def test_state_files_cross(models, tmp_path, writer, reader, kind, kv_dtype):
    """A two-stack Context prefilled past the ring, saved whole (state) or
    as lane 1 of 2 (seq) by one package and restored by the other into a
    fresh Context: the nested leaves kv_k/full, kv_k/swa (int8: .../q,
    .../s) and kv_pos/full, kv_pos/swa; the restored Context continues
    with the writer's 8 greedy tokens and logits."""
    from tpullama.runtime import state as j_state
    from tpullama_torch.runtime import state as t_state

    mods = {"jax": j_state, "torch": t_state}
    lane = 1 if kind == "seq" else 0
    src = _ctx(models, writer, kv_dtype=kv_dtype, n_seqs=2)
    toks = [int(t) for t in _prompt(58, seed=4)]
    src.decode(np.asarray(toks), seq_id=lane)
    f = str(tmp_path / "s.bin")
    if kind == "state":
        mods[writer].state_save(src, f, tokens=toks)
    else:
        mods[writer].seq_save(src, lane, f, tokens=toks)
    dst = _ctx(models, reader, kv_dtype=kv_dtype, n_seqs=2)
    got = (mods[reader].state_load(dst, f) if kind == "state"
           else mods[reader].seq_load(dst, lane, f))
    assert [int(t) for t in got] == toks

    def greedy(ctx, n=8):
        tok, out = toks[-1], []
        for _ in range(n):
            logits = ctx.decode(np.asarray([tok], np.int32), seq_id=lane)
            tok = int(np.argmax(logits[-1]))
            out.append((tok, logits))
        return out

    want, have = greedy(src), greedy(dst)
    assert [t for t, _ in have] == [t for t, _ in want]
    _close(have[-1][1], want[-1][1], kv_dtype)
    if writer == "torch":
        from tpullama_torch.runtime.state import _open_read

        hdr, _ = _open_read(f, t_state.MAGIC_CTX if kind == "state" else t_state.MAGIC_SEQ)
        leaves = ["/q", "/s"] if kv_dtype else [""]
        assert [n for n in hdr["arrays"] if n.startswith("kv_")] == [
            f"{t}/{s}{q}" for t in ("kv_k", "kv_v") for s in ("full", "swa") for q in leaves
        ] + ["kv_pos/full", "kv_pos/swa"]


def test_seq_div_raises(models):
    """seq_div on the ring raises the JAX package's RuntimeError, which
    names swa_full; swa_full's one stack takes it."""
    small = _ctx(models, "torch")
    small.decode(_prompt(12))
    with pytest.raises(RuntimeError, match="swa_full"):
        small.seq_div(0, 12, 2)
    full = _ctx(models, "torch", swa_full=True)
    full.decode(_prompt(12))
    full.seq_div(0, 12, 2)


def test_long_prompt_is_split(models, monkeypatch):
    """A 45-token prompt with 20 logits on the ring runs as forwards of at
    most n_ubatch tokens (16, 16, 13) and returns the JAX package's 20
    logit rows, which span two chunks; swa_full runs it in one forward.
    Embeddings of the prompt equal swa_full's, every chunk's rows; a
    decode_multi chunk longer than n_ubatch is refused."""
    from tpullama_torch.runtime import Context

    widths = []
    forward = Context._forward

    def counting(self, kv_k, kv_v, kv_pos, tokens, *args, **kw):
        widths.append((isinstance(kv_pos, dict), int((args[0] >= 0).sum())))
        return forward(self, kv_k, kv_v, kv_pos, tokens, *args, **kw)

    monkeypatch.setattr(Context, "_forward", counting)
    small, full, jc = _ctx(models, "torch"), _ctx(models, "torch", True), _ctx(models, "jax")
    prompt = _prompt(45)
    ls = small.decode(prompt, n_logits=20)
    assert widths == [(True, 16), (True, 16), (True, 13)]
    np.testing.assert_allclose(ls, jc.decode(prompt, n_logits=20), **LOGIT_TOL)
    np.testing.assert_allclose(ls, full.decode(prompt, n_logits=20), **RING_TOL)
    assert widths[3:] == [(False, 45)]
    np.testing.assert_allclose(small.embeddings(prompt, pooling="none"),
                               full.embeddings(prompt, pooling="none"), **RING_TOL)
    with pytest.raises(ValueError, match="exceeds n_ubatch"):
        small.decode_multi([(0, _prompt(N_UBATCH + 1))])


def test_speculative_on_the_ring(models):
    """generate_speculative with the model as its own draft (n_draft 4),
    the target on the two-stack cache: each round verifies a draft and
    rolls the ring back past its rejected tail; 30 tokens from a 40-token
    prompt, past the ring; tokens and draft counts equal the JAX
    package's."""
    from tpullama.runtime import speculative as j_sp
    from tpullama_torch.runtime import speculative as t_sp

    toks = [int(t) for t in _prompt(40, seed=5)]
    out = {}
    for pkg, sp in (("jax", j_sp), ("torch", t_sp)):
        spec = sp.Speculative(models[pkg], sp.SpeculativeParams(n_draft=4, p_min=0.0),
                              n_ctx=N_CTX)
        ctx = _ctx(models, pkg)
        assert ctx._S_swa == N_SWA + N_UBATCH + 1
        out[pkg] = sp.generate_speculative(ctx, spec, toks, n_predict=30)
    (tokens, stats), (j_tokens, j_stats) = out["torch"], out["jax"]
    assert tokens == j_tokens and len(tokens) == 30 and stats == j_stats
    assert stats["n_accepted"] > 0
