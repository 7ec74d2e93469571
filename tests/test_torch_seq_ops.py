"""The port's KV sequence ops (tpullama_torch/runtime/context.py: seq_add,
seq_div and seq_cp, with the K re-rotation _rotate) held against the JAX
package's (tpullama/runtime/context.py) on the CPU. Fixtures:
make_tiny_llama_gguf at n_embd=64, 2 layers, dense F32, f32 caches of two
lanes: a llama (rope over the whole head), a chatglm (rope over half of
each head) and a llama with YaRN scaling (whose re-rotation applies the
mscale again, as the JAX package does).

The card test (marked cuda) runs seq_add between two steps that replay the
lane's captured CUDA graph: the replay must read the shifted cache, so its
logits equal an eager Context's.

Tolerances: K and V rows within 1e-5 of the largest |K| or |V| (the
same f32 rotation on both sides; the prefill's projections sum in
another order); positions (kv_pos, the host
mirror), n_past and greedy tokens exactly; logits within rtol = atol =
1e-4; the untouched lane bit for bit; on the card a replay's logits equal
the eager step's bit for bit."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.models.testing import make_tiny_llama_gguf

PROMPT = "Once upon a time there was"
KINDS = {
    "llama": {},
    "glm": dict(arch="chatglm"),
    "yarn": dict(extra_kv={"llama.rope.scaling.type": "yarn", "llama.rope.scaling.factor": 4.0,
                           "llama.rope.scaling.original_context_length": 64}),
}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
HUGE = (1 << 30) - 1  # Speculative.gen_draft's upper bound


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    out = {}
    for kind, kw in KINDS.items():
        p = str(tmp_path_factory.mktemp(kind) / "m.gguf")
        make_tiny_llama_gguf(p, n_embd=64, n_layer=2, seed=31, **kw)
        out[kind] = p
    return out


def _pair(path):
    """A JAX and a port Context (f32, 2 lanes of 64 cells) over the same
    file, lane 0 holding the prompt and lane 1 a shorter one."""
    from tpullama.models import load_model as j_load
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.models import load_model as t_load
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    tm = t_load(path, device="cpu")
    jc, tc = JC(j_load(path), JCP(n_ctx=64, n_seqs=2)), TC(tm, TCP(n_ctx=64, n_seqs=2))
    toks = tm.vocab.tokenize(PROMPT, add_special=True)
    for c in (jc, tc):
        c.decode(np.asarray(toks), seq_id=0)
        c.decode(np.asarray(toks[:5]), seq_id=1)
    return jc, tc


def _same_cache(jc, tc):
    for j, t in ((jc.kv_k, tc.kv_k), (jc.kv_v, tc.kv_v)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-5 * np.abs(j).max()
    np.testing.assert_array_equal(tc.kv_pos.numpy(), np.asarray(jc.kv_pos))
    np.testing.assert_array_equal(tc._pos_host, jc._pos_host)
    np.testing.assert_array_equal(tc.n_past, jc.n_past)


OPS = {
    "shift": lambda c: (c.seq_rm(1, 4), c.seq_add(4, HUGE, -3)),
    "add_range": lambda c: c.seq_add(2, 6, 5),
    "div": lambda c: c.seq_div(2, 7, 2),
    "cp": lambda c: c.seq_cp(0, 1),
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_seq_op_is_the_reference(ggufs, kind, op):
    """Each op leaves the reference's K rows, positions and n_past."""
    jc, tc = _pair(ggufs[kind])
    for c in (jc, tc):
        OPS[op](c)
    _same_cache(jc, tc)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_greedy_after_a_shift_is_the_reference(ggufs, kind):
    """A context shift (seq_rm then seq_add down to the gap), then 8 greedy
    steps: the reference's tokens and logits."""
    jc, tc = _pair(ggufs[kind])
    for c in (jc, tc):
        c.seq_rm(1, 4)
        c.seq_add(4, HUGE, -3)
    tok_j = tok_t = 7
    out_j, out_t = [], []
    for _ in range(8):
        lj, lt = jc.decode(np.asarray([tok_j])), tc.decode(np.asarray([tok_t]))
        np.testing.assert_allclose(lt, lj, **LOGIT_TOL)
        tok_j, tok_t = int(np.argmax(lj[-1])), int(np.argmax(lt[-1]))
        out_j.append(tok_j)
        out_t.append(tok_t)
    assert out_t == out_j
    _same_cache(jc, tc)


@pytest.mark.parametrize("op", ["shift", "add_range", "div"])
def test_other_lane_is_untouched(ggufs, op):
    """An op on lane 0 leaves lane 1's K, V and positions bit-equal."""
    _, tc = _pair(ggufs["llama"])
    before = [t[:, 1].clone() for t in (tc.kv_k, tc.kv_v)] + [tc.kv_pos[1].clone()]
    host = tc._pos_host[1].copy()
    OPS[op](tc)
    after = [t[:, 1] for t in (tc.kv_k, tc.kv_v)] + [tc.kv_pos[1]]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    np.testing.assert_array_equal(tc._pos_host[1], host)


def test_huge_upper_bound_moves_every_later_cell(ggufs):
    """seq_add(p0, 2**30 - 1, d) moves every cell at or after p0 and no
    other, and n_past with them."""
    jc, tc = _pair(ggufs["llama"])
    pos0 = tc._pos_host[0].copy()
    n0 = int(tc.n_past[0])
    for c in (jc, tc):
        c.seq_add(3, HUGE, 10)
    moved = pos0 >= 3
    np.testing.assert_array_equal(tc._pos_host[0][moved], pos0[moved] + 10)
    np.testing.assert_array_equal(tc._pos_host[0][~moved], pos0[~moved])
    assert int(tc.n_past[0]) == n0 + 10
    _same_cache(jc, tc)


def test_seq_ops_write_the_cache_in_place(ggufs):
    """The step programs' graphs read kv_k and kv_pos at fixed addresses:
    every op writes into the tensors it was given."""
    _, tc = _pair(ggufs["llama"])
    ptrs = [t.data_ptr() for t in (tc.kv_k, tc.kv_v, tc.kv_pos)]
    for op in OPS.values():
        op(tc)
    assert [t.data_ptr() for t in (tc.kv_k, tc.kv_v, tc.kv_pos)] == ptrs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("a replayed CUDA graph needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_seq_add_between_replayed_steps(cuda, ggufs, kind):
    """A step that replays the lane's graph, seq_add, and the next replayed
    step: the same logits as an eager Context doing the same, bit for bit,
    and close to the CPU port's."""
    from tpullama_torch.models import load_model
    from tpullama_torch.runtime import Context, ContextParams

    class Eager(Context):
        def _run(self, prog):
            return self._step(prog)

    path = ggufs[kind]
    m, mc = load_model(path, device="cuda"), load_model(path, device="cpu")
    cp = ContextParams(n_ctx=64)
    g, e, c = Context(m, cp), Eager(m, cp), Context(mc, cp)
    toks = m.vocab.tokenize(PROMPT, add_special=True)
    for ctx in (g, e, c):
        ctx.decode(np.asarray(toks))
        ctx.decode(np.asarray([7]))
    assert g._programs[(0, 1, None)].graph is not None
    for step in range(3):
        for ctx in (g, e, c):
            ctx.seq_add(2 + step, HUGE, -1)
        lg, le, lc = (ctx.decode(np.asarray([9 + step])) for ctx in (g, e, c))
        np.testing.assert_array_equal(lg, le)
        np.testing.assert_allclose(lg, lc, **LOGIT_TOL)
        np.testing.assert_array_equal(g._pos_host, c._pos_host)
        assert torch.equal(g.kv_pos.cpu(), c.kv_pos)


def test_shift_with_rope_freqs_is_a_fresh_prefill(ggufs):
    """With rope_freqs (Llama-3.x), a context shift leaves layer 0's K rows
    (which depend on their token and position alone) equal to a fresh
    prefill of the kept tokens at their new positions. The port's rotation
    divides by rope_freqs as the forward pass does; the JAX package's
    _rotate leaves them out (ROADMAP.md Queue 3 item 8), so this case is
    held against the exact answer, not against the JAX package."""
    from tpullama_torch.models import load_model
    from tpullama_torch.runtime import Context, ContextParams

    m = load_model(ggufs["llama"], device="cpu")
    m.params["rope_freqs"] = torch.linspace(1.0, 8.0, m.hparams.n_rot // 2)
    toks = m.vocab.tokenize(PROMPT, add_special=True)
    shifted, fresh = Context(m, ContextParams(n_ctx=64)), Context(m, ContextParams(n_ctx=64))
    shifted.decode(np.asarray(toks))
    shifted.seq_rm(0, 3)
    shifted.seq_add(3, HUGE, -3)
    fresh.decode(np.asarray(toks[3:]))
    pos = shifted._pos_host[0]
    cells = np.argsort(np.where(pos >= 0, pos, 1 << 20))[: len(toks) - 3]
    got, want = shifted.kv_k[0, 0][:, cells], fresh.kv_k[0, 0][:, : len(toks) - 3]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
