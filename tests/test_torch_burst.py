"""The port's one-token step programs and on-device bursts
(tpullama_torch/runtime/context.py: decode_burst, the sampled burst,
generate(burst=), decode_batch_burst, and the CUDA graphs they replay on
the card) held against the JAX package's jitted step programs
(tpullama/runtime/context.py), on the CPU, where the port runs the same
eager step its graphs capture and the JAX package runs its Pallas kernels
in interpret mode (exact f32 qmm). Fixtures: make_tiny_llama_gguf at
n_embd=256, n_ff=256, 2 layers, dense F32, packed Q4_K, and a Q4_K
Mixtral-style MoE (4 experts, 2 per token).

The card tests (marked cuda) hold a graph's replays against the eager
step on the same inputs, the launch counts a replay adds, the sampled
burst's determinism, and the cooperative fused_postattn kernel inside a
graph.

Tolerances: greedy ids, burst ids, n_past, the host mirror _pos_host and
the device kv_pos exactly (both pick tokens by argmax of f32 logits that
agree to ~1e-6, tests/test_torch_model.py); logits within rtol = atol =
1e-4 on the CPU; on the card a replay's logits and ids equal the eager
step's bit for bit (the same kernels on the same inputs in the same
order), and the fused kernel inside a graph equals its eager launch and
meets its plain version within 1e-4 of the output's scale."""

import numpy as np
import pytest
import torch

from tests._torch_fixtures import tiny_gguf
from tpullama.gguf import GGMLType

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = "Once upon a time"
KINDS = {
    "dense": dict(qtype=GGMLType.F32),
    "q4k": dict(qtype=GGMLType.Q4_K),
    "moe": dict(qtype=GGMLType.Q4_K, n_expert=4, n_expert_used=2),
}


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    # the files of tests/test_torch_model.py's ggufs and moe_gguf
    return {kind: tiny_gguf(tmp_path_factory, n_embd=256, n_ff=256, n_layer=2, seed=21, **kw)
            for kind, kw in KINDS.items()}


def _load_kw(kind):
    return {} if kind == "dense" else dict(packed=True)


def _pair(path, kind, n_ctx=96, n_seqs=1):
    """A JAX and a port Context over the same file (f32 scale planes on
    both sides), and the prompt's tokens."""
    from tpullama.models import load_model as j_load
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.models import load_model as t_load
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    kw = _load_kw(kind)
    jm = j_load(path, **kw, **({"packed_scale_dtype": np.float32} if kw else {}))
    tm = t_load(path, device="cpu", **kw, **({"packed_scale_dtype": torch.float32} if kw else {}))
    toks = tm.vocab.tokenize(PROMPT, add_special=True)
    return JC(jm, JCP(n_ctx=n_ctx, n_seqs=n_seqs)), TC(tm, TCP(n_ctx=n_ctx, n_seqs=n_seqs)), toks


def _same_cache(jc, tc):
    np.testing.assert_array_equal(tc.n_past, jc.n_past)
    np.testing.assert_array_equal(tc._pos_host, jc._pos_host)
    np.testing.assert_array_equal(tc.kv_pos.numpy(), np.asarray(jc.kv_pos))


@pytest.mark.parametrize("burst", [8, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_generate_burst_is_the_reference_greedy(ggufs, kind, burst):
    """generate(burst=) gives the reference's greedy ids and cache, and the
    ids of the port's own one-step loop."""
    jc, tc, toks = _pair(ggufs[kind], kind)
    out_j = jc.generate(toks, n_predict=20, burst=burst)
    out_t = tc.generate(toks, n_predict=20, burst=burst)
    assert out_t == out_j and len(out_t) == 20
    _same_cache(jc, tc)
    _, loop, _ = _pair(ggufs[kind], kind)
    assert loop.generate(toks, n_predict=20) == out_t


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_burst_is_the_reference(ggufs, kind):
    """decode_burst after a prefill: the reference's ids, n_past, _pos_host
    and kv_pos; a decode step after it gives the reference's logits."""
    jc, tc, toks = _pair(ggufs[kind], kind)
    lj = jc.decode(np.asarray(toks), n_logits=1)[-1]
    tc.decode(np.asarray(toks), n_logits=1)
    first = int(np.argmax(lj))
    out_j = jc.decode_burst(first, 10)
    out_t = tc.decode_burst(first, 10)
    np.testing.assert_array_equal(out_t, out_j)
    assert out_t.dtype == np.int32 and out_t.shape == (10,)
    _same_cache(jc, tc)
    nxt = np.asarray([int(out_j[-1])], np.int32)
    np.testing.assert_allclose(tc.decode(nxt), jc.decode(nxt), **LOGIT_TOL)


def test_decode_burst_past_the_ring(ggufs):
    """A burst longer than the step's id ring (RING steps) reads the ring
    each time it fills: the reference's 70 ids."""
    from tpullama_torch.runtime.context import RING

    jc, tc, toks = _pair(ggufs["dense"], "dense", n_ctx=128)
    n = RING + 6
    first = int(np.argmax(jc.decode(np.asarray(toks))[-1]))
    tc.decode(np.asarray(toks))
    np.testing.assert_array_equal(tc.decode_burst(first, n), jc.decode_burst(first, n))
    _same_cache(jc, tc)


@pytest.mark.parametrize("kind", ["q4k", "moe"])
def test_eog_mid_chunk_rolls_back_as_the_reference(ggufs, kind):
    """A token of the greedy run made an EOG: generate(burst=8) stops at it
    mid-chunk and rolls the cache back to it, as the reference does."""
    jc, tc, toks = _pair(ggufs[kind], kind)
    greedy = jc.generate(toks, n_predict=20)
    at = next(i for i in range(3, 8) if greedy[i] not in greedy[:i])
    eog = greedy[at]
    jc, tc, toks = _pair(ggufs[kind], kind)
    for c in (jc, tc):
        orig = c.model.vocab.is_eog
        c.model.vocab.is_eog = lambda t, orig=orig: t == eog or orig(t)
    out_j = jc.generate(toks, n_predict=20, burst=8)
    out_t = tc.generate(toks, n_predict=20, burst=8)
    assert out_t == out_j == greedy[:at + 1]
    _same_cache(jc, tc)
    assert int(tc.n_past[0]) == len(toks) + at


def test_sampled_generate_reruns_and_cold_is_greedy(ggufs):
    """The reference's test_sampled_burst_deterministic_and_near_greedy on
    the port: a temp 0.9, seed 7 chain gives 16 ids, the same on a rerun;
    temperature 1e-4 with top-k 1 gives the greedy ids."""
    from tpullama_torch.runtime.sampling import SamplerChain

    def gen(sampler):
        _, tc, toks = _pair(ggufs["q4k"], "q4k")
        return tc.generate(toks, n_predict=16, sampler=sampler, burst=8)

    greedy = gen(None)
    assert gen(SamplerChain.std(temp=1e-4, top_k=1)) == greedy
    a = gen(SamplerChain.std(temp=0.9, seed=7))
    assert a == gen(SamplerChain.std(temp=0.9, seed=7)) and len(a) == 16


def test_sampled_decode_burst_generator(ggufs):
    """A sampled decode_burst draws from the generator it is given and moves
    it on; without one, from the spec's seed: reruns from the same state
    give the same ids, and the generator's next burst others."""
    from tpullama_torch.runtime.sampling import DeviceSamplerSpec

    _, tc, toks = _pair(ggufs["q4k"], "q4k")
    first = int(np.argmax(tc.decode(np.asarray(toks))[-1]))
    n0 = int(tc.n_past[0])
    spec = DeviceSamplerSpec(1.5, 0, 1.0, 0.0, 5)

    def burst(**kw):
        tc.rollback_to(n0)
        return tc.decode_burst(first, 12, sampler_spec=spec, **kw).tolist()

    g = torch.Generator().manual_seed(123)
    a = burst(generator=g)
    b = burst(generator=g)  # g moved on
    assert burst(generator=torch.Generator().manual_seed(123)) == a
    assert a != b
    assert burst() == burst() == burst(generator=torch.Generator().manual_seed(5))


def test_decode_burst_refusals(ggufs):
    """The reference's ValueErrors: more than one sequence, a burst past
    n_ctx."""
    jc, tc, _ = _pair(ggufs["dense"], "dense", n_seqs=2)
    for c in (jc, tc):
        with pytest.raises(ValueError, match="single-sequence"):
            c.decode_burst(1, 4)
    jc, tc, toks = _pair(ggufs["dense"], "dense", n_ctx=32)
    for c in (jc, tc):
        c.decode(np.asarray(toks))
        with pytest.raises(ValueError, match="context overflow"):
            c.decode_burst(1, 32 - len(toks))


def test_one_program_per_lane_range(ggufs):
    """decode at T == 1, decode_batch and decode_burst on a one-lane
    Context share one greedy step program; a sampled burst has its own; on
    the CPU none is captured."""
    from tpullama_torch.runtime.sampling import DeviceSamplerSpec

    _, tc, toks = _pair(ggufs["q4k"], "q4k")
    tc.decode(np.asarray(toks))
    tc.decode(np.asarray([5]))
    tc.decode_batch(np.asarray([6]), np.asarray([True]))
    tc.decode_burst(7, 3)
    assert list(tc._programs) == [(0, 1, None)]
    tc.decode_burst(7, 3, sampler_spec=DeviceSamplerSpec(0.9, 0, 1.0, 0.0, 4))
    assert list(tc._programs)[1] == (0, 1, DeviceSamplerSpec(0.9, 0, 1.0, 0.0, 0))
    assert all(p.graph is None for p in tc._programs.values())


def test_add_launch_counts():
    from tpullama_torch.ops.cuda import add_launch_counts, launch_counts

    before = launch_counts()
    add_launch_counts({"qmm_gemv": 5, "fused_postattn": 2})
    add_launch_counts({"qmm_gemv": 3}, -1)
    after = launch_counts()
    assert after["qmm_gemv"] == before["qmm_gemv"] + 2
    assert after["fused_postattn"] == before["fused_postattn"] + 2
    add_launch_counts({"qmm_gemv": 2, "fused_postattn": 2}, -1)
    assert launch_counts() == before


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs of the decode step need a CUDA card")
    return torch.device("cuda")


def _card_pair(path, kind, n_seqs, n_ctx=128, kv_dtype=None):
    """Two port Contexts over one model on the card: one replays its step
    programs' graphs, the other runs the private eager step."""
    from tpullama_torch.models import load_model
    from tpullama_torch.runtime import Context, ContextParams

    class Eager(Context):
        def _run(self, prog):
            return self._step(prog)

    m = load_model(path, device="cuda", **_load_kw(kind))
    cp = ContextParams(n_ctx=n_ctx, n_seqs=n_seqs, kv_dtype=kv_dtype)
    return Context(m, cp), Eager(m, cp), m.vocab.tokenize(PROMPT, add_special=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_replayed_steps_equal_the_eager_step(cuda, ggufs, kind):
    """decode_batch with an inactive lane, then a greedy burst, then on one
    lane decode_burst: a replay gives the eager step's logits and ids bit
    for bit, with the same bookkeeping."""
    g, e, toks = _card_pair(ggufs[kind], kind, n_seqs=3)
    chunks = [(0, toks), (2, toks[:3] + [70, 71, 72])]
    mg, me = g.decode_multi(chunks), e.decode_multi(chunks)
    tok = np.asarray([int(np.argmax(mg[0])), 0, int(np.argmax(mg[2]))], np.int32)
    active = np.asarray([True, False, True])
    for _ in range(4):
        lg, le = g.decode_batch(tok, active), e.decode_batch(tok, active)
        np.testing.assert_array_equal(lg[active], le[active])
        tok = np.argmax(lg, axis=-1).astype(np.int32)
    np.testing.assert_array_equal(g.decode_batch_burst(tok, active, 6),
                                  e.decode_batch_burst(tok, active, 6))
    for a, b in ((g.n_past, e.n_past), (g._pos_host, e._pos_host)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(g.kv_pos, e.kv_pos)
    assert g._programs[(0, 3, None)].graph is not None
    g, e, toks = _card_pair(ggufs[kind], kind, n_seqs=1)
    first = [int(np.argmax(c.decode(np.asarray(toks))[-1])) for c in (g, e)]
    assert first[0] == first[1]
    np.testing.assert_array_equal(g.decode_burst(first[0], 16), e.decode_burst(first[0], 16))
    np.testing.assert_array_equal(g._pos_host, e._pos_host)


@pytest.mark.cuda
def test_int8_cache_replays_equal_the_eager_step(cuda, ggufs):
    """An int8 cache on the card: decode_batch steps, a greedy burst and a
    seq_add between two replays give the eager step's logits and ids bit
    for bit (the scales are allocated with the cache, so the graphs read
    them in place), and one step launches the int8 flash_decode_batched
    once per layer."""
    g, e, toks = _card_pair(ggufs["q4k"], "q4k", n_seqs=2, kv_dtype=torch.int8)
    chunks = [(0, toks), (1, toks[:3] + [70, 71])]
    mg, me = g.decode_multi(chunks), e.decode_multi(chunks)
    np.testing.assert_array_equal(mg[0], me[0])
    tok = np.asarray([int(np.argmax(mg[s])) for s in (0, 1)], np.int32)
    active = np.ones(2, bool)
    for i in range(4):
        if i == 2:
            for c in (g, e):
                c.seq_add(1, 1 << 20, 2, seq_id=0)
        lg, le = g.decode_batch(tok, active), e.decode_batch(tok, active)
        np.testing.assert_array_equal(lg, le)
        tok = np.argmax(lg, axis=-1).astype(np.int32)
    np.testing.assert_array_equal(g.decode_batch_burst(tok, active, 6),
                                  e.decode_batch_burst(tok, active, 6))
    # every cell but the scratch cell S - 1, which the graph's warm-up step
    # (every lane inactive) writes and the eager Context never does
    S = g._S
    for a, b in zip(g.kv_k + g.kv_v, e.kv_k + e.kv_v):
        cells = (slice(None),) * 3 + (slice(0, S - 1),)
        assert torch.equal(a[cells], b[cells])
    assert g._programs[(0, 2, None)].launches["flash_decode_batched_int8"] == g.hp.n_layer


@pytest.mark.cuda
def test_replay_adds_the_captured_launches(cuda, ggufs):
    """Capture takes its launches out of the counters and each replay adds
    them back: one decode_batch step counts each layer's kernels once."""
    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts

    g, _, toks = _card_pair(ggufs["q4k"], "q4k", n_seqs=2)
    g.decode_multi([(0, toks), (1, toks)])
    tok, active = np.asarray([5, 6], np.int32), np.ones(2, bool)
    g.decode_batch(tok, active)  # captures (and runs the warm-up step)
    prog = g._programs[(0, 2, None)]
    n_layer = g.hp.n_layer
    assert prog.launches["flash_decode_batched"] == n_layer
    assert prog.launches["qmm_gemv"] >= 7 * n_layer
    reset_launch_counts()
    g.decode_batch(tok, active)
    g.decode_batch(tok, active)
    counts = launch_counts()
    assert {k: v for k, v in counts.items() if v} == {k: 2 * v for k, v in prog.launches.items()}


@pytest.mark.cuda
def test_sampled_burst_on_the_card(cuda, ggufs):
    """The sampled step's graph draws anew at each replay: a rerun from the
    same seed gives the same ids, another seed others; temperature 1e-4
    with top-k 1 gives the greedy ids."""
    from tpullama_torch.runtime.sampling import SamplerChain

    g, _, toks = _card_pair(ggufs["q4k"], "q4k", n_seqs=1)

    def gen(sampler):
        g.reset()
        return g.generate(toks, n_predict=24, sampler=sampler, burst=8)

    greedy = gen(None)
    assert gen(SamplerChain.std(temp=1e-4, top_k=1)) == greedy
    a = gen(SamplerChain.std(temp=1.5, top_k=0, top_p=1.0, min_p=0.0, seed=7))
    assert a == gen(SamplerChain.std(temp=1.5, top_k=0, top_p=1.0, min_p=0.0, seed=7))
    assert a != gen(SamplerChain.std(temp=1.5, top_k=0, top_p=1.0, min_p=0.0, seed=8))
    assert len(set(a)) > 4


@pytest.mark.cuda
def test_cooperative_fused_postattn_in_a_graph(cuda):
    """fused_postattn's cooperative launch, captured in a CUDA graph: each
    replay on new inputs in the captured buffers equals the eager launch
    and meets the plain version within 1e-4 of the output's scale."""
    from tpullama_torch.ops.cuda import fused_layer as tf

    E, Fd, G = 512, 384, 32
    rng = np.random.default_rng(0)

    def planes(n_out, n_in):
        s = (4.4e-3 * rng.uniform(0.8, 1.2, (n_out, n_in // G))).astype(np.float32)
        return {"q4": torch.from_numpy(rng.integers(0, 256, (n_out, n_in // 2), dtype=np.uint8)
                                       ).to(cuda),
                "scale": torch.from_numpy(s).to(cuda),
                "minv": torch.from_numpy(7.5 * s).to(cuda)}

    o, gu = planes(E, E), planes(2 * Fd, E)
    norm_w = torch.from_numpy((1 + 0.1 * rng.standard_normal(E)).astype(np.float32)).to(cuda)
    att = torch.zeros((1, E), device=cuda)
    x = torch.zeros((1, E), device=cuda)
    tf.fused_postattn(att, x, o, norm_w, gu, group=G, eps=1e-5)  # warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        act, r1 = tf.fused_postattn(att, x, o, norm_w, gu, group=G, eps=1e-5)
    for _ in range(3):
        att.copy_(torch.from_numpy(rng.standard_normal((1, E)).astype(np.float32)))
        x.copy_(torch.from_numpy(rng.standard_normal((1, E)).astype(np.float32)))
        graph.replay()
        want_act, want_r1 = tf.fused_postattn(att, x, o, norm_w, gu, group=G, eps=1e-5)
        plain_act, plain_r1 = tf.fused_postattn_plain(att, x, o, norm_w, gu, group=G, eps=1e-5)
        assert torch.equal(act, want_act) and torch.equal(r1, want_r1)
        for got, want in ((act, plain_act), (r1, plain_r1)):
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


class _HostReads:
    """A dispatch mode that records the ops which read a tensor's value on
    the host (aten._local_scalar_dense: .item(), int(), a 0-dim index) or
    make a tensor from host data (aten.lift_fresh: torch.tensor, a Python
    value assigned into a tensor). On a CUDA device either breaks CUDA
    graph capture; on the CPU both show up here."""

    OPS = ("aten._local_scalar_dense", "aten.lift_fresh")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if str(func.overloadpacket) in _HostReads.OPS:
                    seen.append(str(func.overloadpacket))
                return func(*args, **(kwargs or {}))

        self.mode = Mode()


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kind", ["dense", "q4k"])
def test_step_reads_nothing_on_the_host(ggufs, kind, sampled):
    """The step a CUDA graph captures (Context._step, device_sample
    included) neither reads a tensor value on the host nor makes a tensor
    from host data. The MoE fixture is left out: the CPU's plain gathered
    product groups tiles by expert on the host, which the card's kernel
    never does."""
    from tpullama_torch.runtime.sampling import DeviceSamplerSpec

    _, tc, toks = _pair(ggufs[kind], kind)
    tc.decode(np.asarray(toks))
    spec = DeviceSamplerSpec(0.9, 40, 0.95, 0.05, 1) if sampled else None
    prog = tc._program(0, 1, spec)
    if sampled:
        prog.gen.manual_seed(1)
    prog.fill([5], tc.n_past, [1])
    reads = _HostReads()
    with reads.mode:
        tc._step(prog)
    assert reads.seen == []
