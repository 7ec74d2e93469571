"""llama4 held against the JAX package on the CPU.

Two fixtures: the JAX oracle's (tests/test_e2e_oracle.py:445-455;
make_tiny_llama_gguf(arch="llama4", n_layer=4, n_expert=4, n_head_kv=2,
seed=57), F32), which interleaves MoE every 2nd layer, so both packages
load it as a heterogeneous per-layer list (Llama-4-Maverick's layout);
and Llama-4-Scout's layout, small: every layer MoE (interleave step 1),
written here with the JAX package's gguf writer (make_tiny_llama_gguf
always writes step 2) at n_embd 256 with 8 Q4_K experts of FFN 256, one a
token, and a Q4_K shared expert, so the expert trio packs in both loaders.
Both files carry llama4's defaults: chunked windows of 8192 on three
layers of four, the fourth a NoPE layer with the Q temperature
(floor_scale 8192, scale 0.1), the weightless q/k norm after rope on the
rope layers, sigmoid routing ranked by the raw logits with the weights
scaling the experts' inputs, and an ungated shared expert.

Cases: the loaded hparams and trees; prefill logits and 16 greedy tokens;
moe_ffn with select_logits and weight_before_ffn on its three routes
(dense per pair, dense sorted by expert, packed one-row and dispatched
tiles through the gathered product's plain version); the chunk and the
temperature at a small size (n_swa 32 and attn_temp_floor_scale 16 set on
both packages' loaded HParams: a 120-token prompt at n_ctx 256 and
n_ubatch 16 wraps the ring's 49 cells and passes three chunk starts, then
greedy tokens pass a fourth) and the mask pair of that size; a context
shift that leaves the NoPE layers' K rows as they were, where the JAX
package rotates them (ROADMAP.md Queue 3 item 12). On the card (`cuda`):
the Scout layout with the n_swa override, card against CPU through the
wrapped ring. And a Scout-layout file of three chunked layers with
rope_freqs of 4.0, whose chunked layers the port rotates with them and
the JAX package without (Queue 3 item 13).
tests/test_torch_llama4_b.py holds the ServerEngine, CLI and state
cases, and smollm3, hunyuan-dense and hunyuan-moe.

Tolerances: logits within 1e-4 of their largest magnitude plus 1e-5 (f32
sums in another order); moe_ffn within rtol = atol = 1e-5 (one layer of
f32 products); cache rows within 1e-5 of their largest magnitude; token
ids, positions, text and trees exactly. On the card: logits within 1e-3
of their largest magnitude plus 1e-4 (f32 in the kernels' order)."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures
from tests.test_torch_gemma import assert_logits_close, same_cells
from tests.test_torch_model import _assert_same_tree, _jax_load, _jax_numpy, _port_load, _to_numpy
from tpullama.gguf import GGMLType, GGUFWriter
from tpullama.models.testing import byte_vocab

ORACLE = dict(arch="llama4", n_layer=4, n_expert=4, n_head_kv=2, seed=57)
SCOUT = dict(n_layer=4, step=1, n_expert=8, n_expert_used=1, seed=59)
PACKED = dict(packed=True, packed_scale_dtype=np.float32)
N_UBATCH = 16
SMALL_CHUNK = dict(n_swa=32, attn_temp_floor_scale=16)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
HUGE = (1 << 30) - 1  # seq_add's upper bound for "to the end"


def write_llama4(path, *, n_layer=4, step=1, n_embd=256, n_ff=256, n_head=4, n_head_kv=2,
                 n_expert=8, n_expert_used=1, qtype=GGMLType.Q4_K, seed=59, rope_freqs=None):
    """A tiny llama4 GGUF in make_tiny_llama_gguf's conventions (byte vocab,
    F32 norms and router, `qtype` matrices) with MoE every `step`th layer
    ((il + 1) % step == 0), each with a shared expert of FFN n_ff, and
    `rope_freqs` (a float: every divisor that value) where given."""
    tokens, scores, types = byte_vocab()
    n_vocab = len(tokens)
    rng = np.random.default_rng(seed)
    head_dim = n_embd // n_head
    a = "llama4"
    w = GGUFWriter()
    w.add_str("general.architecture", a)
    w.add_str("general.name", "tiny-test-llama4")
    for key, v in (("context_length", 256), ("embedding_length", n_embd),
                   ("block_count", n_layer), ("feed_forward_length", n_ff),
                   ("attention.head_count", n_head), ("attention.head_count_kv", n_head_kv),
                   ("rope.dimension_count", head_dim), ("vocab_size", n_vocab),
                   ("expert_count", n_expert), ("expert_used_count", n_expert_used),
                   ("interleave_moe_layer_step", step), ("expert_feed_forward_length", n_ff)):
        w.add_u32(f"{a}.{key}", v)
    w.add_f32(f"{a}.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_f32(f"{a}.rope.freq_base", 10000.0)
    w.add_str("tokenizer.ggml.model", "llama")
    w.add_array("tokenizer.ggml.tokens", tokens)
    w.add_array("tokenizer.ggml.scores", np.asarray(scores, np.float32))
    w.add_array("tokenizer.ggml.token_type", np.asarray(types, np.int32))
    w.add_u32("tokenizer.ggml.bos_token_id", 1)
    w.add_u32("tokenizer.ggml.eos_token_id", 2)
    w.add_u32("tokenizer.ggml.unknown_token_id", 0)
    w.add_bool("tokenizer.ggml.add_bos_token", True)
    w.add_bool("tokenizer.ggml.add_eos_token", False)

    def mat(*shape, scale=None):
        s = 1.0 / np.sqrt(shape[-1]) if scale is None else scale
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    w.add_tensor("token_embd.weight", mat(n_vocab, n_embd, scale=0.02), qtype)
    w.add_tensor("output_norm.weight", norm(n_embd), GGMLType.F32)
    w.add_tensor("output.weight", mat(n_vocab, n_embd), qtype)
    if rope_freqs is not None:
        w.add_tensor("rope_freqs.weight", np.full(head_dim // 2, rope_freqs, np.float32),
                     GGMLType.F32)
    kv = head_dim * n_head_kv
    for il in range(n_layer):
        p = f"blk.{il}."
        w.add_tensor(p + "attn_norm.weight", norm(n_embd), GGMLType.F32)
        for name, rows in (("attn_q", n_embd), ("attn_k", kv), ("attn_v", kv)):
            w.add_tensor(p + name + ".weight", mat(rows, n_embd), qtype)
        w.add_tensor(p + "attn_output.weight", mat(n_embd, n_embd), qtype)
        w.add_tensor(p + "ffn_norm.weight", norm(n_embd), GGMLType.F32)
        if (il + 1) % step == 0:
            w.add_tensor(p + "ffn_gate_inp.weight", mat(n_expert, n_embd), GGMLType.F32)
            w.add_tensor(p + "ffn_gate_exps.weight", mat(n_expert, n_ff, n_embd), qtype)
            w.add_tensor(p + "ffn_up_exps.weight", mat(n_expert, n_ff, n_embd), qtype)
            w.add_tensor(p + "ffn_down_exps.weight", mat(n_expert, n_embd, n_ff), qtype)
            sfx = "_shexp"
        else:
            sfx = ""
        w.add_tensor(p + f"ffn_gate{sfx}.weight", mat(n_ff, n_embd), qtype)
        w.add_tensor(p + f"ffn_up{sfx}.weight", mat(n_ff, n_embd), qtype)
        w.add_tensor(p + f"ffn_down{sfx}.weight", mat(n_embd, n_ff), qtype)
    w.write(path)
    return path


def scout_gguf(tmp_path_factory, **kw) -> str:
    """The Scout-layout file for `kw`, written once per test run."""
    spec = {**SCOUT, **kw}
    return _torch_fixtures.cached_file(tmp_path_factory, "write_llama4", spec,
                                       lambda p: write_llama4(p, **spec))


def load_pair(path, packed: bool):
    kw = PACKED if packed else {}
    tkw = {**kw, "packed_scale_dtype": torch.float32} if packed else {}
    return {"jax": _jax_load(path, **kw), "torch": _port_load(path, **tkw), "path": path}


def load_models(tmp_path_factory) -> dict:
    """The oracle's fixture (dense F32) and the Scout layout (packed), each
    loaded by both packages."""
    return {"oracle": load_pair(_torch_fixtures.tiny_gguf(tmp_path_factory, **ORACLE), False),
            "scout": load_pair(scout_gguf(tmp_path_factory), True)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return load_models(tmp_path_factory)


KINDS = ("oracle", "scout")


def context(pair, pkg, n_ctx=128):
    if pkg == "jax":
        from tpullama.runtime import Context, ContextParams
    else:
        from tpullama_torch.runtime import Context, ContextParams
    return Context(pair[pkg], ContextParams(n_ctx=n_ctx, n_ubatch=N_UBATCH))


def contexts(pair, n_ctx=128):
    return context(pair, "jax", n_ctx), context(pair, "torch", n_ctx)


def prompt(n, seed=0):
    return np.random.default_rng(seed).integers(3, 259, size=n).astype(np.int32)


class small_chunk:
    """n_swa 32 and attn_temp_floor_scale 16 on both packages' loaded
    HParams while the block runs."""

    def __init__(self, pair):
        self.hps = [pair["jax"].hparams, pair["torch"].hparams]

    def __enter__(self):
        self.saved = [{k: getattr(hp, k) for k in SMALL_CHUNK} for hp in self.hps]
        for hp in self.hps:
            for k, v in SMALL_CHUNK.items():
                setattr(hp, k, v)

    def __exit__(self, *exc):
        for hp, saved in zip(self.hps, self.saved):
            for k, v in saved.items():
                setattr(hp, k, v)


@pytest.mark.parametrize("kind", KINDS)
def test_load_matches_jax(models, kind):
    """The JAX package's hparams (the chunked window and its pattern, the
    NoPE layers and temperature, the weightless q/k norm, the routing
    flags) and tree; the oracle's step 2 as a per-layer list, Scout's step
    1 stacked with the experts packed. The JAX params carried across
    (params_from_numpy) equal the port's own load."""
    import jax

    from tpullama_torch.models import params_from_numpy

    j, t = models[kind]["jax"], models[kind]["torch"]
    assert vars(t.hparams) == {k: getattr(j.hparams, k) for k in vars(t.hparams)}
    hp = t.hparams
    assert (hp.swa_type, hp.n_swa, hp.swa_layers, hp.nope_layers) == (
        "chunked", 8192, (True, True, True, False), (False, False, False, True))
    assert (hp.attn_temp_scale, hp.attn_temp_floor_scale, hp.qk_norm_weightless,
            hp.moe_select_logits, hp.moe_weight_before_ffn, hp.expert_gating_func,
            hp.moe_norm_topk, hp.rope_type) == (0.1, 8192, True, True, True, 2, False, 0)
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    if kind == "oracle":
        assert hp.n_moe_layer_step == 2 and hp.has_heterogeneous_layers
        assert ["ffn_gate_inp" in w for w in t.params["layer_list"]] == [False, True] * 2
    else:
        assert hp.n_moe_layer_step == 1 and not hp.has_heterogeneous_layers
        assert {"ffn_gateup_exps", "ffn_down_exps", "ffn_gate_shexp"} <= set(
            t.quant_meta["layers"])
    carried = params_from_numpy(jax.tree.map(np.asarray, j.params), j.quant_meta, j.hparams,
                                device="cpu")
    _assert_same_tree(_to_numpy(carried.params), _to_numpy(t.params))


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_and_greedy_match_jax(models, kind):
    """A 40-token prompt's logits (in n_ubatch chunks), then 16 greedy
    tokens from fresh Contexts, and the cells after them."""
    pair = models[kind]
    toks = prompt(40)
    jc, tc = contexts(pair)
    assert_logits_close(tc.decode(toks, n_logits=40), jc.decode(toks, n_logits=40))
    jc, tc = contexts(pair)
    assert tc.generate(list(toks), n_predict=16) == jc.generate(list(toks), n_predict=16)
    same_cells(tc, jc)


def _experts(rng, E, F, D):
    return dict(gate_inp=rng.standard_normal((E, D)).astype(np.float32) * 0.3,
                gate_exps=rng.standard_normal((E, F, D)).astype(np.float32) / 4,
                up_exps=rng.standard_normal((E, F, D)).astype(np.float32) / 4,
                down_exps=rng.standard_normal((E, D, F)).astype(np.float32) / 10)


FLAGS = [dict(select_logits=True), dict(weight_before_ffn=True),
         dict(select_logits=True, weight_before_ffn=True)]
FLAG_IDS = ["select_logits", "weight_before_ffn", "both"]


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("route", ["pair", "sorted"])
def test_dense_expert_routes_with_llama4_flags_match_jax(route, flags):
    """llama4's routing (sigmoid, weights not renormalized) with each flag
    and both, on dense stacks: per pair (each token alone, T == 1) and
    sorted by expert (the tokens together), 12 tokens of 2 sequences, 8
    experts, 2 a token. weight_before_ffn moves the result (SwiGLU is not
    linear in its input)."""
    import jax.numpy as jnp

    from tpullama.ops.moe import moe_ffn as j_moe
    from tpullama_torch.ops.moe import moe_ffn as t_moe

    rng = np.random.default_rng(13)
    B, T, D, F, E, K = 2, 6, 64, 96, 8, 2
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = _experts(rng, E, F, D)
    kw = dict(n_expert_used=K, gating=2, norm_w=False, **flags)
    want = np.asarray(j_moe(jnp.asarray(x), *(jnp.asarray(v) for v in w.values()), **kw))
    tx = torch.from_numpy(x) if route == "sorted" else torch.from_numpy(x).reshape(B * T, 1, D)
    tw = [torch.from_numpy(v) for v in w.values()]
    got = t_moe(tx, *tw, **kw)
    np.testing.assert_allclose(got.reshape(B, T, D).numpy(), want, **MOE_TOL)
    if flags.get("weight_before_ffn"):
        after = t_moe(tx, *tw, **{**kw, "weight_before_ffn": False})
        assert float((after - got).abs().max()) > 1e-3


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("T", [1, 80], ids=["one_row_tiles", "dispatched"])
def test_packed_expert_route_with_llama4_flags_matches_jax(models, T, flags):
    """Layer 0 of the Scout layout: its packed Q4_K [gate | up] and down
    experts and its router through both packages' moe_ffn, 8 experts, 1 a
    token: at T = 1 one-row tiles, at T = 80 slots dispatched into 8-row
    tiles."""
    import jax.numpy as jnp

    from tpullama.ops.moe import moe_ffn as j_moe
    from tpullama_torch.ops.moe import moe_ffn as t_moe

    j, t = models["scout"]["jax"], models["scout"]["torch"]
    jl, tl = j.params["layers"], t.params["layers"]
    jm, tm = j.quant_meta["layers"], t.quant_meta["layers"]
    E = t.hparams.n_expert
    x = np.random.default_rng(6).standard_normal((1, T, 256)).astype(np.float32)
    kw = dict(n_expert_used=1, gating=2, norm_w=False, **flags)
    want = np.asarray(j_moe(
        jnp.asarray(x), jl["ffn_gate_inp"][0], None, (jl["ffn_gateup_exps"], 0),
        (jl["ffn_down_exps"], 0),
        quant_meta_exps={"gateup": jm["ffn_gateup_exps"], "down": jm["ffn_down_exps"]}, **kw))
    got = t_moe(torch.from_numpy(x), tl["ffn_gate_inp"][0], None,
                {k: v[:E] for k, v in tl["ffn_gateup_exps"].items()},
                {k: v[:E] for k, v in tl["ffn_down_exps"].items()},
                quant_meta_exps={"gateup": tm["ffn_gateup_exps"], "down": tm["ffn_down_exps"]},
                **kw)
    np.testing.assert_allclose(got.numpy(), want, **MOE_TOL)


def test_select_logits_ranks_the_raw_logits():
    """With a selection bias, select_logits ranks the raw logits where the
    plain router ranks the biased probabilities; the weights are the
    sigmoid of the selected logits either way."""
    from tpullama_torch.ops.moe import route

    x = torch.ones(1, 1, 1)
    gate_inp = torch.tensor([[2.0], [1.0], [0.0]])
    bias = torch.tensor([0.0, 0.0, 5.0])
    sel_b, _ = route(x, gate_inp, 1, gating=2, norm_w=False, exp_probs_b=bias)
    sel_l, w_l = route(x, gate_inp, 1, gating=2, norm_w=False, exp_probs_b=bias,
                       select_logits=True)
    assert (int(sel_b), int(sel_l)) == (2, 0)
    assert float(w_l) == pytest.approx(1.0 / (1.0 + np.exp(-2.0)))


def _q_temp(pos, floor_scale):
    return np.log(np.floor((pos + 1.0) / floor_scale) + 1.0) * 0.1 + 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_and_temperature_match_jax(models, kind):
    """n_swa 32 and floor_scale 16 on both packages: a 120-token prompt at
    n_ctx 256 in 16-token chunks (the ring of 32 + 16 + 1 = 49 cells wraps
    twice; chunk starts 32, 64 and 96; the temperature steps every 16
    positions), the last 40 logits, 16 greedy tokens past the chunk start
    at 128, and both stacks' positions and K/V rows."""
    pair = models[kind]
    toks = prompt(120, seed=1)
    with small_chunk(pair):
        jc, tc = contexts(pair, n_ctx=256)
        assert tc._S_swa == jc._S_swa == 49 and isinstance(tc.kv_k, dict)
        assert_logits_close(tc.decode(toks, n_logits=40), jc.decode(toks, n_logits=40))
        jc, tc = contexts(pair, n_ctx=256)
        assert tc.generate(list(toks), n_predict=16) == jc.generate(list(toks), n_predict=16)
        same_cells(tc, jc)
        for cache in ("kv_k", "kv_v"):
            for stack in ("full", "swa"):
                want = np.asarray(getattr(jc, cache)[stack])
                got = getattr(tc, cache)[stack].numpy()
                assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (cache, stack)
    # the temperature's steps at floor_scale 16: 1 up to position 14
    assert _q_temp(np.asarray([14, 15, 31]), 16).tolist() == pytest.approx(
        [1.0, 1.0 + 0.1 * np.log(2.0), 1.0 + 0.1 * np.log(3.0)])


def test_chunked_mask_is_the_chunk_rule(models):
    """The mask pair of the last forward of a 70-token prompt at n_swa 32
    on the two stacks (n_ctx 128: the ring's 49 cells beside the full
    stack's 256): the chunked layers' mask shows a query at position p the
    ring's cells of positions (p // 32) * 32 up to p, the full layers' the
    full stack's cells of positions 0 up to p."""
    pair = models["oracle"]
    seen = {}
    with small_chunk(pair):
        tc = context(pair, "torch")
        forward = tc.net.forward

        def spy(*args, **kw):
            seen["positions"], seen["mask"] = args[1], args[5]
            return forward(*args, **kw)

        tc.net.forward = spy
        tc.decode(prompt(70, seed=2))
    full, chunked = (m[0, 0].numpy() > -1e29 for m in seen["mask"])
    rows = [(i, p) for i, p in enumerate(seen["positions"][0].tolist()) if p >= 0]
    assert [p for _, p in rows] == list(range(64, 70))
    for i, p in rows:
        assert sorted(tc.kv_pos["full"][0].numpy()[full[i]]) == list(range(p + 1))
        assert sorted(tc.kv_pos["swa"][0].numpy()[chunked[i]]) == list(range(64, p + 1))


def test_shift_keeps_the_nope_layers(models):
    """A context shift (seq_rm of 4 tokens, seq_add of the rest by -4) on
    the two stacks at n_swa 32: the full stack holds the NoPE layer alone,
    whose K rows stay as they were, bit for bit; the ring's rows re-rotate
    as the JAX package rotates them. The JAX package rotates the NoPE
    layer's rows too (ROADMAP.md Queue 3 item 12), which moves them."""
    pair = models["oracle"]
    toks = prompt(40, seed=9)
    with small_chunk(pair):
        jc, tc = contexts(pair, n_ctx=256)
        jc.decode(toks)
        tc.decode(toks)
        before = {"jax": np.asarray(jc.kv_k["full"]).copy(),
                  "torch": tc.kv_k["full"].clone().numpy()}
        for c in (jc, tc):
            c.seq_rm(0, 4)
            c.seq_add(4, HUGE, -4)
        same_cells(tc, jc)
    assert tc._rope_kinds("full") == [None] and tc._rope_kinds("swa") == ["swa"] * 3
    np.testing.assert_array_equal(tc.kv_k["full"].numpy(), before["torch"])
    assert float(np.abs(np.asarray(jc.kv_k["full"]) - before["jax"]).max()) > 1e-3
    np.testing.assert_allclose(tc.kv_k["swa"].numpy(), np.asarray(jc.kv_k["swa"]),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def freqs_pair(tmp_path_factory):
    return load_pair(scout_gguf(tmp_path_factory, n_layer=3, rope_freqs=4.0), True)


def test_rope_freqs_rotate_the_chunked_layers(freqs_pair):
    """Three chunked layers of the Scout layout with rope_freqs of 4.0 on
    every frequency: the port's chunked layers divide their angles by
    them, so its logits equal the JAX package's with a linear rope scale
    of 1/4 (the same angles, exactly) and no rope_freqs; the JAX package
    builds the SWA layers' table without rope_freqs (ROADMAP.md Queue 3
    item 13), so its own logits on the file are apart from the port's."""
    import copy

    toks = prompt(40, seed=3)
    jc, tc = contexts(freqs_pair)
    lt, lj = tc.decode(toks, n_logits=40), jc.decode(toks, n_logits=40)
    assert float(np.abs(lt - lj).max()) > 1e-2
    scaled = dict(freqs_pair)
    scaled["jax"] = copy.copy(freqs_pair["jax"])
    scaled["jax"].hparams = copy.copy(freqs_pair["jax"].hparams)
    scaled["jax"].hparams.rope_freq_scale = 0.25
    js, _ = contexts(scaled)
    assert_logits_close(lt, js.decode(toks, n_logits=40))
    js, tc = contexts(scaled)
    assert tc.generate(list(toks), n_predict=8) == js.generate(list(toks), n_predict=8)


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the chunked two-stack path on the card needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def card_models(cuda, tmp_path):
    """The Scout layout loaded on the card and on the CPU, written per test
    after `cuda`."""
    from tpullama_torch.models import load_model

    path = write_llama4(str(tmp_path / "scout.gguf"), **{k: v for k, v in SCOUT.items()})
    kw = dict(packed=True, packed_scale_dtype=torch.float32)
    return {"cuda": load_model(path, device="cuda", **kw),
            "cpu": load_model(path, device="cpu", **kw)}


@pytest.mark.cuda
def test_card_chunked_ring_matches_the_cpu(cuda, card_models):
    """The Scout layout with n_swa 32 and floor_scale 16 on both models: a
    120-token prompt at n_ctx 256 in 16-token chunks (the 49-cell ring
    wraps, three chunk starts), card (qmm, the gathered kernels,
    flash_attention over both stacks) against the CPU's plain versions:
    the last 40 logits within 1e-3 of their largest magnitude plus 1e-4;
    then 16 greedy tokens through the replayed one-token steps
    (flash_decode over the ring), identical, with both stacks' positions
    equal."""
    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts
    from tpullama_torch.runtime import Context, ContextParams

    for m in card_models.values():
        for k, v in SMALL_CHUNK.items():
            setattr(m.hparams, k, v)
    cp = ContextParams(n_ctx=256, n_ubatch=N_UBATCH)
    toks = prompt(120, seed=1)
    reset_launch_counts()
    cg, cc = Context(card_models["cuda"], cp), Context(card_models["cpu"], cp)
    assert cg._S_swa == 49 and isinstance(cg.kv_k, dict)
    lg, lc = cg.decode(toks, n_logits=40), cc.decode(toks, n_logits=40)
    assert np.isfinite(lg).all()
    assert np.abs(lg - lc).max() <= 1e-3 * np.abs(lc).max() + 1e-4
    cg, cc = Context(card_models["cuda"], cp), Context(card_models["cpu"], cp)
    assert cg.generate(list(toks), n_predict=16) == cc.generate(list(toks), n_predict=16)
    for stack in ("full", "swa"):
        assert torch.equal(cg.kv_pos[stack].cpu(), cc.kv_pos[stack])
    counts = launch_counts()
    # K = 256: every expert stack is stored transposed (8 scale columns)
    assert all(counts[k] > 0 for k in ("qmm_gemv", "qmm_tiled", "flash_attention",
                                       "flash_decode", "qmm_gathered_t")), counts
