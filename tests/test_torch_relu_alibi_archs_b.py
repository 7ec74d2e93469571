"""The second half of the ALiBi archs (tests/test_torch_relu_alibi_archs.py
holds the first and the fixtures of all nine cases): jais (LayerNorm with
biases, fused biased [Q|K|V], a gated SiLU FFN with biases, the 1/D
attention scale), refact (RMS norms, a gated SiLU FFN) and baichuan at
both of its layouts (7B at 32 layers: a llama with NORM rope; 13B at 40:
ALiBi and no rope), on the JAX oracle's fixtures, with the same cases;
then

- the ALiBi mask: the port's Context builds, cell for cell, the JAX
  Context's mask (-|kv_pos - q_pos| on visible cells, -1e30 elsewhere) for
  a prefill of two lanes (one padded) and a one-token step with a parked
  lane, which sees no cell;
- the slopes: at 6 and 40 heads (no power of two: heads past the largest
  power of two take the second series) the model hands attention the JAX
  package's slopes; bloom at 6 heads against the JAX package;
- bloom under a uniform seq_add: ALiBi reads only the distance, so the
  next logits equal the unshifted Context's, and the JAX package's, whose
  seq_add raises on a model without rope unless its rotation is made the
  identity (ROADMAP.md Queue 3 item 15);
- bloom's decode_multi and decode_batch over 2 lanes against the JAX
  Context; jais through the CLI and a packed bloom through the
  ServerEngine script, against the JAX package's;
- the fused post-attention path stays off for all eight archs.

On the card (`cuda`): nemotron, apertus, mpt and bloom at n_embd 256 with
every layer matrix Q4_K, a card Context against the CPU's (the ALiBi
archs through the kernels' ALiBi branch, counted as
flash_attention_alibi and flash_decode_alibi), and bloom's two lanes
through flash_decode_batched_alibi in the replayed step.

Tolerances: trees exactly; masks exactly; slopes exactly; logits within
rtol = atol = 1e-4 (f32 sums in another order); tokens exactly; card
against CPU within 1e-3 of the CPU logits' largest magnitude plus 1e-4."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_flag_archs import check_greedy, check_load, check_prefill, reference
from tests.test_torch_gemma import check_decode_batch
from tests.test_torch_model import LOGIT_TOL, PROMPT, _check_server_script, _jax_load, _port_load
from tests.test_torch_nongated_archs_b import card_against_cpu, card_file, cuda  # noqa: F401
from tests.test_torch_relu_alibi_archs import (FIXTURES, FIRST, PACKED, arch_of,
                                               check_case_tensors, fixture_file)
from tpullama.models.testing import make_tiny_llama_gguf

SECOND = tuple(c for c in FIXTURES if c not in FIRST)
HUGE = 2**30 - 1


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return {case: reference(fixture_file(tmp_path_factory, case)) for case in SECOND}


@pytest.fixture(scope="module")
def bloom(tmp_path_factory):
    """The bloom oracle fixture, loaded by each package."""
    p = fixture_file(tmp_path_factory, "bloom", "_b")
    return {"jax": _jax_load(p), "torch": _port_load(p), "path": p}


@pytest.mark.parametrize("case", SECOND)
def test_load_matches_jax(refs, case):
    t = check_load(refs[case])
    check_case_tensors(case, t)
    assert t.hparams.n_layer == FIXTURES[case].get("n_layer", 2)


@pytest.mark.parametrize("case", SECOND)
def test_prefill_logits_match_jax(refs, case):
    check_prefill(refs[case], _port_load(refs[case]["path"]))


@pytest.mark.parametrize("case", SECOND)
def test_greedy_tokens_match_jax(refs, case):
    check_greedy(refs[case], _port_load(refs[case]["path"]))


def captured_masks(pair, tokens, positions, slots):
    """Each package's additive mask for one forward of a 2-lane Context
    whose lanes prefilled 12 and 20 tokens: the port's from its model's
    call, the JAX package's from its llama_forward's, both called by
    Context._forward on the same tokens, positions and cells."""
    import jax.numpy as jnp

    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama.runtime import context as j_context
    from tpullama_torch.runtime import Context, ContextParams

    chunks = [(0, np.arange(3, 15, dtype=np.int32)), (1, np.arange(40, 60, dtype=np.int32))]
    jc = JC(pair["jax"], JCP(n_ctx=64, n_seqs=2))
    tc = Context(pair["torch"], ContextParams(n_ctx=64, n_seqs=2))
    jc.decode_multi(chunks)
    tc.decode_multi(chunks)
    got = {}

    class Seen(Exception):
        pass

    def j_forward(params, hp, toks, pos, kv_k, kv_v, slots_, mask, **kw):
        got["jax"] = np.asarray(mask)
        raise Seen

    def t_forward(toks, pos, kv_k, kv_v, slots_, mask, **kw):
        got["torch"] = mask.numpy()
        raise Seen

    orig = j_context.llama_forward
    j_context.llama_forward = j_forward
    tc.net.forward = t_forward
    try:
        with pytest.raises(Seen):
            jc._forward(jc.model.params, jc.kv_k, jc.kv_v, jc.kv_pos, jnp.asarray(tokens),
                        jnp.asarray(positions), jnp.asarray(slots))
        with pytest.raises(Seen):
            tc._forward(tc.kv_k, tc.kv_v, tc.kv_pos.clone(), torch.from_numpy(tokens),
                        torch.from_numpy(positions), torch.from_numpy(slots))
    finally:
        j_context.llama_forward = orig
    return got["torch"], got["jax"], tc._S


@pytest.mark.parametrize("step", ["prefill", "one_token"])
def test_alibi_mask_matches_the_jax_context(bloom, step):
    """Cell for cell: a 4-row chunk on each lane (lane 1's last two rows
    padding at position -1 in the scratch cell), and a one-token step of
    lane 0 with lane 1 parked."""
    if step == "prefill":
        tokens = np.full((2, 4), 65, np.int32)
        positions = np.asarray([[12, 13, 14, 15], [20, 21, -1, -1]], np.int32)
        slots = np.asarray([[12, 13, 14, 15], [20, 21, 64, 64]], np.int32)
    else:
        tokens = np.asarray([[65], [66]], np.int32)
        positions = np.asarray([[12], [-1]], np.int32)
        slots = np.asarray([[12], [64]], np.int32)
    mt, mj, S = captured_masks(bloom, tokens, positions, slots)
    slots[slots == 64] = S - 1
    assert mt.shape == mj.shape == (2, 1, tokens.shape[1], S)
    np.testing.assert_array_equal(mt, mj)
    # visible cells carry -|distance|, up to the query's own cell (0)
    row = mt[0, 0, 0]
    assert (row[:13] == -np.arange(12, -1, -1)).all() and (row[13:] == -1e30).all()
    # padded and parked rows see no cell
    hidden = positions < 0
    assert (mt[:, 0][hidden] == np.float32(-1e30)).all() and hidden.any()


@pytest.mark.parametrize("n_head", [6, 40])
def test_alibi_slopes_match_jax(tmp_path_factory, n_head, monkeypatch):
    """At a head count without a power of two (jais-13b and Baichuan-13B
    have 40): the slopes the port's model hands attention are the ones the
    JAX package's llama_forward hands its attention, bit for bit (captured
    from a one-chunk prefill in each), and follow the two series: m0 = 2^(-8
    / n2) to the powers 1..n2, then m1 = 2^(-4 / n2) to the odd powers."""
    import jax.numpy as jnp

    import tpullama.models.llama as j_llama
    import tpullama_torch.models.llama as t_llama
    from tpullama_torch.runtime import Context, ContextParams

    p = str(tmp_path_factory.mktemp(f"bloom_h{n_head}") / "m.gguf")
    make_tiny_llama_gguf(p, arch="bloom", n_layer=1, n_embd=16 * n_head, n_head=n_head,
                         n_head_kv=n_head, n_ff=64, seed=5, tied_output=True)
    seen = {}

    def spy(pkg, fn):
        def call(*a, alibi_slopes=None, **kw):
            seen.setdefault(pkg, np.asarray(alibi_slopes))
            return fn(*a, alibi_slopes=alibi_slopes, **kw)
        return call

    monkeypatch.setattr(j_llama, "attention_auto", spy("jax", j_llama.attention_auto))
    monkeypatch.setattr(t_llama, "attention_auto", spy("torch", t_llama.attention_auto))
    jm, tm = _jax_load(p), _port_load(p)
    toks, pos = np.arange(3, 11, dtype=np.int32)[None], np.arange(8, dtype=np.int32)[None]
    kv = jnp.zeros((1, 1, n_head, 128, 16), jnp.float32)
    mask = jnp.where(jnp.arange(128)[None, None, None, :] <= pos[:, None, :, None],
                     -jnp.abs(jnp.arange(128)[None, None, None, :] - pos[:, None, :, None]),
                     -1e30).astype(jnp.float32)
    j_llama.llama_forward(jm.params, jm.hparams, jnp.asarray(toks), jnp.asarray(pos), kv, kv,
                          jnp.asarray(pos), mask)
    Context(tm, ContextParams(n_ctx=64)).decode(toks[0])
    n2 = 1 << (n_head.bit_length() - 1)
    want = [2.0 ** (-8 / n2 * (h + 1)) if h < n2 else 2.0 ** (-4 / n2 * (2 * (h - n2) + 1))
            for h in range(n_head)]
    assert seen["torch"].dtype == seen["jax"].dtype == np.float32
    np.testing.assert_array_equal(seen["torch"], seen["jax"])
    np.testing.assert_array_equal(seen["torch"], np.float32(want))
    assert n2 < n_head and seen["torch"][n2] > seen["torch"][n2 - 1]


def test_bloom_at_six_heads_matches_jax(tmp_path_factory):
    """bloom with 6 heads of 16 (the second series on heads 4 and 5):
    prefill logits and greedy tokens against the JAX package."""
    p = str(tmp_path_factory.mktemp("bloom_h6f") / "m.gguf")
    make_tiny_llama_gguf(p, arch="bloom", n_layer=2, n_embd=96, n_head=6, n_head_kv=6,
                         seed=29, tied_output=True)
    ref = reference(p)
    t = check_load(ref)
    assert t.hparams.n_head == 6
    check_prefill(ref, t)
    check_greedy(ref, t)


def test_bloom_uniform_shift_keeps_the_next_logits(bloom, monkeypatch):
    """seq_add(+5) over every cell moves each key and the next query alike,
    so ALiBi's distances, and with them the next tokens' logits, stay as
    they were; the cached rows stay bit for bit (no rope to redo). The JAX
    package's seq_add raises on a model without rope (ROADMAP.md Queue 3
    item 15, a fault of the reference); with its rotation made the
    identity its next logits are the port's."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama.runtime import context as j_context
    from tpullama_torch.runtime import Context, ContextParams

    tm, jm = bloom["torch"], bloom["jax"]
    toks = np.asarray(tm.vocab.tokenize(PROMPT + " there was", add_special=True))
    plain, shifted = (Context(tm, ContextParams(n_ctx=64)) for _ in range(2))
    jc = JC(jm, JCP(n_ctx=64))
    for c in (plain, shifted, jc):
        c.decode(toks)
    with pytest.raises(NotImplementedError, match="rope mode -1"):
        jc.seq_add(0, HUGE, 5)
    monkeypatch.setattr(j_context, "_shift_k_rows", lambda kv_k, *a: kv_k)
    jc.seq_add(0, HUGE, 5)
    rows = shifted.kv_k.clone()
    shifted.seq_add(0, HUGE, 5)
    assert torch.equal(shifted.kv_k, rows)
    assert int(shifted.n_past[0]) == int(jc.n_past[0]) == len(toks) + 5
    np.testing.assert_array_equal(shifted._pos_host, jc._pos_host)
    for tok in (65, 66, 67):
        lp, ls, lj = (c.decode(np.asarray([tok])) for c in (plain, shifted, jc))
        np.testing.assert_allclose(ls, lp, rtol=0, atol=1e-5 * np.abs(lp).max())
        np.testing.assert_allclose(ls, lj, **LOGIT_TOL)


def test_bloom_decode_batch_matches_jax(tmp_path_factory):
    """Two bloom lanes prefilled together (decode_multi) and in chunks, then
    six batched steps: each lane's distances from its own positions; the
    JAX Context's logits and cells."""
    from tests.test_torch_gemma import load_pair

    check_decode_batch(load_pair(tmp_path_factory, "bloom", n_layer=2, **FIXTURES["bloom"]))


def test_jais_cli_prints_the_reference_text(refs, capsys):
    """jais (ALiBi at the 1/D scale) through both CLIs: the same greedy
    text."""
    from tpullama.tools.cli import main as j_main
    from tpullama_torch.tools.cli import main as t_main

    argv = ["-m", refs["jais"]["path"], "-p", PROMPT, "-n", "12", "--dtype", "float32",
            "-c", "128", "--temp", "0"]
    outs = []
    for main, extra in ((j_main, []), (t_main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and len(outs[1]) > len(PROMPT) + 1


def test_bloom_server_engine_script(tmp_path_factory):
    """A packed Q4_K bloom at n_embd 256 through the ServerEngine script of
    tests/test_torch_model.py: concurrent lanes, prompt chunks, a stop
    string and a reused prefix, each request's outcome the JAX engine's."""
    from tests._torch_fixtures import quick_seqsum

    with quick_seqsum():
        path = fixture_file(tmp_path_factory, "bloom", "_srv", **PACKED)
    _check_server_script(path)


def test_fused_path_stays_off(tmp_path_factory):
    """With the fused layer asked for, no layer of the eight archs takes the
    fused post-attention path (its kernel models neither LayerNorm, the
    non-gated FFN, the FFN biases nor an unfused [gate|up]); packed Q4_K
    files at n_embd 256."""
    from tests._torch_fixtures import quick_seqsum
    from tpullama_torch.models.llama import LlamaModel

    # baichuan-13b's flags (RMS norms, a gated SiLU FFN, ALiBi, no rope) are
    # refact's; its 40 packed layers would cost a quarter minute to write
    for case in (c for c in FIXTURES if c != "baichuan-13b"):
        with quick_seqsum():
            path = fixture_file(tmp_path_factory, case, "_fused", **PACKED, n_layer=2)
        tm = _port_load(path, packed=True, fused_layer=True)
        net = LlamaModel(tm.params, tm.hparams, tm.quant_meta, fused_layer=True)
        assert net.fused_layer and not any(layer.fused for layer in net.layers), case


# ------------------------------------------------------------- the card


CARD = ("nemotron", "apertus", "mpt", "bloom")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD)
def test_card_context_matches_the_cpu(card_file, case):
    """Each arch at n_embd 256, every layer matrix Q4_K: prefill (qmm_tiled,
    flash_attention) and greedy steps (qmm_gemv, flash_decode) on the card
    against the CPU, mpt and bloom through the attention kernels' ALiBi
    branch."""
    alibi = "_alibi" if case in ("mpt", "bloom") else ""
    path = card_file(case, arch=arch_of(case), **{"n_layer": 2, **FIXTURES[case], **PACKED})
    toks = _port_load(path).vocab.tokenize(PROMPT + " there was a card", add_special=True)
    card_against_cpu(path, toks, n_ctx=64, n_logits=len(toks),
                     kernels=("qmm_gemv", "qmm_tiled", "flash_attention" + alibi,
                              "flash_decode" + alibi))


@pytest.mark.cuda
def test_card_bloom_lanes_match_the_cpu(card_file):
    """Two bloom lanes on the card against the CPU: a packed 2-lane chunk
    (one lane padded), then six replayed batched steps whose graph builds
    each lane's distance mask on the card (flash_decode_batched_alibi)."""
    from tpullama_torch.models import load_model
    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts
    from tpullama_torch.runtime import Context, ContextParams

    path = card_file("bloom", arch="bloom", **{"n_layer": 2, **FIXTURES["bloom"], **PACKED})
    kw = dict(packed=True, packed_scale_dtype=torch.float32)
    cp = ContextParams(n_ctx=128, n_seqs=2)
    cg = Context(load_model(path, device="cuda", **kw), cp)
    cc = Context(load_model(path, device="cpu", **kw), cp)
    rng = np.random.default_rng(9)
    chunks = [(0, rng.integers(3, 250, 40).astype(np.int32)),
              (1, rng.integers(3, 250, 90).astype(np.int32))]
    reset_launch_counts()
    mg, mc = cg.decode_multi(chunks), cc.decode_multi(chunks)
    tok = np.asarray([int(np.argmax(mc[s])) for s in (0, 1)], np.int32)
    for s in (0, 1):
        assert np.abs(mg[s] - mc[s]).max() <= 1e-3 * np.abs(mc[s]).max() + 1e-4
    for _ in range(6):
        bg, bc = cg.decode_batch(tok, np.ones(2, bool)), cc.decode_batch(tok, np.ones(2, bool))
        assert np.abs(bg - bc).max() <= 1e-3 * np.abs(bc).max() + 1e-4
        tok = np.argmax(bc, axis=-1).astype(np.int32)
    counts = launch_counts()
    assert counts["flash_attention_alibi"] > 0 and counts["flash_decode_batched_alibi"] > 0
    assert counts["flash_attention"] == counts["flash_decode_batched"] == 0
    assert torch.equal(cg.kv_pos.cpu(), cc.kv_pos)
