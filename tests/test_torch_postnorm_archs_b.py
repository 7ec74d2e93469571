"""The second half of the post-norm slice (tests/test_torch_postnorm_archs.py
holds the first and the fixtures of every case): chameleon (per-head
LayerNorm q/k norms with biases under RMS block norms, NORM rope, the
image rows of the logits at the f32 minimum) and its swin variant
(attn_norm and ffn_norm loaded as the post norms, the FFN reading the
normed attention output), bitnet (one-element projection scales, the
attention and FFN sub-norms; F32, and with every matrix TQ2_0, which both
loaders decode dense) and exaone4 at its 32B layout (exactly 64 layers:
SWA layers il % 4 != 3 on the ring, rope on them alone, the full layers
NoPE; window 32 so that the ring wraps), on the JAX oracle's fixtures,
with the same cases; then

- exaone4-64 on both stacks: a 60-token prompt in 16-token chunks wraps
  the ring of 32 + 16 + 1 cells; two lanes through decode_batch; a
  context shift leaves the NoPE full layers' K rows as they were and
  rotates layer 0's (on the ring) to a fresh prefill's rows, where the JAX
  package rotates the full layers too (ROADMAP.md Queue 3 item 12);
- chameleon's image rows at the f32 minimum after a prefill and after a
  replayed one-token step of two lanes, and never a greedy token;
- bitnet's scales multiplied as one-element tensors, with no host read;
- the olmo, olmo2, chameleon swin, bitnet and olmoe fixtures through
  both CLIs, and a packed olmo2 and a packed exaone4 through the
  ServerEngine script, against the JAX package's.

On the card (`cuda`): olmo2, exaone4-64, chameleon swin, bitnet and olmoe
at n_embd 256 with every layer matrix Q4_K, a card Context against the
CPU's.

Tolerances: trees exactly; logits within rtol = atol = 1e-4 (f32 sums in
another order), or within 1e-4 of their largest magnitude plus 1e-5 on
the two-stack cases (tests/test_torch_gemma.py's rule); the ring's
shifted K rows within 1e-5 of their largest magnitude; tokens and the
unrotated rows exactly; card against CPU within 1e-3 of the CPU logits'
largest magnitude plus 1e-4."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_flag_archs import check_greedy, check_load, check_prefill, reference
from tests.test_torch_gemma import (check_decode_batch, check_prefill_and_greedy, contexts,
                                    prompt, same_cells)
from tests.test_torch_gemma import check_load as check_pair_load
from tests.test_torch_model import PROMPT, _check_server_script, _jax_load, _port_load
from tests.test_torch_nongated_archs_b import card_against_cpu, card_file, cuda  # noqa: F401
from tests.test_torch_postnorm_archs import (FIXTURES, HUGE, PACKED, arch_of,
                                             check_case_tensors, fixture_file)

SECOND = ("chameleon", "chameleon-swin", "bitnet", "bitnet-tq2")
F32_MIN = np.finfo(np.float32).min


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return {case: reference(fixture_file(tmp_path_factory, case)) for case in SECOND}


@pytest.fixture(scope="module")
def exaone64(tmp_path_factory):
    """exaone4's 64-layer fixture, loaded by each package."""
    p = fixture_file(tmp_path_factory, "exaone4-64")
    return {"jax": _jax_load(p), "torch": _port_load(p), "path": p}


@pytest.mark.parametrize("case", SECOND)
def test_load_matches_jax(refs, case):
    t = check_load(refs[case])
    check_case_tensors(case, t)
    if case == "bitnet-tq2":
        assert t.quant_meta is None and t.params["layers"]["attn_q"].dtype == torch.float32


@pytest.mark.parametrize("case", SECOND)
def test_prefill_logits_match_jax(refs, case):
    check_prefill(refs[case], _port_load(refs[case]["path"]))


@pytest.mark.parametrize("case", SECOND)
def test_greedy_tokens_match_jax(refs, case):
    check_greedy(refs[case], _port_load(refs[case]["path"]))


def test_exaone4_64_loads_its_swa_layout(exaone64):
    """At exactly 64 layers: SWA layers il % 4 != 3 with the file's window,
    rope on them alone (rope_swa_only, one base), the JAX package's
    hparams and tree, the port's model with no rope table on a full
    layer."""
    from tpullama_torch.models.llama import LlamaModel

    check_pair_load(exaone64)
    t = exaone64["torch"]
    check_case_tensors("exaone4-64", t)
    hp = t.hparams
    assert hp.swa_layers == tuple(il % 4 != 3 for il in range(64))
    assert (hp.n_swa, hp.rope_swa_only, hp.rope_freq_base_swa) == (32, True, hp.rope_freq_base)
    kinds = LlamaModel(t.params, hp).rope_kinds
    assert kinds == tuple("swa" if il % 4 != 3 else None for il in range(64))


def test_exaone4_64_prefill_and_greedy_match_jax(exaone64):
    tc = check_prefill_and_greedy(exaone64)
    assert tc._S_swa == 32 + 16 + 1 and isinstance(tc.kv_k, dict)
    assert tc.kv_k["full"].shape[0] == 16 and tc.kv_k["swa"].shape[0] == 48


def test_exaone4_64_decode_batch_matches_jax(exaone64):
    check_decode_batch(exaone64)


def test_exaone4_64_shift_keeps_the_nope_layers(exaone64):
    """seq_rm of 4 tokens and seq_add(-4) of the rest on the two stacks:
    the full layers take no rope, so their K rows stay bit for bit; layer
    0 (an SWA layer, its K rows from its token and position alone) holds a
    fresh prefill's rows of the kept tokens at each position's ring cell,
    and the JAX package's shifted ring rows. The JAX package rotates the
    full layers' rows too (ROADMAP.md Queue 3 item 12), which moves them."""
    jc, tc = contexts(exaone64)
    _, fresh = contexts(exaone64)
    toks = prompt(40, seed=9)
    jc.decode(toks)
    tc.decode(toks)
    before = {"jax": np.asarray(jc.kv_k["full"]).copy(), "torch": tc.kv_k["full"].clone()}
    for c in (jc, tc):
        c.seq_rm(0, 4)
        c.seq_add(4, HUGE, -4)
    fresh.decode(toks[4:])
    same_cells(tc, jc)
    assert torch.equal(tc.kv_k["full"], before["torch"])
    assert float(np.abs(np.asarray(jc.kv_k["full"]) - before["jax"]).max()) > 1e-3
    np.testing.assert_allclose(tc.kv_k["swa"].numpy(), np.asarray(jc.kv_k["swa"]),
                               rtol=1e-5, atol=1e-5)
    pos_t, pos_f = tc.kv_pos["swa"][0].numpy(), fresh.kv_pos["swa"][0].numpy()
    kept = np.arange(36)
    cells_t = [int(np.flatnonzero(pos_t == p)[0]) for p in kept]
    cells_f = [int(np.flatnonzero(pos_f == p)[0]) for p in kept]
    got = tc.kv_k["swa"][0, 0][:, cells_t]
    want = fresh.kv_k["swa"][0, 0][:, cells_f]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("case", ["chameleon", "chameleon-swin"])
def test_chameleon_image_rows_stay_masked(refs, case):
    """Rows 4..8195 of the logits at the f32 minimum after a prefill and
    after a replayed one-token step of two lanes (the step program's
    logits, which the device sampler reads); the other rows finite and
    above them; no greedy token among them."""
    from tpullama_torch.runtime import Context, ContextParams

    t = _port_load(refs[case]["path"])
    assert t.hparams.n_vocab > 8196
    ctx = Context(t, ContextParams(n_ctx=64, n_seqs=2))
    toks = np.asarray(refs[case]["toks"])
    first = ctx.decode_multi([(0, toks), (1, toks[:5])])
    step = ctx.decode_batch(np.asarray([65, 66], np.int32), np.ones(2, bool))
    for logits in (first[0], first[1], step[0], step[1]):
        assert (logits[..., 4:8196] == F32_MIN).all()
        rest = np.concatenate([logits[..., :4], logits[..., 8196:]], axis=-1)
        assert np.isfinite(rest).all() and (rest > F32_MIN).all()
    assert not any(4 <= tok < 8196 for tok in refs[case]["greedy"])


def test_bitnet_scales_are_tensors(refs, monkeypatch):
    """Each layer holds its seven scales as one-element tensors, and a
    prefill and a one-token step read none of them on the host (no .item():
    a host read syncs and cannot be captured in a CUDA graph)."""
    from tpullama_torch.runtime import Context, ContextParams

    t = _port_load(refs["bitnet"]["path"])
    ctx = Context(t, ContextParams(n_ctx=64))
    for layer in ctx.net.layers:
        for k in ("attn_q_scale", "attn_output_scale", "ffn_down_scale"):
            assert isinstance(layer.w[k], torch.Tensor) and tuple(layer.w[k].shape) == (1,)

    def no_item(self):
        raise AssertionError("a host read of a tensor inside the forward")

    forward = ctx.net.forward

    def guarded(*a, **kw):
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "item", no_item)
            return forward(*a, **kw)

    ctx.net.forward = guarded
    toks = np.asarray(refs["bitnet"]["toks"])
    logits = ctx.decode(toks, n_logits=len(toks))
    np.testing.assert_allclose(logits, refs["bitnet"]["logits"], rtol=1e-4, atol=1e-4)
    ctx.decode(np.asarray([int(np.argmax(logits[-1]))], np.int32))


@pytest.mark.parametrize("case", ["olmo", "olmo2", "chameleon-swin", "bitnet", "olmoe"])
def test_cli_prints_the_reference_text(tmp_path_factory, capsys, case):
    """Each fixture through both CLIs: the same greedy text."""
    from tpullama.tools.cli import main as j_main
    from tpullama_torch.tools.cli import main as t_main

    path = fixture_file(tmp_path_factory, case, "_cli")
    argv = ["-m", path, "-p", PROMPT, "-n", "10", "--dtype", "float32", "-c", "128",
            "--temp", "0"]
    outs = []
    for main, extra in ((j_main, []), (t_main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and len(outs[1]) > len(PROMPT) + 1


@pytest.mark.parametrize("case", ["olmo2", "exaone4"])
def test_server_engine_script(tmp_path_factory, case):
    """A packed Q4_K olmo2 (the served arch) and exaone4 at n_embd 256
    through the ServerEngine script of tests/test_torch_model.py:
    concurrent lanes, prompt chunks, a stop string and a reused prefix,
    each request's outcome the JAX engine's."""
    from tests._torch_fixtures import quick_seqsum

    with quick_seqsum():
        path = fixture_file(tmp_path_factory, case, "_srv", **PACKED)
    _check_server_script(path)


# ------------------------------------------------------------- the card


CARD = {"olmo2": {}, "chameleon-swin": {}, "bitnet": {}, "olmoe": {},
        "exaone4-64": dict(n_ctx=256, n_ubatch=16)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD))
def test_card_context_matches_the_cpu(card_file, case):
    """Each arch at n_embd 256, every layer matrix Q4_K (olmoe's experts
    through the gathered kernels): prefill (qmm_tiled, flash_attention) and
    greedy steps (qmm_gemv, flash_decode) on the card against the CPU;
    exaone4-64's 60-token prompt in 16-token chunks wraps its ring."""
    from tests._torch_fixtures import quick_seqsum

    with quick_seqsum():
        path = card_file(case, arch=arch_of(case), **{"n_layer": 2, **FIXTURES[case], **PACKED})
    if case == "exaone4-64":
        toks = np.random.default_rng(12).integers(3, 259, 60)
        n_logits = 20
    else:
        toks = _port_load(path).vocab.tokenize(PROMPT + " there was a card", add_special=True)
        n_logits = len(toks)
    from tpullama_torch.ops.cuda import launch_counts

    opts = CARD[case]
    cg = card_against_cpu(path, toks, n_ctx=opts.get("n_ctx", 64), n_logits=n_logits,
                          n_ubatch=opts.get("n_ubatch", 512),
                          kernels=("qmm_gemv", "qmm_tiled", "flash_attention", "flash_decode"))
    counts = launch_counts()
    assert counts["fused_postattn"] == 0
    if case == "olmoe":
        # the experts' planes row-major or transposed, by the loader's rule
        assert counts["qmm_gathered"] + counts["qmm_gathered_t"] > 0, counts
    if case == "exaone4-64":
        assert cg._S_swa == 32 + 16 + 1 and isinstance(cg.kv_k, dict)
