"""The gemma family (gemma, gemma2, gemma3) held against the JAX package on
the CPU, on the JAX oracle's fixtures (tests/test_e2e_oracle.py): gemma
with 2 layers, one KV head and a tied output (the token table as lm_head;
sqrt(n_embd) embedding scale, GELU FFN); gemma2 with 4 layers, tied
(sandwich norms, SWA on the even layers, attention and final softcaps
30 / 25); gemma3 at n_embd 64 with 8 layers (per-head q/k norms, sandwich
norms, SWA on five layers of six with their own rope base, the
1/sqrt(head_dim) attention scale), every window 32.

Cases: the loaded hparams and parameter trees; prefill logits of a
60-token prompt and 16 greedy tokens (n_ctx 128, n_ubatch 16: the ring of
32 + 16 + 1 = 49 cells wraps), both stacks' positions and the host mirror
cell for cell after; decode_multi and decode_batch over 2 lanes; a state
file written by one package and read by the other; a gemma3 cut of 4
layers, which has no full layer and so keeps one windowed stack; and
gemma3 with linear rope scaling (factor 8), where the port's SWA layers
rotate unscaled as the published model does and the JAX package's at the
model's scale (ROADMAP.md Queue 3 item 11); and a context shift on one
stack, whose SWA layers the port re-rotates with their own rope base and
the JAX package with the full layers' (Queue 3 item 12), held against a
fresh prefill.

Tolerances: logits within 1e-4 of their largest magnitude plus 1e-5 (f32
sums in another order over up to 8 layers); shifted K rows within 1e-5 of
their largest magnitude (one f32 rotation against another); token ids,
positions and trees exactly."""

import numpy as np
import pytest

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_model import _assert_same_tree, _jax_load, _jax_numpy, _port_load, _to_numpy
from tpullama.models.testing import make_tiny_llama_gguf

N_CTX = 128
N_UBATCH = 16
RING = 32 + N_UBATCH + 1
# the JAX oracle's settings (tests/test_e2e_oracle.py:186-219, 398-413)
FIXTURES = {"gemma": dict(n_layer=2, n_head_kv=1, tied_output=True, seed=17),
            "gemma2": dict(n_layer=4, tied_output=True, seed=53),
            "gemma3": dict(n_embd=64, n_layer=8, seed=70)}
LINEAR_ROPE = {"gemma3.rope.scaling.type": "linear", "gemma3.rope.scaling.factor": 8.0}


def assert_logits_close(got, want):
    """Within 1e-4 of the reference's largest magnitude plus 1e-5."""
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()) + 1e-5, err


def load_pair(tmp_path_factory, arch, **kw):
    """A fixture written once and loaded by each package (f32, dense)."""
    p = str(tmp_path_factory.mktemp(arch) / "m.gguf")
    make_tiny_llama_gguf(p, arch=arch, **kw)
    return {"jax": _jax_load(p), "torch": _port_load(p), "path": p}


def context(pair, pkg, n_seqs=1, n_ctx=N_CTX):
    if pkg == "jax":
        from tpullama.runtime import Context, ContextParams
    else:
        from tpullama_torch.runtime import Context, ContextParams
    return Context(pair[pkg], ContextParams(n_ctx=n_ctx, n_ubatch=N_UBATCH, n_seqs=n_seqs))


def contexts(pair, n_seqs=1, n_ctx=N_CTX):
    return context(pair, "jax", n_seqs, n_ctx), context(pair, "torch", n_seqs, n_ctx)


def prompt(n, seed=0):
    return np.random.default_rng(seed).integers(3, 250, size=n).astype(np.int32)


def same_cells(tc, jc):
    """Both packages' cache positions, stack by stack, and host mirrors."""
    assert tc._S_swa == jc._S_swa
    assert isinstance(tc.kv_pos, dict) == isinstance(jc.kv_pos, dict)
    if isinstance(tc.kv_pos, dict):
        for stack in ("full", "swa"):
            np.testing.assert_array_equal(tc.kv_pos[stack].numpy(),
                                          np.asarray(jc.kv_pos[stack]), err_msg=stack)
    else:
        np.testing.assert_array_equal(tc.kv_pos.numpy(), np.asarray(jc.kv_pos))
    np.testing.assert_array_equal(tc._pos_host, jc._pos_host)
    np.testing.assert_array_equal(tc.n_past, jc.n_past)


def check_load(pair):
    j, t = pair["jax"], pair["torch"]
    assert vars(t.hparams) == {k: getattr(j.hparams, k) for k in vars(t.hparams)}
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))


def check_prefill_and_greedy(pair, n_prompt=60):
    """The prompt's logits, then 16 greedy tokens from fresh Contexts, then
    the cells after them."""
    toks = prompt(n_prompt)
    jc, tc = contexts(pair)
    assert_logits_close(tc.decode(toks, n_logits=n_prompt), jc.decode(toks, n_logits=n_prompt))
    same_cells(tc, jc)
    jc, tc = contexts(pair)
    assert tc.generate(list(toks), n_predict=16) == jc.generate(list(toks), n_predict=16)
    same_cells(tc, jc)
    return tc


def check_decode_batch(pair):
    """Two lanes prefilled together (decode_multi), then 6 decode_batch
    steps of both, the second lane past the ring."""
    jc, tc = contexts(pair, n_seqs=2)
    chunks = [(0, prompt(12, seed=1)), (1, prompt(N_UBATCH, seed=2))]
    mj, mt = jc.decode_multi(chunks), tc.decode_multi(chunks)
    for s, _ in chunks:
        assert_logits_close(mt[s], mj[s])
    for i in range(3):
        chunks = [(1, prompt(N_UBATCH, seed=3 + i))]
        assert_logits_close(tc.decode_multi(chunks)[1], jc.decode_multi(chunks)[1])
    tok = np.asarray([int(np.argmax(mj[0])), 7], np.int32)
    active = np.ones(2, bool)
    for _ in range(6):
        bj, bt = jc.decode_batch(tok, active), tc.decode_batch(tok, active)
        assert_logits_close(bt, bj)
        tok = np.argmax(bj, axis=-1).astype(np.int32)
    same_cells(tc, jc)


def check_state_crosses(pair, tmp_path, writer, reader):
    """A Context prefilled past the ring, saved by one package, restored
    into a fresh Context by the other: the same 8 greedy tokens and
    last logits."""
    from tpullama.runtime import state as j_state
    from tpullama_torch.runtime import state as t_state

    mods = {"jax": j_state, "torch": t_state}
    src = context(pair, writer)
    toks = [int(t) for t in prompt(58, seed=4)]
    src.decode(np.asarray(toks))
    f = str(tmp_path / "s.bin")
    mods[writer].state_save(src, f, tokens=toks)
    dst = context(pair, reader)
    assert [int(t) for t in mods[reader].state_load(dst, f)] == toks

    def greedy(c, n=8):
        tok, out = toks[-1], []
        for _ in range(n):
            logits = c.decode(np.asarray([tok], np.int32))
            tok = int(np.argmax(logits[-1]))
            out.append((tok, logits))
        return out

    want, have = greedy(src), greedy(dst)
    assert [t for t, _ in have] == [t for t, _ in want]
    assert_logits_close(have[-1][1], want[-1][1])


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return {arch: load_pair(tmp_path_factory, arch, **kw) for arch, kw in FIXTURES.items()}


@pytest.mark.parametrize("arch", list(FIXTURES))
def test_load_matches_jax(models, arch):
    """The JAX package's hparams (embedding scale, GELU; gemma2's and
    gemma3's SWA layers, softcaps, rope bases, attention scale) and tree
    (post_attn_norm, post_ffn_norm; no output matrix: the tied table)."""
    check_load(models[arch])
    hp, layers = models[arch]["torch"].hparams, models[arch]["torch"].params["layers"]
    assert hp.act == "gelu" and hp.embd_scale == np.sqrt(hp.n_embd)
    # the oracle's gemma3 fixture keeps its own output matrix
    assert ("output" in models[arch]["torch"].params) == (arch == "gemma3")
    if arch != "gemma":
        assert {"post_attn_norm", "post_ffn_norm"} <= set(layers)
        assert hp.n_swa == 32
    if arch == "gemma3":
        assert hp.swa_layers == (True,) * 5 + (False, True, True)
        assert (hp.rope_freq_base_swa, hp.f_attention_scale) == (10000.0, 1 / 4)
        assert {"attn_q_norm", "attn_k_norm"} <= set(layers)
    if arch == "gemma2":
        assert hp.swa_layers == (True, False, True, False)
        assert (hp.attn_logit_softcap, hp.final_logit_softcap) == (30.0, 25.0)


@pytest.mark.parametrize("arch", list(FIXTURES))
def test_prefill_and_greedy_match_jax(models, arch):
    """60 prompt tokens (in n_ubatch chunks on a two-stack cache, so the
    ring wraps), then 16 greedy tokens: the JAX Context's logits, tokens
    and cells."""
    tc = check_prefill_and_greedy(models[arch])
    assert tc._S_swa == (0 if arch == "gemma" else RING)


@pytest.mark.parametrize("arch", list(FIXTURES))
def test_decode_batch_matches_jax(models, arch):
    check_decode_batch(models[arch])


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("arch", list(FIXTURES))
def test_state_file_crosses(models, tmp_path, arch, writer, reader):
    check_state_crosses(models[arch], tmp_path, writer, reader)


def test_gemma3_cut_keeps_one_windowed_stack(tmp_path_factory):
    """gemma3 at 4 layers (all five-of-six SWA layers, no full one): one
    stack of n_ctx cells under the windowed mask, as the JAX Context; the
    prompt runs past the window in one forward."""
    pair = load_pair(tmp_path_factory, "gemma3", **dict(FIXTURES["gemma3"], n_layer=4))
    assert pair["torch"].hparams.swa_layers == (True,) * 4
    tc = check_prefill_and_greedy(pair)
    assert tc._S_swa == 0 and not isinstance(tc.kv_k, dict)


def test_gemma3_swa_layers_rotate_unscaled(tmp_path_factory):
    """gemma3 with linear rope scaling, factor 8 (gemma-3-12b's and 27b's
    rope_scaling): the port's full layers rotate at freq_scale 0.125 and
    its SWA layers at 1, as llama.cpp (rope_freq_scale_train_swa = 1 for
    gemma3) and HF's local rotary embedding do; the JAX package keeps 0.125
    on the SWA layers too. The prompt's logits then differ: equal at
    position 0, where every rotation is the identity, and 3.62 apart at
    most past it (tiny fixture, 40 tokens; largest logit 3.68). With the
    JAX package's rule on its SWA layers the port gives the JAX logits."""
    from dataclasses import replace

    pair = load_pair(tmp_path_factory, "gemma3", **FIXTURES["gemma3"], extra_kv=LINEAR_ROPE)
    check_load(pair)
    jc, tc = contexts(pair)
    assert (tc.net.rp.freq_scale, tc.net.rp_swa.freq_scale) == (0.125, 1.0)
    toks = prompt(40, seed=1)
    lj, lt = jc.decode(toks, n_logits=40), tc.decode(toks, n_logits=40)
    assert_logits_close(lt[0], lj[0])
    assert float(np.abs(lt[1:] - lj[1:]).max()) > 1.0
    tj = context(pair, "torch")
    tj.net.rp_swa = replace(tj.net.rp_swa, freq_scale=tj.net.rp.freq_scale)
    assert_logits_close(tj.decode(toks, n_logits=40), lj)


def test_gemma_cli_prints_the_reference_text(models, capsys):
    """The port's CLI (--device cpu) prints the JAX CLI's greedy text on
    the tied gemma file."""
    from tpullama.tools.cli import main as j_main
    from tpullama_torch.tools.cli import main as t_main

    argv = ["-m", models["gemma"]["path"], "-p", "Once upon a time", "-n", "12", "--dtype", "float32",
            "-c", "128", "--temp", "0"]
    capsys.readouterr()
    rc_j, out_j = j_main(argv), capsys.readouterr().out
    rc_t, out_t = t_main(argv + ["--device", "cpu"]), capsys.readouterr().out
    assert rc_j == rc_t == 0 and out_t == out_j


HUGE = (1 << 30) - 1  # seq_add's upper bound for "to the end"


def test_gemma3_shift_rotates_swa_layers_by_their_own_rope(tmp_path_factory):
    """A context shift (seq_rm of 3 tokens, seq_add of the rest by -3) on
    gemma3's one stack (swa_full) with the full layers' rope base at 1e6,
    gemma3's, beside the SWA layers' 1e4: layer 0, an SWA layer whose K
    rows depend on their token and position alone, equals a fresh prefill
    of the kept tokens at their new positions. The port rotates each layer
    by the table its forward takes; the JAX package rotates every layer
    with the full layers' (ROADMAP.md Queue 3 item 12), so its layer 0 is
    held to the same answer and found off."""
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    pair = load_pair(tmp_path_factory, "gemma3", **FIXTURES["gemma3"])
    for pkg in ("jax", "torch"):
        pair[pkg].hparams.rope_freq_base = 1e6
    toks = prompt(24, seed=8)
    n = len(toks) - 3
    gaps = {}
    for pkg, C, P in (("jax", JC, JCP), ("torch", TC, TCP)):
        shifted = C(pair[pkg], P(n_ctx=N_CTX, swa_full=True))
        fresh = C(pair[pkg], P(n_ctx=N_CTX, swa_full=True))
        shifted.decode(toks)
        shifted.seq_rm(0, 3)
        shifted.seq_add(3, HUGE, -3)
        fresh.decode(toks[3:])
        pos = np.asarray(shifted._pos_host[0])
        cells = np.argsort(np.where(pos >= 0, pos, 1 << 20))[:n]
        got = np.asarray(shifted.kv_k[0, 0])[:, cells]
        want = np.asarray(fresh.kv_k[0, 0])[:, :n]
        gaps[pkg] = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert gaps["torch"] <= 1e-5
    assert gaps["jax"] > 1e-2
