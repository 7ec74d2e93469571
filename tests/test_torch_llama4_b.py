"""llama4's serving paths, and the three archs that ride
on its mechanisms (smollm3, hunyuan-dense, hunyuan-moe), held against the
JAX package on the CPU; the fixtures and helpers are
tests/test_torch_llama4.py's.

llama4: a 2-slot ServerEngine on the JAX oracle's fixture with n_swa 32
on both packages (two stacks, the ring wrapping); the CLI's greedy text on
the Scout layout's file; a state file of the two stacks written by one
package and read by the other.

smollm3 (NoPE on every 4th layer), hunyuan-dense (per-head q/k RMS norms
after rope) and hunyuan-moe (the same, with softmax routing and an
ungated shared expert) on the JAX oracle's fixtures and seeds
(tests/test_e2e_oracle.py:299, 343, 362): F32 at the oracle's widths, and
Q4_K at n_embd = n_ff = 256 loaded packed in both packages: the hparams
and trees, prefill logits and 16 greedy tokens.

Tolerances: logits within 1e-4 of their largest magnitude plus 1e-5 (f32
sums in another order); token ids, text, metrics and trees exactly."""

import numpy as np
import pytest

from tests import _torch_fixtures
from tests.test_torch_gemma import assert_logits_close
from tests.test_torch_llama4 import (context, contexts, load_models, load_pair, prompt,
                                     small_chunk)
from tests.test_torch_model import (PROMPT, _assert_same_tree, _jax_numpy, _serve,
                                    _to_numpy)
from tpullama.gguf import GGMLType

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return load_models(tmp_path_factory)


def test_server_engine_script(models):
    """A 2-slot ServerEngine (n_ctx 128, n_ubatch 16) on the oracle's model
    with n_swa 32 on both packages (two stacks, the ring wrapping in the
    long prompts): two greedy requests together, then a prompt-cache
    reuse: the JAX engine's completions, stop reasons and metrics."""
    pair = models["oracle"]
    long_prompt = "The quick brown fox jumps over the lazy dog. " * 2
    script = [[dict(prompt=long_prompt, n_predict=10), dict(prompt=PROMPT, n_predict=8)],
              [dict(prompt=long_prompt + "again", n_predict=10)]]
    with small_chunk(pair):
        out_j, eng_j = _serve("jax", pair["jax"], script)
        out_t, eng_t = _serve("torch", pair["torch"], script)
    assert eng_t.ctx._S_swa == eng_j.ctx._S_swa == 49
    assert out_t == out_j and all(o[2] == "length" for o in out_t)
    assert eng_t.metrics == {k: eng_j.metrics[k] for k in eng_t.metrics}
    assert eng_t.ctx.perf.n_reused == eng_j.ctx.perf.n_reused > 0


def test_cli_prints_the_reference_text(models, capsys):
    """The port's CLI (--device cpu) prints the JAX CLI's greedy text on
    the Scout layout's file, packed in both."""
    from tpullama.tools.cli import main as j_main
    from tpullama_torch.tools.cli import main as t_main

    argv = ["-m", models["scout"]["path"], "-p", PROMPT, "-n", "12", "--dtype", "float32",
            "-c", "128", "--temp", "0"]
    capsys.readouterr()
    rc_j, out_j = j_main(argv), capsys.readouterr().out
    rc_t, out_t = t_main(argv + ["--device", "cpu"]), capsys.readouterr().out
    assert rc_j == rc_t == 0
    assert out_t.startswith(PROMPT) and len(out_t) > len(PROMPT) + 1
    assert out_t == out_j


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_state_file_crosses(models, tmp_path, writer, reader):
    """With n_swa 32 (two stacks), a Context prefilled past the ring and
    saved by one package, restored into a fresh Context by the other: the
    same 8 greedy tokens and last logits."""
    from tpullama.runtime import state as j_state
    from tpullama_torch.runtime import state as t_state

    pair = models["oracle"]
    mods = {"jax": j_state, "torch": t_state}
    toks = [int(t) for t in prompt(58, seed=4)]
    with small_chunk(pair):
        src = context(pair, writer)
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


# the JAX oracle's settings (tests/test_e2e_oracle.py:299, 343, 362)
ARCHS = {"smollm3": dict(n_layer=5, seed=31), "hunyuan-dense": dict(n_head_kv=2, seed=41),
         "hunyuan-moe": dict(n_expert=4, n_head_kv=2, seed=43)}
QTYPES = [GGMLType.F32, GGMLType.Q4_K]


@pytest.fixture(scope="module")
def arch_models(tmp_path_factory):
    out = {}
    for arch, kw in ARCHS.items():
        for qt in QTYPES:
            wide = dict(n_embd=256, n_ff=256) if qt == GGMLType.Q4_K else {}
            path = _torch_fixtures.tiny_gguf(tmp_path_factory, arch=arch, qtype=qt,
                                             **{"n_layer": 2, **kw, **wide})
            out[arch, qt] = load_pair(path, qt != GGMLType.F32)
    return out


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_arch_load_matches_jax(arch_models, arch, qtype):
    """The JAX package's hparams (smollm3's NoPE step and NORM rope,
    hunyuan's q/k norms after rope) and parameter tree."""
    pair = arch_models[arch, qtype]
    j, t = pair["jax"], pair["torch"]
    assert vars(t.hparams) == {k: getattr(j.hparams, k) for k in vars(t.hparams)}
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    hp = t.hparams
    if arch == "smollm3":
        assert hp.nope_layers == (False, False, False, True, False) and hp.rope_type == 0
    else:
        assert hp.qk_norm_after_rope and {"attn_q_norm", "attn_k_norm"} <= set(t.params["layers"])
    if arch == "hunyuan-moe":
        assert {"ffn_gate_shexp", "ffn_gate_inp"} <= set(t.params["layers"])
        assert "ffn_gate_inp_shexp" not in t.params["layers"]
        if qtype == GGMLType.Q4_K:
            assert {"ffn_gateup_exps", "ffn_down_exps"} <= set(t.quant_meta["layers"])


@pytest.mark.parametrize("qtype", QTYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_arch_prefill_and_greedy_match_jax(arch_models, arch, qtype):
    """A 40-token prompt's logits, then 16 greedy tokens from fresh
    Contexts."""
    pair = arch_models[arch, qtype]
    toks = prompt(40, seed=5)
    jc, tc = contexts(pair)
    assert_logits_close(tc.decode(toks, n_logits=40), jc.decode(toks, n_logits=40))
    jc, tc = contexts(pair)
    assert tc.generate(list(toks), n_predict=16) == jc.generate(list(toks), n_predict=16)
