"""The port's speculative decoding (tpullama_torch/runtime/speculative.py
over the port's Context) held against the JAX package's
(tpullama/runtime/speculative.py) on the CPU, and the JAX package's own
three cases (tests/test_speculative.py) run on the port. Fixtures, as
there: make_tiny_llama_gguf target (n_embd=64, 3 layers) and draft
(n_embd=32, 1 layer, 2/1 heads), dense F32; f32 Contexts.

Tolerance: none. Tokens, n_drafted and n_accepted must be identical: both
sides draft by argmax and accept by argmax (or the same seeded sampler
chain) over f32 logits that agree to ~1e-6 (tests/test_torch_model.py)."""

import numpy as np
import pytest

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.models.testing import make_tiny_llama_gguf

# (prompt, n_draft, p_min, n_predict, sampled)
CASES = {
    "greedy": ("Once upon", 4, 0.0, 16, False),
    # random weights never reach the 0.5 gate: every round drafts nothing
    "gated": ("xy", 3, 0.5, 10, False),
    "wide": ("abc", 8, 0.0, 20, False),
    "sampled": ("Once upon", 4, 0.0, 12, True),
}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from tpullama.models import load_model as j_load
    from tpullama_torch.models import load_model as t_load

    d = tmp_path_factory.mktemp("spec")
    out = {}
    for name, kw in (("tgt", dict(n_embd=64, n_layer=3, seed=40)),
                     ("dft", dict(n_embd=32, n_layer=1, n_head=2, n_head_kv=1, seed=41))):
        p = str(d / f"{name}.gguf")
        make_tiny_llama_gguf(p, **kw)
        out[name] = (j_load(p), t_load(p, device="cpu"))
    return out


def _run(pkg, tgt, dft, prompt, n_draft, p_min, n_predict, sampled):
    if pkg == "jax":
        from tpullama.runtime import Context, ContextParams
        from tpullama.runtime import speculative as sp
        from tpullama.runtime.sampling import SamplerChain
    else:
        from tpullama_torch.runtime import Context, ContextParams
        from tpullama_torch.runtime import speculative as sp
        from tpullama_torch.runtime.sampling import SamplerChain
    sampler = SamplerChain.from_params(seed=42, temp=0.8) if sampled else None
    toks = tgt.vocab.tokenize(prompt, add_special=True)
    spec = sp.Speculative(dft, sp.SpeculativeParams(n_draft=n_draft, p_min=p_min), n_ctx=128)
    return sp.generate_speculative(Context(tgt, ContextParams(n_ctx=128)), spec, toks,
                                   n_predict=n_predict, sampler=sampler)


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_speculative_is_the_reference(models, case):
    (jt, tt), (jd, td) = models["tgt"], models["dft"]
    out_j, st_j = _run("jax", jt, jd, *CASES[case])
    out_t, st_t = _run("torch", tt, td, *CASES[case])
    assert out_t == out_j
    assert (st_t["n_drafted"], st_t["n_accepted"]) == (st_j["n_drafted"], st_j["n_accepted"])
    assert (st_t["n_drafted"] > 0) == (case != "gated")


def test_gen_draft_reuses_a_shifted_window(models):
    """A second target prompt that drops the first one's head: the draft
    Context keeps the common window and moves it to position 0 (seq_rm,
    then seq_add by -reuse_i over [reuse_i, 2**30 - 1)), as the reference
    does, and drafts the same tokens."""
    from tpullama.runtime import speculative as jsp
    from tpullama_torch.runtime import speculative as tsp

    jd, td = models["dft"]
    specs = [m.Speculative(d, m.SpeculativeParams(n_draft=4, p_min=0.0), n_ctx=128)
             for m, d in ((jsp, jd), (tsp, td))]
    toks = td.vocab.tokenize("Once upon a time there was a model", add_special=True)
    for prompt, last in ((toks[:-1], toks[-1]), (toks[5:], 70), (toks[9:] + [70, 71], 72)):
        drafts = [s.gen_draft(list(prompt), last) for s in specs]
        assert drafts[1] == drafts[0]
        js, ts = specs
        assert ts.prompt == js.prompt
        np.testing.assert_array_equal(ts.ctx.n_past, js.ctx.n_past)
        np.testing.assert_array_equal(ts.ctx._pos_host, js.ctx._pos_host)
        np.testing.assert_array_equal(ts.ctx.kv_pos.numpy(), np.asarray(js.ctx.kv_pos))


# the JAX package's tests/test_speculative.py, on the port


def test_speculative_matches_plain_greedy(models):
    from tpullama_torch.runtime import Context, ContextParams
    from tpullama_torch.runtime.speculative import (Speculative, SpeculativeParams,
                                                    generate_speculative)

    tgt, dft = models["tgt"][1], models["dft"][1]
    prompt = tgt.vocab.tokenize("Once upon", add_special=True)
    plain = Context(tgt, ContextParams(n_ctx=128)).generate(prompt, n_predict=16)
    spec = Speculative(dft, SpeculativeParams(n_draft=4, p_min=0.0), n_ctx=128)
    out, _ = generate_speculative(Context(tgt, ContextParams(n_ctx=128)), spec, prompt,
                                  n_predict=16)
    assert out == plain


def test_self_draft_accepts_all(models):
    from tpullama_torch.runtime import Context, ContextParams
    from tpullama_torch.runtime.speculative import (Speculative, SpeculativeParams,
                                                    generate_speculative)

    tgt = models["tgt"][1]
    prompt = tgt.vocab.tokenize("abc", add_special=True)
    spec = Speculative(tgt, SpeculativeParams(n_draft=4, p_min=0.0), n_ctx=128)
    out, stats = generate_speculative(Context(tgt, ContextParams(n_ctx=128)), spec, prompt,
                                      n_predict=12)
    assert stats["n_drafted"] > 0
    assert stats["accept_rate"] > 0.95, stats
    assert out == Context(tgt, ContextParams(n_ctx=128)).generate(prompt, n_predict=12)


def test_speculative_multiround_consistency(models):
    """Repeated speculative runs are deterministic."""
    outs = [_run("torch", models["tgt"][1], models["dft"][1], "xy", 3, 0.5, 10, False)[0]
            for _ in range(2)]
    assert outs[0] == outs[1]
