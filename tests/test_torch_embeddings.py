"""The port's Context.embeddings (tpullama_torch/runtime/context.py, with
LlamaModel.forward's return_embd) held against the JAX package's on the
CPU: every pooling type (none, mean, cls, last), normalised and not, on
prompts of several tokens and of one token (a one-token step otherwise
takes the step program, which keeps no hidden states). Fixtures:
make_tiny_llama_gguf at n_embd=64, 2 layers: dense F32 and packed Q4_K
(f32 scale planes on both sides) llamas, and a dense chatglm.

The card test (marked cuda) holds the card's embeddings, one token
included, against the CPU port's.

Tolerances: within 1e-5 of the largest |value| on the CPU (f32 on both
sides, sums in another order); the card's within 1e-4 of it (its
attention kernels sum in another order)."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.gguf import GGMLType
from tpullama.models.testing import make_tiny_llama_gguf

POOLINGS = ["none", "mean", "cls", "last"]
PROMPTS = {"many": "Once upon a time there was", "one": ""}
KINDS = {"dense": dict(qtype=GGMLType.F32), "q4k": dict(qtype=GGMLType.Q4_K, n_embd=256),
         "glm": dict(qtype=GGMLType.F32, arch="chatglm")}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Per kind: the file, and a JAX and a port Context (f32, 2 lanes of 64
    cells) over it, shared by the module's cases (embeddings resets the
    lane it runs on)."""
    from tpullama.models import load_model as j_load
    from tpullama.runtime import Context as JC
    from tpullama.runtime import ContextParams as JCP
    from tpullama_torch.models import load_model as t_load
    from tpullama_torch.runtime import Context as TC
    from tpullama_torch.runtime import ContextParams as TCP

    out = {}
    for kind, kw in KINDS.items():
        p = str(tmp_path_factory.mktemp(kind) / "m.gguf")
        make_tiny_llama_gguf(p, **{"n_embd": 64, "n_ff": 256, "n_layer": 2, "seed": 41, **kw})
        pk = {} if kind != "q4k" else dict(packed=True)
        jm = j_load(p, **pk, **({"packed_scale_dtype": np.float32} if pk else {}))
        tm = t_load(p, device="cpu", **pk, **({"packed_scale_dtype": torch.float32} if pk else {}))
        out[kind] = (p, JC(jm, JCP(n_ctx=64, n_seqs=2)), TC(tm, TCP(n_ctx=64, n_seqs=2)))
    return out


def _tokens(vocab, which):
    # "" tokenizes to the BOS alone: a one-token prompt
    return vocab.tokenize(PROMPTS[which], add_special=True)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("which", sorted(PROMPTS))
@pytest.mark.parametrize("pooling", POOLINGS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_embeddings_are_the_reference(models, kind, pooling, which, normalize):
    _, jc, tc = models[kind]
    tm = tc.model
    toks = _tokens(tm.vocab, which)
    assert (len(toks) == 1) == (which == "one")
    # lane 1, after a generation there that embeddings must reset
    for c in (jc, tc):
        c.decode(np.asarray(toks + [5, 6]), seq_id=1)
    ej = jc.embeddings(toks, pooling=pooling, seq_id=1, normalize=normalize)
    et = tc.embeddings(toks, pooling=pooling, seq_id=1, normalize=normalize)
    assert et.shape == ej.shape == ((len(toks), tm.hparams.n_embd) if pooling == "none"
                                    else (tm.hparams.n_embd,))
    assert np.abs(et - ej).max() <= 1e-5 * np.abs(ej).max()
    np.testing.assert_array_equal(tc.n_past, jc.n_past)
    if normalize and pooling != "none":
        assert abs(np.linalg.norm(et) - 1.0) < 1e-5


def test_unknown_pooling_is_refused(models):
    from tpullama_torch.runtime import Context, ContextParams

    tm = models["dense"][2].model
    with pytest.raises(ValueError, match="rank"):
        Context(tm, ContextParams(n_ctx=64)).embeddings([1, 2], pooling="rank")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("embeddings on the card need a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(PROMPTS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_card_embeddings_match_the_cpu(cuda, models, kind, which):
    """The card's embeddings for each pooling, one token included (the
    eager step with hidden states, never the step program's graph)."""
    from tpullama_torch.models import load_model
    from tpullama_torch.runtime import Context, ContextParams

    path, _, tc = models[kind]
    tm = tc.model
    pk = {} if kind != "q4k" else dict(packed=True, packed_scale_dtype=torch.float32)
    gm = load_model(path, device="cuda", **pk)
    toks = _tokens(tm.vocab, which)
    g, c = Context(gm, ContextParams(n_ctx=64)), Context(tm, ContextParams(n_ctx=64))
    for pooling in POOLINGS:
        eg, ec = g.embeddings(toks, pooling=pooling), c.embeddings(toks, pooling=pooling)
        assert np.isfinite(eg).all() and eg.shape == ec.shape
        assert np.abs(eg - ec).max() <= 1e-4 * np.abs(ec).max()
    assert not g._programs  # no one-token step program was built
