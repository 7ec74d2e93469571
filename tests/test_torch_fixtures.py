"""The port's fixture helpers (tests/_torch_fixtures.py) change no byte:
the cumsum column sum equals the quantizer's sequential loop bit for bit
(zeros, negative zeros, cancellations and mixed magnitudes included),
every K-quant the quantizer writes with it swapped in equals its own
blocks, and a file from the run-wide cache equals one written directly
by make_tiny_llama_gguf, also when the cache is asked twice."""

import filecmp

import numpy as np
import pytest

from tests._torch_fixtures import quick_seqsum, seqsum_cumsum, tiny_gguf
from tpullama.gguf import GGMLType
from tpullama.gguf import quants as jq
from tpullama.gguf.quants import quantize
from tpullama.models.testing import make_tiny_llama_gguf


def _rows(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((4096, 32)) * 10.0 ** rng.integers(-8, 8, (4096, 1)))
    a = a.astype(np.float32)
    a[:64] = -0.0
    a[64:128] = 0.0
    a[128:192, ::2] = -0.0
    a[192:256, 1::2] = -a[192:256, ::2]  # exact cancellations
    return a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cumsum_is_the_sequential_sum(seed):
    a = _rows(seed)
    np.testing.assert_array_equal(seqsum_cumsum(a).view(np.uint32),
                                  jq._seqsum_f32(a).view(np.uint32))


# every type of tpullama/gguf/quants.py the port's fixtures quantize (Q2_K
# and Q3_K have no quantizer: their fixtures draw random blocks; IQ3_S is
# iq_encode's, which has its own sums)
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q4_0,
                                   GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0, GGMLType.IQ4_XS,
                                   GGMLType.TQ2_0],
                         ids=lambda t: t.name)
def test_quantized_blocks_are_the_same(qtype):
    rng = np.random.default_rng(qtype.value)
    w = (rng.standard_normal((32, 512)) / 16).astype(np.float32)
    w[0] = 0.0
    want = quantize(w, qtype)
    loop = jq._seqsum_f32
    with quick_seqsum():
        assert jq._seqsum_f32 is not loop
        got = quantize(w, qtype)
    assert jq._seqsum_f32 is loop
    np.testing.assert_array_equal(got, want)


def test_cached_file_is_the_writers_file(tmp_path_factory, tmp_path):
    kw = dict(n_embd=256, n_ff=256, n_layer=1, qtype=GGMLType.Q4_K, seed=99)
    direct = str(tmp_path / "direct.gguf")
    make_tiny_llama_gguf(direct, **kw)
    cached = tiny_gguf(tmp_path_factory, **kw)
    assert filecmp.cmp(cached, direct, shallow=False)
    assert tiny_gguf(tmp_path_factory, **dict(reversed(kw.items()))) == cached
    assert tiny_gguf(tmp_path_factory, **dict(kw, seed=98)) != cached
