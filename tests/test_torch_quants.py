"""The port's GGUF codecs and native host library (tpullama_torch.gguf.quants,
iq_encode, _iq_grids; tpullama_torch.native) equal the JAX package's: every
dequantizer on block bytes drawn from a seed, every quantizer byte for
byte on seeded f32 arrays (the IQ encoders included), the native
dequantize and repack against the JAX package's numpy codecs, and a model
loaded with native=False against one loaded with the native library. All
comparisons are exact: the copies run the same code, and the native
library computes each value with the same f32 operations (NaN where the
random fp16 scales are NaN, in the same places)."""

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.gguf import quants as j_quants
from tpullama.gguf.constants import GGML_TYPE_TRAITS, GGMLType
from tpullama.models.testing import make_tiny_llama_gguf
from tpullama.ops import qweights as j_qw
from tpullama_torch import native as t_native
from tpullama_torch.gguf import quants as t_quants
from tpullama_torch.models import load_model

DEQ_TYPES = sorted(j_quants.DEQUANT_FNS, key=lambda t: t.value)
QUANT_TYPES = sorted(set(j_quants.QUANT_FNS) | set(j_quants._IQ_ENCODERS), key=lambda t: t.value)


def _blocks(qtype, n_blocks, seed):
    """n_blocks random blocks of qtype (any bytes: fp16 scales may be inf or
    NaN, which both codecs decode alike)."""
    ts = GGML_TYPE_TRAITS[qtype].type_size
    return np.random.default_rng(seed).integers(0, 256, n_blocks * ts, dtype=np.uint8)


def _finite_blocks(qtype, n_blocks, seed):
    """Random blocks whose fp16 scales are finite, as a quantizer writes
    them (the native library's sums need finite scales to equal numpy's
    bit for bit only where both are finite)."""
    b = _blocks(qtype, n_blocks, seed).reshape(n_blocks, -1)
    ts = b.shape[1]
    fp16 = {GGMLType.Q4_0: [0], GGMLType.Q4_1: [0, 2], GGMLType.Q5_0: [0],
            GGMLType.Q5_1: [0, 2], GGMLType.Q8_0: [0], GGMLType.Q2_K: [ts - 4, ts - 2],
            GGMLType.Q3_K: [ts - 2], GGMLType.Q4_K: [0, 2], GGMLType.Q5_K: [0, 2],
            GGMLType.Q6_K: [ts - 2]}.get(qtype, [])
    rng = np.random.default_rng(seed + 1)
    for o in fp16:
        b[:, o:o + 2] = (rng.uniform(-0.05, 0.05, n_blocks).astype("<f2")
                         .view(np.uint8).reshape(n_blocks, 2))
    return b.reshape(-1)


@pytest.mark.parametrize("qtype", DEQ_TYPES, ids=lambda t: t.name)
def test_dequantize_equals_original(qtype):
    raw = _blocks(qtype, 24, seed=qtype.value)
    bs = GGML_TYPE_TRAITS[qtype].block_size
    got = t_quants.dequantize(raw, qtype, (2, 12 * bs))
    want = j_quants.dequantize(raw, qtype, (2, 12 * bs))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_dequant_table_is_the_originals():
    assert set(t_quants.DEQUANT_FNS) == set(j_quants.DEQUANT_FNS)
    assert set(t_quants.QUANT_FNS) == set(j_quants.QUANT_FNS)
    assert t_quants._IQ_ENCODERS == j_quants._IQ_ENCODERS


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "imatrix"])
@pytest.mark.parametrize("qtype", QUANT_TYPES, ids=lambda t: t.name)
def test_quantize_equals_original(qtype, weighted):
    """Byte for byte on seeded rows, with and without importance weights
    (the IQ encoders and the weighted K-quant fits read them)."""
    rng = np.random.default_rng(100 + qtype.value)
    x = rng.standard_normal((2, 256)).astype(np.float32)
    qw = rng.uniform(0.1, 2.0, 256).astype(np.float32) if weighted else None
    got = t_quants.quantize(x, qtype, qw)
    want = j_quants.quantize(x, qtype, qw)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_iq_grids_equal_original():
    from tpullama.gguf import _iq_grids as j_grids
    from tpullama_torch.gguf import _iq_grids as t_grids

    names = [n for n in dir(j_grids) if n.endswith("_GRID")]
    assert names and names == [n for n in dir(t_grids) if n.endswith("_GRID")]
    for n in names:
        np.testing.assert_array_equal(getattr(t_grids, n), getattr(j_grids, n))


@pytest.fixture(scope="module")
def lib():
    lib = t_native.get_lib()
    if lib is None:
        pytest.fail("the native library did not build (g++ -O3 -fopenmp)")
    return lib


@pytest.mark.parametrize("qtype", sorted(t_native._NATIVE_DEQ_TYPES, key=lambda t: t.value),
                         ids=lambda t: t.name)
def test_native_dequantize_equals_numpy(lib, qtype):
    raw = _finite_blocks(qtype, 40, seed=qtype.value)
    n = 40 * GGML_TYPE_TRAITS[qtype].block_size
    got = t_native.native_dequantize(raw, qtype, n)
    np.testing.assert_array_equal(got, j_quants.dequantize(raw, qtype))


@pytest.mark.parametrize("K", [256, 1024])
@pytest.mark.parametrize("qtype", sorted(t_native._NATIVE_REPACK_TYPES, key=lambda t: t.value),
                         ids=lambda t: t.name)
def test_native_repack_equals_numpy(lib, qtype, K):
    n_rows = 6
    raw = _finite_blocks(qtype, n_rows * K // GGML_TYPE_TRAITS[qtype].block_size,
                         seed=K + qtype.value)
    fields, group = t_native.native_repack(raw, qtype, n_rows, K)
    want = j_qw.repack(raw, qtype, (n_rows, K))
    assert group == want.group and set(fields) == set(want.fields)
    for k, v in want.fields.items():
        assert fields[k].dtype == v.dtype, k
        np.testing.assert_array_equal(fields[k], v)


def test_native_switch(monkeypatch):
    """load_model's native= defaults to the TPULLAMA_NO_NATIVE variable."""
    monkeypatch.delenv("TPULLAMA_NO_NATIVE", raising=False)
    assert t_native.resolve_native(None) is True
    monkeypatch.setenv("TPULLAMA_NO_NATIVE", "1")
    assert t_native.resolve_native(None) is False
    assert t_native.resolve_native(True) is True


def _flat(params, pre=""):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q5_1, GGMLType.Q5_K, GGMLType.Q6_K,
                                   GGMLType.IQ4_XS], ids=lambda t: t.name)
def test_load_without_native_equals_native(tmp_path, lib, qtype, packed):
    """A model loaded through the numpy codecs equals one loaded through the
    native library, every parameter bit for bit."""
    p = str(tmp_path / "m.gguf")
    make_tiny_llama_gguf(p, qtype=qtype, n_embd=256, n_ff=512, seed=qtype.value)
    a = _flat(load_model(p, device="cpu", packed=packed, native=True).params)
    b = _flat(load_model(p, device="cpu", packed=packed, native=False).params)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_numpy_load_in_row_batches_equals_native(tmp_path, lib, monkeypatch, packed):
    """The numpy path decodes and repacks large matrices in row batches on
    the host's threads (loader._DENSE_ELEMS values a batch): with batches
    of a few rows, so that every matrix splits (one of them unevenly), the
    parameters equal the native library's bit for bit."""
    from tpullama_torch.models import loader

    p = str(tmp_path / "m.gguf")
    make_tiny_llama_gguf(p, qtype=GGMLType.Q5_K, n_embd=256, n_ff=512, seed=4)
    a = _flat(load_model(p, device="cpu", packed=packed, native=True).params)
    monkeypatch.setattr(loader, "_DENSE_ELEMS", 256 * 48)
    b = _flat(load_model(p, device="cpu", packed=packed, native=False).params)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
