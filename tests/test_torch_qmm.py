"""The port's quantized matmul (tpullama_torch/ops/cuda/qmm.py) held against
the JAX package: its plain version against quantized_matmul(...,
interpret=True) in the exact f32 mode, and against the numpy oracle
dequant_planar_np(W) @ x, for every packed type at T in {1, 5, 33}, on the
same planes. The CUDA kernel itself runs only on the card (marked cuda).

Tolerances: the plain version dequantizes exactly (q*scale - minv in f32,
as the exact mode does) and sums in f32 in another order than XLA and
numpy, so it differs by f32 accumulation noise only:
atol = 1e-4 + 1e-6 * max|y|, rtol = 1e-5 (the JAX package's own qmm test)."""

import numpy as np
import pytest
import torch

from tpullama.gguf import GGMLType, dequantize, quantize
from tpullama.gguf.constants import GGML_TYPE_TRAITS
from tpullama.ops.qweights import PACKED_TYPES, dequant_planar_np, group_permute, repack
from tpullama_torch.ops.cuda import qmm

TYPES = sorted(PACKED_TYPES, key=lambda t: t.value)
N_OUT, N_IN = 8, 512


def _planes(qtype, seed=0):
    rng = np.random.default_rng(seed)
    if qtype in (GGMLType.Q2_K, GGMLType.Q3_K):
        # no quantizer in the JAX package: random blocks with finite fp16 scales
        traits = GGML_TYPE_TRAITS[qtype]
        raw = rng.integers(0, 256, N_OUT * N_IN // traits.block_size * traits.type_size,
                           dtype=np.uint8)
        blocks = raw.reshape(-1, traits.type_size)
        blocks[:, -1] &= 0x3F
        if qtype == GGMLType.Q2_K:
            blocks[:, -3] &= 0x3F
    else:
        raw = quantize(rng.standard_normal((N_OUT, N_IN)).astype(np.float32), qtype)
    ref = dequantize(raw, qtype, (N_OUT, N_IN)).reshape(N_OUT, N_IN)
    return repack(raw, qtype, (N_OUT, N_IN)), ref


def _tol(want):
    return dict(rtol=1e-5, atol=1e-4 + 1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("T", [1, 5, 33])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_plain_matches_jax_exact(qtype, T):
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul as jax_qmm

    pq, ref_w = _planes(qtype, seed=T)
    x = np.random.default_rng(100 + T).standard_normal((T, N_IN)).astype(np.float32)
    fields_t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in pq.fields.items()}
    got = qmm.quantized_matmul(torch.from_numpy(x), fields_t, qtype, pq.group, N_OUT, N_IN)
    assert got.dtype == torch.float32 and got.shape == (T, N_OUT)
    got = got.numpy()
    want_jax = np.asarray(jax_qmm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in pq.fields.items()},
                                  qtype, pq.group, N_OUT, N_IN, tile_n=8, interpret=True))
    np.testing.assert_allclose(got, want_jax, **_tol(want_jax))
    # the numpy oracle: exact dequantization of the planes, then x @ W^T
    np.testing.assert_array_equal(dequant_planar_np(pq), ref_w)
    want = x @ dequant_planar_np(pq).T
    np.testing.assert_allclose(got, want, **_tol(want))


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_plain_bf16_inputs(qtype):
    """bf16 activations and bf16 scale planes (the serving path's types):
    the plain version computes in f32 on the bf16 values, as the JAX
    package does (it casts x to f32 first)."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul as jax_qmm

    pq, _ = _planes(qtype, seed=7)
    x = np.random.default_rng(8).standard_normal((4, N_IN)).astype(np.float32)
    x_bf = torch.from_numpy(x).to(torch.bfloat16)
    fields_t = {k: (torch.from_numpy(v).to(torch.bfloat16) if k in ("scale", "minv")
                    else torch.from_numpy(v)) for k, v in pq.fields.items()}
    got = qmm.quantized_matmul(x_bf, fields_t, qtype, pq.group, N_OUT, N_IN).numpy()
    fields_j = {k: (jnp.asarray(v).astype(jnp.bfloat16) if k in ("scale", "minv")
                    else jnp.asarray(v)) for k, v in pq.fields.items()}
    want = np.asarray(jax_qmm(jnp.asarray(x).astype(jnp.bfloat16), fields_j, qtype, pq.group,
                              N_OUT, N_IN, tile_n=8, interpret=True))
    np.testing.assert_allclose(got, want, **_tol(want))


@pytest.mark.parametrize("g", [16, 32])
def test_permute_x_is_group_permute(g):
    x = np.random.default_rng(9).standard_normal((3, 256)).astype(np.float32)
    np.testing.assert_array_equal(qmm.permute_x(torch.from_numpy(x), g).numpy(),
                                  group_permute(x, g))


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_dequant_stored_matches_oracle(qtype):
    pq, _ = _planes(qtype, seed=11)
    fields_t = {k: torch.from_numpy(v) for k, v in pq.fields.items()}
    w = qmm.dequant_stored(fields_t, qtype, pq.group).numpy()
    nat = w.reshape(N_OUT, pq.group, N_IN // pq.group).swapaxes(1, 2).reshape(N_OUT, N_IN)
    np.testing.assert_array_equal(nat, dequant_planar_np(pq))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the qmm kernel runs on a CUDA card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4, 9, 64])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_kernel_matches_plain(cuda, qtype, T):
    """The kernel sums in f32 in another order: 1e-4 of the output's scale."""
    rng = np.random.default_rng(T)
    n_out, n_in = 256, 1024
    raw = quantize(rng.standard_normal((n_out, n_in)).astype(np.float32), qtype)
    pq = repack(raw, qtype, (n_out, n_in))
    x = torch.from_numpy(rng.standard_normal((T, n_in)).astype(np.float32)).to(cuda)
    for sdt in (torch.float32, torch.bfloat16):
        fields = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
                  for k, v in pq.fields.items()}
        for xx in (x, x.to(torch.bfloat16)):
            before = dict(qmm.LAUNCHES)
            got = qmm.quantized_matmul(xx, fields, qtype, pq.group, n_out, n_in)
            want = qmm.quantized_matmul_plain(xx, fields, qtype, pq.group, n_out, n_in)
            assert sum(qmm.LAUNCHES.values()) == sum(before.values()) + 1
            tol = 1e-4 * float(want.abs().max())
            assert float((got - want).abs().max()) <= tol
