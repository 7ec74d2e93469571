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


def _split_bf16(a):
    """hi = bf16(a) and lo = bf16(a - hi), both as f32 values."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _split_product(x, w):
    """x @ w.T as the tensor-core routes (csrc/qmm_mma.cuh) compute it: w
    split into bf16 hi + lo, x too when it is f32, then hi*hi + hi*lo +
    lo*hi summed in f32 (hi_w*x + lo_w*x for bf16 x). Every product of two
    bf16 values is exact in f32."""
    wh, wl = _split_bf16(w)
    if x.dtype == torch.bfloat16:
        xf = x.float()
        return xf @ wh.T + xf @ wl.T
    xh, xl = _split_bf16(x)
    return xh @ wh.T + xh @ wl.T + xl @ wh.T


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16], ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("K", [1024, 4096, 14336])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_bf16_split_product_is_within_kernel_tolerance(qtype, K, xdt):
    """The split the tensor-core routes use keeps the product of the plain
    version's weights within the kernels' tolerance, 1e-4 of the output's
    max plus 1e-5, of the exact (f64) product; one bf16 pass of the weight
    does not."""
    rng = np.random.default_rng(K + qtype.value)
    n_out, T = 16, 8
    raw = quantize(rng.standard_normal((n_out, K)).astype(np.float32), qtype)
    pq = repack(raw, qtype, (n_out, K))
    w = qmm.dequant_stored({k: torch.from_numpy(v) for k, v in pq.fields.items()}, qtype,
                           pq.group)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(xdt)
    exact = x.double() @ w.double().T
    tol = 1e-4 * float(exact.abs().max()) + 1e-5
    err = float((_split_product(x, w).double() - exact).abs().max())
    assert err <= tol
    one_pass = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T
    assert float((one_pass.double() - exact).abs().max()) > tol


# ------------------------------------------- the group-scaled tile body


def _group_case(qtype, K, layout, seed):
    """16 random rows of K repacked in `layout`: "stripe", "fourblock"
    (to_fourblock) or "transposed" (stripe planes through the port's
    transpose_planes, as the gathered kernel reads them)."""
    from tpullama.ops.qweights import to_fourblock
    from tpullama_torch.ops.qweights import transpose_planes

    rng = np.random.default_rng(seed)
    raw = quantize(rng.standard_normal((16, K)).astype(np.float32), qtype)
    pq = repack(raw, qtype, (16, K))
    if layout == "fourblock":
        pq = to_fourblock(pq)
    fields = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in pq.fields.items()}
    planes = (fields if layout != "transposed" else
              {k: torch.from_numpy(v) for k, v in transpose_planes(pq.fields).items()})
    return pq, fields, planes, rng


def _column_ints(planes, qtype, K, transposed):
    """The quantized integers q[n, c, a] of every scale column c of every
    row, gathered from the packed planes by the group body's byte table
    (csrc/qmm_group_mma.cuh): with G = K/g, column c's bytes sit at c + jG
    of each plane. Q4: a < 16 the low nibble of byte c + aG, a >= 16 the
    high nibble of byte c + (a-16)G; Q6: nib(q4[c + (a%8)G], a//8) |
    crumb(q2[c + (a%4)G], a//4) << 4; Q8: the signed byte c + aG."""
    g = 16 if qtype == GGMLType.Q6_K else 32
    G = K // g

    def run(name, n):  # (N, G, n): plane byte c + jG, j < n
        p = planes[name]
        p = p.T if transposed else p
        return p[:, :n * G].reshape(p.shape[0], n, G).transpose(1, 2).to(torch.int32)

    if qtype == GGMLType.Q8_0:
        return run("q8", 32).to(torch.uint8).view(torch.int8).to(torch.int32)
    if qtype == GGMLType.Q6_K:
        q4, q2 = run("q4", 8), run("q2", 4)
        a = torch.arange(16)
        return (((q4[..., a % 8] >> (4 * (a // 8))) & 15)
                | (((q2[..., a % 4] >> (2 * (a // 4))) & 3) << 4))
    b = run("q4", 16)
    return torch.cat([b & 15, b >> 4], dim=-1)


def _column_scales(planes, name, G, transposed):
    p = planes[name]
    return (p[:G].T if transposed else p).float()


def _column_groups(K, g, layout):
    """nu(c): the natural group of scale column c (fourblock_scale_perm in
    fourblock order, c itself otherwise)."""
    c = torch.arange(K // g)
    if layout == "fourblock":
        R = K // 128
        return (c % R) * (128 // g) + c // R
    return c


def _group_scaled_product(x, planes, qtype, K, layout, sdt):
    """y = x @ W^T as the group body computes it: the raw integers (exact
    in bf16) times x (bf16, or f32 split into bf16 hi + lo) summed per
    scale column in f32, scaled once per column, and the min term
    minv . xgsum (xgsum: f32 sums of x's natural groups) as the body's
    tensor-core epilogue takes it, both split into bf16 hi/lo."""
    g = 16 if qtype == GGMLType.Q6_K else 32
    G, T = K // g, x.shape[0]
    tr = layout == "transposed"
    q = _column_ints(planes, qtype, K, tr).float()
    assert torch.equal(q.to(torch.bfloat16).float(), q)  # exact in bf16
    xc = x.float().reshape(T, G, g)[:, _column_groups(K, g, layout)]  # (T, c, a)
    parts = [xc] if x.dtype == torch.bfloat16 else list(_split_bf16(xc))
    col = sum(torch.einsum("nca,tca->tnc", q, p) for p in parts)  # f32 column sums
    s = _column_scales(planes, "scale", G, tr).to(sdt).float()
    y = (col * s).sum(-1)
    if "minv" in planes:
        m = _column_scales(planes, "minv", G, tr).to(sdt).float()
        xgsum = xc.sum(-1)
        mh, ml = _split_bf16(m)
        xh, xl = _split_bf16(xgsum)
        y = y - (xh @ mh.T + xl @ mh.T + xh @ ml.T)
    return y


_GROUP_LAYOUTS = [(qt, "stripe") for qt in (GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0)] + [
    (GGMLType.Q4_K, "fourblock"), (GGMLType.Q4_K, "transposed"),
    (GGMLType.Q8_0, "transposed")]


@pytest.mark.parametrize("qtype,layout", _GROUP_LAYOUTS,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_group_byte_table_matches_stored_positions(qtype, layout):
    """The byte table's integer q[n, c, a], scaled as q * scale[c] -
    minv[c], is dequant_stored's weight at stored position c + aG, bit
    for bit, in every layout the group body reads."""
    K = 1024
    pq, fields, planes, _ = _group_case(qtype, K, layout, seed=5)
    g, G = pq.group, K // pq.group
    w = qmm.dequant_stored(fields, qtype, g)  # (N, K) stored order
    q = _column_ints(planes, qtype, K, layout == "transposed").float()
    s = _column_scales(planes, "scale", G, layout == "transposed")[..., None]
    got = q * s
    if "minv" in planes:
        got = got - _column_scales(planes, "minv", G, layout == "transposed")[..., None]
    c, a = torch.meshgrid(torch.arange(G), torch.arange(g), indexing="ij")
    assert torch.equal(got, w[:, c + a * G])


_GROUP_CASES = [(qt, lay, K, xdt) for qt, lay in _GROUP_LAYOUTS for K in (1024, 4096, 14336)
                for xdt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("qtype,layout,K,xdt", _GROUP_CASES,
                         ids=lambda v: getattr(v, "name", str(v)).replace("torch.", ""))
def test_group_scaled_product_is_within_kernel_tolerance(qtype, layout, K, xdt):
    """The group body's arithmetic (raw integers on the tensor cores, a
    scale per column, the min term apart) against the exact (f64) product
    of the plain version's weights: within the kernels' tolerance, 1e-4 of
    the output's max plus 1e-5, with f32 and with bf16 scales."""
    pq, fields, planes, rng = _group_case(qtype, K, layout, seed=K + qtype.value)
    x = torch.from_numpy(rng.standard_normal((8, K)).astype(np.float32)).to(xdt)
    order = "fourblock" if layout == "fourblock" else "stripe"
    for sdt in (torch.float32, torch.bfloat16):
        fs = {k: (v.to(sdt) if k in ("scale", "minv") else v) for k, v in fields.items()}
        ps = {k: (v.to(sdt) if k in ("scale", "minv") else v) for k, v in planes.items()}
        w = qmm.dequant_stored(fs, qtype, pq.group).double()
        exact = qmm.permute_x(x.double(), pq.group, order) @ w.T
        tol = 1e-4 * float(exact.abs().max()) + 1e-5
        got = _group_scaled_product(x, ps, qtype, K, layout, sdt)
        assert float((got.double() - exact).abs().max()) <= tol


# ------------------------------------------------- the decode body (gemv)


def _gemv_stage(xc, g, c0, width):
    """The kernel's staging rule (gv_stage): columns [c0, c0 + width) of x
    in column order (T, K) -> the slice xs[t, a, c - c0] = xc[t, c*g + a],
    f32, zero past the row's K/g columns."""
    T, K = xc.shape
    G = K // g
    cols = xc.float().reshape(T, G, g)[:, c0:c0 + width]
    out = torch.zeros((T, g, width))
    out[:, :, :cols.shape[1]] = cols.transpose(1, 2)
    return out


def _gemv_values(planes, qtype, K):
    """The integers q[n, c, a] as the decode body makes them: the 4-byte
    word of a class (columns 4k ..) at a-row j of each plane, bytes shifted
    and masked as 4 lanes of a 32-bit word, each byte placed in the
    mantissa of 2^23 (bytes 0x00 0x00 0x4B above it) and 2^23 (Q8_0: +
    128) taken off. Ragged classes read 0 past the row's columns."""
    g = 16 if qtype == GGMLType.Q6_K else 32
    G = K // g
    W = -(-G // 4) * 4

    def rows(name, n):  # (N, n, W) uint32 byte lanes of a-rows j < n, zero padded
        p = planes[name].numpy().view(np.uint8).astype(np.uint32)[:, :n * G].reshape(-1, n, G)
        return np.pad(p, ((0, 0), (0, 0), (0, W - G)))

    if qtype == GGMLType.Q4_K or qtype == GGMLType.Q4_0:
        b = rows("q4", 16)
        v = np.concatenate([b & 0x0F, (b >> 4) & 0x0F], axis=1)  # a < 16 low, else high
        bias = 2.0 ** 23
    elif qtype == GGMLType.Q6_K:
        lo, cr = rows("q4", 8), rows("q2", 4)
        v = []
        for a in range(16):
            i = a // 4
            up = cr[:, a % 4] << (4 - 2 * i) if i < 2 else cr[:, a % 4] >> (2 * i - 4)
            v.append(((lo[:, a % 8] >> (0 if a < 8 else 4)) & 0x0F) | (up & 0x30))
        v = np.stack(v, axis=1)
        bias = 2.0 ** 23
    else:
        v = rows("q8", 32) ^ 0x80  # b + 128
        bias = 2.0 ** 23 + 128
    f = (np.uint32(0x4B000000) | v.astype(np.uint32)).view(np.float32)
    q = torch.from_numpy((f - np.float32(bias)).astype(np.float32))  # (N, g, W)
    return q.transpose(1, 2)[:, :G]


def _gemv_emulated(x, planes, qtype, K, order, chunk=None):
    """y = x @ W^T as the decode body computes it, in f32: the integers of
    each scale column (_gemv_values, the byte rule c + jG) times the staged
    x, summed per (row, x row, column) in the body's step order (Q4: a = j
    then j + 16 for j < 16; Q6_K: j then j + 8 for j < 8; Q8_0: a in
    order); each
    column folded once as part += scale * sum, part -= minv * sum_a x, a
    lane's columns in class order (classes lane, lane + 16, ... of 4
    columns); the 16 lanes' parts added by a butterfly. chunk = (k, nk):
    qmm_ktiled's block of K-chunk k, the byte rows j in [k J / nk, (k + 1)
    J / nk) of each column alone (J = 16 q4 rows, 32 q8 rows; GvRows), the
    min term in chunk 0 alone."""
    g = 16 if qtype == GGMLType.Q6_K else 32
    G, T = K // g, x.shape[0]
    NC = -(-G // 4)
    L = 16
    q = _gemv_values(planes, qtype, K)  # (N, G, g)
    assert torch.equal(q, _column_ints(planes, qtype, K, False).float())
    xs = _gemv_stage(qmm.column_x(x, g, order), g, 0, 4 * NC)  # (T, g, 4 NC)
    acc = torch.zeros((q.shape[0], T, G))
    xsum = torch.zeros((T, 4 * NC))
    steps = {GGMLType.Q6_K: [(j, j + 8) for j in range(8)],
             GGMLType.Q8_0: [(a,) for a in range(32)]}.get(qtype,
                                                          [(j, j + 16) for j in range(16)])
    if chunk is not None:
        k, nk = chunk
        steps = steps[len(steps) * k // nk:len(steps) * (k + 1) // nk]
    for a in (a for step in steps for a in step):
        acc = acc + q[:, None, :, a] * xs[None, :, a, :G]
    for a in range(g):
        xsum = xsum + xs[:, a]
    s = planes["scale"].float()
    m = planes["minv"].float() if "minv" in planes and (chunk is None or chunk[0] == 0) else None
    part = torch.zeros((L, q.shape[0], T))
    for k in range(NC):
        for c in range(4 * k, min(4 * k + 4, G)):
            part[k % L] = part[k % L] + s[:, c, None] * acc[:, :, c]
            if m is not None:
                part[k % L] = part[k % L] - m[:, c, None] * xsum[None, :, c]
    o = L // 2
    while o:
        part = part + part[torch.arange(L) ^ o]
        o //= 2
    return part[0].T


# every qtype at the loader's widths (K = 768: 6 classes of 4 columns for
# Q4/Q8_0, 12 for Q6_K, fewer than the 16 lanes of a row), then rows whose last
# class is ragged (K/g % 4 != 0: 17 and 25 columns)
_GEMV_CASES = [(qt, K) for qt in (GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0)
               for K in (768, 4096, 8960)] + [(GGMLType.Q4_0, 544), (GGMLType.Q8_0, 800)]


@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("qtype,K", _GEMV_CASES, ids=lambda v: getattr(v, "name", str(v)))
def test_gemv_column_arithmetic_is_within_kernel_tolerance(qtype, K, T):
    """The decode body's arithmetic (integers summed per scale column, one
    scale per column, the min term from staged column sums, the lanes'
    order) against the plain version and the JAX package's exact path:
    within the kernels' tolerance, 1e-4 of the output's max plus 1e-5, with
    f32 and with bf16 x and scales."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul as jax_qmm

    pq, x = _chunk_case(qtype, 16, K, T, seed=K + T + qtype.value)
    for dt in (torch.float32, torch.bfloat16):
        fields = {k: torch.from_numpy(v).to(dt if k in ("scale", "minv") else None)
                  for k, v in pq.fields.items()}
        xt = torch.from_numpy(x).to(dt)
        got = _gemv_emulated(xt, fields, qtype, K, "stripe")
        want = qmm.quantized_matmul_plain(xt, fields, qtype, pq.group, 16, K)
        tol = 1e-4 * float(want.abs().max()) + 1e-5
        assert float((got - want).abs().max()) <= tol
        jf = {k: (jnp.asarray(v).astype(jnp.bfloat16) if dt == torch.bfloat16
                  and k in ("scale", "minv") else jnp.asarray(v)) for k, v in pq.fields.items()}
        jx = jnp.asarray(x).astype(jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32)
        want_jax = torch.from_numpy(np.array(
            jax_qmm(jx, jf, qtype, pq.group, 16, K, tile_n=8, interpret=True)))
        assert float((got - want_jax).abs().max()) <= tol


@pytest.mark.parametrize("nk", [2, 4, 8])
@pytest.mark.parametrize("T", [1, 4, 8])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0], ids=lambda t: t.name)
def test_ktiled_chunk_arithmetic_is_within_kernel_tolerance(qtype, T, nk):
    """qmm_ktiled at T <= 8: the decode body over each K-chunk's byte rows
    (_gemv_emulated with chunk=(k, nk), the min term in chunk 0 alone), the
    nk partials summed in chunk order. Against the plain K-chunked product
    and the JAX package's exact path within the kernels' tolerance, 1e-4 of
    the output's max plus 1e-5; against its _qmm_ktiled (interpret), which
    rounds x and the weights to bf16 (qmm.py:489-498), within 1e-2 of the
    output's max, as test_plain_ktiled_matches_jax_and_untiled holds it."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul as jax_qmm

    n_out, K = 16, 4096
    pq, x = _chunk_case(qtype, n_out, K, T, seed=200 + 10 * T + nk)
    fields = {k: torch.from_numpy(v) for k, v in pq.fields.items()}
    assert qmm.kchunks_valid(nk, K, pq.group, fields)
    xt = torch.from_numpy(x)
    got = None
    for k in range(nk):
        part = _gemv_emulated(xt, fields, qtype, K, "stripe", chunk=(k, nk))
        got = part if got is None else got + part
    want = qmm.quantized_matmul_ktiled_plain(xt, fields, qtype, pq.group, n_out, K, nk)
    tol = 1e-4 * float(want.abs().max()) + 1e-5
    assert float((got - want).abs().max()) <= tol
    jf = {k: jnp.asarray(v) for k, v in pq.fields.items()}
    exact = torch.from_numpy(np.array(jax_qmm(jnp.asarray(x), jf, qtype, pq.group, n_out, K,
                                              tile_n=8, interpret=True)))
    assert float((got - exact).abs().max()) <= tol
    fast = torch.from_numpy(np.array(jax_qmm(jnp.asarray(x), jf, qtype, pq.group, n_out, K,
                                             interpret=True, exact=False, tile_k_chunks=nk)))
    assert float((got - fast).abs().max()) <= 1e-2 * float(fast.abs().max())


@pytest.mark.parametrize("order,g", [("stripe", 32), ("stripe", 16), ("fourblock", 32)])
def test_gemv_stages_stored_order(order, g):
    """The staging rule lays x out in stored order: from x in column order
    (column_x: x itself for stripe planes), slice after slice of 4-column
    classes, xs[t, a, c - c0] is stored position a*G + c of permute_x(x),
    the order the planes' bytes meet."""
    K = 4096
    x = torch.from_numpy(np.random.default_rng(g).standard_normal((3, K)).astype(np.float32))
    stored = qmm.permute_x(x, g, order).reshape(3, g, K // g)
    xc = qmm.column_x(x, g, order)
    if order == "stripe":
        assert xc.data_ptr() == x.data_ptr()  # read in place
    for width in (4, 128, K // g):
        for c0 in range(0, K // g, width):
            assert torch.equal(_gemv_stage(xc, g, c0, width), stored[:, :, c0:c0 + width])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the qmm kernel runs on a CUDA card only")
    return torch.device("cuda")


@pytest.mark.parametrize("order", ["stripe", "fourblock"])
def test_column_x_is_the_group_body_order(order):
    """column_x lays x out by scale column: block c holds natural group
    nu(c) (the emulation's _column_groups), for both stored orders."""
    K = 1024
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((3, K)).astype(np.float32))
    want = x.reshape(3, K // 32, 32)[:, _column_groups(K, 32, order)].reshape(3, K)
    assert torch.equal(qmm.column_x(x, 32, order), want)


def test_routes():
    """qmm_tiled and qmm_ktiled run a tensor-core body above 8 rows and the
    decode body up to 8; qmm_gemv always the latter."""
    assert [qmm.route("qmm_tiled", T) for T in (9, 256, 1024)] == ["mma"] * 3
    assert [qmm.route("qmm_ktiled", T) for T in (9, 256)] == ["mma"] * 2
    assert [qmm.route(k, T) for k in ("qmm_tiled", "qmm_ktiled", "qmm_gemv")
            for T in (1, 8)] == ["gemv"] * 6
    assert qmm.route("qmm_gemv", 1024) == "gemv"


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 8, 9, 64, 256, 1024])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_kernel_matches_plain(cuda, qtype, T):
    """The kernel sums in f32 in another order (T > 8: the group body's
    integer products and column scales): 1e-4 of the output's scale."""
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


# every K the loader packs (K % 256), at widths that are not multiples of
# the old 512 (Q4) and 1024 (Q8_0) rules: Qwen2-1.5B's ffn_down (8960,
# Q4_K), Qwen2-7B at Q8_0 (3584), and 768 / 512
_LOADER_WIDTHS = [(GGMLType.Q4_K, 768), (GGMLType.Q4_K, 8960), (GGMLType.Q6_K, 768),
                  (GGMLType.Q8_0, 512), (GGMLType.Q8_0, 3584)]


@pytest.mark.parametrize("qtype", [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q4_K, GGMLType.Q6_K,
                                   GGMLType.Q8_0], ids=lambda t: t.name)
def test_every_loader_width_is_a_kernel_width(qtype):
    """The loader packs a matrix iff K % 256 == 0 (models/loader.py
    packable); every such K is a multiple of its kind's block and of the
    tensor-core routes' multiple, so no route refuses it; the warp bodies
    take the block's multiple alone."""
    fields = set(repack(quantize(np.zeros((1, 256), np.float32), qtype), qtype,
                        (1, 256)).fields)
    _kind, block = qmm._KINDS[frozenset(fields)]
    assert block in (32, 256) and 256 % block == 0 and qmm.MMA_K_MULTIPLE == 256


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4, 64])
@pytest.mark.parametrize("qtype,K", _LOADER_WIDTHS, ids=lambda v: getattr(v, "name", str(v)))
def test_kernel_takes_every_loader_width(cuda, qtype, K, T):
    """qmm_gemv (T <= 8: a scale run may wrap past the row's last column,
    read one by one) and qmm_tiled (T > 8: a partial last weight box) at K
    the kernels refused before, f32 and bf16 scales and x."""
    rng = np.random.default_rng(K + T)
    n_out = 136
    raw = quantize(rng.standard_normal((n_out, K)).astype(np.float32), qtype)
    pq = repack(raw, qtype, (n_out, K))
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(cuda)
    for sdt in (torch.float32, torch.bfloat16):
        fields = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
                  for k, v in pq.fields.items()}
        for xx in (x, x.to(torch.bfloat16)):
            got = qmm.quantized_matmul(xx, fields, qtype, pq.group, n_out, K)
            want = qmm.quantized_matmul_plain(xx, fields, qtype, pq.group, n_out, K)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 64])
@pytest.mark.parametrize("K,nk", [(512, 2), (512, 4), (3584, 4)])
def test_ktiled_kernel_takes_every_loader_width(cuda, K, nk, T):
    """qmm_ktiled at Q8_0 widths whose chunks the reference's
    _kchunks_valid admits (3584: 4 chunks of 896 = 8 scale columns x 112)."""
    qtype = GGMLType.Q8_0
    rng = np.random.default_rng(K + nk + T)
    n_out = 136
    pq = repack(quantize(rng.standard_normal((n_out, K)).astype(np.float32), qtype), qtype,
                (n_out, K))
    assert qmm.kchunks_valid(nk, K, pq.group, pq.fields)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(cuda)
    for sdt in (torch.float32, torch.bfloat16):
        fields = {k: torch.from_numpy(v).to(cuda, sdt if k == "scale" else None)
                  for k, v in pq.fields.items()}
        before = qmm.LAUNCHES["qmm_ktiled"]
        got = qmm.quantized_matmul(x, fields, qtype, pq.group, n_out, K, tile_k=nk)
        assert qmm.LAUNCHES["qmm_ktiled"] == before + 1
        want = qmm.quantized_matmul_ktiled_plain(x, fields, qtype, pq.group, n_out, K, nk)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# ------------------------------------------------ fourblock order, K-chunks


@pytest.mark.parametrize("K", [256, 4096])
def test_permute_x_fourblock_is_fourblock_permute(K):
    """K = 256 is the smallest R = K/128 (2); 4096 the served width."""
    from tpullama.ops.qweights import fourblock_permute

    x = np.random.default_rng(K).standard_normal((3, K)).astype(np.float32)
    np.testing.assert_array_equal(qmm.permute_x(torch.from_numpy(x), 32, "fourblock").numpy(),
                                  fourblock_permute(x, 32))


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("n_in", [512, 1024])
def test_plain_fourblock_matches_jax_exact(n_in, T):
    """Fourblock planes (to_fourblock of the Q4_K repack) through the plain
    version against the JAX package's order="fourblock" exact product and
    the numpy oracle, which dequantizes the same planes."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul as jax_qmm
    from tpullama.ops.qweights import to_fourblock

    rng = np.random.default_rng(n_in + T)
    raw = quantize(rng.standard_normal((N_OUT, n_in)).astype(np.float32), GGMLType.Q4_K)
    pq = to_fourblock(repack(raw, GGMLType.Q4_K, (N_OUT, n_in)))
    ref_w = dequantize(raw, GGMLType.Q4_K, (N_OUT, n_in)).reshape(N_OUT, n_in)
    np.testing.assert_array_equal(dequant_planar_np(pq), ref_w)
    x = rng.standard_normal((T, n_in)).astype(np.float32)
    fields_t = {k: torch.from_numpy(v) for k, v in pq.fields.items()}
    got = qmm.quantized_matmul(torch.from_numpy(x), fields_t, GGMLType.Q4_K, 32, N_OUT, n_in,
                               order="fourblock").numpy()
    want = np.asarray(jax_qmm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in pq.fields.items()},
                              GGMLType.Q4_K, 32, N_OUT, n_in, tile_n=8, interpret=True,
                              order="fourblock"))
    np.testing.assert_allclose(got, want, **_tol(want))
    oracle = x @ dequant_planar_np(pq).T
    np.testing.assert_allclose(got, oracle, **_tol(oracle))


_FIELD_SETS = {  # name -> (group, {field: (dtype, columns as a function of K)})
    "q4": (32, {"q4": (np.uint8, lambda K: K // 2), "scale": (np.float32, lambda K: K // 32),
                "minv": (np.float32, lambda K: K // 32)}),
    "q8": (32, {"q8": (np.int8, lambda K: K), "scale": (np.float32, lambda K: K // 32)}),
    "q6": (16, {"q4": (np.uint8, lambda K: K // 2), "q2": (np.uint8, lambda K: K // 4),
                "scale": (np.float32, lambda K: K // 16), "minv": (np.float32, lambda K: K // 16)}),
}


@pytest.mark.parametrize("fset", sorted(_FIELD_SETS))
@pytest.mark.parametrize("source", ["none", "arg-4", "arg-8", "env-tile-k-2", "env-tiles-row"])
def test_kchunks_choice_matches_reference(source, fset, monkeypatch):
    """choose_kchunks picks the K-chunk count the reference's
    quantized_matmul runs, over (N, K, T, order) for one field set and one
    source of nk (the argument, TPULLAMA_QMM_TILE_K, a TPULLAMA_QMM_TILES
    row, or neither). The reference's choice is observed by recording what
    it hands its K-chunked kernel (else 1) with both kernel calls stubbed."""
    import jax.numpy as jnp

    from tpullama.ops.pallas import qmm as jq

    seen = []

    def fake_ktiled(x, xgsum, pq_fields, field_names, ggml_type, group, Tp, N, K, tn, tt, nk,
                    layer, interpret):
        seen.append(nk)
        return jnp.zeros((Tp, N), jnp.float32)

    def fake_call(kernel, grid, in_specs, out_spec, out_shape, operands, **kw):
        seen.append(1)
        return jnp.zeros(out_shape.shape, out_shape.dtype)

    monkeypatch.setattr(jq, "_qmm_ktiled", fake_ktiled)
    monkeypatch.setattr(jq, "_call_qmm_kernel", fake_call)
    for var in ("TPULLAMA_QMM_TILE_K", "TPULLAMA_QMM_TILES", "TPULLAMA_QMM_VMEM_FIT"):
        monkeypatch.delenv(var, raising=False)
    tile_k = None
    if source.startswith("arg-"):
        tile_k = int(source.split("-")[1])
    elif source == "env-tile-k-2":
        monkeypatch.setenv("TPULLAMA_QMM_TILE_K", "2")
    elif source == "env-tiles-row":
        monkeypatch.setenv("TPULLAMA_QMM_TILES", "4608,4096=512:4; 256,14336=256:16")
    group, spec = _FIELD_SETS[fset]
    checked = 0
    # two of the shapes are rows of the JAX package's default tile table
    for N, K in ((256, 512), (256, 4096), (256, 14336), (4608, 512), (4608, 4096),
                 (4608, 14336), (28672, 4096), (4096, 14336)):
        fields = {k: np.zeros((N, cols(K)), dt) for k, (dt, cols) in spec.items()}
        for T in (1, 33):
            for order in ("stripe", "fourblock") if fset == "q4" else ("stripe",):
                seen.clear()
                x = jnp.zeros((T, K), jnp.float32)
                jq.quantized_matmul(x, {k: jnp.asarray(v) for k, v in fields.items()},
                                    GGMLType.Q4_K, group, N, K, interpret=True, exact=False,
                                    tile_k_chunks=tile_k, order=order)
                assert len(seen) == 1
                got = qmm.choose_kchunks(N, K, T, fields, group, order, tile_k)
                assert got == seen[0], (N, K, T, order, got, seen[0])
                checked += got > 1
    assert checked or source == "none" or fset == "q6"


def _chunk_case(qtype, n_out, n_in, T, seed):
    rng = np.random.default_rng(seed)
    raw = quantize(rng.standard_normal((n_out, n_in)).astype(np.float32), qtype)
    pq = repack(raw, qtype, (n_out, n_in))
    x = rng.standard_normal((T, n_in)).astype(np.float32)
    return pq, x


@pytest.mark.parametrize("nk", [2, 4])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0], ids=lambda t: t.name)
def test_plain_ktiled_matches_jax_and_untiled(qtype, T, nk):
    """The plain K-chunked product against the JAX K-chunked kernel
    (tile_k_chunks=nk, fast mode, interpret): that kernel rounds x and the
    weights to bf16 (qmm.py:489-498), so 1e-2 of the output's max; and
    against the port's untiled plain product: the same f32 weights summed
    in another order, so the f32 tolerance."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul as jax_qmm

    n_out, n_in = 16, 1024
    pq, x = _chunk_case(qtype, n_out, n_in, T, seed=nk * 10 + T)
    fields_t = {k: torch.from_numpy(v) for k, v in pq.fields.items()}
    assert qmm.choose_kchunks(n_out, n_in, T, fields_t, pq.group, tile_k=nk) == nk
    got = qmm.quantized_matmul(torch.from_numpy(x), fields_t, qtype, pq.group, n_out, n_in,
                               tile_k=nk).numpy()
    np.testing.assert_array_equal(
        got, qmm.quantized_matmul_ktiled_plain(torch.from_numpy(x), fields_t, qtype, pq.group,
                                               n_out, n_in, nk).numpy())
    untiled = qmm.quantized_matmul_plain(torch.from_numpy(x), fields_t, qtype, pq.group,
                                         n_out, n_in).numpy()
    np.testing.assert_allclose(got, untiled, **_tol(untiled))
    want = np.asarray(jax_qmm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in pq.fields.items()},
                              qtype, pq.group, n_out, n_in, interpret=True, exact=False,
                              tile_k_chunks=nk))
    assert float(np.abs(got - want).max()) <= 1e-2 * float(np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [2, 4, 8])
@pytest.mark.parametrize("T", [1, 3, 8, 9, 40, 64, 70, 256])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0], ids=lambda t: t.name)
def test_ktiled_kernel_matches_plain(cuda, qtype, T, nk):
    """The K-chunked kernel against its plain version: 1e-4 of the
    output's scale (f32 sums in another order within each chunk). T <= 8
    runs the decode body over each chunk's byte rows, T > 8 the
    tensor-core route (64- or 128-token blocks: T = 70 leaves a ragged
    block, 256 is the served chunk)."""
    n_out, n_in = 260, 4096
    pq, x = _chunk_case(qtype, n_out, n_in, T, seed=T * nk)
    xx = torch.from_numpy(x).to(cuda)
    for sdt in (torch.float32, torch.bfloat16):
        fields = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
                  for k, v in pq.fields.items()}
        for xi in (xx, xx.to(torch.bfloat16)):
            before = qmm.LAUNCHES["qmm_ktiled"]
            got = qmm.quantized_matmul(xi, fields, qtype, pq.group, n_out, n_in, tile_k=nk)
            want = qmm.quantized_matmul_ktiled_plain(xi, fields, qtype, pq.group, n_out, n_in,
                                                     nk)
            assert qmm.LAUNCHES["qmm_ktiled"] == before + 1
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [2, 4, 8])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0], ids=lambda t: t.name)
def test_ktiled_rows_do_not_depend_on_the_batch(cuda, qtype, nk):
    """qmm_ktiled at T <= 8 (the decode body over each K-chunk's byte rows):
    each x row alone and the first T rows of 8 give the rows of the T = 8
    call bit for bit, with f32 and bf16 x and scales. N = 260 leaves a
    ragged row block."""
    n_out, n_in = 260, 4096
    pq, x = _chunk_case(qtype, n_out, n_in, 8, seed=95 + nk)
    for sdt in (torch.float32, torch.bfloat16):
        fields = _card_fields(pq, cuda, sdt)
        for xdt in (torch.float32, torch.bfloat16):
            xx = torch.from_numpy(x).to(cuda, xdt)
            before = qmm.LAUNCHES["qmm_ktiled"]
            full = qmm.quantized_matmul(xx, fields, qtype, pq.group, n_out, n_in, tile_k=nk)
            assert qmm.LAUNCHES["qmm_ktiled"] == before + 1
            for T in range(1, 8):
                head = qmm.quantized_matmul(xx[:T].contiguous(), fields, qtype, pq.group,
                                            n_out, n_in, tile_k=nk)
                assert torch.equal(head, full[:T])
            for t in range(8):
                one = qmm.quantized_matmul(xx[t:t + 1].contiguous(), fields, qtype, pq.group,
                                           n_out, n_in, tile_k=nk)
                assert torch.equal(one[0], full[t])


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0], ids=lambda t: t.name)
def test_ktiled_mma_rows_do_not_depend_on_the_batch(cuda, qtype):
    """Row t of a T = 9 call equals row t of a T = 256 call whose first 9
    rows are the same, bit for bit: each output of the tensor-core route
    depends only on its own weight row, token row and K order."""
    n_out, n_in, nk = 260, 4096, 4
    pq, x = _chunk_case(qtype, n_out, n_in, 256, seed=77)
    for sdt in (torch.float32, torch.bfloat16):
        fields = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
                  for k, v in pq.fields.items()}
        for xdt in (torch.float32, torch.bfloat16):
            xx = torch.from_numpy(x).to(cuda, xdt)
            full = qmm.quantized_matmul(xx, fields, qtype, pq.group, n_out, n_in, tile_k=nk)
            head = qmm.quantized_matmul(xx[:9].contiguous(), fields, qtype, pq.group, n_out,
                                        n_in, tile_k=nk)
            assert torch.equal(head, full[:9])


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_tiled_mma_rows_do_not_depend_on_the_batch(cuda, qtype):
    """Row t of a T = 9 call of qmm_tiled equals row t of a T = 256 call
    whose first 9 rows are the same, bit for bit (f32 and bf16 x and
    scales): each output of the group body depends only on its own weight
    row, token row and column order. N = 260 leaves a ragged row block."""
    n_out, n_in = 260, 4096
    pq, x = _chunk_case(qtype, n_out, n_in, 256, seed=78)
    for sdt in (torch.float32, torch.bfloat16):
        fields = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
                  for k, v in pq.fields.items()}
        for xdt in (torch.float32, torch.bfloat16):
            xx = torch.from_numpy(x).to(cuda, xdt)
            before = qmm.LAUNCHES["qmm_tiled"]
            full = qmm.quantized_matmul(xx, fields, qtype, pq.group, n_out, n_in)
            head = qmm.quantized_matmul(xx[:9].contiguous(), fields, qtype, pq.group, n_out,
                                        n_in)
            assert qmm.LAUNCHES["qmm_tiled"] == before + 2
            assert torch.equal(head, full[:9])
            assert torch.equal(xx, torch.from_numpy(x).to(cuda, xdt))  # x is not split in place


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 8, 9, 64])
def test_fourblock_kernel_matches_plain(cuda, T):
    """Fourblock planes through qmm_gemv / qmm_tiled: only the wrapper's x
    permutation differs from the stripe order."""
    from tpullama.ops.qweights import to_fourblock

    n_out, n_in = 256, 4096
    pq, x = _chunk_case(GGMLType.Q4_K, n_out, n_in, T, seed=50 + T)
    pq = to_fourblock(pq)
    fields = {k: torch.from_numpy(v).to(cuda) for k, v in pq.fields.items()}
    xx = torch.from_numpy(x).to(cuda)
    got = qmm.quantized_matmul(xx, fields, GGMLType.Q4_K, 32, n_out, n_in, order="fourblock")
    want = qmm.quantized_matmul_plain(xx, fields, GGMLType.Q4_K, 32, n_out, n_in,
                                      order="fourblock")
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _card_fields(pq, cuda, sdt):
    return {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
            for k, v in pq.fields.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("qtype,n_in", [(GGMLType.Q4_K, 4096), (GGMLType.Q4_K, 14336),
                                        (GGMLType.Q6_K, 4096), (GGMLType.Q8_0, 4096),
                                        (GGMLType.Q8_0, 800)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_gemv_rows_do_not_depend_on_the_batch(cuda, qtype, n_in):
    """Each x row alone (T = 1) and the first T rows of 8 (T = 2 .. 8) give
    the rows of the T = 8 call bit for bit, with f32 and bf16 x and scales:
    the decode body's lanes, classes and sum order do not depend on T (at
    K = 14336 the slices do, not the order). N = 260 leaves a ragged block;
    K = 800 (Q8_0) a ragged class."""
    n_out = 260
    pq, x = _chunk_case(qtype, n_out, n_in, 8, seed=90 + n_in)
    for sdt in (torch.float32, torch.bfloat16):
        fields = _card_fields(pq, cuda, sdt)
        for xdt in (torch.float32, torch.bfloat16):
            xx = torch.from_numpy(x).to(cuda, xdt)
            full = qmm.quantized_matmul(xx, fields, qtype, pq.group, n_out, n_in)
            for T in range(1, 8):
                head = qmm.quantized_matmul(xx[:T].contiguous(), fields, qtype, pq.group,
                                            n_out, n_in)
                assert torch.equal(head, full[:T])
            for t in range(8):
                one = qmm.quantized_matmul(xx[t:t + 1].contiguous(), fields, qtype, pq.group,
                                           n_out, n_in)
                assert torch.equal(one[0], full[t])


@pytest.mark.cuda
@pytest.mark.parametrize("n_out,n_in", [(256, 14336), (128, 28672)])
def test_gemv_takes_wide_k_at_t8(cuda, n_out, n_in):
    """T = 8 at the widest K of the served models (Llama-3-8B's ffn_down,
    14336) and twice that: x is staged in slices of the row (f32 x at T = 8
    and K = 14336 is 459 KB, twice a block's shared memory)."""
    pq, x = _chunk_case(GGMLType.Q4_K, n_out, n_in, 8, seed=n_in)
    fields = _card_fields(pq, cuda, torch.bfloat16)
    for xdt in (torch.float32, torch.bfloat16):
        xx = torch.from_numpy(x).to(cuda, xdt)
        before = qmm.LAUNCHES["qmm_gemv"]
        got = qmm.quantized_matmul(xx, fields, GGMLType.Q4_K, 32, n_out, n_in)
        assert qmm.LAUNCHES["qmm_gemv"] == before + 1
        want = qmm.quantized_matmul_plain(xx, fields, GGMLType.Q4_K, 32, n_out, n_in)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("qtype,n_in", [(GGMLType.Q4_0, 544), (GGMLType.Q8_0, 800)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_gemv_takes_ragged_column_classes(cuda, qtype, n_in, T):
    """K/g = 17 and 25 columns: a row's last class of 4 is ragged, its bytes
    and scales read one by one and its missing columns zero."""
    n_out = 100
    pq, x = _chunk_case(qtype, n_out, n_in, T, seed=n_in + T)
    for sdt in (torch.float32, torch.bfloat16):
        fields = _card_fields(pq, cuda, sdt)
        xx = torch.from_numpy(x).to(cuda)
        got = qmm.quantized_matmul(xx, fields, qtype, pq.group, n_out, n_in)
        want = qmm.quantized_matmul_plain(xx, fields, qtype, pq.group, n_out, n_in)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
