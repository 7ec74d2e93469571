"""MXFP4 through the port's four qmm kernels, held against the JAX package
on the CPU: the LUT planes {q4_lut, scale} and their A/r re-code {q4a, q1r,
scale} (ops/qweights.mxfp4_to_ar) in quantized_matmul (kernel 1),
K-chunked (kernel 2, LUT only: the reference's _kchunks_valid admits no
A/r), and the gathered products on row-major (kernel 3) and transposed
(kernel 4) expert planes, against the JAX kernels in interpret mode; the
CUDA bodies' new arithmetic emulated (the e2m1 table by byte permutes, the
A/r values, the tensor-core routes' bf16 integers, the byte addresses of
the transposed one-row body and of the tile body); and two models with
`mxfp4_ar` off and on: an all-MXFP4 Mixtral-style MoE and a qwen3moe with
MXFP4 experts (their expert planes stored transposed), prefill logits and
greedy tokens against the JAX package. The kernels themselves run on the
card (marked cuda), each against its plain version.

Tolerances: the products dequantize exactly on both sides (every MXFP4
weight is a small integer times a power of two) and sum in f32 in other
orders: 1e-4 of the output's max, as the other qmm cases. The JAX
K-chunked kernel runs only in its fast mode, which rounds x and the
weights to bf16: x is made of bf16 values and MXFP4's weights are exact
in bf16, so the same 1e-4 holds. Models as tests/test_torch_model.py's:
logits within rtol = atol = 1e-4, tokens and parameter trees exactly."""

import itertools

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tests.test_torch_model import (LONG_PROMPT, MOE, PROMPT, _assert_same_tree,
                                    _check_prefill_and_generate, _jax_load, _jax_numpy,
                                    _port_load, _retype_gguf, _to_numpy)
from tpullama.gguf import GGMLType, quantize
from tpullama.models.testing import make_tiny_llama_gguf
from tpullama_torch.gguf.quants import KVALUES_MXFP4
from tpullama_torch.ops.cuda import qmm
from tpullama_torch.ops.cuda import qmm_gathered as gq
from tpullama_torch.ops.qweights import mxfp4_to_ar, repack, transpose_planes

MX = GGMLType.MXFP4
SETS = [False, True]  # the LUT planes, the A/r re-code
SET_IDS = ["lut", "ar"]


def _raw(n_rows, K, rng):
    return quantize((rng.standard_normal((n_rows, K)) * 0.1).astype(np.float32), MX)


def _planes(n_rows, K, seed, ar):
    """One (n_rows, K) MXFP4 matrix repacked (the port's copy of repack),
    re-coded to the A/r planes with `ar`."""
    f = repack(_raw(n_rows, K, np.random.default_rng(seed)), MX, (n_rows, K)).fields
    return mxfp4_to_ar(f) if ar else f


def _experts(n_experts, n_rows, K, seed, ar, planes_t):
    """n_experts MXFP4 experts (rows padded to 128), A/r with `ar`,
    transposed with `planes_t`, as the loader stores them."""
    rng = np.random.default_rng(seed)
    rows_p = -(-n_rows // 128) * 128
    pqs = [repack(_raw(n_rows, K, rng), MX, (n_rows, K)).fields for _ in range(n_experts)]
    if ar:
        pqs = [mxfp4_to_ar(f) for f in pqs]
    fields = {k: np.pad(np.stack([f[k] for f in pqs]), ((0, 0), (0, rows_p - n_rows), (0, 0)))
              for k in pqs[0]}
    return transpose_planes(fields) if planes_t else fields


def _torch(fields):
    return {k: torch.from_numpy(v) for k, v in fields.items()}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= 1e-4 * float(np.abs(want).max()), err


# ---------------------------------------------------------------- kernels 1-4


@pytest.mark.parametrize("T", [4, 33])  # the decode body's T <= 8, the group body's T > 8
@pytest.mark.parametrize("ar", SETS, ids=SET_IDS)
def test_qmm_matches_jax(ar, T):
    """Kernel 1 (quantized_matmul): the port's product against the JAX
    kernel in interpret mode, on the same planes, f32 and bf16 scales."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul as j_qmm

    N, K = 40, 512
    f = _planes(N, K, seed=T, ar=ar)
    x = np.random.default_rng(T + 1).standard_normal((T, K)).astype(np.float32)
    meta = {k: v.to("meta") for k, v in _torch(f).items()}
    assert qmm.check_inputs(torch.empty((T, K), device="meta"), meta, MX, 32, N, K) == (
        (7, "q4a", "q1r") if ar else (6, "q4_lut", None))
    for bf16 in (False, True):
        ft, fj = _torch(f), {k: jnp.asarray(v) for k, v in f.items()}
        if bf16:
            ft["scale"] = ft["scale"].to(torch.bfloat16)
            fj["scale"] = fj["scale"].astype(jnp.bfloat16)
        got = qmm.quantized_matmul(torch.from_numpy(x), ft, MX, 32, N, K)
        want = j_qmm(jnp.asarray(x), fj, MX, 32, N, K, interpret=True)
        _close(got.numpy(), want)


@pytest.mark.parametrize("nk", [2, 4])
@pytest.mark.parametrize("T", [1, 40])
def test_ktiled_matches_jax(T, nk):
    """Kernel 2 (_qmm_ktiled) on the LUT planes: the port's K-chunked
    product (the route choose_kchunks picks) against the JAX K-chunked
    kernel (fast mode, interpret) on bf16-valued x; the A/r planes are
    never chunked, in either package."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import _kchunks_valid
    from tpullama.ops.pallas.qmm import quantized_matmul as j_qmm

    N, K = 24, 1024
    f = _planes(N, K, seed=nk, ar=False)
    ft = _torch(f)
    assert qmm.choose_kchunks(N, K, T, ft, 32, tile_k=nk) == nk
    ar = mxfp4_to_ar(f)
    assert qmm.choose_kchunks(N, K, T, _torch(ar), 32, tile_k=nk) == 1
    assert not _kchunks_valid(nk, K, 32, list(ar))
    x = torch.randn((T, K), generator=torch.Generator().manual_seed(T)).to(torch.bfloat16).float()
    got = qmm.quantized_matmul(x, ft, MX, 32, N, K, tile_k=nk)
    np.testing.assert_array_equal(
        got.numpy(), qmm.quantized_matmul_ktiled_plain(x, ft, MX, 32, N, K, nk).numpy())
    want = j_qmm(jnp.asarray(x.numpy()), {k: jnp.asarray(v) for k, v in f.items()}, MX, 32, N,
                 K, interpret=True, exact=False, tile_k_chunks=nk)
    _close(got.numpy(), want)


@pytest.mark.parametrize("planes_t", [False, True], ids=["row-major", "transposed"])
@pytest.mark.parametrize("tile_t", [1, 8])
@pytest.mark.parametrize("ar", SETS, ids=SET_IDS)
def test_gathered_matches_jax(ar, tile_t, planes_t):
    """Kernels 3 (row-major planes) and 4 (transposed) on both sets, one-row
    and 8-row tiles: the port's gathered product against the JAX kernel in
    interpret mode, over 5 tiles of 4 experts with padded rows (320 of
    384)."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul_gathered as j_gathered

    N, K = 320, 256
    f = _experts(4, N, K, seed=tile_t + 2 * planes_t, ar=ar, planes_t=planes_t)
    sel = np.asarray([2, 0, 2, 3, 1], np.int32)
    x = np.random.default_rng(tile_t).standard_normal((5 * tile_t, K)).astype(np.float32)
    lo = "q4a" if ar else "q4_lut"
    assert gq.kernel_kind(_torch(f), MX, planes_t)[::2] == ((7, lo) if ar else (6, lo))
    got = gq.quantized_matmul_gathered(torch.from_numpy(x), _torch(f), torch.from_numpy(sel), MX,
                                       32, N, K, tile_t=tile_t, planes_t=planes_t)
    want = j_gathered(jnp.asarray(x), {k: jnp.asarray(v) for k, v in f.items()},
                      jnp.asarray(sel), MX, 32, N, K, tile_t=tile_t, interpret=True,
                      planes_t=planes_t)
    _close(got.numpy(), want)


def test_unknown_sets_still_raise():
    """A field set no kernel takes (a q4 plane without its min plane) is
    refused by every wrapper, naming what the kernels take."""
    f = {"q4": torch.empty((64, 2048), dtype=torch.uint8, device="meta"),
         "scale": torch.empty((64, 128), device="meta")}
    with pytest.raises(NotImplementedError, match="MXFP4 \\(its LUT and A/r planes\\)"):
        qmm.check_inputs(torch.empty((4, 4096), device="meta"), f, MX, 32, 64, 4096)
    with pytest.raises(NotImplementedError, match="MXFP4"):
        gq.kernel_kind(f, MX)
    with pytest.raises(NotImplementedError, match="MXFP4's LUT and A/r planes are"):
        gq.kernel_kind(f, MX, planes_t=True)


# ---------------------------------------------------------------- the bodies' arithmetic


def _prmt(lo: int, hi: int, sel: np.ndarray) -> np.ndarray:
    """__byte_perm(lo, hi, sel) with constant lo, hi: byte n of the result is
    byte (sel >> 4n) & 7 of the 8 bytes hi:lo."""
    table = np.asarray([(lo >> 8 * i) & 0xFF for i in range(4)] +
                       [(hi >> 8 * i) & 0xFF for i in range(4)], np.uint64)
    out = np.zeros_like(sel)
    for n in range(4):
        out |= table[(sel >> np.uint64(4 * n)) & np.uint64(7)] << np.uint64(8 * n)
    return out


def _mxfp4_biased(idx: np.ndarray) -> np.ndarray:
    """qmm_dequant.cuh's mxfp4_biased: four e2m1 indices (a byte each) ->
    12 + their values, by two byte permutes and a select on bit 3."""
    m32 = np.uint64(0xFFFFFFFF)
    s = idx & np.uint64(0x07070707)
    sel = s | (s >> np.uint64(4))
    sel = (sel & np.uint64(0xFF)) | ((sel >> np.uint64(8)) & np.uint64(0xFF00))
    pos = _prmt(0x0F0E0D0C, 0x18141210, sel)
    neg = _prmt(0x090A0B0C, 0x00040608, sel)
    m = ((idx >> np.uint64(3)) & np.uint64(0x01010101)) * np.uint64(0xFF)
    return ((pos & ~m) | (neg & m)) & m32


def _bytes(words: np.ndarray) -> np.ndarray:
    return np.stack([(words >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)], -1)


def test_lut_and_ar_values_by_word():
    """The decode bodies' values (gv_value, over the 4 fields of a word):
    every word of 4 e2m1 indices gives 12 + LUT[idx] in each byte; every
    A/r field a | r << 4 gives 16 + 2 (a - 8) + r as 2 a + r. The
    tensor-core routes' integers (frag_a): the bf16 0x4300 | u less 140
    (LUT) or 144 (A/r) is the value exactly."""
    idx = np.asarray(list(itertools.product(range(16), repeat=4)), np.uint64)
    words = idx[:, 0] | idx[:, 1] << np.uint64(8) | idx[:, 2] << np.uint64(16) | idx[:, 3] << np.uint64(24)
    got = _bytes(_mxfp4_biased(words)).astype(np.int64) - 12
    np.testing.assert_array_equal(got, KVALUES_MXFP4[idx.astype(np.int64)])
    a, r = np.meshgrid(np.arange(16), np.arange(2), indexing="ij")
    u = (a | r << 4).astype(np.uint64).reshape(-1)
    v = ((u & np.uint64(0x0F)) << np.uint64(1)) | ((u >> np.uint64(4)) & np.uint64(1))
    np.testing.assert_array_equal(v.astype(np.int64) - 16, (2 * (a - 8) + r).reshape(-1))

    def bf16_ints(biased, bias):
        b = torch.from_numpy((0x4300 | biased.astype(np.int64)).astype(np.int16))
        return (b.view(torch.bfloat16) - torch.tensor(bias, dtype=torch.bfloat16)).float()

    lut = _bytes(_mxfp4_biased(np.arange(16, dtype=np.uint64)))[:, 0]
    np.testing.assert_array_equal(bf16_ints(lut, 140.0).numpy(), KVALUES_MXFP4.astype(np.float32))
    np.testing.assert_array_equal(bf16_ints(v, 144.0).numpy(),
                                  (2 * (a - 8) + r).reshape(-1).astype(np.float32))


def _unit(fields):
    """The planes with unit scales: dequant_stored then gives each stored
    position's integer value."""
    return {k: (np.ones_like(v) if k == "scale" else v) for k, v in fields.items()}


@pytest.mark.parametrize("K", [256, 768, 2048])
@pytest.mark.parametrize("ar", SETS, ids=SET_IDS)
def test_transposed_one_row_body_reads_every_value(ar, K):
    """The transposed one-row body's byte addresses (gt_body), emulated: the
    tile's byte row j of column c is low-plane row j G + c (low nibble a =
    j, high a = j + 16) and, for A/r, tile row 16 + j % 4 is q1r row (j %
    4) G + c, whose bit j / 4 (a = j) or j / 4 + 4 (a = j + 16) is r; the
    value at stored position a G + c equals the plain version's."""
    n = 128
    f = _planes(n, K, seed=K, ar=ar)
    G = K // 32
    want = qmm.dequant_stored(_torch(_unit(f)), MX, 32).numpy().astype(np.int64)
    t = transpose_planes({k: v[None] for k, v in f.items()})
    lo = t["q4a" if ar else "q4_lut"][0].astype(np.int64)  # (K/2, n)
    got = np.zeros((n, K), np.int64)
    for j in range(16):
        for c in range(G):
            byte = lo[j * G + c]
            for a, idx in ((j, byte & 15), (j + 16, byte >> 4)):
                if ar:
                    rb = t["q1r"][0][(j % 4) * G + c].astype(np.int64)
                    v = 2 * (idx - 8) + ((rb >> (j // 4 + 4 * (a >= 16))) & 1)
                else:
                    v = KVALUES_MXFP4[idx]
                got[:, a * G + c] = v
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K", [256, 768, 2560])
@pytest.mark.parametrize("ar", SETS, ids=SET_IDS)
def test_tile_body_decodes_every_value(ar, K):
    """The tensor-core tile body (qmm_mma.cuh) on MXFP4, emulated: chunk c's
    16 low-plane bytes at 16 c (Q4's and Q5's layout), the A/r set's 16 q1r
    bytes at Geo::high_byte shifted by Geo::high_shift, decode_vals' values
    (LUT[idx]; 2 (a - 8) + r) at Geo::seg_start's positions, equal to the
    plain version's."""
    f = {k: v.astype(np.int64) for k, v in _planes(8, K, seed=K + 1, ar=ar).items()}
    want = qmm.dequant_stored(_torch(_unit(_planes(8, K, seed=K + 1, ar=ar))), MX,
                              32).numpy().astype(np.int64)
    got = np.full((8, K), -99, np.int64)
    for c in range(K // 32):
        q = f["q4a" if ar else "q4_lut"][:, 16 * c:16 * c + 16]
        nib = [q & 15, q >> 4]
        if ar:
            hb, hs = 16 * c % (K // 8), 128 * c // K
            h = f["q1r"][:, hb:hb + 16] >> hs
            vals = [2 * (nib[0] - 8) + (h & 1), 2 * (nib[1] - 8) + ((h >> 4) & 1)]
        else:
            vals = [KVALUES_MXFP4[n] for n in nib]
        for j in range(2):
            p0 = j * (K // 2) + 16 * c
            got[:, p0:p0 + 16] = vals[j]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- models


@pytest.fixture(scope="module")
def mxfp4_ggufs(tmp_path_factory):
    """An all-MXFP4 Mixtral-style MoE (make_tiny_llama_gguf: n_embd 256, n_ff
    256, 2 layers, 4 experts, 2 a token; every matrix, token table and
    output included, MXFP4: the layout of tools/quantize.py's MXFP4 ftype)
    and a qwen3moe at the same widths whose expert stacks alone are MXFP4
    (the rest F32). At K = 256 every expert stack's 8 scale columns make
    the planes_t rule store them transposed."""
    d = tmp_path_factory.mktemp("mxfp4")
    out = {"llama": str(d / "llama-mxfp4.gguf")}
    make_tiny_llama_gguf(out["llama"], qtype=MX, seed=41, **MOE)
    base = str(d / "qwen3moe-f32.gguf")
    make_tiny_llama_gguf(base, arch="qwen3moe", seed=43, **MOE)
    out["qwen3moe"] = str(d / "qwen3moe-mxfp4.gguf")
    _retype_gguf(base, out["qwen3moe"], lambda name: MX if "_exps." in name else None)
    return out


@pytest.mark.parametrize("ar", SETS, ids=SET_IDS)
@pytest.mark.parametrize("arch", ["llama", "qwen3moe"])
def test_model_matches_jax(mxfp4_ggufs, arch, ar, monkeypatch):
    """Both packages load the model packed with TPULLAMA_MXFP4_AR off and on
    (f32 scales): the same parameter trees (every MXFP4 layer matrix and
    expert stack in A/r planes when on, the output's LUT planes kept; the
    expert planes transposed), and the same prefill logits and greedy
    tokens; the prefill of the long prompt runs the dispatch's 8-row tiles.
    The port's keyword gives what the variable gives."""
    monkeypatch.setenv("TPULLAMA_MXFP4_AR", "1" if ar else "0")
    path = mxfp4_ggufs[arch]
    j = _jax_load(path, packed=True, packed_scale_dtype=np.float32)
    t = _port_load(path, packed=True, packed_scale_dtype=torch.float32)
    _assert_same_tree(_to_numpy(t.params), _jax_numpy(j.params))
    lm = t.quant_meta["layers"]
    want = {"ffn_gateup_exps", "ffn_down_exps"}
    if arch == "llama":
        want |= {"attn_q", "attn_k", "attn_v", "attn_output"}
        assert set(t.params["output"]) == {"q4_lut", "scale"}
    assert set(lm) == want and all(m.ggml_type == MX for m in lm.values())
    assert lm["ffn_gateup_exps"].planes_t and lm["ffn_down_exps"].planes_t
    for key in want:
        assert set(t.params["layers"][key]) == ({"q4a", "q1r", "scale"} if ar
                                                else {"q4_lut", "scale"})
    monkeypatch.delenv("TPULLAMA_MXFP4_AR")
    by_kw = _port_load(path, packed=True, packed_scale_dtype=torch.float32, mxfp4_ar=ar)
    _assert_same_tree(_to_numpy(by_kw.params), _to_numpy(t.params))
    monkeypatch.setenv("TPULLAMA_MXFP4_AR", "1" if ar else "0")
    for prompt in (PROMPT, LONG_PROMPT) if arch == "qwen3moe" else (PROMPT,):
        _check_prefill_and_generate(path, prompt, packed=True, packed_scale_dtype=np.float32)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the MXFP4 kernels run on a CUDA card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 4096])
@pytest.mark.parametrize("T", [1, 4, 8, 9, 64, 1024])
@pytest.mark.parametrize("ar", SETS, ids=SET_IDS)
def test_qmm_kernel_matches_plain(cuda, ar, T, K):
    """qmm_gemv (T <= 8) and qmm_tiled (T > 8) on both sets, f32 and bf16 x
    and scales, against the plain version: 1e-4 of the output's max."""
    n_out = 264  # a partial last row block on both routes
    f = _planes(n_out, K, seed=T + K, ar=ar)
    x = torch.from_numpy(np.random.default_rng(T).standard_normal((T, K)).astype(np.float32))
    x = x.to(cuda)
    name = "qmm_gemv" if T <= qmm.GEMV_MAX_T else "qmm_tiled"
    for sdt in (torch.float32, torch.bfloat16):
        ft = {k: torch.from_numpy(v).to(cuda, sdt if k == "scale" else None) for k, v in f.items()}
        for xx in (x, x.to(torch.bfloat16)):
            before = qmm.LAUNCHES[name]
            got = qmm.quantized_matmul(xx, ft, MX, 32, n_out, K)
            assert qmm.LAUNCHES[name] == before + 1
            want = qmm.quantized_matmul_plain(xx, ft, MX, 32, n_out, K)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got).all())
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [2, 4])
@pytest.mark.parametrize("T", [1, 4, 9, 64])
def test_ktiled_kernel_matches_plain(cuda, T, nk):
    """qmm_ktiled on the LUT planes (T <= 8 on the decode body over each
    chunk's byte rows, T > 8 on the tile body), bf16 and f32 x, against
    the plain K-chunked product."""
    N, K = 264, 4096
    f = {k: torch.from_numpy(v).to(cuda) for k, v in _planes(N, K, seed=nk, ar=False).items()}
    f["scale"] = f["scale"].to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(T).standard_normal((T, K)).astype(np.float32))
    for xx in (x.to(cuda), x.to(cuda, torch.bfloat16)):
        before = qmm.LAUNCHES["qmm_ktiled"]
        got = qmm.quantized_matmul(xx, f, MX, 32, N, K, tile_k=nk)
        assert qmm.LAUNCHES["qmm_ktiled"] == before + 1
        want = qmm.quantized_matmul_ktiled_plain(xx, f, MX, 32, N, K, nk)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [768, 2048])
@pytest.mark.parametrize("tile_t", [1, 2, 8])
@pytest.mark.parametrize("planes_t", [False, True])
@pytest.mark.parametrize("ar", SETS, ids=SET_IDS)
def test_gathered_kernel_matches_plain(cuda, ar, planes_t, tile_t, K):
    """qmm_gathered (row-major) and qmm_gathered_t (transposed) on both
    sets: one-row tiles over runs of tiles that share an expert, tiles of 2
    and 8 rows on the tensor-core routes, f32 and bf16 scales, against the
    plain version; a one-row tile alone equals itself in its run."""
    N = 320
    f = _experts(4, N, K, seed=K + tile_t, ar=ar, planes_t=planes_t)
    sel = torch.tensor([3, 1, 1, 0, 3, 3, 1], dtype=torch.int32, device=cuda)
    x = torch.from_numpy(np.random.default_rng(tile_t).standard_normal((7 * tile_t, K))
                         .astype(np.float32)).to(cuda)
    name = "qmm_gathered_t" if planes_t else "qmm_gathered"
    for sdt in (torch.float32, torch.bfloat16):
        ft = {k: torch.from_numpy(v).to(cuda, sdt if k == "scale" else None) for k, v in f.items()}
        before = gq.LAUNCHES[name]
        got = gq.quantized_matmul_gathered(x, ft, sel, MX, 32, N, K, tile_t=tile_t,
                                           planes_t=planes_t)
        assert gq.LAUNCHES[name] == before + 1
        want = gq.quantized_matmul_gathered_plain(x, ft, sel, MX, 32, N, K, tile_t=tile_t,
                                                  planes_t=planes_t)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
        if tile_t == 1:
            alone = gq.quantized_matmul_gathered(x[:1], ft, sel[:1], MX, 32, N, K,
                                                 planes_t=planes_t)
            assert torch.equal(alone[0], got[0])
