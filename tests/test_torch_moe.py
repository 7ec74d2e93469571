"""The port's MoE pieces held against the JAX package on the CPU: the plain
gathered quantized matmul (tpullama_torch/ops/cuda/qmm_gathered.py)
against quantized_matmul_gathered(..., interpret=True) in both plane
layouts, moe_dispatch's integer outputs, and moe_ffn dense and packed
(split and fused [gate | up]) against tpullama/ops/moe.py. The CUDA
kernels themselves run only on the card (marked cuda). The planes come
from the port's copies of repack and transpose_planes (byte for byte the
JAX package's, tests/test_torch_copies.py), and the modules that import
jax are imported inside the tests that need them, so that the card's
tests run where jax is not installed.

Tolerances: the gathered products dequantize exactly on both sides and
sum in f32 in another order: atol = 1e-4 + 1e-6 * max|y|, rtol = 1e-5 (as
tests/test_torch_qmm.py). moe_ffn within rtol = atol = 2e-4 (the JAX
package's own packed-vs-dense MoE tolerance). moe_dispatch exactly."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.gguf import GGMLType, quantize
from tpullama_torch.ops.qweights import repack, transpose_planes
from tpullama_torch.models.loader import QuantMeta as TQuantMeta
from tpullama_torch.ops import moe as t_moe
from tpullama_torch.ops.cuda import qmm_gathered as gq

E, D, F = 4, 256, 320  # F = 320: expert rows padded to 384 (not a multiple of 128)


# the q1/q2 field sets (Q5_0/Q5_1/Q5_K {q4, q1}, Q3_K {q2, q1}, Q2_K {q2}),
# which the row-major gathered kernel takes (csrc/qmm_gathered_lowbit.cu)
LOWBIT = (GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q5_K, GGMLType.Q3_K, GGMLType.Q2_K)


def _raw(qtype, n_rows, n_in, rng):
    """Block bytes of an (n_rows, n_in) matrix: quantized from normal values
    (std 0.1), or for Q2_K / Q3_K (no quantizer in the JAX package) random
    blocks with small fp16 scales."""
    if qtype not in (GGMLType.Q2_K, GGMLType.Q3_K):
        return quantize((rng.standard_normal((n_rows, n_in)) * 0.1).astype(np.float32), qtype)
    from tpullama.gguf.constants import GGML_TYPE_TRAITS

    tr = GGML_TYPE_TRAITS[qtype]
    nb = n_rows * n_in // tr.block_size
    b = rng.integers(0, 256, (nb, tr.type_size), dtype=np.uint8)
    if qtype == GGMLType.Q2_K:
        b[:, 80:84] = rng.uniform(1e-3, 2e-3, (nb, 2)).astype("<f2").view(np.uint8)
    else:
        b[:, 108:110] = rng.uniform(3e-4, 6e-4, (nb, 1)).astype("<f2").view(np.uint8)
    return b.reshape(-1)


def _experts(qtype, n_rows, n_in, seed, planes_t=False, pad=True):
    """E random experts (n_rows, n_in) repacked: planes (E, rows_p, kcols),
    rows zero-padded to 128 when `pad`, transposed when `planes_t`."""
    rng = np.random.default_rng(seed)
    pqs = [repack(_raw(qtype, n_rows, n_in, rng), qtype, (n_rows, n_in)) for _ in range(E)]
    rows_p = -(-n_rows // 128) * 128 if pad else n_rows
    fields = {k: np.pad(np.stack([pq.fields[k] for pq in pqs]),
                        ((0, 0), (0, rows_p - n_rows), (0, 0)))
              for k in pqs[0].fields}
    if planes_t:
        fields = transpose_planes(fields)
    return fields, pqs[0].group


def _tol(want):
    return dict(rtol=1e-5, atol=1e-4 + 1e-6 * float(np.abs(want).max()))


GATHERED_CASES = [(qt, tt, pt) for qt in (GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0, *LOWBIT)
                  for tt in (1, 8) for pt in (False, True)
                  # Q6_K and the q1/q2 sets are never stored transposed
                  if not (pt and qt in (GGMLType.Q6_K, *LOWBIT))]


@pytest.mark.parametrize("qtype,tile_t,planes_t", GATHERED_CASES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_gathered_plain_matches_jax(qtype, tile_t, planes_t):
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul_gathered as j_gathered

    fields, group = _experts(qtype, F, D, seed=tile_t, planes_t=planes_t)
    rng = np.random.default_rng(50 + tile_t)
    n_tiles = 6
    sel = np.asarray([2, 2, 0, 3, 0, 2], np.int32)[:n_tiles]
    x = rng.standard_normal((n_tiles * tile_t, D)).astype(np.float32)
    got = gq.quantized_matmul_gathered(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in fields.items()},
        torch.from_numpy(sel), qtype, group, F, D, tile_t=tile_t, planes_t=planes_t)
    assert got.dtype == torch.float32 and got.shape == (n_tiles * tile_t, F)
    want = np.asarray(j_gathered(jnp.asarray(x), {k: jnp.asarray(v) for k, v in fields.items()},
                                 jnp.asarray(sel), qtype, group, F, D, tile_t=tile_t,
                                 interpret=True, planes_t=planes_t))
    np.testing.assert_allclose(got.numpy(), want, **_tol(want))


def test_gathered_plain_bf16_scales():
    """bf16 scale planes (the served load's default) in both layouts."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul_gathered as j_gathered

    x = np.random.default_rng(3).standard_normal((16, D)).astype(np.float32)
    sel = np.asarray([1, 3], np.int32)
    for planes_t in (False, True):
        fields, group = _experts(GGMLType.Q4_K, F, D, seed=4, planes_t=planes_t)
        ft = {k: torch.from_numpy(v) for k, v in fields.items()}
        ft = {k: (v.to(torch.bfloat16) if k in ("scale", "minv") else v) for k, v in ft.items()}
        fj = {k: (jnp.asarray(v).astype(jnp.bfloat16) if k in ("scale", "minv")
                  else jnp.asarray(v)) for k, v in fields.items()}
        got = gq.quantized_matmul_gathered(torch.from_numpy(x), ft, torch.from_numpy(sel),
                                           GGMLType.Q4_K, group, F, D, tile_t=8,
                                           planes_t=planes_t).numpy()
        want = np.asarray(j_gathered(jnp.asarray(x), fj, jnp.asarray(sel), GGMLType.Q4_K,
                                     group, F, D, tile_t=8, interpret=True, planes_t=planes_t))
        np.testing.assert_allclose(got, want, **_tol(want))


@pytest.mark.parametrize("S,n_expert,tile_t", [(40, 4, 1), (100, 4, 8), (2048, 8, 8), (7, 8, 8)])
def test_moe_dispatch_matches_jax(S, n_expert, tile_t):
    import jax.numpy as jnp

    from tpullama.ops import moe as j_moe

    sel = np.random.default_rng(S).integers(0, n_expert, S).astype(np.int32)
    if S == 7:
        sel[:] = 5  # one expert takes every slot; the others none
    pj, tj, rj, Pj = j_moe.moe_dispatch(jnp.asarray(sel), n_expert, tile_t)
    pt, tt_, rt, Pt = t_moe.moe_dispatch(torch.from_numpy(sel), n_expert, tile_t)
    assert Pt == Pj
    for a, b in ((pt, pj), (tt_, tj), (rt, rj)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _router_inputs(T, seed=0, B=1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, D)) * 0.3).astype(np.float32)
    gate_inp = (rng.standard_normal((E, D)) * 0.05).astype(np.float32)
    return x, gate_inp


def _dense_experts(seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in ((E, F, D), (E, F, D), (E, D, F))]


@pytest.mark.parametrize("T", [1, 40])
@pytest.mark.parametrize("opts", [
    dict(),
    dict(gating=t_moe.GATING_SIGMOID, norm_w=False, w_scale=2.5),
    dict(gating=t_moe.GATING_SOFTMAX_WEIGHT),
    dict(bias=True),
], ids=["softmax", "sigmoid-wscale", "softmax-weight", "biases"])
def test_moe_ffn_dense_matches_jax(T, opts):
    import jax.numpy as jnp

    from tpullama.ops import moe as j_moe

    x, gate_inp = _router_inputs(T, seed=T, B=2)
    g, u, d = _dense_experts(7)
    kw = dict(opts)
    if kw.pop("bias", False):
        rng = np.random.default_rng(9)
        kw["exp_probs_b"] = (0.3 * rng.standard_normal(E)).astype(np.float32)
        kw["gate_inp_b"] = (0.1 * rng.standard_normal(E)).astype(np.float32)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = np.asarray(j_moe.moe_ffn(jnp.asarray(x), jnp.asarray(gate_inp), jnp.asarray(g),
                                    jnp.asarray(u), jnp.asarray(d), n_expert_used=2, **jkw))
    got = t_moe.moe_ffn(torch.from_numpy(x), torch.from_numpy(gate_inp), torch.from_numpy(g),
                        torch.from_numpy(u), torch.from_numpy(d), n_expert_used=2, **tkw)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T", [1, 40])  # 2 and 80 slots: one-row tiles, then the dispatch
@pytest.mark.parametrize("layout", ["split", "fused", "fused-planes_t"])
def test_moe_ffn_packed_matches_jax(T, layout):
    import jax.numpy as jnp

    from tpullama.models.loader import QuantMeta as JQuantMeta
    from tpullama.ops import moe as j_moe

    qt = GGMLType.Q4_0  # blocks of 32, so down can contract K = F = 320
    planes_t = layout == "fused-planes_t"
    x, gate_inp = _router_inputs(T, seed=11)
    g, group = _experts(qt, F, D, 1, planes_t, pad=layout != "split")
    u, _ = _experts(qt, F, D, 2, planes_t, pad=layout != "split")
    dn, _ = _experts(qt, D, F, 3, planes_t)
    if layout == "split":  # 2-D (E * F, kcols) planes, as the JAX package's tests pass them
        g, u = ({k: v.reshape(E * F, -1) for k, v in a.items()} for a in (g, u))
        stacks = (g, u, dn)
        shapes = {"gate": (E * F, D), "up": (E * F, D), "down": (E * D, F)}
    else:  # per expert [gate rows_p | up rows_p] on the rows axis of the layout
        axis = -1 if planes_t else -2
        stacks = (None, {k: np.concatenate([g[k], u[k]], axis=axis) for k in g}, dn)
        shapes = {"gateup": (E * 2 * 384, D), "down": (E * D, F)}
    jm = {k: JQuantMeta(qt, group, *s, planes_t=planes_t) for k, s in shapes.items()}
    tm = {k: TQuantMeta(qt, group, *s, planes_t=planes_t) for k, s in shapes.items()}
    want = np.asarray(j_moe.moe_ffn(
        jnp.asarray(x), jnp.asarray(gate_inp),
        *[None if a is None else {k: jnp.asarray(v) for k, v in a.items()} for a in stacks],
        n_expert_used=2, quant_meta_exps=jm))
    got = t_moe.moe_ffn(
        torch.from_numpy(x), torch.from_numpy(gate_inp),
        *[None if a is None else {k: torch.from_numpy(v) for k, v in a.items()} for a in stacks],
        n_expert_used=2, quant_meta_exps=tm)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T", [1, 40])
@pytest.mark.parametrize("qtype", [GGMLType.Q5_K, GGMLType.Q3_K, GGMLType.Q2_K],
                         ids=lambda t: t.name)
def test_moe_ffn_lowbit_experts_match_jax(qtype, T):
    """moe_ffn over fused [gate | up] and down stacks in a q1/q2 set (K =
    256 both ways: D and an FFN of 256; row-major, as the loader keeps
    them) against the JAX package's moe_ffn, whose gathered kernel runs in
    interpret mode: one-row tiles (T = 1) and the dispatch's 8-row tiles
    (T = 40)."""
    import jax.numpy as jnp

    from tpullama.models.loader import QuantMeta as JQuantMeta
    from tpullama.ops import moe as j_moe

    Fl = 256
    x, gate_inp = _router_inputs(T, seed=12)
    g, group = _experts(qtype, Fl, D, 1)
    u, _ = _experts(qtype, Fl, D, 2)
    dn, _ = _experts(qtype, D, Fl, 3)
    gu = {k: np.concatenate([g[k], u[k]], axis=-2) for k in g}
    shapes = {"gateup": (E * 2 * Fl, D), "down": (E * D, Fl)}
    jm = {k: JQuantMeta(qtype, group, *v) for k, v in shapes.items()}
    tm = {k: TQuantMeta(qtype, group, *v) for k, v in shapes.items()}
    want = np.asarray(j_moe.moe_ffn(
        jnp.asarray(x), jnp.asarray(gate_inp), None, {k: jnp.asarray(v) for k, v in gu.items()},
        {k: jnp.asarray(v) for k, v in dn.items()}, n_expert_used=2, quant_meta_exps=jm))
    got = t_moe.moe_ffn(
        torch.from_numpy(x), torch.from_numpy(gate_inp), None,
        {k: torch.from_numpy(v) for k, v in gu.items()},
        {k: torch.from_numpy(v) for k, v in dn.items()}, n_expert_used=2, quant_meta_exps=tm)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def _tile_body_values(fields, qtype, K):
    """The integers the tensor-core tile body (csrc/qmm_mma.cuh) assembles
    for every row, emulated: for each 32-position chunk c, the byte runs a
    weight thread copies (mma_copy_w: the low plane's run; Q5 and Q3 the
    q1 plane's run at Geo::high_byte) and how decode_vals unpacks them
    (Q5's bits 4 j + hs, Q3's bits 2 j + hs, hs = Geo::high_shift), placed
    at the stored positions Geo::seg_start gives. Returns (rows, K) int."""
    nseg = 1 if qtype == GGMLType.Q8_0 else 2 if qtype in (GGMLType.Q4_K, *LOWBIT[:3]) else 4
    seg = 32 // nseg
    f = {k: v.astype(np.int64) for k, v in fields.items()}
    rows = next(iter(f.values())).shape[0]
    out = np.full((rows, K), -1, np.int64)
    for c in range(K // 32):
        hb, hs = seg * c % (K // 8), (128 * c // K if nseg == 2 else 64 * c // K)
        if qtype in (GGMLType.Q4_K, *LOWBIT[:3]):
            q = f["q4"][:, 16 * c:16 * c + 16]
            w = [q & 15, q >> 4]
            if "q1" in f:
                h = f["q1"][:, hb:hb + 16] >> hs
                w = [w[0] | (h & 1) << 4, w[1] | ((h >> 4) & 1) << 4]
        elif qtype == GGMLType.Q6_K:
            a = f["q4"][:, 8 * c:8 * c + 8]
            b = f["q4"][:, K // 4 + 8 * c:K // 4 + 8 * c + 8]
            h = f["q2"][:, 8 * c:8 * c + 8]
            w = [(a & 15) | (h & 3) << 4, (b & 15) | ((h >> 2) & 3) << 4,
                 (a >> 4) | ((h >> 4) & 3) << 4, (b >> 4) | ((h >> 6) & 3) << 4]
        elif qtype in (GGMLType.Q3_K, GGMLType.Q2_K):
            a = f["q2"][:, 8 * c:8 * c + 8]
            w = [(a >> (2 * j)) & 3 for j in range(4)]
            if "q1" in f:
                h = f["q1"][:, hb:hb + 8] >> hs
                w = [w[j] | ((h >> (2 * j)) & 1) << 2 for j in range(4)]
        else:
            w = [f["q8"][:, 32 * c:32 * c + 32]]
        for j in range(nseg):
            p0 = j * (K // nseg) + seg * c
            out[:, p0:p0 + seg] = w[j]
    return out


@pytest.mark.parametrize("K", [256, 768, 2560])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, *LOWBIT], ids=lambda t: t.name)
def test_tile_body_unpacks_every_set(qtype, K):
    """The tile body's chunk layout and unpacking, emulated on the CPU
    (_tile_body_values), give every stored position exactly the integer
    the plain version dequantizes (dequant_stored with unit scales and no
    mins): for the q1/q2 sets the tile routes of the row-major gathered
    kernel now take, and the Q4_K and Q6_K sets they took before."""
    from tpullama_torch.ops.cuda.qmm import dequant_stored

    pq = repack(_raw(qtype, 8, K, np.random.default_rng(K)), qtype, (8, K))
    G = K // pq.group
    unit = {k: (np.ones((8, G), np.float32) if k == "scale" else
                np.zeros((8, G), np.float32) if k == "minv" else v)
            for k, v in pq.fields.items()}
    want = dequant_stored({k: torch.from_numpy(v) for k, v in unit.items()}, qtype,
                          pq.group).numpy()
    got = _tile_body_values(pq.fields, qtype, K)
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("option", [
    dict(x_router=np.zeros((1, 1, D), np.float32)),
    dict(select_sigmoid=True), dict(expert_div=2),
    dict(ep_axis="ep"), dict(act="gelu"), dict(act="relu"),
], ids=lambda o: next(iter(o)) + ("=" + o["act"] if "act" in o else ""))
def test_moe_ffn_refuses_options_not_ported(option):
    x, gate_inp = _router_inputs(1)
    g, u, d = (torch.from_numpy(a) for a in _dense_experts(7))
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in option.items()}
    name = next(iter(option))
    with pytest.raises(NotImplementedError, match=name):
        t_moe.moe_ffn(torch.from_numpy(x), torch.from_numpy(gate_inp), g, u, d,
                      n_expert_used=2, **kw)


@pytest.mark.parametrize("tile_t", [1, 8])
@pytest.mark.parametrize("planes_t", [False, True], ids=["row_major", "planes_t"])
def test_gathered_plain_is_batch_invariant(planes_t, tile_t):
    """The plain gathered product multiplies fixed tiles of tile_t rows, as
    the reference's grid does: a tile's rows come out bit for bit the same
    alone, among other tiles of its expert, and in a call of another
    height (so the CPU MoE serve's greedy rerun equals its first run)."""
    qtype = GGMLType.Q4_K
    fields, group = _experts(qtype, F, D, seed=7, planes_t=planes_t)
    ft = {k: torch.from_numpy(v) for k, v in fields.items()}
    rng = np.random.default_rng(7)
    sel = torch.tensor([2, 0, 2, 2, 1, 0, 2], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((len(sel) * tile_t, D)).astype(np.float32))

    def run(tiles):
        rows = torch.cat([x[t * tile_t:(t + 1) * tile_t] for t in tiles])
        return gq.quantized_matmul_gathered(rows, ft, sel[list(tiles)], qtype, group, F, D,
                                            tile_t=tile_t, planes_t=planes_t)

    full = run(range(len(sel)))
    for tiles in ([3], [3, 0], [6, 5, 4, 3, 2, 1, 0], [2, 3, 3, 3, 0]):
        got = run(tiles)
        for i, t in enumerate(tiles):
            assert torch.equal(got[i * tile_t:(i + 1) * tile_t],
                               full[t * tile_t:(t + 1) * tile_t])


# (tiles, experts, sorted): 1-63 one-row tiles (the decode range, below
# DISPATCH_MIN_SLOTS) over 2-8 experts
_PLAN_CASES = [(n, e, srt) for n, e in ((1, 2), (4, 2), (5, 8), (8, 2), (8, 6), (8, 8), (9, 3),
                                        (20, 3), (31, 4), (40, 2), (62, 8), (63, 8))
               for srt in (False, True)]


@pytest.mark.parametrize("n_tiles,n_expert,sort", _PLAN_CASES)
def test_run_plan_covers_each_tile_once(n_tiles, n_expert, sort):
    """The one-row kernel's run plan (each block finds its run on the card
    by the same rule): every tile in exactly one run, a run's tiles share
    one expert and come in tile order, at most RUN_CAP of them, and an
    expert picked by c tiles is read ceil(c / RUN_CAP) times."""
    rng = np.random.default_rng(n_tiles * 10 + n_expert)
    sel = rng.integers(0, n_expert, n_tiles)
    if sort:
        sel = np.sort(sel)
    plan = gq.run_plan(torch.from_numpy(sel))
    cap = gq.RUN_CAP
    assert sorted(t for run in plan for t in run) == list(range(n_tiles))
    for run in plan:
        assert 1 <= len(run) <= cap and run == sorted(run)
        assert len({int(sel[t]) for t in run}) == 1
    for e in set(sel.tolist()):
        count = int((sel == e).sum())
        assert sum(1 for run in plan if sel[run[0]] == e) == -(-count // cap)


def test_run_cap():
    """The wrapper's run cap is the kernels' (GATHER_RUN, in the header both
    gathered sources include), 4: one expert picked by 20 tiles is read in
    5 runs of 4, interleaved tiles keep their order."""
    src = (Path(gq.__file__).parents[2] / "csrc" / "qmm_gathered.cuh").read_text()
    assert f"constexpr int GATHER_RUN = {gq.RUN_CAP};" in src
    assert gq.RUN_CAP == 4
    assert gq.run_plan([2] * 20) == [list(range(i, i + 4)) for i in range(0, 20, 4)]
    assert gq.run_plan([0, 1, 0, 1, 0, 0, 0]) == [[0, 2, 4, 5], [1, 3], [6]]


def _fma(a, b, c):
    """fmaf in f32: the exact product and sum in f64, rounded once (the
    f32 operands' product is exact in f64)."""
    f64 = [np.asarray(v, np.float64) for v in (a, b, c)]
    return (f64[0] * f64[1] + f64[2]).astype(np.float32)


def _t_values(fields, qtype, e, K):
    """q[n, c, a] of expert e as the transposed one-row body makes them: the
    4-byte words of byte row j*G + c hold rows 4i .. 4i + 3 (Q4: low nibble
    a = j, high a = j + 16; Q8_0: a = j), each byte shifted out of its word,
    placed in the mantissa of 2^23 (bytes 0x00 0x00 0x4B above it) and 2^23
    taken off (Q8_0's signed bytes biased by 128 first, so 2^23 + 128)."""
    G = K // 32
    plane = fields["q8" if qtype == GGMLType.Q8_0 else "q4"][e]
    words = np.ascontiguousarray(plane).view(np.uint32)  # (kcols, R / 4)
    if qtype == GGMLType.Q8_0:
        words = (words ^ np.uint32(0x80808080)).reshape(32, G, -1)  # (a, c, word)
        bias = 2.0 ** 23 + 128
    else:
        w = words.reshape(16, G, -1)
        words = np.concatenate([w & np.uint32(0x0F0F0F0F), (w >> 4) & np.uint32(0x0F0F0F0F)])
        bias = 2.0 ** 23
    lanes = [((words >> np.uint32(8 * i)) & np.uint32(0xFF)) | np.uint32(0x4B000000)
             for i in range(4)]  # byte i of a word: row 4 * word + i
    v = np.stack(lanes, axis=-1).reshape(32, G, -1).view(np.float32) - np.float32(bias)
    return v.transpose(2, 1, 0)  # (R, G, 32)


def _t_body_emulated(x, fields, sel, qtype, K, N):
    """y of the transposed one-row kernel, computed as it computes it, in
    f32: for each run (gq.run_plan) its tiles' x staged by scale column with
    each column's sum over a in order; per (row, x row, column) the values
    times x summed by fmaf in the body's order (Q4: a = j then j + 16 for j
    < 16; Q8_0: a in order); each column folded once, part = fmaf(scale,
    sum, part) then fmaf(-minv, xsum, part); a split's 8 streams take its
    columns stream, stream + 8, ... and meet in stream order; the splits of
    T_SPLIT_COLS columns meet in split order."""
    G = K // 32
    order = [a for j in range(16) for a in (j, j + 16)] if qtype != GGMLType.Q8_0 else range(32)
    cols, streams = gq.T_SPLIT_COLS, 8
    y = np.zeros((len(sel), N), np.float32)
    for run in gq.run_plan(sel):
        e = int(sel[run[0]])
        q = _t_values(fields, qtype, e, K)[:N]  # (N, G, 32)
        xr = x[run].reshape(len(run), G, 32)
        xsum = np.zeros((len(run), G), np.float32)
        for a in range(32):
            xsum = xsum + xr[:, :, a]
        acc = np.zeros((N, len(run), G), np.float32)
        for a in order:
            acc = _fma(q[:, None, :, a], xr[None, :, :, a], acc)
        sc = np.asarray(fields["scale"][e][:G, :N], np.float32).T  # (N, G)
        mn = np.asarray(fields["minv"][e][:G, :N], np.float32).T if "minv" in fields else None
        total = None
        for c0 in range(0, G, cols):
            block = None
            for m in range(streams):
                part = np.zeros((N, len(run)), np.float32)
                for c in range(c0 + m, min(c0 + cols, G), streams):
                    part = _fma(sc[:, c, None], acc[:, :, c], part)
                    if mn is not None:
                        part = _fma(-mn[:, c, None], xsum[None, :, c], part)
                block = part if block is None else block + part
            total = block if total is None else total + block
        y[run] = total.T
    return y


@pytest.mark.parametrize("run", [1, 2, 4])
@pytest.mark.parametrize("n_in", [768, 4096])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0], ids=lambda t: t.name)
def test_one_row_gathered_t_body_arithmetic_is_within_kernel_tolerance(qtype, n_in, run):
    """The transposed one-row body's arithmetic (_t_body_emulated: the word
    unpacking of 4 rows a word, the per-(row, column) sums in the kernel's
    order, the fold with the hoisted min term, streams and splits) over two
    runs of `run` tiles against the plain version and the JAX package's
    _qmm_gathered_t (interpret), within the kernels' tolerance, 1e-4 of the
    output's max. K = 768 is one split of 24 columns, 4096 four of 32."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul_gathered as j_gathered

    fields, group = _experts(qtype, F, n_in, seed=run, planes_t=True)
    sel = np.repeat(np.asarray([2, 0], np.int32), run)
    assert [len(r) for r in gq.run_plan(sel)] == [run, run]
    x = np.random.default_rng(60 + run).standard_normal((len(sel), n_in)).astype(np.float32)
    got = _t_body_emulated(x, fields, sel, qtype, n_in, F)
    want = gq.quantized_matmul_gathered_plain(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in fields.items()},
        torch.from_numpy(sel), qtype, group, F, n_in, planes_t=True).numpy()
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())
    want_jax = np.asarray(j_gathered(jnp.asarray(x), {k: jnp.asarray(v) for k, v in fields.items()},
                                     jnp.asarray(sel), qtype, group, F, n_in, tile_t=1,
                                     interpret=True, planes_t=True))
    assert float(np.abs(got - want_jax).max()) <= 1e-4 * float(np.abs(want_jax).max())


def test_transposed_split_width():
    """The wrapper's split width is the kernel's (GT_COLS): Mixtral's down
    (K = 14336, 448 columns) runs in 14 splits, K = 768 in one."""
    src = (Path(gq.__file__).parents[2] / "csrc" / "qmm_gathered_t.cuh").read_text()
    assert f"constexpr int GT_COLS = {gq.T_SPLIT_COLS};" in src
    assert [gq.t_splits(K) for K in (768, 1024, 4096, 14336)] == [1, 1, 4, 14]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the gathered qmm kernels run on a CUDA card only")
    return torch.device("cuda")


def test_routes():
    """Tiles of more than one row run a tensor-core route in both plane
    layouts; one-row tiles a CUDA-core body (the decode body over runs of
    tiles for row-major planes)."""
    assert [gq.route(tt, pt) for pt in (False, True) for tt in (2, 8)] == ["mma"] * 4
    assert [gq.route(1, pt) for pt in (False, True)] == ["gemv"] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("tile_t", [1, 2, 8])
@pytest.mark.parametrize("qtype,planes_t", [(GGMLType.Q4_K, False), (GGMLType.Q6_K, False),
                                            (GGMLType.Q8_0, False), (GGMLType.Q4_K, True),
                                            (GGMLType.Q8_0, True)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_gathered_kernel_matches_plain(cuda, qtype, planes_t, tile_t):
    """Each kernel against its plain version at K = 1024 (the row-major
    kernel's Q8_0 K multiple), padded rows, f32 and bf16 scales: the
    kernels sum in f32 in another order, so 1e-4 of the output's scale."""
    n_rows, n_in = F, 1024
    fields, group = _experts(qtype, n_rows, n_in, seed=tile_t, planes_t=planes_t)
    rng = np.random.default_rng(tile_t)
    sel = torch.tensor([3, 1, 1, 0, 3], dtype=torch.int32, device=cuda)
    x = torch.from_numpy(rng.standard_normal((5 * tile_t, n_in)).astype(np.float32)).to(cuda)
    for sdt in (torch.float32, torch.bfloat16):
        ft = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
              for k, v in fields.items()}
        name = "qmm_gathered_t" if planes_t else "qmm_gathered"
        before = gq.LAUNCHES[name]
        got = gq.quantized_matmul_gathered(x, ft, sel, qtype, group, n_rows, n_in,
                                           tile_t=tile_t, planes_t=planes_t)
        assert gq.LAUNCHES[name] == before + 1
        want = gq.quantized_matmul_gathered_plain(x, ft, sel, qtype, group, n_rows, n_in,
                                                  tile_t=tile_t, planes_t=planes_t)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("qtype,planes_t,tt", [
    (GGMLType.Q4_K, False, 8), (GGMLType.Q6_K, False, 8), (GGMLType.Q8_0, False, 8),
    (GGMLType.Q4_K, True, 2), (GGMLType.Q4_K, True, 8), (GGMLType.Q8_0, True, 2),
    (GGMLType.Q8_0, True, 8), *[(qt, False, 8) for qt in LOWBIT]],
    ids=lambda v: getattr(v, "name", str(v)))
def test_gathered_mma_route_over_expert_runs(cuda, qtype, planes_t, tt):
    """Both kernels' tensor-core routes (row-major planes: qmm_mma.cuh,
    16 tiles per block; transposed: qmm_group_mma.cuh, 8): 24 tiles whose
    expert runs of 3, 5, 9 and 7 tiles straddle the blocks, zero rows at
    the end of each run and one whole tile of zero rows (moe_dispatch's
    padding), N = 320 of R = 384 stored rows, f32 and bf16 scales. Against
    the plain version at 1e-4 of the output's max; zero rows give exactly
    0; and a tile computed alone equals, bit for bit, the same tile inside
    the 24-tile call."""
    n_rows, n_in = F, 1024
    runs = (3, 5, 9, 7)
    name = "qmm_gathered_t" if planes_t else "qmm_gathered"
    fields, group = _experts(qtype, n_rows, n_in, seed=24, planes_t=planes_t)
    sel = torch.tensor(np.repeat([2, 0, 3, 1], runs), dtype=torch.int32, device=cuda)
    x = np.random.default_rng(24).standard_normal((sum(runs) * tt, n_in)).astype(np.float32)
    zero = np.zeros(len(x), bool)
    for end in np.cumsum(runs) * tt:
        zero[end - 3:end] = True
    zero[10 * tt:11 * tt] = True
    x[zero] = 0.0
    xx = torch.from_numpy(x).to(cuda)
    for sdt in (torch.float32, torch.bfloat16):
        ft = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
              for k, v in fields.items()}
        before = gq.LAUNCHES[name]
        got = gq.quantized_matmul_gathered(xx, ft, sel, qtype, group, n_rows, n_in, tile_t=tt,
                                           planes_t=planes_t)
        assert gq.LAUNCHES[name] == before + 1
        want = gq.quantized_matmul_gathered_plain(xx, ft, sel, qtype, group, n_rows, n_in,
                                                  tile_t=tt, planes_t=planes_t)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-5
        assert not got[torch.from_numpy(zero).to(cuda)].any()
        for t in (2, 9, 16, 23):
            alone = gq.quantized_matmul_gathered(xx[t * tt:(t + 1) * tt], ft, sel[t:t + 1], qtype,
                                                 group, n_rows, n_in, tile_t=tt,
                                                 planes_t=planes_t)
            assert torch.equal(alone, got[t * tt:(t + 1) * tt])


# sel patterns of one-row tiles: shared experts, all distinct, one expert
# for 20 tiles (5 runs of 4), and unsorted with repeats
_ONE_ROW_SELS = {"repeats": [3, 1, 1, 0, 3, 2, 2, 0], "distinct": [2, 0, 3, 1],
                 "one-expert-20": [2] * 20,
                 "unsorted": [1, 3, 0, 1, 2, 3, 3, 0, 1, 2, 1, 0, 3]}


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", sorted(_ONE_ROW_SELS))
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0, *LOWBIT],
                         ids=lambda t: t.name)
def test_one_row_gathered_kernel_matches_plain(cuda, qtype, pattern):
    """Row-major one-row tiles on the decode body over runs of tiles that
    share an expert: against the plain version at 1e-4 of the output's
    max, f32 and bf16 scales, f32 and bf16 x, K = 4096 and N = 320 of 384
    stored rows."""
    n_in = 4096
    fields, group = _experts(qtype, F, n_in, seed=len(pattern))
    sel = torch.tensor(_ONE_ROW_SELS[pattern], dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(len(sel))
    x = torch.from_numpy(rng.standard_normal((len(sel), n_in)).astype(np.float32)).to(cuda)
    for sdt in (torch.float32, torch.bfloat16):
        ft = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
              for k, v in fields.items()}
        for xx in (x, x.to(torch.bfloat16)):
            want = gq.quantized_matmul_gathered_plain(xx, ft, sel, qtype, group, F, n_in)
            before = gq.LAUNCHES["qmm_gathered"]
            got = gq.quantized_matmul_gathered(xx, ft, sel, qtype, group, F, n_in)
            assert gq.LAUNCHES["qmm_gathered"] == before + 1
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got).all())
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0, *LOWBIT],
                         ids=lambda t: t.name)
def test_one_row_gathered_rows_do_not_depend_on_sharing(cuda, qtype):
    """A one-row tile's output is bit for bit the same computed alone and
    inside runs of 2 to 4 tiles that share its expert (the body's rows do
    not depend on T)."""
    n_in = 1024
    fields, group = _experts(qtype, F, n_in, seed=11)
    ft = {k: torch.from_numpy(v).to(cuda, torch.bfloat16 if k in ("scale", "minv") else None)
          for k, v in fields.items()}
    sel = torch.tensor([1, 1, 2, 1, 1, 1, 0, 1, 1, 1, 3, 1], dtype=torch.int32, device=cuda)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((len(sel), n_in))
                         .astype(np.float32)).to(cuda)
    full = gq.quantized_matmul_gathered(x, ft, sel, qtype, group, F, n_in)
    for t in range(len(sel)):
        alone = gq.quantized_matmul_gathered(x[t:t + 1], ft, sel[t:t + 1], qtype, group, F,
                                             n_in)
        assert torch.equal(alone[0], full[t])
    pair = gq.quantized_matmul_gathered(x[:2], ft, sel[:2], qtype, group, F, n_in)
    assert torch.equal(pair, full[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", sorted(_ONE_ROW_SELS))
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0], ids=lambda t: t.name)
def test_one_row_gathered_t_kernel_matches_plain(cuda, qtype, pattern):
    """Transposed one-row tiles on the decode body's arithmetic over runs of
    tiles that share an expert: against the plain version at 1e-4 of the
    output's max, f32 and bf16 scales, K = 4096 (4 column splits) and N =
    320 of 384 stored rows."""
    n_in = 4096
    fields, group = _experts(qtype, F, n_in, seed=len(pattern), planes_t=True)
    sel = torch.tensor(_ONE_ROW_SELS[pattern], dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(len(sel))
    x = torch.from_numpy(rng.standard_normal((len(sel), n_in)).astype(np.float32)).to(cuda)
    for sdt in (torch.float32, torch.bfloat16):
        ft = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
              for k, v in fields.items()}
        want = gq.quantized_matmul_gathered_plain(x, ft, sel, qtype, group, F, n_in,
                                                  planes_t=True)
        before = gq.LAUNCHES["qmm_gathered_t"]
        got = gq.quantized_matmul_gathered(x, ft, sel, qtype, group, F, n_in, planes_t=True)
        assert gq.LAUNCHES["qmm_gathered_t"] == before + 1
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("qtype,n_in", [(GGMLType.Q4_K, 1024), (GGMLType.Q8_0, 1024),
                                        (GGMLType.Q4_K, 4096)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_one_row_gathered_t_rows_do_not_depend_on_sharing(cuda, qtype, n_in):
    """A transposed one-row tile's output is bit for bit the same computed
    alone and inside runs of 2 to 4 tiles that share its expert (no order
    of the body depends on T), with f32 and bf16 scales."""
    fields, group = _experts(qtype, F, n_in, seed=13, planes_t=True)
    sel = torch.tensor([1, 1, 2, 1, 1, 1, 0, 1, 1, 1, 3, 1], dtype=torch.int32, device=cuda)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal((len(sel), n_in))
                         .astype(np.float32)).to(cuda)
    for sdt in (torch.float32, torch.bfloat16):
        ft = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
              for k, v in fields.items()}
        full = gq.quantized_matmul_gathered(x, ft, sel, qtype, group, F, n_in, planes_t=True)
        for t in range(len(sel)):
            alone = gq.quantized_matmul_gathered(x[t:t + 1], ft, sel[t:t + 1], qtype, group, F,
                                                 n_in, planes_t=True)
            assert torch.equal(alone[0], full[t])
        pair = gq.quantized_matmul_gathered(x[:2], ft, sel[:2], qtype, group, F, n_in,
                                            planes_t=True)
        assert torch.equal(pair, full[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 768, 2560, 4096])
@pytest.mark.parametrize("tile_t", [1, 2, 8])
@pytest.mark.parametrize("qtype", LOWBIT, ids=lambda t: t.name)
def test_lowbit_gathered_kernel_matches_plain(cuda, qtype, tile_t, K):
    """The row-major kernel on the q1/q2 sets (csrc/qmm_gathered_lowbit.cu)
    against its plain version at every K the loader packs that the served
    archs have (256; 768, Qwen3-30B-A3B's down; 2560, Qwen2-57B-A14B's
    down; 4096), one-row tiles (the decode body) and tiles of 2 and 8 rows
    (the tensor-core body), f32 and bf16 x and scales, N = 320 of 384
    stored rows, runs over repeated experts: 1e-4 of the output's max."""
    fields, group = _experts(qtype, F, K, seed=K + tile_t)
    rng = np.random.default_rng(K + tile_t)
    sel = torch.tensor([3, 1, 1, 0, 3, 3, 2, 1, 1, 1, 1, 1], dtype=torch.int32, device=cuda)
    x = torch.from_numpy(rng.standard_normal((len(sel) * tile_t, K)).astype(np.float32))
    x = x.to(cuda)
    for sdt in (torch.float32, torch.bfloat16):
        ft = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
              for k, v in fields.items()}
        for xx in (x, x.to(torch.bfloat16)):
            before = gq.LAUNCHES["qmm_gathered"]
            got = gq.quantized_matmul_gathered(xx, ft, sel, qtype, group, F, K, tile_t=tile_t)
            assert gq.LAUNCHES["qmm_gathered"] == before + 1
            want = gq.quantized_matmul_gathered_plain(xx, ft, sel, qtype, group, F, K,
                                                      tile_t=tile_t)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got).all())
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("planes_t", [False, True])
def test_gathered_kernel_raises_without_fallback(cuda, planes_t):
    """A field set the kernels do not cover (Q4_K's planes without their
    min plane) raises on a CUDA tensor in either layout, naming what they
    take; it does not run the plain version."""
    fields, group = _experts(GGMLType.Q4_K, 256, 1024, seed=0, planes_t=planes_t)
    ft = {k: torch.from_numpy(v).to(cuda) for k, v in fields.items() if k != "minv"}
    x = torch.zeros((2, 1024), device=cuda)
    sel = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = dict(gq.LAUNCHES)
    with pytest.raises(NotImplementedError, match="MXFP4"):
        gq.quantized_matmul_gathered(x, ft, sel, GGMLType.Q4_K, group, 256, 1024,
                                     planes_t=planes_t)
    assert gq.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("qtype,planes_t,n_in", [
    (GGMLType.Q4_K, False, 768), (GGMLType.Q6_K, False, 768), (GGMLType.Q8_0, False, 512),
    (GGMLType.Q8_0, False, 3584), (GGMLType.Q4_K, True, 768), (GGMLType.Q4_K, True, 8960),
    (GGMLType.Q8_0, True, 3584)], ids=lambda v: getattr(v, "name", str(v)))
def test_gathered_kernel_takes_every_loader_width(cuda, qtype, planes_t, n_in):
    """Both gathered kernels at widths they refused before (row-major:
    K % 512 / 1024; transposed tiles of more than one row: K % 512), one-row
    and 8-row tiles, f32 and bf16 scales. 768 and 8960 give 24 and 280
    scale columns: whole 4-column slices, a partial 16-column weight box;
    3584 gives 112."""
    fields, group = _experts(qtype, F, n_in, seed=n_in, planes_t=planes_t)
    rng = np.random.default_rng(n_in)
    sel = torch.tensor([3, 1, 1, 0, 3, 2, 2, 0], dtype=torch.int32, device=cuda)
    name = "qmm_gathered_t" if planes_t else "qmm_gathered"
    for tt in (1, 8):
        x = torch.from_numpy(rng.standard_normal((len(sel) * tt, n_in)).astype(np.float32))
        x = x.to(cuda)
        for sdt in (torch.float32, torch.bfloat16):
            ft = {k: torch.from_numpy(v).to(cuda, sdt if k in ("scale", "minv") else None)
                  for k, v in fields.items()}
            before = gq.LAUNCHES[name]
            got = gq.quantized_matmul_gathered(x, ft, sel, qtype, group, F, n_in, tile_t=tt,
                                               planes_t=planes_t)
            assert gq.LAUNCHES[name] == before + 1
            want = gq.quantized_matmul_gathered_plain(x, ft, sel, qtype, group, F, n_in,
                                                      tile_t=tt, planes_t=planes_t)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.fixture
def moe_768(tmp_path_factory):
    """One Mixtral-wide MoE layer (n_embd 4096, 4 experts) whose experts'
    FFN is 768 wide, Q4_K: ffn_down's 24 scale columns are no multiple of
    128, so the loader stores it transposed, with K = 768. Its one user is
    a card test, so it is written per test, after the `cuda` fixture has
    skipped where there is no card (a module fixture would be written
    before it)."""
    from tpullama.models.testing import make_tiny_llama_gguf

    p = str(tmp_path_factory.mktemp("moe768") / "m.gguf")
    make_tiny_llama_gguf(p, n_embd=4096, n_head=32, n_head_kv=8, n_ff=768, n_layer=1,
                         n_expert=4, n_expert_used=2, qtype=GGMLType.Q4_K, seed=5)
    return p


@pytest.mark.cuda
def test_transposed_prefill_at_k768(cuda, moe_768):
    """A 40-token prefill (80 slots, tiles of 8 through the dispatch) of
    that layer: qmm_gathered_t runs its tensor-core route at K = 768 on the
    card, and the logits match the CPU's plain versions."""
    from tpullama_torch.models import load_model
    from tpullama_torch.runtime import Context, ContextParams

    gpu = load_model(moe_768, device="cuda", packed=True)
    cpu = load_model(moe_768, device="cpu", packed=True)
    assert gpu.quant_meta["layers"]["ffn_down_exps"].planes_t
    toks = np.asarray(gpu.vocab.tokenize(
        "The quick brown fox jumps over the lazy dog, twice.", add_special=True))
    assert len(toks) * 2 >= 64
    before = gq.LAUNCHES["qmm_gathered_t"]
    lg = Context(gpu, ContextParams(n_ctx=96)).decode(toks, n_logits=len(toks))
    assert gq.LAUNCHES["qmm_gathered_t"] > before
    lc = Context(cpu, ContextParams(n_ctx=96)).decode(toks, n_logits=len(toks))
    assert float(np.abs(lg - lc).max()) <= 1e-3 * float(np.abs(lc).max()) + 1e-4
