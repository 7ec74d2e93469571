"""The port's fused post-attention step (tpullama_torch/ops/cuda/fused_layer.py)
held against the JAX package's fused_postattn (ops/pallas/fused_layer.py,
run in interpret mode) and a numpy f32 oracle, on random {q4, scale, minv}
planes in fourblock order at E = Dq = 256 and 4096; its eligibility rule
fused_ok against the reference's on metadata. The CUDA kernel runs only on
the card (marked cuda).

Tolerances: the plain version dequantizes exactly and sums in f32, so it
meets the numpy oracle within f32 accumulation noise (rtol 1e-5, atol 1e-5
of the output's max). The reference kernel rounds weights and
activations to bf16 before its dots (fused_layer.py:101-104), so against
it the tolerance is its own test's bf16-sized 3e-2 (tests/test_fused_layer.py)."""

import numpy as np
import pytest
import torch

from tpullama.gguf import GGMLType
from tpullama.ops.qweights import PlanarQuant, dequant_planar_np
from tpullama_torch.ops.cuda import fused_layer as tf

G = 32
EPS = 1e-5


def _planes(rng, n_out, n_in):
    """Random fourblock {q4, scale, minv} planes whose values have mean
    near 0 and std near 0.02 / sqrt(n_in / 4096) (a layer's weights)."""
    s = (4.4e-3 * np.sqrt(4096 / n_in) * rng.uniform(0.8, 1.2, (n_out, n_in // G))
         ).astype(np.float32)
    return {"q4": rng.integers(0, 256, (n_out, n_in // 2), dtype=np.uint8),
            "scale": s, "minv": (7.5 * s).astype(np.float32)}


def _dense(fields, n_out, n_in):
    return dequant_planar_np(PlanarQuant(GGMLType.Q4_K, (n_out, n_in), fields, G,
                                         order="fourblock"))


def _inputs(E, Fd, seed):
    rng = np.random.default_rng(seed)
    o = _planes(rng, E, E)
    gu = _planes(rng, 2 * Fd, E)
    att = rng.standard_normal((1, E)).astype(np.float32)
    x = rng.standard_normal((1, E)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    return att, x, o, w, gu


def _oracle(att, x, o, w, gu, E, Fd):
    r1 = x.astype(np.float64) + att @ _dense(o, E, E).T.astype(np.float64)
    h = r1 / np.sqrt((r1 ** 2).mean() + EPS) * w
    g = h @ _dense(gu, 2 * Fd, E).T.astype(np.float64)
    gate, up = g[:, :Fd], g[:, Fd:]
    return gate / (1 + np.exp(-gate)) * up, r1


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _close(got, want, rel):
    tol = rel * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol, (float(np.abs(got - want).max()), tol)


@pytest.mark.parametrize("E,Fd", [(256, 384), (4096, 256)])
def test_plain_matches_oracle_and_jax(E, Fd):
    import jax.numpy as jnp

    from tpullama.ops.pallas.fused_layer import fused_postattn as j_fused

    att, x, o, w, gu = _inputs(E, Fd, seed=E)
    act, r1 = tf.fused_postattn(torch.from_numpy(att), torch.from_numpy(x), _t(o),
                                torch.from_numpy(w), _t(gu), group=G, eps=EPS)
    assert act.shape == (1, Fd) and r1.shape == (1, E) and act.dtype == r1.dtype == torch.float32
    want_act, want_r1 = _oracle(att, x, o, w, gu, E, Fd)
    _close(r1.numpy(), want_r1, 1e-5)
    _close(act.numpy(), want_act, 1e-5)
    stack = lambda d: {k: jnp.asarray(v[None]) for k, v in d.items()}  # noqa: E731
    j_act, j_r1 = j_fused(jnp.asarray(att), jnp.asarray(x), stack(o), jnp.asarray(w), stack(gu),
                          group=G, eps=EPS, layer=0, interpret=True)
    np.testing.assert_allclose(r1.numpy(), np.asarray(j_r1), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(act.numpy(), np.asarray(j_act), rtol=3e-2, atol=3e-2)


def test_plain_bf16_inputs():
    """bf16 att / x_res / norm weight and bf16 scale planes (the served
    types): the plain version computes in f32 on the bf16 values."""
    E, Fd = 512, 128
    att, x, o, w, gu = _inputs(E, Fd, seed=3)
    bf = torch.bfloat16

    def planes_bf(d):
        return {k: (torch.from_numpy(v).to(bf) if k != "q4" else torch.from_numpy(v))
                for k, v in d.items()}

    act, r1 = tf.fused_postattn(torch.from_numpy(att).to(bf), torch.from_numpy(x).to(bf),
                                planes_bf(o), torch.from_numpy(w).to(bf), planes_bf(gu),
                                group=G, eps=EPS)

    def rounded(a):
        return torch.from_numpy(a).to(bf).float().numpy()

    o32 = {k: (rounded(v) if k != "q4" else v) for k, v in o.items()}
    gu32 = {k: (rounded(v) if k != "q4" else v) for k, v in gu.items()}
    want_act, want_r1 = _oracle(rounded(att), rounded(x), o32, rounded(w), gu32, E, Fd)
    _close(r1.numpy(), want_r1, 1e-5)
    _close(act.numpy(), want_act, 1e-5)


def test_plain_reads_fourblock_order():
    """The o-projection contracts att in the planes' fourblock order: a
    one-hot att at natural element e picks column e of the dense matrix."""
    E, Fd = 256, 128
    att, x, o, w, gu = _inputs(E, Fd, seed=5)
    e = 77
    att[:] = 0.0
    att[0, e] = 1.0
    _, r1 = tf.fused_postattn(torch.from_numpy(att), torch.from_numpy(x), _t(o),
                              torch.from_numpy(w), _t(gu), group=G, eps=EPS)
    np.testing.assert_allclose(r1.numpy()[0], x[0] + _dense(o, E, E)[:, e], rtol=1e-6, atol=1e-6)


def _inputs_wide(E, Dq, Fd, seed):
    """As _inputs, with an attention width Dq other than E."""
    rng = np.random.default_rng(seed)
    o = _planes(rng, E, Dq)
    gu = _planes(rng, 2 * Fd, E)
    att = rng.standard_normal((1, Dq)).astype(np.float32)
    x = rng.standard_normal((1, E)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    return att, x, o, w, gu


def _body_emulated(att, x, o, w, gu, Fd):
    """(act, r1) as the kernel computes them with the decode body of
    csrc/qmm_gemv.cuh (tests/test_torch_qmm.py _gemv_emulated: integers
    summed per scale column against x staged in column order, one scale
    per column, the min term from the column sums, a lane's columns in
    class order, a butterfly over 16 lanes): r1 = x_res + o(att); h = r1 *
    inv * norm_w; g = [gate | up](h); act = silu(gate) * up, in f32."""
    from .test_torch_qmm import _gemv_emulated

    E, Dq = x.shape[-1], att.shape[-1]
    r1 = x.float() + _gemv_emulated(att, o, GGMLType.Q4_K, Dq, "fourblock")
    inv = 1.0 / torch.sqrt((r1 * r1).sum() / E + EPS)
    g = _gemv_emulated(r1 * inv * w.float(), gu, GGMLType.Q4_K, E, "fourblock")
    return torch.nn.functional.silu(g[:, :Fd]) * g[:, Fd:], r1


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("E,Dq,Fd", [(256, 256, 384), (512, 1024, 128), (4096, 4096, 128)])
def test_body_arithmetic_is_within_kernel_tolerance(E, Dq, Fd, dt):
    """The kernel's arithmetic on the decode body, emulated on the CPU over
    fourblock planes, against the plain version and against the JAX
    package's exact path for the same chain (quantized_matmul in interpret
    mode on the fourblock planes, the norm, silu(gate) * up): within the
    kernel's tolerance, 1e-4 of each output's max plus 1e-5, with f32 and
    with bf16 inputs and scales."""
    import jax.numpy as jnp

    from tpullama.ops.pallas.qmm import quantized_matmul as jax_qmm

    att, x, o, w, gu = _inputs_wide(E, Dq, Fd, seed=E + Dq + Fd)

    def t(a):
        return torch.from_numpy(a).to(dt)

    tp = {n: {k: (torch.from_numpy(v) if k == "q4" else t(v)) for k, v in d.items()}
          for n, d in (("o", o), ("gu", gu))}
    args = (t(att), t(x), tp["o"], t(w), tp["gu"])
    got = _body_emulated(args[0], args[1], args[2], args[3], args[4], Fd)
    want = tf.fused_postattn_plain(*args, group=G, eps=EPS)

    # the JAX exact path on the same (rounded) values, in f32
    def j(a):
        return jnp.asarray(a.float().numpy())

    jo = {k: (jnp.asarray(v.numpy()) if k == "q4" else j(v)) for k, v in tp["o"].items()}
    jgu = {k: (jnp.asarray(v.numpy()) if k == "q4" else j(v)) for k, v in tp["gu"].items()}
    j_r1 = j(args[1]) + jax_qmm(j(args[0]), jo, GGMLType.Q4_K, G, E, Dq, tile_n=128,
                                interpret=True, order="fourblock")
    j_h = j_r1 * (1.0 / jnp.sqrt(jnp.sum(j_r1 * j_r1) / E + EPS)) * j(args[3])
    j_g = jax_qmm(j_h, jgu, GGMLType.Q4_K, G, 2 * Fd, E, tile_n=128, interpret=True,
                  order="fourblock")
    j_act = j_g[:, :Fd] / (1.0 + jnp.exp(-j_g[:, :Fd])) * j_g[:, Fd:]
    jax_out = (torch.from_numpy(np.array(j_act)), torch.from_numpy(np.array(j_r1)))
    for g_, w_, jw in zip(got, want, jax_out):
        tol = 1e-4 * float(w_.abs().max()) + 1e-5
        assert float((g_ - w_).abs().max()) <= tol
        assert float((g_ - jw).abs().max()) <= tol


def _metas(variant):
    """(reference w, reference lmeta, port w, port lmeta) for one case."""
    from tpullama.models.loader import QuantMeta as JQM
    from tpullama_torch.models.loader import QuantMeta as TQM

    E, F2 = 4096, 2 * 256
    shapes = {"attn_output": (E, E), "ffn_up": (F2, E)}
    j_w, j_m, t_w, t_m = {}, {}, {}, {}
    for name, (n_out, n_in) in shapes.items():
        g, order, fields = 32, "fourblock", {"q4", "scale", "minv"}
        rows = n_out
        if variant == "stripe":
            order = "stripe"
        elif variant == "narrow":
            n_in = 2048  # n_embd 2048: not a multiple of 128 * g
        elif variant == "q6-fields" and name == "ffn_up":
            fields = {"q4", "q2", "scale", "minv"}
        elif variant == "group-mismatch" and name == "ffn_up":
            g = 16
        elif variant == "padded-rows" and name == "attn_output":
            rows = n_out + 128
        elif variant == "rows-not-128" and name == "ffn_up":
            n_out = rows = 500
        planes = {k: np.zeros((rows, 8), np.uint8) for k in fields}
        if variant == "missing" and name == "attn_output":
            continue
        j_w[name] = (planes, 0)
        t_w[name] = {k: torch.from_numpy(v) for k, v in planes.items()}
        j_m[name] = JQM(GGMLType.Q4_K, g, n_out, n_in, order=order)
        t_m[name] = TQM(GGMLType.Q4_K, g, n_out, n_in, order=order)
    if variant == "dense":
        t_w["ffn_up"] = torch.zeros((F2, E))
        j_w["ffn_up"] = np.zeros((F2, E))
    return j_w, j_m, t_w, t_m


@pytest.mark.parametrize("variant", ["ok", "stripe", "narrow", "q6-fields", "group-mismatch",
                                     "padded-rows", "rows-not-128", "missing", "dense"])
def test_fused_ok_matches_reference(variant):
    from tpullama.ops.pallas.fused_layer import fused_ok as j_ok

    j_w, j_m, t_w, t_m = _metas(variant)
    want = j_ok(None, j_w, j_m)
    assert tf.fused_ok(None, t_w, t_m) == want
    assert want == (variant == "ok")


def test_resolve_fused_layer(monkeypatch):
    monkeypatch.delenv("TPULLAMA_FUSED_LAYER", raising=False)
    assert tf.resolve_fused_layer(None) is False
    for val, on in (("0", False), ("", False), ("1", True), ("force", True)):
        monkeypatch.setenv("TPULLAMA_FUSED_LAYER", val)
        assert tf.resolve_fused_layer(None) is on
    assert tf.resolve_fused_layer(False) is False and tf.resolve_fused_layer(True) is True


def test_cpu_takes_plain_and_meta_raises():
    from tpullama_torch.ops.cuda import launch_counts, reset_launch_counts

    E, Fd = 512, 128
    att, x, o, w, gu = _inputs(E, Fd, seed=9)
    reset_launch_counts()
    got = tf.fused_postattn(torch.from_numpy(att), torch.from_numpy(x), _t(o),
                            torch.from_numpy(w), _t(gu), group=G, eps=EPS)
    want = tf.fused_postattn_plain(torch.from_numpy(att), torch.from_numpy(x), _t(o),
                                   torch.from_numpy(w), _t(gu), group=G, eps=EPS)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not any(launch_counts().values())
    meta = {k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype, device="meta")
            for k, v in o.items()}
    with pytest.raises(RuntimeError, match="device"):
        tf.fused_postattn(torch.zeros((1, E), device="meta"), torch.zeros((1, E), device="meta"),
                          meta, torch.zeros(E, device="meta"), meta, group=G, eps=EPS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the fused post-attention kernel runs on a CUDA card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E,Fd", [(512, 384), (4096, 13696)])
def test_kernel_matches_plain(cuda, E, Fd):
    """The kernel sums in f32 in another order: 1e-4 of each output's
    scale, for f32 and bf16 inputs and scale planes."""
    att, x, o, w, gu = _inputs(E, Fd, seed=E + Fd)
    for xdt in (torch.float32, torch.bfloat16):
        for sdt in (torch.float32, torch.bfloat16):
            def dev(d):
                return {k: torch.from_numpy(v).to(cuda, sdt if k != "q4" else None)
                        for k, v in d.items()}

            args = (torch.from_numpy(att).to(cuda, xdt), torch.from_numpy(x).to(cuda, xdt),
                    dev(o), torch.from_numpy(w).to(cuda, xdt), dev(gu))
            before = tf.LAUNCHES["fused_postattn"]
            act, r1 = tf.fused_postattn(*args, group=G, eps=EPS)
            want_act, want_r1 = tf.fused_postattn_plain(*args, group=G, eps=EPS)
            assert tf.LAUNCHES["fused_postattn"] == before + 1
            for got, want in ((act, want_act), (r1, want_r1)):
                assert bool(torch.isfinite(got).all())
                assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("E,Dq,Fd", [(512, 4096, 384), (4096, 512, 1536), (1024, 1024, 2712),
                                     (4096, 12288, 13696), (12288, 4096, 13696),
                                     (12288, 12288, 8200)])
def test_kernel_takes_e_unlike_dq(cuda, E, Dq, Fd):
    """An attention width Dq other than E (each matvec's K is its own), and
    Fd not a multiple of the 16 row pairs of a tile (2712, 8200); up to the
    wrapper's widest width, 12288, where a phase's x no longer fits one
    staged slice (K > 8192) and a block restages it for each of its
    several tiles (phase B at E = 12288, phase A at E = Dq = 12288):
    against the plain version at 1e-4 of each output's scale, bf16 and f32
    inputs with bf16 scale planes (the served types)."""
    att, x, o, w, gu = _inputs_wide(E, Dq, Fd, seed=E + Dq)

    def dev(d):
        return {k: torch.from_numpy(v).to(cuda, torch.bfloat16 if k != "q4" else None)
                for k, v in d.items()}

    for xdt in (torch.bfloat16, torch.float32):
        args = (torch.from_numpy(att).to(cuda, xdt), torch.from_numpy(x).to(cuda, xdt),
                dev(o), torch.from_numpy(w).to(cuda, xdt), dev(gu))
        before = tf.LAUNCHES["fused_postattn"]
        act, r1 = tf.fused_postattn(*args, group=G, eps=EPS)
        want_act, want_r1 = tf.fused_postattn_plain(*args, group=G, eps=EPS)
        assert tf.LAUNCHES["fused_postattn"] == before + 1
        assert act.shape == (1, Fd) and r1.shape == (1, E)
        for got, want in ((act, want_act), (r1, want_r1)):
            assert bool(torch.isfinite(got).all())
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
