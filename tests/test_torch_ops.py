"""Elementwise ops of the port (norms, activations, rope, the causal mask)
held against the JAX package's on the same numpy inputs. All run in f32
on the CPU; tolerance rtol = atol = 1e-6 (f32 rounding of transcendental
functions in two libraries), exact where the op is pure arithmetic."""

import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-6, atol=1e-6)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("with_weight,with_bias", [(False, False), (True, False), (True, True)])
def test_rms_norm(with_weight, with_bias):
    import jax.numpy as jnp

    from tpullama.ops.norms import rms_norm as j_rms
    from tpullama_torch.ops.norms import rms_norm as t_rms

    x = _x(3, 5, 64, seed=1, scale=3.0)
    w = _x(64, seed=2) if with_weight else None
    b = _x(64, seed=3) if with_bias else None
    got = t_rms(torch.from_numpy(x), None if w is None else torch.from_numpy(w), 1e-5,
                None if b is None else torch.from_numpy(b)).numpy()
    want = np.asarray(j_rms(jnp.asarray(x), None if w is None else jnp.asarray(w), 1e-5,
                            None if b is None else jnp.asarray(b)))
    np.testing.assert_allclose(got, want, **TOL)


def test_rms_norm_bf16_keeps_dtype():
    from tpullama_torch.ops.norms import rms_norm

    x = torch.from_numpy(_x(2, 64, seed=4)).to(torch.bfloat16)
    assert rms_norm(x, torch.ones(64)).dtype == torch.bfloat16


def test_silu_swiglu():
    import jax.numpy as jnp

    from tpullama.ops.activations import silu as j_silu
    from tpullama.ops.activations import swiglu as j_swiglu
    from tpullama_torch.ops.activations import silu, swiglu

    g, u = _x(4, 96, seed=5, scale=4.0), _x(4, 96, seed=6)
    np.testing.assert_allclose(silu(torch.from_numpy(g)).numpy(),
                               np.asarray(j_silu(jnp.asarray(g))), **TOL)
    np.testing.assert_allclose(swiglu(torch.from_numpy(g), torch.from_numpy(u)).numpy(),
                               np.asarray(j_swiglu(jnp.asarray(g), jnp.asarray(u))), **TOL)


ROPE_CASES = [
    dict(mode=0, n_dims=64, head_dim=64),                       # NORM (llama)
    dict(mode=2, n_dims=64, head_dim=64),                       # NEOX (qwen2)
    dict(mode=0, n_dims=32, head_dim=64),                       # partial rotation
    dict(mode=2, n_dims=64, head_dim=64, freq_scale=0.25, ext_factor=1.0,
         attn_factor=1.0, n_ctx_orig=4096, freq_base=500000.0),  # YaRN
    dict(mode=0, n_dims=64, head_dim=64, freq_factors=True),    # rope_freqs
]


@pytest.mark.parametrize("case", ROPE_CASES, ids=["norm", "neox", "partial", "yarn", "freqs"])
def test_rope(case):
    import jax.numpy as jnp

    from tpullama.ops import rope as jr
    from tpullama_torch.ops import rope as tr

    case = dict(case)
    head_dim = case.pop("head_dim")
    ff = case.pop("freq_factors", False)
    mode = case.pop("mode")
    pos = np.random.default_rng(7).integers(0, 5000, (2, 6)).astype(np.int32)
    x = _x(2, 6, 4, head_dim, seed=8)
    fac = (1.0 + np.random.default_rng(9).random(case["n_dims"] // 2)).astype(np.float32)
    jp = jr.RopeParams(mode=mode, **case)
    tp = tr.RopeParams(mode=mode, **case)
    cj, sj = jr.rope_cache(jp, jnp.asarray(pos), jnp.asarray(fac) if ff else None)
    ct, st = tr.rope_cache(tp, torch.from_numpy(pos), torch.from_numpy(fac) if ff else None)
    # float32 trig of arguments up to ~5000 rad: a few ulps of the argument
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=2e-4)
    # the rotation itself on the same tables: exact arithmetic of one library
    cos, sin = np.array(cj)[:, :, None, :], np.array(sj)[:, :, None, :]
    got = tr.apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin),
                        mode, case["n_dims"]).numpy()
    want = np.asarray(jr.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin),
                                    mode, case["n_dims"]))
    np.testing.assert_allclose(got, want, **TOL)


def test_yarn_corr_dims():
    from tpullama.ops import rope as jr
    from tpullama_torch.ops import rope as tr

    for base, n_ctx in ((10000.0, 2048), (500000.0, 8192)):
        kw = dict(n_dims=128, freq_base=base, n_ctx_orig=n_ctx, ext_factor=1.0)
        assert tr.yarn_corr_dims(tr.RopeParams(**kw)) == jr.yarn_corr_dims(jr.RopeParams(**kw))


def test_make_causal_mask():
    import jax.numpy as jnp

    from tpullama.ops.attention import make_causal_mask as j_mask
    from tpullama_torch.ops.attention import make_causal_mask as t_mask

    rng = np.random.default_rng(10)
    kv_pos = rng.integers(-1, 40, (2, 48)).astype(np.int32)
    q_pos = rng.integers(0, 40, (2, 5)).astype(np.int32)
    valid = rng.random((2, 48)) > 0.2
    for window in (0, 8):
        got = t_mask(torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                     torch.from_numpy(valid), window=window).numpy()
        want = np.asarray(j_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                 jnp.asarray(valid), window=window))
        np.testing.assert_array_equal(got, want)
