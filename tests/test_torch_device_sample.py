"""The port's device sampler (tpullama_torch/runtime/sampling.py:
DeviceSamplerSpec, as_device_spec, device_sample) held against the JAX
package's (tpullama/runtime/sampling.py), on the CPU.

The two draw from different RNG streams (a torch.Generator against a
threefry key, the documented divergence), so draws are compared as sets
and distributions, not one by one.

Tolerances: the spec mapping and the temp-0 argmax exactly; the set of
tokens the port can draw equals the set the reference draws in 4000
draws (every kept token there has probability >= 1 %, so the chance that
4000 draws miss one is below 1e-17); over 4000 draws each, the total
variation between the two empirical distributions is under 0.05 (its
expected value for ~10 kept tokens is ~0.03)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_fixtures  # noqa: F401  (one PyTorch thread a process)
from tpullama.runtime import sampling as js
from tpullama_torch.runtime import sampling as ts

N_DRAWS = 4000
TV_TOL = 0.05


def _chains(mod):
    """The chains of the reference's test_spec_mapping, and the other cases
    of as_device_spec: (name, chain) built from `mod`'s classes."""
    return {
        "std_temp_topk": mod.SamplerChain.std(temp=0.7, top_k=50),
        "greedy": mod.SamplerChain.greedy(),
        "std_penalty": mod.SamplerChain.std(temp=0.7, penalty_repeat=1.2),
        "mirostat": mod.SamplerChain([mod.Temp(0.7), mod.MirostatV2()]),
        "std_temp0": mod.SamplerChain.std(temp=0.0),
        "std_bias": mod.SamplerChain.std(temp=0.7, logit_bias={3: 1.0}),
        "std_typical": mod.SamplerChain.std(temp=0.7, typical_p=0.9),
        "std_topp_minp": mod.SamplerChain.std(temp=0.9, seed=7, top_p=0.8, min_p=0.1),
        "from_params": mod.SamplerChain.from_params(seed=11, temp=0.8),
        "from_params_dry": mod.SamplerChain.from_params(temp=0.8, dry_multiplier=0.5),
        "temp_dist": mod.SamplerChain([mod.Temp(1.3), mod.Dist(5)]),
    }


@pytest.mark.parametrize("name", sorted(_chains(js)))
def test_spec_mapping(name):
    """as_device_spec maps each chain as the reference does, None (the host
    chain) included; the reference's test_spec_mapping cases among them."""
    want = js.as_device_spec(_chains(js)[name])
    got = ts.as_device_spec(_chains(ts)[name])
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_spec_mapping_values():
    """The reference test's literal values."""
    assert ts.as_device_spec(ts.SamplerChain.std(temp=0.7, top_k=50)) == \
        ts.DeviceSamplerSpec(0.7, 50, 0.95, 0.05, 42)
    assert ts.as_device_spec(ts.SamplerChain.greedy()).temp == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_temp0_is_argmax(seed):
    logits = np.random.default_rng(seed).standard_normal(300).astype(np.float32)
    spec = ts.DeviceSamplerSpec(0.0, 0, 1.0, 0.0, 0)
    gen = torch.Generator().manual_seed(seed)
    tok = ts.device_sample(torch.from_numpy(logits), gen, spec)
    assert tok.dtype == torch.int32 and tok.dim() == 0
    assert int(tok) == int(np.argmax(logits))


def _ref_draws(logits, spec, n=N_DRAWS):
    jspec = js.DeviceSamplerSpec(*dataclasses.astuple(spec))
    keys = jax.random.split(jax.random.PRNGKey(spec.seed), n)
    draw = jax.jit(jax.vmap(lambda k: js.device_sample(jnp.asarray(logits), k, jspec)))
    return np.asarray(draw(keys))


def _port_draws(logits, spec, n=N_DRAWS):
    gen = torch.Generator().manual_seed(spec.seed)
    lt = torch.from_numpy(logits)
    return np.array([int(ts.device_sample(lt, gen, spec)) for _ in range(n)])


def _tv(a, b, V):
    pa = np.bincount(a, minlength=V) / len(a)
    pb = np.bincount(b, minlength=V) / len(b)
    return 0.5 * float(np.abs(pa - pb).sum())


# (temp, top_k, top_p, min_p): each truncation alone and all three together
SPECS = [(1.0, 8, 1.0, 0.0), (1.0, 0, 0.6, 0.0), (1.0, 0, 1.0, 0.15),
         (0.8, 12, 0.9, 0.05), (1.2, 40, 0.8, 0.1)]


@pytest.mark.parametrize("temp,top_k,top_p,min_p", SPECS)
def test_kept_set_and_distribution(temp, top_k, top_p, min_p):
    """Logits from a seed (a few tokens well ahead, a long tail): the tokens
    the port can draw (device_candidates' finite entries) and draws equal
    the reference's drawn set; the two empirical distributions are within
    TV_TOL."""
    V = 512
    rng = np.random.default_rng(7)
    logits = rng.standard_normal(V).astype(np.float32)
    logits[rng.choice(V, 10, replace=False)] += np.linspace(3.0, 5.0, 10).astype(np.float32)
    spec = ts.DeviceSamplerSpec(temp, top_k, top_p, min_p, 3)
    ref = _ref_draws(logits, spec)
    got = _port_draws(logits, spec)
    idx, logt = ts.device_candidates(torch.from_numpy(logits), spec)
    can = set(idx[torch.isfinite(logt)].tolist())
    assert set(ref.tolist()) == can == set(got.tolist())
    assert _tv(ref, got, V) < TV_TOL


def test_reference_truncation_cases():
    """The reference's test_device_sample_respects_topk_topp cases."""
    logits = torch.tensor([5.0, 4.0, 3.0, -10.0, -10.0] + [-20.0] * 27)
    gen = torch.Generator().manual_seed(0)
    spec = ts.DeviceSamplerSpec(temp=1.0, top_k=2, top_p=1.0, min_p=0.0, seed=0)
    draws = {int(ts.device_sample(logits, gen, spec)) for _ in range(64)}
    assert draws == {0, 1}
    spec = ts.DeviceSamplerSpec(temp=1.0, top_k=0, top_p=0.5, min_p=0.0, seed=0)
    assert {int(ts.device_sample(logits, gen, spec)) for _ in range(32)} == {0}
    spec = ts.DeviceSamplerSpec(temp=1.0, top_k=0, top_p=1.0, min_p=0.5, seed=0)
    assert {int(ts.device_sample(logits, gen, spec)) for _ in range(64)} == {0}


def test_same_generator_state_same_draws():
    """The draw depends on the generator's state alone: two generators
    seeded alike draw the same tokens, and a drawn generator moves on."""
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(256).astype(np.float32))
    spec = ts.DeviceSamplerSpec(1.0, 0, 1.0, 0.0, 9)
    a, b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    da = [int(ts.device_sample(logits, a, spec)) for _ in range(20)]
    db = [int(ts.device_sample(logits, b, spec)) for _ in range(20)]
    assert da == db and len(set(da)) > 1
