"""Port MoE layer (src/repro_torch/models/moe.py) against the reference's
``repro.models.moe`` in fp32 on the CPU, from the reference's own expert
weights and the same numpy inputs.

Output and aux loss to atol 1e-5: both sides route, scatter and gather
the same rows and run the same three expert products in fp32, summed in
another order. The inputs are 0.1 N(0, 1), where the outputs are of order
0.5; at unit scale (the model's normed residual) the reference's 1/sqrt(E)
expert init makes outputs of order 50, and the same rounding is held to
1e-6 of max|out| there. Each case is run with a capacity that drops
tokens and with one that drops none, and the test checks which it got.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import moe

ARCHS = ["moonshot_v1_16b_a3b", "grok_1_314b", "llama4_maverick_400b_a17b"]
TOL = dict(atol=1e-5, rtol=0)


def layer(arch, capacity_factor, seed):
    """(reference cfg, port cfg, reference params, port MoE)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              capacity_factor=capacity_factor)
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    m = moe.MoE(cfg, torch.float32, torch.device("cpu"))
    m.load_state_dict({k: convert.to_tensor(np.asarray(v), "cpu")
                       for k, v in jp.items()})
    return jcfg, cfg, jp, m


def n_dropped(jp, x, cfg):
    """(token, choice) pairs past their expert's capacity, in numpy."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1) @ np.asarray(jp["router"])
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    load = np.bincount(top.reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(load - moe.moe_capacity(t, cfg), 0).sum())


@pytest.mark.parametrize("scale", [0.1, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor,drops", [(0.5, True),
                                                   (8.0, False)])
def test_apply_moe_matches_reference(arch, capacity_factor, drops, scale):
    seed = ARCHS.index(arch)
    jcfg, cfg, jp, m = layer(arch, capacity_factor, seed=3 + seed)
    x = scale * np.random.default_rng(4 + seed).standard_normal(
        (3, 21, cfg.d_model)).astype(np.float32)
    assert (n_dropped(jp, x, cfg) > 0) == drops
    want, want_aux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = moe.apply_moe(m, torch.from_numpy(x), cfg)
    want = np.asarray(want)
    atol = TOL["atol"] if scale < 1 else 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


@pytest.mark.parametrize("t,k,e", [(1, 2, 4), (37, 2, 4), (5000, 6, 64),
                                   (300, 1, 128)])
def test_queue_positions_are_the_references_cumsum(t, k, e):
    """The stable-sort ranks equal the reference's cumulative sum down the
    choice-major (k * T, E) one-hot, exactly."""
    rng = np.random.default_rng(t)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    onehot = np.eye(e, dtype=np.int64)[idx]                    # (T, k, E)
    flat = onehot.transpose(1, 0, 2).reshape(k * t, e)
    want = ((np.cumsum(flat, axis=0) - flat) * flat).sum(-1).reshape(k, t).T
    got = moe.queue_positions(torch.from_numpy(idx), e)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_tokens", [1, 7, 64, 16_384])
def test_capacity_matches_reference(n_tokens):
    for arch in ARCHS:
        assert moe.moe_capacity(n_tokens, get_config(arch)) == \
            jmoe.moe_capacity(n_tokens, jget_config(arch))


def test_gradients_match_reference():
    """d(sum(out * g) + aux) / d(x, router, wi, wg, wo) with drops."""
    jcfg, cfg, jp, m = layer("moonshot_v1_16b_a3b", 0.5, seed=5)
    rng = np.random.default_rng(6)
    x = 0.1 * rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.apply_moe(p, x, jcfg)
        return jnp.sum(out * g) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.apply_moe(m, xt, cfg)
    (out * torch.from_numpy(g)).sum().add(aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_parameter_names_and_layouts_are_the_references():
    cfg = get_config("moonshot_v1_16b_a3b").reduced()
    jcfg = jget_config("moonshot_v1_16b_a3b").reduced()
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    m = moe.MoE(cfg, torch.float32, torch.device("cpu"))
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == \
        {n: tuple(v.shape) for n, v in jp.items()}
    assert m.router.dtype == torch.float32
