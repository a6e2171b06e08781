"""The port's train step (``zoo.make_train_step``, ``zoo.forward(remat=,
window=)``, ``zoo.effective_microbatches``) and the hybrid family's
differentiable doubling scan against the reference, in fp32 on the CPU,
from the reference's own initial parameters (convert.py).

Every one of the ten reduced archs takes one step at ``microbatches`` 1
and 2, with ``remat`` on and off, a non-uniform per-example ``weight``
and ignored labels, against ``jax.jit(zoo.make_train_step(...))`` of the
reference. Tolerances, those of tests/test_torch_archs.py's SGD step: the
loss and the gradient norm rtol 1e-4, every updated parameter atol 1e-6,
at the reference's own train-step lr of 1e-2 (tests/test_arch_smoke.py).
Reduced rwkv6's gradients reach 1.8, and its two summation orders differ
by ~4e-6 of a gradient: at lr 0.1 or 0.2 that rounding alone passes
1e-6 of a parameter.
With ``accum_dtype=bfloat16`` the microbatch gradients are rounded and
summed in bf16 on both sides, within a bf16 rounding of the sum.
The two forms of the scan are bitwise equal; its gradient matches
autograd through a step-by-step fp64 recurrence within 1e-6 of its
largest magnitude.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import ssm, zoo

B, S, LR = 4, 16, 1e-2
WEIGHT = np.array([0.5, 1.5, 1.0, 2.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tensors here are tiny: one intra-op thread keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def reference_init(arch, seed):
    """The reference's reduced cfg and initial parameters (immutable), the
    port's cfg and the converted state dict: one eager init an arch."""
    jcfg = jget_config(arch).reduced()
    jparams, _ = jzoo.init_model(jax.random.PRNGKey(seed), jcfg)
    cfg = get_config(arch).reduced()
    state = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, "cpu")
    return jcfg, cfg, jparams, state


def build(arch, seed):
    """(reference cfg, port cfg, reference params, port model) from one
    reference init, loaded with a strict ``load_state_dict`` into a fresh
    module (the step updates it in place)."""
    jcfg, cfg, jparams, state = reference_init(arch, seed)
    model = zoo.build_model(cfg, torch.device("cpu"))
    model.load_state_dict(state)
    return jcfg, cfg, jparams, model


def train_batch(cfg, seed):
    """Seeded numpy tokens and labels (B, S) with a few labels -1, the
    non-uniform weight, and a vlm's prefix or an encdec's frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)),
           "weight": WEIGHT}
    out["labels"][rng.random((B, S)) < 0.2] = -1
    out["tokens"] = out["tokens"].astype(np.int32)
    out["labels"] = out["labels"].astype(np.int32)
    if cfg.family in ("vlm", "encdec"):
        out["prefix" if cfg.family == "vlm" else "frames"] = \
            rng.standard_normal((B, cfg.n_prefix_tokens,
                                 cfg.prefix_dim)).astype(np.float32)
    return out


def port_batch(batch):
    return {name: (torch.from_numpy(val).long() if val.dtype == np.int32
                   else torch.from_numpy(val))
            for name, val in batch.items()}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_the_reference(arch, microbatches, remat):
    """Loss, gradient norm and every updated parameter of one step."""
    seed = ARCH_IDS.index(arch)
    jcfg, cfg, jparams, model = build(arch, seed)
    batch = train_batch(cfg, seed)
    jstep = jax.jit(jzoo.make_train_step(jcfg, lr=LR,
                                         microbatches=microbatches,
                                         remat=remat))
    jnew, jmetrics = jstep(jparams, jax.tree.map(jnp.asarray, batch))
    step = zoo.make_train_step(cfg, lr=LR, microbatches=microbatches,
                               remat=remat)
    metrics = step(model, port_batch(batch))
    assert metrics["loss"].dim() == metrics["grad_norm"].dim() == 0
    assert float(metrics["loss"]) == pytest.approx(
        float(jmetrics["loss"]), rel=1e-4)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(jmetrics["grad_norm"]), rel=1e-4)
    want = convert.flatten_tree(jax.tree.map(np.asarray, jnew))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6,
                                   rtol=0, err_msg=name)
    old = convert.flatten_tree(jax.tree.map(np.asarray, jparams))
    moved = float(np.abs(model.embed.detach().numpy() - old["embed"]).max())
    assert moved > 0


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "seamless_m4t_medium"])
def test_remat_changes_nothing(arch):
    """One step with and without ``remat`` from the same weights: the
    recomputed backward gives bitwise the same parameters."""
    _, cfg, _, model = build(arch, 0)
    twin = zoo.build_model(cfg, torch.device("cpu"))
    twin.load_state_dict(model.state_dict())
    batch = port_batch(train_batch(cfg, 1))
    m1 = zoo.make_train_step(cfg, lr=LR, remat=True)(model, batch)
    m2 = zoo.make_train_step(cfg, lr=LR, remat=False)(twin, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for p, q in zip(model.parameters(), twin.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("arch", ["smollm_135m", "seamless_m4t_medium"])
def test_bf16_accumulation_matches_the_reference(arch):
    """``accum_dtype=bfloat16`` at 2 microbatches against the reference's
    step with ``accum_dtype=jnp.bfloat16``. Each microbatch's fp32
    gradient is rounded to bf16 and summed in bf16 on both sides; the two
    frameworks' fp32 gradients differ in their last bits, so a rounding
    may fall on the other side: parameters within lr * 2^-6 of the largest
    gradient (two bf16 roundings of a sum), the gradient norm rtol 2^-7,
    the loss (summed in fp32 on both sides) rtol 1e-4. The step differs
    from the fp32 one: the knob is not ignored."""
    seed = ARCH_IDS.index(arch)
    jcfg, cfg, jparams, model = build(arch, seed)
    twin = zoo.build_model(cfg, torch.device("cpu"))
    twin.load_state_dict(model.state_dict())
    batch = train_batch(cfg, seed)
    jnew, jmetrics = jax.jit(jzoo.make_train_step(
        jcfg, lr=LR, microbatches=2, accum_dtype=jnp.bfloat16))(
        jparams, jax.tree.map(jnp.asarray, batch))
    metrics = zoo.make_train_step(cfg, lr=LR, microbatches=2,
                                  accum_dtype=torch.bfloat16)(
        model, port_batch(batch))
    zoo.make_train_step(cfg, lr=LR, microbatches=2)(twin, port_batch(batch))
    assert float(metrics["loss"]) == pytest.approx(
        float(jmetrics["loss"]), rel=1e-4)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(jmetrics["grad_norm"]), rel=2.0 ** -7)
    want = convert.flatten_tree(jax.tree.map(np.asarray, jnew))
    old = convert.flatten_tree(jax.tree.map(np.asarray, jparams))
    gmax = max(float(np.abs(want[n] - old[n]).max()) for n in want) / LR
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=LR * 2.0 ** -6 * gmax, err_msg=name)
    assert any(not torch.equal(p, q) for p, q in zip(model.parameters(),
                                                     twin.parameters()))


def test_the_step_splits_contiguously_and_refuses_a_ragged_batch():
    """Two microbatches equal the mean of the steps' gradients taken on
    the first and the second half; a batch of 4 does not split in 3."""
    _, cfg, _, model = build("smollm_135m", 2)
    batch = port_batch(train_batch(cfg, 2))
    state = {n: p.detach().clone() for n, p in model.named_parameters()}
    zoo.make_train_step(cfg, lr=LR, microbatches=2)(model, batch)
    two = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = []
    for half in (slice(0, 2), slice(2, 4)):
        model.load_state_dict(state)
        zoo.make_train_step(cfg, lr=1.0)(
            model, {n: v[half] for n, v in batch.items()})
        grads.append({n: state[n] - p.detach()
                      for n, p in model.named_parameters()})
    for name, p in two.items():
        want = state[name] - LR * 0.5 * (grads[0][name] + grads[1][name])
        torch.testing.assert_close(p, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="microbatches"):
        zoo.make_train_step(cfg, microbatches=3)(model, batch)


def test_forward_remat_is_a_no_op_without_autograd():
    """Under ``torch.no_grad()`` remat on and off give equal logits, and
    ``forward``'s tensor form still takes bare tokens (the FL client's)."""
    _, cfg, _, model = build("hymba_1_5b", 3)
    toks = torch.from_numpy(train_batch(cfg, 3)["tokens"]).long()
    with torch.no_grad():
        a, _ = zoo.forward(cfg, model, toks, remat=True)
        b, _ = zoo.forward(cfg, model, {"tokens": toks}, remat=False)
    assert torch.equal(a, b)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "hymba_1_5b"])
def test_forward_window_matches_the_reference(arch, window):
    """``zoo.forward(window=)`` reaches every attention as the
    reference's does (hymba takes its long_context_window for 0)."""
    jcfg, cfg, jparams, model = build(arch, 5)
    toks = train_batch(cfg, 5)["tokens"]
    want, _ = jzoo.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           remat=False, window=window)
    with torch.no_grad():
        got, _ = zoo.forward(cfg, model, torch.from_numpy(toks).long(),
                             window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


GRID = list(itertools.product([1, 2, 3, 4, 6, 8, 12, 16],
                              [1, 2, 3, 4, 8, 16, 32],
                              [1, 2, 3, 4, 8]))


def test_effective_microbatches_matches_the_reference():
    """Every (global batch, micro, shards) of a grid."""
    for gb, micro, shards in GRID:
        assert zoo.effective_microbatches(gb, micro, shards) == \
            jzoo.effective_microbatches(gb, micro, shards), (gb, micro,
                                                             shards)


def coeffs(s, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand((2, s, 3, 4), generator=gen)
    b = torch.randn((2, s, 3, 4), generator=gen)
    return a, b


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33, 64])
def test_the_two_scan_forms_are_bitwise_equal(s):
    """The in-place form (no autograd) and the out-of-place form (an input
    needs a gradient) give the same bits."""
    a, b = coeffs(s, s)
    with torch.no_grad():
        inplace = ssm._doubling_scan(a.clone(), b.clone())
    grad_form = ssm._doubling_scan(a.clone().requires_grad_(),
                                   b.clone().requires_grad_())
    assert grad_form.requires_grad
    assert torch.equal(inplace, grad_form.detach())


@pytest.mark.parametrize("s", [2, 7, 16, 33])
def test_the_scan_gradient_matches_a_step_by_step_recurrence(s):
    """d/da and d/db of a weighted sum of h, against autograd through
    h_t = a_t h_{t-1} + b_t taken one step at a time in fp64."""
    a, b = coeffs(s, 100 + s)
    w = torch.randn((2, s, 3, 4), generator=torch.Generator().manual_seed(s),
                    dtype=torch.float64)
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    got = torch.autograd.grad((ssm._doubling_scan(ta, tb) * w.float()).sum(),
                              (ta, tb))
    ra, rb = a.double().requires_grad_(), b.double().requires_grad_()
    h, hs = torch.zeros_like(rb[:, 0]), []
    for t in range(s):
        h = ra[:, t] * h + rb[:, t]
        hs.append(h)
    want = torch.autograd.grad((torch.stack(hs, 1) * w).sum(), (ra, rb))
    for g, r in zip(got, want):
        err = float((g.double() - r).abs().max())
        assert err <= 1e-6 * max(float(r.abs().max()), 1.0)


def test_the_hybrid_family_trains_through_the_scan():
    """``ssm_scan`` of a reduced hymba layer under autograd: gradients on
    every SSM parameter, and the forward equal to the serving form's."""
    _, cfg, _, model = build("hymba_1_5b", 6)
    layer = model.blocks[0].ssm
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(6))
    y, h_last = ssm.ssm_scan(layer, x)
    grads = torch.autograd.grad(y.square().sum(), list(layer.parameters()))
    assert all(bool(g.abs().sum() > 0) for g in grads)
    with torch.no_grad():
        y0, h0 = ssm.ssm_scan(layer, x)
    assert torch.equal(y.detach(), y0) and torch.equal(h_last.detach(), h0)
