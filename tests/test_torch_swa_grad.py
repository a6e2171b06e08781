"""The gradient of the port's sliding-window attention
(src/repro_torch/kernels/swa.py) against the reference on the CPU, in
fp32, from the same numpy inputs.

``swa_bwd_plain`` follows the backward kernels' algorithm (lse, D =
rowsum(dO * O), dS = P (dP - D) with the softcap's derivative); it is held
to ``jax.vjp`` of the reference's ``layers.flash_attention(causal=True,
window=W, prefix_len=P)`` and to autograd through ``swa_plain``. Both
sides sum in fp32 in another order: each gradient within rtol 1e-4 plus
atol 1e-6 * max(1, max|g|) (measured: at most 1.8e-6 of max|g|).
The reference's vjp is jitted whole: one compile a shape.

The autograd Function that the wrapper applies to CUDA tensors is held
here with the kernels' plain versions in the kernels' place, so that its
wiring (saved tensors, argument order, the ``None`` gradients) is checked
where there is no card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro_torch.kernels import swa

# (B, S, H, KH, hd, window, prefix, softcap): hd 16, 64, 128 and 256; GQA
# 1:1, 5:1 and 8:1; W < S, W = S and W > S; prefix 0 and > 0; softcap 0
# and 30
CASES = {
    "hd16 1:1 W=S softcap": (1, 96, 4, 4, 16, 96, 0, 30.0),
    "hd64 5:1 W>S prefix softcap": (1, 64, 5, 1, 64, 100, 5, 30.0),
    "hd128 8:1 W<S prefix": (1, 96, 8, 1, 128, 33, 40, 0.0),
    "hd256 8:1 W<S prefix softcap B=2": (2, 50, 8, 1, 256, 20, 10, 30.0),
}


def inputs(b, s, h, kh, hd, softcap, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.standard_normal((b, s, h, hd)).astype(f)
    if softcap:
        q *= 4.0                               # scores well past the cap
    k, v = (rng.standard_normal((b, s, kh, hd)).astype(f) for _ in range(2))
    do = rng.standard_normal((b, s, h, hd)).astype(f)
    return q, k, v, do


def assert_grads(got, want):
    for g, w in zip(got, want):
        w = torch.as_tensor(np.array(w))
        torch.testing.assert_close(
            g, w, rtol=1e-4, atol=1e-6 * max(1.0, float(w.abs().max())))


def plain_autograd(q, k, v, do, **band):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = swa.swa_plain(*t, **band)
    return torch.autograd.grad(out, t, torch.from_numpy(do))


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_reference_vjp(case):
    b, s, h, kh, hd, w, p, cap = CASES[case]
    q, k, v, do = inputs(b, s, h, kh, hd, cap, seed=s + hd)
    jcfg = dataclasses.replace(jget_config("hymba_1_5b").reduced(),
                               n_heads=h, n_kv_heads=kh, head_dim=hd,
                               logit_softcap=cap)
    want = jax.jit(lambda a, cot: jax.vjp(lambda *x: jlayers.flash_attention(
        *x, jcfg, causal=True, window=w, prefix_len=p), *a)[1](cot))(
        tuple(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(do))
    band = dict(window=w, softcap=cap, prefix=p)
    got = swa.swa_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, do)),
                            **band)
    assert [tuple(g.shape) for g in got] == [x.shape for x in (q, k, v)]
    assert_grads(got, want)
    assert_grads(got, plain_autograd(q, k, v, do, **band))


def test_wrapper_on_cpu_under_autograd_is_the_plain_forward():
    """CPU tensors that need a gradient take ``swa_plain`` as before: the
    gradients equal autograd's through the plain forward bit for bit, and
    no kernel is counted."""
    b, s, h, kh, hd, w, p, cap = CASES["hd64 5:1 W>S prefix softcap"]
    q, k, v, do = inputs(b, s, h, kh, hd, cap, seed=3)
    band = dict(window=w, softcap=cap, prefix=p)
    before = (swa.swa.launches, swa.swa_bwd.launches)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(swa.swa(*t, **band), t, torch.from_numpy(do))
    assert (swa.swa.launches, swa.swa_bwd.launches) == before
    for g, r in zip(got, plain_autograd(q, k, v, do, **band)):
        assert torch.equal(g, r)


def test_swa_bwd_takes_the_plain_version_for_cpu_tensors():
    b, s, h, kh, hd, w, p, cap = CASES["hd16 1:1 W=S softcap"]
    args = [torch.from_numpy(x) for x in inputs(b, s, h, kh, hd, cap, 4)]
    before = swa.swa_bwd.launches
    got = swa.swa_bwd(*args, window=w, prefix=p)
    assert swa.swa_bwd.launches == before
    for g, r in zip(got, swa.swa_bwd_plain(*args, window=w, prefix=p)):
        assert torch.equal(g, r)
    with pytest.raises(ValueError):
        swa.swa_bwd(*args[:3], args[3][:, :-1], window=w)


@pytest.mark.parametrize("remat", [False, True])
def test_autograd_function_wiring(monkeypatch, remat):
    """``_SwaGrad`` with the forward kernel replaced by ``swa_plain`` (its
    backward, ``swa_bwd``, takes ``swa_bwd_plain`` for CPU tensors): the
    gradients of q, k, v, also through a non-reentrant checkpoint as the
    models' remat takes it, equal autograd through the plain forward
    within the tolerance above."""
    monkeypatch.setattr(swa, "_forward", lambda q, k, v, w, c, p: (
        swa.swa_plain(q, k, v, window=w, softcap=c, prefix=p)))
    b, s, h, kh, hd, w, p, cap = CASES["hd128 8:1 W<S prefix"]
    q, k, v, do = inputs(b, s, h, kh, hd, 30.0, seed=5)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]

    def fn(*a):
        return swa._SwaGrad.apply(*a, w, 30.0, p)

    out = (checkpoint(fn, *t, use_reentrant=False) if remat else fn(*t))
    got = torch.autograd.grad(out, t, torch.from_numpy(do))
    assert_grads(got, plain_autograd(q, k, v, do, window=w, softcap=30.0,
                                     prefix=p))
