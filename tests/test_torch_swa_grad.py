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

The bf16 kernels take P from the forward's lse and D from its output:
``swa_bwd_plain(out=, lse=)`` is held to the same reference with ``out``
and ``lse`` from ``swa_plain`` and ``swa_lse_plain`` (the same
tolerance), and with ``out`` rounded to bf16 (within one bf16 ulp of
max|g|: D moves by the rounding of O); ``swa_lse_plain`` is held to a
logsumexp, in jnp, of the reference's scores under its mask.

The autograd Function that the wrapper applies to CUDA tensors is held
here with the kernels' plain versions in the kernels' place, so that its
wiring (saved tensors, argument order, the ``None`` gradients; for bf16
the forward's output and lse handed to the backward) is checked where
there is no card.
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


def reference_vjp(case, q, k, v, do):
    b, s, h, kh, hd, w, p, cap = CASES[case]
    jcfg = dataclasses.replace(jget_config("hymba_1_5b").reduced(),
                               n_heads=h, n_kv_heads=kh, head_dim=hd,
                               logit_softcap=cap)
    return jax.jit(lambda a, cot: jax.vjp(lambda *x: jlayers.flash_attention(
        *x, jcfg, causal=True, window=w, prefix_len=p), *a)[1](cot))(
        tuple(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(do))


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_reference_vjp(case):
    b, s, h, kh, hd, w, p, cap = CASES[case]
    q, k, v, do = inputs(b, s, h, kh, hd, cap, seed=s + hd)
    want = reference_vjp(case, q, k, v, do)
    band = dict(window=w, softcap=cap, prefix=p)
    got = swa.swa_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, do)),
                            **band)
    assert [tuple(g.shape) for g in got] == [x.shape for x in (q, k, v)]
    assert_grads(got, want)
    assert_grads(got, plain_autograd(q, k, v, do, **band))


@pytest.mark.parametrize("bf16_out", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_from_out_and_lse_matches_reference_vjp(case, bf16_out):
    """The bf16 kernels' algorithm: P = exp(s - lse) from the forward's
    lse and D = rowsum(dO * O) from its output. With ``out`` and ``lse``
    from ``swa_plain`` and ``swa_lse_plain`` the gradients meet
    ``assert_grads``; with ``out`` rounded to bf16, as the bf16 forward
    writes it, each is within one bf16 ulp of its max|g| of the
    reference."""
    b, s, h, kh, hd, w, p, cap = CASES[case]
    q, k, v, do = inputs(b, s, h, kh, hd, cap, seed=s + hd + 1)
    want = reference_vjp(case, q, k, v, do)
    band = dict(window=w, softcap=cap, prefix=p)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out = swa.swa_plain(*t[:3], **band)
    if bf16_out:
        out = out.bfloat16().float()
    lse = swa.swa_lse_plain(*t[:3], **band)
    got = swa.swa_bwd_plain(*t, out=out, lse=lse, **band)
    if not bf16_out:
        assert_grads(got, want)
        return
    for g, x in zip(got, want):
        x = np.array(x)
        peak = float(np.abs(x).max())
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        assert float((g - torch.from_numpy(x)).abs().max()) <= ulp


@pytest.mark.parametrize("case", CASES)
def test_lse_plain_matches_reference_logsumexp(case):
    """``swa_lse_plain`` against a logsumexp of the reference's scores
    (``layers._gqa_scores``, ``layers._softcap``) under the reference's
    prefix-LM band mask (``layers._direct_attention``), written in jnp."""
    b, s, h, kh, hd, w, p, cap = CASES[case]
    q, k, v, _ = inputs(b, s, h, kh, hd, cap, seed=s + hd + 2)
    qf = jnp.asarray(q).reshape(b, s, kh, h // kh, hd) * (1.0 / np.sqrt(hd))
    sc = jlayers._softcap(jlayers._gqa_scores(qf, jnp.asarray(k)), cap)
    qp, kp = jnp.arange(s)[:, None], jnp.arange(s)[None, :]
    mask = ((kp <= qp) | (kp < p)) & (kp > qp - w)
    want = jax.scipy.special.logsumexp(
        jnp.where(mask[None, None, None], sc, -jnp.inf), axis=-1)
    got = swa.swa_lse_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                            window=w, softcap=cap, prefix=p)
    assert got.shape == (b, h, s) and got.dtype == torch.float32
    want = torch.from_numpy(np.array(want).reshape(b, h, s))
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


def test_swa_bwd_takes_out_and_lse_together_on_cpu():
    """On CPU tensors ``swa_bwd`` hands ``out`` and ``lse`` to the plain
    version, and refuses one without the other or of the wrong shape."""
    b, s, h, kh, hd, w, p, cap = CASES["hd64 5:1 W>S prefix softcap"]
    args = [torch.from_numpy(x) for x in inputs(b, s, h, kh, hd, cap, 6)]
    band = dict(window=w, softcap=cap, prefix=p)
    out = swa.swa_plain(*args[:3], **band)
    lse = swa.swa_lse_plain(*args[:3], **band)
    got = swa.swa_bwd(*args, out=out, lse=lse, **band)
    for g, r in zip(got, swa.swa_bwd_plain(*args, out=out, lse=lse, **band)):
        assert torch.equal(g, r)
    for bad in (dict(out=out), dict(lse=lse),
                dict(out=out, lse=lse[:, :, :-1])):
        with pytest.raises(ValueError):
            swa.swa_bwd(*args, **band, **bad)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("remat", [False, True])
def test_autograd_function_wiring(monkeypatch, remat, dtype):
    """``_SwaGrad`` with the forward kernel replaced by ``swa_plain`` (its
    backward, ``swa_bwd``, takes ``swa_bwd_plain`` for CPU tensors): the
    gradients of q, k, v, also through a non-reentrant checkpoint as the
    models' remat takes it, equal autograd through the plain forward
    within the tolerance above (fp32). For bf16 the forward also returns
    ``swa_lse_plain``'s lse, as the bf16 kernel does, and the backward
    must hand that output and lse to ``swa_bwd``: the gradients equal
    ``swa_bwd_plain(out=, lse=)``'s bit for bit."""
    calls = []

    def forward(q, k, v, w, c, p, *, with_lse=False):
        out = swa.swa_plain(q, k, v, window=w, softcap=c, prefix=p)
        calls.append(with_lse)
        if not with_lse:
            return out
        lse = swa.swa_lse_plain(q, k, v, window=w, softcap=c, prefix=p)
        return out, lse

    monkeypatch.setattr(swa, "_forward", forward)
    b, s, h, kh, hd, w, p, cap = CASES["hd128 8:1 W<S prefix"]
    q, k, v, do = inputs(b, s, h, kh, hd, 30.0, seed=5)
    t = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    dout = torch.from_numpy(do).to(dtype)

    def fn(*a):
        return swa._SwaGrad.apply(*a, w, 30.0, p)

    out = (checkpoint(fn, *t, use_reentrant=False) if remat else fn(*t))
    got = torch.autograd.grad(out, t, dout)
    assert calls and all(c == (dtype == torch.bfloat16) for c in calls)
    band = dict(window=w, softcap=30.0, prefix=p)
    if dtype == torch.float32:
        assert_grads(got, plain_autograd(q, k, v, do, **band))
        return
    x = [a.detach() for a in t]
    want = swa.swa_bwd_plain(
        *x, dout, out=swa.swa_plain(*x, **band),
        lse=swa.swa_lse_plain(*x, **band), **band)
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, r)
