"""The gradient of the port's chunked WKV6 (src/repro_torch/kernels/wkv6.py)
against the reference on the CPU, in fp32, from the same numpy inputs.

``wkv6_bwd_plain`` follows the backward kernels' algorithm: chunks of 64
steps with the cumulative log-decays of the forward's frame, the chunks'
local dG_j, a reverse scan of dL/dS over chunks, then each chunk's dr, dk,
dv and dw_log from its start state and G_end (dw_log summed over the steps
each pair spans). It is held to ``jax.vjp`` of the reference's
``rwkv.wkv6_chunked``, with cotangents on both ``out`` and ``s_T``, and to
autograd through ``wkv6_plain`` at the same chunk.

Tolerances, relative to the largest magnitude of the compared gradient:
- 1e-4 off the clip (measured: at most 1.4e-5);
- 2^-11 for dr, dk, dv, du and ds0 with every w_log at the +4 clip. The
  chunked form's lp_prev = lp - w_log, at |lp| in [4096, 8192) over its
  chunk, moves the adjacent step's decay exp(0) by up to one ulp of lp
  (2^-11), and that term carries most of each gradient; the reference's
  chunk of 130 rounds its lp over other frames than the port's 64 or 128
  (measured: at most 7.3e-5 of max|g|);
- dw_log at the clip: the exact gradient is w_t (S_{t-1} . G_t) with
  w_t = e^{-e^4} ~ 2e-24, while autodiff of the chunked form returns
  what is left of terms that cancel through lp's cumulative sum (up to
  8.3e-8 of max(1, max|dr, dk, dv|) here; the port's sum over spanned
  steps leaves no such term).
  It is held at atol 1e-6 * max(1, max|g|) over the other gradients.

The autograd Function that the wrapper applies to CUDA tensors is held
here with the kernels' plain versions in the kernels' place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models import rwkv as jrwkv
from repro_torch.kernels import wkv6

# (B, H, T, C, chunk of the reference, clip, s0, chunk of the port)
# T = 130 is not a multiple of the port's chunk of 64 steps; at the port's
# chunk 128 (the rwkv6 model's) the kernels' cumulative sums run over
# frames of two chunks, then a tail chunk of 2 steps
CASES = {
    "C16 T=1": (2, 2, 1, 16, 64, False, True, 64),
    "C16 T=63 zero s0": (2, 2, 63, 16, 64, False, False, 64),
    "C64 T=64": (1, 2, 64, 64, 64, False, True, 64),
    "C16 T=130": (2, 2, 130, 16, 130, False, True, 64),
    "C16 T=130 clip": (2, 2, 130, 16, 130, True, True, 64),
    "C64 T=130 chunk 128": (1, 2, 130, 64, 130, False, True, 128),
    "C64 T=130 chunk 128 clip": (1, 2, 130, 64, 130, True, True, 128),
}
NAMES = ("dr", "dk", "dv", "dw_log", "du", "ds0")


def inputs(b, h, t, c, seed, *, clip=False, s0=True):
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.standard_normal((b, h, t, c)).astype(f) * 0.5
               for _ in range(3))
    wt = (np.full((b, h, t, c), 4.0, f) if clip
          else rng.standard_normal((b, h, t, c)).astype(f))
    w_log = -np.exp(np.clip(wt, -8.0, 4.0)).astype(f)
    u = rng.standard_normal((h, c)).astype(f) * 0.5
    st = (rng.standard_normal((b, h, c, c)).astype(f) * 0.1 if s0
          else np.zeros((b, h, c, c), f))
    do = rng.standard_normal((b, h, t, c)).astype(f)
    ds = rng.standard_normal((b, h, c, c)).astype(f)
    return (r, k, v, w_log, u, st), do, ds


def assert_grads(got, want, clip):
    want = [torch.as_tensor(np.array(w)) for w in want]
    scale = max(1.0, *(float(w.abs().max()) for w in want[:3]))
    for name, g, w in zip(NAMES, got, want):
        err = float((g - w).abs().max())
        if clip and name == "dw_log":
            assert err <= 1e-6 * scale, (name, err)
        else:
            rel = 2.0 ** -11 if clip else 1e-4
            assert err <= rel * float(w.abs().max()), (name, err)


def reference_vjp(fn, args, cotangent):
    """``jax.vjp`` of ``fn`` at ``args`` for ``cotangent``, jitted whole
    (one compile a shape, where op-by-op dispatch compiles each op)."""
    return jax.jit(lambda a, cot: jax.vjp(fn, *a)[1](cot))(
        tuple(map(jnp.asarray, args)),
        jax.tree_util.tree_map(jnp.asarray, cotangent))


def plain_autograd(args, do, ds, chunk=wkv6.CHUNK):
    t = [torch.from_numpy(x).requires_grad_() for x in args]
    out, s_t = wkv6.wkv6_plain(*t, chunk=chunk)
    return torch.autograd.grad((out, s_t), t, (torch.from_numpy(do),
                                               torch.from_numpy(ds)))


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_reference_vjp(case):
    b, h, t, c, chunk, clip, s0, port_chunk = CASES[case]
    args, do, ds = inputs(b, h, t, c, seed=t + c, clip=clip, s0=s0)
    want = reference_vjp(lambda *a: jrwkv.wkv6_chunked(*a, chunk=chunk),
                         args, (do, ds))
    tens = [torch.from_numpy(x) for x in args]
    if not s0:
        tens[5] = None                          # None is a zero s0
    got = wkv6.wkv6_bwd_plain(*tens, torch.from_numpy(do),
                              torch.from_numpy(ds), chunk=port_chunk)
    assert [tuple(g.shape) for g in got] == [x.shape for x in args]
    assert_grads(got, want, clip)
    assert_grads(got, plain_autograd(args, do, ds, port_chunk), clip)


def test_no_cotangent_on_s_T_is_zero():
    args, do, _ = inputs(1, 2, 70, 16, 9)
    tens = [torch.from_numpy(x) for x in args]
    got = wkv6.wkv6_bwd_plain(*tens, torch.from_numpy(do), None)
    want = wkv6.wkv6_bwd_plain(*tens, torch.from_numpy(do),
                               torch.zeros(1, 2, 16, 16))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_on_cpu_under_autograd_is_the_plain_forward():
    """CPU tensors that need a gradient take ``wkv6_plain`` as before: the
    gradients equal autograd's through the plain forward bit for bit, and
    no kernel is counted."""
    args, do, ds = inputs(1, 2, 70, 16, 7)
    before = (wkv6.wkv6.launches, wkv6.wkv6_bwd.launches)
    t = [torch.from_numpy(x).requires_grad_() for x in args]
    out, s_t = wkv6.wkv6(*t)
    got = torch.autograd.grad((out, s_t), t, (torch.from_numpy(do),
                                              torch.from_numpy(ds)))
    assert (wkv6.wkv6.launches, wkv6.wkv6_bwd.launches) == before
    for g, r in zip(got, plain_autograd(args, do, ds)):
        assert torch.equal(g, r)


def test_wkv6_bwd_takes_the_plain_version_for_cpu_tensors():
    args, do, ds = inputs(2, 2, 40, 16, 8)
    tens = [torch.from_numpy(x) for x in (*args, do, ds)]
    before = wkv6.wkv6_bwd.launches
    got = wkv6.wkv6_bwd(*tens, states=None)
    assert wkv6.wkv6_bwd.launches == before
    for g, r in zip(got, wkv6.wkv6_bwd_plain(*tens)):
        assert torch.equal(g, r)
    with pytest.raises(ValueError):
        wkv6.wkv6_bwd(*tens[:6], tens[6][:, :, :-1], tens[7], states=None)


@pytest.mark.parametrize("remat,s0,dtype", [(False, True, torch.float32),
                                            (True, False, torch.float32),
                                            (False, True, torch.float64)])
def test_autograd_function_wiring(monkeypatch, remat, s0, dtype):
    """``_Wkv6Grad`` with the forward kernels replaced by ``wkv6_plain``
    (its backward, ``wkv6_bwd``, takes ``wkv6_bwd_plain`` for CPU
    tensors), reached through ``wkv6``'s own casts: the gradients of r, k,
    v, w_log, u and s0, with s_T unused (its cotangent None), also through
    a non-reentrant checkpoint, match autograd through the plain forward
    at 1e-4 of max|g|, each in its input's dtype (float64 w_log, u and s0
    come back as float64 after the fp32 kernels)."""
    monkeypatch.setattr(wkv6, "_forward", lambda r, k, v, w, u, s, ch: (
        *wkv6.wkv6_plain(r, k, v, w, u, s, chunk=ch), None))
    args, do, _ = inputs(1, 2, 70, 16, 6, s0=s0)
    t = [torch.from_numpy(x).to(dtype if i >= 3 else torch.float32)
         .requires_grad_() for i, x in enumerate(args)]
    if not s0:
        t[5] = None
    leaves = [x for x in t if x is not None]

    def fn(*a):
        # route the CPU tensors through the Function the way the wrapper
        # routes CUDA ones
        w, u = a[3].to(torch.float32), a[4].to(torch.float32)
        s = None if a[5] is None else a[5].to(torch.float32)
        return wkv6._Wkv6Grad.apply(a[0], a[1], a[2], w, u, s, 64)[0]

    out = (checkpoint(fn, *t, use_reentrant=False) if remat else fn(*t))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    ref_in = [x.detach().float().requires_grad_() for x in leaves]
    full = ref_in[:5] + ([ref_in[5]] if s0 else [None])
    want = torch.autograd.grad(wkv6.wkv6_plain(*full)[0], ref_in,
                               torch.from_numpy(do))
    for g, w, x in zip(got, want, leaves):
        assert g.dtype == x.dtype
        assert float((g.float() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())
