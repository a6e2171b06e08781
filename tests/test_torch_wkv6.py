"""Port chunked WKV6 (src/repro_torch/kernels/wkv6.py) against the reference
on the CPU, in fp32, from the same numpy inputs.

Tolerances, relative to the largest magnitude of the compared output:
- 2e-4 against the naive recurrence ``ref.wkv6_ref`` and the Pallas
  interpreter (the chunked form sums in another order; the reference's own
  tests hold its chunked paths to 2e-4);
- 1e-5 against the reference's ``rwkv.wkv6_chunked`` (the same formulas,
  summed in another order), also with w at the +4 clip, where lp falls to
  about -7000 over a chunk of 128.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rwkv as jrwkv
from repro_torch.kernels import ops, wkv6


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
    return r, k, v, w_log, u, st


def close(got, want, rel):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("t,chunk", [(64, 16), (96, 32), (50, 16), (7, 128)])
def test_plain_matches_recurrence_with_s0(t, chunk):
    """out and s_T against the naive recurrence, from a nonzero s0; T not a
    multiple of the chunk takes the zero-padded tail."""
    args = inputs(2, 3, t, 16, seed=t)
    want_o, want_s = jref.wkv6_ref(*map(jnp.asarray, args))
    got_o, got_s = wkv6.wkv6_plain(*map(torch.from_numpy, args), chunk=chunk)
    close(got_o, want_o, 2e-4)
    close(got_s, want_s, 2e-4)


@pytest.mark.parametrize("t,c", [(64, 16), (96, 8)])
def test_plain_matches_pallas_interpret(t, c):
    """Zero s0 (the Pallas kernel's only case), chunk 32."""
    r, k, v, w_log, u, _ = inputs(1, 2, t, c, seed=c, s0=False)
    want, _ = jops.wkv6(*map(jnp.asarray, (r, k, v, w_log, u)),
                        impl="interpret", chunk=32)
    got, _ = ops.wkv6(*map(torch.from_numpy, (r, k, v, w_log, u)), chunk=32)
    close(got, want, 2e-4)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("t,chunk", [(96, 32), (256, 128)])
def test_plain_matches_model_chunked(t, chunk, clip):
    args = inputs(1, 2, t, 16, seed=chunk, clip=clip)
    want_o, want_s = jrwkv.wkv6_chunked(*map(jnp.asarray, args), chunk=chunk)
    got_o, got_s = wkv6.wkv6_plain(*map(torch.from_numpy, args), chunk=chunk)
    close(got_o, want_o, 1e-5)
    close(got_s, want_s, 1e-5)
    assert np.isfinite(got_o.numpy()).all()


def test_zero_s0_is_the_default():
    r, k, v, w_log, u, z = map(torch.from_numpy,
                               inputs(1, 2, 20, 16, seed=1, s0=False))
    o1, s1 = wkv6.wkv6(r, k, v, w_log, u, None, chunk=8)
    o2, s2 = wkv6.wkv6(r, k, v, w_log, u, z, chunk=8)
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    args = list(map(torch.from_numpy, inputs(1, 2, 20, 16, seed=2)))
    before = wkv6.wkv6.launches
    out = wkv6.wkv6(*args, chunk=8)
    assert wkv6.wkv6.launches == before
    ref = wkv6.wkv6_plain(*args, chunk=8)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["chunk", "u", "s0"])
def test_wrapper_rejects_bad_arguments(bad):
    r, k, v, w_log, u, s0 = map(torch.from_numpy,
                                inputs(1, 2, 8, 16, seed=3))
    kw = dict(chunk=0 if bad == "chunk" else 8)
    if bad == "u":
        u = u[:, :8]
    if bad == "s0":
        s0 = s0[:, :1]
    with pytest.raises(ValueError):
        wkv6.wkv6(r, k, v, w_log, u, s0, **kw)
