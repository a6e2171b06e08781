"""Port sliding-window attention (src/repro_torch/kernels/swa.py) against
the reference on the CPU, in fp32, from the same numpy inputs.

Both sides compute scores, softmax and the weighted sum in fp32 from the
same inputs, in another summation order (the reference's Pallas kernel and
its chunked flash path take an online softmax): atol = rtol = 2e-5, the
tolerance the reference's own tests hold its Pallas kernel to.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.kernels import build, ops, swa
from repro_torch.models import layers as L

TOL = dict(rtol=2e-5, atol=2e-5)


def qkv(b, s, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))


def port(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("b,s,h,kh,hd,window", [
    (2, 37, 4, 2, 16, 5),        # S and W not multiples of any block
    (1, 64, 6, 3, 8, 64),        # W = S
    (1, 40, 5, 1, 16, 100),      # W > S, g = 5
    (1, 33, 4, 4, 16, 1),        # W = 1 (self only), g = 1
])
def test_plain_matches_swa_ref(b, s, h, kh, hd, window):
    q, k, v = qkv(b, s, h, kh, hd, seed=s + window)
    want = jref.swa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        window)
    got = swa.swa_plain(*port(q, k, v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,window,bq,bk", [(256, 128, 128, 128),
                                            (256, 64, 64, 32),
                                            (128, 128, 64, 64)])
def test_plain_matches_pallas_interpret(s, window, bq, bk):
    """At the Pallas kernel's shape limits (S % bq, W % bk, bq % bk)."""
    q, k, v = qkv(1, s, 4, 2, 16, seed=window)
    want = jops.swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    window=window, impl="interpret", bq=bq, bk=bk)
    got = ops.swa(*port(q, k, v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_matches_chunked_flash_attention():
    """The reference model's flash_attention(window=...) at S=512 takes its
    chunked online-softmax branch (sq * skv > 256^2)."""
    jcfg = dataclasses.replace(jget_config("hymba_1_5b").reduced(),
                               n_heads=4, n_kv_heads=2, head_dim=16)
    q, k, v = qkv(1, 512, 4, 2, 16, seed=3)
    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jcfg, causal=True,
                                   window=128, q_chunk=128, kv_chunk=128)
    got = swa.swa_plain(*port(q, k, v), window=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [7, 0])
def test_softcap_matches_direct_attention(window):
    """With logit_softcap > 0, against the reference's _direct_attention
    (ops.swa's xla path drops the softcap, so it is not the yardstick)."""
    jcfg = dataclasses.replace(jget_config("hymba_1_5b").reduced(),
                               logit_softcap=5.0)
    h, kh, hd = jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    q, k, v = qkv(2, 30, h, kh, hd, seed=4)
    q *= 4.0                                   # scores well past the cap
    want = jlayers._direct_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, causal=True,
        window=window, prefix_len=0)
    cfg = dataclasses.replace(get_config("hymba_1_5b").reduced(),
                              logit_softcap=5.0)
    got = L.flash_attention(*port(q, k, v), cfg, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if window:
        got = ops.swa(*port(q, k, v), window=window, softcap=5.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    q, k, v = port(*qkv(1, 20, 4, 2, 16, seed=5))
    before = swa.swa.launches
    out = swa.swa(q, k, v, window=6)
    assert swa.swa.launches == before
    torch.testing.assert_close(out, swa.swa_plain(q, k, v, window=6),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", [dict(window=0),
                                 dict(window=3, kv_heads=3)])
def test_wrapper_rejects_bad_arguments(bad):
    q, k, v = port(*qkv(1, 8, 4, bad.get("kv_heads", 2), 16, seed=6))
    with pytest.raises(ValueError):
        swa.swa(q, k, v, window=bad["window"])


def test_aligned_copies_only_a_misaligned_view():
    """The bf16 swa kernel's tensor maps (and wkv6's cp.async loads) need
    16-byte aligned data: the wrappers copy a contiguous view that starts
    at an odd offset of its storage and pass every other contiguous tensor
    through untouched."""
    flat = torch.arange(64, dtype=torch.bfloat16)
    whole = flat[:48].view(3, 16)
    assert build.aligned(whole) is whole
    shifted = flat[1:49].view(3, 16)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    copy = build.aligned(shifted)
    assert copy.data_ptr() % 16 == 0
    assert torch.equal(copy, shifted)
