"""The port's chunked running-softmax attention (``layers.flash_attention``
above 256 x 256 (query, key) pairs, ``layers.chunked_attention``) against
the reference's chunked ``flash_attention``, in fp32 on the CPU, from
numpy-seeded inputs.

Tolerances: outputs atol 2e-5 against the reference; gradients of q, k
and v against autograd through ``direct_attention`` rtol 1e-4 / atol
1e-6 of max(1, the largest gradient): a query that sees one key (causal
row 0) has an exactly zero gradient in the direct softmax, while the
running softmax's acc / l leaves a rounding residue of the two sums that
cancel (up to 1.1e-6 where the largest gradient is ~5); a reduced
model's prefill logits atol = rtol = 1e-4 (the tier of
tests/test_torch_serve.py).

The reference's chunked path places query i at key position i whatever
the lengths, its direct path right-aligns the queries to the keys
(i + Skv - Sq); the model code of the reference calls the chunked path
with Sq != Skv only without the causal mask (cross-attention), where the
two agree. The port right-aligns in both paths, so a causal Sq < Skv case
is held against the reference's ``_direct_attention``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers, zoo

ARCH = "hymba_1_5b"
OUT_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tensors here are small: one intra-op thread keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(h, kh, softcap=0.0):
    over = dict(n_heads=h, n_kv_heads=kh, head_dim=16, logit_softcap=softcap)
    return (dataclasses.replace(jget_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


def qkv(b, sq, skv, h, kh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, 16)).astype(np.float32),
            rng.standard_normal((b, skv, kh, 16)).astype(np.float32),
            rng.standard_normal((b, skv, kh, 16)).astype(np.float32))


# (sq, skv, h, kh, causal, window, prefix, softcap); every sq * skv > 256^2
CASES = {
    "causal_gqa": (320, 320, 4, 2, True, 0, 0, 0.0),
    "causal_mha": (288, 288, 4, 4, True, 0, 0, 0.0),
    "window": (320, 320, 4, 1, True, 100, 0, 0.0),
    "prefix": (320, 320, 4, 2, True, 0, 70, 0.0),
    "prefix_window": (320, 320, 4, 1, True, 40, 70, 0.0),
    "softcap30": (320, 320, 4, 2, True, 0, 0, 30.0),
    "softcap30_prefix_window": (320, 320, 4, 2, True, 90, 130, 30.0),
    "non_causal": (320, 320, 4, 2, False, 0, 0, 0.0),
    "non_causal_sq_ne_skv": (272, 336, 4, 2, False, 0, 0, 0.0),
    "cross_softcap30": (300, 264, 4, 4, False, 0, 0, 30.0),
}
CHUNKS = {"default": (1024, 1024), "64": (64, 64), "32x96": (32, 96)}


@pytest.mark.parametrize("chunks", list(CHUNKS))
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_matches_the_references_chunked_path(case, chunks):
    """The port's chunked path against the reference's
    ``flash_attention`` with the same chunks (both take their chunked
    branch: sq * skv > 256^2)."""
    sq, skv, h, kh, causal, window, prefix, cap = CASES[case]
    qc, kc = CHUNKS[chunks]
    jcfg, cfg = cfgs(h, kh, cap)
    q, k, v = qkv(2, sq, skv, h, kh, seed=sq + window + prefix)
    want = jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, causal=causal,
        window=window, prefix_len=prefix, q_chunk=qc, kv_chunk=kc)
    got = layers.chunked_attention(
        *map(torch.from_numpy, (q, k, v)), cfg, causal=causal, window=window,
        prefix_len=prefix, q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][5]
                                  or not CASES[c][4]])
def test_flash_attention_takes_the_chunked_path_as_the_reference(case):
    """``flash_attention`` itself (no window, or not causal) above 256^2,
    at the default chunks, against the reference's."""
    sq, skv, h, kh, causal, window, prefix, cap = CASES[case]
    jcfg, cfg = cfgs(h, kh, cap)
    q, k, v = qkv(1, sq, skv, h, kh, seed=7 + sq)
    want = jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, causal=causal,
        window=window, prefix_len=prefix)
    got = layers.flash_attention(*map(torch.from_numpy, (q, k, v)), cfg,
                                 causal=causal, window=window,
                                 prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("window,prefix", [(0, 0), (60, 0), (0, 40)])
def test_causal_sq_below_skv_is_right_aligned(window, prefix):
    """A causal Sq < Skv block (queries at the last Sq key positions)
    against the reference's right-aligned ``_direct_attention``."""
    jcfg, cfg = cfgs(4, 2)
    q, k, v = qkv(2, 240, 320, 4, 2, seed=11 + window)
    want = jlayers._direct_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, causal=True,
        window=window, prefix_len=prefix)
    got = layers.chunked_attention(*map(torch.from_numpy, (q, k, v)), cfg,
                                   causal=True, window=window,
                                   prefix_len=prefix, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("chunks", ["64", "32x96"])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_autograd_through_direct_attention(case, chunks):
    """d/dq, d/dk, d/dv of a weighted sum of the output (the Q blocks as
    checkpoint regions, several KV blocks each) against autograd through
    ``direct_attention``."""
    sq, skv, h, kh, causal, window, prefix, cap = CASES[case]
    qc, kc = CHUNKS[chunks]
    _, cfg = cfgs(h, kh, cap)
    arrays = qkv(1, sq, skv, h, kh, seed=3 + sq + window)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, sq, h, 16)).astype(np.float32))

    def grads(fn):
        t = [torch.from_numpy(a).requires_grad_() for a in arrays]
        out = fn(*t, cfg, causal=causal, window=window, prefix_len=prefix)
        return torch.autograd.grad((out * w).sum(), t)

    got = grads(lambda *a, **kw: layers.chunked_attention(
        *a, q_chunk=qc, kv_chunk=kc, **kw))
    want = grads(layers.direct_attention)
    for name, g, r in zip("qkv", got, want):
        atol = 1e-6 * max(1.0, float(r.abs().max()))
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=name)


def test_the_checkpointed_and_the_plain_forward_agree_bitwise():
    """With autograd (checkpointed Q blocks) and under no_grad: one
    output."""
    _, cfg = cfgs(4, 2, 30.0)
    t = [torch.from_numpy(a) for a in qkv(1, 320, 320, 4, 2, seed=9)]
    with torch.no_grad():
        plain = layers.chunked_attention(*t, cfg, prefix_len=33, q_chunk=64,
                                         kv_chunk=64)
    t[0].requires_grad_()
    ckpt = layers.chunked_attention(*t, cfg, prefix_len=33, q_chunk=64,
                                    kv_chunk=64)
    assert ckpt.requires_grad and torch.equal(ckpt.detach(), plain)


@pytest.mark.parametrize("causal,window,prefix",
                         [(True, 0, 0), (True, 50, 0), (True, 0, 70),
                          (True, 40, 100), (False, 0, 0), (False, 30, 0)])
def test_block_skips_and_masks_follow_the_full_mask(causal, window, prefix):
    """For every (Q block, KV block) pair: a skipped block keeps no pair,
    a block without a mask keeps every pair, and a built mask drops
    exactly the pairs the full mask drops."""
    sq, skv, cq, ck = 192, 288, 32, 48
    off = skv - sq
    qp = np.arange(sq)[:, None] + off
    kp = np.arange(skv)[None, :]
    full = np.ones((sq, skv), bool)
    if causal:
        full &= (kp <= qp) | (kp < prefix)
    if window:
        full &= kp > qp - window
    kcol = torch.arange(ck)[None, :]
    rel = torch.arange(cq)[:, None] - kcol
    kept = skipped = 0
    for q0 in range(0, sq, cq):
        for k0 in range(0, skv, ck):
            want = full[q0:q0 + cq, k0:k0 + ck]
            kw = dict(causal=causal, window=window, prefix_len=prefix)
            if not layers._sees_block(q0 + off, q0 + off + cq - 1, k0, ck,
                                      **kw):
                assert not want.any()
                skipped += 1
                continue
            drop = layers._block_drop(q0 + off, k0, rel, kcol, **kw)
            if drop is None:
                assert want.all()
                kept += 1
            else:
                assert np.array_equal(~drop.numpy(), want)
    # the cases reach each branch: a 50-wide window keeps no whole block
    assert skipped > 0 or not (causal or window)
    assert kept > 0 or window


def test_dispatch_follows_the_references_switch(monkeypatch):
    """Up to 256^2 pairs the direct path, above it the chunked one; causal
    with a window goes to ``ops.swa`` at any length."""
    _, cfg = cfgs(4, 2)
    taken = []
    for name in ("direct_attention", "chunked_attention"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _f=real, **kw:
                            taken.append(_n) or _f(*a, **kw))
    real_swa = layers.ops.swa
    monkeypatch.setattr(layers.ops, "swa", lambda *a, **kw:
                        taken.append("swa") or real_swa(*a, **kw))
    for sq, skv, window in [(256, 256, 0), (257, 256, 0), (128, 513, 0),
                            (64, 1024, 0), (512, 512, 64)]:
        t = [torch.from_numpy(a) for a in qkv(1, sq, skv, 4, 2, seed=1)]
        layers.flash_attention(*t, cfg, causal=window > 0, window=window)
    assert taken == ["direct_attention", "chunked_attention",
                     "chunked_attention", "direct_attention", "swa"]


def test_bf16_inputs_keep_their_dtype():
    """bf16 q, k, v: the chunked path computes in fp32 and returns bf16
    within one bf16 rounding of the fp32 result."""
    _, cfg = cfgs(4, 2)
    t = [torch.from_numpy(a) for a in qkv(1, 320, 320, 4, 2, seed=4)]
    tb = [x.bfloat16() for x in t]
    got = layers.flash_attention(*tb, cfg)
    want = layers.direct_attention(*[x.float() for x in tb], cfg)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - want).abs().max())
    assert err <= 2.0 ** -8 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "paligemma_3b",
                                  "seamless_m4t_medium"])
def test_a_long_prefill_takes_the_chunked_path_as_the_reference(arch):
    """A reduced model's unwindowed prefill past 256 positions (the
    reference's chunked branch on both sides; a vlm's prefix among them):
    last logits and the cache against the reference's."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jparams, _ = jzoo.init_model(jax.random.PRNGKey(2), jcfg)
    model = zoo.build_model(cfg, torch.device("cpu"))
    model.load_state_dict(convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 300)).astype(
        np.int32)}
    if cfg.family in ("vlm", "encdec"):
        batch["prefix" if cfg.family == "vlm" else "frames"] = \
            rng.standard_normal((1, cfg.n_prefix_tokens,
                                 cfg.prefix_dim)).astype(np.float32)
    jlast, jcache = jax.jit(jzoo.make_prefill_step(jcfg))(
        jparams, jax.tree.map(jnp.asarray, batch))
    last, cache = zoo.make_prefill_step(cfg)(model, {
        n: torch.from_numpy(a).long() if a.dtype == np.int32
        else torch.from_numpy(a) for n, a in batch.items()})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
