"""The vlm family (paligemma_3b) and the prefix-LM band of swa against the
reference, in fp32 on the CPU, from the reference's own initial parameters
(convert.py): the reduced paligemma (2 layers, head_dim 16, 4:1 heads, an
8-token prefix) and a 2-layer paligemma at its head_dim 256 and 8:1 MQA.

Tolerances (the tiers of tests/test_torch_archs.py):
- swa_plain against the reference's attention: atol = rtol = 2e-5
  (tests/test_torch_swa.py);
- forward logits: atol 2e-5;
- prefill logits and caches, decode logits: atol = rtol = 1e-4; greedy
  tokens exactly; the token loss rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.configs import FLConfig, NOMAConfig, get_config
from repro_torch.data import TaskConfig
from repro_torch.fl import FLServer
from repro_torch.kernels import swa
from repro_torch.launch import train
from repro_torch.launch.serve import run_serve
from repro_torch.models import layers, zoo

ARCH = "paligemma_3b"
TOL = dict(rtol=1e-4, atol=1e-4)
SWA_TOL = dict(rtol=2e-5, atol=2e-5)
# paligemma's attention at full head_dim, cut to 2 layers and narrow widths
HD256 = dict(n_layers=2, d_model=128, d_ff=256, vocab_size=512,
             n_prefix_tokens=8, prefix_dim=64, dtype="float32",
             long_context_window=256)


def build(seed=0, full_heads=False, **overrides):
    """(reference cfg, port cfg, reference params, port model) from one
    reference init, loaded with a strict ``load_state_dict``; with
    ``full_heads`` paligemma's own heads (8:1 at head_dim 256)."""
    base = (lambda c: dataclasses.replace(c, **HD256)) if full_heads \
        else (lambda c: c.reduced())
    jcfg = dataclasses.replace(base(jget_config(ARCH)), **overrides)
    cfg = dataclasses.replace(base(get_config(ARCH)), **overrides)
    jparams, _ = jzoo.init_model(jax.random.PRNGKey(seed), jcfg)
    model = zoo.build_model(cfg, torch.device("cpu"))
    model.load_state_dict(convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return jcfg, cfg, jparams, model


def inputs(cfg, b, s, seed=0):
    """Seeded tokens (B, S) and image prefix (B, P, prefix_dim)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pref = rng.standard_normal(
        (b, cfg.n_prefix_tokens, cfg.prefix_dim)).astype(np.float32)
    return toks, pref


def batches(toks, pref):
    return ({"tokens": jnp.asarray(toks), "prefix": jnp.asarray(pref)},
            {"tokens": torch.from_numpy(toks).long(),
             "prefix": torch.from_numpy(pref)})


def assert_cache_close(cache, jcache):
    assert sorted(cache) == sorted(jcache)
    for name, val in cache.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(jcache[name]),
                                   err_msg=name, **TOL)


def qkv(b, s, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))


def attn_cfg(hd):
    return dataclasses.replace(jget_config(ARCH).reduced(), n_heads=8,
                               n_kv_heads=1, head_dim=hd)


# a window below and above the prefix, and a prefix longer than the window
@pytest.mark.parametrize("window,prefix", [(20, 40), (60, 16), (16, 100)])
@pytest.mark.parametrize("hd", [16, 256])
def test_swa_plain_prefix_matches_direct_attention(hd, window, prefix):
    """swa_plain(prefix=) at GQA 8:1 against the reference's
    ``_direct_attention(prefix_len=)``, and the CPU path of ``swa``."""
    q, k, v = qkv(2, 130, 8, 1, hd, seed=hd + window)
    want = jlayers._direct_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), attn_cfg(hd),
        causal=True, window=window, prefix_len=prefix)
    t = tuple(map(torch.from_numpy, (q, k, v)))
    got = swa.swa_plain(*t, window=window, prefix=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SWA_TOL)
    assert torch.equal(swa.swa(*t, window=window, prefix=prefix), got)


@pytest.mark.parametrize("window,prefix", [(0, 32), (100, 32), (24, 64)])
@pytest.mark.parametrize("hd", [16, 256])
def test_flash_attention_prefix_matches_the_chunked_reference(hd, window,
                                                              prefix):
    """The port's ``flash_attention(prefix_len=)`` (the direct path, or
    swa with a window) against the reference's chunked online softmax
    (S=320 in 64-row chunks: the prefix spans chunks)."""
    q, k, v = qkv(1, 320, 8, 1, hd, seed=3 * hd + window)
    jcfg = attn_cfg(hd)
    want = jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, causal=True,
        window=window, prefix_len=prefix, q_chunk=64, kv_chunk=64)
    got = layers.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 get_config(ARCH).reduced(), causal=True,
                                 window=window, prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SWA_TOL)


@pytest.mark.parametrize("window", [0, 40])
def test_prefix_lm_mask(window):
    """Mirror of tests/test_model_properties.py::test_prefix_lm_mask on the
    port: prefix tokens attend bidirectionally, the suffix causally."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_heads=2,
                              n_kv_heads=1, head_dim=16)
    b, s, pre = 1, 64, 16
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b, s, 2, 16), generator=gen)
    k = torch.randn((b, s, 1, 16), generator=gen)
    v = torch.randn((b, s, 1, 16), generator=gen)

    def attend(vv):
        return layers.flash_attention(q, k, vv, cfg, causal=True,
                                      window=window, prefix_len=pre)

    out = attend(v)
    # changing a FUTURE suffix token must not affect earlier suffix
    v2 = v.clone()
    v2[:, -1] += 10.0
    torch.testing.assert_close(out[:, :-1], attend(v2)[:, :-1], atol=1e-6,
                               rtol=0)
    # but changing a PREFIX token affects position 0 (bidirectional)
    v3 = v.clone()
    v3[:, pre - 1] += 10.0
    assert float((attend(v3)[:, 0] - out[:, 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("full_heads", [False, True])
def test_forward_logits_with_a_prefix(full_heads):
    """Logits over [prefix + text] (P + S positions); ``full_heads`` is the
    2-layer paligemma at head_dim 256, 8:1."""
    jcfg, cfg, jparams, model = build(full_heads=full_heads)
    toks, pref = inputs(cfg, 2, 24)
    jb, b = batches(toks, pref)
    jlogits, _ = jzoo.forward(jcfg, jparams, jb, remat=False)
    with torch.no_grad():
        logits, aux = zoo.forward(cfg, model, b)
    assert logits.shape[1] == cfg.n_prefix_tokens + 24
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=0)
    assert float(aux) == 0.0


@pytest.mark.parametrize("full_heads,s,window", [
    (False, 24, 0), (False, 24, 7), (False, 24, 12), (False, 300, 0),
    (False, 300, 256), (True, 24, 0), (True, 24, 7), (True, 300, 256)])
def test_prefill_logits_and_cache(full_heads, s, window):
    """The prefill over P + S positions, with and without a window: a
    window of 7 is below the 8-token prefix, 12 above it; at S=300 the
    reference takes its chunked attention."""
    jcfg, cfg, jparams, model = build(seed=1, full_heads=full_heads)
    toks, pref = inputs(cfg, 2, s, seed=1)
    jb, b = batches(toks, pref)
    jlast, jcache = jax.jit(jzoo.make_prefill_step(jcfg, window=window))(
        jparams, jb)
    last, cache = zoo.make_prefill_step(cfg, window=window)(model, b)
    assert cache["k"].shape[2] == cfg.n_prefix_tokens + s
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    assert_cache_close(cache, jcache)


def test_decode_after_the_prefill():
    """Prefill P + s positions into a P + s + gen cache, then decode steps
    at positions P + s + i against the reference's ``decoder_decode``."""
    jcfg, cfg, jparams, model = build(seed=2)
    b, s, gen = 2, 20, 5
    p = cfg.n_prefix_tokens
    toks, pref = inputs(cfg, b, s, seed=2)
    jb, tb = batches(toks, pref)
    _, jpc = jax.jit(jzoo.make_prefill_step(jcfg))(jparams, jb)
    _, pc = zoo.make_prefill_step(cfg)(model, tb)
    jcache = jzoo.init_cache(jcfg, b, p + s + gen)
    cache = zoo.init_cache(cfg, b, p + s + gen, device="cpu")
    for name in ("k", "v", "pos"):
        jcache[name] = jcache[name].at[:, :, :p + s].set(jpc[name])
        cache[name][:, :, :p + s] = pc[name]
    step = zoo.make_serve_step(cfg)
    nxt = toks[:, -1]
    for i in range(gen):
        pos = p + s + i
        jlogits, jcache = jax.jit(jT.decoder_decode, static_argnums=0)(
            jcfg, jparams, jcache, jnp.asarray(nxt), pos)
        tok, logits, cache = step(model, cache, torch.from_numpy(nxt).long(),
                                  pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        nxt = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        np.testing.assert_array_equal(tok.numpy(), nxt)
    assert_cache_close(cache, jcache)


def reference_serve(jcfg, jparams, b, s, gen, seed):
    """The reference's ``launch/serve.py`` body through its own ``zoo``
    steps, with the cache sized P + s + gen (its command line sizes it
    s + gen, which the vlm prefill overflows)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size, (b, s)),
                                   jnp.int32)}
    batch["prefix"] = jnp.asarray(
        rng.normal(size=(b, jcfg.n_prefix_tokens, jcfg.prefix_dim)),
        jnp.dtype(jcfg.dtype))
    pref = jcfg.n_prefix_tokens
    cache = jzoo.init_cache(jcfg, b, pref + s + gen)
    last, pcache = jax.jit(jzoo.make_prefill_step(jcfg))(jparams, batch)
    for n in ("k", "v", "pos"):
        cache[n] = cache[n].at[:, :, :pref + s].set(
            pcache[n][:, :, :pref + s])
    serve = jax.jit(jzoo.make_serve_step(jcfg))
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)
    out = [np.asarray(tok)]
    for i in range(gen - 1):
        tok, _, cache = serve(jparams, cache, tok, s + pref + i)
        out.append(np.asarray(tok))
    return np.stack(out, axis=1)


def test_run_serve_tokens_equal_the_reference_steps():
    b, s, gen, seed = 2, 20, 6, 3
    jcfg, cfg, jparams, model = build(seed=seed)
    want = reference_serve(jcfg, jparams, b, s, gen, seed)
    res = run_serve(cfg, batch=b, prompt_len=s, gen=gen, seed=seed,
                    device="cpu", model=model)
    np.testing.assert_array_equal(res["tokens"], want)


def test_token_loss_takes_the_text_slice():
    """logits[:, P + i] predicts labels[:, i]; equal to the reference's
    ``token_loss`` and to the CE over the text slice alone."""
    jcfg, cfg, jparams, model = build(seed=4)
    toks, pref = inputs(cfg, 3, 13, seed=4)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb, b = batches(toks, pref)
    jlogits, _ = jzoo.forward(jcfg, jparams, jb, remat=False)
    with torch.no_grad():
        logits, _ = zoo.forward(cfg, model, b)
        lab = torch.from_numpy(labels).long()
        loss = zoo.token_loss(cfg, logits, lab)
        text = dataclasses.replace(cfg, n_prefix_tokens=0)
        alone = zoo.token_loss(text, logits[:, cfg.n_prefix_tokens:], lab)
    jl = jzoo.token_loss(jcfg, jlogits, jnp.asarray(labels))
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    assert loss.item() == alone.item()


def test_nope_decoder_matches_the_reference():
    """A dense decoder with rope_frac 0 (NoPE): the sinusoid embedding at
    every position in forward and at ``pos`` in decode."""
    jcfg = dataclasses.replace(jget_config("smollm_135m").reduced(),
                               rope_frac=0.0)
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(),
                              rope_frac=0.0)
    jparams, _ = jzoo.init_model(jax.random.PRNGKey(5), jcfg)
    model = zoo.build_model(cfg, torch.device("cpu"))
    model.load_state_dict(convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (2, 10)).astype(np.int32)
    jlogits, _ = jzoo.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              remat=False)
    with torch.no_grad():
        logits, _ = zoo.forward(cfg, model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=0)
    jcache = jzoo.init_cache(jcfg, 2, 10)
    cache = zoo.init_cache(cfg, 2, 10, device="cpu")
    step = zoo.make_serve_step(cfg)
    for i in range(10):
        _, jl, jcache = jax.jit(jzoo.make_serve_step(jcfg))(
            jparams, jcache, jnp.asarray(toks[:, i]), i)
        _, lg, cache = step(model, cache, torch.from_numpy(toks[:, i]).long(),
                            i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **TOL)


def test_sinusoid_matches_the_reference():
    """The two frameworks' fp32 ``exp`` differ by one ulp (3e-8) in some
    frequencies, which moves the angle at position 693 by up to 2.1e-5:
    atol 5e-5."""
    pos = np.arange(0, 700, 7)
    want = jlayers.sinusoid_pos_emb(jnp.asarray(pos), 96)
    got = layers.sinusoid_pos_emb(torch.from_numpy(pos), 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-5)


def test_init_model_draws_the_references_law():
    """Each tensor's spread matches the reference's init (``prefix_proj``
    by its fan-in prefix_dim); the draws themselves differ by design."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), prefix_dim=64,
                              n_prefix_tokens=8)
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), prefix_dim=64,
                               n_prefix_tokens=8)
    jflat = convert.flatten_tree(jax.tree.map(
        np.asarray, jzoo.init_model(jax.random.PRNGKey(0), jcfg)[0]))
    model = zoo.init_model(cfg, seed=0, device="cpu")
    assert sorted(n for n, _ in model.named_parameters()) == sorted(jflat)
    for name, p in model.named_parameters():
        want = float(np.std(jflat[name]))
        assert float(p.detach().std()) == pytest.approx(want, rel=0.06,
                                                        abs=1e-7), name


@pytest.mark.parametrize("arch", ["paligemma_3b", "seamless_m4t_medium"])
def test_the_fl_round_refuses_the_family(arch, tmp_path):
    """The reference's round fails on these families (a shape error in
    token_loss for vlm, KeyError 'frames' for encdec); the port's server
    and train CLI refuse them up front with a ValueError that says why."""
    cfg = get_config(arch).reduced()
    with pytest.raises(ValueError, match="zoo.py:221-222"):
        FLServer(cfg, FLConfig(n_clients=4, rounds=1), NOMAConfig(),
                 TaskConfig(vocab_size=32, seq_len=17), device="cpu")
    with pytest.raises(ValueError, match=cfg.family):
        train.main(["--arch", arch, "--rounds", "1", "--clients", "4",
                    "--device", "cpu", "--out", str(tmp_path)])
