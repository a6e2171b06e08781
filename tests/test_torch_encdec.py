"""The encdec family (seamless_m4t_medium) against the reference, reduced
(2 encoder + 2 decoder layers, d_model 128, 2:2 heads at head_dim 16, 8
frames), in fp32 on the CPU, from the reference's own initial parameters
loaded through ``convert.params_from_numpy`` (its ``enc_blocks`` and
``dec_blocks`` unstacked).

Tolerances (the tiers of tests/test_torch_archs.py): the encoder's memory
and the forward logits atol 2e-5; prefill logits and caches, decode logits
atol = rtol = 1e-4; greedy tokens exactly; decode against the port's own
teacher-forced forward within 1e-4 of max|logits|, as the reference's
tests/test_arch_smoke.py::test_encdec_decode_matches_forward holds its
own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import encdec as jED
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.serve import run_serve
from repro_torch.models import zoo
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM

ARCH = "seamless_m4t_medium"
TOL = dict(rtol=1e-4, atol=1e-4)


def build(seed=0, **overrides):
    """(reference cfg, port cfg, reference params, port model) from one
    reference init, loaded with a strict ``load_state_dict``."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), **overrides)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **overrides)
    jparams, _ = jzoo.init_model(jax.random.PRNGKey(seed), jcfg)
    model = zoo.build_model(cfg, torch.device("cpu"))
    model.load_state_dict(convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return jcfg, cfg, jparams, model


def inputs(cfg, b, s, seed=0):
    """Seeded tokens (B, S) and encoder frames (B, P, prefix_dim)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.standard_normal(
        (b, cfg.n_prefix_tokens, cfg.prefix_dim)).astype(np.float32)
    return toks, frames


def batches(toks, frames):
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks).long(),
             "frames": torch.from_numpy(frames)})


def assert_cache_close(cache, jcache):
    assert sorted(cache) == sorted(jcache)
    for name, val in cache.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(jcache[name]),
                                   err_msg=name, **TOL)


def test_the_tree_converts_and_the_decoder_refuses_it():
    """``zoo.build_model`` gives an ``EncDecLM`` with the reference's names
    (a strict load); ``DecoderLM`` does not build the family."""
    cfg, model = build()[1], build()[3]
    assert isinstance(model, EncDecLM)
    assert len(model.enc_blocks) == cfg.n_enc_layers == 2
    assert len(model.dec_blocks) == cfg.n_layers == 2
    with pytest.raises(ValueError, match="models/encdec.py"):
        DecoderLM(cfg, torch.device("meta"))
    bad = convert.flatten_tree(jax.tree.map(
        np.asarray, jzoo.init_model(jax.random.PRNGKey(0), dataclasses.replace(
            jget_config(ARCH).reduced(), n_enc_layers=3))[0]))
    with pytest.raises(ValueError, match="3 enc_blocks"):
        convert.params_from_numpy(
            {"enc_blocks": {"ln1": np.stack([bad["enc_blocks.0.ln1"]] * 3)},
             "dec_blocks": {"ln1": np.stack([bad["dec_blocks.0.ln1"]] * 2)}},
            cfg, "cpu")


def test_encode():
    jcfg, cfg, jparams, model = build(seed=1)
    _, frames = inputs(cfg, 2, 4, seed=1)
    want = jED.encode(jcfg, jparams, jnp.asarray(frames), remat=False)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("s", [12, 24])
def test_forward_logits(s):
    jcfg, cfg, jparams, model = build(seed=2)
    toks, frames = inputs(cfg, 2, s, seed=2)
    jb, b = batches(toks, frames)
    jlogits, _ = jzoo.forward(jcfg, jparams, jb, remat=False)
    with torch.no_grad():
        logits, aux = zoo.forward(cfg, model, b)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=0)
    assert float(aux) == 0.0


@pytest.mark.parametrize("s,window", [(24, 0), (24, 7), (300, 0),
                                      (300, 256)])
def test_prefill_logits_and_cache(s, window):
    """The prefill's last logits and its cache (self k, v, pos; cross xk,
    xv), with and without a window on the decoder's self-attention; at
    S=300 the reference takes its chunked attention."""
    jcfg, cfg, jparams, model = build(seed=3)
    toks, frames = inputs(cfg, 2, s, seed=3)
    jb, b = batches(toks, frames)
    jlast, jcache = jax.jit(jzoo.make_prefill_step(jcfg, window=window))(
        jparams, jb)
    last, cache = zoo.make_prefill_step(cfg, window=window)(model, b)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    assert_cache_close(cache, jcache)


def test_decode_steps_against_encdec_decode():
    """Decode from an empty self cache with the cross k, v of the prefill,
    step by step against the reference's ``encdec_decode``."""
    jcfg, cfg, jparams, model = build(seed=4)
    b, steps = 2, 6
    toks, frames = inputs(cfg, b, steps, seed=4)
    jb, tb = batches(toks, frames)
    _, jpc = jax.jit(jzoo.make_prefill_step(jcfg))(jparams, jb)
    _, pc = zoo.make_prefill_step(cfg)(model, tb)
    jcache = dict(jzoo.init_cache(jcfg, b, steps), xk=jpc["xk"],
                  xv=jpc["xv"])
    cache = zoo.init_cache(cfg, b, steps, device="cpu")
    cache["xk"].copy_(pc["xk"])
    cache["xv"].copy_(pc["xv"])
    jstep = jax.jit(jzoo.make_serve_step(jcfg))
    step = zoo.make_serve_step(cfg)
    for i in range(steps):
        jnxt, jlogits, jcache = jstep(jparams, jcache,
                                      jnp.asarray(toks[:, i]), i)
        nxt, logits, cache = step(model, cache,
                                  torch.from_numpy(toks[:, i]).long(), i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    assert_cache_close(cache, jcache)


def test_decode_matches_forward():
    """Mirror of tests/test_arch_smoke.py::test_encdec_decode_matches_forward
    on the port: teacher-forced logits equal step-by-step decode against
    the memory's cross k, v."""
    _, cfg, _, model = build(seed=1)
    b, s = 2, 12
    toks, frames = inputs(cfg, b, s, seed=5)
    t, f = torch.from_numpy(toks).long(), torch.from_numpy(frames)
    with torch.no_grad():
        full = model(f, t)
        mem = model.encode(f)
        cache = zoo.init_cache(cfg, b, s, device="cpu")
        for i, blk in enumerate(model.dec_blocks):
            cache["xk"][i], cache["xv"][i] = blk.cross_kv(mem)
    step = zoo.make_serve_step(cfg)
    outs = [step(model, cache, t[:, i], i)[1] for i in range(s)]
    err = float((full - torch.stack(outs, 1)).abs().max())
    assert err < 1e-4 * max(1.0, float(full.abs().max()))


def test_padded_logits_never_win_argmax():
    """Mirror of tests/test_model_properties.py::TestVocabPadding: vocab
    500 pads to 512, and the padded logits never win the argmax."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), vocab_size=500)
    assert cfg.padded_vocab == 512
    model = zoo.init_model(cfg, seed=0, device="cpu")
    toks, frames = inputs(cfg, 2, 8, seed=6)
    with torch.no_grad():
        logits = model(torch.from_numpy(frames), torch.from_numpy(toks).long())
    assert logits.shape[-1] == 512
    assert int(logits.argmax(-1).max()) < 500


def reference_serve(jcfg, jparams, b, s, gen, seed):
    """The reference's ``launch/serve.py`` body for encdec through its own
    ``zoo`` steps: frames drawn after the prompt, the cross k, v placed
    from the prefill, decode at s + i."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size, (b, s)),
                                   jnp.int32)}
    batch["frames"] = jnp.asarray(
        rng.normal(size=(b, jcfg.n_prefix_tokens, jcfg.prefix_dim)),
        jnp.dtype(jcfg.dtype))
    cache = jzoo.init_cache(jcfg, b, s + gen)
    last, pcache = jax.jit(jzoo.make_prefill_step(jcfg))(jparams, batch)
    cache = dict(cache, xk=pcache["xk"], xv=pcache["xv"])
    for n in ("k", "v", "pos"):
        cache[n] = cache[n].at[:, :, :s].set(pcache[n][:, :, :s])
    serve = jax.jit(jzoo.make_serve_step(jcfg))
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)
    out = [np.asarray(tok)]
    for i in range(gen - 1):
        tok, _, cache = serve(jparams, cache, tok, s + i)
        out.append(np.asarray(tok))
    return np.stack(out, axis=1)


def test_run_serve_tokens_equal_the_reference_steps():
    b, s, gen, seed = 2, 20, 6, 3
    jcfg, cfg, jparams, model = build(seed=seed)
    want = reference_serve(jcfg, jparams, b, s, gen, seed)
    res = run_serve(cfg, batch=b, prompt_len=s, gen=gen, seed=seed,
                    device="cpu", model=model)
    np.testing.assert_array_equal(res["tokens"], want)


def test_init_model_draws_the_references_law():
    """Each tensor's spread matches the reference's init (frontend_proj by
    its fan-in prefix_dim, lm_head by d_model); the draws differ."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), d_ff=256)
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), d_ff=256)
    jflat = convert.flatten_tree(jax.tree.map(
        np.asarray, jzoo.init_model(jax.random.PRNGKey(0), jcfg)[0]))
    model = zoo.init_model(cfg, seed=0, device="cpu")
    assert sorted(n for n, _ in model.named_parameters()) == sorted(jflat)
    for name, p in model.named_parameters():
        want = float(np.std(jflat[name]))
        assert float(p.detach().std()) == pytest.approx(want, rel=0.06,
                                                        abs=1e-7), name


def test_ravel_segments_cover_the_encdec_tree():
    """``convert.ravel_segments`` maps the port's flat order onto the
    reference's ``ravel_pytree`` order for the two stacked subtrees."""
    from jax.flatten_util import ravel_pytree
    jcfg, cfg, jparams, model = build(seed=7)
    flat_ref = np.asarray(ravel_pytree(jparams)[0])
    segs = convert.ravel_segments(
        (n, p.shape) for n, p in model.named_parameters())
    port = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    np.testing.assert_array_equal(
        convert.to_ravel_order(port, segs).numpy(), flat_ref)
