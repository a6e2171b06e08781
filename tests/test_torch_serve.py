"""The port's serving path (prefill, decode, ``run_serve``) against the
reference, for the reduced hymba_1_5b (hybrid) and rwkv6_7b (ssm) configs
in fp32 on the CPU, from the reference's own initial parameters
(convert.py).

Tolerances: prefill and decode logits, and every cache leaf, to
atol = rtol = 1e-4. Both sides run fp32 through two layers from the same
weights and tokens; they sum in another order (the reference takes a
chunked online softmax for the hybrid prefill, an associative scan of
another tree for the SSM branch, and XLA's fusions), which moves values of
order 1 by ~1e-6. The greedy tokens are compared exactly.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.serve import run_serve
from repro_torch.models import zoo
from repro_torch.models.transformer import DecoderLM

TOL = dict(rtol=1e-4, atol=1e-4)
# the hybrid prompt is longer than the reduced window (256): the band bites
PROMPT = {"hymba_1_5b": 300, "rwkv6_7b": 40}
ARCHS = sorted(PROMPT)


def build(arch, seed=0, **overrides):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **overrides)
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    jparams, _ = jzoo.init_model(jax.random.PRNGKey(seed), jcfg)
    model = DecoderLM(cfg, torch.device("cpu"))
    model.load_state_dict(convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return jcfg, cfg, jparams, model


def assert_cache_close(cache, jcache):
    assert sorted(cache) == sorted(jcache)
    for name, val in cache.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(jcache[name]),
                                   err_msg=name, **TOL)


def prompt(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch):
    jcfg, cfg, jparams, model = build(arch)
    toks = prompt(cfg, 2, PROMPT[arch])
    jlast, jcache = jax.jit(jzoo.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    last, cache = zoo.make_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch,ring,overrides,cache_len,steps", [
    ("hymba_1_5b", False, {}, 12, 10),
    # ring cache shorter than the run, and a window shorter than the cache:
    # both the wrap and the window mask of the decode path bite
    ("hymba_1_5b", True, {"long_context_window": 4}, 6, 10),
    ("rwkv6_7b", False, {}, 1, 10),
])
def test_decode_steps_from_an_empty_cache(arch, ring, overrides, cache_len,
                                          steps):
    jcfg, cfg, jparams, model = build(arch, seed=1, **overrides)
    toks = prompt(cfg, 2, steps, seed=1)
    jserve_step = jax.jit(jzoo.make_serve_step(jcfg, ring=ring))
    serve_step = zoo.make_serve_step(cfg, ring=ring)
    jcache = jzoo.init_cache(jcfg, 2, cache_len)
    cache = zoo.init_cache(cfg, 2, cache_len, device="cpu")
    for i in range(steps):
        jnxt, jlogits, jcache = jserve_step(jparams, jcache,
                                            jnp.asarray(toks[:, i]), i)
        nxt, logits, cache = serve_step(model, cache,
                                        torch.from_numpy(toks[:, i]).long(), i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        assert_cache_close(cache, jcache)


def test_hybrid_decode_after_prefill():
    """The serve flow of the hybrid family: prefill, copy k, v, pos and
    ssm_h into a linear cache, then decode against the reference."""
    jcfg, cfg, jparams, model = build("hymba_1_5b", seed=2)
    b, s, gen = 2, PROMPT["hymba_1_5b"], 4
    toks = prompt(cfg, b, s, seed=2)
    jlast, jpcache = jax.jit(jzoo.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    jcache = jzoo.init_cache(jcfg, b, s + gen)
    for name in ("k", "v", "pos"):
        jcache[name] = jax.lax.dynamic_update_slice_in_dim(
            jcache[name], jpcache[name][:, :, :s], 0, axis=2)
    jcache["ssm_h"] = jpcache["ssm_h"]
    _, pcache = zoo.make_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(toks).long()})
    cache = zoo.init_cache(cfg, b, s + gen, device="cpu")
    for name in ("k", "v", "pos"):
        cache[name][:, :, :s] = pcache[name]
    cache["ssm_h"].copy_(pcache["ssm_h"])
    jtok = jnp.argmax(jlast, axis=-1).astype(jnp.int32)
    tok = torch.from_numpy(np.array(jtok)).long()
    jstep = jax.jit(jzoo.make_serve_step(jcfg))
    step = zoo.make_serve_step(cfg)
    for i in range(gen):
        jtok, jlogits, jcache = jstep(jparams, jcache, jtok, s + i)
        tok, logits, cache = step(model, cache, tok, s + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serve_tokens_equal_the_reference_serve(arch):
    """Greedy tokens of ``run_serve`` equal those the reference's
    ``launch/serve.py`` prints, from the same seed's weights."""
    b, s, gen, seed = 2, PROMPT[arch], 5, 3
    argv = ["serve", "--arch", arch, "--batch", str(b), "--prompt-len",
            str(s), "--gen", str(gen), "--seed", str(seed)]
    out = io.StringIO()
    saved = sys.argv
    try:
        sys.argv = argv
        with contextlib.redirect_stdout(out):
            jserve.main()
    finally:
        sys.argv = saved
    line = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("[serve] generated:")][0]
    want = eval(line.split(":", 1)[1])        # a printed list of lists
    _, cfg, _, model = build(arch, seed=seed)
    res = run_serve(cfg, batch=b, prompt_len=s, gen=gen, seed=seed,
                    device="cpu", model=model)
    assert res["tokens"].shape == (b, gen)
    assert res["tokens"].tolist() == want

