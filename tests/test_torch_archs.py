"""The five decoder archs of the moe family and the head_dim-128 dense
decoders against the reference, reduced, in fp32 on the CPU, from the
reference's own initial parameters (convert.py): stablelm_1_6b,
chatglm3_6b, moonshot_v1_16b_a3b, grok_1_314b, llama4_maverick_400b_a17b;
and the registry of the ten archs (the vlm and encdec families are
tests/test_torch_vlm.py and tests/test_torch_encdec.py).

Tolerances:
- forward logits to atol 2e-5 and the summed aux loss to rtol 1e-5. The
  reference's 1/sqrt(E) expert init (its ``dense_init`` takes the expert
  count as the fan-in) gives the reduced MoE models logits of order 10,
  where fp32 rounding of two summation orders reaches ~6e-6;
- prefill logits and caches, decode logits: atol = rtol = 1e-4, as in
  tests/test_torch_serve.py; greedy tokens exactly;
- one step's gradients to rtol 1e-4 / atol 1e-6 and the SGD step's
  parameters to atol 1e-6, as in tests/test_torch_model.py;
- the MoE FL round: selections equal, round times and losses rtol 1e-4,
  final parameters atol 1e-5, as in tests/test_torch_fl.py.
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

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import FLConfig as JFLConfig
from repro.configs import NOMAConfig as JNOMAConfig
from repro.configs import get_config as jget_config
from repro.data import TaskConfig as JTaskConfig
from repro.fl import FLServer as JFLServer
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.configs import (ARCH_IDS, FLConfig, NOMAConfig,
                                 get_config)
from repro_torch.data import TaskConfig
from repro_torch.fl import FLServer
from repro_torch.kernels import swa
from repro_torch.launch import serve, train
from repro_torch.launch.serve import run_serve
from repro_torch.models import zoo
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM

ARCHS = ["stablelm_1_6b", "chatglm3_6b", "moonshot_v1_16b_a3b",
         "grok_1_314b", "llama4_maverick_400b_a17b"]
MOE = [a for a in ARCHS if get_config(a).is_moe]
TOL = dict(rtol=1e-4, atol=1e-4)


def build(arch, seed=0, **overrides):
    """(reference cfg, port cfg, reference params, port model) from one
    reference init, loaded with a strict ``load_state_dict``."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **overrides)
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    jparams, _ = jzoo.init_model(jax.random.PRNGKey(seed), jcfg)
    model = DecoderLM(cfg, torch.device("cpu"))
    model.load_state_dict(convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return jcfg, cfg, jparams, model


def prompt(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def assert_cache_close(cache, jcache):
    assert sorted(cache) == sorted(jcache)
    for name, val in cache.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(jcache[name]),
                                   err_msg=name, **TOL)


EIGHT = ["smollm_135m", "hymba_1_5b", "rwkv6_7b", *ARCHS]


def test_get_config_and_the_command_lines_take_the_eight_archs():
    """The eight archs of the earlier slices stay in ``ARCH_IDS``, equal to
    the reference's configs and taken by ``--arch``."""
    assert set(EIGHT) <= set(ARCH_IDS)
    for arch in EIGHT:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jget_config(arch))
        assert train.parse_args(["--arch", arch]).arch == arch


def test_get_config_and_the_command_lines_take_the_ten_archs():
    """``ARCH_IDS`` is the reference's ten; every config equals the
    reference's, ``--arch`` of both command lines takes each (the train CLI
    then refuses the vlm and encdec families, tests/test_torch_vlm.py), and
    an unknown arch is refused."""
    assert ARCH_IDS == list(JARCH_IDS)
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jget_config(arch))
        assert train.parse_args(["--arch", arch]).arch == arch
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("gemma_7b")
    with pytest.raises(SystemExit):
        train.parse_args(["--arch", "gemma_7b"])
    saved = sys.argv
    try:
        sys.argv = ["serve", "--arch", "gemma_7b"]
        with pytest.raises(SystemExit), \
                contextlib.redirect_stderr(io.StringIO()):
            serve.main()
    finally:
        sys.argv = saved


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux(arch):
    jcfg, cfg, jparams, model = build(arch)
    toks = prompt(cfg, 2, 24)
    jlogits, jaux = jzoo.forward(jcfg, jparams,
                                 {"tokens": jnp.asarray(toks)}, remat=False)
    with torch.no_grad():
        logits, aux = zoo.forward(cfg, model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=0)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert (float(jaux) > 0) == cfg.is_moe


@pytest.mark.parametrize("arch,s,window", [
    *[(a, 24, 0) for a in ARCHS],
    # a window shorter than the prompt: the band bites (the reference's
    # direct attention at S=24, its chunked flash attention at S=300)
    *[(a, 24, 7) for a in ARCHS],
    ("moonshot_v1_16b_a3b", 300, 256), ("chatglm3_6b", 300, 256)])
def test_prefill_logits_and_cache(arch, s, window):
    jcfg, cfg, jparams, model = build(arch, seed=1)
    toks = prompt(cfg, 2, s, seed=1)
    jlast, jcache = jax.jit(jzoo.make_prefill_step(jcfg, window=window))(
        jparams, {"tokens": jnp.asarray(toks)})
    last, cache = zoo.make_prefill_step(cfg, window=window)(
        model, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_from_an_empty_cache(arch):
    jcfg, cfg, jparams, model = build(arch, seed=2)
    b, steps = 2, 6
    toks = prompt(cfg, b, steps, seed=2)
    jstep = jax.jit(jzoo.make_serve_step(jcfg))
    step = zoo.make_serve_step(cfg)
    jcache = jzoo.init_cache(jcfg, b, steps)
    cache = zoo.init_cache(cfg, b, steps, device="cpu")
    for i in range(steps):
        jnxt, jlogits, jcache = jstep(jparams, jcache,
                                      jnp.asarray(toks[:, i]), i)
        nxt, logits, cache = step(model, cache,
                                  torch.from_numpy(toks[:, i]).long(), i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {i}", **TOL)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward(arch):
    """Teacher-forced logits equal step-by-step decode when no token drops
    (capacity_factor 8): the capacity is set by the tokens of each call,
    so with drops the two route differently (tests/test_arch_smoke.py)."""
    _, cfg, _, model = build(arch, seed=3, capacity_factor=8.0)
    b, s = 2, 16
    toks = torch.from_numpy(prompt(cfg, b, s, seed=3)).long()
    with torch.no_grad():
        full = model(toks)
    cache = zoo.init_cache(cfg, b, s, device="cpu")
    step = zoo.make_serve_step(cfg)
    outs = [step(model, cache, toks[:, i], i)[1] for i in range(s)]
    err = float((full - torch.stack(outs, 1)).abs().max())
    assert err <= 3e-4 * max(float(full.abs().max()), 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serve_tokens_equal_the_reference_serve(arch):
    """Greedy tokens of ``run_serve`` equal those the reference's
    ``launch/serve.py`` prints, from the same seed's weights."""
    b, s, gen, seed = 2, 20, 4, 3
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
    assert res["tokens"].tolist() == want


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_step(arch):
    """One step of the token loss (the aux loss in it) and its gradients,
    then SGD at lr 0.2."""
    lr = 0.2
    jcfg, cfg, jparams, model = build(arch, seed=4)
    toks = prompt(cfg, 3, 13, seed=4)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}

    def jloss(p):
        logits, aux = jzoo.forward(jcfg, p, batch, remat=False)
        return jzoo.token_loss(jcfg, logits, batch["labels"], aux=aux)

    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    t = torch.from_numpy(toks).long()
    logits, aux = zoo.forward(cfg, model, t[:, :-1])
    loss = zoo.token_loss(cfg, logits, t[:, 1:], aux=aux)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    jflat = convert.flatten_tree(jax.tree.map(np.asarray, jgrads))
    jnew = convert.flatten_tree(jax.tree.map(
        lambda p, g: np.asarray(p) - lr * np.asarray(g), jparams, jgrads))
    for (name, p), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose((p - lr * g).detach().numpy(),
                                   jnew[name], atol=1e-6, rtol=0,
                                   err_msg=name)


def test_init_model_draws_the_references_law():
    """Each tensor's spread matches the reference's init (moonshot at 64
    experts: wi and wg at 1/sqrt(E), the router at 1/sqrt(D), wo at
    1/sqrt(F)); the draws themselves differ by design."""
    cfg = dataclasses.replace(get_config("moonshot_v1_16b_a3b").reduced(),
                              n_experts=64, top_k=6, d_ff=96)
    jcfg = dataclasses.replace(jget_config("moonshot_v1_16b_a3b").reduced(),
                               n_experts=64, top_k=6, d_ff=96)
    jflat = convert.flatten_tree(jax.tree.map(
        np.asarray, jzoo.init_model(jax.random.PRNGKey(0), jcfg)[0]))
    model = zoo.init_model(cfg, seed=0, device="cpu")
    for name, p in model.named_parameters():
        want = float(np.std(jflat[name]))
        assert float(p.detach().std()) == pytest.approx(want, rel=0.05,
                                                        abs=1e-7), name


def qkv(b, s, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_swa_plain_head_dim_128(cap):
    """swa_plain at head_dim 128 (chatglm3's 32:2 grouping, cut to 4:2)
    against the reference's _direct_attention, with and without grok's
    softcap 30, at atol = rtol = 2e-5 (tests/test_torch_swa.py)."""
    jcfg = dataclasses.replace(jget_config("grok_1_314b").reduced(),
                               n_heads=4, n_kv_heads=2, head_dim=128,
                               logit_softcap=cap)
    q, k, v = qkv(2, 70, 4, 2, 128, seed=7)
    q *= 8.0                                   # scores past the cap
    want = jlayers._direct_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, causal=True,
        window=20, prefix_len=0)
    got = swa.swa_plain(*map(torch.from_numpy, (q, k, v)), window=20,
                        softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_swa_plain_head_dim_128_matches_pallas_interpret():
    q, k, v = qkv(1, 256, 4, 2, 128, seed=8)
    want = jops.swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    window=128, impl="interpret", bq=128, bk=64)
    got = swa.swa(*map(torch.from_numpy, (q, k, v)), window=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


TINY = dict(d_model=32, d_ff=64, vocab_size=32, n_layers=2)
TASK_KW = dict(vocab_size=32, n_topics=4, seq_len=17, seed=0)
FL_KW = dict(n_clients=8, rounds=2, local_epochs=1, local_batch=8, lr=0.2,
             samples_per_client=(24, 48), seed=0)


def test_moe_fl_round_matches_the_reference():
    """The reduced moonshot (4 experts, top 2) in the FL round: two rounds
    of the port's FLServer against the reference's, from its init."""
    arch = "moonshot_v1_16b_a3b"
    ref = JFLServer(dataclasses.replace(jget_config(arch).reduced(), **TINY),
                    JFLConfig(**FL_KW), JNOMAConfig(n_subchannels=2),
                    JTaskConfig(**TASK_KW), engine="jax", eval_every=1)
    port = FLServer(dataclasses.replace(get_config(arch).reduced(), **TINY),
                    FLConfig(**FL_KW), NOMAConfig(n_subchannels=2),
                    TaskConfig(**TASK_KW), eval_every=1, device="cpu",
                    params=jax.tree.map(np.asarray, ref.params))
    ref_h, port_h = ref.run(2), port.run(2)
    np.testing.assert_array_equal(port_h.participation, ref_h.participation)
    assert port_h.n_selected == ref_h.n_selected
    np.testing.assert_allclose(port_h.round_time, ref_h.round_time,
                               rtol=1e-4)
    np.testing.assert_allclose(port_h.loss, ref_h.loss, rtol=1e-4)
    jflat = convert.flatten_tree(jax.tree.map(np.asarray, ref.params))
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[name],
                                   atol=1e-5, rtol=0, err_msg=name)


def test_train_cli_trains_a_reduced_moe_arch(tmp_path):
    """``--arch moonshot_v1_16b_a3b`` without ``--full-size`` trains the
    reference CLI's reduced config: ``reduced()``, then d_model=64,
    d_ff=128, vocab_size=64."""
    rec = train.main(["--arch", "moonshot_v1_16b_a3b", "--rounds", "1",
                      "--clients", "6", "--device", "cpu", "--out",
                      str(tmp_path)])
    cfg = rec["server"].cfg
    assert cfg == dataclasses.replace(
        get_config("moonshot_v1_16b_a3b").reduced(), d_model=64, d_ff=128,
        vocab_size=64)
    assert cfg.is_moe and (cfg.n_experts, cfg.top_k) == (4, 2)
    assert np.isfinite(rec["history"]["loss"]).all()


@pytest.mark.parametrize("family,overrides,builds", [
    ("vlm", dict(n_prefix_tokens=8, prefix_dim=32), True),
    ("encdec", dict(n_enc_layers=2), False),
    ("dense", dict(rope_frac=0.0), True),                # NoPE
    ("dense", dict(n_prefix_tokens=8, prefix_dim=32), True),
    # sliding_window is read by no model code of the reference
    ("dense", dict(sliding_window=4096), True),
    ("moe", dict(n_experts=4, top_k=2), True)])
def test_decoder_builds_the_ported_families_only(family, overrides,
                                                 builds):
    """``DecoderLM`` builds every decoder family (vlm and NoPE since the
    vlm/encdec slice); the encdec family is ``models/encdec.py``, which
    ``zoo`` builds instead."""
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(),
                              family=family, **overrides)
    if builds:
        DecoderLM(cfg, torch.device("meta"))
    else:
        with pytest.raises(ValueError, match="models/encdec.py"):
            DecoderLM(cfg, torch.device("meta"))
        assert isinstance(zoo.build_model(cfg, torch.device("meta")),
                          EncDecLM)
