"""Port model (src/repro_torch/models) against the reference, in fp32 on
the CPU, from the reference's own initial parameters (convert.py).

Logits to atol 1e-5, token loss to rtol 1e-5, gradients to rtol 1e-4 /
atol 1e-6, and one SGD step's parameters to atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import zoo as jzoo
from repro.optim import SGD as JSGD
from repro.optim import apply_updates
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import zoo
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim.sgd import SGD

TINY_KW = dict(d_model=32, d_ff=64, vocab_size=32, n_layers=2)
CASES = ["tiny", "smollm_reduced"]
LR = 0.2


def configs(case):
    """(reference cfg, port cfg) pair."""
    jcfg = jget_config("smollm_135m").reduced()
    cfg = get_config("smollm_135m").reduced()
    if case == "tiny":
        jcfg = dataclasses.replace(jcfg, **TINY_KW)
        cfg = dataclasses.replace(cfg, **TINY_KW)
    return jcfg, cfg


def setup(case, seed=0):
    jcfg, cfg = configs(case)
    jparams, _ = jzoo.init_model(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = DecoderLM(cfg, torch.device("cpu"))
    model.load_state_dict(convert.params_from_numpy(tree, cfg, "cpu"))
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32)
    return jcfg, cfg, jparams, model, tokens


def jax_loss_fn(jcfg, tokens):
    batch = {"tokens": jnp.asarray(tokens[:, :-1]),
             "labels": jnp.asarray(tokens[:, 1:])}

    def loss_fn(p):
        logits, aux = jzoo.forward(jcfg, p, batch, remat=False)
        return jzoo.token_loss(jcfg, logits, batch["labels"], aux=aux)

    return loss_fn


def torch_loss(cfg, model, tokens):
    t = torch.as_tensor(tokens).long()
    logits, aux = zoo.forward(cfg, model, t[:, :-1])
    return logits, zoo.token_loss(cfg, logits, t[:, 1:], aux=aux)


@pytest.mark.parametrize("case", CASES)
def test_logits_and_loss(case):
    jcfg, cfg, jparams, model, tokens = setup(case)
    jlogits, _ = jzoo.forward(jcfg, jparams,
                              {"tokens": jnp.asarray(tokens[:, :-1])},
                              remat=False)
    jl = jzoo.token_loss(jcfg, jlogits, jnp.asarray(tokens[:, 1:]))
    with torch.no_grad():
        logits, loss = torch_loss(cfg, model, tokens)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_gradients(case):
    jcfg, cfg, jparams, model, tokens = setup(case, seed=1)
    jgrads = convert.flatten_tree(jax.tree.map(
        np.asarray, jax.grad(jax_loss_fn(jcfg, tokens))(jparams)))
    names = [n for n, _ in model.named_parameters()]
    _, loss = torch_loss(cfg, model, tokens)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert sorted(names) == sorted(jgrads)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_one_sgd_step(case):
    jcfg, cfg, jparams, model, tokens = setup(case, seed=2)
    opt = JSGD(lr=LR)
    jgrads = jax.grad(jax_loss_fn(jcfg, tokens))(jparams)
    upd, _ = opt.update(jgrads, opt.init(jparams), jparams)
    jnew = convert.flatten_tree(jax.tree.map(
        np.asarray, apply_updates(jparams, upd)))
    params = list(model.parameters())
    _, loss = torch_loss(cfg, model, tokens)
    SGD(lr=LR).step(params, torch.autograd.grad(loss, params), [])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jnew[name],
                                   atol=1e-6, rtol=0, err_msg=name)


def test_ignored_labels_and_weights():
    cfg = configs("tiny")[1]
    logits = torch.randn(2, 5, cfg.vocab_size,
                         generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([[1, 2, -1, -1, 3], [0, -1, 4, 5, 6]])
    lab = labels.clamp(min=0)
    nll = -torch.log_softmax(logits, -1).gather(-1, lab[..., None])[..., 0]
    mask = (labels >= 0).float()
    per_ex = (nll * mask).sum(-1) / mask.sum(-1)
    assert zoo.token_loss(cfg, logits, labels).item() == pytest.approx(
        per_ex.mean().item(), rel=1e-6)
    w = torch.tensor([1.0, 3.0])
    assert zoo.token_loss(cfg, logits, labels, weights=w).item() == \
        pytest.approx(((per_ex * w).sum() / w.sum()).item(), rel=1e-6)


def test_init_model_law_and_param_count():
    cfg = configs("smollm_reduced")[1]
    model = zoo.init_model(cfg, seed=0, device="cpu")
    again = zoo.init_model(cfg, seed=0, device="cpu")
    for (n, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n              # seeded: reproducible
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(jzoo.init_model(
            jax.random.PRNGKey(0), configs("smollm_reduced")[0])[0]))
    wq = model.blocks[0].attn.wq
    assert wq.abs().max() <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    assert torch.equal(model.blocks[0].ln1, torch.ones(cfg.d_model))


def test_full_width_smollm_shapes():
    """134,515,008 parameters at full width (built on the meta device)."""
    cfg = get_config("smollm_135m")
    model = DecoderLM(cfg, torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == 134_515_008
    assert model.embed.dtype == torch.bfloat16
    assert model.norm_f.dtype == torch.float32
