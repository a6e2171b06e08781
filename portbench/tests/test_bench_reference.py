"""The plain reference at a tiny size on the CPU, held to the port's
outputs: the dense decoder's loss and gradients, SGD, FedAvg, the AoU
admission with strong/weak pairing and closed-form power, and the
Monte-Carlo rollout."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench.drivers import fl_round
from portbench.reference import model as ref_model
from portbench.reference import noma as ref_noma
from portbench.tests import tiny

CFG, _ = tiny.fl_cell()


def _port_model(dtype: str):
    from repro_torch.models.transformer import DecoderLM
    mcfg = dataclasses.replace(fl_round.model_config(CFG), dtype=dtype)
    model = DecoderLM(mcfg, "cpu")
    w = ref_model.make_weights(CFG, 5, "cpu", getattr(torch, dtype))
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return mcfg, model, w


def test_loss_and_grads_match_the_port_in_fp32():
    from repro_torch.models import zoo
    mcfg, model, w = _port_model("float32")
    tokens = torch.randint(0, 64, (4, 33), generator=torch.Generator()
                           .manual_seed(1))
    logits, aux = zoo.forward(mcfg, model, tokens[:, :-1], remat=False)
    loss = zoo.token_loss(mcfg, logits, tokens[:, 1:], aux=aux)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    with ref_model.fp32_matmuls():
        ref_loss, ref_grads = ref_model.loss_and_grads(
            CFG, {k: v.float() for k, v in w.items()}, tokens, block_rows=3)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    for n, g in zip(names, grads):
        r = ref_grads[n]
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()), n


def test_control_differs_from_the_reference():
    _, _, w = _port_model("float32")
    tokens = torch.randint(0, 64, (2, 17), generator=torch.Generator()
                           .manual_seed(2))
    wf = {k: v.float() for k, v in w.items()}
    ref, _ = ref_model.loss_and_grads(CFG, wf, tokens, block_rows=2)
    ctl, _ = ref_model.loss_and_grads(CFG, wf, tokens, block_rows=2,
                                      control=True)
    assert 1e-4 < abs(ctl - ref) / ref < 0.1


def test_sgd_and_fedavg_match_the_port():
    from repro_torch.fl.aggregate import aggregate_deltas, apply_aggregate
    from repro_torch.optim.sgd import SGD
    _, model, w = _port_model("bfloat16")
    names = [n for n, _ in model.named_parameters()]
    gen = torch.Generator().manual_seed(3)
    grads = {n: torch.randn(w[n].shape, generator=gen) * 0.3 for n in names}
    params = list(model.parameters())
    SGD(lr=0.05).step(params, [grads[n].to(p.dtype) for n, p in
                               zip(names, params)], [])
    ref = ref_model.sgd_step({k: v.float() for k, v in w.items()},
                             {n: grads[n].to(w[n].dtype).float()
                              for n in names}, 0.05, torch.bfloat16)
    for n, p in zip(names, params):
        assert torch.equal(p.float(), ref[n]), n

    deltas = [{n: torch.randn(w[n].shape, generator=gen) * 0.01
               for n in names} for _ in range(3)]
    sizes = [40, 17, 96]
    rows = torch.stack([torch.cat([d[n].reshape(-1) for n in names])
                        for d in deltas])
    before = {n: p.detach().float().clone()
              for n, p in zip(names, params)}
    apply_aggregate(model, aggregate_deltas(rows, np.array(sizes)))
    ref = ref_model.fedavg(before, deltas, sizes, torch.bfloat16)
    for n, p in zip(names, params):
        gap = (p.float() - ref[n]).abs()
        # the same sum in another order: at most one bf16 step apart
        assert float(gap.max()) <= float(ref[n].abs().max()) * 2 ** -7, n


def _env(b, n, seed):
    g = torch.Generator().manual_seed(seed)
    d = torch.sqrt(torch.rand((b, n), generator=g) * (500 ** 2 - 50 ** 2)
                   + 50 ** 2)
    gains = 1e-3 * d ** -3.76 * torch.empty((b, n)).exponential_(
        1.0, generator=g)
    sizes = torch.randint(200, 1201, (b, n), generator=g).float()
    cpu = torch.rand((b, n), generator=g) * 1.5e9 + 0.5e9
    ages = torch.randint(1, 6, (b, n), generator=g).float()
    return gains.float(), sizes, cpu.float(), ages


@pytest.mark.parametrize("k,j", [(2, 2), (5, 1), (8, 2)])
def test_schedule_matches_the_engine(k, j):
    """Admission, pairing and power; (5, 1) admits an odd count, so the
    weakest admitted is alone on a subchannel."""
    from repro_torch.configs.base import FLConfig, NOMAConfig
    from repro_torch.core.engine import WirelessEngine
    cfg, _ = tiny.mc_cell()
    noma = {**cfg["noma"], "n_subchannels": k, "users_per_subchannel": j}
    eng = WirelessEngine(NOMAConfig(**noma), FLConfig(), device="cpu")
    gains, sizes, cpu, ages = _env(16, 40, k)
    out = eng.schedule_batch(gains, sizes, cpu, ages, 1e6)
    ref = ref_noma.schedule(gains, sizes, cpu, ages, 1e6,
                            ref_noma.params_of(noma, cfg["fl"]))
    assert torch.equal(out.selected, ref["selected"])
    sel = ref["selected"]
    assert ref_noma.rel_gap(out.powers[sel], ref["powers"][sel]) < 1e-5
    assert ref_noma.rel_gap(out.rates[sel], ref["rates"][sel]) < 1e-5
    assert ref_noma.rel_gap(out.t_round, ref["t_round"]) < 1e-5


def test_rollout_matches_the_engine():
    from repro_torch.configs.base import FLConfig, NOMAConfig
    from repro_torch.core.engine import WirelessEngine
    cfg, _ = tiny.mc_cell()
    eng = WirelessEngine(NOMAConfig(**cfg["noma"]), FLConfig(),
                         device="cpu")
    gains = torch.stack([_env(12, 64, 9 + r)[0] for r in range(6)])
    _, sizes, cpu, _ = _env(12, 64, 8)
    out = eng.montecarlo_rounds(gains, sizes, cpu, 1e6)
    ref = ref_noma.rollout(gains, sizes, cpu, 1e6,
                           ref_noma.params_of(cfg["noma"], cfg["fl"]))
    for k in ("final_ages", "participation", "aou_hist", "n_selected",
              "max_age"):
        assert torch.equal(out[k].double(), ref[k].double()), k
    for k in ("t_round", "t_comp_bottleneck", "t_up_bottleneck"):
        assert ref_noma.rel_gap(out[k], ref[k]) < 1e-5, k
