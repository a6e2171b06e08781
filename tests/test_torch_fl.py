"""Port FL round (src/repro_torch/fl) against the reference FLServer.

The port's ``FLServer(device="cpu", params=<the reference's init>)`` and
``repro.fl.FLServer(engine="jax")`` run 3 rounds on the TINY config of
tests/test_fl_system.py in fp32. Selections are identical every round;
round times and losses match to rtol 1e-4; final parameters to atol 1e-5.
The same holds under ``pairing="hungarian", selection="joint"``, with the
reference on ``kernel_backend="pallas_interpret"`` (the planner's bf16
table, as the port computes it).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig
from repro.configs import NOMAConfig as JNOMAConfig
from repro.configs import get_config as jget_config
from repro.data import TaskConfig as JTaskConfig
from repro.fl import FLServer as JFLServer
from repro_torch import convert
from repro_torch.configs import FLConfig, NOMAConfig, get_config
from repro_torch.data import TaskConfig
from repro_torch.fl import FLServer, run_experiment

TINY_KW = dict(d_model=32, d_ff=64, vocab_size=32, n_layers=2)
TASK_KW = dict(vocab_size=32, n_topics=4, seq_len=17, seed=0)
FL_KW = dict(n_clients=8, rounds=3, local_epochs=1, local_batch=8, lr=0.2,
             samples_per_client=(24, 48), seed=0)
ROUNDS = 3


def recording(server):
    """Record every round's selection mask on ``server``."""
    masks = []
    select = server.select

    def wrapped(env):
        sched = select(env)
        masks.append(np.asarray(sched.selected).copy())
        return sched

    server.select = wrapped
    return masks


@pytest.fixture(scope="module", params=["age_noma", "oma_age"])
def runs(request):
    policy = request.param
    ref = JFLServer(
        dataclasses.replace(jget_config("smollm_135m").reduced(), **TINY_KW),
        JFLConfig(**FL_KW), JNOMAConfig(n_subchannels=2),
        JTaskConfig(**TASK_KW), policy=policy, engine="jax", eval_every=1)
    tree = jax.tree.map(np.asarray, ref.params)
    port = FLServer(
        dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW),
        FLConfig(**FL_KW), NOMAConfig(n_subchannels=2),
        TaskConfig(**TASK_KW), policy=policy, eval_every=1, device="cpu",
        params=tree)
    ref_masks, port_masks = recording(ref), recording(port)
    return (ref, ref.run(ROUNDS), ref_masks), (port, port.run(ROUNDS),
                                               port_masks)


def test_selections_identical(runs):
    (_, ref_h, ref_masks), (_, port_h, port_masks) = runs
    assert len(port_masks) == len(ref_masks) == ROUNDS
    for r, (a, b) in enumerate(zip(port_masks, ref_masks)):
        np.testing.assert_array_equal(a, b, err_msg=f"round {r}")
    assert port_h.n_selected == ref_h.n_selected == [4] * ROUNDS
    np.testing.assert_array_equal(port_h.participation,
                                  ref_h.participation)
    assert port_h.max_age == ref_h.max_age
    assert port_h.aou_hist == ref_h.aou_hist


def test_round_times_and_losses(runs):
    (_, ref_h, _), (_, port_h, _) = runs
    np.testing.assert_allclose(port_h.round_time, ref_h.round_time,
                               rtol=1e-4)
    np.testing.assert_allclose(port_h.sim_time, ref_h.sim_time, rtol=1e-4)
    np.testing.assert_allclose(port_h.loss, ref_h.loss, rtol=1e-4)
    np.testing.assert_allclose(port_h.accuracy, ref_h.accuracy, atol=1e-6)
    np.testing.assert_allclose(
        np.add(port_h.t_comp_bottleneck, port_h.t_up_bottleneck),
        port_h.round_time, rtol=1e-6)


def test_final_parameters(runs):
    (ref, _, _), (port, _, _) = runs
    jflat = convert.flatten_tree(jax.tree.map(np.asarray, ref.params))
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[name],
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def hungarian_joint_runs():
    kw = dict(pairing="hungarian", selection="joint")
    ref = JFLServer(
        dataclasses.replace(jget_config("smollm_135m").reduced(), **TINY_KW),
        JFLConfig(**FL_KW, kernel_backend="pallas_interpret"),
        JNOMAConfig(n_subchannels=2), JTaskConfig(**TASK_KW),
        engine="jax", eval_every=1, **kw)
    port = FLServer(
        dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW),
        FLConfig(**FL_KW), NOMAConfig(n_subchannels=2),
        TaskConfig(**TASK_KW), eval_every=1, device="cpu",
        params=jax.tree.map(np.asarray, ref.params), **kw)
    ref_masks, port_masks = recording(ref), recording(port)
    return (ref.run(ROUNDS), ref_masks), (port.run(ROUNDS), port_masks)


def test_hungarian_joint_round(hungarian_joint_runs):
    """Selections identical every round; round times and losses to rtol
    1e-4; the engine path reports no joint swaps (the reference's engine
    has no ``joint_swaps_accepted`` leaf)."""
    (ref_h, ref_masks), (port_h, port_masks) = hungarian_joint_runs
    assert len(port_masks) == len(ref_masks) == ROUNDS
    for r, (a, b) in enumerate(zip(port_masks, ref_masks)):
        np.testing.assert_array_equal(a, b, err_msg=f"round {r}")
    assert port_h.n_selected == ref_h.n_selected == [4] * ROUNDS
    np.testing.assert_allclose(port_h.round_time, ref_h.round_time,
                               rtol=1e-4)
    np.testing.assert_allclose(port_h.loss, ref_h.loss, rtol=1e-4)
    assert port_h.joint_swaps == ref_h.joint_swaps == [0] * ROUNDS


def test_model_bits_count_every_parameter(runs):
    (ref, _, _), (port, _, _) = runs
    assert port.model_bits == ref.model_bits


def test_other_policies_and_driver():
    """random / channel / round_robin select the reference's sets too
    (first round, same seed), and run_experiment drives a server."""
    kw = dict(n_clients=8, local_batch=8, samples_per_client=(24, 48),
              seed=1)
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(),
                              **TINY_KW)
    for policy in ("random", "channel", "round_robin"):
        ref = JFLServer(
            dataclasses.replace(jget_config("smollm_135m").reduced(),
                                **TINY_KW),
            JFLConfig(**kw), JNOMAConfig(n_subchannels=2),
            JTaskConfig(**TASK_KW), policy=policy, engine="jax")
        port = FLServer(cfg, FLConfig(**kw), NOMAConfig(n_subchannels=2),
                        TaskConfig(**TASK_KW), policy=policy, device="cpu",
                        params=jax.tree.map(np.asarray, ref.params))
        for _ in range(2):
            env_r = ref.scenario.step(ref.rng)
            env_p = port.scenario.step(port.rng)
            np.testing.assert_array_equal(env_r[0], env_p[0])
            mk = lambda s, e, mod: mod.RoundEnv(
                gains=e[0], n_samples=e[1], cpu_freq=e[2], ages=s.ages,
                model_bits=s.model_bits)
            from repro.core import scheduler as jsched
            from repro_torch.core import plan
            a = ref.select(mk(ref, env_r, jsched))
            b = port.select(mk(port, env_p, plan))
            np.testing.assert_array_equal(a.selected, b.selected,
                                          err_msg=policy)
            ref.round_idx += 1
            port.round_idx += 1
    hist = run_experiment(cfg, FLConfig(**kw), NOMAConfig(n_subchannels=2),
                          TaskConfig(**TASK_KW), "age_noma", rounds=1,
                          device="cpu")
    assert hist.n_selected == [4] and np.isfinite(hist.loss[0])


@pytest.mark.parametrize("kw,exc", [
    (dict(predictor="annx"), ValueError),
    (dict(fl=FLConfig(scenario="nope")), ValueError),
])
def test_out_of_scope_raises(kw, exc):
    args = dict(fl=FLConfig(n_clients=4, samples_per_client=(8, 8)))
    args.update(kw)
    fl = args.pop("fl")
    with pytest.raises(exc):
        FLServer(dataclasses.replace(get_config("smollm_135m").reduced(),
                                     **TINY_KW), fl, NOMAConfig(),
                 TaskConfig(**TASK_KW), device="cpu", **args)


@pytest.mark.parametrize("in_config", [True, False])
def test_vehicular_scenario_runs(in_config):
    """A dynamic scenario, from the config or the ``scenario=`` override,
    runs a round."""
    fl = FLConfig(n_clients=4, samples_per_client=(8, 8),
                  scenario="vehicular" if in_config else "static_iid")
    srv = FLServer(dataclasses.replace(get_config("smollm_135m").reduced(),
                                       **TINY_KW), fl, NOMAConfig(),
                   TaskConfig(**TASK_KW), device="cpu",
                   scenario=None if in_config else "vehicular")
    assert srv.scenario_name == "vehicular"
    assert srv.scenario.prm.mobility == "drift"
    hist = srv.run(1)
    assert hist.n_selected == [4] and np.isfinite(hist.loss[0])


def test_delta_rows_and_one_weighted_sum(monkeypatch):
    """Aggregation reads the (C, P) delta buffer in one weighted sum."""
    from repro_torch.fl import aggregate
    calls = []
    real = aggregate.kops.weighted_sum

    def spy(rows, w):
        calls.append(tuple(rows.shape))
        return real(rows, w)

    monkeypatch.setattr(aggregate.kops, "weighted_sum", spy)
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW)
    srv = FLServer(cfg, FLConfig(**FL_KW), NOMAConfig(n_subchannels=2),
                   TaskConfig(**TASK_KW), device="cpu")
    srv.run_round()
    n_params = sum(p.numel() for p in srv.model.parameters())
    assert calls == [(4, n_params)]
    assert torch.isfinite(srv.deltas).all()
