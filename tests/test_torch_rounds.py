"""The port's experiment entry points (src/repro_torch/fl/rounds.py,
launch/train.py, obs/, checkpoint/) against the reference.

* ``_summarize`` fed the reference's ``run_montecarlo(presampled=True)``
  raw arrays equals the reference's summary: same keys, ints exact,
  floats rtol 1e-6.
* The reference's ``Scenario.rollout`` through the port's
  ``montecarlo_rounds`` and ``_summarize``, against the reference's
  summaries, every policy but ``random`` (its priorities come from
  another generator): integer leaves exact, times rtol 1e-4 (the fp32
  engines' tier, tests/test_torch_multicell.py), the auto budget rtol
  1e-6.
* ``shard=True`` over ``[cpu, cpu]`` equals the unsplit run bitwise, for
  every policy.
* ``FLServer(scenario=...)`` against the reference's, 3 tiny rounds:
  equal selections and handovers.
* ``compare_policies``, ``time_to_accuracy``, ``json_safe``, the run
  ledger, the checkpoint round trip, ``launch.train.main`` and
  ``bayes_optimal_accuracy``.
"""
import dataclasses
import json
import math
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import FLConfig as JFLConfig
from repro.configs import NOMAConfig as JNOMAConfig
from repro.configs import get_config as jget_config
from repro.data import TaskConfig as JTaskConfig
from repro.data import bayes_optimal_accuracy as jbayes
from repro.fl import FLServer as JFLServer
from repro.fl import rounds as jrounds
from repro.launch import train as jtrain
from repro.obs import json_safe as jjson_safe
from repro.sim import as_scenario as jas_scenario
from repro_torch import checkpoint as ckpt
from repro_torch.configs import FLConfig, NOMAConfig, get_config
from repro_torch.configs.base import POLICIES
from repro_torch.core import engine as E
from repro_torch.data import TaskConfig, bayes_optimal_accuracy
from repro_torch.fl import (FLServer, History, compare_policies,
                            compare_predictors, run_experiment,
                            run_montecarlo, time_to_accuracy)
from repro_torch.fl.rounds import MC_POLICIES, _summarize
from repro_torch.launch import train
from repro_torch.obs import RunLedger, json_safe
from repro_torch.obs import ledger as L

MC = dict(n_clients=16, n_seeds=4, rounds=4, model_bits=4e6, seed=3)
SCENARIO = "vehicular"


@pytest.fixture(autouse=True)
def no_ledger(monkeypatch):
    monkeypatch.setenv("REPRO_LEDGER", "0")


@pytest.fixture(scope="module", params=[1, 3], ids=["1cell", "3cells"])
def reference_mc(request):
    """The reference's presampled sweep and the rollout it replays."""
    c = request.param
    ncfg, fl = JNOMAConfig(n_subchannels=3), JFLConfig(n_cells=c)
    res = jrounds.run_montecarlo(ncfg, fl, policies=POLICIES,
                                 scenario=SCENARIO, presampled=True, **MC)
    envs = jas_scenario(SCENARIO, ncfg, fl).rollout(
        jax.random.PRNGKey(MC["seed"]), MC["rounds"],
        (MC["n_seeds"], MC["n_clients"]))
    return c, res, [np.array(a) for a in envs]


def assert_summaries_match(got, ref, *, rtol):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if v is None or isinstance(v, (int, list)):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=rtol), k


def test_mc_policies_cover_all_policies():
    assert MC_POLICIES == POLICIES == jrounds.MC_POLICIES


def test_summary_of_the_reference_arrays(reference_mc):
    _, res, _ = reference_mc
    for p in POLICIES:
        got = _summarize(res[p], MC["n_clients"], p,
                        res["summary"][p]["t_budget_s"])
        assert_summaries_match(got, res["summary"][p], rtol=1e-6)


def test_reference_rollout_through_the_port(reference_mc):
    c, res, (gains, n_samples, cpu_freq, cell) = reference_mc
    eng = E.WirelessEngine(NOMAConfig(n_subchannels=3), FLConfig(n_cells=c),
                           device="cpu")
    multicell = c > 1
    env0 = eng.schedule_batch(gains[0], n_samples[0], cpu_freq[0],
                              np.ones(gains.shape[1:]), MC["model_bits"],
                              priority=gains[0],
                              cell=cell[0] if multicell else None)
    auto = 2.0 * max(float(env0.t_round.mean()), 1e-6)
    ref_tb = res["summary"]["age_noma_budget"]["t_budget_s"]
    assert auto == pytest.approx(ref_tb, rel=1e-6)
    for p in POLICIES:
        if p == "random":
            continue
        tb = ref_tb if p == "age_noma_budget" else 0.0
        out = eng.montecarlo_rounds(gains, n_samples, cpu_freq,
                                    MC["model_bits"], policy=p, t_budget=tb,
                                    seed=MC["seed"],
                                    cell_seq=cell if multicell else None)
        out = {k: v.numpy() for k, v in out.items()}
        assert sorted(out) == sorted(res[p])
        for k in ("n_selected", "max_age", "participation", "final_ages",
                  "n_evicted", "aou_hist", "handovers"):
            if k in out:
                np.testing.assert_array_equal(out[k], res[p][k],
                                              err_msg=f"{p}/{k}")
        got = _summarize(out, MC["n_clients"], p, tb)
        assert_summaries_match(got, res["summary"][p], rtol=1e-4)


@pytest.mark.parametrize("presampled", [False, True])
@pytest.mark.parametrize("n_cells", [1, 3])
def test_shard_split_equals_unsplit(n_cells, presampled, monkeypatch):
    """Two CPU blocks of 2 x 32 clients (whole vector lanes, so the CPU's
    elementwise kernels round each element alike in both layouts)."""
    kw = dict(MC, n_clients=32, scenario=SCENARIO, presampled=presampled,
              device="cpu", policies=POLICIES)
    fl = FLConfig(n_cells=n_cells)
    ncfg = NOMAConfig(n_subchannels=3)
    whole = run_montecarlo(ncfg, fl, **kw)
    monkeypatch.setattr(E, "shard_devices",
                        lambda dev: [torch.device("cpu")] * 2)
    calls = []
    real = E.split_seeds

    def spy(run, s, devices, **k):
        calls.append((s, len(devices)))
        return real(run, s, devices, **k)

    monkeypatch.setattr(E, "split_seeds", spy)
    split = run_montecarlo(ncfg, fl, shard=True, **kw)
    assert calls == [(4, 2)] * len(POLICIES)
    for p in POLICIES:
        assert sorted(whole[p]) == sorted(split[p])
        for k in whole[p]:
            np.testing.assert_array_equal(whole[p][k], split[p][k],
                                          err_msg=f"{p}/{k}")


def test_launch_counts_survive_worker_threads():
    """The seed split's worker threads share the wrappers' launch counts:
    16 threads x 2,000 counts with a 1 us switch interval lose none."""
    from repro_torch.kernels import build

    def fn():
        pass

    fn.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [build.count_launch(fn) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fn.launches == 16 * 2000


def test_split_seeds_runs_once_when_the_seeds_do_not_divide():
    seen = []

    def run(dev, block):
        seen.append(block)
        return {"t_round": torch.zeros(2, 3)}

    E.split_seeds(run, 3, [torch.device("cpu")] * 2)
    assert seen == [None]


# ---------------------------------------------------------------------------
# FLServer under dynamic scenarios, against the reference
# ---------------------------------------------------------------------------

TINY_KW = dict(d_model=32, d_ff=64, vocab_size=32, n_layers=2)
TASK_KW = dict(vocab_size=32, n_topics=4, seq_len=17, seed=0)
FL_KW = dict(n_clients=16, rounds=3, local_epochs=1, local_batch=8, lr=0.2,
             samples_per_client=(24, 48), seed=2)


def recording(server):
    masks = []
    select = server.select

    def wrapped(env):
        sched = select(env)
        masks.append(np.asarray(sched.selected).copy())
        return sched

    server.select = wrapped
    return masks


@pytest.mark.parametrize("scenario,n_cells", [("vehicular", 1),
                                              ("vehicular", 3),
                                              ("iot_bursty", 1)])
def test_flserver_scenarios_match_the_reference(scenario, n_cells):
    ref = JFLServer(
        dataclasses.replace(jget_config("smollm_135m").reduced(), **TINY_KW),
        JFLConfig(**FL_KW, n_cells=n_cells), JNOMAConfig(n_subchannels=2),
        JTaskConfig(**TASK_KW), engine="jax", eval_every=1,
        scenario=scenario)
    port = FLServer(
        dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW),
        FLConfig(**FL_KW, n_cells=n_cells), NOMAConfig(n_subchannels=2),
        TaskConfig(**TASK_KW), eval_every=1, device="cpu",
        params=jax.tree.map(np.asarray, ref.params), scenario=scenario)
    ref_masks, port_masks = recording(ref), recording(port)
    ref_h, port_h = ref.run(3), port.run(3)
    for r, (a, b) in enumerate(zip(port_masks, ref_masks)):
        np.testing.assert_array_equal(a, b, err_msg=f"round {r}")
    assert port_h.n_selected == ref_h.n_selected
    assert port_h.handovers == ref_h.handovers
    assert port_h.sel_per_cell == ref_h.sel_per_cell
    np.testing.assert_allclose(port_h.round_time, ref_h.round_time,
                               rtol=1e-4)
    np.testing.assert_allclose(port_h.loss, ref_h.loss, rtol=1e-4)
    if n_cells > 1:
        assert len(port_h.handovers) == 3


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_compare_policies_and_time_to_accuracy():
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW)
    fl = FLConfig(**dict(FL_KW, n_clients=8))
    policies = ("age_noma", "channel", "round_robin")
    hists = compare_policies(cfg, fl, NOMAConfig(n_subchannels=2),
                             TaskConfig(**TASK_KW), policies=policies,
                             rounds=2, device="cpu")
    assert list(hists) == list(policies)
    one = run_experiment(cfg, fl, NOMAConfig(n_subchannels=2),
                         TaskConfig(**TASK_KW), "channel", rounds=2,
                         device="cpu")
    assert hists["channel"].n_selected == one.n_selected
    assert hists["channel"].round_time == one.round_time
    for h in hists.values():
        assert len(h.rounds) == 2 and all(map(math.isfinite, h.loss))
    hist = History(sim_time=[1.0, 2.5, 4.0], accuracy=[0.1, 0.3, 0.2])
    for target in (0.05, 0.2, 0.3, 0.9):
        assert time_to_accuracy(hist, target) == \
            jrounds.time_to_accuracy(hist, target)
    # compare_predictors runs every mode on one seed: the predictor never
    # draws from the server's rng, so the selections stay paired
    by_mode = compare_predictors(cfg, fl, NOMAConfig(n_subchannels=2),
                                 TaskConfig(**TASK_KW), rounds=3,
                                 device="cpu")
    assert list(by_mode) == ["none", "stale", "ann"]
    for m, h in by_mode.items():
        np.testing.assert_array_equal(h.participation,
                                      by_mode["none"].participation)
        assert h.round_time == by_mode["none"].round_time, m
        assert all(map(math.isfinite, h.loss)), m
    assert by_mode["none"].n_predicted == [0, 0, 0]
    assert by_mode["ann"].n_predicted[1:] == [4, 4]


def test_json_safe():
    v = {"t": torch.tensor([[1.0, float("nan")], [float("inf"), 2.0]]),
         "bf": torch.tensor([1.5, -0.25], dtype=torch.bfloat16),
         "i": torch.arange(3, dtype=torch.int32), "np": np.float32(0.5),
         "nested": [np.int64(3), {1: float("nan")}], "s": "x", "b": True}
    got = json_safe(v)
    assert got == jjson_safe({"t": np.array([[1.0, np.nan], [np.inf, 2.0]]),
                              "bf": np.array([1.5, -0.25]),
                              "i": np.arange(3), "np": np.float32(0.5),
                              "nested": [np.int64(3), {1: float("nan")}],
                              "s": "x", "b": True})
    json.dumps(got, allow_nan=False)
    hist = History(loss=[float("nan")], participation=np.ones(2))
    assert hist.as_dict()["loss"] == [None]
    assert hist.as_dict()["participation"] == [1.0, 1.0]


def test_run_ledger(tmp_path, monkeypatch):
    led = RunLedger.open("montecarlo", {"x": np.float32(1.0)},
                         root=str(tmp_path), enabled=True)
    led.event("policy_done", summary={"v": float("nan")})
    led.close()
    (run_dir,) = tmp_path.iterdir()
    assert run_dir.name.split("_")[1] == "montecarlo"
    manifest = json.loads((run_dir / "manifest.json").read_text())
    assert set(L.MANIFEST_KEYS) <= set(manifest)
    assert manifest["backend"] in ("cpu", "cuda")
    assert manifest["versions"]["torch"] == torch.__version__
    events = [json.loads(x) for x in
              (run_dir / "events.jsonl").read_text().splitlines()]
    assert [e["event"] for e in events] == ["run_start", "policy_done",
                                            "run_end"]
    assert all(set(L.EVENT_KEYS) <= set(e) for e in events)
    assert events[1]["summary"] == {"v": None}
    monkeypatch.setenv("REPRO_LEDGER", "0")
    off = RunLedger.open("fl_run", {})
    assert not off.enabled and off is RunLedger.open("x")
    off.event("round", r=0)
    off.close()


def test_entry_points_write_their_ledgers(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_LEDGER", "1")
    monkeypatch.setenv("REPRO_RUNS_DIR", str(tmp_path))
    run_montecarlo(NOMAConfig(n_subchannels=3), FLConfig(),
                   policies=("age_noma", "channel"), device="cpu", **MC)
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW)
    FLServer(cfg, FLConfig(**dict(FL_KW, n_clients=8)),
             NOMAConfig(n_subchannels=2), TaskConfig(**TASK_KW),
             device="cpu").run(2)
    runs = {p.name.split("_")[1]: p for p in tmp_path.iterdir()}
    assert set(runs) == {"montecarlo", "fl"}
    events = lambda p: [json.loads(x)["event"] for x in
                        (p / "events.jsonl").read_text().splitlines()]
    assert events(runs["montecarlo"]) == ["run_start", "policy_done",
                                          "policy_done", "run_end"]
    assert events(runs["fl"]) == ["run_start", "round", "round", "history",
                                  "run_end"]
    cfg_fl = json.loads((runs["fl"] / "manifest.json").read_text())["config"]
    assert cfg_fl["scenario"] == "static_iid" and cfg_fl["rounds"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tree = {"blocks.0.w": torch.randn(4, 3, generator=g).to(dtype),
            "embed": torch.randn(5, generator=g).to(dtype),
            "nested": {"b": [torch.randn(2, generator=g).to(dtype)]}}
    assert ckpt.latest_step(str(tmp_path)) is None
    path = ckpt.save(str(tmp_path), tree, step=7, extra={"arch": "x"})
    assert path.endswith("ckpt_7.npz") and ckpt.latest_step(
        str(tmp_path)) == 7
    like = {"blocks.0.w": torch.zeros(4, 3, dtype=dtype),
            "embed": torch.zeros(5, dtype=dtype),
            "nested": {"b": [torch.zeros(2, dtype=dtype)]}}
    back, manifest = ckpt.restore(str(tmp_path), like)
    assert manifest == {"step": 7, "file": "ckpt_7.npz",
                        "extra": {"arch": "x"}}
    for a, b in ((back["blocks.0.w"], tree["blocks.0.w"]),
                 (back["embed"], tree["embed"]),
                 (back["nested"]["b"][0], tree["nested"]["b"][0])):
        assert a.dtype == dtype and torch.equal(a, b)
    # the reference reads the same file
    jback, _ = jckpt.restore(str(tmp_path), {
        "blocks.0.w": jnp.zeros((4, 3)), "embed": jnp.zeros(5),
        "nested": {"b": [jnp.zeros(2)]}})
    np.testing.assert_array_equal(np.asarray(jback["embed"]),
                                  tree["embed"].float().numpy())


def test_train_main_matches_the_reference_cli(tmp_path, monkeypatch,
                                              capsys):
    """The reduced config, 2 rounds, the reference CLI's defaults
    (age_noma_budget, 30 clients): the same selections, evictions and
    participation."""
    argv = ["--rounds", "2", "--eval-every", "1"]
    out = train.main(argv + ["--device", "cpu", "--out",
                             str(tmp_path / "port"), "--ckpt-dir",
                             str(tmp_path / "ck")])
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--out", str(tmp_path / "ref")])
    jtrain.main()
    capsys.readouterr()
    tag = "smollm_135m__age_noma_budget__s0.json"
    port = json.loads((tmp_path / "port" / tag).read_text())
    ref = json.loads((tmp_path / "ref" / tag).read_text())
    for k in ("n_selected", "n_evicted", "participation", "max_age"):
        assert port["history"][k] == ref["history"][k], k
    np.testing.assert_allclose(port["history"]["round_time"],
                               ref["history"]["round_time"], rtol=1e-4)
    assert port["args"]["device"] == "cpu" and port["args"]["clients"] == 30
    srv = out["server"]
    back, manifest = ckpt.restore(str(tmp_path / "ck"),
                                  srv.model.state_dict())
    assert manifest["step"] == 2
    for k, v in srv.model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_bayes_optimal_accuracy_is_the_reference_value():
    for cfg in (dict(), dict(vocab_size=32, n_topics=4, seq_len=17)):
        assert bayes_optimal_accuracy(TaskConfig(**cfg), n_eval=512) == \
            jbayes(JTaskConfig(**cfg), n_eval=512)
