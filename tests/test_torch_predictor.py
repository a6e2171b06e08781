"""Port update predictor (src/repro_torch/fl/predictor.py, optim/adamw.py,
optim/schedules.py, the flat-order map of convert.py) against the
reference's (src/repro/fl/predictor.py), on the CPU.

Inputs come from numpy seeds; the reference's MLP weights are carried
across with ``convert.predictor_from_numpy`` (its threefry init cannot be
drawn in torch). Tolerances:
  * the flat-order map and the schedules: exact;
  * the sketch per coordinate: rtol 1e-5, atol 1e-4 (fp32 sums of ~10^3
    unit-scale terms a bucket, in another order);
  * ``mlp_coeffs``: atol 1e-6; AdamW steps and the MLP after
    ``pred_steps`` steps: atol 1e-6; the first loss rtol 1e-5;
  * ``observe`` / ``predict``: pred_error and pred_loss rtol 1e-5,
    predicted rows (mapped back to ravel order) atol 1e-6;
  * ``FLServer(predictor=...)`` over 6 rounds, the FL tests' tiers: losses,
    pred_error and pred_loss rtol 1e-4, final parameters atol 1e-5,
    selections equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs import FLConfig as JFLConfig
from repro.configs import NOMAConfig as JNOMAConfig
from repro.configs import get_config as jget_config
from repro.data import TaskConfig as JTaskConfig
from repro.fl import FLServer as JFLServer
from repro.fl import aggregate_deltas as jaggregate
from repro.fl import blend_deltas as jblend
from repro.fl import predictor as JP
from repro.fl import rounds as jrounds
from repro.models import zoo as jzoo
from repro.optim import AdamW as JAdamW
from repro.optim import apply_updates as japply
from repro.optim import schedules as jschedules
from repro_torch import convert
from repro_torch.configs import FLConfig, NOMAConfig, get_config
from repro_torch.data import TaskConfig
from repro_torch.fl import (FLServer, UpdatePredictor, aggregate_deltas,
                            blend_deltas, compare_predictors)
from repro_torch.fl import predictor as P
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim import AdamW, schedules

TINY_KW = dict(d_model=32, d_ff=64, vocab_size=32, n_layers=2)
TASK_KW = dict(vocab_size=32, n_topics=4, seq_len=17, seed=0)
FL_KW = dict(n_clients=8, rounds=6, local_epochs=1, local_batch=8, lr=0.2,
             samples_per_client=(24, 48), seed=0)
ROUNDS = 6

# the reference tests' template: leaves "w" (5, 3) and "b" (7,), raveled
# as b then w; the port's module holds them in the order w, b
TEMPLATE = {"w": jnp.zeros((5, 3), jnp.float32),
            "b": jnp.zeros((7,), jnp.float32)}
PRED_KW = dict(pred_embed_dim=8, pred_hidden_dim=16)


class Template(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(5, 3))
        self.b = torch.nn.Parameter(torch.zeros(7))


def template_module():
    return Template()


def segments_of(module):
    return convert.ravel_segments(
        (n, p.shape) for n, p in module.named_parameters())


def predictors(mode, n_clients=6, **fl_kw):
    """(reference, port) predictors on the template, the port's MLP loaded
    with the reference's weights."""
    kw = dict(n_clients=n_clients, predictor=mode, **PRED_KW, **fl_kw)
    ref = JP.UpdatePredictor(TEMPLATE, JFLConfig(**kw), n_clients, seed=0)
    port = UpdatePredictor(template_module(), FLConfig(**kw), n_clients,
                           seed=0)
    port.net.load_state_dict(convert.predictor_from_numpy(
        jax.tree.map(np.asarray, ref.net)))
    return ref, port


# ---------------------------------------------------------------------------
# the flat-order map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm_135m", "hymba_1_5b", "rwkv6_7b",
                                  "stablelm_1_6b", "chatglm3_6b",
                                  "moonshot_v1_16b_a3b", "grok_1_314b",
                                  "llama4_maverick_400b_a17b"])
def test_flat_order_map_round_trips_a_raveled_tree(arch):
    """A reference tree of the arch's shapes holding distinct integers:
    its ravel, mapped to the port's order, is the port model's parameters
    concatenated by name, and back."""
    jcfg = jget_config(arch).reduced()
    shapes = jax.eval_shape(lambda k: jzoo.init_model(k, jcfg)[0],
                            jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(shapes)
    sizes = np.cumsum([0] + [x.size for x in leaves])
    tree = jax.tree.unflatten(treedef, [
        np.arange(a, b, dtype=np.int32).reshape(x.shape)
        for a, b, x in zip(sizes, sizes[1:], leaves)])
    flat_ref = np.asarray(ravel_pytree(tree)[0])
    model = DecoderLM(get_config(arch).reduced(), torch.device("meta"))
    by_name = convert.flatten_tree(tree)
    flat_port = np.concatenate([by_name[n].reshape(-1)
                                for n, _ in model.named_parameters()])
    segs = segments_of(model)
    assert sum(n for _, _, n in segs) == flat_ref.size
    np.testing.assert_array_equal(convert.to_port_order(flat_ref, segs),
                                  flat_port)
    np.testing.assert_array_equal(
        convert.to_ravel_order(torch.from_numpy(flat_port), segs).numpy(),
        flat_ref)


def test_flat_order_map_of_the_template():
    segs = segments_of(template_module())
    assert segs == [(0, 7, 15), (15, 0, 7)]


# ---------------------------------------------------------------------------
# sketch, MLP, AdamW, schedules
# ---------------------------------------------------------------------------


def test_sketch_matches_per_coordinate_after_the_permutation():
    cfg = dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW)
    model = DecoderLM(cfg, torch.device("cpu"))
    segs = segments_of(model)
    n = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    x_ref = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(JP.make_sketch(n, 32, seed=20_000)(jnp.asarray(x_ref)))
    sk = P.make_sketch(n, 32, 20_000, segs)
    got = sk(torch.from_numpy(convert.to_port_order(x_ref, segs)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    # linear, as the reference's
    y = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    x = torch.from_numpy(x_ref)
    torch.testing.assert_close(sk(2.0 * x + y), 2.0 * sk(x) + sk(y),
                               rtol=1e-4, atol=1e-4)


def test_mlp_coeffs_and_prior():
    net = JP.init_mlp(jax.random.PRNGKey(0), d_in=20, d_hidden=16)
    # a trained head, so the clip and both layers matter
    net["w3"] = jnp.asarray(np.random.default_rng(1).standard_normal(
        (16, 2)).astype(np.float32) * 2.0)
    mlp = P.MLP(20, 16, seed=0, device="cpu")
    prior = P.mlp_coeffs(mlp, torch.randn(5, 20))
    for c in prior:
        torch.testing.assert_close(c, torch.full((5,), 0.5), rtol=0,
                                   atol=1e-6)
    mlp.load_state_dict(convert.predictor_from_numpy(
        jax.tree.map(np.asarray, net)))
    x = np.random.default_rng(2).standard_normal((9, 20)).astype(np.float32)
    ra, rb = JP.mlp_coeffs(net, jnp.asarray(x))
    with torch.no_grad():
        a, b = P.mlp_coeffs(mlp, torch.from_numpy(x))
    assert max(float(a.abs().max()), float(b.abs().max())) == 2.0
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ra), atol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(rb), atol=1e-6)


@pytest.mark.parametrize("wd,lr_scale", [(0.0, 1.0), (0.1, 0.5)])
def test_adamw_matches_reference(wd, lr_scale):
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    ref_opt = JAdamW(lr=1e-2, weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = ref_opt.init(jp)
    names = sorted(params)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    opt = AdamW(lr=1e-2, weight_decay=wd)
    state = opt.init(tp)
    for _ in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = ref_opt.update(jax.tree.map(jnp.asarray, grads),
                                     jstate, jp, lr_scale=lr_scale)
        jp = japply(jp, upd)
        opt.step(tp, [torch.from_numpy(grads[k]) for k in names], state,
                 lr_scale=lr_scale)
    assert state["t"] == int(jstate["t"]) == 5
    for k, t in zip(names, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-6,
                                   err_msg=k)


def test_schedules_equal_reference():
    pairs = [(schedules.constant(), jschedules.constant()),
             (schedules.cosine(50, warmup=5), jschedules.cosine(50, warmup=5)),
             (schedules.cosine(50), jschedules.cosine(50)),
             (schedules.inverse_sqrt(10), jschedules.inverse_sqrt(10))]
    for mine, ref in pairs:
        assert [mine(s) for s in range(0, 80, 3)] == \
            [ref(s) for s in range(0, 80, 3)]


def test_train_on_first_loss_and_weights():
    """The reference test's learnable stream (true = 0.9 last + 0.1 mean):
    ``pred_steps`` AdamW steps, first loss and the MLP after them."""
    ref, port = predictors("ann")
    rng = np.random.default_rng(3)
    m, e = 16, port.embed_dim
    sl = rng.normal(size=(m, e)).astype(np.float32)
    sm = rng.normal(size=(m, e)).astype(np.float32)
    st = (0.9 * sl + 0.1 * sm).astype(np.float32)
    x = np.concatenate(
        [sl / np.linalg.norm(sl, axis=1, keepdims=True),
         sm / np.linalg.norm(sm, axis=1, keepdims=True),
         rng.normal(size=(m, 4))], axis=1).astype(np.float32)
    steps = FLConfig().pred_steps
    first_ref = ref.train_on(*map(jnp.asarray, (x, sl, sm, st)), steps=steps)
    first = port.train_on(*map(torch.from_numpy, (x, sl, sm, st)),
                          steps=steps)
    np.testing.assert_allclose(first, first_ref, rtol=1e-5)
    for k, v in port.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref.net[k]),
                                   atol=1e-6, err_msg=k)
    # and the loss goes down, as in the reference's test
    again = port.train_on(*map(torch.from_numpy, (x, sl, sm, st)))
    assert again < first


# ---------------------------------------------------------------------------
# observe / predict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["stale", "ann"])
def test_observe_and_predict_match_reference(mode):
    ref, port = predictors(mode)
    segs = segments_of(template_module())
    rng = np.random.default_rng(4)
    w = rng.uniform(0.5, 1.5, 6)
    w = w / w.sum()
    to_port = lambda f: torch.from_numpy(convert.to_port_order(f, segs))
    stream = [([0, 1, 2], np.array([1, 1, 1, 1, 1, 1])),
              ([1, 3], np.array([2, 1, 2, 1, 2, 2])),
              ([0, 1, 2, 4], np.array([1, 1, 3, 2, 3, 3])),
              ([2], np.array([2, 1, 1, 3, 1, 4]))]     # a lone arrival
    for r, (clients, ages) in enumerate(stream):
        flats = [rng.standard_normal(port.n_params).astype(np.float32)
                 for _ in clients]
        got = port.observe(clients, torch.stack([to_port(f) for f in flats]),
                           ages, w)
        want = ref.observe(clients, [jnp.asarray(f) for f in flats], ages, w)
        for key in ("pred_error", "pred_loss"):
            if np.isnan(want[key]):
                assert np.isnan(got[key]), (r, key)
            else:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=f"round {r} {key}")
        if r == 1:
            assert np.isfinite(got["pred_error"])
            if mode == "ann":
                assert np.isfinite(got["pred_loss"])
        np.testing.assert_array_equal(port.known(), ref.known())
        selected = np.zeros(6, bool)
        selected[clients] = True
        targets = port.predictable(selected, ages)
        np.testing.assert_array_equal(targets,
                                      ref.predictable(selected, ages))
        mean = rng.standard_normal(port.n_params).astype(np.float32)
        out = torch.full((len(targets), port.n_params), float("nan"))
        port.predict(targets, ages, w, to_port(mean), out=out)
        want_rows = ref.predict(targets, ages, w, jnp.asarray(mean))
        for row, want_row in zip(out, want_rows):
            np.testing.assert_allclose(
                convert.to_ravel_order(row, segs).numpy(),
                np.asarray(want_row), atol=1e-6, err_msg=f"round {r}")


def test_predictable_respects_history_and_age_cap():
    _, port = predictors("ann", pred_max_age=3)
    ages = np.array([1, 2, 5, 1, 1, 1])
    port.observe([1, 2], torch.randn(2, port.n_params), ages,
                 np.full(6, 1.0 / 6))
    selected = np.array([False, False, False, True, False, False])
    np.testing.assert_array_equal(port.predictable(selected, ages), [1])


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown predictor mode"):
        UpdatePredictor(template_module(), FLConfig(), 4, mode="annx")


def test_blend_reduces_to_aggregate_without_predictions():
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.normal(size=(3, 6)).astype(np.float32))
    w = np.array([1.0, 2.0, 3.0])
    a = aggregate_deltas(rows, w)
    assert torch.equal(a, blend_deltas(rows, w, np.zeros((0,))))
    # with predictions: the reference's blend over the same deltas
    pw = np.array([0.5, 0.25])
    more = torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32))
    ref = jblend([{"x": jnp.asarray(r)} for r in more[:3].numpy()], w,
                 [{"x": jnp.asarray(r)} for r in more[3:].numpy()], pw)
    np.testing.assert_allclose(blend_deltas(more, w, pw).numpy(),
                               np.asarray(ref["x"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(jaggregate([{"x": jnp.asarray(r)}
                                          for r in rows.numpy()], w)["x"]))


# ---------------------------------------------------------------------------
# the FL round with the predictor, against the reference
# ---------------------------------------------------------------------------


def recording(server):
    masks = []
    select = server.select

    def wrapped(env):
        sched = select(env)
        masks.append(np.asarray(sched.selected).copy())
        return sched

    server.select = wrapped
    return masks


@pytest.fixture(scope="module", params=["stale", "ann"])
def predictor_runs(request):
    mode = request.param
    ref = JFLServer(
        dataclasses.replace(jget_config("smollm_135m").reduced(), **TINY_KW),
        JFLConfig(**FL_KW), JNOMAConfig(n_subchannels=2),
        JTaskConfig(**TASK_KW), engine="jax", eval_every=1, predictor=mode)
    port = FLServer(
        dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW),
        FLConfig(**FL_KW), NOMAConfig(n_subchannels=2),
        TaskConfig(**TASK_KW), eval_every=1, device="cpu",
        params=jax.tree.map(np.asarray, ref.params), predictor=mode)
    if mode == "ann":
        port.predictor.net.load_state_dict(convert.predictor_from_numpy(
            jax.tree.map(np.asarray, ref.predictor.net)))
    ref_masks, port_masks = recording(ref), recording(port)
    return (mode, (ref, ref.run(ROUNDS), ref_masks),
            (port, port.run(ROUNDS), port_masks))


def test_predictor_round_selections_and_telemetry(predictor_runs):
    mode, (_, ref_h, ref_masks), (port, port_h, port_masks) = predictor_runs
    for r, (a, b) in enumerate(zip(port_masks, ref_masks)):
        np.testing.assert_array_equal(a, b, err_msg=f"round {r}")
    assert port_h.n_selected == ref_h.n_selected
    assert port_h.n_predicted == ref_h.n_predicted
    assert port_h.n_predicted[0] == 0 and max(port_h.n_predicted) > 0
    # the buffer holds a row for every client
    assert port.deltas.shape[0] == FL_KW["n_clients"]
    for key in ("pred_error", "pred_loss"):
        got, want = np.array(getattr(port_h, key)), \
            np.array(getattr(ref_h, key))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got[~np.isnan(got)],
                                   want[~np.isnan(want)], rtol=1e-4,
                                   err_msg=key)
    assert any(np.isfinite(port_h.pred_error))
    assert any(np.isfinite(port_h.pred_loss)) == (mode == "ann")


def test_predictor_round_losses_and_parameters(predictor_runs):
    _, (ref, ref_h, _), (port, port_h, _) = predictor_runs
    np.testing.assert_allclose(port_h.loss, ref_h.loss, rtol=1e-4)
    np.testing.assert_allclose(port_h.round_time, ref_h.round_time,
                               rtol=1e-4)
    jflat = convert.flatten_tree(jax.tree.map(np.asarray, ref.params))
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[name],
                                   atol=1e-5, rtol=0, err_msg=name)


def test_compare_predictors_pairs_selections_with_reference():
    """``compare_predictors`` in both packages, 6 rounds, one seed: every
    mode selects the reference's clients each round (the initial weights
    differ between packages, so the losses are held finite)."""
    kw = dict(rounds=ROUNDS, seed=0)
    ref = jrounds.compare_predictors(
        dataclasses.replace(jget_config("smollm_135m").reduced(), **TINY_KW),
        JFLConfig(**FL_KW), JNOMAConfig(n_subchannels=2),
        JTaskConfig(**TASK_KW), **kw)
    port = compare_predictors(
        dataclasses.replace(get_config("smollm_135m").reduced(), **TINY_KW),
        FLConfig(**FL_KW), NOMAConfig(n_subchannels=2),
        TaskConfig(**TASK_KW), device="cpu", **kw)
    assert list(port) == list(ref) == ["none", "stale", "ann"]
    for m in port:
        np.testing.assert_array_equal(port[m].participation,
                                      ref[m].participation, err_msg=m)
        np.testing.assert_array_equal(port[m].participation,
                                      port["none"].participation)
        assert port[m].n_predicted == ref[m].n_predicted, m
        np.testing.assert_allclose(port[m].round_time, ref[m].round_time,
                                   rtol=1e-4)
        assert all(np.isfinite(port[m].loss)), m
