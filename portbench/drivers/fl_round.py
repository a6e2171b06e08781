"""Driver of the FL-round cells: ``FLServer.run_round`` of ``repro_torch``
over whole rounds, on a dense decoder at published width.

Set-up builds one server from the configuration (clients, corpora and the
static-iid wireless stream from the seed), loads the benchmark's own
seeded weights into its model, and runs the first ``check_rounds`` rounds
through ``run_round`` with recorders around the trainer's calls: the
environment and schedule of each round, each client's batches, each local
step's loss and the per-leaf norms of each gradient the optimizer gets,
and the global weights and ages after each round. The same server then
runs the window. After the window the plain reference
(``reference/``) follows those rounds from the same weights and inputs,
worked out again from the seed, and the two are compared.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import statistics

import numpy as np

from portbench import formulas
from portbench.reference import fl_inputs
from portbench.reference import model as ref_model
from portbench.reference import noma as ref_noma


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a Llama-style configuration file."""
    from repro_torch.configs.base import ModelConfig
    if cfg["hidden_act"] != "silu" or not cfg["tie_word_embeddings"]:
        raise ValueError("the FL driver runs tied-embedding SiLU-GLU "
                         "decoders")
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=True, glu=True, dtype=cfg["torch_dtype"])


@dataclasses.dataclass
class RoundRecord:
    """What one followed round produced (the program's, or a reference's
    standing in for it)."""
    gains: np.ndarray = None
    selected: np.ndarray = None
    powers: np.ndarray = None
    rates: np.ndarray = None
    t_round: float = 0.0
    batches: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)
    grad_norms: list = dataclasses.field(default_factory=list)
    first_step: list = dataclasses.field(default_factory=list)
    weights: dict = None
    ages: np.ndarray = None


class _GradRecorder:
    """Stands in for the trainer's optimizer: records the per-leaf norms of
    the gradients it is handed, then steps the real one."""

    def __init__(self, opt, sink: list):
        self.opt, self.sink = opt, sink

    def init(self, params):
        return self.opt.init(params)

    def step(self, params, grads, state):
        import torch
        self.sink.append(torch.stack([g.float().norm() for g in grads]))
        return self.opt.step(params, grads, state)


class Cell:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        import torch
        from repro_torch.configs.base import FLConfig, NOMAConfig
        from repro_torch.data import TaskConfig
        from repro_torch.fl.server import FLServer
        self.torch = torch
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        dep = cfg["deployment"]
        self.fl, self.noma = dep["fl"], dep["noma"]
        self.params = wl["params"]
        self.task = {**dep["task"], "seq_len": self.params["seq_len"],
                     "seed": seed}
        self.mcfg = model_config(cfg)
        self.param_dtype = getattr(torch, cfg["torch_dtype"])
        fl = self.fl
        flc = FLConfig(
            n_clients=fl["n_clients"], local_epochs=fl["local_epochs"],
            local_batch=fl["local_batch"], lr=fl["lr"],
            momentum=fl["momentum"], dirichlet_alpha=fl["dirichlet_alpha"],
            samples_per_client=tuple(fl["samples_per_client"]),
            policy=fl["policy"], pairing=fl["pairing"],
            selection=fl["selection"], admission=fl["admission"],
            scenario=fl["scenario"],
            cpu_cycles_per_sample=fl["cpu_cycles_per_sample"],
            cpu_freq_range_ghz=tuple(fl["cpu_freq_range_ghz"]),
            model_bits=fl["model_bits"], predictor=fl["predictor"],
            seed=seed)
        self.server = FLServer(
            self.mcfg, flc, NOMAConfig(**self.noma),
            TaskConfig(**{k: self.task[k] for k in (
                "vocab_size", "n_topics", "seq_len", "concentration",
                "seed")}),
            policy=fl["policy"], seed=seed, device=device)
        self.w0 = ref_model.make_weights(cfg, seed, device, self.param_dtype)
        names = [n for n, _ in self.server.model.named_parameters()]
        if set(names) != set(self.w0):
            raise ValueError("the program's leaves are not the reference's: "
                             f"{sorted(set(names) ^ set(self.w0))[:6]}")
        self.names = names
        with torch.no_grad():
            for n, p in self.server.model.named_parameters():
                p.copy_(self.w0[n])
        self.n_params = sum(p.numel() for p in self.server.model.parameters())
        self.sizes = self.server.n_samples.astype(np.int64)
        self.records: list = []

    # -- set-up ------------------------------------------------------------

    def warm_up(self):
        for _ in range(int(self.params["check_rounds"])):
            self.records.append(self._recorded_round())

    def _recorded_round(self) -> RoundRecord:
        torch = self.torch
        srv, tr = self.server, self.server.trainer
        rec = RoundRecord()
        losses, norms = [], []
        select, local_update, step = srv.select, tr.local_update, tr.step

        def select_rec(env):
            rec.gains = np.array(env.gains, dtype=np.float64)
            return select(env)

        def local_rec(model, batches, delta_out):
            batches = list(batches)
            rec.batches.append(batches)
            rec.first_step.append(len(losses))
            return local_update(model, batches, delta_out)

        def step_rec(params, state, tokens):
            loss = step(params, state, tokens)
            losses.append(loss)
            return loss

        srv.select, tr.local_update, tr.step = select_rec, local_rec, step_rec
        opt, tr.opt = tr.opt, _GradRecorder(tr.opt, norms)
        try:
            sched = srv.run_round()
        finally:
            del srv.select, tr.local_update, tr.step
            tr.opt = opt
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        rec.selected = np.asarray(sched.selected, bool)
        rec.powers = np.asarray(sched.powers, np.float64)
        rec.rates = np.asarray(sched.rates, np.float64)
        rec.t_round = float(sched.t_round)
        rec.losses = [float(x) for x in losses]
        rec.grad_norms = [dict(zip(self.names, n.tolist())) for n in norms]
        rec.weights = {n: p.detach().clone()
                       for n, p in srv.model.named_parameters()}
        rec.ages = np.array(srv.ages)
        return rec

    # -- the window --------------------------------------------------------

    def _steps(self, selected) -> int:
        b = self.fl["local_batch"]
        return int(sum(self.sizes[i] // b for i in np.flatnonzero(selected))
                   * self.fl["local_epochs"])

    def unit(self) -> int:
        """One FL round; returns its local SGD steps."""
        return self._steps(self.server.run_round().selected)

    def tokens_per_step(self) -> int:
        return self.fl["local_batch"] * self.params["seq_len"]

    def end_to_end(self, units: int, work: int, seconds: float) -> dict:
        return {"fl_train_tokens_per_s": work * self.tokens_per_step()
                / seconds}

    @contextlib.contextmanager
    def trace_hooks(self, spans):
        with spans.wrap(self.server.trainer, "local_update", "local_update"):
            yield

    def layer_context(self) -> dict:
        s = self.params["seq_len"] - 1       # positions a row trains on
        slots = self.noma["n_subchannels"] * self.noma["users_per_subchannel"]
        return {"n_params": self.n_params,
                "fedagg_rows": min(slots, self.fl["n_clients"]),
                "flops_per_step": formulas.train_flops_per_token(self.cfg, s)
                * s * self.fl["local_batch"]}

    def release(self):
        self.server = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the reference -----------------------------------------------------

    def follow(self, control: bool = False) -> list:
        """The reference (``control``: the control) through the checked
        rounds from the benchmark's weights and the seed's inputs."""
        torch = self.torch
        fl, dev = self.fl, self.device
        n = fl["n_clients"]
        corpora = fl_inputs.client_corpora(
            n, fl["dirichlet_alpha"], tuple(fl["samples_per_client"]),
            self.seed, self.task)
        sizes = np.array([c.shape[0] for c in corpora])
        ghz = fl["cpu_freq_range_ghz"]
        stream = fl_inputs.Stream(self.seed + 10_000, n, self.noma,
                                  (ghz[0] * 1e9, ghz[1] * 1e9))
        prm = ref_noma.params_of(self.noma, fl)
        bits = fl["model_bits"] or float(self.n_params) * 32.0
        sched_dtype = torch.bfloat16 if control else torch.float64
        w = {k: v.float() for k, v in self.w0.items()}
        ages = np.ones(n)
        out = []
        with ref_model.fp32_matmuls():
            for _ in self.records:
                rec = RoundRecord(gains=stream.gains())
                host = lambda a: torch.as_tensor(np.asarray(a)[None])
                s = ref_noma.schedule(
                    host(rec.gains.astype(np.float32)), host(sizes),
                    host(stream.cpu_freq), host(ages), bits, prm,
                    sched_dtype)
                rec.selected = s["selected"][0].numpy()
                rec.powers = s["powers"][0].double().numpy()
                rec.rates = s["rates"][0].double().numpy()
                rec.t_round = float(s["t_round"][0])
                deltas = []
                for ci in np.flatnonzero(rec.selected):
                    batches = stream.batches(corpora[ci], fl["local_batch"],
                                             fl["local_epochs"])
                    rec.batches.append(batches)
                    rec.first_step.append(len(rec.losses))
                    wc = dict(w)
                    for tok in batches:
                        loss, grads = ref_model.loss_and_grads(
                            self.cfg, wc, torch.as_tensor(tok, device=dev)
                            .long(), block_rows=self.params["ref_block_rows"],
                            control=control)
                        rec.losses.append(loss)
                        rec.grad_norms.append(
                            {k: float(g.norm()) for k, g in grads.items()})
                        wc = ref_model.sgd_step(wc, grads, fl["lr"],
                                                self.param_dtype)
                        del grads
                    deltas.append({k: wc[k] - w[k] for k in w})
                w = ref_model.fedavg(w, deltas, sizes[rec.selected],
                                     self.param_dtype)
                del deltas
                ages = np.where(rec.selected, 1, ages + 1)
                rec.ages, rec.weights = ages.copy(), w
                out.append(rec)
        return out

    def compare(self, prog: list, ref: list) -> dict:
        """The compared numbers of ``prog`` (the program's records, or a
        control's) against the reference's, with the leaves that set the
        gradient's and the change's."""
        torch = self.torch
        v = dict.fromkeys(("inputs", "selection", "ages", "t_round",
                           "power", "rate", "loss", "grad", "change"), 0.0)
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone: left out of the change (a thousandth of the
        # median leaf's first-gradient norm)
        g0 = ref[0].grad_norms[0]
        med0 = statistics.median(g0.values())
        moved = [k for k, g in g0.items() if g >= 1e-3 * med0]
        for p, r in zip(prog, ref):
            v["inputs"] += float(np.sum(p.gains != r.gains))
            for bp, br in zip(p.batches, r.batches):
                v["inputs"] += sum(float(np.sum(x != y)) if x.shape == y.shape
                                   else float(y.size) for x, y in zip(bp, br))
                v["inputs"] += abs(len(bp) - len(br))
            v["selection"] += float(np.sum(p.selected != r.selected))
            v["ages"] += float(np.sum(p.ages != r.ages))
            sel = r.selected
            v["t_round"] = max(v["t_round"],
                               ref_noma.rel_gap(p.t_round, r.t_round))
            v["power"] = max(v["power"], ref_noma.rel_gap(p.powers[sel],
                                                          r.powers[sel]))
            v["rate"] = max(v["rate"], ref_noma.rel_gap(p.rates[sel],
                                                        r.rates[sel]))
            if len(p.losses) != len(r.losses):     # steps missing or extra
                v["loss"] = max(v["loss"], 1.0)
            for lp, lr in zip(p.losses, r.losses):
                v["loss"] = max(v["loss"], abs(lp - lr) / abs(lr))
            change_p, change_r = {}, {}
            for k in moved:
                w0 = self.w0[k].float()
                change_p[k] = float((p.weights[k].float() - w0).norm())
                change_r[k] = float((r.weights[k].float() - w0).norm())
            gap, leaf = _worst_leaf(change_p, change_r)
            if gap >= v["change"]:
                v["change"], v["change_leaf"] = gap, leaf
        # the first gradient each client of the first round computed
        for ip, ir in zip(prog[0].first_step, ref[0].first_step):
            gap, leaf = _worst_leaf(prog[0].grad_norms[ip],
                                    ref[0].grad_norms[ir])
            if gap >= v["grad"]:
                v["grad"], v["grad_leaf"] = gap, leaf
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return v

    def outputs(self) -> list:
        """What the program produced in the checked rounds."""
        return self.records

    def control(self) -> list:
        """The control standing in for the program."""
        return self.follow(control=True)

    def check(self) -> list:
        vals = self.compare(self.outputs(), self.follow())
        lim = self.wl["limits"]
        return [(k, vals[k], lim[k]) for k in lim]


def _worst_leaf(prog: dict, ref: dict) -> tuple[float, str]:
    """Largest gap between the program's and the reference's norm of a
    leaf, over the larger of the reference's norm of that leaf and of the
    median leaf; and that leaf's name."""
    med = statistics.median(ref.values())
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k)
               for k in ref)
