"""Driver of the Monte-Carlo cells: ``WirelessEngine.montecarlo_rounds``
of ``repro_torch`` over whole rollouts of a presampled environment.

Set-up draws the environment on the card from the seed in a few large
calls: each drop's client placements uniform in the cell's annulus, a
Rayleigh fading draw per round (so (R, S, N) gains), whole-number sample
counts and CPU speeds uniform in the configured ranges. A warm-up rollout
runs every shape. Each rollout in the window ends in a synchronise, so
the rate counts finished drops. After each rollout the results of a
sample of the drops, drawn from the seed, are copied into a store
allocated at the warm-up (the first ``kept_rollouts`` rollouts); after
the window the plain reference (``reference/noma.py``, float64) rolls out
the same drops from the same arrays and every kept result is compared
with it.
"""
from __future__ import annotations

import contextlib
import gc

from portbench.reference import noma as ref_noma

PER_DROP = ("final_ages", "participation")     # (S, N); the rest (R, S, ...)
EXACT = {"ages": ("final_ages",), "part": ("participation",),
         "hist": ("aou_hist", "n_selected", "max_age")}
RELATIVE = {"t_round": "t_round", "t_cmp_bn": "t_comp_bottleneck",
            "t_up_bn": "t_up_bottleneck"}


class Cell:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        import torch
        from repro_torch.configs.base import FLConfig, NOMAConfig
        from repro_torch.core.engine import WirelessEngine
        self.torch = torch
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.params = wl["params"]
        fl, noma = cfg["fl"], cfg["noma"]
        self.prm = ref_noma.params_of(noma, fl)
        self.engine = WirelessEngine(
            NOMAConfig(**noma),
            FLConfig(local_epochs=fl["local_epochs"],
                     cpu_cycles_per_sample=fl["cpu_cycles_per_sample"],
                     pairing=fl["pairing"], selection=fl["selection"],
                     admission=fl["admission"]),
            device=device)
        self.r = cfg["rounds"]
        self.s = cfg["seeds_per_batch"]
        self.n = cfg["n_clients"]
        self.bits = float(cfg["model_bits"])
        self.policy = fl["policy"]
        self.gains, self.n_samples, self.cpu = self._environment(cfg, seed)
        pick = torch.Generator().manual_seed(int(seed) % (2 ** 63))
        self.idx = torch.randperm(self.s, generator=pick)[
            :int(self.params["checked_drops"])].sort().values.to(device)
        self.store: dict = {}
        self.n_kept = 0
        self.tracer = None

    def _environment(self, cfg: dict, seed: int):
        """(R, S, N) gains, (S, N) sample counts and CPU speeds on the
        card, fp32, from one device generator."""
        torch = self.torch
        noma, fl = cfg["noma"], cfg["fl"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % (2 ** 63))
        shape = (self.s, self.n)
        f32 = dict(dtype=torch.float32, device=self.device)
        lo2, hi2 = noma["min_radius_m"] ** 2, noma["cell_radius_m"] ** 2
        dist = torch.rand(shape, generator=gen, **f32).mul_(hi2 - lo2) \
            .add_(lo2).sqrt_()
        path = dist.pow_(-noma["path_loss_exp"]).mul_(noma["ref_path_loss"])
        gains = torch.empty((self.r, *shape), **f32).exponential_(
            1.0, generator=gen).mul_(path)
        lo, hi = fl["samples_per_client"]
        n_samples = torch.randint(lo, hi + 1, shape, generator=gen,
                                  device=self.device).to(torch.float32)
        c_lo, c_hi = (g * 1e9 for g in fl["cpu_freq_range_ghz"])
        cpu = torch.rand(shape, generator=gen, **f32).mul_(c_hi - c_lo) \
            .add_(c_lo)
        return gains, n_samples, cpu

    def _rollout(self) -> dict:
        return self.engine.montecarlo_rounds(
            self.gains, self.n_samples, self.cpu, self.bits,
            policy=self.policy)

    def _keep(self, out: dict):
        """Copies the checked drops' results into the store allocated at
        the warm-up (the first ``kept_rollouts`` rollouts), so the window
        allocates nothing."""
        if not self.store:
            cap = int(self.params["kept_rollouts"])
            for k, v in out.items():
                shape = list(v.shape)
                shape[0 if k in PER_DROP else 1] = len(self.idx)
                self.store[k] = self.torch.empty((cap, *shape),
                                                 dtype=v.dtype,
                                                 device=v.device)
        if self.n_kept == len(next(iter(self.store.values()))):
            return
        for k, v in out.items():
            self.torch.index_select(v, 0 if k in PER_DROP else 1, self.idx,
                                    out=self.store[k][self.n_kept])
        self.n_kept += 1

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def warm_up(self):
        self._keep(self._rollout())
        self._sync()

    def unit(self) -> int:
        """One rollout of R rounds over S drops; returns R x S."""
        self._keep(self._rollout())
        self._sync()
        return self.r * self.s

    def end_to_end(self, units: int, work: int, seconds: float) -> dict:
        return {"mc_drops_per_s": work / seconds}

    @contextlib.contextmanager
    def trace_hooks(self, spans):
        from repro_torch.obs import trace
        with trace.tracing() as tr:
            self.tracer = tr
            yield

    def layer_context(self) -> dict:
        """The port's spans outside the profiled rollouts (the first
        ``profile_units`` x R of each name, where more remain), and the
        shapes the readers count bytes by."""
        skip = int(self.wl.get("profile_units", 1)) * self.r
        spans, seen = [], {}
        for s in [] if self.tracer is None else self.tracer.spans:
            seen[s.name] = seen.get(s.name, 0) + 1
            spans.append((s.name, s.duration_s, seen[s.name]))
        spans = [(n, d) for n, d, k in spans
                 if k > skip or seen[n] <= skip]
        return {"port_spans": spans, "rounds_per_unit": self.r,
                "pairscore_elements": self.s * (
                    min(self.prm["slots"], self.n) // 2)}

    def release(self):
        """Keeps the checked drops' inputs; frees the rest."""
        self.ref_inputs = (self.gains.index_select(1, self.idx),
                           self.n_samples.index_select(0, self.idx),
                           self.cpu.index_select(0, self.idx))
        self.gains = self.n_samples = self.cpu = self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def follow(self, control: bool = False) -> dict:
        dtype = self.torch.bfloat16 if control else self.torch.float64
        return ref_noma.rollout(*self.ref_inputs, self.bits, self.prm,
                                dtype)

    def compare(self, prog: list, ref: dict) -> dict:
        """The compared numbers of the kept results ``prog`` (or a control
        standing in for them) against the reference's; also counts the
        results with any mismatch in ``self.failed``."""
        torch = self.torch
        v = dict.fromkeys(list(EXACT) + list(RELATIVE), 0.0)
        self.failed = 0
        for out in prog:
            bad = 0.0
            for name, keys in EXACT.items():
                for k in keys:
                    miss = float((out[k].to(torch.float64)
                                  != ref[k].to(torch.float64)).sum())
                    v[name] += miss
                    bad += miss
            for name, k in RELATIVE.items():
                gap = ref_noma.rel_gap(out[k], ref[k])
                v[name] = max(v[name], gap)
                bad += gap > self.wl["limits"][name]
            self.failed += bad > 0
        return v

    def outputs(self) -> list:
        """The kept results of the checked drops, a dict a rollout."""
        return [{k: v[i] for k, v in self.store.items()}
                for i in range(self.n_kept)]

    def control(self) -> list:
        """The control standing in for the program."""
        return [self.follow(control=True)]

    def check(self) -> list:
        vals = self.compare(self.outputs(), self.follow())
        lim = self.wl["limits"]
        return [(k, vals[k], lim[k]) for k in lim]

    def failed_units(self) -> int:
        return int(self.failed)
