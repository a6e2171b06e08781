"""Roofline terms on NVIDIA H100s: one kernel's placement, and the dry
run's per-device record.

Counterpart of ``src/repro/launch/roofline.py``, with the H100's roofs in
place of the TPU's. The peaks are NVIDIA's data sheet figures for the SXM
part at its 700 W limit (``NVIDIA H100 80GB HBM3, 700 W``; dense rates,
no sparsity); the link term is NVLink 4's 900 GB/s a GPU, halved for one
direction. ``chip_smoke.py`` takes its bounds from here, so the
repository has one source of them.

The reference fills its record from XLA's analysis of the compiled GSPMD
program. PyTorch has no such analysis, so launch/dryrun.py fills the same
fields from these stand-ins, all per device:

=======================================  =================================
Reference (``compiled``)                  Port stand-in
=======================================  =================================
``memory_analysis()`` argument, output,  exact bytes: each parameter, batch
alias size                               input and cache tensor divided by
                                         the mesh sizes of its resolved
                                         axes; output = parameters + the
                                         two metrics (train) or logits +
                                         cache; alias = the donated
                                         parameters (train) or cache
                                         (decode)
``temp_size_in_bytes``                   the peak of live fake-tensor bytes
                                         of the traced step (``OpBytesMode``
                                         follows the storages; cycles
                                         collected every 100 ops) less its
                                         parameters, every tensor of a
                                         parameter's shape (gradients,
                                         accumulators) counted at the
                                         parameter's per-device size
``cost_analysis()["flops"]``             ``FlopCounterMode`` over the
                                         traced per-device step, the FLOPs
                                         of each module whose weights shard
                                         on the model axis divided by its
                                         size
``cost_analysis()["bytes accessed"]``    ``OpBytesMode``: each op's input
                                         and output bytes (the same
                                         op-level upper bound), divided as
                                         the FLOPs are
``collective_stats(hlo)``                ``collective_terms``: a model of
                                         the collectives the resolved
                                         placements imply, priced by the
                                         ring formulas of ``_wire_bytes``
=======================================  =================================

These are a model of the placements, not an analysis of a compiled
program: a record compares with the reference's ``experiments/dryrun``
JSON in kind only. The port loops over layers in Python, so there is no
scan to correct: ``scan_trips`` is 1 and ``scan_factor`` 1.0.

The collective model, term by term (``collective_terms``), each priced by
``_wire_bytes`` at its group size and counted ``times`` a step:

  fsdp_all_gather     parameters sharded over the batch axes (FSDP): an
                      all-gather in the forward and another in the remat
                      backward, each microbatch (once a prefill or decode)
  fsdp_reduce_scatter their gradients: a reduce-scatter each microbatch
  grad_all_reduce     parameters replicated over the batch axes: an
                      all-reduce of their gradients (in the accumulation
                      dtype) each step
  row_parallel        each product whose contracting dim is on the model
                      axis: an all-reduce of its (tokens, out) output, in
                      the forward, the recompute and the backward
  lse_all_reduce      the vocab-sharded log-sum-exp of the loss: an
                      all-reduce of the (tokens,) max and of the sum
  moe_all_to_all      experts on the model axis: an all-to-all of the
                      (E, capacity, D) buffer for dispatch and one for
                      combine, each pass
  kvseq_all_reduce    a decode cache sharded on its sequence: an
                      all-reduce of the partial softmax (output, max, sum)
                      a layer
  ring_permute        ring attention: each of the n_ring - 1 hops a
                      layer permutes K and V over the sequence axis (what
                      ``CommDebugMode`` counts)
  ring_logits         the ring prefill's last logits: an all-gather of
                      each sequence rank's last position
  ring_moe_counts     the ring's MoE queue places: an all-gather of every
                      rank's (rows, k, E) int64 counts an MoE layer
  act_all_gather      ``act_model_shard``: the residual sharded over the
                      model axis between layers, an all-gather a layer and
                      pass
"""
from __future__ import annotations

import dataclasses
import gc
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.module_tracker import ModuleTracker

from repro_torch.models.zoo import spec_axes

PEAK_BYTES_S = 3.35e12   # HBM3
PEAK_FP32_S = 67e12      # outside the tensor cores
PEAK_BF16_S = 989e12     # dense tensor-core rate
PEAK_TF32_S = 495e12     # dense tensor-core rate
LINK_BYTES_S = 450e9     # NVLink 4: 900 GB/s a GPU, one direction

# XLA's element type names (the reference's HLO text) and torch dtypes
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}


def _shape_bytes(dtype, dims) -> int:
    """Bytes of a tensor: ``dtype`` an XLA name or a ``torch.dtype``,
    ``dims`` a comma-separated string (as HLO prints it) or a sequence."""
    if isinstance(dims, str):
        dims = [int(d) for d in dims.split(",") if d]
    n = math.prod(dims)
    if isinstance(dtype, torch.dtype):
        return n * dtype.itemsize
    return n * _DTYPE_BYTES.get(dtype, 4)


def _wire_bytes(kind: str, nbytes: int, g: int) -> float:
    """Bytes a device sends for one ring collective over a group of ``g``
    on a tensor of ``nbytes`` (the full, gathered size)."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * nbytes * frac
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * frac
    return float(nbytes)                   # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float
    by_kind: dict
    count: int


@dataclasses.dataclass
class CollectiveTerm:
    """One term of the collective model: ``times`` collectives of ``kind``
    a step, each over a group of ``group`` on a tensor of ``nbytes``."""
    name: str
    kind: str
    nbytes: int
    group: int
    times: int

    @property
    def wire_bytes(self) -> float:
        return _wire_bytes(self.kind, self.nbytes, self.group) * self.times


def collective_stats(terms) -> CollectiveStats:
    """The reference's ``CollectiveStats`` of a list of terms."""
    by_kind: dict = {}
    for t in terms:
        by_kind[t.kind] = by_kind.get(t.kind, 0.0) + t.wire_bytes
    return CollectiveStats(wire_bytes=sum(t.wire_bytes for t in terms),
                           by_kind=by_kind,
                           count=sum(t.times for t in terms))


def _model_shards(spec, minfo) -> int:
    on_model = any("model" in spec_axes(e) for e in spec)
    return minfo.model_size if on_model else 1


def _batch_group(spec, minfo) -> int:
    return math.prod(minfo.axis_sizes[a] for e in spec for a in spec_axes(e)
                     if a != "model")


def _row_parallel(spec) -> bool:
    """A weight whose contracting dim (the first of a matrix, the second
    of an (E, in, out) expert stack) is on the model axis."""
    i = 1 if len(spec) == 3 else 0
    return len(spec) >= 2 and "model" in spec_axes(spec[i]) \
        and "model" not in spec_axes(spec[-1])


def collective_terms(cfg, kind: str, minfo, params: dict, specs: dict, *,
                     tokens: int, micro: int = 1, accum_dtype=torch.float32,
                     enc_tokens: int = 0, moe_tokens: int = 0,
                     cache_specs: dict | None = None, batch: int = 0,
                     ring_hops: int = 0, ring_kv_bytes: int = 0,
                     act_model_shard: bool = False) -> list:
    """The collective model of one step on one device (see the module
    docstring). ``params``: name -> ``ShapeDtype`` of the whole model;
    ``specs``: their resolved specs; ``tokens``: the decoder's tokens a
    device and microbatch (prefix included), ``enc_tokens`` the encoder's;
    ``moe_tokens`` the tokens an MoE layer routes; ``batch`` the decode
    rows (or the ring's batch shard) a device; ``ring_hops`` and
    ``ring_kv_bytes`` the ring's size (n_ring) and its K (or V) shard's
    bytes."""
    from repro_torch.models.moe import moe_capacity
    act_dtype = getattr(torch, cfg.dtype)
    train = kind == "train"
    passes = 3 * micro if train else 1      # forward, recompute, backward
    d = cfg.d_model
    terms = []

    def add(name, kind_, nbytes, group, times):
        if group <= 1 or not times or not nbytes:
            return
        for t in terms:              # one term for equal collectives
            if (t.name, t.kind, t.nbytes, t.group) == (name, kind_, nbytes,
                                                       group):
                t.times += int(times)
                return
        terms.append(CollectiveTerm(name, kind_, int(nbytes), int(group),
                                    int(times)))

    fsdp = defaultdict(int)             # group -> gathered bytes
    replicated = 0
    for name, sd in params.items():
        spec = specs[name]
        full = sd.nbytes // _model_shards(spec, minfo)
        g = _batch_group(spec, minfo)
        if g > 1:
            fsdp[g] += full
        else:
            replicated += full // sd.dtype.itemsize * accum_dtype.itemsize
    for g, nbytes in fsdp.items():
        add("fsdp_all_gather", "all-gather", nbytes, g,
            2 * micro if train else 1)
        if train:
            add("fsdp_reduce_scatter", "reduce-scatter", nbytes, g, micro)
    if train:
        add("grad_all_reduce", "all-reduce", replicated,
            minfo.batch_size_total, 1)

    msize = minfo.model_size
    for name, sd in params.items():
        if "." not in name or not _row_parallel(specs[name]):
            continue                    # the embeddings are no product
        if name.startswith("enc_blocks."):
            if kind == "decode":
                continue                # the encoder ran at prefill
            n_tok = enc_tokens
        else:
            n_tok = tokens
        add("row_parallel", "all-reduce",
            _shape_bytes(act_dtype, (n_tok, sd.shape[-1])), msize, passes)

    head = specs.get("lm_head") or specs["embed"]      # tied: the embedding
    if train and any("model" in spec_axes(e) for e in head):
        add("lse_all_reduce", "all-reduce",
            _shape_bytes(torch.float32, (tokens,)), msize, 2 * micro)

    if cfg.is_moe and cfg.n_experts % msize == 0:
        cap = moe_capacity(moe_tokens, cfg)
        n_moe = sum(1 for n in params if n.endswith(".moe.router"))
        add("moe_all_to_all", "all-to-all",
            _shape_bytes(act_dtype, (cfg.n_experts, cap, d)), msize,
            2 * passes * n_moe)

    if kind == "decode" and cache_specs and "k" in cache_specs \
            and cache_specs["k"][2] == "model":
        n_attn = sum(1 for n in params if n.endswith(".attn.wq")
                     and not n.startswith("enc_blocks."))
        add("kvseq_all_reduce", "all-reduce", _shape_bytes(
            torch.float32, (batch, cfg.n_heads, cfg.head_dim + 2)), msize,
            n_attn)

    if ring_hops > 1:
        n_attn = sum(1 for n in params if n.endswith(".attn.wq"))
        add("ring_permute", "collective-permute", ring_kv_bytes, ring_hops,
            2 * (ring_hops - 1) * n_attn)
        world = minfo.batch_size_total * msize
        add("ring_logits", "all-gather", _shape_bytes(
            act_dtype, (ring_hops, batch, cfg.padded_vocab)), ring_hops, 1)
        if cfg.is_moe:
            n_moe = sum(1 for n in params if n.endswith(".moe.router"))
            add("ring_moe_counts", "all-gather", _shape_bytes(
                torch.int64, (world, batch, cfg.top_k, cfg.n_experts)),
                world, n_moe)

    if act_model_shard and train:
        n_layers = cfg.n_layers + cfg.n_enc_layers
        add("act_all_gather", "all-gather",
            _shape_bytes(act_dtype, (tokens, d)), msize, passes * n_layers)
    return terms


class OpBytesMode(TorchDispatchMode):
    """Sums each op's input and output tensor bytes (the op-level upper
    bound that XLA's "bytes accessed" is), by module as
    ``FlopCounterMode`` sums its FLOPs (each op counts for every module
    it runs in, and for "Global"); ops that only make a view move nothing
    and are not counted, nor are the ``prim`` queries that a fake tensor's
    ``.device`` dispatches. It also follows the storages that ops make, and
    ``peak`` is the most bytes live at once, those of ``track``'s tensors
    (the arguments) included. ``shard_of`` maps a tensor shape to a
    divisor: a storage made as a tensor of that shape counts 1/divisor of
    its bytes toward ``live`` and ``peak`` (the dry run's parameters and
    their gradient-sized buffers at their per-device size). With
    ``collect_every`` it runs the garbage collector every that many ops,
    so that storages held only by reference cycles (autograd's) are freed
    at the same points in every run (the caller turns automatic
    collection off)."""

    def __init__(self, collect_every: int = 0, shard_of: dict | None = None):
        super().__init__()
        self.collect_every = collect_every
        self.shard_of = shard_of or {}
        self.n_ops = 0
        self.by_module: dict = defaultdict(int)
        self.live = self.peak = 0
        self._sizes: dict = {}
        self._refs: dict = {}
        self._tracker = ModuleTracker()

    def __enter__(self):
        self._tracker.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._tracker.__exit__(*exc)

    @property
    def total(self) -> int:
        return self.by_module["Global"]

    def track(self, tensors) -> None:
        for t in tensors:
            self._add(t)

    def _add(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        self._sizes[key] = n = st.nbytes() // self.shard_of.get(
            tuple(t.shape), 1)
        self.live += n
        self.peak = max(self.peak, self.live)
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key)
        del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # a view moves nothing; prim ops (a fake tensor's .device) are
        # queries, not ops
        if not func.is_view and func.namespace != "prim":
            tensors = [t for t in tree_flatten((args, kwargs, out))[0]
                       if isinstance(t, torch.Tensor)]
            n = sum(t.numel() * t.element_size() for t in tensors)
            for mod in {"Global", *self._tracker.parents}:
                self.by_module[mod] += n
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self._add(t)
            self.n_ops += 1
            if self.collect_every and self.n_ops % self.collect_every == 0:
                gc.collect()
        return out


# ---------------------------------------------------------------------------
# single-kernel roofline placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoofPoint:
    """Placement of ONE kernel on the card's roofline: where its analytic
    arithmetic intensity (flop/byte) falls relative to the ridge point
    ``peak_flops / hbm_bw`` and what fraction of peak the roof allows
    there. Shape-derived, not timed."""
    flops: float
    bytes: float
    intensity: float         # flop / byte
    ridge: float             # peak_flops / hbm_bw (flop/byte)
    bound: str               # "memory" when intensity < ridge else "compute"
    peak_fraction: float     # attainable FLOP/s at this intensity / peak
    t_compute: float         # seconds at peak compute
    t_memory: float          # seconds at peak HBM bandwidth


def kernel_roof_point(flops: float, bytes_: float, *,
                      peak_flops: float = PEAK_FP32_S,
                      hbm_bw: float = PEAK_BYTES_S) -> RoofPoint:
    """Place a kernel with analytic ``flops``/``bytes_`` on the roofline."""
    intensity = flops / max(bytes_, 1.0)
    ridge = peak_flops / hbm_bw
    attainable = min(peak_flops, intensity * hbm_bw)
    return RoofPoint(
        flops=float(flops), bytes=float(bytes_), intensity=intensity,
        ridge=ridge, bound="memory" if intensity < ridge else "compute",
        peak_fraction=attainable / peak_flops,
        t_compute=flops / peak_flops, t_memory=bytes_ / hbm_bw)


# ---------------------------------------------------------------------------
# roofline assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MemoryStats:
    """The fields of XLA's ``memory_analysis()`` that the record reads,
    per device."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device raw
    hlo_flops_raw: float
    hlo_bytes_raw: float
    scan_factor: float
    # corrected per-device
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float      # per-device wire bytes
    # terms (seconds)
    t_compute: float
    t_memory: float          # from op bytes (op-level UPPER bound)
    t_memory_floor: float    # arguments+outputs touched once (LOWER bound)
    t_collective: float
    bottleneck: str
    model_flops: float           # analytic 6*N*D (global, whole step)
    useful_ratio: float          # model_flops / (hlo_flops * chips)
    memory_per_chip: float       # bytes (arguments+temp+output-alias)
    note: str = ""

    def terms(self):
        return {"compute": self.t_compute, "memory": self.t_memory,
                "collective": self.t_collective}


def build_roofline(*, arch: str, shape: str, mesh_name: str, chips: int,
                   cost: dict, mem, collectives: CollectiveStats,
                   model_flops: float, scan_trips: int = 1,
                   outer_flops_per_dev: float = 0.0, note: str = "",
                   peak_flops: float = PEAK_BF16_S,
                   hbm_bw: float = PEAK_BYTES_S,
                   link_bw: float = LINK_BYTES_S) -> Roofline:
    """The reference's record from per-device ``cost`` ({"flops", "bytes
    accessed"}), ``mem`` (``MemoryStats``) and ``collectives``. With
    ``scan_trips`` 1 (the port) the scan correction is the identity."""
    raw_flops = float(cost.get("flops", 0.0))
    raw_bytes = float(cost.get("bytes accessed", 0.0))
    inner_f = max(raw_flops - outer_flops_per_dev, 0.0)
    flops = outer_flops_per_dev + scan_trips * inner_f
    scan_factor = flops / raw_flops if raw_flops else 1.0
    bytes_ = raw_bytes * scan_factor
    t_c = max(flops, model_flops / chips) / peak_flops
    t_m = bytes_ / hbm_bw
    t_floor = (mem.argument_size_in_bytes + mem.output_size_in_bytes
               - mem.alias_size_in_bytes) / hbm_bw
    t_l = collectives.wire_bytes / link_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    bott = max(terms, key=terms.get)
    mem_per_chip = (mem.argument_size_in_bytes + mem.temp_size_in_bytes
                    + mem.output_size_in_bytes - mem.alias_size_in_bytes)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops_raw=raw_flops, hlo_bytes_raw=raw_bytes,
        scan_factor=scan_factor, hlo_flops=flops, hlo_bytes=bytes_,
        collective_bytes=collectives.wire_bytes,
        t_compute=t_c, t_memory=t_m, t_memory_floor=t_floor,
        t_collective=t_l, bottleneck=bott,
        model_flops=model_flops,
        useful_ratio=(model_flops / (flops * chips)) if flops else 0.0,
        memory_per_chip=float(mem_per_chip), note=note)
