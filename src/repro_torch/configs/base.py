"""Config system of the PyTorch port: architecture config and the FL/NOMA
system config.

Copy of ``src/repro/configs/base.py`` (``ModelConfig``, the input shapes
``ShapeConfig`` and ``SHAPES``, ``NOMAConfig``, the axis registries,
``FLConfig`` with its eager validation and ``all_configs``). The
port keeps its own copy and imports nothing of ``repro``. Two registries
differ from the reference, because they name the port's own axes:

  ENGINES          ("torch",)  — the port has one wireless engine, the
                   counterpart of the reference's ``engine="jax"``;
  KERNEL_BACKENDS  ("auto", "torch", "cuda") — see kernels/backend.py.

The deprecated ``engine_pallas`` alias of the reference has no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Transformer-family architecture description.

    ``family`` selects the assembly (models/zoo.py):
      dense | moe | ssm | hybrid | encdec | vlm
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int            # query heads (0 for attention-free archs)
    n_kv_heads: int         # GQA KV heads
    d_ff: int               # per-expert FF width for MoE archs
    vocab_size: int
    head_dim: int = 0       # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_shard_hints: bool = False

    # --- SSM / RWKV / hybrid ---
    ssm_state: int = 0
    rwkv_head_size: int = 0

    # --- attention details ---
    rope_frac: float = 1.0        # fraction of head_dim with rotary applied
    rope_theta: float = 10_000.0
    sliding_window: int = 0
    long_context_window: int = 8192
    parallel_residual: bool = False
    glu: bool = True                  # gated MLP (swiglu) vs plain gelu MLP
    qkv_bias: bool = False
    logit_softcap: float = 0.0

    # --- encoder-decoder (audio) ---
    n_enc_layers: int = 0

    # --- multimodal stubs ---
    n_prefix_tokens: int = 0
    prefix_dim: int = 0

    # --- numerics / training ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    def __post_init__(self) -> None:
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived ----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 16; padded logits are masked
        in unembed."""
        return self.vocab_size + (-self.vocab_size) % 16

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d
        head = 0 if self.tie_embeddings else v * d
        blocks = 0
        n_dec = self.n_layers
        hd = self.head_dim
        for _ in range(n_dec):
            blk = 0
            if self.family == "ssm":  # rwkv6: time-mix + channel-mix
                blk += 4 * d * d + d * d
                blk += d * ff + ff * d
            else:
                q = self.n_heads * hd
                kv = self.n_kv_heads * hd
                blk += d * q + 2 * d * kv + q * d  # qkvo
                if self.family == "hybrid":
                    blk += 2 * d * d + d * self.ssm_state * 2
                if self.is_moe:
                    mlp = d * ff * (3 if self.glu else 2)
                    blk += self.n_experts * mlp + d * self.n_experts
                else:
                    blk += d * ff * (3 if self.glu else 2)
            blocks += blk
        enc = 0
        for _ in range(self.n_enc_layers):
            q = self.n_heads * hd
            kv = self.n_kv_heads * hd
            enc += d * q + 2 * d * kv + q * d
            enc += d * ff * (3 if self.glu else 2)
        cross = self.n_enc_layers and n_dec * (
            d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            + self.n_heads * hd * d)
        return emb + head + blocks + enc + (cross or 0)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts active)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        mlp = d * ff * (3 if self.glu else 2)
        inactive = self.n_layers * (self.n_experts - self.top_k) * mlp
        return self.param_count() - inactive

    # -- reduced variant for CPU smoke tests ------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family/topology, shrunk to laptop scale (<=128 d_model,
        2 layers, <=4 experts), in float32."""
        d = min(self.d_model, 128)
        if self.n_heads:
            g = max(1, self.n_heads // max(self.n_kv_heads, 1))
            kv = 1 if g > 1 else 2
            n_heads = kv * min(g, 4)
            hd = 16
        else:
            n_heads = kv = hd = 0
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 4 * d),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_prefix_tokens=min(self.n_prefix_tokens, 8) if self.n_prefix_tokens else 0,
            prefix_dim=d if self.prefix_dim else 0,
            rwkv_head_size=min(self.rwkv_head_size, 16) if self.rwkv_head_size else 0,
            long_context_window=256,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# FL + NOMA system config (the paper)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NOMAConfig:
    """Uplink NOMA cell parameters (DESIGN.md section 4)."""

    n_subchannels: int = 5          # K
    users_per_subchannel: int = 2   # J (power-domain NOMA pair)
    bandwidth_hz: float = 1e6       # B per subchannel
    noise_density: float = 1e-20    # N0 (W/Hz) ~ -170 dBm/Hz
    max_power_w: float = 0.2        # P_max per client (23 dBm)
    path_loss_exp: float = 3.76
    ref_path_loss: float = 1e-3     # at 1 m
    cell_radius_m: float = 500.0
    min_radius_m: float = 50.0
    sic_order: str = "strong_first"  # uplink SIC: strongest decoded first


# Canonical axis registries (the reference's, except ENGINES and
# KERNEL_BACKENDS, which name the port's own axes).

ADMISSIONS = ("auto", "full_sort", "segmented")

CELL_LAYOUTS = ("hex", "grid")

POLICIES = ("age_noma", "age_noma_budget", "random", "channel",
            "round_robin", "oma_age")

PAIRINGS = ("strong_weak", "adjacent", "hungarian", "greedy_matching")

SELECTIONS = ("greedy_set", "joint")

# the port's one wireless engine (core/engine.py), counterpart of the
# reference's engine="jax"
ENGINES = ("torch",)

# kernel backends of the port (kernels/backend.py resolve_backend):
#   auto   the CUDA kernels on a CUDA device, the plain PyTorch versions
#          on a CPU device
#   torch  the plain PyTorch versions; raises on a CUDA device
#   cuda   the CUDA kernels; raises on a CPU device
KERNEL_BACKENDS = ("auto", "torch", "cuda")

PREDICTORS = ("none", "stale", "ann")

# FLConfig fields exempt from __post_init__ validation, each with the
# reason eager checking is impossible or meaningless here.
_POST_INIT_EXEMPT = (
    "scenario",       # registry lives in sim/scenario.py;
                      # get_scenario_config raises at resolution
    "seed",           # any int is a valid seed
)


@dataclasses.dataclass(frozen=True)
class FLConfig:
    n_clients: int = 50
    rounds: int = 100
    local_epochs: int = 1
    local_batch: int = 32
    lr: float = 0.05
    momentum: float = 0.0
    dirichlet_alpha: float = 0.5     # non-IID level
    samples_per_client: Tuple[int, int] = (200, 1200)  # min/max, uniform
    # scheduler
    policy: str = "age_noma"         # age_noma|random|channel|round_robin|oma_age
    age_exponent: float = 1.0        # gamma
    t_budget_s: float = 0.0          # 0 = no budget (pure min-round-time)
    engine: str = "torch"            # ENGINES above
    kernel_backend: str = "auto"     # KERNEL_BACKENDS above
    pairing: str = "strong_weak"     # PAIRINGS (DESIGN.md section 7)
    selection: str = "greedy_set"    # SELECTIONS (DESIGN.md section 8)
    admission: str = "auto"          # ADMISSIONS (DESIGN.md section 9)
    n_cells: int = 1
    cell_layout: str = "hex"
    scenario: str = "static_iid"
    # client compute model
    cpu_cycles_per_sample: float = 2e6
    cpu_freq_range_ghz: Tuple[float, float] = (0.5, 2.0)
    model_bits: float = 0.0          # 0 = derived from model param count * 32
    # server-side update predictor for unselected clients
    predictor: str = "none"          # none | stale | ann
    pred_embed_dim: int = 32
    pred_hidden_dim: int = 64
    pred_lr: float = 1e-2
    pred_steps: int = 8
    pred_discount: float = 0.7
    pred_blend: float = 0.5
    pred_max_age: int = 0
    seed: int = 0

    def __post_init__(self) -> None:
        # fail at construction; every field is checked here or listed in
        # _POST_INIT_EXEMPT with a reason
        for field, registry in (("policy", POLICIES),
                                ("engine", ENGINES),
                                ("pairing", PAIRINGS),
                                ("selection", SELECTIONS),
                                ("admission", ADMISSIONS),
                                ("cell_layout", CELL_LAYOUTS),
                                ("kernel_backend", KERNEL_BACKENDS),
                                ("predictor", PREDICTORS)):
            value = getattr(self, field)
            if value not in registry:
                raise ValueError(f"unknown {field} {value!r} "
                                 f"(expected one of {registry})")
        for field in ("n_clients", "rounds", "local_epochs", "local_batch",
                      "pred_embed_dim", "pred_hidden_dim", "pred_steps"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, "
                                 f"got {getattr(self, field)}")
        for field in ("lr", "dirichlet_alpha", "cpu_cycles_per_sample",
                      "pred_lr"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be > 0, "
                                 f"got {getattr(self, field)}")
        for field in ("age_exponent", "t_budget_s", "model_bits",
                      "momentum", "pred_max_age"):
            if getattr(self, field) < 0:
                raise ValueError(f"{field} must be >= 0, "
                                 f"got {getattr(self, field)}")
        for field in ("pred_discount", "pred_blend"):
            if not 0.0 <= getattr(self, field) <= 1.0:
                raise ValueError(f"{field} must be in [0, 1], "
                                 f"got {getattr(self, field)}")
        lo, hi = self.samples_per_client
        if not 1 <= lo <= hi:
            raise ValueError(f"samples_per_client must satisfy "
                             f"1 <= min <= max, got {(lo, hi)}")
        flo, fhi = self.cpu_freq_range_ghz
        if not 0 < flo <= fhi:
            raise ValueError(f"cpu_freq_range_ghz must satisfy "
                             f"0 < min <= max, got {(flo, fhi)}")
        if self.n_cells < 1:
            raise ValueError(f"n_cells must be >= 1, got {self.n_cells}")


# ---------------------------------------------------------------------------
# Registry (the reference's ten architectures)
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "moonshot_v1_16b_a3b",
    "llama4_maverick_400b_a17b",
    "paligemma_3b",
    "hymba_1_5b",
    "seamless_m4t_medium",
    "stablelm_1_6b",
    "chatglm3_6b",
    "smollm_135m",
    "rwkv6_7b",
    "grok_1_314b",
]


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    name = canon(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r} (known: "
                         f"{ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
