"""Ring attention over ``torch.distributed``: one spawn of 8 gloo
processes on a (2, 4) ("data", "model") mesh (tests/_ring_worker.py)
runs ``layers.ring_flash_attention`` and ``zoo.make_prefill_step(ring=)``;
this process holds the results to the port's and the reference's
``flash_attention`` and to the prefill without the ring."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _ring_worker
from repro.configs import get_config as r_get_config
from repro.models import layers as RLAYERS
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import zoo

B, S = 4, 64
# the reference test's attention config (tests/test_system.py)
ATTN = dict(n_heads=5, n_kv_heads=1, head_dim=16)
# name -> (arch, config overrides); moonshot at capacity 0.5 drops tokens:
# 4 experts x ceil(256 * 2 / 4 * 0.5) = 256 places for 512 choices
MODELS = {"dense": ("smollm_135m", {}),
          "moe_dropping": ("moonshot_v1_16b_a3b", {"capacity_factor": 0.5}),
          "hybrid": ("hymba_1_5b", {})}


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    rng = np.random.default_rng(0)
    qkv = [rng.standard_normal((B, S, h, 16)).astype(np.float32)
           for h in (5, 1, 1)]
    attn_cfg = dataclasses.replace(
        get_config("llama4_maverick_400b_a17b").reduced(), **ATTN)
    models = {}
    for name, (arch, over) in MODELS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        model = zoo.init_model(cfg, seed=3, device="cpu")
        toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        models[name] = (cfg, model.state_dict(),
                        {"tokens": torch.from_numpy(toks)})
    path = str(tmp_path_factory.mktemp("ring") / "job.pt")
    torch.save({"qkv": [torch.from_numpy(x) for x in qkv],
                "attn_cfg": attn_cfg, "models": models}, path)
    return qkv, attn_cfg, models, _ring_worker.spawn(path)


def test_ring_attention_is_flash_attention(ring):
    """Across 8 ranks the ring equals the port's ``flash_attention`` and
    the reference's (``q_chunk=kv_chunk=16``, as its own ring test) within
    1e-5."""
    qkv, attn_cfg, _, out = ring
    got = out["ring"].numpy()
    port = L.flash_attention(*(torch.from_numpy(x) for x in qkv), attn_cfg,
                             causal=True).numpy()
    rcfg = dataclasses.replace(
        r_get_config("llama4_maverick_400b_a17b").reduced(), **ATTN)
    ref = np.asarray(RLAYERS.flash_attention(
        *(jnp.asarray(x) for x in qkv), rcfg, causal=True, q_chunk=16,
        kv_chunk=16))
    assert got.shape == (B, S, 5, 16)
    assert np.abs(got - port).max() < 1e-5
    assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("name", list(MODELS))
def test_ring_prefill_is_the_prefill(ring, name):
    """``make_prefill_step(ring=)`` gathers to the prefill without the
    ring: the last logits and every cache tensor within 1e-5 of the
    largest magnitude (positions exactly). The dense model and the MoE
    (whose tokens drop: the queue places come from the whole batch) run
    the sequence ring; hymba runs each rank's batch shard whole."""
    _, _, models, out = ring
    cfg, state, batch = models[name]
    model = zoo.build_model(cfg, torch.device("cpu"))
    model.load_state_dict(state)
    logits, cache = zoo.make_prefill_step(cfg)(model, batch)
    got_logits, got_cache = out[name]
    scale = max(1.0, float(logits.abs().max()))
    assert float((got_logits - logits).abs().max()) <= 1e-5 * scale
    assert set(got_cache) == set(cache)
    for k, want in cache.items():
        assert got_cache[k].shape == want.shape, k
        if want.dtype == torch.int32:
            assert torch.equal(got_cache[k], want), k
        else:
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            assert float((got_cache[k] - want).abs().max()) <= tol, k
