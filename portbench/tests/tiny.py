"""Tiny stand-ins for the cells, small enough for a CPU test: the same
files with widths, clients and drops cut down, and the cells' own
limits."""
from __future__ import annotations

from portbench import harness


def fl_cell() -> tuple[dict, dict]:
    cfg = harness.config("fl_smollm_135m")
    cfg.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=2, vocab_size=256)
    cfg["deployment"]["fl"].update(n_clients=6, samples_per_client=[8, 16],
                                   local_batch=4)
    cfg["deployment"]["noma"].update(n_subchannels=2)
    wl = harness.workload("fl_smollm_135m.seq512")
    wl["params"].update(seq_len=64, ref_block_rows=2)
    return cfg, wl


def mc_cell() -> tuple[dict, dict]:
    cfg = harness.config("mc_noma_10k")
    cfg.update(n_clients=64, rounds=4, seeds_per_batch=32)
    cfg["noma"].update(n_subchannels=8)
    wl = harness.workload("mc_noma_10k.static")
    wl["params"].update(checked_drops=8)
    return cfg, wl


CELLS = {"fl_smollm_135m.seq512": fl_cell, "mc_noma_10k.static": mc_cell}
