"""The benchmark's files against its rules: every file parses, names
and units use the allowed characters, each per-layer metric moves an
end-to-end metric that each of its cells reports, new cells and metrics
are found as new files, nothing loads JAX or the JAX package, and the
model-FLOP formula counts what the reference's matmuls do."""
from __future__ import annotations

import ast
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import formulas, harness
from portbench.reference import model as ref_model

BENCH = harness.BENCH
ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_file_parses():
    for path in sorted((BENCH / "workloads").glob("*.json")) + sorted(
            (BENCH / "configs").glob("*.json")):
        assert isinstance(json.loads(path.read_text()), dict), path
    for path in sorted((BENCH / "metrics").glob("*.py")):
        assert callable(harness.metric_reader(path.stem)), path


def test_names_units_and_lengths():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [c["why"] for c in SPEC["configs"] + SPEC["workloads"]]
    texts += [c["source"] for c in SPEC["configs"]]
    texts += [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in SPEC[group]]
        assert len(got) == len(set(got)), group


def test_cells_match_their_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        wl = harness.workload(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert wl[key] == w[key], (w["name"], key)
        assert w["chips"] in (1, 4)
        assert (BENCH / "drivers" / f"{wl['driver']}.py").is_file()
        cfg_path = ROOT / configs[w["config"]]["file"]
        assert cfg_path.is_file() and cfg_path.is_relative_to(BENCH)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(configs)
    assert len({c["file"] for c in SPEC["configs"]}) == len(configs)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    for w in SPEC["workloads"]:
        got_e2e, got_layer = harness.metrics_of(w["name"], SPEC)
        assert "setup_s" in got_e2e and len(got_e2e) >= 2, w["name"]
        assert got_layer, w["name"]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert m["moves"] in harness.metrics_of(cell, SPEC)[0], \
                (m["name"], cell)
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_shares_of_a_peak_are_named_for_it():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%", m["name"]


def test_new_cell_and_metric_are_found_as_new_files(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__"))
    spec = json.loads(json.dumps(SPEC, allow_nan=False))
    wl = harness.workload("mc_noma_10k.static")
    wl["traffic"] = "static_long"
    (copy / "workloads" / "mc_noma_10k.static_long.json").write_text(
        json.dumps(wl, allow_nan=False))
    (copy / "metrics" / "extra.mc.py").write_text(
        "def read(ctx):\n    return ctx['units'] * 2.0\n")
    spec["workloads"].append({"name": "mc_noma_10k.static_long",
                              "config": "mc_noma_10k",
                              "traffic": "static_long", "chips": 1,
                              "why": "a new cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "mc_drops_per_s":
            m["workloads"].append("mc_noma_10k.static_long")
    spec["per_layer"].append({"name": "extra.mc", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "device", "moves": "mc_drops_per_s",
                              "workloads": ["mc_noma_10k.static_long"]})
    h = _load(copy / "harness.py", "portbench_copy_harness")
    assert h.workload("mc_noma_10k.static_long")["traffic"] == "static_long"
    assert h.metric_reader("extra.mc")({"units": 3}) == 6.0
    e2e, layer = h.metrics_of("mc_noma_10k.static_long", spec)
    assert e2e == ["mc_drops_per_s", "setup_s"] and layer == ["extra.mc"]
    assert "extra.mc" not in h.metrics_of("mc_noma_10k.static", spec)[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _top_imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _top_imports(path) & set(harness.BANNED_MODULES)
        assert not bad, (path, bad)


def test_a_run_loads_no_jax_module():
    """Everything a run imports, program included, in a fresh process:
    no top-level name of ``jax``, ``jaxlib``, ``flax`` or ``repro``
    (``repro_torch`` is the port, compared whole)."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "from portbench import harness, faults, formulas\n"
        "sys.argv = sys.argv[:1]\n"
        "import portbench.run, portbench.calibrate\n"
        "for d in ('fl_round', 'mc_rounds'): harness.driver(d)\n"
        "import repro_torch.fl.server, repro_torch.core.engine\n"
        "import repro_torch.obs.trace\n"
        "for p in (harness.BENCH / 'metrics').glob('*.py'):\n"
        "    harness.metric_reader(p.stem)\n"
        "print(harness.banned_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is not reachable")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "mc_noma_10k.static", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_model_flops_match_the_counted_matmuls():
    """PaLM's count of ``formulas`` equals what ``FlopCounterMode`` counts
    over the forward and backward of the plain reference (which computes
    every score of the causal square, as the count assumes)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = {"hidden_size": 64, "intermediate_size": 96,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "num_hidden_layers": 2, "vocab_size": 128, "rms_norm_eps": 1e-5,
           "rope_theta": 10000.0}
    w = {k: v.float() for k, v in ref_model.make_weights(
        cfg, 3, "cpu").items()}
    tokens = torch.randint(0, 128, (3, 17))
    with FlopCounterMode(display=False) as fc:
        ref_model.loss_and_grads(cfg, w, tokens, block_rows=3)
    positions = tokens.shape[1] - 1
    want = formulas.train_flops_per_token(cfg, positions) * 3 * positions
    assert fc.get_total_flops() == want


def test_peaks_and_bytes():
    assert formulas.PEAK_BF16_FLOPS == 989e12
    assert formulas.PEAK_HBM_BYTES == 3.35e12
    assert formulas.fedagg_bytes(10, 100) == 11 * 100 * 4
    assert formulas.pairscore_bytes(5) == 120
    assert formulas.roofline_pct(1.0, 0.0) is None
    cfg = harness.config("fl_smollm_135m")
    norms = (2 * cfg["num_hidden_layers"] + 1) * cfg["hidden_size"]
    assert formulas.dense_matmul_params(cfg) + norms == cfg["n_params"]
