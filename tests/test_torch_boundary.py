"""Boundaries of the port: it imports neither jax nor the reference
package, and its entry points run on the card unless told otherwise."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs import FLConfig, NOMAConfig, get_config
from repro_torch.core.engine import WirelessEngine
from repro_torch.data import TaskConfig
from repro_torch.fl import FLServer, compare_predictors, run_montecarlo
from repro_torch.kernels.backend import resolve_backend, resolve_device
from repro_torch.launch import train
from repro_torch.launch.serve import run_serve
from repro_torch.models import zoo
from repro_torch.sim import SCENARIOS, Scenario

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_reference_imports(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_scan_sees_the_whole_port():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "src/repro_torch/core/engine.py",
            "src/repro_torch/fl/server.py",
            "src/repro_torch/kernels/fedagg.py",
            "src/repro_torch/kernels/swa.py", "src/repro_torch/kernels/wkv6.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/sim/processes.py",
            "src/repro_torch/sim/numpy_ref.py",
            "src/repro_torch/sim/scenario.py", "src/repro_torch/fl/rounds.py",
            "src/repro_torch/obs/metrics.py", "src/repro_torch/obs/ledger.py",
            "src/repro_torch/checkpoint/ckpt.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/fl/predictor.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/obs/trace.py",
            "src/repro_torch/launch/roofline.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/configs/moonshot_v1_16b_a3b.py",
            "src/repro_torch/configs/grok_1_314b.py",
            "src/repro_torch/configs/llama4_maverick_400b_a17b.py",
            "src/repro_torch/configs/stablelm_1_6b.py",
            "src/repro_torch/configs/chatglm3_6b.py"} <= names


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA card")


def test_entry_points_default_to_cuda_and_raise_without_a_card(no_card):
    cfg = get_config("smollm_135m").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_backend()
    with pytest.raises(RuntimeError, match="cuda"):
        WirelessEngine(NOMAConfig(), FLConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        zoo.init_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        FLServer(cfg, FLConfig(n_clients=4, samples_per_client=(8, 8)),
                 NOMAConfig(), TaskConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        compare_predictors(cfg, FLConfig(n_clients=4,
                                         samples_per_client=(8, 8)),
                           NOMAConfig(), TaskConfig(), rounds=1)
    with pytest.raises(RuntimeError, match="cuda"):
        Scenario(SCENARIOS["vehicular"], NOMAConfig(), FLConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        run_montecarlo(n_clients=4, n_seeds=1, rounds=1)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--rounds", "1"])


@pytest.mark.parametrize("arch", ["hymba_1_5b", "rwkv6_7b",
                                  "moonshot_v1_16b_a3b", "chatglm3_6b"])
def test_serving_entry_points_default_to_cuda(arch, no_card):
    cfg = get_config(arch).reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        zoo.init_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        zoo.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        run_serve(cfg, batch=1, prompt_len=2, gen=1)


def test_explicit_cpu_runs_the_plain_versions():
    eng = WirelessEngine(NOMAConfig(), FLConfig(), device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(RuntimeError):
        WirelessEngine(NOMAConfig(), FLConfig(), device="cpu",
                       kernel_backend="cuda")


@pytest.mark.parametrize("bad", [dict(engine="jax"),
                                 dict(kernel_backend="xla"),
                                 dict(policy="nope"), dict(n_cells=0)])
def test_config_validates_eagerly(bad):
    with pytest.raises(ValueError):
        FLConfig(**bad)
