"""Scenario subsystem: dynamic wireless environments (mobility, correlated
fading, heterogeneous compute), as batched state transitions on tensors
(``Scenario``) and as the FLServer's single-env numpy twin
(``NumpyScenario``). Exports of ``src/repro/sim/__init__.py``."""
from repro_torch.sim.numpy_ref import NumpyScenario
from repro_torch.sim.processes import bessel_j0, jakes_rho
from repro_torch.sim.scenario import (
    SCENARIOS,
    RoundEnvBatch,
    Scenario,
    ScenarioConfig,
    ScenarioParams,
    ScenarioState,
    as_scenario,
    get_scenario_config,
)
from repro_torch.sim.topology import (CellTopology, bs_layout, nearest_cell,
                                      region_radius)

__all__ = [
    "SCENARIOS",
    "CellTopology",
    "NumpyScenario",
    "RoundEnvBatch",
    "Scenario",
    "ScenarioConfig",
    "ScenarioParams",
    "ScenarioState",
    "as_scenario",
    "bessel_j0",
    "bs_layout",
    "get_scenario_config",
    "jakes_rho",
    "nearest_cell",
    "region_radius",
]
