from repro_torch.fl.aggregate import aggregate_deltas, apply_aggregate
from repro_torch.fl.client import LocalTrainer
from repro_torch.fl.rounds import run_experiment
from repro_torch.fl.server import FLServer, History

__all__ = ["FLServer", "History", "LocalTrainer", "aggregate_deltas",
           "apply_aggregate", "run_experiment"]
