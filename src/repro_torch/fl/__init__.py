from repro_torch.fl.aggregate import (aggregate_deltas, apply_aggregate,
                                      blend_deltas)
from repro_torch.fl.client import LocalTrainer
from repro_torch.fl.predictor import UpdatePredictor
from repro_torch.fl.rounds import (POLICIES, compare_policies,
                                   compare_predictors, run_experiment,
                                   run_montecarlo, time_to_accuracy)
from repro_torch.fl.server import FLServer, History

__all__ = ["FLServer", "History", "LocalTrainer", "POLICIES",
           "UpdatePredictor", "aggregate_deltas", "apply_aggregate",
           "blend_deltas", "compare_policies", "compare_predictors",
           "run_experiment", "run_montecarlo", "time_to_accuracy"]
