"""Run-time policies of the port: fault tolerance, elastic plans and the
trace-driven autotuner."""
from repro_torch.runtime.autotune import (CostModel, SearchResult, SimResult,
                                          TraceLog, apply_overlay, autotune,
                                          config_overlay, replay)
from repro_torch.runtime.elastic import ElasticPlan, reshard_tree
from repro_torch.runtime.fault import (FaultInjector, RestartPolicy,
                                       SimulatedFailure, StragglerMonitor,
                                       run_with_restarts)

__all__ = ["FaultInjector", "RestartPolicy", "SimulatedFailure",
           "StragglerMonitor", "run_with_restarts", "ElasticPlan",
           "reshard_tree", "TraceLog", "CostModel", "SimResult", "replay",
           "autotune", "SearchResult", "config_overlay", "apply_overlay"]
