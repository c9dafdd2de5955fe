"""Run-time policies of the port: fault tolerance and elastic plans."""
from repro_torch.runtime.elastic import ElasticPlan, reshard_tree
from repro_torch.runtime.fault import (FaultInjector, RestartPolicy,
                                       SimulatedFailure, StragglerMonitor,
                                       run_with_restarts)

__all__ = ["FaultInjector", "RestartPolicy", "SimulatedFailure",
           "StragglerMonitor", "run_with_restarts", "ElasticPlan",
           "reshard_tree"]
