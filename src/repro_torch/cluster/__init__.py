"""Multi-replica cluster serving: router, health checks, warm failover
(port of ``repro/cluster``).

The fleet layer over :class:`repro_torch.launch.serve.ServingEngine`: a
:class:`Supervisor` runs N replicas behind a :class:`Router`, monitors
their health through supervised tick times, and recovers a crashed
replica warm from the shared
:class:`~repro_torch.core.program_store.ProgramStore`, replaying its
unfinished requests from a durable :class:`RequestJournal`.  See
``repro_torch.cluster.supervisor`` for the full model and
``repro_torch.engine_config.ClusterConfig`` for the knobs.
"""
from repro_torch.cluster.journal import RequestJournal
from repro_torch.cluster.router import Router
from repro_torch.cluster.supervisor import ClusterError, Replica, Supervisor

__all__ = ["Supervisor", "Replica", "Router", "RequestJournal",
           "ClusterError"]
