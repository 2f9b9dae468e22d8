"""Multi-host cluster dispatch for the port's benchmark runner (port of
``repro.runner.cluster``).

The socket transport of the worker protocol (``runner/protocol.py``): a
``Coordinator`` listens on TCP, ``worker --connect`` processes register
with a host id + capacity and steal build-key groups from a central
deque, with heartbeat-based failure detection and group reassignment.
``ClusterScheduler`` wraps it in the ``ShardScheduler`` interface and
owns the ``"local:N"`` self-contained deployment (N localhost worker
subprocesses on the runner's device), which is how
``run_matrix(..., cluster="local:N")``, the tests and ``chip_smoke.py``
exercise the subsystem on one machine.
"""
from repro_torch.runner.cluster.coordinator import Coordinator
from repro_torch.runner.cluster.scheduler import ClusterScheduler, parse_cluster_spec

__all__ = ["Coordinator", "ClusterScheduler", "parse_cluster_spec"]
