"""The fleet layer of the port.  So far only ``metrics`` (a copy of the
reference's process-wide registry), which the pool and the cluster
coordinator count in; the scheduler, triage and service modules are
ROADMAP Queue 1, item 12."""
from repro_torch.fleet.metrics import (METRICS_SCHEMA_KEY, METRICS_SCHEMA_VERSION,
                                       MetricsRegistry, registry, set_enabled)

__all__ = ["METRICS_SCHEMA_KEY", "METRICS_SCHEMA_VERSION", "MetricsRegistry",
           "registry", "set_enabled"]
