"""Observability for the port's benchmark runner.  So far only ``spans``
(a copy of the reference's): the span tracer the dispatchers take.  The
rest of the reference's ``telemetry`` (export, history, provenance) is
ROADMAP Queue 1, item 12."""
from repro_torch.telemetry.spans import NULL_TRACER, Span, Tracer, group_label

__all__ = ["NULL_TRACER", "Span", "Tracer", "group_label"]
