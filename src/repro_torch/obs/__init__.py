"""Observability plane: columnar flight recorder, decision ledger,
request-lifecycle tracing and exporters (see ``repro_torch.obs.recorder``).

Engines gate on :func:`resolve` (``telemetry=`` argument or the
``CHIRON_TELEMETRY`` environment variable); exports (JSONL, Perfetto JSON,
Prometheus text) live in ``repro_torch.obs.export`` and the terminal
dashboard CLI runs as ``python -m repro_torch.obs <run.jsonl>``.
"""
from repro_torch.obs.recorder import FlightRecorder, resolve

__all__ = ["FlightRecorder", "resolve"]
