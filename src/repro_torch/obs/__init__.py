"""Observability plane: the columnar flight recorder, its decision ledger
and request-lifecycle spans (see ``repro_torch.obs.recorder``).

Engines gate on :func:`resolve` (``telemetry=`` argument or the
``CHIRON_TELEMETRY`` environment variable). The exporters and the terminal
dashboard (the reference's ``obs.export`` and ``obs.__main__``) are not
part of the port yet (ROADMAP.md, Queue A item 9c).
"""
from repro_torch.obs.recorder import FlightRecorder, resolve

__all__ = ["FlightRecorder", "resolve"]
