"""Observability: metrics instruments, K8s event generation, structured
logging, tracing, and device-pipeline telemetry (reference:
pkg/metrics, pkg/event, pkg/logging, pkg/tracing)."""

from .metrics import MetricsRegistry  # noqa: F401
from .events import EventGenerator  # noqa: F401
from .catalog import METRICS  # noqa: F401
