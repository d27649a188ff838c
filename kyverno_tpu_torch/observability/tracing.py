"""Tracing: OTel-shaped spans over engine rule execution and webhook
handlers (reference: pkg/tracing/config.go NewTraceConfig, span.go,
childspan.go ChildSpan1 wrapping each rule at pkg/engine/validation.go:139;
HTTP handler spans at pkg/webhooks/handlers/trace.go:16).

Design: a process tracer with contextvar span propagation and pluggable
exporters. The in-memory exporter serves tests and the ``/debug/traces``
endpoint; an OTLP-shaped JSON exporter callback can be attached for a
collector — the hermetic environment has no network, so export is a
callable boundary, not a gRPC client.

Tracing is off until :func:`configure` runs (zero overhead: the no-op
tracer allocates nothing per span).
"""

from __future__ import annotations

import contextvars
import os
import secrets
import threading
import time
from typing import Any, Callable, Dict, List, Optional

#: exporter failures are counted per exporter class before the
#: exporter is dropped, so a dead exporter is visible on /metrics
#: instead of silently discarding spans
TRACE_EXPORT_ERRORS = 'kyverno_tpu_trace_export_errors_total'

#: consecutive export failures before an exporter is dropped from the
#: tracer (each one already counted on the error series)
EXPORT_FAILURE_LIMIT = 8

_current_span: contextvars.ContextVar[Optional['Span']] = \
    contextvars.ContextVar('ktpu_current_span', default=None)


class Span:
    __slots__ = ('name', 'trace_id', 'span_id', 'parent_id', 'start_ns',
                 'end_ns', 'attributes', 'status', 'status_message',
                 '_tracer', '_token')

    def __init__(self, tracer: 'Tracer', name: str,
                 parent: Optional['Span'],
                 attributes: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = parent.trace_id if parent else secrets.token_hex(16)
        self.span_id = secrets.token_hex(8)
        self.parent_id = parent.span_id if parent else ''
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.status = 'unset'
        self.status_message = ''
        self._tracer = tracer
        self._token = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_status(self, status: str, message: str = '') -> None:
        self.status = status
        self.status_message = message

    def record_exception(self, exc: BaseException) -> None:
        self.set_status('error', f'{type(exc).__name__}: {exc}')

    def end(self) -> None:
        self.end_ns = time.time_ns()
        self._tracer._export(self)

    # -- context manager --------------------------------------------------

    def __enter__(self) -> 'Span':
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.record_exception(exc)
        if self._token is not None:
            _current_span.reset(self._token)
        self.end()

    def to_otlp(self) -> dict:
        """OTLP/JSON span shape (subset)."""
        return {
            'traceId': self.trace_id,
            'spanId': self.span_id,
            'parentSpanId': self.parent_id,
            'name': self.name,
            'startTimeUnixNano': str(self.start_ns),
            'endTimeUnixNano': str(self.end_ns),
            'attributes': [
                {'key': k, 'value': {'stringValue': str(v)}}
                for k, v in self.attributes.items()],
            'status': {'code': self.status, 'message': self.status_message},
        }


class _NoopSpan:
    __slots__ = ()

    def set_attribute(self, key, value):
        pass

    def set_status(self, status, message=''):
        pass

    def record_exception(self, exc):
        pass

    def end(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_NOOP_SPAN = _NoopSpan()


class InMemoryExporter:
    """Bounded ring of finished spans (tests + /debug/traces)."""

    def __init__(self, maxlen: int = 2048):
        import collections
        self._spans = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def __call__(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans() if s.name == name]

    def children_of(self, span: Span) -> List[Span]:
        return [s for s in self.spans() if s.parent_id == span.span_id]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


class JsonlExporter:
    """Append each finished span as one OTLP-shaped JSON line.

    Serves the bench path: a scan run leaves a machine-readable
    per-stage record on disk (``stage_breakdown`` assembly) without a
    collector.  Writes are line-buffered and locked.  The file rotates
    by size (``KTPU_TRACE_JSONL_MAX_BYTES``; 0 disables): when the next
    line would exceed the budget, the current file moves to
    ``<path>.1`` (one rotated generation kept) and a fresh file opens —
    long benches no longer grow the trace file without bound.  A write
    failure closes the exporter and re-raises so ``Tracer._export``
    counts it on ``kyverno_tpu_trace_export_errors_total``."""

    DEFAULT_MAX_BYTES = 64 << 20

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        if max_bytes is None:
            try:
                max_bytes = int(os.environ.get(
                    'KTPU_TRACE_JSONL_MAX_BYTES',
                    str(self.DEFAULT_MAX_BYTES)))
            except ValueError:
                max_bytes = self.DEFAULT_MAX_BYTES
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._file = open(path, 'a', buffering=1)
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0

    def __call__(self, span: Span) -> None:
        with self._lock:
            if self._file is None:
                return
            import json
            line = json.dumps(span.to_otlp()) + '\n'
            try:
                if self.max_bytes > 0 and \
                        self._bytes + len(line) > self.max_bytes:
                    self._rotate()
                self._file.write(line)
                self._bytes += len(line)
            except (OSError, ValueError):
                self.close()
                raise

    def _rotate(self) -> None:
        """Current file → ``<path>.1`` (replacing any prior rotation),
        then reopen fresh.  Called under the lock."""
        f, self._file = self._file, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        os.replace(self.path, self.path + '.1')
        self._file = open(self.path, 'a', buffering=1)
        self._bytes = 0

    def close(self) -> None:
        f, self._file = self._file, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass


class Tracer:
    """reference: pkg/tracing — StartSpan/ChildSpan equivalents."""

    def __init__(self, exporters: Optional[List[Callable[[Span], None]]]
                 = None, enabled: bool = True):
        self.exporters = exporters or []
        self.enabled = enabled
        # consecutive failures per exporter (id-keyed; reset on any
        # successful export) — drives the drop-after-N policy
        self._export_failures: Dict[int, int] = {}

    def start_span(self, name: str,
                   attributes: Optional[Dict[str, Any]] = None,
                   parent: Optional[Span] = None):
        """Child of the context's current span (childspan.go ChildSpan1).
        ``parent`` overrides the contextvar — pipeline stages running on
        worker threads pass the request span captured at scan entry so
        one trace covers request → device → report."""
        if not self.enabled:
            return _NOOP_SPAN
        return Span(self, name, parent if parent is not None
                    else _current_span.get(), attributes)

    def _export(self, span: Span) -> None:
        for exporter in list(self.exporters):
            try:
                exporter(span)
            except Exception:  # noqa: BLE001 - exporters must not break
                self._count_export_error(exporter)
            else:
                if self._export_failures:
                    self._export_failures.pop(id(exporter), None)

    def _count_export_error(self, exporter) -> None:
        """A span exporter raised: count it (so a dead exporter shows
        on /metrics) and drop the exporter after EXPORT_FAILURE_LIMIT
        consecutive failures instead of burning a raise per span."""
        from .metrics import global_registry
        registry = global_registry()
        if registry is not None:
            registry.inc(TRACE_EXPORT_ERRORS,
                         exporter=type(exporter).__name__)
        n = self._export_failures.get(id(exporter), 0) + 1
        self._export_failures[id(exporter)] = n
        if n >= EXPORT_FAILURE_LIMIT:
            try:
                self.exporters.remove(exporter)
            except ValueError:
                pass
            self._export_failures.pop(id(exporter), None)


_NOOP_TRACER = Tracer(enabled=False)
_tracer: Tracer = _NOOP_TRACER
_memory: Optional[InMemoryExporter] = None


def configure(otlp_exporter: Optional[Callable[[Span], None]] = None,
              memory: bool = True,
              jsonl_path: Optional[str] = None) -> Optional[InMemoryExporter]:
    """Enable tracing (flag parity: cmd/internal/flag.go:46-49
    enableTracing/tracingAddress). Returns the in-memory exporter."""
    global _tracer, _memory
    exporters: List[Callable[[Span], None]] = []
    if memory:
        _memory = InMemoryExporter()
        exporters.append(_memory)
    if otlp_exporter is not None:
        exporters.append(otlp_exporter)
    if jsonl_path is not None:
        exporters.append(JsonlExporter(jsonl_path))
    _tracer = Tracer(exporters)
    return _memory


def disable() -> None:
    global _tracer, _memory
    for exporter in _tracer.exporters:
        close = getattr(exporter, 'close', None)
        if close is not None:
            close()
    _tracer = _NOOP_TRACER
    _memory = None


def tracer() -> Tracer:
    return _tracer


def memory_exporter() -> Optional[InMemoryExporter]:
    return _memory


def start_span(name: str, attributes: Optional[Dict[str, Any]] = None):
    # ktpu: noqa[KTPU504] -- forwarder: span names are checked against
    # the catalog at each caller's site, not at this pass-through
    return _tracer.start_span(name, attributes)


def current_span():
    return _current_span.get()


class _SpanScope:
    """Make an existing span the ambient parent on this thread without
    touching its lifecycle (the owner still ends it)."""

    __slots__ = ('span', '_token')

    def __init__(self, span: Optional[Span]):
        self.span = span
        self._token = None

    def __enter__(self):
        if self.span is not None:
            self._token = _current_span.set(self.span)
        return self.span

    def __exit__(self, *exc):
        if self._token is not None:
            _current_span.reset(self._token)
        return False


def install_span(span: Optional[Span]) -> _SpanScope:
    """Context manager parenting this thread's new spans under ``span``
    (no-op for None).  Pipeline worker threads install the scan's
    request span so every stage span joins one trace — the span itself
    is neither entered nor ended here."""
    return _SpanScope(span)
