"""Background warm-up: compile/load the admission graph before traffic.

The daemons (``cmd/internal.Setup`` → admission controller) hand the
warmer a ``warm_fn`` that brings the serving path to readiness — for
admission that means building the ``BatchScanner`` for the installed
enforce policy set, which consults the AOT executable store first and
only falls back to a fresh trace + XLA compile on a cold cache.  The
warmer runs it on a daemon thread, wraps it in a ``kyverno/aot/warmer``
span, times it into ``kyverno_tpu_aot_warm_duration_seconds``, and
publishes the store's size/entry gauges, so "how long until this pod
serves compiled admission" is a dashboard number instead of folklore.

``KTPU_WARM=0`` disables warming entirely: ``start()`` is a no-op, no
thread spawns, and state reads ``disabled`` (requests still serve via
the host engine loop and lazy compilation, exactly as before).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

AOT_WARM_DURATION = 'kyverno_tpu_aot_warm_duration_seconds'

#: warmer lifecycle states
DISABLED = 'disabled'
PENDING = 'pending'
WARMING = 'warming'
READY = 'ready'
FAILED = 'failed'

_log = logging.getLogger('kyverno.aotcache')


def _env_enabled() -> bool:
    return os.environ.get('KTPU_WARM', '1') == '1'


class Warmer:
    """Runs ``warm_fn`` once in the background and reports readiness.

    ``warm_fn`` returns a short human-readable detail string (or None),
    or a ``(detail, attrs)`` pair — ``attrs`` land on the
    ``kyverno/aot/warmer`` span, so a warm pass that loads the canonical
    batch shapes can report exactly how many executables it brought up
    (and from where).  An exception marks the warmer ``failed`` —
    serving is unaffected either way, the un-warmed paths lazily
    compile as before.
    """

    def __init__(self, warm_fn: Callable[[], Optional[str]],
                 name: str = 'admission', registry=None,
                 enabled: Optional[bool] = None):
        self.warm_fn = warm_fn
        self.name = name
        self.registry = registry
        self.enabled = _env_enabled() if enabled is None else enabled
        self.state = PENDING if self.enabled else DISABLED
        self.detail: Optional[str] = None
        self.error: Optional[str] = None
        self.duration_s: Optional[float] = None
        self._done = threading.Event()
        self._started = False
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        if not self.enabled:
            self._done.set()

    @property
    def ready(self) -> bool:
        return self.state == READY

    def start(self) -> bool:
        """Spawn the warm thread; False (and no thread) when disabled.
        Idempotent — later calls return whether a run was ever started."""
        if not self.enabled:
            return False
        with self._lock:
            if self._started:
                return True
            self._started = True
            self._thread = threading.Thread(
                target=self.run_sync, name=f'ktpu-aot-warmer-{self.name}',
                daemon=True)
            self._thread.start()
        return True

    def run_sync(self) -> None:
        """The warm pass itself (the thread body; tests call it inline)."""
        if not self.enabled:
            return
        from ..observability import tracing
        from .store import default_store, publish_stats
        self.state = WARMING
        t0 = time.monotonic()
        with tracing.start_span('kyverno/aot/warmer',
                                {'target': self.name}) as span:
            try:
                detail = self.warm_fn()
                if isinstance(detail, tuple):
                    detail, attrs = detail
                    for k, v in (attrs or {}).items():
                        span.set_attribute(k, v)
                self.detail = detail
                self.state = READY
            except Exception as e:  # noqa: BLE001 - warm failure must
                # never take serving down; the lazy path still compiles
                self.error = str(e)
                self.state = FAILED
            self.duration_s = time.monotonic() - t0
            span.set_attribute('state', self.state)
            span.set_attribute('duration_s', round(self.duration_s, 3))
        reg = self.registry
        if reg is None:
            from ..observability.metrics import global_registry
            reg = global_registry()
        if reg is not None:
            from ..observability.metrics import WIDE_BUCKETS
            reg.register_histogram(AOT_WARM_DURATION, WIDE_BUCKETS)
            reg.observe(AOT_WARM_DURATION, self.duration_s,
                        target=self.name, state=self.state)
        publish_stats(default_store())
        from ..observability.logging import with_values
        with_values(_log, 'aot warm-up finished',
                    level=logging.ERROR if self.state == FAILED
                    else logging.INFO,
                    target=self.name, state=self.state,
                    duration_s=round(self.duration_s, 3),
                    detail=self.detail or self.error or '')
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the warm pass finished (or was disabled)."""
        return self._done.wait(timeout)
