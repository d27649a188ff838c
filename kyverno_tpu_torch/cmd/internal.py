"""Shared process bootstrap for the deployable binaries.

Mirrors the reference's setup sequence — logging → flags → maxprocs →
profiling → signal handling → metrics (reference: cmd/internal/setup.go:21
Setup, flag registry cmd/internal/flag.go:35-63).
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
from typing import Callable, List, Optional

from ..config.config import Configuration
from ..observability.logging import FORMAT_TEXT, setup as setup_logging
from ..observability.metrics import MetricsRegistry


def base_parser(name: str) -> argparse.ArgumentParser:
    """reference: cmd/internal/flag.go:35-63"""
    p = argparse.ArgumentParser(prog=name)
    p.add_argument('--logging-format', default=FORMAT_TEXT,
                   choices=('text', 'json'))
    p.add_argument('--log-level', default='info',
                   choices=('debug', 'info', 'warning', 'error'))
    p.add_argument('--namespace', default='kyverno')
    p.add_argument('--metrics-port', type=int, default=8000)
    p.add_argument('--disable-metrics', action='store_true')
    p.add_argument('--leader-election', action='store_true')
    # reference: cmd/internal/flag.go:40-42 (-profile/-profilePort) and
    # :46-49 (enableTracing/tracingAddress/tracingPort)
    p.add_argument('--profile', action='store_true')
    p.add_argument('--profile-port', type=int, default=6060)
    p.add_argument('--enable-tracing', action='store_true')
    p.add_argument('--kubeconfig', default='',
                   help='unused with the in-memory client; reserved for '
                        'a real cluster transport')
    return p


class Setup:
    """Process-wide wiring shared by every binary."""

    def __init__(self, name: str, args: Optional[List[str]] = None,
                 parser: Optional[argparse.ArgumentParser] = None,
                 client=None):
        parser = parser or base_parser(name)
        self.options = parser.parse_args(args)
        self.logger = setup_logging(
            self.options.logging_format,
            getattr(logging, self.options.log_level.upper()))
        self.metrics = MetricsRegistry() if not self.options.disable_metrics \
            else MetricsRegistry(disabled=['*'])
        if not self.options.disable_metrics:
            # publish the daemon registry process-wide and light up the
            # device-pipeline telemetry (stage histograms, compile-cache
            # counters, d2h stall watchdog — KTPU_D2H_STALL_S)
            from ..observability.metrics import set_global_registry
            from ..observability import coverage
            from ..observability import device as device_telemetry
            from ..observability import executables
            from ..observability import provenance
            from ..observability import slo
            set_global_registry(self.metrics)
            device_telemetry.configure(self.metrics)
            # device-coverage ledger: per-rule placement + attributed
            # host-fallback counters (GET /debug/coverage with --profile)
            coverage.configure(self.metrics)
            # decision provenance: per-decision serving-path records +
            # the flight recorder (GET /debug/decisions with --profile;
            # KTPU_FLIGHT_N=0 keeps it off)
            provenance.configure(self.metrics)
            # executable lifecycle ledger (GET /debug/executables;
            # KTPU_EXEC_LEDGER_N=0 keeps it off)
            executables.configure(self.metrics)
            # admission-latency SLO engine (GET /debug/slo; off unless
            # KTPU_SLO_WINDOW_S > 0)
            slo.configure(self.metrics)
            # fleet observatory: mesh-step telemetry, straggler blame +
            # cross-host federation (GET /debug/fleet; KTPU_FLEET=0
            # pins it off)
            from ..observability import fleet
            fleet.configure(self.metrics)
        self.configuration = Configuration()
        if client is None:
            from ..dclient.client import FakeClient
            client = FakeClient()
        self.client = client
        self.stop_event = threading.Event()
        # populated by start_aot_warmer (admission controller)
        self.aot_warmer = None
        # LIFO shutdown hooks (drain the admission batcher, stop
        # servers); run by shutdown() when the daemon loop exits
        self._shutdown_hooks: List[Callable[[], None]] = []
        # profiling + tracing (reference: setup.go:21 setup order)
        self.profiling_server = None
        if getattr(self.options, 'profile', False):
            from ..observability.profiling import ProfilingServer
            self.profiling_server = ProfilingServer(
                self.options.profile_port)
            self.profiling_server.start()
        if getattr(self.options, 'enable_tracing', False):
            from ..observability import tracing
            tracing.configure()

    def start_aot_warmer(self, warm_fn, name: str = 'admission'):
        """Kick off the background AOT warm-up (pre-compile / pre-load
        of the serving graph before first traffic).  Honors KTPU_WARM=0
        (no thread, state 'disabled').  Returns the Warmer so callers
        can report readiness (webhook health endpoints, benchmarks)."""
        from ..aotcache.warmer import Warmer
        registry = None if self.options.disable_metrics else self.metrics
        warmer = Warmer(warm_fn, name=name, registry=registry)
        warmer.start()
        self.aot_warmer = warmer
        return warmer

    def register_shutdown(self, hook: Callable[[], None]) -> None:
        """Register a graceful-shutdown hook (run LIFO by shutdown()).
        The admission controller registers WebhookServer.stop here,
        which drains the serving micro-batcher — queued admission
        futures resolve before the process exits."""
        self._shutdown_hooks.append(hook)

    def shutdown(self) -> None:
        """Run registered shutdown hooks, newest first.  Hooks must be
        idempotent (the daemon run loop may also call them directly);
        a failing hook is logged and never blocks the rest."""
        while self._shutdown_hooks:
            hook = self._shutdown_hooks.pop()
            try:
                hook()
            except Exception:  # noqa: BLE001
                self.logger.exception('shutdown hook failed')
        # residency gauges (queue depth, in-flight chunks, breaker
        # states) describe live occupancy: once everything above has
        # drained, a scrape must see 0, not the last sampled value
        self.metrics.reset_residency_gauges()

    def install_signal_handlers(self) -> None:
        def handler(signum, frame):
            self.logger.info('shutting down (signal %s)', signum)
            self.stop_event.set()
        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass  # not the main thread (tests)

    def run_until_stopped(self, tick: Callable[[], None],
                          interval: float = 1.0) -> None:
        while not self.stop_event.wait(interval):
            try:
                tick()
            except Exception:  # noqa: BLE001
                self.logger.exception('controller tick failed')
