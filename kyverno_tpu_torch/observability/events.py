"""Kubernetes Event generation for policy violations/applications.

Bounded workqueue drained by worker threads creating v1 Events
(reference: pkg/event/controller.go:106 Run — 3 workers, queue bound
1000 via the maxQueuedEvents flag, cmd/kyverno/main.go:234)."""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

from ..engine.api import EngineResponse, RuleStatus

SOURCE_ADMISSION = 'kyverno-admission'
SOURCE_SCAN = 'kyverno-scan'

REASON_POLICY_VIOLATION = 'PolicyViolation'
REASON_POLICY_APPLIED = 'PolicyApplied'
REASON_POLICY_ERROR = 'PolicyError'


def new_event(resource_ref: dict, reason: str, message: str,
              source: str = SOURCE_ADMISSION) -> dict:
    return {
        'apiVersion': 'v1',
        'kind': 'Event',
        'metadata': {
            'generateName': 'kyverno-event-',
            'namespace': resource_ref.get('namespace') or 'default',
        },
        'involvedObject': resource_ref,
        'reason': reason,
        'message': message,
        'source': {'component': source},
        'type': 'Warning' if reason != REASON_POLICY_APPLIED else 'Normal',
    }


def events_for_response(response: EngineResponse,
                        blocked: bool = False) -> List[dict]:
    """reference: pkg/webhooks/utils/event.go GenerateEvents"""
    pr = response.policy_response
    ref = {'kind': pr.resource_kind, 'namespace': pr.resource_namespace,
           'name': pr.resource_name, 'apiVersion': pr.resource_api_version}
    out: List[dict] = []
    for rule in pr.rules:
        if rule.status == RuleStatus.FAIL:
            out.append(new_event(
                ref, REASON_POLICY_VIOLATION,
                f'policy {pr.policy_name}/{rule.name} fail: '
                f'{rule.message}'))
        elif rule.status == RuleStatus.ERROR:
            out.append(new_event(
                ref, REASON_POLICY_ERROR,
                f'policy {pr.policy_name}/{rule.name} error: '
                f'{rule.message}'))
    return out


def _policy_ref(response: EngineResponse) -> dict:
    pr = response.policy_response
    policy = getattr(response, 'policy', None)
    kind = (policy.raw.get('kind') if policy is not None and
            getattr(policy, 'raw', None) else None) or \
        ('Policy' if pr.policy_namespace else 'ClusterPolicy')
    ref = {'apiVersion': 'kyverno.io/v1', 'kind': kind,
           'name': pr.policy_name}
    if pr.policy_namespace:
        ref['namespace'] = pr.policy_namespace
    return ref


def _resource_label(pr) -> str:
    if pr.resource_namespace:
        return (f'{pr.resource_kind} {pr.resource_namespace}/'
                f'{pr.resource_name}')
    return f'{pr.resource_kind} {pr.resource_name}'


def events_for_responses(responses: List[EngineResponse],
                         blocked: bool = False,
                         source: str = SOURCE_ADMISSION) -> List[dict]:
    """Admission-chain event generation, reference-faithful: failures
    raise PolicyViolation events on the POLICY (plus, when not blocked,
    violation events on the resource); full success raises a Normal
    PolicyApplied event on the policy (reference:
    pkg/webhooks/utils/event.go:11 GenerateEvents +
    pkg/event/events.go:12 NewPolicyFailEvent, :50
    NewPolicyAppliedEvent)."""
    out: List[dict] = []
    for er in responses:
        pr = er.policy_response
        if not pr.rules:
            continue
        statuses = [r.status for r in pr.rules]
        failed = any(s in (RuleStatus.FAIL, RuleStatus.ERROR)
                     for s in statuses)
        if failed:
            res_ref = {'kind': pr.resource_kind,
                       'namespace': pr.resource_namespace,
                       'name': pr.resource_name,
                       'apiVersion': pr.resource_api_version}
            for rule in pr.rules:
                if rule.status not in (RuleStatus.FAIL, RuleStatus.ERROR):
                    continue
                # reference: events.go:23 buildPolicyEventMessage
                msg = f'{_resource_label(pr)}: [{rule.name}] {rule.status}'
                if blocked:
                    msg += ' (blocked)'
                if rule.status == RuleStatus.ERROR and rule.message:
                    msg += f'; {rule.message}'
                ev = new_event(_policy_ref(er), REASON_POLICY_VIOLATION,
                               msg, source)
                out.append(ev)
                if not blocked:
                    out.append(new_event(
                        res_ref, REASON_POLICY_VIOLATION,
                        f'policy {pr.policy_name}/{rule.name} '
                        f'{rule.status}: {rule.message}', source))
        elif all(s == RuleStatus.SKIP for s in statuses):
            continue  # skipped: no event (exceptions handled upstream)
        else:
            out.append(new_event(
                _policy_ref(er), REASON_POLICY_APPLIED,
                f'{_resource_label(pr)}: pass', source))
    return out


class EventGenerator:
    """Buffered event emitter (reference: pkg/event/controller.go)."""

    MAX_QUEUED = 1000
    WORKERS = 3

    def __init__(self, client, max_queued: Optional[int] = None):
        self.client = client
        self._queue: 'queue.Queue[dict]' = queue.Queue(
            maxsize=max_queued or self.MAX_QUEUED)
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self.dropped = 0

    def add(self, *events: dict) -> None:
        for ev in events:
            try:
                self._queue.put_nowait(ev)
            except queue.Full:
                self.dropped += 1  # the reference drops on overflow too

    def run(self) -> None:
        for _ in range(self.WORKERS):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                ev = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            self._emit(ev)
            self._queue.task_done()

    def _emit(self, ev: dict) -> None:
        ns = ev['metadata'].get('namespace', 'default')
        ev = dict(ev)
        ev.setdefault('metadata', {})
        ev['metadata'] = dict(ev['metadata'])
        ev['metadata']['name'] = \
            f"{ev['metadata'].get('generateName', 'ev-')}{time.time_ns()}"
        try:
            self.client.create_resource('v1', 'Event', ns, ev)
        except Exception:  # noqa: BLE001 - event loss is tolerated
            pass

    def drain(self, timeout: float = 5.0) -> None:
        deadline = time.time() + timeout
        while self._queue.unfinished_tasks and time.time() < deadline:
            time.sleep(0.01)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads = []
