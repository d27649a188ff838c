"""UpdateRequest controller (reference:
pkg/background/update_request_controller.go).

Dispatches pending UpdateRequests to the generate or mutate-existing
processor, with bounded retries and cleanup of completed URs — the same
worker/workqueue discipline as the reference, driven here by an explicit
``process_pending`` step so it composes with any scheduler (thread pool,
asyncio, or a test loop).
"""

from __future__ import annotations

from typing import List, Optional

from ..dclient.client import NotFoundError
from .generate import GenerateController
from .mutate_existing import MutateExistingController
from .updaterequest import (
    KYVERNO_NAMESPACE, STATE_COMPLETED, STATE_FAILED, STATE_PENDING,
    UR_GENERATE, UR_MUTATE, UpdateRequest,
)

MAX_RETRIES = 10  # reference: update_request_controller.go:39 maxRetries


class UpdateRequestController:
    """reference: pkg/background/update_request_controller.go:74"""

    def __init__(self, client, engine, policy_getter=None):
        self.client = client
        self.generate = GenerateController(client, engine, policy_getter)
        self.mutate = MutateExistingController(client, engine, policy_getter)
        self._retries = {}

    def list_urs(self, state: Optional[str] = None) -> List[UpdateRequest]:
        urs = [UpdateRequest(raw) for raw in self.client.list_resource(
            'kyverno.io/v1beta1', 'UpdateRequest', KYVERNO_NAMESPACE)]
        if state is not None:
            urs = [ur for ur in urs if (ur.state or STATE_PENDING) == state]
        return urs

    def process_pending(self) -> int:
        """One reconcile pass over all pending URs. Returns the number
        processed (reference: syncUpdateRequest worker loop)."""
        n = 0
        for ur in self.list_urs(STATE_PENDING):
            self.sync_update_request(ur)
            n += 1
        # synchronize=true generate URs re-reconcile continuously: the
        # reference watches downstream/source changes and re-enqueues
        # the UR (pkg/background/update_request_controller.go informer
        # hooks); the tick model re-processes them each pass, which
        # no-ops when everything already converged
        for ur in self.list_urs(STATE_COMPLETED):
            if ur.type != UR_GENERATE or not self._wants_sync(ur):
                continue
            # converged sync URs re-reconcile as no-ops; not counted as
            # processed work
            self.sync_update_request(ur)
        return n

    def _wants_sync(self, ur: UpdateRequest) -> bool:
        policy = None
        try:
            policy = self.generate.policy_getter(ur.policy_key)
        except Exception:  # noqa: BLE001 - deleted policy: nothing to sync
            return False
        if policy is None:
            return False
        return any(bool((r.raw.get('generate') or {}).get('synchronize'))
                   for r in policy.rules)

    def sync_update_request(self, ur: UpdateRequest) -> None:
        """reference: update_request_controller.go syncUpdateRequest"""
        # background entry point of the trace: any device scans the
        # processors trigger nest their stage spans under this one
        from ..observability import tracing
        with tracing.start_span(
                'kyverno/background/ur',
                {'ur': ur.name, 'type': ur.type or '',
                 'policy': ur.policy_key or ''}) as span:
            self._sync_update_request(ur, span)

    def _sync_update_request(self, ur: UpdateRequest, span) -> None:
        if ur.type == UR_GENERATE:
            err = self.generate.process_ur(ur)
        elif ur.type == UR_MUTATE:
            err = self.mutate.process_ur(ur)
        else:
            # a malformed type is permanent: fail without consuming retries
            ur.set_status(STATE_FAILED, f'unknown request type {ur.type!r}')
            self._store_status(ur)
            return
        span.set_attribute('result', 'error' if err is not None else 'ok')
        if err is not None:
            key = ur.name
            self._retries[key] = self._retries.get(key, 0) + 1
            if self._retries[key] < MAX_RETRIES:
                # leave Pending for the next pass (rate-limited requeue)
                ur.raw.setdefault('status', {})['state'] = STATE_PENDING
                ur.raw['status']['message'] = str(err)
            else:
                ur.set_status(STATE_FAILED, str(err))
                self._retries.pop(key, None)
        else:
            self._retries.pop(ur.name, None)
        self._store_status(ur)

    def _store_status(self, ur: UpdateRequest) -> None:
        try:
            self.client.update_resource(
                'kyverno.io/v1beta1', 'UpdateRequest', KYVERNO_NAMESPACE,
                ur.raw)
        except NotFoundError:
            pass

    def cleanup_completed(self) -> int:
        """Delete completed URs (reference: cleanupUR). Returns count."""
        n = 0
        for ur in self.list_urs(STATE_COMPLETED):
            try:
                self.client.delete_resource(
                    'kyverno.io/v1beta1', 'UpdateRequest', KYVERNO_NAMESPACE,
                    ur.name)
                n += 1
            except NotFoundError:
                pass
        return n
