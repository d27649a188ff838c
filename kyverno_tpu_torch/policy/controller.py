"""Policy lifecycle controller.

Watches policy add/update/delete and spawns UpdateRequests so
generate-existing and mutate-existing rules are applied to resources
already in the cluster; re-enqueues everything on a periodic force
reconcile (reference: pkg/policy/policy_controller.go:98 NewController,
:428-551 the UR spawning paths, :388 forceReconciliation, default 1h).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from ..api.policy import Policy
from ..api.unstructured import Resource
from ..background.updaterequest import (UR_GENERATE, UR_MUTATE,
                                        UpdateRequestGenerator)
from ..engine.api import PolicyContext, RuleStatus
from ..engine.engine import Engine


class PolicyController:
    """reference: pkg/policy/policy_controller.go:57"""

    FORCE_RECONCILE_INTERVAL = 3600.0  # policy_controller.go:388 (1h)

    def __init__(self, client, engine: Optional[Engine] = None,
                 ur_generator: Optional[UpdateRequestGenerator] = None):
        self.client = client
        self.engine = engine or Engine()
        self.ur_generator = ur_generator or UpdateRequestGenerator(client)
        self._policies: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- event handlers (informer-driven in the reference) ----------------

    def add_policy(self, doc: dict) -> None:
        policy = Policy(doc)
        with self._lock:
            self._policies[self._key(policy)] = policy
        self._spawn_update_requests(policy)

    def update_policy(self, old_doc: dict, new_doc: dict) -> None:
        policy = Policy(new_doc)
        with self._lock:
            self._policies[self._key(policy)] = policy
        if (old_doc.get('spec') or {}) != (new_doc.get('spec') or {}):
            self._spawn_update_requests(policy)

    def delete_policy(self, doc: dict) -> None:
        policy = Policy(doc)
        with self._lock:
            self._policies.pop(self._key(policy), None)
        # deleting a synchronize=true DATA generate policy deletes its
        # downstream resources (reference: the UR cleanup path triggered
        # by policy deletion — generate.go:848 deleteGeneratedResources;
        # cloned downstream is preserved, generate.go:242).  The list is
        # scoped to the rule's generated kind AND the per-rule label so
        # a sibling clone rule's downstream is never swept.
        from ..background.labels import (BACKGROUND_GEN_RULE_LABEL,
                                         POLICY_NAME_LABEL)
        for rule in policy.rules:
            gen = rule.raw.get('generate') or {}
            if not rule.has_generate() or not gen.get('synchronize'):
                continue
            if gen.get('clone') or gen.get('cloneList'):
                continue
            selector = {'matchLabels': {POLICY_NAME_LABEL: policy.name}}
            try:
                downstream = self.client.list_resource(
                    gen.get('apiVersion', ''), gen.get('kind', ''), '',
                    selector)
            except Exception:  # noqa: BLE001 - kind not listable
                continue
            for obj in downstream:
                meta = obj.get('metadata') or {}
                labels = meta.get('labels') or {}
                # the rule label is only stamped on generate-existing
                # downstream; when present it must name THIS rule
                stamped = labels.get(BACKGROUND_GEN_RULE_LABEL)
                if stamped is not None and stamped != rule.name:
                    continue
                try:
                    self.client.delete_resource(
                        obj.get('apiVersion', ''), obj.get('kind', ''),
                        meta.get('namespace', ''), meta.get('name', ''))
                except Exception:  # noqa: BLE001 - already gone
                    pass

    @staticmethod
    def _key(policy: Policy) -> str:
        return f'{policy.namespace}/{policy.name}' if policy.namespace \
            else policy.name

    # -- UR spawning ------------------------------------------------------

    def _spawn_update_requests(self, policy: Policy) -> None:
        """Create URs for the triggers each generate / mutate-existing
        rule matches (reference: policy_controller.go:428-551)."""
        has_generate = any(r.has_generate() for r in policy.rules)
        mutate_existing = any(
            r.has_mutate() and (r.raw.get('mutate') or {}).get('targets')
            for r in policy.rules)
        if not has_generate and not mutate_existing:
            return
        if has_generate and not policy.raw.get(
                'spec', {}).get('generateExisting',
                                policy.raw.get('spec', {}).get(
                                    'generateExistingOnPolicyUpdate')):
            has_generate = False
        if not has_generate and not mutate_existing:
            return
        for trigger in self._triggers(policy):
            resp = self.engine.filter_background_rules(
                PolicyContext(policy, new_resource=trigger.obj))
            applied = [r for r in resp.policy_response.rules
                       if r.status == RuleStatus.PASS]
            if not applied:
                continue
            request_type = UR_GENERATE if has_generate else UR_MUTATE
            self.ur_generator.apply({
                'requestType': request_type,
                'policy': self._key(Policy(policy.raw)),
                'resource': {
                    'kind': trigger.kind,
                    'apiVersion': trigger.api_version,
                    'namespace': trigger.namespace,
                    'name': trigger.name,
                },
                'context': {},
            })

    def _triggers(self, policy: Policy) -> List[Resource]:
        """List cluster resources matching the policy's rule kinds
        (reference: policy_controller.go:552 generateTriggers)."""
        out: List[Resource] = []
        seen = set()
        for rule in policy.rules:
            match = rule.raw.get('match') or {}
            filters = [match] + (match.get('any') or []) + \
                (match.get('all') or [])
            for f in filters:
                for kind in (f.get('resources') or {}).get('kinds') or []:
                    bare = str(kind).split('/')[-1]
                    try:
                        items = self.client.list_resource(
                            '', bare, '', None)
                    except Exception:  # noqa: BLE001
                        continue
                    for item in items:
                        r = Resource(item)
                        key = (r.kind, r.namespace, r.name)
                        if key not in seen:
                            seen.add(key)
                            out.append(r)
        return out

    # -- periodic force reconcile ----------------------------------------

    def run(self, interval: Optional[float] = None) -> None:
        """Start the force-reconciliation loop
        (reference: policy_controller.go:388 forceReconciliation)."""
        interval = interval or self.FORCE_RECONCILE_INTERVAL

        def loop():
            while not self._stop.wait(interval):
                self.reconcile()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def reconcile(self) -> None:
        with self._lock:
            policies = list(self._policies.values())
        for policy in policies:
            self._spawn_update_requests(policy)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
