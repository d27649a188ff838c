"""Policy metrics controller.

Mirrors the reference's informer-driven policy metrics (reference:
pkg/controllers/metrics/policy/controller.go:155 — policy change
counters and per-rule info gauges emitted from policy add/update/delete
events).  The dynamic client's watch feed is the informer equivalent:
every Policy/ClusterPolicy event increments
``kyverno_policy_changes_total`` and re-derives the
``kyverno_policy_rule_info_total`` gauge set (1 per live rule).
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from ..api.policy import Policy
from ..observability.metrics import POLICY_CHANGES, MetricsRegistry

POLICY_RULE_INFO = 'kyverno_policy_rule_info_total'

_POLICY_KINDS = {'ClusterPolicy', 'Policy'}


class PolicyMetricsController:
    """reference: pkg/controllers/metrics/policy/controller.go"""

    def __init__(self, client, registry: MetricsRegistry):
        self.client = client
        self.registry = registry
        self._lock = threading.Lock()
        # (policy key) → {rule label-tuples} for gauge retraction
        self._rules: Dict[str, set] = {}
        client.watch(self._on_event)
        # informers replay ADDED for objects that exist before the watch
        # starts (controller.go informer cache sync) — list and seed the
        # rule-info gauges so a restart doesn't zero the series
        for api_version, kind in (('kyverno.io/v1', 'ClusterPolicy'),
                                  ('kyverno.io/v1', 'Policy')):
            try:
                existing = client.list_resource(api_version, kind)
            except Exception:  # noqa: BLE001 - kind may not be served
                continue
            for resource in existing:
                resource.setdefault('kind', kind)
                self._sync_rule_info(Policy(resource))

    @staticmethod
    def _labels(policy: Policy) -> dict:
        return {
            'policy_name': policy.name,
            'policy_namespace': policy.namespace or '-',
            'policy_type': 'cluster' if not policy.namespace
            else 'namespaced',
            'policy_validation_mode':
                str(policy.validation_failure_action).lower(),
            'policy_background_mode': str(bool(policy.background)).lower(),
        }

    def _on_event(self, event: str, resource: dict) -> None:
        if resource.get('kind') not in _POLICY_KINDS:
            return
        policy = Policy(resource)
        labels = self._labels(policy)
        change = {'create': 'created', 'update': 'updated',
                  'delete': 'deleted',
                  'ADDED': 'created', 'MODIFIED': 'updated',
                  'DELETED': 'deleted'}.get(event, event)
        self.registry.inc(POLICY_CHANGES,
                          policy_change_type=change, **labels)
        self._sync_rule_info(policy, deleted=change == 'deleted')

    def _sync_rule_info(self, policy: Policy, deleted: bool = False) -> None:
        labels = self._labels(policy)
        key = f'{policy.namespace}/{policy.name}'
        with self._lock:
            # retract the previous rule-info series for this policy —
            # the rule no longer exists, so the series is removed from
            # exposition entirely (set_gauge(0) would keep it visible)
            for old in self._rules.pop(key, set()):
                self.registry.clear_gauge(POLICY_RULE_INFO,
                                          **dict(old))
            if deleted:
                return
            current = set()
            for rule in policy.rules:
                rule_labels: Tuple = tuple(sorted({
                    **labels,
                    'rule_name': rule.name,
                    'rule_type': _rule_type(rule),
                }.items()))
                current.add(rule_labels)
                self.registry.set_gauge(POLICY_RULE_INFO, 1.0,
                                        **dict(rule_labels))
            self._rules[key] = current


def _rule_type(rule) -> str:
    if rule.has_validate():
        return 'validate'
    if rule.has_mutate():
        return 'mutate'
    if rule.has_generate():
        return 'generate'
    if rule.verify_images:
        return 'verifyImages'
    return 'unknown'
