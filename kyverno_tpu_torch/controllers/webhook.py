"""Webhook configuration reconciler.

Builds Validating/MutatingWebhookConfigurations from the live policy set
— narrow per-kind rules in fine-grained mode, a wildcard default
otherwise — injects the CA bundle, and maintains the lease heartbeat the
readiness watchdog checks (reference:
pkg/controllers/webhook/controller.go:215 watchdog, :617
buildResourceMutatingWebhookConfiguration, :692
buildDefaultResourceValidatingWebhookConfiguration).
"""

from __future__ import annotations

import base64
import time
from typing import Dict, List, Optional, Set

from ..api.policy import Policy

DEFAULT_WEBHOOK_TIMEOUT = 10  # reference: webhook/controller.go:49

VALIDATING_NAME = 'kyverno-resource-validating-webhook-cfg'
MUTATING_NAME = 'kyverno-resource-mutating-webhook-cfg'
# static control-plane webhooks (reference: pkg/config/config.go:22-34)
POLICY_VALIDATING_NAME = 'kyverno-policy-validating-webhook-cfg'
POLICY_MUTATING_NAME = 'kyverno-policy-mutating-webhook-cfg'
VERIFY_MUTATING_NAME = 'kyverno-verify-mutating-webhook-cfg'
#: stamped on every managed webhook configuration
#: (reference: pkg/utils/kube ManagedByLabel via webhook/utils.go:101)
MANAGED_BY_LABELS = {'webhook.kyverno.io/managed-by': 'kyverno'}
LEASE_NAME = 'kyverno-health'
# watchdog heartbeat: every 10s, stale after 100s
# (reference: webhook/controller.go:215-275, IdleDeadline)
TICK = 10.0
IDLE_DEADLINE = 100.0

# kinds → (apiGroups, apiVersions, resources) for webhook rules; the
# reference resolves these via discovery — this static table covers the
# built-in workload/core kinds, discovery extends it at runtime
_KIND_RESOURCES = {
    'Pod': ('', 'v1', 'pods'),
    'Namespace': ('', 'v1', 'namespaces'),
    'ConfigMap': ('', 'v1', 'configmaps'),
    'Secret': ('', 'v1', 'secrets'),
    'Service': ('', 'v1', 'services'),
    'ServiceAccount': ('', 'v1', 'serviceaccounts'),
    'Deployment': ('apps', 'v1', 'deployments'),
    'DaemonSet': ('apps', 'v1', 'daemonsets'),
    'StatefulSet': ('apps', 'v1', 'statefulsets'),
    'ReplicaSet': ('apps', 'v1', 'replicasets'),
    'Job': ('batch', 'v1', 'jobs'),
    'CronJob': ('batch', 'v1', 'cronjobs'),
    'Ingress': ('networking.k8s.io', 'v1', 'ingresses'),
    'NetworkPolicy': ('networking.k8s.io', 'v1', 'networkpolicies'),
    'LimitRange': ('', 'v1', 'limitranges'),
    'ResourceQuota': ('', 'v1', 'resourcequotas'),
}


def _policy_kinds(policies: List[Policy], want) -> Dict[str, Set[str]]:
    """kinds with their failure actions for the selected rule types."""
    from ..config.toggle import FORCE_FAILURE_POLICY_IGNORE
    force_ignore = FORCE_FAILURE_POLICY_IGNORE.enabled()
    kinds: Dict[str, Set[str]] = {}
    for policy in policies:
        # env-tier toggle (reference: pkg/toggle/toggle.go:23
        # ForceFailurePolicyIgnore)
        fail_policy = 'Ignore' if force_ignore else \
            (policy.spec.get('failurePolicy') or 'Fail')
        for rule in policy.rules:
            if not want(rule):
                continue
            match = rule.raw.get('match') or {}
            for f in [match] + (match.get('any') or []) + \
                    (match.get('all') or []):
                for k in (f.get('resources') or {}).get('kinds') or []:
                    kinds.setdefault(str(k).split('/')[-1],
                                     set()).add(fail_policy)
    return kinds


def _rules_for(kinds: Dict[str, Set[str]]) -> List[dict]:
    groups: Dict[tuple, List[str]] = {}
    wildcard = False
    for kind in sorted(kinds):
        if '*' in kind:
            wildcard = True
            continue
        entry = _KIND_RESOURCES.get(kind)
        if entry is None:
            wildcard = True  # unknown kind → fall back to wildcard rule
            continue
        group, version, resource = entry
        groups.setdefault((group, version), []).append(resource)
    rules = [{'apiGroups': [g], 'apiVersions': [v],
              'resources': sorted(res), 'scope': '*'}
             for (g, v), res in sorted(groups.items())]
    if wildcard:
        rules = [{'apiGroups': ['*'], 'apiVersions': ['*'],
                  'resources': ['*/*'], 'scope': '*'}]
    return rules


class WebhookConfigReconciler:
    """reference: pkg/controllers/webhook/controller.go:904 (NewController)"""

    def __init__(self, client, ca_bundle: bytes = b'',
                 namespace: str = 'kyverno', service: str = 'kyverno-svc',
                 timeout: int = DEFAULT_WEBHOOK_TIMEOUT):
        self.client = client
        self.ca_bundle = ca_bundle
        self.namespace = namespace
        self.service = service
        self.timeout = timeout

    def _client_config(self, path: str) -> dict:
        return {
            'service': {'name': self.service, 'namespace': self.namespace,
                        'path': path, 'port': 443},
            'caBundle': base64.b64encode(self.ca_bundle).decode(),
        }

    def reconcile(self, policies: List[Policy]) -> None:
        self._apply(VALIDATING_NAME, 'ValidatingWebhookConfiguration',
                    self._build_validating(policies))
        self._apply(MUTATING_NAME, 'MutatingWebhookConfiguration',
                    self._build_mutating(policies))
        self._apply(POLICY_VALIDATING_NAME,
                    'ValidatingWebhookConfiguration',
                    self._build_policy_validating())
        self._apply(POLICY_MUTATING_NAME, 'MutatingWebhookConfiguration',
                    self._build_policy_mutating())
        self._apply(VERIFY_MUTATING_NAME, 'MutatingWebhookConfiguration',
                    self._build_verify_mutating())
        self._update_policy_statuses(policies)

    #: kyverno.io policy CRs (reference: webhook/controller.go:62
    #: policyRule) and the health lease (:67 verifyRule)
    _POLICY_RULE = {'apiGroups': ['kyverno.io'],
                    'apiVersions': ['v1', 'v2beta1'],
                    'resources': ['clusterpolicies/*', 'policies/*']}
    _VERIFY_RULE = {'apiGroups': ['coordination.k8s.io'],
                    'apiVersions': ['v1'], 'resources': ['leases']}

    def _build_policy_validating(self) -> dict:
        """reference: controller.go:569
        buildPolicyValidatingWebhookConfiguration"""
        return {
            'apiVersion': 'admissionregistration.k8s.io/v1',
            'kind': 'ValidatingWebhookConfiguration',
            'metadata': {'name': POLICY_VALIDATING_NAME,
                         'labels': dict(MANAGED_BY_LABELS)},
            'webhooks': [{
                'name': 'validate-policy.kyverno.svc',
                'clientConfig': self._client_config('/policyvalidate'),
                'rules': [dict(self._POLICY_RULE,
                               operations=['CREATE', 'UPDATE'])],
                'failurePolicy': 'Fail',
                'sideEffects': 'None',
                'admissionReviewVersions': ['v1'],
            }],
        }

    def _build_policy_mutating(self) -> dict:
        """reference: controller.go:548
        buildPolicyMutatingWebhookConfiguration"""
        return {
            'apiVersion': 'admissionregistration.k8s.io/v1',
            'kind': 'MutatingWebhookConfiguration',
            'metadata': {'name': POLICY_MUTATING_NAME,
                         'labels': dict(MANAGED_BY_LABELS)},
            'webhooks': [{
                'name': 'mutate-policy.kyverno.svc',
                'clientConfig': self._client_config('/policymutate'),
                'rules': [dict(self._POLICY_RULE,
                               operations=['CREATE', 'UPDATE'])],
                'failurePolicy': 'Fail',
                'sideEffects': 'NoneOnDryRun',
                'reinvocationPolicy': 'IfNeeded',
                'admissionReviewVersions': ['v1'],
            }],
        }

    def _build_verify_mutating(self) -> dict:
        """reference: controller.go:521
        buildVerifyMutatingWebhookConfiguration"""
        return {
            'apiVersion': 'admissionregistration.k8s.io/v1',
            'kind': 'MutatingWebhookConfiguration',
            'metadata': {'name': VERIFY_MUTATING_NAME,
                         'labels': dict(MANAGED_BY_LABELS)},
            'webhooks': [{
                'name': 'monitor-webhooks.kyverno.svc',
                'clientConfig': self._client_config('/verifymutate'),
                'rules': [dict(self._VERIFY_RULE, operations=['UPDATE'])],
                'failurePolicy': 'Ignore',
                'sideEffects': 'NoneOnDryRun',
                'reinvocationPolicy': 'IfNeeded',
                'admissionReviewVersions': ['v1'],
                'objectSelector': {'matchLabels': {
                    'app.kubernetes.io/name': 'kyverno'}},
            }],
        }

    def _build_validating(self, policies: List[Policy]) -> dict:
        kinds = _policy_kinds(
            policies, lambda r: r.has_validate() or r.has_generate())
        webhooks = []
        for fail_policy, suffix in (('Fail', '/fail'), ('Ignore', '/ignore')):
            sel = {k: v for k, v in kinds.items() if fail_policy in v}
            if not sel:
                continue
            webhooks.append({
                'name': f'validate{suffix.replace("/", ".")}.kyverno.svc',
                'clientConfig': self._client_config(f'/validate{suffix}'),
                'rules': [dict(r, operations=['CREATE', 'UPDATE', 'DELETE',
                                              'CONNECT'])
                          for r in _rules_for(sel)],
                'failurePolicy': fail_policy,
                'sideEffects': 'NoneOnDryRun',
                'admissionReviewVersions': ['v1'],
                'timeoutSeconds': self.timeout,
            })
        if not webhooks:
            # no policies installed: the default catch-all ignore webhook
            # (reference: controller.go
            # buildDefaultResourceValidatingWebhookConfiguration)
            webhooks.append({
                'name': 'validate.kyverno.svc-ignore',
                'clientConfig': self._client_config('/validate/ignore'),
                'rules': [{'apiGroups': ['*'], 'apiVersions': ['*'],
                           'resources': ['*/*'],
                           'operations': ['CREATE', 'UPDATE', 'DELETE',
                                          'CONNECT']}],
                'failurePolicy': 'Ignore',
                'sideEffects': 'NoneOnDryRun',
                'admissionReviewVersions': ['v1'],
                'timeoutSeconds': self.timeout,
            })
        return {
            'apiVersion': 'admissionregistration.k8s.io/v1',
            'kind': 'ValidatingWebhookConfiguration',
            'metadata': {'name': VALIDATING_NAME,
                         'labels': dict(MANAGED_BY_LABELS)},
            'webhooks': webhooks,
        }

    def _build_mutating(self, policies: List[Policy]) -> dict:
        kinds = _policy_kinds(
            policies,
            lambda r: r.has_mutate() or r.has_verify_images())
        webhooks = []
        for fail_policy, suffix in (('Fail', '/fail'), ('Ignore', '/ignore')):
            sel = {k: v for k, v in kinds.items() if fail_policy in v}
            if not sel:
                continue
            webhooks.append({
                'name': f'mutate{suffix.replace("/", ".")}.kyverno.svc',
                'clientConfig': self._client_config(f'/mutate{suffix}'),
                'rules': [dict(r, operations=['CREATE', 'UPDATE'])
                          for r in _rules_for(sel)],
                'failurePolicy': fail_policy,
                'sideEffects': 'NoneOnDryRun',
                'admissionReviewVersions': ['v1'],
                'timeoutSeconds': self.timeout,
            })
        if not webhooks:
            # reference: controller.go
            # buildDefaultResourceMutatingWebhookConfiguration
            webhooks.append({
                'name': 'mutate.kyverno.svc-ignore',
                'clientConfig': self._client_config('/mutate/ignore'),
                'rules': [{'apiGroups': ['*'], 'apiVersions': ['*'],
                           'resources': ['*/*'],
                           'operations': ['CREATE', 'UPDATE']}],
                'failurePolicy': 'Ignore',
                'sideEffects': 'NoneOnDryRun',
                'admissionReviewVersions': ['v1'],
                'timeoutSeconds': self.timeout,
            })
        return {
            'apiVersion': 'admissionregistration.k8s.io/v1',
            'kind': 'MutatingWebhookConfiguration',
            'metadata': {'name': MUTATING_NAME,
                         'labels': dict(MANAGED_BY_LABELS)},
            'webhooks': webhooks,
        }

    def _apply(self, name: str, kind: str, desired: dict) -> None:
        existing = None
        try:
            existing = self.client.get_resource(
                'admissionregistration.k8s.io/v1', kind, '', name)
        except Exception:  # noqa: BLE001
            existing = None
        if not desired['webhooks']:
            if existing is not None:
                self.client.delete_resource(
                    'admissionregistration.k8s.io/v1', kind, '', name)
            return
        if existing is None:
            self.client.create_resource(
                'admissionregistration.k8s.io/v1', kind, '', desired)
        else:
            existing['webhooks'] = desired['webhooks']
            self.client.update_resource(
                'admissionregistration.k8s.io/v1', kind, '', existing)

    def _update_policy_statuses(self, policies: List[Policy]) -> None:
        """Mark policies ready once their webhooks exist, persisting the
        Ready condition, the computed autogen rules and the per-type
        rule counts to the live CR the way the reference's status
        subresource update does (controller.go:426 updatePolicyStatuses
        + utils.go:111 setRuleCount; condition shape: api/kyverno/v1
        IsReady/SetReady)."""
        from ..autogen.autogen import compute_rules
        for policy in policies:
            rules = compute_rules(policy)
            counts = {'validate': 0, 'generate': 0, 'mutate': 0,
                      'verifyimages': 0}
            autogen_rules = []
            for rule in rules:
                if str(rule.get('name', '')).startswith('autogen-'):
                    autogen_rules.append(rule)
                    continue
                if rule.get('validate') is not None:
                    counts['validate'] += 1
                if rule.get('generate') is not None:
                    counts['generate'] += 1
                if rule.get('mutate') is not None:
                    counts['mutate'] += 1
                if rule.get('verifyImages') is not None:
                    counts['verifyimages'] += 1
            status = {
                'ready': True,
                'conditions': [{'type': 'Ready', 'status': 'True',
                                'reason': 'Succeeded'}],
                'autogen': {'rules': autogen_rules},
                'rulecount': counts,
            }
            policy.raw.setdefault('status', {}).update(status)
            kind = policy.raw.get('kind', 'ClusterPolicy')
            api_version = policy.raw.get('apiVersion', 'kyverno.io/v1')
            try:
                live = self.client.get_resource(
                    api_version, kind, policy.namespace or '', policy.name)
                live_status = live.get('status') or {}
                if all(live_status.get(k) == v for k, v in status.items()):
                    continue  # already current: no steady-state writes
                live.setdefault('status', {}).update(status)
                self.client.update_status_resource(
                    api_version, kind, policy.namespace or '', live)
            except Exception:  # noqa: BLE001 - ad-hoc policies in unit
                # tests are not stored as CRs; readiness is best-effort
                pass

    # -- watchdog lease ---------------------------------------------------

    def heartbeat(self, now: Optional[float] = None) -> dict:
        """Renew the health lease (reference: controller.go:215)."""
        now = now or time.time()
        stamp = time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime(now))
        try:
            lease = self.client.get_resource(
                'coordination.k8s.io/v1', 'Lease', self.namespace,
                LEASE_NAME)
        except Exception:  # noqa: BLE001
            lease = None
        if lease is None:
            return self.client.create_resource(
                'coordination.k8s.io/v1', 'Lease', self.namespace, {
                    'apiVersion': 'coordination.k8s.io/v1', 'kind': 'Lease',
                    'metadata': {'name': LEASE_NAME,
                                 'namespace': self.namespace,
                                 'annotations': {
                                     'kyverno.io/last-request-time': stamp}},
                    'spec': {'renewTime': stamp}})
        lease.setdefault('metadata', {}).setdefault('annotations', {})[
            'kyverno.io/last-request-time'] = stamp
        lease.setdefault('spec', {})['renewTime'] = stamp
        return self.client.update_resource(
            'coordination.k8s.io/v1', 'Lease', self.namespace, lease)
