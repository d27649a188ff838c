"""Report CR builders and labels (reference: pkg/utils/report/{new,labels}.go,
api/kyverno/v1alpha2, api/policyreport/v1alpha2).
"""

from __future__ import annotations

import hashlib
import json
from typing import List, Optional

from ..api.policy import Policy

LABEL_RESOURCE_HASH = 'audit.kyverno.io/resource.hash'
LABEL_RESOURCE_UID = 'audit.kyverno.io/resource.uid'
LABEL_DOMAIN_CLUSTER_POLICY = 'cpol.kyverno.io'
LABEL_DOMAIN_POLICY = 'pol.kyverno.io'
LABEL_AGGREGATED_REPORT = 'audit.kyverno.io/report.aggregate'
LABEL_APP_MANAGED_BY = 'app.kubernetes.io/managed-by'
VALUE_KYVERNO_APP = 'kyverno'


# (policy id) → (policy, label): label derivation runs per (report,
# policy) pair during batch scans — millions of calls for a value that
# is constant per policy object.  The resourceVersion is read at each
# call: a daemon keeps a policy's object across a status write and
# gives it the server's new document
_POLICY_LABEL_CACHE: dict = {}


def policy_label(policy: Policy) -> str:
    """reference: labels.go:61 PolicyLabel"""
    return _policy_label_rv(policy)[0]


def _resource_version(policy: Policy) -> str:
    return policy.metadata.get('resourceVersion', '') or ''


def _policy_label_rv(policy: Policy):
    pid = id(policy)
    hit = _POLICY_LABEL_CACHE.get(pid)
    if hit is not None and hit[0] is policy:
        return hit[1], _resource_version(policy)
    domain = LABEL_DOMAIN_POLICY if policy.is_namespaced \
        else LABEL_DOMAIN_CLUSTER_POLICY
    label = f'{domain}/{policy.name}'
    if len(_POLICY_LABEL_CACHE) > 4096:
        _POLICY_LABEL_CACHE.clear()
    _POLICY_LABEL_CACHE[pid] = (policy, label)
    return label, _resource_version(policy)


def is_policy_label(label: str) -> bool:
    """reference: labels.go:31 IsPolicyLabel"""
    return label.startswith(f'{LABEL_DOMAIN_POLICY}/') or \
        label.startswith(f'{LABEL_DOMAIN_CLUSTER_POLICY}/')


def policy_name_from_label(namespace: str, label: str) -> str:
    """reference: labels.go:35 PolicyNameFromLabel"""
    parts = label.split('/')
    if len(parts) == 2:
        if parts[0] == LABEL_DOMAIN_CLUSTER_POLICY:
            return parts[1]
        if parts[0] == LABEL_DOMAIN_POLICY:
            return f'{namespace}/{parts[1]}'
    raise ValueError(
        f'cannot get policy name from label, incorrect format: {label}')


def _set_label(obj: dict, key: str, value: str) -> None:
    obj.setdefault('metadata', {}).setdefault('labels', {})[key] = value


def set_managed_by_kyverno_label(obj: dict) -> None:
    _set_label(obj, LABEL_APP_MANAGED_BY, VALUE_KYVERNO_APP)


def set_policy_label(report: dict, policy: Policy) -> None:
    """reference: labels.go:100 SetPolicyLabel — value is the policy's
    resourceVersion so report controllers detect stale results."""
    label, rv = _policy_label_rv(policy)
    _set_label(report, label, rv)


def set_resource_labels(report: dict, uid: str) -> None:
    _set_label(report, LABEL_RESOURCE_UID, uid)


def calculate_resource_hash(resource: dict) -> str:
    """reference: labels.go:73 CalculateResourceHash — md5 over
    [labels, annotations, object minus metadata/status/scale/nodeName].
    Shallow-copies only the containers it prunes (json.dumps never
    mutates): the old deepcopy dominated background-reconcile ticks at
    two calls per row."""
    meta = resource.get('metadata') or {}
    obj = {k: v for k, v in resource.items()
           if k not in ('metadata', 'status', 'scale')}
    spec = obj.get('spec')
    if isinstance(spec, dict) and 'nodeName' in spec:
        obj['spec'] = {k: v for k, v in spec.items() if k != 'nodeName'}
    data = json.dumps([meta.get('labels'), meta.get('annotations'), obj],
                      separators=(',', ':'), sort_keys=True)
    return hashlib.md5(data.encode()).hexdigest()  # noqa: S324 — parity


def set_resource_version_labels(report: dict, resource: Optional[dict],
                                resource_hash: Optional[str] = None
                                ) -> None:
    """``resource_hash`` short-circuits the hash when the caller already
    holds it (the metadata cache computes it on every update)."""
    if resource_hash is None:
        resource_hash = calculate_resource_hash(resource) if resource \
            else ''
    _set_label(report, LABEL_RESOURCE_HASH, resource_hash)


def _owner_reference(resource: dict) -> dict:
    meta = resource.get('metadata') or {}
    return {
        'apiVersion': resource.get('apiVersion', ''),
        'kind': resource.get('kind', ''),
        'name': meta.get('name', ''),
        'uid': meta.get('uid', ''),
    }


def new_admission_report(namespace: str, name: str, owner_resource: dict
                         ) -> dict:
    """reference: new.go:15 NewAdmissionReport"""
    kind = 'AdmissionReport' if namespace else 'ClusterAdmissionReport'
    report = {
        'apiVersion': 'kyverno.io/v1alpha2',
        'kind': kind,
        'metadata': {
            'name': name,
            'ownerReferences': [_owner_reference(owner_resource)],
        },
        'spec': {'owner': _owner_reference(owner_resource)},
    }
    if namespace:
        report['metadata']['namespace'] = namespace
    uid = (owner_resource.get('metadata') or {}).get('uid', '')
    set_resource_labels(report, uid)
    set_managed_by_kyverno_label(report)
    return report


def build_admission_report(resource: dict, request: dict,
                           *responses, now: Optional[int] = None) -> dict:
    """reference: new.go:35 BuildAdmissionReport"""
    from .results import set_responses
    meta = resource.get('metadata') or {}
    report = new_admission_report(meta.get('namespace', ''),
                                  str(request.get('uid', '')), resource)
    set_responses(report, *responses, now=now)
    return report


def new_background_scan_report(resource: dict) -> dict:
    """reference: new.go:42 NewBackgroundScanReport"""
    meta = resource.get('metadata') or {}
    namespace = meta.get('namespace', '')
    kind = 'BackgroundScanReport' if namespace else \
        'ClusterBackgroundScanReport'
    report = {
        'apiVersion': 'kyverno.io/v1alpha2',
        'kind': kind,
        'metadata': {
            'name': meta.get('uid', '') or meta.get('name', ''),
            'ownerReferences': [_owner_reference(resource)],
        },
    }
    if namespace:
        report['metadata']['namespace'] = namespace
    set_managed_by_kyverno_label(report)
    return report


# label-dict template per distinct policy tuple: the streaming report
# path stamps the same policy set onto every row's report, so the
# managed-by + per-policy labels prebuild once and each report pays one
# C-level dict copy (id-keyed with identity re-verification, like
# _POLICY_LABEL_CACHE, and rebuilt when a policy's resourceVersion
# changed)
_FUSED_LABEL_CACHE: dict = {}


def _fused_labels(policies) -> dict:
    lkey = tuple(id(p) for p in policies)
    rvs = tuple(_resource_version(p) for p in policies)
    hit = _FUSED_LABEL_CACHE.get(lkey)
    if hit is not None and len(hit[0]) == len(policies) and \
            all(a is b for a, b in zip(hit[0], policies)) and \
            hit[1] == rvs:
        return hit[2]
    labels = {LABEL_APP_MANAGED_BY: VALUE_KYVERNO_APP}
    for policy in policies:
        label, rv = _policy_label_rv(policy)
        labels[label] = rv
    if len(_FUSED_LABEL_CACHE) > 4096:
        _FUSED_LABEL_CACHE.clear()
    _FUSED_LABEL_CACHE[lkey] = (tuple(policies), rvs, labels)
    return labels


def build_fused_report(resource: dict, results: List[dict], summary: dict,
                       policies) -> dict:
    """One-shot BackgroundScanReport for the streaming scan path:
    equivalent to ``new_background_scan_report`` + ``set_policy_label``
    per policy + ``set_fused_results``, built as a single literal with
    the label dict copied from a per-policy-set template — the report
    materialization leg of the 1M-row stream runs ~3x fewer dict
    operations per row."""
    meta = resource.get('metadata') or {}
    namespace = meta.get('namespace', '')
    report_meta = {
        'name': meta.get('uid', '') or meta.get('name', ''),
        'ownerReferences': [_owner_reference(resource)],
    }
    if namespace:
        report_meta['namespace'] = namespace
    report_meta['labels'] = dict(_fused_labels(policies))
    return {
        'apiVersion': 'kyverno.io/v1alpha2',
        'kind': 'BackgroundScanReport' if namespace
                else 'ClusterBackgroundScanReport',
        'metadata': report_meta,
        'spec': {'results': list(results), 'summary': dict(summary)},
    }


def new_policy_report(namespace: str, name: str,
                      results: Optional[List[dict]] = None) -> dict:
    """reference: new.go:57 NewPolicyReport"""
    from .results import set_results
    kind = 'PolicyReport' if namespace else 'ClusterPolicyReport'
    report = {
        'apiVersion': 'wgpolicyk8s.io/v1alpha2',
        'kind': kind,
        'metadata': {'name': name},
    }
    if namespace:
        report['metadata']['namespace'] = namespace
    set_managed_by_kyverno_label(report)
    set_results(report, results or [])
    return report
