"""Report aggregation (reference:
pkg/controllers/report/aggregate/controller.go).

Merges per-resource AdmissionReports and BackgroundScanReports into
namespaced PolicyReports / cluster-scoped ClusterPolicyReports, one per
policy (``cpol-<name>`` / ``pol-<name>``), keeping only results for
policies and rules that still exist and preferring the newest result per
(policy, rule, resource-uid).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..api.policy import Policy, Rule
from ..autogen.autogen import compute_rules
from ..dclient.client import NotFoundError
from .results import set_results
from .types import (
    LABEL_APP_MANAGED_BY, VALUE_KYVERNO_APP, new_policy_report,
    set_managed_by_kyverno_label, set_policy_label,
)

_SOURCE_KINDS = (
    ('kyverno.io/v1alpha2', 'AdmissionReport'),
    ('kyverno.io/v1alpha2', 'ClusterAdmissionReport'),
    ('kyverno.io/v1alpha2', 'BackgroundScanReport'),
    ('kyverno.io/v1alpha2', 'ClusterBackgroundScanReport'),
)


class AggregateController:
    """reference: aggregate/controller.go:46"""

    def __init__(self, client, policy_lister=None):
        self.client = client
        # policy_lister() -> List[Policy]; defaults to the client store
        self.policy_lister = policy_lister or self._list_policies

    def _list_policies(self) -> List[Policy]:
        out = []
        for api_version in ('kyverno.io/v1', 'kyverno.io/v2beta1'):
            for kind in ('ClusterPolicy', 'Policy'):
                out += [Policy(p) for p in self.client.list_resource(
                    api_version, kind)]
        return out

    def _create_policy_map(self) -> Dict[str, Tuple[Policy, Set[str]]]:
        """reference: aggregate/controller.go:283 createPolicyMap"""
        out: Dict[str, Tuple[Policy, Set[str]]] = {}
        for policy in self.policy_lister():
            rules = {Rule(r).name for r in compute_rules(policy)}
            out[policy.get_kind_and_name()] = (policy, rules)
        return out

    def reconcile(self) -> List[dict]:
        """One full aggregation pass over every namespace (plus cluster
        scope). Returns the reconciled PolicyReport/ClusterPolicyReport
        objects (reference: reconcile + buildReportsResults)."""
        policy_map = self._create_policy_map()
        accumulator: Dict[str, dict] = {}
        for api_version, kind in _SOURCE_KINDS:
            for report in self.client.list_resource(api_version, kind):
                self._merge_report(policy_map, accumulator, report)
        # bucket merged results by namespace, then by per-policy report
        # name via the shared naming helper
        from .results import split_results_by_policy
        by_ns: Dict[str, List[dict]] = {}
        for result in accumulator.values():
            by_ns.setdefault(result.pop('_namespace', ''), []).append(result)
        buckets: Dict[Tuple[str, str], List[dict]] = {}
        for ns, ns_results in by_ns.items():
            for name, results in split_results_by_policy(ns_results).items():
                buckets[(ns, name)] = results
        reconciled = []
        for (ns, name), results in sorted(buckets.items()):
            reconciled.append(
                self._reconcile_report(policy_map, ns, name, results))
        self._clean_reports({(
            (r.get('metadata') or {}).get('namespace', ''),
            (r.get('metadata') or {}).get('name', ''))
            for r in reconciled})
        return reconciled

    def _merge_report(self, policy_map, accumulator: Dict[str, dict],
                      report: dict) -> None:
        """reference: aggregate/controller.go:254 mergeReports"""
        owner_refs = (report.get('metadata') or {}).get('ownerReferences') or []
        if len(owner_refs) != 1:
            return
        owner = owner_refs[0]
        ns = (report.get('metadata') or {}).get('namespace', '')
        object_ref = {
            'apiVersion': owner.get('apiVersion', ''),
            'kind': owner.get('kind', ''),
            'namespace': ns,
            'name': owner.get('name', ''),
            'uid': owner.get('uid', ''),
        }
        from .results import get_results
        for result in get_results(report):
            entry = policy_map.get(result.get('policy', ''))
            if entry is None or result.get('rule', '') not in entry[1]:
                continue
            key = (f"{result.get('policy', '')}/{result.get('rule', '')}/"
                   f"{owner.get('uid', '')}")
            merged = dict(result)
            merged['resources'] = [object_ref]
            merged['_namespace'] = ns
            current = accumulator.get(key)
            if current is None or \
                    (current.get('timestamp', {}).get('seconds', 0) <
                     merged.get('timestamp', {}).get('seconds', 0)):
                accumulator[key] = merged

    def _reconcile_report(self, policy_map, namespace: str, name: str,
                          results: List[dict]) -> dict:
        """reference: aggregate/controller.go:211 reconcileReport"""
        kind = 'PolicyReport' if namespace else 'ClusterPolicyReport'
        try:
            existing = self.client.get_resource(
                'wgpolicyk8s.io/v1alpha2', kind, namespace, name)
        except NotFoundError:
            existing = None
        if existing is None:
            report = new_policy_report(namespace, name, results)
            self._label_policies(report, policy_map, results)
            return self.client.create_resource(
                'wgpolicyk8s.io/v1alpha2', kind, namespace, report)
        import copy as _copy
        after = _copy.deepcopy(existing)
        after.setdefault('metadata', {})['labels'] = {}
        set_managed_by_kyverno_label(after)
        self._label_policies(after, policy_map, results)
        set_results(after, results)
        if after == existing:
            return after
        return self.client.update_resource(
            'wgpolicyk8s.io/v1alpha2', kind, namespace, after)

    @staticmethod
    def _label_policies(report: dict, policy_map, results: List[dict]) -> None:
        for result in results:
            entry = policy_map.get(result.get('policy', ''))
            if entry is not None:
                set_policy_label(report, entry[0])

    def _clean_reports(self, keep: Set[Tuple[str, str]]) -> None:
        """reference: aggregate/controller.go:238 cleanReports"""
        for kind in ('PolicyReport', 'ClusterPolicyReport'):
            for report in self.client.list_resource(
                    'wgpolicyk8s.io/v1alpha2', kind):
                meta = report.get('metadata') or {}
                labels = meta.get('labels') or {}
                # only reap kyverno-managed reports — third-party
                # PolicyReports (e.g. trivy-operator) are not ours
                # (reference: aggregate/controller.go report selector)
                if labels.get(LABEL_APP_MANAGED_BY) != VALUE_KYVERNO_APP:
                    continue
                key = (meta.get('namespace', ''), meta.get('name', ''))
                if key not in keep:
                    try:
                        self.client.delete_resource(
                            'wgpolicyk8s.io/v1alpha2', kind,
                            key[0], key[1])
                    except NotFoundError:
                        pass
