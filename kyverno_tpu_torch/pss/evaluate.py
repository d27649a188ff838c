"""PSS evaluation with Kyverno exclusion semantics.

Re-implements the reference's EvaluatePod
(reference: pkg/pss/evaluate.go:84): run the check set for the rule's
level/version, then exempt failing check ids matched by the rule's
``exclude`` entries (pod-level when no images are given, else only the
containers whose images match).
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, List, Optional, Tuple

from ..utils import wildcard
from .checks import (DEFAULT_CHECKS, LEVEL_BASELINE, PSS_CONTROLS_TO_CHECK_ID,
                     CheckResult)

_VERSION_RE = re.compile(r'^v?(\d+)\.(\d+)$')


def parse_version(rule: dict) -> Tuple[str, str]:
    level = rule.get('level', '') or ''
    version = rule.get('version', '') or ''
    if version in ('', 'latest'):
        version = 'latest'
    elif not _VERSION_RE.match(version):
        raise ValueError(f'invalid pod security admission version {version!r}')
    return level, version


def evaluate_pss(level: str, pod: dict) -> List[dict]:
    """Run the default checks and return failing results
    (reference: pkg/pss/evaluate.go:17 evaluatePSS)."""
    meta = pod.get('metadata') or {}
    spec = pod.get('spec') or {}
    results = []
    for check in DEFAULT_CHECKS:
        if level == LEVEL_BASELINE and check.level != level:
            continue
        # EVERY versioned variant runs, regardless of the requested
        # version, and failing variants each append a result — the
        # reference does not dedup (evaluate.go:24-35), so a pod
        # failing two variants reports the violation twice
        for variant in (check.fns or (check.fn,)):
            result = variant(meta, spec)
            if not result.allowed:
                results.append({
                    'id': check.id,
                    'checkResult': {
                        'allowed': False,
                        'forbiddenReason': result.forbidden_reason,
                        'forbiddenDetail': result.forbidden_detail,
                    },
                })
    return results


def evaluate_pod_security(rule: dict, pod: dict) -> Tuple[bool, List[dict]]:
    """reference: pkg/pss/evaluate.go:84 EvaluatePod"""
    level, _version = parse_version(rule)
    default_results = evaluate_pss(level, pod)
    for exclude in rule.get('exclude') or []:
        pod_level, matching = _pod_with_matching_containers(exclude, pod)
        target = pod_level if pod_level is not None else matching
        exclude_results = evaluate_pss(level, target)
        default_results = _exempt(default_results, exclude_results, exclude)
    return len(default_results) == 0, default_results


def _pod_with_matching_containers(exclude: dict, pod: dict):
    # reference: pkg/pss/evaluate.go:110 GetPodWithMatchingContainers
    images = exclude.get('images') or []
    if not images:
        pod_copy = copy.deepcopy(pod)
        spec = pod_copy.setdefault('spec', {})
        spec['containers'] = [{'name': 'fake'}]
        spec.pop('initContainers', None)
        spec.pop('ephemeralContainers', None)
        return pod_copy, None
    meta = pod.get('metadata') or {}
    matching = {'metadata': {'name': meta.get('name', ''),
                             'namespace': meta.get('namespace', '')},
                'spec': {}}
    spec = pod.get('spec') or {}
    for field in ('containers', 'initContainers', 'ephemeralContainers'):
        selected = [c for c in spec.get(field) or []
                    if wildcard.check_patterns(images, c.get('image', ''))]
        if selected:
            matching['spec'][field] = selected
    return None, matching


def _exempt(default_results: List[dict], exclude_results: List[dict],
            exclude: dict) -> List[dict]:
    # reference: pkg/pss/evaluate.go:38 exemptKyvernoExclusion — the
    # results round-trip through a map keyed by check ID, so duplicate
    # versioned-variant results COLLAPSE whenever a rule has excludes
    # (last one wins); insertion order stands in for Go's random map
    # iteration
    by_id = {}
    for r in default_results:
        by_id[r['id']] = r
    check_ids = PSS_CONTROLS_TO_CHECK_ID.get(exclude.get('controlName', ''), [])
    for ex in exclude_results:
        if ex['id'] in check_ids:
            by_id.pop(ex['id'], None)
    return list(by_id.values())


def format_checks_print(checks: List[dict]) -> str:
    """Go-style %+v print of the failing checks
    (reference: pkg/pss/evaluate.go:160 FormatChecksPrint)."""
    out = ''
    for check in checks:
        cr = check['checkResult']
        out += (f"({{Allowed:{str(cr['allowed']).lower()} "
                f"ForbiddenReason:{cr['forbiddenReason']} "
                f"ForbiddenDetail:{cr['forbiddenDetail']}}})\n")
    return out


_TEMPLATE_KINDS = {'DaemonSet', 'Deployment', 'Job', 'StatefulSet',
                   'ReplicaSet', 'ReplicationController'}


def extract_pod_spec(resource: dict) -> dict:
    """Extract a pod {metadata, spec} from one of the 8 workload kinds
    (reference: pkg/engine/validation.go:481 getSpec)."""
    kind = resource.get('kind', '')
    if kind in _TEMPLATE_KINDS:
        template = ((resource.get('spec') or {}).get('template') or {})
        return {'metadata': template.get('metadata') or {},
                'spec': template.get('spec') or {}}
    if kind == 'CronJob':
        template = (((resource.get('spec') or {}).get('jobTemplate') or {})
                    .get('spec') or {}).get('template') or {}
        return {'metadata': template.get('metadata') or {},
                'spec': template.get('spec') or {}}
    if kind == 'Pod':
        return {'metadata': resource.get('metadata') or {},
                'spec': resource.get('spec') or {}}
    raise ValueError(f'unsupported kind {kind!r} for podSecurity rule')
