"""Match/exclude evaluation: does a rule apply to a resource?

Re-implements MatchesResourceDescription and its helpers
(reference: pkg/engine/utils.go:185, pkg/utils/match/*.go):

* match block: AND across attributes, OR inside list attributes
* any/all lists of resource filters
* exclude block: resource excluded if the block matches
* user info (roles / clusterRoles / subjects) matching
* label selectors with wildcard expansion
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..api.unstructured import (Resource, get_kind_from_gvk,
                                group_version_matches)
from ..utils import wildcard


class MatchError(Exception):
    pass


def matches_resource_description(resource: Resource, rule, admission_info: Optional[dict],
                                 exclude_group_roles: List[str],
                                 namespace_labels: Dict[str, str],
                                 policy_namespace: str,
                                 subresource_in_review: str = '',
                                 subresources_in_policy: Optional[List[dict]] = None) -> Optional[str]:
    """Return None if the rule matches, else a reason string
    (reference: pkg/engine/utils.go:185 MatchesResourceDescription)."""
    if policy_namespace and policy_namespace != resource.namespace:
        return (' The policy and resource namespace are different.'
                ' Therefore, policy skip this resource.')

    match = rule.match if not isinstance(rule, dict) else (rule.get('match') or {})
    exclude = rule.exclude if not isinstance(rule, dict) else (rule.get('exclude') or {})
    rule_name = rule.name if not isinstance(rule, dict) else rule.get('name', '')

    reasons: List[str] = []

    def match_filter(f):
        return _check_filter(f, resource, admission_info, exclude_group_roles,
                             namespace_labels, subresource_in_review,
                             allow_ephemeral=True, mode='match',
                             subresources_in_policy=subresources_in_policy)

    def exclude_filter(f):
        return _check_filter(f, resource, admission_info, exclude_group_roles,
                             namespace_labels, subresource_in_review,
                             allow_ephemeral=True, mode='exclude',
                             subresources_in_policy=subresources_in_policy)

    any_filters = match.get('any') or []
    all_filters = match.get('all') or []
    if any_filters:
        if not any(not match_filter(f) for f in any_filters):
            reasons.append('no resource matched')
    elif all_filters:
        for f in all_filters:
            reasons.extend(match_filter(f))
    else:
        f = {'resources': match.get('resources') or {},
             'roles': match.get('roles'), 'clusterRoles': match.get('clusterRoles'),
             'subjects': match.get('subjects')}
        reasons.extend(match_filter(f))

    ex_any = exclude.get('any') or []
    ex_all = exclude.get('all') or []
    if ex_any:
        for f in ex_any:
            if not exclude_filter(f):
                reasons.append('resource excluded since one of the criteria excluded it')
    elif ex_all:
        if all(not exclude_filter(f) for f in ex_all):
            reasons.append('resource excluded since the combination of all criteria exclude it')
    elif exclude:
        f = {'resources': exclude.get('resources') or {},
             'roles': exclude.get('roles'), 'clusterRoles': exclude.get('clusterRoles'),
             'subjects': exclude.get('subjects')}
        if not _filter_is_empty(f):
            if not exclude_filter(f):
                reasons.append('resource excluded since one of the criteria excluded it')

    if reasons:
        msg = f'rule {rule_name} not matched:'
        for i, r in enumerate(reasons):
            msg += '\n ' + str(i + 1) + '. ' + r
        return msg
    return None


def _filter_is_empty(f: dict) -> bool:
    res = f.get('resources') or {}
    return not any([res, f.get('roles'), f.get('clusterRoles'), f.get('subjects')])


def _check_filter(f: dict, resource: Resource, admission_info: Optional[dict],
                  exclude_group_roles: List[str],
                  namespace_labels: Dict[str, str],
                  subresource_in_review: str,
                  allow_ephemeral: bool = False,
                  mode: str = 'match',
                  subresources_in_policy: Optional[List[dict]] = None) -> List[str]:
    """Return list of mismatch reasons (empty == filter matched).

    ``mode='match'`` mirrors matchesResourceDescriptionMatchHelper
    (reference: pkg/engine/utils.go:261): user info is ignored when there is
    no admission info, and an empty filter is a non-match ("match cannot be
    empty"). ``mode='exclude'`` mirrors the exclude helper (utils.go:276):
    user info always applies and an empty filter never excludes."""
    errs: List[str] = []
    user_info = {'roles': f.get('roles'), 'clusterRoles': f.get('clusterRoles'),
                 'subjects': f.get('subjects')}
    has_user_info = any(user_info.values())
    res_desc = f.get('resources') or {}
    if mode == 'match' and (admission_info is None or not admission_info):
        has_user_info = False
        user_info = {}
    if res_desc or has_user_info:
        errs.extend(_check_resource_description(
            res_desc, resource, namespace_labels, subresource_in_review,
            allow_ephemeral, subresources_in_policy))
        if has_user_info:
            errs.extend(_check_user_info(user_info, admission_info or {},
                                         exclude_group_roles))
    else:
        # empty filter: never matches (match) / never excludes (exclude)
        errs.append('match cannot be empty' if mode == 'match'
                    else 'exclude filter is empty')
    return errs


def _check_resource_description(block: dict, resource: Resource,
                                namespace_labels: Dict[str, str],
                                subresource_in_review: str,
                                allow_ephemeral: bool,
                                subresources_in_policy: Optional[List[dict]] = None) -> List[str]:
    # reference: pkg/engine/utils.go:72 doesResourceMatchConditionBlock
    errs: List[str] = []
    kinds = block.get('kinds') or []
    if kinds:
        if not check_kind(kinds, resource, subresource_in_review,
                          allow_ephemeral, subresources_in_policy):
            errs.append(f'kind does not match {kinds}')
    resource_name = resource.name or resource.generate_name
    name = block.get('name') or ''
    if name:
        if not wildcard.match(name, resource_name):
            errs.append('name does not match')
    names = block.get('names') or []
    if names and not any(wildcard.match(n, resource_name) for n in names):
        errs.append('none of the names match')
    namespaces = block.get('namespaces') or []
    if namespaces and not _check_namespaces(namespaces, resource):
        errs.append('namespace does not match')
    annotations = block.get('annotations') or {}
    if annotations and not check_annotations(annotations, resource.annotations):
        errs.append('annotations does not match')
    selector = block.get('selector')
    if selector is not None:
        try:
            if not check_selector(selector, resource.labels):
                errs.append('selector does not match')
        except MatchError as e:
            errs.append(f'failed to parse selector: {e}')
    ns_selector = block.get('namespaceSelector')
    if ns_selector is not None and resource.kind != 'Namespace' and resource.kind != '':
        try:
            if not check_selector(ns_selector, namespace_labels):
                errs.append('namespace selector does not match')
        except MatchError as e:
            errs.append(f'failed to parse namespace selector: {e}')
    return errs


def _check_namespaces(namespaces: List[str], resource: Resource) -> bool:
    ns = resource.namespace
    if resource.kind == 'Namespace':
        ns = resource.name
    return any(wildcard.match(n, ns) for n in namespaces)


def check_kind(kinds: List[str], resource: Resource,
               subresource_in_review: str = '',
               allow_ephemeral: bool = False,
               subresources_in_policy: Optional[List[dict]] = None) -> bool:
    """Kind matching incl. group/version prefixes and subresources
    (reference: pkg/utils/match/kind.go:14 CheckKind; the subresource
    lookup map is built per-policy from CLI values when there is no
    cluster, reference: pkg/engine/common.go:12
    GetSubresourceGVKToAPIResourceMap)."""
    for k in kinds:
        if k == '*':
            return True
        gv, kind = get_kind_from_gvk(k)
        api_resource = _subresource_api_resource(k, subresources_in_policy)
        if api_resource is not None:
            if (api_resource.get('group', '') == resource.group and
                    (api_resource.get('version', '') == resource.version or
                     '*' in gv) and
                    api_resource.get('kind', '') == resource.kind):
                return True
            continue
        from ..api.unstructured import split_subresource
        parent_kind, sub = split_subresource(kind)
        if sub:
            # cluster path for 'Parent/subresource' rule kinds: the
            # review carries the subresource name and the parent kind
            # (reference: pkg/utils/match/kind.go CheckKind resolving
            # via the discovery subresource map)
            if parent_kind == resource.kind and \
                    subresource_in_review.lower() == sub.lower():
                if not gv or group_version_matches(gv,
                                                   resource.group_version):
                    return True
            continue
        result = kind == resource.kind and (
            subresource_in_review == '' or
            (allow_ephemeral and subresource_in_review == 'ephemeralcontainers'))
        if gv:
            result = result and group_version_matches(gv, resource.group_version)
        if result:
            return True
    return False


def _subresource_api_resource(gvk_str: str,
                              subresources_in_policy: Optional[List[dict]]
                              ) -> Optional[dict]:
    """reference: pkg/engine/common.go:12 — resolve a rule kind like
    'Deployment/scale' or a standalone subresource kind like
    'PodExecOptions' against the CLI-provided subresource list."""
    if not subresources_in_policy:
        return None
    from ..api.unstructured import split_subresource
    gv, k = get_kind_from_gvk(gvk_str)
    parent_kind, subresource = split_subresource(k)
    for entry in subresources_in_policy:
        api_resource = entry.get('subresource') or entry.get('apiResource') or {}
        parent = entry.get('parentResource') or {}
        if subresource:
            parent_gv = (f"{parent.get('group')}/{parent.get('version', '')}"
                         if parent.get('group') else parent.get('version', ''))
            if gv and not group_version_matches(gv, parent_gv):
                continue
            if parent_kind != parent.get('kind'):
                continue
            name_parts = (api_resource.get('name', '') or '').split('/')
            if len(name_parts) > 1 and subresource.lower() == name_parts[1]:
                return api_resource
        else:
            if (k == api_resource.get('kind') and
                    k != parent.get('kind')):
                sub_gv = (f"{api_resource.get('group')}/"
                          f"{api_resource.get('version', '')}"
                          if api_resource.get('group')
                          else api_resource.get('version', ''))
                if gv == '' or group_version_matches(gv, sub_gv):
                    return api_resource
    return None


def check_annotations(expected: Dict[str, str], actual: Dict[str, str]) -> bool:
    # reference: pkg/utils/match/annotations.go:7
    for k, v in expected.items():
        if not any(wildcard.match(k, k1) and wildcard.match(str(v), v1)
                   for k1, v1 in actual.items()):
            return False
    return True


def check_selector(selector: dict, labels: Dict[str, str]) -> bool:
    """Kubernetes LabelSelector semantics with kyverno wildcard expansion
    (reference: pkg/utils/match/labels.go:10 CheckSelector,
    pkg/engine/wildcards/wildcards.go:14 ReplaceInSelector)."""
    match_labels = dict(selector.get('matchLabels') or {})
    # wildcard expansion: wildcard keys/values replaced by matching real ones
    expanded = {}
    for k, v in match_labels.items():
        v = str(v)
        if wildcard.contains_wildcard(k) or wildcard.contains_wildcard(v):
            replaced = False
            for k1, v1 in labels.items():
                if wildcard.match(k, k1) and wildcard.match(v, v1):
                    expanded[k1] = v1
                    replaced = True
                    break
            if not replaced:
                expanded[k.replace('*', '0').replace('?', '0')] = \
                    v.replace('*', '0').replace('?', '0')
        else:
            expanded[k] = v
    for k, v in expanded.items():
        if labels.get(k) != v:
            return False
    for expr in selector.get('matchExpressions') or []:
        key = expr.get('key', '')
        op = expr.get('operator', '')
        values = expr.get('values') or []
        if op == 'In':
            if labels.get(key) not in values:
                return False
        elif op == 'NotIn':
            if labels.get(key) in values:
                return False
        elif op == 'Exists':
            if key not in labels:
                return False
        elif op == 'DoesNotExist':
            if key in labels:
                return False
        else:
            raise MatchError(f'invalid selector operator {op!r}')
    return True


def _check_user_info(user_info: dict, admission_info: dict,
                     exclude_group_roles: List[str]) -> List[str]:
    # reference: pkg/engine/utils.go:139-160
    errs: List[str] = []
    admission_user = (admission_info or {}).get('userInfo') or {}
    keys = list(admission_user.get('groups') or []) + [admission_user.get('username', '')]
    excluded = any(k in (exclude_group_roles or []) for k in keys)
    roles = user_info.get('roles') or []
    if roles and not excluded:
        if not any(r in roles for r in (admission_info.get('roles') or [])):
            errs.append('user info does not match roles for the given conditionBlock')
    cluster_roles = user_info.get('clusterRoles') or []
    if cluster_roles and not excluded:
        if not any(r in cluster_roles for r in (admission_info.get('clusterRoles') or [])):
            errs.append('user info does not match clustersRoles for the given conditionBlock')
    subjects = user_info.get('subjects') or []
    if subjects:
        if not check_subjects(subjects, admission_user, exclude_group_roles):
            errs.append('user info does not match subject for the given conditionBlock')
    return errs


def check_subjects(rule_subjects: List[dict], user_info: dict,
                   exclude_group_roles: List[str]) -> bool:
    # reference: pkg/utils/match/subjects.go:10
    sa_prefix = 'system:serviceaccount:'
    username = user_info.get('username', '') or ''
    user_groups = list(user_info.get('groups') or []) + [username]
    subjects = list(rule_subjects)
    for e in exclude_group_roles or []:
        subjects.append({'kind': 'Group', 'name': e})
    for subject in subjects:
        kind = subject.get('kind', '')
        if kind == 'ServiceAccount':
            if len(username) <= len(sa_prefix):
                continue
            expected = f"{subject.get('namespace', '')}:{subject.get('name', '')}"
            if username[len(sa_prefix):] == expected:
                return True
        elif kind in ('User', 'Group'):
            if subject.get('name') in user_groups:
                return True
    return False
