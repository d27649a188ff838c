"""Autogen: rewrite Pod rules for pod controllers.

Re-implements the reference's autogen expansion
(reference: pkg/autogen/autogen.go:280 ComputeRules, rule.go):

* Pod rules are cloned as ``autogen-<name>`` rules targeting
  DaemonSet/Deployment/Job/StatefulSet/ReplicaSet/ReplicationController with
  patterns re-rooted under ``spec.template`` and as ``autogen-cronjob-<name>``
  rules re-rooted under ``spec.jobTemplate.spec.template``
* controlled by the ``pod-policies.kyverno.io/autogen-controllers`` annotation
* JMESPath references inside messages/variables are shifted the same way the
  reference does (string replacement on the serialized rule).
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any, List, Optional, Tuple

from ..api.policy import POD_CONTROLLERS_ANNOTATION, Policy
from ..api.unstructured import contains_kind

POD_CONTROLLER_CRONJOB = 'CronJob'
POD_CONTROLLERS = 'DaemonSet,Deployment,Job,StatefulSet,ReplicaSet,ReplicationController,CronJob'
_POD_CONTROLLERS_SET = set(POD_CONTROLLERS.split(',')) | {'Pod'}
_NON_CRONJOB = 'DaemonSet,Deployment,Job,StatefulSet,ReplicaSet,ReplicationController'


def _is_kind_other_than_pod(kinds: List[str]) -> bool:
    return len(kinds) > 1 and contains_kind(kinds, 'Pod')


def _check_autogen_support(state: dict, *subjects: dict) -> bool:
    for subject in subjects:
        subject = subject or {}
        if (subject.get('name') or subject.get('names') or
                subject.get('selector') is not None or
                subject.get('annotations') is not None or
                _is_kind_other_than_pod(subject.get('kinds') or [])):
            return False
        state['needed'] = state['needed'] or any(
            k in _POD_CONTROLLERS_SET for k in subject.get('kinds') or [])
    return True


def _strip_cronjob(controllers: str) -> str:
    out = [c for c in controllers.split(',') if c != POD_CONTROLLER_CRONJOB]
    return ','.join(out)


def can_auto_gen(spec: dict) -> Tuple[bool, str]:
    """reference: pkg/autogen/autogen.go:70 CanAutoGen"""
    state = {'needed': False}
    for rule in spec.get('rules') or []:
        mutate = rule.get('mutate') or {}
        if mutate.get('patchesJson6902') or rule.get('generate'):
            return False, 'none'
        match = rule.get('match') or {}
        exclude = rule.get('exclude') or {}
        if not _check_autogen_support(state, match.get('resources') or {},
                                      exclude.get('resources') or {}):
            return False, ''
        for block in (match.get('any') or []) + (match.get('all') or []) + \
                     (exclude.get('any') or []) + (exclude.get('all') or []):
            if not _check_autogen_support(state, block.get('resources') or {}):
                return False, ''
    if not state['needed']:
        return False, ''
    return True, POD_CONTROLLERS


def get_requested_controllers(metadata: dict) -> Optional[List[str]]:
    annotations = (metadata or {}).get('annotations') or {}
    controllers = annotations.get(POD_CONTROLLERS_ANNOTATION)
    if not controllers:
        return None
    if controllers == 'none':
        return []
    return controllers.split(',')


def get_supported_controllers(spec: dict) -> Optional[List[str]]:
    apply_autogen, controllers = can_auto_gen(spec)
    if not apply_autogen or controllers == 'none':
        return None
    return controllers.split(',')


def get_controllers(metadata: dict, spec: dict):
    """Return (requested, supported, activated)
    (reference: pkg/autogen/autogen.go:139 GetControllers)."""
    supported = get_supported_controllers(spec) or []
    requested = get_requested_controllers(metadata)
    if requested is None:
        return requested, supported, supported
    activated = [c for c in supported if c in requested]
    return requested, supported, activated


def compute_rules(policy: Policy) -> List[dict]:
    """Expand a policy's rules with autogen rules
    (reference: pkg/autogen/autogen.go:284 computeRules)."""
    spec = policy.spec
    apply_autogen, desired = can_auto_gen(spec)
    if not apply_autogen:
        desired = 'none'
    actual = policy.annotations.get(POD_CONTROLLERS_ANNOTATION)
    if actual is None or not apply_autogen:
        actual = desired
    if actual == 'none':
        return copy.deepcopy(spec.get('rules') or [])
    gen_rules = _generate_rules(copy.deepcopy(spec), actual)
    if not gen_rules:
        return copy.deepcopy(spec.get('rules') or [])
    out = [copy.deepcopy(r) for r in spec.get('rules') or []
           if not _is_autogen_name(r.get('name', ''))]
    out.extend(gen_rules)
    return out


def _generate_rules(spec: dict, controllers: str) -> List[dict]:
    rules = []
    for rule in spec.get('rules') or []:
        gen = _generate_rule_for_controllers(rule, _strip_cronjob(controllers))
        if gen is not None:
            rules.append(_convert_rule(gen, 'Pod'))
        cron = _generate_cronjob_rule(rule, controllers)
        if cron is not None:
            rules.append(_convert_rule(cron, 'Cronjob'))
    return rules


def _is_autogen_name(name: str) -> bool:
    return name.startswith('autogen-')


def _autogen_rule_name(prefix: str, name: str) -> str:
    name = f'{prefix}-{name}'
    return name[:63]


def _replace_kinds_in_filters(filters: List[dict], match: str,
                              kinds: List[str]) -> List[dict]:
    out = copy.deepcopy(filters)
    for f in out:
        res = f.get('resources') or {}
        if contains_kind(res.get('kinds') or [], match):
            res['kinds'] = list(kinds)
    return out


def _generate_rule_for_controllers(rule: dict, controllers: str) -> Optional[dict]:
    # reference: pkg/autogen/rule.go:228
    if _is_autogen_name(rule.get('name', '')) or controllers == '':
        return None
    match = rule.get('match') or {}
    exclude = rule.get('exclude') or {}
    match_kinds = _get_kinds(match)
    exclude_kinds = _get_kinds(exclude)
    if not contains_kind(match_kinds, 'Pod') or \
            (exclude_kinds and not contains_kind(exclude_kinds, 'Pod')):
        return None
    valid = [c for c in controllers.split(',')
             if c in _NON_CRONJOB.split(',')] if controllers not in ('all', 'none') else []
    if controllers == 'all':
        controllers = _NON_CRONJOB
    elif valid:
        controllers = ','.join(valid)
    return _generate_rule(
        _autogen_rule_name('autogen', rule.get('name', '')),
        rule, 'template', 'spec/template', controllers.split(','), 'Pod')


def _generate_cronjob_rule(rule: dict, controllers: str) -> Optional[dict]:
    # reference: pkg/autogen/rule.go:281
    if POD_CONTROLLER_CRONJOB not in controllers and 'all' not in controllers:
        return None
    base = _generate_rule_for_controllers(rule, controllers)
    if base is None:
        return None
    return _generate_rule(
        _autogen_rule_name('autogen-cronjob', rule.get('name', '')),
        base, 'jobTemplate', 'spec/jobTemplate/spec/template',
        [POD_CONTROLLER_CRONJOB], 'Job')


def _get_kinds(match: dict) -> List[str]:
    kinds = list((match.get('resources') or {}).get('kinds') or [])
    for f in (match.get('any') or []) + (match.get('all') or []):
        kinds.extend((f.get('resources') or {}).get('kinds') or [])
    return kinds


def _generate_rule(name: str, rule: dict, tpl_key: str, shift: str,
                   kinds: List[str], filter_match: str) -> Optional[dict]:
    # reference: pkg/autogen/rule.go:73 generateRule
    rule = copy.deepcopy(rule)
    rule['name'] = name
    match = rule.get('match') or {}
    if match.get('any'):
        match['any'] = _replace_kinds_in_filters(match['any'], filter_match, kinds)
    elif match.get('all'):
        match['all'] = _replace_kinds_in_filters(match['all'], filter_match, kinds)
    else:
        match.setdefault('resources', {})['kinds'] = list(kinds)
    rule['match'] = match
    exclude = rule.get('exclude') or {}
    if exclude.get('any'):
        exclude['any'] = _replace_kinds_in_filters(exclude['any'], filter_match, kinds)
        rule['exclude'] = exclude
    elif exclude.get('all'):
        exclude['all'] = _replace_kinds_in_filters(exclude['all'], filter_match, kinds)
        rule['exclude'] = exclude
    elif (exclude.get('resources') or {}).get('kinds'):
        exclude['resources']['kinds'] = list(kinds)
        rule['exclude'] = exclude

    mutate = rule.get('mutate') or {}
    validate = rule.get('validate') or {}

    if mutate.get('patchStrategicMerge') is not None:
        rule['mutate'] = {'patchStrategicMerge': {
            'spec': {tpl_key: mutate['patchStrategicMerge']}}}
        return rule
    if mutate.get('foreach'):
        new_foreach = []
        for fe in mutate['foreach']:
            entry = {k: v for k, v in fe.items()
                     if k in ('list', 'context', 'preconditions')}
            entry['patchStrategicMerge'] = {
                'spec': {tpl_key: fe.get('patchStrategicMerge')}}
            new_foreach.append(entry)
        rule['mutate'] = {'foreach': new_foreach}
        return rule
    if validate.get('pattern') is not None:
        rule['validate'] = {
            'message': find_and_shift_references(
                validate.get('message', ''), shift, 'pattern'),
            'pattern': {'spec': {tpl_key: validate['pattern']}},
        }
        return rule
    if validate.get('deny') is not None:
        rule['validate'] = {
            'message': find_and_shift_references(
                validate.get('message', ''), shift, 'deny'),
            'deny': validate['deny'],
        }
        return rule
    if validate.get('podSecurity') is not None:
        rule['validate'] = {
            'message': find_and_shift_references(
                validate.get('message', ''), shift, 'podSecurity'),
            'podSecurity': copy.deepcopy(validate['podSecurity']),
        }
        return rule
    if validate.get('anyPattern') is not None:
        patterns = [{'spec': {tpl_key: p}} for p in validate['anyPattern']]
        rule['validate'] = {
            'message': find_and_shift_references(
                validate.get('message', ''), shift, 'anyPattern'),
            'anyPattern': patterns,
        }
        return rule
    if validate.get('foreach'):
        rule['validate'] = {
            'message': find_and_shift_references(
                validate.get('message', ''), shift, 'pattern'),
            'foreach': copy.deepcopy(validate['foreach']),
        }
        return rule
    if rule.get('verifyImages'):
        return rule
    return None


def _convert_rule(rule: dict, kind: str) -> dict:
    """Re-root JMESPath references via JSON string replacement
    (reference: pkg/autogen/autogen.go:238 convertRule)."""
    raw = json.dumps(rule)
    validate = rule.get('validate') or {}
    if validate.get('podSecurity') is not None:
        if kind == 'Pod':
            raw = raw.replace('"restrictedField":"spec',
                              '"restrictedField":"spec.template.spec')
        if kind == 'Cronjob':
            raw = raw.replace('"restrictedField":"spec',
                              '"restrictedField":"spec.jobTemplate.spec.template.spec')
        raw = raw.replace('metadata', 'spec.template.metadata')
    else:
        if kind == 'Pod':
            raw = raw.replace('request.object.spec',
                              'request.object.spec.template.spec')
        if kind == 'Cronjob':
            raw = raw.replace('request.object.spec',
                              'request.object.spec.jobTemplate.spec.template.spec')
        raw = raw.replace('request.object.metadata',
                          'request.object.spec.template.metadata')
    return json.loads(raw)


_REFERENCES_RE = re.compile(r'\$\(.[^\ ]*\)')


def find_and_shift_references(value: str, shift: str, pivot: str) -> str:
    """Shift $(...) references past the re-rooted prefix
    (reference: pkg/engine/variables/vars.go:517 FindAndShiftReferences)."""
    if not value:
        return value
    for m in list(_REFERENCES_RE.finditer(value)):
        reference = m.group(0)
        idx = reference.find(pivot)
        if idx == -1:
            continue
        local_pivot = pivot
        if pivot == 'anyPattern':
            rule_index = reference[idx + len(pivot) + 1:].split('/')[0]
            local_pivot = f'{pivot}/{rule_index}'
        shifted = reference.replace(local_pivot, f'{local_pivot}/{shift}')
        value = value.replace(reference, shifted, 1)
    return value
