"""Generate-rule validation with permission pre-flight (reference:
pkg/policy/generate/validate.go Generate.Validate, pkg/policy/actions.go
validateActions).

Before a generate policy is admitted, the controller verifies its own
service account can create/update/get/delete the target kinds — each
probe is a SelfSubjectAccessReview (``auth.CanI``).  Offline contexts
(CLI apply/test) use :class:`~..auth.FakeAuth`, mirroring the
reference's mock mode (actions.go:53).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..auth import Auth, FakeAuth
from ..auth.auth import is_variable
from ..utils.wildcard import contains_wildcard

_PERM_HINT = ("Update permissions in ClusterRole 'kyverno:generate'")


class GenerateValidator:
    """reference: pkg/policy/generate/validate.go:19 Generate."""

    def __init__(self, generation: dict, auth=None):
        self.rule = generation or {}
        self.auth = auth if auth is not None else FakeAuth()

    def validate(self) -> Tuple[str, Optional[str]]:
        """Returns (path, error-message) — error None means valid
        (reference: validate.go:40 Validate)."""
        rule = self.rule
        clone = rule.get('clone') or {}
        clone_list = rule.get('cloneList') or {}
        has_data = rule.get('data') is not None
        has_clone = bool(clone)
        if has_data and has_clone:
            return '', 'only one of data or clone can be specified'
        if has_clone and clone_list.get('kinds'):
            return '', 'only one of clone or cloneList can be specified'

        kind = rule.get('kind', '')
        name = rule.get('name', '')
        namespace = rule.get('namespace', '')

        if not clone_list.get('kinds'):
            if not name:
                return 'name', 'name cannot be empty'
            if not kind:
                return 'kind', 'kind cannot be empty'
        else:
            if name:
                return 'name', \
                    'with cloneList, generate.name. should not be specified.'
            if kind:
                return 'kind', \
                    'with cloneList, generate.kind. should not be specified.'

        selector = clone_list.get('selector')
        if selector is not None and contains_wildcard(str(selector)):
            return 'selector', 'wildcard characters `*/?` not supported'

        if has_clone:
            path, err = self._validate_clone(clone, clone_list, kind)
            if err is not None:
                return f'clone.{path}' if path else 'clone', err

        if clone_list.get('kinds'):
            for gvk in clone_list['kinds']:
                # the full group/version/Kind string rides into the SSAR
                # so group-qualified kinds probe the right GVR
                err = self._can_i_generate(str(gvk), namespace)
                if err is not None:
                    return '', err
        else:
            err = self._can_i_generate(kind, namespace)
            if err is not None:
                return '', err
        return '', None

    def _validate_clone(self, clone: dict, clone_list: dict,
                        kind: str) -> Tuple[str, Optional[str]]:
        """reference: validate.go:106 validateClone — clone sources need
        'get' (and the sync sweep 'delete' on the target kind)."""
        if not clone_list.get('kinds') and not clone.get('name'):
            return 'name', 'name cannot be empty'
        namespace = clone.get('namespace', '')
        if is_variable(kind) or is_variable(namespace):
            return '', None
        if not self.auth.can_i_get(kind, namespace):
            return '', (f"kyverno does not have permissions to 'get' "
                        f'resource {kind}/{namespace}. {_PERM_HINT}')
        return '', None

    def _can_i_generate(self, kind: str, namespace: str) -> Optional[str]:
        """reference: validate.go:130 canIGenerate — create/update/get/
        delete on the target kind, skipped when either field is an
        unresolved variable."""
        from ..auth.auth import can_i_generate_error
        return can_i_generate_error(self.auth, kind, namespace)


_CLUSTER_SCOPED_KINDS = {
    'Namespace', 'Node', 'ClusterRole', 'ClusterRoleBinding',
    'CustomResourceDefinition', 'ClusterPolicy', 'PriorityClass',
    'StorageClass', 'PersistentVolume', 'ValidatingWebhookConfiguration',
    'MutatingWebhookConfiguration',
}


def _check_namespaced_generate(rule: dict, generation: dict,
                               policy_namespace: str) -> Optional[str]:
    """A namespaced Policy may only generate into its own namespace
    (reference: pkg/policy/validate.go:1115-1140)."""
    name = rule.get('name', '')
    kind = generation.get('kind', '')
    if kind and kind in _CLUSTER_SCOPED_KINDS:
        return (f'path: spec.rules[{name}]: a namespaced policy cannot '
                f'generate cluster-wide resources')
    target_ns = generation.get('namespace', '')
    if kind and not is_variable(target_ns) and \
            target_ns != policy_namespace:
        return (f'path: spec.rules[{name}]: a namespaced policy cannot '
                f'generate resources in other namespaces, expected: '
                f'{policy_namespace}, received: {target_ns}')
    clone = generation.get('clone') or {}
    if clone.get('name'):
        clone_ns = clone.get('namespace', '')
        if not is_variable(clone_ns) and clone_ns != policy_namespace:
            return (f'path: spec.rules[{name}]: a namespaced policy '
                    f'cannot clone resources to or from other '
                    f'namespaces, expected: {policy_namespace}, '
                    f'received: {clone_ns}')
    clone_list = generation.get('cloneList') or {}
    if clone_list.get('kinds'):
        cl_ns = clone_list.get('namespace', '')
        if not is_variable(cl_ns) and cl_ns != policy_namespace:
            return (f'path: spec.rules[{name}]: a namespaced policy '
                    f'cannot clone resources to or from other '
                    f'namespaces, expected: {policy_namespace}, '
                    f'received: {cl_ns}')
    return None


def validate_generate_rule(rule: dict, index: int, client=None,
                           policy_namespace: str = '') -> Optional[str]:
    """Validate one rule's generate action; returns an error string or
    None (reference: pkg/policy/actions.go:24 validateActions — mock mode
    when no client is supplied)."""
    generation = rule.get('generate')
    if generation is None:
        return None
    if policy_namespace:
        err = _check_namespaced_generate(rule, generation,
                                         policy_namespace)
        if err is not None:
            return err
    auth = Auth(client) if client is not None else FakeAuth()
    path, err = GenerateValidator(generation, auth).validate()
    if err is not None:
        prefix = f'spec.rules[{index}].generate.'
        return f'path: {prefix}{path}.: {err}' if path \
            else f'path: {prefix}: {err}'
    # reference: actions.go:65 — generating the kind the rule matches on
    # would retrigger itself
    match = rule.get('match') or {}
    match_kinds = list((match.get('resources') or {}).get('kinds') or [])
    for f in (match.get('any') or []) + (match.get('all') or []):
        match_kinds.extend((f.get('resources') or {}).get('kinds') or [])
    if generation.get('kind') and generation.get('kind') in match_kinds:
        return 'generation kind and match resource kind should not be ' \
            'the same'
    return None
