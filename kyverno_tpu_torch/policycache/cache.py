"""Policy cache (reference: pkg/policycache/{cache,store,type}.go).

Indexes policies by (PolicyType, kind, namespace) so the admission hot
path resolves the applicable policy set with two dictionary lookups
instead of scanning every policy. Additionally keyed on the compiled
TPU artifact: the cache invalidation hook is where the batch evaluator's
compiled-program table gets rebuilt on policy change.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set

from ..api.policy import Policy, Rule
from ..api.unstructured import get_kind_from_gvk, split_subresource
from ..autogen.autogen import compute_rules
from ..utils.wildcard import check_patterns

# PolicyType (reference: pkg/policycache/type.go)
MUTATE = 'Mutate'
VALIDATE_ENFORCE = 'ValidateEnforce'
VALIDATE_AUDIT = 'ValidateAudit'
GENERATE = 'Generate'
VERIFY_IMAGES_MUTATE = 'VerifyImagesMutate'
VERIFY_IMAGES_VALIDATE = 'VerifyImagesValidate'

_ALL_TYPES = (MUTATE, VALIDATE_ENFORCE, VALIDATE_AUDIT, GENERATE,
              VERIFY_IMAGES_MUTATE, VERIFY_IMAGES_VALIDATE)


def _compute_kind(gvk: str) -> str:
    """reference: store.go:70 computeKind"""
    _, k = get_kind_from_gvk(gvk)
    kind, _ = split_subresource(k)
    return kind


def _is_enforce(action) -> bool:
    """'Enforce' plus the deprecated lowercase 'enforce'
    (reference: api/kyverno/v1/spec_types.go:29 Enforce())."""
    return action in ('Enforce', 'enforce')


def _compute_enforce(policy: Policy) -> bool:
    """reference: store.go:76 computeEnforcePolicy"""
    if _is_enforce(policy.validation_failure_action):
        return True
    return any(_is_enforce(o.get('action'))
               for o in policy.validation_failure_action_overrides)


def _check_overrides(enforce: bool, ns: str, policy: Policy) -> bool:
    """reference: cache.go:78 checkValidationFailureActionOverrides"""
    action_enforce = _is_enforce(policy.validation_failure_action)
    overrides = policy.validation_failure_action_overrides
    if action_enforce != enforce and (not ns or not overrides):
        return False
    for override in overrides:
        override_enforce = _is_enforce(override.get('action'))
        if override_enforce != enforce and \
                check_patterns(override.get('namespaces') or [], ns):
            return False
    return True


class Cache:
    """reference: pkg/policycache/cache.go:9 Cache"""

    def __init__(self,
                 on_change: Optional[Callable[[], None]] = None):
        self._lock = threading.RLock()
        self._policies: Dict[str, Policy] = {}
        # kind -> PolicyType -> set of policy keys
        self._kind_type: Dict[str, Dict[str, Set[str]]] = {}
        self._on_change = on_change

    # -- writes --------------------------------------------------------------

    def set(self, key: str, policy: Policy) -> None:
        """reference: store.go:95 policyMap.set"""
        with self._lock:
            self._unset_locked(key)
            self._policies[key] = policy
            enforce = _compute_enforce(policy)
            kind_states: Dict[str, dict] = {}
            for raw_rule in compute_rules(policy):
                rule = Rule(raw_rule)
                for gvk in self._match_kinds(rule):
                    kind = _compute_kind(gvk)
                    entry = kind_states.setdefault(kind, {
                        'mutate': False, 'validate': False,
                        'generate': False, 'verify_images': False,
                        'verify_images_validate': False})
                    entry['mutate'] |= rule.has_mutate()
                    entry['validate'] |= rule.has_validate()
                    entry['generate'] |= rule.has_generate()
                    entry['verify_images'] |= rule.has_verify_images()
                    entry['verify_images_validate'] |= any(
                        iv.get('verifyDigest', True) or
                        iv.get('required', True)
                        for iv in rule.verify_images)
            for kind, state in kind_states.items():
                buckets = self._kind_type.setdefault(
                    kind, {t: set() for t in _ALL_TYPES})
                self._apply(buckets[MUTATE], key, state['mutate'])
                self._apply(buckets[VALIDATE_ENFORCE], key,
                            state['validate'] and enforce)
                self._apply(buckets[VALIDATE_AUDIT], key,
                            state['validate'] and not enforce)
                self._apply(buckets[GENERATE], key, state['generate'])
                self._apply(buckets[VERIFY_IMAGES_MUTATE], key,
                            state['verify_images'])
                self._apply(buckets[VERIFY_IMAGES_VALIDATE], key,
                            state['verify_images'] and
                            state['verify_images_validate'])
        if self._on_change:
            self._on_change()

    @staticmethod
    def _match_kinds(rule: Rule) -> List[str]:
        # match-block kinds only (reference store.go:101 iterates
        # rule.MatchResources.GetKinds()); exclude kinds never index
        kinds: List[str] = []
        block = rule.match
        res = block.get('resources') or {}
        kinds.extend(res.get('kinds') or [])
        for f in (block.get('any') or []) + (block.get('all') or []):
            kinds.extend((f.get('resources') or {}).get('kinds') or [])
        return kinds

    @staticmethod
    def _apply(bucket: Set[str], key: str, value: bool) -> None:
        if value:
            bucket.add(key)
        else:
            bucket.discard(key)

    def unset(self, key: str) -> None:
        with self._lock:
            self._unset_locked(key)
        if self._on_change:
            self._on_change()

    def _unset_locked(self, key: str) -> None:
        self._policies.pop(key, None)
        for buckets in self._kind_type.values():
            for bucket in buckets.values():
                bucket.discard(key)

    # -- reads ---------------------------------------------------------------

    def get_policies(self, policy_type: str, kind: str,
                     namespace: str = '') -> List[Policy]:
        """reference: cache.go:38 GetPolicies"""
        with self._lock:
            result = self._get(policy_type, kind, '')
            result += self._get(policy_type, '*', '')
            if namespace:
                result += self._get(policy_type, kind, namespace)
                result += self._get(policy_type, '*', namespace)
            if policy_type == VALIDATE_AUDIT:
                result += self._get(VALIDATE_ENFORCE, kind, '')
                result += self._get(VALIDATE_ENFORCE, '*', '')
        if policy_type in (VALIDATE_AUDIT, VALIDATE_ENFORCE):
            enforce = policy_type == VALIDATE_ENFORCE
            result = [p for p in result
                      if _check_overrides(enforce, namespace, p)]
        return result

    def _get(self, policy_type: str, gvk: str, namespace: str
             ) -> List[Policy]:
        """reference: store.go:149 policyMap.get"""
        kind = _compute_kind(gvk)
        out = []
        for key in sorted(self._kind_type.get(kind, {})
                          .get(policy_type, ())):
            ns = key.split('/', 1)[0] if '/' in key else ''
            policy = self._policies.get(key)
            if policy is None:
                continue
            if not ns and not namespace:
                out.append(policy)
            elif ns == namespace:
                out.append(policy)
        return out

    def warm_up(self, policies: List[Policy]) -> None:
        """Bulk load; fires the recompile hook once, not per policy
        (reference: pkg/controllers/policycache/controller.go:133 WarmUp)."""
        hook, self._on_change = self._on_change, None
        try:
            for policy in policies:
                self.set(policy.get_kind_and_name(), policy)
        finally:
            self._on_change = hook
        if hook:
            hook()
