"""Engine API types: PolicyContext, EngineResponse, RuleResponse, RuleStatus.

Mirrors the reference engine API (reference: pkg/engine/api/policycontext.go:24,
engineresponse.go:13, ruleresponse.go:23, rulestatus.go).
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, Optional

from ..api.policy import Policy, Rule
from ..api.unstructured import Resource
from .context import Context


class RuleStatus:
    PASS = 'pass'
    FAIL = 'fail'
    SKIP = 'skip'
    ERROR = 'error'
    WARN = 'warn'


class RuleType:
    VALIDATION = 'Validation'
    MUTATION = 'Mutation'
    GENERATION = 'Generation'
    IMAGE_VERIFY = 'ImageVerify'


class RuleResponse:
    def __init__(self, name: str, rule_type: str, message: str, status: str,
                 patches: Optional[List[dict]] = None,
                 generated_resource: Optional[dict] = None,
                 patched_target: Optional[dict] = None,
                 pod_security_checks: Optional[dict] = None):
        self.name = name
        self.rule_type = rule_type
        self.message = message
        self.status = status
        self.patches = patches or []
        self.generated_resource = generated_resource
        self.patched_target = patched_target
        self.pod_security_checks = pod_security_checks
        self.processing_time: float = 0.0
        self.timestamp: int = 0

    def __repr__(self):
        return (f'RuleResponse(name={self.name!r}, status={self.status!r}, '
                f'message={self.message!r})')

    def to_dict(self) -> dict:
        out = {
            'name': self.name,
            'ruleType': self.rule_type,
            'message': self.message,
            'status': self.status,
        }
        if self.patches:
            out['patches'] = self.patches
        if self.generated_resource:
            out['generatedResource'] = self.generated_resource
        if self.pod_security_checks:
            out['podSecurityChecks'] = self.pod_security_checks
        return out


class PolicyResponse:
    def __init__(self):
        self.rules: List[RuleResponse] = []
        self.rules_applied_count = 0
        self.rules_error_count = 0
        self.processing_time: float = 0.0
        self.timestamp: int = 0
        self.validation_failure_action = 'Audit'
        self.validation_failure_action_overrides: List[dict] = []
        self.policy_name = ''
        self.policy_namespace = ''
        self.resource_name = ''
        self.resource_namespace = ''
        self.resource_kind = ''
        self.resource_api_version = ''


class EngineResponse:
    def __init__(self, policy: Optional[Policy] = None,
                 patched_resource: Optional[dict] = None):
        self.policy = policy
        self.patched_resource = patched_resource
        self.policy_response = PolicyResponse()
        self.namespace_labels: Dict[str, str] = {}

    def is_successful(self) -> bool:
        return not any(r.status in (RuleStatus.FAIL, RuleStatus.ERROR)
                       for r in self.policy_response.rules)

    def is_failed(self) -> bool:
        return any(r.status == RuleStatus.FAIL
                   for r in self.policy_response.rules)

    def is_error(self) -> bool:
        return any(r.status == RuleStatus.ERROR
                   for r in self.policy_response.rules)

    def is_empty(self) -> bool:
        return len(self.policy_response.rules) == 0

    def get_failed_rules(self) -> List[str]:
        return [r.name for r in self.policy_response.rules
                if r.status in (RuleStatus.FAIL, RuleStatus.ERROR)]

    def get_successful_rules(self) -> List[str]:
        return [r.name for r in self.policy_response.rules
                if r.status == RuleStatus.PASS]

    def get_validation_failure_action(self) -> str:
        """Resolve enforce/audit with namespace overrides
        (reference: pkg/engine/api/engineresponse.go:107)."""
        from ..utils import wildcard
        from .match import check_selector
        for override in self.policy_response.validation_failure_action_overrides:
            action = override.get('action', '')
            if action.lower() not in ('enforce', 'audit'):
                continue
            ns_selector = override.get('namespaceSelector')
            if ns_selector is not None:
                try:
                    if not check_selector(ns_selector, self.namespace_labels):
                        continue
                except Exception:
                    continue
                if not override.get('namespaces'):
                    return action
            for ns in override.get('namespaces') or []:
                if wildcard.match(ns, self.policy_response.resource_namespace):
                    return action
        return self.policy_response.validation_failure_action


class PolicyContext:
    """Everything the engine needs for one (policy, resource) evaluation
    (reference: pkg/engine/policyContext.go)."""

    def __init__(self, policy: Policy,
                 new_resource: Optional[dict] = None,
                 old_resource: Optional[dict] = None,
                 admission_info: Optional[dict] = None,
                 namespace_labels: Optional[Dict[str, str]] = None,
                 exclude_group_roles: Optional[List[str]] = None,
                 json_context: Optional[Context] = None,
                 exceptions: Optional[List[dict]] = None,
                 admission_operation: str = '',
                 subresource: str = '',
                 element: Optional[dict] = None,
                 subresources_in_policy: Optional[List[dict]] = None):
        self.policy = policy
        self.new_resource = new_resource or {}
        self.old_resource = old_resource or {}
        self.admission_info = admission_info or {}
        self.namespace_labels = namespace_labels or {}
        self.exclude_group_roles = exclude_group_roles or []
        self.exceptions = exceptions or []
        self.admission_operation = admission_operation
        self.subresource = subresource
        self.element = element
        # CLI-only: subresource declarations from the values file
        # (reference: pkg/engine/policyContext.go WithSubresourcesInPolicy)
        self.subresources_in_policy = subresources_in_policy or []
        if json_context is None:
            json_context = Context()
            if self.new_resource:
                json_context.add_resource(self.new_resource)
            if self.old_resource:
                json_context.add_old_resource(self.old_resource)
            if admission_operation:
                json_context.add_operation(admission_operation)
        self.json_context = json_context

    def copy(self) -> 'PolicyContext':
        c = PolicyContext.__new__(PolicyContext)
        c.policy = self.policy
        c.new_resource = self.new_resource
        c.old_resource = self.old_resource
        c.admission_info = self.admission_info
        c.namespace_labels = self.namespace_labels
        c.exclude_group_roles = self.exclude_group_roles
        c.exceptions = self.exceptions
        c.admission_operation = self.admission_operation
        c.subresource = self.subresource
        c.element = self.element
        c.subresources_in_policy = self.subresources_in_policy
        c.json_context = self.json_context
        return c

    def set_element(self, element: dict) -> None:
        self.element = element

    def new_resource_obj(self) -> Resource:
        return Resource(self.new_resource)

    def old_resource_obj(self) -> Resource:
        return Resource(self.old_resource)

    def find_exceptions(self, rule_name: str) -> List[dict]:
        """Return PolicyException candidates for (policy, rule)
        (reference: pkg/engine/policyContext.go FindExceptions)."""
        out = []
        policy_key = self.policy.get_kind_and_name()
        for ex in self.exceptions:
            for match_ex in (ex.get('spec') or {}).get('exceptions') or []:
                if match_ex.get('policyName') == policy_key and \
                        rule_name in (match_ex.get('ruleNames') or []):
                    out.append(ex)
                    break
        return out
