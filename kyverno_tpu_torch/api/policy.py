"""Policy API types.

Policies are kept as unstructured dicts (the same representation the engine
substitutes variables into) wrapped in light accessor classes mirroring the
reference CRD fields (reference: api/kyverno/v1/policy_types.go:136,
spec_types.go:49, rule_types.go:40).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, List, Optional

import yaml

POD_CONTROLLERS_ANNOTATION = 'pod-policies.kyverno.io/autogen-controllers'


class Rule:
    __slots__ = ('raw',)

    def __init__(self, raw: dict):
        self.raw = raw or {}

    @property
    def name(self) -> str:
        return self.raw.get('name', '') or ''

    @property
    def match(self) -> dict:
        return self.raw.get('match') or {}

    @property
    def exclude(self) -> dict:
        return self.raw.get('exclude') or {}

    @property
    def context(self) -> List[dict]:
        return self.raw.get('context') or []

    @property
    def preconditions(self) -> Any:
        return self.raw.get('preconditions')

    @property
    def validation(self) -> dict:
        return self.raw.get('validate') or {}

    @property
    def mutation(self) -> dict:
        return self.raw.get('mutate') or {}

    @property
    def generation(self) -> dict:
        return self.raw.get('generate') or {}

    @property
    def verify_images(self) -> List[dict]:
        return self.raw.get('verifyImages') or []

    def has_validate(self) -> bool:
        return bool(self.raw.get('validate'))

    def has_mutate(self) -> bool:
        return bool(self.raw.get('mutate'))

    def has_generate(self) -> bool:
        return bool(self.raw.get('generate'))

    def has_verify_images(self) -> bool:
        return bool(self.raw.get('verifyImages'))

    def has_validate_pod_security(self) -> bool:
        return bool(self.validation.get('podSecurity'))

    def copy(self) -> 'Rule':
        return Rule(copy.deepcopy(self.raw))

    def get_any_all_conditions(self) -> Any:
        return self.preconditions


class Policy:
    """ClusterPolicy or (namespaced) Policy."""

    __slots__ = ('raw',)

    def __init__(self, raw: dict):
        self.raw = raw or {}

    @property
    def api_version(self) -> str:
        return self.raw.get('apiVersion', '') or ''

    @property
    def kind(self) -> str:
        return self.raw.get('kind', '') or ''

    @property
    def metadata(self) -> dict:
        return self.raw.get('metadata') or {}

    @property
    def name(self) -> str:
        return self.metadata.get('name', '') or ''

    @property
    def namespace(self) -> str:
        return self.metadata.get('namespace', '') or ''

    @property
    def annotations(self) -> Dict[str, str]:
        return {str(k): str(v) for k, v in (self.metadata.get('annotations') or {}).items()}

    @property
    def is_namespaced(self) -> bool:
        return self.kind == 'Policy'

    @property
    def spec(self) -> dict:
        return self.raw.get('spec') or {}

    @property
    def rules(self) -> List[Rule]:
        return [Rule(r) for r in self.spec.get('rules') or []]

    @property
    def validation_failure_action(self) -> str:
        # reference: api/kyverno/v1/spec_types.go ValidationFailureAction
        return self.spec.get('validationFailureAction', 'Audit') or 'Audit'

    @property
    def validation_failure_action_overrides(self) -> List[dict]:
        return self.spec.get('validationFailureActionOverrides') or []

    @property
    def background(self) -> bool:
        v = self.spec.get('background')
        return True if v is None else bool(v)

    @property
    def failure_policy(self) -> str:
        return self.spec.get('failurePolicy', 'Fail') or 'Fail'

    @property
    def webhook_timeout_seconds(self) -> Optional[int]:
        return self.spec.get('webhookTimeoutSeconds')

    @property
    def apply_rules(self) -> str:
        return self.spec.get('applyRules', 'All') or 'All'

    @property
    def schema_validation(self) -> bool:
        v = self.spec.get('schemaValidation')
        return True if v is None else bool(v)

    def get_kind_and_name(self) -> str:
        if self.namespace:
            return f'{self.namespace}/{self.name}'
        return self.name

    def copy(self) -> 'Policy':
        return Policy(copy.deepcopy(self.raw))


def load_policies_from_yaml(text: str) -> List[Policy]:
    """Load every ClusterPolicy/Policy document from a YAML string."""
    out = []
    for doc in yaml.safe_load_all(text):
        if not isinstance(doc, dict):
            continue
        if is_kyverno_policy(doc):
            out.append(Policy(doc))
        elif doc.get('kind') == 'List':
            for item in doc.get('items') or []:
                if isinstance(item, dict) and is_kyverno_policy(item):
                    out.append(Policy(item))
    return out


def is_kyverno_policy(doc: dict) -> bool:
    """True only for kyverno.io Policy/ClusterPolicy — other API groups
    also use the kind name ``Policy`` (e.g. config.kio.kasten.io)."""
    if doc.get('kind') not in ('ClusterPolicy', 'Policy'):
        return False
    api_version = doc.get('apiVersion') or 'kyverno.io/v1'
    return api_version.startswith('kyverno.io/')


def load_resources_from_yaml(text: str) -> List[dict]:
    """Load every non-policy Kubernetes document from a YAML string."""
    out = []
    for doc in yaml.safe_load_all(text):
        if not isinstance(doc, dict) or not doc.get('kind'):
            continue
        if doc.get('kind') == 'List':
            out.extend(i for i in doc.get('items') or [] if isinstance(i, dict))
        else:
            out.append(doc)
    return out
