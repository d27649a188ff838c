"""Generated-resource label management (reference:
pkg/background/common/labels.go ManageLabels).
"""

from __future__ import annotations

LABEL_APP_MANAGED_BY = 'app.kubernetes.io/managed-by'
VALUE_KYVERNO_APP = 'kyverno'
GENERATED_BY_KIND = 'kyverno.io/generated-by-kind'
GENERATED_BY_NAMESPACE = 'kyverno.io/generated-by-namespace'
GENERATED_BY_NAME = 'kyverno.io/generated-by-name'
POLICY_NAME_LABEL = 'policy.kyverno.io/policy-name'
GR_NAME_LABEL = 'policy.kyverno.io/gr-name'
SYNCHRONIZE_LABEL = 'policy.kyverno.io/synchronize'
BACKGROUND_GEN_RULE_LABEL = 'kyverno.io/background-gen-rule'


def manage_labels(resource: dict, trigger: dict) -> None:
    """Stamp managed-by + generated-by-* labels onto a generated resource
    (reference: labels.go:23 ManageLabels). An existing foreign managed-by
    value is left untouched."""
    meta = resource.setdefault('metadata', {})
    labels = meta.setdefault('labels', {})
    if labels.get(LABEL_APP_MANAGED_BY, VALUE_KYVERNO_APP) == VALUE_KYVERNO_APP:
        labels[LABEL_APP_MANAGED_BY] = VALUE_KYVERNO_APP
    tmeta = trigger.get('metadata') or {}
    checks = [
        (GENERATED_BY_KIND, trigger.get('kind', '')),
        (GENERATED_BY_NAMESPACE, tmeta.get('namespace', '')),
        (GENERATED_BY_NAME, tmeta.get('name', '')),
    ]
    for key, value in checks:
        # keep at most 63 chars per label-value k8s constraint
        labels[key] = str(value)[:63]
