"""UpdateRequest CR model + generator (reference:
api/kyverno/v1beta1/updaterequest_types.go,
pkg/webhooks/updaterequest/generator.go).
"""

from __future__ import annotations

import copy
import itertools
from typing import Dict, List, Optional

UR_MUTATE = 'mutate'
UR_GENERATE = 'generate'

STATE_PENDING = 'Pending'
STATE_FAILED = 'Failed'
STATE_COMPLETED = 'Completed'
STATE_SKIP = 'Skip'

# reference: api/kyverno/v1beta1/constants.go
UR_GENERATE_POLICY_LABEL = 'generate.kyverno.io/policy-name'
UR_GENERATE_RESOURCE_NAME_LABEL = 'generate.kyverno.io/resource-name'
UR_GENERATE_RESOURCE_NS_LABEL = 'generate.kyverno.io/resource-namespace'
UR_GENERATE_RESOURCE_KIND_LABEL = 'generate.kyverno.io/resource-kind'
UR_MUTATE_POLICY_LABEL = 'mutate.updaterequest.kyverno.io/policy-name'
UR_MUTATE_TRIGGER_NAME_LABEL = 'mutate.updaterequest.kyverno.io/trigger-name'
UR_MUTATE_TRIGGER_NS_LABEL = 'mutate.updaterequest.kyverno.io/trigger-namespace'
UR_MUTATE_TRIGGER_KIND_LABEL = 'mutate.updaterequest.kyverno.io/trigger-kind'
UR_MUTATE_TRIGGER_APIVERSION_LABEL = 'mutate.updaterequest.kyverno.io/trigger-apiversion'

KYVERNO_NAMESPACE = 'kyverno'

_counter = itertools.count(1)


class UpdateRequest:
    """Accessor wrapper over an unstructured UpdateRequest."""

    __slots__ = ('raw',)

    def __init__(self, raw: dict):
        self.raw = raw or {}

    @property
    def name(self) -> str:
        return (self.raw.get('metadata') or {}).get('name', '')

    @property
    def spec(self) -> dict:
        return self.raw.get('spec') or {}

    @property
    def type(self) -> str:
        return self.spec.get('requestType', '')

    @property
    def policy_key(self) -> str:
        return self.spec.get('policy', '')

    @property
    def resource(self) -> dict:
        """Trigger resource spec {apiVersion, kind, namespace, name}."""
        return self.spec.get('resource') or {}

    @property
    def user_info(self) -> dict:
        return ((self.spec.get('context') or {}).get('userInfo') or {})

    @property
    def admission_request(self) -> Optional[dict]:
        info = (self.spec.get('context') or {}).get('admissionRequestInfo') or {}
        return info.get('admissionRequest')

    @property
    def operation(self) -> str:
        info = (self.spec.get('context') or {}).get('admissionRequestInfo') or {}
        return info.get('operation', '')

    @property
    def status(self) -> dict:
        return self.raw.get('status') or {}

    @property
    def state(self) -> str:
        return self.status.get('state', '')

    @property
    def generated_resources(self) -> List[dict]:
        return self.status.get('generatedResources') or []

    def set_status(self, state: str, message: str = '',
                   generated: Optional[List[dict]] = None) -> None:
        status = self.raw.setdefault('status', {})
        status['state'] = state
        if message:
            status['message'] = message
        elif 'message' in status:
            del status['message']
        if generated is not None:
            status['generatedResources'] = generated


def generate_labels_set(policy_key: str, trigger: Optional[dict]) -> Dict[str, str]:
    """reference: pkg/background/common/labels.go GenerateLabelsSet"""
    policy_name = policy_key.split('/')[-1]
    labels = {UR_GENERATE_POLICY_LABEL: policy_name}
    if trigger:
        meta = trigger.get('metadata') or {}
        labels[UR_GENERATE_RESOURCE_NAME_LABEL] = meta.get('name', '')
        labels[UR_GENERATE_RESOURCE_NS_LABEL] = meta.get('namespace', '')
        labels[UR_GENERATE_RESOURCE_KIND_LABEL] = trigger.get('kind', '')
    return labels


def mutate_labels_set(policy_key: str, trigger: Optional[dict]) -> Dict[str, str]:
    """reference: pkg/background/common/labels.go MutateLabelsSet"""
    policy_name = policy_key.split('/')[-1]
    labels = {UR_MUTATE_POLICY_LABEL: policy_name}
    if trigger:
        meta = trigger.get('metadata') or {}
        labels[UR_MUTATE_TRIGGER_NAME_LABEL] = meta.get('name', '')
        labels[UR_MUTATE_TRIGGER_NS_LABEL] = meta.get('namespace', '')
        labels[UR_MUTATE_TRIGGER_KIND_LABEL] = trigger.get('kind', '')
        if trigger.get('apiVersion'):
            labels[UR_MUTATE_TRIGGER_APIVERSION_LABEL] = \
                trigger['apiVersion'].replace('/', '-')
    return labels


class UpdateRequestGenerator:
    """Creates UpdateRequest CRs in the kyverno namespace, deduplicating
    by label set (reference: pkg/webhooks/updaterequest/generator.go:42
    Apply — a pending UR with the same labels is reused)."""

    def __init__(self, client):
        self.client = client

    def apply(self, ur_spec: dict) -> dict:
        labels = (generate_labels_set if ur_spec.get('requestType') == UR_GENERATE
                  else mutate_labels_set)(
            ur_spec.get('policy', ''),
            _trigger_from_spec(ur_spec))
        existing = self.client.list_resource(
            'kyverno.io/v1beta1', 'UpdateRequest', KYVERNO_NAMESPACE,
            {'matchLabels': labels})
        for old in existing:
            state = ((old.get('status') or {}).get('state'))
            if state in (None, '', STATE_PENDING):
                old['spec'] = copy.deepcopy(ur_spec)
                old.setdefault('status', {})['state'] = STATE_PENDING
                return self.client.update_resource(
                    'kyverno.io/v1beta1', 'UpdateRequest',
                    KYVERNO_NAMESPACE, old)
        ur = {
            'apiVersion': 'kyverno.io/v1beta1',
            'kind': 'UpdateRequest',
            'metadata': {
                'generateName': 'ur-',
                'name': f'ur-{next(_counter)}',
                'namespace': KYVERNO_NAMESPACE,
                'labels': labels,
            },
            'spec': copy.deepcopy(ur_spec),
            'status': {'state': STATE_PENDING},
        }
        return self.client.create_resource(
            'kyverno.io/v1beta1', 'UpdateRequest', KYVERNO_NAMESPACE, ur)


def _trigger_from_spec(ur_spec: dict) -> Optional[dict]:
    res = ur_spec.get('resource') or {}
    if not res:
        return None
    return {
        'apiVersion': res.get('apiVersion', ''),
        'kind': res.get('kind', ''),
        'metadata': {'name': res.get('name', ''),
                     'namespace': res.get('namespace', '')},
    }


def new_ur_spec(request_type: str, policy_key: str, trigger: dict,
                user_info: Optional[dict] = None,
                admission_request: Optional[dict] = None,
                operation: str = '') -> dict:
    """Build an UpdateRequestSpec from a trigger resource."""
    meta = (trigger.get('metadata') or {})
    spec = {
        'requestType': request_type,
        'policy': policy_key,
        'resource': {
            'apiVersion': trigger.get('apiVersion', ''),
            'kind': trigger.get('kind', ''),
            'namespace': meta.get('namespace', ''),
            'name': meta.get('name', ''),
        },
        'context': {},
    }
    if user_info:
        spec['context']['userInfo'] = user_info
    if admission_request or operation:
        spec['context']['admissionRequestInfo'] = {}
        if admission_request:
            spec['context']['admissionRequestInfo']['admissionRequest'] = \
                admission_request
        if operation:
            spec['context']['admissionRequestInfo']['operation'] = operation
    return spec
