"""AdmissionReview protocol helpers + PolicyContext construction.

Mirrors the reference's admission utilities
(reference: pkg/utils/admission/response.go, pkg/webhooks/utils/
policy_context_builder.go:57) for the K8s admission webhook protocol:
requests arrive as AdmissionReview JSON, responses carry uid / allowed /
status.message / JSONPatch (base64) / warnings.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Callable, Dict, List, Optional

from ..engine.api import PolicyContext


def parse_review(body: dict) -> dict:
    """Extract the AdmissionRequest from an AdmissionReview document."""
    request = body.get('request')
    if not isinstance(request, dict):
        raise ValueError('admission review without request')
    return request


def review_response(request: dict, response: dict) -> dict:
    """Wrap an AdmissionResponse in the review envelope the API server
    expects (same apiVersion/kind as the request review)."""
    return {
        'apiVersion': 'admission.k8s.io/v1',
        'kind': 'AdmissionReview',
        'response': response,
    }


def response(uid: str, allowed: bool = True, message: str = '',
             warnings: Optional[List[str]] = None) -> dict:
    """reference: pkg/utils/admission/response.go:11 Response"""
    out: Dict[str, Any] = {'uid': uid, 'allowed': allowed}
    if message:
        out['status'] = {'message': message}
    if warnings:
        out['warnings'] = warnings
    return out


def mutation_response(uid: str, patches: List[dict],
                      warnings: Optional[List[str]] = None) -> dict:
    """reference: pkg/utils/admission/response.go:30 MutationResponse"""
    out = response(uid, True, '', warnings)
    if patches:
        raw = json.dumps(patches, separators=(',', ':')).encode('utf-8')
        out['patch'] = base64.b64encode(raw).decode('ascii')
        out['patchType'] = 'JSONPatch'
    return out


def decode_patch(resp: dict) -> List[dict]:
    """Decode the base64 JSONPatch of an AdmissionResponse (tests)."""
    if 'patch' not in resp:
        return []
    return json.loads(base64.b64decode(resp['patch']))


def request_resource(request: dict) -> dict:
    obj = request.get('object')
    return obj if isinstance(obj, dict) else {}


def request_old_resource(request: dict) -> dict:
    obj = request.get('oldObject')
    return obj if isinstance(obj, dict) else {}


class PolicyContextBuilder:
    """Builds a PolicyContext from an AdmissionRequest
    (reference: pkg/webhooks/utils/policy_context_builder.go:57).

    ``role_resolver`` maps (username, groups) → (roles, cluster_roles) —
    the reference resolves these through RBAC listers
    (pkg/userinfo/roleRef.go:25); injectable so serving stays hermetic.
    """

    def __init__(self, configuration=None,
                 role_resolver: Optional[Callable] = None,
                 exception_lister: Optional[Callable] = None):
        self.configuration = configuration
        self.role_resolver = role_resolver
        self.exception_lister = exception_lister

    def build(self, request: dict, policy=None) -> PolicyContext:
        user_info = request.get('userInfo') or {}
        roles: List[str] = []
        cluster_roles: List[str] = []
        if self.role_resolver is not None:
            roles, cluster_roles = self.role_resolver(
                user_info.get('username', ''), user_info.get('groups') or [])
        admission_info = {
            'roles': roles,
            'clusterRoles': cluster_roles,
            'userInfo': user_info,
        }
        exclude_group_roles: List[str] = []
        if self.configuration is not None:
            exclude_group_roles = list(
                self.configuration.get_exclude_group_role())
        exceptions = None
        if self.exception_lister is not None:
            exceptions = list(self.exception_lister())
        new = request_resource(request)
        old = request_old_resource(request)
        operation = request.get('operation', '')
        ctx = PolicyContext(
            policy, new_resource=new, old_resource=old,
            admission_info=admission_info,
            exclude_group_roles=exclude_group_roles,
            exceptions=exceptions,
            admission_operation=operation,
            subresource=request.get('subResource', ''))
        ctx.json_context.add_user_info({
            'userInfo': user_info, 'roles': roles,
            'clusterRoles': cluster_roles})
        if request.get('namespace'):
            ctx.json_context.add_namespace(request['namespace'])
        # the `images.` context variable is available to every rule
        # (reference: NewPolicyContextFromAdmissionRequest →
        # AddImageInfos; mutate foreach preconditions rely on it)
        from ..engine.image_verify import _add_resource_images
        _add_resource_images(ctx)
        return ctx
