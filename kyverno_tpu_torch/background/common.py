"""Shared background-context construction (reference:
pkg/background/common/context.go NewBackgroundContext,
pkg/background/common/resource.go GetResource).
"""

from __future__ import annotations

from typing import Optional

from ..api.policy import Policy
from ..dclient.client import NotFoundError
from ..engine.api import PolicyContext
from ..engine.context import Context
from .updaterequest import UpdateRequest


def get_policy(client, policy_key: str) -> Policy:
    """Resolve a UR's policy key (``ns/name`` for namespaced Policy, bare
    name for ClusterPolicy) from the store (reference:
    pkg/background/generate/generate.go:267 getPolicySpec)."""
    from ..dclient.client import NotFoundError
    if '/' in policy_key:
        ns, name = policy_key.split('/', 1)
        kind = 'Policy'
    else:
        ns, name, kind = '', policy_key, 'ClusterPolicy'
    # policy CRDs serve multiple versions; the store holds whichever the
    # manifest used
    for api_version in ('kyverno.io/v1', 'kyverno.io/v2beta1', ''):
        try:
            return Policy(client.get_resource(api_version, kind, ns, name))
        except NotFoundError:
            continue
    raise NotFoundError(f'{kind} "{policy_key}" not found')


def get_trigger_resource(client, ur: UpdateRequest) -> Optional[dict]:
    """reference: pkg/background/common/resource.go:16 GetResource —
    resolves the trigger from the cluster; a trigger deleted (or already
    terminating) yields None, signalling the caller to skip processing
    (generate then cleans up downstream targets)."""
    res = ur.resource
    namespace = res.get('namespace', '')
    if res.get('kind') == 'Namespace':
        namespace = ''
    try:
        trigger = client.get_resource(res.get('apiVersion', ''),
                                      res.get('kind', ''),
                                      namespace, res.get('name', ''))
    except NotFoundError:
        req = ur.admission_request or {}
        if ur.operation == 'DELETE' or req.get('operation') == 'DELETE':
            return None
        raise
    meta = trigger.get('metadata') or {}
    if meta.get('deletionTimestamp'):
        return None  # trigger is terminating
    return trigger


def new_background_context(client, ur: UpdateRequest, policy: Policy,
                           trigger: Optional[dict]) -> PolicyContext:
    """reference: pkg/background/common/context.go NewBackgroundContext"""
    ctx = Context()
    if trigger:
        ctx.add_resource(trigger)
    user_info = ur.user_info
    if user_info:
        ctx.add_user_info(user_info)
        username = ((user_info.get('userInfo') or {}).get('username')
                    or user_info.get('username') or '')
        if username:
            ctx.add_service_account(username)
    req = ur.admission_request
    if req:
        ctx.add_request(req)
        old = req.get('oldObject')
        if isinstance(old, dict) and old:
            ctx.add_old_resource(old)
    ns = (trigger.get('metadata') or {}).get('namespace', '') if trigger else ''
    ctx.add_namespace(ns)
    ns_labels = client.get_namespace_labels(ns) if ns else {}
    pctx = PolicyContext(
        policy=policy,
        new_resource=trigger or {},
        old_resource=(req or {}).get('oldObject')
        if isinstance((req or {}).get('oldObject'), dict) else None,
        admission_info=user_info or None,
        namespace_labels=ns_labels,
        json_context=ctx,
    )
    return pctx
