"""CLI engine harness: values files, mock context loader, apply loop.

Reference: cmd/cli/kubectl-kyverno/utils/common/common.go — notably
``ApplyPolicyOnResource`` (common.go:371): build a JSON context from the
resource + values-file variables, then run mutate → validate →
verifyImages → generate against a single (policy, resource) pair.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Tuple

import yaml

from ..api.policy import (Policy, load_policies_from_yaml,
                          load_resources_from_yaml)
from ..autogen.autogen import compute_rules
from ..engine.api import EngineResponse, PolicyContext, RuleStatus
from ..engine.context import Context, ContextError, InvalidVariableError
from ..engine.engine import ContextLoader, Engine
from ..utils.image_extract import extract_images_from_resource
from .store import Store, get_store


class MockContextLoader(ContextLoader):
    """Loads per-rule variables from the CLI store instead of the cluster
    (reference: pkg/engine/jsonContext.go:88 mockContextLoader.Load)."""

    def __init__(self, store: Optional[Store] = None,
                 configmap_resolver=None, api_call=None, image_data=None):
        super().__init__(configmap_resolver=configmap_resolver,
                         api_call=api_call, image_data=image_data)
        self.store = store or get_store()

    def load(self, entries: List[dict], ctx: Context,
             policy_name: str = '', rule_name: str = '') -> None:
        rule_values = self.store.get_policy_rule(policy_name, rule_name)
        if rule_values:
            for key, value in rule_values.items():
                ctx.add_variable(key, value)
        for entry in entries:
            name = entry.get('name', '')
            if entry.get('imageRegistry') is not None:
                if self.store.registry_access and self.image_data is not None:
                    data = self.image_data(entry, ctx)
                    ctx.add_context_entry(name, data)
            elif entry.get('variable') is not None:
                self._load_variable(entry, ctx)
            elif entry.get('apiCall') is not None:
                if self.store.allow_api_calls:
                    if self.api_call is None:
                        raise ContextError(
                            f'failed to load context entry {name}: '
                            'no API client')
                    ctx.add_context_entry(name, self.api_call(entry, ctx))
            elif entry.get('configMap') is not None:
                if self.configmap_resolver is not None:
                    self._load_configmap(entry, ctx)
        foreach = self.store.get_foreach_values(policy_name, rule_name)
        if foreach:
            for key, values in foreach.items():
                ctx.add_variable(key, values[self.store.foreach_element])


class Values:
    """Parsed values file (reference: common.go:59 Values struct)."""

    def __init__(self, raw: Optional[dict] = None):
        raw = raw or {}
        self.policies: List[dict] = raw.get('policies') or []
        self.global_values: Dict[str, Any] = raw.get('globalValues') or {}
        self.namespace_selectors: List[dict] = \
            raw.get('namespaceSelector') or []
        self.subresources: List[dict] = raw.get('subresources') or []

    def namespace_selector_map(self) -> Dict[str, Dict[str, str]]:
        return {s.get('name', ''): s.get('labels') or {}
                for s in self.namespace_selectors}

    def resource_values(self, policy: str, resource: str) -> Dict[str, Any]:
        """Per-(policy, resource) variables (reference: common.go:300
        variables resolution in GetVariable)."""
        for p in self.policies:
            if p.get('name') != policy:
                continue
            for r in p.get('resources') or []:
                if r.get('name') == resource:
                    return dict(r.get('values') or {})
        return {}


def load_values(path: str) -> Values:
    with open(path, encoding='utf-8') as f:
        return Values(yaml.safe_load(f) or {})


def load_user_info(path: str) -> dict:
    """Load a RequestInfo YAML (reference:
    cmd/cli/kubectl-kyverno/utils/common/fetch.go GetUserInfoFromPath)."""
    with open(path, encoding='utf-8') as f:
        doc = yaml.safe_load(f) or {}
    user_info = doc.get('userInfo') or {}
    subject = doc.get('subject') or {}
    if subject and not user_info.get('username'):
        # reference: store.SetSubject + engine/utils.go:164 matchSubjects
        # mock — translate the subject into the equivalent username
        if subject.get('kind') == 'ServiceAccount':
            user_info['username'] = (
                f"system:serviceaccount:{subject.get('namespace', '')}:"
                f"{subject.get('name', '')}")
        elif subject.get('kind') in ('User', 'Group'):
            user_info['username'] = subject.get('name', '')
    return {
        'roles': doc.get('roles') or [],
        'clusterRoles': doc.get('clusterRoles') or [],
        'userInfo': user_info,
    }


def load_policies_from_paths(paths: List[str]) -> List[Policy]:
    out: List[Policy] = []
    for path in paths:
        if os.path.isdir(path):
            for entry in sorted(os.listdir(path)):
                if entry.endswith(('.yaml', '.yml', '.json')):
                    out.extend(load_policies_from_paths(
                        [os.path.join(path, entry)]))
            continue
        with open(path, encoding='utf-8') as f:
            loaded = load_policies_from_yaml(f.read())
        # reference: pkg/utils/yaml/loadpolicy.go:66 — namespaced Policy
        # defaults to "default"; ClusterPolicy namespace is cleared
        for policy in loaded:
            meta = policy.raw.setdefault('metadata', {})
            if policy.kind == 'Policy':
                if not meta.get('namespace'):
                    meta['namespace'] = 'default'
            else:
                meta.pop('namespace', None)
        out.extend(loaded)
    return out


def load_resources_from_paths(paths: List[str]) -> List[dict]:
    out: List[dict] = []
    for path in paths:
        if os.path.isdir(path):
            for entry in sorted(os.listdir(path)):
                if entry.endswith(('.yaml', '.yml', '.json')):
                    out.extend(load_resources_from_paths(
                        [os.path.join(path, entry)]))
            continue
        with open(path, encoding='utf-8') as f:
            docs = load_resources_from_yaml(f.read())
        from ..api.policy import is_kyverno_policy
        for doc in docs:
            if is_kyverno_policy(doc):
                continue
            # reference: fetch.go:310 — CLI resources default to "default"
            meta = doc.setdefault('metadata', {})
            if not meta.get('namespace'):
                meta['namespace'] = 'default'
            out.append(doc)
    return out


def _policy_uses_namespace_selector(policy: Policy) -> bool:
    # reference: common.go:381-412
    for rule in compute_rules(policy):
        match = rule.get('match') or {}
        exclude = rule.get('exclude') or {}
        for block in (match, exclude):
            if (block.get('resources') or {}).get('namespaceSelector'):
                return True
            for clause in (block.get('any') or []) + (block.get('all') or []):
                if (clause.get('resources') or {}).get('namespaceSelector'):
                    return True
    return False


class ApplyResult:
    def __init__(self):
        self.engine_responses: List[EngineResponse] = []
        self.patched_resource: Optional[dict] = None
        self.generated_resources: List[dict] = []


def apply_policy_on_resource(
        policy: Policy,
        resource: dict,
        engine: Optional[Engine] = None,
        variables: Optional[Dict[str, Any]] = None,
        user_info: Optional[dict] = None,
        namespace_selector_map: Optional[Dict[str, Dict[str, str]]] = None,
        subresource: str = '',
        rule_to_clone_source: Optional[Dict[str, dict]] = None,
        exceptions: Optional[List[dict]] = None,
        subresources: Optional[List[dict]] = None,
) -> ApplyResult:
    """reference: common.go:371 ApplyPolicyOnResource."""
    engine = engine or Engine(context_loader=MockContextLoader())
    variables = dict(variables or {})
    # reference: common.go:287 — request.operation defaults to CREATE
    if not variables.get('request.operation'):
        variables['request.operation'] = 'CREATE'
    out = ApplyResult()

    namespace_labels: Dict[str, str] = {}
    if _policy_uses_namespace_selector(policy):
        ns = (resource.get('metadata') or {}).get('namespace') or ''
        namespace_labels = (namespace_selector_map or {}).get(ns, {})

    operation_is_delete = variables.get('request.operation') == 'DELETE'

    ctx = Context()
    if operation_is_delete:
        ctx.add_old_resource(resource)
    else:
        ctx.add_resource(resource)
    for key, value in variables.items():
        ctx.add_variable(key, value)
    try:
        infos = extract_images_from_resource(resource)
        if infos:
            ctx.add_image_infos(
                {name: {k: i.to_dict() for k, i in group.items()}
                 for name, group in infos.items()})
    except Exception:  # noqa: BLE001 — kinds without extractors
        pass

    admission_info = user_info or {}
    pctx = PolicyContext(
        policy,
        new_resource=resource if not operation_is_delete else {},
        old_resource=resource if operation_is_delete else {},
        admission_info=admission_info,
        namespace_labels=namespace_labels,
        json_context=ctx,
        subresource=subresource,
        exceptions=exceptions or [],
        admission_operation=variables.get('request.operation', ''),
        subresources_in_policy=subresources or [],
    )
    if admission_info.get('userInfo'):
        ctx.add_user_info({'userInfo': admission_info['userInfo']})
        username = (admission_info['userInfo'] or {}).get('username', '')
        if username:
            ctx.add_service_account(username)

    has_mutate = any(r.get('mutate') for r in compute_rules(policy))
    patched = resource
    mutate_resp = None
    if has_mutate:
        mutate_resp = engine.mutate(pctx)
        out.engine_responses.append(mutate_resp)
        if mutate_resp.patched_resource is not None:
            patched = mutate_resp.patched_resource
    out.patched_resource = patched

    has_validate = any(r.get('validate') for r in compute_rules(policy))
    pctx = pctx.copy()
    pctx.new_resource = patched if not operation_is_delete else {}
    if not operation_is_delete:
        ctx.add_resource(patched)
    if has_validate:
        out.engine_responses.append(engine.validate(pctx))

    has_verify_images = any(r.get('verifyImages')
                            for r in compute_rules(policy))
    if has_verify_images:
        vresp, _ = engine.verify_and_patch_images(pctx)
        if not vresp.is_empty():
            out.engine_responses.append(vresp)

    has_generate = any(r.get('generate') for r in compute_rules(policy))
    if has_generate:
        gen_resp = engine.filter_background_rules(pctx)
        _simulate_generation(gen_resp, pctx, rule_to_clone_source or {})
        if not gen_resp.is_empty():
            out.engine_responses.append(gen_resp)
            for r in gen_resp.policy_response.rules:
                if r.generated_resource:
                    out.generated_resources.append(r.generated_resource)
    return out


def _simulate_generation(resp: EngineResponse, pctx: PolicyContext,
                         rule_to_clone_source: Dict[str, dict]) -> None:
    """Materialize generate-rule targets offline
    (reference: cmd/cli/kubectl-kyverno/utils/common/generate.go
    handleGeneratePolicy — runs the generate controller with a fake client
    seeded from CloneSourceResource)."""
    from ..background.generate import materialize_rule_offline
    for rule_resp in resp.policy_response.rules:
        if rule_resp.status != RuleStatus.PASS:
            continue
        raw_rule = None
        for r in compute_rules(pctx.policy):
            if r.get('name') == rule_resp.name and r.get('generate'):
                raw_rule = r
                break
        if raw_rule is None:
            continue
        try:
            generated = materialize_rule_offline(
                raw_rule, pctx,
                rule_to_clone_source.get(rule_resp.name))
            if generated is not None:
                rule_resp.generated_resource = generated
        except Exception as exc:  # noqa: BLE001
            rule_resp.status = RuleStatus.ERROR
            rule_resp.message = f'failed to generate resource: {exc}'
