"""Generate-rule materialization (reference: pkg/background/generate/
generate.go).

Given a Pending UpdateRequest of type ``generate``, re-validates the
trigger against the policy, then materializes each applicable generate
rule's target: inline ``data``, ``clone`` (copy one source resource) or
``cloneList`` (copy all selector-matched resources of the listed kinds),
honoring ``synchronize`` create/update semantics and ownership labels.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

from ..api.policy import Policy, Rule
from ..api.unstructured import get_kind_from_gvk
from ..dclient.client import AlreadyExistsError, NotFoundError
from ..engine.api import RuleStatus
from ..engine.background import generate_response
from ..engine.variables import substitute_all
from .common import get_policy, get_trigger_resource, new_background_context
from .labels import (
    BACKGROUND_GEN_RULE_LABEL, GR_NAME_LABEL, POLICY_NAME_LABEL,
    SYNCHRONIZE_LABEL, manage_labels,
)
from .updaterequest import (
    STATE_COMPLETED, STATE_FAILED, UpdateRequest,
)

# ResourceMode (reference: generate.go ResourceMode)
SKIP = 'SKIP'
CREATE = 'CREATE'
UPDATE = 'UPDATE'

#: default apiVersions for generate rules that name only a kind — the
#: reference resolves these through discovery (dclient.GetResource with
#: empty apiVersion); the fake path needs the common built-ins
_DEFAULT_API_VERSIONS = {
    'ConfigMap': 'v1', 'Secret': 'v1', 'Namespace': 'v1',
    'ServiceAccount': 'v1', 'Service': 'v1', 'LimitRange': 'v1',
    'ResourceQuota': 'v1', 'Pod': 'v1',
    'Role': 'rbac.authorization.k8s.io/v1',
    'RoleBinding': 'rbac.authorization.k8s.io/v1',
    'ClusterRole': 'rbac.authorization.k8s.io/v1',
    'ClusterRoleBinding': 'rbac.authorization.k8s.io/v1',
    'NetworkPolicy': 'networking.k8s.io/v1',
    'Deployment': 'apps/v1',
    'PodDisruptionBudget': 'policy/v1',
}


class GenerateResponseItem:
    __slots__ = ('data', 'action', 'name', 'kind', 'namespace',
                 'api_version', 'error')

    def __init__(self, data=None, action=SKIP, name='', kind='',
                 namespace='', api_version='', error=None):
        self.data = data
        self.action = action
        self.name = name
        self.kind = kind
        self.namespace = namespace
        self.api_version = api_version
        self.error = error


class GenerateController:
    """reference: pkg/background/generate/generate.go:61"""

    def __init__(self, client, engine, policy_getter=None):
        self.client = client
        self.engine = engine
        # policy_getter(policy_key) -> Policy; defaults to the client store
        self.policy_getter = policy_getter or (
            lambda key: get_policy(client, key))
        # permission pre-flight results, keyed (kind, namespace) with a
        # short TTL: RBAC changes live (the shipped ClusterRoles are
        # aggregated), so both a cached denial after the admin grants
        # the permission and a cached allow after revocation must age out
        self._auth_cache: Dict[Tuple[str, str],
                               Tuple[float, Optional[str]]] = {}
        self._auth_ttl = float(
            __import__('os').environ.get('KTPU_AUTH_TTL', '60'))

    def _check_generate_auth(self, kind: str, namespace: str
                             ) -> Optional[str]:
        """SSAR pre-flight before applying a generate target: create/
        update/get/delete on the target kind (reference:
        pkg/policy/generate/auth.go Operations + validate.go:130
        canIGenerate — enforced here so a permission lost after policy
        admission still fails the UR instead of erroring mid-apply)."""
        import time as _time
        from ..auth import Auth
        from ..auth.auth import can_i_generate_error
        if not kind:
            return None
        key = (kind, namespace)
        hit = self._auth_cache.get(key)
        now = _time.monotonic()
        if hit is not None and now - hit[0] < self._auth_ttl:
            return hit[1]
        try:
            err = can_i_generate_error(Auth(self.client), kind, namespace)
        except AttributeError:
            # client without an access-review surface (bare test doubles):
            # behave like the reference with full RBAC
            err = None
        self._auth_cache[key] = (now, err)
        return err

    # -- UR processing -------------------------------------------------------

    def process_ur(self, ur: UpdateRequest) -> Optional[Exception]:
        """reference: generate.go:92 ProcessUR"""
        try:
            trigger = get_trigger_resource(self.client, ur)
        except NotFoundError as err:
            ur.set_status(STATE_FAILED, str(err))
            return err
        if trigger is None:
            # DELETE with no recoverable trigger: clean up downstream
            self._delete_downstream(ur)
            ur.set_status(STATE_COMPLETED)
            return None
        try:
            generated, err = self._apply_generate(trigger, ur)
        except Exception as exc:  # noqa: BLE001 — status captures the failure
            ur.set_status(STATE_FAILED, str(exc))
            return exc
        existing = {self._spec_key(g) for g in ur.generated_resources}
        merged = ur.generated_resources + [
            g for g in generated if self._spec_key(g) not in existing]
        if err is not None:
            # record partial creations so they remain cleanable
            # (reference: generate.go updateStatus → statusControl.Failed
            # with genResources)
            ur.set_status(STATE_FAILED, str(err), generated=merged)
            return err
        ur.set_status(STATE_COMPLETED, generated=merged)
        return None

    @staticmethod
    def _spec_key(g: dict) -> Tuple[str, str, str, str]:
        return (g.get('apiVersion', ''), g.get('kind', ''),
                g.get('namespace', ''), g.get('name', ''))

    def _apply_generate(self, trigger: dict, ur: UpdateRequest
                        ) -> Tuple[List[dict], Optional[Exception]]:
        """reference: generate.go:178 applyGenerate"""
        policy = self.policy_getter(ur.policy_key)
        pctx = new_background_context(self.client, ur, policy, trigger)
        resp = generate_response(self.engine, pctx, ur.raw)
        applicable = []
        failed_match = False
        for rr in resp.policy_response.rules:
            if rr.status == RuleStatus.PASS:
                applicable.append(rr.name)
            elif rr.status == RuleStatus.FAIL:
                failed_match = True
        if not applicable:
            if failed_match:
                # the old resource matched but the new one doesn't: the
                # trigger moved out of scope — delete downstream targets
                # (reference: generate.go:206-217)
                self._delete_downstream(ur)
            return [], None
        return self.apply_generate_policy(pctx, ur, applicable)

    def apply_generate_policy(self, pctx, ur: UpdateRequest,
                              applicable_rules: List[str]
                              ) -> Tuple[List[dict], Optional[Exception]]:
        """reference: generate.go:311 ApplyGeneratePolicy"""
        policy = pctx.policy
        gen_resources: List[dict] = []
        apply_rules = policy.apply_rules
        apply_count = 0
        for raw_rule in self.engine._compute_rules(policy):
            rule = Rule(raw_rule)
            if not rule.has_generate():
                continue
            if rule.name not in applicable_rules:
                continue
            if apply_rules == 'One' and apply_count > 0:
                break
            ctx = pctx.json_context
            ctx.checkpoint()
            try:
                self.engine.context_loader.load(rule.context, ctx,
                                                policy_name=policy.name,
                                                rule_name=rule.name)
                substituted = Rule(substitute_all(ctx, raw_rule))
                created = self._apply_rule(substituted, pctx.new_resource,
                                           policy, ur)
            except Exception as exc:  # noqa: BLE001
                return gen_resources, exc
            finally:
                ctx.restore()
            gen_resources.extend(created)
            apply_count += 1
        return gen_resources, None

    # -- single rule ---------------------------------------------------------

    def _apply_rule(self, rule: Rule, trigger: dict, policy: Policy,
                    ur: UpdateRequest) -> List[dict]:
        """reference: generate.go:414 applyRule"""
        gen = rule.generation
        clone = gen.get('clone') or {}
        clone_list = gen.get('cloneList') or {}
        items: List[GenerateResponseItem] = []

        kind = gen.get('kind', '')
        name = gen.get('name', '')
        namespace = gen.get('namespace', '')
        api_version = gen.get('apiVersion', '') or \
            _DEFAULT_API_VERSIONS.get(kind, '')
        if not clone_list.get('kinds'):
            if not kind:
                raise ValueError('generate kind can not be empty')
            if not name:
                raise ValueError('generate name can not be empty')
            auth_err = self._check_generate_auth(kind, namespace)
        else:
            auth_err = None
            for gvk in clone_list['kinds']:
                # the full group/version/Kind string rides into the SSAR
                # so group-qualified kinds probe the right GVR
                auth_err = self._check_generate_auth(str(gvk), namespace)
                if auth_err:
                    break
        if auth_err:
            raise PermissionError(auth_err)

        if clone.get('name'):
            data, mode, err = self._manage_clone(
                api_version, kind, namespace, name, clone,
                bool(gen.get('synchronize')), ur)
            items.append(GenerateResponseItem(
                data, mode, name, kind, namespace, api_version, err))
        elif clone_list.get('kinds'):
            items = self._manage_clone_list(namespace, clone_list,
                                            bool(gen.get('synchronize')), ur)
        else:
            data, mode, err = self._manage_data(
                api_version, kind, namespace, name, gen.get('data'),
                bool(gen.get('synchronize')), ur)
            items.append(GenerateResponseItem(
                data, mode, name, kind, namespace, api_version, err))

        created: List[dict] = []
        for item in items:
            if item.error is not None:
                raise item.error
            if item.action == SKIP:
                continue
            if item.data is None and item.action == UPDATE:
                continue
            new_resource = copy.deepcopy(item.data) or {}
            meta = new_resource.setdefault('metadata', {})
            meta['name'] = item.name
            if item.namespace:
                meta['namespace'] = item.namespace
            elif 'namespace' in meta:
                del meta['namespace']
            if not new_resource.get('kind'):
                new_resource['kind'] = item.kind
            if item.api_version:
                new_resource['apiVersion'] = item.api_version
            manage_labels(new_resource, trigger)
            labels = meta.setdefault('labels', {})
            if _is_generate_existing(policy):
                labels[BACKGROUND_GEN_RULE_LABEL] = rule.name
            labels[POLICY_NAME_LABEL] = policy.name
            labels[GR_NAME_LABEL] = ur.name
            if clone.get('name') or clone_list.get('kinds'):
                # cloned targets carry the cloning policy's name
                # (reference: pkg/background/common/labels.go
                # GenerateLabelsSet clone path)
                labels['generate.kyverno.io/clone-policy-name'] = \
                    policy.name
            synchronize = bool(rule.generation.get('synchronize'))
            if item.action == CREATE:
                labels[SYNCHRONIZE_LABEL] = 'enable' if synchronize else 'disable'
                meta.pop('resourceVersion', None)
                try:
                    self.client.create_resource(
                        new_resource.get('apiVersion', item.api_version),
                        new_resource.get('kind', item.kind),
                        item.namespace, new_resource)
                except AlreadyExistsError:
                    pass
                created.append(_resource_spec(item))
            elif item.action == UPDATE:
                created.extend(self._update_target(
                    item, new_resource, labels, synchronize))
        return created

    def _update_target(self, item: GenerateResponseItem, new_resource: dict,
                       labels: dict, synchronize: bool) -> List[dict]:
        try:
            generated = self.client.get_resource(
                item.api_version, item.kind, item.namespace, item.name)
        except NotFoundError:
            self.client.create_resource(
                new_resource.get('apiVersion', item.api_version),
                new_resource.get('kind', item.kind),
                item.namespace, new_resource)
            return [_resource_spec(item)]
        if synchronize:
            labels[SYNCHRONIZE_LABEL] = 'enable'
            meta = new_resource.setdefault('metadata', {})
            meta['resourceVersion'] = (generated.get('metadata') or {}) \
                .get('resourceVersion', '')
            if not _subset_matches(generated, new_resource):
                self.client.update_resource(
                    new_resource.get('apiVersion', item.api_version),
                    new_resource.get('kind', item.kind),
                    item.namespace, new_resource)
        else:
            # synchronize is off here; downgrade a stale 'enable' marker
            cur_labels = ((generated.get('metadata') or {})
                          .setdefault('labels', {}))
            if cur_labels.get(SYNCHRONIZE_LABEL) == 'enable':
                cur_labels[SYNCHRONIZE_LABEL] = 'disable'
                self.client.update_resource(
                    generated.get('apiVersion', item.api_version),
                    generated.get('kind', item.kind),
                    item.namespace, generated)
        return []

    # -- data / clone / cloneList --------------------------------------------

    def _manage_data(self, api_version, kind, namespace, name, data,
                     synchronize, ur):
        """reference: generate.go:594 manageData"""
        if data is None:
            resource = None
        elif not isinstance(data, dict):
            return None, SKIP, TypeError('generate.data must be an object')
        else:
            resource = copy.deepcopy(data)
        try:
            existing = self.client.get_resource(api_version, kind, namespace, name)
        except NotFoundError:
            if ur.generated_resources and not synchronize:
                return None, SKIP, None
            if resource is None:
                return None, SKIP, None
            return resource, CREATE, None
        if data is None:
            return None, SKIP, None
        resource.setdefault('metadata', {})['resourceVersion'] = \
            (existing.get('metadata') or {}).get('resourceVersion', '')
        return resource, UPDATE, None

    def _manage_clone(self, api_version, kind, namespace, name, clone,
                      synchronize, ur):
        """reference: generate.go:626 manageClone"""
        src_ns = clone.get('namespace', '')
        src_name = clone.get('name', '')
        if not src_name:
            return None, SKIP, ValueError('failed to find source name')
        if src_ns == namespace and src_name == name:
            return None, SKIP, None  # self-clone
        try:
            src = self.client.get_resource(api_version, kind, src_ns, src_name)
        except NotFoundError as err:
            return None, SKIP, NotFoundError(
                f'source resource {api_version} {kind}/{src_ns}/{src_name} '
                f'not found. {err}')
        try:
            target = self.client.get_resource(api_version, kind, namespace, name)
        except NotFoundError:
            target = None
            if ur.generated_resources and not synchronize:
                return None, SKIP, None
        if src_ns != namespace:
            (src.get('metadata') or {}).pop('ownerReferences', None)
        if target is not None:
            src_meta = src.setdefault('metadata', {})
            tgt_meta = target.get('metadata') or {}
            for field in ('uid', 'selfLink', 'creationTimestamp',
                          'managedFields', 'resourceVersion'):
                if field in tgt_meta:
                    src_meta[field] = tgt_meta[field]
                else:
                    src_meta.pop(field, None)
            src_cmp = copy.deepcopy(src)
            (src_cmp.get('metadata') or {})['name'] = tgt_meta.get('name', '')
            (src_cmp.get('metadata') or {})['namespace'] = \
                tgt_meta.get('namespace', '')
            if src_cmp == target:
                return None, SKIP, None
            return src, UPDATE, None
        return src, CREATE, None

    def _manage_clone_list(self, namespace, clone_list, synchronize, ur
                           ) -> List[GenerateResponseItem]:
        """reference: generate.go:681 manageCloneList"""
        out: List[GenerateResponseItem] = []
        src_ns = clone_list.get('namespace', '')
        kinds = clone_list.get('kinds') or []
        selector = clone_list.get('selector')
        if not kinds:
            return [GenerateResponseItem(
                error=ValueError('failed to find kinds list'))]
        for gvk in kinds:
            api_version, kind = get_kind_from_gvk(gvk)
            sources = self.client.list_resource(
                api_version, kind, src_ns, selector)
            for src in sources:
                src_name = (src.get('metadata') or {}).get('name', '')
                data, mode, err = self._manage_clone(
                    api_version or src.get('apiVersion', ''), kind,
                    namespace, src_name,
                    {'namespace': src_ns, 'name': src_name},
                    synchronize, ur)
                out.append(GenerateResponseItem(
                    data, mode, src_name, kind, namespace,
                    api_version or src.get('apiVersion', ''), err))
        return out

    # -- cleanup -------------------------------------------------------------

    def _delete_downstream(self, ur: UpdateRequest) -> None:
        """reference: generate.go:848 deleteGeneratedResources — deletes the
        targets recorded in UR status, and additionally locates downstream
        resources by the ownership labels stamped at creation time (a fresh
        UR for a retired trigger has an empty status list)."""
        for g in ur.generated_resources:
            try:
                self.client.delete_resource(
                    g.get('apiVersion', ''), g.get('kind', ''),
                    g.get('namespace', ''), g.get('name', ''))
            except NotFoundError:
                pass
        from .labels import (
            GENERATED_BY_KIND, GENERATED_BY_NAME, GENERATED_BY_NAMESPACE,
        )
        trigger = ur.resource
        policy_name = ur.policy_key.split('/')[-1]
        selector = {'matchLabels': {
            POLICY_NAME_LABEL: policy_name,
            GENERATED_BY_KIND: trigger.get('kind', '')[:63],
            GENERATED_BY_NAMESPACE: trigger.get('namespace', '')[:63],
            GENERATED_BY_NAME: trigger.get('name', '')[:63],
        }}
        for obj in self.client.list_resource('', '', '', selector):
            meta = obj.get('metadata') or {}
            try:
                self.client.delete_resource(
                    obj.get('apiVersion', ''), obj.get('kind', ''),
                    meta.get('namespace', ''), meta.get('name', ''))
            except NotFoundError:
                pass

    def cleanup_cloned_resource(self, target_spec: dict) -> None:
        """Delete a generated resource on trigger delete unless it carries
        data the user owns (reference: generate.go:242
        cleanupClonedResource — only deletes when generated by clone and
        synchronize is enabled via the label)."""
        try:
            target = self.client.get_resource(
                target_spec.get('apiVersion', ''), target_spec.get('kind', ''),
                target_spec.get('namespace', ''), target_spec.get('name', ''))
        except NotFoundError:
            return
        labels = ((target.get('metadata') or {}).get('labels') or {})
        if labels.get(SYNCHRONIZE_LABEL) == 'enable':
            self.client.delete_resource(
                target_spec.get('apiVersion', ''), target_spec.get('kind', ''),
                target_spec.get('namespace', ''), target_spec.get('name', ''))


def _is_generate_existing(policy: Policy) -> bool:
    """reference: spec_types.go IsGenerateExistingOnPolicyUpdate"""
    v = policy.spec.get('generateExistingOnPolicyUpdate')
    return bool(v)


def _resource_spec(item: GenerateResponseItem) -> dict:
    return {'apiVersion': item.api_version, 'kind': item.kind,
            'namespace': item.namespace, 'name': item.name}


def _subset_matches(existing: dict, desired: dict) -> bool:
    """True when every field of ``desired`` already equals ``existing``
    (reference: generate.go ValidateResourceWithPattern gate before
    update)."""
    if isinstance(desired, dict):
        if not isinstance(existing, dict):
            return False
        return all(k in existing and _subset_matches(existing[k], v)
                   for k, v in desired.items())
    if isinstance(desired, list):
        if not isinstance(existing, list) or len(existing) != len(desired):
            return False
        return all(_subset_matches(e, d) for e, d in zip(existing, desired))
    return existing == desired


def materialize_rule_offline(raw_rule: dict, pctx,
                             clone_source: Optional[dict] = None
                             ) -> Optional[dict]:
    """Materialize one generate rule's target without a cluster — the CLI
    `test`/`apply` path (reference: cmd/cli/kubectl-kyverno/utils/common/
    generate.go handleGeneratePolicy, which runs the generate controller
    against a fake client seeded with CloneSourceResource)."""
    ctx = pctx.json_context
    ctx.checkpoint()
    try:
        rule = Rule(substitute_all(ctx, raw_rule))
    finally:
        ctx.restore()
    gen = rule.generation
    kind = gen.get('kind', '')
    name = gen.get('name', '')
    namespace = gen.get('namespace', '')
    api_version = gen.get('apiVersion', '')
    clone = gen.get('clone') or {}
    if clone.get('name'):
        if clone_source is None:
            raise ValueError(
                f'no clone source for generate rule {rule.name}')
        data = copy.deepcopy(clone_source)
        (data.get('metadata') or {}).pop('creationTimestamp', None)
        (data.get('metadata') or {}).pop('resourceVersion', None)
        (data.get('metadata') or {}).pop('uid', None)
    elif gen.get('data') is not None:
        data = copy.deepcopy(gen.get('data')) or {}
    elif (gen.get('cloneList') or {}).get('kinds'):
        raise ValueError(
            f'generate rule {rule.name} uses cloneList, which needs cluster '
            'access; provide cloneSourceResource per target instead')
    else:
        return None
    meta = data.setdefault('metadata', {})
    meta['name'] = name
    if namespace:
        meta['namespace'] = namespace
    else:
        meta.pop('namespace', None)
    if not data.get('kind'):
        data['kind'] = kind
    if api_version and not data.get('apiVersion'):
        data['apiVersion'] = api_version
    manage_labels(data, pctx.new_resource)
    return data
