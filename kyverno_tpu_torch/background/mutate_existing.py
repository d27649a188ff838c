"""Mutate-existing processing (reference: pkg/background/mutate/mutate.go).

Applies mutate rules carrying ``targets:`` to already-admitted cluster
resources when a trigger event fires.
"""

from __future__ import annotations

import json
from typing import List, Optional

from ..api.policy import Policy, Rule
from ..engine.api import PolicyContext, RuleStatus
from ..engine.background import is_mutate_existing
from ..engine.context import Context
from ..dclient.client import NotFoundError
from ..engine.variables import substitute_all
from .common import get_policy, get_trigger_resource, new_background_context
from .updaterequest import STATE_COMPLETED, STATE_FAILED, UpdateRequest

MUTATE_LAST_APPLIED_ANNOTATION = 'policies.kyverno.io/last-applied-patches'


class MutateExistingController:
    """reference: pkg/background/mutate/mutate.go:46"""

    def __init__(self, client, engine, policy_getter=None):
        self.client = client
        self.engine = engine
        self.policy_getter = policy_getter or (
            lambda key: get_policy(client, key))

    def process_ur(self, ur: UpdateRequest) -> Optional[Exception]:
        """reference: mutate.go:73 ProcessUR"""
        errs: List[str] = []
        try:
            policy = self.policy_getter(ur.policy_key)
        except Exception as exc:  # noqa: BLE001
            ur.set_status(STATE_FAILED, str(exc))
            return exc
        if policy is None:
            err = NotFoundError(f'policy {ur.policy_key!r} not found')
            ur.set_status(STATE_FAILED, str(err))
            return err
        rules = [r for r in (policy.spec.get('rules') or [])
                 if is_mutate_existing(Rule(r))]
        pctx = None
        if rules:
            try:
                trigger = get_trigger_resource(self.client, ur)
            except Exception as exc:  # noqa: BLE001
                ur.set_status(STATE_FAILED, str(exc))
                return exc
            if trigger is None:
                # DELETE triggers resolve from the admission request's
                # old object (reference: pkg/background/common/
                # context.go:50 — trigger = &old when nil)
                old = (ur.admission_request or {}).get('oldObject')
                if isinstance(old, dict) and old:
                    trigger = old
            if trigger is not None:
                pctx = new_background_context(self.client, ur, policy, trigger)
        if pctx is not None:
            from ..api.unstructured import Resource
            from ..engine.match import matches_resource_description
            from ..engine.mutate.mutate import _check_preconditions
            for raw_rule in rules:
                rule = Rule(raw_rule)
                # the trigger must actually select this rule before any
                # target is touched (reference: mutate.go:80 ProcessUR →
                # engine.Mutate, whose rule loop match/precondition-gates)
                if matches_resource_description(
                        Resource(pctx.new_resource), rule,
                        pctx.admission_info, pctx.exclude_group_roles,
                        pctx.namespace_labels,
                        policy.namespace) is not None:
                    continue
                try:
                    # rule context loads BEFORE preconditions, exactly
                    # like the engine mutate loop (mutate.py:185)
                    self.engine.context_loader.load(
                        rule.context, pctx.json_context,
                        policy_name=policy.name, rule_name=rule.name)
                    if not _check_preconditions(pctx, rule.preconditions):
                        continue
                except Exception as exc:  # noqa: BLE001
                    errs.append(f'{rule.name}: failed to evaluate '
                                f'preconditions: {exc}')
                    continue
                errs.extend(
                    self._mutate_targets(pctx, rule, raw_rule, policy, ur))
        if errs:
            msg = '; '.join(errs)
            ur.set_status(STATE_FAILED, msg)
            return RuntimeError(msg)
        ur.set_status(STATE_COMPLETED)
        return None

    def _mutate_targets(self, pctx: PolicyContext, rule: Rule,
                        raw_rule: dict, policy: Policy,
                        ur: UpdateRequest) -> List[str]:
        """Resolve each target spec, run the mutation against the target
        with ``target`` bound in the JSON context, and persist the patched
        object (reference: mutate.go:102-170 + engine mutate target
        loading)."""
        errs: List[str] = []
        ctx = pctx.json_context
        for target in rule.mutation.get('targets') or []:
            ctx.checkpoint()
            try:
                resolved = substitute_all(ctx, dict(target))
                api_version = resolved.get('apiVersion', '')
                kind = resolved.get('kind', '')
                name = resolved.get('name', '')
                namespace = resolved.get('namespace', '')
                candidates = self._resolve_targets(
                    api_version, kind, namespace, name)
                for obj in candidates:
                    err = self._mutate_one(pctx, rule, raw_rule, policy, obj)
                    if err:
                        errs.append(err)
            except Exception as exc:  # noqa: BLE001
                errs.append(f'{rule.name}: {exc}')
            finally:
                ctx.restore()
        return errs

    def _resolve_targets(self, api_version: str, kind: str, namespace: str,
                         name: str) -> List[dict]:
        if name and '*' not in name:
            try:
                return [self.client.get_resource(
                    api_version, kind, namespace, name)]
            except Exception:  # noqa: BLE001 — missing target is not fatal
                return []
        from ..utils.wildcard import match as wildcard_match
        out = []
        for obj in self.client.list_resource(api_version, kind, namespace):
            obj_name = (obj.get('metadata') or {}).get('name', '')
            if not name or wildcard_match(name, obj_name):
                out.append(obj)
        return out

    def _mutate_one(self, pctx: PolicyContext, rule: Rule, raw_rule: dict,
                    policy: Policy, target_obj: dict) -> Optional[str]:
        from ..engine.mutate.mutate import mutate_rule
        ctx = pctx.json_context
        ctx.checkpoint()
        try:
            ctx.add_target_resource(target_obj)
            resp = mutate_rule(raw_rule, ctx, target_obj)
            if resp.status == RuleStatus.FAIL or resp.status == RuleStatus.ERROR:
                return (f'failed to mutate existing resource, rule response '
                        f'{resp.status}: {resp.message}')
            if resp.status != RuleStatus.PASS or resp.patched_resource is None:
                return None
            patched = resp.patched_resource
            if resp.patches:
                annotations = patched.setdefault('metadata', {}) \
                    .setdefault('annotations', {})
                annotations[MUTATE_LAST_APPLIED_ANNOTATION] = json.dumps(
                    resp.patches, separators=(',', ':'), sort_keys=True)
            patched.setdefault('metadata', {})['resourceVersion'] = \
                (target_obj.get('metadata') or {}).get('resourceVersion', '')
            self.client.update_resource(
                patched.get('apiVersion', ''), patched.get('kind', ''),
                (patched.get('metadata') or {}).get('namespace', ''), patched)
            return None
        except Exception as exc:  # noqa: BLE001
            return f'{rule.name}: {exc}'
        finally:
            ctx.restore()
