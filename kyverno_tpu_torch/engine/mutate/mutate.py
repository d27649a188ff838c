"""Mutation entry points and the engine mutate rule loop.

reference: pkg/engine/mutation.go (rule loop + foreach mutator),
pkg/engine/mutate/mutation.go (Mutate/ForEach handlers).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

from ...api.policy import Policy, Rule
from ...api.unstructured import Resource
from .. import operators
from .. import variables as vars_mod
from ..api import (EngineResponse, PolicyContext, RuleResponse, RuleStatus,
                   RuleType)
from ..context import Context, ContextError, InvalidVariableError
from ..match import matches_resource_description
from ..variables import SubstitutionError
from .jsonpatch import JsonPatchError, apply_patch, generate_patches, load_patches
from .strategic import (ConditionError, GlobalConditionError,
                        preprocess_pattern, strategic_merge)


class MutateResponse:
    def __init__(self, status: str, patched_resource: Optional[dict],
                 patches: Optional[List[dict]], message: str):
        self.status = status
        self.patched_resource = patched_resource
        self.patches = patches or []
        self.message = message


def _error_response(msg: str, err: Exception) -> MutateResponse:
    return MutateResponse(RuleStatus.ERROR, None, None, f'{msg}: {err}')


def mutate_rule(rule_raw: dict, ctx: Context, resource: dict) -> MutateResponse:
    """Apply one mutate rule to a resource
    (reference: pkg/engine/mutate/mutation.go:38 Mutate)."""
    try:
        if vars_mod.tree_has_variables(rule_raw):
            # substitute_all output may ALIAS the rule tree (static
            # subtrees are returned by reference via _STATIC_TREES) —
            # safe only because it is treated read-only here and every
            # downstream applier copies before mutating
            updated_rule = vars_mod.substitute_all(ctx, rule_raw)
        else:
            # constant rule: substitution is the identity, and every
            # downstream consumer copies before mutating — skip the
            # per-resource deepcopy + walk (bulk-apply hot path)
            updated_rule = rule_raw
    except (SubstitutionError, ContextError, InvalidVariableError) as e:
        return _error_response('variable substitution failed', e)
    mutation = updated_rule.get('mutate') or {}
    resp = _apply_patcher(mutation, resource, ctx)
    if resp.status != RuleStatus.PASS:
        return resp
    if not resp.patches:
        return MutateResponse(RuleStatus.SKIP, resource, None,
                              'no patches applied')
    is_mutate_existing = bool((rule_raw.get('mutate') or {}).get('targets'))
    if is_mutate_existing:
        ctx.add_target_resource(resp.patched_resource)
    else:
        ctx.add_resource(resp.patched_resource)
    return resp


def mutate_foreach_entry(name: str, foreach: dict, ctx: Context,
                         resource: dict) -> MutateResponse:
    """reference: pkg/engine/mutate/mutation.go:72 ForEach"""
    try:
        fe = vars_mod.substitute_all(ctx, foreach)
    except (SubstitutionError, ContextError, InvalidVariableError) as e:
        return _error_response('variable substitution failed', e)
    resp = _apply_patcher(fe, resource, ctx)
    if resp.status != RuleStatus.PASS:
        return resp
    if not resp.patches:
        return MutateResponse(RuleStatus.SKIP, resource, None,
                              'no patches applied')
    ctx.add_resource(resp.patched_resource)
    return resp


def _apply_patcher(mutation: dict, resource: dict, ctx: Context) -> MutateResponse:
    smp = mutation.get('patchStrategicMerge')
    json6902 = mutation.get('patchesJson6902')
    if smp is not None:
        return _apply_strategic_merge(smp, resource)
    if json6902:
        return _apply_json6902(json6902, resource)
    return MutateResponse(RuleStatus.ERROR, resource, None, 'empty mutate rule')


def _apply_strategic_merge(overlay: Any, resource: dict) -> MutateResponse:
    # reference: pkg/engine/mutate/patch/strategicMergePatch.go:18
    # preprocess_pattern never mutates the overlay (strategic.py module
    # note), so the rule-constant tree applies per resource without a
    # deepcopy; the patched output may alias overlay subtrees — the
    # substitute_all read-only contract downstream consumers already
    # honor
    try:
        try:
            processed = preprocess_pattern(overlay, resource)
        except (ConditionError, GlobalConditionError):
            processed = {}
        patched = strategic_merge(resource, processed)
        if patched is None:
            patched = {}
    except Exception as e:  # preprocessing bugs must not crash the webhook
        return MutateResponse(RuleStatus.FAIL, resource, None,
                              f'failed to apply patchStrategicMerge: {e}')
    patches = generate_patches(resource, patched)
    return MutateResponse(RuleStatus.PASS, patched, patches,
                          'applied strategic merge patch')


_PATCH_TEXT_CACHE: dict = {}


def _load_patches_cached(patch_text: str):
    """The patch text is a rule constant; parsing it per resource
    dominated bulk applies.  apply_patch treats ops read-only."""
    ops = _PATCH_TEXT_CACHE.get(patch_text)
    if ops is None:
        if len(_PATCH_TEXT_CACHE) > 1024:
            _PATCH_TEXT_CACHE.clear()
        ops = load_patches(patch_text)
        _PATCH_TEXT_CACHE[patch_text] = ops
    return ops


def _apply_json6902(patch_text: Any, resource: dict) -> MutateResponse:
    # reference: pkg/engine/mutate/patch/patchJSON6902.go
    try:
        if isinstance(patch_text, str):
            ops = _load_patches_cached(patch_text)
        else:
            ops = patch_text
        patched = apply_patch(resource, ops)
    except JsonPatchError as e:
        return MutateResponse(RuleStatus.FAIL, resource, None,
                              f'failed to apply patchesJson6902: {e}')
    patches = generate_patches(resource, patched)
    return MutateResponse(RuleStatus.PASS, patched, patches,
                          'applied patchesJson6902')


# ---------------------------------------------------------------------------
# Engine-level Mutate

def mutate(engine, pctx: PolicyContext) -> EngineResponse:
    """The engine Mutate entry (reference: pkg/engine/mutation.go:24)."""
    start = time.time()
    policy = pctx.policy
    resp = EngineResponse(policy)
    matched_resource = pctx.new_resource
    skipped_rules: List[str] = []

    pctx.json_context.checkpoint()
    try:
        apply_rules = policy.apply_rules
        for raw_rule in engine._compute_rules(policy):
            rule = Rule(raw_rule)
            if not rule.has_mutate():
                continue
            err = matches_resource_description(
                Resource(matched_resource), rule, pctx.admission_info,
                pctx.exclude_group_roles, pctx.namespace_labels,
                policy.namespace, pctx.subresource)
            if err is not None:
                skipped_rules.append(rule.name)
                continue
            exception_resp = engine._check_exceptions(pctx, rule)
            if exception_resp is not None:
                exception_resp.rule_type = RuleType.MUTATION
                resp.policy_response.rules.append(exception_resp)
                continue
            # refresh request.object in context then reset to checkpoint
            try:
                resource = pctx.json_context.query('request.object')
            except (ContextError, InvalidVariableError):
                resource = None
            pctx.json_context.reset()
            if isinstance(resource, dict):
                pctx.json_context.add_resource(resource)
            try:
                engine.context_loader.load(rule.context, pctx.json_context,
                                           policy_name=pctx.policy.name,
                                           rule_name=rule.name)
            except (ContextError, SubstitutionError, InvalidVariableError):
                continue

            rule_start = time.time()
            if (rule.mutation or {}).get('foreach') is not None:
                mutator = ForEachMutator(engine, rule, pctx,
                                         matched_resource, nesting=0)
                mutate_resp = mutator.mutate_foreach()
            else:
                mutate_resp = _mutate_resource(rule, pctx, matched_resource)

            if mutate_resp.patched_resource is not None:
                matched_resource = mutate_resp.patched_resource
            message = mutate_resp.message
            if mutate_resp.status == RuleStatus.PASS:
                # reference: mutation.go:334 buildRuleResponse →
                # :347 buildSuccessMessage
                message = _success_message(mutate_resp.patched_resource)
            rule_resp = RuleResponse(rule.name, RuleType.MUTATION,
                                     message, mutate_resp.status,
                                     patches=mutate_resp.patches)
            rule_resp.processing_time = time.time() - rule_start
            resp.policy_response.rules.append(rule_resp)
            if mutate_resp.status == RuleStatus.ERROR:
                resp.policy_response.rules_error_count += 1
            else:
                resp.policy_response.rules_applied_count += 1
            if apply_rules == 'One' and \
                    resp.policy_response.rules_applied_count > 0:
                break
    finally:
        pctx.json_context.restore()

    for r in resp.policy_response.rules:
        if r.name in skipped_rules:
            r.status = RuleStatus.SKIP

    resp.patched_resource = matched_resource
    engine._build_response(pctx, resp, start)
    return resp


def _success_message(patched: Optional[dict]) -> str:
    """reference: pkg/engine/mutation.go:347 buildSuccessMessage"""
    if not patched:
        return 'mutated resource'
    meta = patched.get('metadata') or {}
    kind = patched.get('kind', '')
    name = meta.get('name', '')
    ns = meta.get('namespace', '')
    if not ns:
        return f'mutated {kind}/{name}'
    return f'mutated {kind}/{name} in namespace {ns}'


def _mutate_resource(rule: Rule, pctx: PolicyContext,
                     resource: dict) -> MutateResponse:
    # reference: pkg/engine/mutation.go:189 mutateResource
    try:
        passed = _check_preconditions(pctx, rule.preconditions)
    except (ContextError, SubstitutionError, InvalidVariableError) as e:
        return _error_response('failed to evaluate preconditions', e)
    if not passed:
        return MutateResponse(RuleStatus.SKIP, resource, None,
                              'preconditions not met')
    return mutate_rule(rule.raw, pctx.json_context, resource)


def _check_preconditions(pctx: PolicyContext, conditions: Any) -> bool:
    if conditions is None:
        return True
    substituted = vars_mod.substitute_all_in_preconditions(
        pctx.json_context, conditions)
    return operators.evaluate_conditions(pctx.json_context, substituted)


class ForEachMutator:
    """reference: pkg/engine/mutation.go:202 forEachMutator"""

    def __init__(self, engine, rule: Rule, pctx: PolicyContext,
                 resource: dict, nesting: int):
        self.engine = engine
        self.rule = rule
        self.pctx = pctx
        self.resource = resource
        self.nesting = nesting
        self.foreach = (rule.mutation or {}).get('foreach') or []

    def mutate_foreach(self, foreach_list: Optional[List[dict]] = None) -> MutateResponse:
        apply_count = 0
        all_patches: List[dict] = []
        entries = foreach_list if foreach_list is not None else self.foreach
        for foreach in entries:
            try:
                self.engine.context_loader.load(
                    self.rule.context, self.pctx.json_context,
                    policy_name=self.pctx.policy.name,
                    rule_name=self.rule.name)
            except (ContextError, SubstitutionError, InvalidVariableError) as e:
                return _error_response('failed to load context', e)
            try:
                passed = _check_preconditions(self.pctx, self.rule.preconditions)
            except (ContextError, SubstitutionError, InvalidVariableError) as e:
                return _error_response('failed to evaluate preconditions', e)
            if not passed:
                return MutateResponse(RuleStatus.SKIP, self.resource, None,
                                      'preconditions not met')
            try:
                elements = self.pctx.json_context.query(foreach.get('list', ''))
            except (ContextError, InvalidVariableError) as e:
                return _error_response(
                    f'failed to evaluate list {foreach.get("list")}', e)
            if not isinstance(elements, list):
                elements = [elements]
            mutate_resp = self._mutate_elements(foreach, elements)
            if mutate_resp.status == RuleStatus.ERROR:
                return mutate_resp
            if mutate_resp.status != RuleStatus.SKIP:
                apply_count += 1
                if mutate_resp.patches:
                    self.resource = mutate_resp.patched_resource
                    all_patches.extend(mutate_resp.patches)
        msg = f'{apply_count} elements processed'
        status = RuleStatus.SKIP if apply_count == 0 else RuleStatus.PASS
        return MutateResponse(status, self.resource, all_patches, msg)

    def _mutate_elements(self, foreach: dict, elements: List[Any]) -> MutateResponse:
        ctx = self.pctx.json_context
        ctx.checkpoint()
        try:
            patched = self.resource
            all_patches: List[dict] = []
            if foreach.get('patchStrategicMerge') is not None:
                elements = list(reversed(elements))
            for index, element in enumerate(elements):
                if element is None:
                    continue
                ctx.reset()
                pctx = self.pctx.copy()
                ctx.add_element(element, index, self.nesting)
                try:
                    self.engine.context_loader.load(
                        foreach.get('context') or [], ctx,
                        policy_name=self.pctx.policy.name,
                        rule_name=self.rule.name)
                except (ContextError, SubstitutionError,
                        InvalidVariableError) as e:
                    return _error_response(
                        f'failed to load to mutate.foreach[{index}].context', e)
                try:
                    passed = _check_preconditions(
                        pctx, foreach.get('preconditions'))
                except (ContextError, SubstitutionError,
                        InvalidVariableError) as e:
                    return _error_response(
                        f'failed to evaluate mutate.foreach[{index}]'
                        f'.preconditions', e)
                if not passed:
                    continue
                nested = foreach.get('foreach')
                if nested is not None:
                    sub = ForEachMutator(self.engine, self.rule, self.pctx,
                                         patched, self.nesting + 1)
                    mutate_resp = sub.mutate_foreach(nested)
                else:
                    mutate_resp = mutate_foreach_entry(
                        self.rule.name, foreach, ctx, patched)
                if mutate_resp.status in (RuleStatus.FAIL, RuleStatus.ERROR):
                    return mutate_resp
                if mutate_resp.patches:
                    patched = mutate_resp.patched_resource
                    all_patches.extend(mutate_resp.patches)
            return MutateResponse(RuleStatus.PASS, patched, all_patches, '')
        finally:
            ctx.restore()
