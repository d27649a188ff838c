"""Background rule filtering (reference: pkg/engine/background.go,
pkg/engine/generation.go).

``filter_background_rules`` decides which generate / mutate-existing rules
of a policy apply to a trigger resource (reference name:
ApplyBackgroundChecks; renamed here because ``Engine.apply_background_checks``
is the background-scan validate entry); the background controller then
materializes the applicable rules (kyverno_tpu.background.generate).
``generate_response`` is the UpdateRequest-driven variant used when
replaying a UR (reference: pkg/engine/generation.go:14 GenerateResponse).
"""

from __future__ import annotations

import time
from typing import Optional

from ..api.policy import Rule
from ..api.unstructured import Resource
from .api import EngineResponse, PolicyContext, RuleResponse, RuleStatus, RuleType
from .match import matches_resource_description
from .variables import (
    substitute_all_in_preconditions,
)
from .operators import evaluate_conditions


def is_mutate_existing(rule: Rule) -> bool:
    """reference: api/kyverno/v1/rule_types.go IsMutateExisting"""
    return bool(rule.mutation.get('targets'))


def filter_background_rules(engine, pctx: PolicyContext) -> EngineResponse:
    """reference: pkg/engine/background.go:20 ApplyBackgroundChecks"""
    start = time.time()
    resp = EngineResponse(pctx.policy)
    apply_rules = pctx.policy.apply_rules
    for raw_rule in engine._compute_rules(pctx.policy):
        rule = Rule(raw_rule)
        rule_resp = _filter_rule(engine, rule, pctx)
        if rule_resp is not None:
            resp.policy_response.rules.append(rule_resp)
            if apply_rules == 'One' and rule_resp.status != RuleStatus.SKIP:
                break
    engine._build_response(pctx, resp, start)
    return resp


def generate_response(engine, pctx: PolicyContext, ur: dict) -> EngineResponse:
    """reference: pkg/engine/generation.go:14 GenerateResponse — filters the
    generate rules of the UR's policy against the trigger resource."""
    start = time.time()
    resp = EngineResponse(pctx.policy)
    for raw_rule in engine._compute_rules(pctx.policy):
        rule = Rule(raw_rule)
        if not rule.has_generate():
            continue
        rule_resp = _filter_rule(engine, rule, pctx)
        if rule_resp is not None:
            resp.policy_response.rules.append(rule_resp)
    engine._build_response(pctx, resp, start)
    return resp


def _filter_rule(engine, rule: Rule,
                 pctx: PolicyContext) -> Optional[RuleResponse]:
    """reference: pkg/engine/background.go:77 filterRule"""
    if not rule.has_generate() and not is_mutate_existing(rule):
        return None
    rule_type = RuleType.GENERATION if rule.has_generate() else RuleType.MUTATION

    exception_resp = engine._check_exceptions(pctx, rule)
    if exception_resp is not None:
        return exception_resp

    new_res = Resource(pctx.new_resource)
    err = matches_resource_description(
        new_res, rule, pctx.admission_info, pctx.exclude_group_roles,
        pctx.namespace_labels, '', pctx.subresource)
    if err is not None:
        if rule_type == RuleType.GENERATION and pctx.old_resource:
            # the old resource matched: report Fail so the controller can
            # delete the downstream resources of the retired trigger
            # (reference: background.go:115-126)
            old_err = matches_resource_description(
                Resource(pctx.old_resource), rule, pctx.admission_info,
                pctx.exclude_group_roles, pctx.namespace_labels, '',
                pctx.subresource)
            if old_err is None:
                return RuleResponse(rule.name, rule_type, '', RuleStatus.FAIL)
        return None

    ctx = pctx.json_context
    ctx.checkpoint()
    try:
        try:
            engine.context_loader.load(rule.context, ctx,
                                       policy_name=pctx.policy.name,
                                       rule_name=rule.name)
        except Exception:
            return None
        try:
            conditions = substitute_all_in_preconditions(
                ctx, rule.preconditions)
        except Exception:
            return None
        if conditions is not None and not evaluate_conditions(ctx, conditions):
            return RuleResponse(rule.name, rule_type, '', RuleStatus.SKIP)
        return RuleResponse(rule.name, rule_type, '', RuleStatus.PASS)
    finally:
        ctx.restore()
