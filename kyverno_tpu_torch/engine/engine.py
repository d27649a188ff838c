"""The policy engine: stateless Validate entry (Mutate lives in mutate/).

Re-implements the reference's validation flow
(reference: pkg/engine/validation.go): autogen expansion → per-rule
match/exclude → policy exceptions → context loading → preconditions →
deny / pattern / anyPattern / podSecurity / foreach dispatch, with
bit-compatible rule messages and statuses.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api.policy import Policy, Rule
from ..api.unstructured import Resource
from ..autogen.autogen import compute_rules
from . import operators
from . import variables as vars_mod
from .api import (EngineResponse, PolicyContext, RuleResponse, RuleStatus,
                  RuleType)
from .context import Context, ContextError, InvalidVariableError
from .match import matches_resource_description, check_kind
from .match import check_selector  # noqa: F401  (re-exported for callers)
from .validate_pattern import PatternError, match_pattern
from .variables import SubstitutionError


class ContextLoader:
    """Loads rule ``context:`` entries into the JSON context
    (reference: pkg/engine/jsonContext.go:126 LoadContext).

    ``configmap_resolver(name, namespace) -> dict`` and
    ``api_call(entry, ctx) -> Any`` are pluggable; the defaults raise, which
    surfaces as a rule error exactly like a failed network call would.
    """

    def __init__(self,
                 configmap_resolver: Optional[Callable[[str, str], Optional[dict]]] = None,
                 api_call: Optional[Callable[[dict, Context], Any]] = None,
                 image_data: Optional[Callable[[dict, Context], Any]] = None):
        self.configmap_resolver = configmap_resolver
        self.api_call = api_call
        self.image_data = image_data

    def load(self, entries: List[dict], ctx: Context,
             policy_name: str = '', rule_name: str = '') -> None:
        """``policy_name``/``rule_name`` identify the calling rule so mock
        loaders (CLI values files, reference: pkg/engine/jsonContext.go:88)
        can inject per-rule variables; the real loader ignores them."""
        del policy_name, rule_name
        for entry in entries:
            name = entry.get('name', '')
            if entry.get('configMap') is not None:
                self._load_configmap(entry, ctx)
            elif entry.get('apiCall') is not None:
                if self.api_call is None:
                    raise ContextError(
                        f'failed to load context entry {name}: no API client')
                data = self.api_call(entry, ctx)
                ctx.add_context_entry(name, data)
            elif entry.get('imageRegistry') is not None:
                if self.image_data is None:
                    raise ContextError(
                        f'failed to load context entry {name}: no registry client')
                data = self.image_data(entry, ctx)
                ctx.add_context_entry(name, data)
            elif entry.get('variable') is not None:
                self._load_variable(entry, ctx)

    def _load_variable(self, entry: dict, ctx: Context) -> None:
        # reference: pkg/engine/jsonContext.go:130 loadVariable
        name = entry.get('name', '')
        var = entry.get('variable') or {}
        path = ''
        if var.get('jmesPath'):
            path = vars_mod.substitute_all(ctx, var['jmesPath'])
        default_value = None
        if var.get('default') is not None:
            default_value = vars_mod.substitute_all(ctx, var['default'])
        output = default_value
        if var.get('value') is not None:
            value = vars_mod.substitute_all(ctx, var['value'])
            if path:
                try:
                    from . import jmespath as jp
                    output = jp.search(path, value)
                except jp.JMESPathError as e:
                    if default_value is None:
                        raise ContextError(
                            f'failed to apply jmespath {path} to variable '
                            f'{var["value"]}: {e}') from e
            else:
                output = value
        elif path:
            try:
                result = ctx.query(path)
                if result is not None:
                    output = result
                elif default_value is None:
                    output = result
            except (ContextError, InvalidVariableError) as e:
                if default_value is None:
                    raise ContextError(
                        f'failed to apply jmespath {path} to variable: {e}') from e
        if output is None:
            raise ContextError(
                f'unable to add context entry for variable {name} since it '
                f'evaluated to nil')
        ctx.replace_context_entry(name, output)

    def _load_configmap(self, entry: dict, ctx: Context) -> None:
        name = entry.get('name', '')
        cm = entry.get('configMap') or {}
        cm_name = vars_mod.substitute_all(ctx, cm.get('name', ''))
        cm_ns = vars_mod.substitute_all(ctx, cm.get('namespace', '') or 'default')
        if self.configmap_resolver is None:
            raise ContextError(
                f'failed to load context entry {name}: no ConfigMap resolver')
        try:
            data = self.configmap_resolver(cm_name, cm_ns)
        except ContextError:
            raise
        except Exception as e:  # noqa: BLE001 - a missing ConfigMap is a
            # context-load failure, not an engine crash (reference:
            # jsonContext.go:307 'failed to retrieve config map...')
            raise ContextError(
                f'failed to retrieve config map for context entry '
                f'{name}: {e}')
        if data is None:
            raise ContextError(
                f'failed to get configmap {cm_ns}/{cm_name}')
        ctx.replace_context_entry(name, data)


class Engine:
    """Stateless policy engine (reference: pkg/engine)."""

    def __init__(self, context_loader: Optional[ContextLoader] = None,
                 pss_evaluator: Optional[Callable] = None):
        self.context_loader = context_loader or ContextLoader()
        if pss_evaluator is None:
            from ..pss.evaluate import evaluate_pod_security
            pss_evaluator = evaluate_pod_security
        self.pss_evaluator = pss_evaluator
        # autogen expansion memo: policies are immutable during evaluation
        self._rules_cache: Dict[int, Tuple[dict, List[dict]]] = {}

    _RULES_CACHE_MAX = 512

    def _compute_rules(self, policy: Policy) -> List[dict]:
        # the cache entry holds a strong reference to the keyed dict so the
        # id cannot be recycled; identity is re-verified on every hit and
        # the cache is bounded (FIFO eviction) for long-lived engines
        key = id(policy.raw)
        entry = self._rules_cache.get(key)
        if entry is not None and entry[0] is policy.raw:
            return entry[1]
        rules = compute_rules(policy)
        if len(self._rules_cache) >= self._RULES_CACHE_MAX:
            # webhook threads share one engine: two threads evicting at
            # once can race next(iter)/pop — eviction is best-effort
            try:
                self._rules_cache.pop(next(iter(self._rules_cache)))
            except (KeyError, StopIteration, RuntimeError):
                pass
        self._rules_cache[key] = (policy.raw, rules)
        return rules

    # -- public entry points -------------------------------------------------

    def validate(self, policy_context: PolicyContext) -> EngineResponse:
        """reference: pkg/engine/validation.go:39 Validate"""
        start = time.time()
        resp = self._validate_resource(policy_context)
        resp.namespace_labels = policy_context.namespace_labels
        self._build_response(policy_context, resp, start)
        return resp

    def mutate(self, policy_context: PolicyContext) -> EngineResponse:
        """reference: pkg/engine/mutation.go:24 Mutate"""
        from .mutate.mutate import mutate as mutate_impl
        return mutate_impl(self, policy_context)

    def apply_background_checks(self, policy_context: PolicyContext) -> EngineResponse:
        """Background-scan entry: same as validate but only if the policy has
        background enabled (reference: pkg/engine/background.go:20)."""
        if not policy_context.policy.background:
            resp = EngineResponse(policy_context.policy)
            self._build_response(policy_context, resp, time.time())
            return resp
        return self.validate(policy_context)

    def filter_background_rules(self, policy_context: PolicyContext) -> EngineResponse:
        """Filter generate / mutate-existing rules applicable to a trigger
        (reference: pkg/engine/background.go:20 ApplyBackgroundChecks)."""
        from .background import filter_background_rules as impl
        return impl(self, policy_context)

    def generate_response(self, policy_context: PolicyContext,
                          ur: dict) -> EngineResponse:
        """reference: pkg/engine/generation.go:14 GenerateResponse"""
        from .background import generate_response as impl
        return impl(self, policy_context, ur)

    def verify_and_patch_images(self, policy_context: PolicyContext,
                                rclient=None):
        """reference: pkg/engine/imageVerify.go:69 VerifyAndPatchImages —
        returns (EngineResponse, ImageVerificationMetadata)."""
        from .image_verify import verify_and_patch_images as impl
        return impl(self, policy_context, rclient)

    # -- internals -----------------------------------------------------------

    def _build_response(self, pctx: PolicyContext, resp: EngineResponse,
                        start: float) -> None:
        if resp.patched_resource is None:
            resp.patched_resource = pctx.new_resource or pctx.old_resource
        policy = pctx.policy
        resp.policy = policy
        pr = resp.policy_response
        pr.policy_name = policy.name
        pr.policy_namespace = policy.namespace
        patched = Resource(resp.patched_resource)
        pr.resource_name = patched.name
        pr.resource_namespace = patched.namespace
        pr.resource_kind = patched.kind
        pr.resource_api_version = patched.api_version
        pr.validation_failure_action = policy.validation_failure_action
        pr.validation_failure_action_overrides = \
            policy.validation_failure_action_overrides
        pr.processing_time = time.time() - start
        pr.timestamp = int(start)

    def _validate_resource(self, pctx: PolicyContext) -> EngineResponse:
        # reference: pkg/engine/validation.go:106 validateResource
        resp = EngineResponse(pctx.policy)
        pctx.json_context.checkpoint()
        try:
            rules = self._compute_rules(pctx.policy)
            apply_rules = pctx.policy.apply_rules
            policy = pctx.policy

            if policy.is_namespaced:
                pol_ns = policy.namespace
                new_r, old_r = Resource(pctx.new_resource), Resource(pctx.old_resource)
                if pctx.new_resource and (new_r.namespace != pol_ns or new_r.namespace == ''):
                    return resp
                if pctx.old_resource and (old_r.namespace != pol_ns or old_r.namespace == ''):
                    return resp

            from ..observability import tracing
            for raw_rule in rules:
                rule = Rule(raw_rule)
                pctx.json_context.reset()
                start = time.time()
                # per-rule child span (reference: pkg/engine/validation.go:139
                # via pkg/tracing/childspan.go ChildSpan1)
                with tracing.start_span(
                        'kyverno/engine/rule',
                        {'policy': policy.name, 'rule': rule.name}) as span:
                    rule_resp = self._process_rule(pctx, rule)
                    if rule_resp is not None:
                        span.set_attribute('status', rule_resp.status)
                if rule_resp is not None:
                    self._add_rule_response(resp, rule_resp, start)
                    if apply_rules == 'One' and \
                            resp.policy_response.rules_applied_count > 0:
                        break
            return resp
        finally:
            pctx.json_context.restore()

    def _process_rule(self, pctx: PolicyContext,
                      rule: Rule) -> Optional[RuleResponse]:
        has_validate = rule.has_validate()
        # reference: api/kyverno/v1/rule_types.go:107
        # HasImagesValidationChecks (verifyDigest/required default true)
        has_validate_image = any(
            iv.get('verifyDigest', True) or iv.get('required', True)
            for iv in rule.verify_images)
        if not has_validate and not has_validate_image:
            return None
        if not self._matches(rule, pctx):
            return None
        exception_resp = self._check_exceptions(pctx, rule)
        if exception_resp is not None:
            return exception_resp
        pctx.json_context.reset()
        if has_validate:
            # manifests rules also flow through Validator so context
            # loading and preconditions run first
            # (reference: pkg/engine/validation.go:185)
            return Validator(self, pctx, rule).validate()
        if has_validate_image:
            from .image_verify import process_image_validation_rule
            return process_image_validation_rule(self, pctx, rule)
        return None

    def _matches(self, rule: Rule, pctx: PolicyContext) -> bool:
        # reference: pkg/engine/validation.go:600 matches
        err = matches_resource_description(
            Resource(pctx.new_resource), rule, pctx.admission_info,
            pctx.exclude_group_roles, pctx.namespace_labels, '',
            pctx.subresource, pctx.subresources_in_policy)
        if err is None:
            return True
        if pctx.old_resource:
            err = matches_resource_description(
                Resource(pctx.old_resource), rule, pctx.admission_info,
                pctx.exclude_group_roles, pctx.namespace_labels, '',
                pctx.subresource, pctx.subresources_in_policy)
            if err is None:
                return True
        return False

    def _check_exceptions(self, pctx: PolicyContext,
                          rule: Rule) -> Optional[RuleResponse]:
        # reference: pkg/engine/validation.go:826 hasPolicyExceptions
        from .match import _check_filter  # reuse filter matching
        for exception in pctx.find_exceptions(rule.name):
            match = (exception.get('spec') or {}).get('match') or {}
            matched = False
            any_f = match.get('any') or []
            all_f = match.get('all') or []
            res = Resource(pctx.new_resource)
            if any_f:
                matched = any(not _check_filter(
                    f, res, pctx.admission_info, pctx.exclude_group_roles,
                    pctx.namespace_labels, pctx.subresource) for f in any_f)
            elif all_f:
                matched = all(not _check_filter(
                    f, res, pctx.admission_info, pctx.exclude_group_roles,
                    pctx.namespace_labels, pctx.subresource) for f in all_f)
            if matched:
                meta = exception.get('metadata') or {}
                key = f"{meta.get('namespace', '')}/{meta.get('name', '')}" \
                    if meta.get('namespace') else meta.get('name', '')
                return RuleResponse(
                    rule.name, RuleType.VALIDATION,
                    f'rule skipped due to policy exception {key}',
                    RuleStatus.SKIP)
        return None

    def _add_rule_response(self, resp: EngineResponse,
                           rule_resp: RuleResponse, start: float) -> None:
        rule_resp.processing_time = time.time() - start
        rule_resp.timestamp = int(start)
        if rule_resp.status in (RuleStatus.PASS, RuleStatus.FAIL):
            resp.policy_response.rules_applied_count += 1
        elif rule_resp.status == RuleStatus.ERROR:
            resp.policy_response.rules_error_count += 1
        resp.policy_response.rules.append(rule_resp)


def _rule_response(rule: Rule, rule_type: str, message: str,
                   status: str) -> RuleResponse:
    return RuleResponse(rule.name, rule_type, message, status)


def _rule_error(rule: Rule, rule_type: str, message: str,
                err: Exception) -> RuleResponse:
    return RuleResponse(rule.name, rule_type, f'{message}: {err}',
                        RuleStatus.ERROR)


class Validator:
    """Per-rule validator (reference: pkg/engine/validation.go:210)."""

    def __init__(self, engine: Engine, pctx: PolicyContext, rule: Rule,
                 foreach_entry: Optional[dict] = None, nesting: int = 0):
        self.engine = engine
        self.pctx = pctx
        # no deep copy: the rule dict is never mutated (substitution builds
        # new objects; self.pattern is rebound, not written through)
        self.rule = rule
        self.nesting = nesting
        if foreach_entry is None:
            v = self.rule.validation
            self.context_entries = self.rule.context
            self.any_all_conditions = self.rule.preconditions
            self.pattern = v.get('pattern')
            self.any_pattern = v.get('anyPattern')
            self.deny = v.get('deny')
            self.pod_security = v.get('podSecurity')
            self.manifests = v.get('manifests')
            self.foreach = v.get('foreach')
        else:
            self.context_entries = foreach_entry.get('context') or []
            self.any_all_conditions = foreach_entry.get('preconditions')
            self.pattern = foreach_entry.get('pattern')
            self.any_pattern = foreach_entry.get('anyPattern')
            self.deny = foreach_entry.get('deny')
            self.pod_security = None
            self.manifests = None
            self.foreach = foreach_entry.get('foreach')

    # -- entry ---------------------------------------------------------------

    def validate(self) -> Optional[RuleResponse]:
        # reference: pkg/engine/validation.go:276 validate
        try:
            self.engine.context_loader.load(
                self.context_entries, self.pctx.json_context,
                policy_name=self.pctx.policy.name, rule_name=self.rule.name)
        except (ContextError, SubstitutionError, InvalidVariableError) as e:
            return _rule_error(self.rule, RuleType.VALIDATION,
                               'failed to load context', e)
        try:
            passed = self._check_preconditions()
        except (ContextError, SubstitutionError, InvalidVariableError) as e:
            return _rule_error(self.rule, RuleType.VALIDATION,
                               'failed to evaluate preconditions', e)
        if not passed:
            return _rule_response(self.rule, RuleType.VALIDATION,
                                  'preconditions not met', RuleStatus.SKIP)
        if self.deny is not None:
            return self._validate_deny()
        if self.pattern is not None or self.any_pattern is not None:
            try:
                self._substitute_patterns()
            except (SubstitutionError, ContextError, InvalidVariableError) as e:
                return _rule_error(self.rule, RuleType.VALIDATION,
                                   'variable substitution failed', e)
            return self._validate_resource_with_rule()
        if self.pod_security is not None:
            if not self._is_delete_request():
                return self._validate_pod_security()
        if self.manifests is not None:
            # reference: pkg/engine/validation.go processYAMLValidationRule
            from .k8smanifest import process_yaml_validation_rule
            return process_yaml_validation_rule(self.pctx, self.rule)
        if self.foreach is not None:
            return self._validate_foreach()
        return None

    # -- preconditions -------------------------------------------------------

    def _check_preconditions(self) -> bool:
        # reference: pkg/engine/utils.go:328 checkPreconditions
        conditions = self.any_all_conditions
        if conditions is None:
            return True
        substituted = vars_mod.substitute_all_in_preconditions(
            self.pctx.json_context, conditions)
        return operators.evaluate_conditions(self.pctx.json_context,
                                             substituted)

    # -- deny ----------------------------------------------------------------

    def _validate_deny(self) -> RuleResponse:
        # reference: pkg/engine/validation.go:437 validateDeny
        try:
            conditions = vars_mod.substitute_all(
                self.pctx.json_context, (self.deny or {}).get('conditions'))
        except (SubstitutionError, ContextError, InvalidVariableError) as e:
            return _rule_error(self.rule, RuleType.VALIDATION,
                               'failed to substitute variables in deny '
                               'conditions', e)
        deny = operators.evaluate_conditions(self.pctx.json_context,
                                             conditions)
        if deny:
            return _rule_response(self.rule, RuleType.VALIDATION,
                                  self._deny_message(True), RuleStatus.FAIL)
        return _rule_response(self.rule, RuleType.VALIDATION,
                              self._deny_message(False), RuleStatus.PASS)

    def _deny_message(self, deny: bool) -> str:
        # reference: pkg/engine/validation.go:460 getDenyMessage
        if not deny:
            return f"validation rule '{self.rule.name}' passed."
        msg = self.rule.validation.get('message', '')
        if not msg:
            return f'validation error: rule {self.rule.name} failed'
        try:
            raw = vars_mod.substitute_all(self.pctx.json_context, msg)
        except (SubstitutionError, ContextError, InvalidVariableError):
            return msg
        if isinstance(raw, str):
            return raw
        return ("the produced message didn't resolve to a string, check your "
                "policy definition.")

    # -- patterns ------------------------------------------------------------

    def _substitute_patterns(self) -> None:
        if self.pattern is not None:
            self.pattern = vars_mod.substitute_all(self.pctx.json_context,
                                                   self.pattern)
        elif self.any_pattern is not None:
            self.any_pattern = vars_mod.substitute_all(self.pctx.json_context,
                                                       self.any_pattern)

    def _is_delete_request(self) -> bool:
        return not self.pctx.new_resource

    def _validate_resource_with_rule(self) -> Optional[RuleResponse]:
        element = self.pctx.element
        if element:
            return self._validate_patterns(element)
        if self._is_delete_request():
            return None
        return self._validate_patterns(self.pctx.new_resource)

    def _validate_patterns(self, resource: dict) -> RuleResponse:
        # reference: pkg/engine/validation.go:618 validatePatterns
        rule = self.rule
        if self.pattern is not None:
            try:
                match_pattern(resource, self.pattern)
            except PatternError as pe:
                if pe.skip:
                    return _rule_response(rule, RuleType.VALIDATION, str(pe),
                                          RuleStatus.SKIP)
                if pe.path == '':
                    return _rule_response(rule, RuleType.VALIDATION,
                                          self._error_message(pe, ''),
                                          RuleStatus.ERROR)
                return _rule_response(rule, RuleType.VALIDATION,
                                      self._error_message(pe, pe.path),
                                      RuleStatus.FAIL)
            return _rule_response(
                rule, RuleType.VALIDATION,
                f"validation rule '{rule.name}' passed.", RuleStatus.PASS)

        if self.any_pattern is not None:
            failed, skipped = [], []
            patterns = self.any_pattern
            if not isinstance(patterns, list):
                return _rule_response(
                    rule, RuleType.VALIDATION,
                    'failed to deserialize anyPattern, expected type array',
                    RuleStatus.ERROR)
            for idx, pattern in enumerate(patterns):
                try:
                    match_pattern(resource, pattern)
                    return _rule_response(
                        rule, RuleType.VALIDATION,
                        f"validation rule '{rule.name}' anyPattern[{idx}] "
                        f"passed.", RuleStatus.PASS)
                except PatternError as pe:
                    if pe.skip:
                        skipped.append(
                            f'rule {rule.name}[{idx}] skipped: {pe}')
                    else:
                        if pe.path == '':
                            failed.append(
                                f'rule {rule.name}[{idx}] failed: {pe}')
                        else:
                            failed.append(
                                f'rule {rule.name}[{idx}] failed at path '
                                f'{pe.path}')
            if skipped and not failed:
                return _rule_response(rule, RuleType.VALIDATION,
                                      ' '.join(skipped), RuleStatus.SKIP)
            if failed:
                return _rule_response(
                    rule, RuleType.VALIDATION,
                    self._any_pattern_message(failed), RuleStatus.FAIL)

        return _rule_response(rule, RuleType.VALIDATION,
                              self.rule.validation.get('message', ''),
                              RuleStatus.PASS)

    def _error_message(self, err: Exception, path: str) -> str:
        # reference: pkg/engine/validation.go:722 buildErrorMessage
        rule = self.rule
        msg = rule.validation.get('message', '')
        if not msg:
            if path:
                return f'validation error: rule {rule.name} failed at path {path}'
            return (f'validation error: rule {rule.name} execution error: '
                    f'{err}')
        try:
            msg = vars_mod.substitute_all(self.pctx.json_context, msg)
        except (SubstitutionError, ContextError, InvalidVariableError):
            return (f'validation error: variables substitution error in rule '
                    f'{rule.name} execution error: {err}')
        if not isinstance(msg, str):
            msg = str(msg)
        if not msg.endswith('.'):
            msg += '.'
        if path:
            return f'validation error: {msg} rule {rule.name} failed at path {path}'
        return f'validation error: {msg} rule {rule.name} execution error: {err}'

    def _any_pattern_message(self, errors: List[str]) -> str:
        # reference: pkg/engine/validation.go:746 buildAnyPatternErrorMessage
        err_str = ' '.join(errors)
        msg = self.rule.validation.get('message', '')
        if not msg:
            return f'validation error: {err_str}'
        if msg.endswith('.'):
            return f'validation error: {msg} {err_str}'
        return f'validation error: {msg}. {err_str}'

    # -- pod security --------------------------------------------------------

    def _validate_pod_security(self) -> RuleResponse:
        # reference: pkg/engine/validation.go:535 validatePodSecurity
        from ..pss.evaluate import extract_pod_spec
        rule = self.rule
        try:
            pod = extract_pod_spec(self.pctx.new_resource)
        except ValueError as e:
            return _rule_error(rule, RuleType.VALIDATION,
                               'Error while getting new resource', e)
        try:
            allowed, checks = self.engine.pss_evaluator(self.pod_security, pod)
        except ValueError as e:
            return _rule_error(rule, RuleType.VALIDATION,
                               'failed to parse pod security api version', e)
        level = self.pod_security.get('level', '')
        version = self.pod_security.get('version', '')
        psc = {'level': level, 'version': version, 'checks': checks}
        if allowed:
            r = _rule_response(rule, RuleType.VALIDATION,
                               f"Validation rule '{rule.name}' passed.",
                               RuleStatus.PASS)
        else:
            from ..pss.evaluate import format_checks_print
            r = _rule_response(
                rule, RuleType.VALIDATION,
                f"Validation rule '{rule.name}' failed. It violates "
                f'PodSecurity "{level}:{version}": '
                f'{format_checks_print(checks)}', RuleStatus.FAIL)
        r.pod_security_checks = psc
        return r

    # -- foreach -------------------------------------------------------------

    def _validate_foreach(self) -> Optional[RuleResponse]:
        # reference: pkg/engine/validation.go:319 validateForEach
        apply_count = 0
        for foreach in self.foreach or []:
            try:
                elements = self._evaluate_list(foreach.get('list', ''))
            except (ContextError, InvalidVariableError):
                continue
            resp, count = self._validate_elements(foreach, elements,
                                                  foreach.get('elementScope'))
            if resp.status != RuleStatus.PASS:
                return resp
            apply_count += count
        if apply_count == 0:
            if not self.foreach:
                return None
            return _rule_response(self.rule, RuleType.VALIDATION,
                                  'rule skipped', RuleStatus.SKIP)
        return _rule_response(self.rule, RuleType.VALIDATION, 'rule passed',
                              RuleStatus.PASS)

    def _evaluate_list(self, jmespath_expr: str) -> List[Any]:
        result = self.pctx.json_context.query(jmespath_expr)
        if isinstance(result, list):
            return result
        return [result]

    def _validate_elements(self, foreach: dict, elements: List[Any],
                           element_scope: Optional[bool]):
        # reference: pkg/engine/validation.go:347 validateElements
        ctx = self.pctx.json_context
        ctx.checkpoint()
        try:
            apply_count = 0
            for index, element in enumerate(elements):
                if element is None:
                    continue
                ctx.reset()
                pctx = self.pctx.copy()
                try:
                    _add_element_to_context(pctx, element, index, self.nesting,
                                            element_scope)
                except ValueError as e:
                    return (_rule_error(self.rule, RuleType.VALIDATION,
                                        'failed to process foreach', e),
                            apply_count)
                sub = Validator(self.engine, pctx, self.rule,
                                foreach_entry=foreach,
                                nesting=self.nesting + 1)
                r = sub.validate()
                if r is None or r.status == RuleStatus.SKIP:
                    continue
                if r.status != RuleStatus.PASS:
                    if r.status == RuleStatus.ERROR and index < len(elements) - 1:
                        continue
                    return (_rule_response(
                        self.rule, RuleType.VALIDATION,
                        f'validation failure: {r.message}', r.status),
                        apply_count)
                apply_count += 1
            return (_rule_response(self.rule, RuleType.VALIDATION, '',
                                   RuleStatus.PASS), apply_count)
        finally:
            ctx.restore()


def _add_element_to_context(pctx: PolicyContext, element: Any, index: int,
                            nesting: int, element_scope: Optional[bool]) -> None:
    # reference: pkg/engine/validation.go:391 addElementToContext
    pctx.json_context.add_element(element, index, nesting)
    is_map = isinstance(element, dict)
    scoped = is_map
    if element_scope is not None:
        if element_scope and not is_map:
            raise ValueError(
                'cannot use elementScope=true foreach rules for elements that '
                f'are not maps, expected type=map got type={type(element).__name__}')
        scoped = element_scope
    if scoped:
        pctx.set_element(element)
