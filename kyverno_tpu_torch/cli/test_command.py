"""``kyverno test`` — run YAML-defined fixtures and compare expected results.

Reference: cmd/cli/kubectl-kyverno/test/test_command.go — loads
``kyverno-test.yaml`` (policies, resources, variables, userinfo, results),
applies each policy to each resource through the engine with the mock
context loader, then checks every expected (policy, rule, resource) row
against the actual rule statuses (buildPolicyResults, test_command.go:430).
"""

from __future__ import annotations

import fnmatch
import os
from typing import Any, Dict, List, Optional, Tuple

import yaml

from ..autogen.autogen import compute_rules
from ..engine.api import EngineResponse, RuleStatus, RuleType
from ..engine.engine import Engine
from .common import (ApplyResult, MockContextLoader, Values,
                     apply_policy_on_resource, load_policies_from_paths,
                     load_resources_from_paths, load_user_info, load_values)
from .store import get_store, reset_store

TEST_FILE_NAMES = ('kyverno-test.yaml', 'kyverno-test.yml')


class TestCase:
    """One expected-result row (reference: test/api/types.go TestResults)."""

    def __init__(self, raw: dict):
        self.policy = raw.get('policy', '')
        self.rule = raw.get('rule', '')
        self.resource = raw.get('resource', '')
        self.resources = raw.get('resources') or []
        self.kind = raw.get('kind', '')
        self.namespace = raw.get('namespace', '')
        self.status = raw.get('status') or raw.get('result') or ''
        self.patched_resource = raw.get('patchedResource', '')
        self.generated_resource = raw.get('generatedResource', '')
        self.clone_source_resource = raw.get('cloneSourceResource', '')

    def target_resources(self) -> List[str]:
        return self.resources if self.resources else [self.resource]


class TestRow:
    def __init__(self, policy: str, rule: str, resource: str,
                 expected: str, actual: str):
        self.policy = policy
        self.rule = rule
        self.resource = resource
        self.expected = expected
        self.actual = actual

    @property
    def ok(self) -> bool:
        return self.expected == self.actual


def _load_yaml(path: str) -> dict:
    with open(path, encoding='utf-8') as f:
        return yaml.safe_load(f) or {}


def _load_expected_resource(path: str) -> dict:
    """Load an expected patched/generated resource with the same namespace
    defaulting the CLI applies to inputs (reference: fetch.go:310)."""
    doc = _load_yaml(path)
    meta = doc.setdefault('metadata', {})
    if not meta.get('namespace'):
        meta['namespace'] = 'default'
    return doc


def find_test_files(path: str) -> List[str]:
    """Recursively find kyverno-test.yaml files under ``path``."""
    out: List[str] = []
    if os.path.isfile(path):
        return [path]
    for root, _dirs, files in os.walk(path):
        for name in files:
            if name in TEST_FILE_NAMES:
                out.append(os.path.join(root, name))
    return sorted(out)


def run_test_file(test_file: str,
                  registry_access: bool = False) -> Tuple[str, List[TestRow]]:
    """Run one kyverno-test.yaml; returns (test name, result rows)."""
    base = os.path.dirname(os.path.abspath(test_file))
    doc = _load_yaml(test_file)
    name = doc.get('name', os.path.basename(base))
    store = reset_store()
    store.mock = True
    store.registry_access = registry_access

    values = Values()
    if doc.get('variables'):
        values = load_values(os.path.join(base, doc['variables']))
    store.set_policies(values.policies)
    store.subresources = values.subresources

    user_info = None
    if doc.get('userinfo'):
        user_info = load_user_info(os.path.join(base, doc['userinfo']))

    policies = load_policies_from_paths(
        [os.path.join(base, p) for p in doc.get('policies') or []])
    resources = load_resources_from_paths(
        [os.path.join(base, r) for r in doc.get('resources') or []])

    cases = [TestCase(r) for r in doc.get('results') or []]

    # CloneSourceResource per generate rule (test_command.go:720ish)
    rule_to_clone_source: Dict[str, dict] = {}
    for case in cases:
        if case.clone_source_resource:
            src = _load_yaml(os.path.join(base, case.clone_source_resource))
            if case.rule:
                rule_to_clone_source[case.rule] = src

    engine = Engine(context_loader=MockContextLoader(store))
    ns_map = values.namespace_selector_map()

    # (policy, kind, namespace, resource_name) -> ApplyResult
    applied: Dict[Tuple[str, str, str, str], ApplyResult] = {}
    for policy in policies:
        for resource in resources:
            meta = resource.get('metadata') or {}
            rname = meta.get('name', '')
            rkind = resource.get('kind', '')
            rns = meta.get('namespace', '')
            variables = dict(values.global_values)
            variables.update(values.resource_values(policy.name, rname))
            result = apply_policy_on_resource(
                policy, resource, engine=engine, variables=variables,
                user_info=user_info, namespace_selector_map=ns_map,
                rule_to_clone_source=rule_to_clone_source,
                subresources=values.subresources)
            applied[(policy.name, rkind, rns, rname)] = result

    unscored = {p.name for p in policies
                if (p.annotations or {}).get(
                    'policies.kyverno.io/scored') == 'false'}
    rows: List[TestRow] = []
    for case in cases:
        for target in case.target_resources():
            actual = _actual_status(case, target, applied, base)
            # reference: common.go:739 — scored=false downgrades fail→warn
            if actual == RuleStatus.FAIL and case.policy in unscored:
                actual = RuleStatus.WARN
            rows.append(TestRow(case.policy, case.rule, target,
                                case.status, actual))
    return name, rows


def _match_resource(case: TestCase, target: str,
                    applied: Dict[Tuple[str, str, str, str], ApplyResult]
                    ) -> Optional[ApplyResult]:
    candidates = []
    for (pname, kind, ns, rname), result in applied.items():
        if pname != case.policy or rname != target:
            continue
        if case.kind and kind != case.kind:
            continue
        if case.namespace and ns not in (case.namespace, ''):
            continue
        candidates.append(result)
    return candidates[0] if candidates else None


def _actual_status(case: TestCase, target: str,
                   applied: Dict[Tuple[str, str, str, str], ApplyResult],
                   base: str) -> str:
    result = _match_resource(case, target, applied)
    if result is None:
        return RuleStatus.SKIP
    rule_names = [r.name
                  for resp in result.engine_responses
                  for r in resp.policy_response.rules]
    rule_name = case.rule
    if rule_name not in rule_names:
        # reference: test_command.go:482 autogen rule name fallback
        if 'autogen-' + rule_name in rule_names:
            rule_name = 'autogen-' + rule_name
        elif 'autogen-cronjob-' + rule_name in rule_names:
            rule_name = 'autogen-cronjob-' + rule_name
        else:
            return RuleStatus.SKIP
    for resp in result.engine_responses:
        for rule in resp.policy_response.rules:
            if rule.name != rule_name:
                continue
            if rule.rule_type == RuleType.MUTATION:
                return _mutation_status(case, rule, result, base)
            if rule.rule_type == RuleType.GENERATION:
                return _generation_status(case, rule, base)
            return rule.status
    return RuleStatus.SKIP


def _mutation_status(case: TestCase, rule, result: ApplyResult,
                     base: str) -> str:
    # reference: test_command.go:578 mutation result comparison
    if rule.status in (RuleStatus.SKIP, RuleStatus.ERROR):
        return rule.status
    if not case.patched_resource:
        return rule.status
    try:
        expected = _load_expected_resource(
            os.path.join(base, case.patched_resource))
    except yaml.YAMLError:
        # unreadable expected resource compares as a failure
        # (reference: test_command.go getAndCompareResource load error)
        return RuleStatus.FAIL
    actual = result.patched_resource or {}
    return RuleStatus.PASS if _normalize(actual) == _normalize(expected) \
        else RuleStatus.FAIL


def _generation_status(case: TestCase, rule, base: str) -> str:
    # reference: test_command.go:545 generation result comparison
    if rule.status in (RuleStatus.SKIP, RuleStatus.ERROR):
        return rule.status
    if not case.generated_resource:
        return rule.status
    try:
        expected = _load_expected_resource(os.path.join(
            base, case.generated_resource))
    except yaml.YAMLError:
        return RuleStatus.FAIL
    actual = rule.generated_resource or {}
    return RuleStatus.PASS if _normalize(actual) == _normalize(expected) \
        else RuleStatus.FAIL


def _normalize(resource: Any) -> Any:
    """Drop fields the CLI strips before comparing
    (reference: test_command.go getAndCompareResource →
    common.GetResourceFromPath + unstructured cleanup)."""
    if isinstance(resource, dict):
        out = {}
        for k, v in resource.items():
            if k in ('status',):
                continue
            out[k] = _normalize(v)
        meta = out.get('metadata')
        if isinstance(meta, dict):
            for drop in ('creationTimestamp', 'resourceVersion', 'uid',
                         'generation', 'managedFields'):
                meta.pop(drop, None)
            if 'labels' in meta and isinstance(meta['labels'], dict):
                for label in list(meta['labels']):
                    if label.startswith(('policy.kyverno.io/',
                                         'generate.kyverno.io/',
                                         'app.kubernetes.io/managed-by',
                                         'kyverno.io/')):
                        meta['labels'].pop(label)
                if not meta['labels']:
                    meta.pop('labels')
        return out
    if isinstance(resource, list):
        return [_normalize(v) for v in resource]
    return resource


def format_rows(name: str, rows: List[TestRow],
                detailed_results: bool = False) -> str:
    lines = [f'Executing {name}...']
    width_p = max([len('POLICY')] + [len(r.policy) for r in rows])
    width_r = max([len('RULE')] + [len(r.rule) for r in rows])
    width_s = max([len('RESOURCE')] + [len(r.resource) for r in rows])
    lines.append(f'{"#":<4}{"POLICY":<{width_p + 2}}{"RULE":<{width_r + 2}}'
                 f'{"RESOURCE":<{width_s + 2}}RESULT')
    for i, row in enumerate(rows, 1):
        verdict = 'Pass' if row.ok else \
            f'Fail (expected {row.expected}, got {row.actual})'
        lines.append(f'{i:<4}{row.policy:<{width_p + 2}}'
                     f'{row.rule:<{width_r + 2}}'
                     f'{row.resource:<{width_s + 2}}{verdict}')
    return '\n'.join(lines)


def command(args) -> int:
    paths = args.paths or ['.']
    test_files: List[str] = []
    for p in paths:
        test_files.extend(find_test_files(p))
    if args.file_name and args.file_name not in TEST_FILE_NAMES:
        test_files = [f for f in test_files
                      if os.path.basename(f) == args.file_name] or [
            os.path.join(p, args.file_name) for p in paths]
    if not test_files:
        print('no test yamls available')
        return 1
    total = passed = 0
    failed_rows: List[TestRow] = []
    for tf in test_files:
        try:
            name, rows = run_test_file(
                tf, registry_access=getattr(args, 'registry', False))
        except Exception as exc:  # noqa: BLE001
            print(f'Error: failed to execute {tf}: {exc}')
            if getattr(args, 'debug', False):
                raise
            total += 1
            continue
        if args.test_case_selector:
            sel = dict(kv.split('=', 1)
                       for kv in args.test_case_selector.split(','))
            rows = [r for r in rows
                    if fnmatch.fnmatch(r.policy, sel.get('policy', '*')) and
                    fnmatch.fnmatch(r.rule, sel.get('rule', '*')) and
                    fnmatch.fnmatch(r.resource, sel.get('resource', '*'))]
        print(format_rows(name, rows))
        print()
        total += len(rows)
        passed += sum(r.ok for r in rows)
        failed_rows.extend(r for r in rows if not r.ok)
    print(f'Test Summary: {total} tests ({passed} passed, '
          f'{total - passed} failed)')
    if failed_rows:
        print('Aggregated Failed Test Cases:')
        for r in failed_rows:
            print(f'  {r.policy}/{r.rule}/{r.resource}: expected '
                  f'{r.expected}, got {r.actual}')
        return 1
    return 0
