"""``kyverno apply`` — apply policies to resources from files.

Reference: cmd/cli/kubectl-kyverno/apply/apply_command.go — loads policies
and resources from paths, runs the engine per (policy, resource) pair, and
prints mutated output plus a pass/fail/warn/error/skip summary.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import yaml

from ..engine.api import RuleStatus, RuleType
from ..engine.engine import Engine
from ..reports.results import (calculate_summary,
                               engine_response_to_report_results,
                               sort_report_results)
from .common import (MockContextLoader, Values, apply_policy_on_resource,
                     load_policies_from_paths, load_resources_from_paths,
                     load_user_info, load_values)
from .store import reset_store


class ResultCounts:
    """reference: common.go ResultCounts"""

    def __init__(self):
        self.pass_ = 0
        self.fail = 0
        self.warn = 0
        self.error = 0
        self.skip = 0


def command(args) -> int:
    store = reset_store()
    store.mock = True
    store.registry_access = getattr(args, 'registry', False)

    values = Values()
    if args.values_file:
        values = load_values(args.values_file)
    store.set_policies(values.policies)
    store.subresources = values.subresources

    set_vars: Dict[str, str] = {}
    for kv in args.set or []:
        for pair in kv.split(','):
            if '=' in pair:
                k, v = pair.split('=', 1)
                set_vars[k.strip()] = v.strip()

    user_info = None
    if getattr(args, 'userinfo', None):
        user_info = load_user_info(args.userinfo)

    policies = load_policies_from_paths(args.paths)
    if not policies:
        print('no policies found')
        return 1
    resource_paths = args.resource or []
    resources = load_resources_from_paths(resource_paths)
    if not resources:
        print('no resources found')
        return 1

    # -o handling (reference: apply_command.go:298-318 checkMutateLogPath +
    # createFileOrFolder): a path whose last segment ends in .yml/.yaml is a
    # file — created (with parents) and truncated once per invocation, then
    # appended to; any other path is a directory — created if missing, and
    # each resource overwrites its own <name>-mutated.yaml inside it
    out_path = getattr(args, 'output', None)
    if out_path:
        try:
            if _mutate_path_is_dir(out_path):
                os.makedirs(out_path, exist_ok=True)
            else:
                parent = os.path.dirname(out_path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                open(out_path, 'w', encoding='utf-8').close()
        except OSError as exc:
            print(f'failed to create file/folder at {out_path}: {exc}')
            return 1

    rule_count = sum(
        len(p.spec.get('rules') or []) for p in policies)
    if not getattr(args, 'policy_report', False):
        print(f'\nApplying {len(policies)} policy rule(s) to '
              f'{len(resources)} resource(s)...\n')

    engine = Engine(context_loader=MockContextLoader(store))
    ns_map = values.namespace_selector_map()
    rc = ResultCounts()
    responses = []
    for policy in policies:
        for resource in resources:
            rname = (resource.get('metadata') or {}).get('name', '')
            variables = dict(values.global_values)
            variables.update(set_vars)
            variables.update(values.resource_values(policy.name, rname))
            result = apply_policy_on_resource(
                policy, resource, engine=engine, variables=variables,
                user_info=user_info, namespace_selector_map=ns_map,
                subresources=values.subresources)
            responses.extend(result.engine_responses)
            _count(result, rc, audit_warn=getattr(args, 'audit_warn', False))
            if getattr(args, 'output_mutate', True):
                _print_mutation(result, policy, resource, args)

    if getattr(args, 'policy_report', False):
        results: List[dict] = []
        for resp in responses:
            results.extend(engine_response_to_report_results(resp))
        sort_report_results(results)
        report = {
            'apiVersion': 'wgpolicyk8s.io/v1alpha2',
            'kind': 'ClusterPolicyReport',
            'metadata': {'name': 'clusterpolicyreport'},
            'results': results,
            'summary': calculate_summary(results),
        }
        print(yaml.safe_dump(report, sort_keys=False))
    else:
        for resp in responses:
            for rule in resp.policy_response.rules:
                if rule.status in (RuleStatus.FAIL, RuleStatus.ERROR):
                    pr = resp.policy_response
                    print(f'policy {pr.policy_name} -> resource '
                          f'{pr.resource_namespace}/{pr.resource_kind}/'
                          f'{pr.resource_name} failed: ')
                    print(f'{rule.name}: {rule.message}')
                    print()
    print(f'pass: {rc.pass_}, fail: {rc.fail}, warn: {rc.warn}, '
          f'error: {rc.error}, skip: {rc.skip}')
    return 1 if rc.fail or rc.error else 0


def _count(result, rc: ResultCounts, audit_warn: bool = False) -> None:
    for resp in result.engine_responses:
        audit = resp.get_validation_failure_action() == 'Audit' \
            if resp.policy is not None else False
        for rule in resp.policy_response.rules:
            if rule.status == RuleStatus.PASS:
                rc.pass_ += 1
            elif rule.status == RuleStatus.FAIL:
                if audit_warn and audit:
                    rc.warn += 1
                else:
                    rc.fail += 1
            elif rule.status == RuleStatus.WARN:
                rc.warn += 1
            elif rule.status == RuleStatus.ERROR:
                rc.error += 1
            elif rule.status == RuleStatus.SKIP:
                rc.skip += 1


def _mutate_path_is_dir(path: str) -> bool:
    """Extension-based dir/file split for -o (reference:
    apply_command.go:448 checkMutateLogPath — last dot-suffix of the last
    path segment must be yml/yaml for file mode)."""
    # no slash-stripping: "logs.yaml/" has last segment "" → directory,
    # exactly as the reference's strings.Split behaves
    last = path.split('/')[-1]
    return last.split('.')[-1] not in ('yml', 'yaml')


def _print_mutation(result, policy, resource, args) -> None:
    mutated = result.patched_resource
    if mutated is None or mutated == resource:
        return
    has_mutation = any(
        rule.rule_type == RuleType.MUTATION and rule.status == RuleStatus.PASS
        for resp in result.engine_responses
        for rule in resp.policy_response.rules)
    if not has_mutation:
        return
    text = yaml.safe_dump(mutated, sort_keys=False)
    rname = (resource.get('metadata') or {}).get('name', '')
    if getattr(args, 'output', None):
        # file mode appends within the run; dir mode overwrites one
        # <resource>-mutated.yaml per resource (reference:
        # utils/common/common.go:567-577 PrintMutatedOutput, filename from
        # common.go:934)
        path = args.output
        if _mutate_path_is_dir(path):
            path = os.path.join(path, f'{rname}-mutated.yaml')
            mode = 'w'
        else:
            mode = 'a'
        with open(path, mode, encoding='utf-8') as f:
            f.write(text + '\n---\n\n')
    else:
        print(f'\nmutate policy {policy.name} applied to '
              f'{resource.get("kind")}/{rname}:')
        sys.stdout.write(text + '\n---\n\n')
