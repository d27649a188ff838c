"""YAML scenario replay (reference: pkg/testrunner/scenario.go:30-50 +
test/scenarios corpus).

Each scenario file holds test cases (``---``-separated) naming a policy
file, a resource file, and the expected mutation / validation /
generation outcomes.  The runner mirrors runTestCase (scenario.go:136):
mutate → compare patched resource + rule responses, validate the
patched resource → compare, and for Namespace resources run the
generate path against a fake cluster and check the generated resources
exist.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import yaml

REF_ROOT = '/root/reference'


class ScenarioFailure(AssertionError):
    pass


def _load_docs(rel: str) -> List[dict]:
    path = os.path.join(REF_ROOT, rel.lstrip('/'))
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def _normalize(node: Any) -> Any:
    """Drop Go-marshalling artifacts (``creationTimestamp: null`` etc.)
    that the corpus' expected files carry from struct serialization."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if v is None and k == 'creationTimestamp':
                continue
            nv = _normalize(v)
            if nv == {}:
                # Go empty-struct artifacts (strategy: {}, status: {});
                # dropped from BOTH sides, so equality is preserved
                continue
            out[k] = nv
        return out
    if isinstance(node, list):
        return [_normalize(v) for v in node]
    return node


def _strip_empty(node: Any) -> Any:
    """Stand-in for the reference loader's typed-scheme round trip
    (scenario.go loadPolicyResource → runtime scheme): k8s structs drop
    omitempty fields, so empty strings/maps in the input YAML vanish
    before the engine sees the resource."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            sv = _strip_empty(v)
            if sv == '' or sv is None:
                # omitempty strings vanish; empty maps stay (a pointer
                # struct like emptyDir: {} survives the round trip)
                continue
            out[k] = sv
        return out
    if isinstance(node, list):
        return [_strip_empty(v) for v in node]
    return node


def _compare_rules(actual, expected_rules: List[dict], stage: str) -> None:
    """reference: scenario.go:261 — count equality, then in-order
    name/type/status/message comparison."""
    if len(actual) != len(expected_rules):
        raise ScenarioFailure(
            f'{stage}: rule count mismatch: got '
            f'{[(r.name, r.status) for r in actual]}, expected '
            f'{[(r.get("name"), r.get("status")) for r in expected_rules]}')
    for got, want in zip(actual, expected_rules):
        if want.get('name') and got.name != want['name']:
            raise ScenarioFailure(
                f'{stage}: rule name {got.name!r} != {want["name"]!r}')
        if want.get('type') and got.rule_type != want['type']:
            raise ScenarioFailure(
                f'{stage}: rule type {got.rule_type!r} != {want["type"]!r}')
        if want.get('status') and \
                str(got.status).lower() != str(want['status']).lower():
            raise ScenarioFailure(
                f'{stage}: rule {got.name} status {got.status!r} != '
                f'{want["status"]!r} ({got.message})')
        if want.get('message') and got.message != want['message']:
            raise ScenarioFailure(
                f'{stage}: rule {got.name} message {got.message!r} != '
                f'{want["message"]!r}')


def _compare_header(response, expected: dict, stage: str) -> None:
    pr = response.policy_response
    pol = expected.get('policy') or {}
    if pol.get('name') and pr.policy_name != pol['name']:
        raise ScenarioFailure(
            f'{stage}: policy name {pr.policy_name!r} != {pol["name"]!r}')
    res = expected.get('resource') or {}
    for field, got in (('kind', pr.resource_kind),
                       ('namespace', pr.resource_namespace),
                       ('name', pr.resource_name)):
        want = res.get(field)
        if want is not None and got != want:
            raise ScenarioFailure(
                f'{stage}: resource {field} {got!r} != {want!r}')


def run_scenario(rel_path: str) -> int:
    """Replay one scenario file; returns the number of test cases run."""
    from ..api.policy import Policy
    from ..engine.api import PolicyContext
    from ..engine.engine import Engine

    cases = _load_docs(rel_path)
    n = 0
    for tc in cases:
        inp = tc.get('input') or {}
        expected = tc.get('expected') or {}
        policy_doc = _load_docs(inp['policy'])[0]
        resource = _strip_empty(_load_docs(inp['resource'])[0])
        policy = Policy(policy_doc)
        engine = Engine()

        # --- mutation (scenario.go:155) ---
        pctx = PolicyContext(policy, new_resource=resource)
        er = engine.mutate(pctx)
        expected_mutation = expected.get('mutation') or {}
        patched_file = expected_mutation.get('patchedresource', '')
        if patched_file:
            want = _load_docs(patched_file)[0]
            if _normalize(er.patched_resource) != _normalize(want):
                raise ScenarioFailure(
                    f'patched resource mismatch:\n got: '
                    f'{er.patched_resource}\nwant: {want}')
        if expected_mutation.get('policyresponse'):
            _compare_header(er, expected_mutation['policyresponse'],
                            'mutation')
            _compare_rules(er.policy_response.rules,
                           expected_mutation['policyresponse'].get(
                               'rules') or [], 'mutation')
        if er.policy_response.rules and er.patched_resource is not None:
            resource = er.patched_resource

        # --- validation (scenario.go:167) ---
        pctx = PolicyContext(policy, new_resource=resource)
        er = engine.validate(pctx)
        expected_validation = (expected.get('validation') or {})
        if expected_validation.get('policyresponse'):
            _compare_header(er, expected_validation['policyresponse'],
                            'validation')
            _compare_rules(er.policy_response.rules,
                           expected_validation['policyresponse'].get(
                               'rules') or [], 'validation')

        # --- generation (scenario.go:177, Namespace triggers only) ---
        expected_generation = expected.get('generation') or {}
        if resource.get('kind') == 'Namespace' and expected_generation:
            from ..background.update_request_controller import \
                UpdateRequestController
            from ..background.updaterequest import UpdateRequestGenerator
            from ..dclient.client import FakeClient
            client = FakeClient()
            for extra_rel in inp.get('loadresources') or []:
                for doc in _load_docs(extra_rel):
                    meta = doc.get('metadata') or {}
                    client.create_resource(doc.get('apiVersion', ''),
                                           doc.get('kind', ''),
                                           meta.get('namespace', ''), doc)
            client.create_resource('v1', 'Namespace', '', resource)
            ns_name = (resource.get('metadata') or {}).get('name', '')
            gen = UpdateRequestGenerator(client)
            gen.apply({
                'type': 'generate', 'policy': policy.name,
                'resource': {'apiVersion': 'v1', 'kind': 'Namespace',
                             'name': ns_name, 'namespace': ''},
                'requestType': 'generate',
            })
            ctrl = UpdateRequestController(
                client, engine, policy_getter={policy.name: policy}.get)
            ctrl.process_pending()
            for spec in expected_generation.get('generatedResources') or []:
                try:
                    client.get_resource(spec.get('apiVersion', ''),
                                        spec.get('kind', ''), ns_name,
                                        spec.get('name', ''))
                except Exception:
                    raise ScenarioFailure(
                        f'generated resource {spec.get("kind")}/'
                        f'{ns_name}/{spec.get("name")} not found')
        n += 1
    return n
