"""kuttl step-replay harness (reference corpus:
/root/reference/test/conformance/kuttl — SURVEY.md §4).

Replays a kuttl test directory against the in-memory cluster + the real
daemons: numbered step files apply manifests through the admission
webhook chain (mutate → validate, enforce denials fail the apply, the
way the API server would), ``NN-assert.yaml`` subset-matches live CRs
after controller ticks, ``NN-errors.yaml`` asserts absence.  TestStep
``apply:`` entries honor ``shouldFail``; the common
``if kubectl apply -f X`` deny-check script pattern is recognized.
Unsupported commands surface as :class:`Unsupported` so callers can
list divergences instead of mis-reporting them as passes.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional, Tuple

import yaml

from ..cmd.admission_controller import AdmissionController
from ..cmd.background_controller import BackgroundController
from ..cmd.internal import Setup, base_parser
from ..cmd.reports_controller import ReportsController
from ..dclient.client import ApiError, FakeClient, NotFoundError


class KuttlFailure(AssertionError):
    """A replayed step diverged from the recorded expectation."""


class Unsupported(Exception):
    """The step uses a kuttl feature the replay harness cannot model."""


class AdmissionDenied(Exception):
    def __init__(self, message: str):
        super().__init__(message)


_STEP_RE = re.compile(r'^(\d+)-(.+)\.yaml$')
# the corpus' standard denial-check script shape
_DENY_SCRIPT_RE = re.compile(
    r'if\s+kubectl\s+apply\s+-f\s+(\S+)', re.MULTILINE)
_APPLY_CMD_RE = re.compile(r'^kubectl\s+apply\s+-f\s+(\S+)\s*$')


class KuttlCluster:
    """One in-memory cluster wired with the three daemons."""

    def __init__(self, device=None):
        self.client = FakeClient()
        setup = Setup('kuttl', [], base_parser('kuttl'), client=self.client)
        self.admission = AdmissionController(setup, tls=False, device=device)
        self.background = BackgroundController(setup)
        self.reports = ReportsController(setup, device=device)
        from ..controllers.cleanup import CleanupController
        self.cleanup = CleanupController(self.client)
        self._uid = 0
        self.client.create_resource('v1', 'Namespace', '', {
            'apiVersion': 'v1', 'kind': 'Namespace',
            'metadata': {'name': 'default'}})
        # the chart's install-time objects (aggregated ClusterRoles)
        # exist in any real cluster the corpus runs against
        from ..config.install import seed_install_manifests
        seed_install_manifests(self.client)

    # -- plumbing ----------------------------------------------------------

    def tick(self) -> None:
        self.admission.flush_audits()
        self.admission.tick()
        self.background.tick()
        self.reports.tick()
        # cleanup policies run on their cron; a tick stands in for the
        # corpus' sleep-past-the-minute steps.  Deleted policies must
        # also leave the controller or they keep firing.
        live = set()
        for kind in ('ClusterCleanupPolicy', 'CleanupPolicy'):
            for doc in self.client.list_resource(
                    'kyverno.io/v2alpha1', kind):
                self.cleanup.set_policy(doc)
                live.add(self.cleanup._key(doc))
        self.cleanup.retain_policies(live)
        self.cleanup.tick()
        self.admission.event_generator.drain(timeout=3)

    def _review(self, doc: dict, operation: str,
                old: Optional[dict], sub_resource: str = '') -> bytes:
        self._uid += 1
        meta = doc.get('metadata') or {}
        return json.dumps({
            'apiVersion': 'admission.k8s.io/v1', 'kind': 'AdmissionReview',
            'request': {
                'uid': f'kuttl-{self._uid}', 'operation': operation,
                'kind': {'group': '', 'version': 'v1',
                         'kind': doc.get('kind', '')},
                'subResource': sub_resource,
                'namespace': meta.get('namespace', ''),
                'name': meta.get('name', ''),
                'object': doc, 'oldObject': old,
                'userInfo': {'username': 'kuttl-admin',
                             'groups': ['system:masters']},
            }}).encode()

    def _ensure_namespace(self, doc: dict) -> None:
        ns = (doc.get('metadata') or {}).get('namespace', '')
        if not ns:
            return
        try:
            self.client.get_resource('v1', 'Namespace', '', ns)
        except NotFoundError:
            self.client.create_resource('v1', 'Namespace', '', {
                'apiVersion': 'v1', 'kind': 'Namespace',
                'metadata': {'name': ns}})

    # -- apply -------------------------------------------------------------

    #: kinds stored without a namespace (everything else defaults to
    #: 'default' when the manifest names none, the way kubectl does)
    _CLUSTER_SCOPED = {
        'Namespace', 'Node', 'ClusterPolicy', 'ClusterCleanupPolicy',
        'ClusterRole', 'ClusterRoleBinding', 'CustomResourceDefinition',
        'ValidatingWebhookConfiguration', 'MutatingWebhookConfiguration',
        'ClusterPolicyReport', 'ClusterAdmissionReport',
        'ClusterBackgroundScanReport', 'PriorityClass', 'StorageClass',
    }

    def apply_doc(self, doc: dict) -> None:
        """Apply one manifest the way ``kubectl apply`` + the admission
        chain would; raises AdmissionDenied on an enforce block."""
        kind = doc.get('kind', '')
        api_version = doc.get('apiVersion', '')
        meta = doc.setdefault('metadata', {})
        if kind not in self._CLUSTER_SCOPED and not meta.get('namespace'):
            meta['namespace'] = 'default'
        if kind in ('ClusterCleanupPolicy', 'CleanupPolicy'):
            # the cleanup controller's own admission webhook validates
            # these (cmd/cleanup-controller/handlers/admission/policy.go)
            from ..controllers.cleanup import validate_cleanup_admission
            resp = validate_cleanup_admission(
                {'uid': 'kuttl', 'object': doc}, self.client)
            if not resp.get('allowed', True):
                raise AdmissionDenied(
                    (resp.get('status') or {}).get('message', 'denied'))
            self._store(api_version, kind, meta.get('namespace', ''), doc)
            self.admission.tick()
            return
        if kind in ('ClusterPolicy', 'Policy'):
            # policy CR admission (reference: pkg/webhooks/policy/
            # handlers.go served at /policyvalidate)
            from ..policy.validate import validate_policy_admission
            resp = validate_policy_admission(
                {'uid': 'kuttl', 'object': doc}, self.client)
            if not resp.get('allowed', True):
                raise AdmissionDenied(
                    (resp.get('status') or {}).get('message', 'denied'))
            self._store(api_version, kind, meta.get('namespace', ''), doc)
            self.admission.tick()
            return
        if kind == 'PolicyException':
            self._store(api_version, kind, meta.get('namespace', ''), doc)
            self.admission.tick()
            return
        if kind == 'Deployment':
            # stand in for the deployment controller: kuttl asserts read
            # back rollout status a real cluster would converge to
            replicas = int((doc.get('spec') or {}).get('replicas', 1))
            doc.setdefault('status', {
                'replicas': replicas, 'readyReplicas': replicas,
                'availableReplicas': replicas,
                'updatedReplicas': replicas,
                'conditions': [{'type': 'Available', 'status': 'True',
                                'reason': 'MinimumReplicasAvailable'}],
            })
        if kind == 'CustomResourceDefinition':
            # the API server populates acceptedNames/conditions on CRD
            # create; asserts in the corpus read them back
            doc.setdefault('status', {
                'acceptedNames': dict(
                    (doc.get('spec') or {}).get('names') or {},
                    categories=((doc.get('spec') or {}).get('names') or
                                {}).get('categories', ['all'])),
                'conditions': [
                    {'type': 'NamesAccepted', 'status': 'True',
                     'reason': 'NoConflicts',
                     'message': 'no conflicts found'},
                    {'type': 'Established', 'status': 'True',
                     'reason': 'InitialNamesAccepted',
                     'message': 'the initial names have been accepted'},
                ],
                'storedVersions': [
                    v.get('name') for v in
                    ((doc.get('spec') or {}).get('versions') or [])
                    if v.get('storage')],
            })
        self._ensure_namespace(doc)
        exists, old = self._existing(api_version, kind, doc)
        operation = 'UPDATE' if exists else 'CREATE'
        # the API server assigns the uid before admission webhooks run
        if exists:
            doc.setdefault('metadata', {}).setdefault(
                'uid', (old.get('metadata') or {}).get('uid', ''))
        else:
            self._uid += 1
            doc.setdefault('metadata', {}).setdefault(
                'uid', f'kuttl-uid-{self._uid}')
        # API-server order: mutating webhooks run before validating ones
        body = self.admission.server.handle(
            '/mutate', self._review(doc, operation, old))
        resp = json.loads(body)['response']
        if not resp.get('allowed', True):
            raise AdmissionDenied(
                (resp.get('status') or {}).get('message', 'denied'))
        patched = doc
        patch_b64 = resp.get('patch')
        if patch_b64:
            import base64
            from ..engine.mutate.jsonpatch import apply_patch
            patched = apply_patch(
                json.loads(json.dumps(doc)),
                json.loads(base64.b64decode(patch_b64)))
        body = self.admission.server.handle(
            '/validate', self._review(patched, operation, old))
        resp = json.loads(body)['response']
        if not resp.get('allowed', True):
            raise AdmissionDenied(
                (resp.get('status') or {}).get('message', 'denied'))
        self._store(api_version, kind, (patched.get('metadata') or
                                        {}).get('namespace', ''), patched)

    def close(self) -> None:
        """Reap worker threads (a conformance run spins up many
        clusters; leaked event workers busy-poll the queue forever)."""
        self.admission.close()

    def delete_doc(self, api_version: str, kind: str, namespace: str,
                   name: str) -> None:
        """Delete through the admission chain (DELETE reviews carry the
        old object and can spawn mutate-existing URs / be denied)."""
        try:
            old = self.client.get_resource(api_version, kind, namespace,
                                           name)
        except ApiError:
            raise NotFoundError(f'{kind} "{name}" not found')
        self._uid += 1
        review = json.dumps({
            'apiVersion': 'admission.k8s.io/v1', 'kind': 'AdmissionReview',
            'request': {
                'uid': f'kuttl-{self._uid}', 'operation': 'DELETE',
                'kind': {'group': '', 'version': 'v1', 'kind': kind},
                'namespace': namespace, 'name': name,
                'object': None, 'oldObject': old,
                'userInfo': {'username': 'kuttl-admin',
                             'groups': ['system:masters']},
            }}).encode()
        body = self.admission.server.handle('/validate', review)
        resp = json.loads(body)['response']
        if not resp.get('allowed', True):
            raise AdmissionDenied(
                (resp.get('status') or {}).get('message', 'denied'))
        self.client.delete_resource(api_version, kind, namespace, name)

    def _existing(self, api_version: str, kind: str,
                  doc: dict) -> Tuple[bool, Optional[dict]]:
        meta = doc.get('metadata') or {}
        try:
            old = self.client.get_resource(
                api_version, kind, meta.get('namespace', ''),
                meta.get('name', ''))
            return True, old
        except ApiError:
            return False, None

    def _store(self, api_version: str, kind: str, namespace: str,
               doc: dict) -> None:
        try:
            self.client.create_resource(api_version, kind, namespace, doc)
        except ApiError:
            current = self.client.get_resource(
                api_version, kind, namespace,
                (doc.get('metadata') or {}).get('name', ''))
            merged = dict(doc)
            merged.setdefault('metadata', {})['resourceVersion'] = \
                (current.get('metadata') or {}).get('resourceVersion')
            self.client.update_resource(api_version, kind, namespace,
                                        merged)

    # -- asserts -----------------------------------------------------------

    def assert_doc(self, expected: dict, rounds: int = 5) -> None:
        """kuttl assert: some live resource must subset-match; controller
        ticks stand in for kuttl's polling."""
        last = None
        for _ in range(rounds):
            ok, last = self._match_once(expected)
            if ok:
                return
            self.tick()
        raise KuttlFailure(
            f'no live {expected.get("kind")} matches assert '
            f'{json.dumps(expected)[:300]}; closest: '
            f'{json.dumps(last)[:300] if last else "none"}')

    def assert_absent(self, expected: dict, rounds: int = 2) -> None:
        for _ in range(rounds):
            self.tick()
        ok, matched = self._match_once(expected)
        if ok:
            raise KuttlFailure(
                f'{expected.get("kind")} unexpectedly present: '
                f'{json.dumps(matched)[:300]}')

    def _match_once(self, expected: dict
                    ) -> Tuple[bool, Optional[dict]]:
        kind = expected.get('kind', '')
        api_version = expected.get('apiVersion', '')
        if api_version.startswith('kyverno.io/'):
            # policy CRDs are multi-version served; the fake stores one
            # version, asserts may name another — conversion-equivalent
            expected = dict(expected)
            expected.pop('apiVersion')
            api_version = ''
        meta = expected.get('metadata') or {}
        name = meta.get('name', '')
        ns = meta.get('namespace', '')
        candidates = []
        if name:
            try:
                candidates = [self.client.get_resource(
                    api_version, kind, ns, name)]
            except ApiError:
                # report CR names are nondeterministic; fall back to a
                # kind-wide sweep
                candidates = self.client.list_resource('', kind, ns)
        else:
            candidates = self.client.list_resource('', kind, ns)
        best = candidates[0] if candidates else None
        for cand in candidates:
            if _subset(expected, cand, skip_keys={'resourceVersion'}):
                return True, cand
        return False, best


def _subset(expected: Any, actual: Any, skip_keys=frozenset()) -> bool:
    """kuttl subset matching: every expected field must be present and
    equal; lists match index-wise as subsets."""
    if isinstance(expected, dict):
        if not isinstance(actual, dict):
            return False
        for k, v in expected.items():
            if k in skip_keys:
                continue
            if k not in actual:
                return False
            if not _subset(v, actual[k], skip_keys):
                return False
        return True
    if isinstance(expected, list):
        if not isinstance(actual, list) or len(actual) < len(expected):
            return False
        return all(_subset(e, a, skip_keys)
                   for e, a in zip(expected, actual))
    if isinstance(expected, (int, float)) and \
            isinstance(actual, (int, float)):
        return float(expected) == float(actual)
    return expected == actual


def _load_docs(path: str) -> List[dict]:
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def run_suite(suite_dir: str, device=None) -> None:
    """Replay one kuttl test directory; raises KuttlFailure on
    divergence, Unsupported on unreplayable steps.  ``device`` is the
    daemons' torch device (``None``: the CUDA card)."""
    cluster = KuttlCluster(device=device)
    steps = []
    for name in os.listdir(suite_dir):
        m = _STEP_RE.match(name)
        if m:
            label = m.group(2)
            # kuttl runs the index's step first, then checks its assert
            # and error files
            if label == 'assert' or label.endswith('-assert'):
                rank = 1
            elif label in ('errors', 'error') or label.endswith('-errors'):
                rank = 2
            else:
                rank = 0
            steps.append((int(m.group(1)), rank, label, name))
    steps.sort()
    steps = [(num, label, name) for num, _rank, label, name in steps]
    try:
        _run_steps(cluster, suite_dir, steps)
    finally:
        cluster.close()


def _run_steps(cluster: KuttlCluster, suite_dir: str, steps) -> None:
    for _num, label, name in steps:
        path = os.path.join(suite_dir, name)
        docs = _load_docs(path)
        if label == 'assert' or label.endswith('-assert'):
            for doc in docs:
                if doc.get('kind') == 'TestAssert':
                    # timeout/collector tuning — ticks stand in for the
                    # poll budget; replay its command list if any
                    for c in doc.get('commands') or []:
                        _run_command(cluster, suite_dir, c)
                    continue
                cluster.assert_doc(doc)
            continue
        if label in ('errors', 'error') or label.endswith('-errors'):
            for doc in docs:
                if doc.get('kind') == 'TestAssert':
                    continue
                cluster.assert_absent(doc)
            continue
        for doc in docs:
            if doc.get('kind') == 'TestStep':
                _run_test_step(cluster, suite_dir, doc)
            else:
                cluster.apply_doc(doc)
        cluster.tick()


def _run_test_step(cluster: KuttlCluster, suite_dir: str,
                   step: dict) -> None:
    for entry in step.get('delete') or []:
        ref = entry.get('ref') or entry
        try:
            cluster.delete_doc(
                ref.get('apiVersion', ''), ref.get('kind', ''),
                ref.get('namespace', ''), ref.get('name', ''))
        except ApiError:
            pass
    for entry in step.get('apply') or []:
        if isinstance(entry, str):
            fname, should_fail = entry, False
        else:
            fname = entry.get('file', '')
            should_fail = bool(entry.get('shouldFail'))
        _apply_file(cluster, os.path.join(suite_dir, fname), should_fail)
    for cmd in step.get('commands') or []:
        _run_command(cluster, suite_dir, cmd)
    for fname in step.get('assert') or []:
        for doc in _load_docs(os.path.join(suite_dir, fname)):
            cluster.assert_doc(doc)
    for fname in step.get('error') or []:
        for doc in _load_docs(os.path.join(suite_dir, fname)):
            cluster.assert_absent(doc)


def _apply_file(cluster: KuttlCluster, path: str, should_fail: bool,
                deny_phrase: Optional[str] = None) -> None:
    denied: Optional[AdmissionDenied] = None
    for doc in _load_docs(path):
        try:
            cluster.apply_doc(doc)
        except AdmissionDenied as e:
            denied = e
    if should_fail and denied is None:
        raise KuttlFailure(
            f'{os.path.basename(path)} applied cleanly but the corpus '
            f'expects a denial')
    if not should_fail and denied is not None:
        raise KuttlFailure(
            f'{os.path.basename(path)} denied unexpectedly: {denied}')
    if should_fail and deny_phrase and deny_phrase not in str(denied):
        raise KuttlFailure(
            f'{os.path.basename(path)} denied, but the message lacks the '
            f'expected phrase {deny_phrase!r}: {denied}')
    cluster.tick()


#: kubectl short-name / plural aliases the corpus uses
_KIND_ALIASES = {
    'cpol': ('kyverno.io/v1', 'ClusterPolicy'),
    'clusterpolicy': ('kyverno.io/v1', 'ClusterPolicy'),
    'clusterpolicies': ('kyverno.io/v1', 'ClusterPolicy'),
    'pol': ('kyverno.io/v1', 'Policy'),
    'policy': ('kyverno.io/v1', 'Policy'),
    'policies': ('kyverno.io/v1', 'Policy'),
    'polex': ('kyverno.io/v2beta1', 'PolicyException'),
    'ur': ('kyverno.io/v1beta1', 'UpdateRequest'),
    'updaterequest': ('kyverno.io/v1beta1', 'UpdateRequest'),
    'updaterequests': ('kyverno.io/v1beta1', 'UpdateRequest'),
    'pod': ('v1', 'Pod'), 'pods': ('v1', 'Pod'), 'po': ('v1', 'Pod'),
    'ns': ('v1', 'Namespace'), 'namespace': ('v1', 'Namespace'),
    'namespaces': ('v1', 'Namespace'),
    'cm': ('v1', 'ConfigMap'), 'configmap': ('v1', 'ConfigMap'),
    'configmaps': ('v1', 'ConfigMap'),
    'secret': ('v1', 'Secret'), 'secrets': ('v1', 'Secret'),
    'svc': ('v1', 'Service'), 'service': ('v1', 'Service'),
    'deploy': ('apps/v1', 'Deployment'),
    'deployment': ('apps/v1', 'Deployment'),
    'deployments': ('apps/v1', 'Deployment'),
    'node': ('v1', 'Node'), 'nodes': ('v1', 'Node'),
    'netpol': ('networking.k8s.io/v1', 'NetworkPolicy'),
    'cleanuppolicy': ('kyverno.io/v2alpha1', 'CleanupPolicy'),
    'clustercleanuppolicy': ('kyverno.io/v2alpha1',
                             'ClusterCleanupPolicy'),
    'crd': ('apiextensions.k8s.io/v1', 'CustomResourceDefinition'),
    'crds': ('apiextensions.k8s.io/v1', 'CustomResourceDefinition'),
}


def _do_scale(cluster: KuttlCluster, kind_tok: str, name: str, ns: str,
              replicas: int, expect_deny: bool,
              phrase: Optional[str]) -> None:
    """Replay ``kubectl scale`` as the scale-subresource UPDATE it is:
    policies match ``<Kind>/scale`` (reference: the webhook registers
    the deployments/scale resource and the engine matches subresources,
    pkg/utils/match CheckKind)."""
    import copy as _copy
    resolved = _resolve_kind(cluster, kind_tok)
    if resolved is None:
        raise Unsupported(f'scale kind {kind_tok!r} unknown')
    api_version, kind = resolved
    try:
        current = cluster.client.get_resource(api_version or 'apps/v1',
                                              kind, ns, name)
    except ApiError:
        raise Unsupported(f'scale target {kind}/{name} not found')
    patched = _copy.deepcopy(current)
    patched.setdefault('spec', {})['replicas'] = replicas
    body = cluster.admission.server.handle(
        '/validate', cluster._review(patched, 'UPDATE', current,
                                     sub_resource='scale'))
    resp = json.loads(body)['response']
    allowed = resp.get('allowed', True)
    message = (resp.get('status') or {}).get('message', '')
    if expect_deny and allowed:
        raise KuttlFailure(f'scale of {kind}/{name} was not denied')
    if not expect_deny and not allowed:
        raise KuttlFailure(f'scale of {kind}/{name} denied: {message}')
    if expect_deny and phrase and phrase not in message:
        raise KuttlFailure(
            f'scale denial message lacks {phrase!r}: {message}')
    if allowed:
        patched['status'] = dict(patched.get('status') or {},
                                 replicas=replicas)
        cluster.client.update_resource(
            patched.get('apiVersion', api_version), kind, ns, patched)
    cluster.tick()


def _do_patch(cluster: KuttlCluster, argstr: str, expect_deny: bool,
              phrase: Optional[str]) -> None:
    """Replay ``kubectl patch <Kind> <name> [-n ns] --type=t -p=<doc>``
    through the admission chain as the UPDATE it performs."""
    toks = argstr.split()
    if len(toks) < 2:
        raise Unsupported(f'patch args not replayable: {argstr[:80]!r}')
    kind_tok, name = toks[0], toks[1]
    api_version, kind = _KIND_ALIASES.get(
        kind_tok.lower(), ('', kind_tok))
    ns = _flag_value(toks, '-n') or _flag_value(toks, '--namespace') or ''
    ptype = (_flag_value(toks, '--type') or 'strategic').strip("'\"")
    mp = re.search(r'(?:^|\s)-p=?\s*(.+)$', argstr, re.S)
    if not mp:
        raise Unsupported(f'patch without -p: {argstr[:80]!r}')
    payload = mp.group(1).strip()
    # tiered un-quoting: try the payload as-is first (empty-string
    # values are legitimate), then undo the corpus scripts' shell
    # quoting (\" escapes, "" concatenation seams)
    def _valid(d):
        if isinstance(d, dict):
            return True
        return isinstance(d, list) and d and all(
            isinstance(o, dict) and 'op' in o for o in d)

    doc = None
    for candidate in (payload.strip('"\''),
                      payload.strip('"').replace('\\"', '"'),
                      payload.strip('"').replace('\\"', '"')
                      .replace('""', '')):
        try:
            parsed = yaml.safe_load(candidate)
        except Exception:  # noqa: BLE001 - try the next unquoting tier
            continue
        if _valid(parsed):
            doc = parsed
            break
    if doc is None:
        raise Unsupported(f'unparseable patch payload: {payload[:80]!r}')
    try:
        current = cluster.client.get_resource(api_version, kind, ns, name)
    except ApiError:
        raise Unsupported(f'patch target {kind}/{name} not found')
    if ptype == 'json':
        from ..engine.mutate.jsonpatch import apply_patch
        patched = apply_patch(current, doc)
    else:
        from ..engine.mutate.strategic import strategic_merge
        patched = strategic_merge(current, doc)
    denied: Optional[AdmissionDenied] = None
    try:
        cluster.apply_doc(patched)
    except AdmissionDenied as e:
        denied = e
    if expect_deny and denied is None:
        raise KuttlFailure(
            f'patch of {kind}/{name} applied cleanly but the corpus '
            f'expects a denial')
    if not expect_deny and denied is not None:
        raise KuttlFailure(f'patch of {kind}/{name} denied: {denied}')
    if expect_deny and phrase and phrase not in str(denied):
        raise KuttlFailure(
            f'patch denial message lacks the expected phrase '
            f'{phrase!r}: {denied}')
    cluster.tick()


def _resolve_kind(cluster: KuttlCluster, token: str
                  ) -> Optional[Tuple[str, str]]:
    """(apiVersion, Kind) for a kubectl kind token: the static alias
    table first, then the live store (covers custom resources whose CRDs
    the suite itself created)."""
    hit = _KIND_ALIASES.get(token.lower())
    if hit is not None:
        return hit
    t = token.lower()
    for obj in cluster.client.list_resource('', '', ''):
        kind = obj.get('kind', '')
        low = kind.lower()
        if t in (low, low + 's', low + 'es',
                 (low[:-1] + 'ies') if low.endswith('y') else low):
            return obj.get('apiVersion', ''), kind
    return None


def _flag_value(tokens: List[str], flag: str) -> Optional[str]:
    for i, tok in enumerate(tokens):
        if tok == flag and i + 1 < len(tokens):
            return tokens[i + 1]
        if tok.startswith(flag + '='):
            return tok.split('=', 1)[1]
    return None


def _run_command(cluster: KuttlCluster, suite_dir: str,
                 cmd: dict) -> None:
    script = cmd.get('script', '') or cmd.get('command', '')
    if isinstance(script, list):
        script = ' '.join(str(s) for s in script)
    sm = re.search(
        r'if\s+kubectl\s+scale\s+(\S+)\s+(\S+)\s+--replicas[= ](\d+)'
        r'(?:\s+-n\s+(\S+))?.*?grep\s+-q\s+(["\'])(.*?)\5', script, re.S)
    if sm is None:
        sm2 = re.match(
            r'^kubectl\s+scale\s+(\S+)\s+(\S+)\s+--replicas[= ](\d+)'
            r'(?:\s+-n\s+(\S+))?', script.strip())
        if sm2 is not None:
            _do_scale(cluster, sm2.group(1), sm2.group(2),
                      sm2.group(4) or 'default', int(sm2.group(3)),
                      expect_deny=False, phrase=None)
            return
    else:
        _do_scale(cluster, sm.group(1), sm.group(2),
                  sm.group(4) or 'default', int(sm.group(3)),
                  expect_deny=True, phrase=sm.group(6))
        return
    pm = re.search(
        r'if\s+kubectl\s+patch\s+(.+?)\s+2>&1\s*\|\s*grep\s+-q\s+'
        r'(["\'])(.*?)\2', script, re.S)
    if pm:
        _do_patch(cluster, pm.group(1), expect_deny=True,
                  phrase=pm.group(3))
        return
    m = re.match(r'^kubectl\s+patch\s+(.+)$', script.strip(), re.S)
    if m:
        _do_patch(cluster, m.group(1), expect_deny=False, phrase=None)
        return
    m = _DENY_SCRIPT_RE.search(script)
    if m:
        # the corpus writes both polarities of this script: the branch
        # that exits 0 tells us whether the apply is expected to be
        # denied (grep-on-error / plain-if with exit 1 in then) or to
        # succeed (plain-if with exit 0 in then)
        phrase = None
        pm = re.search(r"grep\s+-q\s+'([^']+)'", script) or \
            re.search(r'grep\s+-q\s+"([^"]+)"', script)
        if pm:
            phrase = pm.group(1)
        bm = re.search(r'\bthen\b(.*?)(?:\belse\b(.*?))?\bfi\b', script,
                       re.S)
        then_block = bm.group(1) if bm else ''
        if pm is not None:
            should_fail = 'exit 1' not in then_block.split('echo')[0] \
                and 'exit 0' in then_block
        else:
            should_fail = 'exit 1' in then_block
        _apply_file(cluster, os.path.join(suite_dir, m.group(1)),
                    should_fail=should_fail, deny_phrase=phrase)
        return
    m = _APPLY_CMD_RE.match(script.strip())
    if m:
        _apply_file(cluster, os.path.join(suite_dir, m.group(1)),
                    should_fail=False)
        return
    m = re.match(r'^kubectl\s+delete\s+-f\s+(\S+)', script.strip())
    if m:
        for fname in m.group(1).split(','):
            path = os.path.join(suite_dir, fname)
            if not os.path.exists(path):
                continue
            for doc in _load_docs(path):
                meta = doc.get('metadata') or {}
                try:
                    cluster.delete_doc(
                        doc.get('apiVersion', ''), doc.get('kind', ''),
                        meta.get('namespace', ''), meta.get('name', ''))
                except ApiError:
                    pass
        cluster.tick()
        return
    tokens = script.strip().split()
    # kubectl delete <kind> [<name>] [-n ns] [-A --all --force ...]
    delete_kind = _resolve_kind(cluster, tokens[2]) \
        if len(tokens) >= 3 and tokens[0] == 'kubectl' and \
        tokens[1] == 'delete' else None
    if delete_kind is not None:
        api_version, kind = delete_kind
        ns = _flag_value(tokens, '-n') or \
            _flag_value(tokens, '--namespace') or ''
        names = [t for t in tokens[3:] if not t.startswith('-')
                 and t != ns]
        delete_all = '--all' in tokens or '-A' in tokens
        if delete_all:
            targets = cluster.client.list_resource('', kind, ns)
            names = [(t.get('metadata') or {}).get('name', '')
                     for t in targets]
        for name in names:
            try:
                cluster.delete_doc(api_version, kind, ns, name)
            except ApiError:
                pass
        cluster.tick()
        return
    # kubectl label <kind> <name> key=value | key-
    if len(tokens) >= 5 and tokens[0] == 'kubectl' and \
            tokens[1] == 'label' and tokens[2].lower() in _KIND_ALIASES:
        api_version, kind = _KIND_ALIASES[tokens[2].lower()]
        name = tokens[3]
        ns = _flag_value(tokens, '-n') or ''
        try:
            obj = cluster.client.get_resource(api_version, kind, ns, name)
        except ApiError:
            raise Unsupported(
                f'label target {kind}/{name} absent from the fake '
                f'cluster (no real nodes here)')
        labels = obj.setdefault('metadata', {}).setdefault('labels', {})
        for spec in tokens[4:]:
            if spec.startswith('-'):
                continue
            if spec.endswith('-') and '=' not in spec:
                labels.pop(spec[:-1], None)
            elif '=' in spec:
                k, v = spec.split('=', 1)
                labels[k] = v
        cluster.client.update_resource(api_version, kind, ns, obj)
        cluster.tick()
        return
    # kubectl [-n ns] create cm <name> --from-literal=k=v ...
    m = re.match(
        r'^kubectl\s+(?:-n\s+(\S+)\s+)?create\s+(?:cm|configmap)\s+(\S+)'
        r'(.*)$', script.strip())
    if m:
        ns, name, rest = m.group(1) or 'default', m.group(2), m.group(3)
        data = {}
        for lit in re.findall(r'--from-literal=([^=\s]+)=(\S+)', rest):
            data[lit[0]] = lit[1]
        cluster.apply_doc({'apiVersion': 'v1', 'kind': 'ConfigMap',
                           'metadata': {'name': name, 'namespace': ns},
                           'data': data})
        cluster.tick()
        return
    if re.fullmatch(r'sleep\s+\d+', script.strip()):
        cluster.tick()
        return
    if len(tokens) >= 3 and tokens[0] == 'kubectl' and \
            tokens[1] == 'delete' and '--ignore-not-found' in script:
        # deleting an unknown kind with --ignore-not-found is a no-op
        # (cleanup steps for resources an earlier denial never created)
        cluster.tick()
        return
    raise Unsupported(f'command not replayable: {script[:120]!r}')
