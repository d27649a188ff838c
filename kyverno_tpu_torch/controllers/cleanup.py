"""Cleanup controller: CleanupPolicy / ClusterCleanupPolicy execution.

The reference reconciles a CronJob per cleanup policy whose schedule
POSTs back to the cleanup webhook, which deletes the matching resources
(reference: pkg/controllers/cleanup/controller.go:164 buildCronJob,
cmd/cleanup-controller/handlers/cleanup/handlers.go).  Here the cron
schedule is evaluated in-process: ``tick(now)`` runs every due policy's
deletion pass — the same match + conditions semantics — against the
dynamic client.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..api.policy import Policy, Rule
from ..api.unstructured import Resource
from ..engine import operators
from ..engine.api import PolicyContext
from ..engine.context import Context
from ..engine.match import matches_resource_description
from ..engine.variables import substitute_all


def parse_cron(expr: str) -> Tuple[set, set, set, set, set]:
    """Standard 5-field cron (minute hour dom month dow)."""
    fields = expr.split()
    if len(fields) != 5:
        raise ValueError(f'invalid cron expression {expr!r}')
    ranges = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]
    out = []
    for field, (lo, hi) in zip(fields, ranges):
        vals = set()
        for part in field.split(','):
            step = 1
            if '/' in part:
                part, step_s = part.split('/', 1)
                step = int(step_s)
            if part == '*':
                start, end = lo, hi
            elif '-' in part:
                start_s, end_s = part.split('-', 1)
                start, end = int(start_s), int(end_s)
            else:
                start = end = int(part)
            vals.update(range(start, end + 1, step))
        out.append(vals)
    return tuple(out)


def validate_cleanup_policy_auth(doc: dict, client) -> Optional[str]:
    """Permission pre-flight for a CleanupPolicy: the controller must be
    able to 'delete' and 'list' every matched kind (reference:
    pkg/validation/cleanuppolicy/validate.go:67 validateAuth).  Returns
    an error string or None."""
    from ..auth import CanI
    namespace = ((doc.get('metadata') or {}).get('namespace') or '')
    spec = doc.get('spec') or {}
    match = spec.get('match') or {}
    kinds = set()
    for f in [match] + (match.get('any') or []) + (match.get('all') or []):
        kinds.update((f.get('resources') or {}).get('kinds') or [])
    for kind in sorted(kinds):
        if not CanI(client, kind, namespace, 'delete').run_access_check():
            return (f'cleanup controller has no permission to delete '
                    f'kind {kind}')
        if not CanI(client, kind, namespace, 'list').run_access_check():
            return (f'cleanup controller has no permission to list '
                    f'kind {kind}')
    return None


def validate_cleanup_admission(request: dict, client) -> dict:
    """CleanupPolicy admission response: structural checks (schedule,
    match) then the delete/list permission pre-flight (reference:
    cmd/cleanup-controller/handlers/admission/policy.go Validate →
    pkg/validation/cleanuppolicy/validate.go)."""
    from ..webhooks import admission
    uid = request.get('uid', '')
    doc = admission.request_resource(request) or {}
    spec = doc.get('spec') or {}
    try:
        parse_cron(str(spec.get('schedule', '')))
    except ValueError as e:
        return admission.response(uid, False, str(e))
    match = spec.get('match')
    if not match:
        return admission.response(uid, False, 'spec.match is required')
    # user infos are not allowed in cleanup match statements (reference:
    # api/kyverno/v2alpha1 cleanup_policy_types ValidateMatchResources →
    # match.GetUserInfo() must be empty)
    for f in [match] + (match.get('any') or []) + (match.get('all') or []):
        if f.get('subjects') or f.get('roles') or f.get('clusterRoles'):
            return admission.response(
                uid, False,
                'cleanup policies do not support user infos in match: '
                'not allowed here')
    err = validate_cleanup_policy_auth(doc, client)
    if err is not None:
        return admission.response(uid, False, err)
    return admission.response(uid, True)


def cron_matches(expr: str, ts: float) -> bool:
    minute, hour, dom, month, dow = parse_cron(expr)
    t = time.gmtime(ts)
    return (t.tm_min in minute and t.tm_hour in hour and
            t.tm_mday in dom and t.tm_mon in month and
            (t.tm_wday + 1) % 7 in dow)


class CleanupController:
    """reference: pkg/controllers/cleanup/controller.go +
    cmd/cleanup-controller/handlers/cleanup"""

    def __init__(self, client):
        self.client = client
        self._lock = threading.Lock()
        self._policies: Dict[str, dict] = {}
        self._last_run: Dict[str, int] = {}

    def set_policy(self, doc: dict) -> None:
        key = self._key(doc)
        with self._lock:
            self._policies[key] = doc

    def delete_policy(self, doc: dict) -> None:
        with self._lock:
            self._policies.pop(self._key(doc), None)

    def retain_policies(self, keys) -> None:
        """Drop tracked policies not in ``keys`` (cluster-sync prune)."""
        keys = set(keys)
        with self._lock:
            for key in list(self._policies):
                if key not in keys:
                    del self._policies[key]

    @staticmethod
    def _key(doc: dict) -> str:
        meta = doc.get('metadata') or {}
        ns = meta.get('namespace', '')
        return f"{ns}/{meta.get('name', '')}" if ns else meta.get('name', '')

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """Run every policy whose schedule matches the current minute;
        returns the deleted resources."""
        now = now or time.time()
        minute = int(now // 60)
        deleted: List[dict] = []
        with self._lock:
            policies = dict(self._policies)
        for key, doc in policies.items():
            schedule = (doc.get('spec') or {}).get('schedule', '')
            if not schedule:
                continue
            if self._last_run.get(key) == minute:
                continue
            try:
                due = cron_matches(schedule, now)
            except ValueError:
                continue
            if not due:
                continue
            self._last_run[key] = minute
            deleted.extend(self.cleanup(doc))
        return deleted

    CLEANUP_SERVICE_PATH = '/cleanup'  # reference: controller.go:28

    def reconcile_cronjobs(self, namespace: str = 'kyverno',
                           service: str = 'https://cleanup-controller.'
                                          'kyverno.svc') -> List[dict]:
        """Materialize one CronJob CR per cleanup policy whose schedule
        calls back the ``/cleanup`` endpoint — the reference's externally
        visible deployment contract (reference:
        pkg/controllers/cleanup/controller.go:164 buildCronJob).  Stale
        CronJobs of deleted policies are removed.  Returns the CronJobs.
        """
        with self._lock:
            policies = dict(self._policies)
        desired = {}
        for key, doc in policies.items():
            meta = doc.get('metadata') or {}
            pol_ns = meta.get('namespace', '')
            kind = 'CleanupPolicy' if pol_ns else 'ClusterCleanupPolicy'
            # a flat ns+name join is ambiguous ('a-b' vs ns a / name b);
            # an 8-hex digest of kind+key makes the CronJob name unique
            # per policy and keeps it inside the 52-char CronJob limit
            digest = hashlib.sha256(f'{kind}/{key}'.encode()) \
                .hexdigest()[:8]
            base = f"cleanup-{pol_ns}-{meta.get('name', '')}" if pol_ns \
                else f"cleanup-{meta.get('name', '')}"
            name = f'{base[:43].rstrip("-")}-{digest}'
            cronjob = {
                'apiVersion': 'batch/v1', 'kind': 'CronJob',
                'metadata': {
                    'name': name, 'namespace': namespace,
                    'ownerReferences': [{
                        'apiVersion': 'kyverno.io/v2alpha1',
                        'kind': kind, 'name': meta.get('name', ''),
                        'uid': meta.get('uid', ''),
                    }],
                },
                'spec': {
                    'schedule': (doc.get('spec') or {}).get('schedule', ''),
                    'successfulJobsHistoryLimit': 0,
                    'failedJobsHistoryLimit': 1,
                    'concurrencyPolicy': 'Forbid',
                    'jobTemplate': {'spec': {'template': {'spec': {
                        'restartPolicy': 'OnFailure',
                        'containers': [{
                            'name': 'cleanup',
                            'image': 'curlimages/curl:7.86.0',
                            'args': [
                                '-k',
                                f'{service}'
                                f'{self.CLEANUP_SERVICE_PATH}'
                                f'?policy={key}'],
                            'securityContext': {
                                'allowPrivilegeEscalation': False,
                                'runAsNonRoot': True,
                                'runAsUser': 1000,
                                'seccompProfile': {'type': 'RuntimeDefault'},
                                'capabilities': {'drop': ['ALL']},
                            },
                        }],
                    }}}},
                },
            }
            desired[name] = cronjob
        out = []
        for name, cronjob in desired.items():
            try:
                existing = self.client.get_resource(
                    'batch/v1', 'CronJob', namespace, name)
            except Exception:  # noqa: BLE001
                existing = None
            if existing is None:
                out.append(self.client.create_resource(
                    'batch/v1', 'CronJob', namespace, cronjob))
            elif (existing.get('spec') == cronjob['spec'] and
                  existing['metadata'].get('ownerReferences') ==
                  cronjob['metadata']['ownerReferences']):
                # unchanged: no write (the reference controller compares
                # observed vs desired before updating)
                out.append(existing)
            else:
                existing['spec'] = cronjob['spec']
                existing['metadata']['ownerReferences'] = \
                    cronjob['metadata']['ownerReferences']
                out.append(self.client.update_resource(
                    'batch/v1', 'CronJob', namespace, existing))
        try:
            for cj in self.client.list_resource('batch/v1', 'CronJob',
                                                namespace, None):
                name = (cj.get('metadata') or {}).get('name', '')
                if name.startswith('cleanup-') and name not in desired:
                    self.client.delete_resource('batch/v1', 'CronJob',
                                                namespace, name)
        except Exception:  # noqa: BLE001
            pass
        return out

    def handle_cleanup_request(self, policy_key: str) -> List[dict]:
        """The ``/cleanup?policy=ns/name`` endpoint body (reference:
        cmd/cleanup-controller/handlers/cleanup/handlers.go)."""
        with self._lock:
            doc = self._policies.get(policy_key)
        if doc is None:
            raise KeyError(policy_key)
        return self.cleanup(doc)

    def cleanup(self, doc: dict) -> List[dict]:
        """One deletion pass for a cleanup policy
        (reference: handlers/cleanup/handlers.go executePolicy)."""
        spec = doc.get('spec') or {}
        meta = doc.get('metadata') or {}
        policy_ns = meta.get('namespace', '')
        match = spec.get('match') or {}
        exclude = spec.get('exclude') or {}
        conditions = spec.get('conditions')
        rule = Rule({'name': 'cleanup', 'match': match, 'exclude': exclude})
        kinds = set()
        for f in [match] + (match.get('any') or []) + \
                (match.get('all') or []):
            for k in (f.get('resources') or {}).get('kinds') or []:
                kinds.add(str(k).split('/')[-1])
        deleted = []
        for kind in sorted(kinds):
            try:
                items = self.client.list_resource('', kind, policy_ns, None)
            except Exception:  # noqa: BLE001
                continue
            for item in items:
                r = Resource(item)
                if matches_resource_description(
                        r, rule, None, [], {}, '') is not None:
                    continue
                if conditions is not None and \
                        not self._conditions_met(conditions, item):
                    continue
                try:
                    self.client.delete_resource(
                        item.get('apiVersion', ''), r.kind,
                        r.namespace, r.name)
                    deleted.append(item)
                except Exception:  # noqa: BLE001
                    continue
        return deleted

    def _conditions_met(self, conditions: Any, resource: dict) -> bool:
        ctx = Context()
        ctx.add_resource(resource)
        # cleanup conditions address the candidate as {{ target.* }}
        # (reference: cmd/cleanup-controller/handlers/cleanup/handlers.go
        # enginectx.AddTargetResource)
        ctx.add_target_resource(resource)
        try:
            substituted = substitute_all(ctx, conditions)
        except Exception:  # noqa: BLE001
            return False
        return operators.evaluate_conditions(ctx, substituted)
