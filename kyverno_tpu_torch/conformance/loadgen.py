"""Synthetic cluster admission-traffic generator.

Models the traffic shape the heterogeneous-occupancy work targets
(ROADMAP): millions-of-users admission streams are NOT homogeneous —
they mix distinct userInfos (zipfian: a few controllers dominate, a
long tail of humans), many namespaces (zipfian too), CREATE/UPDATE
verbs, a small population of exception-holding tenants whose requests
ride the host engine loop, and bursty/trickling arrival.  The
generator is fully deterministic for a seed, so bench numbers and
tests reproduce.

Consumers:

* ``bench.py`` drives the admission-concurrency bench with
  :meth:`SyntheticCluster.review_bytes` and ratchets mean batch
  occupancy under this traffic (``HET_OCCUPANCY_FLOOR``);
* tests use small instances to pin batched-vs-sync bit-identity under
  mixed admission tuples;
* the chaos drills (``bench.py --admission-chaos``,
  ``tests/test_faults.py``) mark a deterministic slice of rows as
  *poison* — their ``chaos`` label is what a marker-armed
  ``KTPU_FAULTS`` clause keys on — and pair the traffic with a fault
  schedule, so a run under injected failures replays against its own
  fault-free oracle;
* the policy-churn bench (``bench.py --policy-churn``) and churn
  tests share :meth:`SyntheticCluster.churn_schedule` /
  :func:`apply_churn` — deterministic mid-burst policy edit/add/delete
  events at fixed request ticks.

Layered beside the kuttl/scenario harness (this package): scenarios
replay *recorded* cases, the generator synthesizes *load*.
"""

from __future__ import annotations

import bisect
import copy
import json
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple


#: label value a poison row carries under ``metadata.labels.chaos`` —
#: the key the fault injector's ``marker=`` clauses match on
#: (``kyverno_tpu.faults.MARKER_LABEL``); inert in a fault-free run
POISON_MARKER = 'poison'


@dataclass(frozen=True)
class ChurnEvent:
    """One scheduled policy change mid-traffic: at request ``tick``,
    apply ``action`` (edit | add | delete) to ``policy_index`` of the
    live policy set.  ``seed`` disambiguates the edit content so two
    events against the same policy produce distinct fingerprints."""
    tick: int
    action: str
    policy_index: int
    seed: int

    def marker(self) -> str:
        """The string the event's edit stamps into the policy — what a
        bench polls for in responses to observe enforcement."""
        return f'[churn-{self.seed}]'

    def to_dict(self) -> Dict:
        return {'tick': self.tick, 'action': self.action,
                'policy_index': self.policy_index, 'seed': self.seed,
                'marker': self.marker()}


def apply_churn(raw_policies: List[Dict], event: ChurnEvent
                ) -> List[Dict]:
    """Apply one :class:`ChurnEvent` to a list of raw policy documents,
    returning a NEW list with deep-copied changed entries (the inputs
    are never mutated — callers keep the pre-churn set as the oracle).

    * ``edit`` appends the event marker to the target's first validate
      message: a semantic change (new compile fingerprint, new verdict
      text) that leaves the policy's slot vocabulary — and therefore
      its partition assignment — intact.
    * ``add`` clones the target under a ``-churn<seed>`` name.
    * ``delete`` removes the target.
    """
    idx = event.policy_index % max(1, len(raw_policies))
    out = list(raw_policies)
    if event.action == 'delete':
        del out[idx]
        return out
    doc = copy.deepcopy(raw_policies[idx])
    rules = ((doc.get('spec') or {}).get('rules')) or []
    for rule in rules:
        validate = rule.get('validate')
        if isinstance(validate, dict) and 'message' in validate:
            validate['message'] = \
                f"{validate['message']} {event.marker()}"
            break
    if event.action == 'add':
        meta = doc.setdefault('metadata', {})
        meta['name'] = f"{meta.get('name', 'pol')}-churn{event.seed}"
        out.append(doc)
    else:  # edit
        out[idx] = doc
    return out


def _zipf_cum(n: int, s: float) -> List[float]:
    """Cumulative zipf(s) weights over ranks 1..n (rank 1 hottest)."""
    total = 0.0
    out: List[float] = []
    for k in range(1, n + 1):
        total += 1.0 / (k ** s)
        out.append(total)
    return out


class SyntheticCluster:
    """Deterministic admission-traffic source for one synthetic cluster.

    ``request(i)`` is a pure function of ``(seed, i)``: the i-th
    request's user, namespace, verb, and pod shape never depend on how
    many requests were drawn before it, so threads can partition the
    index space freely and still replay identically.
    """

    def __init__(self, seed: int = 0, users: int = 200,
                 namespaces: int = 32, teams: int = 12,
                 zipf_s: float = 1.1, update_ratio: float = 0.25,
                 delete_ratio: float = 0.0,
                 exception_tenant_ratio: float = 0.05,
                 compliant_ratio: float = 0.5,
                 poison_ratio: float = 0.0):
        import random
        self.seed = seed
        self._base = random.Random(seed)
        self.users = [f'user-{i}' for i in range(max(1, users))]
        self.namespaces = [f'ns-{i}' for i in range(max(1, namespaces))]
        self.teams = max(1, teams)
        self.update_ratio = update_ratio
        self.delete_ratio = delete_ratio
        self.compliant_ratio = compliant_ratio
        self._user_cum = _zipf_cum(len(self.users), zipf_s)
        self._ns_cum = _zipf_cum(len(self.namespaces), zipf_s)
        # a deterministic zipf-tail slice of tenants holds policy
        # exceptions; their requests leave the batched device path
        step = max(1, int(round(1.0 / exception_tenant_ratio))) \
            if exception_tenant_ratio > 0 else 0
        self.exception_users = frozenset(
            u for i, u in enumerate(self.users)
            if step and i % step == step - 1)
        # poison rows: every poison_step-th request carries the chaos
        # marker label AND is forced onto a non-exception tenant with a
        # device-served verb, so every poison row is guaranteed to ride
        # the batched device path — the quarantine ratchet can then
        # demand shed(poison_row) == the exact injected poison count
        self._poison_step = max(1, int(round(1.0 / poison_ratio))) \
            if poison_ratio > 0 else 0
        self._device_users = [u for u in self.users
                              if u not in self.exception_users] \
            or list(self.users)

    # -- per-index draws ---------------------------------------------------

    def _rng(self, i: int):
        import random
        return random.Random((self.seed << 20) ^ i)

    @staticmethod
    def _pick(rng, items: List[str], cum: List[float]) -> str:
        r = rng.random() * cum[-1]
        return items[min(bisect.bisect_left(cum, r), len(items) - 1)]

    def user_info(self, user: str) -> Dict:
        idx = int(user.rsplit('-', 1)[1])
        groups = ['system:authenticated', f'team-{idx % self.teams}']
        if idx % 7 == 0:
            groups.append('system:masters')
        return {'username': user, 'groups': groups}

    def is_exception_tenant(self, username: str) -> bool:
        return username in self.exception_users

    # -- poison rows (chaos drills) ----------------------------------------

    def is_poison(self, i: int) -> bool:
        """Whether the i-th request is a marked poison row (pure in
        ``(poison_ratio, i)`` — callers compute exact expectations)."""
        step = self._poison_step
        return bool(step) and i % step == step - 1

    def poison_count(self, count: int, start: int = 0) -> int:
        """Poison rows among requests ``start .. start+count-1``."""
        return sum(1 for k in range(count) if self.is_poison(start + k))

    def fault_spec(self, error: str = 'RuntimeError') -> str:
        """``KTPU_FAULTS`` clause arming the poison marker: any batched
        device dispatch carrying a marked row raises ``error`` — the
        batcher's bisection then has a row-deterministic failure to
        isolate (the clause re-fires on every sub-batch that still
        contains the poison row, and never on one that does not)."""
        return f'site=batcher_dispatch,marker={POISON_MARKER}' \
               f',error={error}'

    def pod(self, ns: str, name: str, user: str,
            compliant: bool) -> Dict:
        idx = int(user.rsplit('-', 1)[1])
        labels = {'app': f'svc-{idx % 17}'}
        if compliant:
            labels['team'] = f'team-{idx % self.teams}'
        containers = [{'name': f'c{k}', 'image': f'registry/app:{idx % 5}'}
                      for k in range(1 + idx % 3)]
        return {'apiVersion': 'v1', 'kind': 'Pod',
                'metadata': {'name': name, 'namespace': ns,
                             'labels': labels},
                'spec': {'containers': containers}}

    def request(self, i: int) -> Dict:
        """The i-th AdmissionRequest dict (uid, operation, object,
        oldObject for UPDATE, userInfo)."""
        rng = self._rng(i)
        user = self._pick(rng, self.users, self._user_cum)
        ns = self._pick(rng, self.namespaces, self._ns_cum)
        compliant = rng.random() < self.compliant_ratio
        poison = self.is_poison(i)
        if poison:
            # device-path guarantee: never an exception tenant (whose
            # requests bypass the batcher entirely)
            user = self._device_users[i % len(self._device_users)]
        name = f'pod-{i}'
        doc = self.pod(ns, name, user, compliant)
        if poison:
            doc['metadata']['labels']['chaos'] = POISON_MARKER
        verb_draw = rng.random()
        if poison or verb_draw >= self.delete_ratio + self.update_ratio:
            operation = 'CREATE'  # poison rows keep a device verb
        elif verb_draw < self.delete_ratio:
            operation = 'DELETE'
        else:
            operation = 'UPDATE'
        req = {
            'uid': f'load-{self.seed}-{i}',
            'operation': operation,
            'kind': {'group': '', 'version': 'v1', 'kind': 'Pod'},
            'namespace': ns, 'name': name,
            'userInfo': self.user_info(user),
        }
        if operation == 'DELETE':
            req['oldObject'] = doc
        else:
            req['object'] = doc
            if operation == 'UPDATE':
                old = json.loads(json.dumps(doc))
                old['metadata']['labels'].pop('team', None)
                old['metadata']['labels']['rev'] = 'old'
                req['oldObject'] = old
        return req

    def review(self, i: int) -> Dict:
        return {'apiVersion': 'admission.k8s.io/v1',
                'kind': 'AdmissionReview', 'request': self.request(i)}

    def review_bytes(self, i: int) -> bytes:
        return json.dumps(self.review(i)).encode('utf-8')

    # -- arrival schedules -------------------------------------------------

    def arrivals(self, count: int, pattern: str = 'burst',
                 burst: int = 16, gap_ms: float = 2.0,
                 rate_per_s: float = 500.0, start: int = 0
                 ) -> Iterator[Tuple[float, bytes]]:
        """Yield ``(delay_before_send_s, review_bytes)`` pairs.

        ``burst`` releases ``burst`` back-to-back requests then pauses
        ``gap_ms``; ``trickle`` spaces requests exponentially around
        ``rate_per_s``; ``steady`` is fixed spacing.  Deterministic."""
        rng = self._rng(-1 - start)
        for k in range(count):
            i = start + k
            if pattern == 'burst':
                delay = 0.0 if (k % max(1, burst)) else (
                    0.0 if k == 0 else gap_ms / 1000.0)
            elif pattern == 'trickle':
                delay = rng.expovariate(rate_per_s)
            else:  # steady
                delay = 1.0 / rate_per_s
            yield delay, self.review_bytes(i)

    # -- mid-burst policy churn --------------------------------------------

    def churn_schedule(self, count: int, n_policies: int,
                       events: int = 1, start_frac: float = 0.25,
                       end_frac: float = 0.75,
                       actions: Tuple[str, ...] = ('edit',)
                       ) -> List['ChurnEvent']:
        """Deterministic mid-burst policy-churn schedule: ``events``
        policy changes at fixed request ticks, evenly spread across
        ``[start_frac, end_frac)`` of a ``count``-request run.  Pure in
        ``(seed, count, n_policies, events, ...)`` so the churn bench
        and the chaos drills fire the exact same edits at the exact
        same ticks — a churn run replays against its own oracle.
        Actions cycle through ``actions``; the targeted policy index is
        a seed-keyed draw so different seeds churn different policies.
        """
        events = max(1, events)
        span = max(0.0, end_frac - start_frac)
        out: List[ChurnEvent] = []
        for k in range(events):
            tick = int(count * (start_frac + span * k / events))
            rng = self._rng(-1000 - k)
            out.append(ChurnEvent(
                tick=min(max(tick, 0), max(count - 1, 0)),
                action=actions[k % len(actions)],
                policy_index=rng.randrange(max(1, n_policies)),
                seed=(self.seed << 8) ^ k))
        return out

    # -- exception-holding tenants ----------------------------------------

    def exception_docs(self, policy_name: str = 'loadgen-exception',
                       rule_names: Optional[List[str]] = None
                       ) -> List[Dict]:
        """PolicyException documents for the exception-tenant
        population.  With the default placeholder ``policy_name`` they
        match no real policy: requests still pay the exception-bearing
        host path (`pctx.exceptions` non-empty disables the device fast
        path) without changing any verdict — the load shape, not the
        outcome."""
        return [{
            'apiVersion': 'kyverno.io/v2beta1',
            'kind': 'PolicyException',
            'metadata': {'name': f'exc-{u}', 'namespace': 'kyverno'},
            'spec': {'exceptions': [{
                'policyName': policy_name,
                'ruleNames': rule_names or ['*'],
            }]},
        } for u in sorted(self.exception_users)]
