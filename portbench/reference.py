"""The plain reference: what the program has to answer, worked out again
from the policies' meaning, in plain Python, per policy pack
(``refs/<pack>.py``).  It imports nothing of the program and takes
nothing the program made: it reads the Pods the benchmark generated.

* ``report_rows``: a Pod's PolicyReport results, as a background scan
  yields them (sorted by policy and rule), and its summary.
* ``Yielded`` and ``rows_wrong``: the comparison that decides
  ``correct``.  A run records what the timed path yielded for every Pod
  in its window, and ``rows_wrong`` judges each record against the
  reference.  The control (``control.py``) is judged by the same
  function.
"""

from __future__ import annotations

import importlib
import pickle
import sys
from array import array
from typing import Dict, List, Tuple

BUCKETS = ('pass', 'fail', 'warn', 'error', 'skip')


class Context:
    __slots__ = ('pod', 'precision')

    def __init__(self, pod, precision='float64'):
        self.pod = pod
        self.precision = precision


def pack_rules(packs: List[str]):
    """``[(policy, rule, kinds, evaluate)]`` of the packs, in order."""
    out = []
    for pack in packs:
        out += importlib.import_module(f'portbench.refs.{pack}').RULES
    return out


def _evaluate(rules, ctx):
    kind = ctx.pod.get('kind', '')
    for policy, rule, kinds, evaluate in rules:
        if kind not in kinds:
            continue
        got = evaluate(ctx)
        if got is not None:
            yield policy, rule, got[0], got[1]


def report_rows(rules, pod: dict, ts: int, precision: str = 'float64'
                ) -> Tuple[List[dict], Dict[str, int]]:
    """A Pod's background-scan results and summary."""
    rows = [{'source': 'kyverno', 'policy': policy, 'rule': rule,
             'message': message, 'result': result, 'scored': True,
             'timestamp': {'seconds': ts}}
            for policy, rule, result, message in
            _evaluate(rules, Context(pod, precision=precision))]
    rows.sort(key=lambda r: (r['policy'], r['rule']))
    summary = dict.fromkeys(BUCKETS, 0)
    for r in rows:
        summary[r['result']] += 1
    return rows, summary


class Yielded:
    """What a scan yielded, Pod by Pod: each Pod's index and its
    ``(results, summary)`` pickled into one buffer, so that recording a
    Pod in the window costs one ``pickle.dumps`` and leaves nothing for
    the garbage collector to walk."""

    def __init__(self):
        self.index = array('q')
        self.ends = array('q')
        self.blob = bytearray()

    def add(self, i: int, results, summary) -> None:
        self.blob += pickle.dumps((results, summary), 5)
        self.index.append(i)
        self.ends.append(len(self.blob))

    def __len__(self) -> int:
        return len(self.index)

    def __iter__(self):
        start = 0
        for i, end in zip(self.index, self.ends):
            results, summary = pickle.loads(self.blob[start:end])
            start = end
            yield i, list(results), summary


def rows_wrong(rules, pods: List[dict], yielded: Yielded, ts: int,
               show: int = 3) -> int:
    """The number of records in ``yielded`` whose rows (each row's
    policy, rule, result, message, scored, source and timestamp, in
    order) or summary differ from the reference's for that Pod; the
    first ``show`` of them are printed on standard error."""
    wrong = 0
    for i, results, summary in yielded:
        ref = report_rows(rules, pods[i], ts)
        if results != ref[0] or summary != ref[1]:
            wrong += 1
            if wrong <= show:
                print(f'portbench: pod {i} differs from the reference:\n'
                      f'  got  {results} {summary}\n'
                      f'  want {ref[0]} {ref[1]}', file=sys.stderr)
    return wrong
