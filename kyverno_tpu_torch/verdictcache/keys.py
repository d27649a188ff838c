"""Cache-key derivation for persisted verdict rows.

A cached verdict row is replayable only while three things hold: the
resource content the policies evaluated is unchanged (**spec digest**),
the policy set is unchanged (**policy-set fingerprint**,
``ops/eval.py:policy_set_fingerprint``), and the engine that produced
the row still has the same semantics (**engine rev**).
The digest deliberately covers the *whole* resource document — match/
exclude, patterns, and JMESPath programs may reference any field,
including ``metadata.uid`` — minus the server-side bookkeeping fields
that change on every write without changing what policies see
(``managedFields``, ``resourceVersion``, ``generation``,
``creationTimestamp``).  Keeping ``uid`` in the digest means a
deleted-then-recreated resource never aliases its predecessor's entries
even before the uid-keyed invalidation hook drops them.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

#: bump to invalidate every persisted verdict row (snapshot format or
#: engine-semantics changes not captured by the source digests below)
VERDICT_VERSION = 1

#: metadata fields the API server rewrites on every update without
#: changing anything a policy can meaningfully evaluate — excluded from
#: the spec digest so a no-op resync never invalidates a row
VOLATILE_METADATA = ('managedFields', 'resourceVersion', 'generation',
                     'creationTimestamp', 'selfLink')

_ENGINE_REV: Optional[str] = None


def spec_digest(resource: dict) -> str:
    """Stable digest of one resource's policy-visible content.  Key
    order never matters (canonical JSON); the volatile metadata fields
    never matter; any other change — spec, labels, annotations, status,
    uid — produces a different digest (a changed resource must miss)."""
    meta = resource.get('metadata')
    if isinstance(meta, dict) and any(k in meta for k in VOLATILE_METADATA):
        resource = dict(resource)
        resource['metadata'] = {k: v for k, v in meta.items()
                                if k not in VOLATILE_METADATA}
    payload = json.dumps(resource, sort_keys=True, separators=(',', ':'),
                         default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


#: sources whose semantics are baked into a verdict row: the evaluator
#: and compiler, the hand-written kernels and their wrappers, the
#: partition runtime and composer (partitioned scans store composed
#: rows), then the scan-assembly and report-mapping layers that turn
#: device cells into result dicts
ENGINE_SOURCES = ('ops/eval.py', 'ops/kernels.py', 'ops/vm.py',
                  'csrc/k1_vm.cu', 'csrc/k1_vm.cuh', 'csrc/glob_dp.cuh',
                  'csrc/k1h_fdet_select.cu', 'csrc/k1c_wildcard.cu',
                  'csrc/k3_mutate.cu', 'csrc/k4_status_hist.cu',
                  'csrc/k4_count.cuh',
                  'compiler/compile.py',
                  'compiler/encode.py', 'compiler/ir.py',
                  'compiler/pss_compile.py', 'compiler/scan.py',
                  'partition/compose.py', 'partition/runtime.py',
                  'reports/results.py')


def engine_rev() -> str:
    """Digest of this package's own ``ENGINE_SOURCES``.  Any change to
    them invalidates every persisted row — a stale row from an older
    engine can never replay — and since the digest reads the torch
    port's files, a row written by the JAX package never replays here
    (nor the other way round)."""
    global _ENGINE_REV
    if _ENGINE_REV is None:
        h = hashlib.sha256()
        base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for rel in ENGINE_SOURCES:
            try:
                with open(os.path.join(base, rel), 'rb') as f:
                    h.update(f.read())
            except OSError:
                h.update(rel.encode())
        h.update(str(VERDICT_VERSION).encode())
        _ENGINE_REV = h.hexdigest()[:16]
    return _ENGINE_REV


def generation_key(fingerprint: str, rev: Optional[str] = None) -> str:
    """One cache generation = one (policy set, engine rev) pair; a
    policy-set change flushes by switching generations."""
    return f'{fingerprint}-{rev or engine_rev()}'
