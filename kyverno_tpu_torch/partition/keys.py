"""Partition-scoped compile key derivation.

The whole-set fingerprint (``ops/eval.py:policy_set_fingerprint``) is
the right identity for *provenance* — "which policy set served this
decision" — but the wrong identity for *executable cache keys*: one
edited policy in a large enforce set changes the whole-set fingerprint
and would invalidate every compiled program built from it.

This module is the single construction site for the fingerprint a
compile cache key may consume.  An evaluator built over a partition's
member policies gets a fingerprint derived from *those members only* —
editing any other policy leaves it untouched.  The partition plan
(``plan.py``) takes its partition fingerprints from here.
"""

from __future__ import annotations

from typing import Iterable

from ..ops.eval import policy_set_fingerprint


def compile_fingerprint(cps) -> str:
    """The fingerprint executable cache keys are derived from.

    For a :class:`CompiledPolicySet` over a partition's member policies
    this is the *partition* fingerprint — stable under edits to any
    policy outside the partition.  For a whole-set compile (the
    ``KTPU_PARTITIONS=0`` monolithic oracle) it degenerates to the
    whole-set fingerprint."""
    return policy_set_fingerprint(cps.policies)


def partition_fingerprint(policies: Iterable) -> str:
    """Fingerprint of one partition's member policies, in membership
    order.  Identical inputs across processes yield identical
    fingerprints."""
    return policy_set_fingerprint(list(policies))
