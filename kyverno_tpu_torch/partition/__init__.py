"""Partitioned policy-set compilation (``KTPU_PARTITIONS``).

Splits a policy set into stable per-group partitions, each with its own
fingerprint and AOT keys derived from only its member policies, so
policy churn recompiles one partition instead of the world.  See
``plan.py`` (grouping + differ), ``runtime.py`` (per-partition
compile/evaluator lifecycle), ``compose.py`` (bit-identical merge back
into the whole-set verdict contract), ``census.py``
(``/debug/partitions``), and ``keys.py`` (the only sanctioned
fingerprint source for executable cache keys — enforced by ktpu-lint
KTPU508).
"""

from .keys import compile_fingerprint, partition_fingerprint
from .plan import (ChurnDiff, Partition, PartitionError, PartitionPlan,
                   build_plan, coupling_signature, diff_plans,
                   env_partitions)
from . import census

__all__ = [
    'ChurnDiff', 'Partition', 'PartitionError', 'PartitionPlan',
    'build_plan', 'coupling_signature', 'diff_plans', 'env_partitions',
    'compile_fingerprint', 'partition_fingerprint', 'census',
    'Composer', 'PartitionRuntime', 'PartitionedSet', 'build_runtime',
    'clear_eval_cache',
]

_LAZY = {
    'Composer': 'compose',
    'PartitionRuntime': 'runtime',
    'PartitionedSet': 'runtime',
    'build_runtime': 'runtime',
    'clear_eval_cache': 'runtime',
    'eval_cache_size': 'runtime',
}


def __getattr__(name):
    # runtime/compose pull in the compiler + ops stack; loaded on first
    # use so `from ..partition.keys import compile_fingerprint` inside
    # ops/eval.py never cycles
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f'.{mod}', __name__), name)
