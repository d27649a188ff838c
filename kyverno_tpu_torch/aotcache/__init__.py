"""Persistent AOT executable cache + background warm-up subsystem.

Fresh-process warm-up pays 43-88s of jax trace + XLA compile before the
first admission decision (VERDICT #2 / ADVICE r5 #4).  This package is
the compile-once discipline for the whole repo:

* :mod:`.store` — a disk-backed blob store with atomic writes,
  integrity-checked corruption-tolerant loads, and LRU size-capped
  eviction (``KTPU_AOT_CACHE_DIR`` / ``KTPU_AOT_CACHE_MAX``).
* :mod:`.keys` — cache-key derivation covering the policy-set
  fingerprint, jax/jaxlib + XLA environment, device kind/topology, and
  the batch input layout, plus the XLA persistent-compilation-cache
  hookup shared by every jit site.
* :mod:`.warmer` — a background warmer daemons start before first
  traffic: it pre-loads (or pre-compiles) the admission graph for the
  installed policy set and reports readiness through metrics, a span,
  and the webhook health endpoints.

The executable codec itself (jax.experimental.serialize_executable +
compression) lives in :mod:`kyverno_tpu.compiler.aot`, the layer the
jit sites (ops/eval.py, compiler/scan.py, parallel/mesh.py) call.
"""

from .keys import (enable_persistent_compilation_cache,
                   executable_cache_key, policy_set_fingerprint)
from .store import (AOT_CACHE_ENTRIES, AOT_CACHE_SIZE_BYTES, AotStore,
                    default_store, publish_stats, reset_default_store)
from .warmer import AOT_WARM_DURATION, Warmer

__all__ = [
    'AOT_CACHE_ENTRIES', 'AOT_CACHE_SIZE_BYTES', 'AOT_WARM_DURATION',
    'AotStore', 'Warmer', 'default_store', 'reset_default_store',
    'publish_stats', 'enable_persistent_compilation_cache',
    'executable_cache_key', 'policy_set_fingerprint',
]
