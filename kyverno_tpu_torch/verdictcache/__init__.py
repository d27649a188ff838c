"""Digest-keyed verdict cache: incremental O(churn) background rescans.

Background scans re-evaluated every resource×rule cell on every
reconcile tick — the scaling cliff on the road to the 1M-Pod north
star.  This package carries verdict state across ticks keyed by what
actually changed (the compiler-first caching discipline of the
"Portable O(1) Autoregressive Caching" line of work): a rescan looks
every pending resource up by **spec digest × policy-set fingerprint ×
engine rev** and only ships the misses — the rows whose content,
policy set, or engine changed — to the device, replaying everything
else from the cache in O(1) per row.  Steady-state rescan cost tracks
churn (~1% of rows per tick), not cluster size.

* :mod:`.keys` — spec-digest canonicalization (volatile server-side
  metadata excluded; everything policies can see included) and the
  engine-rev digest that invalidates rows across code changes.
* :mod:`.store` — the cache itself: entry-capped in-memory LRU front,
  atomic digest-framed on-disk snapshots per cache generation (the
  ``aotcache/store.py`` protocol), uid-keyed invalidation, and the
  hit/miss/eviction + per-tick rescan telemetry.
* :mod:`.partitioned` — per-partition generations over the
  :mod:`kyverno_tpu.partition` plan (``KTPU_PARTITIONS>0``): a policy
  edit rolls only the touched partitions' generations, unchanged
  verdict subrows keep replaying, and partial hits re-scan rows
  against only the touched partitions' policies.

The dense full scan stays the cold path and the correctness oracle:
``KTPU_VERDICT_CACHE=off`` produces bit-identical reports (pinned by
``tests/test_verdict_cache.py``), and cached rows are only ever read
back under the exact (fingerprint, engine-rev) generation that wrote
them.  Integration lives in ``reports/controllers.py:
BackgroundScanController.reconcile`` — the cache is a filter stage in
front of ``BatchScanner``, with ``MetadataCache`` update/remove deltas
feeding invalidation.
"""

from .keys import (VERDICT_VERSION, engine_rev, generation_key,
                   spec_digest)
from .partitioned import (VERDICT_CACHE_PARTIAL_HITS,
                          PartitionedVerdictCache)
from .store import (RESCAN_ROWS_REPLAYED, RESCAN_ROWS_SCANNED,
                    VERDICT_CACHE_EVICTIONS, VERDICT_CACHE_HITS,
                    VERDICT_CACHE_MISSES, VerdictCache, publish_tick)

__all__ = [
    'VERDICT_VERSION', 'engine_rev', 'generation_key', 'spec_digest',
    'RESCAN_ROWS_REPLAYED', 'RESCAN_ROWS_SCANNED',
    'VERDICT_CACHE_EVICTIONS', 'VERDICT_CACHE_HITS',
    'VERDICT_CACHE_MISSES', 'VERDICT_CACHE_PARTIAL_HITS',
    'PartitionedVerdictCache', 'VerdictCache', 'publish_tick',
]
