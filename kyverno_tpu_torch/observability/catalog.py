"""Metric + span catalog: the single source of truth for every metric
name this process exports and every span name it starts.

Each series emitted through :class:`MetricsRegistry` (``inc`` /
``observe`` / ``set_gauge`` / ``clear_gauge``) must use a name listed
here with its type and help text; ``scripts/check_metric_names.py``
(run by ``tests/test_metric_catalog.py``) statically verifies every
call site against this table, so a typo'd or undocumented metric name
fails tier-1 instead of silently forking a series.  The ``SPANS``
table plays the same role for trace span names (KTPU504/505 in
ktpu-lint): a ``start_span`` site whose name is absent here — or a
cataloged span nothing starts — is catalog drift.
"""

from __future__ import annotations

from typing import Dict, NamedTuple


class Metric(NamedTuple):
    type: str  # counter | gauge | histogram
    help: str
    #: fleet identity axis for metrics emitted on the sharded mesh path
    #: (``kyverno_tpu/parallel/``): the label key every write site must
    #: carry so cross-host federation can tell series apart —
    #: ``'shard'`` (one series per mesh shard) or ``'mesh'`` (one
    #: series per mesh shape).  '' for single-host metrics.  Enforced
    #: by ktpu-lint KTPU509 (write sites under parallel/ must use a
    #: fleet-scoped metric and pass its label; a declared scope with no
    #: parallel/ write site is dead).
    fleet_scope: str = ''


METRICS: Dict[str, Metric] = {
    # engine / webhook instruments (reference: pkg/metrics/metrics.go)
    'kyverno_policy_results_total': Metric(
        'counter', 'Rule executions by policy/rule/result/resource.'),
    'kyverno_policy_execution_duration_seconds': Metric(
        'histogram', 'Per-policy engine execution latency.'),
    'kyverno_policy_changes_total': Metric(
        'counter', 'Policy create/update/delete events.'),
    'kyverno_policy_rule_info_total': Metric(
        'gauge', '1 per live (policy, rule) pair; retracted on delete.'),
    'kyverno_admission_review_duration_seconds': Metric(
        'histogram', 'End-to-end admission handler latency.'),
    'kyverno_admission_requests_total': Metric(
        'counter', 'Admission requests by operation/allowed.'),
    'kyverno_client_queries_total': Metric(
        'counter', 'Cluster client queries by verb/kind.'),
    # device-pipeline instruments (observability/device.py)
    'kyverno_tpu_scan_stage_duration_seconds': Metric(
        'histogram', 'Batched-scan stage latency; stage=pack|encode|'
        'match|h2d|device_eval|d2h|report, wait (the report loop '
        'waiting for the next chunk), gc (a garbage-collector pause), '
        'and device: a K1 call\'s time on its CUDA stream from events '
        'recorded around evaluate_packed, read after the readback, '
        'which includes any gap while the host enqueues K1v and K1h.'),
    'kyverno_tpu_scan_stage_cpu_seconds_total': Metric(
        'counter', 'Thread CPU seconds of each scan stage '
        '(time.thread_time; a forked encode worker\'s process time), '
        'beside its wall seconds on the stage histogram: wall minus CPU '
        'is time spent waiting for the interpreter lock, the garbage '
        'collector or I/O.'),
    'kyverno_tpu_gc_pause_seconds_total': Metric(
        'counter', 'Garbage-collector pauses while device telemetry is '
        'on, by generation=0|1|2; every thread of the process waits '
        'while one runs.'),
    'kyverno_tpu_compile_cache_requests_total': Metric(
        'counter', 'Evaluator executable lookups; result=hit|miss|'
        'aot_load|aot_store.'),
    'kyverno_tpu_device_batch_size': Metric(
        'gauge', 'Rows in the most recent device chunk.'),
    'kyverno_tpu_d2h_bytes_total': Metric(
        'counter', 'Device-to-host readback bytes.'),
    'kyverno_tpu_d2h_stalls_total': Metric(
        'counter', 'Readbacks exceeding the stall watchdog threshold '
        '(KTPU_D2H_STALL_S, default 30s).'),
    'kyverno_tpu_scan_pipeline_inflight_chunks': Metric(
        'gauge', 'Chunks resident in the streaming scan pipeline '
        '(bounded by KTPU_PIPELINE_DEPTH; intake backpressures at the '
        'bound instead of buffering).'),
    'kyverno_tpu_scan_backpressure_seconds_total': Metric(
        'counter', 'Time a scan-pipeline stage spent blocked on a full '
        'downstream queue (stage=intake|encode|h2d|device_eval|d2h) — '
        'which leg bounds the stream.'),
    # device-coverage ledger (observability/coverage.py)
    'kyverno_tpu_rule_placement_info': Metric(
        'gauge', '1 per compiled (policy, rule, path); placement=device|'
        'host|partial with the fallback-reason taxonomy slug.'),
    'kyverno_tpu_host_fallback_total': Metric(
        'counter', 'Rows served by the host engine instead of the '
        'device/fast path, by path=validate|mutate|pss and attributed '
        'reason (observability/coverage.py REASONS).'),
    'kyverno_tpu_device_coverage_ratio': Metric(
        'gauge', 'Device-decided fraction of the most recent scan '
        '(device_rows / total_rows).'),
    # admission micro-batching scheduler (serving/)
    'kyverno_tpu_admission_queue_depth': Metric(
        'gauge', 'Pending requests in the admission micro-batch queue '
        '(KTPU_QUEUE_CAP bounds it; overflow sheds to the host loop).'),
    'kyverno_tpu_admission_batch_occupancy': Metric(
        'histogram', 'Coalesced requests per shared device dispatch '
        '(flushes on the KTPU_BATCH_WINDOW_MS window or at '
        'KTPU_BATCH_MAX occupancy).'),
    'kyverno_tpu_admission_hetero_occupancy': Metric(
        'histogram', 'Coalesced requests per shared dispatch whose '
        'riders carried MORE than one distinct canonical admission '
        'tuple (heterogeneous traffic) — distinguishes real mixed-user '
        'coalescing from same-tuple batching in production telemetry.'),
    'kyverno_tpu_admission_queue_wait_seconds': Metric(
        'histogram', 'Time a request waited in the admission queue '
        'before its batch dispatched.'),
    'kyverno_tpu_admission_shed_total': Metric(
        'counter', 'Requests shed from the batched fast path to the '
        'host engine loop, by reason=queue_full|deadline|scan_error|'
        'shutdown|poison_row|breaker_open|stage_retry_exhausted '
        '(never a 500).'),
    # degradation under failure (faults/, serving/breaker.py)
    'kyverno_tpu_faults_injected_total': Metric(
        'counter', 'Faults the KTPU_FAULTS injection harness actually '
        'raised, by site= (chaos drills only; zero in production).'),
    'kyverno_tpu_breaker_state': Metric(
        'gauge', 'Per-policy-set circuit breakers in each lifecycle '
        'state, by state=closed|open|half_open (serving/breaker.py).'),
    'kyverno_tpu_breaker_evictions_total': Metric(
        'counter', 'Breaker entries evicted by the KTPU_BREAKER_CAP '
        'bound; forgetting breaker state can silently re-admit a '
        'broken backend, so evictions are counted, never silent.'),
    # verdict cache + incremental rescans (verdictcache/)
    'kyverno_tpu_verdict_cache_hits_total': Metric(
        'counter', 'Background-rescan rows replayed from the '
        'digest-keyed verdict cache instead of re-scanning.'),
    'kyverno_tpu_verdict_cache_misses_total': Metric(
        'counter', 'Verdict-cache lookups that missed (changed or '
        'never-seen spec digest) and shipped to the dense scan.'),
    'kyverno_tpu_verdict_cache_evictions_total': Metric(
        'counter', 'Verdict rows dropped by the memory-LRU entry cap '
        'or generation snapshots dropped by the disk byte budget '
        '(KTPU_VERDICT_CACHE_MAX).'),
    'kyverno_tpu_verdict_cache_partial_hits_total': Metric(
        'counter', 'Partitioned-cache lookups that missed the full row '
        'but held every unchanged partition\'s subrow — the row '
        're-scanned against only the touched partitions\' policies '
        '(verdictcache/partitioned.py).'),
    'kyverno_tpu_rescan_rows_scanned': Metric(
        'gauge', 'Rows the most recent background reconcile evaluated '
        'on the dense device path.'),
    'kyverno_tpu_rescan_rows_replayed': Metric(
        'gauge', 'Rows the most recent background reconcile replayed '
        'from the verdict cache.'),
    # partitioned policy-set compilation (kyverno_tpu/partition/)
    'kyverno_tpu_partition_count': Metric(
        'gauge', 'Device-evaluated partitions of the most recently '
        'built partitioned scanner (KTPU_PARTITIONS).'),
    'kyverno_tpu_partition_recompiles_total': Metric(
        'counter', 'Partition evaluators built fresh (no evaluator-'
        'cache entry for the partition fingerprint) — under policy '
        'churn this should track touched partitions, not the set.'),
    'kyverno_tpu_partition_evaluator_reuses_total': Metric(
        'counter', 'Partition evaluators served from the process-wide '
        'evaluator cache (fingerprint unchanged across a scanner '
        'rebuild).'),
    'kyverno_tpu_partition_fallbacks_total': Metric(
        'counter', 'Scanner builds that requested partitioning but '
        'fell back to the monolithic whole-set compile '
        '(PartitionError: unsupported layout for composition).'),
    # scanner hot-swap under live traffic (webhooks/handlers.py)
    'kyverno_tpu_scanner_hot_swaps_total': Metric(
        'counter', 'Live scanner replacements after policy churn: the '
        'successor took over a same-kind predecessor\'s slot without '
        'draining traffic, by kind=.'),
    'kyverno_tpu_breaker_migrations_total': Metric(
        'counter', 'Circuit-breaker entries carried from a retired '
        'scanner\'s key to its hot-swap successor instead of being '
        'reset to closed.'),
    # AOT cache + warm-up instruments (aotcache/)
    'kyverno_tpu_aot_warm_duration_seconds': Metric(
        'histogram', 'Background warm-up wall time by target/state '
        '(aotcache/warmer.py).'),
    'kyverno_tpu_aot_cache_size_bytes': Metric(
        'gauge', 'Bytes of persisted AOT executables on disk '
        '(KTPU_AOT_CACHE_DIR).'),
    'kyverno_tpu_aot_cache_entries': Metric(
        'gauge', 'Persisted AOT executable entries on disk.'),
    'kyverno_tpu_aot_load_rejected_total': Metric(
        'counter', 'AOT store entries dropped instead of loaded; '
        'reason=undecodable|feature_mismatch|env_mismatch|jax_mismatch|'
        'deserialize_failed|execute_failed (a rejected entry falls back '
        'to a fresh persistent-XLA-cache-assisted compile, never a '
        'possibly-SIGILL load).'),
    # device-side mutate (kyverno_tpu/mutate/scanner.py)
    'kyverno_tpu_mutate_patch_emit_seconds': Metric(
        'histogram', 'Mutate patch-emit stage: encode the edit-site '
        'lanes and run the device kernel that decides per-(resource, '
        'rule) edit bitmasks.'),
    'kyverno_tpu_mutate_decode_seconds': Metric(
        'histogram', 'Mutate decode stage: edit bitmasks back to '
        '(slot, value) edit lists, copy-on-write patch application, '
        'and EngineResponse assembly on the host.'),
    'kyverno_tpu_mutate_device_edits_total': Metric(
        'counter', 'Individual edits applied from device-decided '
        'mutate edit lists.'),
    # decision provenance (observability/provenance.py)
    'kyverno_tpu_decision_duration_seconds': Metric(
        'histogram', 'End-to-end per-decision latency by serving '
        'path=batch|sync|shed:<reason>|cache_replay|host_fallback.'),
    'kyverno_tpu_decision_device_share_seconds': Metric(
        'histogram', 'Amortized device time one decision consumed '
        '(its batch device_eval time / riders; sync decisions carry '
        'their whole scan).'),
    # tracing health (observability/tracing.py)
    'kyverno_tpu_trace_export_errors_total': Metric(
        'counter', 'Span-exporter failures by exporter class; an '
        'exporter failing repeatedly is dropped after this counts it, '
        'so a dead exporter is visible instead of silent.'),
    # executable ledger (observability/executables.py)
    'kyverno_tpu_executable_count': Metric(
        'gauge', 'Live compiled executables in the lifecycle ledger, '
        'by source=fresh_compile|aot_load|persistent_xla.'),
    'kyverno_tpu_executable_dispatches_total': Metric(
        'counter', 'Device dispatches served per executable '
        'acquisition source.'),
    'kyverno_tpu_executable_device_seconds_total': Metric(
        'counter', 'Cumulative device-eval seconds spent per '
        'executable acquisition source.'),
    # pipeline critical-path observatory (observability/timeline.py)
    'kyverno_tpu_pipeline_blame_seconds_total': Metric(
        'counter', 'Exclusive critical-path blame per streaming-scan '
        'stage: seconds of scan wall the timeline walk attributed to '
        'stage= (executing or gated-waiting while on the e2e critical '
        'path); per-scan fractions drive the bottleneck advisor.'),
    # mesh-step telemetry (parallel/mesh.py, observability/fleet.py)
    'kyverno_tpu_mesh_step_duration_seconds': Metric(
        'histogram', 'Sharded-dispatch wall per mesh step: one series '
        'per shard index with that shard\'s device-eval wait '
        '(host-side block_until_ready split, arrival order), plus '
        'shard=all for the whole step.', fleet_scope='shard'),
    'kyverno_tpu_mesh_shard_skew_ratio': Metric(
        'gauge', 'Max-shard / mean-shard device-eval wall of the most '
        'recent mesh step, per mesh shape — 1.0 is a perfectly '
        'balanced step; the fleet skew analyzer windows this '
        '(KTPU_FLEET_SKEW_WINDOW) to name stragglers.',
        fleet_scope='mesh'),
    'kyverno_tpu_mesh_collective_seconds_total': Metric(
        'counter', 'Cumulative wall spent in cross-shard collectives '
        '(psum\'d summary readback + multi-host allgather) per mesh '
        'shape.', fleet_scope='mesh'),
    'kyverno_tpu_mesh_padding_rows_total': Metric(
        'counter', 'Rows added to pad mesh batches up to a multiple '
        'of the mesh size (canonical capacity included) — wasted '
        'device work per mesh shape.', fleet_scope='mesh'),
    # registry self-protection (observability/metrics.py)
    'kyverno_tpu_metric_series_dropped_total': Metric(
        'counter', 'New label-sets refused because a metric already '
        'held KTPU_METRIC_SERIES_MAX distinct series, by metric= — '
        'per-host/per-shard labels cannot explode the registry under '
        'a large fleet.'),
    # serving SLO engine (observability/slo.py)
    'kyverno_tpu_slo_burn_rate': Metric(
        'gauge', 'Admission-latency error-budget burn rate '
        '(error_rate / (1 - KTPU_SLO_TARGET)) by window=short|long; '
        '1.0 spends the budget exactly at the sustainable rate.'),
    'kyverno_tpu_slo_budget_remaining': Metric(
        'gauge', 'Fraction of the long-window error budget left '
        '(1 - long-window burn rate); negative means overspent.'),
}


#: every span name this process starts, with what it covers — the
#: tracing analogue of METRICS, drift-checked by ktpu-lint KTPU504/505.
#: ``<...>`` segments mark route-/name-templated spans whose start
#: sites build the name dynamically (an f-string site is checked by its
#: literal prefix).
SPANS: Dict[str, str] = {
    'webhooks/<route>': 'Admission HTTP handler root span (one per '
                        'request; route-templated).',
    'kyverno/engine/rule': 'One host-engine rule execution.',
    'kyverno/serving/batch': 'One coalesced admission dispatch (batch '
                             'serving mode); carries occupancy.',
    'kyverno/device/scan': 'One device-scan chunk: device wait + host '
                           'assembly.',
    'kyverno/device/chunk': 'Dispatch-thread wrapper seeding the '
                            'per-chunk stage spans.',
    'kyverno/device/pack': 'Pack-plan build stage.',
    'kyverno/device/encode': 'Host feature-extraction (encode) stage.',
    'kyverno/device/h2d': 'Host-to-device transfer stage.',
    'kyverno/device/device_eval': 'Device evaluation dispatch stage.',
    'kyverno/device/d2h': 'Device-to-host readback stage (stall-'
                          'watchdog armed).',
    'kyverno/device/report': 'Response/report assembly stage.',
    'kyverno/device/match': 'Per-chunk match mask (match_matrix) in the '
                            'pipeline\'s encode thread, before the '
                            'chunk is encoded.',
    'kyverno/device/wait': 'The report loop waiting for the pipeline\'s '
                           'next chunk (a leaf span: the stages it '
                           'drives parent under the scan\'s span).',
    'kyverno/device/gc': 'One garbage-collector pause while device '
                         'telemetry is on, on the thread that started '
                         'it (a leaf span; every thread waits).',
    'kyverno/mutate/patch_emit': 'Device mutate patch-emit stage: '
                                 'edit-site lane encode + kernel '
                                 'dispatch for one batch.',
    'kyverno/mutate/decode': 'Device mutate decode stage: edit '
                             'bitmasks to patched JSON + engine '
                             'responses.',
    'kyverno/mesh/step': 'One sharded mesh dispatch '
                         '(distributed_scan_step): carries mesh '
                         'shape, per-shard row occupancy, skew ratio '
                         'and the blamed straggler shard.',
    'kyverno/rescan': 'One background reconcile tick (verdict-cache '
                      'filter + dense scan of the misses).',
    'kyverno/background/ur': 'One UpdateRequest sync.',
    'kyverno/aot/warmer': 'Background AOT warm-up pass.',
    'kyverno/executable/<event>': 'Executable-ledger lifecycle event '
                                  '(build/evict) as a zero-duration '
                                  'span; the JSONL trace exporter is '
                                  'the lifecycle log.',
}


#: canonical streaming-pipeline stage labels — the single source of
#: truth for every ``stage('<s>')`` timer, ``ChunkPipeline`` stage-list
#: entry, and backpressure attribution in the tree (ktpu-lint KTPU507:
#: an unregistered label under ``compiler/`` or a dead registry entry
#: is catalog drift).  The timeline recorder and its critical-path
#: blame walk (observability/timeline.py) group events by these names.
PIPELINE_STAGES: Dict[str, str] = {
    'intake': 'Feeder admission into the streaming pipeline (chunk '
              'slot acquire + first-queue handoff).',
    'pack': 'Pack-plan build.',
    'encode': 'Host feature extraction (columnar lane encode, inline '
              'or forked worker).',
    'h2d': 'Host-to-device transfer (and forked-encode resolution).',
    'device_eval': 'Device evaluation dispatch.',
    'd2h': 'Device-to-host readback (stall-watchdog armed).',
    'report': 'Report-row assembly / flush window.',
    'match': 'Per-chunk match mask in the encode stage\'s thread '
             '(streaming report scans).',
    'wait': 'The report loop waiting for the next chunk (not pipeline '
            'work: drives the stages, never one of them).',
    'gc': 'A garbage-collector pause, in every live scan (not pipeline '
          'work).',
}
