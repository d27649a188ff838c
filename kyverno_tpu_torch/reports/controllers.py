"""Report-side controllers: resource metadata cache, background scanner,
admission-report dedup (reference: pkg/controllers/report/{resource,
background,admission}/controller.go).

The background scan is where the device path plugs into the control
plane: instead of the reference's per-resource workqueue loop calling
the engine once per (resource, policy), pending resources drain in
batches through ``BatchScanner`` — the CUDA card evaluates the whole
[resources × rules] verdict matrix in one shot and only non-pass
entries touch the host engine.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..api.policy import Policy
from ..api.unstructured import Resource
from ..compiler.scan import BatchScanner
from ..engine.engine import Engine
from ..verdictcache.keys import spec_digest
from .results import set_responses
from .types import (calculate_resource_hash, new_background_scan_report,
                    set_managed_by_kyverno_label,
                    set_resource_version_labels)

ANNOTATION_LAST_SCAN_TIME = 'audit.kyverno.io/last-scan-time'


class MetadataCache:
    """Resource-metadata cache keyed by uid
    (reference: pkg/controllers/report/resource/controller.go
    MetadataCache): tracks the resource versions/hashes the scanner uses
    for invalidation.  ``add_invalidator`` registers uid-keyed hooks the
    cache calls on every content change or delete — the watch/
    resourceVersion delta the verdict cache rides for free."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self._invalidators: List[Callable[[str], Any]] = []

    def add_invalidator(self, fn: Callable[[str], Any]) -> None:
        """``fn(uid)`` runs (outside the cache lock) whenever a
        resource's hash changes or the resource is removed."""
        self._invalidators.append(fn)

    def _invalidate(self, uid: str) -> None:
        for fn in self._invalidators:
            try:
                fn(uid)
            except Exception:  # noqa: BLE001 - hooks must not break sync
                pass

    def update(self, resource: dict) -> bool:
        """Record a resource; returns True when its hash changed."""
        meta = resource.get('metadata') or {}
        uid = meta.get('uid') or f"{resource.get('kind')}/" \
            f"{meta.get('namespace', '')}/{meta.get('name', '')}"
        h = calculate_resource_hash(resource)
        with self._lock:
            old = self._entries.get(uid)
            self._entries[uid] = {
                'uid': uid,
                'kind': resource.get('kind', ''),
                'apiVersion': resource.get('apiVersion', ''),
                'namespace': meta.get('namespace', ''),
                'name': meta.get('name', ''),
                'hash': h,
                # verdict-cache key, computed once per content change
                # instead of once per reconcile tick over every row
                'digest': spec_digest(resource),
                'resource': resource,
            }
        changed = old is None or old['hash'] != h
        if changed and old is not None:
            self._invalidate(uid)
        return changed

    def remove(self, resource: dict) -> None:
        """Forget a deleted resource — and drop its verdict-cache rows
        via the invalidators, so a recreated resource with a stale uid
        can never replay old verdicts."""
        meta = resource.get('metadata') or {}
        uid = meta.get('uid') or f"{resource.get('kind')}/" \
            f"{meta.get('namespace', '')}/{meta.get('name', '')}"
        with self._lock:
            self._entries.pop(uid, None)
        self._invalidate(uid)

    def entries(self) -> List[dict]:
        with self._lock:
            return list(self._entries.values())

    def get(self, uid: str) -> Optional[dict]:
        with self._lock:
            return self._entries.get(uid)


class ResourceController:
    """Watches the resource kinds matched by the live policy set and
    keeps the MetadataCache in sync (reference:
    report/resource/controller.go:342)."""

    def __init__(self, client, cache: Optional[MetadataCache] = None,
                 on_change: Optional[Callable[[dict], None]] = None):
        self.client = client
        self.cache = cache or MetadataCache()
        self.on_change = on_change
        self._kinds: Set[str] = set()

    def update_policies(self, policies: List[Policy]) -> None:
        kinds: Set[str] = set()
        for policy in policies:
            for rule in policy.rules:
                match = rule.raw.get('match') or {}
                for f in [match] + (match.get('any') or []) + \
                        (match.get('all') or []):
                    for k in (f.get('resources') or {}).get('kinds') or []:
                        kinds.add(str(k).split('/')[-1])
        self._kinds = kinds

    def sync(self) -> List[dict]:
        """Poll-list the watched kinds; returns changed resources
        (informer events in the reference)."""
        changed = []
        for kind in sorted(self._kinds):
            try:
                items = self.client.list_resource('', kind, '', None)
            except Exception:  # noqa: BLE001
                continue
            for item in items:
                if self.cache.update(item):
                    changed.append(item)
                    if self.on_change is not None:
                        self.on_change(item)
        return changed


class BackgroundScanController:
    """Background-scan loop with last-scan-time resumability
    (reference: pkg/controllers/report/background/controller.go:40-46:
    2 workers / 30s enqueue delay; the batch path replaces the
    per-resource queue with device-evaluated chunks).  Its scanners run
    on ``device`` (default: the CUDA card; they raise without one — pass
    ``device='cpu'`` for the host)."""

    def __init__(self, client, policies: List[Policy],
                 cache: Optional[MetadataCache] = None,
                 engine: Optional[Engine] = None, device=None):
        self.client = client
        self.device = device
        self.cache = cache or MetadataCache()
        if engine is None and client is not None:
            from ..engine.apicall import make_context_loader
            engine = Engine(context_loader=make_context_loader(
                dclient=client))
        self.engine = engine or Engine()
        self._lock = threading.Lock()
        self._pending: Set[str] = set()
        self._scanned: Dict[str, Tuple[str, float]] = {}  # uid → (hash, ts)
        self._policy_epoch = 0.0
        self.verdict_cache = None
        #: per-reconcile rescan accounting (mirrors the
        #: kyverno_tpu_rescan_rows_* gauges for in-process readers)
        self.rescan_stats: Dict[str, int] = {
            'rows_pending': 0, 'rows_scanned': 0, 'rows_replayed': 0}
        self.set_policies(policies)
        # verdict-cache invalidation rides the metadata cache's
        # resourceVersion/delete deltas for free
        self.cache.add_invalidator(self._drop_verdicts)

    def set_policies(self, policies: List[Policy]) -> None:
        """Policy change invalidates every prior scan
        (reference: controller.go re-enqueues on policy events).  The
        verdict cache flushes by fingerprint: a changed policy set opens
        a new cache generation, so stale rows can never replay."""
        from ..ops.eval import policy_set_fingerprint
        from ..verdictcache import VerdictCache
        self.policies = policies
        self.scanner = BatchScanner(policies, engine=self.engine,
                                    device=self.device)
        self._policy_index = {id(p): i for i, p in enumerate(policies)}
        # rows are only cacheable when every contributing result is a
        # pure function of (resource, policy set): host-riding policies
        # and context-loading rules consult external state per tick, so
        # their rows must re-evaluate on the dense path every time
        self._verdicts_cacheable = (
            not self.scanner._host_policy_idx and
            all(p.context_spec is None for p in self.scanner.cps.programs))
        old_cache = self.verdict_cache
        if old_cache is not None:
            old_cache.flush()
        self._policy_fingerprint = policy_set_fingerprint(policies)
        self.verdict_cache = None
        # partitioned generations (KTPU_PARTITIONS>0): verdict rows key
        # by partition fingerprint instead of the whole-set fingerprint,
        # so a policy edit only rolls the touched partitions' rows — and
        # the diff against the previous plan scopes the next reconcile's
        # rescan to the touched partitions' member policies
        old_plan = getattr(self, '_partition_plan', None)
        self._partition_plan = None
        self._scoped_pids: frozenset = frozenset()
        self._scoped_scanner = None
        self._scoped_globals: Dict[int, int] = {}
        from ..partition.plan import env_partitions
        if env_partitions() > 0:
            from ..partition.plan import (PartitionError, build_plan,
                                          diff_plans)
            from ..verdictcache import PartitionedVerdictCache
            try:
                plan = build_plan(policies, env_partitions())
            except PartitionError:
                plan = None
            if plan is not None:
                self._partition_plan = plan
                self.verdict_cache = PartitionedVerdictCache.from_env(
                    plan, policies,
                    prev=old_cache if isinstance(
                        old_cache, PartitionedVerdictCache) else None)
                if old_plan is not None:
                    diff = diff_plans(old_plan, plan)
                    if diff.touched and diff.unchanged:
                        self._scoped_pids = frozenset(diff.touched)
        if self.verdict_cache is None and self._partition_plan is None:
            self.verdict_cache = VerdictCache.from_env(
                self._policy_fingerprint)
        with self._lock:
            self._policy_epoch = time.time()

    def _get_scoped_scanner(self) -> Optional[BatchScanner]:
        """Lazily build the scanner scoped to the touched partitions'
        member policies (the partition evaluator cache makes this
        near-free: the touched partitions were just compiled for the
        full scanner, and the scoped sub-set re-derives the same
        partition fingerprints)."""
        if not self._scoped_pids or self._partition_plan is None:
            return None
        if self._scoped_scanner is None:
            plan = self._partition_plan
            idx = [i for i in range(len(self.policies))
                   if plan.assignment[i] in self._scoped_pids]
            members = [self.policies[i] for i in idx]
            self._scoped_scanner = BatchScanner(members, engine=self.engine,
                                                device=self.device)
            self._scoped_globals = {id(p): g
                                    for p, g in zip(members, idx)}
        return self._scoped_scanner

    def _drop_verdicts(self, uid: str) -> None:
        vc = self.verdict_cache
        if vc is not None:
            vc.invalidate_uid(uid)

    def reset_scan_state(self) -> None:
        """Forget per-process resumability: the next reconcile rebuilds
        every enqueued resource's report (what a process restart or a
        report-repair pass demands).  With a warm verdict cache that
        full demand stays O(churn) — unchanged rows replay."""
        self._scanned.clear()

    def close(self) -> None:
        """Persist the verdict cache (daemon shutdown hook)."""
        vc = self.verdict_cache
        if vc is not None:
            vc.flush()

    def enqueue(self, resource: dict) -> None:
        self.cache.update(resource)
        meta = resource.get('metadata') or {}
        uid = meta.get('uid') or f"{resource.get('kind')}/" \
            f"{meta.get('namespace', '')}/{meta.get('name', '')}"
        with self._lock:
            self._pending.add(uid)

    def enqueue_all(self) -> None:
        with self._lock:
            self._pending.update(e['uid'] for e in self.cache.entries())

    def _pending_rows(self, pending, epoch):
        """Yield ``(uid, resource, hash, digest)`` for each pending uid
        that actually needs work — a generator, so the cache-hit pass
        streams entries one at a time instead of double-materializing a
        1M-entry MetadataCache into parallel row lists before the
        replay/miss partition."""
        for uid in pending:
            entry = self.cache.get(uid)
            if entry is None:
                continue
            prior = self._scanned.get(uid)
            if prior is not None and prior[0] == entry['hash'] and \
                    prior[1] >= epoch:
                continue  # resumability: already scanned this version
            yield (uid, entry['resource'], entry['hash'],
                   entry.get('digest') or spec_digest(entry['resource']))

    def reconcile(self, now: Optional[float] = None) -> List[dict]:
        """Drain the pending set through the verdict-cache filter and
        one batched device scan of the misses, writing
        BackgroundScanReport CRs; unchanged resources scanned after the
        last policy change are skipped.  ``now`` pins the scan
        timestamp (tests use it for bit-identity comparisons)."""
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
            epoch = self._policy_epoch
        now = time.time() if now is None else now
        from ..observability import provenance, tracing
        from ..observability import device as devtel
        from ..verdictcache import publish_tick
        # decision provenance: every rescan row yields one record —
        # cache_replay (digest, zero device share), batch (dense-scan
        # riders share the tick's device_eval time), or host_fallback
        # (exception-present host sweep)
        prov_on = provenance.enabled()
        # PolicyExceptions are rare and rule-targeted; when any exist
        # the host engine decides (exception semantics:
        # pkg/engine/validation.go:826 hasPolicyExceptions — the
        # compiled path has no exception lanes) and rows are
        # exception-dependent, so the verdict cache stands aside
        exceptions = self._list_exceptions()
        vc = self.verdict_cache \
            if self._verdicts_cacheable and not exceptions else None
        reports: List[dict] = []
        rows = self._pending_rows(pending, epoch)
        try:
            first = next(rows)
        except StopIteration:
            return []
        import itertools
        rows = itertools.chain([first], rows)
        with tracing.start_span('kyverno/rescan', {
                'cache': 'on' if vc is not None else 'off'}) as span:
            if exceptions:
                n_work = 0
                for uid, resource, rhash, digest in rows:
                    n_work += 1
                    t_row = time.monotonic() if prov_on else 0.0
                    report = self._store_report(
                        uid, resource,
                        self._host_scan_row(resource, exceptions),
                        now, rhash)
                    self._scanned[uid] = (rhash, now)
                    if report is not None:
                        reports.append(report)
                    if prov_on:
                        self._record_row(
                            provenance, 'host_fallback', uid, resource,
                            duration_s=time.monotonic() - t_row)
                self._tick_stats(span, publish_tick, n_work,
                                 scanned=n_work, replayed=0)
                return reports
            # verdict-cache filter stage, single streaming pass: hit
            # rows replay (and write their report) the moment they are
            # seen — only the misses (O(churn)) accumulate for the
            # batched device scan
            ts = int(now)
            miss_uids: List[str] = []
            miss_work: List[dict] = []
            miss_digests: List[str] = []
            miss_hashes: List[str] = []
            scoped_uids: List[str] = []
            scoped_work: List[dict] = []
            scoped_digests: List[str] = []
            scoped_hashes: List[str] = []
            scoped_cached: List[dict] = []
            # scoped rescan (partitioned cache, post-churn): a full-row
            # miss whose unchanged partitions all still hold subrows
            # only needs the touched partitions re-evaluated
            scoped_ok = bool(self._scoped_pids) and hasattr(vc, 'partial')
            replayed = 0
            if vc is not None:
                for uid, resource, rhash, digest in rows:
                    row = vc.lookup(digest)
                    if row is None:
                        if scoped_ok:
                            cached = vc.partial(digest, self._scoped_pids)
                            if cached is not None:
                                scoped_uids.append(uid)
                                scoped_work.append(resource)
                                scoped_digests.append(digest)
                                scoped_hashes.append(rhash)
                                scoped_cached.append(cached)
                                continue
                        miss_uids.append(uid)
                        miss_work.append(resource)
                        miss_digests.append(digest)
                        miss_hashes.append(rhash)
                        continue
                    t_row = time.monotonic() if prov_on else 0.0
                    report = self._store_fused_report(
                        uid, resource, vc.replay(row, self.policies, ts),
                        now, rhash)
                    self._scanned[uid] = (rhash, now)
                    if report is not None:
                        reports.append(report)
                    replayed += 1
                    if prov_on:
                        self._record_row(
                            provenance, 'cache_replay', uid, resource,
                            duration_s=time.monotonic() - t_row,
                            verdict_digest=digest)
            else:
                for uid, resource, rhash, digest in rows:
                    miss_uids.append(uid)
                    miss_work.append(resource)
                    miss_digests.append(digest)
                    miss_hashes.append(rhash)
            # scoped rescan: partial-hit rows re-evaluate against ONLY
            # the touched partitions' policies; the unchanged subrows
            # come from the cache and merge_scoped composes + stores
            # the full row (O(touched) device work per row, not O(set))
            if scoped_work:
                scanner = self._get_scoped_scanner()
                cap_s = devtel.ScanCapture()
                t_scoped = time.monotonic()
                with devtel.install_capture(cap_s):
                    for uid, resource, digest, rhash, cached, row in zip(
                            scoped_uids, scoped_work, scoped_digests,
                            scoped_hashes, scoped_cached,
                            scanner.scan_report_results(scoped_work,
                                                        now)):
                        results, summary, row_policies = row
                        m_res, m_sum, m_idx = vc.merge_scoped(
                            digest, uid, cached, results, summary,
                            [self._scoped_globals[id(p)]
                             for p in row_policies], ts)
                        report = self._store_fused_report(
                            uid, resource,
                            (m_res, m_sum,
                             [self.policies[g] for g in m_idx]),
                            now, rhash)
                        self._scanned[uid] = (rhash, now)
                        if report is not None:
                            reports.append(report)
                if prov_on:
                    n_scoped = len(scoped_work)
                    elapsed = time.monotonic() - t_scoped
                    device_eval_s = cap_s.stage_s('device_eval')
                    batch_id = provenance.next_batch_id('rescan-scoped')
                    for uid, resource in zip(scoped_uids, scoped_work):
                        self._record_row(
                            provenance, 'batch', uid, resource,
                            duration_s=elapsed / n_scoped,
                            batch_id=batch_id, occupancy=n_scoped,
                            device_share_s=device_eval_s / n_scoped,
                            device_eval_s=device_eval_s,
                            aot_cache=cap_s.aot,
                            coverage_ratio=cap_s.coverage_ratio)
            # fused fast path over the misses: report results assembled
            # straight from the device cells (bit-identity pinned by
            # tests/test_report_fusion), rows written back to the cache
            if miss_work:
                # the capture feeds both provenance (device-share
                # amortization) and the tick's overlap attribution
                cap = devtel.ScanCapture()
                t_scan = time.monotonic()
                with devtel.install_capture(cap):
                    for uid, resource, digest, rhash, row in zip(
                            miss_uids, miss_work, miss_digests,
                            miss_hashes,
                            self.scanner.scan_report_results(miss_work,
                                                             now)):
                        report = self._store_fused_report(
                            uid, resource, row, now, rhash)
                        self._scanned[uid] = (rhash, now)
                        if report is not None:
                            reports.append(report)
                        if vc is not None:
                            results, summary, row_policies = row
                            vc.store(digest, uid, results, summary,
                                     [self._policy_index[id(p)]
                                      for p in row_policies])
                # per-stage busy time ÷ tick wall: >1 means the
                # pipeline legs genuinely overlapped this tick (the
                # pipeline's work stages only: not the report loop's
                # wait, collector pauses, device time or CPU seconds)
                scan_wall = time.monotonic() - t_scan
                if scan_wall > 0:
                    stages = cap.stages
                    busy = sum(stages.get(s, 0.0) for s in devtel.STAGES)
                    span.set_attribute('overlap_ratio',
                                       round(busy / scan_wall, 4))
                if cap.critical_path:
                    from ..observability import timeline as tlmod
                    span.set_attribute(
                        'critical_path',
                        tlmod.format_summary(cap.critical_path))
                if prov_on:
                    # dense-scanned rows are riders of one shared tick
                    # scan: the tick's device_eval time amortizes over
                    # them exactly like an admission batch's riders
                    n_miss = len(miss_work)
                    elapsed = time.monotonic() - t_scan
                    device_eval_s = cap.stage_s('device_eval')
                    batch_id = provenance.next_batch_id('rescan')
                    for uid, resource in zip(miss_uids, miss_work):
                        self._record_row(
                            provenance, 'batch', uid, resource,
                            duration_s=elapsed / n_miss,
                            batch_id=batch_id, occupancy=n_miss,
                            device_share_s=device_eval_s / n_miss,
                            device_eval_s=device_eval_s,
                            aot_cache=cap.aot,
                            coverage_ratio=cap.coverage_ratio)
            self._tick_stats(span, publish_tick,
                             len(miss_work) + len(scoped_work) + replayed,
                             scanned=len(miss_work) + len(scoped_work),
                             replayed=replayed, scoped=len(scoped_work))
        if vc is not None:
            vc.flush()
        return reports

    def _record_row(self, provenance, path: str, uid: str,
                    resource: dict, **fields) -> None:
        """One rescan row's DecisionRecord (resource identity + the
        controller's policy-set fingerprint folded in)."""
        meta = resource.get('metadata') or {}
        provenance.record_decision(
            path=path, source='rescan', uid=uid,
            kind=resource.get('kind', '') or '',
            namespace=meta.get('namespace', '') or '',
            name=meta.get('name', '') or '',
            fingerprint=self._policy_fingerprint, **fields)

    def _tick_stats(self, span, publish_tick, pending: int, scanned: int,
                    replayed: int, scoped: int = 0) -> None:
        self.rescan_stats = {'rows_pending': pending,
                             'rows_scanned': scanned,
                             'rows_replayed': replayed}
        span.set_attribute('rows_scanned', scanned)
        span.set_attribute('rows_replayed', replayed)
        if scoped:
            # only surfaced when a partition-scoped rescan ran, so the
            # steady-state stats dict keeps its legacy three-key shape
            self.rescan_stats['rows_scoped'] = scoped
            span.set_attribute('rows_scoped', scoped)
        publish_tick(scanned, replayed)

    def _store_fused_report(self, uid: str, resource: dict, row,
                            now: float,
                            resource_hash: Optional[str] = None
                            ) -> Optional[dict]:
        from .types import build_fused_report
        results, summary, row_policies = row
        meta = resource.get('metadata') or {}
        ns = meta.get('namespace', '')
        report = build_fused_report(resource, results, summary,
                                    row_policies)
        if not report['metadata'].get('name'):
            report['metadata']['name'] = uid.replace('/', '-').lower()
        set_resource_version_labels(report, resource, resource_hash)
        report['metadata'].setdefault('annotations', {})[
            ANNOTATION_LAST_SCAN_TIME] = _rfc3339(now)
        return self._write_report(report, ns)

    def _write_report(self, report: dict, ns: str) -> Optional[dict]:
        from .results import get_results
        existing = None
        try:
            existing = self.client.get_resource(
                'kyverno.io/v1alpha2', report['kind'], ns,
                report['metadata']['name'])
        except Exception:  # noqa: BLE001
            existing = None
        if not get_results(report):
            # no policy produced a result (e.g. the policy set shrank):
            # an empty report is deleted, not kept around (reference:
            # report/background/controller.go reconcileReport)
            if existing is not None:
                try:
                    self.client.delete_resource(
                        'kyverno.io/v1alpha2', report['kind'], ns,
                        report['metadata']['name'])
                except Exception:  # noqa: BLE001
                    pass
            return None
        if existing is not None:
            existing.update({k: report[k]
                             for k in ('metadata', 'spec', 'results',
                                       'summary') if k in report})
            return self.client.update_resource(
                'kyverno.io/v1alpha2', report['kind'], ns, existing)
        return self.client.create_resource(
            'kyverno.io/v1alpha2', report['kind'], ns, report)

    def _list_exceptions(self) -> List[dict]:
        if self.client is None:
            return []
        out: List[dict] = []
        for api_version in ('kyverno.io/v2alpha1', 'kyverno.io/v2beta1'):
            try:
                out += self.client.list_resource(api_version,
                                                 'PolicyException')
            except Exception:  # noqa: BLE001
                pass
        return out

    def _host_scan_row(self, doc: dict, exceptions: List[dict]):
        from ..engine.api import PolicyContext
        responses = []
        for policy in self.policies:
            pctx = PolicyContext(policy, new_resource=doc,
                                 exceptions=exceptions)
            responses.append(
                self.engine.apply_background_checks(pctx))
        return responses

    def _store_report(self, uid: str, resource: dict, responses,
                      now: float, resource_hash: Optional[str] = None
                      ) -> Optional[dict]:
        meta = resource.get('metadata') or {}
        ns = meta.get('namespace', '')
        report = new_background_scan_report(resource)
        if not report['metadata'].get('name'):
            report['metadata']['name'] = uid.replace('/', '-').lower()
        set_resource_version_labels(report, resource, resource_hash)
        # the scan timestamp annotation drives resumability
        # (reference: controller.go:44 audit.kyverno.io/last-scan-time)
        report.setdefault('metadata', {}).setdefault('annotations', {})[
            ANNOTATION_LAST_SCAN_TIME] = _rfc3339(now)
        relevant = [r for r in responses if r.policy_response.rules]
        set_responses(report, *relevant)
        return self._write_report(report, ns)


class AdmissionReportController:
    """Aggregates per-request AdmissionReports by resource uid and
    deduplicates (reference: report/admission/controller.go:258)."""

    def __init__(self, client):
        self.client = client

    def reconcile(self) -> int:
        """Merge duplicate reports per resource uid; returns merge count."""
        merged = 0
        for kind in ('AdmissionReport', 'ClusterAdmissionReport'):
            try:
                reports = self.client.list_resource(
                    'kyverno.io/v1alpha2', kind, '', None)
            except Exception:  # noqa: BLE001
                continue
            by_uid: Dict[str, List[dict]] = {}
            for report in reports:
                labels = (report.get('metadata') or {}).get('labels') or {}
                uid = labels.get('audit.kyverno.io/resource.uid', '')
                if not uid:
                    continue  # unlabeled reports are not dedup candidates
                by_uid.setdefault(uid, []).append(report)
            for uid, group in by_uid.items():
                group.sort(key=lambda r: (r.get('metadata') or {}).get(
                    'creationTimestamp', ''))
                primary = group[0]
                from .results import (calculate_summary, get_results,
                                      sort_report_results)
                results = list(get_results(primary))
                for extra in group[1:]:
                    results.extend(get_results(extra))
                    ns = (extra.get('metadata') or {}).get('namespace', '')
                    self.client.delete_resource(
                        'kyverno.io/v1alpha2', kind, ns,
                        (extra.get('metadata') or {}).get('name', ''))
                # aggregation stamps the owning resource ref onto every
                # result (reference: report/admission/controller.go:131
                # mergeReports — result.Resources = objectRefs)
                owner_refs = (primary.get('metadata') or {}).get(
                    'ownerReferences') or []
                ns = (primary.get('metadata') or {}).get('namespace', '')
                changed = len(group) > 1
                if len(owner_refs) == 1:
                    owner = owner_refs[0]
                    object_ref = {
                        'apiVersion': owner.get('apiVersion', ''),
                        'kind': owner.get('kind', ''),
                        'name': owner.get('name', ''),
                    }
                    if ns:
                        object_ref['namespace'] = ns
                    if owner.get('uid'):
                        object_ref['uid'] = owner['uid']
                    for result in results:
                        if not result.get('resources'):
                            result['resources'] = [object_ref]
                            changed = True
                if not changed:
                    continue
                sort_report_results(results)
                spec = primary.setdefault('spec', {})
                spec['results'] = results
                spec['summary'] = calculate_summary(results)
                self.client.update_resource(
                    'kyverno.io/v1alpha2', kind, ns, primary)
                merged += 1
        return merged


def _rfc3339(ts: float) -> str:
    import datetime
    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc).strftime('%Y-%m-%dT%H:%M:%SZ')
