"""Bounded overlapped chunk pipeline for the streaming scan path.

The 1M-resource background scan is a classic producer chain —
encode → h2d → device_eval → d2h → assemble — and before this module
it ran as two fat threads (encode, dispatch) with the assembly serial
behind them.  Here each leg is its own worker thread connected by
depth-1 queues, with a global in-flight budget (``KTPU_PIPELINE_DEPTH``
chunk slots, default 2): resources flow through a fixed set of buffers
and the pipeline *backpressures* instead of buffering — a slow d2h leg
stalls intake rather than ballooning RSS, which is the paged/streaming
discipline of Ragged Paged Attention applied to the host side.

Instrumentation rides the existing device-telemetry surface: every
stage span re-parents under the scan's request span and feeds the
ambient :class:`~..observability.device.ScanCapture`, blocked ``put``
time lands on ``kyverno_tpu_scan_backpressure_seconds_total{stage}``,
and the number of resident chunks is exported as the
``kyverno_tpu_scan_pipeline_inflight_chunks`` gauge.  Items leave the
pipeline in submission order (single worker per stage, FIFO queues).

Failure model: a transient stage error is retried per chunk
(``KTPU_STAGE_RETRIES`` attempts beyond the first, exponential
backoff) before surfacing at the consumer; an error that burns the
whole budget is marked ``ktpu_retry_exhausted`` and attributed on the
coverage ledger.  Whenever a chunk dies — terminal stage error, or the
stream aborting with chunks still in flight — the ``cleanup`` hook
runs on that chunk's current value, so owners of pooled buffers (the
scanner's encode arena) reclaim them instead of leaking per crash.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple


def pipeline_depth(default: int = 2) -> int:
    """The in-flight chunk budget (``KTPU_PIPELINE_DEPTH``, min 1)."""
    try:
        return max(1, int(os.environ.get('KTPU_PIPELINE_DEPTH',
                                         str(default))))
    except ValueError:
        return default


def stage_retries(default: int = 1) -> int:
    """Retry attempts per (chunk, stage) beyond the first
    (``KTPU_STAGE_RETRIES``, min 0)."""
    try:
        return max(0, int(os.environ.get('KTPU_STAGE_RETRIES',
                                         str(default))))
    except ValueError:
        return default


#: backoff before retry attempt k is ``_RETRY_BACKOFF_S * 2**(k-1)`` —
#: enough for a transient device hiccup to clear, far below the shed
#: deadline of any batched rider waiting on the scan
_RETRY_BACKOFF_S = 0.005


class _Item:
    __slots__ = ('value', 'error', 'seq')

    def __init__(self, value: Any, seq: int = -1):
        self.value = value
        self.seq = seq
        self.error: Optional[BaseException] = None


_SENTINEL = object()


class ChunkPipeline:
    """Run items through named stages on one worker thread per stage.

    ``stages`` is a sequence of ``(name, fn)`` pairs; each ``fn`` maps
    the previous stage's value to the next.  :meth:`run` is a generator
    yielding the final values in submission order; a stage exception
    surfaces at the consumer for the item that failed (later items
    still flow), after ``retries`` transparent re-runs of the failing
    stage on that chunk.  Closing the generator early stops intake and
    drains the workers — no thread outlives the ``run`` call, and
    ``cleanup(value)`` runs for every chunk that errored or was still
    in flight when the stream ended."""

    def __init__(self, stages: Sequence[Tuple[str, Callable[[Any], Any]]],
                 depth: Optional[int] = None, capture=None,
                 parent_span=None,
                 cleanup: Optional[Callable[[Any], None]] = None,
                 retries: Optional[int] = None, timeline=None):
        self.stages = list(stages)
        #: per-scan event recorder (observability/timeline.py
        #: ScanTimeline) — None keeps every hook on its no-cost branch
        self.timeline = timeline
        self.depth = depth if depth is not None else pipeline_depth()
        self.capture = capture
        self.parent_span = parent_span
        self.cleanup = cleanup
        self.retries = retries if retries is not None else stage_retries()
        self._queues: List[queue.Queue] = \
            [queue.Queue(maxsize=1) for _ in self.stages]
        self._out: queue.Queue = queue.Queue()
        self._slots = threading.Semaphore(self.depth)
        self._stop = threading.Event()
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    # -- telemetry ----------------------------------------------------------

    def _track(self, delta: int) -> None:
        from ..observability import device as devtel
        with self._inflight_lock:
            self._inflight += delta
            n = self._inflight
        devtel.set_pipeline_inflight(n)

    def _put(self, q: queue.Queue, stage: str, item) -> None:
        """Queue put with blocked time attributed as backpressure."""
        from ..observability import device as devtel
        try:
            q.put_nowait(item)
            return
        except queue.Full:
            pass
        t0 = time.monotonic()
        q.put(item)
        devtel.add_backpressure(stage, time.monotonic() - t0)
        tl = self.timeline
        if tl is not None and isinstance(item, _Item):
            tl.block(item.seq, stage, t0)

    def _cleanup(self, value: Any) -> None:
        """Best-effort owner cleanup for a chunk that will never reach
        the consumer (terminal stage error or an aborted stream)."""
        if self.cleanup is None or value is None:
            return
        try:
            self.cleanup(value)
        except Exception:  # ktpu: noqa[KTPU304] -- best-effort buffer
            pass           # reclaim; the chunk's own error already surfaced

    def _run_stage(self, name: str, fn: Callable[[Any], Any],
                   item) -> None:
        """Apply one stage to one chunk with the per-chunk retry
        budget; a terminal failure records the exhaustion, releases
        the chunk's buffers, and parks the error on the item for the
        consumer."""
        attempt = 0
        while True:
            try:
                item.value = fn(item.value)
                return
            except BaseException as e:  # noqa: BLE001 - surfaces
                attempt += 1            # at the consumer
                # only plain Exceptions are retry candidates —
                # KeyboardInterrupt/SystemExit must surface immediately
                if attempt <= self.retries and isinstance(e, Exception) \
                        and not self._stop.is_set():
                    t_r = time.monotonic()
                    time.sleep(_RETRY_BACKOFF_S * (2.0 ** (attempt - 1)))
                    if self.timeline is not None:
                        self.timeline.retry(item.seq, name, t_r, attempt)
                    continue
                if attempt > 1:
                    # the whole retry budget burned: mark the error so
                    # shed accounting downstream (batcher quarantine)
                    # can attribute it, and count the attributed fall
                    from ..observability import coverage
                    try:
                        e.ktpu_retry_exhausted = True
                        e.ktpu_stage = name
                    except Exception:  # ktpu: noqa[KTPU304] -- exotic
                        pass           # exception sans __dict__
                    coverage.record_fallback(
                        'serving', coverage.REASON_STAGE_RETRY_EXHAUSTED)
                item.error = e
                self._cleanup(item.value)
                item.value = None
                return

    # -- workers ------------------------------------------------------------

    def _worker(self, i: int) -> None:
        from ..observability import device as devtel
        from ..observability import tracing
        name, fn = self.stages[i]
        qin = self._queues[i]
        qout = self._queues[i + 1] if i + 1 < len(self.stages) else self._out
        next_name = self.stages[i + 1][0] if i + 1 < len(self.stages) \
            else None
        tl = self.timeline
        # worker threads have no ambient span/capture: re-install the
        # scan's so stage spans join the caller's trace and stage time
        # lands on the right provenance record
        with devtel.install_capture(self.capture), \
                tracing.install_span(self.parent_span):
            while True:
                item = qin.get()
                if item is _SENTINEL:
                    qout.put(item)
                    return
                if item.error is None and not self._stop.is_set():
                    if tl is not None:
                        tl.start(item.seq, name)
                    self._run_stage(name, fn, item)
                    if tl is not None:
                        tl.end(item.seq, name, ok=item.error is None)
                self._put(qout, name, item)
                if tl is not None and next_name is not None \
                        and item.error is None:
                    tl.enqueue(item.seq, next_name)

    def _feed(self, items: Iterable) -> None:
        from ..observability import device as devtel
        intake = self._queues[0]
        first_stage = self.stages[0][0] if self.stages else ''
        tl = self.timeline
        try:
            for seq, value in enumerate(items):
                waited = 0.0
                while not self._slots.acquire(timeout=0.05):
                    waited += 0.05
                    if self._stop.is_set():
                        return
                if waited:
                    devtel.add_backpressure('intake', waited)
                    if tl is not None:
                        tl.record('intake', seq,
                                  time.monotonic() - waited, kind='block')
                if self._stop.is_set():
                    self._slots.release()
                    return
                self._track(1)
                if tl is not None:
                    tl.enqueue(seq, first_stage)
                self._put(intake, 'intake', _Item(value, seq))
        finally:
            intake.put(_SENTINEL)

    # -- driver -------------------------------------------------------------

    def run(self, items: Iterable):
        """Yield the fully-processed items in order."""
        threads = [threading.Thread(target=self._worker, args=(i,),
                                    name=f'ktpu-pipe-{name}', daemon=True)
                   for i, (name, _fn) in enumerate(self.stages)]
        feeder = threading.Thread(target=self._feed, args=(items,),
                                  name='ktpu-pipe-intake', daemon=True)
        for t in threads:
            t.start()
        feeder.start()
        try:
            while True:
                item = self._out.get()
                if item is _SENTINEL:
                    return
                self._slots.release()
                self._track(-1)
                if item.error is not None:
                    raise item.error
                yield item.value
        finally:
            self._stop.set()
            feeder.join(timeout=5)
            for t in threads:
                t.join(timeout=5)
            # drain: chunks still parked in the stage queues when the
            # stream ended (consumer raised / generator closed / stage
            # crash) never reach an owner — reclaim their buffers here
            # so an aborted scan leaks nothing
            for q in list(self._queues) + [self._out]:
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    if item is _SENTINEL or not isinstance(item, _Item):
                        continue
                    if item.error is None:
                        self._cleanup(item.value)
                        item.value = None
            from ..observability import device as devtel
            with self._inflight_lock:
                self._inflight = 0
            devtel.set_pipeline_inflight(0)
            if self.timeline is not None:
                # workers are joined: close exec intervals a stage had
                # open when the stream was torn down, so the timeline
                # never leaks orphan intervals on early generator close
                self.timeline.close_open()
