"""What a traced run (``--trace 1``) reads of the device and the host,
from the benchmark's side of the program's seams:

* CUDA events around each call of the kernel wrapper ``status_vm`` (K1v)
  of ``ops/kernels.py``: each launch's device time and rows, and the
  host time at which it was called;
* ``torch.profiler`` over the whole window, device activity only: the
  device's busy seconds (the union of its kernels and copies) and the
  operations that took most time;
* the program's pipeline stages (``observability/device.py stage``),
  as host spans, to name what the host was doing in each idle gap.

Each reading keeps to the window's counted intervals
(``arith.steady_window``): launches called inside them, and device
activity and idle gaps clipped to them.  Nothing here runs in an
untraced run.  Off the card it records spans only."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple


class Trace:
    def __init__(self, device):
        self.cuda = device.type == 'cuda'
        self.launches: Dict[str, List[Tuple[int, object, object, float]]] = \
            {'k1_vm': []}
        self.spans: List[Tuple[str, float, float]] = []
        self._undo = []
        self._prof = None
        self.t0 = 0.0

    # -- seams ---------------------------------------------------------

    def _wrap_kernel(self, kernels, attr: str, key: str) -> None:
        import torch
        real = getattr(kernels, attr)
        store = self.launches[key]

        def timed(*args, **kwargs):
            if not self.cuda:
                return real(*args, **kwargs)
            called = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kwargs)
            end.record()
            rows = int(next(iter(args[0].values())).shape[0])
            store.append((rows, start, end, called))
            return out
        setattr(kernels, attr, timed)
        self._undo.append(lambda: setattr(kernels, attr, real))

    def _wrap_stages(self) -> None:
        from kyverno_tpu_torch.observability import device as devtel
        real = devtel.stage
        spans = self.spans

        class Span:
            def __init__(self, name, inner):
                self.name, self.inner = name, inner

            def __enter__(self):
                self.t = time.perf_counter()
                return self.inner.__enter__()

            def __exit__(self, *exc):
                spans.append((self.name, self.t, time.perf_counter()))
                return self.inner.__exit__(*exc)

            def __getattr__(self, item):
                return getattr(self.inner, item)

        def stage(name, attributes=None, parent=None):
            return Span(name, real(name, attributes, parent))
        devtel.stage = stage
        self._undo.append(lambda: setattr(devtel, 'stage', real))

    def start(self) -> None:
        from kyverno_tpu_torch.ops import kernels
        self._wrap_kernel(kernels, 'status_vm', 'k1_vm')
        self._wrap_stages()
        if self.cuda:
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    # -- readings ------------------------------------------------------

    def kernel_ms(self, key: str, intervals: Sequence
                  ) -> List[Tuple[int, float]]:
        """``[(rows, device ms)]`` of each launch called inside one of
        the counted ``intervals`` (``arith.Interval``, on the host
        clock)."""
        return [(rows, start.elapsed_time(end))
                for rows, start, end, called in self.launches[key]
                if any(iv.start <= called < iv.end for iv in intervals)]

    def _device_intervals(self) -> List[Tuple[float, float, str]]:
        """``[(start s, end s, name)]`` of the profiler's device
        activity, on the host clock of ``t0``."""
        if self._prof is None:
            return []
        from torch.autograd import DeviceType
        out = []
        for evt in self._prof.events():
            if evt.device_type != DeviceType.CUDA:
                continue
            tr = evt.time_range
            out.append((tr.start / 1e6, tr.end / 1e6, evt.name))
        if not out:
            return []
        # times count from the profiler's start, which is the window's;
        # a build that gives them from the epoch is put on that origin
        base = min(s for s, _, _ in out) if min(
            s for s, _, _ in out) > 1e6 else 0.0
        return sorted((s - base, e - base, n) for s, e, n in out)

    def device(self, intervals: Sequence) -> Optional[dict]:
        """``busy_s``, ``window_s`` and the breakdown, over the counted
        ``intervals`` (``arith.Interval``, on the host clock): the
        device operations with most time and the longest idle gaps,
        each named by the host stage active in its middle.  None where
        the profiler saw no device activity in them."""
        spans = [(iv.start - self.t0, iv.end - self.t0) for iv in intervals]
        out = clipped_activity(self._device_intervals(), spans)
        if out is None:
            return None
        out['idle_gaps'] = [[self.host_stage((a + b) / 2), b - a]
                            for a, b in out['idle_gaps']]
        return out

    def launch_lag_ms(self, key: str, kernel: str) -> Optional[list]:
        """``[least, median, most]`` ms from each launch's call on the host
        to the start of the first of the profiler's ``kernel`` that
        starts after it, less 1 s: a check that the profiler's clock and
        the host's agree.  None where the profiler saw no such kernel."""
        import bisect
        starts = sorted(s for s, _, name in self._device_intervals()
                        if kernel in name)
        lag = []
        for *_, called in self.launches[key]:
            at = called - self.t0
            k = bisect.bisect_left(starts, at - 1.0)
            if k < len(starts):
                lag.append(1e3 * (starts[k] - at))
        if not lag:
            return None
        lag.sort()
        return [round(lag[0], 3), round(lag[len(lag) // 2], 3),
                round(lag[-1], 3)]

    def host_stage(self, at: float) -> str:
        """The pipeline stages active ``at`` seconds into the window
        (``idle`` when none)."""
        t = self.t0 + at
        names = sorted({n for n, a, b in self.spans if a <= t <= b})
        return '+'.join(names) or 'idle'


def clipped_activity(activity: Sequence[Tuple[float, float, str]],
                     spans: Sequence[Tuple[float, float]]
                     ) -> Optional[dict]:
    """The device's activity ``[(start, end, name)]`` clipped to
    ``spans`` ``[(start, end)]`` (one clock; spans that touch are one):
    ``busy_s``, the seconds in which some operation ran; ``window_s``,
    the spans' seconds; ``device_ops``, the ten names with most seconds;
    and ``idle_gaps``, the ten longest ``(start, end)`` in which nothing
    ran, cut at the spans' edges.  None where nothing ran in them."""
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    by_name: Dict[str, float] = {}
    busy, gaps = 0.0, []
    for lo, hi in merged:
        end = lo
        for s, e, name in activity:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            by_name[name] = by_name.get(name, 0.0) + (e - s)
            if s > end:
                gaps.append((end, s))
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        if hi > end:
            gaps.append((end, hi))
    if not by_name:
        return None
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {'busy_s': busy, 'window_s': sum(b - a for a, b in merged),
            'device_ops': sorted(by_name.items(), key=lambda kv: -kv[1]
                                 )[:10],
            'idle_gaps': gaps[:10]}


class GcWatch:
    """Seconds the process spent in the garbage collector, by
    generation, between ``start`` and ``stop`` (a note beside the
    metrics: every thread waits while it runs)."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t = 0.0

    def _callback(self, phase, info):
        if phase == 'start':
            self._t = time.perf_counter()
        else:
            gen = info['generation']
            self.seconds[gen] += time.perf_counter() - self._t
            self.count[gen] += 1

    def start(self) -> None:
        import gc
        gc.callbacks.append(self._callback)

    def stop(self) -> dict:
        import gc
        gc.callbacks.remove(self._callback)
        return {'seconds': [round(s, 3) for s in self.seconds],
                'collections': self.count}


class HostWatch:
    """The CPU seconds this process's threads took between ``start`` and
    ``stop`` (``getrusage``), over the wall seconds: a note beside the
    metrics, with ``calibrate``, to tell the host's speed from the
    program's."""

    def __init__(self):
        self._t0 = None

    @staticmethod
    def _now():
        import resource
        r = resource.getrusage(resource.RUSAGE_SELF)
        return time.perf_counter(), r.ru_utime + r.ru_stime

    def start(self) -> None:
        self._t0 = self._now()

    def stop(self) -> dict:
        (w0, c0), (w1, c1) = self._t0, self._now()
        import torch
        return {'cpu_s': round(c1 - c0, 3), 'wall_s': round(w1 - w0, 3),
                'torch_threads': torch.get_num_threads()}


def calibrate() -> float:
    """Milliseconds that a fixed loop of pure Python takes on this host
    now (the best of three)."""
    best = None
    for _ in range(3):
        t = time.perf_counter()
        x = 0
        for k in range(300_000):
            x += k * k
        ms = 1e3 * (time.perf_counter() - t)
        best = ms if best is None else min(best, ms)
    return round(best, 3)


def stored_programs() -> int:
    """Files in the program store (``KTPU_AOT_CACHE_DIR``): a K1v program
    lowered for a pack layout the store did not hold adds one."""
    count = 0
    for _root, _dirs, files in os.walk(os.environ['KTPU_AOT_CACHE_DIR']):
        count += len(files)
    return count
