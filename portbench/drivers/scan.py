"""The background-scan driver: one ``BatchScanner.scan_report_results``
pass over the cluster's Pods, the way the reports controller scans.

Set-up builds the scanner (policy compile, K1v lowering), forks its
encode workers, builds or loads the kernel library, and takes the pass
through its first ``warm_chunks`` whole chunks.  The window opens when
the next chunk's first report flush comes out, and continues the same
pass; a pass that ends starts again over the same Pods.  Rows come out
in report flushes (``KTPU_REPORT_FLUSH_ROWS``), two to a chunk: the
first waits for the chunk, the second only for its own assembly.

The window counts steady chunk intervals only (``arith.steady_window``):
from one chunk-opening flush to the next of the same pass, from the
pass's chunk ``warm_chunks`` on.  The interval across a pass's end
(its last chunk and the next pass's cold start) and the next pass's
warm chunks are dropped, rows and time: a reports controller rescans
once an interval, never back to back, and a pass's cold start is
``setup_s``'s.  The window closes when the counted seconds reach
``--seconds`` (``arith.close_at``).  ``scan_pods_per_s`` is the counted
rows over the counted seconds.

Every Pod yielded from the window's opening to its close, counted or
not, is recorded (``reference.Yielded``) and, once the window has
closed, judged against the plain reference.

Traffic parameters: ``pods`` (the cluster's Pods), ``warm_chunks``
(whole chunks in set-up, and dropped at each later pass's start),
``lane_sample`` (Pods encoded once to count K1v's bytes in a traced
run).
"""

from __future__ import annotations

import time

from portbench import gen, reference

#: the report clock every row carries (one scan, one timestamp)
REPORT_TS = 1_700_000_000


def _lane_bytes(scanner, pods) -> float:
    """Bytes per row of the encoded lanes of ``pods`` under the
    scanner's compiled set."""
    from kyverno_tpu_torch.compiler.encode import encode_batch
    tensors = encode_batch([dict(p) for p in pods], scanner.cps).tensors()
    return sum(a.nbytes for a in tensors.values()) / len(pods)


def run(h) -> dict:
    import torch
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    from kyverno_tpu_torch.observability import device as devtel
    from portbench.arith import close_at, counts, steady_window
    from portbench.devtime import (GcWatch, HostWatch, Trace, calibrate,
                                   stored_programs)

    cfg, traffic = h.config, h.traffic
    cuda = h.device.type == 'cuda'
    policies = h.policies(cfg['scan_action'])
    n = traffic['pods']
    chunk = BatchScanner.CHUNK
    warm = traffic['warm_chunks']
    if not counts(warm * chunk, chunk, warm, n):
        raise SystemExit(f'portbench: a pass of {n} Pods in chunks of '
                         f'{chunk} has no chunk after its {warm} warm ones')
    pods = gen.scan_pods(cfg['pod_generator'], n, h.seed)
    scanner = BatchScanner(policies, device=h.device)
    # the encode workers fork before the first CUDA call
    scanner.start_encoder_pool()
    if cuda:
        from kyverno_tpu_torch.ops import _build
        _build.build_all()
        torch.cuda.reset_peak_memory_stats()
    rules = len(scanner.device_programs)
    lane_bytes = _lane_bytes(scanner, pods[:traffic['lane_sample']]) \
        if h.trace else None

    capture = devtel.ScanCapture() if h.trace else None
    scope = devtel.install_capture(capture)
    scope.__enter__()
    trace = Trace(h.device) if h.trace else None
    yielded = reference.Yielded()
    flushes = []         # (time, row in the pass, pass) of each chunk opening
    stages = []          # the capture's stage seconds at each
    short_passes = []
    passes = 0

    def opened(now, row):
        flushes.append((now, row, passes))
        stages.append(dict(capture.stages) if capture is not None else None)
        return close_at(flushes, chunk, warm, n, h.seconds)

    try:
        it = scanner.scan_report_results(pods, now=REPORT_TS)
        # set-up takes the pass through its first ``warm_chunks``
        # chunks: the encode workers, the staging buffers and the
        # report assembly are in their steady state by then
        i = warm * chunk
        for _ in range(i):
            next(it)
        if trace is not None:
            trace.start()
        stored0 = stored_programs()
        gcw, host = GcWatch(), HostWatch()
        # the window opens with the next chunk's first flush
        item = next(it)
        t0 = time.perf_counter()
        gcw.start()
        host.start()
        setup_s = t0 - h.t_process
        deadline = opened(t0, i)
        yielded.add(i, item[0], item[1])
        i += 1
        done = False
        while not done:
            for item in it:
                now = time.perf_counter()
                if now >= deadline:
                    done = True
                    break
                if i % chunk == 0:
                    deadline = opened(now, i)
                yielded.add(i, item[0], item[1])
                i += 1
            else:
                if i != n:
                    short_passes.append(i)
                passes += 1
                it = scanner.scan_report_results(pods, now=REPORT_TS)
                i = 0
        t_close = now
        gc_note = gcw.stop()
        host_note = host.stop()
        it.close()
        if trace is not None:
            trace.stop()
        stored = stored_programs() - stored0
    finally:
        scope.__exit__(None, None, None)
        scanner._encoder_pool.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del scanner, it, item
    host_note['calib_ms'] = calibrate()
    intervals, rate = steady_window(flushes, chunk, warm, n)
    counted_s = sum(iv.end - iv.start for iv in intervals)

    # the comparison: every Pod yielded in the window
    t_ref = time.perf_counter()
    wrong = reference.rows_wrong(h.reference_rules(), pods, yielded,
                                 REPORT_TS)
    ref_s = time.perf_counter() - t_ref
    attempted = len(yielded)
    counted = {iv.first for iv in intervals}
    dropped = []         # seconds of each stretch of uncounted intervals
    for k, (a, b) in enumerate(zip(flushes, flushes[1:])):
        if k in counted:
            continue
        if k - 1 in counted or not dropped:
            dropped.append(0.0)
        dropped[-1] += b[0] - a[0]
    obs = {
        'correct': wrong == 0 and not short_passes and rate is not None,
        'attempted': attempted, 'failed': wrong,
        'end_to_end': {'scan_pods_per_s': rate, 'setup_s': setup_s},
        'memory_peak_bytes': peak,
        'checks': {'rows_wrong': {'value': wrong, 'limit': 0},
                   'short_passes': {'value': len(short_passes), 'limit': 0},
                   'flushes_short': {'value': max(0, 1 - len(intervals)),
                                     'limit': 0}},
        'notes': {'pods_compared': attempted, 'reference_s': ref_s,
                  'flushes': len(flushes), 'passes_ended': passes,
                  'counted_s': round(counted_s, 4),
                  'wall_s': round(t_close - t0, 4),
                  'dropped_s': [round(d, 4) for d in dropped],
                  'programs_lowered_in_window': stored,
                  'gc_in_window': gc_note, 'host_in_window': host_note,
                  'flush_gaps_s': [round(iv.end - iv.start, 3)
                                   for iv in intervals],
                  # (seconds from the opening, row in the pass, pass)
                  'flush_events': [[round(t - t0, 4), row, p]
                                   for t, row, p in flushes]},
        'flushes': flushes, 'stages': stages, 'intervals': intervals,
        'chunk': chunk,
    }
    if trace is not None:
        from portbench.arith import k1v_least_s
        obs['device'] = trace.device(intervals) if cuda else None
        obs['notes']['k1v_lag_ms'] = trace.launch_lag_ms(
            'k1_vm', 'k1_vm_kernel') if cuda else None
        # (rows, event ms, least ms) of each K1v launch in the window's
        # counted intervals
        obs['k1v'] = [(rows, ms, 1e3 * k1v_least_s(rows, lane_bytes, rules))
                      for rows, ms in trace.kernel_ms('k1_vm', intervals)] \
            if cuda else []
    return obs
