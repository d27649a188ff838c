"""The background-scan driver: one ``BatchScanner.scan_report_results``
pass over the cluster's Pods, the way the reports controller scans.

Set-up builds the scanner (policy compile, K1v lowering), forks its
encode workers, builds or loads the kernel library, and takes the pass
through its first ``warm_chunks`` whole chunks.  The window opens when
the next chunk's first report flush comes out, and continues the same
pass; a pass that ends starts again over the same Pods.  Rows come out
in report flushes (``KTPU_REPORT_FLUSH_ROWS``), two to a chunk: the
first waits for the chunk, the second only for its own assembly.
``scan_pods_per_s`` counts whole chunks: the rows of every chunk from
the window's opening up to the last chunk-opening flush in it, over
the time between the two.

Every Pod yielded in the window is recorded (``reference.Yielded``) and,
once the window has closed, judged against the plain reference.

Traffic parameters: ``pods`` (the cluster's Pods), ``warm_chunks``
(whole chunks in set-up), ``lane_sample`` (Pods encoded once to count
K1v's bytes in a traced run).
"""

from __future__ import annotations

import time

from portbench import gen, reference

#: the report clock every row carries (one scan, one timestamp)
REPORT_TS = 1_700_000_000


def _flush_windows(n: int, chunk: int, flush: int):
    """``{first row index: rows}`` of each report flush of a pass."""
    out = {}
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        for w0 in range(0, m, flush):
            out[start + w0] = min(flush, m - w0)
    return out


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
    from portbench.devtime import (GcWatch, HostWatch, Trace, calibrate,
                                   stored_programs)

    cfg, traffic = h.config, h.traffic
    cuda = h.device.type == 'cuda'
    policies = h.policies(cfg['scan_action'])
    n = traffic['pods']
    pods = gen.scan_pods(cfg['pod_generator'], n, h.seed)
    scanner = BatchScanner(policies, device=h.device)
    # the encode workers fork before the first CUDA call
    scanner.start_encoder_pool()
    if cuda:
        from kyverno_tpu_torch.ops import _build
        _build.build_all()
        torch.cuda.reset_peak_memory_stats()
    chunk = scanner.CHUNK
    windows = _flush_windows(n, chunk, scanner.REPORT_FLUSH_ROWS)
    rules = len(scanner.device_programs)
    lane_bytes = _lane_bytes(scanner, pods[:traffic['lane_sample']]) \
        if h.trace else None

    capture = devtel.ScanCapture() if h.trace else None
    scope = devtel.install_capture(capture)
    scope.__enter__()
    trace = Trace(h.device) if h.trace else None
    yielded = reference.Yielded()
    flushes = []         # (time, rows since the last, stage seconds)
    short_passes = []
    passes = 0
    try:
        it = scanner.scan_report_results(pods, now=REPORT_TS)
        # set-up takes the pass through its first ``warm_chunks``
        # chunks: the encode workers, the staging buffers and the
        # report assembly are in their steady state by then
        i = traffic['warm_chunks'] * chunk
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
        deadline = t0 + h.seconds
        flushes.append((t0, 0, dict(capture.stages)
                        if capture is not None else None))
        rows_since = windows[i]
        yielded.add(i, item[0], item[1])
        i += 1
        done = False
        while not done:
            for item in it:
                now = time.perf_counter()
                if now >= deadline:
                    done = True
                    break
                rows = windows.get(i)
                if rows is not None and i % chunk == 0:
                    flushes.append((now, rows_since, dict(capture.stages)
                                    if capture is not None else None))
                    rows_since = 0
                if rows is not None:
                    rows_since += rows
                yielded.add(i, item[0], item[1])
                i += 1
            else:
                if i != n:
                    short_passes.append(i)
                passes += 1
                it = scanner.scan_report_results(pods, now=REPORT_TS)
                i = 0
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

    rate = None
    if len(flushes) >= 2:
        from portbench.arith import flush_rate
        rate = flush_rate([(t, r) for t, r, _ in flushes])

    # the comparison: every Pod yielded in the window
    t_ref = time.perf_counter()
    wrong = reference.rows_wrong(h.reference_rules(), pods, yielded,
                                 REPORT_TS)
    ref_s = time.perf_counter() - t_ref
    attempted = len(yielded)
    obs = {
        'correct': wrong == 0 and not short_passes and rate is not None,
        'attempted': attempted, 'failed': wrong,
        'end_to_end': {'scan_pods_per_s': rate, 'setup_s': setup_s},
        'memory_peak_bytes': peak,
        'checks': {'rows_wrong': {'value': wrong, 'limit': 0},
                   'short_passes': {'value': len(short_passes), 'limit': 0},
                   'flushes_short': {'value': max(0, 2 - len(flushes)),
                                     'limit': 0}},
        'notes': {'pods_compared': attempted, 'reference_s': ref_s,
                  'flushes': len(flushes), 'passes_ended': passes,
                  'programs_lowered_in_window': stored,
                  'gc_in_window': gc_note, 'host_in_window': host_note,
                  'flush_gaps_s': [round(b[0] - a[0], 3) for a, b in
                                   zip(flushes, flushes[1:])]},
        'flushes': flushes, 'chunk': chunk,
    }
    if trace is not None:
        from portbench.arith import k1v_least_s
        obs['device'] = trace.device() if cuda else None
        # (rows, event ms, least ms) of each K1v launch in the window
        obs['k1v'] = [(rows, ms, 1e3 * k1v_least_s(rows, lane_bytes, rules))
                      for rows, ms in trace.kernel_ms('k1_vm')] \
            if cuda else []
    return obs
