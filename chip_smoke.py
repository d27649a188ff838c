#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kyverno_tpu_torch``) on one card.

Drives the port's main path — the validate background scan that the
reports controller serves, ``BatchScanner.scan_report_results`` — on the
CUDA card and checks it, in phases that each print one line:

1. ``card``: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the time to build the hand-written kernels from
   ``kyverno_tpu_torch/csrc`` (one nvcc per source, all at once).
2. ``kernels``: each kernel (K1h fail-detail select, K1c wildcard DP)
   against its plain torch version on the card, at the main path's
   shapes — the first chunk's real tensors plus seeded random ones.
   Outputs must be exactly equal.  Times come from CUDA events.
3. ``slice``: ``scan_report_results`` over ``--pods`` Pods (default
   100,000, a large production cluster) with the smoke pack's 12
   policies: Pods/s, decisions/s, the stage breakdown, the
   device-decided fraction, each kernel's launches during the scan
   (each must be > 0) and the encoder pool's state.  The first 2,000
   rows and every row of the last chunk are held against the port's
   host ``Engine``; any mismatch fails the run.

Then one JSON line of per-kernel numbers, the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  A full report goes to
``chiprun_out/chip_smoke.json``.

Run from the repository root:

    python3 chip_smoke.py [--pods N] [--seed S]

Without a CUDA card, or outside the repository, it exits non-zero and
prints no result.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NOW = 1_700_000_000            # report timestamp (seconds) for the scan
CHECK_HEAD = 2000              # rows held against the host engine, plus
                               # every row of the last chunk
MIN_PODS = 3 * 16384 + 1       # never cut below three full chunks
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM non-tensor rate (data sheet)


def _die(msg: str) -> None:
    print(f'chip_smoke: {msg}', file=sys.stderr)
    sys.exit(1)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _ms(fn, device, reps: int = 20) -> float:
    """Mean milliseconds per call over ``reps`` warm calls (CUDA events
    on the card; the host clock otherwise, for rehearsals)."""
    import torch
    fn()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(got, want) -> int:
    import torch
    if isinstance(got, tuple):
        return max(_max_abs_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        raise AssertionError(f'shape {tuple(got.shape)} != '
                             f'{tuple(want.shape)}')
    if got.numel() == 0:
        return 0
    return int((got.cpu().to(torch.int64) -
                want.cpu().to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# phase 2: the kernels against their plain versions

def first_chunk_inputs(scanner, pods, device):
    """Run the evaluator once over the scan's first chunk and keep the
    tensors each kernel wrapper was given, plus the chunk's device and
    host times."""
    import numpy as np
    import torch
    from kyverno_tpu_torch.api.unstructured import Resource
    from kyverno_tpu_torch.compiler import admission as admission_lanes
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.ops.eval import fold_match_unique, shard_batch
    chunk = scanner.CHUNK
    part = pods[:chunk]
    ev = scanner._evaluator
    tensors = dict(encode_batch(part, scanner.cps, padded_n=chunk).tensors())
    cm = scanner.match_matrix(part, [Resource(r) for r in part])
    mm_u = fold_match_unique((cm & scanner._dev_mask).astype(np.uint8), ev)
    mm = np.zeros((chunk, mm_u.shape[1]), np.uint8)
    mm[:len(part)] = mm_u
    tensors['__match__'] = mm
    if scanner._adm is not None:
        tensors.update(admission_lanes.zero_lanes(scanner._adm, chunk))
    packed, layout = shard_batch(tensors, device)

    seen = {'fdet_select': [], 'wildcard_match': []}
    real_fs, real_wm = kernels.fdet_select, kernels.wildcard_match

    def spy_fs(rel, fdet_u, k):
        seen['fdet_select'].append((rel.clone(), fdet_u.clone(), k))
        return real_fs(rel, fdet_u, k)

    def spy_wm(head, str_len, tag, pattern):
        seen['wildcard_match'].append(
            (head.clone(), str_len.clone(), tag.clone(), pattern))
        return real_wm(head, str_len, tag, pattern)

    kernels.fdet_select, kernels.wildcard_match = spy_fs, spy_wm
    try:
        ev(packed, layout)
    finally:
        kernels.fdet_select, kernels.wildcard_match = real_fs, real_wm
    # one more call, timed: the host clock covers the Python dispatch of
    # the whole op chain, the CUDA events the device span it enqueued
    if device.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if device.type == 'cuda':
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    out = ev(packed, layout)
    host_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = None
    if device.type == 'cuda':
        e1.record()
        torch.cuda.synchronize()
        dev_ms = e0.elapsed_time(e1)
    busy_ms = _device_busy_ms(lambda: ev(packed, layout), device)
    chunk_stats = {'rows': chunk, 'host_dispatch_ms': host_ms,
                   'device_span_ms': dev_ms, 'device_busy_ms': busy_ms,
                   'packed_bytes': int(sum(v.numel() * v.element_size()
                                           for v in packed.values())),
                   'out8_shape': list(out[0].shape),
                   'out32_shape': list(out[1].shape)}
    return seen, chunk_stats


def _device_busy_ms(fn, device, kernel: str = ''):
    """Device time of one call from torch.profiler: the sum of every
    device kernel's own time, or of those whose name holds ``kernel``
    (None off the card or when the profiler sees no device activity)."""
    if device.type != 'cuda':
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - an extra reading, not a check
        print(f'chip_smoke: profiler unavailable: {e}', file=sys.stderr)
        return None
    total_us = 0.0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += getattr(evt, 'self_device_time_total', 0.0) or 0.0
    return total_us / 1e3 if total_us > 0 else None


def _random_k1h(rel, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    r, c = rel.shape
    out = []
    for density in (0.3, 0.9):
        rr = torch.rand(r, c, generator=g) < density
        fd = torch.randint(-3, 1 << 24, (r, c), generator=g,
                           dtype=torch.int32)
        out.append((rr, fd))
    return out


def _random_k1c(shape, w, seed):
    """Seeded windows with '?', '*', non-ASCII bytes, values past the
    window and every tag, at the real call's shape."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    alphabet = np.frombuffer(b'ab:-*?x.\xc3\xa9latest/0123456789', np.uint8)
    lens = rng.choice(np.array([0, 1, 3, max(w - 1, 0), w, w + 7]), n)
    lens = np.where(rng.random(n) < 0.5, rng.integers(0, w + 1, n), lens)
    head = rng.choice(alphabet, (n, w)).astype(np.uint8)
    head[np.arange(w)[None, :] >= np.minimum(lens, w)[:, None]] = 0
    tag = rng.choice(np.array([0, 1, 2, 3, 4, 5, 5, 5, 5, 6, 7], np.int8), n)
    return (torch.from_numpy(head.reshape(tuple(shape) + (w,))),
            torch.from_numpy(lens.astype(np.int32).reshape(shape)),
            torch.from_numpy(tag.reshape(shape)))


def kernel_phase(seen, device, seed):
    """Hold each kernel against its plain version on the card; returns
    the per-kernel records (launch counts are filled in later)."""
    import torch
    from kyverno_tpu_torch.ops import kernels
    if not seen['fdet_select'] or not seen['wildcard_match']:
        raise AssertionError('the first chunk reached '
                             f'{[k for k, v in seen.items() if v]} only')
    records = []

    # K1h ------------------------------------------------------------
    rel, fdet_u, k = seen['fdet_select'][0]
    cases = [(rel, fdet_u)] + [
        (r.to(device), f.to(device)) for r, f in _random_k1h(rel, seed)]
    err = 0
    for r_, f_ in cases:
        got = kernels.fdet_select(r_, f_, k)
        want = kernels.fdet_select_plain(r_, f_, k)
        err = max(err, _max_abs_err(got, want))
    if err:
        raise AssertionError(f'K1h differs from its plain version: {err}')
    r_n, c_n = rel.shape
    counts = rel.sum(dim=1)
    taken = torch.clamp(counts, max=k)
    fill = (counts < k).to(torch.int64)
    k1h_bytes = r_n * c_n + int((taken + fill).sum()) * 4 + r_n * 2 * k * 4
    records.append({
        'name': 'k1h_fdet_select', 'route': 'cuda',
        'source': 'kyverno_tpu_torch/csrc/k1h_fdet_select.cu',
        'replaces': 'kyverno_tpu/ops/eval.py:1797',
        'launches': 0, 'max_abs_err': err,
        'ms': _ms(lambda: kernels.fdet_select(rel, fdet_u, k), device),
        'plain_ms': _ms(lambda: kernels.fdet_select_plain(rel, fdet_u, k),
                        device),
        'bound_ms': k1h_bytes / HBM_BYTES_PER_S * 1e3,
        'bound_by': 'bytes',
        'library_ms': _ms(lambda: kernels.fdet_select_library(
            rel, fdet_u, k), device),
        'kernel_device_ms': _device_busy_ms(
            lambda: kernels.fdet_select(rel, fdet_u, k), device,
            'fdet_select_kernel'),
        'shape': {'rows': r_n, 'cols': c_n, 'k': k,
                  'relevant_cells': int(counts.sum())},
        'cases': len(cases)})

    # K1c ------------------------------------------------------------
    head, str_len, tag, pattern = seen['wildcard_match'][0]
    w = head.shape[-1]
    lead = tuple(str_len.shape)
    rnd = [tuple(a.to(device) for a in _random_k1c(lead, w, seed + i))
           for i in range(2)]
    patterns = [pattern, b'*', b'?*', b'a?b*', b'*latest', b'?\xc3*',
                b'*:*:*', b'']
    err = 0
    n_cases = 0
    for args in [(head, str_len, tag)] + rnd:
        for pat in patterns:
            got = kernels.wildcard_match(*args, pat)
            want = kernels.wildcard_plain(*args, pat)
            err = max(err, _max_abs_err(got, want))
            n_cases += 1
    if err:
        raise AssertionError(f'K1c differs from its plain version: {err}')
    n = str_len.numel()
    literal = sum(1 for b in pattern if b not in b'*?')
    k1c_bytes = n * w + n * 4 + n + 2 * n
    k1c_ops = n * (literal * w + len(pattern))
    bound_s = max(k1c_bytes / HBM_BYTES_PER_S,
                  k1c_ops / CUDA_CORE_OPS_PER_S)
    records.append({
        'name': 'k1c_wildcard', 'route': 'cuda',
        'source': 'kyverno_tpu_torch/csrc/k1c_wildcard.cu',
        'replaces': 'kyverno_tpu/ops/eval.py:275',
        'launches': 0, 'max_abs_err': err,
        'ms': _ms(lambda: kernels.wildcard_match(head, str_len, tag,
                                                 pattern), device),
        'plain_ms': _ms(lambda: kernels.wildcard_plain(head, str_len, tag,
                                                       pattern), device),
        'bound_ms': bound_s * 1e3,
        'bound_by': ('bytes' if k1c_bytes / HBM_BYTES_PER_S >=
                     k1c_ops / CUDA_CORE_OPS_PER_S else 'operations'),
        'library_ms': None,
        'kernel_device_ms': _device_busy_ms(
            lambda: kernels.wildcard_match(head, str_len, tag, pattern),
            device, 'wildcard_kernel'),
        'shape': {'values': n, 'lead': list(lead), 'window': w,
                  'pattern': pattern.decode('utf-8', 'replace')},
        'cases': n_cases})
    return records


# ---------------------------------------------------------------------------
# phase 3: the slice

def slice_phase(scanner, policies, pods):
    """The main path over every Pod, then the host-engine check."""
    from kyverno_tpu_torch.engine.engine import Engine
    from kyverno_tpu_torch.observability import coverage
    from kyverno_tpu_torch.observability import device as devtel
    from kyverno_tpu_torch.observability.metrics import MetricsRegistry
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.smokepack import host_report_results
    n = len(pods)
    chunk = scanner.CHUNK
    last_start = ((n - 1) // chunk) * chunk
    keep = {}
    decisions = 0
    coverage.configure(MetricsRegistry())
    cap = devtel.ScanCapture()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with devtel.install_capture(cap):
        for i, (results, summary, _pols) in enumerate(
                scanner.scan_report_results(pods, now=NOW)):
            decisions += len(results)
            if i < CHECK_HEAD or i >= last_start:
                keep[i] = (results, summary)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want_rows = set(range(min(n, CHECK_HEAD))) | set(range(last_start, n))
    if set(keep) != want_rows:
        raise AssertionError(f'scan yielded {len(keep)} of the '
                             f'{len(want_rows)} rows to check')
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f'kernels never launched on the main path: '
                             f'{missing}')
    engine = Engine()
    t1 = time.perf_counter()
    mismatches = [i for i, got in sorted(keep.items())
                  if got != host_report_results(policies, pods[i], NOW,
                                                engine)]
    check_s = time.perf_counter() - t1
    pool = scanner._encoder_pool
    return {
        'pods': n, 'chunk': chunk, 'policies': len(policies),
        'programs': len(scanner.cps.programs),
        'host_rules': len(scanner.cps.host_rules),
        'wall_s': wall, 'pods_per_s': n / wall,
        'decisions': decisions, 'decisions_per_s': decisions / wall,
        'stage_s': dict(sorted(cap.stages.items())),
        'device_decided_frac': cap.coverage_ratio,
        'launches': launches,
        'encoder_pool': {'procs': pool.procs,
                         'up': pool._pool is not None,
                         'broken': pool._broken},
        'checked_rows': len(keep), 'mismatches': len(mismatches),
        'first_mismatches': mismatches[:10], 'check_s': check_s,
    }


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--pods', type=int, default=100_000)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, 'kyverno_tpu_torch')):
        _die('kyverno_tpu_torch/ is not beside this script; run it from a '
             'checkout of the repository')
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        _die('torch.cuda.is_available() is False: this script measures '
             'the CUDA card and has no CPU mode')
    # forked encode workers use as many cores as the card's host spares
    os.environ.setdefault('KTPU_ENCODE_PROCS', '4')
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    from kyverno_tpu_torch.ops import _build
    report = {'argv': sys.argv[1:], 'seed': args.seed}

    # 1. card -------------------------------------------------------------
    smi = _nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    card = {'nvidia_smi': smi, 'torch': torch.__version__,
            'cuda': torch.version.cuda, 'kernel_build_s': build_s,
            'per_kernel_build_s': built}
    print('card ' + json.dumps(card), flush=True)
    report['card'] = card
    report['ptxas'] = {n: _build.build_log(n) for n in _build.KERNELS}

    policies = smokepack.load_smoke_pack()
    n = max(args.pods, 1)
    if n < MIN_PODS:
        print(f'cut: {n} Pods requested, below three full chunks; '
              f'scanning {MIN_PODS}', flush=True)
        n = MIN_PODS
    elif n < 100_000:
        print(f'cut: scanning {n} Pods instead of 100000', flush=True)
    rng = random.Random(args.seed)
    pods = [smokepack.make_config4_pod(rng, i) for i in range(n)]
    scanner = BatchScanner(policies)       # on the card by default
    # fork the encode workers before this process creates a CUDA
    # context, so no child ever inherits one
    scanner._encoder_pool.start()
    device = scanner.device
    try:
        # 2. kernels ------------------------------------------------------
        seen, chunk_stats = first_chunk_inputs(scanner, pods, device)
        records = kernel_phase(seen, device, args.seed)
        print('kernels ' + json.dumps(
            {r['name']: dict({k: r[k] for k in (
                'max_abs_err', 'ms', 'kernel_device_ms', 'plain_ms',
                'library_ms', 'cases')},
                bound_us=r['bound_ms'] * 1e3) for r in records}),
              flush=True)
        report['first_chunk'] = chunk_stats

        # 3. slice --------------------------------------------------------
        sl = slice_phase(scanner, policies, pods)
        for r in records:
            r['launches'] = sl['launches'][r['name']]
        print('slice ' + json.dumps(sl), flush=True)
        report['slice'] = sl
        report['kernels'] = records
        if sl['mismatches']:
            raise AssertionError(f'{sl["mismatches"]} rows differ from the '
                                 f'host engine: {sl["first_mismatches"]}')
    finally:
        scanner._encoder_pool.close()

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    report['device'] = {'kind': kind, 'count': count}
    out_dir = os.path.join(HERE, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as f:
        json.dump(report, f, indent=1)
    print(json.dumps({'kernels': [{k: r[k] for k in (
        'name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
        'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')}
        for r in records]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
