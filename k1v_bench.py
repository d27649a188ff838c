#!/usr/bin/env python3
"""K1v, K1h and K3 on one card at the main path's shapes, and the sync
admission latency that rests on them: a short A/B harness.

For the smoke pack and the restricted configuration (the smoke pack,
the restricted chart's ``foreach`` capability policies and the
admission-lanes pack, with the admission lanes of ``ADMISSIONS``
users), at 64 rows, the admission capacity, and at a 16,384-row chunk,
the scan's (the restricted chunk holds the three 43-container Pods of
``smokepack.OVERFLOW_PODS``):

* K1v's time per wrapper call (CUDA events, mean of ``--reps`` warm
  calls), held bit-equal to K1v's plain version once;
* one K1 call (the evaluator with its ``__match__`` lane: K1v, then
  K1h), median host milliseconds of the call alone and of the call with
  its readback to the host (the card synchronized before each).

For the mutate pack (``bench.py``'s ``MUTATE_PACK``): one
``MutateKernel`` call (stage, K3, readback) at 64 rows and at a chunk
of seeded Pods, median host milliseconds.  Then ``--reviews`` sync
reviews through ``WebhookServer`` on the card, one client —
``/validate/fail`` for both packs and ``/mutate`` for the mutate pack:
p50 and p99 latency and the card's busy time per request (CUDA events
around each kernel wrapper call, ``chip_smoke.request_kernel_ms``).
K1v (K3 on /mutate) must launch once per review, so a review the host
engine served would fail the run.

Run from the root of a checkout on a machine with a CUDA card:

    python3 k1v_bench.py [--reviews N] [--reps N]

It prints one JSON line.  It imports nothing of JAX or of the JAX
package, and runs in the checkout it sits in, so two checkouts side by
side time two versions of the kernels in one run each, on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHUNK = 16384                  # rows of a scan chunk
ADMISSION_ROWS = 64            # the admission path's row capacity


def k1v_times(policies, make_pod, device, reps: int, adm: bool) -> dict:
    """K1v's milliseconds per call at 64 rows and at a chunk of Pods
    ``make_pod(rng, i)`` (seed 0), with the error against its plain
    version and the program's full-width instructions per row."""
    import chip_smoke
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.compiler import admission
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.ops.eval import build_evaluator, shard_batch
    cps = compile_policies(policies)
    ev = build_evaluator(cps, device)
    rng = random.Random(0)
    pods = [make_pod(rng, i) for i in range(CHUNK)]
    out = {}
    for label, n in (('rows_64', ADMISSION_ROWS), ('chunk', CHUNK)):
        tensors = dict(encode_batch(pods[:n], cps, padded_n=n).tensors())
        if ev.adm_table is not None:
            lanes = admission.zero_lanes(ev.adm_table, n)
            if adm:
                rows = [smokepack.ADMISSIONS[i % len(smokepack.ADMISSIONS)]
                        for i in range(n)]
                for name, lane in admission.encode_rows(
                        ev.adm_table, rows).lanes.items():
                    lanes[name][:] = lane
            tensors.update(lanes)
        packed, layout = shard_batch(tensors, device)
        program = ev.plan_for(layout).program
        err = chip_smoke._max_abs_err(kernels.status_vm(packed, program),
                                      program.plain(packed))
        out[label] = {'rows': n, 'max_abs_err': err,
                      'row_insns': program.row_insns,
                      'ms': chip_smoke._ms(
                          lambda: kernels.status_vm(packed, program),
                          device, reps)}
    return out


def _readback(out):
    # the compact outputs on the host: one copy of K1h's allocation
    # where the evaluator offers it, else one per output
    if hasattr(out, 'host'):
        return out.host()
    return tuple(o.cpu() for o in out)


def k1_calls(policies, make_pod, device, reps: int) -> dict:
    """One K1 call, the evaluator over a batch with its ``__match__``
    lane (every program matched), at 64 rows and at a chunk of Pods
    ``make_pod(rng, i)`` (seed 0): median host milliseconds of the call
    and of the call with its readback."""
    import numpy as np
    import chip_smoke
    from kyverno_tpu_torch.compiler import admission
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import build_evaluator, shard_batch
    cps = compile_policies(policies)
    ev = build_evaluator(cps, device)
    rng = random.Random(0)
    pods = [make_pod(rng, i) for i in range(CHUNK)]
    out = {}
    for label, n in (('rows_64', ADMISSION_ROWS), ('chunk', CHUNK)):
        tensors = dict(encode_batch(pods[:n], cps, padded_n=n).tensors())
        tensors['__match__'] = np.ones((n, ev.n_uniq), np.uint8)
        if ev.adm_table is not None:
            tensors.update(admission.zero_lanes(ev.adm_table, n))
        packed, layout = shard_batch(tensors, device)
        _readback(ev(packed, layout))
        out[label] = {
            'rows': n,
            'call_ms': chip_smoke._host_ms(lambda: ev(packed, layout),
                                           device, reps),
            'call_and_readback_ms': chip_smoke._host_ms(
                lambda: _readback(ev(packed, layout)), device, reps)}
    return out


def mutate_calls(device, reps: int) -> dict:
    """One ``MutateKernel`` call (stage the lanes, K3, read back) on the
    mutate pack at 64 rows and at a chunk of seeded Pods: median host
    milliseconds."""
    import chip_smoke
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.mutate import MutateScanner
    from kyverno_tpu_torch.mutate.encode import encode_mutate_batch
    scanner = MutateScanner(smokepack.load_mutate_pack())
    kern = scanner._kernel
    rng = random.Random(7)
    pods = [smokepack.make_mutate_pod(rng, i) for i in range(CHUNK)]
    out = {}
    for label, n in (('rows_64', ADMISSION_ROWS), ('chunk', CHUNK)):
        lanes = encode_mutate_batch(pods[:n], scanner.program, padded_n=n,
                                    width=scanner._width)
        kern(lanes)
        out[label] = {'rows': n, 'sites': kern.n_sites,
                      'ms': chip_smoke._host_ms(lambda: kern(lanes), device,
                                                reps)}
    return out


def sync_mutate_latency(n: int) -> dict:
    """``n`` sync /mutate reviews through the webhook on the card after
    20 warm ones (the smoke pack in Enforce and the mutate pack): p50
    and p99 latency (ms), the card's busy ms per request and K3's
    launches per review."""
    import chip_smoke
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.policycache import cache as pcache
    from kyverno_tpu_torch.policycache.cache import Cache
    from kyverno_tpu_torch.webhooks.handlers import ResourceHandlers
    from kyverno_tpu_torch.webhooks.server import WebhookServer
    cache = Cache()
    cache.warm_up(smokepack.load_smoke_pack('Enforce') +
                  smokepack.load_mutate_pack())
    handlers = ResourceHandlers(cache, serving_mode='sync')
    server = WebhookServer(handlers)
    mutate = cache.get_policies(pcache.MUTATE, 'Pod', 'ns-0')
    t0 = time.perf_counter()
    msc = None
    while msc is None and time.perf_counter() - t0 < 300.0:
        msc = handlers._device_scanner(mutate, kind='mutate')
        time.sleep(0.02)
    if msc is None or not msc.ok:
        raise AssertionError('the mutate scanner did not come up')
    bodies = [b for r, b in chip_smoke._reviews(2 * (n + 20), 0, 0)
              if r == '/mutate']
    for body in bodies[:20]:
        server.handle('/mutate', body)
    before = kernels.LAUNCHES['k3_mutate']
    lat = []
    for body in bodies[20:]:
        t = time.perf_counter()
        server.handle('/mutate', body)
        lat.append((time.perf_counter() - t) * 1e3)
    launches = kernels.LAUNCHES['k3_mutate'] - before
    if launches < len(lat):
        raise AssertionError(f'K3 launched {launches} times for '
                             f'{len(lat)} reviews: the host served some')
    busy, calls = chip_smoke.request_kernel_ms(
        lambda: server.handle('/mutate', bodies[20]))
    handlers.shutdown()
    lat.sort()
    return {'n': len(lat), 'p50_ms': chip_smoke._pctl(lat, 0.50),
            'p99_ms': chip_smoke._pctl(lat, 0.99), 'device_busy_ms': busy,
            'kernel_calls': calls, 'k3_launches_per_review':
            launches / len(lat)}


def sync_latency(restricted: bool, n: int) -> dict:
    """``n`` sync /validate/fail reviews through the webhook on the
    card after 20 warm ones: latency p50 and p99 (ms), the card's busy
    ms per request and K1v's launches per review."""
    import chip_smoke
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.policycache import cache as pcache
    from kyverno_tpu_torch.policycache.cache import Cache
    from kyverno_tpu_torch.webhooks.handlers import ResourceHandlers
    from kyverno_tpu_torch.webhooks.server import WebhookServer
    cache = Cache()
    if restricted:
        cache.warm_up(smokepack.load_restricted_pack('Enforce'))
        handlers = ResourceHandlers(
            cache, serving_mode='sync',
            pc_builder=chip_smoke._restricted_context())
        reviews = chip_smoke._restricted_reviews(n + 20, 0, 0)
    else:
        cache.warm_up(smokepack.load_smoke_pack('Enforce'))
        handlers = ResourceHandlers(cache, serving_mode='sync')
        reviews = [r for r in chip_smoke._reviews(2 * (n + 20), 0, 0)
                   if r[0] == '/validate/fail']
    server = WebhookServer(handlers)
    validate = cache.get_policies(pcache.VALIDATE_ENFORCE, 'Pod', 'ns-0')
    if not handlers.wait_device_ready(validate, timeout=300.0):
        raise AssertionError('the validate scanner did not come up')
    bodies = [b for _r, b in reviews]
    for body in bodies[:20]:
        server.handle('/validate/fail', body)
    before = kernels.LAUNCHES['k1_vm']
    lat = []
    for body in bodies[20:]:
        t0 = time.perf_counter()
        server.handle('/validate/fail', body)
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = kernels.LAUNCHES['k1_vm'] - before
    if launches < len(lat):
        raise AssertionError(f'K1v launched {launches} times for '
                             f'{len(lat)} reviews: the host served some')
    busy, calls = chip_smoke.request_kernel_ms(
        lambda: server.handle('/validate/fail', bodies[20]))
    handlers.shutdown()
    lat.sort()
    return {'n': len(lat), 'p50_ms': chip_smoke._pctl(lat, 0.50),
            'p99_ms': chip_smoke._pctl(lat, 0.99), 'device_busy_ms': busy,
            'kernel_calls': calls, 'k1v_launches_per_review':
            launches / len(lat)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reviews', type=int, default=300)
    ap.add_argument('--reps', type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print('k1v_bench: needs a CUDA card', file=sys.stderr)
        return 1
    import chip_smoke
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.ops import _build
    device = torch.device('cuda')
    _build.build_all(['k1_vm', 'k1h_fdet_select', 'k3_mutate'])
    out = {'checkout': HERE, 'nvidia_smi': chip_smoke._nvidia_smi(),
           'ptxas': chip_smoke.ptxas_summary(_build.build_log('k1_vm'))}
    out['smoke'] = k1v_times(smokepack.load_smoke_pack(),
                             smokepack.make_config4_pod, device, args.reps,
                             adm=False)
    out['restricted'] = k1v_times(smokepack.load_restricted_pack(),
                                  smokepack.make_restricted_pod, device,
                                  args.reps, adm=True)
    bad = {f'{c}.{s}': r['max_abs_err'] for c in ('smoke', 'restricted')
           for s, r in out[c].items() if r['max_abs_err']}
    if bad:
        raise AssertionError(f'K1v differs from its plain version: {bad}')
    out['k1_call'] = {
        'smoke': k1_calls(smokepack.load_smoke_pack(),
                          smokepack.make_config4_pod, device, args.reps),
        'restricted': k1_calls(smokepack.load_restricted_pack(),
                               smokepack.make_restricted_pod, device,
                               args.reps)}
    out['mutate_kernel_call'] = mutate_calls(device, args.reps)
    out['sync_validate'] = {'smoke': sync_latency(False, args.reviews),
                            'restricted': sync_latency(True, args.reviews)}
    out['sync_mutate'] = sync_mutate_latency(args.reviews)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
