#!/usr/bin/env python3
"""K1v on one card at the main path's shapes, and the sync admission
latency that rests on it: a short A/B harness for the kernel.

For the smoke pack and the restricted configuration (the smoke pack,
the restricted chart's ``foreach`` capability policies and the
admission-lanes pack, with the admission lanes of ``ADMISSIONS``
users): K1v's time per wrapper call (CUDA events, mean of ``--reps``
warm calls) at 64 rows, the admission capacity, and at a 16,384-row
chunk, the scan's (the restricted chunk holds the three 43-container
Pods of ``smokepack.OVERFLOW_PODS``), each held bit-equal to K1v's
plain version once.  Then ``--reviews`` sync ``/validate/fail``
reviews through ``WebhookServer`` on the card, one client: p50 and p99
latency and the card's busy time per request (CUDA events around each
kernel wrapper call, ``chip_smoke.request_kernel_ms``).  K1v must
launch once per review, so a review the host engine served would fail
the run.

Run from the root of a checkout on a machine with a CUDA card:

    python3 k1v_bench.py [--reviews N] [--reps N]

It prints one JSON line.  It imports nothing of JAX or of the JAX
package, and runs in the checkout it sits in, so two checkouts side by
side time two versions of the kernel in one run each, on one card.
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
    _build.build_all(['k1_vm', 'k1h_fdet_select'])
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
    out['sync_validate'] = {'smoke': sync_latency(False, args.reviews),
                            'restricted': sync_latency(True, args.reviews)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
