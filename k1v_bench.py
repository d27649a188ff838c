#!/usr/bin/env python3
"""K1v, K1h, K1c, K3 and K4h on one card at the main path's shapes, and
the sync admission latency that rests on them: a short A/B harness.

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
of seeded Pods, median host milliseconds.

K4h (the mesh step's histogram) at the step's own tensors (a 16,384-Pod
smoke chunk: K1v's statuses and the ``__rowvalid__`` lane as the step
passes it) and at a random ``[131072, 256]``; K1c at the inputs the
eager walk gives it on the admission shape and on the chunk, and at a
random ``w = 64`` case with long patterns; and K1v on a glob-heavy
pack (``GLOB_PACK``: ``dp``-class image and name patterns over Pods
of 12 containers).  Each kernel's wrapper time (CUDA events over
``--reps`` back-to-back calls: the host's enqueue rate where the kernel
is shorter), its device time (the same calls captured in one CUDA
graph, the replay timed with CUDA events), its plain version's time,
the library call's where there is one and the bound; every kernel is
held bit-equal to its plain version.  One mesh step is traced with a
dispatch mode: the aten ops and kernel launches between K1v's launch
and the ``all_reduce``.  Then ``--reviews`` sync
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
    from kyverno_tpu_torch.ops import kernels, vm
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
                      'globs': int((program.code[:, 0] ==
                                    vm.OP['GLOB']).sum()),
                      'ms': chip_smoke._ms(
                          lambda: kernels.status_vm(packed, program),
                          device, reps),
                      'device_ms': device_ms(
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


#: glob-heavy K1v case: ``dp``-class patterns (more than one star, or a
#: '?' beside a star; ``compiler/ir.py classify_wildcard``) on every
#: container's image and name, in the form of upstream
#: ``disallow-latest-tag``'s ``image: "*:*"`` (smokepack.py)
GLOB_PACK = """
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: glob-images
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
""" + ''.join(f"""
    - name: glob-{i}
      match: {{any: [{{resources: {{kinds: [Pod]}}}}]}}
      validate:
        message: "{field} must match {pat}"
        pattern:
          spec:
            containers:
              - {field}: "{pat}"
""" for i, (field, pat) in enumerate([
    ('image', '*:*'), ('image', '*.*/*:*'), ('image', '*/*/*:v?*'),
    ('image', '*:?*.?*'), ('image', '*registry*:*/*'),
    ('image', '?*.io/*/*:*'), ('name', 'c?*'), ('name', '*-*-*')]))

GLOB_IMAGES = ['nginx:1.25.3', 'ghcr.io/org/app:v2.1.0',
               'registry.internal:5000/team/api:canary',
               'docker.io/library/busybox:1.36.1',
               'gcr.io/project-name/service-name@sha256:' + 'ab' * 10,
               'quay.io/prometheus/node-exporter:v1.7.0', 'app',
               'europe-west1-docker.pkg.dev/acme/images/web-frontend:2024.1']


def make_glob_pod(rng, i: int) -> dict:
    """A smoke-pack Pod (``make_pod``) with 12 containers, images of 3
    to 60 bytes."""
    from kyverno_tpu_torch import smokepack
    pod = smokepack.make_pod(rng, i)
    conts = pod['spec']['containers']
    for c in range(len(conts), 12):
        conts.append({'name': f'c{c}-side-{i % 5}',
                      'image': GLOB_IMAGES[(i + c) % len(GLOB_IMAGES)]})
    return pod


def device_ms(fn, device, reps: int):
    """Device milliseconds of one call of ``fn``: ``reps`` calls
    captured in one CUDA graph and the replay timed with CUDA events, so
    the host's dispatch is not in it (None if the calls cannot be
    captured).  ``fn`` runs twice on the capture stream first (K4h keeps
    a workspace per stream)."""
    import torch
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
    except Exception as e:  # noqa: BLE001 - an extra reading, not a check
        print(f'k1v_bench: graph capture failed: {e}', file=sys.stderr)
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_times(call, plain, library, bound, device, reps: int) -> dict:
    import chip_smoke
    err = chip_smoke._max_abs_err(call(), plain())
    ms, by = bound
    return {'max_abs_err': err, 'ms': chip_smoke._ms(call, device, reps),
            'device_ms': device_ms(call, device, reps),
            'plain_ms': chip_smoke._ms(plain, device, 5),
            'library_ms': chip_smoke._ms(library, device, reps)
            if library is not None else None,
            'bound_ms': ms, 'bound_by': by}


#: ops that launch no device work (views, allocations, profiler marks)
_NO_LAUNCH = {'view', 'slice', 'select', 'reshape', '_reshape_alias',
              'as_strided', 'empty', 'empty_strided', 'alias', 'detach',
              'unsqueeze', 'squeeze', 'expand', '_unsafe_view', 't',
              'lift_fresh', 'view_as', '_record_function_enter_new',
              '_record_function_exit'}


def mesh_step(device, reps: int) -> dict:
    """One ``build_sharded_evaluator`` step over a 16,384-Pod smoke
    chunk on a one-rank mesh: the aten ops it dispatches between K1v's
    launch and the ``all_reduce`` and the kernels they launch (K4h's
    and those of ops that are not views or allocations), then K4h at the
    step's own statuses and row-validity lane and at the random case."""
    import chip_smoke
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.compiler.ir import N_STATUS_CODES
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.parallel import mesh as mesh_mod
    cps = compile_policies(smokepack.load_smoke_pack())
    mesh = mesh_mod.make_mesh(device=device)
    rng = random.Random(0)
    pods = [smokepack.make_config4_pod(rng, i) for i in range(CHUNK)]
    tensors, layout = mesh_mod.shard_tensors(
        encode_batch(pods, cps, padded_n=CHUNK).tensors(), mesh)
    step = mesh_mod.build_sharded_evaluator(cps, mesh)
    step(tensors, layout)
    log, marks, seen = [], {}, {}

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            log.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    real_vm, real_ar = kernels.status_vm, mesh_mod.Mesh.all_reduce_sum
    real_k4 = kernels.status_histogram

    def vm(*args):
        out = real_vm(*args)
        marks['k1v'] = (len(log), dict(kernels.LAUNCHES))
        return out

    def all_reduce(self, t):
        marks['all_reduce'] = (len(log), dict(kernels.LAUNCHES))
        return real_ar(self, t)

    def k4(*args):
        seen['args'] = args
        return real_k4(*args)

    kernels.status_vm, mesh_mod.Mesh.all_reduce_sum = vm, all_reduce
    kernels.status_histogram = k4
    try:
        torch.cuda.synchronize()
        with Log():
            step(tensors, layout)
        torch.cuda.synchronize()
    finally:
        kernels.status_vm, mesh_mod.Mesh.all_reduce_sum = real_vm, real_ar
        kernels.status_histogram = real_k4
    (a, la), (b, lb) = marks['k1v'], marks['all_reduce']
    ops = log[a:b]
    hand = {k: lb[k] - la[k] for k in lb if lb[k] != la[k]}
    out = {'aten_ops': ops, 'n_aten_ops': len(ops), 'hand_launches': hand,
           'launches': sum(hand.values()) + sum(
               op not in _NO_LAUNCH for op in ops)}
    statuses, rowvalid, n_codes = seen['args']
    st_rv = (statuses, rowvalid, n_codes)
    out['rowvalid_stride'] = rowvalid.stride(0) if rowvalid is not None \
        else None
    g = torch.Generator().manual_seed(0)
    r, p = chip_smoke.K4_RANDOM
    rand = (torch.randint(-2, 8, (r, p), generator=g,
                          dtype=torch.int8).to(device),
            (torch.rand(r, generator=g) >= 0.1).to(torch.uint8).to(device),
            N_STATUS_CODES)
    for label, args in (('step', st_rv), ('random', rand)):
        out[label] = dict(_kernel_times(
            lambda: kernels.status_histogram(*args),
            lambda: kernels.status_histogram_plain(*args),
            lambda: kernels.status_histogram_library(*args),
            chip_smoke._k4_bound(*args), device, reps),
            shape=list(args[0].shape))
    return out


#: K1c's random case: long patterns, several stars and literal runs
K1C_LONG = (b'*a*b*:*x?*', b'ab*?:*latest*a', b'*:*l*a*t*e*s*t*',
            b'?*/*.*:*-*.*')


def k1c_times(device, reps: int) -> dict:
    """K1c at the inputs the eager walk gives it on the smoke pack's
    64-row admission batch and 16,384-row chunk (``*:*``), and at a
    random case of the chunk's shape, w = 64, with ``K1C_LONG``."""
    import chip_smoke
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.ops.eval import build_evaluator, shard_batch
    cps = compile_policies(smokepack.load_smoke_pack())
    ev = build_evaluator(cps, device)
    rng = random.Random(0)
    pods = [smokepack.make_config4_pod(rng, i) for i in range(CHUNK)]
    out = {}
    calls = {}
    for label, n in (('rows_64', ADMISSION_ROWS), ('chunk', CHUNK)):
        packed, layout = shard_batch(
            dict(encode_batch(pods[:n], cps, padded_n=n).tensors()), device)
        _err, _vm, seen, _l = chip_smoke.k1v_check(
            lambda: ev.raw(packed, layout))
        calls[label] = seen['wildcard_match'][0]
    head, str_len, _tag, _p = calls['chunk']
    rand = [a.to(device) for a in chip_smoke._random_k1c(
        tuple(str_len.shape), 64, 1)]
    cases = [(k, c) for k, c in calls.items()] + [
        (f'random_{i}', tuple(rand) + (p,)) for i, p in enumerate(K1C_LONG)]
    for label, args in cases:
        out[label] = dict(_kernel_times(
            lambda: kernels.wildcard_match(*args),
            lambda: kernels.wildcard_plain(*args), None,
            chip_smoke._k1c_bound(args[1], args[0].shape[-1], args[3]),
            device, reps), shape=list(args[0].shape),
            pattern=args[3].decode('utf-8', 'replace'))
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
    _build.build_all()
    out = {'checkout': HERE, 'nvidia_smi': chip_smoke._nvidia_smi(),
           'ptxas': chip_smoke.ptxas_summary(_build.build_log('k1_vm'))}
    out['smoke'] = k1v_times(smokepack.load_smoke_pack(),
                             smokepack.make_config4_pod, device, args.reps,
                             adm=False)
    out['restricted'] = k1v_times(smokepack.load_restricted_pack(),
                                  smokepack.make_restricted_pod, device,
                                  args.reps, adm=True)
    from kyverno_tpu_torch.api.policy import load_policies_from_yaml
    out['glob'] = k1v_times(load_policies_from_yaml(GLOB_PACK),
                            make_glob_pod, device, args.reps, adm=False)
    out['k4h'] = mesh_step(device, args.reps)
    out['k1c'] = k1c_times(device, args.reps)
    bad = {f'{c}.{s}': r['max_abs_err']
           for c in ('smoke', 'restricted', 'glob', 'k1c')
           for s, r in out[c].items() if r['max_abs_err']}
    bad.update({f'k4h.{s}': out['k4h'][s]['max_abs_err']
                for s in ('step', 'random') if out['k4h'][s]['max_abs_err']})
    if bad:
        raise AssertionError(f'a kernel differs from its plain version: '
                             f'{bad}')
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
