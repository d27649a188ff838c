#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kyverno_tpu_torch``) on one card.

Drives the port's main path — the validate background scan that the
reports controller serves, ``BatchScanner.scan_report_results`` — on the
CUDA card and checks it, in phases that each print one line:

1. ``card``: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, the time to build the hand-written kernels from
   ``kyverno_tpu_torch/csrc`` (one nvcc per source, all at once) and
   ptxas' registers, stack and spills of each.
2. ``float64_division``, ``kernels``, ``k1_chunk``: the eager walk's
   float64 quotients against IEEE division on the host (they must be
   equal); then the evaluator on the first 16,384-row chunk, once with
   K1v (the status-program interpreter) and once with its plain
   version, the eager walk, on the same card tensors: out8 and out32
   must be bit-equal, and the eager run hands K1c and K1h their inputs
   (K1c's DP runs inside K1v on the main path, so K1c launches only
   there).  ``k1_chunk`` reports per K1 call the aten ops
   (torch.profiler, split K1v / K1h / K1i / glue by the evaluator's
   labels; the glue must be 0: K1h takes the whole tail of the call),
   the host dispatch and the device span, against the eager walk's, and
   each program's route.  ``kernels``: K1v, K1h and K1c against their
   plain versions on the card at the main path's shapes — the chunk's
   real tensors plus seeded random ones (K1h's with the match and
   row-validity lanes inside wider buffers).  Outputs must be exactly
   equal.  Times come from CUDA events.  K1v's record adds its
   launch plan (parts per tree, groups, blocks, warps per block, shared
   memory per block, groups staged in shared memory or reading device
   memory), ptxas' numbers, the instructions it executed per row (its
   loops stop at the count) beside ``row_insns``, the full-width count
   its bound uses, and its time with every block in the global mode.
3. ``slice``: ``scan_report_results`` over ``--pods`` Pods (100,000
   is a large production cluster; the default is cut to 3 chunks + 1,
   49,153, so that the script fits the time limit) with the smoke pack's
   12 policies: Pods/s, decisions/s, the stage breakdown, the
   device-decided fraction, each kernel's launches during the scan
   (K1v and K1h must launch, K1v once per chunk) and the encoder pool's
   state.  The first 2,000
   rows and every row of the last chunk are held against the port's
   host ``Engine``; any mismatch fails the run.  A sha256 digest over
   every result row is kept for the mesh phase.
4. ``mesh``, ``mesh_step``, ``mesh_2rank``: the multi-device scan
   (``parallel/mesh.py``) on ``torch.distributed``.  (a) An NCCL group
   of world size 1 (rendezvous through a file store; no network), and
   ``BatchScanner(policies, mesh=...).scan_report_results`` over the
   first 3 chunks + 1 of the same Pods (49,153): every row's digest must
   equal the slice's, the first 2,000 rows and the last chunk are held
   against the host ``Engine``, and the
   fleet telemetry reports the shard wall and collective seconds.  (b)
   ``distributed_scan_step`` over three steps of 16,384 Pods on that
   group: each summary must equal a numpy histogram of its statuses, the
   statuses must equal the single-device scanner's, K1v must equal the
   eager walk on one step's ``.raw`` inputs, and the histogram
   kernel (K4h) is held against its plain version on the exact card
   tensors a step gave it, on a seeded random case (131,072 rows, 256
   programs) and on empty shapes (no launch).  (c) Two ranks on the one
   card: two child processes of this script, each evaluating on
   ``cuda:0`` with its collectives on host copies under gloo (NCCL
   refuses two ranks on one GPU), depth cut to one step over 2 x 16,384
   Pods and a scan of 3 chunks + 1 Pod.  Their summaries must agree with
   each other and with (b), their report digests with (a); rank 0 alone
   leads; K4h must launch in each.  A child that fails, outlives its
   timeout or prints no result fails the run.
5. ``k3``: the mutate kernel (K3) against its plain version on the card,
   on the staged lanes of one full chunk of the mutate pack, seeded
   random cases (8 rules of 32 sites, a 256-byte and an 8-byte window,
   10 % padding rows) and a program with no sites.  Outputs must be
   exactly equal, and the wrapper must refuse a card ``rule_start``
   without its host bounds.
6. ``mutate``: ``MutateScanner.scan`` over one full chunk (16,384 Pods)
   of the mutate pack: rows/s, the FALLBACK rows, K3's launches; 256
   sampled rows are held against the host engine's mutate chain.
7. ``admission``: the admission webhook, ``WebhookServer.handle`` on
   ``/validate/fail`` and ``/mutate``, over the smoke pack in Enforce plus
   the mutate pack, with the scanners on the card.  A sync pass (500 +
   500 sequential reviews) and a batch pass (the micro-batcher, 16
   client threads, 8,000 reviews: CREATE and UPDATE, 8 users, 7
   namespaces), every review with Kyverno's default 10 s timeout.
   Response bytes of every sync review and of 2,000 batch reviews are
   held against a host-loop handler (``device=False``).  Before the
   passes, one sync review of each route is served with the kernel
   wrappers spied on; K1v's evaluator call is repeated with the eager
   walk (bit-equal out8/out32; ``k1_admission`` reports the aten ops and
   dispatch per call), and each kernel is held against its plain version
   on the exact card tensors that review gave it (K1v, K1h and K1c at the
   64-row admission capacity, K3 at the /mutate lanes).  One K1 call,
   and one call of the mutate kernel up to its readback, run under
   ``torch.cuda.set_sync_debug_mode('error')``: a wrapper that waits
   for the card fails the run, as do aten ops of glue in the K1 call.
   ``k1_admission`` prints the copies each way of one K1 call with its
   readback and of one sync request per route (a dispatch mode counts
   them), and torch.profiler's kernel events beside the launches the
   wrappers counted for a wrapper call, an evaluator call (also on a
   second thread) and sync /validate/fail requests (``profiler_k1v``).
   Because the
   handler serves a failed device path from the host engine with the
   same bytes, the phase also counts the serving path of each validate
   decision (decision provenance), the rows the mutate scanner
   dispatched and the breaker failures, and fails unless the device
   served (see ``admission_phase``).  The card's busy time per sync
   request is the sum of CUDA-event times around each kernel wrapper
   call the request made (K1v and K1h; K3 on /mutate), over 5 requests.
8. ``restricted_chunk``, ``restricted_slice``, ``restricted_admission``:
   the restricted configuration (``smokepack.load_restricted_pack``: the
   smoke pack, Kyverno's restricted chart's ``disallow-capabilities-
   strict`` foreach rules and the admission-lanes pack) over ``--pods``
   ``make_restricted_pod`` Pods.  K1v, which now runs the ``foreach``
   trees and the per-row admission match (K1i), is held bit-equal to its
   plain version (the eager walk and ``_adm_match_graph``) on the first
   chunk with the admission lanes of ``ADMISSIONS`` tuples, with the
   aten ops and host dispatch of both; ``_adm_match_graph`` must run no
   aten op on the card.  Then the scan (rows held against the host
   engine as in phase 3) and the admission webhook in Enforce (500 sync
   and 8,000 batch /validate/fail reviews from the ``ADMISSIONS`` users,
   roles resolved from the same table by both handlers; checks as in
   phase 7).
9. ``reports``, ``partitioned``: the reports-controller daemon,
   ``ReportsController(Setup('kyverno-reports-controller', [],
   client=FakeClient()))``, its own ``tick()`` driven directly over a
   client holding the smoke pack as ClusterPolicies and the first
   ``--reports-pods`` Pods of phase 3 (default one chunk + 1, 16,385, cut
   from 100,000 so that phase 11 fits the time limit), the verdict cache
   in a fresh temporary directory; (b) runs in a child process of this
   script (``--partitioned-child OUT``) while (a) runs here, each on the
   card.  (a) Whole set
   (``KTPU_PARTITIONS=0``) over every Pod: a cold tick (one report per
   Pod, rows equal to the slice phase's and, on the first 2,000 and
   the last chunk, to the host engine's; K1v and K1h once per chunk, the
   encoder pool up and not broken), a tick after ``reset_scan_state()``
   and ``enqueue_all()`` (every row replayed, no launch, the same
   reports) and a tick after one rule message is edited through the
   client (a new cache generation, every row rescanned, sampled rows
   equal to the host engine's under the edited set).  (b) Partitioned
   (``KTPU_PARTITIONS=4``, a fresh cache directory) over at most the
   first 3 chunks + 1 Pods: a cold tick (rows equal to (a)'s, K1v once per
   partition per chunk, no fallback) and the same edit (1 recompile,
   every row on the scoped path, K1v only for the touched partition,
   rows equal to (a)'s edit tick), then the executable ledger: one
   record per (partition, layout) under the partition's fingerprint,
   none for the whole-set evaluator.  Each line gives per tick the wall
   time, Pods/s, the seconds of the daemon's passes and of the scan
   stages, launches, rescan and partition counters, the verdict cache's
   bytes on disk and the encoder pool.
10. ``admission_daemon``: the admission-controller daemon as users start
   it (``cmd/admission_controller.py``), in two child processes of this
   script in turn (``--admission-child OUT``), sharing one fresh AOT
   store (``KTPU_AOT_CACHE_DIR``) and one fresh kernel library
   directory (``KTPU_COMPILE_CACHE``).  Each starts
   ``AdmissionController(setup, tls=True)`` on the card over a
   ``FakeClient`` holding the smoke pack in Enforce, the mutate pack, an
   Audit policy and a generate policy; runs ``server.start()`` and
   ``tick()`` from a thread of its own; polls ``/health/warmup`` over
   HTTPS, the certificate verified against the CA secret's bundle, until
   ready (``ready_s`` from process start; the warmer must report
   ``compiled scanner serving``); holds K1v, K1h and K3 against their
   plain versions on the tensors one review of each route gives them;
   then serves 200 /validate/fail and 200 /mutate reviews, 20 compliant
   Pods, 20 Namespace creations and 2 /policyvalidate reviews through
   the socket, every response byte held against a host-loop handler on
   the daemon's cache.  It fails on a Pod decision off ``sync``, a
   breaker failure, a /mutate review not through the mutate scanner, a
   kernel never launched, other than one UpdateRequest and (after a
   background-controller tick) one NetworkPolicy per Namespace, other
   than one admission report per allowed Pod, or webhook configurations
   without that CA bundle.  The cold process must build the kernels and
   lower and store its K1v programs; the warm one must build no kernel,
   lower no program and load them from the store; both must answer the
   same bytes.
11. ``restart``: the daemons against an API server over HTTP, then
   restarted on the state they left.  This process serves the port's
   ``FakeApiServer`` on 127.0.0.1, holding phase 10's policies and the
   first 4,096 Pods of phase 3 in their Namespaces, with every kind of
   ``API_KINDS`` registered; two child processes of this script in turn
   (``--restart-child FIRST|SECOND OUT --api-server URL``) share one
   fresh AOT store, kernel library directory and verdict cache, and
   each gives every daemon an ``HTTPClient`` of its own.  Each runs the
   reports daemon's ``tick()`` (one report per Pod, 1,000 rows held
   against the host engine, every policy label of its reports and of the
   aggregated PolicyReports equal to the policy's current resourceVersion
   on the server), then the admission daemon as in phase 10 (100 + 100
   reviews, 10 compliant Pods, 10 Namespace creations, 2
   /policyvalidate; K1v, K1h and K3 held against their plain versions;
   every response byte against the host loop), then ticks it (the
   reconciler writes each policy's status), serves 10 more compliant
   Pods and holds the policy labels of their admission reports against
   the server's current resourceVersions.  Between the processes every
   ClusterPolicy must carry status.  The restarted process must build no
   kernel, lower no K1v program and load one, replay every report row
   under the first one's cache generation with no launch, and write the
   first one's reports but for the policy labels.  The line gives per
   process the readiness, the program cache, the serving rate, the
   reports tick and the requests the server answered, by verb and kind.
12. ``loadgen``: the load generator's drills (``conformance/loadgen.py``
   ``SyntheticCluster``) against batch-mode handlers on the card over
   the smoke pack in Enforce and the admission-lanes pack, each as its
   ``bench.py`` counterpart checks it.  (a) heterogeneous traffic
   (seed 1234: zipfian users and namespaces, CREATE and UPDATE,
   exception tenants on the host loop) at 1, 8 and 32 client threads,
   25 reviews each, every response byte against the host loop: mean
   occupancy at 32 threads over 2.0, no ``host_fallback``, at least
   99 % of the other tenants' decisions on ``batch``; one burst's K1v
   (with admission entries, K1i) and K1h calls are first held against
   their plain versions.  (b) chaos (seed 4321, every 8th review a
   poison row): the fault-free oracle pass, then 6 threads x 8 reviews
   with ``KTPU_FAULTS`` armed: every response 200 with the oracle's
   verdict and ``poison_row`` shedding exactly the poison rows; then
   the breaker's open → half-open → closed round trip.  (c) policy
   churn in a child process (``--loadgen-child OUT``) with
   ``KTPU_PARTITIONS=4``: one scheduled edit of a policy that denies a
   probe Pod, enforced at once and after the hot swap, one swap, one
   partition recompiled, no fallback, 4 threads x 24 reviews on the
   swapped scanner against the host loop.  Then a small kuttl suite
   (``KUTTL_SUITE``) through ``run_suite(..., device='cuda:0')``.  K1v
   and K1h must launch in (a) and (c), K1v in the suite.

Every phase fails if a program of its packs is routed to the eager
walk.  Then the seconds of each phase, one JSON line of
per-kernel numbers (launches on the path that runs each kernel: the
admission path for K1v, K1h and K3, with the error, times and bound at
the admission shapes, the chunk-shape numbers being in the report; K1c,
whose DP runs inside K1v, reports 0 launches on the main path and its
comparison-run launches in the report; the mesh path for K4h, at the
step's shapes), the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  A full report goes to
``chiprun_out/chip_smoke.json``.

Run from the repository root:

    python3 chip_smoke.py [--pods N] [--reports-pods N] [--seed S]

(``--mesh-child RANK`` is the mode phase 4c starts its two ranks in,
``--partitioned-child OUT`` the one phase 9 starts 9b in,
``--admission-child OUT`` the one phase 10 starts its daemons in,
``--restart-child FIRST|SECOND OUT --api-server URL`` the one phase 11
starts its processes in, ``--loadgen-child OUT`` the one phase 12 starts
its churn drill in; with ``--device cpu`` the last three rehearse on
the host without the kernel checks.)

Without a CUDA card, or outside the repository, it exits non-zero and
prints no result.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import time

#: when this process started, near enough (before any heavy import):
#: phase 10's daemon processes count their readiness from here
STARTED = time.monotonic()
HERE = os.path.dirname(os.path.abspath(__file__))
NOW = 1_700_000_000            # report timestamp (seconds) for the scan
CHECK_HEAD = 2000              # rows held against the host engine, plus
                               # every row of the last chunk
MIN_PODS = 3 * 16384 + 1       # never cut below three full chunks
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM non-tensor rate (data sheet)
PCIE_BYTES_PER_S = 64e9        # PCIe Gen5 x16, one direction (data sheet)
SCAN_KERNELS = ('k1_vm', 'k1h_fdet_select')        # launched by the scan
MESH_KERNELS = ('k1_vm', 'k4_status_hist')          # by the mesh path
ADMISSION_KERNELS = ('k1_vm', 'k1h_fdet_select', 'k3_mutate')
#: launched by the eager walk (K1v's plain version) that the K1v checks
#: run on the card: K1c's DP runs inside K1v on the main path
CAPTURE_KERNELS = ('k1c_wildcard', 'k1h_fdet_select')
MESH_STEP_ROWS = 16384         # rows of each distributed_scan_step
MESH_STEPS = 3                 # steps on the world-size-1 group
MESH_CHILD_RANKS = 2                        # ranks of the two-rank mesh
MESH_CHILD_STEP_ROWS = 2 * MESH_STEP_ROWS   # the two-rank step
MESH_CHILD_PODS = 3 * 16384 + 1             # the two-rank scan
K4_RANDOM = (131072, 256)      # rows, programs of K4h's random case
INIT_TIMEOUT_S = 60            # every process group's rendezvous
CHILD_TIMEOUT_S = 480          # each two-rank child, start to end
MUTATE_CHUNK = 16384           # rows of the mutate-chunk phase
MUTATE_CHECK = 256             # of them held against the host chain
SYNC_REVIEWS = 500             # per route, sequential
BATCH_REVIEWS = 8000           # both routes, over BATCH_CLIENTS threads
BATCH_CLIENTS = 16
BATCH_ORACLE = 2000            # batch reviews held against the host loop
READY_S = 300.0                # bound on the wait for the scanners
#: a kernel record's numbers that belong to the shapes it was run at
AT_SHAPE = ('ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
            'kernel_device_ms', 'shape')
#: and K1v's own: its time in the global mode and its launch plan
K1V_AT_SHAPE = AT_SHAPE + ('global_mode_ms', 'plan')


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


def float64_division_check(device) -> dict:
    """The eager walk's float64 quotient (``ops/eval.py _fdiv``: the
    host's ``float(key)`` of a milli lane, and nanos over 1e9) on the
    card against IEEE division on the host, over every milli value in
    [-200, 200] and seeded int64s up to 2^53; beside it, how many of
    those a Python-scalar divisor, which CUDA applies as a product with
    its reciprocal, gets wrong.  Fails unless ``_fdiv`` is exact."""
    import torch
    from kyverno_tpu_torch.ops.eval import _fdiv
    gen = torch.Generator().manual_seed(0)
    x = torch.cat([torch.arange(-200000, 200001, dtype=torch.int64),
                   torch.randint(-(1 << 53), 1 << 53, (1 << 20,),
                                 generator=gen)])
    out = {'values': int(x.numel())}
    for name, div in (('over_1000', 1000.0), ('over_1e9', 1e9)):
        want = x.to(torch.float64) / div
        xd = x.to(device)
        walk = int((_fdiv(xd, div).cpu() != want).sum())
        scalar = int(((xd.to(torch.float64) / div).cpu() != want).sum())
        out[name] = {'walk_differs': walk,
                               'scalar_divisor_differs': scalar}
        if walk:
            raise AssertionError(f'the eager walk\'s float64 division by '
                                 f'{div:g} differs from IEEE division on '
                                 f'{walk} values')
    return out


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

def first_chunk_inputs(scanner, pods, device, adm_rows=None):
    """Run the evaluator once over the scan's first chunk and keep the
    tensors each kernel wrapper was given, plus the chunk's device and
    host times.  With ``adm_rows`` (one admission tuple per Pod) the
    chunk carries their admission lanes, the resource-shape atoms
    decided by the scanner's host helpers, instead of zero lanes."""
    import numpy as np
    import torch
    from kyverno_tpu_torch.api.unstructured import Resource
    from kyverno_tpu_torch.compiler import admission as admission_lanes
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops.eval import fold_match_unique, shard_batch
    chunk = scanner.CHUNK
    part = pods[:chunk]
    ev = scanner._evaluator
    tensors = dict(encode_batch(part, scanner.cps, padded_n=chunk).tensors())
    wrapped = [Resource(r) for r in part]
    cm = scanner.match_matrix(part, wrapped)
    mm_u = fold_match_unique((cm & scanner._dev_mask).astype(np.uint8), ev)
    mm = np.zeros((chunk, mm_u.shape[1]), np.uint8)
    mm[:len(part)] = mm_u
    tensors['__match__'] = mm
    if scanner._adm is not None:
        lanes = admission_lanes.zero_lanes(scanner._adm, chunk)
        if adm_rows is not None:
            plan = admission_lanes.encode_rows(scanner._adm,
                                               adm_rows[:len(part)])
            for name, lane in plan.lanes.items():
                lanes[name][:len(part)] = lane
            lanes['__admres__'][:len(part)] = \
                scanner._adm_res_atoms(part, wrapped)
        tensors.update(lanes)
    packed, layout = shard_batch(tensors, device)

    # K1v against its plain version on the chunk's card tensors; the
    # eager run hands K1c and K1h their captured inputs
    err, vm_calls, seen, launched = k1v_check(lambda: ev(packed, layout))
    if err:
        raise AssertionError(f'K1v differs from the eager walk on the '
                             f'first chunk: {err}')
    # one more call, timed: the CUDA events cover the device span it
    # enqueued (``_host_ms`` below times its Python dispatch)
    if device.type == 'cuda':
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    out = ev(packed, layout)
    dev_ms = None
    if device.type == 'cuda':
        e1.record()
        torch.cuda.synchronize()
        dev_ms = e0.elapsed_time(e1)
    busy_ms = _device_busy_ms(lambda: ev(packed, layout), device)
    packed_bytes = int(sum(v.numel() * v.element_size()
                           for v in packed.values()))
    out_bytes = int(sum(o.numel() * o.element_size() for o in out))
    with eager_walk():
        t1 = time.perf_counter()
        ev(packed, layout)
        eager_host_ms = (time.perf_counter() - t1) * 1e3
        eager_aten = aten_ops(lambda: ev(packed, layout), device)
    host_ms = _host_ms(lambda: ev(packed, layout), device)
    chunk_stats = {'rows': chunk, 'host_dispatch_ms': host_ms,
                   'plan_lookup_us': _plan_lookup_us(ev, layout),
                   'device_span_ms': dev_ms, 'device_busy_ms': busy_ms,
                   'k1v_check': {'max_abs_err': err,
                                 'capture_launches': launched},
                   'aten_ops': aten_ops(lambda: ev(packed, layout), device),
                   'eager_walk': {'host_dispatch_ms': eager_host_ms,
                                  'aten_ops': eager_aten},
                   'routes': {str(j): list(r) for j, r in ev.routes.items()},
                   'packed_bytes': packed_bytes, 'out_bytes': out_bytes,
                   'out8_shape': list(out[0].shape),
                   'out32_shape': list(out[1].shape),
                   # K1: the packed input read once, out8/out32 written
                   # once, over the card's memory rate (K1v's own bound,
                   # of the lanes its bytecode reads, is in the kernels
                   # line); K2: the packed input over the host link
                   'k1_bound_ms': (packed_bytes + out_bytes) /
                   HBM_BYTES_PER_S * 1e3,
                   'k2_bound_ms': packed_bytes / PCIE_BYTES_PER_S * 1e3}
    seen['status_vm'] = vm_calls
    glue = chunk_stats['aten_ops']['by_part']['glue']
    if glue:
        raise AssertionError(f'{glue} aten ops of glue per K1 call on the '
                             f'first chunk (must be 0)')
    return seen, chunk_stats


def _clone(a):
    import torch
    if isinstance(a, torch.Tensor):
        if a.dim() == 1 and a.stride(0) > 1:
            # a lane inside its packed buffer (K4h's row mask): the copy
            # keeps its row stride, as the kernel reads it
            out = torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                      device=a.device)
            return out.copy_(a)
        return a.clone()
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    if isinstance(a, tuple) and not hasattr(a, '_fields'):
        return tuple(_clone(x) for x in a)
    return a


def capture_kernel_inputs(fn, names=('fdet_select', 'wildcard_match',
                                       'k3_mutate')):
    """Call ``fn`` with the kernel wrappers ``names`` spied on.  Returns
    what ``fn`` returned and, per wrapper, copies of the arguments of
    each call it got (the tensors stay on their device).  The spies call
    the real wrappers, so each call still launches and counts."""
    from kyverno_tpu_torch.ops import kernels
    seen = {name: [] for name in names}
    real = {name: getattr(kernels, name) for name in seen}

    def spy(name):
        def call(*args):
            seen[name].append(tuple(_clone(a) for a in args))
            return real[name](*args)
        return call

    for name in seen:
        setattr(kernels, name, spy(name))
    try:
        out = fn()
    finally:
        for name, wrapper in real.items():
            setattr(kernels, name, wrapper)
    return out, seen


class eager_walk:
    """Within the block the evaluator's K1v calls take K1v's plain
    version, the eager walk, on the same card tensors."""

    def __enter__(self):
        from kyverno_tpu_torch.ops import kernels
        self._real = kernels.status_vm
        kernels.status_vm = lambda packed, program: program.plain(packed)
        return self

    def __exit__(self, *exc):
        from kyverno_tpu_torch.ops import kernels
        kernels.status_vm = self._real
        return False


def k1v_check(fn, names=('fdet_select', 'wildcard_match')):
    """``fn()`` (one evaluator call) with K1v and then with the eager
    walk.  Returns the outputs' largest difference, the K1v call's
    ``status_vm`` arguments and the eager run's kernel inputs (K1c and
    K1h, whose launches in that run are counted and returned too)."""
    import torch
    from kyverno_tpu_torch.ops import kernels
    got, vm_calls = capture_kernel_inputs(fn, names=('status_vm',))
    before = dict(kernels.LAUNCHES)
    with eager_walk():
        want, seen = capture_kernel_inputs(fn, names=names)
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in CAPTURE_KERNELS}
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = (want,) if isinstance(want, torch.Tensor) else tuple(want)
    return _max_abs_err(got, want), vm_calls['status_vm'], seen, launched


def aten_ops(fn, device) -> dict:
    """aten ops one call of ``fn`` dispatches (torch.profiler, host
    side), split by the evaluator's ``record_function`` labels (K1v,
    K1h, K1i, the eager walk) and glue (everything else).  ``top`` counts the ops no other
    aten op called."""
    from torch.profiler import ProfilerActivity, profile
    labels = ('k1v_status_vm', 'k1h_fdet_select', 'k1i_adm_match',
              'k1_eager_walk')
    acts = [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        fn()
    split = {k: 0 for k in labels + ('glue',)}
    top = 0
    for evt in prof.events():
        if not evt.name.startswith('aten::'):
            continue
        where, parent, nested = 'glue', evt.cpu_parent, False
        while parent is not None:
            if parent.name.startswith('aten::'):
                nested = True
            if parent.name in labels:
                where = parent.name
                break
            parent = parent.cpu_parent
        split[where] += 1
        top += not nested
    return {'total': sum(split.values()), 'top': top, 'by_part': split}


def ptxas_summary(log: str) -> dict:
    """Registers, stack and spills of each kernel in a ptxas report."""
    import re
    regs = [int(x) for x in re.findall(r'Used (\d+) registers', log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r'(\d+) bytes spill stores, (\d+) bytes spill loads', log)]
    stack = [int(x) for x in re.findall(r'(\d+) bytes stack frame', log)]
    return {'registers': regs, 'spill_bytes': spills, 'stack_bytes': stack}


def _k1v_bound(program, rows: int):
    """(ms, bound_by) of K1v: the lanes its bytecode reads, each read
    once per row, and the unique-space and admission outputs written
    once, over the card's memory rate; one integer operation per
    instruction a row executes over the card's non-tensor rate."""
    out_bytes = rows * (2 * program.n_uniq + 4 * program.n_cols_u +
                        program.n_adm)
    t_bytes = (rows * program.row_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = rows * program.row_insns / CUDA_CORE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        'bytes' if t_bytes >= t_ops else 'operations'


def k1v_plan(program, rows: int) -> dict:
    """K1v's launch over ``rows`` rows: entries, parts per tree (by
    unique column), groups and blocks, warps per block, each block's
    dynamic shared memory and the groups in each mode (tables staged in
    shared memory, or read from device memory)."""
    return {'entries': program.n_entries,
            'parts': {str(c): n for c, n in sorted(program.tree_parts.items())},
            'groups': program.n_groups, 'blocks': program.blocks(rows),
            'warps_per_block': program.group_warps,
            'smem_bytes': program.smem_bytes,
            'staged_groups': program.n_staged,
            'global_groups': program.n_groups - program.n_staged}


def measure_k1v(calls, device) -> dict:
    """K1v on its first captured call (packed buffers, program): the
    wrapper, its device time and its plain version, against the bound;
    its launch plan, the instructions it executed (its loops stop at the
    count; the bound's op term counts every loop at full width), the
    time of the same launch with every block in the global mode, and
    ptxas' numbers."""
    from kyverno_tpu_torch.ops import _build, kernels
    if not calls:
        raise AssertionError('K1v was never called')
    packed, program = calls[0]
    rows = next(iter(packed.values())).shape[0]
    flat = program.restaged(0)
    err = max(_max_abs_err(kernels.status_vm(*c), c[1].plain(c[0]))
              for c in calls)
    err = max(err, _max_abs_err(kernels.status_vm(packed, flat),
                                program.plain(packed)))
    bound_ms, bound_by = _k1v_bound(program, rows)
    executed = kernels.status_vm_executed(packed, program) \
        if device.type == 'cuda' else None
    return {
        'max_abs_err': err,
        'ms': _ms(lambda: kernels.status_vm(packed, program), device),
        'global_mode_ms': _ms(lambda: kernels.status_vm(packed, flat),
                              device),
        'plain_ms': _ms(lambda: program.plain(packed), device, reps=3),
        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None,
        'kernel_device_ms': _device_busy_ms(
            lambda: kernels.status_vm(packed, program), device,
            'k1_vm_kernel', reps=20),
        'plan': k1v_plan(program, rows),
        'ptxas': ptxas_summary(_build.build_log('k1_vm')),
        'shape': {'rows': rows, 'entries': program.n_entries,
                  'adm_cols': program.n_adm,
                  'instructions': int(program.code.shape[0]),
                  'lanes': int(program.lanes.shape[0]),
                  'row_bytes': program.row_bytes,
                  'row_insns': program.row_insns,
                  'executed_row_insns': None if executed is None
                  else executed / rows,
                  'depths': program.depths},
        'calls': len(calls)}


def _device_busy_ms(fn, device, kernel: str = '', reps: int = 1):
    """Device time from torch.profiler over ``reps`` calls of ``fn``,
    counting device-side kernel events only (a CPU op's own device time
    repeats its kernels').  With ``kernel``, the mean time of one launch
    of the kernels whose name holds it; without, the summed time of all
    kernels per call.  None off the card, when the profiler sees no such
    kernel, or, for the summed time, when it saw fewer or more launches
    of a hand-written kernel than its wrapper counted in those calls (a
    sum that misses launches is no reading; a mean over the launches
    it saw stays one)."""
    if device.type != 'cuda':
        return None
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kyverno_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - an extra reading, not a check
        print(f'chip_smoke: profiler unavailable: {e}', file=sys.stderr)
        return None
    total_us, launches = 0.0, 0
    seen = dict.fromkeys(kernels.KERNEL_SYMBOLS.values(), 0)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or \
                getattr(evt, 'is_user_annotation', False):
            continue
        for symbol in seen:
            if symbol in evt.key:
                seen[symbol] += evt.count
        if kernel in evt.key:
            total_us += evt.self_device_time_total
            launches += evt.count
    missed = {name: (kernels.LAUNCHES[name] - before.get(name, 0),
                     seen[symbol])
              for name, symbol in kernels.KERNEL_SYMBOLS.items()
              if kernels.LAUNCHES[name] - before.get(name, 0) !=
              seen[symbol]}
    if missed and not kernel:
        print(f'chip_smoke: profiler reading dropped, launches counted '
              f'vs seen: {missed}', file=sys.stderr)
        return None
    if total_us <= 0:
        return None
    return total_us / 1e3 / (launches if kernel else reps)


def profiler_launches(fn, device, others: bool = False) -> dict:
    """One call of ``fn`` (a sync request) under torch.profiler: the
    launches of each hand-written kernel its wrapper counted, beside the
    kernel events the profiler recorded under the kernel's symbol
    (``observability/profiling.py kernel_event_counts``, which
    ``deep_profile`` reports when they differ); with ``others``, also
    the device events of everything else (torch's own kernels and
    copies) under ``'others'``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kyverno_tpu_torch.observability.profiling import \
        kernel_event_counts
    from kyverno_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = kernel_event_counts(events, before, dict(kernels.LAUNCHES))
    if others:
        out['others'] = sum(
            e.count for e in events if e.device_type == DeviceType.CUDA and
            not getattr(e, 'is_user_annotation', False) and
            not any(sym in e.key for sym in kernels.KERNEL_SYMBOLS.values()))
    return out


def profiler_probe(vev, packed, program, server, body, device,
                   sessions: int = 2) -> dict:
    """Where torch.profiler sees the hand-written kernels' launches and
    where it does not: ``sessions`` sessions each (``profiler_launches``)
    of one K1v wrapper call, one evaluator call (K1v and K1h), one sync
    /validate/fail request, the last two also with 50 ms of idle time
    before the call or after its ``synchronize``, inside the session;
    and one session each of the evaluator call on a second thread and
    of a request right after a session that records the CPU alone (as
    ``aten_ops``'s).  Each evaluator call is followed by one torch
    kernel (an in-place add), so every session has a device event of
    torch's own beside the hand-written ones.  Per variant: the
    sessions, the launches the wrappers counted, the kernel events the
    profiler recorded for them, the sessions in which it recorded none
    of them, and its device events of everything else (torch's kernels
    and copies) in those sessions and in the others."""
    import threading
    import torch
    from kyverno_tpu_torch.ops import kernels
    layout = program.layout

    def on_thread(fn):
        th = threading.Thread(target=fn)
        th.start()
        th.join()

    def padded(fn, before: float, after: float):
        def call():
            time.sleep(before)
            fn()
            torch.cuda.synchronize()
            time.sleep(after)
        return call

    def tally(fn, n: int) -> dict:
        out = {'sessions': n, 'launches': 0, 'events': 0, 'blind': 0,
               'others_when_blind': 0, 'others_when_seen': 0}
        for _ in range(n):
            recs = profiler_launches(fn, device, others=True)
            others = recs.pop('others')
            seen = sum(r['profiler_events'] for r in recs.values())
            out['launches'] += sum(r['launches'] for r in recs.values())
            out['events'] += seen
            out['blind'] += not seen
            out['others_when_blind' if not seen else
                'others_when_seen'] += others
        return out

    marker = torch.zeros(1, device=device)

    def call():
        out = vev(packed, layout)
        marker.add_(1)
        return out

    def request():
        return server.handle('/validate/fail', body)

    out = {'k1v_wrapper': tally(
        lambda: (kernels.status_vm(packed, program), marker.add_(1)),
        sessions)}
    for name, fn in (('k1_call', call), ('request', request)):
        out[name] = tally(fn, sessions)
        out[f'{name}_idle_before'] = tally(padded(fn, 0.05, 0.0), sessions)
        out[f'{name}_idle_after'] = tally(padded(fn, 0.0, 0.05), sessions)
    out['k1_call_other_thread'] = tally(lambda: on_thread(call), 1)
    aten_ops(call, device)
    out['request_after_cpu_only_session'] = tally(request, 1)
    return out


def sync_error(fn):
    """None when ``fn()`` runs under ``torch.cuda.set_sync_debug_mode(
    'error')`` without an operation that waits for the card, else that
    operation's error."""
    import torch
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('error')
    try:
        fn()
    except RuntimeError as e:
        return str(e)[:500]
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return None


def copies(fn) -> dict:
    """Host-to-device and device-to-host copies one call of ``fn``
    dispatches on this thread (aten ``_to_copy`` and ``copy_`` between
    the CPU and the card, seen by a dispatch mode)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    to_copy = torch.ops.aten._to_copy.default
    copy_ = torch.ops.aten.copy_.default
    n = {'h2d': 0, 'd2h': 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is to_copy or func is copy_:
                src, dst = (args[0], out) if func is to_copy else \
                    (args[1], args[0])
                kinds = (src.device.type, dst.device.type)
                if kinds == ('cpu', 'cuda'):
                    n['h2d'] += 1
                elif kinds == ('cuda', 'cpu'):
                    n['d2h'] += 1
            return out

    with Count():
        fn()
    return n


def request_kernel_ms(fn, reps: int = 5,
                      names=('status_vm', 'fdet_select', 'k3_mutate')):
    """Device milliseconds of the hand-written kernels one call of
    ``fn`` launches, mean over ``reps`` calls: each call of a kernel
    wrapper ``names`` is bracketed by CUDA events on the current stream
    (as ``capture_kernel_inputs`` spies on them), and the events' times
    are summed once the card is synchronized.  Also the wrappers' calls
    per call of ``fn``."""
    import torch
    from kyverno_tpu_torch.ops import kernels
    real = {name: getattr(kernels, name) for name in names}
    marks = []

    def spy(name):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*args)
            end.record()
            marks.append((name, start, end))
            return out
        return call

    for name in names:
        setattr(kernels, name, spy(name))
    try:
        for _ in range(reps):
            fn()
    finally:
        for name, wrapper in real.items():
            setattr(kernels, name, wrapper)
    torch.cuda.synchronize()
    calls = {name: sum(1 for n, _s, _e in marks if n == name) / reps
             for name in names}
    return sum(s.elapsed_time(e) for _n, s, e in marks) / reps, calls


def _host_ms(fn, device, reps: int = 20) -> float:
    """Median host milliseconds of one call of ``fn``: its Python
    dispatch, with the card synchronized before each call."""
    import torch
    times = []
    for _ in range(reps):
        if device.type == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    if device.type == 'cuda':
        torch.cuda.synchronize()
    return sorted(times)[reps // 2]


def _plan_lookup_us(ev, layout, reps: int = 1000) -> float:
    """Mean host microseconds of the evaluator's per-call layout plan
    lookup (a cache hit, keyed by the layout's lane signature)."""
    ev.plan_for(layout)
    t0 = time.perf_counter()
    for _ in range(reps):
        ev.plan_for(layout)
    return (time.perf_counter() - t0) / reps * 1e6


def _random_k1h(call, seed):
    """Seeded K1h inputs at a captured call's shapes and column map:
    statuses 30 % and 90 % FAIL, random details, admission columns and
    fail details, the match lane (nine in ten set) inside a wider byte
    buffer at column 3, and a row-validity lane (one row in eight off)
    at column 1 of another."""
    import torch
    s_u, _d, adm, fdet_u, _m, _rv, src, k = call
    dev = s_u.device
    g = torch.Generator().manual_seed(seed)
    r, u = s_u.shape
    out = []
    for density in (0.3, 0.9):
        fail = torch.rand(r, u, generator=g) < density
        s = torch.where(fail, 1, torch.randint(0, 6, (r, u), generator=g)
                        ).to(torch.int8)
        d = torch.randint(-2, 100, (r, u), generator=g, dtype=torch.int8)
        a = torch.randint(0, 2, tuple(adm.shape), generator=g,
                          dtype=torch.int8)
        fd = torch.randint(-3, 1 << 24, tuple(fdet_u.shape), generator=g,
                           dtype=torch.int32)
        mbuf = torch.randint(0, 256, (r, u + 9), generator=g,
                             dtype=torch.uint8)
        mbuf[:, 3:3 + u] = (torch.rand(r, u, generator=g) < 0.9).to(
            torch.uint8)
        rbuf = torch.randint(-3, 3, (r, 4), generator=g, dtype=torch.int8)
        rbuf[:, 1] = (torch.rand(r, generator=g) < 0.875).to(torch.int8)
        out.append((s.to(dev), d.to(dev), a.to(dev), fd.to(dev),
                    (mbuf.to(dev), 3), (rbuf.to(dev), 1), src, k))
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


def _k1h_bound(call):
    """(ms, 'bytes') of K1h: s_u, d_u and adm read once, the match bytes
    and the row-validity byte of each row, the column map, the fail
    detail of each taken column (and of the fill column of a short
    row), and the output rows written once."""
    import torch
    from kyverno_tpu_torch.ops import kernels
    s_u, _d, adm, _fd, match, rowvalid, src, k = call
    r_n, u = s_u.shape
    n8 = 2 * u + adm.shape[1]
    counts = kernels._fdet_rel(s_u, match, rowvalid, src).sum(dim=1)
    taken = torch.clamp(counts, max=k)
    fill = (counts < k).to(torch.int64)
    nbytes = (r_n * n8 + r_n * u + (r_n if rowvalid is not None else 0) +
              src.numel() * 4 + int((taken + fill).sum()) * 4 +
              r_n * kernels.fdet_row_bytes(n8, k)[0])
    return nbytes / HBM_BYTES_PER_S * 1e3, 'bytes'


def _k1c_bound(str_len, w: int, pattern: bytes):
    """(ms, bound_by) of K1c: the windows, lengths and tags read once,
    two bools written; one compare per literal pattern byte and window
    byte plus one step per pattern byte."""
    n = str_len.numel()
    literal = sum(1 for b in pattern if b not in b'*?')
    t_bytes = (n * w + n * 4 + n + 2 * n) / HBM_BYTES_PER_S
    t_ops = n * (literal * w + len(pattern)) / CUDA_CORE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        'bytes' if t_bytes >= t_ops else 'operations'


def measure_k1h(calls, device, extra=()):
    """K1h on each captured call and on ``extra`` calls against its
    plain version; the time, bound and library time are those of the
    first call."""
    from kyverno_tpu_torch.ops import kernels
    if not calls:
        raise AssertionError('K1h was never called')
    call = calls[0]
    cases = list(calls) + list(extra)
    err = max(_max_abs_err(kernels.fdet_select(*c),
                           kernels.fdet_select_plain(*c)) for c in cases)
    bound_ms, bound_by = _k1h_bound(call)
    s_u, _d, adm, fdet_u, match, rowvalid, src, k = call
    return {
        'max_abs_err': err,
        'ms': _ms(lambda: kernels.fdet_select(*call), device),
        'plain_ms': _ms(lambda: kernels.fdet_select_plain(*call), device),
        'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': _ms(lambda: kernels.fdet_select_library(*call),
                          device),
        'kernel_device_ms': _device_busy_ms(
            lambda: kernels.fdet_select(*call), device,
            'fdet_select_kernel', reps=20),
        'shape': {'rows': s_u.shape[0], 'uniq': s_u.shape[1],
                  'adm_cols': adm.shape[1], 'cols': fdet_u.shape[1],
                  'k': k, 'rowvalid': rowvalid is not None,
                  'match_row_stride': match[0].stride(0),
                  'relevant_cells': int(kernels._fdet_rel(
                      s_u, match, rowvalid, src).sum())},
        'calls': len(calls), 'cases': len(cases)}


def measure_k1c(calls, device, extra=(), patterns=()):
    """K1c on each captured call, on every ``patterns`` over each call's
    windows and on ``extra`` (head, str_len, tag) cases, against its
    plain version; the time and bound are those of the first call."""
    from kyverno_tpu_torch.ops import kernels
    if not calls:
        raise AssertionError('K1c was never called')
    head, str_len, tag, pattern = calls[0]
    cases = list(calls)
    for args in [c[:3] for c in calls] + list(extra):
        cases += [tuple(args) + (p,) for p in patterns]
    err = max(_max_abs_err(kernels.wildcard_match(*c),
                           kernels.wildcard_plain(*c)) for c in cases)
    w = head.shape[-1]
    bound_ms, bound_by = _k1c_bound(str_len, w, pattern)
    return {
        'max_abs_err': err,
        'ms': _ms(lambda: kernels.wildcard_match(head, str_len, tag,
                                                 pattern), device),
        'plain_ms': _ms(lambda: kernels.wildcard_plain(head, str_len, tag,
                                                       pattern), device),
        'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None,
        'kernel_device_ms': _device_busy_ms(
            lambda: kernels.wildcard_match(head, str_len, tag, pattern),
            device, 'wildcard_kernel', reps=20),
        'shape': {'values': str_len.numel(), 'lead': list(str_len.shape),
                  'window': w, 'pattern': pattern.decode('utf-8',
                                                         'replace')},
        'calls': len(calls), 'cases': len(cases)}


def kernel_phase(seen, device, seed):
    """Hold K1v, K1h and K1c against their plain versions on the card at
    the scan's first chunk (K1h and K1c at the inputs the eager walk gave
    them), plus seeded random cases of that shape; returns the
    per-kernel records (launch counts are filled in later)."""
    k1v = measure_k1v(seen['status_vm'], device)
    k1h = measure_k1h(seen['fdet_select'], device, extra=_random_k1h(
        seen['fdet_select'][0], seed) if seen['fdet_select'] else ())
    k1c_calls = seen['wildcard_match']
    extra = []
    if k1c_calls:
        head, str_len = k1c_calls[0][0], k1c_calls[0][1]
        extra = [tuple(a.to(device) for a in _random_k1c(
            tuple(str_len.shape), head.shape[-1], seed + i))
            for i in range(2)]
    real_pattern = [k1c_calls[0][3]] if k1c_calls else []
    k1c = measure_k1c(k1c_calls, device, extra=extra, patterns=real_pattern + [
        b'*', b'?*', b'a?b*', b'*latest', b'?\xc3*', b'*:*:*', b'',
        b'*a*b*:*x?*', b'ab*?:*latest*a', b'?' * 64 + b'*', b'a' * 70])
    for name, rec in (('K1v', k1v), ('K1h', k1h), ('K1c', k1c)):
        if rec['max_abs_err']:
            raise AssertionError(f'{name} differs from its plain version: '
                                 f'{rec["max_abs_err"]}')
    return [
        dict(k1v, name='k1_vm', route='cuda',
             source='kyverno_tpu_torch/csrc/k1_vm.cu',
             replaces='kyverno_tpu/ops/eval.py:1764', launches=0),
        dict(k1h, name='k1h_fdet_select', route='cuda',
             source='kyverno_tpu_torch/csrc/k1h_fdet_select.cu',
             replaces='kyverno_tpu/ops/eval.py:1789', launches=0),
        dict(k1c, name='k1c_wildcard', route='cuda',
             source='kyverno_tpu_torch/csrc/k1c_wildcard.cu',
             replaces='kyverno_tpu/ops/eval.py:275', launches=0)]


# ---------------------------------------------------------------------------
# phase 3: the slice

def row_digests(rows) -> list:
    """sha256 of each report row: its results, without their
    timestamps, and its summary as canonical JSON (the policies' names
    are in the results), so rows of scans stamped at other times
    compare."""
    import hashlib
    return [hashlib.sha256(json.dumps(
        [[{k: v for k, v in res.items() if k != 'timestamp'}
          for res in r[0]], r[1]], sort_keys=True).encode()).digest()
        for r in rows]


def digest_of(digests, n=None) -> str:
    """One sha256 over the first ``n`` row digests (all by default)."""
    import hashlib
    return hashlib.sha256(b''.join(digests[:n])).hexdigest()


def slice_phase(scanner, policies, pods, need=SCAN_KERNELS):
    """The main path over every Pod, then the host-engine check; every
    kernel of ``need`` must have launched.  Returns the record and the
    row digests."""
    from kyverno_tpu_torch.engine.engine import Engine
    from kyverno_tpu_torch.observability import coverage
    from kyverno_tpu_torch.observability import device as devtel
    from kyverno_tpu_torch.observability.metrics import MetricsRegistry
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.smokepack import host_report_results
    n = len(pods)
    chunk = scanner.CHUNK
    last_start = ((n - 1) // chunk) * chunk
    rows = []
    decisions = 0
    coverage.configure(MetricsRegistry())
    reg = devtel.configure(MetricsRegistry())
    cap = devtel.ScanCapture()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with devtel.install_capture(cap):
            for results, summary, _pols in scanner.scan_report_results(
                    pods, now=NOW):
                decisions += len(results)
                rows.append((results, summary))
        wall = time.perf_counter() - t0
    finally:
        devtel.disable()
    # the bytes the d2h stage recorded, and its chunk count
    d2h_bytes = reg.counter_total(devtel.D2H_BYTES)
    d2h_chunks = reg.histogram_count(devtel.SCAN_STAGE_DURATION, stage='d2h')
    launches = dict(kernels.LAUNCHES)
    if len(rows) != n:
        raise AssertionError(f'scan yielded {len(rows)} of {n} rows')
    keep = {i: rows[i] for i in sorted(set(range(min(n, CHECK_HEAD))) |
                                       set(range(last_start, n)))}
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise AssertionError(f'kernels never launched on the scan: '
                             f'{missing}')
    if launches['k1_vm'] != d2h_chunks:
        raise AssertionError(f'K1v launched {launches["k1_vm"]} times for '
                             f'{d2h_chunks} chunks (once per K1 call)')
    t1 = time.perf_counter()
    digests = row_digests(rows)
    digest_s = time.perf_counter() - t1
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
        'd2h_bytes': d2h_bytes, 'd2h_chunks': d2h_chunks,
        'd2h_bytes_per_chunk': d2h_bytes / d2h_chunks,
        'device_decided_frac': cap.coverage_ratio,
        'launches': launches,
        'encoder_pool': {'procs': pool.procs,
                         'up': pool._pool is not None,
                         'broken': pool._broken},
        'checked_rows': len(keep), 'mismatches': len(mismatches),
        'first_mismatches': mismatches[:10], 'check_s': check_s,
        'row_digest': digest_of(digests), 'digest_s': digest_s,
    }, digests


# ---------------------------------------------------------------------------
# phase 4: the multi-device scan on torch.distributed


def init_group(backend: str, store_path: str, rank: int, world: int) -> None:
    """A process group through a file store (no network), bounded by
    ``INIT_TIMEOUT_S``: a rendezvous that never completes fails."""
    import datetime
    import torch.distributed as dist
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))


def _k4_bound(statuses, rowvalid, n_codes: int):
    """(ms, bound_by) of K4h: the statuses and the row mask read once,
    the int64 counts written once; one compare and one add per cell."""
    r, p = statuses.shape
    nbytes = r * p + (r if rowvalid is not None else 0) + p * n_codes * 8
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * r * p / CUDA_CORE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        'bytes' if t_bytes >= t_ops else 'operations'


def _random_k4(seed: int, device, shape=K4_RANDOM, lo: int = -2,
               hi: int = 8):
    """K4h's random case: codes drawn from [lo, hi), 10 % rows invalid."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    r, p = shape
    statuses = rng.integers(lo, hi, (r, p)).astype(np.int8)
    rowvalid = (rng.random(r) >= 0.1).astype(np.uint8)
    return (torch.from_numpy(statuses).to(device),
            torch.from_numpy(rowvalid).to(device))


#: K4h's edge shapes (rows, programs, codes from, to): one program, more
#: programs than one column tile, one row, rows that fill no tile, and
#: 16 x 256 + 1 rows of a single code
K4_EDGES = {'p_1': (1000, 1, -2, 8), 'p_4097': (1000, 4097, -2, 8),
            'rows_1': (1, 13, 0, 6), 'rows_ragged': (16383, 256, -2, 8),
            'one_code': (16 * 256 + 1, 13, 2, 3)}


def measure_k4(statuses, rowvalid, n_codes: int, device) -> dict:
    """K4h on one call's tensors against its plain version: the error,
    the call, device, plain and library times, and the bound."""
    from kyverno_tpu_torch.ops import kernels
    args = (statuses, rowvalid, n_codes)
    err = _max_abs_err(kernels.status_histogram(*args),
                       kernels.status_histogram_plain(*args))
    bound_ms, bound_by = _k4_bound(statuses, rowvalid, n_codes)
    return {
        'shape': {'rows': statuses.shape[0], 'programs': statuses.shape[1],
                  'codes': n_codes, 'masked_rows': 0 if rowvalid is None
                  else int((rowvalid == 0).sum())},
        'max_abs_err': err,
        'ms': _ms(lambda: kernels.status_histogram(*args), device),
        'kernel_device_ms': _device_busy_ms(
            lambda: kernels.status_histogram(*args), device,
            'status_hist_kernel', reps=20),
        'plain_ms': _ms(lambda: kernels.status_histogram_plain(*args),
                        device),
        'library_ms': _ms(lambda: kernels.status_histogram_library(*args),
                          device),
        'bound_ms': bound_ms, 'bound_by': bound_by}


def k4_phase(calls, device, seed) -> dict:
    """K4h against its plain version on the card: every call a step
    made (the first is timed; its row mask is the step's lane inside
    its packed buffer), the random case, P = 0 and R = 0, which must not
    launch, and the edge shapes of ``K4_EDGES``.  Returns the kernel's
    record."""
    import torch
    from kyverno_tpu_torch.compiler.ir import N_STATUS_CODES
    from kyverno_tpu_torch.ops import kernels
    if not calls:
        raise AssertionError('K4h was never called on the mesh step')
    first = measure_k4(*calls[0], device)
    err = max(_max_abs_err(kernels.status_histogram(*c),
                           kernels.status_histogram_plain(*c))
              for c in calls[1:]) if len(calls) > 1 else 0
    cases = {'step': dict(first, calls=len(calls),
                          max_abs_err=max(err, first['max_abs_err'])),
             'random': measure_k4(*_random_k4(seed, device),
                                  N_STATUS_CODES, device)}
    before = kernels.LAUNCHES['k4_status_hist']
    empty = {}
    for name, (r, p) in (('no_programs', (MESH_STEP_ROWS, 0)),
                         ('no_rows', (0, 13))):
        st = torch.zeros((r, p), dtype=torch.int8, device=device)
        rv = torch.ones(r, dtype=torch.uint8, device=device)
        got = kernels.status_histogram(st, rv, N_STATUS_CODES)
        empty[name] = _max_abs_err(got, kernels.status_histogram_plain(
            st, rv, N_STATUS_CODES))
    if kernels.LAUNCHES['k4_status_hist'] != before:
        raise AssertionError('K4h launched on an empty shape')
    cases['empty'] = {'max_abs_err': max(empty.values()), 'cases': empty}
    edges = {}
    for i, (name, (r, p, lo, hi)) in enumerate(K4_EDGES.items()):
        args = _random_k4(seed + i, device, (r, p), lo, hi) + \
            (N_STATUS_CODES,)
        edges[name] = _max_abs_err(kernels.status_histogram(*args),
                                   kernels.status_histogram_plain(*args))
    cases['edges'] = {'max_abs_err': max(edges.values()), 'cases': edges}
    worst = max(c['max_abs_err'] for c in cases.values())
    if worst:
        raise AssertionError(f'K4h differs from its plain version: '
                             f'{ {n: c["max_abs_err"] for n, c in cases.items()} }')
    main = cases['step']
    return dict({k: main[k] for k in AT_SHAPE}, name='k4_status_hist',
                route='cuda', source='kyverno_tpu_torch/csrc/k4_status_hist.cu',
                replaces='kyverno_tpu/parallel/mesh.py:59', launches=0,
                max_abs_err=worst, cases=cases)


def mesh_scan_phase(mesh, scanner, policies, pods, slice_digests) -> dict:
    """(a) ``BatchScanner(mesh=...)`` over ``pods`` (the slice's first
    Pods), held row by row against the slice's digests and against the
    host engine, with the fleet telemetry armed on a fresh registry."""
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    from kyverno_tpu_torch.observability import fleet
    from kyverno_tpu_torch.observability.metrics import MetricsRegistry
    reg = MetricsRegistry()
    fleet.configure(reg, profile_trigger=lambda: None)
    msc = BatchScanner(policies, mesh=mesh)
    # the slice's encode workers were forked before any CUDA context
    # and encode the same compiled set; a pool forked now would not be
    msc._encoder_pool = scanner._encoder_pool
    try:
        rec, digests = slice_phase(msc, policies, pods, need=('k1_vm',))
    finally:
        fleet.disable()
    rec['differing_rows'] = sum(a != b for a, b in zip(digests,
                                                       slice_digests))
    rec['digest_equal'] = digest_of(digests) == \
        digest_of(slice_digests, len(digests))
    mkey = f'data{mesh.world_size}'
    rec['fleet'] = {
        'dispatches': reg.histogram_count(fleet.MESH_STEP_DURATION,
                                          shard=str(mesh.rank)),
        'shard_wall_s': reg.histogram_sum(fleet.MESH_STEP_DURATION,
                                          shard=str(mesh.rank)),
        'collective_s': reg.counter_total(fleet.MESH_COLLECTIVE_SECONDS),
        'padding_rows': reg.counter_total(fleet.MESH_PADDING_ROWS),
        'skew': reg.gauge_value(fleet.MESH_SHARD_SKEW, mesh=mkey)}
    # cross-check of the recorded d2h bytes: every row reads back its
    # program-space statuses, details (int8) and fail details (int32)
    # in full, with no __match__ plane and no compaction
    rec['d2h_bytes_formula'] = len(pods) * len(msc.cps.programs) * (1 + 1 + 4)
    rec['d2h_formula_agrees'] = rec['d2h_bytes'] == rec['d2h_bytes_formula']
    rec['backend'] = mesh.backend
    rec['world_size'] = mesh.world_size
    rec['devices'] = mesh.devices
    if rec['mismatches'] or rec['differing_rows'] or not rec['digest_equal']:
        raise AssertionError(
            f'mesh scan: {rec["differing_rows"]} rows differ from the '
            f'single-device scan, {rec["mismatches"]} from the host engine')
    return rec, digests


def mesh_step_phase(mesh, cps, scanner, pods):
    """(b) ``distributed_scan_step`` over ``MESH_STEPS`` steps of
    ``MESH_STEP_ROWS`` Pods with the K4h wrapper spied on; each summary
    against a numpy histogram of its statuses and the statuses against
    the single-device scanner's.  Returns the record, the steps'
    (statuses, summary) and the K4h calls."""
    import numpy as np
    from kyverno_tpu_torch.compiler.ir import N_STATUS_CODES
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.parallel.mesh import distributed_scan_step
    from kyverno_tpu_torch.ops.eval import build_evaluator
    from kyverno_tpu_torch.parallel import mesh as mesh_mod
    parts = [pods[i * MESH_STEP_ROWS:(i + 1) * MESH_STEP_ROWS]
             for i in range(MESH_STEPS)]
    staged = []
    real_shard = mesh_mod.shard_tensors

    def keep_first(*args, **kwargs):
        out = real_shard(*args, **kwargs)
        if not staged:
            staged.append((_clone(out[0]), out[1]))
        return out

    mesh_mod.shard_tensors = keep_first
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        steps, calls = capture_kernel_inputs(
            lambda: [distributed_scan_step(cps, mesh, part)
                     for part in parts],
            names=('status_histogram',))
    finally:
        mesh_mod.shard_tensors = real_shard
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches['k1_vm'] != MESH_STEPS:
        raise AssertionError(f'K1v launched {launches["k1_vm"]} times in '
                             f'{MESH_STEPS} steps (once per K1 call)')
    # K1v against the eager walk on one step's .raw inputs (program-space
    # statuses, details and fail details); these launches do not count
    ev = build_evaluator(cps, mesh.device)
    raw_err, _vm, _seen, _l = k1v_check(lambda: ev.raw(*staged[0]))
    if raw_err:
        raise AssertionError(f'K1v differs from the eager walk on a mesh '
                             f'step\'s raw inputs: {raw_err}')
    single, _d, _m = scanner.scan_statuses(pods[:MESH_STEPS *
                                                MESH_STEP_ROWS])
    bad = []
    for i, (statuses, summary) in enumerate(steps):
        hist = np.stack([(statuses == c).sum(axis=0, dtype=np.int64)
                         for c in range(N_STATUS_CODES)], axis=1)
        if summary.dtype != np.int64 or not np.array_equal(summary, hist):
            bad.append(f'step {i}: summary is not the statuses\' histogram')
        if not np.array_equal(
                statuses, single[i * MESH_STEP_ROWS:(i + 1) * MESH_STEP_ROWS]):
            bad.append(f'step {i}: statuses differ from the single-device '
                       f'scan')
    if bad:
        raise AssertionError('; '.join(bad))
    rec = {'steps': MESH_STEPS, 'rows_per_step': MESH_STEP_ROWS,
           'wall_s': wall, 'pods_per_s': MESH_STEPS * MESH_STEP_ROWS / wall,
           'launches': launches, 'k1v_raw_max_abs_err': raw_err,
           'summary_total': [int(sm.sum()) for _s, sm in steps]}
    return rec, steps, calls['status_histogram']


def spawn_mesh_children(seed: int, tmp: str) -> list:
    """(c) ``MESH_CHILD_RANKS`` ranks of this script, all on the first
    card, gloo between them, their output in files under ``tmp`` (a
    pipe nobody reads could block a rank); returns each rank's result.
    Fails on a child that fails, outlives ``CHILD_TIMEOUT_S`` or prints
    no result; once one rank fails, the others are killed, since they
    would wait for it in a collective."""
    env = dict(os.environ)
    env.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    env['KTPU_ENCODE_PROCS'] = '2'
    cmd = [sys.executable, os.path.abspath(__file__), '--seed', str(seed),
           '--pods', str(MESH_CHILD_PODS), '--step-rows',
           str(MESH_CHILD_STEP_ROWS), '--store',
           os.path.join(tmp, 'gloo-store'), '--device', 'cuda:0',
           '--mesh-child']
    logs = [(os.path.join(tmp, f'rank{r}.out'),
             os.path.join(tmp, f'rank{r}.err'))
            for r in range(MESH_CHILD_RANKS)]
    procs = []
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        for rank, (out_path, err_path) in enumerate(logs):
            with open(out_path, 'w') as out, open(err_path, 'w') as err:
                procs.append(subprocess.Popen(cmd + [str(rank)], cwd=HERE,
                                              env=env, stdout=out, stderr=err))
        while any(p.poll() is None for p in procs) and \
                not any(p.returncode for p in procs) and \
                time.monotonic() < deadline:
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs, problems = [], []
    for rank, (proc, (out_path, err_path)) in enumerate(zip(procs, logs)):
        with open(out_path) as out, open(err_path) as err:
            lines = [ln for ln in out.read().splitlines()
                     if ln.startswith('mesh_child ')]
            tail = err.read()[-3000:]
        if proc.returncode == -signal.SIGKILL:
            problems.append(f'rank {rank} killed: it outlived '
                            f'{CHILD_TIMEOUT_S} s or a peer failed:\n{tail}')
        elif proc.returncode != 0 or len(lines) != 1:
            problems.append(f'rank {rank} exited {proc.returncode} with '
                            f'{len(lines)} results:\n{tail}')
        else:
            outs.append(json.loads(lines[0][len('mesh_child '):]))
    if problems:
        raise AssertionError('two-rank mesh: ' + '; '.join(problems))
    return outs


def mesh_phase(policies, pods, scanner, slice_digests, device, seed) -> dict:
    """Phase 4: (a) and (b) on an NCCL group of world size 1, then
    (c) in two child processes on the first card.  Kernel
    launches on the mesh path are those of (a) and (b), each counted
    from 0; the comparison launches of K4h come after and do not
    count."""
    import hashlib
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from kyverno_tpu_torch.parallel.mesh import make_mesh
    with tempfile.TemporaryDirectory(prefix='ktpu-mesh-') as tmp:
        t0 = time.perf_counter()
        init_group('nccl', os.path.join(tmp, 'store'), 0, 1)
        try:
            mesh = make_mesh()
            print(f'cut: mesh: scan_report_results over {MESH_CHILD_PODS} '
                  f'of the {len(pods)} Pods (3 chunks + 1)', flush=True)
            scan, digests = mesh_scan_phase(mesh, scanner, policies,
                                            pods[:MESH_CHILD_PODS],
                                            slice_digests)
            scan['seconds'] = time.perf_counter() - t0
            print('mesh ' + json.dumps(scan), flush=True)
            t1 = time.perf_counter()
            step, steps, calls = mesh_step_phase(mesh, scanner.cps,
                                                 scanner, pods)
            launches = {k: scan['launches'][k] + step['launches'][k]
                        for k in scan['launches']}
            k4 = k4_phase(calls, device, seed)
            step['seconds'] = time.perf_counter() - t1
            print('mesh_step ' + json.dumps(dict(step, k4h={
                n: {k: c.get(k) for k in ('shape', 'max_abs_err', 'ms',
                                          'kernel_device_ms', 'plain_ms',
                                          'library_ms', 'bound_ms')}
                for n, c in k4['cases'].items()})), flush=True)
        finally:
            dist.destroy_process_group()
        missing = [k for k in MESH_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f'kernels never launched on the mesh path: '
                                 f'{missing}')
        t2 = time.perf_counter()
        print(f'cut: mesh_2rank: one distributed_scan_step over '
              f'{MESH_CHILD_STEP_ROWS} Pods (2 x {MESH_STEP_ROWS}) and '
              f'scan_report_results over {MESH_CHILD_PODS} of the '
              f'{len(pods)} Pods (3 chunks + 1)', flush=True)
        children = spawn_mesh_children(seed, tmp)
    want_summary = (steps[0][1] + steps[1][1]).tolist()
    want_statuses = hashlib.sha256(np.concatenate(
        [steps[0][0], steps[1][0]]).tobytes()).hexdigest()
    want_digest = digest_of(digests, MESH_CHILD_PODS)
    by_rank = {c['rank']: c for c in children}
    problems = []
    if sorted(by_rank) != [0, 1]:
        problems.append(f'ranks {sorted(by_rank)}')
    for rank, c in sorted(by_rank.items()):
        if c['summary'] != want_summary:
            problems.append(f'rank {rank}: summary differs from the '
                            f'world-size-1 steps')
        if c['statuses'] != want_statuses:
            problems.append(f'rank {rank}: statuses differ')
        if c['row_digest'] != want_digest:
            problems.append(f'rank {rank}: report digest differs from the '
                            f'world-size-1 scan')
        if c['leader'] is not (rank == 0):
            problems.append(f'rank {rank}: leader={c["leader"]}')
        for k in MESH_KERNELS:
            if c['launches'][k] <= 0:
                problems.append(f'rank {rank}: {k} never launched')
        if (c['backend'], c['world_size']) != ('gloo', MESH_CHILD_RANKS):
            problems.append(f'rank {rank}: {c["backend"]} x '
                            f'{c["world_size"]}')
    two = {'children': children, 'seconds': time.perf_counter() - t2,
           'launches': {k: sum(c['launches'][k] for c in children)
                        for k in children[0]['launches']} if children else {},
           'agree': not problems}
    print('mesh_2rank ' + json.dumps(two), flush=True)
    if problems:
        raise AssertionError('two-rank mesh: ' + '; '.join(problems))
    return {'scan': scan, 'step': step, 'two_rank': two, 'k4': k4,
            'launches': launches}


def mesh_child(args) -> int:
    """One rank of phase 4c: its encoder pool forked first, then the
    gloo group, then one step over ``--step-rows`` Pods and the report
    scan over ``--pods`` Pods on this rank's device.  Prints one
    ``mesh_child`` JSON line."""
    import hashlib
    import torch.distributed as dist
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.scan import BatchScanner, _EncoderPool
    from kyverno_tpu_torch.controllers.leaderelection import mesh_is_leader
    from kyverno_tpu_torch.observability import fleet
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.parallel.mesh import (distributed_scan_step,
                                                 make_mesh)
    from kyverno_tpu_torch.device import resolve_device
    t0 = time.perf_counter()
    resolve_device(args.device)    # no card asked for and none there: fail
    policies = smokepack.load_smoke_pack()
    rng = random.Random(args.seed)
    pods = [smokepack.make_config4_pod(rng, i) for i in range(args.pods)]
    pool = _EncoderPool(compile_policies(policies),
                        int(os.environ.get('KTPU_ENCODE_PROCS', '2')))
    pool.start()                    # before any CUDA context or group
    try:
        init_group('gloo', args.store, args.mesh_child, MESH_CHILD_RANKS)
        try:
            mesh = make_mesh(device=args.device)
            kernels.reset_launches()
            t1 = time.perf_counter()
            statuses, summary = distributed_scan_step(
                compile_policies(policies), mesh, pods[:args.step_rows])
            step_s = time.perf_counter() - t1
            msc = BatchScanner(policies, mesh=mesh)
            msc._encoder_pool = pool
            t2 = time.perf_counter()
            rows = [(r, sm) for r, sm, _p in msc.scan_report_results(
                pods, now=NOW)]
            scan_s = time.perf_counter() - t2
            launches = dict(kernels.LAUNCHES)
            result = {
                'rank': mesh.rank, 'world_size': mesh.world_size,
                'backend': mesh.backend, 'device': str(mesh.device),
                'devices': mesh.devices, 'leader': mesh_is_leader(),
                'process_index': fleet.identity()['process_index'],
                'summary': summary.tolist(),
                'summary_dtype': str(summary.dtype),
                'statuses': hashlib.sha256(statuses.tobytes()).hexdigest(),
                'step_rows': len(statuses), 'step_s': step_s,
                'pods': len(rows), 'scan_s': scan_s,
                'pods_per_s': len(rows) / scan_s,
                'row_digest': digest_of(row_digests(rows)),
                'launches': launches,
                'seconds': time.perf_counter() - t0}
        finally:
            dist.destroy_process_group()
    finally:
        pool.close()
    print('mesh_child ' + json.dumps(result), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phases 4 and 5: the mutate kernel (K3) and the mutate chunk


class MutateCounter:
    """Counts what one live ``MutateScanner`` serves: rows dispatched
    through ``scan`` and, from the kernel's own output, the live rows
    whose status has a FALLBACK (the host engine finishes them).  It
    wraps the instance's ``scan`` and kernel; nothing is launched for
    the count."""

    def __init__(self, scanner):
        from kyverno_tpu_torch.mutate.kernel import MUT_FALLBACK
        self.rows = 0
        self.dispatches = 0
        self.fallback_rows = 0
        scan, kernel = scanner.scan, scanner._kernel
        #: the scanner's ``MutateKernel`` and the lanes of its last call
        self.kernel, self.last_lanes = kernel, None

        def counting_scan(resources, *args, **kwargs):
            self.dispatches += 1
            self.rows += len(resources)
            return scan(resources, *args, **kwargs)

        def counting_kernel(lanes):
            self.last_lanes = lanes
            out = kernel(lanes)
            live = lanes['valid']
            self.fallback_rows += int(
                (out[0][live] == MUT_FALLBACK).any(axis=1).sum())
            return out

        scanner.scan = counting_scan
        scanner._kernel = counting_kernel

    def reset(self) -> None:
        self.rows = self.dispatches = self.fallback_rows = 0

    def stats(self) -> dict:
        return {'rows': self.rows, 'dispatches': self.dispatches,
                'fallback_rows': self.fallback_rows,
                'device_decided_rows': self.rows - self.fallback_rows}


def _random_k3(rows: int, seed: int, device, n_rules: int = 8,
               per_rule: int = 32, w: int = 256):
    """Seeded K3 inputs: ``n_rules`` rules of ``per_rule`` sites (bit 31
    set by the 32nd), a ``w``-byte window, numeric constants and lane
    values at the edges of the milli window, byte noise in the string
    windows, every tag and intermediate state, 10 % padding rows.  The
    fault rates leave about half the rules free of FALLBACK, so SKIP,
    PASS and FALLBACK all occur.  Returns the staged lanes, the site
    tables and the host bounds, as ``MutateKernel`` passes them."""
    import numpy as np
    import torch
    from kyverno_tpu_torch.ops import kernels
    rng = np.random.default_rng(seed)
    s = n_rules * per_rule
    imax = np.iinfo(np.int64).max
    edges = np.array([0, 1000, -1000, imax, -imax - 1, 250], np.int64)
    is_num = rng.random(s) < 0.4
    t_milli = np.where(is_num, rng.choice(edges, s), 0).astype(np.int64)
    t_len = np.where(is_num, 0, rng.choice(
        np.array([0, 1, w - 1, w, w + 9]), s)).astype(np.int32)
    t_bytes = rng.integers(1, 256, (s, w)).astype(np.uint8)
    t_bytes[np.arange(w)[None, :] >= np.minimum(t_len, w)[:, None]] = 0
    t_bytes[is_num] = 0
    bounds = tuple(range(0, s + 1, per_rule))
    sites = {'t_is_num': is_num, 't_milli': t_milli, 't_len': t_len,
             't_bytes': t_bytes, 'add_only': rng.random(s) < 0.3,
             'replace': rng.random(s) < 0.03,
             'site_slot': kernels.k3_site_slot(bounds),
             'rule_start': np.asarray(bounds, np.int32)}
    tag = rng.choice(np.array([0, 1, 2, 3, 4, 5, 6, 7, 5, 3], np.int8),
                     (rows, s))
    istate = rng.choice(np.array([0] * 97 + [1, 1, 2], np.int8), (rows, s))
    milli = np.where(rng.random((rows, s)) < 0.6, t_milli[None, :],
                     rng.choice(edges, (rows, s))).astype(np.int64)
    slen = np.where(rng.random((rows, s)) < 0.7, t_len[None, :],
                    t_len[None, :] + rng.integers(-1, 2, (rows, s))
                    ).astype(np.int32)
    sbytes = np.broadcast_to(t_bytes, (rows, s, w)).copy()
    r_i, s_i = np.nonzero(rng.random((rows, s)) < 0.2)
    pos = rng.integers(0, w, len(r_i))
    sbytes[r_i, s_i, pos] ^= rng.integers(1, 256, len(r_i)).astype(np.uint8)
    lanes = {'tag': tag, 'istate': istate, 'milli': milli,
             'milli_ok': rng.random((rows, s)) < 0.97, 'slen': slen,
             'sbytes': sbytes,
             'valid': np.arange(rows) < rows - rows // 10}
    buf, layout = kernels.k3_pack(lanes)
    return ((buf.to(device), layout),
            {k: torch.from_numpy(v).to(device) for k, v in sites.items()},
            bounds)


def _k3_bytes(lanes, sites, bounds) -> dict:
    """K3's bytes.  ``full_pass``: every lane read once, R*S*(15 + w) +
    R, plus R*NR*10 written (status i8, edits i64, reason i8).
    ``needed``: what this run's data needs — tag and istate of every
    cell, milli and milli_ok of present numeric cells under a numeric
    site, slen of present strings under a string site and the w-byte
    window of those whose length matches, ``valid``, and the outputs."""
    from kyverno_tpu_torch.compiler.ir import (TAG_BOOL, TAG_FLOAT, TAG_INT,
                                               TAG_MISSING, TAG_STRING)
    from kyverno_tpu_torch.ops import kernels
    lanes = kernels.k3_unpack(*lanes)
    tag, istate = lanes['tag'], lanes['istate']
    r, s = tag.shape
    w = lanes['sbytes'].shape[2]
    nr = len(bounds) - 1
    out = r * nr * 10
    present = (tag != TAG_MISSING) & (istate != 2)
    is_num = sites['t_is_num']
    num_tag = (tag == TAG_BOOL) | (tag == TAG_INT) | (tag == TAG_FLOAT)
    strings = present & ~is_num & (tag == TAG_STRING)
    windows = strings & (lanes['slen'] == sites['t_len'])
    needed = (r * s * 2 + int((present & is_num & num_tag).sum()) * 9 +
              int(strings.sum()) * 4 + int(windows.sum()) * w + r + out)
    return {'full_pass': r * s * (15 + w) + r + out, 'needed': needed}


def measure_k3(lanes, sites, bounds, device) -> dict:
    """K3 on one call's staged lanes, site tables and host bounds
    against its plain version: the error, the times, the bound of what
    the data needs and that of a full pass."""
    import torch
    from kyverno_tpu_torch.ops import kernels
    got = kernels.k3_mutate(lanes, sites, bounds)
    err = _max_abs_err(got, kernels.k3_mutate_plain(lanes, sites, bounds))
    layout = lanes[1]
    r, s, nr = layout.rows, layout.sites, len(bounds) - 1
    status, edits, _reason = kernels.k3_outputs(got, r, nr)
    nbytes = _k3_bytes(lanes, sites, bounds)
    return {
        'shape': {'rows': r, 'sites': s, 'rules': nr,
                  'window': layout.width, 'staged_bytes': layout.nbytes},
        'max_abs_err': err,
        'status_counts': torch.bincount(
            status.flatten().long(), minlength=3).tolist(),
        'bit31_rows': int(((edits >> 31) & 1).any(dim=1).sum()),
        'ms': _ms(lambda: kernels.k3_mutate(lanes, sites, bounds), device),
        'kernel_device_ms': _device_busy_ms(
            lambda: kernels.k3_mutate(lanes, sites, bounds), device,
            'mutate_kernel', reps=20),
        'plain_ms': _ms(lambda: kernels.k3_mutate_plain(lanes, sites,
                                                        bounds), device),
        'bytes': nbytes,
        'bound_ms': nbytes['needed'] / HBM_BYTES_PER_S * 1e3,
        'full_pass_bound_ms': nbytes['full_pass'] / HBM_BYTES_PER_S * 1e3,
        'bound_by': 'bytes', 'library_ms': None}


def k3_phase(scanner, pods, device, seed):
    """K3 against its plain version on the card: the lanes of one full
    chunk of the mutate pack, seeded random cases (8 rules of 32 sites
    at w = 256 and at w = 8) and no sites."""
    import torch
    from kyverno_tpu_torch.compiler.shapes import canonical_capacity
    from kyverno_tpu_torch.mutate.encode import encode_mutate_batch
    from kyverno_tpu_torch.ops import kernels
    kern = scanner._kernel
    real = encode_mutate_batch(pods, scanner.program,
                               padded_n=canonical_capacity(len(pods)),
                               width=scanner._width)
    r0 = len(real['valid'])
    empty_lanes = {k: v[:, :0] if v.ndim > 1 else v
                   for k, v in real.items()}
    cases = {
        'mutate_chunk': (kern.stage(real), kern.site_tensors(),
                         kern.bounds),
        'random_8x32_w256': _random_k3(r0, seed, device),
        'random_8x32_w8': _random_k3(r0, seed + 1, device, w=8),
        'no_sites': (kern.stage(empty_lanes), {
            't_is_num': torch.zeros(0, dtype=torch.bool, device=device),
            't_milli': torch.zeros(0, dtype=torch.int64, device=device),
            't_len': torch.zeros(0, dtype=torch.int32, device=device),
            't_bytes': torch.zeros((0, kern.width), dtype=torch.uint8,
                                   device=device),
            'add_only': torch.zeros(0, dtype=torch.bool, device=device),
            'replace': torch.zeros(0, dtype=torch.bool, device=device),
            'site_slot': torch.zeros(0, dtype=torch.int32, device=device),
            'rule_start': torch.zeros(kern.n_rules + 1, dtype=torch.int32,
                                      device=device)},
            (0,) * (kern.n_rules + 1)),
    }
    out = {}
    for name, (lanes, sites, bounds) in cases.items():
        out[name] = measure_k3(lanes, sites, bounds, device)
        if out[name]['max_abs_err']:
            raise AssertionError(f'K3 differs from its plain version on '
                                 f'{name}: {out[name]["max_abs_err"]}')
    # the wrapper never reads rule_start back: it refuses a card table
    # without the host bounds
    try:
        kernels.k3_mutate(cases['mutate_chunk'][0], kern.site_tensors())
    except ValueError:
        pass
    else:
        if device.type == 'cuda':
            raise AssertionError('k3_mutate took a card rule_start '
                                 'without its host bounds')
    main = out['mutate_chunk']
    record = {
        'name': 'k3_mutate', 'route': 'cuda',
        'source': 'kyverno_tpu_torch/csrc/k3_mutate.cu',
        'replaces': 'kyverno_tpu/mutate/kernel.py:94',
        'launches': 0, 'max_abs_err': max(c['max_abs_err']
                                          for c in out.values()),
        'ms': main['ms'], 'plain_ms': main['plain_ms'],
        'bound_ms': main['bound_ms'], 'bound_by': 'bytes',
        'library_ms': None,
        'kernel_device_ms': main['kernel_device_ms'],
        'shape': main['shape'],
        'cases': out}
    return record


def mutate_phase(scanner, policies, pods, seed):
    """``MutateScanner.scan`` over one full chunk, then the sample held
    against the host engine's cumulative chain."""
    from kyverno_tpu_torch.engine.engine import Engine
    from kyverno_tpu_torch.observability import coverage
    from kyverno_tpu_torch.observability.metrics import MetricsRegistry
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.smokepack import host_mutate_chain, mutate_row_key
    counter = MutateCounter(scanner)
    ledger = coverage.configure(MetricsRegistry())
    docs = [json.loads(json.dumps(p)) for p in pods]
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = scanner.scan(docs)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches['k3_mutate'] <= 0:
        raise AssertionError('K3 never launched on the mutate chunk')
    engine = Engine()
    sample = random.Random(seed).sample(range(len(pods)), MUTATE_CHECK)
    t1 = time.perf_counter()
    mismatches = [i for i in sample if mutate_row_key(*rows[i]) !=
                  mutate_row_key(*host_mutate_chain(policies, pods[i],
                                                    engine))]
    return dict(counter.stats(), pods=len(pods), wall_s=wall,
                rows_per_s=len(pods) / wall, launches=launches,
                device_cell_share=ledger.totals()['ratio'],
                checked_rows=len(sample), mismatches=len(mismatches),
                first_mismatches=mismatches[:10],
                check_s=time.perf_counter() - t1)


# ---------------------------------------------------------------------------
# phase 6: admission serving through the webhook


def _review(i: int, route: str, obj: dict, rng, user=None) -> bytes:
    """One AdmissionReview: 30 % UPDATEs with an ``oldObject``, 8
    users (or ``user``, a userInfo), the Pod's own namespace (7 of
    them), and Kyverno's default webhook timeout of 10 s."""
    ns = obj['metadata']['namespace']
    req = {'uid': f'{route.strip("/").replace("/", "-")}-{i}',
           'operation': 'CREATE',
           'kind': {'group': '', 'version': 'v1', 'kind': 'Pod'},
           'resource': {'group': '', 'version': 'v1', 'resource': 'pods'},
           'namespace': ns, 'name': obj['metadata']['name'], 'object': obj,
           'userInfo': user or {'username': f'user-{i % 8}',
                                'groups': ['system:authenticated']},
           'timeoutSeconds': 10}
    if rng.random() < 0.3:
        old = json.loads(json.dumps(obj))
        old['metadata'].setdefault('labels', {})['revision'] = 'previous'
        req['operation'] = 'UPDATE'
        req['oldObject'] = old
    return json.dumps({'apiVersion': 'admission.k8s.io/v1',
                       'kind': 'AdmissionReview', 'request': req}).encode()


def _reviews(n: int, seed: int, start: int):
    """``n`` (route, body) pairs, alternating /validate/fail (smoke-pack
    Pods) and /mutate (mutate-pack Pods)."""
    from kyverno_tpu_torch import smokepack
    rng = random.Random(seed)
    out = []
    for j in range(n):
        i = start + j
        if j % 2 == 0:
            route, obj = '/validate/fail', smokepack.make_config4_pod(rng, i)
        else:
            route, obj = '/mutate', smokepack.make_mutate_pod(rng, i)
        out.append((route, _review(i, route, obj, rng)))
    return out


def _restricted_reviews(n: int, seed: int, start: int):
    """``n`` /validate/fail reviews of restricted Pods, each with the
    userInfo of an ``ADMISSIONS`` tuple (every subject, role and
    cluster-role branch of the admission-lanes pack)."""
    from kyverno_tpu_torch import smokepack
    rng = random.Random(seed)
    out = []
    for j in range(n):
        i = start + j
        obj = smokepack.make_restricted_pod(rng, i)
        user = rng.choice(smokepack.ADMISSIONS)[0]['userInfo']
        out.append(('/validate/fail', _review(i, '/validate/fail', obj, rng,
                                              user=user)))
    return out


def _restricted_context():
    """The PolicyContextBuilder of the restricted phase's handlers: the
    roles and cluster roles of each ``ADMISSIONS`` user, standing in for
    the RBAC listers the handler resolves them through, and the
    exclude-group roles of a Kyverno ConfigMap that adds ``dev``."""
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.config.config import Configuration
    from kyverno_tpu_torch.webhooks.admission import PolicyContextBuilder
    table = {info['userInfo']['username']: (info['roles'],
                                            info['clusterRoles'])
             for info, *_rest in smokepack.ADMISSIONS}
    configuration = Configuration()
    configuration.load({'data': {'excludeGroupRole': 'dev'}})
    return PolicyContextBuilder(
        configuration,
        role_resolver=lambda user, groups: table.get(user, ([], [])))


def _pctl(values, q: float) -> float:
    data = sorted(values)
    return data[min(len(data) - 1, int(q * len(data)))] if data else 0.0


def _latency(lat) -> dict:
    out = {}
    for route in sorted({r for r, _ in lat}):
        ms = [t * 1e3 for r, t in lat if r == route]
        out[route] = {'n': len(ms), 'p50_ms': _pctl(ms, 0.50),
                      'p99_ms': _pctl(ms, 0.99), 'max_ms': max(ms)}
    return out


def admission_kernels(server, oracle, reviews, vev, device,
                      mutate=None) -> dict:
    """Each kernel at the admission path's own shapes.  One sync review
    of each route is served with the kernel wrappers spied on; every
    call's card tensors are held against the plain version, and the
    first call of each kernel is timed and bounded.  K1v's call is
    repeated through the validate evaluator ``vev`` with the eager walk
    in its place: out8 and out32 must be bit-equal, and that run gives
    K1c its inputs.  Then one K1 call and one call of the mutate
    kernel (``mutate``, the live scanner's ``MutateCounter``) up to its
    readback run under the sync debug mode, and must not wait for the
    card; the K1 call's aten ops of glue must be 0; and the copies each
    way of one K1 call and of one sync request per route are counted.
    These launches come before the counted passes."""
    from kyverno_tpu_torch.ops import kernels
    seen = {'fdet_select': [], 'status_vm': [], 'k3_mutate': []}
    routes = sorted({r for r, _b in reviews})
    for route in routes:
        body = next(b for r, b in reviews if r == route)
        got, calls = capture_kernel_inputs(
            lambda: server.handle(route, body), names=tuple(seen))
        if got != oracle.handle(route, body):
            raise AssertionError(f'{route}: the captured review differs '
                                 f'from the host loop')
        for name, c in calls.items():
            seen[name].extend(c)
    if '/mutate' in routes and not seen['k3_mutate']:
        raise AssertionError('K3 was never called on /mutate')
    if not seen['status_vm']:
        raise AssertionError('K1v was never called on /validate/fail')
    packed, program = seen['status_vm'][0]
    layout = program.layout
    err, _vm, eager_seen, launched = k1v_check(lambda: vev(packed, layout))
    if err:
        raise AssertionError(f'K1v differs from the eager walk at the '
                             f'admission shape: {err}')
    if not eager_seen['wildcard_match'] or launched['k1c_wildcard'] <= 0:
        raise AssertionError('K1c never launched in the eager walk')
    out = {'k1_vm': measure_k1v(seen['status_vm'], device),
           'k1h_fdet_select': measure_k1h(
               seen['fdet_select'], device,
               extra=_random_k1h(seen['fdet_select'][0], len(reviews))),
           'k1c_wildcard': measure_k1c(eager_seen['wildcard_match'], device)}
    if seen['k3_mutate']:
        k3 = [measure_k3(*c, device) for c in seen['k3_mutate']]
        out['k3_mutate'] = dict(k3[0], calls=len(k3), max_abs_err=max(
            c['max_abs_err'] for c in k3))
    bad = {n: r['max_abs_err'] for n, r in out.items() if r['max_abs_err']}
    if bad:
        raise AssertionError(f'kernels differ from their plain versions at '
                             f'the admission shapes: {bad}')
    host_ms = _host_ms(lambda: vev(packed, layout), device)
    with eager_walk():
        t0 = time.perf_counter()
        vev(packed, layout)
        eager_ms = (time.perf_counter() - t0) * 1e3
        eager_aten = aten_ops(lambda: vev(packed, layout), device)
    body = next(b for r, b in reviews if r == '/validate/fail')
    # neither wrapper waits for the card: one K1 call, and one
    # MutateKernel call up to its readback, under the sync debug mode
    sync = {'k1_call': sync_error(lambda: vev(packed, layout))}
    if mutate is not None and mutate.last_lanes is not None:
        kern, lanes = mutate.kernel, mutate.last_lanes
        sync['mutate_kernel_call'] = sync_error(lambda: kernels.k3_mutate(
            kern.stage(lanes), kern.site_tensors(), kern.bounds))
    out['k1_call'] = {
        'profiler_k1v': profiler_probe(vev, packed, program, server, body,
                                       device),
        'rows': next(iter(packed.values())).shape[0],
        'k1v_check': {'max_abs_err': err, 'capture_launches': launched},
        'host_dispatch_ms': host_ms,
        'plan_lookup_us': _plan_lookup_us(vev, layout),
        'aten_ops': aten_ops(lambda: vev(packed, layout), device),
        'copies': {'k1_call_and_readback': copies(
            lambda: vev(packed, layout).host())},
        'sync_debug': sync,
        'eager_walk': {'host_dispatch_ms': eager_ms,
                       'aten_ops': eager_aten},
        'routes': {str(j): list(r) for j, r in vev.routes.items()}}
    for route in routes:
        body = next(b for r, b in reviews if r == route)
        out['k1_call']['copies'][route] = copies(
            lambda: server.handle(route, body))
    synced = {k: v for k, v in sync.items() if v is not None}
    if synced:
        raise AssertionError(f'kernel wrappers synchronized with the '
                             f'card: {synced}')
    glue = out['k1_call']['aten_ops']['by_part']['glue']
    if glue:
        raise AssertionError(f'{glue} aten ops of glue per K1 call at the '
                             f'admission shape (must be 0)')
    return out


def admission_phase(seed: int, restricted: bool = False) -> dict:
    """The admission webhook on the card against a host-loop handler.

    By default the smoke pack in Enforce and the mutate pack, over
    alternating /validate/fail and /mutate reviews; with ``restricted``
    the restricted configuration (``smokepack.load_restricted_pack``) in
    Enforce over /validate/fail reviews of restricted Pods from the
    ``ADMISSIONS`` users, both handlers resolving their roles through
    ``_restricted_context``.  Fails on any response-byte mismatch, any
    ``host_fallback`` decision, any breaker failure or a breaker left
    open, a sync-pass decision not served on ``sync``, under 99 % of
    batch-pass validate decisions on ``batch``, under 99 % of /mutate
    reviews dispatched through the mutate scanner, a program routed to
    the eager walk, and a kernel of the path never launched."""
    import threading
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.observability import provenance
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.policycache import cache as pcache
    from kyverno_tpu_torch.policycache.cache import Cache
    from kyverno_tpu_torch.serving import breaker
    from kyverno_tpu_torch.webhooks.handlers import ResourceHandlers
    from kyverno_tpu_torch.webhooks.server import WebhookServer

    cache = Cache()
    if restricted:
        cache.warm_up(smokepack.load_restricted_pack('Enforce'))
        builder = _restricted_context()
        handlers = ResourceHandlers(cache, serving_mode='sync',
                                    pc_builder=builder)
        oracle = WebhookServer(ResourceHandlers(cache, device=False,
                                                pc_builder=builder))
        need = ('k1_vm', 'k1h_fdet_select')
    else:
        cache.warm_up(smokepack.load_smoke_pack('Enforce') +
                      smokepack.load_mutate_pack())
        handlers = ResourceHandlers(cache, serving_mode='sync')  # the card
        oracle = WebhookServer(ResourceHandlers(cache, device=False))
        need = ADMISSION_KERNELS
    server = WebhookServer(handlers)
    validate = cache.get_policies(pcache.VALIDATE_ENFORCE, 'Pod', 'ns-0')
    mutate = cache.get_policies(pcache.MUTATE, 'Pod', 'ns-0')
    t0 = time.perf_counter()
    if not handlers.wait_device_ready(validate, timeout=READY_S):
        raise AssertionError('the validate scanner did not come up')
    counter = None
    if mutate:
        msc = None
        while msc is None and time.perf_counter() - t0 < READY_S:
            msc = handlers._device_scanner(mutate, kind='mutate')
            time.sleep(0.02)
        if msc is None or not msc.ok:
            raise AssertionError(f'the mutate scanner did not come up: '
                                 f'{msc}')
        counter = MutateCounter(msc)
    ready_s = time.perf_counter() - t0
    vev = handlers._device_scanner(validate)._evaluator
    eager = {j: r for j, r in vev.routes.items() if r[0] != 'vm'}
    if eager:
        raise AssertionError(f'admission pack programs on the eager walk: '
                             f'{eager}')
    failures = []
    record_failure = handlers._record_key_failure

    def counting_failure(key, policies, reason):
        failures.append(reason)
        return record_failure(key, policies, reason)

    handlers._record_key_failure = counting_failure
    flight = os.path.join(HERE, 'chiprun_out', 'flight')
    report = {'ready_s': ready_s, 'policies': {
        'validate': len(validate), 'mutate': len(mutate)},
        'adm_cols': vev.n_adm}
    launches = {}

    def drive(reviews, clients):
        """Serve ``reviews`` from ``clients`` threads; returns the
        responses, per-request (route, seconds) and the wall time."""
        got = [None] * len(reviews)
        lat = [None] * len(reviews)
        errors = []

        def client(c):
            try:
                for j in range(c, len(reviews), clients):
                    route, body = reviews[j]
                    t = time.perf_counter()
                    got[j] = server.handle(route, body)
                    lat[j] = (route, time.perf_counter() - t)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise AssertionError(f'webhook raised: {errors[:3]}')
        return got, lat, time.perf_counter() - t

    def run_pass(name, reviews, clients, check):
        rec = provenance.configure(flight_n=len(reviews), dump_dir=flight)
        if counter is not None:
            counter.reset()
        kernels.reset_launches()
        got, lat, wall = drive(reviews, clients)
        launches[name] = dict(kernels.LAUNCHES)
        paths = rec.stats()['by_path']
        provenance.disable()
        t = time.perf_counter()
        mismatches = [j for j in check
                      if got[j] != oracle.handle(*reviews[j])]
        n_val = sum(1 for r, _ in reviews if r == '/validate/fail')
        n_mut = len(reviews) - n_val
        out = {'reviews': len(reviews), 'clients': clients,
               'wall_s': wall, 'requests_per_s': len(reviews) / wall,
               'latency': _latency(lat), 'validate_paths': paths,
               'validate_decisions': n_val, 'mutate_reviews': n_mut,
               'launches': launches[name], 'checked': len(check),
               'mismatches': len(mismatches),
               'first_mismatches': mismatches[:10],
               'check_s': time.perf_counter() - t}
        if counter is not None:
            out.update(mutate=counter.stats(),
                       mutate_dispatched_frac=counter.rows / max(n_mut, 1))
        return out

    try:
        if restricted:
            sync = _restricted_reviews(SYNC_REVIEWS, seed, 0)
        else:
            sync = _reviews(2 * SYNC_REVIEWS, seed, 0)
        report['kernels_at_admission'] = admission_kernels(
            server, oracle, sync, vev, handlers.torch_device, counter)
        report['sync'] = run_pass('sync', sync, 1, range(len(sync)))
        # the card's share of one sync request: the device time of the
        # kernels it launched (CUDA events around each wrapper call)
        # against the request's latency
        for route in sorted({r for r, _b in sync}):
            body = next(b for r, b in sync if r == route)
            busy, calls = request_kernel_ms(
                lambda: server.handle(route, body))
            p50 = report['sync']['latency'][route]['p50_ms']
            report['sync']['latency'][route].update(
                device_busy_ms=busy, kernel_calls=calls,
                device_idle_share=1 - busy / p50)
        handlers.serving_mode = 'batch'
        if restricted:
            batch = _restricted_reviews(BATCH_REVIEWS, seed + 1, len(sync))
        else:
            batch = _reviews(BATCH_REVIEWS, seed + 1, len(sync))
        sample = sorted(random.Random(seed).sample(range(len(batch)),
                                                   BATCH_ORACLE))
        report['batch'] = run_pass('batch', batch, BATCH_CLIENTS, sample)
        report['batcher'] = handlers._get_batcher().stats()
    finally:
        handlers.shutdown()
    report['breaker_failures'] = failures
    report['breakers'] = handlers._breakers.report()
    open_keys = [k for k in [handlers._policy_key(validate)] +
                 ([handlers._policy_key(mutate)] if mutate else [])
                 if handlers._breakers.state(k) != breaker.CLOSED]
    report['launches'] = {k: sum(launches[p][k] for p in launches)
                          for k in need}

    sp, bp = report['sync'], report['batch']
    problems = []
    for name, p in (('sync', sp), ('batch', bp)):
        if p['mismatches']:
            problems.append(f'{name}: {p["mismatches"]} responses differ '
                            f'from the host loop: {p["first_mismatches"]}')
        if p['validate_paths'].get('host_fallback'):
            problems.append(f'{name}: host_fallback decisions '
                            f'{p["validate_paths"]}')
        if counter is not None and p['mutate_dispatched_frac'] < 0.99:
            problems.append(f'{name}: only {p["mutate"]["rows"]} of '
                            f'{p["mutate_reviews"]} /mutate reviews went '
                            f'through the mutate scanner')
    if sp['validate_paths'] != {'sync': sp['validate_decisions']}:
        problems.append(f'sync pass paths {sp["validate_paths"]}')
    on_batch = bp['validate_paths'].get('batch', 0)
    if on_batch < 0.99 * bp['validate_decisions']:
        problems.append(f'batch pass: {on_batch} of '
                        f'{bp["validate_decisions"]} validate decisions '
                        f'on batch: {bp["validate_paths"]}')
    if failures or open_keys:
        problems.append(f'breaker failures {failures[:3]}, open keys '
                        f'{len(open_keys)}')
    missing = [k for k, v in report['launches'].items() if v <= 0]
    if missing:
        problems.append(f'kernels never launched on the admission path: '
                        f'{missing}')
    if report['launches']['k1_vm'] != report['launches']['k1h_fdet_select']:
        problems.append(f'K1v and K1h launched {report["launches"]} times: '
                        f'each runs once per K1 call')
    report['problems'] = problems
    return report


def measure_k1i(ev, packed, program, device) -> dict:
    """K1i's plain version, ``_adm_match_graph`` (the torch ops that
    K1v's admission entries replace), on the chunk's admission lanes on
    the card and on their first 64 rows (the admission shape), with
    the evaluator's device constants cached as in a call: milliseconds
    per call (CUDA events over 20 calls), host dispatch and aten ops,
    against the bound of the function: the lanes read once and the
    int8 columns written once, over the card's memory rate."""
    from kyverno_tpu_torch.ops import eval as k1
    lanes = ev.plan_for(program.layout).lanes(packed)
    adm = {name: lanes[name] for name in k1.ADM_LANES}
    rows = next(iter(adm.values())).shape[0]
    out = {}
    token = k1._CONSTS.set({})
    try:
        for label, n in (('chunk', rows), ('admission', 64)):
            sub = {name: lane[:n] for name, lane in adm.items()}

            def call(sub=sub):
                return k1._adm_match_graph(ev.adm_table, sub)

            nbytes = sum(t.numel() * t.element_size()
                         for t in sub.values()) + n * ev.n_adm
            out[label] = {'rows': n, 'ms': _ms(call, device),
                          'host_dispatch_ms': _host_ms(call, device),
                          'aten_ops': aten_ops(call, device)['total'],
                          'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3,
                          'bound_by': 'bytes'}
    finally:
        k1._CONSTS.reset(token)
    return out


def measure_foreach_trees(pods, device, chunk: int) -> dict:
    """The restricted chart's two ``foreach`` trees alone: an evaluator
    of ``RESTRICTED_FOREACH_PACK`` on the card over the first ``chunk``
    of ``pods`` and over its first 64 Pods (the admission shape), K1v
    against its plain version (the eager walk) on the same card
    tensors: the error, both times (CUDA events) and K1v's bound."""
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.api.policy import load_policies_from_yaml
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.ops.eval import build_evaluator, shard_batch
    cps = compile_policies(load_policies_from_yaml(
        smokepack.RESTRICTED_FOREACH_PACK))
    ev = build_evaluator(cps, device)
    out = {}
    for label, n in (('chunk', chunk), ('admission', 64)):
        packed, layout = shard_batch(encode_batch(
            pods[:n], cps, padded_n=n).tensors(), device)
        program = ev.plan_for(layout).program
        bound_ms, bound_by = _k1v_bound(program, n)
        out[label] = {
            'rows': n, 'plan': k1v_plan(program, n),
            'row_insns': program.row_insns,
            'executed_row_insns': kernels.status_vm_executed(
                packed, program) / n,
            'max_abs_err': _max_abs_err(kernels.status_vm(packed, program),
                                        program.plain(packed)),
            'ms': _ms(lambda: kernels.status_vm(packed, program), device),
            'plain_ms': _ms(lambda: program.plain(packed), device, reps=3),
            'bound_ms': bound_ms, 'bound_by': bound_by}
    return out


def restricted_phase(scanner, policies, pods, device, seed) -> dict:
    """Phase 8: the restricted configuration (the smoke pack, the
    restricted chart's ``foreach`` capability policies and the
    admission-lanes pack) on the card.  Every program must be routed to
    K1v.  K1v is held bit-equal to its plain version (the eager walk and
    ``_adm_match_graph``) on the first chunk with the admission lanes of
    ``ADMISSIONS`` tuples, and ``_adm_match_graph`` must not run on the
    card; then the scan over every Pod, checked against the host engine,
    and the admission webhook (``admission_phase(restricted=True)``)."""
    from kyverno_tpu_torch import smokepack
    eager = {j: r for j, r in scanner._evaluator.routes.items()
             if r[0] != 'vm'}
    if eager:
        raise AssertionError(f'restricted programs on the eager walk: '
                             f'{eager}')
    adm_rows = [smokepack.ADMISSIONS[i % len(smokepack.ADMISSIONS)]
                for i in range(scanner.CHUNK)]
    seen, chunk = first_chunk_inputs(scanner, pods, device,
                                     adm_rows=adm_rows)
    k1v = measure_k1v(seen['status_vm'], device)
    if k1v['max_abs_err']:
        raise AssertionError(f'K1v differs from its plain version on the '
                             f'restricted chunk: {k1v["max_abs_err"]}')
    k1i_card = chunk['aten_ops']['by_part']['k1i_adm_match']
    k1i_eager = chunk['eager_walk']['aten_ops']['by_part']['k1i_adm_match']
    if k1i_card or not k1i_eager:
        raise AssertionError(f'K1i aten ops: {k1i_card} with K1v (must be '
                             f'0), {k1i_eager} in the plain version')
    packed, program = seen['status_vm'][0]
    k1i = measure_k1i(scanner._evaluator, packed, program, device)
    trees = measure_foreach_trees(pods, device, scanner.CHUNK)
    if any(r['max_abs_err'] for r in trees.values()):
        raise AssertionError(f'K1v differs from the eager walk on the '
                             f'foreach trees: {trees}')
    print('restricted_chunk ' + json.dumps(dict(
        {k: chunk[k] for k in ('rows', 'host_dispatch_ms',
                               'device_span_ms', 'k1v_check', 'aten_ops',
                               'eager_walk', 'routes')},
        k1v={k: k1v[k] for k in ('max_abs_err', 'ms', 'kernel_device_ms',
                                 'global_mode_ms', 'plain_ms', 'bound_ms',
                                 'bound_by', 'plan', 'shape')},
        adm_cols=program.n_adm, k1i_plain=k1i, foreach_trees=trees)),
        flush=True)
    sl, _digests = slice_phase(scanner, policies, pods)
    print('restricted_slice ' + json.dumps(sl), flush=True)
    if sl['mismatches']:
        raise AssertionError(f'{sl["mismatches"]} restricted rows differ '
                             f'from the host engine: '
                             f'{sl["first_mismatches"]}')
    adm = admission_phase(seed, restricted=True)
    print('restricted_admission ' + json.dumps(adm), flush=True)
    if adm['problems']:
        raise AssertionError('restricted admission: ' +
                             '; '.join(adm['problems']))
    k1i_64 = adm['kernels_at_admission']['k1_call']['aten_ops'][
        'by_part']['k1i_adm_match']
    if k1i_64:
        raise AssertionError(f'K1i ran {k1i_64} aten ops at the admission '
                             f'shape with K1v')
    return {'chunk': chunk, 'k1v_chunk': k1v, 'k1i_plain': k1i,
            'foreach_trees': trees, 'slice': sl, 'admission': adm}


# ---------------------------------------------------------------------------
# phase 9: the reports-controller daemon (cmd/reports_controller.py)

#: the ClusterPolicy whose rule message the edit tick changes (a
#: partition of its own under KTPU_PARTITIONS=4)
REPORTS_EDIT = 'require-resources'
REPORTS_PODS = 16384 + 1        # one chunk + 1: a tick crosses a boundary
REPORTS_PARTITIONS = 4          # KTPU_PARTITIONS of the partitioned ticks
REPORTS_CHECK = 1000            # edit-tick rows held against the host engine
REPORTS_CHILD_TIMEOUT_S = 900  # the partitioned ticks' process


def reports_cluster(policies, pods):
    """A ``FakeClient`` holding ``policies`` as ClusterPolicies and the
    Pods; returns it and the Pods as the client stored them (with the
    uid and resourceVersion it gave each), in order."""
    from kyverno_tpu_torch.dclient.client import FakeClient
    client = FakeClient()
    for p in policies:
        client.create_resource('kyverno.io/v1', 'ClusterPolicy', '', p.raw)
    docs = [client.create_resource('v1', 'Pod', pod['metadata']['namespace'],
                                   pod) for pod in pods]
    return client, docs


def edit_policy(client, name: str) -> None:
    """Change the message of ``name``'s first rule through the client."""
    pol = client.get_resource('kyverno.io/v1', 'ClusterPolicy', '', name)
    rule = pol['spec']['rules'][0]
    rule['validate']['message'] += ' (edited)'
    client.update_resource('kyverno.io/v1', 'ClusterPolicy', '', pol)


def _timed_parts(daemon, written: list) -> dict:
    """Wrap the daemon's four sub-controller passes with wall clocks,
    and keep the reports the scan controller's pass returns (each as
    the client stored it) in ``written``; returns the dict each tick's
    seconds accumulate into."""
    parts = {}
    for key, obj, meth in (
            ('sync', daemon.resource_controller, 'sync'),
            ('reconcile', daemon.scan_controller, 'reconcile'),
            ('admission', daemon.admission_controller, 'reconcile'),
            ('aggregate', daemon.aggregate_controller, 'reconcile')):
        fn = getattr(obj, meth)

        def timed(*a, _fn=fn, _key=key, **k):
            t0 = time.perf_counter()
            try:
                out = _fn(*a, **k)
            finally:
                parts[_key] = parts.get(_key, 0.0) + \
                    time.perf_counter() - t0
            if _key == 'reconcile':
                written.extend(out)
            return out
        setattr(obj, meth, timed)
    return parts


def _dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(root) for f in files)


def reports_tick(daemon, parts, vc_dir) -> dict:
    """One ``ReportsController.tick()``: its wall and Pods/s (the rows
    it demanded), the seconds of each sub-controller pass and of each
    scan stage, each kernel's launches, the rescan stats, the partition
    counters, the verdict cache's bytes on disk and the encoder pool."""
    from kyverno_tpu_torch.observability import device as devtel
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.partition.runtime import (
        PARTITION_FALLBACKS, PARTITION_RECOMPILES, PARTITION_REUSES)
    reg = global_registry()

    def stage_sums():
        return {dict(key).get('stage', ''): total for key, _n, total in
                reg.histogram_series(devtel.SCAN_STAGE_DURATION)}

    def counters():
        return {'recompiles': reg.counter_value(PARTITION_RECOMPILES),
                'reuses': reg.counter_value(PARTITION_REUSES),
                'fallbacks': reg.counter_value(PARTITION_FALLBACKS)}

    stages0, counters0 = stage_sums(), counters()
    parts.clear()
    kernels.reset_launches()
    t0 = time.perf_counter()
    daemon.tick()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stages1, counters1 = stage_sums(), counters()
    stats = dict(daemon.scan_controller.rescan_stats)
    pool = daemon.scan_controller.scanner._encoder_pool
    return {
        'wall_s': wall, 'pods_per_s': stats['rows_pending'] / wall,
        'parts_s': dict(parts),
        'stage_s': {k: v - stages0.get(k, 0.0)
                    for k, v in sorted(stages1.items())
                    if v - stages0.get(k, 0.0) > 0},
        'launches': {k: v for k, v in launches.items() if v},
        'rescan': stats,
        'partition': {k: counters1[k] - counters0[k] for k in counters1},
        'verdict_cache_bytes': _dir_bytes(vc_dir),
        'encoder_pool': {'procs': pool.procs, 'up': pool._pool is not None,
                         'broken': pool._broken},
    }


class _Ticks:
    """What the ticks of one daemon share: the Pods as its client
    stored them, the problems found, and the checks that add to them."""

    def __init__(self, policies, pods, vc_dir):
        from kyverno_tpu_torch.cmd.internal import Setup
        from kyverno_tpu_torch.cmd.reports_controller import \
            ReportsController
        os.environ['KTPU_VERDICT_CACHE_DIR'] = vc_dir
        self.vc_dir = vc_dir
        self.problems = []
        t0 = time.perf_counter()
        self.client, self.docs = reports_cluster(policies, pods)
        self.daemon = ReportsController(Setup(
            'kyverno-reports-controller', [], client=self.client))
        self.written = []
        self.parts = _timed_parts(self.daemon, self.written)
        self.setup_s = time.perf_counter() - t0

    def tick(self, name: str, edit: bool = False) -> dict:
        if edit:
            edit_policy(self.client, REPORTS_EDIT)
        self.written.clear()
        tick = reports_tick(self.daemon, self.parts, self.vc_dir)
        tick['name'] = name
        return tick

    def rows(self, tick):
        """Per Pod, in order, the ``(results, summary)`` of the report
        the tick wrote for it (named by the Pod's uid; None where it
        wrote none), and the rows' digests."""
        t0 = time.perf_counter()
        by_name = {r['metadata']['name']: r for r in self.written}
        rows = [None if r is None else
                (r['spec']['results'], r['spec']['summary'])
                for r in (by_name.get(d['metadata']['uid'])
                          for d in self.docs)]
        missing = sum(r is None for r in rows)
        if missing:
            self.problems.append(f'{tick["name"]}: {missing} Pods without '
                                 f'a report')
        digests = row_digests([r or ([], {}) for r in rows])
        tick['read_s'] = time.perf_counter() - t0
        return rows, digests

    def host_check(self, tick, rows, policies, idx) -> None:
        """Rows ``idx`` against the host engine's under ``policies``."""
        from kyverno_tpu_torch.engine.engine import Engine
        from kyverno_tpu_torch.smokepack import host_report_results
        engine = Engine()
        t0 = time.perf_counter()
        bad = [i for i in idx if rows[i] is None or
               row_digests([rows[i]]) != row_digests(
                   [host_report_results(policies, self.docs[i], NOW,
                                        engine)])]
        if bad:
            self.problems.append(f'{tick["name"]}: {len(bad)} of '
                                 f'{len(idx)} rows differ from the host '
                                 f'engine: {bad[:10]}')
        tick['vs_host'] = {'rows': len(idx), 'mismatches': len(bad),
                           'check_s': time.perf_counter() - t0}

    def expect(self, tick, n: int, k1_calls: int, replayed: int = 0,
               scoped: int = 0) -> None:
        """Every one of ``n`` Pods demanded, ``replayed`` of them from
        the verdict cache and ``scoped`` on the scoped path, and K1v and
        K1h launched ``k1_calls`` times per chunk of the rows the tick
        scanned."""
        st = tick['rescan']
        if st['rows_pending'] != n or st['rows_replayed'] != replayed or \
                st.get('rows_scoped', 0) != scoped:
            self.problems.append(f'{tick["name"]}: rescan stats {st} '
                                 f'(pending {n}, replayed {replayed}, '
                                 f'scoped {scoped} expected)')
        chunks = -(-st['rows_scanned'] //
                   self.daemon.scan_controller.scanner.CHUNK)
        for k in SCAN_KERNELS:
            got = tick['launches'].get(k, 0)
            if got != k1_calls * chunks:
                self.problems.append(
                    f'{tick["name"]}: {k} launched {got} times for {chunks} '
                    f'chunks x {k1_calls} (once per K1 call)')


def same_rows(digests, want, name: str, problems: list) -> dict:
    """Rows of two runs over the same Pods, by digest."""
    k = min(len(digests), len(want))
    diff = [i for i in range(k) if digests[i] != want[i]]
    if diff:
        problems.append(f'{name}: {len(diff)} of {k} rows differ: '
                        f'{diff[:10]}')
    return {'rows': k, 'mismatches': len(diff)}


def whole_ticks(policies, pods, slice_digests, vc_dir):
    """Phase 9a: the daemon with the whole policy set
    (``KTPU_PARTITIONS=0``) over every Pod: the cold tick, a replay of
    every row, and the edit tick.  Returns the record, the problems, and
    the cold and edit ticks' row digests."""
    os.environ['KTPU_PARTITIONS'] = '0'
    t = _Ticks(policies, pods, vc_dir)
    n = len(pods)
    sc = t.daemon.scan_controller
    cold = t.tick('cold')
    t.expect(cold, n, 1)
    if cold['encoder_pool']['broken'] or not cold['encoder_pool']['up']:
        t.problems.append(f'cold: the encoder pool is not serving: '
                          f'{cold["encoder_pool"]}')
    rows, cold_d = t.rows(cold)
    if slice_digests is not None:
        cold['vs_slice'] = same_rows(cold_d, slice_digests, 'cold vs slice',
                                     t.problems)
    last = ((n - 1) // sc.scanner.CHUNK) * sc.scanner.CHUNK
    t.host_check(cold, rows, policies,
                 sorted(set(range(min(n, CHECK_HEAD))) | set(range(last, n))))
    del rows
    sc.reset_scan_state()
    sc.enqueue_all()
    replay = t.tick('replay')
    t.expect(replay, n, 1, replayed=n)
    _rows, replay_d = t.rows(replay)
    replay['vs_cold'] = same_rows(replay_d, cold_d, 'replay vs cold',
                                  t.problems)
    del _rows
    generation = sc.verdict_cache.fingerprint
    edit = t.tick('edit', edit=True)
    t.expect(edit, n, 1)
    edit['new_generation'] = sc.verdict_cache.fingerprint != generation
    if not edit['new_generation']:
        t.problems.append('edit: the verdict cache kept its generation')
    rows, edit_d = t.rows(edit)
    t.host_check(edit, rows, sc.policies,
                 list(range(0, n, max(1, n // REPORTS_CHECK))))
    sc.scanner._encoder_pool.close()
    t.daemon.setup.shutdown()
    return ({'pods': n, 'setup_s': t.setup_s, 'cold': cold,
             'replay': replay, 'edit': edit}, t.problems, cold_d, edit_d)


def partitioned_ticks(policies, pods, vc_dir):
    """Phase 9b: the daemon with ``KTPU_PARTITIONS=4``: the cold tick
    and the edit tick, then the executable ledger — one record per
    (partition, layout) under the partition's fingerprint and none for
    the whole-set evaluator — and the partition census.  Returns the
    record, the problems and the two ticks' row digests."""
    from kyverno_tpu_torch.observability import executables
    from kyverno_tpu_torch.partition import census
    os.environ['KTPU_PARTITIONS'] = str(REPORTS_PARTITIONS)
    t = _Ticks(policies, pods, vc_dir)
    n = len(pods)
    sc = t.daemon.scan_controller
    cold = t.tick('partitioned cold')
    if sc.scanner._pset is None:
        raise AssertionError('partitioned: the scanner fell back to the '
                             'whole set')
    runtimes = sc.scanner._pset.runtimes
    t.expect(cold, n, len(runtimes))
    if cold['partition']['fallbacks']:
        t.problems.append(f'partitioned cold: {cold["partition"]}')
    _rows, cold_d = t.rows(cold)
    del _rows
    edit = t.tick('partitioned edit', edit=True)
    t.expect(edit, n, 1, scoped=n)
    if edit['partition']['recompiles'] != 1 or \
            edit['partition']['fallbacks']:
        t.problems.append(f'partitioned edit: {edit["partition"]} (1 '
                          f'recompile expected)')
    _rows, edit_d = t.rows(edit)
    del _rows
    by_fp = {}
    for rec in executables.ledger().records():
        by_fp.setdefault(rec.fingerprint, []).append(rec)
    ledger = []
    for rt in sc.scanner._pset.runtimes:
        ev = rt.evaluator
        want = sum(p.program is not None for p in ev.plans.values())
        got = by_fp.get(ev.fingerprint, [])
        ledger.append({'partition': rt.part.pid, 'layouts': want,
                       'records': len(got),
                       'dispatches': sum(r.dispatches for r in got)})
        if len(got) != want or not want:
            t.problems.append(f'ledger: partition {rt.part.pid} has '
                              f'{len(got)} records for {want} layouts')
    if sc.scanner._evaluator.fingerprint in by_fp:
        t.problems.append('ledger: the whole-set evaluator was lowered')
    rep = census.report()
    t.daemon.setup.shutdown()
    return ({'pods': n, 'setup_s': t.setup_s,
             'partitions': [[sc.policies[i].name
                             for i in rt.part.policy_indices]
                            for rt in runtimes],
             'cold': cold, 'edit': edit,
             'ledger': {'census': executables.census(), 'partitions': ledger,
                        'census_sets': [{
                            'n_partitions': st['n_partitions'],
                            'executables': [p['executables']['executables']
                                            for p in st['partitions']]}
                            for st in rep['sets']],
                        'unattributed': rep['unattributed']}},
            t.problems, cold_d, edit_d)


def partitioned_child(args) -> int:
    """Phase 9b in a process of its own, beside 9a: the first
    ``--pods`` Pods of ``--seed``, the verdict cache in a fresh
    temporary directory; writes the record, the problems and the row
    digests to ``--partitioned-child``'s file."""
    import tempfile
    import torch
    from kyverno_tpu_torch import smokepack
    if not torch.cuda.is_available():
        _die('torch.cuda.is_available() is False')
    policies = smokepack.load_smoke_pack()
    rng = random.Random(args.seed)
    pods = [smokepack.make_config4_pod(rng, i) for i in range(args.pods)]
    with tempfile.TemporaryDirectory(prefix='ktpu-partitioned-') as tmp:
        rec, problems, cold_d, edit_d = partitioned_ticks(policies, pods,
                                                          tmp)
    with open(args.partitioned_child, 'w') as f:
        json.dump({'record': rec, 'problems': problems,
                   'cold': [d.hex() for d in cold_d],
                   'edit': [d.hex() for d in edit_d]}, f)
    return 0


def reports_phase(policies, pods, slice_digests, partitioned_pods: int,
                  seed: int, tmp: str) -> dict:
    """Phase 9: 9b in a child process over the first
    ``partitioned_pods`` Pods while 9a runs here over every Pod (two
    processes, each on the card); then 9b's rows against 9a's.  Both
    drive the daemon's own ``tick()``, so a failing tick ends the run."""
    out_path = os.path.join(tmp, 'partitioned.json')
    logs = (os.path.join(tmp, 'partitioned.out'),
            os.path.join(tmp, 'partitioned.err'))
    cmd = [sys.executable, os.path.abspath(__file__), '--seed', str(seed),
           '--pods', str(partitioned_pods), '--partitioned-child', out_path]
    with open(logs[0], 'w') as out, open(logs[1], 'w') as err:
        child = subprocess.Popen(cmd, cwd=HERE, stdout=out, stderr=err)
    deadline = time.monotonic() + REPORTS_CHILD_TIMEOUT_S
    try:
        whole, problems, cold_d, edit_d = whole_ticks(
            policies, pods, slice_digests, os.path.join(tmp, 'whole'))
        while child.poll() is None and time.monotonic() < deadline:
            time.sleep(0.5)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0 or not os.path.exists(out_path):
        with open(logs[1]) as err:
            tail = err.read()[-3000:]
        raise AssertionError(f'the partitioned child exited '
                             f'{child.returncode} (killed past '
                             f'{REPORTS_CHILD_TIMEOUT_S} s if negative):\n'
                             f'{tail}')
    with open(out_path) as f:
        res = json.load(f)
    part = res['record']
    problems += res['problems']
    for name, got, want in (('cold', res['cold'], cold_d),
                            ('edit', res['edit'], edit_d)):
        part[name]['vs_whole'] = same_rows(
            [bytes.fromhex(d) for d in got], want,
            f'partitioned {name} vs whole', problems)
    return {'whole': whole, 'partitioned': part, 'edit': REPORTS_EDIT,
            'problems': problems}


# ---------------------------------------------------------------------------
# phase 10: the admission-controller daemon (cmd/admission_controller.py),
# cold and warm

DAEMON_REVIEWS = 200           # /validate/fail and /mutate reviews each
DAEMON_NAMESPACES = 20         # Namespace creations, and compliant Pods
DAEMON_CHILD_TIMEOUT_S = 150   # each daemon process, start to end
#: the webhook service's DNS name, which the serving pair's SANs carry
SERVICE_HOST = 'kyverno-svc.kyverno.svc'

DAEMON_POLICIES = '''
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: need-team
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  validationFailureAction: audit
  rules:
    - name: team
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: team required
        pattern: {metadata: {labels: {team: "?*"}}}
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata: {name: add-np}
spec:
  rules:
    - name: default-deny
      match: {any: [{resources: {kinds: [Namespace]}}]}
      generate:
        apiVersion: networking.k8s.io/v1
        kind: NetworkPolicy
        name: default-deny
        namespace: "{{request.object.metadata.name}}"
        data:
          spec: {podSelector: {}, policyTypes: [Ingress]}
'''


def daemon_cluster():
    """A FakeClient holding the smoke pack in Enforce, the mutate pack,
    an Audit policy (``need-team``) and a generate policy (``add-np``),
    all as ClusterPolicies."""
    import yaml
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.dclient.client import FakeClient
    client = FakeClient()
    docs = [p.raw for p in smokepack.load_smoke_pack('Enforce') +
            smokepack.load_mutate_pack()]
    docs += list(yaml.safe_load_all(DAEMON_POLICIES))
    for doc in docs:
        client.create_resource('kyverno.io/v1', 'ClusterPolicy', '',
                               dict(doc, kind='ClusterPolicy'))
    return client


def _policy_review(i: int, policy: dict) -> bytes:
    return json.dumps({'apiVersion': 'admission.k8s.io/v1',
                       'kind': 'AdmissionReview', 'request': {
        'uid': f'policy-{i}', 'operation': 'CREATE',
        'kind': {'group': 'kyverno.io', 'version': 'v1',
                 'kind': 'ClusterPolicy'},
        'object': policy, 'userInfo': {'username': 'admin'}}}).encode()


def compliant_pod(i: int) -> dict:
    """A Pod that every smoke-pack policy passes (the generated ones all
    fail ``pss-restricted``, and a blocked review writes no admission
    report); every other one carries the Audit policy's ``team``."""
    meta = {'name': f'ok-{i}', 'namespace': f'ns-{i % 7}',
            'labels': {'app': f'app-{i % 11}'}}
    if i % 2:
        meta['labels']['team'] = f'team-{i % 3}'
    hardened = {'runAsNonRoot': True,
                'seccompProfile': {'type': 'RuntimeDefault'}}
    probe = {'httpGet': {'path': '/healthz', 'port': 8080}}
    cont = {'name': 'app', 'image': f'registry.example.com/app:1.{i}.0',
            'resources': {'requests': {'memory': '64Mi', 'cpu': '100m'},
                          'limits': {'memory': '128Mi'}},
            'livenessProbe': probe, 'readinessProbe': probe,
            'securityContext': dict(hardened,
                                    allowPrivilegeEscalation=False,
                                    capabilities={'drop': ['ALL']})}
    return {'apiVersion': 'v1', 'kind': 'Pod', 'metadata': meta,
            'spec': {'securityContext': hardened, 'containers': [cont]}}


def daemon_reviews(n: int, namespaces: int, seed: int):
    """``n`` /validate/fail and ``n`` /mutate Pod reviews (as phase 7's),
    ``namespaces`` compliant Pods (``compliant_pod``) and as many
    Namespace creations on /validate/fail, and two /policyvalidate
    reviews, one of a valid policy and one of a policy whose rule has no
    match."""
    import yaml
    rng = random.Random(seed + 10)
    out = _reviews(2 * n, seed + 10, 0)
    out += [('/validate/fail', _review(2 * n + i, '/validate/fail',
                                       compliant_pod(i), rng))
            for i in range(namespaces)]
    for i in range(namespaces):
        ns = {'apiVersion': 'v1', 'kind': 'Namespace',
              'metadata': {'name': f'team-{i}'}}
        out.append(('/validate/fail', json.dumps({
            'apiVersion': 'admission.k8s.io/v1', 'kind': 'AdmissionReview',
            'request': {'uid': f'ns-{i}', 'operation': 'CREATE',
                        'kind': {'group': '', 'version': 'v1',
                                 'kind': 'Namespace'},
                        'resource': {'group': '', 'version': 'v1',
                                     'resource': 'namespaces'},
                        'name': f'team-{i}', 'object': ns,
                        'userInfo': {'username': 'admin'}}}).encode()))
    valid = list(yaml.safe_load_all(DAEMON_POLICIES))[0]
    invalid = json.loads(json.dumps(valid))
    del invalid['spec']['rules'][0]['match']
    out += [('/policyvalidate', _policy_review(0, valid)),
            ('/policyvalidate', _policy_review(1, invalid))]
    return out


def _https(port: int, ca_pem: bytes, method: str, path: str,
           body: bytes = b''):
    """One request to the daemon on 127.0.0.1, its certificate verified
    against ``ca_pem`` under the service's name (as the API server
    does).  Returns (status, body)."""
    import http.client
    import socket
    import ssl
    ctx = ssl.create_default_context(cadata=ca_pem.decode())

    class Conn(http.client.HTTPSConnection):
        def connect(self):
            sock = socket.create_connection(('127.0.0.1', port),
                                            self.timeout)
            self.sock = ctx.wrap_socket(sock, server_hostname=SERVICE_HOST)

    conn = Conn('127.0.0.1', port, timeout=30, context=ctx)
    try:
        headers = {'Content-Type': 'application/json'} if body else {}
        conn.request(method, path, body=body or None, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def daemon_kernel_checks(server, oracle, reviews, device) -> dict:
    """One review of each Pod route served in-process with the kernel
    wrappers spied on, and every captured call held against the
    kernel's plain version on the same card tensors, with the first
    call's time and its plain version's.  These launches come before
    the counted pass."""
    from kyverno_tpu_torch.ops import kernels
    names = {'status_vm': 'k1_vm', 'fdet_select': 'k1h_fdet_select',
             'k3_mutate': 'k3_mutate'}
    seen = {n: [] for n in names}
    for route in ('/validate/fail', '/mutate'):
        body = next(b for r, b in reviews if r == route)
        got, calls = capture_kernel_inputs(
            lambda: server.handle(route, body), names=tuple(names))
        if got != oracle.handle(route, body):
            raise AssertionError(f'{route}: the captured review differs '
                                 f'from the host loop')
        for n, c in calls.items():
            seen[n].extend(c)
    pairs = {'status_vm': (kernels.status_vm,
                           lambda packed, program: program.plain(packed)),
             'fdet_select': (kernels.fdet_select,
                             kernels.fdet_select_plain),
             'k3_mutate': (kernels.k3_mutate, kernels.k3_mutate_plain)}
    out = {}
    for n, calls in seen.items():
        if not calls:
            raise AssertionError(f'{names[n]} was never called by the '
                                 f'daemon')
        kernel, plain = pairs[n]
        out[names[n]] = {
            'calls': len(calls),
            'max_abs_err': max(_max_abs_err(kernel(*c), plain(*c))
                               for c in calls),
            'ms': _ms(lambda: kernel(*calls[0]), device),
            'plain_ms': _ms(lambda: plain(*calls[0]), device, reps=3)}
    bad = {n: r['max_abs_err'] for n, r in out.items() if r['max_abs_err']}
    if bad:
        raise AssertionError(f'kernels differ from their plain versions '
                             f'under the daemon: {bad}')
    return out


def admission_child(args) -> int:
    """One admission-controller process of phase 10 (cold or warm: the
    caches in ``KTPU_AOT_CACHE_DIR`` and ``KTPU_COMPILE_CACHE`` decide)
    over a fresh ``FakeClient`` cluster (``daemon_cluster``); writes its
    record (``admission_daemon_run``) to ``--admission-child``'s file."""
    import torch
    from kyverno_tpu_torch.cmd.internal import Setup
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        _die('torch.cuda.is_available() is False')
    # seconds from process start to each step of the start-up
    steps = {'imports': time.monotonic() - STARTED}
    client = daemon_cluster()
    setup = Setup('kyverno-admission-controller', ['--enable-tracing'],
                  client=client)
    steps['cluster'] = time.monotonic() - STARTED
    out = admission_daemon_run(
        setup, device, daemon_reviews(args.reviews, args.namespaces,
                                      args.seed),
        args.namespaces, os.path.dirname(os.path.abspath(
            args.admission_child)), steps)
    with open(args.admission_child, 'w') as f:
        json.dump(out, f)
    return 0


def admission_daemon_run(setup, device, reviews, namespaces: int,
                         dump_dir: str, steps: dict,
                         restart: bool = False) -> dict:
    """One admission daemon over ``setup.client`` (phases 10 and 11).
    Starts it on ``device``, waits for ``/health/warmup`` over HTTPS,
    serves ``reviews`` through the socket and checks what the daemon
    wrote; returns its record, with the problems found.  On the CPU
    (``device`` cpu, a rehearsal) the kernel checks and the launch counts
    are left out: no kernel runs there.

    Phase 10 (``restart`` false) then creates the Namespaces and runs
    the background controller, which must generate one NetworkPolicy
    each.  Phase 11 (``restart``) instead ticks the daemon again, so the
    reconciler writes each policy's status, serves ``namespaces`` more
    compliant Pods, and holds the policy labels of their admission
    reports against the server's current resourceVersions; then it
    deletes the admission reports it wrote, so that the next process's
    reports daemon meets the Pods' state alone."""
    import hashlib
    import threading
    from kyverno_tpu_torch.cmd.admission_controller import \
        AdmissionController
    from kyverno_tpu_torch.cmd.background_controller import \
        BackgroundController
    from kyverno_tpu_torch.compiler import aot
    from kyverno_tpu_torch.controllers.webhook import (MUTATING_NAME,
                                                       VALIDATING_NAME)
    from kyverno_tpu_torch.observability import (device as devtel,
                                                 executables, provenance,
                                                 tracing)
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.policycache import cache as pcache
    from kyverno_tpu_torch.webhooks.handlers import ResourceHandlers
    from kyverno_tpu_torch.webhooks.server import (PolicyHandlers,
                                                   WebhookServer)
    on_card = device.type == 'cuda'
    client = setup.client
    problems = []
    # port 0: the listener takes the port the kernel gives it when it
    # binds, so no outgoing connection to the API server can take a
    # port chosen beforehand and leave the daemon without one
    daemon = AdmissionController(setup, port=0, tls=True, device=device)
    steps['constructed'] = time.monotonic() - STARTED
    # run()'s parts, from a thread of this process's own
    failed = []

    def run():
        try:
            daemon.server.start()
            daemon.tick()
        except BaseException as e:  # noqa: BLE001 - raised below
            failed.append(e)
    runner = threading.Thread(target=run, name='daemon-run')
    runner.start()
    runner.join(DAEMON_CHILD_TIMEOUT_S)
    if runner.is_alive():
        raise AssertionError('server.start() and tick() did not return')
    if failed:
        raise AssertionError('server.start() or tick() raised') \
            from failed[0]
    port = daemon.server.port
    ca = daemon.cert_renewer.ca_bundle()
    deadline = time.monotonic() + DAEMON_CHILD_TIMEOUT_S
    polls = 0
    while True:
        code, body = _https(port, ca, 'GET', '/health/warmup')
        polls += 1
        state = json.loads(body)['state']
        if state == 'ready':
            break
        if state not in ('pending', 'warming') or \
                time.monotonic() > deadline:
            raise AssertionError(f'/health/warmup: {code} {body[:500]!r}')
        time.sleep(0.02)
    ready_s = time.monotonic() - STARTED
    warmer = daemon.warmer
    if not (warmer.detail or '').startswith('compiled scanner serving'):
        problems.append(f'warmer detail {warmer.detail!r}: the daemon '
                        f'does not serve from the device')
    [span] = [s for s in tracing.memory_exporter().spans()
              if s.name == 'kyverno/aot/warmer']
    lowered = dict(executables.census().get('by_source', {}))
    handlers = daemon.handlers
    mutate = daemon.cache.get_policies(pcache.MUTATE, 'Pod', 'ns-0')
    msc = None
    while msc is None and time.monotonic() < deadline:
        msc = handlers._device_scanner(mutate, kind='mutate')
        time.sleep(0.02)
    if msc is None or not msc.ok:
        raise AssertionError(f'the mutate scanner did not come up: {msc}')
    mutate_ready_s = time.monotonic() - STARTED
    counter = MutateCounter(msc)
    failures = []
    record_failure = handlers._record_key_failure

    def counting_failure(key, policies, reason):
        failures.append(reason)
        return record_failure(key, policies, reason)

    handlers._record_key_failure = counting_failure
    oracle = WebhookServer(
        ResourceHandlers(daemon.cache, device=False,
                         configuration=setup.configuration, client=client),
        configuration=setup.configuration,
        policy_handlers=PolicyHandlers(client))
    checks = daemon_kernel_checks(daemon.server, oracle, reviews, device) \
        if on_card else {}

    def drop_admission_reports():
        daemon.flush_audits()
        for kind in ('AdmissionReport', 'ClusterAdmissionReport'):
            for r in client.list_resource('kyverno.io/v1alpha2', kind, '',
                                          None):
                meta = r['metadata']
                client.delete_resource('kyverno.io/v1alpha2', kind,
                                       meta.get('namespace', ''),
                                       meta['name'])

    drop_admission_reports()
    # the counted pass: every review through the socket
    rec = provenance.configure(flight_n=len(reviews), dump_dir=dump_dir)
    counter.reset()
    kernels.reset_launches()
    t0 = time.monotonic()
    got = []
    for route, body in reviews:
        code, resp = _https(port, ca, 'POST', route, body)
        if code != 200:
            raise AssertionError(f'{route}: HTTP {code} {resp[:300]!r}')
        got.append(resp)
    serve_s = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    paths, ns_paths = {}, {}
    for r in rec.records():
        into = paths if r.kind == 'Pod' else ns_paths
        into[r.path] = into.get(r.path, 0) + 1
    provenance.disable()
    daemon.flush_audits()
    mismatches = [j for j, (route, body) in enumerate(reviews)
                  if got[j] != oracle.handle(route, body)]
    if mismatches:
        problems.append(f'{len(mismatches)} responses differ from the host '
                        f'loop: {mismatches[:10]}')
    if failures:
        problems.append(f'breaker failures {failures[:3]}')
    n_pod = sum(1 for r, b in reviews if r == '/validate/fail'
                and b'"Pod"' in b)
    if paths != {'sync': n_pod}:
        problems.append(f'Pod decisions by path {paths}, want all '
                        f'{n_pod} on sync')
    # no Enforce policy matches a Namespace: the handler records those
    # decisions, which evaluate no policy, on the host loop's path
    if ns_paths != {'host_fallback': namespaces}:
        problems.append(f'Namespace decisions by path {ns_paths}')
    # an allowed Pod review hands the Audit policy's results to an
    # audit thread, which writes one admission report
    allowed_pods = sum(
        1 for j, (r, b) in enumerate(reviews) if r == '/validate/fail'
        and b'"Pod"' in b and json.loads(got[j])['response']['allowed'])
    n_mut = sum(1 for r, _b in reviews if r == '/mutate')
    if counter.rows < n_mut:
        problems.append(f'only {counter.rows} of {n_mut} /mutate reviews '
                        f'went through the mutate scanner')
    if on_card:
        missing = [k for k in ADMISSION_KERNELS if launches.get(k, 0) <= 0]
        if missing:
            problems.append(f'kernels never launched under the daemon: '
                            f'{missing}')
    policy_allowed = [json.loads(got[j])['response']['allowed']
                      for j, (r, _b) in enumerate(reviews)
                      if r == '/policyvalidate']
    if policy_allowed != [True, False]:
        problems.append(f'/policyvalidate allowed {policy_allowed}, '
                        f'want [True, False]')
    # the generate hand-off: one UpdateRequest per Namespace (a restarted
    # daemon updates the ones its predecessor created)
    urs = len(client.list_resource('kyverno.io/v1beta1', 'UpdateRequest',
                                   'kyverno', None))
    reports = len(client.list_resource('kyverno.io/v1alpha2',
                                       'AdmissionReport', '', None))
    if reports != allowed_pods:
        problems.append(f'{reports} admission reports for {allowed_pods} '
                        f'allowed Pod reviews under the Audit policy')
    nps = None
    labels = None
    if not restart:
        # which the background controller turns into a NetworkPolicy
        # once the Namespace exists
        for i in range(namespaces):
            client.create_resource('v1', 'Namespace', '', {
                'apiVersion': 'v1', 'kind': 'Namespace',
                'metadata': {'name': f'team-{i}'}})
        BackgroundController(setup).tick()
        nps = sum(len(client.list_resource(
            'networking.k8s.io/v1', 'NetworkPolicy', f'team-{i}', None))
            for i in range(namespaces))
    if urs != namespaces or nps not in (None, namespaces):
        problems.append(f'{urs} UpdateRequests and {nps} '
                        f'NetworkPolicies for {namespaces} Namespaces')
    if restart:
        labels = restart_label_pass(daemon, oracle, port, ca, namespaces,
                                    problems)
        drop_admission_reports()
    bundles = []
    for kind, name in (('ValidatingWebhookConfiguration', VALIDATING_NAME),
                       ('MutatingWebhookConfiguration', MUTATING_NAME)):
        cfg = client.get_resource('admissionregistration.k8s.io/v1', kind,
                                  '', name)
        bundles += [w['clientConfig']['caBundle'] for w in cfg['webhooks']]
    import base64
    if not bundles or set(bundles) != {base64.b64encode(ca).decode()}:
        problems.append('the webhook configurations do not carry the CA '
                        'bundle that verified the connection')
    C = devtel.COMPILE_CACHE_REQUESTS
    aot.flush_stores()
    # no scanner build may still be inside a torch op at exit
    while handlers._building and time.monotonic() < deadline:
        time.sleep(0.05)
    if handlers._building:
        problems.append(f'scanner builds still running: '
                        f'{handlers._building}')
    daemon.close()
    setup.shutdown()
    digest = hashlib.sha256(b''.join(
        hashlib.sha256(r).digest() for r in got)).hexdigest()
    steps['warm_up'] = warmer.duration_s
    out = {'device': str(device), 'ready_s': ready_s,
           'start_up_s': steps, 'mutate_ready_s': mutate_ready_s,
           'warmup_polls': polls, 'warmer': {
               'detail': warmer.detail, 'duration_s': warmer.duration_s,
               'attributes': dict(span.attributes)},
           'lowered_by_source': lowered,
           'compile_cache': {r: setup.metrics.counter_value(C, result=r)
                             for r in ('miss', 'aot_load', 'aot_store')},
           'reviews': len(reviews), 'serve_s': serve_s,
           'requests_per_s': len(reviews) / serve_s,
           'validate_paths': paths, 'launches': launches,
           'mutate': counter.stats(), 'kernel_checks': checks,
           'update_requests': urs, 'network_policies': nps,
           'admission_reports': reports, 'allowed_pod_reviews': allowed_pods,
           'ca_bundles': len(bundles),
           'responses_digest': digest, 'mismatches': len(mismatches),
           'problems': problems}
    if restart:
        out['labels'] = labels
    return out


def admission_daemon_phase(seed: int, tmp: str, device: str = 'cuda:0',
                           reviews: int = DAEMON_REVIEWS,
                           namespaces: int = DAEMON_NAMESPACES) -> dict:
    """Phase 10: the admission daemon in two processes of this script in
    turn, sharing one fresh AOT store and one fresh kernel library
    directory: the cold one builds the kernels and lowers and stores its
    K1v programs, the warm one must build and lower nothing and load
    its programs.  Both must serve the same bytes."""
    env = dict(os.environ, KTPU_AOT='1', KTPU_WARM='1',
               KTPU_AOT_CACHE_DIR=os.path.join(tmp, 'aot'),
               KTPU_COMPILE_CACHE=os.path.join(tmp, 'lib'))
    runs = {}
    for name in ('cold', 'warm'):
        out_path = os.path.join(tmp, f'{name}.json')
        logs = (os.path.join(tmp, f'{name}.out'),
                os.path.join(tmp, f'{name}.err'))
        cmd = [sys.executable, os.path.abspath(__file__), '--seed',
               str(seed), '--device', device, '--reviews', str(reviews),
               '--namespaces', str(namespaces), '--admission-child',
               out_path]
        t0 = time.monotonic()
        with open(logs[0], 'w') as out, open(logs[1], 'w') as err:
            child = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=out,
                                     stderr=err)
        try:
            child.wait(timeout=DAEMON_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
        if child.returncode != 0 or not os.path.exists(out_path):
            with open(logs[1]) as err:
                tail = err.read()[-3000:]
            raise AssertionError(
                f'the {name} admission daemon exited {child.returncode} '
                f'(killed past {DAEMON_CHILD_TIMEOUT_S} s if negative):\n'
                f'{tail}')
        with open(out_path) as f:
            runs[name] = dict(json.load(f), wall_s=time.monotonic() - t0)
    cold, warm = runs['cold'], runs['warm']
    problems = [f'{name}: {p}' for name, r in runs.items()
                for p in r['problems']]
    on_card = device.startswith('cuda')
    built = {name: r['warmer']['attributes'].get('kernels_built', 0)
             for name, r in runs.items()}
    if on_card and (built['cold'] < 1 or built['warm'] != 0):
        problems.append(f'kernels built {built}: the cold daemon must '
                        f'build them and the warm one none')
    fresh = {name: r['lowered_by_source'].get('fresh_compile', 0)
             for name, r in runs.items()}
    if fresh['cold'] < 1 or cold['compile_cache']['aot_store'] < 1:
        problems.append(f'the cold daemon lowered {fresh["cold"]} and '
                        f'stored {cold["compile_cache"]["aot_store"]} '
                        f'programs')
    if fresh['warm'] != 0 or \
            warm['lowered_by_source'].get('aot_load', 0) < 1:
        problems.append(f'the warm daemon lowered {fresh["warm"]} and '
                        f'loaded {warm["lowered_by_source"]} programs')
    if cold['responses_digest'] != warm['responses_digest']:
        problems.append('the cold and warm daemons answered differently')
    return {'cold': cold, 'warm': warm, 'problems': problems}



# ---------------------------------------------------------------------------
# phase 11: the daemons against an API server over HTTP, then restarted on
# the state they left

RESTART_PODS = 4096            # Pods on the API server, in their Namespaces
RESTART_REVIEWS = 100          # /validate/fail and /mutate reviews each
RESTART_NAMESPACES = 10        # Namespace creations, and compliant Pods
RESTART_CHECK = 1000           # report rows held against the host engine
RESTART_CHILD_TIMEOUT_S = 300  # each process, start to end

#: the kinds the daemons read or write over HTTP beyond the 11 that
#: ``FakeApiServer``'s registry knows, each with its plural and its
#: scope as a Kubernetes API server serves it.  Without an entry the
#: server answers 404, and the client's discovery fallback would call a
#: cluster-scoped kind namespaced
API_KINDS = (
    ('v1', 'Event', 'events', True),
    ('coordination.k8s.io/v1', 'Lease', 'leases', True),
    ('admissionregistration.k8s.io/v1', 'ValidatingWebhookConfiguration',
     'validatingwebhookconfigurations', False),
    ('admissionregistration.k8s.io/v1', 'MutatingWebhookConfiguration',
     'mutatingwebhookconfigurations', False),
    ('apiextensions.k8s.io/v1', 'CustomResourceDefinition',
     'customresourcedefinitions', False),
    ('batch/v1', 'CronJob', 'cronjobs', True),
    ('kyverno.io/v1', 'Policy', 'policies', True),
    ('kyverno.io/v2beta1', 'ClusterPolicy', 'clusterpolicies', False),
    ('kyverno.io/v2beta1', 'Policy', 'policies', True),
    ('kyverno.io/v2alpha1', 'ClusterCleanupPolicy', 'clustercleanuppolicies',
     False),
    ('kyverno.io/v2alpha1', 'CleanupPolicy', 'cleanuppolicies', True),
    ('kyverno.io/v2alpha1', 'PolicyException', 'policyexceptions', True),
    ('kyverno.io/v2beta1', 'PolicyException', 'policyexceptions', True),
    ('kyverno.io/v1alpha2', 'AdmissionReport', 'admissionreports', True),
    ('kyverno.io/v1alpha2', 'ClusterAdmissionReport',
     'clusteradmissionreports', False),
    ('kyverno.io/v1alpha2', 'BackgroundScanReport', 'backgroundscanreports',
     True),
    ('kyverno.io/v1alpha2', 'ClusterBackgroundScanReport',
     'clusterbackgroundscanreports', False),
    ('wgpolicyk8s.io/v1alpha2', 'ClusterPolicyReport',
     'clusterpolicyreports', False),
)


def register_kinds(server) -> None:
    """Teach ``server`` (a ``FakeApiServer`` of either package) every
    kind of ``API_KINDS``."""
    for api_version, kind, plural, namespaced in API_KINDS:
        server.registry.register(api_version, kind, plural, namespaced)


class RequestCounter:
    """Counts the requests ``server`` answers, by verb and kind
    (``'list Pod'``, ``'update_status ClusterPolicy'``; a path the
    server does not route counts under ``'<verb> ?'``): installed in
    place of its request handler, before it starts."""

    def __init__(self, server):
        import re
        import threading
        self.counts = {}
        self._lock = threading.Lock()
        counter, base = self, server._server.RequestHandlerClass

        class Counting(base):
            def _count(self, method):
                path, _, query = self.path.partition('?')
                parsed = server._parse(path)
                verb = {'POST': 'create', 'PUT': 'update', 'PATCH': 'patch',
                        'DELETE': 'delete'}.get(method)
                if verb is None:
                    verb = 'watch' if 'watch=true' in query else \
                        'get' if parsed is not None and parsed[3] else 'list'
                if method == 'PUT' and path.endswith('/status'):
                    verb = 'update_status'
                kind = parsed[1] if parsed is not None else '?'
                if method == 'GET' and re.fullmatch(
                        r'/api/v1|/apis/[^/]+/[^/]+', path):
                    verb, kind = 'discovery', path
                key = f'{verb} {kind}'
                with counter._lock:
                    counter.counts[key] = counter.counts.get(key, 0) + 1

            def do_GET(self):  # noqa: N802
                self._count('GET')
                super().do_GET()

            def do_POST(self):  # noqa: N802
                self._count('POST')
                super().do_POST()

            def do_PUT(self):  # noqa: N802
                self._count('PUT')
                super().do_PUT()

            def do_PATCH(self):  # noqa: N802
                self._count('PATCH')
                super().do_PATCH()

            def do_DELETE(self):  # noqa: N802
                self._count('DELETE')
                super().do_DELETE()

        server._server.RequestHandlerClass = Counting

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counts)

    def since(self, before: dict) -> dict:
        return {k: v - before.get(k, 0)
                for k, v in sorted(self.snapshot().items())
                if v - before.get(k, 0)}


def restart_cluster(seed: int, pods: int):
    """Phase 10's cluster (``daemon_cluster``) plus the first ``pods``
    Pods of phase 3's generator, each in its Namespace."""
    from kyverno_tpu_torch import smokepack
    store = daemon_cluster()
    rng = random.Random(seed)
    namespaces = set()
    for i in range(pods):
        pod = smokepack.make_config4_pod(rng, i)
        ns = pod['metadata']['namespace']
        if ns not in namespaces:
            namespaces.add(ns)
            store.create_resource('v1', 'Namespace', '', {
                'apiVersion': 'v1', 'kind': 'Namespace',
                'metadata': {'name': ns}})
        store.create_resource('v1', 'Pod', ns, pod)
    return store


#: where the uids of phase 11's label-pass reviews start
RESTART_LABEL_UID = 100_000
#: the metadata an API server stamps on each write
STAMPED = ('uid', 'resourceVersion', 'creationTimestamp', 'generation',
           'managedFields', 'selfLink')


def current_resource_versions(client) -> dict:
    """Each ClusterPolicy's resourceVersion on the server, by name."""
    return {p['metadata']['name']: p['metadata'].get('resourceVersion')
            for p in client.list_resource('kyverno.io/v1', 'ClusterPolicy',
                                          '', None)}


def stale_policy_labels(reports, current: dict) -> list:
    """``(report, label, value)`` for each policy label of ``reports``
    whose value is not that policy's resourceVersion in ``current``."""
    out = []
    for r in reports:
        meta = r.get('metadata') or {}
        for k, v in (meta.get('labels') or {}).items():
            if k.startswith('cpol.kyverno.io/') and \
                    current.get(k.split('/', 1)[1]) != v:
                out.append((meta.get('name'), k, v))
    return out


def _report_body(report: dict) -> dict:
    """``report`` without the server's stamps, its policy labels and the
    scan clock (its results' timestamps, its last-scan-time annotation):
    what two processes must write alike."""
    report = json.loads(json.dumps(report))
    meta = report.get('metadata') or {}
    for k in STAMPED:
        meta.pop(k, None)
    (meta.get('annotations') or {}).pop('audit.kyverno.io/last-scan-time',
                                        None)
    meta['labels'] = {k: v for k, v in (meta.get('labels') or {}).items()
                      if not k.startswith(('cpol.kyverno.io/',
                                           'pol.kyverno.io/'))}
    for r in (report.get('spec') or {}).get('results') or \
            report.get('results') or []:
        r.pop('timestamp', None)
    return report


def restart_label_pass(daemon, oracle, port: int, ca: bytes, n: int,
                       problems: list) -> dict:
    """Phase 11's check of the policy labels: tick the daemon (its
    reconciler writes each policy's status, which bumps the policies'
    resourceVersions, unless the status is already current), serve
    ``n`` more compliant Pods through the socket, and hold the policy
    labels of the admission reports they write against the server's
    current resourceVersions."""
    client = daemon.setup.client
    t0 = time.monotonic()
    daemon.tick()
    tick_s = time.monotonic() - t0
    before = {r['metadata']['name'] for r in client.list_resource(
        'kyverno.io/v1alpha2', 'AdmissionReport', '', None)}
    rng = random.Random(n)
    reviews = [('/validate/fail', _review(RESTART_LABEL_UID + i,
                                          '/validate/fail', compliant_pod(i),
                                          rng)) for i in range(n)]
    bad = 0
    for route, body in reviews:
        code, resp = _https(port, ca, 'POST', route, body)
        bad += code != 200 or resp != oracle.handle(route, body)
    daemon.flush_audits()
    new = [r for r in client.list_resource('kyverno.io/v1alpha2',
                                           'AdmissionReport', '', None)
           if r['metadata']['name'] not in before]
    stale = stale_policy_labels(new, current_resource_versions(client))
    if bad:
        problems.append(f'label pass: {bad} of {n} responses differ from '
                        f'the host loop')
    if not new:
        problems.append('label pass: no admission report was written')
    if stale:
        problems.append(f'label pass: {len(stale)} policy labels of '
                        f'admission reports are not the policies\' current '
                        f'resourceVersions: {stale[:4]}')
    return {'tick_s': tick_s, 'reviews': n, 'reports': len(new),
            'labels': sum(1 for r in new for k in r['metadata']['labels']
                          if k.startswith('cpol.kyverno.io/')),
            'stale': len(stale), 'mismatches': bad}


def restart_reports(url: str, device, vc_dir: str, first: bool) -> dict:
    """Phase 11's reports daemon: ``ReportsController`` over an
    ``HTTPClient`` to ``url``, one ``tick()``.  One report per Pod; the
    rows of ``RESTART_CHECK`` Pods, spread evenly, held against the host
    engine; the policy labels of every report it wrote and of the
    aggregated PolicyReports held against the server's current
    resourceVersions.  The first process (``first``) scans every row
    with one K1v and one K1h launch; the restarted one must replay every
    row from the verdict cache and launch nothing."""
    from kyverno_tpu_torch.cmd.internal import Setup
    from kyverno_tpu_torch.cmd.reports_controller import ReportsController
    from kyverno_tpu_torch.dclient.http_client import (ClusterConfig,
                                                       HTTPClient)
    from kyverno_tpu_torch.engine.engine import Engine
    from kyverno_tpu_torch.smokepack import host_report_results
    import hashlib
    problems = []
    client = HTTPClient(ClusterConfig(server=url))
    setup = Setup('kyverno-reports-controller', [], client=client)
    daemon = ReportsController(setup, device=device)
    written = []
    parts = _timed_parts(daemon, written)
    tick = reports_tick(daemon, parts, vc_dir)
    sc = daemon.scan_controller
    st = tick['rescan']
    docs = client.list_resource('v1', 'Pod', '', None)
    by_name = {r['metadata']['name']: r for r in written}
    reports = [by_name.get(d['metadata']['uid']) for d in docs]
    missing = sum(r is None for r in reports)
    if missing or not docs:
        problems.append(f'reports: {missing} of {len(docs)} Pods without a '
                        f'report')
    rows = [([], {}) if r is None else
            (r['spec']['results'], r['spec']['summary']) for r in reports]
    digests = row_digests(rows)
    n = len(docs)
    idx = sorted({i * n // RESTART_CHECK
                  for i in range(min(n, RESTART_CHECK))})
    engine = Engine()
    t0 = time.perf_counter()
    bad = [i for i in idx if row_digests([rows[i]]) != row_digests(
        [host_report_results(sc.policies, docs[i], NOW, engine)])]
    tick['vs_host'] = {'rows': len(idx), 'mismatches': len(bad),
                       'check_s': time.perf_counter() - t0}
    if bad:
        problems.append(f'reports: {len(bad)} of {len(idx)} rows differ '
                        f'from the host engine: {bad[:10]}')
    aggregated = []
    for kind in ('PolicyReport', 'ClusterPolicyReport'):
        aggregated += client.list_resource('wgpolicyk8s.io/v1alpha2', kind,
                                           '', None)
    current = current_resource_versions(client)
    stale = stale_policy_labels(written + aggregated, current)
    if stale:
        problems.append(f'reports: {len(stale)} policy labels are not the '
                        f'policies\' current resourceVersions: {stale[:4]}')
    body = hashlib.sha256(json.dumps(
        [_report_body(r) for r in sorted(
            written, key=lambda r: r['metadata']['name'])] +
        [_report_body(r) for r in sorted(
            aggregated, key=lambda r: (r['metadata'].get('namespace', ''),
                                       r['metadata']['name']))],
        sort_keys=True).encode()).hexdigest()
    launched = {k: v for k, v in tick['launches'].items() if v}
    if first:
        if st['rows_scanned'] != st['rows_pending'] or st['rows_replayed']:
            problems.append(f'reports: rescan stats {st}, every row '
                            f'scanned expected')
        on_card = device.type == 'cuda'
        chunks = -(-st['rows_scanned'] // sc.scanner.CHUNK)
        want = {k: chunks for k in SCAN_KERNELS} if on_card else {}
        if {k: launched.get(k, 0) for k in want} != want:
            problems.append(f'reports: launches {launched} for {chunks} '
                            f'chunks')
    else:
        if st['rows_replayed'] != st['rows_pending'] or st['rows_scanned']:
            problems.append(f'reports: rescan stats {st}, every row '
                            f'replayed expected')
        if launched:
            problems.append(f'reports: a replay tick launched {launched}')
    sc.scanner._encoder_pool.close()
    setup.shutdown()
    client.close()
    tick.update({'pods': n, 'reports': len(written) - missing,
                 'aggregated': len(aggregated),
                 'policy_labels': sum(
                     1 for r in written + aggregated
                     for k in r['metadata'].get('labels') or {}
                     if k.startswith('cpol.kyverno.io/')),
                 'stale_labels': len(stale),
                 'generation': sc.verdict_cache.fingerprint,
                 'rows_digest': digest_of(digests), 'body_digest': body,
                 'resource_versions': current})
    return {'tick': tick, 'problems': problems}


def restart_child(args) -> int:
    """One process of phase 11 (``--restart-child FIRST|SECOND OUT``):
    the reports daemon's tick, then the admission daemon, each over its
    own ``HTTPClient`` to ``--api-server``; writes the record to OUT."""
    import torch
    from kyverno_tpu_torch.cmd.internal import Setup
    from kyverno_tpu_torch.dclient.http_client import (ClusterConfig,
                                                       HTTPClient)
    name, out_path = args.restart_child
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        _die('torch.cuda.is_available() is False')
    steps = {'imports': time.monotonic() - STARTED}
    reports = restart_reports(args.api_server, device,
                              os.environ['KTPU_VERDICT_CACHE_DIR'],
                              first=name == 'FIRST')
    client = HTTPClient(ClusterConfig(server=args.api_server))
    setup = Setup('kyverno-admission-controller', ['--enable-tracing'],
                  client=client)
    steps['cluster'] = time.monotonic() - STARTED
    adm = admission_daemon_run(
        setup, device, daemon_reviews(args.reviews, args.namespaces,
                                      args.seed),
        args.namespaces, os.path.dirname(os.path.abspath(out_path)), steps,
        restart=True)
    client.close()
    adm['ready_after_reports_s'] = adm['ready_s'] - steps['cluster']
    with open(out_path, 'w') as f:
        json.dump({'name': name, 'reports': reports['tick'],
                   'admission': adm,
                   'problems': reports['problems'] + adm['problems']}, f)
    return 0


def restart_phase(seed: int, tmp: str, device: str = 'cuda:0',
                  pods: int = RESTART_PODS, reviews: int = RESTART_REVIEWS,
                  namespaces: int = RESTART_NAMESPACES) -> dict:
    """Phase 11: one ``FakeApiServer`` on 127.0.0.1 holding phase 10's
    policies and ``pods`` Pods, every kind of ``API_KINDS`` registered,
    and two processes of this script in turn against it over HTTP
    (``restart_child``), sharing one fresh AOT store, kernel library
    directory and verdict cache.  Between them every ClusterPolicy must
    carry the status the first one's reconciler wrote.  The second (the
    restart) must build no kernel, lower no K1v program and load one,
    replay every report row under the first one's cache generation with
    no launch, and write the first one's reports but for the policy
    labels, which must be the server's current resourceVersions."""
    from kyverno_tpu_torch.dclient.fakeserver import FakeApiServer
    t0 = time.monotonic()
    server = FakeApiServer(restart_cluster(seed, pods))
    register_kinds(server)
    requests = RequestCounter(server)
    setup_s = time.monotonic() - t0
    env = dict(os.environ, KTPU_AOT='1', KTPU_WARM='1', KTPU_PARTITIONS='0',
               KTPU_AOT_CACHE_DIR=os.path.join(tmp, 'aot'),
               KTPU_COMPILE_CACHE=os.path.join(tmp, 'lib'),
               KTPU_VERDICT_CACHE_DIR=os.path.join(tmp, 'verdicts'))
    runs, problems = {}, []
    with server:
        for name in ('FIRST', 'SECOND'):
            if name == 'SECOND':
                bare = [p['metadata']['name'] for p in
                        server.store.list_resource('kyverno.io/v1',
                                                   'ClusterPolicy', '', None)
                        if not p.get('status')]
                if bare:
                    raise AssertionError(f'no status on {bare} after the '
                                         f'first process: the restart '
                                         f'would prove nothing')
            out_path = os.path.join(tmp, f'{name}.json')
            logs = (os.path.join(tmp, f'{name}.out'),
                    os.path.join(tmp, f'{name}.err'))
            cmd = [sys.executable, os.path.abspath(__file__), '--seed',
                   str(seed), '--device', device, '--reviews', str(reviews),
                   '--namespaces', str(namespaces), '--api-server',
                   server.url, '--restart-child', name, out_path]
            before = requests.snapshot()
            t1 = time.monotonic()
            with open(logs[0], 'w') as out, open(logs[1], 'w') as err:
                child = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=out,
                                         stderr=err)
            try:
                child.wait(timeout=RESTART_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
            if child.returncode != 0 or not os.path.exists(out_path):
                with open(logs[1]) as err:
                    tail = err.read()[-3000:]
                raise AssertionError(
                    f'the {name} process exited {child.returncode} (killed '
                    f'past {RESTART_CHILD_TIMEOUT_S} s if negative):\n'
                    f'{tail}')
            with open(out_path) as f:
                runs[name] = dict(json.load(f),
                                  wall_s=time.monotonic() - t1,
                                  http_requests=requests.since(before))
            problems += [f'{name}: {p}' for p in runs[name]['problems']]
    first, second = runs['FIRST'], runs['SECOND']
    cold = first['admission']
    if cold['lowered_by_source'].get('fresh_compile', 0) < 1 or \
            cold['compile_cache']['aot_store'] < 1:
        problems.append(f'the first daemon lowered and stored '
                        f'{cold["lowered_by_source"]}, '
                        f'{cold["compile_cache"]}')
    adm = second['admission']
    on_card = device.startswith('cuda')
    built = adm['warmer']['attributes'].get('kernels_built', 0)
    if on_card and built:
        problems.append(f'the restarted daemon built {built} kernels')
    if adm['lowered_by_source'].get('fresh_compile', 0) or \
            adm['lowered_by_source'].get('aot_load', 0) < 1:
        problems.append(f'the restarted daemon lowered and loaded '
                        f'{adm["lowered_by_source"]} (0 lowered, 1 or more '
                        f'loaded expected)')
    if first['admission']['responses_digest'] != adm['responses_digest']:
        problems.append('the two admission daemons answered differently')
    r1, r2 = first['reports'], second['reports']
    for key in ('generation', 'rows_digest', 'body_digest'):
        if r1[key] != r2[key]:
            problems.append(f'the restarted reports daemon\'s {key} '
                            f'differs from the first one\'s')
    if r1['resource_versions'] == r2['resource_versions']:
        problems.append('no policy resourceVersion changed between the '
                        'two reports ticks')
    return {'pods': pods, 'setup_s': setup_s, 'first': first,
            'second': second, 'problems': problems}



def restart_line(rs: dict) -> dict:
    """The ``restart`` line: per process, the readiness, the program
    cache, the serving rate, the reports tick and the HTTP requests the
    server answered, by verb and kind."""
    out = {'pods': rs['pods']}
    for name in ('first', 'second'):
        run = rs[name]
        adm, rep = run['admission'], run['reports']
        out[name] = {
            'wall_s': run['wall_s'], 'ready_s': adm['ready_s'],
            'ready_after_reports_s': adm['ready_after_reports_s'],
            'kernels_built': adm['warmer']['attributes'].get(
                'kernels_built', 0),
            'lowered_by_source': adm['lowered_by_source'],
            'compile_cache': adm['compile_cache'],
            'serve_s': adm['serve_s'],
            'requests_per_s': adm['requests_per_s'],
            'validate_paths': adm['validate_paths'],
            'mismatches': adm['mismatches'], 'labels': adm['labels'],
            'kernel_checks': adm['kernel_checks'],
            'launches': adm['launches'],
            'reports_tick': {k: rep[k] for k in (
                'wall_s', 'pods_per_s', 'parts_s', 'rescan', 'launches',
                'vs_host', 'reports', 'aggregated', 'policy_labels',
                'stale_labels', 'generation', 'encoder_pool')},
            'http_requests': run['http_requests']}
    return out
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 12: the load generator's drills, and the kuttl harness, on the card

LOADGEN_THREADS = (1, 8, 32)   # (a)'s client threads, one block each
LOADGEN_PER_THREAD = 25        # (a)'s reviews per thread
HET_OCCUPANCY_FLOOR = 2.0      # (a)'s mean occupancy must exceed it at the
                               # top thread count (bench.py's ratchet)
CHAOS_THREADS = 6              # (b): threads x reviews of the poison wave
CHAOS_PER_THREAD = 8
CHURN_THREADS = 4              # (c): threads x reviews after the swap
CHURN_PER_THREAD = 24
CHURN_PARTITIONS = 4           # KTPU_PARTITIONS of (c)'s process
BREAKER_BACKOFF_MS = '300'     # the breaker drill's backoff (bench.py's)
LOADGEN_CHILD_TIMEOUT_S = 300  # (c)'s process, start to end
LOADGEN_PROBES = 64            # Pods tried for (c)'s denied probe


def loadgen_policies():
    """Phase 12's policies: the smoke pack in Enforce and the
    admission-lanes pack, whose subject, role and cluster-role matches
    put each row's user and groups into K1v's admission entries (K1i)."""
    import yaml
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.api.policy import Policy
    return smokepack.load_smoke_pack('Enforce') + [
        Policy(d) for d in yaml.safe_load_all(smokepack.ADMISSION_LANES_PACK)
        if d]


def loadgen_server(device, policies=None):
    """``(cache, handlers, server, oracle)``: batch-mode handlers on
    ``device`` over ``policies`` (default ``loadgen_policies()``), ready
    to serve, with the breaker drill's backoff, and a host-loop oracle
    on the same cache."""
    from kyverno_tpu_torch.policycache.cache import Cache
    from kyverno_tpu_torch.webhooks.handlers import ResourceHandlers
    from kyverno_tpu_torch.webhooks.server import WebhookServer
    cache = Cache()
    cache.warm_up(policies if policies is not None else loadgen_policies())
    saved = os.environ.get('KTPU_BREAKER_BACKOFF_MS')
    os.environ['KTPU_BREAKER_BACKOFF_MS'] = BREAKER_BACKOFF_MS
    try:
        handlers = ResourceHandlers(cache, serving_mode='batch',
                                    torch_device=device)
    finally:
        if saved is None:
            os.environ.pop('KTPU_BREAKER_BACKOFF_MS', None)
        else:
            os.environ['KTPU_BREAKER_BACKOFF_MS'] = saved
    oracle = WebhookServer(ResourceHandlers(cache, device=False))
    if not handlers.wait_device_ready(_enforce(cache), timeout=READY_S):
        raise AssertionError('phase 12: the validate scanner did not come '
                             'up')
    return cache, handlers, WebhookServer(handlers), oracle


def _enforce(cache, ns: str = 'ns-0'):
    from kyverno_tpu_torch.policycache import cache as pcache
    return cache.get_policies(pcache.VALIDATE_ENFORCE, 'Pod', ns)


class exception_tenants:
    """Within the block, a request of one of ``cluster``'s exception
    tenants carries ``cluster.exception_docs()`` through each handler's
    PolicyContextBuilder (``bench.py``'s wrapper): placeholders that
    match no policy, so its verdict is unchanged and it rides the host
    loop."""

    def __init__(self, cluster, *handlers):
        self.cluster = cluster
        self.builders = [h.pc_builder for h in handlers]
        self.docs = cluster.exception_docs()

    def __enter__(self):
        self.real = [b.build for b in self.builders]

        def wrap(build):
            def call(request, policy=None):
                pctx = build(request, policy)
                user = (request.get('userInfo') or {}).get('username', '')
                if self.cluster.is_exception_tenant(user):
                    pctx.exceptions = list(self.docs)
                return pctx
            return call

        for b, build in zip(self.builders, self.real):
            b.build = wrap(build)
        return self

    def __exit__(self, *exc):
        for b, build in zip(self.builders, self.real):
            b.build = build
        return False


def _burst(threads: int, per_thread: int, send, strided: bool = False):
    """``send(j)`` for ``j`` in ``range(threads * per_thread)`` from
    ``threads`` threads released together (thread t sends its block of
    ``per_thread``, or with ``strided`` every j = t mod threads); returns
    the results by ``j`` and the wall seconds."""
    import threading
    out = [None] * (threads * per_thread)
    errors = []
    barrier = threading.Barrier(threads + 1)

    def work(t):
        barrier.wait()
        try:
            for k in range(per_thread):
                j = t + k * threads if strided else t * per_thread + k
                out[j] = send(j)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    workers = [threading.Thread(target=work, args=(t,))
               for t in range(threads)]
    for w in workers:
        w.start()
    barrier.wait()
    t0 = time.perf_counter()
    for w in workers:
        w.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f'phase 12: the webhook raised: {errors[:3]}')
    return out, wall


def _held_to_plain(calls) -> dict:
    """One batch's K1v and K1h calls (captured on the card) against
    their plain versions on the same tensors."""
    from kyverno_tpu_torch.ops import kernels
    packed, program = calls['status_vm'][0]
    vm = kernels.status_vm(packed, program)
    k1h = calls['fdet_select'][0]
    return {'rows': next(iter(packed.values())).shape[0],
            'adm_entries': program.n_adm, 'adm_cols': vm[3].shape[1],
            'k1_vm': _max_abs_err(vm, program.plain(packed)),
            'k1h_fdet_select': _max_abs_err(
                kernels.fdet_select(*k1h), kernels.fdet_select_plain(*k1h))}


def hetero_drill(server, handlers, oracle, thread_counts=LOADGEN_THREADS,
                 per_thread: int = LOADGEN_PER_THREAD,
                 kernel_checks: bool = True, keep: bool = False) -> dict:
    """(a) ``bench.py admission_heterogeneous`` on the port: the
    synthetic cluster's reviews (seed 1234: zipfian users and
    namespaces, CREATE and UPDATE, exception tenants on the host loop)
    from each thread count in turn, every response byte held against
    the host loop.  With ``kernel_checks`` (the card) one burst's K1v
    and K1h calls are first held against their plain versions, and K1v
    must carry admission entries (K1i).  With ``keep`` the record holds
    each block's (review, response) pairs."""
    from kyverno_tpu_torch.conformance.loadgen import SyntheticCluster
    from kyverno_tpu_torch.observability import provenance
    from kyverno_tpu_torch.ops import kernels
    cluster = SyntheticCluster(seed=1234)
    route = '/validate/fail'
    top = max(thread_counts)
    out = {'generator': {'seed': cluster.seed, 'users': len(cluster.users),
                         'namespaces': len(cluster.namespaces),
                         'exception_tenants': len(cluster.exception_users)},
           'blocks': [], 'problems': []}
    problems = out['problems']
    base = 0
    recorder = provenance.configure(flight_n=top * per_thread)
    try:
        with exception_tenants(cluster, handlers, oracle.resource_handlers):
            if kernel_checks:
                bodies = [cluster.review_bytes(k) for k in range(8)]
                got, calls = capture_kernel_inputs(
                    lambda: _burst(8, 1, lambda j: server.handle(
                        route, bodies[j]))[0],
                    names=('status_vm', 'fdet_select'))
                base = len(bodies)
                if not calls['status_vm'] or not calls['fdet_select']:
                    raise AssertionError(f'phase 12: K1v or K1h was not '
                                         f'called: {calls.keys()}')
                out['held_to_plain'] = held = _held_to_plain(calls)
                if held['k1_vm'] or held['k1h_fdet_select']:
                    problems.append(f'hetero: kernels differ from their '
                                    f'plain versions: {held}')
                if held['adm_entries'] <= 0 or held['adm_cols'] <= 0:
                    problems.append(f'hetero: K1v ran without admission '
                                    f'entries: {held}')
                bad = [j for j, b in enumerate(bodies)
                       if got[j] != oracle.handle(route, b)]
                if bad:
                    problems.append(f'hetero: captured burst differs from '
                                    f'the host loop at {bad}')
            launches = {}
            for n_threads in thread_counts:
                n = n_threads * per_thread
                idx = range(base, base + n)
                reviews = [cluster.review_bytes(i) for i in idx]
                exc = {cluster.request(i)['uid'] for i in idx
                       if cluster.is_exception_tenant(
                           cluster.request(i)['userInfo']['username'])}
                base += n
                batcher = handlers._get_batcher()
                batcher.reset_stats()
                recorder.reset()
                kernels.reset_launches()
                burst = {}

                def block_run():
                    burst['r'] = _burst(n_threads, per_thread,
                                        lambda j: server.handle(
                                            route, reviews[j]))

                busy = None
                if kernel_checks:
                    # the card's busy time: CUDA events around each K1v
                    # and K1h call of the block, summed after it
                    busy, _calls = request_kernel_ms(
                        block_run, reps=1,
                        names=('status_vm', 'fdet_select'))
                else:
                    block_run()
                got, wall = burst['r']
                for k, v in kernels.LAUNCHES.items():
                    launches[k] = launches.get(k, 0) + v
                stats = batcher.stats()
                paths, exc_paths = {}, {}
                for rec in recorder.records():
                    into = exc_paths if rec.uid in exc else paths
                    into[rec.path] = into.get(rec.path, 0) + 1
                t0 = time.perf_counter()
                bad = [j for j in range(n)
                       if got[j] != oracle.handle(route, reviews[j])]
                block = {'threads': n_threads, 'decisions': n,
                         'exception_decisions': len(exc),
                         'wall_s': wall, 'decisions_per_s': n / wall,
                         'occupancy_mean': stats['occupancy_mean'],
                         'occupancy_p50': stats['occupancy_p50'],
                         'dispatches': stats['dispatches'],
                         'hetero_dispatches': stats['hetero_dispatches'],
                         'hetero_occupancy_mean':
                             stats['hetero_occupancy_mean'],
                         'queue_wait_p50_ms': stats['queue_wait_p50_ms'],
                         'shed': stats['shed'], 'paths': paths,
                         'exception_paths': exc_paths,
                         'device_busy_ms': busy,
                         'device_idle_share': None if busy is None
                         else 1 - busy / (wall * 1e3),
                         'mismatches': len(bad),
                         'check_s': time.perf_counter() - t0}
                if keep:
                    block['responses'] = list(zip(reviews, got))
                out['blocks'].append(block)
                on_batch = paths.get('batch', 0)
                if bad:
                    problems.append(f'hetero {n_threads}: {len(bad)} '
                                    f'responses differ from the host loop: '
                                    f'{bad[:10]}')
                if paths.get('host_fallback'):
                    problems.append(f'hetero {n_threads}: host_fallback '
                                    f'decisions {paths}')
                if on_batch < 0.99 * (n - len(exc)):
                    problems.append(f'hetero {n_threads}: {on_batch} of '
                                    f'{n - len(exc)} decisions of other '
                                    f'tenants on batch: {paths}')
                if sum(paths.values()) != n - len(exc):
                    problems.append(f'hetero {n_threads}: {paths} recorded '
                                    f'for {n - len(exc)} decisions')
    finally:
        provenance.disable()
    out['launches'] = launches
    occ = max(out['blocks'], key=lambda b: b['threads'])['occupancy_mean']
    if top >= 8 and occ <= HET_OCCUPANCY_FLOOR:
        problems.append(f'hetero: mean occupancy {occ} at {top} threads is '
                        f'at or under {HET_OCCUPANCY_FLOOR}')
    return out


def _breaker_row(handlers, key):
    for row in handlers._breakers.report():
        if row['key'] == repr(key):
            return row
    return {'failures': 0}


def chaos_drill(server, handlers, threads: int = CHAOS_THREADS,
                per_thread: int = CHAOS_PER_THREAD) -> dict:
    """(b) ``bench.py admission_chaos`` on the port: the fault-free
    oracle pass of the synthetic cluster's reviews (seed 4321, every
    8th a poison row), then the same reviews from ``threads`` threads
    with the poison marker armed (``KTPU_FAULTS``'s
    ``batcher_dispatch`` site): every response 200 with the oracle's
    verdict, and ``poison_row`` sheds exactly the poison rows.  Then the
    breaker drill (``_chaos_breaker_drill``): three dispatch failures
    open the policy set's breaker, a request while open sheds
    ``breaker_open``, and after the backoff a probe closes it."""
    from kyverno_tpu_torch import faults
    from kyverno_tpu_torch.conformance.loadgen import SyntheticCluster
    from kyverno_tpu_torch.serving import breaker
    cluster = SyntheticCluster(seed=4321, poison_ratio=1 / 8)
    total = threads * per_thread
    route = '/validate/fail'
    policies = _enforce(handlers.cache, cluster.namespaces[0])
    key = handlers._policy_key(policies)
    batcher = handlers._get_batcher()

    def send(i):
        body, status = server.handle_request(route, cluster.review_bytes(i))
        return status, json.loads(body.decode()).get('response')

    out = {'requests': total, 'problems': []}
    problems = out['problems']
    try:
        with exception_tenants(cluster, handlers):
            faults.disable()
            oracle = {i: send(i) for i in range(total + 8)}
            bad = [i for i, (s, _r) in oracle.items() if s != 200]
            if bad:
                raise AssertionError(f'phase 12: oracle requests {bad} '
                                     f'were not 200')
            if handlers._breakers.state(key) != breaker.CLOSED:
                raise AssertionError('phase 12: the breaker is not closed '
                                     'before the poison wave')
            faults.configure(cluster.fault_spec())
            before = dict(batcher.stats()['shed'])
            got, wall = _burst(threads, per_thread, send, strided=True)
            after = dict(batcher.stats()['shed'])
            faults.disable()
            poison = after.get('poison_row', 0) - before.get('poison_row', 0)
            out['wave'] = {
                'wall_s': wall,
                'non_200': sum(1 for s, _r in got if s != 200),
                'verdict_mismatches': sum(
                    1 for i, (_s, r) in enumerate(got) if r != oracle[i][1]),
                'poison_rows_injected': cluster.poison_count(total),
                'poison_rows_shed': poison,
                'shed': {k: after.get(k, 0) - before.get(k, 0)
                         for k in after}}
            w = out['wave']
            if w['non_200'] or w['verdict_mismatches']:
                problems.append(f'chaos: {w["non_200"]} non-200 and '
                                f'{w["verdict_mismatches"]} verdicts '
                                f'different from the oracle')
            if poison != w['poison_rows_injected']:
                problems.append(f'chaos: shed(poison_row) = {poison}, '
                                f'{w["poison_rows_injected"]} injected')
        # every request of the drill rides the device path: no tenant
        # holds exceptions (they change no verdict, so the oracle holds)
        out['breaker'] = _chaos_breaker_drill(
            handlers, policies, key, send, oracle, total, problems)
    finally:
        faults.disable()
    return out


def _chaos_breaker_drill(handlers, policies, key, send, oracle, base,
                         problems) -> dict:
    """The breaker's open → half-open → closed round trip
    (``bench.py _chaos_breaker_drill``): each request's dispatch fails
    twice (the original and the quarantine's solo retry, exhausted),
    which is one breaker failure; each failure drops the scanner, so
    the drill waits for the rebuild before the next.  Every request
    answers 200 with the oracle's verdict through the host loop."""
    from kyverno_tpu_torch import faults
    from kyverno_tpu_torch.observability.metrics import global_registry
    from kyverno_tpu_torch.serving import breaker
    limit = handlers.DEVICE_FAILURE_LIMIT
    drill = {'states': []}
    i = base

    def served(stage):
        nonlocal i
        status, resp = send(i)
        if status != 200 or resp != oracle[i][1]:
            raise AssertionError(f'phase 12: breaker drill {stage}: status '
                                 f'{status}, verdict equal '
                                 f'{resp == oracle[i][1]}')
        i += 1

    def note(stage):
        state = handlers._breakers.state(key)
        drill['states'].append({'stage': stage, 'state': state})
        return state

    if not handlers.wait_device_ready(policies, timeout=READY_S):
        raise AssertionError('phase 12: no scanner before the breaker drill')
    served('entry')     # one healthy dispatch: the failure count starts at 0
    if note('entry') != breaker.CLOSED:
        raise AssertionError('phase 12: breaker not closed entering the '
                             'drill')
    faults.configure(';'.join(
        f'site={faults.SITE_BATCHER_DISPATCH},nth={n},exhaust=1'
        for n in range(1, 2 * limit + 1)))
    for k in range(limit):
        served(f'trip {k}')
        deadline = time.monotonic() + 10.0
        while _breaker_row(handlers, key)['failures'] < k + 1 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        if _breaker_row(handlers, key)['failures'] < k + 1:
            raise AssertionError(f'phase 12: trip request {k} recorded no '
                                 f'device failure')
        if k + 1 < limit:
            handlers.wait_device_ready(policies, timeout=READY_S)
    faults.disable()
    if note('tripped') != breaker.OPEN:
        problems.append(f'chaos: {limit} dispatch failures did not open '
                        f'the breaker')
        return drill
    report = breaker.debug_report()
    if not any(row['state'] == breaker.OPEN for row in report['breakers']):
        problems.append('chaos: /debug/breakers shows no open breaker')
    registry = global_registry()
    if registry is not None:
        drill['open_gauge'] = registry.gauge_value(breaker.BREAKER_STATE,
                                                   state=breaker.OPEN)
    sheds = handlers._get_batcher().stats()['shed']
    before = sheds.get('breaker_open', 0)
    served('open')
    drill['breaker_open_sheds'] = \
        handlers._get_batcher().stats()['shed'].get('breaker_open', 0) - \
        before
    if drill['breaker_open_sheds'] < 1:
        problems.append('chaos: no breaker_open shed while open')
    backoff = max((row.get('reopens_in_s', 0.0)
                   for row in report['breakers']), default=0.0)
    drill['backoff_s'] = backoff
    time.sleep(backoff + 0.1)
    served('half-open probe')           # grants the probe: the rebuild
    if not handlers.wait_device_ready(policies, timeout=READY_S):
        problems.append('chaos: no rebuild in the half-open window')
        return drill
    note('half_open')
    served('recovery')                  # the probe that closes it
    deadline = time.monotonic() + 10.0
    while handlers._breakers.state(key) != breaker.CLOSED and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    if note('recovered') != breaker.CLOSED:
        problems.append(f'chaos: the breaker did not close: '
                        f'{drill["states"]}')
    if registry is not None and registry.gauge_value(
            breaker.BREAKER_STATE, state=breaker.OPEN) > 0:
        problems.append('chaos: the open-state gauge stayed up')
    return drill


def _probe_review(doc: dict, uid: str) -> bytes:
    return json.dumps({
        'apiVersion': 'admission.k8s.io/v1', 'kind': 'AdmissionReview',
        'request': {'uid': uid, 'operation': 'CREATE',
                    'kind': {'group': '', 'version': 'v1', 'kind': 'Pod'},
                    'namespace': doc['metadata']['namespace'],
                    'name': doc['metadata']['name'], 'object': doc,
                    'userInfo': {'username': 'churn-probe'}}}).encode()


def churn_drill(device, threads: int = CHURN_THREADS,
                per_thread: int = CHURN_PER_THREAD, seed: int = 0) -> dict:
    """(c) ``bench.py admission_policy_churn`` on the port, under
    ``KTPU_PARTITIONS`` (set before this process builds a scanner): one
    ``churn_schedule`` edit of the synthetic cluster's burst (seed
    2026), retargeted to a policy that denies a probe Pod, lands at its
    tick; the new text is enforced at once (the host loop serves while
    the touched partition recompiles), the successor scanner hot-swaps
    in with exactly that partition recompiled, and after the swap the
    probe's denial carries the edit's marker and ``threads`` x
    ``per_thread`` reviews run on the swapped scanner, held against the
    host loop."""
    import copy
    import dataclasses
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.api.policy import Policy
    from kyverno_tpu_torch.conformance.loadgen import (SyntheticCluster,
                                                       apply_churn)
    from kyverno_tpu_torch.observability import metrics
    from kyverno_tpu_torch.ops import kernels
    from kyverno_tpu_torch.partition.plan import diff_plans
    from kyverno_tpu_torch.partition.runtime import PARTITION_FALLBACKS
    from kyverno_tpu_torch.webhooks.handlers import SCANNER_HOT_SWAPS
    reg = metrics.global_registry()
    if reg is None:
        reg = metrics.MetricsRegistry()
        metrics.set_global_registry(reg)
    route = '/validate/fail'
    cache, handlers, server, oracle = loadgen_server(device)
    out = {'partitions_env': os.environ.get('KTPU_PARTITIONS', ''),
           'problems': []}
    problems = out['problems']
    try:
        live = _enforce(cache)
        old = handlers._device_scanner(live)
        if old is None or old._pset is None:
            raise AssertionError('phase 12: the partitioned scanner is not '
                                 'serving (KTPU_PARTITIONS unset or the '
                                 'whole set fell back)')
        rng = random.Random(seed)
        probe = target = None
        for i in range(LOADGEN_PROBES):
            doc = smokepack.make_config4_pod(rng, i)
            resp = json.loads(server.handle(
                route, _probe_review(doc, f'probe-{i}')))['response']
            msg = (resp.get('status') or {}).get('message', '')
            hits = [j for j, p in enumerate(live) if p.name in msg]
            if not resp.get('allowed', True) and hits:
                probe = doc
                target = max(hits, key=lambda j: len(live[j].name))
                break
        if probe is None:
            raise AssertionError('phase 12: no probe Pod is denied')
        cluster = SyntheticCluster(seed=2026)
        total = threads * per_thread
        event = dataclasses.replace(
            cluster.churn_schedule(total, len(live))[0], policy_index=target)
        out['event'] = dict(event.to_dict(), policy=live[target].name)
        new_raws = apply_churn([copy.deepcopy(p.raw) for p in live], event)
        swaps0 = reg.counter_value(SCANNER_HOT_SWAPS, kind='validate')
        fallbacks0 = reg.counter_value(PARTITION_FALLBACKS)
        kernels.reset_launches()
        statuses = []
        t_edit = t_enforce = None
        for i in range(total):
            if i == event.tick:
                t_edit = time.perf_counter()
                cache.warm_up([Policy(copy.deepcopy(d)) for d in new_raws])
            if t_edit is not None and t_enforce is None and i % 2:
                body, status = server.handle_request(
                    route, _probe_review(probe, f'churn-p{i}'))
                if event.marker() in body.decode('utf-8', 'replace'):
                    t_enforce = time.perf_counter()
            else:
                body, status = server.handle_request(
                    route, cluster.review_bytes(i))
            statuses.append(status)
        new_live = _enforce(cache)
        swapped = handlers.wait_device_ready(new_live, timeout=READY_S)
        t_swap = time.perf_counter()
        new = handlers._device_scanner(new_live)
        body, status = server.handle_request(
            route, _probe_review(probe, 'churn-after-swap'))
        statuses.append(status)
        enforced = event.marker() in body.decode('utf-8', 'replace')
        wave = [cluster.review_bytes(total + j) for j in range(total)]
        got, wall = _burst(threads, per_thread,
                           lambda j: server.handle_request(route, wave[j]))
        statuses += [s for _b, s in got]
        mismatches = [j for j, (b, _s) in enumerate(got)
                      if b != oracle.handle(route, wave[j])]
        out.update({
            'requests': len(statuses),
            'non_200': sum(1 for s in statuses if s != 200),
            'enforcement_ms': None if t_enforce is None
            else (t_enforce - t_edit) * 1e3,
            'device_swap_s': t_swap - t_edit,
            'enforced_after_swap': enforced,
            'hot_swaps': int(reg.counter_value(SCANNER_HOT_SWAPS,
                                               kind='validate') - swaps0),
            'partition_fallbacks': int(reg.counter_value(
                PARTITION_FALLBACKS) - fallbacks0),
            'wave_wall_s': wall, 'mismatches': len(mismatches),
            'launches': dict(kernels.LAUNCHES)})
        if not swapped or new is None or new._pset is None:
            problems.append('churn: the swap did not land a partitioned '
                            'scanner')
        else:
            diff = diff_plans(old._pset.plan, new._pset.plan)
            out.update(partitions=len(new._pset.runtimes),
                       touched=sorted(diff.touched),
                       recompiled=sorted(new._pset.recompiled()))
            if len(diff.touched) != 1 or \
                    out['recompiled'] != out['touched']:
                problems.append(f'churn: touched {out["touched"]}, '
                                f'recompiled {out["recompiled"]} (one '
                                f'partition expected)')
        if out['non_200']:
            problems.append(f'churn: {out["non_200"]} non-200 responses')
        if t_enforce is None or not enforced:
            problems.append(f'churn: the edit\'s marker was not enforced '
                            f'(before the swap {t_enforce is not None}, '
                            f'after {enforced})')
        if out['hot_swaps'] != 1:
            problems.append(f'churn: {out["hot_swaps"]} hot swaps')
        if out['partition_fallbacks']:
            problems.append(f'churn: {out["partition_fallbacks"]} partition '
                            f'fallbacks to the whole set')
        if mismatches:
            problems.append(f'churn: {len(mismatches)} responses after the '
                            f'swap differ from the host loop')
    finally:
        handlers.shutdown()
    return out


def loadgen_child(args) -> int:
    """(c) in a process of its own: ``KTPU_PARTITIONS`` set before any
    scanner is built; writes the record to ``--loadgen-child``'s file."""
    import torch
    os.environ['KTPU_PARTITIONS'] = str(CHURN_PARTITIONS)
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        _die('torch.cuda.is_available() is False')
    rec = churn_drill(args.device, seed=args.seed)
    with open(args.loadgen_child, 'w') as f:
        json.dump(rec, f)
    return 0


#: the small kuttl suite of phase 12 and tests/test_torch_conformance.py,
#: in the corpus' shapes: a policy, a Pod it denies (the ``if kubectl
#: apply`` script), the Pod's absence, a Pod it admits, and the
#: PolicyReport the reports daemon writes for it
KUTTL_SUITE = {
    '01-policy.yaml': '''apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: require-team-label
spec:
  validationFailureAction: Enforce
  background: true
  rules:
    - name: check-team
      match:
        any:
          - resources:
              kinds: [Pod]
      validate:
        message: "label 'team' is required"
        pattern:
          metadata:
            labels:
              team: "?*"
''',
    '02-script.yaml': '''apiVersion: kuttl.dev/v1beta1
kind: TestStep
commands:
  - script: |
      if kubectl apply -f pod-bad.yaml
      then
        echo "Tested failed. Pod was created when it shouldn't have been."
        exit 1
      else
        echo "Test succeeded. Pod was not created as intended."
        exit 0
      fi
''',
    'pod-bad.yaml': '''apiVersion: v1
kind: Pod
metadata:
  name: badpod
  namespace: default
spec:
  containers:
    - name: nginx
      image: nginx:1.25.3
''',
    '03-errors.yaml': '''apiVersion: v1
kind: Pod
metadata:
  name: badpod
  namespace: default
''',
    '04-pod-good.yaml': '''apiVersion: v1
kind: Pod
metadata:
  name: goodpod
  namespace: default
  labels:
    team: payments
spec:
  containers:
    - name: nginx
      image: nginx:1.25.3
''',
    '05-assert.yaml': '''apiVersion: wgpolicyk8s.io/v1alpha2
kind: PolicyReport
metadata:
  name: cpol-require-team-label
  namespace: default
results:
  - policy: require-team-label
    rule: check-team
    result: pass
    resources:
      - kind: Pod
        name: goodpod
summary:
  pass: 1
  fail: 0
''',
}


def write_kuttl_suite(path: str, failing: bool = False) -> str:
    """Write ``KUTTL_SUITE`` into ``path``; with ``failing`` its report
    assert expects the admitted Pod to fail, which must raise
    ``KuttlFailure``."""
    os.makedirs(path, exist_ok=True)
    for name, text in KUTTL_SUITE.items():
        if failing and name == '05-assert.yaml':
            text = text.replace('result: pass', 'result: fail')
        with open(os.path.join(path, name), 'w') as f:
            f.write(text)
    return path


def kuttl_drill(tmp: str, device) -> dict:
    """The kuttl suite through ``run_suite(..., device=device)``: the
    admission, background and reports daemons of the harness's cluster
    on ``device``."""
    from kyverno_tpu_torch.conformance.kuttl import run_suite
    from kyverno_tpu_torch.ops import kernels
    suite = write_kuttl_suite(os.path.join(tmp, 'kuttl-require-team'))
    kernels.reset_launches()
    t0 = time.perf_counter()
    run_suite(suite, device=device)
    return {'steps': len([n for n in KUTTL_SUITE if n[0].isdigit()]),
            'wall_s': time.perf_counter() - t0,
            'launches': dict(kernels.LAUNCHES)}


def loadgen_phase(seed: int, tmp: str, device: str = 'cuda:0') -> dict:
    """Phase 12: (a) and (b) here on one batch-mode handler set, (c) in
    a child process (``--loadgen-child OUT``), then the kuttl suite.
    On the card K1v (with K1i) and K1h must launch in (a) and (c), and
    K1v in the kuttl suite; with ``device='cpu'`` the phase rehearses
    without the kernel checks."""
    on_card = str(device).startswith('cuda')
    problems = []
    t0 = time.perf_counter()
    _cache, handlers, server, oracle = loadgen_server(device)
    setup_s = time.perf_counter() - t0
    try:
        hetero = hetero_drill(server, handlers, oracle,
                              kernel_checks=on_card)
        chaos = chaos_drill(server, handlers)
    finally:
        handlers.shutdown()
    problems += hetero['problems'] + chaos['problems']
    out_path = os.path.join(tmp, 'churn.json')
    logs = (os.path.join(tmp, 'churn.out'), os.path.join(tmp, 'churn.err'))
    cmd = [sys.executable, os.path.abspath(__file__), '--seed', str(seed),
           '--device', str(device), '--loadgen-child', out_path]
    t1 = time.perf_counter()
    with open(logs[0], 'w') as o, open(logs[1], 'w') as e:
        child = subprocess.run(cmd, cwd=HERE, stdout=o, stderr=e,
                               timeout=LOADGEN_CHILD_TIMEOUT_S)
    if child.returncode != 0 or not os.path.exists(out_path):
        with open(logs[1]) as e:
            tail = e.read()[-3000:]
        raise AssertionError(f'phase 12: the churn child exited '
                             f'{child.returncode}:\n{tail}')
    with open(out_path) as f:
        churn = json.load(f)
    churn['process_s'] = time.perf_counter() - t1
    problems += churn['problems']
    kuttl = kuttl_drill(tmp, device)
    if on_card:
        for name, launched in (('hetero', hetero['launches']),
                               ('churn', churn['launches'])):
            for k in SCAN_KERNELS:
                if launched.get(k, 0) <= 0:
                    problems.append(f'{name}: {k} never launched')
        if kuttl['launches'].get('k1_vm', 0) <= 0:
            problems.append('kuttl: K1v never launched')
    return {'setup_s': setup_s, 'hetero': hetero, 'chaos': chaos,
            'churn': churn, 'kuttl': kuttl, 'problems': problems,
            'launches': {k: hetero['launches'].get(k, 0) +
                         churn['launches'].get(k, 0) +
                         kuttl['launches'].get(k, 0)
                         for k in set(hetero['launches']) |
                         set(churn['launches']) | set(kuttl['launches'])}}


def loadgen_line(lg: dict) -> dict:
    """The phase's printed line: per thread count of (a), the chaos
    wave and breaker round trip of (b), the churn of (c) and the kuttl
    suite."""
    h, c, ch = lg['hetero'], lg['chaos'], lg['churn']
    return {
        'hetero': [{k: b[k] for k in (
            'threads', 'decisions_per_s', 'occupancy_mean',
            'occupancy_p50', 'hetero_dispatches', 'queue_wait_p50_ms',
            'device_busy_ms', 'device_idle_share', 'shed', 'paths',
            'exception_decisions', 'mismatches')}
            for b in h['blocks']],
        'held_to_plain': h.get('held_to_plain'),
        'chaos': dict(c.get('wave', {}), breaker=[
            s['state'] for s in c.get('breaker', {}).get('states', [])],
            breaker_open_sheds=c.get('breaker', {}).get(
                'breaker_open_sheds')),
        'churn': {k: ch.get(k) for k in (
            'event', 'requests', 'non_200', 'enforcement_ms',
            'device_swap_s', 'enforced_after_swap', 'hot_swaps',
            'partitions', 'touched', 'recompiled', 'partition_fallbacks',
            'mismatches', 'process_s')},
        'kuttl': lg['kuttl'], 'launches': lg['launches']}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--pods', type=int, default=MIN_PODS,
                    help='Pods of the scans and of the reports daemon\'s '
                         'cluster (100,000 is the full configuration)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--mesh-child', type=int, metavar='RANK',
                    help='run as one rank of the two-rank mesh phase')
    ap.add_argument('--store', help='(--mesh-child) rendezvous file')
    ap.add_argument('--step-rows', type=int, default=MESH_CHILD_STEP_ROWS,
                    help='(--mesh-child) Pods of the distributed step')
    ap.add_argument('--device', default='cuda:0',
                    help='(--mesh-child, --admission-child) the device')
    ap.add_argument('--partitioned-child', metavar='OUT',
                    help='run phase 9b and write its result to OUT')
    ap.add_argument('--admission-child', metavar='OUT',
                    help='run one admission daemon of phase 10 and write '
                         'its result to OUT')
    ap.add_argument('--reviews', type=int, default=DAEMON_REVIEWS,
                    help='(--admission-child) /validate/fail and /mutate '
                         'reviews each')
    ap.add_argument('--namespaces', type=int, default=DAEMON_NAMESPACES,
                    help='(--admission-child, --restart-child) Namespace '
                         'creations')
    ap.add_argument('--reports-pods', type=int, default=REPORTS_PODS,
                    help='Pods of the reports daemon\'s cluster (phase 9; '
                         '100,000 is the full configuration)')
    ap.add_argument('--restart-child', nargs=2, metavar=('FIRST|SECOND',
                                                         'OUT'),
                    help='run one process of phase 11 against '
                         '--api-server and write its result to OUT')
    ap.add_argument('--api-server', metavar='URL',
                    help='(--restart-child) the API server')
    ap.add_argument('--loadgen-child', metavar='OUT',
                    help='run phase 12c (policy churn) and write its result '
                         'to OUT')
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, 'kyverno_tpu_torch')):
        _die('kyverno_tpu_torch/ is not beside this script; run it from a '
             'checkout of the repository')
    sys.path.insert(0, HERE)
    if args.mesh_child is not None:
        if not args.store:
            _die('--mesh-child needs --store')
        return mesh_child(args)
    if args.partitioned_child:
        return partitioned_child(args)
    if args.admission_child:
        return admission_child(args)
    if args.restart_child:
        if not args.api_server:
            _die('--restart-child needs --api-server')
        return restart_child(args)
    if args.loadgen_child:
        return loadgen_child(args)
    import torch
    if not torch.cuda.is_available():
        _die('torch.cuda.is_available() is False: this script measures '
             'the CUDA card and has no CPU mode')
    # forked encode workers use as many cores as the card's host spares
    os.environ.setdefault('KTPU_ENCODE_PROCS', '4')
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    from kyverno_tpu_torch.mutate import MutateScanner
    from kyverno_tpu_torch.ops import _build
    report = {'argv': sys.argv[1:], 'seed': args.seed}
    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        t_phase = now

    # 1. card -------------------------------------------------------------
    smi = _nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    card = {'nvidia_smi': smi, 'torch': torch.__version__,
            'cuda': torch.version.cuda, 'kernel_build_s': build_s,
            'per_kernel_build_s': built}
    report['ptxas'] = {n: _build.build_log(n) for n in _build.KERNELS}
    card['ptxas'] = {n: ptxas_summary(log)
                     for n, log in report['ptxas'].items()}
    print('card ' + json.dumps(card), flush=True)
    report['card'] = card
    phase_done('card')

    policies = smokepack.load_smoke_pack()
    n = max(args.pods, 1)
    if n < MIN_PODS:
        print(f'cut: {n} Pods requested, below three full chunks; '
              f'scanning {MIN_PODS}', flush=True)
        n = MIN_PODS
    elif n < 100_000:
        print(f'cut: the slice and the restricted scan run over {n} Pods '
              f'instead of 100000', flush=True)
    rng = random.Random(args.seed)
    pods = [smokepack.make_config4_pod(rng, i) for i in range(n)]
    scanner = BatchScanner(policies)       # on the card by default
    rpolicies = smokepack.load_restricted_pack()
    rrng = random.Random(args.seed)
    rpods = [smokepack.make_restricted_pod(rrng, i) for i in range(n)]
    rscanner = BatchScanner(rpolicies)
    # fork the encode workers before this process creates a CUDA
    # context, so no child ever inherits one
    scanner._encoder_pool.start()
    rscanner._encoder_pool.start()
    device = scanner.device
    eager = {j: r for j, r in scanner._evaluator.routes.items()
             if r[0] != 'vm'}
    if eager:
        raise AssertionError(f'smoke pack programs on the eager walk: '
                             f'{eager}')
    try:
        # 2. kernels ------------------------------------------------------
        report['float64_division'] = float64_division_check(device)
        print('float64_division ' + json.dumps(report['float64_division']),
              flush=True)
        seen, chunk_stats = first_chunk_inputs(scanner, pods, device)
        records = kernel_phase(seen, device, args.seed)
        print('kernels ' + json.dumps(
            {r['name']: dict({k: r.get(k) for k in (
                'max_abs_err', 'ms', 'kernel_device_ms', 'plain_ms',
                'library_ms', 'cases', 'global_mode_ms', 'plan', 'ptxas')
                if k in r},
                bound_us=r['bound_ms'] * 1e3) for r in records}),
              flush=True)
        print('k1_chunk ' + json.dumps({k: chunk_stats[k] for k in (
            'rows', 'host_dispatch_ms', 'plan_lookup_us', 'device_span_ms',
            'device_busy_ms', 'k1v_check', 'aten_ops', 'eager_walk',
            'routes')}), flush=True)
        report['first_chunk'] = chunk_stats
        phase_done('kernels')

        # 3. slice --------------------------------------------------------
        sl, slice_digests = slice_phase(scanner, policies, pods)
        print('slice ' + json.dumps(sl), flush=True)
        report['slice'] = sl
        if sl['mismatches']:
            raise AssertionError(f'{sl["mismatches"]} rows differ from the '
                                 f'host engine: {sl["first_mismatches"]}')
        phase_done('slice')

        # 4. mesh ---------------------------------------------------------
        mesh = mesh_phase(policies, pods, scanner, slice_digests, device,
                          args.seed)
        report['mesh'] = {k: v for k, v in mesh.items() if k != 'k4'}
        phase_done('mesh')
    finally:
        scanner._encoder_pool.close()

    # 5. K3 -------------------------------------------------------------
    mpolicies = smokepack.load_mutate_pack()
    mrng = random.Random(args.seed + 7)
    mpods = [smokepack.make_mutate_pod(mrng, i) for i in range(MUTATE_CHUNK)]
    mscanner = MutateScanner(mpolicies)     # on the card by default
    if not mscanner.ok:
        raise AssertionError('the mutate pack did not lower')
    k3 = k3_phase(mscanner, mpods, device, args.seed)
    print('k3 ' + json.dumps({n: {k: c[k] for k in (
        'shape', 'max_abs_err', 'ms', 'kernel_device_ms',
        'plain_ms', 'bound_ms', 'status_counts', 'bit31_rows')}
        for n, c in k3['cases'].items()}), flush=True)
    records.append(k3)
    phase_done('k3')

    # 6. mutate chunk ---------------------------------------------------
    mu = mutate_phase(mscanner, mpolicies, mpods, args.seed)
    print('mutate ' + json.dumps(mu), flush=True)
    report['mutate'] = mu
    if mu['mismatches']:
        raise AssertionError(f'{mu["mismatches"]} mutate rows differ from '
                             f'the host chain: {mu["first_mismatches"]}')
    phase_done('mutate')

    # 7. admission ------------------------------------------------------
    adm = admission_phase(args.seed)
    print('k1_admission ' + json.dumps(
        adm['kernels_at_admission']['k1_call']), flush=True)
    print('admission ' + json.dumps(adm), flush=True)
    report['admission'] = adm
    phase_done('admission')

    # 8. restricted -----------------------------------------------------
    try:
        rs = restricted_phase(rscanner, rpolicies, rpods, device, args.seed)
    finally:
        rscanner._encoder_pool.close()
    report['restricted'] = rs
    phase_done('restricted')

    # 9. the reports controller -----------------------------------------
    nr = max(args.reports_pods, 1)
    if nr < 100_000:
        print(f'cut: the reports daemon runs over {nr} Pods instead of '
              f'100000', flush=True)
    if nr <= n:
        rpods_9 = pods[:nr]
    else:
        prng = random.Random(args.seed)
        rpods_9 = [smokepack.make_config4_pod(prng, i) for i in range(nr)]
    nb = min(nr, MIN_PODS)
    if nb < nr:
        print(f'cut: the partitioned ticks run over {nb} Pods instead of '
              f'{nr}', flush=True)
    import tempfile
    with tempfile.TemporaryDirectory(prefix='ktpu-reports-') as tmp:
        rp = reports_phase(policies, rpods_9, slice_digests[:nr], nb,
                           args.seed, tmp)
    del rpods_9
    print('reports ' + json.dumps(rp['whole']), flush=True)
    print('partitioned ' + json.dumps(rp['partitioned']), flush=True)
    report['reports'] = rp
    if rp['problems']:
        raise AssertionError('reports: ' + '; '.join(rp['problems']))
    phase_done('reports')

    # 10. the admission-controller daemon, cold and warm ----------------
    with tempfile.TemporaryDirectory(prefix='ktpu-daemon-') as tmp:
        ad = admission_daemon_phase(args.seed, tmp)
    print('admission_daemon ' + json.dumps({name: {k: ad[name][k] for k in (
        'ready_s', 'start_up_s', 'mutate_ready_s', 'wall_s', 'warmer',
        'lowered_by_source', 'compile_cache', 'reviews', 'serve_s',
        'requests_per_s', 'validate_paths', 'launches', 'kernel_checks',
        'update_requests', 'network_policies', 'admission_reports',
        'mismatches')} for name in ('cold', 'warm')}), flush=True)
    report['admission_daemon'] = ad
    if ad['problems']:
        raise AssertionError('admission daemon: ' +
                             '; '.join(ad['problems']))
    phase_done('admission_daemon')

    # 11. the daemons over HTTP, restarted on the state they left -------
    with tempfile.TemporaryDirectory(prefix='ktpu-restart-') as tmp:
        rs11 = restart_phase(args.seed, tmp)
    print('restart ' + json.dumps(restart_line(rs11)), flush=True)
    report['restart'] = rs11
    if rs11['problems']:
        raise AssertionError('restart: ' + '; '.join(rs11['problems']))
    phase_done('restart')

    # 12. the load generator's drills and the kuttl harness -------------
    with tempfile.TemporaryDirectory(prefix='ktpu-loadgen-') as tmp:
        lg = loadgen_phase(args.seed, tmp)
    print('loadgen ' + json.dumps(loadgen_line(lg)), flush=True)
    report['loadgen'] = lg
    if lg['problems']:
        raise AssertionError('loadgen: ' + '; '.join(lg['problems']))
    phase_done('loadgen')
    for r in records:
        # K1v, K1h, K1c and K3 are held at the admission webhook's shapes:
        # its launches, and the times and bound of the kernel at the
        # shapes that path gave it; the chunk-shape numbers stay beside
        r['launches'] = adm['launches'].get(r['name'], 0)
        at = adm['kernels_at_admission'][r['name']]
        keys = K1V_AT_SHAPE if r['name'] == 'k1_vm' else AT_SHAPE
        r['at_chunk'] = {k: r[k] for k in keys}
        r.update({k: at[k] for k in keys})
        r['max_abs_err'] = max(r['max_abs_err'], at['max_abs_err'])
    # K4h runs on the mesh path, and is held at the step's shapes
    k4 = dict(mesh['k4'], launches=mesh['launches']['k4_status_hist'])
    records.append(k4)
    for r in records:
        r['launches_by_path'] = {
            'scan': sl['launches'].get(r['name'], 0),
            'mesh': mesh['launches'].get(r['name'], 0),
            'mesh_2rank': mesh['two_rank']['launches'].get(r['name'], 0),
            'mutate_chunk': mu['launches'].get(r['name'], 0),
            'admission': adm['launches'].get(r['name'], 0),
            'restricted_scan': rs['slice']['launches'].get(r['name'], 0),
            'restricted_admission': rs['admission']['launches'].get(
                r['name'], 0),
            'reports': sum(rp['whole'][t]['launches'].get(r['name'], 0)
                           for t in ('cold', 'replay', 'edit')),
            'partitioned': sum(
                rp['partitioned'][t]['launches'].get(r['name'], 0)
                for t in ('cold', 'edit')),
            # the warm daemon's counted pass, its programs from the store
            'admission_daemon': ad['warm']['launches'].get(r['name'], 0),
            # the restarted process of phase 11: its reports tick (a
            # replay) and its admission daemon's counted pass
            'restart': rs11['second']['reports']['launches'].get(
                r['name'], 0) + rs11['second']['admission'][
                    'launches'].get(r['name'], 0),
            # phase 12: (a) the heterogeneous blocks, (c) the churn
            # process and the kuttl suite's daemons
            'loadgen': lg['launches'].get(r['name'], 0),
            # the eager walks that hold K1v against its plain version
            # (K1c runs only there: on the main path its DP is in K1v)
            'k1v_checks': chunk_stats['k1v_check']['capture_launches'].get(
                r['name'], 0) + adm['kernels_at_admission']['k1_call'][
                    'k1v_check']['capture_launches'].get(r['name'], 0)}
    report['kernels'] = records
    report['phase_s'] = phase_s
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    report['device'] = {'kind': kind, 'count': count}
    out_dir = os.path.join(HERE, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as f:
        json.dump(report, f, indent=1)
    if adm['problems']:
        raise AssertionError('admission: ' + '; '.join(adm['problems']))
    print('phases ' + json.dumps(dict(
        phase_s, total=sum(phase_s.values()))), flush=True)
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
