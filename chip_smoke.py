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
3. ``slice``: ``scan_report_results`` over ``--pods`` Pods (default
   100,000, a large production cluster) with the smoke pack's 12
   policies: Pods/s, decisions/s, the stage breakdown, the
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
   strict`` foreach rules and the admission-lanes pack) over 100,000
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

    python3 chip_smoke.py [--pods N] [--seed S]

(``--mesh-child RANK`` is the mode phase 4c starts its two ranks in.)

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
    """sha256 of each report row: its results and summary as canonical
    JSON (the policies' names are in the results)."""
    import hashlib
    return [hashlib.sha256(json.dumps([r[0], r[1]], sort_keys=True)
                           .encode()).digest() for r in rows]


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

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--pods', type=int, default=100_000)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--mesh-child', type=int, metavar='RANK',
                    help='run as one rank of the two-rank mesh phase')
    ap.add_argument('--store', help='(--mesh-child) rendezvous file')
    ap.add_argument('--step-rows', type=int, default=MESH_CHILD_STEP_ROWS,
                    help='(--mesh-child) Pods of the distributed step')
    ap.add_argument('--device', default='cuda:0',
                    help='(--mesh-child) the rank\'s device')
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, 'kyverno_tpu_torch')):
        _die('kyverno_tpu_torch/ is not beside this script; run it from a '
             'checkout of the repository')
    sys.path.insert(0, HERE)
    if args.mesh_child is not None:
        if not args.store:
            _die('--mesh-child needs --store')
        return mesh_child(args)
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
        print(f'cut: scanning {n} Pods instead of 100000', flush=True)
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
