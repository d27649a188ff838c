"""Device mesh + sharded evaluation step.

The scaling model (SURVEY.md §2.6): policy evaluation is embarrassingly
data-parallel over the resource batch axis — the device-native
equivalent of the reference's horizontally replicated webhook pods. The
compiled check program is replicated, the batch is sharded over a 1-D
``data`` mesh axis, and the only cross-device communication is the
verdict-summary reduction (an all-reduce), plus the row gather that
lets every rank assemble the same reports.

The mesh is one ``torch.distributed`` process (rank) per device, the
layout of DDP and ``torchrun``: NCCL between CUDA cards, gloo between
host processes.  Every rank encodes the whole padded batch, so element
widths and the packed layout agree on every rank, and stages only its
own row slice on its device.
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..compiler.ir import CompiledPolicySet


class Mesh:
    """A 1-D data mesh over the ranks of a ``torch.distributed`` process
    group: this rank's ``rank``, ``world_size``, ``backend``, ``device``
    and ``devices`` (every rank's device, in rank order).  ``group``
    None is a one-rank mesh that calls no collective.

    Collectives run on tensors on the backend's device: this rank's
    card under NCCL, host copies under any other backend (gloo)."""

    def __init__(self, group, rank: int, world_size: int,
                 backend: Optional[str], device: torch.device,
                 devices: List[str], axis: str = 'data'):
        self.group = group
        self.rank = rank
        self.world_size = world_size
        self.backend = backend
        self.device = device
        self.devices = devices
        self.axis = axis
        self.coll_device = device if backend == 'nccl' \
            else torch.device('cpu')

    def row_slice(self, rows: int) -> slice:
        """This rank's rows of a ``rows``-row batch."""
        if rows % self.world_size:
            raise ValueError(
                f'a batch of {rows} rows does not divide over a mesh of '
                f'{self.world_size} ranks; pad it to a multiple '
                f'(pad_to_multiple)')
        per = rows // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks (on the collective's device)."""
        if self.group is None:
            return t
        buf = t.to(self.coll_device).contiguous()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated on the row axis, in rank
        order (on the collective's device)."""
        if self.group is None:
            return t
        buf = t.to(self.coll_device).contiguous()
        out = torch.empty((buf.shape[0] * self.world_size,) +
                          tuple(buf.shape[1:]), dtype=buf.dtype,
                          device=buf.device)
        dist.all_gather_into_tensor(out, buf, group=self.group)
        return out


def _rank_device(device, rank: int) -> torch.device:
    """This rank's device: ``device`` when given, else ``cuda:{LOCAL_RANK}``
    or ``cuda:{rank % device_count}`` (raises without CUDA)."""
    from ..device import resolve_device
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    local = os.environ.get('LOCAL_RANK')
    index = int(local) if local is not None \
        else rank % max(1, torch.cuda.device_count())
    return torch.device('cuda', index)


def make_mesh(group=None, device=None, axis: str = 'data') -> Mesh:
    """The mesh over ``group`` (default: the initialized default group;
    with none initialized, one rank and no group) with this rank on
    ``device`` (default: its CUDA card; ``'cpu'`` for the host)."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        dev = _rank_device(device, 0)
        return Mesh(None, 0, 1, None, dev, [str(dev)], axis)
    rank = dist.get_rank(group)
    world_size = dist.get_world_size(group)
    backend = dist.get_backend(group)
    dev = _rank_device(device, rank)
    if backend == 'nccl':
        if dev.type != 'cuda':
            raise ValueError(f'an NCCL mesh needs a CUDA device, got {dev}')
        # NCCL's object collectives run on the current card
        torch.cuda.set_device(dev)
    devices: List[Optional[str]] = [None] * world_size
    dist.all_gather_object(devices, str(dev), group=group)
    return Mesh(group, rank, world_size, backend, dev,
                [str(d) for d in devices], axis)


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def build_sharded_evaluator(cps: CompiledPolicySet, mesh: Mesh,
                            axis: str = 'data'):
    """The mesh-sharded evaluation step.

    Returns ``(statuses [R/N, P] of this rank's rows, details, summary
    [P, 6] summed over every rank)`` where summary counts each status
    code per rule across all shards — the all-reduce that replaces the
    reference's report aggregation fan-in (reference:
    pkg/controllers/report/aggregate/controller.go).
    """
    from ..compiler.ir import N_STATUS_CODES
    from ..ops import kernels
    from ..ops.eval import build_evaluator
    evaluator = build_evaluator(cps, mesh.device)
    n_codes = N_STATUS_CODES

    def run(tensors, layout):
        # the layout rides with each call and the evaluator serializes
        # its own eager walks, so no lock is taken here.  K1v reads the
        # packed buffers themselves (evaluator.raw's packed entry)
        statuses, details, _fdet = evaluator.raw(tensors, layout)
        # the encoder's row-validity lane: canonical-capacity padding
        # rows must not count in the cross-shard verdict summary.  K4h
        # reads it in place, a strided view of its packed buffer
        rv = evaluator.plan_for(layout).rowvalid_at
        rowvalid = tensors[rv[0]][:, rv[1]].view(torch.uint8) \
            if rv is not None else None
        # fdet is dropped here: the distributed summary path never
        # synthesizes messages (K1v still computes it)
        # per-rule verdict histogram over the status codes (K4h), then
        # the partial sums all-reduced over the mesh
        summary = kernels.status_histogram(statuses, rowvalid, n_codes)
        summary = mesh.all_reduce_sum(summary)
        return statuses, details, summary

    return run


def shard_tensors(tensors: Dict[str, np.ndarray], mesh: Mesh,
                  axis: str = 'data') -> Tuple[Dict[str, Any], Dict]:
    """Place this rank's rows of the batch tensors on its device."""
    from ..ops.eval import shard_batch
    return shard_batch(tensors, mesh.device, mesh=mesh)


# (cps id, mesh, axis) -> sharded evaluator. LRU with single-entry
# eviction; the cps entry keeps a strong reference to the keyed object so
# ids cannot be recycled while cached.
from collections import OrderedDict

_SHARDED_CACHE: 'OrderedDict[Tuple[int, Mesh, str], Tuple[CompiledPolicySet, Any]]' = OrderedDict()
_SHARDED_CACHE_MAX = 16


def _cached_sharded_evaluator(cps: CompiledPolicySet, mesh: Mesh, axis: str):
    key = (id(cps), mesh, axis)
    hit = _SHARDED_CACHE.get(key)
    if hit is not None and hit[0] is cps:
        _SHARDED_CACHE.move_to_end(key)
        return hit[1]
    step = build_sharded_evaluator(cps, mesh, axis)
    while len(_SHARDED_CACHE) >= _SHARDED_CACHE_MAX:
        _SHARDED_CACHE.popitem(last=False)
    _SHARDED_CACHE[key] = (cps, step)
    return step


def shard_wait_splits(array: torch.Tensor) -> List[float]:
    """Readback-wait split of this rank's shard: block until the
    just-dispatched ``array`` (this rank's rows) is ready and time the
    wait.  The split attributes wall to the shard the host was actually
    waiting on; the ``mesh_shard`` fault site is checked inside the
    timed split, so an injected ``delay_ms`` clause inflates exactly
    this shard's wall."""
    from .. import faults
    t0 = time.perf_counter()
    faults.check(faults.SITE_MESH_SHARD)
    if array.device.type == 'cuda':
        # ktpu: noqa[KTPU101] -- the fleet observatory times this wait
        torch.cuda.current_stream(array.device).synchronize()
    return [time.perf_counter() - t0]


def record_sharded_dispatch(mesh: Mesh, axis: str, n_rows: int,
                            padded_rows: int,
                            shard_walls: List[float],
                            collective_s: float,
                            step_wall: Optional[float] = None,
                            span=None):
    """Publish one sharded dispatch's telemetry: this rank's shard
    device-eval walls (labelled by their global shard index), skew
    verdict, collective wall and padding waste — on the fleet-scoped
    mesh metrics (KTPU509 holds these write sites to their shard/mesh
    identity labels) and the ``kyverno/mesh/step`` span when the caller
    passes one.  Returns the skew verdict."""
    from ..observability import fleet
    n_dev = mesh.world_size
    mesh_key = f'{axis}{n_dev}'
    first = mesh.rank * len(shard_walls)
    devices = list(mesh.devices[first:first + len(shard_walls)])
    verdict = fleet.record_step(mesh_key, shard_walls, devices)
    registry = fleet.registry()
    if registry is not None:
        for i, wall_s in enumerate(shard_walls):
            registry.observe(fleet.MESH_STEP_DURATION, wall_s,
                             shard=str(first + i))
        if step_wall is not None:
            registry.observe(fleet.MESH_STEP_DURATION, step_wall,
                             shard='all')
        # skew describes the mesh step in flight — reset-on-close so a
        # drained host doesn't export its last imbalance forever
        registry.mark_reset_on_close(fleet.MESH_SHARD_SKEW)
        registry.set_gauge(fleet.MESH_SHARD_SKEW, verdict['skew'],
                           mesh=mesh_key)
        registry.inc(fleet.MESH_COLLECTIVE_SECONDS, collective_s,
                     mesh=mesh_key)
        registry.inc(fleet.MESH_PADDING_ROWS,
                     float(max(0, padded_rows - n_rows)), mesh=mesh_key)
    if span is not None:
        per = padded_rows // max(1, n_dev)
        occupancy = [min(max(n_rows - i * per, 0), per)
                     for i in range(n_dev)]
        span.set_attribute('mesh', mesh_key)
        span.set_attribute('rows', n_rows)
        span.set_attribute('padding_rows', max(0, padded_rows - n_rows))
        span.set_attribute('shard_rows', ','.join(map(str, occupancy)))
        span.set_attribute('skew', verdict['skew'])
        span.set_attribute('slow_shard', verdict['slow_shard'])
        span.set_attribute('collective_s', round(collective_s, 6))
        if verdict.get('sustained'):
            span.set_attribute('bound_by', 'straggler')
    return verdict


def distributed_scan_step(cps: CompiledPolicySet, mesh: Mesh,
                          resources: List[dict], axis: str = 'data'):
    """Encode + evaluate a batch across the mesh; returns (statuses, summary).

    The batch pads to the canonical capacity (``compiler/shapes.py``),
    rounded up to a multiple of the mesh size so every shard gets
    identical shapes; the encoder's ``__rowvalid__`` lane keeps the
    padding rows out of the verdict summary.  Every rank returns the
    whole ``int8 [n, P]`` status matrix (gathered in rank order) and
    the ``int64 [P, 6]`` summary.

    With the fleet observatory armed (``observability/fleet.py``;
    ``KTPU_FLEET=0`` pins it off) every dispatch additionally records
    this rank's readback-wait split, the collective wall and padding
    waste under a ``kyverno/mesh/step`` span — the timing never
    touches the computed values, so output stays bit-identical.
    """
    from ..compiler.encode import encode_batch
    from ..compiler.shapes import canonical_capacity
    from ..observability import fleet
    fl = fleet.enabled()
    n = len(resources)
    n_dev = mesh.world_size
    padded = pad_to_multiple(
        max(canonical_capacity(max(n, n_dev)), n), n_dev)
    span_cm = nullcontext()
    if fl:
        from ..observability import tracing
        span_cm = tracing.start_span('kyverno/mesh/step')
    with span_cm as span:
        t_start = time.perf_counter() if fl else 0.0
        batch = encode_batch(resources, cps, padded_n=padded)
        raw = batch.tensors()
        tensors, layout = shard_tensors(raw, mesh, axis)
        step = _cached_sharded_evaluator(cps, mesh, axis)
        statuses, details, summary = step(tensors, layout)
        shard_walls = None
        t_coll = 0.0
        if fl:
            shard_walls = shard_wait_splits(statuses)
            t_coll = time.perf_counter()
        if mesh.world_size > 1:
            # each rank only holds its rows of the batch axis — gather
            # the full status matrix (the all-reduced summary is already
            # the same on every rank)
            statuses = mesh.all_gather_rows(statuses)
        collective_s = 0.0
        if fl:
            # the all-reduced summary's readback (plus the gather
            # above) is the step's cross-shard collective
            # ktpu: noqa[KTPU101] -- the summary's readback, past the
            # all_reduce, timed for the fleet observatory
            summary = summary.cpu()
            collective_s = time.perf_counter() - t_coll
        # ktpu: noqa[KTPU101] -- the step's readback, past the all_reduce
        statuses_np = statuses.cpu().numpy()[:n]
        summary_np = summary.cpu().numpy()  # ktpu: noqa[KTPU101] -- same
        if fl:
            record_sharded_dispatch(
                mesh, axis, n, padded, shard_walls, collective_s,
                step_wall=time.perf_counter() - t_start, span=span)
    from ..observability import coverage
    if coverage.enabled():
        # the padded rows are already masked out of the summary, so the
        # STATUS_HOST column IS the host-replay row count of this step
        from ..compiler.ir import STATUS_HOST
        total = int(summary_np.sum())
        host = int(summary_np[:, STATUS_HOST].sum())
        coverage.record_scan(total - host, host)
    return statuses_np, summary_np
