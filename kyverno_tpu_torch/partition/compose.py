"""Merge per-partition compact verdict buffers into the whole-set
verdict contract.

Per-rule compilation is independent — a rule lowers to the same
``RuleProgram`` whether its policy is compiled alone or inside the full
set — so a partition's program list is value-identical to the whole-set
program list restricted to its members.  Composition is therefore pure
index bookkeeping: scatter each partition's program columns into the
global column order, and remap each partition's anyPattern auxiliary
fdet blocks (local base offsets) onto the whole-set evaluator's aux
layout.  No verdict value is ever recomputed or approximated, which is
what makes ``KTPU_PARTITIONS=N`` bit-identical to the
``KTPU_PARTITIONS=0`` oracle.

Both mappings are validated eagerly at construction; any mismatch
raises :class:`PartitionError` and the scanner falls back to the
monolithic path rather than risk a wrong verdict.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .plan import PartitionError


class Composer:
    """Precomputed scatter maps from per-partition output buffers into
    whole-set ``(statuses, details, fdet)`` buffers."""

    def __init__(self, whole_evaluator, runtimes: Sequence) -> None:
        self.n_programs = int(whole_evaluator.n_programs)
        self.n_cols = int(whole_evaluator.n_cols)
        whole_meta = dict(whole_evaluator.any_meta or {})
        self._runtimes = tuple(runtimes)
        self._prog_cols: List[np.ndarray] = []
        self._aux_src: List[np.ndarray] = []
        self._aux_dst: List[np.ndarray] = []

        covered = np.zeros(self.n_programs, bool)
        aux_covered = set()
        for rt in self._runtimes:
            cols = np.asarray(rt.prog_cols, np.int64)
            if cols.size and (cols.min() < 0 or
                              cols.max() >= self.n_programs):
                raise PartitionError(
                    f'partition {rt.part.pid}: program column out of '
                    f'range [0, {self.n_programs})')
            if covered[cols].any():
                raise PartitionError(
                    f'partition {rt.part.pid}: program column claimed '
                    f'by two partitions')
            covered[cols] = True
            self._prog_cols.append(cols)

            p_k = int(rt.evaluator.n_programs)
            local_meta = dict(rt.evaluator.any_meta or {})
            src, dst = [], []
            for lj, (lbase, cnt) in sorted(local_meta.items()):
                gj = int(cols[lj])
                gmeta = whole_meta.get(gj)
                if gmeta is None or gmeta[1] != cnt:
                    raise PartitionError(
                        f'partition {rt.part.pid}: aux block for local '
                        f'program {lj} (global {gj}) does not match the '
                        f'whole-set layout')
                src.extend(range(p_k + lbase, p_k + lbase + cnt))
                dst.extend(range(self.n_programs + gmeta[0],
                                 self.n_programs + gmeta[0] + cnt))
                aux_covered.add(gj)
            self._aux_src.append(np.asarray(src, np.int64))
            self._aux_dst.append(np.asarray(dst, np.int64))

        if not covered.all():
            missing = int((~covered).sum())
            raise PartitionError(
                f'{missing} whole-set program column(s) owned by no '
                f'partition')
        stray = set(whole_meta) - aux_covered
        if stray:
            raise PartitionError(
                f'whole-set aux blocks for programs {sorted(stray)} '
                f'owned by no partition')

    def compose(self, parts_out: Sequence[Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]],
                rows: int):
        """Scatter per-partition ``(s_k, d_k, fd_k)`` buffers (aligned
        with the runtimes this composer was built over) into whole-set
        buffers.  fdet cells default to -1, the 'materialize on host'
        sentinel — coverage validation guarantees every live cell is
        overwritten, so the default is only visible to code that never
        reads it."""
        s = np.zeros((rows, self.n_programs), np.int8)
        d = np.zeros((rows, self.n_programs), np.int8)
        fd = np.full((rows, self.n_cols), -1, np.int32)
        for i, (s_k, d_k, fd_k) in enumerate(parts_out):
            cols = self._prog_cols[i]
            p_k = cols.size
            s[:, cols] = s_k
            d[:, cols] = d_k
            fd[:, cols] = fd_k[:, :p_k]
            if self._aux_src[i].size:
                fd[:, self._aux_dst[i]] = fd_k[:, self._aux_src[i]]
        return s, d, fd
