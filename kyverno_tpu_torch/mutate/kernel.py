"""The device mutate evaluator: lanes → (status, edit bitmask, reason).

One hand-written CUDA kernel (``csrc/k3_mutate.cu``, wrapped by
``ops/kernels.py k3_mutate``) per lowered policy set, batched over
resources and edit sites.  Per (resource, site) it decides whether the
edit applies — leaf missing → apply; add-only anchors skip present
leaves; otherwise apply iff the encoded value differs from the patch
constant (Python equality semantics: bool/int/float compare through the
exact milli lane, strings through length + byte window; cross-kind
never equal except the numeric tower) — then reduces sites to per-rule
outputs:

  status  i8 [R, NR]   0 = SKIP (no edits), 1 = PASS (edit list
                       non-empty), 2 = FALLBACK (host applies)
  edits   i64 [R, NR]  bitmask over the rule's sites (bit k = site k
                       applies); the host decodes it into a (slot,
                       value) edit list and patches the JSON
  reason  i8 [R, NR]   first-fault attribution for FALLBACK rows, in
                       the host fast path's check order: 1 = a
                       json6902 replace path is missing, 2 = a non-map
                       intermediate, 3 = equality undecidable in the
                       encoded lanes

Sites are enumerated rule by rule, so each rule owns a contiguous site
range (``_rule_start``, CSR offsets; checked when the tables are built:
at most 32 sites a rule, one bit each of its mask) and the kernel runs
one thread per (resource, site) cell.  Rows past the live row count
(the ``valid`` lane) are capacity padding: their statuses, edit
bitmasks, and reasons are forced to SKIP/0 inside the kernel so no
cross-row consumer can ever observe them.  The site tables are device
tensors built once per kernel object; a call writes its lanes into one
pinned host buffer, copies it to the card with one ``non_blocking``
copy, and reads the one output buffer back with one copy.  Nothing
else in a call waits for the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from .encode import exact_milli, string_window
from .plan import MutateSetProgram

#: per-(resource, rule) device statuses
MUT_SKIP = 0
MUT_PASS = 1
MUT_FALLBACK = 2

#: FALLBACK reason codes (decoded to taxonomy slugs in scanner.py)
RC_NONE = 0
RC_REPLACE_MISSING = 1
RC_NON_DICT = 2
RC_UNDECIDABLE = 3


class MutateKernel:
    """Site tables of one program and its device dispatch."""

    def __init__(self, program: MutateSetProgram, device=None):
        from ..device import resolve_device
        self.device = resolve_device(device)
        sites = [(ri, k, site)
                 for ri, prog in enumerate(program.programs)
                 for k, site in enumerate(prog.sites)]
        self.n_rules = len(program.programs)
        self.n_sites = len(sites)
        self.width = string_window(program)
        s, w = self.n_sites, self.width
        self._t_is_num = np.zeros(s, bool)
        self._t_milli = np.zeros(s, np.int64)
        self._t_len = np.zeros(s, np.int32)
        self._t_bytes = np.zeros((s, w), np.uint8)
        self._add_only = np.zeros(s, bool)
        self._replace = np.zeros(s, bool)
        # rule r owns sites _rule_start[r]:_rule_start[r + 1] (sites are
        # enumerated rule by rule); site k of a rule is bit k of its mask
        self._rule_start = np.zeros(self.n_rules + 1, np.int32)
        for idx, (ri, k, site) in enumerate(sites):
            v = site.value
            if isinstance(v, str) and not isinstance(v, bool):
                b = v.encode('utf-8')
                self._t_len[idx] = len(b)
                self._t_bytes[idx, :min(len(b), w)] = \
                    np.frombuffer(b[:w], np.uint8)
            else:
                self._t_is_num[idx] = True
                m = exact_milli(v)
                # lowering guarantees representable constants
                self._t_milli[idx] = 0 if m is None else m
            self._add_only[idx] = site.add_only
            self._replace[idx] = site.replace
            self._rule_start[ri + 1] = idx + 1
        np.maximum.accumulate(self._rule_start, out=self._rule_start)
        #: ``_rule_start`` on the host, checked here once: the card
        #: wrapper takes it instead of reading the device copy back
        self.bounds = tuple(self._rule_start.tolist())
        kernels.k3_check_bounds(self.bounds, s)
        self._site_slot = kernels.k3_site_slot(self.bounds)
        self._sites: Optional[Dict[str, torch.Tensor]] = None

    def site_tensors(self) -> Dict[str, torch.Tensor]:
        """The site tables on the kernel's device, built on first use."""
        if self._sites is None:
            tables = {'t_is_num': self._t_is_num, 't_milli': self._t_milli,
                      't_len': self._t_len, 't_bytes': self._t_bytes,
                      'add_only': self._add_only, 'replace': self._replace,
                      'site_slot': self._site_slot,
                      'rule_start': self._rule_start}
            self._sites = {k: torch.from_numpy(v).to(self.device)
                           for k, v in tables.items()}
        return self._sites

    def stage(self, lanes: Dict[str, np.ndarray]
              ) -> Tuple[torch.Tensor, 'kernels.K3Layout']:
        """``lanes`` on the kernel's device: written into one buffer
        (``kernels.k3_pack``) — pinned host memory from the caching
        allocator, so concurrent calls never share one — and copied
        with one ``non_blocking`` copy on the current stream (no copy
        on the CPU)."""
        cuda = self.device.type == 'cuda'
        host, layout = kernels.k3_pack(lanes, pin=cuda)
        return (host.to(self.device, non_blocking=True) if cuda else host,
                layout)

    def __call__(self, lanes: Dict[str, np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = lanes['tag'].shape[0]
        if self.n_sites == 0:
            return (np.zeros((n, self.n_rules), np.int8),
                    np.zeros((n, self.n_rules), np.int64),
                    np.zeros((n, self.n_rules), np.int8))
        out = kernels.k3_mutate(self.stage(lanes), self.site_tensors(),
                                self.bounds)
        # one copy back; .cpu() waits for the kernel on its stream
        return kernels.k3_outputs(out.cpu().numpy(), n, self.n_rules)
