"""ktpu-lint for the port: AST-based static analysis for host syncs
inside device stages, shape hazards, and taxonomy/catalog drift.

The failure modes that silently break "queued once on the card, read
back once, bit-identical output" are program-structure properties,
not runtime bugs: a host read of a tensor inside a device stage, a
computed batch shape, a fallback site that drifted out of the
coverage taxonomy.  pytest never sees them; this package enforces
them (``python -m kyverno_tpu_torch.analysis --strict``, held by
``tests/test_torch_lint.py``).  Rule ids, the noqa syntax and the
report are the reference's.

Layout:

* :mod:`.core` — finding model, rule registry (stable ``KTPU###`` ids),
  per-line ``# ktpu: noqa[RULEID] -- reason`` suppressions, committed
  baseline for grandfathered findings (``baseline.json`` beside it),
  and the :class:`Analyzer` driver
* :mod:`.jitgraph` — import/def indexing and the device-stage call
  graph (rooted at ``DEVICE_STAGES``) shared by the host-sync,
  taxonomy and concurrency passes
* :mod:`.trace_safety` — KTPU101/102/103 (host syncs inside device
  stages)
* :mod:`.retrace` — KTPU204/205 (non-canonical batch shapes, per-row
  allocations on the encode hot path); KTPU201-203, the reference's
  jit-cache rules, are registered as not applying
* :mod:`.taxonomy` — KTPU301/302/303/304 (fallback-reason taxonomy
  drift)
* :mod:`.envreg` — KTPU401/402 (``KTPU_*`` knob registry drift)
* :mod:`.catalog_pass` — KTPU501/502/503 (metric catalog drift),
  KTPU504/505 (span-name catalog drift against
  ``observability/catalog.py:SPANS``), KTPU506 (unit mismatch), and
  KTPU507-509 (stage registry, partition keys, fleet scope)
* :mod:`.concurrency` — KTPU601-604 (thread-reachable writes and locks)
* :mod:`.knobs` — the machine-readable ``KTPU_*`` knob registry that
  drives both KTPU401/402 and the README knob table
"""

from .core import (Analyzer, Finding, Rule, RULES, load_baseline,  # noqa: F401
                   write_baseline)

# importing the pass modules registers their rules
from . import trace_safety  # noqa: F401,E402
from . import retrace  # noqa: F401,E402
from . import taxonomy  # noqa: F401,E402
from . import envreg  # noqa: F401,E402
from . import catalog_pass  # noqa: F401,E402
from . import concurrency  # noqa: F401,E402
