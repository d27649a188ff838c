"""Admission micro-batching scheduler.

Sits between the webhook handlers and the compiled
:class:`~kyverno_tpu.compiler.scan.BatchScanner`: concurrent CREATE-path
validate requests for the same policy set coalesce into one shared
device dispatch instead of each paying a batch-of-one scan (the
continuous-batching pattern of TPU serving stacks, applied to policy
evaluation).

* :mod:`.queue` — bounded request queue with per-request futures;
* :mod:`.batcher` — the coalescing loop (flush on the
  ``KTPU_BATCH_WINDOW_MS`` deadline or at ``KTPU_BATCH_MAX`` occupancy;
  batches are ragged — padded to a canonical capacity with the tail
  masked in-graph — so a flush at any occupancy reuses a compiled
  executable);
* :mod:`.shed` — the degradation policy: queue-full, deadline-blown, or
  scan-failed requests shed to the host engine loop (identical
  verdicts, never a 500).

Selected per-handler via ``KTPU_SERVING=batch|sync`` (default sync).
Bit-identity with the sync path is the contract, pinned by
``tests/test_serving.py``.
"""

from .batcher import AdmissionBatcher
from .queue import QueueFull, Stopped, Ticket

__all__ = ['AdmissionBatcher', 'QueueFull', 'Stopped', 'Ticket']
