"""PyTorch/CUDA port of the kyverno_tpu policy engine.

The package mirrors ``kyverno_tpu``'s layout module for module: host
modules are verbatim copies, and the modules whose device seams differ
(``ops/eval.py``, ``compiler/scan.py``) run their device work as torch
ops on CUDA plus the hand-written kernels under ``csrc/``.  It imports
torch, numpy and the standard library only.
"""

__version__ = '0.1.0'
