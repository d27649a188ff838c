"""Device-side mutate: compiled patch kernels over edit-site lanes.

``plan`` lowers strategic-merge / json6902 mutate rules into fixed
edit-site programs, ``encode`` projects resources onto their lanes,
``kernel`` is the jitted per-(resource, rule) decision program, and
``scanner.MutateScanner`` ties them into the admission serving path
with the host engine as the bit-identity oracle.
"""

from .plan import (EditSite, LowerError, MutateSetProgram,
                   RuleMutateProgram, compile_mutate_set,
                   lower_mutate_rule)
from .scanner import MutateScanner

__all__ = ['EditSite', 'LowerError', 'MutateSetProgram',
           'RuleMutateProgram', 'compile_mutate_set',
           'lower_mutate_rule', 'MutateScanner']
