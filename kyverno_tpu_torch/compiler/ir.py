"""Compiler IR v2: policies → slot table + tri-state status programs.

The TPU execution model replaces the reference's per-resource tree-walk
interpreter (reference: pkg/engine/validate/validate.go) with trace-time
specialization:

* a **slot** is a policy-relevant structural path (e.g.
  ``spec.containers.*.image``); resources are *projected* onto the slot
  table at encode time — the document itself never reaches the device.
  Paths may contain up to two ``'*'`` array traversals (e.g.
  ``spec.containers.*.ports.*.hostPort``).
* a **gather slot** collects a flattened list of scalars addressed by a
  JMESPath shape (field chains, ``[]`` flattens, multiselect lists,
  ``keys(@)``, ``|| <literal>`` fallbacks) — the device form of deny /
  precondition condition keys over ``request.object``.
* a **leaf check** is a scalar predicate on one slot from a closed
  vectorizable vocabulary; a **condition check** is one reference
  condition operator applied to a gather slot.
* a **status expression** is a tree mirroring the anchor walk with
  tri-state semantics (PASS / FAIL / SKIP), evaluated under Kleene
  three-valued logic so any undecidable leaf yields UNKNOWN → the rule is
  re-run on the host engine for that resource (exactness is never lost).

Because programs are Python constants closed over by the jitted evaluator,
XLA sees straight-line fused elementwise ops over ``[R]``/``[R, E]``
tensors — no interpreter loop on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# type tags in the encoded tensors
TAG_MISSING = 0
TAG_NULL = 1
TAG_BOOL = 2
TAG_INT = 3
TAG_FLOAT = 4
TAG_STRING = 5
TAG_MAP = 6
TAG_ARRAY = 7

# maximum string bytes kept per value (suffix-matched strings keep the tail)
STR_LEN = 64
# bytes kept from the end of each string (right-aligned suffix window)
TAIL_LEN = 16
# maximum array elements encoded per element-bearing slot dimension
MAX_ELEMS = 16
# maximum elements per gather slot (flattened JMESPath projections)
MAX_GATHER = 32

# device status codes (STATUS_HOST = undecidable on device → host fallback;
# STATUS_SKIP_PRECOND = skipped by preconditions, whose message is the
# static 'preconditions not met'; STATUS_VAR_ERR = a condition variable
# failed to resolve — the host's deterministic substitution-error ERROR,
# message indexed by ``detail`` into RuleProgram.error_messages)
STATUS_PASS, STATUS_FAIL, STATUS_SKIP, STATUS_HOST = 0, 1, 2, 3
STATUS_SKIP_PRECOND = 4
STATUS_VAR_ERR = 5
N_STATUS_CODES = 6


@dataclass(frozen=True)
class Slot:
    """A policy-relevant structural path.

    ``path`` is a tuple of keys; ``'*'`` marks an array-of-maps traversal.
    Up to two ``'*'`` levels are vectorized (deeper nesting falls back to
    host). ``depth`` is the number of element dimensions.
    """
    path: Tuple[str, ...]

    @property
    def depth(self) -> int:
        return sum(1 for p in self.path if p == '*')

    @property
    def elem(self) -> bool:
        return self.depth > 0

    def __str__(self):
        return '.'.join(self.path)


# --- gather programs (JMESPath shapes) -------------------------------------

@dataclass(frozen=True)
class GatherSlot:
    """A scalar-or-list value gathered from the resource document.

    ``expr`` is the raw JMESPath condition key (braces stripped); at
    encode time it is evaluated verbatim by the in-repo JMESPath
    interpreter against the same ``{'request': {'object': doc}}`` context
    the host engine builds, so gather semantics are host-exact by
    construction.  ``__pss:``-prefixed exprs are encoder-side Python
    projections (pss_compile.virtual_searcher).
    """
    expr: str

    def __str__(self):
        return self.expr


@dataclass(frozen=True)
class ElemGather:
    """A per-foreach-element projection: ``expr`` evaluated against the
    element context (``element`` / ``elementIndex`` injected over the
    request, engine/context.py:109 add_element) for each element of the
    ``list_expr`` foreach list.  Lanes are [R, FE, EG] with per-(r, fe)
    kind/count/overflow/notfound metadata."""
    list_expr: str
    expr: str

    def __str__(self):
        return f'{self.list_expr}[]→{self.expr}'


# --- leaf checks ------------------------------------------------------------

# Leaf-check op vocabulary — the single source of truth; the compiler emits
# exactly these strings and ops/eval.py implements exactly this set.
LEAF_OPS = frozenset({
    'true',         # constant pass
    'absent',       # key missing (X() negation anchors)
    'present',      # key exists in parent map (anchor presence tests)
    'star',         # "*": key present and non-null
    'is_map',       # structural guard: value is a map
    'is_array',     # structural guard: value is an array
    'any_str',      # wildcard "*" string compare: any string-convertible
    'nonempty',     # "?*": non-empty string form
    'convertible',  # value has a string form (guards NotEqual)
    'eq_bool',      # operand: bool
    'eq_null',      # null pattern: null/0/"" match (missing treated as null)
    'eq_int',       # operand: int
    'eq_float',     # operand: float (milli-exact)
    'cmp_qty',      # operand: (cmp, milli int)
    'cmp_dur',      # operand: (cmp, nanos int)
    'eq_str',       # operand: str (exact, ≤ STR_LEN bytes)
    'prefix',       # operand: str (≤ STR_LEN bytes)
    'suffix',       # operand: str (≤ TAIL_LEN bytes)
    'min_len',      # operand: int (byte length lower bound)
    'wildcard',     # operand: str pattern with */?; DP over the byte window
    # Python-semantics predicates for the PSS check library (pss_compile):
    'truthy',       # bool(value): non-zero number / non-empty string / True
    'is_true',      # value is True (strict bool identity)
    'is_false',     # value is False
    'is_zero_num',  # value == 0 under Python numerics (0, 0.0, False)
})

CMP_GT, CMP_GE, CMP_LT, CMP_LE, CMP_EQ, CMP_NE = '>', '>=', '<', '<=', '==', '!='


def classify_wildcard(operand: str):
    """Classify a glob pattern into the cheapest vectorizable string op.

    Returns (op, parts) with op ∈ {'eq','any','nonempty','prefix',
    'suffix','prefix_suffix','dp'} — shared by the compiler, the
    evaluator's constant matcher, and the lane-need analysis so all three
    agree on which lanes (and byte widths) a comparison reads.
    """
    has_star = '*' in operand
    has_q = '?' in operand
    if not has_star and not has_q:
        return 'eq', (operand,)
    if operand == '*':
        return 'any', ()
    if operand == '?*':
        return 'nonempty', ()
    if not has_q:
        parts = operand.split('*')
        if len(parts) == 2 and parts[0] and not parts[1]:
            return 'prefix', (parts[0],)
        if len(parts) == 2 and not parts[0] and parts[1] and \
                len(parts[1].encode()) <= TAIL_LEN:
            return 'suffix', (parts[1],)
        if len(parts) == 3 and parts[0] and parts[2] and not parts[1] and \
                len(parts[2].encode()) <= TAIL_LEN:
            return 'prefix_suffix', (parts[0], parts[2])
    return 'dp', (operand,)


@dataclass(frozen=True)
class Leaf:
    """A scalar predicate on a slot."""
    slot: Slot
    op: str
    operand: Any = None
    # missing key passes the check (=(key) equality anchors fold this in)
    missing_ok: bool = False


@dataclass(frozen=True)
class CondCheck:
    """One compiled deny/precondition condition.

    Two modes (semantics: kyverno_tpu/engine/operators.py, reference:
    pkg/engine/variables/operator/*.go):
      A — ``gather`` key vs constant ``values`` (the common shape);
      B — constant ``key_const`` vs a ``value_gather`` projection
          (foreach conditions like ``key: ALL, value: {{element...}}``).
    ``op`` is the lower-cased reference operator name.  ``list_value``
    records whether the constant side was a YAML list — the reference
    dispatches on the operand's type, not just its contents.
    """
    gather: Optional[Any]        # GatherSlot | ElemGather (mode A key)
    op: str                      # 'anyin' | 'allin' | 'anynotin' | 'allnotin'
                                 # | 'equals' | 'notequals' | numeric cmps
    values: Tuple[Any, ...] = ()
    list_value: bool = False
    key_const: Any = None        # mode B constant key
    value_gather: Optional[Any] = None  # mode B value projection


@dataclass(frozen=True)
class BoolExpr:
    """AND/OR/NOT tree over leaves / condition checks (Kleene 3-valued on
    device: each node evaluates to (true-known, false-known)).

    'any_elem' / 'all_elem' quantify their single child over the valid
    elements of the array at ``slot`` (one depth level deeper); a missing
    or null array is vacuous (∃ → False, ∀ → True), mirroring the PSS
    library's ``spec.get(field) or []`` walks (pss/checks.py)."""
    kind: str   # 'leaf' | 'cond' | 'and' | 'or' | 'not' | *_elem
    leaf: Optional[Leaf] = None
    cond: Optional[CondCheck] = None
    children: Tuple['BoolExpr', ...] = ()
    slot: Optional[Slot] = None    # quantifier array slot

    @staticmethod
    def of(leaf: Leaf) -> 'BoolExpr':
        return BoolExpr('leaf', leaf=leaf)

    @staticmethod
    def of_cond(cond: CondCheck) -> 'BoolExpr':
        return BoolExpr('cond', cond=cond)

    @staticmethod
    def all(children: List['BoolExpr']) -> 'BoolExpr':
        if len(children) == 1:
            return children[0]
        return BoolExpr('and', children=tuple(children))

    @staticmethod
    def any(children: List['BoolExpr']) -> 'BoolExpr':
        if len(children) == 1:
            return children[0]
        return BoolExpr('or', children=tuple(children))

    @staticmethod
    def negate(child: 'BoolExpr') -> 'BoolExpr':
        return BoolExpr('not', children=(child,))


# --- status expressions -----------------------------------------------------

@dataclass(frozen=True)
class StatusExpr:
    """Tri-state node mirroring one step of the validate walk.

    kinds and semantics (reference: pkg/engine/validate/validate.go +
    pkg/engine/anchor/handlers.go):

      const     — constant status (operand = status code)
      leaf      — BoolExpr ``expr``: True → PASS, False → FAIL
      seq       — children in walk order; first non-PASS child decides
      cond      — (k) condition anchor: key absent → SKIP; present and
                  ``sub`` non-PASS → SKIP; else PASS   (handlers.go:31)
      global    — <(k): key absent → PASS; present and ``sub`` non-PASS →
                  SKIP                                  (handlers.go:??)
      equality  — =(k): key absent → PASS; else ``sub`` status as-is
      negation  — X(k): key present → FAIL; absent → PASS
      exists    — ^(k): key absent → PASS; non-array → FAIL; else at least
                  one element with ``sub``==PASS → PASS else FAIL
                  (handlers.go:228; inner skips count as non-match)
      forall    — array-of-maps walk (validate.go:218): non-array → FAIL;
                  any element FAIL → FAIL; 0 applied & >0 skips → SKIP;
                  else PASS.  ``sub`` is evaluated per element.
      scalars   — scalar pattern vs array value (validate.go:71 case):
                  non-array handled by plain leaf; for arrays every element
                  must satisfy ``expr``
      deny      — ``expr`` True → FAIL (operand carries nothing)
      precond   — ``expr`` False → SKIP, else PASS (preconditions gate)
      any       — anyPattern: any child PASS → PASS; else all children
                  SKIP → SKIP; else FAIL  (engine.py validate_any_pattern)

    ``slot`` is the anchored key's slot for presence tests (cond/global/
    equality/negation/exists) or the array node slot (forall).
    """
    kind: str
    slot: Optional[Slot] = None
    expr: Optional[BoolExpr] = None
    sub: Optional['StatusExpr'] = None
    children: Tuple['StatusExpr', ...] = ()
    operand: Any = None
    # fail-site id: index into RuleProgram.fail_sites identifying the walk
    # position (path template) the host would report for a FAIL decided at
    # this node; None → a FAIL here is not message-synthesizable on device
    fail_site: Optional[int] = None

    @staticmethod
    def const(status: int) -> 'StatusExpr':
        return StatusExpr('const', operand=status)

    @staticmethod
    def seq(children: List['StatusExpr']) -> 'StatusExpr':
        flat: List[StatusExpr] = []
        for c in children:
            if c.kind == 'seq':
                flat.extend(c.children)
            elif c.kind == 'const' and c.operand == STATUS_PASS:
                continue
            else:
                flat.append(c)
        if not flat:
            return StatusExpr.const(STATUS_PASS)
        if len(flat) == 1:
            return flat[0]
        return StatusExpr('seq', children=tuple(flat))


@dataclass(frozen=True, eq=False)
class RuleProgram:
    """One compiled rule: a status expression per resource."""
    policy_name: str
    rule_name: str
    policy_index: int
    rule_index: int
    status: StatusExpr
    # static pass messages (compile-time constants); anyPattern rules carry
    # one per sub-pattern, indexed by the evaluator's ``detail`` output
    # (reference message format: pkg/engine/validation.go:640)
    pass_messages: Tuple[str, ...]
    # substitution-error messages for unresolvable condition variables,
    # indexed by ``detail`` on STATUS_VAR_ERR (engine.py:388-391,431-434)
    error_messages: Tuple[str, ...] = ()
    # (level, version) for podSecurity rules — synthesized PASS responses
    # carry {'level', 'version', 'checks': []} (engine.py:592-605)
    pss: Optional[Tuple[str, str]] = None
    # static skip message when the rule's SKIP outcome is synthesizable
    # (foreach 'rule skipped', engine.py:628)
    skip_message: Optional[str] = None
    background: bool = True
    # the original rule dict (for host-side match evaluation + fallback)
    rule_raw: Optional[dict] = None
    # --- device FAIL-message synthesis (single-pattern + deny rules) ----
    # fail-site path templates indexed by the evaluator's ``fdet`` output
    # (site = fdet >> 16, element indices in the low bytes); '{e0}'/'{e1}'
    # mark array positions.  None → FAIL cells re-run on the host.
    fail_sites: Optional[Tuple[str, ...]] = None
    # static message prefix: full FAIL message = fail_prefix + path
    # (reference format: pkg/engine/validation.go:722 buildErrorMessage)
    fail_prefix: Optional[str] = None
    # static deny FAIL message (reference: validation.go:460 getDenyMessage);
    # for foreach rules this is the wrapped 'validation failure: …' form
    # (engine.py:665) and is gated on the evaluator's fdet >= 0
    deny_fail_message: Optional[str] = None
    # anyPattern synthesis: per-sub-pattern fail-site tables + the message
    # prefix of buildAnyPatternErrorMessage (validation.go:746); failing
    # children contribute 'rule NAME[i] failed at path P' parts in order
    any_fail_sites: Optional[Tuple[Tuple[str, ...], ...]] = None
    any_fail_prefix: Optional[str] = None
    # context entries (configMap/apiCall/variable) whose VALUES feed no
    # compiled lane: the device decision is context-independent, but the
    # host engine's load-failure semantics must hold — the scanner
    # attempts the load per (resource, rule) and falls back to exact
    # host materialization on failure (reference:
    # pkg/engine/jsonContext.go:126 LoadContext)
    context_spec: Optional[Tuple[dict, ...]] = None
    # the {{...}} inputs the context spec consumes, when all are
    # request.object-rooted: load outcomes are a pure function of these
    # values, so the scanner memoizes per (rule, inputs) instead of
    # re-loading per cell; None -> not cacheable (re-load per resource)
    context_inputs: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class ForEachEntryIR:
    """One compiled ``validate.foreach`` entry (deny-conditions form).

    ``err_gathers`` lists the entry's element gathers in substitution
    order (preconditions doc first, then deny conditions) for the
    per-element variable-error semantics (engine.py:660-667)."""
    list_gather: GatherSlot
    precond: Optional[BoolExpr]
    deny: Optional[BoolExpr]
    err_gathers: Tuple[ElemGather, ...] = ()


@dataclass
class CompiledPolicySet:
    """Output of the compiler for a policy set."""
    slots: List[Slot] = field(default_factory=list)
    slot_index: Dict[Slot, int] = field(default_factory=dict)
    gathers: List[GatherSlot] = field(default_factory=list)
    gather_index: Dict[GatherSlot, int] = field(default_factory=dict)
    elem_gathers: List[ElemGather] = field(default_factory=list)
    elem_gather_index: Dict[ElemGather, int] = field(default_factory=dict)
    programs: List[RuleProgram] = field(default_factory=list)
    # (policy_index, rule dict, policy) for rules the device cannot evaluate
    host_rules: List[Tuple[int, dict, Any]] = field(default_factory=list)
    policies: List[Any] = field(default_factory=list)
    # per-(policy, rule) device/host placement with the attributed
    # fallback reason (observability/coverage.py RulePlacement), in
    # compile order — the compile-time half of the coverage ledger
    placements: List[Any] = field(default_factory=list)

    def slot_id(self, slot: Slot) -> int:
        if slot not in self.slot_index:
            self.slot_index[slot] = len(self.slots)
            self.slots.append(slot)
        return self.slot_index[slot]

    def gather_id(self, g: GatherSlot) -> int:
        if g not in self.gather_index:
            self.gather_index[g] = len(self.gathers)
            self.gathers.append(g)
        return self.gather_index[g]

    def elem_gather_id(self, g: ElemGather) -> int:
        if g not in self.elem_gather_index:
            self.elem_gather_index[g] = len(self.elem_gathers)
            self.elem_gathers.append(g)
        return self.elem_gather_index[g]


class CompileError(Exception):
    """Raised when a rule (or part) cannot be vectorized → host fallback.

    ``reason`` is a stable taxonomy slug (observability/coverage.py
    REASONS) recording WHY the rule left the device path; the default
    covers the common case of an operator / pattern shape outside the
    device vocabulary."""

    def __init__(self, message: str = '',
                 reason: str = 'unsupported_operator'):
        super().__init__(message)
        self.reason = reason
