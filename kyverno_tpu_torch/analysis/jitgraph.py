"""Qualified-name interprocedural engine: device-stage call graph +
taint lattice.

The host-sync (KTPU1xx), retrace (KTPU2xx) and concurrency (KTPU6xx)
passes share two whole-program questions this module answers:

1. *Could this function's body run inside a device stage* (or on a
   ``threading.Thread``)?  — reachability over a **resolved** call
   graph.
2. *Does this value derive from a device tensor?* — a param-rooted
   **taint lattice** over that graph.

**Device stages.**  The port has no ``jax.jit``: its device work is
eager torch ops and hand-written kernels, queued on a CUDA stream and
read back once.  The graph is rooted at :data:`DEVICE_STAGES`, a
declared tuple of the port's counterparts of the reference's jit
sites — the evaluator's compact K1 call (``evaluate_packed``) up to
its one readback (``CompactOut.host``), the kernel wrappers of
``ops/kernels.py``, ``MutateKernel.__call__`` and the mesh step
(``distributed_scan_step``).  Inside a stage any host read of a
tensor blocks the host on the stream; the stage's own single
readback is the one allowed sync and carries a reasoned noqa.  Each
declaration names the parameters (or the locals a tuple argument
unpacks to) that carry device tensors: the counterpart of jit's
non-static arguments.  A call made under an
``if _on_cpu(...)`` guard is the kernel's plain version on CPU
tensors, where nothing waits for a card, so it is no stage edge.

**Binder (two passes).**  Pass one indexes every module in a single
tree traversal: defs by name, classes with their methods, import
aliases (relative imports resolved against the importing package),
parent links, and *assignment-tracked receiver types one level deep*
(``x = SomeClass(...)`` at module level or locally,
``self.attr = SomeClass(...)`` inside methods).  Pass two resolves
call sites against those indexes:

* bare ``f(...)`` → same-file defs (any nesting level), then
  ``from M import f`` targets, then class constructors (edge to
  ``__init__``);
* ``alias.f(...)`` where ``alias`` imports a tree module → that
  module's ``f`` (or class ``f``'s ``__init__``);
* ``self.m(...)`` inside a method of class ``C`` → ``C.m`` (walking
  one level of resolvable bases) — **qualified**, no same-file
  homonym over-approximation;
* ``obj.m(...)`` / ``self.attr.m(...)`` where the receiver's type
  was assignment-tracked → that class's ``m``;
* anything else with an *unknown* receiver keeps the historical
  over-approximation (same-file homonym defs) — a false reachable
  edge costs a reviewed suppression, a false unreachable edge hides
  a real host sync.

**Taint.**  Every declared tensor parameter of a stage is tainted at
depth 0, and so is the result of any ``torch.*`` call that makes a
tensor.  Taint propagates through local assignments, call arguments
(tainted arg → callee param, depth+1), return values (a callee that
returns a tainted expression taints the call result) and methods on
a tainted receiver, bounded at ``KTPU_LINT_TAINT_DEPTH`` call edges
(default 3): a cast at depth 3 is a finding, the same cast at depth 4
is silence.  Host metadata (``.shape``/``.ndim``/``.dtype``/
``.device``, ``.size()``/``.dim()``/``.numel()``/``.data_ptr()``,
``len()``) launders taint — those never wait for the card — and so
does a readback (``.cpu()``/``.numpy()``/``.item()``/``.tolist()``),
whose result is host data: the readback itself is the finding.
Each tainted function carries a representative stage→here call chain
for the finding message.

Everything is memoized per :class:`Context` — resolution results per
function, taint summaries per (function, tainted-params) state — and
the per-file AST memo on :class:`SourceFile` keeps the whole build
single-traversal per file.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import Context, SourceFile

FuncKey = Tuple[str, int]  # (file rel, def lineno)

#: taint propagation bound, in call edges from the stage root
TAINT_DEPTH_DEFAULT = 3


@dataclass(frozen=True)
class DeviceStage:
    """One root of the device-stage graph: the function at ``path``
    (repo-relative) and ``qualname`` (its lexical path in the module,
    ``Class.method`` or ``outer.inner``), and the names in it that carry
    device tensors (parameters, or locals a tuple argument unpacks
    to)."""
    path: str
    qualname: str
    tensors: Tuple[str, ...]


#: the port's device stages: the counterparts of the reference's
#: ``jax.jit`` / ``pjit`` sites (the evaluator, the mutate kernel and
#: the mesh step) and the hand-written kernels' wrappers
DEVICE_STAGES: Tuple[DeviceStage, ...] = (
    # the K1 call, up to CompactOut.host: the one readback
    DeviceStage('kyverno_tpu_torch/ops/eval.py',
                'build_evaluator.evaluate_packed', ('packed',)),
    DeviceStage('kyverno_tpu_torch/ops/eval.py', 'CompactOut.host', ()),
    # each up to its launch
    DeviceStage('kyverno_tpu_torch/ops/kernels.py', 'status_vm',
                ('packed',)),
    DeviceStage('kyverno_tpu_torch/ops/kernels.py', 'fdet_select',
                ('s_u', 'd_u', 'adm', 'fdet_u', 'match', 'rowvalid',
                 'src')),
    DeviceStage('kyverno_tpu_torch/ops/kernels.py', 'wildcard_match',
                ('head', 'str_len', 'tag')),
    DeviceStage('kyverno_tpu_torch/ops/kernels.py', 'k3_mutate',
                ('lanes', 'sites')),
    DeviceStage('kyverno_tpu_torch/ops/kernels.py', 'status_histogram',
                ('statuses', 'rowvalid')),
    # up to its one readback
    DeviceStage('kyverno_tpu_torch/mutate/kernel.py',
                'MutateKernel.__call__', ()),
    # up to the all_reduce and the step's readback
    DeviceStage('kyverno_tpu_torch/parallel/mesh.py',
                'distributed_scan_step', ()),
)

#: guards whose true branch runs a kernel's plain version on CPU
#: tensors — calls under them are not stage edges
CPU_GUARDS = frozenset({'_on_cpu'})


def taint_depth() -> int:
    """Interprocedural taint bound (``KTPU_LINT_TAINT_DEPTH``)."""
    raw = os.environ.get('KTPU_LINT_TAINT_DEPTH', '')
    try:
        return int(raw) if raw else TAINT_DEPTH_DEFAULT
    except ValueError:
        return TAINT_DEPTH_DEFAULT


#: tensor attributes the host holds without waiting for the card —
#: taint does not flow through them
STATIC_ATTRS = {'shape', 'ndim', 'dtype', 'device', 'is_cuda', 'layout',
                'requires_grad'}

#: tensor methods answered from host metadata (no wait for the card)
STATIC_METHODS = {'size', 'dim', 'numel', 'nelement', 'stride',
                  'data_ptr', 'is_contiguous', 'element_size',
                  'storage_offset', 'get_device', 'is_pinned'}

#: readbacks: their result is host data (the call itself is KTPU101)
READBACK_METHODS = {'cpu', 'numpy', 'item', 'tolist'}

#: builtins whose result is host-static even over a tensor argument
STATIC_BUILTINS = {'len', 'isinstance', 'type', 'id', 'repr', 'str',
                   'hash', 'callable', 'getattr', 'hasattr', 'range'}

#: ``torch.*`` calls whose result is host data, not a tensor
STATIC_TORCH_CALLS = {'device', 'Size', 'is_tensor', 'iinfo', 'finfo',
                      'get_default_dtype', 'dtype', 'no_grad',
                      'inference_mode'}


#: ``torch`` submodules whose calls answer host queries or drive the
#: runtime (streams, events, the profiler, collectives on tensors they
#: are handed) and return no new tensor
HOST_TORCH_MODULES = {'cuda', 'profiler', 'distributed', 'backends',
                      'utils', 'library', 'autograd', 'testing'}

#: builtins that hand their arguments' tensors through
PASSTHROUGH_BUILTINS = {'list', 'tuple', 'dict', 'set', 'frozenset',
                        'sorted', 'reversed', 'iter', 'next', 'max',
                        'min', 'sum', 'abs', 'round', 'zip', 'enumerate'}

_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                   ast.DictComp)


def torch_call_name(func: ast.AST) -> Optional[str]:
    """The last attribute of a ``torch.*`` call target (``torch.zeros``
    → ``zeros``, ``torch.cuda.synchronize`` → ``synchronize``), or
    ``None`` when the call is not rooted at ``torch``."""
    if not isinstance(func, ast.Attribute):
        return None
    root = func
    while isinstance(root, ast.Attribute):
        root = root.value
    if isinstance(root, ast.Name) and root.id == 'torch':
        return func.attr
    return None


def makes_tensor(func: ast.AST) -> Optional[bool]:
    """For a ``torch.*`` call target: does the call return a tensor?
    ``None`` when the target is not rooted at ``torch``."""
    name = torch_call_name(func)
    if name is None:
        return None
    parts = []
    node = func.value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if HOST_TORCH_MODULES & set(parts):
        return False
    return name not in STATIC_TORCH_CALLS

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def walk_scope(fn: ast.AST):
    """Walk ``fn``'s subtree without descending into nested def/class
    scopes — nested functions are analyzed as their own (reachable)
    scopes, so walking them twice double-reports every finding."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


@dataclass
class ClassInfo:
    node: ast.ClassDef
    name: str
    methods: Dict[str, ast.AST] = field(default_factory=dict)
    bases: List[ast.expr] = field(default_factory=list)
    #: ``self.<attr> = Ctor(...)`` sites: attr -> type token
    attr_types: Dict[str, Tuple] = field(default_factory=dict)
    #: first ``self.<attr> = <value>`` site per attr — the value node
    #: (KTPU201 checks these for mutable-container initializers)
    attr_values: Dict[str, ast.AST] = field(default_factory=dict)


@dataclass
class FuncInfo:
    node: ast.AST
    rel: str
    qualname: str            # module-dotted + lexical path
    cls: Optional[str]       # immediately enclosing class, if a method

    @property
    def key(self) -> FuncKey:
        return (self.rel, self.node.lineno)


@dataclass
class ModuleInfo:
    sf: SourceFile
    dotted: Optional[str]                      # dotted module name, if known
    defs: Dict[str, List[ast.AST]] = field(default_factory=dict)
    # local name -> ('module', dotted) | ('from', src, name)
    imports: Dict[str, Tuple] = field(default_factory=dict)
    parents: Dict[ast.AST, ast.AST] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    #: module-level ``NAME = Ctor(...)``: name -> type token
    var_types: Dict[str, Tuple] = field(default_factory=dict)
    #: every def in the file -> its FuncInfo
    func_info: Dict[ast.AST, FuncInfo] = field(default_factory=dict)


def _dotted_for(rel: str) -> Optional[str]:
    """Dotted module path for files that live in a package directory
    (``kyverno_tpu/ops/eval.py`` → ``kyverno_tpu.ops.eval``)."""
    if not rel.endswith('.py'):
        return None
    parts = rel[:-3].replace(os.sep, '/').split('/')
    if parts[-1] == '__init__':
        parts = parts[:-1]
    return '.'.join(parts) if parts else None


def _resolve_relative(dotted: Optional[str], level: int,
                      module: Optional[str]) -> Optional[str]:
    if level == 0:
        return module
    if dotted is None:
        return None
    base = dotted.split('.')
    # inside module X.Y.Z, `from . import` resolves against X.Y
    base = base[:-1]
    if level > 1:
        base = base[:-(level - 1)] if level - 1 <= len(base) else []
    if not base and module is None:
        return None
    return '.'.join(base + (module.split('.') if module else []))


def _type_token(ctor: ast.AST) -> Optional[Tuple]:
    """Type token for an ``x = Ctor(...)`` right-hand side: the
    constructor's spelling, resolved lazily against module indexes."""
    if not isinstance(ctor, ast.Call):
        return None
    f = ctor.func
    if isinstance(f, ast.Name):
        return ('local', f.id)
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return ('attr', f.value.id, f.attr)
    return None


class JitGraph:
    def __init__(self, ctx: Context):
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_dotted: Dict[str, ModuleInfo] = {}
        for sf in ctx.files:
            if sf.tree is None:
                continue
            mi = ModuleInfo(sf, _dotted_for(sf.rel))
            self._bind_module(mi)
            self.modules[sf.rel] = mi
            if mi.dotted:
                self.by_dotted[mi.dotted] = mi
        self._callee_cache: Dict[FuncKey, List[Tuple]] = {}
        self._local_type_cache: Dict[FuncKey, Dict[str, Tuple]] = {}
        self._return_taint_memo: Dict[Tuple[FuncKey, frozenset],
                                      bool] = {}
        self._tainted_locals_memo: Dict[Tuple[FuncKey, frozenset],
                                        Set[str]] = {}
        self._scope_cache: Dict[FuncKey, List[ast.AST]] = {}
        self.entries: List[Tuple[ModuleInfo, ast.AST, ast.AST]] = []
        self._find_entries()
        self.reachable: Set[FuncKey] = set()
        self._walk_reachable()
        #: merged tensor-tainted parameter names per function
        self.taint: Dict[FuncKey, Set[str]] = {}
        #: min call-edge distance from a stage root, taint-bounded walk
        self.taint_min_depth: Dict[FuncKey, int] = {}
        #: representative stage→function qualname chain
        self.taint_chain: Dict[FuncKey, Tuple[str, ...]] = {}
        self._propagate_taint()

    # -- binder pass 1: per-module indexes -----------------------------------

    def _bind_module(self, mi: ModuleInfo) -> None:
        """Single recursive traversal building every per-module index:
        parents, defs, imports, classes/methods, receiver types."""
        mod_prefix = mi.dotted or mi.sf.rel

        def visit(node: ast.AST, qual: str, cls: Optional[ClassInfo],
                  in_func: bool) -> None:
            for child in ast.iter_child_nodes(node):
                mi.parents[child] = node
                if isinstance(child, _FUNC_DEFS):
                    mi.defs.setdefault(child.name, []).append(child)
                    qn = f'{qual}.{child.name}' if qual else child.name
                    mi.func_info[child] = FuncInfo(
                        child, mi.sf.rel, f'{mod_prefix}:{qn}',
                        cls.name if cls is not None else None)
                    if cls is not None:
                        cls.methods.setdefault(child.name, child)
                    visit(child, qn, None, True)
                elif isinstance(child, ast.ClassDef):
                    qn = f'{qual}.{child.name}' if qual else child.name
                    ci = ClassInfo(child, child.name,
                                   bases=list(child.bases))
                    # outermost same-name class wins; nested/shadowed
                    # definitions keep their own methods map
                    mi.classes.setdefault(child.name, ci)
                    visit(child, qn, ci, in_func)
                elif isinstance(child, ast.Import):
                    for alias in child.names:
                        mi.imports[alias.asname or
                                   alias.name.split('.')[0]] = \
                            ('module', alias.name)
                    visit(child, qual, cls, in_func)
                elif isinstance(child, ast.ImportFrom):
                    src = _resolve_relative(mi.dotted, child.level,
                                            child.module)
                    if src is not None:
                        for alias in child.names:
                            local = alias.asname or alias.name
                            mi.imports[local] = ('from', src, alias.name)
                    visit(child, qual, cls, in_func)
                elif isinstance(child, ast.Assign):
                    tok = _type_token(child.value)
                    for tgt in child.targets:
                        if isinstance(tgt, ast.Name) and not in_func:
                            if tok is not None:
                                mi.var_types.setdefault(tgt.id, tok)
                        elif isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == 'self' and \
                                cls is None and in_func:
                            # parent links exist up to `child`;
                            # resolve the owner from there
                            owner = self._owning_class(mi, child)
                            if owner is not None:
                                if tok is not None:
                                    owner.attr_types.setdefault(
                                        tgt.attr, tok)
                                owner.attr_values.setdefault(
                                    tgt.attr, child.value)
                    visit(child, qual, cls, in_func)
                else:
                    visit(child, qual, cls, in_func)

        visit(mi.sf.tree, '', None, False)

    def _owning_class(self, mi: ModuleInfo,
                      node: ast.AST) -> Optional[ClassInfo]:
        """The ClassInfo whose method lexically contains ``node``."""
        cur = mi.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                ci = mi.classes.get(cur.name)
                if ci is not None and ci.node is cur:
                    return ci
                return mi.classes.get(cur.name)
            cur = mi.parents.get(cur)
        return None

    # -- entry detection -----------------------------------------------------

    def _find_entries(self) -> None:
        """The declared device stages present in the analyzed tree;
        each entry's site is its :class:`DeviceStage`."""
        wanted = {(st.path, st.qualname): st for st in DEVICE_STAGES}
        for mi in self.modules.values():
            rel = mi.sf.rel.replace(os.sep, '/')
            for fn, info in mi.func_info.items():
                qn = info.qualname.split(':', 1)[1]
                st = wanted.get((rel, qn))
                if st is not None:
                    self.entries.append((mi, fn, st))

    def entry_tainted_params(self, mi: ModuleInfo, fn: ast.AST,
                             site: DeviceStage) -> Set[str]:
        """The stage's declared tensor-carrying names that the root
        binds: parameters, or locals it assigns (a tuple argument's
        tensor, once unpacked)."""
        args = fn.args
        names = {a.arg for a in
                 args.posonlyargs + args.args + args.kwonlyargs}
        for node in self.scope_nodes(mi, fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                names.update(n.id for t in targets for n in ast.walk(t)
                             if isinstance(n, ast.Name))
        return {n for n in site.tensors if n in names}

    def _cpu_guarded(self, mi: ModuleInfo, node: ast.AST,
                     fn: ast.AST) -> bool:
        """Is ``node`` inside the true branch of an ``if`` whose test
        calls a :data:`CPU_GUARDS` function (within ``fn``)?"""
        child, cur = node, mi.parents.get(node)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.If) and child in cur.body and any(
                    isinstance(n, ast.Call) and (
                        getattr(n.func, 'id', None) in CPU_GUARDS or
                        getattr(n.func, 'attr', None) in CPU_GUARDS)
                    for n in ast.walk(cur.test)):
                return True
            child, cur = cur, mi.parents.get(cur)
        return False

    def stage_callees(self, mi: ModuleInfo, fn: ast.AST
                      ) -> List[Tuple[ModuleInfo, ast.AST, ast.Call]]:
        """:meth:`callees` less the calls under a CPU guard: the edges
        along which a stage's device work runs."""
        return [(tmi, d, c) for tmi, d, c in self.callees(mi, fn)
                if not self._cpu_guarded(mi, c, fn)]

    # -- binder pass 2: call resolution --------------------------------------

    def _resolve_class(self, mi: ModuleInfo, token: Tuple
                       ) -> Optional[Tuple[ModuleInfo, ClassInfo]]:
        """Resolve a type token to an in-tree class, chasing one
        import hop."""
        if token[0] == 'local':
            name = token[1]
            ci = mi.classes.get(name)
            if ci is not None:
                return mi, ci
            imp = mi.imports.get(name)
            if imp is not None and imp[0] == 'from':
                tgt = self.by_dotted.get(imp[1])
                if tgt is not None:
                    ci = tgt.classes.get(imp[2])
                    if ci is not None:
                        return tgt, ci
        elif token[0] == 'attr':
            imp = mi.imports.get(token[1])
            if imp is not None:
                dotted = imp[1] if imp[0] == 'module' \
                    else f'{imp[1]}.{imp[2]}'
                tgt = self.by_dotted.get(dotted)
                if tgt is not None:
                    ci = tgt.classes.get(token[2])
                    if ci is not None:
                        return tgt, ci
        return None

    def _class_method(self, mi: ModuleInfo, ci: ClassInfo, name: str,
                      _depth: int = 0
                      ) -> Optional[Tuple[ModuleInfo, ast.AST]]:
        """Look ``name`` up on ``ci``, then one level of resolvable
        base classes."""
        m = ci.methods.get(name)
        if m is not None:
            return mi, m
        if _depth >= 2:
            return None
        for base in ci.bases:
            tok = None
            if isinstance(base, ast.Name):
                tok = ('local', base.id)
            elif isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name):
                tok = ('attr', base.value.id, base.attr)
            if tok is None:
                continue
            resolved = self._resolve_class(mi, tok)
            if resolved is not None:
                hit = self._class_method(resolved[0], resolved[1],
                                         name, _depth + 1)
                if hit is not None:
                    return hit
        return None

    def _local_types(self, mi: ModuleInfo,
                     fn: Optional[ast.AST]) -> Dict[str, Tuple]:
        """``x = Ctor(...)`` receiver types local to ``fn`` (one
        assignment hop, memoized)."""
        if fn is None:
            return {}
        key = (mi.sf.rel, fn.lineno)
        hit = self._local_type_cache.get(key)
        if hit is not None:
            return hit
        out: Dict[str, Tuple] = {}
        for node in self.scope_nodes(mi, fn):
            if isinstance(node, ast.Assign):
                tok = _type_token(node.value)
                if tok is None:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.setdefault(tgt.id, tok)
        self._local_type_cache[key] = out
        return out

    def _receiver_token(self, mi: ModuleInfo, fn: Optional[ast.AST],
                        base: ast.AST) -> Optional[Tuple]:
        """Type token of a call receiver expression, if tracked."""
        if isinstance(base, ast.Name):
            tok = self._local_types(mi, fn).get(base.id)
            if tok is not None:
                return tok
            return mi.var_types.get(base.id)
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and \
                base.value.id == 'self' and fn is not None:
            info = mi.func_info.get(fn)
            if info is not None and info.cls is not None:
                ci = mi.classes.get(info.cls)
                if ci is not None:
                    return ci.attr_types.get(base.attr)
        return None

    def _resolve_attr_call(self, mi: ModuleInfo, fn: Optional[ast.AST],
                           f: ast.Attribute
                           ) -> List[Tuple[ModuleInfo, ast.AST]]:
        base = f.value
        # self.m() → the enclosing class's method, qualified
        if isinstance(base, ast.Name) and base.id == 'self' and \
                fn is not None:
            info = mi.func_info.get(fn)
            if info is not None and info.cls is not None:
                ci = mi.classes.get(info.cls)
                if ci is not None:
                    hit = self._class_method(mi, ci, f.attr)
                    if hit is not None:
                        return [hit]
                    tok = ci.attr_types.get(f.attr)
                    if tok is not None:
                        # self.attr holds a tracked instance and is
                        # being *called*: self.fn(...)-style callables
                        resolved = self._resolve_class(mi, tok)
                        if resolved is not None:
                            hit = self._class_method(
                                resolved[0], resolved[1], '__call__')
                            if hit is not None:
                                return [hit]
                    return []  # per-class lookup is authoritative
        # typed receiver (local/module var, self.attr) → that class
        tok = self._receiver_token(mi, fn, base)
        if tok is not None:
            resolved = self._resolve_class(mi, tok)
            if resolved is not None:
                hit = self._class_method(resolved[0], resolved[1],
                                         f.attr)
                return [hit] if hit is not None else []
        # alias.f() → the imported module's f (def or class ctor)
        if isinstance(base, ast.Name):
            imp = mi.imports.get(base.id)
            if imp is not None:
                dotted = imp[1] if imp[0] == 'module' \
                    else f'{imp[1]}.{imp[2]}'
                tgt = self.by_dotted.get(dotted)
                if tgt is not None:
                    out = [(tgt, d) for d in tgt.defs.get(f.attr, [])
                           if self._is_top_level(tgt, d)]
                    ci = tgt.classes.get(f.attr)
                    if ci is not None and '__init__' in ci.methods:
                        out.append((tgt, ci.methods['__init__']))
                    if out or imp[0] == 'module':
                        return out
        # unknown receiver: historical same-file homonym fallback
        return [(mi, d) for d in mi.defs.get(f.attr, [])]

    @staticmethod
    def _is_top_level(mi: ModuleInfo, d: ast.AST) -> bool:
        return isinstance(mi.parents.get(d), ast.Module)

    def resolve_call(self, mi: ModuleInfo, fn: Optional[ast.AST],
                     call: ast.Call
                     ) -> List[Tuple[ModuleInfo, ast.AST]]:
        """Resolve one call site to its in-tree target def(s)."""
        f = call.func
        if isinstance(f, ast.Name):
            name = f.id
            if name in mi.defs:
                return [(mi, d) for d in mi.defs[name]]
            ci = mi.classes.get(name)
            if ci is not None:
                init = ci.methods.get('__init__')
                return [(mi, init)] if init is not None else []
            imp = mi.imports.get(name)
            if imp is not None and imp[0] == 'from':
                tgt = self.by_dotted.get(imp[1])
                if tgt is not None:
                    out = [(tgt, d) for d in tgt.defs.get(imp[2], [])
                           if self._is_top_level(tgt, d)]
                    ci = tgt.classes.get(imp[2])
                    if ci is not None and '__init__' in ci.methods:
                        out.append((tgt, ci.methods['__init__']))
                    return out
            return []
        if isinstance(f, ast.Attribute):
            return self._resolve_attr_call(mi, fn, f)
        return []

    def callees(self, mi: ModuleInfo, fn: ast.AST
                ) -> List[Tuple[ModuleInfo, ast.AST, ast.Call]]:
        """Every resolved call edge out of ``fn`` (memoized).  Walks
        the full subtree including nested defs — a closure's calls run
        when the closure does, and the closure is only reachable via
        its enclosing function."""
        key = (mi.sf.rel, fn.lineno)
        hit = self._callee_cache.get(key)
        if hit is not None:
            return hit
        out: List[Tuple[ModuleInfo, ast.AST, ast.Call]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                for tmi, d in self.resolve_call(mi, fn, node):
                    out.append((tmi, d, node))
        self._callee_cache[key] = out
        return out

    # -- reachability --------------------------------------------------------

    def _walk_reachable(self) -> None:
        work: List[Tuple[ModuleInfo, ast.AST]] = \
            [(mi, fn) for mi, fn, _site in self.entries]
        while work:
            mi, fn = work.pop()
            key = (mi.sf.rel, fn.lineno)
            if key in self.reachable:
                continue
            self.reachable.add(key)
            work.extend((tmi, d)
                        for tmi, d, _c in self.stage_callees(mi, fn))

    def reachable_set(self, mi: ModuleInfo,
                      fn: ast.AST) -> Set[FuncKey]:
        """Transitive closure of call edges from ``fn`` (inclusive) —
        the reachability primitive the KTPU6xx thread passes reuse."""
        seen: Set[FuncKey] = set()
        work = [(mi, fn)]
        while work:
            cmi, cfn = work.pop()
            key = (cmi.sf.rel, cfn.lineno)
            if key in seen:
                continue
            seen.add(key)
            work.extend((tmi, d)
                        for tmi, d, _c in self.callees(cmi, cfn))
        return seen

    # -- taint lattice -------------------------------------------------------

    def _bind_args(self, callee: ast.AST, call: ast.Call,
                   is_method_call: bool) -> List[Tuple[str, ast.AST]]:
        """(param name, arg expr) pairs for a resolved call."""
        args = callee.args
        pos = [a.arg for a in args.posonlyargs + args.args]
        if is_method_call and pos and pos[0] in ('self', 'cls'):
            pos = pos[1:]
        out: List[Tuple[str, ast.AST]] = []
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                break
            if i < len(pos):
                out.append((pos[i], a))
        kw_ok = {a.arg for a in
                 args.posonlyargs + args.args + args.kwonlyargs}
        for kw in call.keywords:
            if kw.arg is not None and kw.arg in kw_ok:
                out.append((kw.arg, kw.value))
        return out

    def expr_tainted(self, mi: ModuleInfo, fn: Optional[ast.AST],
                     expr: ast.AST, tainted: Set[str],
                     _depth: int = 0) -> bool:
        """Does ``expr`` (under ``tainted`` names) carry a device
        tensor?  Host metadata, readbacks and host-static builtins
        launder taint; calls consult the callee's return-taint
        summary."""
        if _depth > 6:
            return False
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Attribute):
            if expr.attr in STATIC_ATTRS:
                return False
            return self.expr_tainted(mi, fn, expr.value, tainted,
                                     _depth + 1)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and f.id in STATIC_BUILTINS:
                return False
            if isinstance(f, ast.Attribute) and \
                    f.attr in STATIC_METHODS | READBACK_METHODS:
                return False
            tensor = makes_tensor(f)
            if tensor is not None:
                return tensor
            targets = self.resolve_call(mi, fn, expr) \
                if fn is not None else []
            if targets:
                for tmi, d in targets:
                    bound = self._bind_args(
                        d, expr, isinstance(f, ast.Attribute))
                    sub = {p for p, a in bound
                           if self.expr_tainted(mi, fn, a, tainted,
                                                _depth + 1)}
                    if sub and self.returns_tainted(tmi, d,
                                                    frozenset(sub)):
                        return True
                # a method *on* a tainted receiver stays tainted even
                # when the callee body is opaque (t.sum(), t.astype())
            if isinstance(f, ast.Attribute) and not targets and \
                    self.expr_tainted(mi, fn, f.value, tainted,
                                      _depth + 1):
                return True
            # any other call with no resolved body (ctypes launches,
            # numpy, the standard library) returns host data, save the
            # builtins that hand their arguments through
            if isinstance(f, ast.Name) and f.id in PASSTHROUGH_BUILTINS:
                return any(self.expr_tainted(mi, fn, a, tainted,
                                             _depth + 1)
                           for a in expr.args)
            return False
        if isinstance(expr, ast.Compare) and \
                all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False  # an identity test reads no tensor value
        if isinstance(expr, _COMPREHENSIONS):
            # the element decides; a target bound from a tensor-carrying
            # iterable carries tensors
            inner = set(tainted)
            for gen in expr.generators:
                if self.expr_tainted(mi, fn, gen.iter, inner, _depth + 1):
                    inner.update(n.id for n in ast.walk(gen.target)
                                 if isinstance(n, ast.Name))
            elts = [expr.key, expr.value] \
                if isinstance(expr, ast.DictComp) else [expr.elt]
            return any(self.expr_tainted(mi, fn, e, inner, _depth + 1)
                       for e in elts)
        return any(self.expr_tainted(mi, fn, c, tainted, _depth + 1)
                   for c in ast.iter_child_nodes(expr))

    def tainted_locals(self, mi: ModuleInfo, fn: ast.AST,
                       params: Set[str]) -> Set[str]:
        """Tainted names visible in ``fn``: the tainted params plus
        locals assigned (transitively, to a small fixpoint) from
        tainted expressions."""
        memo_key = ((mi.sf.rel, fn.lineno), frozenset(params))
        hit = self._tainted_locals_memo.get(memo_key)
        if hit is not None:
            return set(hit)
        tainted = set(params)
        assigns = [n for n in self.scope_nodes(mi, fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign))]
        for _round in range(3):
            grew = False
            for node in assigns:
                value = node.value
                if value is None or not self.expr_tainted(
                        mi, fn, value, tainted):
                    continue
                targets = node.targets \
                    if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    elts = t.elts if isinstance(
                        t, (ast.Tuple, ast.List)) else [t]
                    if len(elts) > 1:
                        kinds = self._tuple_kinds(mi, fn, value)
                        if kinds is not None and len(kinds) == len(elts):
                            elts = [e for e, k in zip(elts, kinds) if k]
                    for e in elts:
                        if isinstance(e, ast.Name) and \
                                e.id not in tainted:
                            tainted.add(e.id)
                            grew = True
            if not grew:
                break
        self._tainted_locals_memo[memo_key] = set(tainted)
        return tainted

    def _tuple_kinds(self, mi: ModuleInfo, fn: ast.AST,
                     value: ast.AST) -> Optional[List[bool]]:
        """For ``a, b = param`` where the parameter is annotated with a
        fixed ``Tuple[...]`` (directly, under ``Optional``, or through
        a module-level alias such as ``Lane = Tuple[torch.Tensor,
        int]``): which elements are tensors.  ``None`` when unknown —
        then every target takes the value's taint."""
        if not isinstance(value, ast.Name):
            return None
        args = fn.args
        ann = next((a.annotation for a in
                    args.posonlyargs + args.args + args.kwonlyargs
                    if a.arg == value.id), None)
        for _hop in range(3):
            if isinstance(ann, ast.Name):
                ann = next((n.value for n in mi.sf.tree.body
                            if isinstance(n, ast.Assign) and any(
                                isinstance(t, ast.Name) and t.id == ann.id
                                for t in n.targets)), None)
            elif isinstance(ann, ast.Subscript) and \
                    getattr(ann.value, 'id', '') == 'Optional':
                ann = ann.slice
            else:
                break
        if not (isinstance(ann, ast.Subscript) and
                getattr(ann.value, 'id', '') == 'Tuple' and
                isinstance(ann.slice, ast.Tuple)):
            return None
        elts = ann.slice.elts
        if any(isinstance(e, ast.Constant) and e.value is Ellipsis
               for e in elts):
            return None
        return [any(isinstance(n, (ast.Name, ast.Attribute)) and
                    getattr(n, 'id', getattr(n, 'attr', '')) == 'Tensor'
                    for n in ast.walk(e)) for e in elts]

    def returns_tainted(self, mi: ModuleInfo, fn: ast.AST,
                        params: frozenset) -> bool:
        """Does ``fn`` return a tainted value when ``params`` are
        tainted?  Memoized; cycles assume False (under-approximate —
        a missed return edge costs a missed finding, never a false
        one)."""
        key = ((mi.sf.rel, fn.lineno), params)
        hit = self._return_taint_memo.get(key)
        if hit is not None:
            return hit
        self._return_taint_memo[key] = False  # cycle guard
        tainted = self.tainted_locals(mi, fn, set(params))
        result = False
        for node in self.scope_nodes(mi, fn):
            if isinstance(node, ast.Return) and node.value is not None:
                if self.expr_tainted(mi, fn, node.value, tainted):
                    result = True
                    break
        self._return_taint_memo[key] = result
        return result

    def _propagate_taint(self) -> None:
        limit = taint_depth()
        work: List[FuncKey] = []
        infos: Dict[FuncKey, Tuple[ModuleInfo, ast.AST]] = {}
        for mi, fn, site in self.entries:
            key = (mi.sf.rel, fn.lineno)
            params = self.entry_tainted_params(mi, fn, site)
            if not params:
                continue
            infos[key] = (mi, fn)
            prev = self.taint.setdefault(key, set())
            if not params <= prev or key not in self.taint_min_depth:
                prev.update(params)
                self.taint_min_depth[key] = 0
                info = mi.func_info.get(fn)
                self.taint_chain.setdefault(
                    key, (info.qualname if info else fn.name,))
                work.append(key)
        while work:
            key = work.pop()
            mi, fn = infos[key]
            depth = self.taint_min_depth[key]
            if depth >= limit:
                continue
            params = set(self.taint[key])
            tainted = self.tainted_locals(mi, fn, params)
            for tmi, d, call in self.stage_callees(mi, fn):
                bound = self._bind_args(
                    d, call, isinstance(call.func, ast.Attribute))
                sub = {p for p, a in bound
                       if self.expr_tainted(mi, fn, a, tainted)}
                if not sub:
                    continue
                tkey = (tmi.sf.rel, d.lineno)
                prev = self.taint.setdefault(tkey, set())
                old_depth = self.taint_min_depth.get(tkey)
                new_depth = depth + 1
                changed = not sub <= prev
                prev.update(sub)
                if old_depth is None or new_depth < old_depth:
                    self.taint_min_depth[tkey] = new_depth
                    changed = True
                if tkey not in self.taint_chain:
                    info = tmi.func_info.get(d)
                    self.taint_chain[tkey] = self.taint_chain[key] + \
                        (info.qualname if info else d.name,)
                if changed:
                    infos[tkey] = (tmi, d)
                    work.append(tkey)

    def tainted_names_for(self, mi: ModuleInfo,
                          fn: ast.AST) -> Set[str]:
        """Tainted params ∪ tainted locals for a reachable function
        (empty when taint never reaches it)."""
        params = self.taint.get((mi.sf.rel, fn.lineno))
        if not params:
            return set()
        return self.tainted_locals(mi, fn, params)

    def chain_for(self, mi: ModuleInfo, fn: ast.AST) -> str:
        """Rendered entry→function call chain for finding messages."""
        chain = self.taint_chain.get((mi.sf.rel, fn.lineno))
        if not chain:
            return ''
        return ' -> '.join(chain)

    # -- queries -------------------------------------------------------------

    def scope_nodes(self, mi: ModuleInfo,
                    fn: ast.AST) -> List[ast.AST]:
        """Memoized :func:`walk_scope` — every pass asking for a
        function's own-scope nodes shares one traversal."""
        key = (mi.sf.rel, fn.lineno)
        hit = self._scope_cache.get(key)
        if hit is None:
            hit = list(walk_scope(fn))
            self._scope_cache[key] = hit
        return hit

    def reachable_functions(self):
        """Yield ``(SourceFile, ModuleInfo, FunctionDef)`` for every
        function whose body may run inside a device stage."""
        for mi in self.modules.values():
            for defs in mi.defs.values():
                for d in defs:
                    if (mi.sf.rel, d.lineno) in self.reachable:
                        yield mi.sf, mi, d

    def enclosing_scopes(self, mi: ModuleInfo, fn: ast.AST) -> List[ast.AST]:
        """Lexically enclosing function scopes (innermost first), then
        the module."""
        out: List[ast.AST] = []
        node = mi.parents.get(fn)
        while node is not None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Module)):
                out.append(node)
            node = mi.parents.get(node)
        return out

    def function_by_name(self, name: str
                         ) -> List[Tuple[ModuleInfo, ast.AST]]:
        """Every def matching ``name`` — bare (``_worker``), qualified
        (``ChunkPipeline._worker``), or dotted-module-prefixed
        (``kyverno_tpu.compiler.pipeline:ChunkPipeline._worker``) —
        for ``--graph-dump``."""
        out: List[Tuple[ModuleInfo, ast.AST]] = []
        for mi in self.modules.values():
            for info in mi.func_info.values():
                qn = info.qualname
                short = qn.split(':', 1)[1] if ':' in qn else qn
                if name in (qn, short, short.split('.')[-1]):
                    out.append((mi, info.node))
        return out

    def graph_dump(self, mi: ModuleInfo, fn: ast.AST) -> dict:
        """Resolved callees + taint facts for one function (the
        ``--graph-dump`` payload)."""
        info = mi.func_info.get(fn)
        key = (mi.sf.rel, fn.lineno)
        callees = []
        seen = set()
        for tmi, d, call in self.callees(mi, fn):
            tinfo = tmi.func_info.get(d)
            ck = (tmi.sf.rel, d.lineno, call.lineno)
            if ck in seen:
                continue
            seen.add(ck)
            callees.append({
                'qualname': tinfo.qualname if tinfo else d.name,
                'file': tmi.sf.rel, 'line': d.lineno,
                'call_line': call.lineno,
                'jit_reachable': (tmi.sf.rel, d.lineno)
                                 in self.reachable})
        return {
            'qualname': info.qualname if info else fn.name,
            'file': mi.sf.rel, 'line': fn.lineno,
            'class': info.cls if info else None,
            'jit_reachable': key in self.reachable,
            'callees': callees,
            'taint': {
                'params': sorted(self.taint.get(key, ())),
                'depth': self.taint_min_depth.get(key),
                'chain': list(self.taint_chain.get(key, ())),
                'names': sorted(self.tainted_names_for(mi, fn)),
            },
        }


def jit_graph(ctx: Context) -> JitGraph:
    return ctx.cached('jitgraph', lambda: JitGraph(ctx))
