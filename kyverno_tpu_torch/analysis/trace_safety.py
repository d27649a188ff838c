"""Host-sync passes (KTPU1xx): the host waiting on the card inside a
device stage.

The port queues its device work — torch ops and the hand-written
kernels — on a CUDA stream and reads each stage's result back once.
A host read of a tensor anywhere else inside a stage blocks the host
until the stream drains: the batcher's next batch cannot encode while
the card runs, and a sync per call caps the pipeline at the launch
latency.  These passes flag the constructs on any function reachable
from a declared device stage (``jitgraph.DEVICE_STAGES``: the
evaluator's K1 call, the kernel wrappers, ``MutateKernel.__call__``,
the mesh step).  A stage's own single readback is the one allowed
sync, marked by a ``# ktpu: noqa[KTPU101] -- reason``.

The passes are **interprocedural**: KTPU102/103 consult the
param-rooted taint lattice, so a helper three call edges below the
stage that casts or branches on a value derived from a stage's
tensor *argument* is a finding at the helper's own site, with the
stage→helper call chain in the message.  Local evidence (a
``torch.*`` call in the expression, a local assigned from one) counts
as well.

* **KTPU101** — explicit host syncs: ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize`` / any ``.synchronize()``, and
  ``.item()`` / ``.tolist()`` / ``np.asarray`` / ``np.array`` on a
  tensor expression.
* **KTPU102** — Python scalar casts (``float`` / ``int`` / ``bool``)
  over a tensor expression: each reads the value back.
* **KTPU103** — Python ``if`` / ``while`` on a tensor expression
  (``is None`` identity tests excluded — those gate Python-level
  optionality, not tensor values): the test reads the value back.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .core import Context, Finding, register
from .jitgraph import jit_graph, torch_call_name

#: tensor methods that copy to the host and wait for the card
SYNC_METHODS = {'cpu', 'numpy'}

#: methods that read a value back when called on a tensor (numpy has
#: them too, so they count only over a tensor expression)
TENSOR_READ_METHODS = {'item', 'tolist'}

#: ``module.func`` spellings that materialize a host array from a tensor
SYNC_MODULE_CALLS = {
    ('np', 'asarray'), ('np', 'array'), ('numpy', 'asarray'),
    ('numpy', 'array'),
}


def _is_none_test(test: ast.AST) -> bool:
    """``x is None`` / ``x is not None`` (possibly under ``not``)."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_none_test(test.operand)
    if isinstance(test, ast.Compare):
        return any(isinstance(op, (ast.Is, ast.IsNot))
                   for op in test.ops)
    return False


def _chain_suffix(graph, mi, fn) -> str:
    chain = graph.chain_for(mi, fn)
    return f' (call chain: {chain})' if chain else ''


def _tensor_hits(graph, mi, fn):
    """``hit(expr) -> None | 'local' | 'taint'``: whether ``expr`` is a
    tensor by local evidence (a ``torch.*`` call, a local assigned
    from one) or by a stage argument's taint."""
    local = graph.tainted_locals(mi, fn, set())
    tainted = graph.tainted_names_for(mi, fn)

    def hit(expr: ast.AST):
        if graph.expr_tainted(mi, fn, expr, local):
            return 'local'
        if tainted and graph.expr_tainted(mi, fn, expr, tainted):
            return 'taint'
        return None
    return hit


@register('KTPU101', 'host-sync call (.cpu()/.numpy()/.synchronize(), '
                     'or .item()/.tolist()/np.asarray on a tensor) '
                     'inside a device-stage-reachable function')
def _check_host_sync(ctx: Context) -> Iterable[Finding]:
    graph = jit_graph(ctx)
    for sf, mi, fn in graph.reachable_functions():
        hit = None
        for node in graph.scope_nodes(mi, fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            if f.attr == 'synchronize' or \
                    (f.attr in SYNC_METHODS and not node.args):
                spelled = 'torch.cuda.synchronize' \
                    if torch_call_name(f) == 'synchronize' \
                    else f'.{f.attr}()'
                yield sf.finding(
                    'KTPU101', node,
                    f'`{spelled}` waits for the card inside '
                    f'stage-reachable `{fn.name}` — keep the value on '
                    f'the device, or make it the stage\'s one readback '
                    f'(noqa with the reason)'
                    f'{_chain_suffix(graph, mi, fn)}')
                continue
            hit = hit or _tensor_hits(graph, mi, fn)
            if f.attr in TENSOR_READ_METHODS and not node.args and \
                    hit(f.value):
                yield sf.finding(
                    'KTPU101', node,
                    f'`.{f.attr}()` on a tensor reads it back inside '
                    f'stage-reachable `{fn.name}` — keep the value on '
                    f'the device or hoist the read to the host side'
                    f'{_chain_suffix(graph, mi, fn)}')
                continue
            base = f.value
            if isinstance(base, ast.Name) and \
                    (base.id, f.attr) in SYNC_MODULE_CALLS and \
                    node.args and hit(node.args[0]):
                yield sf.finding(
                    'KTPU101', node,
                    f'`{base.id}.{f.attr}` of a tensor copies it to the '
                    f'host inside stage-reachable `{fn.name}` — use '
                    f'torch ops, or move the conversion past the '
                    f'stage\'s readback'
                    f'{_chain_suffix(graph, mi, fn)}')


@register('KTPU102', 'Python scalar cast (float/int/bool) over a tensor '
                     'or tensor-tainted expression inside a '
                     'device-stage-reachable function')
def _check_scalar_cast(ctx: Context) -> Iterable[Finding]:
    graph = jit_graph(ctx)
    for sf, mi, fn in graph.reachable_functions():
        hit = None
        for node in graph.scope_nodes(mi, fn):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Name) and
                    node.func.id in ('float', 'int', 'bool') and
                    len(node.args) == 1):
                continue
            hit = hit or _tensor_hits(graph, mi, fn)
            how = hit(node.args[0])
            if how:
                why = 'a tensor expression' if how == 'local' else \
                    'a tensor-tainted argument'
                yield sf.finding(
                    'KTPU102', node,
                    f'`{node.func.id}(...)` over {why} in '
                    f'stage-reachable `{fn.name}` reads the value back '
                    f'— keep it as a tensor'
                    f'{_chain_suffix(graph, mi, fn)}')


@register('KTPU103', 'Python if/while branching on a tensor or '
                     'tensor-tainted expression inside a '
                     'device-stage-reachable function')
def _check_tensor_branch(ctx: Context) -> Iterable[Finding]:
    graph = jit_graph(ctx)
    for sf, mi, fn in graph.reachable_functions():
        hit = None
        for node in graph.scope_nodes(mi, fn):
            if not isinstance(node, (ast.If, ast.While)) or \
                    _is_none_test(node.test):
                continue
            hit = hit or _tensor_hits(graph, mi, fn)
            if hit(node.test):
                kw = 'if' if isinstance(node, ast.If) else 'while'
                yield sf.finding(
                    'KTPU103', node,
                    f'Python `{kw}` on a tensor expression in '
                    f'stage-reachable `{fn.name}` reads the value back '
                    f'— use torch.where, or branch on host data'
                    f'{_chain_suffix(graph, mi, fn)}')
