"""Lint-framework core: findings, rule registry, suppressions, baseline.

Design constraints (they shape every API here):

* **Pure AST** — the analyzer must run in tier-1 on a CPU-only box in
  well under 10 seconds, so no pass may import the modules it inspects
  (the one deliberate exception is the metric catalog, a plain table).
* **Stable rule ids** — ``KTPU###`` strings are a public contract:
  they appear in ``# ktpu: noqa[...]`` comments and in the committed
  baseline, so renumbering a rule invalidates user annotations.
* **Suppressions carry reasons** — ``# ktpu: noqa[KTPU101] -- why`` is
  the only accepted form; a bare ``noqa[...]`` is itself a finding
  (KTPU001), and a noqa that suppresses nothing is one too (KTPU002),
  so annotations can never silently rot.
* **Baseline is minimal by construction** — entries match on (rule,
  path, stripped line text) so they survive line drift but die with
  the code they grandfathered; a stale entry fails ``--strict``.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

#: suppression comment — a hash, then ``ktpu: noqa[RULE,...]``,
#: optionally followed by ``-- reason text`` (reason required: a bare
#: directive is itself a KTPU001 finding)
NOQA_RE = re.compile(
    r'#\s*ktpu:\s*noqa\[([A-Za-z0-9_,\s]*)\]\s*(?:--\s*(\S.*))?')

RULE_ID_RE = re.compile(r'^KTPU\d{3}$')

#: the committed baseline of grandfathered findings, inside the package
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'baseline.json')


@dataclass(frozen=True)
class Finding:
    rule_id: str
    path: str          # repo-relative
    line: int          # 1-indexed
    message: str
    line_text: str = ''  # stripped source line, the baseline match key

    def key(self) -> Tuple[str, str, str]:
        return (self.rule_id, self.path, self.line_text)

    def render(self) -> str:
        return f'{self.path}:{self.line}: {self.rule_id} {self.message}'


@dataclass
class Noqa:
    line: int
    rule_ids: Tuple[str, ...]
    reason: str
    used: bool = False


class SourceFile:
    """One parsed source file: AST + per-line noqa directives.

    Also the per-file AST memo: :meth:`walk` flattens the tree once
    and :meth:`nodes_of` indexes it by node type once, so a dozen
    passes asking "every Call in this file" cost one traversal total
    instead of one ``ast.walk`` each — the difference between the
    analyzer fitting its 10s tier-1 budget and not.
    """

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.syntax_error: Optional[str] = None
        self._nodes: Optional[List[ast.AST]] = None
        self._by_type: Dict[type, List[ast.AST]] = {}
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            self.syntax_error = str(e)
        # tokenize so only real comments count — a docstring QUOTING a
        # `# ktpu: noqa[...]` directive must not suppress anything
        self.noqa: Dict[int, Noqa] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = NOQA_RE.search(tok.string)
                if m:
                    i = tok.start[0]
                    ids = tuple(x.strip() for x in m.group(1).split(',')
                                if x.strip())
                    self.noqa[i] = Noqa(i, ids,
                                        (m.group(2) or '').strip())
        except (tokenize.TokenError, IndentationError):
            pass  # syntax_error already recorded above

    def walk(self) -> List[ast.AST]:
        """Every node in the file, flattened once and memoized."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree)) \
                if self.tree is not None else []
        return self._nodes

    def nodes_of(self, *types: type) -> List[ast.AST]:
        """Every node of the given type(s), from a memoized per-type
        index (``isinstance``-exact: pass each concrete type)."""
        out: List[ast.AST] = []
        for t in types:
            if t not in self._by_type:
                self._by_type[t] = [n for n in self.walk()
                                    if type(n) is t]
            out.extend(self._by_type[t])
        return out

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ''

    def finding(self, rule_id: str, node_or_line, message: str) -> Finding:
        line = getattr(node_or_line, 'lineno', node_or_line)
        return Finding(rule_id, self.rel, line, message,
                       self.line_text(line))


@dataclass
class Rule:
    rule_id: str
    summary: str
    check: Callable[['Context'], Iterable[Finding]]
    meta: bool = False  # meta rules run after suppression filtering


#: the registry — stable ids, one entry per pass
RULES: Dict[str, Rule] = {}


def register(rule_id: str, summary: str, meta: bool = False):
    """Register a lint pass under a stable ``KTPU###`` id."""
    if not RULE_ID_RE.match(rule_id):
        raise ValueError(f'bad rule id {rule_id!r}')

    def deco(fn: Callable[['Context'], Iterable[Finding]]):
        if rule_id in RULES:
            raise ValueError(f'duplicate rule id {rule_id}')
        RULES[rule_id] = Rule(rule_id, summary, fn, meta=meta)
        return fn
    return deco


class Context:
    """Shared state handed to every pass: the parsed file set plus
    lazily-built cross-file indexes (jit call graph, taxonomy, ...)."""

    def __init__(self, files: List[SourceFile], root: str):
        self.files = files
        self.root = root
        self._cache: Dict[str, object] = {}

    def by_rel(self, rel: str) -> Optional[SourceFile]:
        for f in self.files:
            if f.rel == rel:
                return f
        return None

    def cached(self, key: str, build: Callable[[], object]):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]


# -- file collection ---------------------------------------------------------

#: the ONE directory exclude list every walker shares — the driver
#: (``python -m kyverno_tpu_torch.analysis``), :func:`collect_files`, and the
#: ``catalog_pass`` shim all consume this instead of keeping private
#: copies that drift.  ``tests`` is excluded because fixture strings
#: deliberately contain violations; caches/VCS dirs never hold source.
EXCLUDE_DIRS = frozenset({
    '__pycache__', '.git', '.cache', 'node_modules', 'tests',
    'fixtures',
})

#: the default analyzed file set, shared by the driver and the
#: standalone catalog checker (the lint lints itself as part of the
#: package; ``tests/`` is excluded above)
DEFAULT_SOURCE_PATHS = ('kyverno_tpu_torch', 'chip_smoke.py', 'k1v_bench.py')


def collect_files(paths: List[str], root: str) -> List[SourceFile]:
    out: List[SourceFile] = []
    seen = set()
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap):
            cands = [ap]
        else:
            cands = []
            for base, dirs, names in os.walk(ap):
                dirs[:] = [d for d in dirs if d not in EXCLUDE_DIRS]
                cands.extend(os.path.join(base, n) for n in sorted(names)
                             if n.endswith('.py'))
        for c in sorted(cands):
            c = os.path.abspath(c)
            if c in seen:
                continue
            seen.add(c)
            with open(c, encoding='utf-8') as f:
                text = f.read()
            out.append(SourceFile(c, os.path.relpath(c, root), text))
    return out


# -- baseline ----------------------------------------------------------------

def load_baseline(path: str) -> List[dict]:
    """Entries: ``{"rule", "path", "match", "reason"}`` — ``match`` is
    the stripped source line of the grandfathered finding."""
    if not os.path.exists(path):
        return []
    with open(path, encoding='utf-8') as f:
        doc = json.load(f)
    return list(doc.get('entries', []))


def write_baseline(path: str, findings: List[Finding],
                   reason: str = 'TODO: justify this grandfathered '
                                 'finding') -> None:
    entries = []
    seen = set()
    for f in sorted(findings, key=lambda f: (f.rule_id, f.path, f.line)):
        key = f.key()
        if key in seen:
            continue
        seen.add(key)
        entries.append({'rule': f.rule_id, 'path': f.path,
                        'match': f.line_text, 'reason': reason})
    with open(path, 'w', encoding='utf-8') as fh:
        json.dump({'entries': entries}, fh, indent=2)
        fh.write('\n')


# -- meta rules (registered here so the registry always has them) ------------

@register('KTPU001', 'ktpu noqa suppression without a reason string '
                     '(`# ktpu: noqa[ID] -- why`)', meta=True)
def _check_noqa_reason(ctx: Context) -> Iterable[Finding]:
    for sf in ctx.files:
        for nq in sf.noqa.values():
            bad_ids = [i for i in nq.rule_ids if not RULE_ID_RE.match(i)]
            if bad_ids or not nq.rule_ids:
                yield sf.finding(
                    'KTPU001', nq.line,
                    f'malformed ktpu noqa rule list {nq.rule_ids!r} — '
                    f'use explicit KTPU### ids')
            elif not nq.reason:
                yield sf.finding(
                    'KTPU001', nq.line,
                    f'noqa[{",".join(nq.rule_ids)}] has no reason — '
                    f'append `-- <why this is intentionally host-side>`')


@register('KTPU002', 'ktpu noqa suppression that suppresses nothing '
                     '(stale annotation)', meta=True)
def _check_noqa_used(ctx: Context) -> Iterable[Finding]:
    for sf in ctx.files:
        for nq in sf.noqa.values():
            if not nq.used and nq.rule_ids and \
                    all(RULE_ID_RE.match(i) for i in nq.rule_ids):
                yield sf.finding(
                    'KTPU002', nq.line,
                    f'noqa[{",".join(nq.rule_ids)}] suppresses no '
                    f'finding — remove the stale annotation')


# -- driver ------------------------------------------------------------------

@dataclass
class Report:
    active: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    stale_baseline: List[dict] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)

    def to_json(self) -> dict:
        def enc(fs):
            return [{'rule': f.rule_id, 'path': f.path, 'line': f.line,
                     'message': f.message, 'match': f.line_text}
                    for f in fs]
        return {'active': enc(self.active),
                'suppressed': enc(self.suppressed),
                'baselined': enc(self.baselined),
                'stale_baseline': self.stale_baseline,
                'errors': self.errors,
                'counts': {'active': len(self.active),
                           'suppressed': len(self.suppressed),
                           'baselined': len(self.baselined),
                           'stale_baseline': len(self.stale_baseline)}}


class Analyzer:
    """Run every registered pass over a file set, apply suppressions,
    then the baseline; meta passes (noqa hygiene) run after suppression
    state is known."""

    def __init__(self, paths: List[str], root: str,
                 baseline_path: Optional[str] = None,
                 rules: Optional[List[str]] = None):
        self.root = os.path.abspath(root)
        self.files = collect_files(paths, self.root)
        self.ctx = Context(self.files, self.root)
        self.baseline_path = baseline_path
        self.rule_ids = rules  # None = all

    def _selected(self, meta: bool) -> List[Rule]:
        out = []
        for rid in sorted(RULES):
            rule = RULES[rid]
            if rule.meta != meta:
                continue
            if self.rule_ids is not None and rid not in self.rule_ids:
                continue
            out.append(rule)
        return out

    def _suppressed_by(self, sf: SourceFile, f: Finding) -> Optional[Noqa]:
        # a directive suppresses findings on its own line, or — for
        # statements that cannot carry a trailing comment — anywhere in
        # the contiguous comment block directly above (so wrapped
        # reason text keeps working)
        nq = sf.noqa.get(f.line)
        if nq is not None and f.rule_id in nq.rule_ids:
            return nq
        line = f.line - 1
        while line > 0 and sf.line_text(line).startswith('#'):
            nq = sf.noqa.get(line)
            if nq is not None and f.rule_id in nq.rule_ids:
                return nq
            line -= 1
        return None

    def run(self) -> Report:
        rep = Report()
        for sf in self.files:
            if sf.syntax_error:
                rep.errors.append(f'{sf.rel}: syntax error: '
                                  f'{sf.syntax_error}')
        by_rel = {sf.rel: sf for sf in self.files}
        raw: List[Finding] = []
        for rule in self._selected(meta=False):
            raw.extend(rule.check(self.ctx))
        kept: List[Finding] = []
        for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule_id)):
            sf = by_rel.get(f.path)
            nq = self._suppressed_by(sf, f) if sf is not None else None
            if nq is not None:
                nq.used = True
                rep.suppressed.append(f)
            else:
                kept.append(f)
        # meta passes see final suppression usage; they are not
        # themselves noqa-suppressible (that would be circular) but may
        # be baselined
        for rule in self._selected(meta=True):
            kept.extend(rule.check(self.ctx))
        entries = load_baseline(self.baseline_path) \
            if self.baseline_path else []
        matched = [0] * len(entries)
        for f in kept:
            hit = None
            for i, e in enumerate(entries):
                if (e.get('rule'), e.get('path'), e.get('match')) == \
                        f.key():
                    hit = i
                    break
            if hit is None:
                rep.active.append(f)
            else:
                matched[hit] += 1
                rep.baselined.append(f)
        for i, e in enumerate(entries):
            if not matched[i]:
                rep.stale_baseline.append(e)
            if not str(e.get('reason', '')).strip() or \
                    str(e.get('reason', '')).startswith('TODO'):
                rep.errors.append(
                    f'baseline entry {e.get("rule")} {e.get("path")} '
                    f'has no justification — every grandfathered '
                    f'finding needs a reason')
        rep.active.sort(key=lambda f: (f.path, f.line, f.rule_id))
        return rep
