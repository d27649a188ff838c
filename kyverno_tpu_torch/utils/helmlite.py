"""Minimal Helm-template renderer for the kyverno-policies chart.

Renders /root/reference/charts/kyverno-policies/templates/{baseline,
restricted} (reference layout) with the chart's default values — enough
of Go template semantics for that chart: ``{{- if/with/else/end }}``
blocks, backtick-escaped literals (``{{`{{ ... }}`}}`` — how the chart
embeds kyverno variables), and the handful of ``.Values`` pipelines the
templates use.  Not a general Helm implementation.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

DEFAULT_VALUES: Dict[str, Any] = {
    # chart defaults (reference: charts/kyverno-policies/values.yaml)
    'podSecurityStandard': 'baseline',
    'podSecuritySeverity': 'medium',
    'podSecurityPolicies': [],
    'includeOtherPolicies': [],
    'includeRestrictedPolicies': [],
    'failurePolicy': 'Fail',
    'validationFailureAction': 'audit',
    'validationFailureActionByPolicy': {},
    'validationFailureActionOverrides': {'all': []},
    'policyExclude': {},
    'policyPreconditions': {},
    'autogenControllers': '',
    'background': True,
    'customLabels': {},
}

_ESCAPED = re.compile(r'\{\{`(.*?)`\}\}', re.DOTALL)
_ACTION = re.compile(r'\{\{-?\s*(.*?)\s*-?\}\}')


def render(text: str, name: str, values: Optional[Dict[str, Any]] = None,
           restricted: bool = False) -> str:
    vals = dict(DEFAULT_VALUES)
    if restricted:
        vals['podSecurityStandard'] = 'restricted'
    if values:
        vals.update(values)
    # protect backtick-escaped literals before template processing
    protected: List[str] = []

    def keep(m: re.Match) -> str:
        protected.append(m.group(1))
        return f'\x00{len(protected) - 1}\x00'

    text = _ESCAPED.sub(keep, text)
    lines = text.split('\n')
    out: List[str] = []
    _render_block(lines, 0, len(lines), out, vals, name, emit=True)
    result = '\n'.join(out)
    return re.sub(r'\x00(\d+)\x00',
                  lambda m: protected[int(m.group(1))], result)


def _directive(line: str) -> Optional[str]:
    s = line.strip()
    m = _ACTION.fullmatch(s)
    return m.group(1).strip() if m else None


def _render_block(lines: List[str], i: int, end: int, out: List[str],
                  vals: Dict[str, Any], name: str, emit: bool) -> int:
    """Render lines[i:end]; returns the index after the consumed block."""
    while i < end:
        line = lines[i]
        d = _directive(line)
        if d is None:
            if emit:
                rendered = _subst(line, vals, name)
                if rendered is not None:
                    out.append(rendered)
            i += 1
            continue
        if d.startswith('$') and ':=' in d:  # {{- $name := "..." }}
            i += 1
            continue
        if d.startswith('include'):
            i += 1
            continue
        if d.startswith('if ') or d.startswith('with '):
            cond = _truthy(d.split(' ', 1)[1], vals, name)
            # find matching else/end at this nesting level
            j, else_at = i + 1, None
            depth = 0
            while j < end:
                dj = _directive(lines[j])
                if dj is not None:
                    if dj.startswith(('if ', 'with ', 'range ')):
                        depth += 1
                    elif dj == 'end':
                        if depth == 0:
                            break
                        depth -= 1
                    elif dj == 'else' and depth == 0:
                        else_at = j
                j += 1
            body_end = else_at if else_at is not None else j
            _render_block(lines, i + 1, body_end, out, vals, name,
                          emit and bool(cond))
            if else_at is not None:
                _render_block(lines, else_at + 1, j, out, vals, name,
                              emit and not cond)
            i = j + 1
            continue
        if d in ('end', 'else'):
            i += 1
            continue
        i += 1  # unknown standalone directive: drop
    return i


def _lookup(expr: str, vals: Dict[str, Any], name: str) -> Any:
    expr = expr.strip()
    if expr.startswith('.Values.'):
        cur: Any = vals
        for part in expr[len('.Values.'):].split('.'):
            if not isinstance(cur, dict):
                return None
            cur = cur.get(part)
        return cur
    m = re.fullmatch(r'index \.Values "([^"]+)"(?: \$name)?', expr)
    if m:
        v = vals.get(m.group(1))
        if expr.endswith('$name') and isinstance(v, dict):
            return v.get(name)
        return v
    if expr == '$name':
        return name
    return None


def _truthy(expr: str, vals: Dict[str, Any], name: str) -> bool:
    expr = expr.strip()
    if expr.startswith('eq (include "kyverno-policies.podSecurity'):
        return True  # policy enabled under the selected standard
    if expr.startswith('include'):
        return True
    m = re.fullmatch(r'concat \(index \.Values "([^"]+)" "all"\).*', expr)
    if m:
        return bool((vals.get(m.group(1)) or {}).get('all'))
    v = _lookup(expr, vals, name)
    return bool(v)


def _subst(line: str, vals: Dict[str, Any], name: str) -> Optional[str]:
    def repl(m: re.Match) -> str:
        expr = m.group(1).strip()
        if expr == '$name':
            return name
        if expr == '.':
            return ''  # {{ . }} inside with-blocks: dropped with the block
        if expr.startswith('include "kyverno-policies.labels"'):
            return "{'app.kubernetes.io/part-of': kyverno-policies}"
        expr = expr.split('|')[0].strip()
        if expr.startswith('toYaml '):
            expr = expr[len('toYaml '):].strip()
        v = _lookup(expr, vals, name)
        if v is None:
            return ''
        if isinstance(v, bool):
            return 'true' if v else 'false'
        return str(v)

    return _ACTION.sub(repl, line)


def load_chart_policies(chart_dir: str, profiles=('baseline',),
                        values: Optional[Dict[str, Any]] = None) -> List[dict]:
    """Render and parse the kyverno-policies chart templates."""
    import os
    import yaml
    out: List[dict] = []
    for profile in profiles:
        tdir = os.path.join(chart_dir, 'templates', profile)
        for fn in sorted(os.listdir(tdir)):
            if not fn.endswith('.yaml'):
                continue
            name = fn[:-len('.yaml')]
            text = open(os.path.join(tdir, fn)).read()
            rendered = render(text, name, values,
                              restricted=(profile == 'restricted'))
            for doc in yaml.safe_load_all(rendered):
                if doc and doc.get('kind') in ('ClusterPolicy', 'Policy'):
                    out.append(doc)
    return out
