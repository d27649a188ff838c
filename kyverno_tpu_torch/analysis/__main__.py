"""ktpu-lint driver for the port: run every static-analysis pass over
the tree.

    python -m kyverno_tpu_torch.analysis                  # findings
    python -m kyverno_tpu_torch.analysis --json           # machine-readable
    python -m kyverno_tpu_torch.analysis --strict         # nonzero on any
                                                          # non-baseline
                                                          # finding or stale
                                                          # baseline entry
    python -m kyverno_tpu_torch.analysis --write-baseline # regenerate the
                                                          # grandfather file
    python -m kyverno_tpu_torch.analysis --knob-table     # README table
    python -m kyverno_tpu_torch.analysis --list-rules     # rule ids

Default file set: ``kyverno_tpu_torch/``, ``chip_smoke.py`` and
``k1v_bench.py``, relative to the repository root.  The committed
baseline is ``kyverno_tpu_torch/analysis/baseline.json``; every entry
must carry a ``reason`` (``--strict`` refuses unjustified entries).
Per-line suppressions: ``# ktpu: noqa[KTPU101] -- reason``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import RULES, Analyzer, load_baseline, write_baseline
from .core import DEFAULT_BASELINE, DEFAULT_SOURCE_PATHS
from .knobs import render_knob_table

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _print_graph_dump(dumps, as_json: bool) -> None:
    if as_json:
        print(json.dumps(dumps, indent=2))
        return
    for d in dumps:
        print(f'{d["qualname"]}  ({d["file"]}:{d["line"]})')
        print(f'  stage-reachable: {d["jit_reachable"]}')
        if d.get('class'):
            print(f'  class: {d["class"]}')
        print('  callees:')
        if not d['callees']:
            print('    (none resolved)')
        for c in d['callees']:
            reach = ' [stage-reachable]' if c['jit_reachable'] else ''
            print(f'    {c["qualname"]}  ({c["file"]}:{c["line"]}, '
                  f'called at line {c["call_line"]}){reach}')
        taint = d.get('taint') or {}
        if taint.get('params'):
            print(f'  tainted params (depth {taint.get("depth")}): '
                  f'{", ".join(taint["params"])}')
            if taint.get('chain'):
                print(f'  taint chain: {" -> ".join(taint["chain"])}')
            print(f'  tainted locals: '
                  f'{", ".join(taint.get("names", [])) or "-"}')
        else:
            print('  tainted params: (none)')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m kyverno_tpu_torch.analysis', description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('paths', nargs='*', default=None,
                    help='files/dirs to analyze (default: '
                         + ' '.join(DEFAULT_SOURCE_PATHS) + ')')
    ap.add_argument('--json', action='store_true', dest='as_json')
    ap.add_argument('--strict', action='store_true',
                    help='exit nonzero on non-baseline findings, '
                         'stale baseline entries, or unjustified '
                         'baseline entries')
    ap.add_argument('--baseline', default=None,
                    help=f'baseline path (default: {DEFAULT_BASELINE})')
    ap.add_argument('--no-baseline', action='store_true',
                    help='ignore the committed baseline')
    ap.add_argument('--write-baseline', action='store_true',
                    help='grandfather every current finding into the '
                         'baseline file (then justify each entry)')
    ap.add_argument('--rules', default=None,
                    help='comma-separated rule ids to run')
    ap.add_argument('--knob-table', action='store_true',
                    help='print the generated KTPU_* README table')
    ap.add_argument('--span-table', action='store_true',
                    help='print the generated README span table')
    ap.add_argument('--debug-table', action='store_true',
                    help='print the generated README debug-endpoint '
                         'table (profiling-server route registry)')
    ap.add_argument('--list-rules', action='store_true')
    ap.add_argument('--graph-dump', default=None, metavar='FN',
                    help='debug: print the resolved callees and taint '
                         'facts for one function (bare name, '
                         'Class.method, or module:qualname); '
                         'honors --json')
    args = ap.parse_args(argv)

    if args.knob_table:
        print(render_knob_table())
        return 0
    if args.span_table:
        from .catalog_pass import render_span_table
        print(render_span_table())
        return 0
    if args.debug_table:
        from ..observability.profiling import render_debug_table
        print(render_debug_table())
        return 0
    if args.list_rules:
        for rid in sorted(RULES):
            print(f'{rid}  {RULES[rid].summary}')
        return 0

    paths = args.paths or [p for p in DEFAULT_SOURCE_PATHS
                           if os.path.exists(os.path.join(REPO_ROOT, p))]
    baseline = None if args.no_baseline else \
        (args.baseline or DEFAULT_BASELINE)
    rules = [r.strip() for r in args.rules.split(',')] \
        if args.rules else None
    analyzer = Analyzer(paths, REPO_ROOT, baseline_path=baseline,
                        rules=rules)

    if args.graph_dump:
        from .jitgraph import jit_graph
        graph = jit_graph(analyzer.ctx)
        matches = graph.function_by_name(args.graph_dump)
        if not matches:
            print(f'no function matches {args.graph_dump!r}',
                  file=sys.stderr)
            return 2
        _print_graph_dump([graph.graph_dump(mi, fn) for mi, fn in matches],
                          args.as_json)
        return 0

    report = analyzer.run()

    if args.write_baseline:
        target = baseline or DEFAULT_BASELINE
        # regenerate from every kept finding — new AND already
        # grandfathered — and carry existing justifications over by key
        prior = {(e.get('rule'), e.get('path'), e.get('match')):
                 str(e.get('reason', ''))
                 for e in load_baseline(target)}
        write_baseline(target, report.active + report.baselined)
        with open(target, encoding='utf-8') as fh:
            doc = json.load(fh)
        for e in doc['entries']:
            r = prior.get((e['rule'], e['path'], e['match']), '')
            if r and not r.startswith('TODO'):
                e['reason'] = r
        with open(target, 'w', encoding='utf-8') as fh:
            json.dump(doc, fh, indent=2)
            fh.write('\n')
        print(f'wrote {len(doc["entries"])} entries to {target} — '
              f'justify each "reason" before committing')
        return 0

    if args.as_json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        for f in report.active:
            print(f.render())
        for e in report.stale_baseline:
            print(f'stale baseline entry: {e.get("rule")} '
                  f'{e.get("path")} ({e.get("match")!r}) no longer '
                  f'matches — remove it')
        for e in report.errors:
            print(e, file=sys.stderr)
        print(f'{len(report.active)} finding(s), '
              f'{len(report.baselined)} baselined, '
              f'{len(report.suppressed)} suppressed, '
              f'{len(report.stale_baseline)} stale baseline '
              f'entr(y/ies) over {len(analyzer.files)} files / '
              f'{len(RULES)} rules')

    if report.active or report.errors:
        return 1
    if args.strict and report.stale_baseline:
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
