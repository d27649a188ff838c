"""The port lint (``python -m kyverno_tpu_torch.analysis``): the port's
tree is clean under ``--strict`` with a justified, minimal baseline;
the host-sync rules (KTPU101-103) fire on a bad fixture at a declared
device stage and not on its good twin; the reference's fixtures for
the rules the port keeps (KTPU204/205, 3xx-6xx) hold against the
port's analyzer; and a ``.item()`` planted in a copy of the
evaluator's stage is a KTPU101 finding.  Fixtures live under
``tmp_path``."""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

import test_analysis as reference
from kyverno_tpu_torch import analysis
from kyverno_tpu_torch.analysis import Analyzer, RULES, write_baseline
from kyverno_tpu_torch.analysis import jitgraph
from kyverno_tpu_torch.analysis.core import DEFAULT_BASELINE
from kyverno_tpu_torch.analysis.knobs import KNOBS
from kyverno_tpu_torch.observability.catalog import METRICS
from kyverno_tpu_torch.observability.coverage import REASONS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = 'kyverno_tpu_torch/ops/kernels.py'   # declared stages live here


def run(tmp_path, sources, rules=None, baseline=None):
    """Write {relpath: source} under tmp_path and analyze it."""
    for rel, src in sources.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return Analyzer([str(tmp_path)], str(tmp_path), baseline_path=baseline,
                    rules=rules).run()


def rule_ids(report):
    return {f.rule_id for f in report.active}


def _lint(*args):
    return subprocess.run([sys.executable, '-m', 'kyverno_tpu_torch.analysis',
                           *args], capture_output=True, text=True, cwd=ROOT,
                          timeout=300)


# -- the port's own tree -----------------------------------------------------

def test_port_tree_is_clean_in_strict_mode():
    proc = _lint('--strict', '--json')
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(proc.stdout)
    assert report['counts']['active'] == 0, report['active']
    assert report['counts']['stale_baseline'] == 0, report['stale_baseline']
    assert not report['errors'], report['errors']
    files = {f['path'] for f in report['suppressed'] + report['baselined']}
    assert 'chip_smoke.py' in files


def test_baseline_lives_in_the_package_and_is_justified():
    assert DEFAULT_BASELINE == os.path.join(
        ROOT, 'kyverno_tpu_torch', 'analysis', 'baseline.json')
    with open(DEFAULT_BASELINE, encoding='utf-8') as f:
        entries = json.load(f)['entries']
    for e in entries:
        reason = str(e.get('reason', '')).strip()
        assert reason and not reason.startswith('TODO'), e
    report = Analyzer(['kyverno_tpu_torch', 'chip_smoke.py', 'k1v_bench.py'],
                      ROOT, baseline_path=DEFAULT_BASELINE).run()
    assert not report.stale_baseline and not report.active
    assert len(report.baselined) >= len(entries)


def test_driver_lists_rules_and_knobs():
    rules = _lint('--list-rules')
    assert rules.returncode == 0
    listed = dict(line.split('  ', 1) for line in rules.stdout.splitlines())
    assert set(listed) == set(reference.RULES)
    for rid in ('KTPU201', 'KTPU202', 'KTPU203'):
        assert listed[rid].startswith('not applicable to the port:'), rid
    knobs = _lint('--knob-table')
    assert knobs.returncode == 0
    for name in KNOBS:
        assert f'`{name}`' in knobs.stdout


def test_device_stages_exist_in_the_port():
    """Every declared stage names a def of the port, and each tensor
    name is one the def binds."""
    ctx = Analyzer(['kyverno_tpu_torch'], ROOT).ctx
    graph = jitgraph.jit_graph(ctx)
    found = {(mi.sf.rel, mi.func_info[fn].qualname.split(':', 1)[1])
             for mi, fn, _site in graph.entries}
    declared = {(st.path, st.qualname) for st in jitgraph.DEVICE_STAGES}
    assert found == declared
    for mi, fn, st in graph.entries:
        assert graph.entry_tainted_params(mi, fn, st) == set(st.tensors)
    reached = {mi.sf.rel for mi, fn in
               ((m, f) for _sf, m, f in graph.reachable_functions())}
    assert {'kyverno_tpu_torch/ops/eval.py', KERNELS,
            'kyverno_tpu_torch/mutate/kernel.py',
            'kyverno_tpu_torch/parallel/mesh.py'} <= reached


# -- KTPU1xx: host syncs inside a device stage -------------------------------

_HOST_SYNC = {
    # rule: (bad body, good twin) of status_vm(packed, program)
    'KTPU101-item': ('KTPU101', "n = packed['a'].sum().item()",
                     "n = packed['a'].shape[0]"),
    'KTPU101-tolist': ('KTPU101', "n = packed['a'].tolist()",
                       "n = [1, 2].copy()"),
    'KTPU101-cpu': ('KTPU101', "n = packed['a'].cpu()",
                    "n = packed['a'].to(torch.int8)"),
    'KTPU101-numpy': ('KTPU101', "n = packed['a'].numpy()",
                      "n = packed['a'].data_ptr()"),
    'KTPU101-synchronize': ('KTPU101', 'torch.cuda.synchronize()',
                            'n = torch.cuda.current_device()'),
    'KTPU101-asarray': ('KTPU101', "n = np.asarray(packed['a'])",
                        'n = np.asarray([1, 2])'),
    'KTPU102-int': ('KTPU102', "n = int(packed['a'].sum())",
                    "n = int(packed['a'].shape[0])"),
    'KTPU102-local': ('KTPU102', 'n = float(torch.zeros(2).max())',
                      'n = float(len(packed))'),
    'KTPU103-if': ('KTPU103', "if packed['a'].any():\n        n = 1",
                   "if packed['a'].numel() == 0:\n        n = 1"),
    'KTPU103-while': ('KTPU103', "while torch.ones(1).sum():\n        n = 1",
                      "while packed.get('a') is None:\n        n = 1"),
}


def _stage_src(body):
    return ('import numpy as np\nimport torch\n\n\n'
            'def status_vm(packed, program):\n'
            f'    n = 0\n    {body}\n    return n\n')


@pytest.mark.parametrize('case', sorted(_HOST_SYNC))
def test_host_sync_rule_fires_on_bad_and_not_on_good(tmp_path, case):
    rule, bad, good = _HOST_SYNC[case]
    rep = run(tmp_path / 'bad', {KERNELS: _stage_src(bad)},
              rules=[rule])
    assert rule_ids(rep) == {rule}, [f.render() for f in rep.active]
    rep = run(tmp_path / 'good', {KERNELS: _stage_src(good)},
              rules=['KTPU101', 'KTPU102', 'KTPU103'])
    assert not rep.active, [f.render() for f in rep.active]


def test_host_sync_outside_a_stage_is_not_flagged(tmp_path):
    rep = run(tmp_path, {KERNELS: _stage_src(
        "n = packed['a'].sum().item()").replace('def status_vm',
                                                 'def not_a_stage')},
        rules=['KTPU101', 'KTPU102', 'KTPU103'])
    assert not rep.active
    rep = run(tmp_path, {'kyverno_tpu_torch/other.py': _stage_src(
        "n = packed['a'].sum().item()")}, rules=['KTPU101'])
    assert not rep.active


def test_host_sync_through_a_helper_carries_the_chain(tmp_path):
    rep = run(tmp_path, {KERNELS: """\
    import torch


    def _count(t):
        if t.any():
            return 1
        return 0


    def status_vm(packed, program):
        return _count(packed['a'])
    """}, rules=['KTPU103'])
    [f] = rep.active
    assert f.rule_id == 'KTPU103' and 'status_vm' in f.message
    assert '_count' in f.message


def test_cpu_guard_keeps_the_plain_version_out_of_the_stage(tmp_path):
    """``if _on_cpu(...)``: the kernel's plain version on CPU tensors,
    whose host reads wait for no card."""
    src = """\
    import torch


    def _on_cpu(t):
        return t.device.type == 'cpu'


    def _plain(t):
        return int(t.sum().item())


    def status_vm(packed, program):
        t = packed['a']
        if _on_cpu(t):
            return _plain(t)
        return t.sum()
    """
    rep = run(tmp_path, {KERNELS: src},
              rules=['KTPU101', 'KTPU102', 'KTPU103'])
    assert not rep.active
    # unguarded, the plain version's readback is in the stage (the cast
    # over the read-back value is host data: no second finding)
    rep = run(tmp_path, {KERNELS: src.replace('if _on_cpu(t):',
                                              'if t.dim() > 0:')},
              rules=['KTPU101', 'KTPU102'])
    assert [f.rule_id for f in rep.active] == ['KTPU101']


def test_annotated_tuple_unpack_taints_only_the_tensor(tmp_path):
    """``match: Lane`` (``Tuple[torch.Tensor, int]``): the column is
    host data, the buffer a tensor."""
    src = """\
    from typing import Optional, Tuple

    import torch

    Lane = Tuple[torch.Tensor, int]


    def fdet_select(s_u, d_u, adm, fdet_u, match: Optional[Lane],
                    rowvalid, src, k):
        buf, col = match
        if col > 0:
            return s_u
        return d_u
    """
    rep = run(tmp_path, {KERNELS: src}, rules=['KTPU103'])
    assert not rep.active
    rep = run(tmp_path, {KERNELS: src.replace('if col > 0:',
                                              'if buf.any():')},
              rules=['KTPU103'])
    assert rule_ids(rep) == {'KTPU103'}


def test_stage_readback_noqa_with_reason(tmp_path):
    src = _stage_src("n = packed['a'].cpu()  "
                     "# ktpu: noqa[KTPU101] -- the stage's one readback")
    rules = ['KTPU001', 'KTPU002', 'KTPU101']
    rep = run(tmp_path, {KERNELS: src}, rules=rules)
    assert not rep.active and len(rep.suppressed) == 1
    rep = run(tmp_path, {KERNELS: _stage_src(
        "n = packed['a'].cpu()  # ktpu: noqa[KTPU101]")}, rules=rules)
    assert rule_ids(rep) == {'KTPU001'}


def test_item_planted_in_the_evaluator_stage_is_caught(tmp_path):
    """A copy of ``ops/eval.py`` is clean of KTPU101; the same copy with
    one ``.item()`` inside ``evaluate_packed`` is a KTPU101 finding at
    that line."""
    src = open(os.path.join(ROOT, 'kyverno_tpu_torch', 'ops', 'eval.py'),
               encoding='utf-8').read()
    anchor = '        s_u, d_u, fdet_u, adm = evaluate_unique(packed, plan)\n'
    assert src.count(anchor) == 1
    rel = 'kyverno_tpu_torch/ops/eval.py'
    rep = run(tmp_path / 'clean', {rel: src}, rules=['KTPU101'])
    assert not rep.active
    planted = src.replace(anchor, anchor +
                          '        n_fail = s_u.sum().item()\n')
    rep = run(tmp_path / 'planted', {rel: planted}, rules=['KTPU101'])
    line = planted.split('\n').index('        n_fail = s_u.sum().item()') + 1
    assert [(f.rule_id, f.line) for f in rep.active] == [('KTPU101', line)]
    assert 'evaluate_packed' in rep.active[0].message


def test_jit_cache_rules_do_not_apply(tmp_path):
    """KTPU201-203 are registered with nothing to find: the port has no
    ``jax.jit``, so the reference's positive fixtures are silent."""
    rep = run(tmp_path, {'a.py': """\
    import jax

    TABLE = {}


    def f(x, opts=[]):
        if x.shape[0] > 1:
            return TABLE.get(x)
        return x

    g = jax.jit(f, static_argnums=(1,))
    """}, rules=['KTPU201', 'KTPU202', 'KTPU203'])
    assert not rep.active


# -- the reference's fixtures for the rules the port keeps -------------------

KEPT = sorted(n for n in dir(reference)
              if re.match(r'test_ktpu(20[45]|[3-6]\d\d)_', n))


@pytest.mark.parametrize('name', KEPT)
def test_reference_fixture_holds_on_the_port(name, tmp_path, monkeypatch):
    """The reference's positive/negative fixture ``name`` run through
    the port's analyzer (its rule registry, knob registry, metric
    catalog, coverage taxonomy and pipeline stage registry in place of
    the reference's)."""
    from kyverno_tpu.analysis import catalog_pass as ref_catalog_pass
    from kyverno_tpu_torch.analysis import catalog_pass
    for attr, value in (('Analyzer', Analyzer), ('RULES', RULES),
                        ('write_baseline', write_baseline),
                        ('KNOBS', KNOBS), ('METRICS', METRICS),
                        ('REASONS', REASONS)):
        monkeypatch.setattr(reference, attr, value)
    monkeypatch.setattr(ref_catalog_pass, 'load_stage_registry',
                        catalog_pass.load_stage_registry)
    getattr(reference, name)(tmp_path)


def test_port_keeps_every_rule_id():
    assert set(RULES) == set(reference.RULES)
    assert analysis.RULES is RULES
    for rid, rule in RULES.items():
        assert rule.summary.strip(), rid
