"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed one step below the
precision the configuration states (float32 for its float64 numbers),
and judged by the same comparison a run uses.  It has to come out as
not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--precision float32]

It judges the rows of every Pod of a pass, more than any window yields,
with the comparison a run uses (``reference.rows_wrong``), and prints
one JSON line per seed: the number compared and the number judged
wrong.  ``--precision float64`` puts the reference itself in the program's place
(it has to read 0).  No chip is needed; the benchmark's own runs do not
run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import gen, reference  # noqa: E402


def _load(name: str, root: str = ROOT):
    """``(BENCHMARK.json, configuration, traffic)`` of the cell ``name``."""
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    cell = next(w for w in bench['workloads'] if w['name'] == name)
    return (bench,) + load_parts(cell['config'], cell['traffic'], root)


def load_parts(config: str, traffic: str, root: str = ROOT):
    """``(configuration, traffic)`` read from their files by name."""
    with open(os.path.join(root, 'portbench', 'configs',
                           config + '.json')) as f:
        cfg = json.load(f)
    with open(os.path.join(root, 'portbench', 'traffic',
                           traffic + '.json')) as f:
        mix = json.load(f)
    return cfg, mix


def scan_wrong(cfg, traffic, seed: int, precision: str) -> dict:
    """The control of a scan cell: the reference computed in
    ``precision`` yields every Pod of a pass, more than any window
    yields, and the run's own comparison (``reference.rows_wrong``)
    judges it."""
    from portbench.drivers.scan import REPORT_TS
    rules = reference.pack_rules(cfg['packs'])
    pods = gen.scan_pods(cfg['pod_generator'], traffic['pods'], seed)
    yielded = reference.Yielded()
    for i, pod in enumerate(pods):
        yielded.add(i, *reference.report_rows(rules, pod, REPORT_TS,
                                              precision))
    return {'compared': len(yielded),
            'wrong': reference.rows_wrong(rules, pods, yielded, REPORT_TS,
                                          show=0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--precision', default='float32')
    args = p.parse_args(argv)
    _bench, cfg, traffic = _load(args.workload)
    for seed in (int(s) for s in args.seeds.split(',')):
        out = scan_wrong(cfg, traffic, seed, args.precision)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'precision': args.precision, **out}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
