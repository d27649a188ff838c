"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name:
``BENCHMARK.json`` names the cell's configuration and traffic,
``portbench/configs/<config>.json`` holds the configuration (its policy
packs, its Pod generator, its guarantees), ``portbench/traffic/<mix>.json``
the traffic's parameters, whose ``driver`` names the general driver
that reads them (``portbench/drivers/<driver>.py``), and each per-layer
metric is read by ``portbench/metrics/<metric>.py``.  A later cell, mix
or metric is added as files and entries; nothing here changes.

The run sets up the system under test on ``cuda:0``, measures for
``--seconds`` seconds, checks what the timed path produced against the
plain reference (``portbench/reference.py``), and prints the result as
the last line of standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.

``--device cpu`` runs the same on the CPU (tests only: it reports no
device metric a run on the card would).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: modules that may not be loaded in the process that prints a result
#: (top-level names, compared whole)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'kyverno_tpu')
#: every build and kernel cache of the program, at fixed paths in the
#: checkout: only the first run in a checkout builds
CACHES = {'KTPU_COMPILE_CACHE': os.path.join(HERE, '.build', 'kernels'),
          'KTPU_AOT_CACHE_DIR': os.path.join(HERE, '.build', 'aot'),
          'KTPU_VERDICT_CACHE_DIR': os.path.join(HERE, '.build', 'verdicts'),
          'TORCH_EXTENSIONS_DIR': os.path.join(HERE, '.build', 'torch'),
          'TRITON_CACHE_DIR': os.path.join(HERE, '.build', 'triton')}


class Harness:
    """What a driver gets: the cell, its configuration and traffic, the
    run's arguments, and helpers that load the configuration's policies
    and reference."""

    def __init__(self, bench: dict, cell: dict, args):
        self.bench = bench
        self.cell = cell
        self.args = args
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.t_process = T_PROCESS
        with open(os.path.join(HERE, 'configs',
                               cell['config'] + '.json')) as f:
            self.config = json.load(f)
        with open(os.path.join(HERE, 'traffic',
                               cell['traffic'] + '.json')) as f:
            self.traffic = json.load(f)
        self.device = None

    def policies(self, action: str):
        """The configuration's policies, each in ``action``."""
        import yaml
        from kyverno_tpu_torch.api.policy import Policy
        docs = []
        for pack in self.config['packs']:
            with open(os.path.join(HERE, 'packs', pack + '.yaml')) as f:
                docs += [d for d in yaml.safe_load_all(f) if d]
        for d in docs:
            d['spec']['validationFailureAction'] = action
        return [Policy(d) for d in docs]

    def reference_rules(self):
        from portbench import reference
        return reference.pack_rules(self.config['packs'])


def _find(items, name, what):
    for item in items:
        if item['name'] == name:
            return item
    raise SystemExit(f'portbench: no {what} {name!r} in BENCHMARK.json')


def _metric_applies(metric: dict, cell: dict, e2e_names) -> bool:
    if 'workloads' in metric:
        return cell['name'] in metric['workloads']
    return metric.get('moves', metric['name']) in e2e_names


def _reader(name: str):
    path = os.path.join(HERE, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + name.replace('.', '_').replace('-', '_'),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _device_info(h, obs) -> dict:
    if h.device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    import torch
    out = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
           'count': h.cell['chips'],
           'memory_peak_bytes': obs['memory_peak_bytes']}
    if h.trace:
        out['busy_s'] = obs['device']['busy_s']
        out['window_s'] = obs['device']['window_s']
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = p.parse_args(argv)

    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    cell = _find(bench['workloads'], args.workload, 'workload')
    h = Harness(bench, cell, args)
    for key, path in CACHES.items():
        os.makedirs(path, exist_ok=True)
        os.environ[key] = path
    os.environ.setdefault('PYTORCH_NVML_BASED_CUDA_CHECK', '1')

    import torch
    if args.device == 'cuda':
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell['chips']:
            print(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
                  f"device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        h.device = torch.device('cuda:0')
    else:
        h.device = torch.device('cpu')

    spec = importlib.util.spec_from_file_location(
        'portbench_driver', os.path.join(HERE, 'drivers',
                                         h.traffic['driver'] + '.py'))
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    obs = driver.run(h)

    loaded = sorted({m.split('.')[0] for m in sys.modules} &
                    set(FORBIDDEN))
    if loaded:
        print(f'portbench: the run loaded {loaded}', file=sys.stderr)
        return 3
    if h.trace and h.device.type == 'cuda' and not obs['device']:
        print('portbench: the profiler saw no device activity in the '
              'traced window; no result', file=sys.stderr)
        return 4

    e2e = [m for m in bench['end_to_end']
           if 'workloads' not in m or cell['name'] in m['workloads']]
    metrics = {}
    if not h.trace:
        for m in e2e:
            metrics[m['name']] = {'value': obs['end_to_end'][m['name']],
                                  'unit': m['unit']}
    else:
        names = {m['name'] for m in e2e}
        for m in bench['per_layer']:
            if not _metric_applies(m, cell, names):
                continue
            value = _reader(m['name'])(obs)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {'correct': obs['correct'], 'attempted': obs['attempted'],
              'failed': obs['failed'], 'metrics': metrics,
              'device': _device_info(h, obs)}
    if h.trace and h.device.type == 'cuda':
        result['breakdown'] = {
            'device_ops': [[n, s] for n, s in obs['device']['device_ops']],
            'idle_gaps': obs['device']['idle_gaps']}
    for key, value in obs.get('notes', {}).items():
        print(f'portbench: {key} {json.dumps(value)}', file=sys.stderr)
    result['checks'] = obs['checks']
    for name, c in obs['checks'].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
