"""The scan's Pods, frozen here so that no change to the program can move
them.

``make_pod`` and ``make_config4_pod`` are copies of the smoke pack's
synthetic Pod generators; no public source gives a cluster's Pod mix, so
the mix is the smoke pack's own, stated here as drawn per Pod:

* 1-3 containers (by index), images from eight references of which one
  is ``:latest`` and two carry no tag;
* per container: requests and a memory limit on 80 %, a security
  context on 50 % (privilege escalation, privileged, capabilities,
  runAsNonRoot), ports on 30 %, a liveness probe on 28 % of them;
* per Pod: hostNetwork 10 %, hostPID 8 %, a volume 15 % (hostPath half
  of them), sysctls 20 %, a ``tier`` label 60 %, an ``env`` label 30 %,
  a digest-pinned first image 10 %, a ``budget.io/max-cpu`` annotation
  25 %.

One change from the smoke pack: the annotation also takes
``16.0000001`` and ``15.9999999``, which float64 tells from the cap of 16
and float32 does not, so that the comparison can tell the two precisions
apart.  The same seed gives the same Pods.
"""

from __future__ import annotations

import random
from typing import List

_IMAGES = ['nginx:1.25.3', 'nginx:latest', 'ghcr.io/org/app:v2.1',
           'redis:7', 'docker.io/library/busybox', 'gcr.io/proj/svc:prod',
           'app', 'registry.internal:5000/team/api:canary']
_CAPS = ['NET_ADMIN', 'SYS_TIME', 'CHOWN', 'KILL', 'AUDIT_WRITE', 'ALL']
#: the values of ``budget.io/max-cpu``; the last two lie within float32's
#: rounding of the cap of 16
BUDGETS = ['2', '8', '24', '16.0000001', '15.9999999']


def make_pod(rng, i: int) -> dict:
    """Synthetic Pod with a realistic violation mix."""
    n_containers = 1 + (i % 3)
    containers = []
    for c in range(n_containers):
        cont = {'name': f'c{c}', 'image': _IMAGES[(i + c) % len(_IMAGES)]}
        if rng.random() < 0.8:
            cont['resources'] = {
                'requests': {'memory': '64Mi', 'cpu': '100m'},
                'limits': {'memory': rng.choice(['128Mi', '2Gi', '8Gi'])},
            }
        if rng.random() < 0.5:
            sc = {}
            if rng.random() < 0.5:
                sc['allowPrivilegeEscalation'] = rng.random() < 0.3
            if rng.random() < 0.3:
                sc['privileged'] = rng.random() < 0.3
            if rng.random() < 0.4:
                sc['capabilities'] = {
                    'add': rng.sample(_CAPS, rng.randint(1, 2)),
                    'drop': rng.choice([['ALL'], [], ['KILL']]),
                }
            if rng.random() < 0.4:
                sc['runAsNonRoot'] = rng.random() < 0.7
            cont['securityContext'] = sc
        if rng.random() < 0.3:
            cont['ports'] = [{'containerPort': rng.choice([80, 8080, 443]),
                              'hostPort': rng.choice([0, 80, 9000])}]
        containers.append(cont)
    spec = {'containers': containers}
    if rng.random() < 0.1:
        spec['hostNetwork'] = True
    if rng.random() < 0.08:
        spec['hostPID'] = True
    if rng.random() < 0.15:
        spec['volumes'] = [{'name': 'v0', 'hostPath': {'path': '/var/run'}}
                           if rng.random() < 0.5 else
                           {'name': 'v0', 'emptyDir': {}}]
    if rng.random() < 0.2:
        spec['securityContext'] = {'sysctls': [
            {'name': rng.choice(['kernel.shm_rmid_forced',
                                 'net.core.rmem_max']),
             'value': '1'}]}
    return {'apiVersion': 'v1', 'kind': 'Pod',
            'metadata': {'name': f'pod-{i}', 'namespace': f'ns-{i % 7}',
                         'labels': {'app': f'app-{i % 11}'}},
            'spec': spec}


def make_config4_pod(rng, i: int) -> dict:
    pod = make_pod(rng, i)
    labels = pod['metadata'].setdefault('labels', {})
    if rng.random() < 0.6:
        labels['tier'] = rng.choice(['web', 'api', 'batch', 'cache'])
    if rng.random() < 0.3:
        labels['env'] = rng.choice(['prod', 'staging'])
    if rng.random() < 0.25:
        pod['metadata']['annotations'] = {
            'budget.io/max-cpu': rng.choice(BUDGETS)}
    if rng.random() < 0.4:
        for cont in pod['spec']['containers']:
            if rng.random() < 0.7:
                cont['livenessProbe'] = {
                    'httpGet': {'path': '/healthz', 'port': 8080}}
    if rng.random() < 0.1:
        pod['spec']['containers'][0]['image'] = \
            'gcr.io/proj/svc@sha256:' + '0' * 64
    return pod


POD_GENERATORS = {'config4': make_config4_pod}


def scan_pods(generator: str, n: int, seed: int) -> List[dict]:
    """The cluster's ``n`` Pods for ``seed``."""
    make = POD_GENERATORS[generator]
    rng = random.Random(seed)
    return [make(rng, i) for i in range(n)]
