"""The smoke pack: the policy set and Pod generator that drive the
port's main path on the card (``chip_smoke.py``) and its CPU tests.

* ``BEST_PRACTICE_PACK``: upstream Kyverno's ``disallow-latest-tag``
  (kyverno/policies best-practices/disallow-latest-tag: ``image: "*:*"``
  requires a tag, ``image: "!*:latest"`` forbids ``latest``) and
  ``require-resources``.  The ``*:*`` rule is the one whose glob
  reaches the wildcard DP kernel (K1c).
* ``JMESPATH_PACK``: seven JMESPath-heavy precondition/deny policies.
* ``PSS_PACK``: Pod Security Standards baseline and restricted.

Twelve policies; on the evaluator they compile to 13 device programs
and no host rules.  ``make_pod`` / ``make_config4_pod`` generate Pods
with a realistic violation mix from a ``random.Random``.

* ``MUTATE_PACK`` and ``make_mutate_pod``: the JAX package's mutate
  pack and its Pod generator (``bench.py`` ``MUTATE_PACK`` /
  ``make_mutate_pod``), copied here since the port cannot import
  ``bench.py``.  Three policies that all lower to device edit sites; about
  10 % of the generated Pods take the per-row FALLBACK path (a json6902
  replace on a missing annotation).
"""

from __future__ import annotations

from typing import List

BEST_PRACTICE_PACK = """
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: disallow-latest-tag
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: require-image-tag-any
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: "An image tag is required."
        pattern:
          spec:
            containers:
              - image: "*:*"
    - name: require-image-tag
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: "An image tag is required."
        pattern:
          spec:
            containers:
              - image: "!*:latest"
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: require-resources
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: validate-resources
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: "resource requests and limits required"
        pattern:
          spec:
            containers:
              - resources:
                  requests:
                    memory: "?*"
                    cpu: "?*"
"""

JMESPATH_PACK = """
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: limit-containers
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: max-3-containers
      match: {any: [{resources: {kinds: [Pod]}}]}
      preconditions:
        all:
          - key: "{{ request.object.metadata.labels.tier || 'none' }}"
            operator: AnyIn
            value: [web, api]
      validate:
        message: "tiered pods are limited to 3 containers"
        deny:
          conditions:
            any:
              - key: "{{ length(request.object.spec.containers) }}"
                operator: GreaterThan
                value: 3
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: require-tagged-images
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: no-latest-or-untagged
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: "images must carry a non-latest tag"
        deny:
          conditions:
            any:
              - key: "{{ length(request.object.spec.containers[?contains(image, ':latest')]) }}"
                operator: GreaterThan
                value: 0
              - key: "{{ length(request.object.spec.containers[?!contains(image, ':')]) }}"
                operator: GreaterThan
                value: 0
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: require-probes
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: liveness-required
      match: {any: [{resources: {kinds: [Pod]}}]}
      preconditions:
        all:
          - key: "{{ request.object.metadata.labels.app || '' }}"
            operator: NotEquals
            value: ""
      validate:
        message: "app pods need liveness probes on every container"
        deny:
          conditions:
            any:
              - key: "{{ length(request.object.spec.containers[?livenessProbe == null]) }}"
                operator: GreaterThan
                value: 0
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: digest-pin-prod
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: prod-pins-digests
      match: {any: [{resources: {kinds: [Pod]}}]}
      preconditions:
        all:
          - key: "{{ request.object.metadata.labels.env || '' }}"
            operator: Equals
            value: prod
      validate:
        message: "prod images must be pinned by digest"
        deny:
          conditions:
            any:
              - key: "{{ length(request.object.spec.containers[?!contains(image, '@sha256:')]) }}"
                operator: GreaterThan
                value: 0
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: hostpath-quarantine
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: no-hostpath-outside-system
      match: {any: [{resources: {kinds: [Pod]}}]}
      preconditions:
        all:
          - key: "{{ request.object.metadata.namespace }}"
            operator: AnyNotIn
            value: [kube-system]
      validate:
        message: "hostPath volumes are quarantined to kube-system"
        deny:
          conditions:
            any:
              - key: "{{ length(request.object.spec.volumes[?hostPath] || `[]`) }}"
                operator: GreaterThan
                value: 0
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: sysctl-allowlist
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: net-sysctls-only
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        message: "only net.* sysctls are allowed"
        deny:
          conditions:
            any:
              - key: "{{ length(request.object.spec.securityContext.sysctls[?!starts_with(name, 'net.')] || `[]`) }}"
                operator: GreaterThan
                value: 0
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: resource-budget
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: cpu-annotation-budget
      match: {any: [{resources: {kinds: [Pod]}}]}
      preconditions:
        all:
          - key: "{{ request.object.metadata.annotations.\\"budget.io/max-cpu\\" || '0' }}"
            operator: NotEquals
            value: '0'
      validate:
        message: "declared cpu budget exceeds the cluster cap of 16"
        deny:
          conditions:
            any:
              - key: "{{ to_number(request.object.metadata.annotations.\\"budget.io/max-cpu\\") }}"
                operator: GreaterThan
                value: 16
"""

PSS_PACK = """
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: pss-baseline
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: baseline
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        podSecurity:
          level: baseline
          version: latest
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: pss-restricted
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: restricted
      match: {any: [{resources: {kinds: [Pod]}}]}
      validate:
        podSecurity:
          level: restricted
          version: latest
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: pss-deployments
spec:
  rules:
    - name: restricted-deploy
      match: {any: [{resources: {kinds: [Deployment]}}]}
      validate:
        podSecurity:
          level: restricted
          version: latest
"""

SMOKE_PACK = '\n---\n'.join([BEST_PRACTICE_PACK, JMESPATH_PACK, PSS_PACK])


def load_smoke_pack(action: str = '') -> List:
    """The twelve smoke-pack policies; ``action`` (``Enforce``/``Audit``)
    sets every policy's ``validationFailureAction`` (default: Audit, as
    the pack leaves it unset)."""
    import yaml
    from .api.policy import Policy, load_policies_from_yaml
    if not action:
        return load_policies_from_yaml(SMOKE_PACK)
    docs = [d for d in yaml.safe_load_all(SMOKE_PACK) if d]
    for d in docs:
        d['spec']['validationFailureAction'] = action
    return [Policy(d) for d in docs]


# the JAX package's mutate pack (bench.py MUTATE_PACK), verbatim
MUTATE_PACK = """
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: add-default-labels
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: add-team
      match: {any: [{resources: {kinds: [Pod]}}]}
      mutate:
        patchStrategicMerge:
          metadata:
            labels:
              "+(team)": platform
              "+(cost-center)": eng-42
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: set-dns-policy
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: dns
      match: {any: [{resources: {kinds: [Pod]}}]}
      mutate:
        patchStrategicMerge:
          spec:
            dnsPolicy: ClusterFirst
            "+(enableServiceLinks)": false
---
apiVersion: kyverno.io/v1
kind: ClusterPolicy
metadata:
  name: stamp-annotations
  annotations: {pod-policies.kyverno.io/autogen-controllers: none}
spec:
  rules:
    - name: stamp
      match: {any: [{resources: {kinds: [Pod]}}]}
      mutate:
        patchesJson6902: |-
          - op: add
            path: /metadata/annotations/managed-by
            value: kyverno-tpu
          - op: replace
            path: /metadata/annotations/tier
            value: gold
"""


def load_mutate_pack() -> List:
    """The three mutate-pack policies."""
    from .api.policy import load_policies_from_yaml
    return load_policies_from_yaml(MUTATE_PACK)


_IMAGES = ['nginx:1.25.3', 'nginx:latest', 'ghcr.io/org/app:v2.1',
           'redis:7', 'docker.io/library/busybox', 'gcr.io/proj/svc:prod',
           'app', 'registry.internal:5000/team/api:canary']
_CAPS = ['NET_ADMIN', 'SYS_TIME', 'CHOWN', 'KILL', 'AUDIT_WRITE', 'ALL']


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
            'budget.io/max-cpu': str(rng.choice([2, 8, 24]))}
    if rng.random() < 0.4:
        for cont in pod['spec']['containers']:
            if rng.random() < 0.7:
                cont['livenessProbe'] = {
                    'httpGet': {'path': '/healthz', 'port': 8080}}
    if rng.random() < 0.1:
        pod['spec']['containers'][0]['image'] = \
            'gcr.io/proj/svc@sha256:' + '0' * 64
    return pod


def make_mutate_pod(rng, i: int) -> dict:
    """Pods for the mutate pack (bench.py ``make_mutate_pod``): ~90%
    carry the ``tier`` annotation the json6902 replace needs (the rest
    FALLBACK per row, attributed ``replace_path_missing``), half already
    carry a ``team`` label (the add-only anchor skips), and dnsPolicy
    varies so the strategic merge sometimes edits, sometimes SKIPs."""
    meta = {'name': f'pod-{i}', 'namespace': f'ns-{i % 7}'}
    annotations = {'owner': f'team-{i % 5}'}
    if rng.random() < 0.9:
        annotations['tier'] = rng.choice(['bronze', 'silver', 'gold'])
    meta['annotations'] = annotations
    if rng.random() < 0.5:
        meta['labels'] = {'team': rng.choice(['red', 'blue'])}
    spec = {'containers': [{'name': 'c', 'image': 'nginx:1.25.3'}]}
    if rng.random() < 0.5:
        spec['dnsPolicy'] = 'Default'
    return {'apiVersion': 'v1', 'kind': 'Pod', 'metadata': meta,
            'spec': spec}


def host_mutate_chain(policies, resource: dict, engine=None):
    """``(steps, patched)`` of one resource from the host ``Engine``
    alone: the admission handler's cumulative mutate loop (policy k + 1
    sees policy k's output; the chain stops after the first unsuccessful
    policy) — the oracle ``MutateScanner.scan`` rows are held against."""
    import json
    from .engine.api import PolicyContext
    from .engine.engine import Engine
    engine = engine or Engine()
    pctx = PolicyContext(None, new_resource=json.loads(json.dumps(resource)))
    steps = []
    for policy in policies:
        ctx = pctx.copy()
        ctx.policy = policy
        er = engine.mutate(ctx)
        steps.append((policy, er))
        if not er.is_successful():
            break
        pctx = pctx.copy()
        pctx.new_resource = er.patched_resource or pctx.new_resource
        pctx.json_context.add_resource(pctx.new_resource)
    return steps, pctx.new_resource


def mutate_row_key(steps, patched) -> str:
    """Canonical JSON of one mutate row: per policy its name and rule
    cells (name, status, message, patches), then the patched document."""
    import json
    cells = [[policy.name, [[r.name, str(r.status), r.message, r.patches]
                            for r in er.policy_response.rules]]
             for policy, er in steps]
    return json.dumps([cells, patched], sort_keys=True, default=str)


def host_report_results(policies, resource: dict, now: int, engine=None):
    """``(results, summary)`` of one resource from the host ``Engine``
    alone: every policy's background-scan response, turned into sorted
    PolicyReport results — the oracle ``scan_report_results`` rows are
    held against."""
    from .engine.api import PolicyContext
    from .engine.engine import Engine
    from .reports.results import (calculate_summary,
                                  engine_response_to_report_results,
                                  sort_report_results)
    engine = engine or Engine()
    results: List[dict] = []
    for policy in policies:
        resp = engine.apply_background_checks(
            PolicyContext(policy, new_resource=resource))
        if resp.policy_response.rules:
            results.extend(engine_response_to_report_results(resp, now=now))
    sort_report_results(results)
    return results, calculate_summary(results)
