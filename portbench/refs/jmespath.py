"""Plain reference of ``packs/jmespath.yaml``: seven precondition and
``deny`` policies, each written out in Python from its JMESPath.  A
precondition that is not met skips the rule; a deny that holds fails it
with the rule's message; otherwise it passes.

``resource-budget`` compares a parsed number with the cap of 16.  The
configuration states float64 for it, as Kyverno parses numbers;
``ctx.precision = 'float32'`` computes it one step lower (the control)."""

from __future__ import annotations

import numpy as np

SKIP = ('skip', 'preconditions not met')


def _deny(rule: str, message: str, denied: bool):
    if denied:
        return 'fail', message
    return 'pass', f"validation rule '{rule}' passed."


def _containers(pod):
    return pod['spec'].get('containers') or []


def limit_containers(ctx):
    if (ctx.pod['metadata'].get('labels') or {}).get('tier') \
            not in ('web', 'api'):
        return SKIP
    return _deny('max-3-containers', 'tiered pods are limited to 3 '
                 'containers', len(_containers(ctx.pod)) > 3)


def require_tagged_images(ctx):
    images = [c.get('image', '') for c in _containers(ctx.pod)]
    return _deny('no-latest-or-untagged', 'images must carry a non-latest '
                 'tag', any(':latest' in i or ':' not in i for i in images))


def require_probes(ctx):
    if not (ctx.pod['metadata'].get('labels') or {}).get('app'):
        return SKIP
    return _deny('liveness-required', 'app pods need liveness probes on '
                 'every container',
                 any(c.get('livenessProbe') is None
                     for c in _containers(ctx.pod)))


def digest_pin_prod(ctx):
    if (ctx.pod['metadata'].get('labels') or {}).get('env') != 'prod':
        return SKIP
    return _deny('prod-pins-digests', 'prod images must be pinned by '
                 'digest', any('@sha256:' not in c.get('image', '')
                               for c in _containers(ctx.pod)))


def hostpath_quarantine(ctx):
    if ctx.pod['metadata'].get('namespace') == 'kube-system':
        return SKIP
    volumes = ctx.pod['spec'].get('volumes') or []
    return _deny('no-hostpath-outside-system', 'hostPath volumes are '
                 'quarantined to kube-system',
                 any(v.get('hostPath') for v in volumes))


def sysctl_allowlist(ctx):
    sysctls = (ctx.pod['spec'].get('securityContext') or {}) \
        .get('sysctls') or []
    return _deny('net-sysctls-only', 'only net.* sysctls are allowed',
                 any(not s.get('name', '').startswith('net.')
                     for s in sysctls))


def resource_budget(ctx):
    value = (ctx.pod['metadata'].get('annotations') or {}) \
        .get('budget.io/max-cpu') or '0'
    if value == '0':
        return SKIP
    if ctx.precision == 'float32':
        over = np.float32(float(value)) > np.float32(16)
    else:
        over = float(value) > 16
    return _deny('cpu-annotation-budget', 'declared cpu budget exceeds the '
                 'cluster cap of 16', bool(over))


RULES = [
    ('limit-containers', 'max-3-containers', ('Pod',), limit_containers),
    ('require-tagged-images', 'no-latest-or-untagged', ('Pod',),
     require_tagged_images),
    ('require-probes', 'liveness-required', ('Pod',), require_probes),
    ('digest-pin-prod', 'prod-pins-digests', ('Pod',), digest_pin_prod),
    ('hostpath-quarantine', 'no-hostpath-outside-system', ('Pod',),
     hostpath_quarantine),
    ('sysctl-allowlist', 'net-sysctls-only', ('Pod',), sysctl_allowlist),
    ('resource-budget', 'cpu-annotation-budget', ('Pod',), resource_budget),
]
