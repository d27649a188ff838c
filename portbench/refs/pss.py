"""Plain reference of ``packs/pss.yaml``: Kyverno's ``validate.podSecurity``
at ``latest`` for Pods, written from the Pod Security Standards
(k8s.io/pod-security-admission ``policy.DefaultChecks``) as Kyverno runs
them: every versioned variant of a check runs, and each failing variant
adds its line, so a check with two variants reports twice.
``pss-deployments`` matches Deployments only and gives a Pod no row."""

from __future__ import annotations

from typing import List, Optional, Tuple

_BASELINE_CAPS = {
    'AUDIT_WRITE', 'CHOWN', 'DAC_OVERRIDE', 'FOWNER', 'FSETID', 'KILL',
    'MKNOD', 'NET_BIND_SERVICE', 'SETFCAP', 'SETGID', 'SETPCAP', 'SETUID',
    'SYS_CHROOT'}
_SYSCTLS = {'kernel.shm_rmid_forced', 'net.ipv4.ip_local_port_range',
            'net.ipv4.ip_unprivileged_port_start', 'net.ipv4.tcp_syncookies',
            'net.ipv4.ping_group_range'}
_VOLUMES = {'configMap', 'csi', 'downwardAPI', 'emptyDir', 'ephemeral',
            'persistentVolumeClaim', 'projected', 'secret'}
_SELINUX = {'', 'container_t', 'container_init_t', 'container_kvm_t'}
_RUNTIME = ('RuntimeDefault', 'Localhost')


def _n(word: str, count: int) -> str:
    """``container`` / ``containers`` and the like."""
    if count == 1:
        return word
    return 'use' if word == 'uses' else word + 's'


def _q(names) -> str:
    return ', '.join(f'"{n}"' for n in names)


def _sc(obj: dict) -> dict:
    return obj.get('securityContext') or {}


def _all(spec: dict, ephemeral: bool = True) -> List[dict]:
    out = list(spec.get('containers') or []) + \
        list(spec.get('initContainers') or [])
    if ephemeral:
        out += list(spec.get('ephemeralContainers') or [])
    return out


def _windows(spec: dict) -> bool:
    return (spec.get('os') or {}).get('name') == 'windows'


# Each check returns None when allowed, else (reason, detail).

def host_namespaces(meta, spec):
    on = [f'{k}=true' for k in ('hostNetwork', 'hostPID', 'hostIPC')
          if spec.get(k)]
    return ('host namespaces', ', '.join(on)) if on else None


def privileged(meta, spec):
    bad = [c.get('name', '') for c in _all(spec)
           if _sc(c).get('privileged') is True]
    if not bad:
        return None
    return ('privileged', f'{_n("container", len(bad))} {_q(bad)} must '
            f'not set securityContext.privileged=true')


def caps_baseline(meta, spec):
    bad, caps = [], set()
    for c in _all(spec):
        extra = [a for a in (_sc(c).get('capabilities') or {}).get('add')
                 or [] if a not in _BASELINE_CAPS]
        if extra:
            bad.append(c.get('name', ''))
            caps.update(extra)
    if not bad:
        return None
    return ('non-default capabilities',
            f'{_n("container", len(bad))} {_q(bad)} must not include '
            f'{_q(sorted(caps))} in securityContext.capabilities.add')


def host_path(meta, spec):
    bad = [v.get('name', '') for v in spec.get('volumes') or []
           if 'hostPath' in v]
    if not bad:
        return None
    return ('hostPath volumes', f'{_n("volume", len(bad))} {_q(bad)}')


def host_ports(meta, spec):
    bad, ports = [], set()
    for c in _all(spec):
        hp = [p.get('hostPort') for p in c.get('ports') or []
              if p.get('hostPort')]
        if hp:
            bad.append(c.get('name', ''))
            ports.update(hp)
    if not bad:
        return None
    return ('hostPort', f'{_n("container", len(bad))} {_q(bad)} '
            f'{_n("uses", len(bad))} {_n("hostPort", len(ports))} '
            f'{", ".join(str(p) for p in sorted(ports))}')


def app_armor(meta, spec):
    prefix = 'container.apparmor.security.beta.kubernetes.io/'
    bad = sorted(f'{k}="{v}"' for k, v in
                 (meta.get('annotations') or {}).items()
                 if k.startswith(prefix) and v not in ('runtime/default', '')
                 and not str(v).startswith('localhost/'))
    if not bad:
        return None
    return ('forbidden AppArmor profile',
            f'{_n("annotation", len(bad))} {", ".join(bad)}')


def selinux(meta, spec):
    types, user_role = set(), False
    for sc in [_sc(spec)] + [_sc(c) for c in _all(spec)]:
        opts = sc.get('seLinuxOptions') or {}
        if opts.get('type', '') not in _SELINUX:
            types.add(opts.get('type', ''))
        user_role = user_role or bool(opts.get('user') or opts.get('role'))
    parts = []
    if types:
        parts.append(f'{_n("type", len(types))} {_q(sorted(types))}')
    if user_role:
        parts.append('user or role')
    return ('seLinuxOptions', '; '.join(parts)) if parts else None


def proc_mount(meta, spec):
    bad = {c.get('name', ''): _sc(c)['procMount'] for c in _all(spec)
           if _sc(c).get('procMount') not in (None, '', 'Default')}
    if not bad:
        return None
    return ('procMount', f'{_n("container", len(bad))} {_q(bad)} must not '
            f'set securityContext.procMount to '
            f'{_q(sorted(set(bad.values())))}')


def seccomp_annotations(meta, spec):
    ann = meta.get('annotations') or {}
    pod_key = 'seccomp.security.alpha.kubernetes.io/pod'
    bad = []
    if ann.get(pod_key) == 'unconfined':
        bad.append(f'{pod_key}="unconfined"')
    for c in _all(spec):
        key = 'container.seccomp.security.alpha.kubernetes.io/' + \
            c.get('name', '')
        if ann.get(key) == 'unconfined':
            bad.append(f'{key}="unconfined"')
    if not bad:
        return None
    return ('seccompProfile', f'forbidden {_n("annotation", len(bad))} '
            f'{", ".join(bad)}')


def seccomp_baseline(meta, spec):
    parts = []
    if (_sc(spec).get('seccompProfile') or {}).get('type') == 'Unconfined':
        parts.append('pod must not set securityContext.seccompProfile.type '
                     'to "Unconfined"')
    bad = [c.get('name', '') for c in _all(spec)
           if (_sc(c).get('seccompProfile') or {}).get('type') ==
           'Unconfined']
    if bad:
        parts.append(f'{_n("container", len(bad))} {_q(bad)} must not set '
                     f'securityContext.seccompProfile.type to "Unconfined"')
    return ('seccompProfile', '; '.join(parts)) if parts else None


def sysctls(meta, spec):
    bad = sorted(s.get('name', '') for s in _sc(spec).get('sysctls') or []
                 if s.get('name', '') not in _SYSCTLS)
    return ('forbidden sysctls', _q(bad)) if bad else None


def host_process(meta, spec):
    parts = []
    if (_sc(spec).get('windowsOptions') or {}).get('hostProcess') is True:
        parts.append('pod must not set '
                     'securityContext.windowsOptions.hostProcess=true')
    bad = [c.get('name', '') for c in _all(spec)
           if (_sc(c).get('windowsOptions') or {}).get('hostProcess')
           is True]
    if bad:
        parts.append(f'{_n("container", len(bad))} {_q(bad)} must not set '
                     f'securityContext.windowsOptions.hostProcess=true')
    return ('hostProcess', '; '.join(parts)) if parts else None


def volume_types(meta, spec):
    bad, types = [], set()
    for v in spec.get('volumes') or []:
        restricted = [k for k in v if k != 'name' and k not in _VOLUMES]
        if restricted:
            bad.append(v.get('name', ''))
            types.update(restricted)
    if not bad:
        return None
    return ('restricted volume types',
            f'{_n("volume", len(bad))} {_q(bad)} {_n("uses", len(bad))} '
            f'restricted volume {_n("type", len(types))} '
            f'{_q(sorted(types))}')


def privilege_escalation(meta, spec):
    bad = [c.get('name', '') for c in _all(spec)
           if _sc(c).get('allowPrivilegeEscalation') is not False]
    if not bad:
        return None
    return ('allowPrivilegeEscalation != false',
            f'{_n("container", len(bad))} {_q(bad)} must set '
            f'securityContext.allowPrivilegeEscalation=false')


def run_as_non_root(meta, spec):
    pod = _sc(spec).get('runAsNonRoot')
    unset, false = [], []
    for c in _all(spec):
        own = _sc(c).get('runAsNonRoot')
        if own is False:
            false.append(c.get('name', ''))
        elif own is None and pod is not True:
            unset.append(c.get('name', ''))
    parts = []
    if pod is False:
        parts.append('pod must not set securityContext.runAsNonRoot=false')
    if false:
        parts.append(f'{_n("container", len(false))} {_q(false)} must not '
                     f'set securityContext.runAsNonRoot=false')
    if unset:
        parts.append(f'pod or {_n("container", len(unset))} {_q(unset)} '
                     f'must set securityContext.runAsNonRoot=true')
    return ('runAsNonRoot != true', '; '.join(parts)) if parts else None


def run_as_user(meta, spec):
    parts = []
    if _sc(spec).get('runAsUser') == 0:
        parts.append('pod must not set runAsUser=0')
    bad = [c.get('name', '') for c in _all(spec)
           if _sc(c).get('runAsUser') == 0]
    if bad:
        parts.append(f'{_n("container", len(bad))} {_q(bad)} must not set '
                     f'runAsUser=0')
    return ('runAsUser=0', '; '.join(parts)) if parts else None


def seccomp_restricted(meta, spec):
    pod_ok = (_sc(spec).get('seccompProfile') or {}).get('type') in _RUNTIME
    unset, bad = [], []
    for c in _all(spec):
        t = (_sc(c).get('seccompProfile') or {}).get('type')
        if t in _RUNTIME:
            continue
        if t is None:
            if not pod_ok:
                unset.append(c.get('name', ''))
        else:
            bad.append(c.get('name', ''))
    parts = []
    if bad:
        parts.append(f'{_n("container", len(bad))} {_q(bad)} must not set '
                     f'securityContext.seccompProfile.type to "Unconfined"')
    if unset:
        parts.append(f'pod or {_n("container", len(unset))} {_q(unset)} '
                     f'must set securityContext.seccompProfile.type to '
                     f'"RuntimeDefault" or "Localhost"')
    return ('seccompProfile', '; '.join(parts)) if parts else None


def caps_restricted(meta, spec):
    no_drop, adders, caps = [], [], set()
    for c in _all(spec, ephemeral=False):
        cc = _sc(c).get('capabilities') or {}
        if 'ALL' not in (cc.get('drop') or []):
            no_drop.append(c.get('name', ''))
        extra = [a for a in cc.get('add') or [] if a != 'NET_BIND_SERVICE']
        if extra:
            adders.append(c.get('name', ''))
            caps.update(extra)
    parts = []
    if no_drop:
        parts.append(f'{_n("container", len(no_drop))} {_q(no_drop)} must '
                     f'set securityContext.capabilities.drop=["ALL"]')
    if adders:
        parts.append(f'{_n("container", len(adders))} {_q(adders)} must '
                     f'not include {_q(sorted(caps))} in '
                     f'securityContext.capabilities.add')
    return ('unrestricted capabilities', '; '.join(parts)) if parts else None


def _skip_windows(check):
    def variant(meta, spec):
        return None if _windows(spec) else check(meta, spec)
    return variant


#: (level, variants) in the order the standard lists its controls
CHECKS = [
    ('baseline', [host_namespaces]),
    ('baseline', [privileged]),
    ('baseline', [caps_baseline]),
    ('baseline', [host_path]),
    ('baseline', [host_ports]),
    ('baseline', [app_armor]),
    ('baseline', [selinux]),
    ('baseline', [proc_mount]),
    ('baseline', [seccomp_annotations, seccomp_baseline]),
    ('baseline', [sysctls]),
    ('baseline', [host_process]),
    ('restricted', [volume_types]),
    ('restricted', [privilege_escalation,
                    _skip_windows(privilege_escalation)]),
    ('restricted', [run_as_non_root]),
    ('restricted', [run_as_user]),
    ('restricted', [seccomp_restricted, _skip_windows(seccomp_restricted)]),
    ('restricted', [caps_restricted, _skip_windows(caps_restricted)]),
]


def pod_security(level: str, rule: str, pod: dict) -> Tuple[str, str]:
    meta, spec = pod.get('metadata') or {}, pod.get('spec') or {}
    lines = []
    for check_level, variants in CHECKS:
        if level == 'baseline' and check_level != 'baseline':
            continue
        for variant in variants:
            bad = variant(meta, spec)
            if bad is not None:
                lines.append(f'({{Allowed:false ForbiddenReason:{bad[0]} '
                             f'ForbiddenDetail:{bad[1]}}})\n')
    if not lines:
        return 'pass', f"Validation rule '{rule}' passed."
    return 'fail', (f"Validation rule '{rule}' failed. It violates "
                    f'PodSecurity "{level}:latest": ' + ''.join(lines))


def _rule(level: str, rule: str):
    def evaluate(ctx) -> Optional[Tuple[str, str]]:
        return pod_security(level, rule, ctx.pod)
    return evaluate


#: (policy, rule, kinds, evaluate) in the pack's order
RULES = [
    ('pss-baseline', 'baseline', ('Pod',), _rule('baseline', 'baseline')),
    ('pss-restricted', 'restricted', ('Pod',), _rule('restricted', 'restricted')),
    ('pss-deployments', 'restricted-deploy', ('Deployment',),
     _rule('restricted', 'restricted-deploy')),
]
