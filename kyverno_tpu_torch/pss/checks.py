"""Pod Security Standards check library.

Native implementation of the upstream k8s.io/pod-security-admission
``policy.DefaultChecks()`` set that the reference wraps
(reference: pkg/pss/evaluate.go:17 evaluatePSS). Checks operate on
unstructured pod dicts {metadata, spec}. Latest-version semantics.

Each check returns a CheckResult; failing results carry the upstream-style
forbidden reason/detail strings.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

LEVEL_BASELINE = 'baseline'
LEVEL_RESTRICTED = 'restricted'


class CheckResult(NamedTuple):
    allowed: bool
    forbidden_reason: str = ''
    forbidden_detail: str = ''


class Check(NamedTuple):
    id: str
    level: str
    fn: Callable[[dict, dict], CheckResult]
    # upstream checks carry one implementation per MinimumVersion, and
    # the reference runs EVERY versioned variant regardless of the
    # requested version (pkg/pss/evaluate.go:24 `for _, versionCheck :=
    # range check.Versions` — no dedup), so a pod failing two variants
    # reports the violation twice.  Empty → just ``fn``.
    fns: tuple = ()


OK = CheckResult(True)


def _containers(spec: dict, include_init=True, include_ephemeral=True):
    out = []
    for c in spec.get('containers') or []:
        out.append(c)
    if include_init:
        out.extend(spec.get('initContainers') or [])
    if include_ephemeral:
        out.extend(spec.get('ephemeralContainers') or [])
    return out


def _pluralize(singular: str, plural: str, n: int) -> str:
    return singular if n == 1 else plural


def _join_quote(names: List[str]) -> str:
    return ', '.join(f'"{n}"' for n in names)


def _sec_ctx(obj: dict) -> dict:
    return obj.get('securityContext') or {}


# -- baseline ----------------------------------------------------------------

def check_host_namespaces(meta: dict, spec: dict) -> CheckResult:
    fields = []
    if spec.get('hostNetwork'):
        fields.append('hostNetwork=true')
    if spec.get('hostPID'):
        fields.append('hostPID=true')
    if spec.get('hostIPC'):
        fields.append('hostIPC=true')
    if fields:
        return CheckResult(False, 'host namespaces', ', '.join(fields))
    return OK


def check_privileged(meta: dict, spec: dict) -> CheckResult:
    bad = [c.get('name', '') for c in _containers(spec)
           if _sec_ctx(c).get('privileged') is True]
    if bad:
        return CheckResult(
            False, 'privileged',
            f'{_pluralize("container", "containers", len(bad))} '
            f'{_join_quote(bad)} must not set securityContext.privileged=true')
    return OK


_BASELINE_CAPS = {
    'AUDIT_WRITE', 'CHOWN', 'DAC_OVERRIDE', 'FOWNER', 'FSETID', 'KILL',
    'MKNOD', 'NET_BIND_SERVICE', 'SETFCAP', 'SETGID', 'SETPCAP', 'SETUID',
    'SYS_CHROOT',
}


def check_capabilities_baseline(meta: dict, spec: dict) -> CheckResult:
    bad: Dict[str, List[str]] = {}
    forbidden = set()
    for c in _containers(spec):
        caps = (_sec_ctx(c).get('capabilities') or {}).get('add') or []
        non_default = [cap for cap in caps if cap not in _BASELINE_CAPS]
        if non_default:
            bad[c.get('name', '')] = non_default
            forbidden.update(non_default)
    if bad:
        return CheckResult(
            False, 'non-default capabilities',
            f'{_pluralize("container", "containers", len(bad))} '
            f'{_join_quote(list(bad))} must not include '
            f'{_join_quote(sorted(forbidden))} in '
            f'securityContext.capabilities.add')
    return OK


def check_host_path_volumes(meta: dict, spec: dict) -> CheckResult:
    bad = [v.get('name', '') for v in spec.get('volumes') or []
           if 'hostPath' in v]
    if bad:
        return CheckResult(
            False, 'hostPath volumes',
            f'{_pluralize("volume", "volumes", len(bad))} {_join_quote(bad)}')
    return OK


def check_host_ports(meta: dict, spec: dict) -> CheckResult:
    bad: Dict[str, List[int]] = {}
    ports = set()
    for c in _containers(spec):
        host_ports = [p.get('hostPort') for p in c.get('ports') or []
                      if p.get('hostPort')]
        if host_ports:
            bad[c.get('name', '')] = host_ports
            ports.update(host_ports)
    if bad:
        return CheckResult(
            False, 'hostPort',
            f'{_pluralize("container", "containers", len(bad))} '
            f'{_join_quote(list(bad))} '
            f'{_pluralize("uses", "use", len(bad))} '
            f'{_pluralize("hostPort", "hostPorts", len(ports))} '
            f'{", ".join(str(p) for p in sorted(ports))}')
    return OK


_APPARMOR_PREFIX = 'container.apparmor.security.beta.kubernetes.io/'


def check_app_armor(meta: dict, spec: dict) -> CheckResult:
    bad = []
    for k, v in (meta.get('annotations') or {}).items():
        if k.startswith(_APPARMOR_PREFIX):
            if v not in ('runtime/default', '') and not str(v).startswith('localhost/'):
                bad.append(f'{k}="{v}"')
    if bad:
        return CheckResult(
            False, 'forbidden AppArmor profile',
            f'{_pluralize("annotation", "annotations", len(bad))} '
            f'{", ".join(sorted(bad))}')
    return OK


_ALLOWED_SELINUX_TYPES = {'', 'container_t', 'container_init_t', 'container_kvm_t'}


def check_selinux_options(meta: dict, spec: dict) -> CheckResult:
    bad_types = set()
    bad_user_role = False
    scopes = [('pod', _sec_ctx(spec))]
    scopes += [(f'container "{c.get("name", "")}"', _sec_ctx(c))
               for c in _containers(spec)]
    for _, sc in scopes:
        opts = sc.get('seLinuxOptions') or {}
        t = opts.get('type', '')
        if t not in _ALLOWED_SELINUX_TYPES:
            bad_types.add(t)
        if opts.get('user') or opts.get('role'):
            bad_user_role = True
    details = []
    if bad_types:
        details.append(
            f'{_pluralize("type", "types", len(bad_types))} '
            f'{_join_quote(sorted(bad_types))}')
    if bad_user_role:
        details.append('user or role')
    if details:
        return CheckResult(False, 'seLinuxOptions', '; '.join(details))
    return OK


def check_proc_mount(meta: dict, spec: dict) -> CheckResult:
    bad: Dict[str, str] = {}
    for c in _containers(spec):
        pm = _sec_ctx(c).get('procMount')
        if pm and pm != 'Default':
            bad[c.get('name', '')] = pm
    if bad:
        return CheckResult(
            False, 'procMount',
            f'{_pluralize("container", "containers", len(bad))} '
            f'{_join_quote(list(bad))} must not set securityContext.procMount '
            f'to {_join_quote(sorted(set(bad.values())))}')
    return OK


def check_seccomp_baseline(meta: dict, spec: dict) -> CheckResult:
    bad = []
    pod_type = (_sec_ctx(spec).get('seccompProfile') or {}).get('type')
    if pod_type == 'Unconfined':
        bad.append('pod must not set securityContext.seccompProfile.type to '
                   '"Unconfined"')
    bad_containers = [
        c.get('name', '') for c in _containers(spec)
        if (_sec_ctx(c).get('seccompProfile') or {}).get('type') == 'Unconfined']
    if bad_containers:
        bad.append(
            f'{_pluralize("container", "containers", len(bad_containers))} '
            f'{_join_quote(bad_containers)} must not set '
            f'securityContext.seccompProfile.type to "Unconfined"')
    if bad:
        return CheckResult(False, 'seccompProfile', '; '.join(bad))
    return OK


_ALLOWED_SYSCTLS = {
    'kernel.shm_rmid_forced', 'net.ipv4.ip_local_port_range',
    'net.ipv4.ip_unprivileged_port_start', 'net.ipv4.tcp_syncookies',
    'net.ipv4.ping_group_range',
}


def check_sysctls(meta: dict, spec: dict) -> CheckResult:
    bad = [s.get('name', '') for s in _sec_ctx(spec).get('sysctls') or []
           if s.get('name', '') not in _ALLOWED_SYSCTLS]
    if bad:
        return CheckResult(
            False, 'forbidden sysctls',
            _join_quote(sorted(bad)))
    return OK


def check_windows_host_process(meta: dict, spec: dict) -> CheckResult:
    bad = []
    pod_wo = (_sec_ctx(spec).get('windowsOptions') or {})
    if pod_wo.get('hostProcess') is True:
        bad.append('pod')
    bad_containers = [
        c.get('name', '') for c in _containers(spec)
        if (_sec_ctx(c).get('windowsOptions') or {}).get('hostProcess') is True]
    if bad or bad_containers:
        parts = []
        if bad:
            parts.append('pod must not set '
                         'securityContext.windowsOptions.hostProcess=true')
        if bad_containers:
            parts.append(
                f'{_pluralize("container", "containers", len(bad_containers))} '
                f'{_join_quote(bad_containers)} must not set '
                f'securityContext.windowsOptions.hostProcess=true')
        return CheckResult(False, 'hostProcess', '; '.join(parts))
    return OK


# -- restricted --------------------------------------------------------------

_ALLOWED_VOLUME_TYPES = {
    'configMap', 'csi', 'downwardAPI', 'emptyDir', 'ephemeral',
    'persistentVolumeClaim', 'projected', 'secret',
}


def check_restricted_volumes(meta: dict, spec: dict) -> CheckResult:
    bad = []
    bad_types = set()
    for v in spec.get('volumes') or []:
        types = [k for k in v if k != 'name']
        restricted = [t for t in types if t not in _ALLOWED_VOLUME_TYPES]
        if restricted:
            bad.append(v.get('name', ''))
            bad_types.update(restricted)
    if bad:
        return CheckResult(
            False, 'restricted volume types',
            f'{_pluralize("volume", "volumes", len(bad))} {_join_quote(bad)} '
            f'{_pluralize("uses", "use", len(bad))} restricted volume '
            f'{_pluralize("type", "types", len(bad_types))} '
            f'{_join_quote(sorted(bad_types))}')
    return OK


def check_allow_privilege_escalation(meta: dict, spec: dict) -> CheckResult:
    bad = [c.get('name', '') for c in _containers(spec)
           if _sec_ctx(c).get('allowPrivilegeEscalation') is not False]
    if bad:
        return CheckResult(
            False, 'allowPrivilegeEscalation != false',
            f'{_pluralize("container", "containers", len(bad))} '
            f'{_join_quote(bad)} must set '
            f'securityContext.allowPrivilegeEscalation=false')
    return OK


def check_run_as_non_root(meta: dict, spec: dict) -> CheckResult:
    pod_non_root = _sec_ctx(spec).get('runAsNonRoot')
    bad = []
    explicitly_bad = []
    for c in _containers(spec):
        c_setting = _sec_ctx(c).get('runAsNonRoot')
        if c_setting is False:
            explicitly_bad.append(c.get('name', ''))
        elif c_setting is None and pod_non_root is not True:
            bad.append(c.get('name', ''))
    details = []
    if pod_non_root is False:
        details.append('pod must not set securityContext.runAsNonRoot=false')
    if explicitly_bad:
        details.append(
            f'{_pluralize("container", "containers", len(explicitly_bad))} '
            f'{_join_quote(explicitly_bad)} must not set '
            f'securityContext.runAsNonRoot=false')
    if bad and pod_non_root is not True:
        details.append(
            f'pod or {_pluralize("container", "containers", len(bad))} '
            f'{_join_quote(bad)} must set securityContext.runAsNonRoot=true')
    if details:
        return CheckResult(False, 'runAsNonRoot != true', '; '.join(details))
    return OK


def check_run_as_user(meta: dict, spec: dict) -> CheckResult:
    details = []
    if _sec_ctx(spec).get('runAsUser') == 0:
        details.append('pod must not set runAsUser=0')
    bad = [c.get('name', '') for c in _containers(spec)
           if _sec_ctx(c).get('runAsUser') == 0]
    if bad:
        details.append(
            f'{_pluralize("container", "containers", len(bad))} '
            f'{_join_quote(bad)} must not set runAsUser=0')
    if details:
        return CheckResult(False, 'runAsUser=0', '; '.join(details))
    return OK


def check_seccomp_restricted(meta: dict, spec: dict) -> CheckResult:
    pod_type = (_sec_ctx(spec).get('seccompProfile') or {}).get('type')
    pod_ok = pod_type in ('RuntimeDefault', 'Localhost')
    bad = []
    explicitly_bad = []
    for c in _containers(spec):
        c_type = (_sec_ctx(c).get('seccompProfile') or {}).get('type')
        if c_type in ('RuntimeDefault', 'Localhost'):
            continue
        if c_type is None:
            if not pod_ok:
                bad.append(c.get('name', ''))
        else:
            explicitly_bad.append(c.get('name', ''))
    details = []
    if explicitly_bad:
        details.append(
            f'{_pluralize("container", "containers", len(explicitly_bad))} '
            f'{_join_quote(explicitly_bad)} must not set '
            f'securityContext.seccompProfile.type to "Unconfined"')
    if bad:
        details.append(
            f'pod or {_pluralize("container", "containers", len(bad))} '
            f'{_join_quote(bad)} must set securityContext.seccompProfile.type '
            f'to "RuntimeDefault" or "Localhost"')
    if details:
        return CheckResult(False, 'seccompProfile', '; '.join(details))
    return OK


def check_capabilities_restricted(meta: dict, spec: dict) -> CheckResult:
    bad_drop = []
    bad_add: Dict[str, List[str]] = {}
    forbidden = set()
    for c in _containers(spec, include_ephemeral=False):
        caps = _sec_ctx(c).get('capabilities') or {}
        drop = caps.get('drop') or []
        if 'ALL' not in drop:
            bad_drop.append(c.get('name', ''))
        add = [cap for cap in caps.get('add') or []
               if cap != 'NET_BIND_SERVICE']
        if add:
            bad_add[c.get('name', '')] = add
            forbidden.update(add)
    details = []
    if bad_drop:
        details.append(
            f'{_pluralize("container", "containers", len(bad_drop))} '
            f'{_join_quote(bad_drop)} must set '
            f'securityContext.capabilities.drop=["ALL"]')
    if bad_add:
        details.append(
            f'{_pluralize("container", "containers", len(bad_add))} '
            f'{_join_quote(list(bad_add))} must not include '
            f'{_join_quote(sorted(forbidden))} in '
            f'securityContext.capabilities.add')
    if details:
        return CheckResult(False, 'unrestricted capabilities',
                           '; '.join(details))
    return OK


def _windows_exempt(fn: Callable[[dict, dict], CheckResult]
                    ) -> Callable[[dict, dict], CheckResult]:
    """The 1.25 variants skip linux-only checks for windows pods
    (KEP-2802: pod.spec.os.name == 'windows')."""
    def variant(meta: dict, spec: dict) -> CheckResult:
        if (spec.get('os') or {}).get('name') == 'windows':
            return OK
        return fn(meta, spec)
    return variant


_SECCOMP_ANNOTATION_POD = 'seccomp.security.alpha.kubernetes.io/pod'
_SECCOMP_ANNOTATION_PREFIX = 'container.seccomp.security.alpha.kubernetes.io/'


def check_seccomp_baseline_1_0(meta: dict, spec: dict) -> CheckResult:
    """The pre-1.19 annotation-based seccomp check
    (pod-security-admission check_seccompProfile_baseline.go v1.0)."""
    annotations = meta.get('annotations') or {}
    forbidden = []
    val = annotations.get(_SECCOMP_ANNOTATION_POD)
    if val == 'unconfined':
        forbidden.append(f'{_SECCOMP_ANNOTATION_POD}="{val}"')
    for c in _containers(spec):
        key = _SECCOMP_ANNOTATION_PREFIX + c.get('name', '')
        val = annotations.get(key)
        if val == 'unconfined':
            forbidden.append(f'{key}="{val}"')
    if forbidden:
        return CheckResult(
            False, 'seccompProfile',
            f'forbidden '
            f'{_pluralize("annotation", "annotations", len(forbidden))} '
            f'{", ".join(forbidden)}')
    return OK


DEFAULT_CHECKS: List[Check] = [
    Check('hostNamespaces', LEVEL_BASELINE, check_host_namespaces),
    Check('privileged', LEVEL_BASELINE, check_privileged),
    Check('capabilities_baseline', LEVEL_BASELINE, check_capabilities_baseline),
    Check('hostPathVolumes', LEVEL_BASELINE, check_host_path_volumes),
    Check('hostPorts', LEVEL_BASELINE, check_host_ports),
    Check('appArmorProfile', LEVEL_BASELINE, check_app_armor),
    Check('seLinuxOptions', LEVEL_BASELINE, check_selinux_options),
    Check('procMount', LEVEL_BASELINE, check_proc_mount),
    Check('seccompProfile_baseline', LEVEL_BASELINE, check_seccomp_baseline,
          (check_seccomp_baseline_1_0, check_seccomp_baseline)),
    Check('sysctls', LEVEL_BASELINE, check_sysctls),
    Check('windowsHostProcess', LEVEL_BASELINE, check_windows_host_process),
    Check('restrictedVolumes', LEVEL_RESTRICTED, check_restricted_volumes),
    Check('allowPrivilegeEscalation', LEVEL_RESTRICTED,
          check_allow_privilege_escalation,
          (check_allow_privilege_escalation,
           _windows_exempt(check_allow_privilege_escalation))),
    Check('runAsNonRoot', LEVEL_RESTRICTED, check_run_as_non_root),
    Check('runAsUser', LEVEL_RESTRICTED, check_run_as_user),
    Check('seccompProfile_restricted', LEVEL_RESTRICTED,
          check_seccomp_restricted,
          (check_seccomp_restricted,
           _windows_exempt(check_seccomp_restricted))),
    Check('capabilities_restricted', LEVEL_RESTRICTED,
          check_capabilities_restricted,
          (check_capabilities_restricted,
           _windows_exempt(check_capabilities_restricted))),
]


# Control name → check ids (reference: pkg/pss/utils/mapping.go:45)
PSS_CONTROLS_TO_CHECK_ID: Dict[str, List[str]] = {
    'Capabilities': ['capabilities_baseline', 'capabilities_restricted'],
    'Seccomp': ['seccompProfile_baseline', 'seccompProfile_restricted'],
    'Privileged Containers': ['privileged'],
    'Host Ports': ['hostPorts'],
    '/proc Mount Type': ['procMount'],
    'HostProcess': ['windowsHostProcess'],
    'SELinux': ['seLinuxOptions'],
    'Host Namespaces': ['hostNamespaces'],
    'HostPath Volumes': ['hostPathVolumes'],
    'Sysctls': ['sysctls'],
    'AppArmor': ['appArmorProfile'],
    'Volume Types': ['restrictedVolumes'],
    'Privilege Escalation': ['allowPrivilegeEscalation'],
    'Running as Non-root': ['runAsNonRoot'],
    'Running as Non-root user': ['runAsUser'],
}
