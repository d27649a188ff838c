"""Pod Security Standards → device check library.

Compiles ``validate.podSecurity`` rules into slot predicates mirroring
the native check set (kyverno_tpu/pss/checks.py, reference:
pkg/pss/evaluate.go:17 + k8s.io/pod-security-admission DefaultChecks).
Each check becomes a BoolExpr whose truth means "check passes"; the rule
status is the conjunction walked in DEFAULT_CHECKS order, so the first
failing check decides (messages for failures are materialized by the
host engine — only the PASS verdict is synthesized on device).

The pod spec prefix is derived from the rule's matched kinds
(pss/evaluate.py extract_pod_spec, reference: pkg/engine/validation.go:481):
Pod → the resource itself; template workloads → ``spec.template``;
CronJob → ``spec.jobTemplate.spec.template``.  Autogen has already split
rules per kind class, so a compilable rule maps to exactly one prefix.

Two checks scan map keys (AppArmor annotations, volume type keys), which
the slot model cannot address; those use *virtual gathers* — encoder-side
Python closures marked ``__pss:...`` that project a boolean per resource
(host-exact by construction, still ~50× cheaper than a full host run).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from ..pss.checks import (_ALLOWED_SELINUX_TYPES, _ALLOWED_SYSCTLS,
                          _BASELINE_CAPS, LEVEL_BASELINE)
from .ir import (BoolExpr, CompileError, CompiledPolicySet, CondCheck,
                 GatherSlot, Leaf, Slot, StatusExpr)

_TEMPLATE_PREFIX: dict = {
    'Pod': (),
    'DaemonSet': ('spec', 'template'),
    'Deployment': ('spec', 'template'),
    'Job': ('spec', 'template'),
    'StatefulSet': ('spec', 'template'),
    'ReplicaSet': ('spec', 'template'),
    'ReplicationController': ('spec', 'template'),
    'CronJob': ('spec', 'jobTemplate', 'spec', 'template'),
}


def _rule_kinds(rule: dict) -> List[str]:
    kinds: List[str] = []
    match = rule.get('match') or {}
    for f in [match] + (match.get('any') or []) + (match.get('all') or []):
        for k in (f.get('resources') or {}).get('kinds') or []:
            kinds.append(str(k).split('/')[-1])
    return kinds


def compile_pod_security(cps: CompiledPolicySet, pod_security: dict,
                         rule: dict) -> StatusExpr:
    if pod_security.get('exclude'):
        raise CompileError('podSecurity excludes require the host engine')
    from ..pss.evaluate import parse_version
    try:
        level, _version = parse_version(pod_security)
    except ValueError:
        raise CompileError('invalid podSecurity version')
    kinds = _rule_kinds(rule)
    if not kinds:
        raise CompileError('podSecurity rule without kinds')
    prefixes = set()
    for kind in kinds:
        if kind not in _TEMPLATE_PREFIX:
            raise CompileError(f'podSecurity kind {kind!r} not mapped')
        prefixes.add(_TEMPLATE_PREFIX[kind])
    if len(prefixes) != 1:
        raise CompileError('podSecurity rule spans multiple pod prefixes')
    prefix = next(iter(prefixes))

    b = _Builder(cps, prefix)
    checks: List[Tuple[str, BoolExpr]] = [
        ('hostNamespaces', b.host_namespaces()),
        ('privileged', b.privileged()),
        ('capabilities_baseline', b.capabilities_baseline()),
        ('hostPathVolumes', b.host_path_volumes()),
        ('hostPorts', b.host_ports()),
        ('appArmorProfile', b.app_armor()),
        ('seLinuxOptions', b.selinux_options()),
        ('procMount', b.proc_mount()),
        ('seccompProfile_baseline', b.seccomp_baseline()),
        ('sysctls', b.sysctls()),
        ('windowsHostProcess', b.windows_host_process()),
    ]
    if level != LEVEL_BASELINE:
        checks += [
            ('restrictedVolumes', b.restricted_volumes()),
            ('allowPrivilegeEscalation', b.allow_privilege_escalation()),
            ('runAsNonRoot', b.run_as_non_root()),
            ('runAsUser', b.run_as_user()),
            ('seccompProfile_restricted', b.seccomp_restricted()),
            ('capabilities_restricted', b.capabilities_restricted()),
        ]
    # DEFAULT_CHECKS order: first failing check decides; the host
    # materializes the exact forbidden-reason message on any non-pass
    return StatusExpr.seq(
        [StatusExpr('leaf', expr=e) for _, e in checks])


class _Builder:
    """Per-prefix expression builders, one per check in pss/checks.py."""

    _CONTAINER_FIELDS = ('containers', 'initContainers',
                         'ephemeralContainers')

    def __init__(self, cps: CompiledPolicySet, prefix: Tuple[str, ...]):
        self.cps = cps
        self.prefix = prefix
        self.spec = prefix + ('spec',)
        self.meta = prefix + ('metadata',)

    def _slot(self, path: Tuple[str, ...]) -> Slot:
        slot = Slot(path)
        self.cps.slot_id(slot)
        return slot

    def L(self, path: Tuple[str, ...], op: str, operand: Any = None
          ) -> BoolExpr:
        return BoolExpr.of(Leaf(self._slot(path), op, operand))

    def eq_any(self, path: Tuple[str, ...], values) -> BoolExpr:
        return BoolExpr.any([self.L(path, 'eq_str', v) for v in values])

    def quant(self, kind: str, array: Tuple[str, ...],
              fn: Callable[[Tuple[str, ...]], BoolExpr]) -> BoolExpr:
        slot = self._slot(array)
        return BoolExpr(kind, children=(fn(array + ('*',)),), slot=slot)

    def all_containers(self, fn: Callable[[Tuple[str, ...]], BoolExpr],
                       include_ephemeral: bool = True) -> BoolExpr:
        fields = self._CONTAINER_FIELDS if include_ephemeral else \
            self._CONTAINER_FIELDS[:2]
        return BoolExpr.all([
            self.quant('all_elem', self.spec + (f,), fn) for f in fields])

    def virtual(self, check: str) -> BoolExpr:
        """True when the virtual projection reports a violation."""
        expr = f'__pss:{check}:' + '.'.join(self.prefix)
        gather = GatherSlot(expr)
        self.cps.gather_id(gather)
        return BoolExpr.of_cond(CondCheck(
            gather=gather, op='equals', values=(True,), list_value=False))

    # -- baseline ---------------------------------------------------------

    def host_namespaces(self) -> BoolExpr:
        return BoolExpr.negate(BoolExpr.any([
            self.L(self.spec + (k,), 'truthy')
            for k in ('hostNetwork', 'hostPID', 'hostIPC')]))

    def privileged(self) -> BoolExpr:
        return self.all_containers(lambda c: BoolExpr.negate(
            self.L(c + ('securityContext', 'privileged'), 'is_true')))

    def capabilities_baseline(self) -> BoolExpr:
        caps = sorted(_BASELINE_CAPS)
        return self.all_containers(lambda c: self.quant(
            'all_elem', c + ('securityContext', 'capabilities', 'add'),
            lambda e: self.eq_any(e, caps)))

    def host_path_volumes(self) -> BoolExpr:
        return self.quant(
            'all_elem', self.spec + ('volumes',),
            lambda v: self.L(v + ('hostPath',), 'absent'))

    def host_ports(self) -> BoolExpr:
        return self.all_containers(lambda c: self.quant(
            'all_elem', c + ('ports',),
            lambda p: BoolExpr.negate(self.L(p + ('hostPort',), 'truthy'))))

    def app_armor(self) -> BoolExpr:
        return BoolExpr.negate(self.virtual('apparmor'))

    def selinux_options(self) -> BoolExpr:
        def ok(sc: Tuple[str, ...]) -> BoolExpr:
            opts = sc + ('seLinuxOptions',)
            # opts.get('type', '') — missing → '' (allowed); an explicit
            # null is NOT defaulted and violates (checks.py:160)
            type_ok = BoolExpr.any(
                [self.L(opts + ('type',), 'absent'),
                 self.L(opts + ('type',), 'eq_str', ''),
                 self.eq_any(opts + ('type',),
                             sorted(t for t in _ALLOWED_SELINUX_TYPES if t))])
            no_user = BoolExpr.negate(self.L(opts + ('user',), 'truthy'))
            no_role = BoolExpr.negate(self.L(opts + ('role',), 'truthy'))
            return BoolExpr.all([type_ok, no_user, no_role])
        return BoolExpr.all(
            [ok(self.spec + ('securityContext',))] +
            [self.all_containers(
                lambda c: ok(c + ('securityContext',)))])

    def proc_mount(self) -> BoolExpr:
        def ok(c: Tuple[str, ...]) -> BoolExpr:
            pm = c + ('securityContext', 'procMount')
            return BoolExpr.any([
                BoolExpr.negate(self.L(pm, 'truthy')),
                self.L(pm, 'eq_str', 'Default')])
        return self.all_containers(ok)

    def seccomp_baseline(self) -> BoolExpr:
        def ok(sc: Tuple[str, ...]) -> BoolExpr:
            return BoolExpr.negate(self.L(
                sc + ('securityContext', 'seccompProfile', 'type'),
                'eq_str', 'Unconfined'))
        pod_ok = BoolExpr.negate(self.L(
            self.spec + ('securityContext', 'seccompProfile', 'type'),
            'eq_str', 'Unconfined'))
        return BoolExpr.all([pod_ok, self.all_containers(ok)])

    def sysctls(self) -> BoolExpr:
        return self.quant(
            'all_elem', self.spec + ('securityContext', 'sysctls'),
            lambda s: self.eq_any(s + ('name',), sorted(_ALLOWED_SYSCTLS)))

    def windows_host_process(self) -> BoolExpr:
        wo = ('securityContext', 'windowsOptions', 'hostProcess')
        pod_ok = BoolExpr.negate(self.L(self.spec + wo, 'is_true'))
        return BoolExpr.all([pod_ok, self.all_containers(
            lambda c: BoolExpr.negate(self.L(c + wo, 'is_true')))])

    # -- restricted -------------------------------------------------------

    def restricted_volumes(self) -> BoolExpr:
        return BoolExpr.negate(self.virtual('volumes'))

    def allow_privilege_escalation(self) -> BoolExpr:
        return self.all_containers(lambda c: self.L(
            c + ('securityContext', 'allowPrivilegeEscalation'), 'is_false'))

    def run_as_non_root(self) -> BoolExpr:
        pod = self.spec + ('securityContext', 'runAsNonRoot')
        pod_false = self.L(pod, 'is_false')
        pod_true = self.L(pod, 'is_true')
        no_false = self.all_containers(lambda c: BoolExpr.negate(self.L(
            c + ('securityContext', 'runAsNonRoot'), 'is_false')))
        # a container with the setting unset (None) violates unless the
        # pod-level default is exactly True (pss/checks.py:297)
        any_unset = BoolExpr.any([
            self.quant('any_elem', self.spec + (f,),
                       lambda c: _nullish(self, c + (
                           'securityContext', 'runAsNonRoot')))
            for f in self._CONTAINER_FIELDS])
        return BoolExpr.all([
            BoolExpr.negate(pod_false),
            no_false,
            BoolExpr.any([BoolExpr.negate(any_unset), pod_true]),
        ])

    def run_as_user(self) -> BoolExpr:
        pod_ok = BoolExpr.negate(self.L(
            self.spec + ('securityContext', 'runAsUser'), 'is_zero_num'))
        return BoolExpr.all([pod_ok, self.all_containers(
            lambda c: BoolExpr.negate(self.L(
                c + ('securityContext', 'runAsUser'), 'is_zero_num')))])

    def seccomp_restricted(self) -> BoolExpr:
        allowed = ('Localhost', 'RuntimeDefault')
        pod_path = self.spec + ('securityContext', 'seccompProfile', 'type')
        pod_ok = self.eq_any(pod_path, allowed)
        def c_ok(c: Tuple[str, ...]) -> BoolExpr:
            ct = c + ('securityContext', 'seccompProfile', 'type')
            explicit_ok = self.eq_any(ct, allowed)
            inherits = _nullish(self, ct)
            return BoolExpr.any([
                explicit_ok,
                BoolExpr.all([inherits, pod_ok])])
        return self.all_containers(c_ok)

    def capabilities_restricted(self) -> BoolExpr:
        def c_ok(c: Tuple[str, ...]) -> BoolExpr:
            caps = c + ('securityContext', 'capabilities')
            drops_all = self.quant('any_elem', caps + ('drop',),
                                   lambda e: self.L(e, 'eq_str', 'ALL'))
            adds_ok = self.quant('all_elem', caps + ('add',),
                                 lambda e: self.L(e, 'eq_str',
                                                  'NET_BIND_SERVICE'))
            return BoolExpr.all([drops_all, adds_ok])
        return self.all_containers(c_ok, include_ephemeral=False)


def _nullish(b: _Builder, path: Tuple[str, ...]) -> BoolExpr:
    """`.get(key) is None` — key absent or explicitly null."""
    slot = b._slot(path)
    return BoolExpr.negate(BoolExpr.of(Leaf(slot, 'star')))


# ---------------------------------------------------------------------------
# virtual gathers (encoder-side projections for map-key scans)

class _VirtualSearcher:
    def __init__(self, fn: Callable[[dict], bool],
                 prefix: Tuple[str, ...]):
        self._fn = fn
        self._prefix = prefix

    def search(self, data: dict) -> bool:
        doc = (data.get('request') or {}).get('object') or {}
        for part in self._prefix:
            doc = doc.get(part) if isinstance(doc, dict) else None
            if doc is None:
                doc = {}
                break
        return self._fn(doc if isinstance(doc, dict) else {})


def _apparmor_violation(pod: dict) -> bool:
    from ..pss.checks import check_app_armor
    return not check_app_armor(pod.get('metadata') or {},
                               pod.get('spec') or {}).allowed


def _volumes_violation(pod: dict) -> bool:
    from ..pss.checks import check_restricted_volumes
    return not check_restricted_volumes(pod.get('metadata') or {},
                                        pod.get('spec') or {}).allowed


_VIRTUALS = {'apparmor': _apparmor_violation, 'volumes': _volumes_violation}


def virtual_searcher(expr: str) -> _VirtualSearcher:
    """Resolve a ``__pss:<check>:<dotted-prefix>`` virtual gather."""
    _, check, dotted = expr.split(':', 2)
    prefix = tuple(p for p in dotted.split('.') if p)
    return _VirtualSearcher(_VIRTUALS[check], prefix)
