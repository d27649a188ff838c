"""Per-row admission lanes: subject/role match decided in-graph.

Batched admission serving historically required every rider of a shared
dispatch to carry an IDENTICAL admission tuple (userInfo / roles /
namespace labels / operation), because the host match sieve evaluated
one scan-wide tuple.  Real traffic — millions of distinct users — then
degenerates to batch-of-one.  This module moves the per-request
variation into tensor lanes, the same trick the ragged batch kernels
play with row counts: the batch key collapses to the policy set, and
one compiled program serves arbitrary request mixes.

Three pieces, mirroring the encode.py / ops/eval.py split:

* **compile** (:func:`compile_admission`): for every compiled program
  whose match/exclude depends on admission data (roles / clusterRoles /
  subjects) and whose resource descriptions are group-simple
  (kinds/namespaces/operations — cacheable per resource group), lower
  the rule's filter structure to a static boolean tree over per-filter
  atoms.  Operand strings are **interned exactly** into a per-policy-set
  vocabulary, so device membership tests are integer-id equality — no
  hashing, no collision risk, bit-identity preserved by construction.
  Rules outside this vocabulary (namespaceSelector, selector+userinfo
  combinations, non-list operands) simply keep the host matcher.
* **row encoding** (:func:`encode_rows`): each request's admission tuple
  becomes fixed-width int32 id lanes (username, groups, RBAC roles,
  cluster roles) plus ``hasinfo``/``excluded`` flags.  A row whose
  values do not intern exactly (non-string entries, more in-vocabulary
  values than the lane width) is marked *unencodable*: that row alone
  falls back to the host matcher under the coverage-taxonomy reason
  ``admission_unencodable`` — it never holds the rest of the batch.
* **host halves**: :func:`atom_ok` evaluates one filter's
  resource-shape atom with the exact host helpers (group-cached by the
  scanner), and :func:`match_upper` derives the conservative
  over-approximation the fail-detail compaction mask uses before the
  device's exact decision lands.

The in-graph decision itself lives in ``ops/eval.py``
(``_adm_match_graph``), which consumes these tables and lanes inside
the same jitted evaluator — admission lanes add inputs, not
executables, so the fresh-process census stays at
``WARM_EXECUTABLES_MAX``.  ``KTPU_ADM_LANES=0`` disables the whole
mechanism (every admission-dependent match stays on the host matcher,
the bit-identity oracle).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

#: fixed per-row lane widths (static shapes: widths are part of the
#: compiled signature, so they are constants, not knobs).  Rows with
#: more *in-vocabulary* values than a lane holds are unencodable and
#: fall back per-row; out-of-vocabulary values can never match any
#: operand and are dropped before the width check.
GROUPS_W = 16
ROLES_W = 16

#: lane-name contract shared with ops/eval.py and compiler/scan.py
LANE_NAMES = ('__admres__', '__adm_user__', '__adm_groups__',
              '__adm_roles__', '__adm_croles__', '__adm_hasinfo__',
              '__adm_excluded__')

#: resource-description keys whose match decision is a function of the
#: (kind, apiVersion, namespace) group alone (the matcher ignores
#: ``operations`` entirely) — the same set compiler/scan.py group-caches
_SIMPLE_RES_KEYS = frozenset({'kinds', 'namespaces', 'operations'})


def lanes_enabled() -> bool:
    return os.environ.get('KTPU_ADM_LANES', '1') not in ('0', 'false',
                                                         'off')


class AdmFilter(NamedTuple):
    """One lowered match/exclude filter: a resource-shape atom index
    plus exact-interned user-info operand id sets.  ``has_*`` flags
    capture host presence semantics (a ``roles`` list whose entries all
    failed to intern still *gates* — it can only ever match via the
    excluded-groups escape)."""
    atom: int
    has_res: bool
    has_roles: bool
    has_croles: bool
    has_subjects: bool
    roles: Tuple[int, ...]
    cluster_roles: Tuple[int, ...]
    subjects_ug: Tuple[int, ...]   # User/Group names vs groups+username
    subjects_sa: Tuple[int, ...]   # full system:serviceaccount:ns:name

    @property
    def has_ui(self) -> bool:
        return self.has_roles or self.has_croles or self.has_subjects


class AdmProgram(NamedTuple):
    """Static filter structure of one eligible program (column ``j`` in
    the compiled program space)."""
    j: int
    match_kind: str                       # 'any' | 'all' | 'plain'
    match_filters: Tuple[AdmFilter, ...]
    exclude_kind: str                     # 'none' | 'any' | 'all' | 'plain'
    exclude_filters: Tuple[AdmFilter, ...]


class AdmAtom(NamedTuple):
    """Host-evaluated resource-shape atom: the policy namespace gate AND
    the filter's (simple) resource description."""
    policy_index: int
    resources: dict


class AdmissionTable(NamedTuple):
    programs: Tuple[AdmProgram, ...]
    atoms: Tuple[AdmAtom, ...]
    vocab: Dict[str, int]

    def program_cols(self) -> np.ndarray:
        return np.array([p.j for p in self.programs], np.int64)


# ---------------------------------------------------------------------------
# compile: rule match/exclude blocks -> static filter trees


def _filters_of(block: dict, mode: str) -> Tuple[str, List[dict]]:
    """Mirror matches_resource_description's filter extraction
    (engine/match.py): any/all lists verbatim, else the plain
    four-field filter; an empty plain exclude never excludes."""
    any_f = block.get('any') or []
    all_f = block.get('all') or []
    if any_f:
        return 'any', list(any_f)
    if all_f:
        return 'all', list(all_f)
    plain = {'resources': block.get('resources') or {},
             'roles': block.get('roles'),
             'clusterRoles': block.get('clusterRoles'),
             'subjects': block.get('subjects')}
    if mode == 'exclude':
        if not any([plain['resources'], plain['roles'],
                    plain['clusterRoles'], plain['subjects']]):
            return 'none', []
    return 'plain', [plain]


def _lower_filter(f: Any, policy_index: int, intern,
                  atoms: List[AdmAtom]) -> Optional[AdmFilter]:
    if not isinstance(f, dict):
        return None
    res = f.get('resources') or {}
    if not isinstance(res, dict) or \
            any(k not in _SIMPLE_RES_KEYS for k in res):
        return None
    roles = f.get('roles') or []
    croles = f.get('clusterRoles') or []
    subjects = f.get('subjects') or []
    if not isinstance(roles, list) or not isinstance(croles, list) or \
            not isinstance(subjects, list):
        # a non-list here changes host semantics ('in' on a string is a
        # substring test) — keep the whole rule on the host matcher
        return None
    role_ids = tuple(sorted({intern(r) for r in roles
                             if isinstance(r, str)}))
    crole_ids = tuple(sorted({intern(r) for r in croles
                              if isinstance(r, str)}))
    ug: set = set()
    sa: set = set()
    for s in subjects:
        if not isinstance(s, dict):
            return None  # the host matcher would raise; stay off device
        kind = s.get('kind', '')
        if kind == 'ServiceAccount':
            # host: username[len('system:serviceaccount:'):] == 'ns:name'
            # — equivalent to full-username equality (the suffix always
            # contains at least the separating colon)
            sa.add(intern('system:serviceaccount:'
                          f"{s.get('namespace', '')}:{s.get('name', '')}"))
        elif kind in ('User', 'Group'):
            nm = s.get('name')
            if isinstance(nm, str):
                ug.add(intern(nm))
            # non-string names can never equal a string user key
        # other kinds never match on the host either: contribute nothing
    atom = len(atoms)
    atoms.append(AdmAtom(policy_index, dict(res)))
    return AdmFilter(atom, bool(res), bool(roles), bool(croles),
                     bool(subjects), role_ids, crole_ids,
                     tuple(sorted(ug)), tuple(sorted(sa)))


def _lower_rule(j: int, rule: dict, policy_index: int, intern,
                atoms: List[AdmAtom]) -> Optional[AdmProgram]:
    match = rule.get('match') or {}
    exclude = rule.get('exclude') or {}
    if not isinstance(match, dict) or not isinstance(exclude, dict):
        return None
    mk, mfs_raw = _filters_of(match, 'match')
    ek, efs_raw = _filters_of(exclude, 'exclude')

    def dep(f) -> bool:
        return isinstance(f, dict) and bool(
            f.get('roles') or f.get('clusterRoles') or f.get('subjects'))

    if not any(dep(f) for f in mfs_raw + efs_raw):
        return None  # admission-invariant: the group cache already serves it
    staged: List[AdmAtom] = []
    mfs = [_lower_filter(f, policy_index, intern, staged) for f in mfs_raw]
    efs = [_lower_filter(f, policy_index, intern, staged) for f in efs_raw]
    if any(f is None for f in mfs + efs):
        return None  # outside the lane vocabulary: host matcher
    base = len(atoms)
    atoms.extend(staged)
    shift = [f._replace(atom=f.atom + base) for f in mfs + efs]
    mfs2, efs2 = shift[:len(mfs)], shift[len(mfs):]
    return AdmProgram(j, mk, tuple(mfs2), ek, tuple(efs2))


def compile_admission(cps) -> Optional[AdmissionTable]:
    """Lower every eligible program of ``cps`` (or None when nothing is
    admission-dependent, or ``KTPU_ADM_LANES`` is off).  Deterministic
    for a policy set, so the table is implicitly covered by the AOT
    fingerprint and the lane signature."""
    if not lanes_enabled():
        return None
    vocab: Dict[str, int] = {}

    def intern(s: str) -> int:
        return vocab.setdefault(s, len(vocab))

    atoms: List[AdmAtom] = []
    programs: List[AdmProgram] = []
    for j, prog in enumerate(cps.programs):
        rule = prog.rule_raw
        if not isinstance(rule, dict):
            continue
        spec = _lower_rule(j, rule, prog.policy_index, intern, atoms)
        if spec is not None:
            programs.append(spec)
    if not programs:
        return None
    return AdmissionTable(tuple(programs), tuple(atoms), vocab)


# ---------------------------------------------------------------------------
# host halves: resource-shape atoms + the compaction upper bound


def atom_ok(atom: AdmAtom, policy, res) -> bool:
    """One filter's resource-shape decision for one resource — the exact
    host helpers the matcher itself runs (_check_resource_description
    with admission-free arguments; group-cacheable: nothing here reads
    beyond kind/apiVersion/namespace and the policy namespace gate)."""
    if policy.is_namespaced and (
            not res.namespace or res.namespace != policy.namespace):
        return False
    if not atom.resources:
        return True
    from ..engine.match import _check_resource_description
    return not _check_resource_description(atom.resources, res, {}, '',
                                           True, None)


def match_upper(table: AdmissionTable, atoms_u8: np.ndarray) -> np.ndarray:
    """[R, n_elig] conservative upper bound of the final match (user
    info treated as always-matching, exclusion as never-excluding) —
    what the device compaction mask may safely use before the exact
    in-graph decision replaces it."""
    n = atoms_u8.shape[0]
    out = np.zeros((n, len(table.programs)), bool)
    for c, p in enumerate(table.programs):
        oks = [atoms_u8[:, f.atom].astype(bool)
               if (f.has_res or f.has_ui) else np.zeros(n, bool)
               for f in p.match_filters]
        if not oks:
            continue
        if p.match_kind == 'all':
            acc = oks[0]
            for o in oks[1:]:
                acc = acc & o
        else:  # 'any' | 'plain'
            acc = oks[0]
            for o in oks[1:]:
                acc = acc | o
        out[:, c] = acc
    return out


# ---------------------------------------------------------------------------
# per-row encoding


class AdmissionRowPlan:
    """Encoded admission lanes + host bookkeeping for one scan.

    ``valid`` marks rows whose device decision is authoritative;
    ``unencodable`` the subset excluded because their admission values
    did not intern exactly (UPDATE rows carrying an oldObject are also
    non-``valid`` — their old-match retry folds on the host — but that
    is a semantic exclusion, not a taxonomy event)."""

    __slots__ = ('lanes', 'valid', 'unencodable', 'upper')

    def __init__(self, lanes: Dict[str, np.ndarray], valid: np.ndarray,
                 unencodable: np.ndarray):
        self.lanes = lanes
        self.valid = valid
        self.unencodable = unencodable
        self.upper: Optional[np.ndarray] = None


def _str_list(v) -> Optional[List[str]]:
    if v is None:
        return []
    if not isinstance(v, (list, tuple)) or \
            any(not isinstance(x, str) for x in v):
        return None
    return list(v)


def encode_rows(table: AdmissionTable, adm_rows: List[Any],
                old_flags: Optional[List[bool]] = None
                ) -> AdmissionRowPlan:
    """Encode one admission tuple per row into the fixed-width id lanes.

    ``adm_rows[i]`` is the (admission_info, exclude_group_roles,
    namespace_labels, operation) tuple webhook scans thread through.
    Interning is exact: a value outside the vocabulary becomes -1 and
    can never match an operand, so equality on ids IS equality on
    strings."""
    n = len(adm_rows)
    user = np.full(n, -1, np.int32)
    groups = np.full((n, GROUPS_W), -1, np.int32)
    roles = np.full((n, ROLES_W), -1, np.int32)
    croles = np.full((n, ROLES_W), -1, np.int32)
    hasinfo = np.zeros(n, np.int8)
    excluded = np.zeros(n, np.int8)
    valid = np.zeros(n, bool)
    unenc = np.zeros(n, bool)
    vocab = table.vocab
    for i, adm in enumerate(adm_rows):
        if not isinstance(adm, tuple) or len(adm) < 2:
            unenc[i] = True
            continue
        info, egr = adm[0], adm[1]
        if info is not None and not isinstance(info, dict):
            unenc[i] = True
            continue
        info = info or {}
        ui = info.get('userInfo') or {}
        if not isinstance(ui, dict):
            unenc[i] = True
            continue
        username = ui.get('username', '') or ''
        g = _str_list(ui.get('groups'))
        r = _str_list(info.get('roles'))
        cr = _str_list(info.get('clusterRoles'))
        ex = _str_list(egr)
        if not isinstance(username, str) or None in (g, r, cr, ex):
            unenc[i] = True
            continue
        gid = sorted({vocab[x] for x in g if x in vocab})
        rid = sorted({vocab[x] for x in r if x in vocab})
        cid = sorted({vocab[x] for x in cr if x in vocab})
        if len(gid) > GROUPS_W or len(rid) > ROLES_W or \
                len(cid) > ROLES_W:
            unenc[i] = True
            continue
        user[i] = vocab.get(username, -1)
        groups[i, :len(gid)] = gid
        roles[i, :len(rid)] = rid
        croles[i, :len(cid)] = cid
        hasinfo[i] = 1 if info else 0
        exset = set(ex)
        excluded[i] = 1 if any(k in exset for k in g + [username]) else 0
        valid[i] = True
    if old_flags is not None:
        # UPDATE rows fold their old-object match retry on the host
        valid &= ~np.asarray(old_flags, bool)
    lanes = {'__adm_user__': user, '__adm_groups__': groups,
             '__adm_roles__': roles, '__adm_croles__': croles,
             '__adm_hasinfo__': hasinfo, '__adm_excluded__': excluded}
    return AdmissionRowPlan(lanes, valid, unenc)


def slice_lanes(lanes: Dict[str, np.ndarray], start: int, ln: int,
                padded: int) -> Dict[str, np.ndarray]:
    """One chunk's lane slice, padded to the canonical capacity (id
    lanes pad with -1 so padding rows can never match an operand)."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in lanes.items():
        part = arr[start:start + ln]
        if padded > part.shape[0]:
            fill = -1 if arr.dtype == np.int32 else 0
            pad = np.full((padded - part.shape[0],) + arr.shape[1:],
                          fill, arr.dtype)
            part = np.concatenate([part, pad])
        out[name] = part
    return out


def zero_lanes(table: AdmissionTable, padded: int) -> Dict[str, np.ndarray]:
    """The no-admission lane set (background scans, shape warm-up):
    same signature as live traffic so admission lanes never add an XLA
    shape — the device output is simply ignored (no row is ``valid``)."""
    return {
        '__admres__': np.zeros((padded, len(table.atoms)), np.uint8),
        '__adm_user__': np.full(padded, -1, np.int32),
        '__adm_groups__': np.full((padded, GROUPS_W), -1, np.int32),
        '__adm_roles__': np.full((padded, ROLES_W), -1, np.int32),
        '__adm_croles__': np.full((padded, ROLES_W), -1, np.int32),
        '__adm_hasinfo__': np.zeros(padded, np.int8),
        '__adm_excluded__': np.zeros(padded, np.int8),
    }
