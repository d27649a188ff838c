"""Pre-install init job (reference: cmd/kyverno-init/main.go): removes
stale webhook configurations, health leases and old report CRs left by a
previous deployment so a fresh install starts clean."""

from __future__ import annotations

from typing import List, Optional

from ..controllers.webhook import LEASE_NAME, MUTATING_NAME, VALIDATING_NAME
from .internal import Setup, base_parser

_REPORT_KINDS = (
    ('kyverno.io/v1alpha2', 'AdmissionReport'),
    ('kyverno.io/v1alpha2', 'ClusterAdmissionReport'),
    ('kyverno.io/v1alpha2', 'BackgroundScanReport'),
    ('kyverno.io/v1alpha2', 'ClusterBackgroundScanReport'),
)


def cleanup_stale_state(client, namespace: str = 'kyverno') -> int:
    removed = 0
    for kind, name in (('ValidatingWebhookConfiguration', VALIDATING_NAME),
                       ('MutatingWebhookConfiguration', MUTATING_NAME)):
        try:
            client.delete_resource('admissionregistration.k8s.io/v1',
                                   kind, '', name)
            removed += 1
        except Exception:  # noqa: BLE001
            pass
    try:
        client.delete_resource('coordination.k8s.io/v1', 'Lease',
                               namespace, LEASE_NAME)
        removed += 1
    except Exception:  # noqa: BLE001
        pass
    for api_version, kind in _REPORT_KINDS:
        try:
            for report in client.list_resource(api_version, kind, '', None):
                meta = report.get('metadata') or {}
                client.delete_resource(api_version, kind,
                                       meta.get('namespace', ''),
                                       meta.get('name', ''))
                removed += 1
        except Exception:  # noqa: BLE001
            continue
    return removed


def main(args: Optional[List[str]] = None) -> int:
    setup = Setup('kyverno-init', args, base_parser('kyverno-init'))
    removed = cleanup_stale_state(setup.client, setup.options.namespace)
    setup.logger.info('cleaned %d stale objects', removed)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
