"""Reports-controller daemon (reference: cmd/reports-controller/main.go)
— the batch-scan path the CUDA card accelerates: resource metadata
sync → device-batched background scan → admission-report dedup →
PolicyReport aggregation."""

from __future__ import annotations

from typing import List, Optional

from ..api.policy import Policy
from ..controllers.leaderelection import mesh_is_leader
from ..reports.aggregate import AggregateController
from ..reports.controllers import (AdmissionReportController,
                                   BackgroundScanController, MetadataCache,
                                   ResourceController)
from .internal import Setup, base_parser


class ReportsController:
    """The daemon's tick over ``setup.client``; its scans run on
    ``device`` (default: the CUDA card; raises without one — pass
    ``device='cpu'`` for the host)."""

    def __init__(self, setup: Setup, device=None):
        self.setup = setup
        self.cache = MetadataCache()
        self.resource_controller = ResourceController(setup.client,
                                                      self.cache)
        self.scan_controller = BackgroundScanController(
            setup.client, [], cache=self.cache, device=device)
        self.admission_controller = AdmissionReportController(setup.client)
        self.aggregate_controller = AggregateController(setup.client)
        self._policy_snapshot = None
        # persist the verdict cache on shutdown so the next process
        # restarts its background rescans at O(churn), not O(cluster)
        setup.register_shutdown(self.scan_controller.close)

    def _policies(self) -> List[Policy]:
        docs = []
        # policy CRDs are multi-version served (v1 storage, v2beta1
        # conversion-identical for the fields the engine reads)
        for api_version in ('kyverno.io/v1', 'kyverno.io/v2beta1'):
            for kind in ('ClusterPolicy', 'Policy'):
                try:
                    docs += self.setup.client.list_resource(
                        api_version, kind, '', None)
                except Exception:  # noqa: BLE001
                    continue
        return [Policy(d) for d in docs]

    def tick(self) -> None:
        if not mesh_is_leader():
            return
        policies = self._policies()
        snapshot = [p.raw for p in policies]
        if snapshot != self._policy_snapshot:
            self._policy_snapshot = snapshot
            self.resource_controller.update_policies(policies)
            self.scan_controller.set_policies(policies)
            # fork the new scanner's encode workers here, between
            # reconciles on the tick thread, rather than lazily inside
            # its first multi-chunk scan: this process holds a CUDA
            # context, and the workers never touch it
            self.scan_controller.scanner.start_encoder_pool()
            self.scan_controller.enqueue_all()
        for changed in self.resource_controller.sync():
            self.scan_controller.enqueue(changed)
        self.scan_controller.reconcile()
        self.admission_controller.reconcile()
        self.aggregate_controller.reconcile()

    def run(self) -> None:
        self.setup.install_signal_handlers()
        self.setup.run_until_stopped(self.tick, interval=2.0)


def main(args: Optional[List[str]] = None) -> int:
    setup = Setup('kyverno-reports-controller', args,
                  base_parser('kyverno-reports-controller'))
    ReportsController(setup).run()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
