"""Background-controller daemon (reference:
cmd/background-controller/main.go): drains UpdateRequests through the
generate / mutate-existing processors and runs the policy lifecycle
controller."""

from __future__ import annotations

from typing import List, Optional

from ..background.update_request_controller import UpdateRequestController
from ..controllers.leaderelection import mesh_is_leader
from ..policy.controller import PolicyController
from .internal import Setup, base_parser


class BackgroundController:
    def __init__(self, setup: Setup):
        self.setup = setup
        from ..engine.apicall import make_context_loader
        from ..engine.engine import Engine
        engine = Engine(context_loader=make_context_loader(
            dclient=setup.client))
        self.ur_controller = UpdateRequestController(
            setup.client, engine,
            policy_getter=self._get_policy)
        self.policy_controller = PolicyController(setup.client)
        self._seen_policies: dict = {}

    def _get_policy(self, key: str):
        from ..background.common import get_policy
        try:
            return get_policy(self.setup.client, key)
        except Exception:  # noqa: BLE001 - deleted policy
            return None

    def tick(self) -> None:
        if not mesh_is_leader():
            return
        # policy lifecycle events from the stored CRs
        current = {}
        for api_version in ('kyverno.io/v1', 'kyverno.io/v2beta1'):
          for kind in ('ClusterPolicy', 'Policy'):
            try:
                for doc in self.setup.client.list_resource(
                        api_version, kind, '', None):
                    meta = doc.get('metadata') or {}
                    key = f"{meta.get('namespace', '')}/{meta.get('name')}"
                    current[key] = doc
            except Exception:  # noqa: BLE001
                continue
        for key, doc in current.items():
            old = self._seen_policies.get(key)
            if old is None:
                self.policy_controller.add_policy(doc)
            elif old != doc:
                self.policy_controller.update_policy(old, doc)
        for key, doc in list(self._seen_policies.items()):
            if key not in current:
                self.policy_controller.delete_policy(doc)
        self._seen_policies = current
        # drain pending UpdateRequests
        self.ur_controller.process_pending()

    def run(self) -> None:
        self.setup.install_signal_handlers()
        self.setup.run_until_stopped(self.tick, interval=2.0)


def main(args: Optional[List[str]] = None) -> int:
    setup = Setup('kyverno-background-controller', args,
                  base_parser('kyverno-background-controller'))
    BackgroundController(setup).run()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
