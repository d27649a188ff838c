"""Leader election.

Two modes, mirroring SURVEY §2.6's mapping of the reference's
client-go lease election (reference: pkg/leaderelection/
leaderelection.go:51 New):

* **Lease mode** — lease CRs through the dynamic client, for running
  multiple replicas against a shared API server like the reference.
* **Mesh mode** — under ``torch.distributed`` the leader is rank 0 of
  the initialized process group: a single deterministic leader per
  mesh with no extra coordination traffic (the device-native
  equivalent of one elected replica driving the reconcilers).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Optional

LEASE_DURATION = 15.0   # reference: leaderelection.go LeaseDuration
RENEW_DEADLINE = 10.0
RETRY_PERIOD = 2.0


def _to_microtime(ts: float) -> str:
    """coordination.k8s.io/v1 Lease renewTime is RFC3339 MicroTime —
    client-go holders cannot parse an epoch float."""
    import datetime
    dt = datetime.datetime.fromtimestamp(ts, tz=datetime.timezone.utc)
    return dt.strftime('%Y-%m-%dT%H:%M:%S.%f') + 'Z'


def _parse_microtime(value) -> float:
    """Accept both RFC3339 MicroTime and the legacy epoch-float form."""
    if value is None or value == '':
        return 0.0
    try:
        return float(value)
    except (TypeError, ValueError):
        pass
    import datetime
    try:
        dt = datetime.datetime.strptime(str(value),
                                        '%Y-%m-%dT%H:%M:%S.%fZ')
        return dt.replace(tzinfo=datetime.timezone.utc).timestamp()
    except ValueError:
        try:
            dt = datetime.datetime.strptime(str(value),
                                            '%Y-%m-%dT%H:%M:%SZ')
            return dt.replace(tzinfo=datetime.timezone.utc).timestamp()
        except ValueError:
            return 0.0


def mesh_is_leader() -> bool:
    """Rank 0 of the initialized torch.distributed group leads
    (single-process setups are trivially the leader)."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
    except Exception:  # noqa: BLE001 - no group → standalone
        return True
    return True


class LeaderElector:
    """Lease-based election over the dynamic client."""

    def __init__(self, client, name: str, namespace: str = 'kyverno',
                 identity: Optional[str] = None,
                 on_started: Optional[Callable[[], None]] = None,
                 on_stopped: Optional[Callable[[], None]] = None):
        self.client = client
        self.name = name
        self.namespace = namespace
        self.identity = identity or f'kyverno-{uuid.uuid4().hex[:8]}'
        self.on_started = on_started
        self.on_stopped = on_stopped
        self._leading = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def is_leader(self) -> bool:
        return self._leading

    def try_acquire(self, now: Optional[float] = None) -> bool:
        """One acquire/renew attempt; returns leadership state.

        The claim is a compare-and-swap: the update carries the observed
        ``resourceVersion``, so two replicas racing on an expired lease
        cannot both win — the loser's update conflicts (409) and it
        re-reads before deciding (client-go LeaderElector semantics)."""
        now = now or time.time()
        for _attempt in range(3):
            lease = None
            try:
                lease = self.client.get_resource(
                    'coordination.k8s.io/v1', 'Lease', self.namespace,
                    self.name)
            except Exception:  # noqa: BLE001
                lease = None
            if lease is None:
                try:
                    self.client.create_resource(
                        'coordination.k8s.io/v1', 'Lease', self.namespace, {
                            'apiVersion': 'coordination.k8s.io/v1',
                            'kind': 'Lease',
                            'metadata': {'name': self.name,
                                         'namespace': self.namespace},
                            'spec': {
                                'holderIdentity': self.identity,
                                'renewTime': _to_microtime(now),
                                'leaseDurationSeconds':
                                    int(LEASE_DURATION)}})
                except Exception:  # noqa: BLE001 - lost the create race
                    continue
                self._set_leading(True)
                return True
            spec = lease.setdefault('spec', {})
            holder = spec.get('holderIdentity', '')
            renew = _parse_microtime(spec.get('renewTime'))
            expired = now - renew > LEASE_DURATION
            if not (holder == self.identity or expired or not holder):
                self._set_leading(False)
                return False
            spec['holderIdentity'] = self.identity
            spec['renewTime'] = _to_microtime(now)
            try:
                # the lease still carries the resourceVersion we read —
                # a concurrent claimant makes this raise, and we re-read
                self.client.update_resource(
                    'coordination.k8s.io/v1', 'Lease', self.namespace,
                    lease)
            except Exception:  # noqa: BLE001 - conflict: re-observe
                continue
            self._set_leading(True)
            return True
        self._set_leading(False)
        return False

    def _set_leading(self, leading: bool) -> None:
        if leading and not self._leading and self.on_started is not None:
            self.on_started()
        if not leading and self._leading and self.on_stopped is not None:
            self.on_stopped()
        self._leading = leading

    def run(self) -> None:
        def loop():
            while not self._stop.wait(RETRY_PERIOD):
                try:
                    self.try_acquire()
                except Exception:  # noqa: BLE001
                    self._set_leading(False)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def release(self) -> None:
        """Graceful shutdown releases the lease
        (reference: pkg/webhooks/server.go:213 cleanup)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._leading:
            try:
                lease = self.client.get_resource(
                    'coordination.k8s.io/v1', 'Lease', self.namespace,
                    self.name)
                if (lease.get('spec') or {}).get(
                        'holderIdentity') == self.identity:
                    lease['spec']['holderIdentity'] = ''
                    self.client.update_resource(
                        'coordination.k8s.io/v1', 'Lease', self.namespace,
                        lease)
            except Exception:  # noqa: BLE001
                pass
        self._set_leading(False)
