"""``chip_smoke.py`` phase 12's three drills of the load generator, at a
small size on the CPU: the heterogeneous traffic (byte-equal to the
port's host loop and to the JAX package's), the chaos wave and breaker
round trip, and the policy churn under ``KTPU_PARTITIONS=4``.  On the
card the same functions run at full size with the kernel checks."""

import pytest
import yaml

import chip_smoke


@pytest.fixture
def drill_env(tmp_path, monkeypatch):
    """Caches under ``tmp_path``, no forked encoders, and the
    process-wide telemetry a drill configures torn down after it."""
    from kyverno_tpu_torch.observability import metrics, provenance
    monkeypatch.setenv('KTPU_AOT_CACHE_DIR', str(tmp_path / 'aot'))
    monkeypatch.setenv('KTPU_VERDICT_CACHE_DIR', str(tmp_path / 'vc'))
    monkeypatch.setenv('KTPU_ENCODE_PROCS', '0')
    prior = metrics.global_registry()
    yield tmp_path
    provenance.disable()
    metrics.set_global_registry(prior)


@pytest.fixture
def served(drill_env):
    _cache, handlers, server, oracle = chip_smoke.loadgen_server('cpu')
    yield handlers, server, oracle
    handlers.shutdown()


def _jax_host_loop(cluster):
    """The JAX package's host-loop webhook over phase 12's policies,
    with the same exception tenants."""
    from kyverno_tpu.api.policy import Policy
    from kyverno_tpu.policycache.cache import Cache
    from kyverno_tpu.webhooks.handlers import ResourceHandlers
    from kyverno_tpu.webhooks.server import WebhookServer
    from kyverno_tpu_torch import smokepack
    docs = [d for d in yaml.safe_load_all(smokepack.SMOKE_PACK) if d]
    for d in docs:
        d['spec']['validationFailureAction'] = 'Enforce'
    docs += [d for d in yaml.safe_load_all(smokepack.ADMISSION_LANES_PACK)
             if d]
    cache = Cache()
    cache.warm_up([Policy(d) for d in docs])
    handlers = ResourceHandlers(cache, device=False)
    return handlers, WebhookServer(handlers)


def test_heterogeneous_traffic_is_byte_equal_to_both_host_loops(served):
    from kyverno_tpu_torch.conformance.loadgen import SyntheticCluster
    handlers, server, oracle = served
    rec = chip_smoke.hetero_drill(server, handlers, oracle, (1, 8), 6,
                                  kernel_checks=False, keep=True)
    assert rec['problems'] == []
    assert [b['threads'] for b in rec['blocks']] == [1, 8]
    for b in rec['blocks']:
        assert b['mismatches'] == 0
        assert b['paths'].get('batch', 0) == \
            b['decisions'] - b['exception_decisions']
    assert rec['blocks'][1]['hetero_dispatches'] > 0
    cluster = SyntheticCluster(seed=1234)
    jax_handlers, jax_server = _jax_host_loop(cluster)
    pairs = [p for b in rec['blocks'] for p in b['responses']]
    assert len(pairs) == 6 + 48
    with chip_smoke.exception_tenants(cluster, jax_handlers):
        bad = [i for i, (review, got) in enumerate(pairs)
               if jax_server.handle('/validate/fail', review) != got]
    assert bad == []


def test_chaos_wave_and_breaker_round_trip(served):
    handlers, server, _oracle = served
    rec = chip_smoke.chaos_drill(server, handlers, threads=4, per_thread=4)
    assert rec['problems'] == []
    wave = rec['wave']
    assert (wave['non_200'], wave['verdict_mismatches']) == (0, 0)
    assert wave['poison_rows_shed'] == wave['poison_rows_injected'] == 2
    assert [s['state'] for s in rec['breaker']['states']] == \
        ['closed', 'open', 'half_open', 'closed']
    assert rec['breaker']['breaker_open_sheds'] >= 1


def test_policy_churn_hot_swaps_one_partition(drill_env, monkeypatch):
    monkeypatch.setenv('KTPU_PARTITIONS', '4')
    rec = chip_smoke.churn_drill('cpu', threads=2, per_thread=6)
    assert rec['problems'] == []
    assert rec['hot_swaps'] == 1 and rec['partition_fallbacks'] == 0
    assert rec['partitions'] == 4
    assert rec['touched'] == rec['recompiled'] and len(rec['touched']) == 1
    assert rec['enforced_after_swap'] and rec['non_200'] == 0
    assert rec['mismatches'] == 0


def test_kuttl_drill_on_the_cpu(drill_env):
    rec = chip_smoke.kuttl_drill(str(drill_env), 'cpu')
    assert rec['steps'] == 5
