"""The port's admission webhook (``kyverno_tpu_torch/webhooks/``) end to
end: ``WebhookServer.handle`` on ``/validate/fail`` and ``/mutate``, in
both serving modes, with the scanners on the CPU (``torch_device='cpu'``).

Every response must be byte-identical to the JAX package's host engine
loop (``ResourceHandlers(device=False)``) on the same review.  The
handler's never-500 recovery serves a failed device path from the host
engine with the same bytes, so identity alone would not show that the
device path served: each test also reads the serving path of every
validate decision (decision provenance: ``sync`` or ``batch``, never
``host_fallback``), counts the rows the mutate scanner dispatched, and
requires that no breaker recorded a failure.
"""

import json
import random
import threading
import time

import pytest
import torch

from kyverno_tpu.api.policy import Policy as JaxPolicy
from kyverno_tpu.policycache.cache import Cache as JaxCache
from kyverno_tpu.webhooks.handlers import ResourceHandlers as JaxHandlers
from kyverno_tpu.webhooks.server import WebhookServer as JaxServer
from kyverno_tpu_torch import smokepack
from kyverno_tpu_torch.observability import provenance
from kyverno_tpu_torch.policycache import cache as pcache
from kyverno_tpu_torch.policycache.cache import Cache
from kyverno_tpu_torch.serving import breaker
from kyverno_tpu_torch.webhooks.handlers import ResourceHandlers
from kyverno_tpu_torch.webhooks.server import WebhookServer

USERS = ('alice', 'bob', 'system:serviceaccount:ci:deployer')
NAMESPACES = ('team-a', 'team-b')
READY_S = 120.0


def review(i: int, rng: random.Random) -> tuple:
    """(route, body) of review ``i``: validate for odd ``i``, mutate for
    even; a quarter UPDATEs with an ``oldObject``; 3 users, 2
    namespaces; Kyverno's default 10 s webhook timeout."""
    ns = NAMESPACES[i % 2]
    if i % 2:
        route, obj = '/validate/fail', smokepack.make_config4_pod(rng, i)
    else:
        route, obj = '/mutate', smokepack.make_mutate_pod(rng, i)
    obj['metadata']['namespace'] = ns
    req = {'uid': f'uid-{i}', 'operation': 'CREATE',
           'kind': {'group': '', 'version': 'v1', 'kind': 'Pod'},
           'resource': {'group': '', 'version': 'v1', 'resource': 'pods'},
           'namespace': ns, 'name': obj['metadata']['name'], 'object': obj,
           'userInfo': {'username': USERS[i % 3], 'groups': []},
           'timeoutSeconds': 10}
    if i % 4 == 3:
        old = json.loads(json.dumps(obj))
        old['metadata'].setdefault('labels', {})['rev'] = 'old'
        req['operation'] = 'UPDATE'
        req['oldObject'] = old
    return route, json.dumps({'apiVersion': 'admission.k8s.io/v1',
                              'kind': 'AdmissionReview',
                              'request': req}).encode()


def policy_docs():
    import yaml
    docs = [d for d in yaml.safe_load_all(smokepack.SMOKE_PACK) if d]
    for d in docs:
        d['spec']['validationFailureAction'] = 'Enforce'
    return docs + [d for d in yaml.safe_load_all(smokepack.MUTATE_PACK)
                   if d]


@pytest.fixture(scope='module')
def chains(tmp_path_factory):
    """The port's handler chain on the CPU with both scanners built, the
    JAX package's host-loop chain over the same policies, and counters
    of the port's device paths."""
    from kyverno_tpu_torch.api.policy import Policy
    docs = policy_docs()
    cache = Cache()
    cache.warm_up([Policy(json.loads(json.dumps(d))) for d in docs])
    handlers = ResourceHandlers(cache, torch_device='cpu',
                                serving_mode='sync')
    server = WebhookServer(handlers)
    jcache = JaxCache()
    jcache.warm_up([JaxPolicy(json.loads(json.dumps(d))) for d in docs])
    oracle = JaxServer(JaxHandlers(jcache, device=False))

    validate = cache.get_policies(pcache.VALIDATE_ENFORCE, 'Pod',
                                  NAMESPACES[0])
    mutate = cache.get_policies(pcache.MUTATE, 'Pod', NAMESPACES[0])
    assert handlers.wait_device_ready(validate, timeout=READY_S)
    deadline = time.monotonic() + READY_S
    msc = None
    while msc is None and time.monotonic() < deadline:
        msc = handlers._device_scanner(mutate, kind='mutate')
        time.sleep(0.02)
    assert msc is not None and msc.ok

    counts = {'mutate_rows': 0, 'breaker_failures': []}
    scan = msc.scan

    def counting_scan(resources, *args, **kwargs):
        counts['mutate_rows'] += len(resources)
        return scan(resources, *args, **kwargs)

    msc.scan = counting_scan
    record_failure = handlers._record_key_failure

    def counting_failure(key, policies, reason):
        counts['breaker_failures'].append(reason)
        return record_failure(key, policies, reason)

    handlers._record_key_failure = counting_failure
    rec = provenance.configure(
        flight_n=4096, dump_dir=str(tmp_path_factory.mktemp('flight')))
    yield {'server': server, 'handlers': handlers, 'oracle': oracle,
           'counts': counts, 'recorder': rec,
           'keys': [handlers._policy_key(validate),
                    handlers._policy_key(mutate)]}
    provenance.disable()
    handlers.shutdown()


def _check_paths(chains, want_path, n_validate, n_mutate):
    rec, counts = chains['recorder'], chains['counts']
    paths = [r.path for r in rec.records()]
    assert paths == [want_path] * n_validate
    assert counts['mutate_rows'] == n_mutate
    assert counts['breaker_failures'] == []
    brk = chains['handlers']._breakers
    assert all(brk.state(k) == breaker.CLOSED for k in chains['keys'])


def test_sync_responses_equal_host_loop(chains):
    server, oracle = chains['server'], chains['oracle']
    chains['handlers'].serving_mode = 'sync'
    chains['recorder'].reset()
    chains['counts']['mutate_rows'] = 0
    rng = random.Random(11)
    reviews = [review(i, rng) for i in range(40)]
    for route, body in reviews:
        assert server.handle(route, body) == oracle.handle(route, body), \
            json.loads(body)['request']['uid']
    _check_paths(chains, 'sync', 20, 20)


def test_batch_responses_equal_host_loop(chains, monkeypatch):
    # a CPU run under several test workers can take more than the
    # default 500 ms per dispatch; the deadline is not under test here
    monkeypatch.setenv('KTPU_SHED_DEADLINE_MS', '5000')
    handlers = chains['handlers']
    handlers.serving_mode = 'batch'
    chains['recorder'].reset()
    chains['counts']['mutate_rows'] = 0
    rng = random.Random(12)
    reviews = [review(i, rng) for i in range(40)]
    got = [None] * len(reviews)
    barrier = threading.Barrier(8)

    def client(t):
        barrier.wait(timeout=30)
        for j in range(t, len(reviews), 8):
            got[j] = chains['server'].handle(*reviews[j])

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for (route, body), g in zip(reviews, got):
        assert g == chains['oracle'].handle(route, body), \
            json.loads(body)['request']['uid']
    _check_paths(chains, 'batch', 20, 20)
    stats = handlers._get_batcher().stats()
    assert stats['shed_total'] == 0
    assert stats['requests'] == 40


def test_handlers_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cache = Cache()
    with pytest.raises(RuntimeError, match='CUDA'):
        ResourceHandlers(cache)
    # the host loop needs no card
    assert ResourceHandlers(cache, device=False).torch_device is None


# ---------------------------------------------------------------------------
# policy churn: the successor scanner replaces the live one


def _wait_scanner(handlers, policies, kind):
    """The live ``kind`` scanner of ``policies`` once its build thread,
    the hot-swap included, has finished."""
    key = (kind,) + handlers._policy_key(policies)
    deadline = time.monotonic() + READY_S
    while time.monotonic() < deadline:
        scanner = handlers._device_scanner(policies, kind=kind)
        with handlers._scanner_lock:
            building = key in handlers._building
        if scanner is not None and not building:
            return key, scanner
        time.sleep(0.02)
    raise AssertionError(f'the {kind} scanner did not come up')


def test_policy_change_hot_swaps_without_breaker_failures(tmp_path):
    """Editing a validate and a mutate policy builds successor scanners
    that replace the live ones (the handler's scanner hot-swap, logged
    in the partition census).  No breaker records a failure, and the
    edited set is served on the device path with the bytes of the JAX
    package's host loop over the same edited policies."""
    from kyverno_tpu_torch.api.policy import Policy
    from kyverno_tpu_torch.partition import census
    docs = policy_docs()
    cache = Cache()
    cache.warm_up([Policy(json.loads(json.dumps(d))) for d in docs])
    handlers = ResourceHandlers(cache, torch_device='cpu',
                                serving_mode='sync')
    failures = []
    record_failure = handlers._record_key_failure

    def counting_failure(key, policies, reason):
        failures.append(reason)
        return record_failure(key, policies, reason)

    handlers._record_key_failure = counting_failure
    types = {'validate': pcache.VALIDATE_ENFORCE, 'mutate': pcache.MUTATE}
    census.reset()
    rec = provenance.configure(flight_n=64, dump_dir=str(tmp_path))
    try:
        old = {kind: _wait_scanner(handlers, cache.get_policies(
            ptype, 'Pod', NAMESPACES[0]), kind)[0]
            for kind, ptype in types.items()}
        edited = json.loads(json.dumps(docs))
        for kind in types:
            doc = next(d for d in edited if any(
                kind in r for r in d['spec']['rules']))
            doc['metadata'].setdefault('annotations', {})[
                'policies.kyverno.io/description'] = 'edited'
            cache.set(doc['metadata']['name'], Policy(doc))
        new = {kind: _wait_scanner(handlers, cache.get_policies(
            ptype, 'Pod', NAMESPACES[0]), kind)[0]
            for kind, ptype in types.items()}
        assert failures == []
        for kind in types:
            assert old[kind] != new[kind]
            assert old[kind] not in handlers._scanners
            assert new[kind] in handlers._scanners
            assert handlers._breakers.state(new[kind][1:]) == \
                breaker.CLOSED
        assert sorted(s['kind'] for s in census._swaps) == \
            ['mutate', 'validate']

        jcache = JaxCache()
        jcache.warm_up([JaxPolicy(d) for d in edited])
        oracle = JaxServer(JaxHandlers(jcache, device=False))
        server = WebhookServer(handlers)
        rng = random.Random(13)
        rec.reset()
        for i in range(8):
            route, body = review(2 * i + (i % 2), rng)
            assert server.handle(route, body) == \
                oracle.handle(route, body), route
        assert [r.path for r in rec.records()] == ['sync'] * 4
        assert failures == []
    finally:
        provenance.disable()
        census.reset()
        handlers.shutdown()


def test_partition_plan_equals_jax():
    """The port's partition plan (grouping and fingerprints, which the
    hot-swap's churn differ compares) is the JAX package's, but that each
    partition's fingerprint digests what the engine reads of its members
    (``aotcache/keys.py policy_semantics``), where the JAX key digests
    their raw documents."""
    from kyverno_tpu.partition import plan as jax_plan
    from kyverno_tpu_torch.aotcache.keys import policy_semantics
    from kyverno_tpu_torch.api.policy import Policy
    from kyverno_tpu_torch.partition import plan
    from kyverno_tpu_torch.partition.keys import partition_fingerprint
    docs = policy_docs()

    def shape(partitions):
        return [{k: v for k, v in p.to_dict().items() if k != 'fingerprint'}
                for p in partitions]
    for n_parts in (1, 3, 8):
        got = plan.build_plan([Policy(d) for d in docs], n_parts)
        want = jax_plan.build_plan([JaxPolicy(d) for d in docs], n_parts)
        assert got.assignment == want.assignment
        assert shape(got.partitions) == shape(want.partitions)
        for part in got.partitions:
            members = [docs[i] for i in part.policy_indices]
            assert part.fingerprint == partition_fingerprint(
                [Policy(d) for d in members])
            # a status write leaves it as it was
            stamped = [dict(d, status={'ready': True}) for d in members]
            assert [policy_semantics(d) for d in stamped] == \
                [policy_semantics(d) for d in members]
            assert part.fingerprint == partition_fingerprint(
                [Policy(d) for d in stamped])
    edited = json.loads(json.dumps(docs))
    edited[0]['spec']['rules'][0]['name'] += '-edited'
    diff = plan.diff_plans(plan.build_plan([Policy(d) for d in docs], 3),
                           plan.build_plan([Policy(d) for d in edited], 3))
    assert len(diff.touched) == 1
