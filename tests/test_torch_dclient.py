"""The port's API clients (``kyverno_tpu_torch/dclient/``): every case of
the dclient contract suite (``tests/test_dclient_contract.py``) run on
the port's ``FakeClient`` and on its ``HTTPClient`` over its
``FakeApiServer``; one request sequence against the JAX package's
server and the port's, through plain HTTP and through each package's
``HTTPClient``; the in-memory client's lazy ``labelSelector`` route;
and the verbs that name a kind without its apiVersion, which the
port's ``HTTPClient`` resolves as the in-memory client does.
"""

import contextlib
import copy
import http.client
import inspect
import json
import os
import re
import types
from urllib.parse import quote

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CONTRACT_PATH = os.path.join(HERE, 'test_dclient_contract.py')

#: metadata the fake API server stamps per object
STAMPED = ('uid', 'resourceVersion', 'creationTimestamp', 'generation',
           'managedFields')


def _contract_on_the_port():
    """The contract suite's module, its imports of the JAX package
    pointed at the port."""
    src = open(CONTRACT_PATH, encoding='utf-8').read()
    src = re.sub(r'\bfrom kyverno_tpu\.', 'from kyverno_tpu_torch.', src)
    mod = types.ModuleType('dclient_contract_on_the_port')
    mod.__file__ = CONTRACT_PATH
    exec(compile(src, CONTRACT_PATH, 'exec'), mod.__dict__)
    return mod


CONTRACT = _contract_on_the_port()


def _contract_cases():
    out = []
    for cname, cls in sorted(vars(CONTRACT).items()):
        if not (cname.startswith('Test') and isinstance(cls, type)):
            continue
        for name in sorted(vars(cls)):
            if not name.startswith('test_'):
                continue
            params = inspect.signature(getattr(cls, name)).parameters
            kinds = ('fake', 'http') if 'client' in params else (None,)
            out += [(cname, name, kind) for kind in kinds]
    return out


CONTRACT_CASES = _contract_cases()


@contextlib.contextmanager
def _port_client(kind):
    from kyverno_tpu_torch.dclient.client import FakeClient
    from kyverno_tpu_torch.dclient.fakeserver import FakeApiServer
    from kyverno_tpu_torch.dclient.http_client import (ClusterConfig,
                                                       HTTPClient)
    if kind == 'fake':
        yield FakeClient()
        return
    with FakeApiServer() as srv:
        client = HTTPClient(ClusterConfig(server=srv.url))
        try:
            yield client
        finally:
            client.close()


def test_the_contract_suite_runs_on_the_port():
    """The suite's names resolve to the port's modules, and every one of
    its cases is collected below."""
    for name in ('FakeClient', 'FakeApiServer', 'HTTPClient',
                 'NotFoundError'):
        assert getattr(CONTRACT, name).__module__.startswith(
            'kyverno_tpu_torch.dclient.'), name
    assert len(CONTRACT_CASES) >= 37


@pytest.mark.parametrize('cls,name,kind', CONTRACT_CASES,
                         ids=[f'{c}.{n}' + (f'[{k}]' if k else '')
                              for c, n, k in CONTRACT_CASES])
def test_contract_case_on_the_port(cls, name, kind, tmp_path):
    method = getattr(getattr(CONTRACT, cls)(), name)
    params = inspect.signature(method).parameters
    kwargs = {}
    if 'tmp_path' in params:
        kwargs['tmp_path'] = tmp_path
    if kind is None:
        method(**kwargs)
        return
    with _port_client(kind) as client:
        method(client=client, **kwargs)


# ---------------------------------------------------------------------------
# one request sequence, two servers


def _pod(name, labels=None, rv=None):
    meta = {'name': name, 'namespace': 'default'}
    if labels:
        meta['labels'] = labels
    if rv:
        meta['resourceVersion'] = rv
    return {'apiVersion': 'v1', 'kind': 'Pod', 'metadata': meta,
            'spec': {'containers': [{'name': 'c', 'image': 'i'}]}}


PODS = '/api/v1/namespaces/default/pods'
SEQUENCE = [
    ('GET', '/api/v1', None),
    ('GET', '/apis/networking.k8s.io/v1', None),
    ('POST', PODS, _pod('a', {'color': 'red'})),
    ('POST', PODS, _pod('b', {'color': 'blue'})),
    ('POST', PODS, _pod('a')),
    ('POST', PODS + '?dryRun=All', _pod('c')),
    ('GET', PODS + '/a', None),
    ('GET', PODS + '/c', None),
    ('GET', PODS + '?labelSelector=' + quote('color=red'), None),
    ('GET', PODS + '?labelSelector=' + quote('color notin (red)'), None),
    ('GET', '/api/v1/pods', None),
    ('PUT', PODS + '/a', _pod('a', {'color': 'green'}, rv='1')),
    ('PUT', PODS + '/a', _pod('a', {'color': 'green'}, rv='99')),
    ('PUT', PODS + '/ghost', _pod('ghost')),
    ('PUT', PODS + '/b/status', dict(_pod('b', rv='2'),
                                     status={'phase': 'Running'})),
    ('PATCH', PODS + '/a', [{'op': 'add', 'path': '/metadata/annotations',
                             'value': {'patched': 'yes'}}]),
    ('POST', '/api/v1/namespaces', {'apiVersion': 'v1', 'kind': 'Namespace',
                                    'metadata': {'name': 'team-a'}}),
    ('GET', '/api/v1/namespaces/team-a', None),
    ('POST', '/apis/authorization.k8s.io/v1/selfsubjectaccessreviews',
     {'apiVersion': 'authorization.k8s.io/v1',
      'kind': 'SelfSubjectAccessReview',
      'spec': {'resourceAttributes': {'verb': 'delete',
                                      'resource': 'pods'}}}),
    ('GET', '/apis/unknown.io/v1/things', None),
    ('DELETE', PODS + '/a', None),
    ('DELETE', PODS + '/a', None),
    ('DELETE', PODS + '/b?dryRun=All', None),
    ('GET', PODS, None),
]


def _strip(doc):
    """``doc`` without the stamps of the server, at any depth."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if not (k in STAMPED and isinstance(doc.get('name'), str))}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _exchange(url, method, path, body):
    host, port = url[len('http://'):].split(':')
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        data = None if body is None else json.dumps(body).encode()
        headers = {'Content-Type': 'application/json'} if data else {}
        conn.request(method, path, body=data, headers=headers)
        resp = conn.getresponse()
        return resp.status, _strip(json.loads(resp.read()))
    finally:
        conn.close()


def _run_sequence(package):
    import importlib
    server = importlib.import_module(f'{package}.dclient.fakeserver')
    with server.FakeApiServer() as srv:
        return [_exchange(srv.url, m, p, copy.deepcopy(b))
                for m, p, b in SEQUENCE]


def test_the_servers_answer_one_sequence_alike():
    want = _run_sequence('kyverno_tpu')
    got = _run_sequence('kyverno_tpu_torch')
    assert [c for c, _b in got] == [c for c, _b in want]
    assert {c for c, _b in got} >= {200, 201, 404, 409}
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, SEQUENCE[i][:2]


def _client_verbs(package):
    """The sequence's verbs through ``package``'s ``HTTPClient``: each
    result, or the name of the error class it raised and its message."""
    import importlib
    server = importlib.import_module(f'{package}.dclient.fakeserver')
    http_client = importlib.import_module(f'{package}.dclient.http_client')
    out = []
    with server.FakeApiServer() as srv:
        c = http_client.HTTPClient(
            http_client.ClusterConfig(server=srv.url))
        calls = [
            lambda: c.create_resource('v1', 'Pod', 'default',
                                      _pod('a', {'color': 'red'})),
            lambda: c.create_resource('v1', 'Pod', 'default', _pod('a')),
            lambda: c.get_resource('v1', 'Pod', 'default', 'a'),
            lambda: c.get_resource('v1', 'Pod', 'default', 'nope'),
            lambda: c.list_resource('v1', 'Pod', 'default',
                                    {'matchLabels': {'color': 'red'}}),
            lambda: c.update_resource('v1', 'Pod', 'default',
                                      _pod('a', rv='7')),
            lambda: c.update_status_resource(
                'v1', 'Pod', 'default',
                dict(_pod('a', rv='1'), status={'phase': 'Running'})),
            lambda: c.patch_resource('v1', 'Pod', 'default', 'a', [
                {'op': 'add', 'path': '/metadata/labels/x',
                 'value': 'y'}]),
            lambda: c.create_access_review({'verb': 'get',
                                            'resource': 'pods'}),
            lambda: c.get_namespace_labels('ghost'),
            lambda: c.delete_resource('v1', 'Pod', 'default', 'a'),
            lambda: c.delete_resource('v1', 'Pod', 'default', 'a'),
        ]
        for call in calls:
            try:
                out.append(_strip(call()))
            except Exception as e:  # noqa: BLE001 - compared by class
                out.append((type(e).__name__, str(e)))
        c.close()
    return out


def test_the_clients_run_one_sequence_alike():
    want = _client_verbs('kyverno_tpu')
    got = _client_verbs('kyverno_tpu_torch')
    assert got == want
    assert ('ConflictError' in {g[0] for g in got if isinstance(g, tuple)})


# ---------------------------------------------------------------------------
# the in-memory client's labelSelector route, and kind-only verbs


@pytest.mark.parametrize('selector', ['color=red', 'color in (red,green)',
                                      '!color', 'color'])
def test_raw_list_with_a_label_selector_resolves(selector):
    """``FakeClient.raw_abs_path`` parses a ``labelSelector`` with the
    server's parser (a reach into ``fakeserver.py``, now ported): the
    same items as the JAX package's client."""
    from kyverno_tpu.dclient.client import FakeClient as JaxClient
    from kyverno_tpu_torch.dclient.client import FakeClient
    path = f'{PODS}?labelSelector={quote(selector)}'
    out = []
    for cls in (JaxClient, FakeClient):
        client = cls()
        for name, labels in (('red', {'color': 'red'}),
                             ('blue', {'color': 'blue'}), ('plain', None)):
            client.create_resource('v1', 'Pod', 'default',
                                   _pod(name, labels))
        out.append(json.loads(client.raw_abs_path(path)))
    assert out[1] == out[0] and out[1]['items']


@pytest.mark.parametrize('kind', ['fake', 'http'])
def test_kind_only_verbs_name_any_version(kind):
    """An empty apiVersion names the kind at any version, over HTTP as in
    memory: the reports and cleanup daemons list by kind alone."""
    with _port_client(kind) as client:
        client.create_resource('v1', 'Pod', 'default', _pod('a'))
        client.create_resource('v1', 'ConfigMap', 'default', {
            'apiVersion': 'v1', 'kind': 'ConfigMap',
            'metadata': {'name': 'cm', 'namespace': 'default'}})
        assert [p['metadata']['name']
                for p in client.list_resource('', 'Pod', '', None)] == ['a']
        assert [p['metadata']['name'] for p in client.list_resource(
            '', 'ConfigMap', 'default', None)] == ['cm']
        assert client.get_resource('', 'Pod', 'default', 'a')['kind'] == \
            'Pod'
        client.delete_resource('', 'ConfigMap', 'default', 'cm')
        assert client.list_resource('', 'ConfigMap', '', None) == []


def test_the_reference_client_lists_nothing_by_kind_over_http():
    """The fault the port's ``HTTPClient`` repairs: the JAX package's
    writes ``/api//pods`` for a kind-only list, which its own server
    answers 404, so its reports daemon over HTTP sees no Pod."""
    from kyverno_tpu.dclient.client import NotFoundError
    from kyverno_tpu.dclient.fakeserver import FakeApiServer
    from kyverno_tpu.dclient.http_client import ClusterConfig, HTTPClient
    with FakeApiServer() as srv:
        srv.store.create_resource('v1', 'Pod', 'default', _pod('a'))
        client = HTTPClient(ClusterConfig(server=srv.url))
        with pytest.raises(NotFoundError, match='/api//pods'):
            client.list_resource('', 'Pod', '', None)
        client.close()
