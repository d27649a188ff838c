"""APICall / ServiceCall context-entry execution.

Mirrors the reference's apicall package (reference:
pkg/engine/apicall/apiCall.go:31-160): ``urlPath`` entries GET the K8s
API server through the dynamic client's raw path; ``service`` entries
issue GET/POST HTTP requests (bearer token from the projected service
account token, optional CA bundle), and results are JMESPath-transformed
before landing in the JSON context.

Transports are injectable so policies relying on API calls stay
hermetically testable; the defaults use urllib against live endpoints.
"""

from __future__ import annotations

import json
import ssl
import tempfile
from typing import Any, Callable, Optional

from . import variables as vars_mod
from .context import Context, ContextError
from .jmespath import compile as jp_compile

TOKEN_PATH = '/var/run/secrets/tokens/api-token'


def default_http_transport(method: str, url: str, headers: dict,
                           body: Optional[bytes],
                           ca_bundle: str = '') -> bytes:
    """reference: apiCall.go:83-126 executeServiceCall"""
    import urllib.request
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in headers.items():
        req.add_header(k, v)
    ctx = None
    if ca_bundle:
        ctx = ssl.create_default_context()
        with tempfile.NamedTemporaryFile('w', suffix='.pem') as f:
            f.write(ca_bundle)
            f.flush()
            ctx.load_verify_locations(f.name)
    with urllib.request.urlopen(req, context=ctx, timeout=30) as resp:
        if not (200 <= resp.status < 300):
            raise ContextError(f'HTTP {resp.status}: {resp.reason}')
        return resp.read()


def default_token_reader() -> str:
    try:
        with open(TOKEN_PATH) as f:
            return f.read().strip()
    except OSError:
        return ''


class APICallExecutor:
    """Executes one ``apiCall`` context entry
    (reference: apiCall.go:45 Execute)."""

    def __init__(self, raw_abs_path: Optional[Callable[[str], bytes]] = None,
                 http_transport: Callable = default_http_transport,
                 token_reader: Callable[[], str] = default_token_reader):
        self.raw_abs_path = raw_abs_path
        self.http_transport = http_transport
        self.token_reader = token_reader

    def __call__(self, entry: dict, ctx: Context) -> Any:
        name = entry.get('name', '')
        call = vars_mod.substitute_all(ctx, entry.get('apiCall') or {})
        data = self._execute(name, call)
        return self._transform(name, call, ctx, data)

    def _execute(self, name: str, call: dict) -> bytes:
        url_path = call.get('urlPath', '')
        if url_path:
            # reference: apiCall.go:72 executeK8sAPICall (RawAbsPath)
            if self.raw_abs_path is None:
                raise ContextError(
                    f'failed to load context entry {name}: no cluster '
                    f'client for urlPath {url_path}')
            try:
                return self.raw_abs_path(url_path)
            except Exception as e:  # noqa: BLE001
                raise ContextError(
                    f'failed to get resource with raw url\n: {url_path}: '
                    f'{e}')
        service = call.get('service')
        if not service:
            raise ContextError(f'missing service for APICall {name}')
        method = service.get('method', 'GET') or 'GET'
        headers = {}
        token = self.token_reader()
        if token:
            headers['Authorization'] = f'Bearer {token}'
        body = None
        if method == 'POST':
            data_map = {d.get('key'): d.get('value')
                        for d in call.get('data') or []}
            body = json.dumps(data_map).encode('utf-8')
            headers['Content-Type'] = 'application/json'
        elif method != 'GET':
            raise ContextError(
                f'invalid request type {method} for APICall {name}')
        try:
            return self.http_transport(method, service.get('url', ''),
                                       headers, body,
                                       service.get('caBundle', ''))
        except ContextError:
            raise
        except Exception as e:  # noqa: BLE001
            raise ContextError(
                f'failed to execute HTTP request for APICall {name}: {e}')

    def _transform(self, name: str, call: dict, ctx: Context,
                   data: bytes) -> Any:
        """reference: apiCall.go:186 transformAndStore"""
        try:
            parsed = json.loads(data)
        except ValueError as e:
            raise ContextError(
                f'failed to parse JSON response for APICall {name}: {e}')
        # the whole apiCall dict was already variable-substituted in
        # __call__; the path is final here
        path = call.get('jmesPath', '')
        if not path:
            return parsed
        try:
            result = jp_compile(str(path)).search(parsed)
        except Exception as e:  # noqa: BLE001
            raise ContextError(
                f'failed to apply JMESPath {path} for APICall {name}: {e}')
        return result


def make_context_loader(dclient=None, registry_client=None,
                        http_transport: Callable = default_http_transport,
                        token_reader: Callable[[], str] =
                        default_token_reader,
                        cm_resolver: Optional[Callable] = None):
    """Build a fully-wired engine ContextLoader: ConfigMap resolution via
    the dynamic client, APICall/ServiceCall via the HTTP transport,
    imageRegistry via the registry client
    (reference: pkg/engine/jsonContext.go:23 ContextLoaderFactory)."""
    from .engine import ContextLoader
    raw = None
    if dclient is not None and hasattr(dclient, 'raw_abs_path'):
        raw = dclient.raw_abs_path
    api_call = APICallExecutor(raw_abs_path=raw,
                               http_transport=http_transport,
                               token_reader=token_reader)
    if cm_resolver is None and dclient is not None:
        def cm_resolver(name, namespace):  # noqa: F811
            return dclient.get_resource('v1', 'ConfigMap', namespace, name)
    image_data = None
    if registry_client is not None:
        def image_data(entry, ctx):  # noqa: F811
            return fetch_image_data(entry, ctx, registry_client)
    return ContextLoader(configmap_resolver=cm_resolver,
                         api_call=api_call,
                         image_data=image_data)


def fetch_image_data(entry: dict, ctx: Context, rclient) -> Any:
    """``imageRegistry`` context entries: fetch image metadata from the
    registry client (reference: pkg/engine/jsonContext.go:189-283
    fetchImageData / fetchImageDataMap)."""
    from ..utils.image import get_image_info
    spec = entry.get('imageRegistry') or {}
    ref = vars_mod.substitute_all(ctx, spec.get('reference', ''))
    if not isinstance(ref, str):
        raise ContextError(
            f'invalid image reference {ref}, image reference must be '
            f'a string')
    path = vars_mod.substitute_all(ctx, spec.get('jmesPath', '') or '')
    try:
        desc = rclient.fetch_image_descriptor(ref)
    except Exception as e:  # noqa: BLE001 - registry failure → rule error
        raise ContextError(
            f'failed to fetch image descriptor for {ref}: {e}')
    try:
        info = get_image_info(ref)
    except ValueError as e:
        raise ContextError(str(e))
    manifest = {}
    config_data = {}
    try:
        if hasattr(rclient, 'get_manifest'):
            manifest = rclient.get_manifest(ref)
        if hasattr(rclient, 'get_config'):
            config_data = rclient.get_config(ref)
    except Exception as e:  # noqa: BLE001
        raise ContextError(
            f'failed to fetch image metadata for {ref}: {e}')
    repo_name = f'{info.registry}/{info.path}' if info.registry \
        else info.path
    data = {
        'image': ref,
        'resolvedImage': f'{repo_name}@{desc.digest}',
        'registry': info.registry,
        'repository': info.path,
        'identifier': info.digest or info.tag,
        'manifest': manifest,
        'configData': config_data,
    }
    if path:
        try:
            return jp_compile(str(path)).search(data)
        except Exception as e:  # noqa: BLE001
            raise ContextError(
                f'failed to apply JMESPath ({path}) results to context '
                f'entry {entry.get("name", "")}, error: {e}')
    return data
