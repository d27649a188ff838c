"""Plain reference of ``packs/best_practice.yaml``: kyverno/policies'
``disallow-latest-tag`` and ``require-requests-limits``, Kyverno validate
patterns over
``spec.containers``.  A pattern over a list fails at its first element
that does not match, and the message names that element's path."""

from __future__ import annotations


def _pattern_fail(message: str, rule: str, path: str):
    if not message.endswith('.'):
        message += '.'
    return 'fail', f'validation error: {message} rule {rule} failed at ' \
        f'path {path}'


def _passed(rule: str):
    return 'pass', f"validation rule '{rule}' passed."


def _first_container(pod: dict, bad) -> int:
    for k, c in enumerate(pod['spec'].get('containers') or []):
        if bad(c):
            return k
    return -1


def _image_rule(rule: str, message: str, bad):
    def evaluate(ctx):
        k = _first_container(ctx.pod, lambda c: bad(c.get('image', '')))
        if k < 0:
            return _passed(rule)
        return _pattern_fail(message, rule, f'/spec/containers/{k}/image/')
    return evaluate


def require_requests_limits(ctx):
    def bad(c):
        res = c.get('resources') or {}
        req = res.get('requests') or {}
        lim = res.get('limits') or {}
        return not req.get('memory') or not req.get('cpu') or \
            not lim.get('memory')
    k = _first_container(ctx.pod, bad)
    if k < 0:
        return _passed('validate-resources')
    res = ctx.pod['spec']['containers'][k].get('resources')
    if res is None:
        path = f'/spec/containers/{k}/resources/'
    else:
        raise ValueError('a container with partial resources lies outside '
                         'the generators this reference covers')
    return _pattern_fail('CPU and memory resource requests and limits are '
                         'required.', 'validate-resources', path)


RULES = [
    ('disallow-latest-tag', 'require-image-tag', ('Pod',),
     # "*:*": a tag (or a port) is required
     _image_rule('require-image-tag', 'An image tag is required.',
                 lambda image: ':' not in image)),
    ('disallow-latest-tag', 'validate-image-tag', ('Pod',),
     # "!*:latest"
     _image_rule('validate-image-tag',
                 "Using a mutable image tag e.g. 'latest' is not allowed.",
                 lambda image: image.endswith(':latest'))),
    ('require-requests-limits', 'validate-resources', ('Pod',),
     require_requests_limits),
]
