"""The glob DP of ``csrc/glob_dp.cuh`` (K1c's kernel and K1v's ``GLOB``)
on the CPU, through the host build of K1v (``k1_glob_host`` in
``csrc/k1_vm_host.cpp``, the ``host_vm`` fixture of
``tests/test_torch_vm.py``), against K1c's plain version
(``kernels.wildcard_plain``) and the JAX evaluator's
``_View.wildcard_const``.

The DP reads each value's first vlen bytes as 32-bit words and the
pattern as ``kernels.glob_program`` compiles it (the '?' flag, runs of
'*' as one star, runs of other bytes as one step); the cases cover
literal runs, '*', '**', '?', the empty pattern, patterns past the
64-byte window, non-ASCII bytes, vlen 0, vlen = w = 64 (the DP's
position 64), values past the window, every tag, and windows of 1, 8,
63 and 64 bytes.  A hypothesis test draws patterns and values, half of
the values made from the pattern so that matches are frequent.  Every
comparison is exact.  The card's loads (aligned words and a funnel
shift) run in the ``cuda`` tests of ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from kyverno_tpu.compiler.ir import (TAG_ARRAY, TAG_BOOL, TAG_FLOAT,
                                     TAG_INT, TAG_MAP, TAG_MISSING,
                                     TAG_NULL, TAG_STRING)
from kyverno_tpu.ops.eval import _View
from kyverno_tpu_torch.ops import kernels
from test_torch_vm import host_vm  # noqa: F401

ALL_TAGS = (TAG_MISSING, TAG_NULL, TAG_BOOL, TAG_INT, TAG_FLOAT, TAG_STRING,
            TAG_MAP, TAG_ARRAY)
WIDTHS = (1, 8, 63, 64)
#: pattern characters: literals (one of them two UTF-8 bytes), '*', '?'
PATTERN_CHARS = 'ab:x-é*?'
VALUE_BYTES = b'ab:x-\xc3\xa9*?'


def host_glob(fn, head, str_len, tag, pattern: bytes):
    """K1v's GLOB verdict from the host build: (t, f) as bool arrays."""
    head = np.ascontiguousarray(head, np.uint8)
    str_len = np.ascontiguousarray(str_len, np.int32)
    tag = np.ascontiguousarray(tag, np.int8)
    n, w = head.shape
    prog = kernels.glob_program(pattern)
    out = np.zeros(n, np.uint8)
    fn.glob(head.ctypes.data, w, str_len.ctypes.data, tag.ctypes.data, n,
            prog, len(prog), out.ctypes.data)
    return (out & 1).astype(bool), ((out >> 1) & 1).astype(bool)


def plain_glob(head, str_len, tag, pattern: bytes):
    t, f = kernels.wildcard_plain(torch.from_numpy(head),
                                  torch.from_numpy(str_len),
                                  torch.from_numpy(tag), pattern)
    return t.numpy(), f.numpy()


def jax_glob(head, str_len, tag, pattern: str):
    t = {'x_str_head': jnp.asarray(head), 'x_str_len': jnp.asarray(str_len),
         'x_tag': jnp.asarray(tag)}
    k = _View(t, 'x').wildcard_const(pattern)
    return np.asarray(k.t), np.asarray(k.f)


def _values(values, w):
    """(head [n, w], str_len [n]) of byte strings, only the first w
    bytes kept, as the encoder does."""
    head = np.zeros((len(values), w), np.uint8)
    for i, v in enumerate(values):
        body = np.frombuffer(v[:w], np.uint8)
        head[i, :len(body)] = body
    return head, np.array([len(v) for v in values], np.int32)


def _check_all(fn, values, tags, pattern: str, w: int):
    head, str_len = _values(values, w)
    tag = np.asarray(tags, np.int8)
    pb = pattern.encode()
    got = host_glob(fn, head, str_len, tag, pb)
    want = plain_glob(head, str_len, tag, pb)
    ref = jax_glob(head, str_len, tag, pattern)
    for name, (t, f) in (('plain', want), ('jax', ref)):
        bad = np.nonzero((got[0] != t) | (got[1] != f))[0]
        assert bad.size == 0, (name, pattern, w,
                               [(values[i], tags[i]) for i in bad[:4]])


def _instances(pattern: str, rng) -> list:
    """Byte strings the pattern matches, '*' filled with 0-9 bytes and
    '?' with one, plus each with a byte changed, dropped or added."""
    out = []
    for _ in range(4):
        b = bytearray()
        for ch in pattern:
            if ch == '*':
                b += bytes(rng.choice(list(VALUE_BYTES),
                                      int(rng.integers(0, 10))))
            elif ch == '?':
                b.append(int(rng.choice(list(b'ab:-x'))))
            else:
                b += ch.encode()
        out.append(bytes(b))
        if b:
            i = int(rng.integers(0, len(b)))
            out.append(bytes(b[:i] + b'!' + b[i + 1:]))
            out.append(bytes(b[:i] + b[i + 1:]))
        out.append(bytes(b) + b'a')
    return out


EDGE_PATTERNS = ['', '*', '**', '?', '??', '?*', '*?', 'latest', ':latest',
                 '*:*', '*:*:*', 'nginx:*', '*-*-*', 'a?b*', '**a**',
                 'é*', '?é', '*é?', 'ab' * 20, 'a' * 70, '*' + 'a' * 64,
                 '?' * 64, '?' * 65, '*' * 70, 'a*' * 40, ('ab?' * 30)[:80]]


@pytest.mark.parametrize('w', WIDTHS)
@pytest.mark.parametrize('pattern', EDGE_PATTERNS)
def test_glob_dp_edge_cases_match_plain_and_jax(host_vm, pattern, w):
    rng = np.random.default_rng(len(pattern) * 7 + w)
    values = [b'', b'a', b'\xc3\xa9', b'nginx:latest', b'a' * 64,
              b'a' * 70, b'x' * w, b'x' * (w + 1), b'a:b' * 30,
              b'ab' * 40] + _instances(pattern, rng)
    values += [bytes(rng.choice(list(VALUE_BYTES), int(rng.integers(0, 80))))
               for _ in range(30)]
    tags = [TAG_STRING if i % 3 else ALL_TAGS[i % len(ALL_TAGS)]
            for i in range(len(values))]
    _check_all(host_vm, values, tags, pattern, w)


def test_glob_program_compiles_runs_and_stars():
    """The compiled form: the '?' flag, one star per run of '*', runs of
    other bytes with their length, split at 255."""
    assert kernels.glob_program(b'') == b'\x00'
    assert kernels.glob_program(b'*:*') == b'\x00\x00\x01:\x00'
    assert kernels.glob_program(b'a**b?c') == b'\x01\x01a\x00\x03b?c'
    long = kernels.glob_program(b'a' * 300)
    assert long == b'\x00\xff' + b'a' * 255 + b'\x2d' + b'a' * 45


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(pattern=st.text(PATTERN_CHARS, max_size=80),
       w=st.sampled_from(WIDTHS), seed=st.integers(0, 2 ** 32 - 1))
def test_glob_dp_hypothesis_matches_plain_and_jax(host_vm, pattern, w,
                                                  seed):
    rng = np.random.default_rng(seed)
    values = _instances(pattern, rng) + [
        bytes(rng.choice(list(VALUE_BYTES), int(rng.integers(0, 72))))
        for _ in range(16)] + [b'', b'x' * w]
    tags = [int(rng.choice(ALL_TAGS + (TAG_STRING,) * 6))
            for _ in values]
    _check_all(host_vm, values, tags, pattern, w)


@pytest.mark.parametrize('rows', [1, 64])
def test_glob_pack_host_vm_equals_eager_walk(host_vm, rows):
    """The glob-heavy pack of ``k1v_bench.py`` (eight ``dp``-class image
    and name patterns over Pods of 12 containers) through K1v's host
    build, lowered with the compiled patterns, against the eager walk."""
    import random

    import k1v_bench
    from kyverno_tpu_torch.api.policy import load_policies_from_yaml
    from kyverno_tpu_torch.compiler.compile import compile_policies
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.ops import vm
    from kyverno_tpu_torch.ops.eval import build_evaluator, shard_batch
    from test_torch_vm import run_host
    cps = compile_policies(load_policies_from_yaml(k1v_bench.GLOB_PACK))
    ev = build_evaluator(cps, torch.device('cpu'))
    assert {r for r, _why in ev.routes.values()} == {'vm'}
    rng = random.Random(rows)
    pods = [k1v_bench.make_glob_pod(rng, i) for i in range(rows)]
    packed, layout = shard_batch(
        dict(encode_batch(pods, cps, padded_n=rows).tensors()),
        torch.device('cpu'))
    program = ev.plan_for(layout).program
    assert int((program.code[:, 0] == vm.OP['GLOB']).sum()) == 8
    got = run_host(host_vm, program, packed)
    want = program.plain(packed)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
