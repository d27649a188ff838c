"""Reference harness for the PyTorch port's tests: the JAX package is the
oracle, the port (``kyverno_tpu_torch``) is held bit-for-bit against it.

The JAX evaluator's device path imports ``jax.experimental.enable_x64``,
which jax 0.9 no longer has, so on such a jax every reference dispatch
raises ``ImportError``.  ``x64_shim`` works around that for the span of
one ``with`` block: it swaps ``kyverno_tpu.ops.eval.enable_x64`` for a
no-op while the global ``jax_enable_x64`` flag is on, and restores both
on exit.  It is never installed at module scope: the JAX package's own
tests share worker processes with these, and must keep seeing the JAX
package exactly as it is.

The packs and resource generators of the JAX package's compiler tests
are reused here, so both packages run the same policies over the same
seeded resources.
"""

import contextlib
import random

import jax
import numpy as np
import pytest
import yaml

import test_compiler
import test_compiler_conditions
import test_foreach_compile
import test_pss_compile
import test_wildcard_keys
from kyverno_tpu.ops import eval as jax_eval
from kyverno_tpu_torch import smokepack


@contextlib.contextmanager
def x64_shim():
    """Scoped stand-in for the JAX package's ``enable_x64`` (see the
    module docstring).  x64 stays on for the whole block rather than per
    call, because the scan pipeline enters ``enable_x64`` from several
    threads at once."""
    orig = jax_eval.enable_x64
    prev = jax.config.read('jax_enable_x64')
    jax.config.update('jax_enable_x64', True)
    jax_eval.enable_x64 = contextlib.nullcontext
    try:
        yield
    finally:
        jax_eval.enable_x64 = orig
        jax.config.update('jax_enable_x64', prev)


@pytest.fixture
def jax_reference(monkeypatch):
    """The JAX evaluator as an oracle: the x64 shim on, and executables
    compiled in-process rather than loaded from the on-disk caches (the
    package's AOT store and XLA's persistent cache, whose CPU artifacts
    can fail to load in another process)."""
    monkeypatch.setenv('KTPU_AOT', '0')
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update('jax_enable_compilation_cache', False)
    try:
        with x64_shim():
            yield
    finally:
        jax.config.update('jax_enable_compilation_cache', prev)


# ---------------------------------------------------------------------------
# packs: name -> (policy YAML, generator(rng, i) -> resource)

def _wildcard_key_pod(rng, i):
    ann = {}
    if rng.random() < 0.7:
        ann[f'{test_wildcard_keys.AA_KEY}/c{rng.randint(0, 2)}'] = \
            rng.choice(['runtime/default', 'localhost/prof', 'unconfined',
                        'localhost/', ''])
    if rng.random() < 0.3:
        ann['other'] = 'x'
    labels = {}
    if rng.random() < 0.7:
        labels[f'team-{rng.choice(["a", "b"])}'] = \
            rng.choice(['platform', 'infra', 'web', ''])
    return test_wildcard_keys.pod(f'w{i}', annotations=ann or None,
                                  labels=labels or None)


def _pods_and_deployments(mod):
    return lambda rng, i: (mod.make_deployment(rng) if i % 4 == 3
                           else mod.make_pod(rng))


PACKS = {
    'compiler': (test_compiler.POLICY_PACK,
                 _pods_and_deployments(test_compiler)),
    'conditions': (test_compiler_conditions.PACK,
                   _pods_and_deployments(test_compiler_conditions)),
    'pss': (test_pss_compile.PACK, _pods_and_deployments(test_pss_compile)),
    'foreach': (test_foreach_compile.PACK,
                lambda rng, i: test_foreach_compile.make_pod(rng)),
    'wildcard_keys': (test_wildcard_keys.APPARMOR + '\n---\n' +
                      test_wildcard_keys.LABEL_WILD, _wildcard_key_pod),
    'smoke': (smokepack.SMOKE_PACK, smokepack.make_config4_pod),
}


def load_pack(name: str):
    """(JAX-package policies, port policies) of pack ``name``."""
    from kyverno_tpu.api.policy import Policy as JaxPolicy
    from kyverno_tpu_torch.api.policy import Policy as TorchPolicy
    docs = [d for d in yaml.safe_load_all(PACKS[name][0]) if d]
    return [JaxPolicy(d) for d in docs], [TorchPolicy(d) for d in docs]


def make_resources(name: str, n: int, seed: int = 7):
    rng = random.Random(seed)
    gen = PACKS[name][1]
    return [gen(rng, i) for i in range(n)]


# ---------------------------------------------------------------------------

def test_reference_raises_without_shim():
    """The reason for the shim: on jax 0.9 the JAX package's staging
    path cannot import enable_x64."""
    if hasattr(__import__('jax.experimental',
                          fromlist=['enable_x64']), 'enable_x64'):
        pytest.skip('this jax still has jax.experimental.enable_x64')
    tensors = {'x': np.zeros((2, 3), np.int64)}
    with pytest.raises(ImportError):
        jax_eval.shard_batch(tensors)


def test_shim_restores_attribute_and_config():
    orig = jax_eval.enable_x64
    prev = jax.config.read('jax_enable_x64')
    with x64_shim():
        assert jax_eval.enable_x64 is not orig
        assert jax.config.read('jax_enable_x64') is True
        packed, _layout = jax_eval.shard_batch(
            {'x': np.full((2, 3), 1 << 40, np.int64)})
        assert packed['pk_int64'].dtype == np.int64
    assert jax_eval.enable_x64 is orig
    assert jax.config.read('jax_enable_x64') == prev


def test_shim_restores_after_error():
    orig = jax_eval.enable_x64
    prev = jax.config.read('jax_enable_x64')
    with pytest.raises(RuntimeError):
        with x64_shim():
            raise RuntimeError('inside')
    assert jax_eval.enable_x64 is orig
    assert jax.config.read('jax_enable_x64') == prev


@pytest.mark.parametrize('name', sorted(PACKS))
def test_packs_load_in_both_packages(name):
    jax_pols, torch_pols = load_pack(name)
    assert len(jax_pols) == len(torch_pols) > 0
    assert [p.name for p in jax_pols] == [p.name for p in torch_pols]
