"""Registry client layer (reference: pkg/registryclient).

Network OCI access is environment-gated (the TPU build runs with zero
egress by default). ``MockRegistryClient`` is the hermetic store the CLI
and tests use — the same strategy as the reference CLI's registry mock
(cmd/cli/kubectl-kyverno/utils/store).
"""

from .client import (  # noqa: F401
    Descriptor, MockRegistryClient, RegistryError,
)
