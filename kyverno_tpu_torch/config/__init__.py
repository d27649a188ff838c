"""Dynamic configuration (reference: pkg/config)."""

from .config import (  # noqa: F401
    KYVERNO_CONFIGMAP_NAME, KYVERNO_NAMESPACE, ConfigController,
    Configuration,
)
