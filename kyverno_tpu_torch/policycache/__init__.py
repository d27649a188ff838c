"""Type-indexed in-memory policy cache (reference: pkg/policycache)."""

from .cache import (  # noqa: F401
    GENERATE, MUTATE, VALIDATE_AUDIT, VALIDATE_ENFORCE,
    VERIFY_IMAGES_MUTATE, VERIFY_IMAGES_VALIDATE, Cache,
)
