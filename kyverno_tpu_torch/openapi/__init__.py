"""OpenAPI schema validation (reference: pkg/openapi)."""

from .manager import Manager, ValidationError  # noqa: F401
