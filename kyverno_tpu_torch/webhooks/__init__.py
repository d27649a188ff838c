"""Admission serving layer (L4): AdmissionReview protocol, handler
middleware chain, resource/policy/exception handlers and the HTTPS
webhook server (reference: pkg/webhooks)."""

from . import admission  # noqa: F401
from .handlers import ResourceHandlers  # noqa: F401
from .server import WebhookServer  # noqa: F401
