"""Dynamic client layer (reference: pkg/clients/dclient).

The reference talks to a live Kubernetes API server through a dynamic
client plus discovery. The TPU-native framework keeps the same interface
as the plugin boundary but ships an in-memory fake (the reference's own
test strategy, pkg/clients/dclient/fake.go) as the default store; a real
cluster binding can be plugged in behind the same interface.
"""

from .client import (  # noqa: F401
    AlreadyExistsError,
    ApiError,
    FakeClient,
    NotFoundError,
)
