"""Background processing (reference: pkg/background).

UpdateRequests are the durable hand-off from the admission path to the
async controllers: generate-rule materialization and mutate-existing.
"""

from .updaterequest import (  # noqa: F401
    UR_GENERATE, UR_MUTATE, STATE_COMPLETED, STATE_FAILED, STATE_PENDING,
    STATE_SKIP, UpdateRequest, UpdateRequestGenerator,
)
from .generate import GenerateController  # noqa: F401
from .mutate_existing import MutateExistingController  # noqa: F401
from .update_request_controller import UpdateRequestController  # noqa: F401
