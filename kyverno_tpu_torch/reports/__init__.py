"""PolicyReport pipeline (reference: api/policyreport/v1alpha2,
pkg/utils/report, pkg/controllers/report)."""

from .aggregate import AggregateController  # noqa: F401
from .results import (  # noqa: F401
    calculate_summary, engine_response_to_report_results,
    sort_report_results, split_results_by_policy,
)
from .types import (  # noqa: F401
    build_admission_report, calculate_resource_hash,
    new_background_scan_report, new_policy_report, policy_label,
)