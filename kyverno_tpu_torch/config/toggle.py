"""Feature toggles — the env-var tier of the three-level config system
(reference: pkg/toggle/toggle.go:8-24).

Resolution order matches the reference: an explicitly parsed flag value
wins, then the environment variable, then the default.
"""

from __future__ import annotations

import os
from typing import Optional


class Toggle:
    """reference: toggle.go Toggle interface (Enabled/Parse)."""

    def __init__(self, default: bool, env_var: str):
        self.default = default
        self.env_var = env_var
        self._value: Optional[bool] = None

    def parse(self, value: str) -> None:
        """Flag-tier override (strconv.ParseBool semantics)."""
        v = str(value).strip().lower()
        if v in ('1', 't', 'true'):
            self._value = True
        elif v in ('0', 'f', 'false'):
            self._value = False
        else:
            raise ValueError(f'invalid toggle value {value!r}')

    def enabled(self) -> bool:
        if self._value is not None:
            return self._value
        env = os.environ.get(self.env_var)
        if env is not None:
            v = env.strip().lower()
            if v in ('1', 't', 'true'):
                return True
            if v in ('0', 'f', 'false'):
                return False
        return self.default

    def reset(self) -> None:
        self._value = None


# reference: toggle.go:21-24
PROTECT_MANAGED_RESOURCES = Toggle(False, 'FLAG_PROTECT_MANAGED_RESOURCES')
FORCE_FAILURE_POLICY_IGNORE = Toggle(
    False, 'FLAG_FORCE_FAILURE_POLICY_IGNORE')
