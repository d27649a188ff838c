"""CLI mock store: per-policy/rule variable values and mock toggles.

Reference: cmd/cli/kubectl-kyverno/utils/store/store.go — the CLI runs the
engine with a mock context loader whose variables come from the test's
values file rather than live cluster/API/registry calls.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class Store:
    def __init__(self):
        self.mock = False
        self.registry_access = False
        self.allow_api_calls = False
        # matches the reference's Go zero-value: store.ForeachElement is
        # never set by the CLI, so the mock loader always injects element 0
        self.foreach_element = 0
        # policy name -> rule name -> {key: value}
        self.rule_values: Dict[str, Dict[str, Dict[str, Any]]] = {}
        # policy name -> rule name -> {key: [values per foreach element]}
        self.foreach_values: Dict[str, Dict[str, Dict[str, List[Any]]]] = {}
        self.subresources: List[dict] = []

    def set_policies(self, policies: List[dict]) -> None:
        """Load the ``policies:`` section of a values file
        (reference: store.SetContext)."""
        for p in policies or []:
            name = p.get('name', '')
            for rule in p.get('rules') or []:
                self.rule_values.setdefault(name, {})[rule.get('name', '')] = \
                    rule.get('values') or {}
                if rule.get('foreachValues'):
                    self.foreach_values.setdefault(name, {})[
                        rule.get('name', '')] = rule['foreachValues']

    def get_policy_rule(self, policy: str, rule: str) -> Optional[Dict[str, Any]]:
        return (self.rule_values.get(policy) or {}).get(rule)

    def get_foreach_values(self, policy: str, rule: str
                           ) -> Optional[Dict[str, List[Any]]]:
        return (self.foreach_values.get(policy) or {}).get(rule)


_store = Store()


def get_store() -> Store:
    return _store


def reset_store() -> Store:
    global _store
    _store = Store()
    return _store
