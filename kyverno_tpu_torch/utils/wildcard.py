"""Glob wildcard matching.

Semantics match the reference's wildcard helper (reference:
pkg/utils/wildcard/wildcard.go, IGLOU-EU/go-wildcard): ``*`` matches any
sequence of characters (including empty), ``?`` matches exactly one
character.  An empty pattern matches only the empty string.
"""

from __future__ import annotations

from functools import lru_cache


def match(pattern: str, name: str) -> bool:
    """Return True if ``name`` matches glob ``pattern``."""
    return _match_impl(pattern, name)


@lru_cache(maxsize=65536)
def _match_impl(pattern: str, name: str) -> bool:
    # Iterative two-pointer glob matcher with backtracking on '*'.
    p = n = 0
    star = -1  # index in pattern of last '*'
    mark = 0   # index in name to resume from after backtrack
    lp, ln = len(pattern), len(name)
    while n < ln:
        if p < lp and (pattern[p] == '?' or pattern[p] == name[n]):
            p += 1
            n += 1
        elif p < lp and pattern[p] == '*':
            star = p
            mark = n
            p += 1
        elif star != -1:
            p = star + 1
            mark += 1
            n = mark
        else:
            return False
    while p < lp and pattern[p] == '*':
        p += 1
    return p == lp


def contains_wildcard(s: str) -> bool:
    return '*' in s or '?' in s


def check_patterns(patterns: list[str], key: str) -> bool:
    """True if key matches any pattern in the list."""
    return any(match(p, key) for p in patterns)
