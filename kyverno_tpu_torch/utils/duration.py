"""Go-style duration parsing (time.ParseDuration semantics).

Used by leaf pattern comparisons (reference: pkg/engine/pattern/pattern.go:213
compareDuration) and the JMESPath time/arithmetic functions.

A duration string is a possibly signed sequence of decimal numbers, each with
optional fraction and a mandatory unit suffix, e.g. "300ms", "-1.5h", "2h45m".
Valid units: ns, us (or µs/μs), ms, s, m, h.  "0" is valid without a unit.
Returns integer nanoseconds.
"""

from __future__ import annotations

_UNITS = {
    'ns': 1,
    'us': 1000, 'µs': 1000, 'μs': 1000,
    'ms': 1000 * 1000,
    's': 1000 * 1000 * 1000,
    'm': 60 * 1000 * 1000 * 1000,
    'h': 3600 * 1000 * 1000 * 1000,
}


class DurationError(ValueError):
    pass


def parse_duration(s: str) -> int:
    """Parse a Go duration string to integer nanoseconds."""
    if not isinstance(s, str):
        raise DurationError(f"invalid duration {s!r}")
    orig = s
    neg = False
    if s and s[0] in '+-':
        neg = s[0] == '-'
        s = s[1:]
    if s == '0':
        return 0
    if not s:
        raise DurationError(f"invalid duration {orig!r}")
    total = 0
    while s:
        # leading digits (integer part)
        i = 0
        while i < len(s) and s[i].isdigit():
            i += 1
        int_part = s[:i]
        s = s[i:]
        frac_part = ''
        if s.startswith('.'):
            s = s[1:]
            j = 0
            while j < len(s) and s[j].isdigit():
                j += 1
            frac_part = s[:j]
            s = s[j:]
        if not int_part and not frac_part:
            raise DurationError(f"invalid duration {orig!r}")
        # unit: longest match first
        unit = None
        for u in ('ns', 'us', 'µs', 'μs', 'ms', 's', 'm', 'h'):
            if s.startswith(u):
                # 'm' must not shadow 'ms'; ordering above handles it since we
                # try two-char units first, but 's'/'m'/'h' are one char.
                unit = u
                break
        if unit is None:
            raise DurationError(f"missing unit in duration {orig!r}")
        s = s[len(unit):]
        scale = _UNITS[unit]
        v = int(int_part or '0') * scale
        if frac_part:
            v += int(round(float('0.' + frac_part) * scale))
        total += v
    return -total if neg else total


def is_duration(s: str) -> bool:
    try:
        parse_duration(s)
        return True
    except (DurationError, TypeError):
        return False


def format_duration(ns: int) -> str:
    """Format nanoseconds as a Go duration string (time.Duration.String)."""
    if ns == 0:
        return '0s'
    neg = ns < 0
    ns = abs(ns)
    out = ''
    if ns < 1000:
        out = f'{ns}ns'
    elif ns < 10 ** 6:
        out = _fmt_frac(ns, 1000, 'µs')
    elif ns < 10 ** 9:
        out = _fmt_frac(ns, 10 ** 6, 'ms')
    else:
        secs, rem = divmod(ns, 10 ** 9)
        h, secs = divmod(secs, 3600)
        m, secs = divmod(secs, 60)
        out = ''
        if h:
            out += f'{h}h'
        if h or m:
            out += f'{m}m'
        out += _fmt_frac(secs * 10 ** 9 + rem, 10 ** 9, 's')
    return ('-' + out) if neg else out


def _fmt_frac(value: int, scale: int, unit: str) -> str:
    whole, frac = divmod(value, scale)
    if frac == 0:
        return f'{whole}{unit}'
    fs = str(frac).rjust(len(str(scale)) - 1, '0').rstrip('0')
    return f'{whole}.{fs}{unit}'
