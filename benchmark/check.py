"""The verdict: each number compared beside its limit."""

from __future__ import annotations

import math


def verdict(values: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``correct`` and ``{name: {"value": v, "limit": l}}`` for every
    number compared.  A number without a limit, or one that is not a finite
    number, is not correct."""
    out, ok = {}, True
    for name, value in values.items():
        limit = limits.get(name)
        good = (limit is not None and isinstance(value, (int, float))
                and math.isfinite(value) and value <= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    missing = sorted(set(limits) - set(values))
    for name in missing:
        out[name] = {"value": None, "limit": limits[name]}
    return ok and not missing, out


def lines(checks: dict) -> list[str]:
    """One line per number compared: ``check <name>: <value> (limit <limit>)``."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]
