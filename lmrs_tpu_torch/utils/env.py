"""Validated parser for environment knobs (trimmed copy of the reference's
``utils/env.py``): empty means default, non-finite numbers are rejected,
and a bad value warns once and keeps the default instead of crashing."""

from __future__ import annotations

import logging
import math
import os

logger = logging.getLogger("lmrs_torch.env")

_TRUTHY = frozenset(("1", "true", "yes", "on"))
_FALSY = frozenset(("0", "false", "no", "off"))

_warned: set[str] = set()


def _warn_once(name: str, message: str) -> None:
    if name not in _warned:
        _warned.add(name)
        logger.warning("%s: %s", name, message)


def _raw(name: str) -> str | None:
    raw = os.environ.get(name)
    if raw is None:
        return None
    return raw.strip() or None


def _clamp(name: str, val, lo, hi):
    if lo is not None and val < lo:
        _warn_once(name, f"value {val} below minimum {lo}; clamping")
        return lo
    if hi is not None and val > hi:
        _warn_once(name, f"value {val} above maximum {hi}; clamping")
        return hi
    return val


def env_str(name: str, default: str = "") -> str:
    raw = _raw(name)
    return default if raw is None else raw


def env_bool(name: str, default: bool) -> bool:
    """Boolean knob: 1/true/yes/on vs 0/false/no/off (case-insensitive);
    anything else warns and keeps the default."""
    raw = _raw(name)
    if raw is None:
        return default
    low = raw.lower()
    if low in _TRUTHY:
        return True
    if low in _FALSY:
        return False
    _warn_once(name, f"not a boolean: {raw!r}; using {default}")
    return default


def env_int(name: str, default: int, *, lo: int | None = None,
            hi: int | None = None) -> int:
    raw = _raw(name)
    if raw is None:
        return default
    try:
        val = int(raw, 10)
    except ValueError:
        _warn_once(name, f"not an integer: {raw!r}; using {default}")
        return default
    return _clamp(name, val, lo, hi)


def env_float(name: str, default: float, *, lo: float | None = None,
              hi: float | None = None) -> float:
    raw = _raw(name)
    if raw is None:
        return default
    try:
        val = float(raw)
    except ValueError:
        _warn_once(name, f"not a number: {raw!r}; using {default}")
        return default
    if not math.isfinite(val):
        _warn_once(name, f"non-finite value {raw!r}; using {default}")
        return default
    return _clamp(name, val, lo, hi)


def env_list(name: str) -> tuple[str, ...]:
    """Comma-separated list knob (``LMRS_HOSTS=a:1,b:2``); empty items
    dropped."""
    raw = _raw(name)
    if raw is None:
        return ()
    return tuple(item.strip() for item in raw.split(",") if item.strip())
