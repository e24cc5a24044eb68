"""Validated parser for environment knobs (trimmed copy of the reference's
``utils/env.py``): empty means default, non-finite numbers are rejected,
and a bad value warns once and keeps the default instead of crashing."""

from __future__ import annotations

import logging
import math
import os

logger = logging.getLogger("lmrs_torch.env")

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


def env_str(name: str, default: str = "") -> str:
    raw = _raw(name)
    return default if raw is None else raw


def env_int(name: str, default: int) -> int:
    raw = _raw(name)
    if raw is None:
        return default
    try:
        return int(raw, 10)
    except ValueError:
        _warn_once(name, f"not an integer: {raw!r}; using {default}")
        return default


def env_float(name: str, default: float) -> float:
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
    return val
