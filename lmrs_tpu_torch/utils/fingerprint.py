"""Canonical JSON and config fingerprints for chunk dumps and the job and
session journals (copy of the reference's ``jobs/journal.py`` helpers):
the same fields give the same 16-hex digest in both packages."""

from __future__ import annotations

import hashlib
import json
from typing import Any


def canonical_json(obj: Any) -> str:
    """Stable serialization: sorted keys, no whitespace, UTF-8 kept."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False)


def config_fingerprint(**fields: Any) -> str:
    """Hash of the (prompt, model, sampling) surface that determines what a
    chunk summary MEANS.  Stamped into ``--save-chunks`` dumps: a resume
    under a different fingerprint drops the dump's summaries rather than
    mix stale content into a fresh run."""
    return hashlib.sha256(
        canonical_json(fields).encode("utf-8")).hexdigest()[:16]
