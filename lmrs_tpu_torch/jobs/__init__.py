"""Durable summarization jobs: the CRC-framed write-ahead journal
(``journal``) and ``JobManager`` (``manager``), served as ``/v1/jobs`` by
``lmrs-serve-torch --jobs-dir``."""

from lmrs_tpu_torch.jobs.journal import (Journal, canonical_json, chunk_key,
                                         config_fingerprint, job_id_for,
                                         node_key, rebuild_state, replay)
from lmrs_tpu_torch.jobs.manager import TERMINAL_STATES, Job, JobManager

__all__ = [
    "Journal", "canonical_json", "chunk_key", "config_fingerprint",
    "job_id_for", "node_key", "rebuild_state", "replay",
    "Job", "JobManager", "TERMINAL_STATES",
]
