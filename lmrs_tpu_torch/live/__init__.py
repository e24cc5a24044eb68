"""Live sessions: growing transcripts summarized incrementally over the
write-ahead journal (``session``), served as ``/v1/sessions`` by
``lmrs-serve-torch --live-dir``."""

from lmrs_tpu_torch.live.session import (LiveSession, SessionManager,
                                         rebuild_live_state)

__all__ = ["LiveSession", "SessionManager", "rebuild_live_state"]
