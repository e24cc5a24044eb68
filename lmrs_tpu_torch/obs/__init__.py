"""Observability of the port (a copy of the reference's ``obs`` package,
trimmed to what the port runs): the request-lifecycle tracer and its
cross-host stitching, the metric registry and exposition, live roofline
attribution and the on-demand ``torch.profiler`` capture, the step
anatomy, the per-request cost ledger, the SLO engine and the flight
recorder.  Standard library and numpy only (the capture and the
round-trip probe import torch inside the call)."""

from lmrs_tpu_torch.obs.anatomy import (
    CLASSES,
    NULL_ANATOMY,
    SEGMENTS,
    NullAnatomy,
    StepAnatomy,
    anatomy_enabled,
    maybe_anatomy,
    merge_anatomy,
    rtt_resample_s,
    slow_step_ms,
)
from lmrs_tpu_torch.obs.flight import (
    POSTMORTEM_SCHEMA,
    dump_postmortem,
    postmortem_dir,
    validate_postmortem_file,
)
from lmrs_tpu_torch.obs.ledger import DEFAULT_TENANT, CostLedger, merge_usage
from lmrs_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    MS_LATENCY_BUCKETS,
    POW2_TOKEN_BUCKETS,
    RATIO_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    add_label_to_exposition,
    log_buckets,
    merge_expositions,
)
from lmrs_tpu_torch.obs.perf import (
    DispatchAttribution,
    profile_capture_active,
    start_profile_capture,
)
from lmrs_tpu_torch.obs.slo import (
    DEFAULT_SPECS,
    SLOEngine,
    SLOSpec,
    specs_from_env,
    state_rank,
    worst_state,
)
from lmrs_tpu_torch.obs.trace import (
    PID_ENGINE,
    PID_PIPELINE,
    PID_STITCH,
    TID_SCHED,
    TRACE_TRACK_PREFIX,
    Tracer,
    disable_tracing,
    enable_tracing,
    export_current,
    get_tracer,
    new_trace_id,
    req_tid,
    stitch_traces,
    stitched_chains,
    validate_trace_events,
    validate_trace_file,
)

__all__ = [
    "CLASSES", "NULL_ANATOMY", "SEGMENTS", "NullAnatomy", "StepAnatomy",
    "anatomy_enabled", "maybe_anatomy", "merge_anatomy", "rtt_resample_s",
    "slow_step_ms",
    "DEFAULT_LATENCY_BUCKETS_S", "MS_LATENCY_BUCKETS", "POW2_TOKEN_BUCKETS",
    "RATIO_BUCKETS",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "add_label_to_exposition", "log_buckets", "merge_expositions",
    "DispatchAttribution", "profile_capture_active", "start_profile_capture",
    "POSTMORTEM_SCHEMA", "dump_postmortem", "postmortem_dir",
    "validate_postmortem_file",
    "DEFAULT_TENANT", "CostLedger", "merge_usage",
    "DEFAULT_SPECS", "SLOEngine", "SLOSpec", "specs_from_env",
    "state_rank", "worst_state",
    "PID_ENGINE", "PID_PIPELINE", "PID_STITCH", "TID_SCHED",
    "TRACE_TRACK_PREFIX", "Tracer",
    "disable_tracing", "enable_tracing", "export_current", "get_tracer",
    "new_trace_id", "req_tid", "stitch_traces", "stitched_chains",
    "validate_trace_events", "validate_trace_file",
]
