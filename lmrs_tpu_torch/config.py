"""Typed configuration tree of the port (trimmed copy of the reference's
``config.py``).

``EngineConfig`` carries only the fields the port honours: the
static path (``scheduler="static"``: lockstep waves over a dense cache)
and the continuous scheduler with packed fresh prefill, decode blocks, mixed
prefill/decode steps, chunked continuation prefill and the shared-prefix
KV cache (the reference's defaults), speculation (``speculate_k``: tree
speculation under mixed steps, linear with ``mixed_batch=False``), int8
weights and KV pages (``quantize``, ``kv_quantize``), and the executor's
request cap, retries and deadline budget (``max_concurrent_requests``,
``retry_attempts``, ``retry_delay``, ``request_deadline_s``).
``ReduceConfig.streaming`` feeds the reduce tree into the map stage's
engine stream and ``ReduceConfig.stable_tree`` gives it the append-stable
shape of live sessions; ``JobsConfig`` and ``LiveConfig`` carry the durable
job and live session knobs (``jobs/``, ``live/``).  ``backend`` picks the engine: ``"torch"`` (the default, the
card's engine), ``"mock"`` (the deterministic no-device engine,
``engine/mock.py``) or ``"http"`` (``serving/router.py`` over the running
``lmrs-serve-torch`` servers named by ``hosts``).  ``EngineConfig.checkpoint_path`` names a native checkpoint
(``models/loader.py``) and ``tokenizer`` the serving tokenizer; a
``ModelConfig`` with ``n_experts`` has mixture-of-experts FFNs
(``ops/moe.py``).  Host/disk KV and device meshes have no field here; the
CLI refuses their flags by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lmrs_tpu_torch.utils import env as _envmod


@dataclass
class DataConfig:
    """Preprocessing stage knobs."""

    merge_same_speaker: bool = True
    time_interval_seconds: float | None = None
    max_segment_duration: float = 120.0
    preserve_timestamps: bool = True
    limit_segments: int | None = None


@dataclass
class ChunkConfig:
    """Chunker knobs; ``tokenizer`` names the token-count authority."""

    max_tokens_per_chunk: int = 4000
    overlap_tokens: int = 200
    context_tokens: int = 150
    # "approx" | "byte" | a *.model SentencePiece path | an HF tokenizer dir
    tokenizer: str = "approx"


@dataclass
class ModelConfig:
    """Decoder-only transformer hyperparameters."""

    name: str = "tiny"
    vocab_size: int = 512
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    hidden_dim: int = 688
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # Gemma-style differences
    logit_softcap: float | None = None
    embed_scale: bool = False  # multiply embeddings by sqrt(dim)
    head_dim: int | None = None  # explicit per-head dim
    activation: str = "silu"  # "silu" (Llama) | "gelu" (Gemma)
    # mixture-of-experts (0 experts = dense FFN; ops/moe.py)
    n_experts: int = 0
    n_experts_per_token: int = 2
    expert_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01  # load-balance loss weight in training

    @property
    def hd(self) -> int:
        """Per-head dimension; ``head_dim`` overrides the dim/n_heads default."""
        return self.head_dim or self.dim // self.n_heads


def _env_backend() -> str:
    """The backend the environment names: ``LMRS_BACKEND``, else
    ``DEFAULT_PROVIDER``, else ``"torch"``.  The reference's
    ``DEFAULT_PROVIDER`` values name HTTP vendors; from the environment
    both map to the local default, as there, which in the port is the
    card's engine: only ``LMRS_BACKEND=mock`` chooses the mock."""
    name = _envmod.env_str("LMRS_BACKEND",
                           _envmod.env_str("DEFAULT_PROVIDER", "torch"))
    return "torch" if name in ("openai", "anthropic") else name


@dataclass
class EngineConfig:
    """Generation engine knobs.

    ``prefill_chunk`` caps the prompt tokens one prefill dispatch advances
    a slot by; a longer prompt, or the tail after a
    prefix-cache hit, prefills in continuation chunks through the ragged
    span kernel.  ``mixed_batch``: once any slot decodes, a prompt slice
    of at most ``mixed_token_budget`` minus the decoding rows rides each
    decode step.  ``prefix_cache``: completed prompts donate their
    full-page KV prefix to a radix tree that later admissions reuse
    (``prefix_cache_max_pages`` caps it; 0 = bounded by the pool).
    ``quantize="int8"``: int8 weight-only projections (``ops/quant.py``).
    ``kv_quantize="int8"``: int8 KV pages with per-(slot, kv head,
    channel) scales; it needs ``page_size % 32 == 0`` and turns the prefix
    cache off (the scheduler says so), as in the reference.  ``host_kv``
    (on by default, as in the reference) keeps evicted prefix pages in a
    host-RAM tier of ``host_kv_gb`` and restores them on a later match;
    ``kv_disk`` adds a disk tier under it (``engine/host_kv.py``).
    """

    # "torch" | "mock" | "http", from LMRS_BACKEND or DEFAULT_PROVIDER as
    # in the reference (whose default, "mock", is not the port's: the port
    # exists to run the card's engine)
    backend: str = field(default_factory=lambda: _env_backend())
    model: str = field(default_factory=lambda: _envmod.env_str("LMRS_MODEL", "tiny"))
    scheduler: str = "continuous"
    max_batch_slots: int = 8
    page_size: int = 128
    num_pages: int = 512
    prefill_chunk: int = 4096
    decode_block: int = 16  # decode steps per host sync
    mixed_batch: bool = True
    mixed_token_budget: int = field(
        default_factory=lambda: _envmod.env_int("LMRS_MIXED_TOKEN_BUDGET", 256))
    prefix_cache: bool = True
    prefix_cache_max_pages: int = 0
    # host-RAM spill tier behind the prefix cache (engine/host_kv.py): an
    # evicted page's content is captured into host memory and restored on
    # a later match instead of re-prefilled; LMRS_HOST_KV=0 makes eviction
    # mean gone.  Off with int8 KV, which turns the prefix cache off
    host_kv: bool = field(
        default_factory=lambda: _envmod.env_bool("LMRS_HOST_KV", True))
    # host pool budget in GiB (LRU over spilled subtrees past it)
    host_kv_gb: float = field(
        default_factory=lambda: _envmod.env_float("LMRS_HOST_KV_GB", 1.0))
    # disk tier under the host pool (opt-in): host pressure demotes the
    # LRU entry to a spill file instead of dropping it
    kv_disk: bool = field(
        default_factory=lambda: _envmod.env_bool("LMRS_KV_DISK", False))
    kv_disk_gb: float = field(
        default_factory=lambda: _envmod.env_float("LMRS_KV_DISK_GB", 4.0))
    # spill-file root ("" = the system temp directory); each pool writes
    # into a fresh subdirectory of it
    kv_disk_dir: str = field(
        default_factory=lambda: _envmod.env_str("LMRS_KV_DISK_DIR", ""))
    # seconds a prefill→decode handoff keeps its pages pinned before the
    # orphan sweep reclaims them (a request deadline clips it)
    handoff_ttl_s: float = field(
        default_factory=lambda: _envmod.env_float("LMRS_HANDOFF_TTL", 60.0))
    # the fault-injection plane (testing/faults.py): a JSON FaultPlan (or
    # "@/path/to/plan.json") that make_engine installs process-wide; empty
    # = disabled, every injection site a no-op
    fault_plan: str = field(
        default_factory=lambda: _envmod.env_str("LMRS_FAULT_PLAN", ""))
    # speculative decoding: k n-gram drafts per chain verified per step (0 =
    # off); with mixed_batch tree speculation (engine/scheduler.py
    # spec_tree_width), without it linear speculation
    speculate_k: int = 0
    speculate_ngram: int = 3
    # a native checkpoint directory (models/loader.save_checkpoint; convert
    # an HF one with lmrs-torch-convert); None = random-init weights
    checkpoint_path: str | None = None
    quantize: str | None = None     # None | "int8" (weight-only)
    kv_quantize: str | None = None  # None | "int8" (KV pages)
    temperature: float = field(
        default_factory=lambda: _envmod.env_float("TEMPERATURE", 0.3))
    max_tokens: int = field(
        default_factory=lambda: _envmod.env_int("MAX_TOKENS", 1000))
    # the executor's wave cap, for engines that do not schedule internally
    # (TorchEngine does, and gets the whole queue at once)
    max_concurrent_requests: int = field(
        default_factory=lambda: _envmod.env_int("MAX_CONCURRENT_REQUESTS", 5))
    retry_attempts: int = field(
        default_factory=lambda: _envmod.env_int("RETRY_ATTEMPTS", 3))
    retry_delay: float = field(
        default_factory=lambda: _envmod.env_float("RETRY_DELAY", 5.0))
    # deadline budget (seconds) the executor stamps onto every request it
    # runs that carries none (0 = no deadline): such a request is shed at
    # admission when its budget cannot cover the TTFT estimate, expired in
    # flight at the next block boundary, and its retries clip to the budget
    request_deadline_s: float = field(
        default_factory=lambda: _envmod.env_float("LMRS_REQUEST_DEADLINE", 0.0))
    # the serving tokenizer ("" = the model's default: byte for vocabularies
    # under 100,000, else approx); the forms ``data.tokenizer.get_tokenizer``
    # takes: "byte", a *.model SentencePiece path, an HF tokenizer directory
    tokenizer: str = ""
    seed: int = 0
    # backend="http": the lmrs-serve-torch servers the router fans over
    # (comma-separated in the environment)
    hosts: tuple[str, ...] = field(
        default_factory=lambda: _envmod.env_list("LMRS_HOSTS"))
    # backend="http" disaggregated pools: prefill-role servers mint KV
    # handoff tickets, decode-role servers import them (serving/router.py)
    prefill_hosts: tuple[str, ...] = field(
        default_factory=lambda: _envmod.env_list("LMRS_PREFILL_HOSTS"))
    decode_hosts: tuple[str, ...] = field(
        default_factory=lambda: _envmod.env_list("LMRS_DECODE_HOSTS"))
    request_timeout: float = field(
        default_factory=lambda: _envmod.env_float("REQUEST_TIMEOUT", 60.0))

    def __post_init__(self) -> None:
        if self.backend == "jax":
            raise ValueError("backend 'jax' is the JAX package's engine; the "
                             "port's engine is backend 'torch'")
        if self.backend not in ("torch", "mock", "http"):
            raise ValueError(f"unknown engine backend {self.backend!r}; "
                             "the port has 'torch', 'mock' and 'http'")
        if self.quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {self.quantize!r}; "
                             "supported: int8")
        if self.kv_quantize not in (None, "int8"):
            raise ValueError(f"unknown kv_quantize mode {self.kv_quantize!r}; "
                             "supported: int8")
        if self.scheduler not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}; "
                             "want continuous|static")
        for name in ("max_batch_slots", "page_size", "num_pages",
                     "prefill_chunk", "decode_block", "max_tokens"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1 "
                                 f"(got {getattr(self, name)})")
        if self.mixed_token_budget < 32:
            raise ValueError(f"mixed_token_budget must be >= 32 "
                             f"(got {self.mixed_token_budget}); use "
                             "mixed_batch=False to disable mixed dispatch")
        if self.prefix_cache_max_pages < 0:
            raise ValueError(f"prefix_cache_max_pages must be >= 0 "
                             f"(got {self.prefix_cache_max_pages})")
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0 (got {self.speculate_k})")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0 "
                             f"(got {self.temperature})")
        if self.request_deadline_s < 0:
            raise ValueError(f"request_deadline_s must be >= 0 "
                             f"(got {self.request_deadline_s}); 0 disables "
                             "deadlines")
        if self.host_kv_gb < 0:
            raise ValueError(f"host_kv_gb must be >= 0 "
                             f"(got {self.host_kv_gb}); use host_kv=False / "
                             "LMRS_HOST_KV=0 to disable the spill tier")
        if self.kv_disk_gb < 0:
            raise ValueError(f"kv_disk_gb must be >= 0 "
                             f"(got {self.kv_disk_gb}); use kv_disk=False / "
                             "LMRS_KV_DISK=0 to disable the disk tier")
        if self.handoff_ttl_s <= 0:
            raise ValueError(f"handoff_ttl_s must be > 0 "
                             f"(got {self.handoff_ttl_s}): un-acked "
                             "handoff pins need a finite orphan-sweep "
                             "deadline or a dead decode pod leaks pages")


@dataclass
class ReduceConfig:
    """Reduce-tree knobs."""

    max_tokens_per_batch: int = 6000
    hierarchical: bool = True
    reserve_tokens: int = 1000
    max_summaries_per_batch: int = 10
    # feed reduce batches into the map stage's engine stream as their
    # member summaries complete (reduce/streaming.py) instead of a barrier
    # between map and reduce
    streaming: bool = False
    max_levels: int = 4
    temperature: float = 0.2
    # append-stable tree for append-only workloads (live sessions,
    # ``live/session.py``): fixed-arity (``max_summaries_per_batch``)
    # leaf-aligned batches with no positional batch metadata, so appended
    # leaves change only the last batch per level and the root path.  Off
    # by default: the batch pipeline keeps its token-budget tree
    stable_tree: bool = False


@dataclass
class JobsConfig:
    """Durable-job knobs (``jobs/``).  ``jobs_dir`` empty disables the job
    API (the server answers 501).  ``max_failed_chunk_fraction`` is the
    degraded-completion policy: a job whose failed-chunk fraction stays at
    or under it finishes ``status="degraded"``, above it ``"failed"``."""

    jobs_dir: str = field(
        default_factory=lambda: _envmod.env_str("LMRS_JOBS_DIR", ""))
    max_failed_chunk_fraction: float = field(
        default_factory=lambda: _envmod.env_float(
            "LMRS_JOBS_DEGRADED_FRACTION", 0.2))

    def __post_init__(self) -> None:
        if not 0.0 <= self.max_failed_chunk_fraction <= 1.0:
            raise ValueError(
                f"max_failed_chunk_fraction must be in [0, 1] "
                f"(got {self.max_failed_chunk_fraction}); 0 = any failed "
                "chunk fails the job, 1 = always finish degraded")


@dataclass
class LiveConfig:
    """Live-session knobs (``live/``).  ``sessions_dir`` empty disables the
    session API (501).  ``refresh_tokens`` > 0 auto-refreshes a session
    once that many appended tokens are unsummarized (0 = on request only);
    ``class_default`` is a refresh's deadline class when the request names
    none: ``interactive`` stamps ``interactive_deadline_s`` on its
    requests, ``bulk`` runs unbounded."""

    sessions_dir: str = field(
        default_factory=lambda: _envmod.env_str("LMRS_LIVE_DIR", ""))
    refresh_tokens: int = field(
        default_factory=lambda: _envmod.env_int("LMRS_LIVE_REFRESH_TOKENS", 0))
    class_default: str = field(
        default_factory=lambda: _envmod.env_str("LMRS_LIVE_CLASS_DEFAULT",
                                                "interactive"))
    interactive_deadline_s: float = 120.0

    def __post_init__(self) -> None:
        if self.class_default not in ("interactive", "bulk"):
            raise ValueError(
                f"unknown live deadline class {self.class_default!r}; "
                "want interactive|bulk")
        if self.refresh_tokens < 0:
            raise ValueError(
                f"refresh_tokens must be >= 0 (got {self.refresh_tokens}); "
                "0 disables auto-refresh")
        if self.interactive_deadline_s <= 0:
            raise ValueError(
                f"interactive_deadline_s must be > 0 "
                f"(got {self.interactive_deadline_s}); use class 'bulk' "
                "for unbounded refreshes")


@dataclass
class PipelineConfig:
    """Top-level config: one object wires the whole pipeline."""

    data: DataConfig = field(default_factory=DataConfig)
    chunk: ChunkConfig = field(default_factory=ChunkConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    model: ModelConfig | None = None  # None: the preset named by engine.model
    reduce: ReduceConfig = field(default_factory=ReduceConfig)
    jobs: JobsConfig = field(default_factory=JobsConfig)
    live: LiveConfig = field(default_factory=LiveConfig)


_PRESETS: dict[str, dict] = {
    "tiny": {},
    "tiny-gemma": dict(
        logit_softcap=30.0, embed_scale=True, rope_theta=10000.0,
        tie_embeddings=True, activation="gelu", norm_eps=1e-6,
    ),
    "llama3-8b": dict(
        vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        hidden_dim=14336, max_seq_len=8192, rope_theta=500000.0,
        tie_embeddings=False,
    ),
    "gemma-2b": dict(
        vocab_size=256128, dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
        hidden_dim=16384, max_seq_len=8192, rope_theta=10000.0,
        tie_embeddings=True, embed_scale=True, head_dim=256,
        activation="gelu", norm_eps=1e-6,
    ),
    "gemma-7b": dict(
        vocab_size=256128, dim=3072, n_layers=28, n_heads=16, n_kv_heads=16,
        hidden_dim=24576, max_seq_len=8192, rope_theta=10000.0,
        tie_embeddings=True, embed_scale=True, head_dim=256,  # != dim/heads
        activation="gelu", norm_eps=1e-6,
    ),
    "tiny-moe": dict(
        hidden_dim=512, n_experts=4, n_experts_per_token=2,
    ),
    "bench-1b": dict(
        vocab_size=512, dim=2048, n_layers=18, n_heads=16, n_kv_heads=8,
        hidden_dim=7168, max_seq_len=2048, rope_theta=500000.0,
        tie_embeddings=True,
    ),
    "bench-8b": dict(
        # Llama-3-8B widths with the full vocabulary; window 2048
        vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, hidden_dim=14336, max_seq_len=2048,
        rope_theta=500000.0, tie_embeddings=False,
    ),
    "quality-tiny": dict(
        vocab_size=512, dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=256, max_seq_len=1024, dtype="float32",
    ),
    "bench-smoke": dict(
        vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=256, max_seq_len=2048,
    ),
    "mixtral-8x7b": dict(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        hidden_dim=14336, max_seq_len=8192, rope_theta=1e6,
        tie_embeddings=False, n_experts=8, n_experts_per_token=2,
    ),
}


def model_preset(name: str) -> ModelConfig:
    """Named model configurations (same widths as the reference presets)."""
    if name not in _PRESETS:
        raise ValueError(f"unknown model preset {name!r}; have {sorted(_PRESETS)}")
    return ModelConfig(name=name, **_PRESETS[name])
