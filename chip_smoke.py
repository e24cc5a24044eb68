"""Runs the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives ``lmrs_tpu_torch`` on the card and fails (non-zero exit) on
anything wrong.  Phases, one JSON object per line:

1. device   — CUDA must be available; the card's name and power limit
              (``nvidia-smi --query-gpu=name,power.limit``).
2. build    — every kernel built from ``lmrs_tpu_torch/csrc`` (one nvcc per
              source, all at once); build seconds.
3. kernels  — each kernel against its plain PyTorch version at the main
              path's shapes (bf16): max |err| (tolerance 2e-2), pool writes
              bit-exact, kernel / plain / library times (CUDA events, L2
              flushed and a device spin queued before each launch, so the
              wrapper's host work is not timed) and the bound for this
              run's work.  The five split builds (decode bf16/int8,
              walk-only, spans bf16/int8) also at their split boundaries
              with a bit-identical repeat launch, and at the main path's
              shapes beside other split sizes.
              Flash prefill: the phase-3 packed row (4 segments and a
              padded tail) and an unpacked row with lengths < S, q/k/v
              as strided views of one qkv product, a repeat launch
              bit-identical; its library time is the fair yardstick
              (``scaled_dot_product_attention(is_causal=True,
              enable_gqa=True)`` on the flash backend, one call per
              segment), with the dense-mask call beside it;
              the card tests' edge cases ("kernels-flash-cases": n_rep
              1-8, hd 32/64/128, cut tiles, short and mid-tile
              segments, rows of different lengths); and the main path's
              shapes ("kernels-main-shape": one unpacked 1,600-token
              row, a packed bin of three 600-token segments).
              The span kernel at two shapes: a mixed step (7 decode rows +
              a 249-token slice) and a 1,300-token continuation chunk.  The
              multi-token verify kernel at the speculative step's shape (8
              rows x 5 tokens, pools exact outside the null page) and the
              walk-only decode kernel at the decode kernel's shape (pools
              untouched).  The int8 variants of the write-fused decode,
              span and verify kernels at the same shapes over int8 pools
              (random values, scales from ``kv_scale_from`` on random bf16
              K/V, one row whose new K/V are exact .5 ties of x / s): the
              same tolerance, int8 pool writes bit-exact.  The seven split
              builds (the five above and the verify kernel, bf16 and int8)
              at their split boundaries, and at the main path's shapes
              (the verify kernel at the speculative step: 8 rows x 5 tokens
              after 1,500) beside other split sizes.
              The span kernel's ancestor-mask build (tree speculation;
              "kernels-anc" lines), bf16 and int8, at hd 128 and 64 against
              ``ragged_spans_ref(anc_masks=)``: tree spans at heal 0-4
              whose bases lie on split and tile boundaries, a 32-token tree
              with bit 31 set, mask-0 spans in the same dispatch; pools
              exact, a repeat launch bit-identical.  At phase 12's step
              ("kernels-anc-main-shape": 8 rows x (heal + 9) tokens after
              1,500) with its bound, plain time and, as its yardstick, the
              unmasked span kernel on the same inputs.
3b. hd32    — every kernel's hd-32 build (the ``tiny`` presets' head dim;
              H=8, K=4) against its plain version at the split boundaries:
              flash prefill (packed and not), decode bf16/int8, walk-only,
              spans bf16/int8, verify bf16/int8, the ancestor-mask build
              bf16/int8; pools exact, repeat launches bit-identical.
3c. hd256   — every kernel's hd-256 build (the Gemma presets' head dim)
              at both head groupings, gemma-7b's (H=16, K=16) and
              gemma-2b's (H=8, K=1), held against its plain version as
              in phase 3b; then ("hd256-main-shape") each build at the
              main path's shapes (flash one 1,600-token row beside the
              fair SDPA call; decode
              8 x 1,501 tokens; spans phase 5's mixed step; verify 8 x 5
              tokens after 1,500; the ancestor-mask build phase 12's step)
              with its bound, plain time and times at other split sizes.
4. model    — bench-8b widths at 2 layers (``MODEL_CHECK_LAYERS``): one
              packed prefill of 3 prompts,
              16 teacher-forced decode steps, one span dispatch (2 decode
              rows + a 100-token slice) and one 5-token verify step
              (``multi_decode``) through ``forward_paged``, on the card
              (bf16, kernels) and on the CPU (f32, plain versions), same
              weights; max logit difference, and greedy agreement wherever
              the CPU top-2 margin exceeds the tolerance.  The CPU passes
              (``model_pass``) run in a child (``--model-refs``, every
              phase-4 case in ``MODEL_CASES`` order) started before phase
              3, and phases 4-4e run after phase 14, so the child's ~200 s
              of f32 CPU work overlaps the card's phases 3-14; each check
              loads its case's weights and CPU logits from the child's
              file.  Then the same
              check with int8 weights and int8 KV pages (``quantize_params``
              on the CPU, the same int8 values and scales on the card; the
              span dispatch re-prefills row 2 from position 0, a base-0 row
              that owns its slot's scales).
4c. model-gemma — the same two checks at gemma-7b's widths (hd 256, 16
              query over 16 kv heads), 2 layers.
4d. model-tree — one tree-speculation span dispatch through
              ``forward_paged(span_anc=)`` at bench-8b widths, 2 layers, on
              the card, bf16 and int8: two tree rows (one after a heal) and
              a prefill slice, every node's logits held against per-branch
              linear span dispatches of the same tokens on the same pools
              (LOGIT_TOL, greedy agreement above the margin).
4e. model-moe — phase 4's packed prefill, 16 decode steps and span
              dispatch at Mixtral-8x7B's widths, ONE layer, bf16 and then
              int8 weights (bf16 KV) on the same draw; every routing
              decision recorded on both devices: >= 90% of the (token,
              layer) top-k sets agree, and the logit and greedy gates hold
              on the tokens whose top-k sets and kept assignments agreed
              (bf16 hidden states can swap a near-tie token's experts).
4b. default — the CLI's ``main`` with no ``--model`` (the default
              ``EngineConfig``: preset ``tiny``, hd 32, random-init) on the
              demo transcript; counters zeroed just before and read just
              after: no failed request, a non-empty summary without an error
              string, and flash prefill, the write-fused decode kernel and
              the span kernel launched.
5. main     — ``TranscriptSummarizer`` at full bench-8b (32 layers,
              random-init bf16, byte tokenizer) with the hierarchical reduce,
              mixed steps, continuation chunks and the prefix cache; launch
              counters zeroed just before and read just after; the scheduler
              counters (mixed steps, prefix hits, preemptions) and a clean
              audit (allocator + prefix cache); a decode-step profile and
              a fresh-prefill dispatch profile (one 1,600-token row, all
              32 layers: device time by kernel kind).  The default engine
              runs under the dispatch watchdog (the scheduler on its
              dispatch thread): decode and prefill tokens, mixed steps and
              the three kernels' launches must equal the counts measured
              inline before the watchdog (``PHASE5_INLINE``), and
              ``watchdog_fires`` is printed (0); the wall is printed beside
              the inline one, not gated.  The engine's page allocator must
              be the native runtime's (``NativePageAllocator``).
6. spec     — the same transcript and config with linear speculation
              (``speculate_k=4, mixed_batch=False``) at 8 layers
              (``VARIANT_LAYERS``; full depth before phase 18); counters
              zeroed just before and read just after: the verify kernel,
              flash prefill and the span kernel (prefix-hit tails) launched,
              the write-fused decode kernel not at all (every decode
              dispatch is a speculative block); a clean audit.
7. int8      — phase 5's transcript and config with ``quantize="int8",
              kv_quantize="int8"`` at 8 layers (``VARIANT_LAYERS``; full
              depth before phase 18) (params quantized on the
              card after random init; the prefix cache is then off):
              flash prefill and the int8 span and decode kernels launched,
              mixed steps > 0, no prefix-cache query, a clean audit; a
              decode-step profile split into the decode kernel, the int8
              weight products and the rest.
8. int8-spec — phase 7 with ``speculate_k=4, mixed_batch=False``: the int8
              verify kernel launched, the int8 decode kernel not at all.
9. gemma-7b — phase 5 at gemma-7b's widths, 8 of its 28 layers
              (``VARIANT_LAYERS``; full before phase 18; hd 256, random-init
              bf16): phase 5's gates and a preemption; a decode-step
              profile with the attention kernel's ms a launch beside its
              bound; peak memory.
10. gemma-2b-int8-spec — gemma-2b (8 of its 18 layers, ``VARIANT_LAYERS``
              since phase 20; one kv head) with
              int8 weights and KV and ``speculate_k=4, mixed_batch=False``,
              prompts past 1,024 tokens prefilled in continuation chunks:
              the int8 verify and span kernels and flash launched, the
              int8 decode kernel not at all, no prefix-cache query.
11. parity  — the pipeline, executor and CLI parity flows at bench-8b widths
              and 4 layers (``PARITY_LAYERS``; 8 before phase 18, 32
              before phases 13-14
              took the script past ~650 s), with phase 5's settings, over
              one engine shared by five
              sub-phases, each on a line of its own with its wall, request
              and prefill-token counts, launches and the card's name and
              power limit: 11a ``summarize(save_chunks=)`` with the
              streaming reduce (no failed request, a tree, a clean audit, a
              reduce request admitted while a map request was in flight,
              flash, decode and span kernels launched, the dump complete);
              11b a new summarizer resuming from that dump (every chunk
              resumed, only reduce requests, prefill tokens only theirs);
              11c ``summarize_many`` of demo segments [:200] and [200:400]
              (two summaries, the map queue alternating, requests = map +
              reduce); 11d 8 of phase 5's map prompts, greedy, clean and
              then with a shed request, a cancel and a deadline set from
              ``on_result`` (their finish reasons and kept text, every other
              text identical, pages back, a clean audit); 11e the same 8
              through a ``MapExecutor`` whose engine raises once inside the
              scheduler loop (retried, nothing failed, 11d's clean texts).
12. spec-tree — phase 5's transcript and config with ``speculate_k=4`` and
              mixed steps on: the reference's tree speculation, every decode
              step one span dispatch through the ancestor-mask build; flash
              and the ancestor-mask kernel launched, the decode and verify
              kernels not at all, tree dispatches and accepted drafts > 0, a
              clean audit; a tree-step profile (8 rows x 9 nodes).
12b. the same with ``gemma-2b`` (8 of its 18 layers since phase 20,
              one kv head), int8
              weights and KV: the int8 ancestor-mask build at hd 256.
13. checkpoint — an HF-layout Mixtral checkpoint (Mixtral-8x7B widths, one
              layer, random bf16, ~3.4 GB, the port's safetensors writer)
              under ``build/``, converted by ``lmrs-torch-convert`` and
              loaded by ``TorchEngine(checkpoint_path=)`` bf16 and int8:
              leaves and a packed forward's logits bit-equal to an engine
              built from the same params in memory, int8 leaves equal to
              ``quantize_params`` of the bf16 ones, 8 greedy requests on
              each with a clean audit; bytes written and read, seconds a
              step; the files deleted.
14. mixtral — phase 5's transcript and config at ``mixtral-8x7b``'s
              widths, all 32 layers (``MIXTRAL_LAYERS``), int8 weights
              drawn a layer at a time on the
              card, bf16 KV, prefix cache on): no failed request, a clean
              audit, a tree, flash, decode and span kernels launched (no
              verify, ancestor-mask or int8-KV build), mixed steps and
              prefix hits, peak memory < 64 GiB; a decode-step profile
              split into attention, expert products, routing/dispatch,
              the other int8 products and the rest.
15. serve   — the serving surface at bench-8b widths (15a-15b at 8
              layers, ``VARIANT_LAYERS``, full before phase 18; 15c's child
              at full depth; random-init bf16,
              byte tokenizer, phase 5's engine settings with a 512-token
              cap), each sub-phase on a line of its own with the card's
              name and power limit.  15a: ``EngineHTTPServer`` in this
              process on 127.0.0.1, launch counters zeroed just before
              and read after: an OpenAI chat completion and an Anthropic
              message, each non-streamed and streamed at temperature 0
              (SSE deltas join to the non-streamed text; finish reason,
              stop reason and usage right; latency and time to the first
              delta), a stop string cut in the stream, 8 of phase 5's map
              prompts in one batch window (ONE wave; texts equal one
              direct ``generate_batch`` of the same 8), an
              ``X-LMRS-Deadline: 0.001`` request shed, a streamed client
              reset after its first delta (cancelled, pages back), a warm
              repeat (a prefix hit, its tail through the span kernel);
              ``/healthz`` (with a radix summary), ``/v1/models`` and both
              ``/metrics`` forms; a clean audit; flash, decode and span
              kernels launched.  15b: ``lmrs-torch --backend http --hosts
              <15a's server>,<a dead port>`` as a child with no card:
              no failed request, a tree, a summary, every request served
              by the live host and the dead one unhealthy; its wall beside
              phase 5's.  15c: once 15a's engine is freed,
              ``python -m lmrs_tpu_torch.serving.cli --model bench-8b
              --tokenizer byte`` as a child on the card: ``/healthz``
              within 300 s, one chat completion, SIGINT exits 0; start-up
              seconds.
16. kv      — KV movement at bench-8b widths, 8 layers
              (``VARIANT_LAYERS``; full before phase 18) (random-init bf16, byte
              tokenizer, phase 5's engine settings), each sub-phase on a
              line of its own with the card's name and power limit.  16a
              (host tier, on by default): 8 of phase 5's map prompts cold,
              again with the prefix pages resident (their bytes digested),
              then ``evict(10_000)`` and again: spill pages equal prefetch
              pages (> 0), spilled hits > 0, fewer prefill tokens than the
              cold wave, every restored page bit-equal to its captured
              bytes, texts equal the resident rerun's (the same shapes), a
              clean audit; capture and restore seconds and GB/s per 16 MiB
              page and per 64-page wave, the pinned bytes held.  16b: the
              host pool replaced by a 4-page one over a disk pool under
              ``build/``: a disk round trip (same bytes, same texts), then
              a corrupted spill file whose segment re-prefills (texts equal
              a rerun with that segment dropped by hand), files deleted;
              bytes and seconds written and read.  16c: two engines in
              this process behind a prefill-role and a decode-role server
              and a ``RouterEngine`` with role pools: 4 prompts one at a
              time, texts equal the colocated run, flash only on the
              prefill engine and decode only on the decode engine, no
              pins left; payload bytes, encode, transfer and import
              seconds, first-token times; the decode server shut down, a
              wave falls back colocated and the orphan sweep reclaims the
              pins after 2 s; an int8-KV pair at the engine level (scales
              in the payload, text equal colocated).  16d: the same pair
              behind ``role="both"`` servers: ``/v1/kv`` export, import
              and ack make the sibling's run a prefix hit through the span
              kernel with the warm host's text, and a same-preamble group
              of 8 through a colocated router ends with
              ``lmrs_kv_migrate_prefetches_total`` above 0.
17. jobs-live — durable jobs and live sessions at bench-8b widths (17a's
              child and 17b at 8 layers, ``VARIANT_LAYERS``; random-
              init bf16, byte tokenizer), each sub-phase on a line of its
              own with the card's name and power limit.  17a:
              ``lmrs-serve-torch --jobs-dir --max-tokens-cap 64`` as a
              child on the card (this script with ``--jobs-child``: the
              CLI, each chunk record appended 0.3 s late so the kill lands
              between records, the launch counts printed at exit); a job
              of 60 demo segments (16 map prompts) is SIGKILLed once its
              journal holds 3 chunk records, a new server on the same
              directory recovers it: ``done``, the journaled chunks not
              mapped again (map requests = the chunks left) and their
              records unchanged, no corrupt record on replay, flash and the
              decode kernel launched in the resumed server; start-up,
              resume and fsync seconds, journal bytes, requests and prefill
              tokens against the uninterrupted map wave.  17b: an in-process
              server with ``live_dir`` (and ``jobs_dir``) over a
              ``speculate_k=4`` engine (tree speculation): a session fed
              120 demo segments in three appends, a refresh after each:
              refresh 1 carries no draft hint, 2 and 3 the previous
              summary (read on the requests the engine saw), 2 and 3 reuse
              chunk summaries and reduce nodes, the chunks equal a cold
              session's, the ancestor-mask build launched in refreshes 2-3;
              the server shut down, a new manager recovers the session with
              equal status and summary docs; refresh 3's requests rerun with
              and without the hint (accept depths printed, not gated).  17c:
              a ``RouterEngine`` front over 17b's server: a job and a
              session's create, append and refresh through it, pinned to
              the host, the routed docs equal the host's.
18. obs     — the measurement half of observability at bench-8b widths
              (18a-18b at ``VARIANT_LAYERS`` since phase 20, 18c-18e at
              full depth; random-init bf16, byte tokenizer, phase 5's
              config), each
              sub-phase on a line of its own with the card's name and
              power limit.  18a: phase 5's workload with the tracer on
              (the ledger, anatomy, SLO and attribution on by default):
              the exported trace validates; every request's track runs
              enqueue → admit → prefill → first_token → decode → finish (a
              preempted one inserts preempt and a new admit); the pipeline
              track holds map_stage and one reduce_level a level; every
              decode_block span carries hbm_gb > 0; a clean audit (ledger
              conservation and the anatomy identity included); every live
              decode HBM-utilisation and prefill-MFU sample in (0, 1.05];
              ``chip_spec().known``; flash, decode and span kernels
              launched.  Printed: the wall, the trace's
              events and bytes, the anatomy's per-class segment means with
              the residual, the medians, the ledger's totals.  18b: the
              same with tracing off and ``LMRS_ANATOMY=0
              LMRS_COST_LEDGER=0 LMRS_SLO=0``: decode and prefill tokens,
              mixed steps and preemptions equal 18a's; its wall beside
              18a's and phase 5's (not gated).  18c: ``python -m lmrs_tpu_torch.cli
              --model bench-8b`` on 60 demo segments with ``--trace-out F
              --profile`` as a child (exit 0, F validates), then
              ``--trace-out F2 --no-trace`` (mock backend) writes no F2.
              18d: an in-process server with tracing on over a bench-8b
              engine: 8 chat requests under two ``X-LMRS-Tenant`` labels
              (``/v1/usage`` per tenant equals the responses' usage,
              device-seconds equal the ledger's fed walls), ``/v1/anatomy``
              and a clean audit, ``/v1/trace`` validates, ``/healthz``
              ``slo`` ok, ``/metrics`` text with the scheduler's
              instruments, ``POST /v1/debug/profile`` for 2 s while a
              request decodes (the Chrome trace names
              ``paged_decode_kernel``), and with ``LMRS_POSTMORTEM_DIR``
              armed 8 requests whose deadline (from the TTFT and 18a's
              block wall) runs out in decode: all ``deadline``, a
              ``deadline_storm`` postmortem that validates and holds the
              ring's spans.  18e: a ``RouterEngine`` over 18d's server and
              a mock server (a child with ``--trace``): the stitched trace
              validates, each routed request's trace id is on the router's
              ``route`` instant and on the host that finished it, fleet
              usage totals equal the hosts' sum, fleet anatomy merges both.
19. train   — training and evaluation on the card, each sub-phase on a
              line of its own with the card's name and power limit; the
              models train through ``training.train`` (plain PyTorch
              under autograd: no kernel, as in the reference).  19a: the
              whole gemma-2b (18 layers, 2.51 B params, bf16, AdamW states
              bf16) three steps on a [4, 512] byte-token batch of the demo
              transcript, once without and once with remat, from the same
              init: finite losses, the 3rd below the 1st, first-step
              losses within 1e-2, remat's peak memory below the other's,
              no attention kernel launched; step ms (median of steps 2-3),
              tokens/s, share of the bf16 peak (6·N·T) and peak GiB.  19b:
              ``tests/test_quality.py``'s synthetic gate at bench-smoke's
              widths, trained in f32 (200 AdamW steps at 4e-3, final loss
              < 0.5), served in bf16 by a continuous engine: mean ROUGE-L
              of 8 held-out prompts >= 0.30 and > 3x lead-1, >= 0.28 with
              int8 KV pages, the flash, decode and span kernels (int8
              builds under int8 KV) launched; then linear speculation
              (the verify kernel launched) and its accepted drafts,
              printed.  19c: its CLI gate: bench-smoke widths trained in
              f32 on CLI-format pairs (1,500 steps, warmup-cosine, loss <
              0.25), a native checkpoint, then ``lmrs-torch --checkpoint``
              on a held-out transcript plain, ``--quantize int8`` and
              ``--kv-quantize int8``: ROUGE-L >= 0.45, >= 2 chunks, no
              failed request, flash and decode kernels launched.  19d:
              ``python -m lmrs_tpu_torch.training.cli`` as a child (exit
              0, its checkpoint served by ``lmrs-torch --checkpoint``),
              then phase 5's configuration at ``VARIANT_LAYERS`` with
              ``scheduler="static"`` on 60 demo segments: a summary, no
              failed request, no kernel launched; its wall.
20. faults — faults and hangs, each sub-phase a line with the card's name
              and power limit.  20a: phase 5's configuration (full depth,
              the first ``CHAOS_SEGMENTS`` demo segments)
              with a seeded plan in ``EngineConfig.fault_plan``
              (``CHAOS_PLAN``: ``kv_cache.allocate`` every 11th occurrence,
              ``scheduler.step`` once mid-map, ``engine.batch`` and
              ``prefix_cache.insert`` once): a summary with no failed
              request, a clean audit, the three kernels launched, the
              plane's occurrence counts printed; a second run on a fresh
              engine with the same plan gives the same counts, fires and
              summary; the plan is uninstalled after.  20b (``VARIANT_LAYERS``,
              ``LMRS_WATCHDOG_S`` = ``WEDGE_S``): a host stall
              (``scheduler.heartbeat``, ``action: "stall"``) and a device
              stall (``torch.cuda._sleep`` of ``DEVICE_STALL_S`` queued on
              the engine's stream while the batch decodes): each declared
              within the threshold plus ``WEDGE_MARGIN_S`` (the postmortem's
              ``stalled_s``), the requests ``wedged`` with an error, a
              ``watchdog`` postmortem that validates, ``wedged()`` and an
              in-process server's ``/healthz`` 503 ``wedged: true``, the
              executor's retries completing through the kernels with the
              undisturbed run's greedy texts once the engine re-arms, a
              clean audit; then ``LMRS_WATCHDOG=0`` (inline) gives the same
              texts.  20c: ``lmrs-serve-torch --supervise`` (through
              ``--layers-child``: the children at ``VARIANT_LAYERS``) with
              ``--jobs-dir``:
              the child in the pidfile SIGKILLed mid-job, respawned; its
              successor, started on a plan file that stalls its
              ``scheduler.heartbeat`` past its ``LMRS_WATCHDOG_S``, turns
              ``/healthz`` 503 wedged and is SIGKILLed and respawned by the
              supervisor; the plan file emptied once the wedge is seen; the
              job ends ``done`` with no journaled chunk re-mapped;
              start-up, kill-to-healthy and resume-to-done seconds; the
              supervisor exits 0 on SIGTERM.  20d: a ``RouterEngine`` with
              ``LMRS_HEDGE_MS`` over a straggling server (a child at
              ``VARIANT_LAYERS`` whose heartbeat stalls under its watchdog
              threshold) and one in this process: the hedge wins
              (``{"hedges": 1, "wins": 1}``) with the winner's own text for
              the request, the loser cancels it and exits with a clean
              audit; a streamed request does not hedge.
21. fleet (``run_fleet_path``; each sub-phase prints the card's name and
    power limit): 21a, QoS on the main path at full bench-8b depth:
    ``FLEET_WAVE`` = 16 of phase 5's map prompts as tenant ``bulk`` class
    ``batch`` (``TenantStampEngine``) then 4 as tenant ``live`` class
    ``interactive``, one ``generate_batch`` of 64 tokens each over
    ``FLEET_PAGES`` pages with the tracer on: the interactive requests
    admitted first, ``lmrs_qos_reorders_total`` >= 1, a preemption whose
    every ``qos_preempt`` victim is batch and
    ``lmrs_qos_preempt_victims_total`` equal to the preemptions, no failed
    request, a clean audit, flash, decode and span launches; the same wave
    with ``LMRS_QOS=0`` admits FIFO with no reorder.  Median TTFT per class
    and each wall are printed, not gated.  21b: two ``role="both"``
    servers over 8-layer bench-8b engines (B built under ``FLEET_SLO``: a
    1 ms TTFT target, 3 s windows) and a colocated ``RouterEngine``: a
    tenant's second request follows its first (``tenant_route.routed``),
    B burns its objective and the next requests go to A
    (``slo_route.penalized``), then a warm host is drained: its page set
    moves to the sibling over ``/v1/kv``, whose rerun is a prefix hit
    through the span kernel with fewer prefill tokens than cold and the
    warm host's own prefix-hit text; the drained host is removed, the
    last one cannot be, audits clean.  21c: an ``Autoscaler`` ticked by
    hand over B alone: one tick spawns one ``SupervisedHostPool`` child on
    the card (through ``--layers-child``), which serves a request; once
    B's burn clears, a tick drains the child, a later one removes it, the
    supervisor exits 0 and the three ``lmrs_autoscale_*`` counters read 1.
22. tooling (``run_tooling_path``, on the card's host): the native host
    runtime (``lmrs_tpu_torch/runtime/native.py``) against the port's
    Python versions on every segment of the demo transcript (cleaning,
    one batch call, and approximate counts) and on a seeded script of
    ``TOOLING_OPS`` alloc/incref/free/refcount operations over phase 5's
    112-page pool (``testing/alloc_script.py``): every outcome equal; each
    run timed both ways (best of ``TOOLING_REPS``, MB/s and ops/s).  Then
    ``python -m lmrs_tpu_torch.analysis --json`` (``lmrs-lint-torch``) on
    this checkout in a child: exit 0, no new finding, its seconds.  The
    phase must take under ``TOOLING_BUDGET_S`` seconds.
    Then the script's total seconds.
23. the ``{"kernels": [...]}`` line (each kernel, then each hd-256 build
    as ``<name>@hd256``; the ancestor-mask builds as ``ragged_spans_anc``
    and ``ragged_spans_anc_int8``), then ``{"ok": true, "device": ...}``.

No phase catches its own failure: any exception exits non-zero before the
last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

TOL = 2e-2                 # bf16 kernel vs bf16 plain version, |out| ~ O(1)
LOGIT_TOL = 0.25           # bf16 card vs f32 CPU logits through 1-2 layers
# Depths cut when phase 18 took the script past ~900 s (on the slower of
# the card's hosts, past ~1,100 s): phases 6-9, 12, 15a-15b, 16 and 17b
# (full until then) and phase 11 (8).  Their gates and flows do not depend
# on depth.  Two depths are not cut because a check needs them: the
# phase-4 model checks run 2 layers, so a layer's offset into the pool's
# folded page axis is compared with the CPU, and phase 14 runs all 32 of
# Mixtral's layers, so its 64 GiB gate shows the whole int8 model fits one
# card.  Phases 5, 13, 15c, 18c-18e and 20a keep full depth.  Since phase
# 20 (with which the uncut script took 1,260 s on a slow card host), 10,
# 12b, 17a's child and 18a-18b run 8 layers too: their gates count
# launches, chunks, records and schedules (18b's against 18a's), not
# depth.
MODEL_CHECK_LAYERS = 2
VARIANT_LAYERS = 8
MIXTRAL_LAYERS = 32


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def peaks() -> tuple[float, float]:
    """(dense bf16 FLOP/s, HBM bytes/s) of the card, from the port's one
    table of data-sheet peaks (``utils/perf_model.chip_spec``)."""
    from lmrs_tpu_torch.utils.perf_model import chip_spec

    spec = chip_spec()
    return spec.peak_flops, spec.peak_hbm_bw


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    peak_flops, peak_bytes = peaks()
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


KV_TIE = 2.0 ** -5         # a scale that divides half-integer multiples to .5


def int8_case(x: dict, tie_tokens, tie_row: int, gen: torch.Generator) -> dict:
    """A bf16 kernel case in its int8 form: random int8 pools, K/V scales
    [rows, K, hd] from ``kv_scale_from`` on random bf16 K/V, and row
    ``tie_row`` with scale 2^-5 whose new K/V (flat tokens ``tie_tokens``)
    are half-integer multiples of it: every x / s is an exact .5 tie, and
    four values saturate past 127 (bf16 holds all of them exactly)."""
    from lmrs_tpu_torch.ops.quant import kv_scale_from

    y = dict(x)
    for name in ("k_pages", "v_pages"):
        y[name] = torch.randint(-127, 128, x[name].shape, generator=gen,
                                device="cuda", dtype=torch.int8)
    rows, kh, hd = (x["page_tables"].shape[0], x["k_pages"].shape[1],
                    x["k_pages"].shape[3])
    for name, new in (("kscale", "k_new"), ("vscale", "v_new")):
        kv = torch.randn(rows, 64, kh, hd, generator=gen, device="cuda").bfloat16()
        sc = kv_scale_from(kv, torch.ones(rows, 64, dtype=torch.bool, device="cuda"))
        sc[tie_row] = KV_TIE
        y[name] = sc.contiguous()
        m = torch.randint(-127, 127, y[new][tie_tokens].shape, generator=gen,
                          device="cuda")
        ties = (m + 0.5) * KV_TIE
        ties.view(-1)[:4] = torch.tensor([160.0, -160.0, 130.0, -130.0],
                                         device="cuda") * KV_TIE
        y[new] = y[new].clone()
        y[new][tie_tokens] = ties.bfloat16()
    return y


def pool_bytes(x: dict) -> tuple[int, float]:
    """(bytes per K or V pool value, bytes of the scale operands)."""
    e = x["k_pages"].element_size()
    return e, (4.0 * (x["kscale"].numel() + x["vscale"].numel())
               if "kscale" in x else 0.0)


def time_ms(fn, reps: int = 10) -> float:
    """Median device ms of ``fn`` over ``reps`` launches, L2 flushed before
    each and the wrapper's host work kept out of the timed window
    (``lmrs_tpu_torch.utils.kernel_ab.time_ms``)."""
    from lmrs_tpu_torch.utils.kernel_ab import time_ms as timed

    return timed(fn, reps)


# ------------------------------------------------------------ phase 3

PHASE3_SEGMENTS = [700, 512, 333, 260]  # one packed 2,048-token bin


def flash_spans(x: dict, seg_lens: list[int] | None) -> list[tuple[int, int]]:
    """(start, length) of each causal run in row 0: the segments of a
    packed row, else the row's valid prefix."""
    if seg_lens is None:
        return [(0, int(x["lengths"][0]))]
    starts = [sum(seg_lens[:i]) for i in range(len(seg_lens))]
    return list(zip(starts, seg_lens))


def flash_bound(x: dict, seg_lens: list[int] | None) -> tuple[float, str]:
    """Bound of one flash launch on these inputs: q, k, v read and out
    written once in bf16, lengths and segment ids (int32); operations
    4·H·hd per (query, visible key) pair of each causal run."""
    b, S, H, hd = x["q"].shape
    K = x["k"].shape[2]
    flops = 4.0 * H * hd * sum(n * (n + 1) / 2 for _, n in flash_spans(x, seg_lens))
    nbytes = (2.0 * b * (2 * S * H * hd + 2 * S * K * hd)
              + 4.0 * (b + (b * S if seg_lens is not None else 0)))
    return bound(flops, nbytes)


def flash_library(x: dict, seg_lens: list[int] | None):
    """Two PyTorch yardsticks for one flash launch (timed, never used by
    the port): (fair, dense).  fair: ``scaled_dot_product_attention`` with
    ``is_causal=True`` on the flash backend, GQA by ``enable_gqa``, one
    call per causal run (a packed row's segments, timed together).  dense:
    one call with the [S, S] boolean mask of the whole row and the kv heads
    repeated outside the timed call (no flash backend takes a mask; it
    computes all S² pairs), kept beside the fair one for comparison with
    older records."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = x["q"], x["k"], x["v"]
    S, H = q.shape[1], q.shape[2]
    runs = [tuple(t[:, a:a + n].transpose(1, 2) for t in (q, k, v))
            for a, n in flash_spans(x, seg_lens)]

    def fair():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return [F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                                   enable_gqa=True)
                    for qq, kk, vv in runs]

    idx = torch.arange(S, device="cuda")
    length = int(x["lengths"][0])
    mask = (idx[None, :] <= idx[:, None]) & (idx[None, :] < length)
    if seg_lens is not None:
        seg = x["segment_ids"][0]
        mask &= seg[:, None] == seg[None, :]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(H // k.shape[2], dim=2).transpose(1, 2).contiguous()
              for t in (k, v))

    def dense():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[None, None])

    return fair, dense


def time_flash(x: dict, seg_lens: list[int] | None, want: torch.Tensor) -> dict:
    """Kernel, plain and library times of one flash shape, its bound, and
    the fair yardstick's max |err| against the plain version (it computes
    the same rows)."""
    from lmrs_tpu_torch.ops import flash_attention as fa

    fair, dense = flash_library(x, seg_lens)
    lib = torch.cat([o.transpose(1, 2) for o in fair()], dim=1)
    n = lib.shape[1]
    b_ms, b_by = flash_bound(x, seg_lens)
    return {"ms": time_ms(lambda: fa.flash_attention(**x)),
            "plain_ms": time_ms(lambda: fa.flash_attention_ref(**x), reps=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(fair),
            "library": "scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True), flash backend, one call per run",
            "library_max_abs_err":
                (lib.float() - want[:, :n].float()).abs().max().item(),
            "library_dense_mask_ms": time_ms(dense)}


def flash_check(name: str, x: dict) -> tuple[float, torch.Tensor]:
    """Kernel vs plain within TOL and a repeat launch bit-identical:
    (max |err|, the plain output)."""
    from lmrs_tpu_torch.ops import flash_attention as fa

    got = fa.flash_attention(**x)
    again = fa.flash_attention(**x)
    want = fa.flash_attention_ref(**x)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"flash kernel vs plain ({name}): max |err| {err} > {TOL}")
    if not torch.equal(got, again):
        raise AssertionError(f"flash kernel ({name}): two launches on the same "
                             "inputs differ")
    return err, want


def check_flash(gen: torch.Generator) -> dict:
    """Phase 3's flash row: one packed 2,048-token bin of 4 segments and a
    padded tail (the kernels line's times), and an unpacked row with
    lengths < S; q/k/v as strided views of one qkv product."""
    from lmrs_tpu_torch.utils.kernel_ab import flash_inputs

    S, H, K, hd = 2048, 32, 8, 128
    x = flash_inputs(gen, PHASE3_SEGMENTS, S)
    err_packed, want = flash_check("packed", x)
    err_unpacked, _ = flash_check("unpacked", flash_inputs(gen, None, S,
                                                           lengths=[1537]))
    return {"name": "flash_prefill", "route": "cuda",
            "source": "lmrs_tpu_torch/csrc/flash_prefill.cu",
            "replaces": "lmrs_tpu/ops/flash_attention.py:208",
            "max_abs_err": max(err_packed, err_unpacked),
            "max_abs_err_packed": err_packed,
            "max_abs_err_unpacked": err_unpacked,
            "repeat_bit_identical": True,
            **time_flash(x, PHASE3_SEGMENTS, want),
            "shape": f"packed S={S} segs={PHASE3_SEGMENTS} H={H} K={K} "
                     f"hd={hd} bf16"}


def check_flash_cases(gen: torch.Generator) -> list[dict]:
    """The flash kernel at its edges (``kernel_ab.FLASH_CASES``, the card
    tests' cases), each within TOL of the plain version and bit-identical
    on a repeat launch."""
    from lmrs_tpu_torch.utils.kernel_ab import FLASH_CASES, flash_inputs

    out = []
    for name, (b, s, h, kh, hd, lens, seg_lens) in FLASH_CASES.items():
        x = flash_inputs(gen, seg_lens, s, h, kh, hd, b, lens)
        err, _ = flash_check(name, x)
        out.append({"name": "flash_prefill", "case": name, "max_abs_err": err,
                    "repeat_bit_identical": True,
                    "shape": f"B={b} S={s} H={h} K={kh} hd={hd} "
                             f"lengths={x['lengths'].tolist()} segs={seg_lens}"})
    return out


def check_decode(gen: torch.Generator, int8: bool = False) -> dict:
    from lmrs_tpu_torch.ops import paged_attention as pa

    B, H, K, hd, ps, W, P = 8, 32, 8, 128, 128, 16, 256
    dev = "cuda"
    # mixed lengths: empty row, 1 token, a page boundary (128, 129), the
    # table's full width (2048), and ordinary mid-page rows
    lens_l = [0, 1, 128, 129, 700, 1500, 2048, 1000]
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    tables = perm[: B * W].view(B, W).to(torch.int32)
    tables[0] = 0  # the empty row carries the null table
    bf = lambda *shape: torch.randn(*shape, generator=gen, device=dev).bfloat16()  # noqa: E731
    x = dict(q=bf(B, H, hd), k_new=bf(B, K, hd), v_new=bf(B, K, hd),
             k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
             page_tables=tables,
             kv_lens=torch.tensor(lens_l, dtype=torch.int32, device=dev))
    if int8:
        x = int8_case(x, 4, 4, gen)  # row 4's new K/V: exact ties
    x2 = {k: v.clone() for k, v in x.items()}
    got = pa.paged_decode_fused(**x)
    want = pa.paged_decode_fused_ref(**x2)
    torch.cuda.synchronize()
    name = "paged_decode_fused_int8" if int8 else "paged_decode_fused"
    err = (got.float() - want.float()).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"{name} kernel vs plain: max |err| {err} > {TOL}")
    if not (torch.equal(x["k_pages"], x2["k_pages"])
            and torch.equal(x["v_pages"], x2["v_pages"])):
        raise AssertionError(f"{name} kernel pool writes differ from the plain version")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError(f"{name} kernel: the kv_len == 0 row is not zero")

    ms = time_ms(lambda: pa.paged_decode_fused(**x))
    plain_ms = time_ms(lambda: pa.paged_decode_fused_ref(**x2), reps=3)
    b_ms, b_by = decode_bound(x)
    return {"name": name, "route": "cuda",
            "source": "lmrs_tpu_torch/csrc/paged_decode.cu",
            "replaces": "lmrs_tpu/ops/paged_attention.py:1495",
            "max_abs_err": err, "pool_writes_exact": True, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "shape": f"B={B} W={W} ps={ps} H={H} K={K} hd={hd} lens={lens_l} "
                     f"{'int8 pools' if int8 else 'bf16'}"}


def decode_bound(x: dict, write: bool = True) -> tuple[float, str]:
    """Bound of one decode launch on these inputs: the live K/V read (e
    bytes a value), q read, out written (bf16), and for the write-fused
    kernel k_new/v_new read (bf16) and written into the pool for each row
    that writes, the rows' f32 scales (int8); int32 tables and lengths."""
    B, H, hd = x["q"].shape
    _, K, ps, _ = x["k_pages"].shape
    W = x["page_tables"].shape[1]
    lens_l = x["kv_lens"].tolist()
    live = sum(min(max(n, 0), W * ps) for n in lens_l)
    written = sum(1 for n in lens_l if 0 < n <= W * ps) if write else 0
    e, scale_bytes = pool_bytes(x)
    flops = 4.0 * H * hd * live
    nbytes = (e * 2.0 * live * K * hd
              + 2.0 * (2 * B * H * hd + (2 * B * K * hd if write else 0))
              + e * 2.0 * written * K * hd + scale_bytes + 4.0 * (B * W + B))
    return bound(flops, nbytes)


def span_bound(x: dict) -> tuple[float, str]:
    """Bound of one span dispatch on these inputs (``span_work``)."""
    return bound(*span_work(x))


def span_work(x: dict) -> tuple[float, float]:
    """(operations, bytes) of one span dispatch on these inputs: the
    prefix K/V read once (e bytes a value), q read, out written (every
    flat row), the new K/V
    read (bf16) and written into the pool, the rows' f32 scales (int8);
    int32 tables, lengths, starts and span lengths (and the ancestor masks,
    one word a flat token, when given).  Operations: 4·H·hd per (query
    token, attended column): a token with a nonzero mask attends its row's
    context and the span offsets its bits name, any other its causal
    prefix."""
    tp, H, hd = x["q"].shape
    b, W = x["page_tables"].shape
    _, K, ps, _ = x["k_pages"].shape
    cap = W * ps
    anc = x["anc_masks"].tolist() if "anc_masks" in x else None
    rows = [(int(base), int(n), int(s)) for base, n, s in
            zip(x["kv_lens"].tolist(), x["q_lens"].tolist(),
                x["q_starts"].tolist()) if n > 0]
    span = sum(n for _, n, _ in rows)
    prefix = sum(min(base, cap) for base, _, _ in rows)
    written = sum(max(0, min(base + n, cap) - base) for base, n, _ in rows)
    attended = 0
    for base, n, s in rows:
        for j in range(n):
            m = anc[s + j] & 0xFFFFFFFF if anc else 0
            attended += (min(base, cap) + sum(1 for o in range(32)
                                              if m >> o & 1 and base + o < cap)
                         if m else min(base + j + 1, cap))
    flops = 4.0 * H * hd * attended
    e, scale_bytes = pool_bytes(x)
    nbytes = (e * 2.0 * prefix * K * hd
              + 2.0 * (span * H * hd + tp * H * hd + 2 * span * K * hd)
              + e * 2.0 * written * K * hd + scale_bytes
              + 4.0 * (b * W + 3 * b + (tp if anc else 0)))
    return flops, nbytes


def _span_inputs(gen: torch.Generator, case: str, H: int = 32, K: int = 8,
                 hd: int = 128) -> dict:
    """One span dispatch at bench-8b widths unless given (H=32, K=8,
    hd=128; ps=128, W=16, 8 table rows), as the main path issues it."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    ps, W = 128, 16
    dev = "cuda"
    if case == "mixed":
        # a mixed step: 7 decode rows + the 249-token slice a 256-token
        # budget leaves, from a prefix hit's 384-token base; 512 flat tokens
        q_lens = [1] * 7 + [249]
        bases = [100, 400, 700, 1000, 1300, 1600, 1900, 384]
        tp = 512
    else:
        # a continuation chunk: one 1,300-token tail after a 384-token
        # prefix hit, the other 7 rows idle
        q_lens, bases, tp = [1300] + [0] * 7, [384] + [0] * 7, None
    q_starts, total = pa.pack_spans(q_lens)
    tp = tp or total
    b = len(q_lens)
    n_pages = b * W + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bf = lambda *shape: torch.randn(*shape, generator=gen, device=dev).bfloat16()  # noqa: E731
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    return dict(q=bf(tp, H, hd), k_new=bf(tp, K, hd), v_new=bf(tp, K, hd),
                k_pages=bf(n_pages, K, ps, hd), v_pages=bf(n_pages, K, ps, hd),
                page_tables=perm[: b * W].view(b, W).to(torch.int32),
                kv_lens=i32(bases), q_starts=i32(q_starts), q_lens=i32(q_lens))


def check_spans(gen: torch.Generator, int8: bool = False) -> list[dict]:
    """The span kernel against its plain version at the mixed-step and
    continuation shapes; the kernels line takes the mixed step (the span
    dispatch the main path issues most) and the larger error.  ``int8``:
    the int8 variant, with the slice row (mixed) or the continuation row
    carrying the exact ties."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    name = "ragged_spans_int8" if int8 else "ragged_spans"
    out = []
    for case in ("mixed", "continuation"):
        x = _span_inputs(gen, case)
        if int8:
            row = 7 if case == "mixed" else 0
            s0, n0 = int(x["q_starts"][row]), int(x["q_lens"][row])
            x = int8_case(x, slice(s0, s0 + n0), row, gen)
        x2 = {k: v.clone() for k, v in x.items()}
        got = pa.ragged_spans(**x)
        want = pa.ragged_spans_ref(**x2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= TOL:
            raise AssertionError(f"{name} kernel vs plain ({case}): max |err| "
                                 f"{err} > {TOL}")
        exact = (torch.equal(x["k_pages"], x2["k_pages"])
                 and torch.equal(x["v_pages"], x2["v_pages"]))
        if not exact:
            raise AssertionError(f"{name} kernel pool writes differ from the "
                                 f"plain version ({case})")
        ms = time_ms(lambda: pa.ragged_spans(**x))
        plain_ms = time_ms(lambda: pa.ragged_spans_ref(**x2), reps=3)
        tp, H, hd = x["q"].shape
        b, W = x["page_tables"].shape
        _, K, ps, _ = x["k_pages"].shape
        rows = [(int(base), int(n)) for base, n in
                zip(x["kv_lens"].tolist(), x["q_lens"].tolist()) if n > 0]
        b_ms, b_by = span_bound(x)
        out.append({"name": name, "route": "cuda",
                    "source": "lmrs_tpu_torch/csrc/ragged_spans.cu",
                    "replaces": "lmrs_tpu/ops/paged_attention.py:1137",
                    "case": case, "max_abs_err": err,
                    "pool_writes_exact": exact, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None,
                    "shape": f"Tp={tp} q_lens={[n for _, n in rows]} "
                             f"bases={[base for base, _ in rows]} B={b} "
                             f"W={W} ps={ps} H={H} K={K} hd={hd} "
                             f"{'int8 pools' if int8 else 'bf16'}"})
        del x, x2
    return out


def check_multi(gen: torch.Generator, int8: bool = False) -> dict:
    """The verify step of the speculative path: 8 rows x T=5 tokens at
    bench-8b widths.  kv_lens count the 5 tokens; row 2's span (125..129)
    straddles a page boundary and row 5's (2045..2049) overhangs the
    2048-token window, so its last two tokens are neither written nor
    attended.  No table here is the null page; the pool comparison leaves
    it out all the same, as the kernel's contract says."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    B, T, H, K, hd, ps, W, max_pos = 8, 5, 32, 8, 128, 128, 16, 2048
    dev = "cuda"
    lens_l = [6, 133, 130, 700, 1500, 2050, 1000, 305]
    P = B * W + 1
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    tables = perm.view(B, W).to(torch.int32)
    kv_lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    bf = lambda *shape: torch.randn(*shape, generator=gen, device=dev).bfloat16()  # noqa: E731
    x = dict(q=bf(B, T, H, hd), k_new=bf(B, T, K, hd), v_new=bf(B, T, K, hd),
             k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
             page_tables=tables, kv_lens=kv_lens)
    if int8:
        x = int8_case(x, 3, 3, gen)  # row 3's 5 tokens: exact ties
    x2 = {k: v.clone() for k, v in x.items()}
    name = "paged_decode_multi_int8" if int8 else "paged_decode_multi"
    got = pa.paged_decode_multi(**x, max_pos=max_pos)
    want = pa.paged_decode_multi_ref(**x2, max_pos=max_pos)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"{name} kernel vs plain: max |err| {err} > {TOL}")
    exact = all(torch.equal(x[k][1:], x2[k][1:]) for k in ("k_pages", "v_pages"))
    if not exact:
        raise AssertionError(f"{name} kernel pool writes differ from the plain "
                             "version outside the null page")
    ms = time_ms(lambda: pa.paged_decode_multi(**x, max_pos=max_pos))
    plain_ms = time_ms(lambda: pa.paged_decode_multi_ref(**x2, max_pos=max_pos),
                       reps=3)
    b_ms, b_by = multi_bound(x, max_pos)
    return {"name": name, "route": "cuda",
            "source": "lmrs_tpu_torch/csrc/paged_decode_multi.cu",
            "replaces": "lmrs_tpu/ops/paged_attention.py:852",
            "max_abs_err": err, "pool_writes_exact_outside_null_page": exact,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "shape": f"B={B} T={T} W={W} ps={ps} H={H} K={K} hd={hd} "
                     f"kv_lens={lens_l} max_pos={max_pos} "
                     f"{'int8 pools' if int8 else 'bf16'}"}


def multi_bound(x: dict, max_pos: int) -> tuple[float, str]:
    """Bound of one verify launch on these inputs: the prior K/V read once
    (e bytes a value), q read, out written, the new K/V read (bf16) and its
    in-window rows written into the pool, the rows' f32 scales (int8);
    int32 tables and lengths.  Operations: 4·H·hd per (query token,
    attended column)."""
    B, T, H, hd = x["q"].shape
    _, K, ps, _ = x["k_pages"].shape
    W = x["page_tables"].shape[1]
    cap = min(W * ps, max_pos)
    bases = [max(n - T, 0) for n in x["kv_lens"].tolist()]
    prior = sum(min(b, cap) for b in bases)
    written = sum(max(0, min(b + T, cap) - b) for b in bases)
    attended = sum(min(b + j + 1, cap) for b in bases for j in range(T))
    flops = 4.0 * H * hd * attended
    e, scale_bytes = pool_bytes(x)
    nbytes = (e * 2.0 * prior * K * hd
              + 2.0 * (2 * B * T * H * hd + 2 * B * T * K * hd)
              + e * 2.0 * written * K * hd + scale_bytes + 4.0 * (B * W + B))
    return bound(flops, nbytes)


def check_walk(gen: torch.Generator) -> dict:
    """The walk-only decode kernel at the write-fused kernel's shape; it
    has no caller on any path, so this check is its only launch."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    B, H, K, hd, ps, W, P = 8, 32, 8, 128, 128, 16, 256
    dev = "cuda"
    lens_l = [0, 1, 128, 129, 700, 1500, 2048, 1000]
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    tables = perm[: B * W].view(B, W).to(torch.int32)
    tables[0] = 0  # the empty row carries the null table
    kv_lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    k_pages = torch.randn(P, K, ps, hd, generator=gen, device=dev).bfloat16()
    v_pages = torch.randn(P, K, ps, hd, generator=gen, device=dev).bfloat16()
    q = torch.randn(B, H, hd, generator=gen, device=dev).bfloat16()
    kp0, vp0 = k_pages.clone(), v_pages.clone()
    got = pa.paged_decode(q, k_pages, v_pages, tables, kv_lens)
    want = pa.paged_decode_ref(q, k_pages, v_pages, tables, kv_lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"walk-only kernel vs plain: max |err| {err} > {TOL}")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("walk-only kernel: the kv_len == 0 row is not zero")
    if not (torch.equal(k_pages, kp0) and torch.equal(v_pages, vp0)):
        raise AssertionError("walk-only kernel wrote into the pools")
    del kp0, vp0
    ms = time_ms(lambda: pa.paged_decode(q, k_pages, v_pages, tables, kv_lens))
    plain_ms = time_ms(lambda: pa.paged_decode_ref(q, k_pages, v_pages, tables,
                                                   kv_lens), reps=3)
    b_ms, b_by = decode_bound(dict(q=q, k_pages=k_pages, page_tables=tables,
                                   kv_lens=kv_lens), write=False)
    return {"name": "paged_decode", "route": "cuda",
            "source": "lmrs_tpu_torch/csrc/paged_decode.cu",
            "replaces": "lmrs_tpu/ops/paged_attention.py:1687",
            "max_abs_err": err, "pools_untouched": True, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "shape": f"B={B} W={W} ps={ps} H={H} K={K} hd={hd} lens={lens_l} bf16"}


BENCH8B = dict(H=32, K=8, hd=128)  # bench-8b's attention widths
TINY = dict(H=8, K=4, hd=32)       # the default tiny preset's
GEMMA = {"gemma-7b": dict(H=16, K=16, hd=256),  # multi-head
         "gemma-2b": dict(H=8, K=1, hd=256)}    # multi-query


def _split_decode_inputs(gen: torch.Generator, int8: bool, H: int = 32,
                         K: int = 8, hd: int = 128) -> dict:
    """Decode rows at the split boundaries, bench-8b widths unless given
    (ps=128, W=16): exactly one split (``decode_split``) of tokens, one
    more (the write opens a new split), W·ps, a stale length past W·ps, 0
    (null table) and 1."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    B, ps, W = 6, 128, 16
    split = pa.decode_split(B, K)
    dev = "cuda"
    P = B * W + 1
    tables = (torch.randperm(P - 1, generator=gen, device=dev)[: B * W] + 1
              ).view(B, W).to(torch.int32)
    tables[4] = 0
    bf = lambda *shape: torch.randn(*shape, generator=gen, device=dev).bfloat16()  # noqa: E731
    x = dict(q=bf(B, H, hd), k_new=bf(B, K, hd), v_new=bf(B, K, hd),
             k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
             page_tables=tables,
             kv_lens=torch.tensor([split, split + 1, W * ps, W * ps + 100, 0, 1],
                                  dtype=torch.int32, device=dev))
    return int8_case(x, 1, 1, gen) if int8 else x


def _split_span_inputs(gen: torch.Generator, int8: bool, H: int = 32,
                       K: int = 8, hd: int = 128) -> dict:
    """Span rows at the split boundaries (bench-8b widths unless given):
    decode rows whose columns end on a SPAN_SPLIT boundary and one past it,
    a 48-token continuation at base 1000 (split: at most 4 query tiles)
    whose walk crosses three splits, a 900-token continuation at base 300
    (walked unsplit), a decode row at W·ps - 1, a stale base past W·ps, an
    inactive row and a fresh one-token row."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    ps, W = 128, 16
    split = pa.SPAN_SPLIT
    dev = "cuda"
    rows = [(split - 1, 1), (split, 1), (1000, 48), (300, 900),
            (W * ps - 1, 1), (W * ps + 50, 1), (0, 0), (0, 1)]
    q_lens = [n for _, n in rows]
    q_starts, tp = pa.pack_spans(q_lens)
    b = len(rows)
    P = b * W + 1
    bf = lambda *shape: torch.randn(*shape, generator=gen, device=dev).bfloat16()  # noqa: E731
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    x = dict(q=bf(tp, H, hd), k_new=bf(tp, K, hd), v_new=bf(tp, K, hd),
             k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
             page_tables=(torch.randperm(P - 1, generator=gen, device=dev)[: b * W]
                          + 1).view(b, W).to(torch.int32),
             kv_lens=i32([base for base, _ in rows]), q_starts=i32(q_starts),
             q_lens=i32(q_lens))
    if int8:
        s0, n0 = int(q_starts[2]), q_lens[2]
        x = int8_case(x, slice(s0, s0 + n0), 2, gen)
    return x


def _split_multi_inputs(gen: torch.Generator, int8: bool, H: int = 32,
                        K: int = 8, hd: int = 128) -> dict:
    """Verify rows (T = 5) at MULTI_SPLIT's boundaries (bench-8b widths
    unless given, ps=128, W=16, max_pos 2048): tokens straddling a split, a
    last token on a split's last column, tokens overhanging the window, T
    tokens inside one split, a stale length past W·ps, the null-table row of
    an empty slot (kv_lens = T, row 5), tokens opening a split and a fresh
    row.  int8: row 0's new K/V are exact ties."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    T, ps, W = 5, 128, 16
    split = pa.MULTI_SPLIT
    lens = [split + 3, split, W * ps + 2, 700, W * ps + 100, T, 2 * split + T, T]
    B = len(lens)
    P = B * W + 1
    tables = (torch.randperm(P - 1, generator=gen, device="cuda")[: B * W] + 1
              ).view(B, W).to(torch.int32)
    tables[5] = 0
    bf = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").bfloat16()  # noqa: E731
    x = dict(q=bf(B, T, H, hd), k_new=bf(B, T, K, hd), v_new=bf(B, T, K, hd),
             k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
             page_tables=tables,
             kv_lens=torch.tensor(lens, dtype=torch.int32, device="cuda"))
    x = int8_case(x, 0, 0, gen) if int8 else x
    return {**x, "max_pos": 2048}


MULTI_REAL = [0, 1, 2, 3, 4, 6, 7]  # _split_multi_inputs' rows with real tables


def _boundary_check(name: str, fn, ref, x: dict, pools: str,
                    rows=slice(None), pages=slice(None)) -> dict:
    """Kernel vs plain within TOL, the pools bit-exact (``pools`` =
    "written") or untouched ("untouched"), and a second launch on the same
    inputs (pools restored) bit-identical to the first.  ``rows`` and
    ``pages`` leave out the verify kernel's null-table rows and the null
    page they all write."""
    clone = lambda d: {k: (v.clone() if torch.is_tensor(v) else v)  # noqa: E731
                       for k, v in d.items()}
    x0, x2 = clone(x), clone(x)
    got = fn(**x)
    want = ref(**x2)
    torch.cuda.synchronize()
    err = (got[rows].float() - want[rows].float()).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"{name} at the split boundaries: max |err| {err} > {TOL}")
    base = x2 if pools == "written" else x0
    if not all(torch.equal(x[k][pages], base[k][pages]) for k in ("k_pages", "v_pages")):
        raise AssertionError(f"{name} at the split boundaries: pools differ "
                             f"from the plain version ({pools})")
    again = fn(**clone(x0))
    torch.cuda.synchronize()
    if not torch.equal(got[rows], again[rows]):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    return {"name": name, "max_abs_err": err, "pools": pools + " (exact)",
            "repeat_bit_identical": True}


def check_split_boundaries(gen: torch.Generator, widths: dict = BENCH8B) -> list[dict]:
    """The seven split builds at their split-boundary cases, each held
    against its plain version, with bit-exact pools (the verify kernel's
    outside the null page) and a bit-identical repeat launch."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    out = []
    for int8 in (False, True):
        x = _split_decode_inputs(gen, int8, **widths)
        out.append({**_boundary_check(
            "paged_decode_fused_int8" if int8 else "paged_decode_fused",
            pa.paged_decode_fused, pa.paged_decode_fused_ref, x, "written"),
            "kv_lens": x["kv_lens"].tolist()})
        if not int8:
            walk = {k: x[k] for k in ("q", "k_pages", "v_pages", "page_tables",
                                      "kv_lens")}
            out.append({**_boundary_check("paged_decode", pa.paged_decode,
                                          pa.paged_decode_ref, walk, "untouched"),
                        "kv_lens": x["kv_lens"].tolist()})
        y = _split_span_inputs(gen, int8, **widths)
        out.append({**_boundary_check(
            "ragged_spans_int8" if int8 else "ragged_spans", pa.ragged_spans,
            pa.ragged_spans_ref, y, "written"),
            "bases": y["kv_lens"].tolist(), "q_lens": y["q_lens"].tolist()})
        z = _split_multi_inputs(gen, int8, **widths)
        out.append({**_boundary_check(
            "paged_decode_multi_int8" if int8 else "paged_decode_multi",
            pa.paged_decode_multi, pa.paged_decode_multi_ref, z, "written",
            rows=MULTI_REAL, pages=slice(1, None)),
            "kv_lens": z["kv_lens"].tolist(), "null_table_row": 5})
    return out


# tree speculation at speculate_k=4 and the default width: 13-token spans
# at heal 4
TREE_K, TREE_W = 4, 2
ANC_SOURCE = "lmrs_tpu_torch/csrc/ragged_spans.cu"
ANC_REPLACES = "lmrs_tpu/ops/paged_attention.py:1154"  # ragged_spans_xla


def tree_masks(hl: int, width: int = TREE_W, k: int = TREE_K) -> list[int]:
    """The ancestor masks (int32 words) of a tree span [heal (hl), cur,
    width chains of k], from the scheduler's span template: 0 for the heal
    tokens and cur (the causal rule), chain c's node j its heal + cur
    prefix and its own chain through it."""
    from types import SimpleNamespace

    from lmrs_tpu_torch.engine.scheduler import ContinuousScheduler

    ns = SimpleNamespace(_spec_tmpl={}, _spec_width=width, spec_k=k)
    return ContinuousScheduler._tree_span_template(ns, hl)[1].tolist()


def _anc_inputs(gen: torch.Generator, int8: bool, case: str, H: int = 32,
                K: int = 8, hd: int = 128) -> dict:
    """One tree-speculation span dispatch (bench-8b widths unless given,
    ps=128, W=16).  "boundaries": tree spans at heal 0-4 whose bases lie on
    a split boundary (512), a 32-column tile boundary (544: hd 256's
    tiles), a 64-column one (576), nowhere (1000) and one column before a
    split boundary (1535: the span crosses 1536), a 32-token tree whose
    last token has bit 31 set (heal 3, 2 chains of 14), a tree at a stale
    base past W·ps, mask-0 spans in the same dispatch (a 40-token slice, a
    300-token slice walked unsplit, a decode row) and an inactive row.
    "main": phase 12's step, 8 rows x (heal + 9) tokens after 1,500
    context tokens, heals 0-4.  int8: row 3's new K/V are exact ties."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    ps, W = 128, 16
    dev = "cuda"
    if case == "main":
        heals = [0, 1, 2, 3, 4, 0, 1, 2]
        spans = [(1500 - h, tree_masks(h)) for h in heals]
    else:
        spans = [(512, tree_masks(0)), (544, tree_masks(1)),
                 (576, tree_masks(2)), (1000, tree_masks(3)),
                 (1535, tree_masks(4)), (300, tree_masks(3, 2, 14)),
                 (W * ps + 50, tree_masks(0)), (700, [0] * 40),
                 (100, [0] * 300), (129, [0]), (0, [])]
    q_lens = [len(m) for _, m in spans]
    q_starts, tp = pa.pack_spans(q_lens)
    anc = [0] * tp
    for s, (_, m) in zip(q_starts.tolist(), spans):
        anc[s: s + len(m)] = m
    b = len(spans)
    P = b * W + 1
    bf = lambda *shape: torch.randn(*shape, generator=gen, device=dev).bfloat16()  # noqa: E731
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    x = dict(q=bf(tp, H, hd), k_new=bf(tp, K, hd), v_new=bf(tp, K, hd),
             k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
             page_tables=(torch.randperm(P - 1, generator=gen, device=dev)[: b * W]
                          + 1).view(b, W).to(torch.int32),
             kv_lens=i32([base for base, _ in spans]),
             q_starts=i32(q_starts.tolist()), q_lens=i32(q_lens),
             anc_masks=i32(anc))
    if int8:
        s0 = int(q_starts[3])
        x = int8_case(x, slice(s0, s0 + q_lens[3]), 3, gen)
    return x


def check_anc(gen: torch.Generator, widths: dict = BENCH8B) -> list[dict]:
    """The ancestor-mask builds (bf16 and int8) at ``_anc_inputs``'
    boundary cases against ``ragged_spans_ref(anc_masks=)``: within TOL,
    pools exact, a repeat launch bit-identical."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    out = []
    for int8 in (False, True):
        x = _anc_inputs(gen, int8, "boundaries", **widths)
        name = "ragged_spans_anc" + ("_int8" if int8 else "")
        out.append({**_boundary_check(name, pa.ragged_spans,
                                      pa.ragged_spans_ref, x, "written"),
                     "hd": widths["hd"], "H": widths["H"], "K": widths["K"],
                     "bases": x["kv_lens"].tolist(),
                     "q_lens": x["q_lens"].tolist()})
        del x
    return out


def anc_main_shapes(gen: torch.Generator, widths: dict = BENCH8B) -> list[dict]:
    """The ancestor-mask builds at phase 12's step (``_anc_inputs``
    "main"): max |err| against the plain version, ms, bound, plain ms, and
    as the yardstick the unmasked span kernel's ms on the same inputs (the
    same walk over the same columns, causal)."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    rows = []
    for int8 in (False, True):
        x = _anc_inputs(gen, int8, "main", **widths)
        x2 = {k: v.clone() for k, v in x.items()}
        got = pa.ragged_spans(**x)
        want = pa.ragged_spans_ref(**x2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        name = "ragged_spans_anc" + ("_int8" if int8 else "")
        if not err <= TOL:
            raise AssertionError(f"{name} at the main shape: max |err| {err} > {TOL}")
        unmasked = {k: v for k, v in x.items() if k != "anc_masks"}
        b_ms, b_by = span_bound(x)
        flops, nbytes = span_work(x)
        rows.append({"name": name, "route": "cuda", "source": ANC_SOURCE,
                     "replaces": ANC_REPLACES, "hd": widths["hd"],
                     "H": widths["H"], "K": widths["K"], "max_abs_err": err,
                     "ms": time_ms(lambda: pa.ragged_spans(**x)),
                     "plain_ms": time_ms(lambda: pa.ragged_spans_ref(**x2), reps=3),
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "bound_bytes_ms": nbytes / peaks()[1] * 1e3,
                     "bound_operations_ms": flops / peaks()[0] * 1e3,
                     "unmasked_ms": time_ms(lambda: pa.ragged_spans(**unmasked)),
                     "shape": "8 rows x (heal + 9) tokens after 1500, heals "
                              f"{[n - 9 for n in x['q_lens'].tolist()]}, "
                              f"H={widths['H']} K={widths['K']} hd={widths['hd']} "
                              f"ps=128 W=16 {'int8 pools' if int8 else 'bf16'}"})
        del x, x2, unmasked
    return rows


def check_hd32(gen: torch.Generator) -> list[dict]:
    """Phase 3b: every kernel's hd-32 build at the tiny preset's heads,
    flash prefill against its plain version (one packed row of 4 segments
    and a padded tail, and an unpacked row; q/k/v strided views, a repeat
    launch bit-identical) and the paged kernels at their split
    boundaries."""
    from lmrs_tpu_torch.utils.kernel_ab import flash_inputs

    out = []
    for packed in (True, False):
        x = flash_inputs(gen, [300, 257, 200, 150] if packed else None, 1024,
                         TINY["H"], TINY["K"], 32,
                         lengths=None if packed else [777])
        case = "packed" if packed else "unpacked"
        err, _ = flash_check(f"hd 32 {case}", x)
        out.append({"name": "flash_prefill", "max_abs_err": err, "case": case,
                    "repeat_bit_identical": True})
    out += check_split_boundaries(gen, TINY) + check_anc(gen, TINY)
    return [{**r, "hd": 32, "H": TINY["H"], "K": TINY["K"]} for r in out]


def check_hd256(gen: torch.Generator) -> list[dict]:
    """Phase 3c: every kernel's hd-256 build at both Gemma head groupings
    (gemma-7b's 16 over 16, gemma-2b's 8 over 1), as phase 3b holds the
    hd-32 builds: flash prefill packed and not (a repeat launch
    bit-identical) and the paged kernels at their split boundaries (pools
    exact, int8 ties included, a repeat launch bit-identical)."""
    from lmrs_tpu_torch.utils.kernel_ab import flash_inputs

    out = []
    for model, w in GEMMA.items():
        rows = []
        for packed in (True, False):
            x = flash_inputs(gen, [300, 257, 200, 150] if packed else None, 1024,
                             w["H"], w["K"], 256,
                             lengths=None if packed else [777])
            case = "packed" if packed else "unpacked"
            err, _ = flash_check(f"hd 256 {model} {case}", x)
            rows.append({"name": "flash_prefill", "max_abs_err": err,
                         "case": case, "repeat_bit_identical": True})
            del x
        rows += check_split_boundaries(gen, w) + check_anc(gen, w)
        out += [{**r, "hd": 256, "H": w["H"], "K": w["K"], "heads_of": model}
                for r in rows]
        torch.cuda.empty_cache()
    return out


def hd256_main_shapes(gen: torch.Generator) -> list[dict]:
    """Phase 3c's times: every hd-256 build at the main path's shapes, at
    both Gemma head groupings — flash one unpacked 1,600-token row beside
    the fair SDPA call (flash backend: it takes hd 256), decode 8 x 1,501
    tokens, spans phase 5's mixed step, verify 8 x 5 tokens after 1,500 —
    each with its bound, its plain version's time and its time at other
    split sizes."""
    from lmrs_tpu_torch.utils.kernel_ab import flash_inputs

    rows = []
    for model, w in GEMMA.items():
        x = flash_inputs(gen, None, 1600, w["H"], w["K"], 256)
        err, want = flash_check(f"hd 256 {model} main", x)
        rows.append({"name": "flash_prefill", "case": "main_unpacked",
                     "hd": 256, "H": w["H"], "K": w["K"], "heads_of": model,
                     "max_abs_err": err, **time_flash(x, None, want),
                     "shape": f"S=1600 H={w['H']} K={w['K']} hd=256 bf16"})
        del x, want
        rows += [{**r, "heads_of": model}
                 for r in time_main_shapes(gen, w) + anc_main_shapes(gen, w)]
        torch.cuda.empty_cache()
    return rows


def _timed_split(attr: str, value: int, fn) -> float:
    """``time_ms(fn)`` with the wrapper's split set to ``value``."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    keep = getattr(pa, attr)
    setattr(pa, attr, value)
    try:
        return time_ms(fn)
    finally:
        setattr(pa, attr, keep)


def flash_main_shapes(gen: torch.Generator) -> list[dict]:
    """Flash prefill at the main path's shapes: one unpacked 1,600-token
    row (phase 5's map prompts are 1,358-1,871 tokens and never share a
    2,048-token bin, so each is one fresh [1, n] dispatch) and one packed
    reduce-sized bin (three 600-token segments); each checked against the
    plain version, with its bound, plain and library times."""
    from lmrs_tpu_torch.utils.kernel_ab import FLASH_SHAPES, flash_inputs

    rows = []
    for name in ("main_unpacked", "reduce_packed"):
        seg_lens, s = FLASH_SHAPES[name]
        x = flash_inputs(gen, seg_lens, s)
        err, want = flash_check(name, x)
        rows.append({"name": "flash_prefill", "case": name, "max_abs_err": err,
                     **time_flash(x, seg_lens, want),
                     "shape": f"S={s} segs={seg_lens} H=32 K=8 hd=128 bf16"})
        del x, want
    return rows


def time_main_shapes(gen: torch.Generator, widths: dict = BENCH8B) -> list[dict]:
    """The seven split builds at the main path's shapes: decode at 8 rows x
    1,501 tokens (``profile_decode_step``'s step: 1,500 cached + the current
    token), spans at phase 5's mixed step (7 decode rows at 1,500 tokens +
    a 249-token slice at base 384), verify at phase 6's step (8 rows x 5
    tokens after 1,500); each with its bound, its plain version's time, and
    its time at other split sizes.  At bench-8b's widths (the default) also
    phase 3's shapes at the other split sizes."""
    from lmrs_tpu_torch.ops import paged_attention as pa

    B, ps, W = 8, 128, 16
    H, K, hd = widths["H"], widths["K"], widths["hd"]
    dev = "cuda"
    rows = []
    bf = lambda *shape: torch.randn(*shape, generator=gen, device=dev).bfloat16()  # noqa: E731
    P = B * W + 1
    dec = dict(q=bf(B, H, hd), k_new=bf(B, K, hd), v_new=bf(B, K, hd),
               k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
               page_tables=(torch.randperm(P - 1, generator=gen, device=dev)
                            + 1).view(B, W).to(torch.int32),
               kv_lens=torch.full((B,), 1501, dtype=torch.int32, device=dev))
    span = _span_inputs(gen, "mixed", **widths)
    span["kv_lens"] = torch.tensor([1500] * 7 + [384], dtype=torch.int32,
                                   device=dev)
    sweep_d, sweep_s, sweep_v = (128, 256, 512), (256, 512, 1024), (128, 256, 512)
    for name, x, fn, ref, write in (
            ("paged_decode_fused", dec, pa.paged_decode_fused,
             pa.paged_decode_fused_ref, True),
            ("paged_decode_fused_int8", int8_case(dec, 0, 0, gen),
             pa.paged_decode_fused, pa.paged_decode_fused_ref, True),
            ("paged_decode", {k: dec[k] for k in ("q", "k_pages", "v_pages",
                                                  "page_tables", "kv_lens")},
             pa.paged_decode, pa.paged_decode_ref, False),
            ("ragged_spans", span, pa.ragged_spans, pa.ragged_spans_ref, None),
            ("ragged_spans_int8",
             int8_case(span, slice(int(span["q_starts"][7]),
                                   int(span["q_starts"][7]) + 249), 7, gen),
             pa.ragged_spans, pa.ragged_spans_ref, None)):
        call = (lambda x=x, fn=fn: fn(**x))
        is_span = write is None
        b_ms, b_by = span_bound(x) if is_span else decode_bound(x, write)
        attr, values = (("SPAN_SPLIT", sweep_s) if is_span
                        else ("DECODE_SPLIT", sweep_d))
        # the split each DECODE_SPLIT setting gives this launch
        eff = (lambda v: v) if is_span else (
            lambda v: v if B * K >= pa.DECODE_FILL_GROUPS else v // 2)
        rows.append({"name": name, "hd": hd, "H": H, "K": K,
                     "ms": time_ms(call),
                     "plain_ms": time_ms(lambda x=x, ref=ref: ref(**x), reps=3),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "split": eff(getattr(pa, attr)),
                     "ms_by_split": {eff(v): _timed_split(attr, v, call)
                                     for v in values},
                     "shape": ("mixed step: 7 decode rows at 1500 + 249 tokens "
                               "at 384" if is_span else "B=8 x 1501 tokens")
                              + f", H={H} K={K} hd={hd} ps={ps} W={W}"})
    # the verify step of the speculative path: 8 rows x 5 tokens after
    # 1,500 cached (profile_decode_step(tokens=5)'s step)
    T, max_pos = 5, 2048
    ver = dict(q=bf(B, T, H, hd), k_new=bf(B, T, K, hd), v_new=bf(B, T, K, hd),
               k_pages=dec["k_pages"], v_pages=dec["v_pages"],
               page_tables=dec["page_tables"],
               kv_lens=torch.full((B,), 1500 + T, dtype=torch.int32, device=dev))
    for name, x in (("paged_decode_multi", ver),
                    ("paged_decode_multi_int8", int8_case(ver, 0, 0, gen))):
        call = (lambda x=x: pa.paged_decode_multi(**x, max_pos=max_pos))
        b_ms, b_by = multi_bound(x, max_pos)
        rows.append({"name": name, "hd": hd, "H": H, "K": K,
                     "ms": time_ms(call),
                     "plain_ms": time_ms(lambda x=x: pa.paged_decode_multi_ref(
                         **x, max_pos=max_pos), reps=3),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "split": pa.MULTI_SPLIT,
                     "ms_by_split": {v: _timed_split("MULTI_SPLIT", v, call)
                                     for v in sweep_v},
                     "shape": f"B=8 x T={T} tokens after 1500, H={H} K={K} "
                              f"hd={hd} ps={ps} W={W}"})
    if widths != BENCH8B:
        return rows
    # phase 3's shapes at the other split sizes (its own times are in the
    # kernels rows)
    v3 = dict(ver, kv_lens=torch.tensor([6, 133, 130, 700, 1500, 2050, 1000, 305],
                                        dtype=torch.int32, device=dev))
    rows.append({"name": "paged_decode_multi", "shape": "phase 3 verify",
                 "ms_by_split": {v: _timed_split(
                     "MULTI_SPLIT", v,
                     lambda: pa.paged_decode_multi(**v3, max_pos=max_pos))
                     for v in sweep_v}})
    g3 = _span_inputs(gen, "mixed")
    rows.append({"name": "ragged_spans", "shape": "phase 3 mixed step",
                 "ms_by_split": {v: _timed_split("SPAN_SPLIT", v,
                                                 lambda: pa.ragged_spans(**g3))
                                 for v in sweep_s}})
    d3 = dict(dec, kv_lens=torch.tensor([0, 1, 128, 129, 700, 1500, 2048, 1000],
                                        dtype=torch.int32, device=dev))
    rows.append({"name": "paged_decode_fused", "shape": "phase 3 decode",
                 "ms_by_split": {v: _timed_split("DECODE_SPLIT", v,
                                                 lambda: pa.paged_decode_fused(**d3))
                                 for v in sweep_d}})
    return rows


# ------------------------------------------------------------ phase 4

def moe_routes(cfg, records: list) -> tuple[torch.Tensor, torch.Tensor]:
    """One ``forward_paged`` call's routing, from the ``(n, experts)`` of
    each ``moe.route`` call (one a layer): (top-k sets [L, N, k] sorted,
    kept [L, N, k] in that order, from ``assign_slots`` at the call's
    capacity)."""
    from lmrs_tpu_torch.ops import moe

    sets, kept = [], []
    for n, experts in records:
        keep = moe.assign_slots(experts, cfg.n_experts,
                                moe.expert_capacity(n, cfg))[1]
        keep = keep.view(experts.shape[1], n).t()  # [N, k], choice order
        order = experts.argsort(dim=1)
        sets.append(experts.gather(1, order))
        kept.append(keep.gather(1, order))
    return torch.stack(sets), torch.stack(kept)


def model_pass(dev: str, cfg, params: dict, kv8: bool,
               cpu: dict | None = None) -> dict:
    """Every forward of one phase-4 model check on ``dev``: a packed
    prefill of three prompts (517, 300 and 129 tokens), 16 decode steps,
    one span dispatch (rows 0 and 1 decode a token, row 2 takes a
    100-token slice after its 145-token context; int8 KV: row 2
    re-prefills from position 0, a preempted request's continuation that
    owns its slot's scales) and, for a dense model, one 5-token verify
    step.  Inputs come from seeded draws, so both devices see the same;
    the decode steps are teacher-forced with the greedy tokens of ``cpu``
    (the CPU pass) when given, else of this pass.  Returns each compared
    step's logits (f32, on the host), the token rows its comparison reads,
    its ``moe.route`` records, and the KV scale buffers at the end."""
    import numpy as np

    from lmrs_tpu_torch.models.transformer import forward_paged
    from lmrs_tpu_torch.ops import moe
    from lmrs_tpu_torch.ops.paged_attention import pack_spans

    ps, n_pool, steps = 128, 48, 16
    g = torch.Generator().manual_seed(3)
    prompt_lens = [517, 300, 129]
    prompts = [torch.randint(3, 259, (n,), generator=g) for n in prompt_lens]
    # pages: prompt + decode steps per sequence, disjoint, page 0 reserved
    tables, nxt = [], 1
    for n in prompt_lens:
        need = -(-(n + steps) // ps)
        tables.append(list(range(nxt, nxt + need)))
        nxt += need
    W = max(len(t) for t in tables)
    table = torch.tensor([t + [0] * (W - len(t)) for t in tables]).to(dev)
    shape = (cfg.n_layers * n_pool, cfg.n_kv_heads, ps, cfg.hd)
    pool_dt = (torch.int8 if kv8 else
               torch.float32 if dev == "cpu" else torch.bfloat16)
    kp = torch.zeros(shape, dtype=pool_dt, device=dev)
    vp = torch.zeros(shape, dtype=pool_dt, device=dev)
    # int8: per-slot scale buffers (3 slots = the 3 prompts' rows)
    sshape = (cfg.n_layers, len(prompt_lens), cfg.n_kv_heads, cfg.hd)
    scales = ((torch.ones(sshape, device=dev), torch.ones(sshape, device=dev))
              if kv8 else None)
    tokens = torch.cat(prompts)[None]
    positions = torch.cat([torch.arange(n) for n in prompt_lens])[None]
    seg = torch.cat([torch.full((n,), i) for i, n in enumerate(prompt_lens)])[None]
    tok_pages = torch.cat([torch.tensor(t)[torch.arange(n) // ps]
                           for t, n in zip(tables, prompt_lens)])[None]
    last_idx = torch.tensor(prompt_lens).cumsum(0) - 1
    total = torch.tensor([sum(prompt_lens)], dtype=torch.int32)
    out: list[dict] = []
    routes: list = []
    route = moe.route

    def recording_route(router, cfg_, xt):
        res = route(router, cfg_, xt)
        routes.append((xt.shape[0], res[2].cpu()))
        return res

    def run(toks, pos, lens, **kw):
        return forward_paged(params, cfg, toks.to(dev), pos.to(dev), kp, vp,
                             table, lens.to(dev), cfg.max_seq_len,
                             kv_scales=scales,
                             **{k: (v.to(dev) if torch.is_tensor(v) else v)
                                for k, v in kw.items()}).float().cpu()

    def step(logits, rows) -> torch.Tensor:
        """Record one compared step; its greedy tokens for teacher
        forcing (the CPU pass's when given)."""
        out.append({"logits": logits, "rows": rows, "routes": list(routes)})
        routes.clear()
        return (cpu["steps"][len(out) - 1]["logits"] if cpu else logits
                ).argmax(-1)

    moe.route = recording_route
    try:
        cur = step(run(tokens, positions, total, token_pages=tok_pages,
                       segment_ids=seg, packed_last_idx=last_idx,
                       scale_rows=torch.arange(3))[0], last_idx)
        lens = torch.tensor(prompt_lens)
        for _ in range(steps):
            cur = step(run(cur[:, None], lens[:, None],
                           (lens + 1).to(torch.int32))[:, 0], torch.arange(3))
            lens = lens + 1
        q_lens = np.array([1, 1, 100], np.int32)
        q_starts, n_flat = pack_spans(q_lens)
        flat = torch.zeros(n_flat, dtype=torch.long)
        row_flat = np.full((n_flat,), 3, np.int32)
        for i, n in enumerate(q_lens):
            row_flat[q_starts[i]: q_starts[i] + n] = i
        flat[q_starts[0]], flat[q_starts[1]] = cur[0], cur[1]
        flat[q_starts[2]: q_starts[2] + 100] = torch.randint(
            3, 259, (100,), generator=g)
        base = lens.numpy().astype(np.int32)
        if kv8:
            base[2] = 0
        rf = np.clip(row_flat, 0, 2)
        pos = torch.from_numpy(np.clip(base[rf] + np.arange(n_flat)
                                       - q_starts[rf], 0, cfg.max_seq_len - 1))
        gidx = torch.from_numpy(q_starts + q_lens - 1)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        step(forward_paged(
            params, cfg, flat[None].to(dev), pos[None].to(dev), kp, vp, table,
            t(base), cfg.max_seq_len, packed_last_idx=gidx.to(dev),
            kv_scales=scales, spans=(t(q_starts), t(q_lens), t(row_flat))
        )[0].float().cpu(), gidx)
        ctx = torch.from_numpy(base + q_lens).long()
        if not cfg.n_experts:
            # one verify step (speculative decoding's shape): 5 tokens per
            # row after each row's context; kv_lens count the 5 tokens
            multi = torch.randint(3, 259, (3, 5), generator=g)
            step(run(multi, ctx[:, None] + torch.arange(5),
                     (ctx + 5).to(torch.int32), multi_decode=True), None)
    finally:
        moe.route = route
    return {"steps": out, "prompts": prompt_lens, "decode_steps": steps,
            "q_lens": q_lens.tolist(), "bases": base.tolist(),
            "contexts": ctx.tolist(),
            "scales": ([s.cpu() for s in scales] if kv8 else None)}


# phase 4's model checks, in the order the script runs them (Mixtral's two
# on one f32 draw, one layer: at two the CPU's f32 copy is ~12 GB)
MODEL_CASES = (("bench-8b", False), ("bench-8b", True), ("gemma-7b", False),
               ("gemma-7b", True), ("mixtral-8x7b", False),
               ("mixtral-8x7b", True))
MODEL_REFS_DIR = (Path(__file__).resolve().parent / "build" / "lmrs_tpu_torch"
                  / "model_refs")


def model_case_name(preset: str, int8: bool) -> str:
    return preset + ("-int8" if int8 else "")


def model_refs_child(out_dir: str) -> int:
    """``python3 chip_smoke.py --model-refs DIR``: the CPU side of every
    phase-4 model check, in ``MODEL_CASES`` order, each written to
    ``DIR/<case>.pt`` (atomically): the weights in the form the card gets
    them (bf16, or the int8 values and scales) and the f32 CPU pass
    (``model_pass``).  The card's phases 3-3c run meanwhile; phase 4 reads
    the files."""
    import dataclasses
    import os

    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.models.transformer import init_params
    from lmrs_tpu_torch.ops.quant import is_quantized, quantize_params

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    drawn: dict = {}
    for preset, int8 in MODEL_CASES:
        n_layers = 1 if preset == "mixtral-8x7b" else MODEL_CHECK_LAYERS
        cfg = dataclasses.replace(model_preset(preset), n_layers=n_layers)
        if preset not in drawn:
            drawn = {preset: init_params(cfg, seed=1, device="cpu",
                                         dtype=torch.float32)}
        params = drawn[preset]
        if int8:
            params = quantize_params(params)
        kv8 = int8 and not cfg.n_experts
        ref = model_pass("cpu", cfg, params, kv8)

        def card_form(v):
            return v if is_quantized(v) else v.to(torch.bfloat16)

        weights = {k: (card_form(v) if k != "layers" else
                       [{n: card_form(x) for n, x in lp.items()} for lp in v])
                   for k, v in params.items()}
        name = model_case_name(preset, int8)
        tmp = out / f"{name}.pt.tmp"
        torch.save({"weights": weights, "cpu": ref, "n_layers": n_layers}, tmp)
        tmp.rename(out / f"{name}.pt")
        print(f"model-refs: {name} written", flush=True)
    return 0


class ModelRefs:
    """The ``--model-refs`` child, started before phase 3 so its f32 CPU
    passes overlap the card's kernel phases; ``take`` waits for one case's
    file and loads it, ``close`` joins the child.  The child is killed if
    the script exits first."""

    def __init__(self):
        import atexit
        import shutil

        shutil.rmtree(MODEL_REFS_DIR, ignore_errors=True)
        MODEL_REFS_DIR.mkdir(parents=True)
        self.log_path = MODEL_REFS_DIR / "child.log"
        self.log = open(self.log_path, "w", encoding="utf-8")
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--model-refs",
             str(MODEL_REFS_DIR)], stdout=self.log, stderr=subprocess.STDOUT)
        atexit.register(self._kill)

    def _kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def take(self, preset: str, int8: bool) -> dict:
        path = MODEL_REFS_DIR / f"{model_case_name(preset, int8)}.pt"
        while not path.exists():
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"the --model-refs child exited {self.proc.returncode} "
                    f"before {path.name}: "
                    f"{self.log_path.read_text()[-2000:]}")
            time.sleep(0.2)
        refs = torch.load(path, weights_only=False)
        path.unlink()
        return refs

    def close(self) -> dict:
        """Join the child; its seconds from start to the last file."""
        rc = self.proc.wait()
        self.log.close()
        if rc != 0:
            raise AssertionError(f"the --model-refs child exited {rc}: "
                                 f"{self.log_path.read_text()[-2000:]}")
        return {"child_seconds": round(time.time() - self.t0, 3)}


def check_model(refs: ModelRefs, int8: bool = False,
                preset: str = "bench-8b") -> dict:
    """``preset``'s widths at ``MODEL_CHECK_LAYERS`` layers (Mixtral's at
    one), the card's bf16 pass (``model_pass``) against the f32 CPU pass
    the ``--model-refs`` child made from the same weights and inputs.
    ``int8``: the same weights quantized (``quantize_params`` on the CPU;
    the card gets the same int8 values and scales), int8 KV pools with
    per-slot scale buffers on both devices — except for a
    mixture-of-experts preset, whose path keeps bf16 KV.

    A mixture-of-experts preset (phase 4e) records every routing decision
    on both devices (``moe.route``): bf16 hidden states on the card can
    swap a near-tie token's 2nd and 3rd expert, which moves its logits far
    past the tolerance.  A token's routing agrees when its top-k set and
    its kept assignments (capacity) are equal in every layer; at least 90%
    of the (token, layer) top-k sets must agree, and the logit and greedy
    gates hold on the tokens whose routing agreed.  No verify step (not on
    that path)."""
    import dataclasses

    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.ops.quant import is_quantized

    got = refs.take(preset, int8)
    n_layers, cpu = got["n_layers"], got["cpu"]
    cfg = dataclasses.replace(model_preset(preset), n_layers=n_layers)
    kv8 = int8 and not cfg.n_experts

    def to_card(t):
        if is_quantized(t):
            return {k: v.to("cuda") for k, v in t.items()}
        return t.to("cuda")

    params_gpu = {k: (to_card(v) if k != "layers" else
                      [{n: to_card(t) for n, t in lp.items()} for lp in v])
                  for k, v in got.pop("weights").items()}
    card = model_pass("cuda", cfg, params_gpu, kv8, cpu=cpu)
    diffs, agree, checked = [], 0, 0
    routing = {"decisions": 0, "topk_agree": 0, "tokens": 0,
               "tokens_agree": 0, "logit_rows": 0, "logit_rows_checked": 0}

    def agreed_rows(rows, rc, rg):
        """Tokens ``rows`` of one step whose routing agreed on both
        devices in every layer (None for a dense model)."""
        if not cfg.n_experts:
            return None
        (sc, kc), (sg, kg) = moe_routes(cfg, rc), moe_routes(cfg, rg)
        same_set = (sc == sg).all(-1)                       # [L, N]
        same = (same_set & (kc == kg).all(-1)).all(0)       # [N]
        routing["decisions"] += same_set.numel()
        routing["topk_agree"] += int(same_set.sum())
        routing["tokens"] += same.numel()
        routing["tokens_agree"] += int(same.sum())
        return same[rows]

    for c, d in zip(cpu["steps"], card["steps"], strict=True):
        a, b = c["logits"], d["logits"]
        ok = agreed_rows(c["rows"], c["routes"], d["routes"])
        if ok is not None:
            routing["logit_rows"] += ok.numel()
            routing["logit_rows_checked"] += int(ok.sum())
            a, b = a[ok], b[ok]
        if a.numel() == 0:
            continue
        diffs.append((a - b).abs().max().item())
        top2 = torch.topk(a, 2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > LOGIT_TOL
        same = a.argmax(-1) == b.argmax(-1)
        checked += int(sure.sum())
        agree += int((same & sure).sum())
        if not bool(same[sure].all()):
            raise AssertionError("greedy disagreement above the margin tolerance")
    max_diff = max(diffs)
    if not max_diff <= LOGIT_TOL:
        raise AssertionError(f"model logits: max |diff| {max_diff} > {LOGIT_TOL}")
    if cfg.n_experts:
        routing["topk_agree_share"] = routing["topk_agree"] / routing["decisions"]
        if routing["topk_agree_share"] < 0.9:
            raise AssertionError(f"routing: only {routing['topk_agree_share']:.3f} "
                                 "of (token, layer) top-k sets agree")
        if routing["logit_rows_checked"] == 0:
            raise AssertionError("routing: no compared token agreed")
    if kv8:
        sdiff = max((a - b).abs().max().item() / b.abs().max().item()
                    for a, b in zip(card["scales"], cpu["scales"]))
    del params_gpu, card
    torch.cuda.empty_cache()
    phase = {"bench-8b": "model", "mixtral-8x7b": "model-moe"}.get(
        preset, "model-gemma")
    return {"phase": phase + ("-int8" if int8 else ""),
            "config": f"{preset} widths, n_layers={n_layers}"
                      + (", quantize=int8" if int8 else "")
                      + (", kv_quantize=int8" if kv8 else ""),
            **({"scale_buffers_max_rel_diff": sdiff} if kv8 else {}),
            **({"routing": routing} if cfg.n_experts else {}),
            "prompts": cpu["prompts"], "decode_steps": cpu["decode_steps"],
            "span_dispatch": {"q_lens": cpu["q_lens"], "bases": cpu["bases"]},
            **({} if cfg.n_experts else
               {"verify_step": {"tokens": 5, "contexts": cpu["contexts"]}}),
            "max_logit_diff": max_diff, "logit_tol": LOGIT_TOL,
            "greedy_checked": checked, "greedy_agree": agree}


def check_tree_dispatch(int8: bool = False, preset: str = "bench-8b") -> dict:
    """Phase 4d: one tree-speculation span dispatch through
    ``forward_paged(span_anc=)`` at ``preset``'s widths, 2 layers, on the
    card (``int8``: int8 weights and KV pools with per-slot scales), held
    against per-branch LINEAR span dispatches of the same tokens on the
    same pools (restored before each): row 0 a tree [cur, 2 chains of 4]
    after 517 context tokens, row 1 the same after a 2-token heal at 298,
    row 2 a 100-token prefill slice (mask 0) after 129.  Tree node (c, j)
    sees the context, the heal, cur and chain c through j; the linear span
    [heal, cur, chain c] gives node j the same keys at other columns and
    the same rope positions.  Every node's logits within LOGIT_TOL, greedy
    agreement wherever the linear top-2 margin exceeds it."""
    import dataclasses

    import numpy as np

    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.models.transformer import forward_paged, init_params
    from lmrs_tpu_torch.ops.paged_attention import pack_spans
    from lmrs_tpu_torch.ops.quant import quantize_params

    cfg = dataclasses.replace(model_preset(preset), n_layers=2)
    dev, ps, n_pool = "cuda", 128, 24
    params = init_params(cfg, seed=1, device=dev)
    if int8:
        params = quantize_params(params)
    g = torch.Generator().manual_seed(4)
    ctx = [517, 300, 129]
    tables, nxt = [], 1
    for n in ctx:  # pages for the context and 100 tokens more, disjoint
        need = -(-(n + 100) // ps)
        tables.append(list(range(nxt, nxt + need)))
        nxt += need
    W = max(len(t) for t in tables)
    table = torch.tensor([t + [0] * (W - len(t)) for t in tables], device=dev)
    shape = (cfg.n_layers * n_pool, cfg.n_kv_heads, ps, cfg.hd)
    pool_dt = torch.int8 if int8 else torch.bfloat16
    kp = torch.zeros(shape, dtype=pool_dt, device=dev)
    vp = torch.zeros_like(kp)
    sshape = (cfg.n_layers, len(ctx), cfg.n_kv_heads, cfg.hd)
    scales = ((torch.ones(sshape, device=dev), torch.ones(sshape, device=dev))
              if int8 else None)
    prompts = [torch.randint(3, 259, (n,), generator=g) for n in ctx]
    # the contexts: one packed prefill (int8: it fixes the slots' scales)
    forward_paged(
        params, cfg, torch.cat(prompts)[None].to(dev),
        torch.cat([torch.arange(n) for n in ctx])[None].to(dev), kp, vp, table,
        torch.tensor([sum(ctx)], dtype=torch.int32, device=dev), cfg.max_seq_len,
        token_pages=torch.cat([torch.tensor(t)[torch.arange(n) // ps]
                               for t, n in zip(tables, ctx)])[None].to(dev),
        segment_ids=torch.cat([torch.full((n,), i) for i, n in enumerate(ctx)])[None].to(dev),
        packed_last_idx=torch.tensor(ctx, device=dev).cumsum(0) - 1,
        kv_scales=scales, scale_rows=torch.arange(3, device=dev))
    heal = prompts[1][298:300].tolist()
    cur = torch.randint(3, 259, (2,), generator=g).tolist()
    chains = torch.randint(3, 259, (2, TREE_W, TREE_K), generator=g).tolist()
    slice_ = torch.randint(3, 259, (100,), generator=g).tolist()
    bases = np.array([517, 298, 129], np.int32)

    def dispatch(spans_, anc_=None):
        """spans_: per row (tokens, rope offsets); returns every real
        token's logits [n, V] (f32, on the host) in span order."""
        q_lens = np.array([len(t) for t, _ in spans_], np.int32)
        q_starts, total = pack_spans(q_lens)
        toks = np.zeros(total, np.int64)
        pos = np.zeros(total, np.int64)
        row_flat = np.full(total, 3, np.int32)
        anc = np.zeros(total, np.int32)
        for r, (t, off) in enumerate(spans_):
            s0 = q_starts[r]
            toks[s0: s0 + len(t)] = t
            pos[s0: s0 + len(t)] = bases[r] + np.asarray(off)
            row_flat[s0: s0 + len(t)] = r
            if anc_ is not None:
                anc[s0: s0 + len(t)] = anc_[r]
        gidx = np.concatenate([np.arange(s0, s0 + n) for s0, n in zip(q_starts, q_lens)])
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        return forward_paged(
            params, cfg, t(toks)[None], t(pos)[None], kp, vp, table, t(bases),
            cfg.max_seq_len, packed_last_idx=t(gidx), kv_scales=scales,
            spans=(t(q_starts), t(q_lens), t(row_flat)),
            span_anc=t(anc) if anc_ is not None else None)[0].float().cpu()

    saved = (kp.clone(), vp.clone())
    # rope offsets by depth: heal and cur in order, chain c's node j at
    # hl + 1 + j
    offs = lambda hl: list(range(hl + 1)) + [hl + 1 + j for _ in range(TREE_W)  # noqa: E731
                                             for j in range(TREE_K)]
    tree_spans = [(cur[:1] + sum(chains[0], []), offs(0)),
                  (heal + cur[1:] + sum(chains[1], []), offs(2)),
                  (slice_, list(range(100)))]
    tree = dispatch(tree_spans, [tree_masks(0), tree_masks(2), [0] * 100])
    diffs, agree, checked = [], 0, 0
    n0, n1 = 1 + TREE_W * TREE_K, 3 + TREE_W * TREE_K
    for c in range(TREE_W):
        kp.copy_(saved[0])
        vp.copy_(saved[1])
        lin = dispatch([(cur[:1] + chains[0][c], list(range(1 + TREE_K))),
                        (heal + cur[1:] + chains[1][c], list(range(3 + TREE_K))),
                        (slice_, list(range(100)))])
        # tree rows [row 0 | row 1 | row 2] vs linear rows likewise
        t_idx = ([0] + [1 + c * TREE_K + j for j in range(TREE_K)]
                 + [n0 + i for i in range(3)]
                 + [n0 + 3 + c * TREE_K + j for j in range(TREE_K)]
                 + [n0 + n1 + i for i in range(100)])
        a, b = lin, tree[t_idx]
        diffs.append((a - b).abs().max().item())
        top2 = torch.topk(a, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
        same = a.argmax(-1) == b.argmax(-1)
        checked += int(sure.sum())
        agree += int((same & sure).sum())
        if not bool(same[sure].all()):
            raise AssertionError("tree dispatch: greedy disagreement with the "
                                 f"linear branch {c} above the margin")
    max_diff = max(diffs)
    if not max_diff <= LOGIT_TOL:
        raise AssertionError(f"tree dispatch logits: max |diff| {max_diff} > {LOGIT_TOL}")
    del params, kp, vp, saved, scales
    torch.cuda.empty_cache()
    return {"phase": "model-tree" + ("-int8" if int8 else ""),
            "config": f"{preset} widths, n_layers=2"
                      + (", quantize=int8, kv_quantize=int8" if int8 else ""),
            "rows": "tree heal 0 at 517, tree heal 2 at 298, 100-token slice at 129",
            "width": TREE_W, "depth": TREE_K,
            "max_logit_diff": max_diff, "logit_tol": LOGIT_TOL,
            "greedy_checked": checked, "greedy_agree": agree}


def check_moe_model(refs: ModelRefs) -> dict:
    """Phase 4e: ``check_model`` at Mixtral-8x7B's widths, one layer, bf16
    and then int8 weights (bf16 KV) on the same f32 draw; one line with
    both."""
    out = {"phase": "model-moe"}
    for label, int8 in (("bf16", False), ("int8", True)):
        out[label] = check_model(refs, int8=int8, preset="mixtral-8x7b")
    return out


# ------------------------------------------------------------ phase 4b

DEFAULT_DIR = Path(__file__).resolve().parent / "build" / "lmrs_tpu_torch" / "cli-default"


def run_cli_default() -> dict:
    """``lmrs-torch -i demo.json`` with no ``--model``: the default
    ``EngineConfig`` (preset ``tiny``, hd 32, random-init bf16) on the card,
    64 tokens a request.  Fails unless no request failed, the summary is
    non-empty and holds no error string, and flash prefill, the write-fused
    decode kernel and the span kernel launched."""
    from lmrs_tpu_torch.cli import main as cli_main
    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    src, dst = DEFAULT_DIR / "demo.json", DEFAULT_DIR / "summary.txt"
    src.write_text(json.dumps(load_demo_transcript()), encoding="utf-8")
    counted = zero_launches()
    t0 = time.time()
    rc = cli_main(["-i", str(src), "-o", str(dst), "--max-tokens", "64",
                   "--report", "-q"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(counted)
    if rc != 0:
        raise AssertionError(f"lmrs-torch with the default preset exited {rc}")
    summary = dst.read_text(encoding="utf-8")
    report = json.loads(Path(str(dst) + ".report.json").read_text(encoding="utf-8"))
    if report["failed_requests"] != 0:
        raise AssertionError(f"default preset: failed_requests = "
                             f"{report['failed_requests']}")
    if not summary or "[Error" in summary:
        raise AssertionError(f"default preset: summary {summary[:200]!r}")
    require_launches(launches, "default preset",
                     ("flash_prefill", "paged_decode_fused", "ragged_spans"))
    em = report["engine_metrics"]
    return {"phase": "default", "model": EngineConfig().model,
            "argv": "-i demo.json -o summary.txt --max-tokens 64 --report -q",
            "wall_seconds": wall, "requests": em["requests"],
            "failed_requests": report["failed_requests"],
            "chunks": report["num_chunks"],
            "reduce_levels": report["reduce_levels"],
            "mixed_dispatches": em["mixed_batch"]["dispatches"],
            "decode_tokens_per_sec": em["decode_tokens_per_sec"],
            "summary_chars": len(summary), "launches": launches}


# ------------------------------------------------------------ phase 5

WEIGHT_SPAN = "int8_weight_product"
EXPERT_SPAN = "moe_expert_product"
MOE_SPAN = "moe_layer"


def profile_decode_step(engine, rows: int = 8, context: int = 1500,
                        steps: int = 4, tokens: int = 1,
                        tree: bool = False) -> dict:
    """Where one decode step's time goes at the main path's shape (8 rows,
    ~1500-token contexts: what the 112-page pool holds, full bench-8b):
    host wall per step (synchronized) and, from ``torch.profiler``, device
    kernel time by kind.  ``tokens`` > 1 profiles the speculative verify
    step instead (``multi_decode``, that many tokens per row; the model
    forward only, without drafting and acceptance).  ``tree`` profiles the
    tree-speculation step instead: one span dispatch of [cur, W chains of
    k] a row (heal 0) with ancestor masks, the LM head on every node, the
    model forward only.  With int8 weights the
    products (``qmatmul``: the int8 -> bf16 conversion, the GEMM and the
    scale multiply) run under a profiler range of their own, and their
    device time is reported apart.  A mixture-of-experts model's layers
    (``moe_mlp``) and their expert products run under two more ranges, so
    the step splits into attention, expert products, routing and dispatch
    (the rest of ``moe_mlp``), the other weight products and the rest.
    Uses real pages from the engine's pool (the prefix cache gives up what
    it retains) and returns them afterwards."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from lmrs_tpu_torch.models import transformer
    from lmrs_tpu_torch.ops import moe
    from lmrs_tpu_torch.ops.quant import is_quantized
    from lmrs_tpu_torch.utils.kernel_ab import kernel_kind

    sched = engine._scheduler
    cache, cfg = sched.cache, sched.model_cfg
    int8_weights = is_quantized(sched.params["layers"][0]["wqkv"])
    moe_qmatmul, moe_mlp = moe.qmatmul, transformer.moe_mlp

    def traced_expert_qmatmul(x, w):
        with record_function(EXPERT_SPAN):
            return moe_qmatmul(x, w)

    def traced_moe_mlp(mp, cfg_, x):
        with record_function(MOE_SPAN):
            return moe_mlp(mp, cfg_, x)
    n_pages = -(-(context + steps + 1 + tokens
                  + (sched._spec_width * sched.spec_k if tree else 0))
                // cache.page_size)
    seqs = [cache.alloc_pages(n_pages) for _ in range(rows)]
    qmatmul = transformer.qmatmul

    def traced_qmatmul(x, w):
        with record_function(WEIGHT_SPAN):
            return qmatmul(x, w)

    try:
        table = torch.tensor([s + [0] * (cache.max_pages_per_slot - len(s))
                              for s in seqs], device="cuda")
        tok = torch.full((rows, tokens), 65, dtype=torch.long, device="cuda")
        offs = torch.arange(tokens, device="cuda")
        if tree:
            import numpy as np

            from lmrs_tpu_torch.ops.paged_attention import pack_spans

            masks = tree_masks(0, sched._spec_width, sched.spec_k)
            n = len(masks)
            q_starts, total = pack_spans([n] * rows)
            t = lambda a: torch.from_numpy(np.asarray(a)).to("cuda")  # noqa: E731
            row_flat = np.full(total, rows, np.int32)
            anc = np.zeros(total, np.int32)
            pos_off = np.zeros(total, np.int64)
            node_off = [0] + [1 + j for _ in range(sched._spec_width)
                              for j in range(sched.spec_k)]
            for r, s0 in enumerate(q_starts):
                row_flat[s0: s0 + n], anc[s0: s0 + n] = r, masks
                pos_off[s0: s0 + n] = node_off
            gidx = np.concatenate([np.arange(s0, s0 + n) for s0 in q_starts])
            spans = (t(q_starts), t(np.full(rows, n, np.int32)), t(row_flat))
            anc_d, pos_d, gidx_d = t(anc), t(pos_off), t(gidx)
            flat = torch.full((1, total), 65, dtype=torch.long, device="cuda")

        def one_step(i):
            lens = torch.full((rows,), context + i, dtype=torch.long, device="cuda")
            forward_paged = transformer.forward_paged
            if tree:
                forward_paged(sched.params, cfg, flat, (context + i + pos_d)[None],
                              cache.k, cache.v, table, lens.to(torch.int32),
                              cfg.max_seq_len, packed_last_idx=gidx_d,
                              spans=spans, kv_scales=sched.kv_scales,
                              span_anc=anc_d)
                return
            forward_paged(sched.params, cfg, tok, lens[:, None] + offs,
                          cache.k, cache.v, table, (lens + tokens).to(torch.int32),
                          cfg.max_seq_len, multi_decode=tokens > 1,
                          kv_scales=sched.kv_scales)

        one_step(0)
        torch.cuda.synchronize()
        t0 = time.time()
        for i in range(steps):
            one_step(i)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / steps
        # host time to issue one step's launches, from an idle device to
        # the closing synchronize (not included)
        issue_ms = 0.0
        for i in range(steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            one_step(i)
            issue_ms += (time.perf_counter() - t1) * 1e3
        torch.cuda.synchronize()
        if int8_weights or cfg.n_experts:
            transformer.qmatmul = traced_qmatmul
        if cfg.n_experts:
            moe.qmatmul, transformer.moe_mlp = traced_expert_qmatmul, traced_moe_mlp
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(steps):
                    one_step(i)
                torch.cuda.synchronize()
        finally:
            transformer.qmatmul = qmatmul
            moe.qmatmul, transformer.moe_mlp = moe_qmatmul, moe_mlp
        kinds = {"paged_decode": 0.0, "gemm": 0.0, "other": 0.0}
        n_kernels = 0
        span_us = {WEIGHT_SPAN: 0.0, EXPERT_SPAN: 0.0, MOE_SPAN: 0.0}
        for evt in prof.events():
            if evt.name in span_us:
                if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
                    # the range's kernels (GEMMs, casts, scale multiplies)
                    span_us[evt.name] += evt.device_time_total
                continue
            if str(getattr(evt, "device_type", "")).endswith("CUDA"):
                us = evt.time_range.elapsed_us()  # a kernel's own duration
                kind = kernel_kind(evt.name)
                kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
                n_kernels += 1
        busy = sum(kinds.values()) / steps
        out = {"rows": rows, "tokens": n if tree else tokens, "context": context,
               **({"tree": f"[cur, {sched._spec_width} chains of "
                           f"{sched.spec_k}] a row, heal 0"} if tree else {}),
               "wall_ms_per_step": wall_ms,
               "host_issue_ms_per_step": issue_ms / steps,
               "device_busy_ms_per_step": busy if n_kernels else "not measured",
               "device_idle_share": (1 - busy / wall_ms) if n_kernels else "not measured",
               "kernel_ms_per_step": {k: v / steps for k, v in kinds.items()},
               "kernels_per_step": n_kernels / steps}
        w_ms, e_ms, m_ms = (span_us[s] / 1e3 / steps
                            for s in (WEIGHT_SPAN, EXPERT_SPAN, MOE_SPAN))
        attn_ms = kinds["paged_decode"] / steps
        if int8_weights and not cfg.n_experts:
            out["int8_split_ms_per_step"] = (
                {"decode_kernel": attn_ms, "int8_weight_products": w_ms,
                 "rest": busy - attn_ms - w_ms}
                if w_ms > 0 else "not measured")
        if cfg.n_experts:  # the other products: q/k/v, o and the LM head
            out["moe_split_ms_per_step"] = (
                {"attention": attn_ms, "expert_products": e_ms,
                 "routing_dispatch": m_ms - e_ms, "other_weight_products": w_ms,
                 "rest": busy - attn_ms - m_ms - w_ms}
                if m_ms > 0 else "not measured")
        return out
    finally:
        for s in seqs:
            cache.allocator.free(s)


def profile_prefill_dispatch(engine, n: int = 1600) -> dict:
    """One fresh-prefill dispatch at phase 5's map-prompt shape (one [1, n]
    row, all 32 layers: ``kernel_ab.profile_prefill``) over real pages of
    the engine's pool, returned afterwards."""
    from lmrs_tpu_torch.utils.kernel_ab import profile_prefill

    sched = engine._scheduler
    cache = sched.cache
    pages = cache.alloc_pages(-(-n // cache.page_size))
    try:
        table = torch.tensor([pages + [0] * (cache.max_pages_per_slot - len(pages))],
                             device="cuda")
        return profile_prefill(sched.params, sched.model_cfg, cache.k, cache.v,
                               table, n)
    finally:
        cache.allocator.free(pages)


def kernel_counters() -> dict:
    """Every kernel's launch counter: name -> (wrapper, attribute)."""
    from lmrs_tpu_torch.ops.flash_attention import flash_attention
    from lmrs_tpu_torch.ops.paged_attention import (paged_decode,
                                                    paged_decode_fused,
                                                    paged_decode_multi,
                                                    ragged_spans)

    out = {"flash_prefill": (flash_attention, "launches"),
           "paged_decode": (paged_decode, "launches")}
    for fn in (paged_decode_fused, ragged_spans, paged_decode_multi):
        out[fn.__name__] = (fn, "launches")
        out[fn.__name__ + "_int8"] = (fn, "launches_int8")
    out["ragged_spans_anc"] = (ragged_spans, "launches_anc")
    out["ragged_spans_anc_int8"] = (ragged_spans, "launches_anc_int8")
    return out


def zero_launches() -> dict:
    """Every kernel's launch counter set to 0; the counters, for
    ``read_launches``."""
    counted = kernel_counters()
    for fn, attr in counted.values():
        setattr(fn, attr, 0)
    return counted


def read_launches(counted: dict) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counted.items()}


def at_depth(cfg, layers: int | None):
    """``cfg`` with its engine's preset cut to ``layers`` layers (None:
    the full preset)."""
    if layers is None:
        return cfg
    import dataclasses

    from lmrs_tpu_torch.config import model_preset

    return dataclasses.replace(cfg, model=dataclasses.replace(
        model_preset(cfg.engine.model), n_layers=layers))


def phase5_config(model: str = "bench-8b", streaming: bool = False,
                  **engine_kw):
    """Phase 5's ``PipelineConfig`` at the preset ``model``."""
    from lmrs_tpu_torch.config import (ChunkConfig, EngineConfig,
                                       PipelineConfig, ReduceConfig)

    return PipelineConfig(
        # the defaults (mixed steps, prefix cache, 4096-token chunks) with
        # the pool budgeted at 112 pages: the first wave's prompts take 109,
        # so decode growth preempts the youngest slot and the slots fall
        # out of lockstep, as uneven completions make them in serving (with
        # uniform budgets and no EOS all 8 would finish on one block and no
        # prefill would ever meet a decoding row)
        engine=EngineConfig(model=model, max_tokens=64, seed=0,
                            temperature=0.3, num_pages=112, **engine_kw),
        # byte tokens: 1400-token chunks + header + template stay inside the
        # 2048 window at a 64-token budget
        chunk=ChunkConfig(tokenizer="byte", max_tokens_per_chunk=1400),
        # a reduce budget small enough that the summaries form a tree
        reduce=ReduceConfig(max_tokens_per_batch=600, reserve_tokens=100,
                            streaming=streaming))


def summarize_once(model: str = "bench-8b", layers: int | None = None,
                   segments: int = 200, **engine_kw) -> tuple:
    """``TranscriptSummarizer`` over the demo transcript at the full
    preset ``model`` (bench-8b unless given; ``layers`` deep when given;
    the first ``segments`` demo segments), every launch counter zeroed
    just before ``summarize`` and read just after; the checks every path
    must pass (a summary, no failed request, a clean audit, a hierarchical
    reduce).  Returns (summarizer, engine, stats, wall seconds,
    launches)."""
    from lmrs_tpu_torch.pipeline import TranscriptSummarizer
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    cfg = at_depth(phase5_config(model, **engine_kw), layers)
    transcript = load_demo_transcript(max_segments=segments)
    summarizer = TranscriptSummarizer(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    engine = summarizer.executor.engine  # builds + random-inits the model
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    counted = zero_launches()
    t0 = time.time()
    stats = summarizer.summarize(transcript)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(counted)
    violations = engine.audit()
    if not stats["summary"]:
        raise AssertionError("empty summary")
    if stats["failed_requests"] != 0:
        raise AssertionError(f"failed_requests = {stats['failed_requests']}")
    if violations:
        raise AssertionError(f"allocator audit: {violations}")
    if not stats["hierarchical"]:
        raise AssertionError("the reduce did not form a tree")
    stats["build_peak_memory_gib"] = build_peak
    return summarizer, engine, stats, wall, launches


def require_launches(launches: dict, path: str, want: tuple,
                     never: tuple = ()) -> None:
    for name in want:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {path}")
    for name in never:
        if launches[name] != 0:
            raise AssertionError(f"kernel {name} ran {launches[name]} times "
                                 f"on the {path}")


# phase 5's counts and launches on the card with the scheduler inline
# (measured before the dispatch watchdog was on by default): the dispatch
# thread must change no dispatch
PHASE5_INLINE = {"decode_tokens": 3019, "prefill_tokens": 56650,
                 "mixed_steps": 79, "flash_prefill": 480,
                 "paged_decode_fused": 17408, "ragged_spans": 2656}
PHASE5_INLINE_WALL_S = 23.56


def run_main_path() -> dict:
    summarizer, engine, stats, wall, launches = summarize_once()
    em = stats["engine_metrics"]
    violations = engine.audit()
    require_launches(launches, "main path",
                     ("flash_prefill", "paged_decode_fused", "ragged_spans"))
    if engine._runner is None:
        raise AssertionError("the main path ran without the dispatch watchdog")
    allocator = type(engine._scheduler.cache.allocator).__name__
    if allocator != "NativePageAllocator":
        raise AssertionError(f"the main path ran on {allocator}, not the "
                             "native runtime's page allocator")
    counts = {"decode_tokens": em["decode_tokens"],
              "prefill_tokens": em["prefill_tokens"],
              "mixed_steps": em["mixed_batch"]["dispatches"],
              **{k: launches[k] for k in ("flash_prefill",
                                          "paged_decode_fused",
                                          "ragged_spans")}}
    if counts != PHASE5_INLINE:
        raise AssertionError(f"phase 5 under the watchdog: {counts}, inline "
                             f"{PHASE5_INLINE}")
    watchdog_fires = engine._scheduler.metrics["watchdog_fires"]
    if em["mixed_batch"]["dispatches"] <= 0:
        raise AssertionError("no mixed step ran on the main path")
    if em["prefix_cache"]["tokens_reused"] <= 0:
        raise AssertionError("no prefix-cache hit on the main path")
    step = profile_decode_step(engine)
    prefill = profile_prefill_dispatch(engine)
    if engine.audit():
        raise AssertionError(f"allocator audit after profiling: {engine.audit()}")
    summarizer.shutdown()
    return {"phase": "main", "decode_step_profile": step,
            "prefill_dispatch_profile": prefill,
            "model": "bench-8b (32 layers, random-init bf16)",
            "allocator": allocator,
            "segments": stats["num_input_segments"],
            "chunks": stats["num_chunks"], "requests": em["requests"],
            "reduce_levels": stats["reduce_levels"],
            "prefill_tokens": em["prefill_tokens"],
            "prefill_dispatches": em["prefill_dispatches"],
            "packed_prefill_dispatches": em["packed_prefill_dispatches"],
            "decode_tokens": em["decode_tokens"],
            "decode_blocks": em["decode_blocks"],
            "decode_block_seconds": em["decode_block_seconds"],
            "decode_tokens_per_sec": em["decode_tokens_per_sec"],
            "mixed_step_seconds": em["mixed_step_seconds"],
            "mixed_batch": em["mixed_batch"], "rpa": em["rpa"],
            "prefix_cache": em["prefix_cache"],
            "preemptions": em["preemptions"], "stalls": em["stalls"],
            "audit": violations,
            "wall_seconds": wall, "stage_times": stats["stage_times"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "failed_requests": stats["failed_requests"],
            "summary_chars": len(stats["summary"]), "launches": launches,
            "watchdog": {"armed": True, "fires": watchdog_fires,
                         "inline_wall_seconds": PHASE5_INLINE_WALL_S,
                         "counts_equal_inline": True}}


# ------------------------------------------------------------ phase 6

def run_spec_path() -> dict:
    """Phase 5's transcript and config with linear speculation: every
    decode dispatch is a speculative block through the verify kernel."""
    summarizer, engine, stats, wall, launches = summarize_once(
        layers=VARIANT_LAYERS, speculate_k=4, mixed_batch=False)
    em = stats["engine_metrics"]
    require_launches(launches, "spec path",
                     ("paged_decode_multi", "flash_prefill", "ragged_spans"),
                     never=("paged_decode_fused",))
    if em["mixed_batch"]["dispatches"] != 0:
        raise AssertionError("a mixed step ran on the spec path")
    step = profile_decode_step(engine, tokens=5)
    if engine.audit():
        raise AssertionError(f"allocator audit after profiling: {engine.audit()}")
    summarizer.shutdown()
    return {"phase": "spec", "speculate_k": 4, "mixed_batch": False,
            "model": f"bench-8b ({VARIANT_LAYERS} layers, random-init bf16)",
            "verify_step_profile": step,
            "requests": em["requests"], "reduce_levels": stats["reduce_levels"],
            "prefill_tokens": em["prefill_tokens"],
            "prefill_dispatches": em["prefill_dispatches"],
            "decode_tokens": em["decode_tokens"],
            "decode_blocks": em["decode_blocks"],
            "decode_block_seconds": em["decode_block_seconds"],
            "decode_tokens_per_sec": em["decode_tokens_per_sec"],
            "spec_accepted_tokens": em["spec_accepted_tokens"],
            "rpa": em["rpa"], "prefix_cache": em["prefix_cache"],
            "prefix_hit_tokens": em["prefix_cache"]["tokens_reused"],
            "preemptions": em["preemptions"], "stalls": em["stalls"],
            "audit": engine.audit(), "wall_seconds": wall,
            "stage_times": stats["stage_times"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "failed_requests": stats["failed_requests"],
            "summary_chars": len(stats["summary"]), "launches": launches}


# ------------------------------------------------------------ phase 9

def run_gemma_path() -> dict:
    """Phase 5's transcript and engine settings at gemma-7b's widths
    (``VARIANT_LAYERS`` of its 28
    layers, hd 256, 16 query over 16 kv heads, random-init bf16, byte
    tokenizer), with phase 5's gates and a preemption besides; its decode-step
    profile puts the attention kernel's time a launch beside its bound."""
    summarizer, engine, stats, wall, launches = summarize_once(
        "gemma-7b", layers=VARIANT_LAYERS)
    em = stats["engine_metrics"]
    require_launches(launches, "gemma-7b path",
                     ("flash_prefill", "paged_decode_fused", "ragged_spans"))
    if em["mixed_batch"]["dispatches"] <= 0:
        raise AssertionError("no mixed step ran on the gemma-7b path")
    if em["prefix_cache"]["tokens_reused"] <= 0:
        raise AssertionError("no prefix-cache hit on the gemma-7b path")
    if em["preemptions"] <= 0:
        raise AssertionError("no preemption on the gemma-7b path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step = profile_decode_step(engine)
    cfg = engine._scheduler.model_cfg
    B, ctx = step["rows"], step["context"]
    # one launch's bound at the profile's shape (contexts 1,501-1,504 over
    # its steps; the first step's): the live K/V read once, q/out, the
    # new row written, tables and lengths
    fake = {"q": torch.empty(B, cfg.n_heads, cfg.hd),
            "k_pages": torch.empty(1, cfg.n_kv_heads, 128, cfg.hd,
                                   dtype=torch.bfloat16),
            "page_tables": torch.empty(B, 16),
            "kv_lens": torch.full((B,), ctx + 1)}
    b_ms, b_by = decode_bound(fake)
    per_launch = step["kernel_ms_per_step"]["paged_decode"] / cfg.n_layers
    step["attention_ms_per_launch"] = per_launch
    step["attention_bound_ms_per_launch"] = b_ms
    step["attention_bound_by"] = b_by
    if engine.audit():
        raise AssertionError(f"allocator audit after profiling: {engine.audit()}")
    summarizer.shutdown()
    return {"phase": "gemma-7b",
            "model": f"gemma-7b ({cfg.n_layers} layers, hd {cfg.hd}, "
                     "random-init bf16)",
            "decode_step_profile": step,
            "segments": stats["num_input_segments"],
            "chunks": stats["num_chunks"], "requests": em["requests"],
            "reduce_levels": stats["reduce_levels"],
            "prefill_tokens": em["prefill_tokens"],
            "prefill_dispatches": em["prefill_dispatches"],
            "packed_prefill_dispatches": em["packed_prefill_dispatches"],
            "decode_tokens": em["decode_tokens"],
            "decode_blocks": em["decode_blocks"],
            "decode_tokens_per_sec": em["decode_tokens_per_sec"],
            "mixed_batch": em["mixed_batch"], "rpa": em["rpa"],
            "prefix_cache": em["prefix_cache"],
            "preemptions": em["preemptions"], "stalls": em["stalls"],
            "audit": engine.audit(), "wall_seconds": wall,
            "stage_times": stats["stage_times"], "peak_memory_gib": peak,
            "failed_requests": stats["failed_requests"],
            "summary_chars": len(stats["summary"]), "launches": launches}


# ------------------------------------------------------------ phase 12

def run_tree_path(model: str = "bench-8b", **engine_kw) -> dict:
    """Phase 12 (12b with ``model``/``engine_kw``): phase 5's transcript
    and config with ``speculate_k=4`` and mixed steps on, the reference's
    tree speculation: every decode step is a span dispatch through the
    ancestor-mask build.  Fails unless flash prefill and the ancestor-mask
    span kernel launched, the decode and verify kernels did not, tree
    dispatches ran and drafts were accepted (and summarize_once's gates)."""
    summarizer, engine, stats, wall, launches = summarize_once(
        model, layers=VARIANT_LAYERS, speculate_k=4, **engine_kw)
    em = stats["engine_metrics"]
    sched = engine._scheduler
    int8 = sched.kv_scales is not None
    sfx = "_int8" if int8 else ""
    never = tuple(n + s for n in ("paged_decode_fused", "paged_decode_multi")
                  for s in ("", "_int8"))
    require_launches(launches, f"{model} tree path",
                     ("flash_prefill", "ragged_spans_anc" + sfx), never=never)
    tree = em["spec_tree"]
    if tree["dispatches"] <= 0:
        raise AssertionError("no tree dispatch ran on the tree path")
    if em["spec_accepted_tokens"] <= 0:
        raise AssertionError("no draft was accepted on the tree path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step = profile_decode_step(engine, tree=True)
    cfg = sched.model_cfg
    step["attention_ms_per_launch"] = (
        step["kernel_ms_per_step"].get("ragged_spans", 0.0) / cfg.n_layers)
    if engine.audit():
        raise AssertionError(f"allocator audit after profiling: {engine.audit()}")
    summarizer.shutdown()
    return {"phase": "spec-tree" + ("" if model == "bench-8b" else f"-{model}")
                     + ("-int8" if int8 else ""),
            "model": f"{model} ({cfg.n_layers} layers, random-init"
                     + (", int8 weights + int8 KV)" if int8 else " bf16)"),
            "speculate_k": 4, "mixed_batch": True, "spec_tree": tree,
            "tree_step_profile": step,
            "requests": em["requests"], "reduce_levels": stats["reduce_levels"],
            "prefill_tokens": em["prefill_tokens"],
            "prefill_dispatches": em["prefill_dispatches"],
            "decode_tokens": em["decode_tokens"],
            "decode_blocks": em["decode_blocks"],
            "decode_block_seconds": em["decode_block_seconds"],
            "decode_tokens_per_sec": em["decode_tokens_per_sec"],
            "mixed_step_seconds": em["mixed_step_seconds"],
            "spec_accepted_tokens": em["spec_accepted_tokens"],
            **{key: em[key] for key in ("spec_tree_dispatches", "spec_tree_rows",
                                        "spec_tree_nodes_sum",
                                        "spec_accept_depth_sum")},
            "mixed_batch": em["mixed_batch"], "rpa": em["rpa"],
            **({"prefix_cache": em["prefix_cache"]} if "prefix_cache" in em else {}),
            "preemptions": em["preemptions"], "stalls": em["stalls"],
            "audit": engine.audit(), "wall_seconds": wall,
            "stage_times": stats["stage_times"], "peak_memory_gib": peak,
            "failed_requests": stats["failed_requests"],
            "summary_chars": len(stats["summary"]), "launches": launches}


# ------------------------------------------------------------ phases 7-8

def run_int8_path(spec: bool = False, model: str = "bench-8b",
                  **engine_kw) -> dict:
    """Phase 5's transcript and config with int8 weights and int8 KV pages
    (the prefix cache is then off); ``spec``: plus linear speculation
    (phase 8).  ``model``/``engine_kw``: phase 10's preset and engine
    settings; it also requires the int8 span kernel."""
    kw = dict(quantize="int8", kv_quantize="int8", **engine_kw)
    if spec:
        kw.update(speculate_k=4, mixed_batch=False)
    # phases 7-8 and 10 at VARIANT_LAYERS
    summarizer, engine, stats, wall, launches = summarize_once(
        model, layers=VARIANT_LAYERS, **kw)
    em = stats["engine_metrics"]
    sched = engine._scheduler
    if sched.cache.k.dtype != torch.int8:
        raise AssertionError("the int8 path's pools are not int8")
    if "prefix_cache" in em or sched.counters["prefix_queries"] != 0:
        raise AssertionError("the prefix cache ran under int8 KV")
    bf16_kernels = ("paged_decode_fused", "ragged_spans", "paged_decode_multi")
    if spec:
        path = "int8 spec path"
        want = ("paged_decode_multi_int8", "flash_prefill")
        if model != "bench-8b":
            want += ("ragged_spans_int8",)
        require_launches(launches, path, want,
                         never=("paged_decode_fused_int8",) + bf16_kernels)
        if em["mixed_batch"]["dispatches"] != 0:
            raise AssertionError("a mixed step ran on the int8 spec path")
    else:
        path = "int8 path"
        require_launches(launches, path,
                         ("flash_prefill", "ragged_spans_int8",
                          "paged_decode_fused_int8"), never=bf16_kernels)
        if em["mixed_batch"]["dispatches"] <= 0:
            raise AssertionError("no mixed step ran on the int8 path")
    step = profile_decode_step(engine, tokens=5 if spec else 1)
    if engine.audit():
        raise AssertionError(f"allocator audit after profiling: {engine.audit()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    summarizer.shutdown()
    cfg = sched.model_cfg
    out = {"phase": (("int8-spec" if spec else "int8") if model == "bench-8b"
                     else f"{model}-int8" + ("-spec" if spec else "")),
           "model": f"{model} ({cfg.n_layers} layers, random-init, int8 "
                    "weights + int8 KV)", "engine": engine_kw,
           ("verify_step_profile" if spec else "decode_step_profile"): step,
           "requests": em["requests"], "reduce_levels": stats["reduce_levels"],
           "prefill_tokens": em["prefill_tokens"],
           "prefill_dispatches": em["prefill_dispatches"],
           "packed_prefill_dispatches": em["packed_prefill_dispatches"],
           "decode_tokens": em["decode_tokens"],
           "decode_blocks": em["decode_blocks"],
           "decode_block_seconds": em["decode_block_seconds"],
           "decode_tokens_per_sec": em["decode_tokens_per_sec"],
           "mixed_step_seconds": em["mixed_step_seconds"],
           "mixed_batch": em["mixed_batch"], "rpa": em["rpa"],
           "prefix_queries": sched.counters["prefix_queries"],
           "preemptions": em["preemptions"], "stalls": em["stalls"],
           "audit": engine.audit(), "wall_seconds": wall,
           "stage_times": stats["stage_times"], "peak_memory_gib": peak,
           "failed_requests": stats["failed_requests"],
           "summary_chars": len(stats["summary"]), "launches": launches}
    if spec:
        out["spec_accepted_tokens"] = em["spec_accepted_tokens"]
    return out


# ------------------------------------------------------------ phase 13

CKPT_DIR = Path(__file__).resolve().parent / "build" / "lmrs_tpu_torch" / "checkpoint"


def hf_mixtral_tensors(cfg, gen: torch.Generator, device: str) -> dict:
    """An HF-layout Mixtral checkpoint of ``cfg`` ([out, in] matrices,
    Mixtral's names), random bf16 at 1/sqrt(fan_in), norms 1."""
    D, F_, hd, E = cfg.dim, cfg.hidden_dim, cfg.hd, cfg.n_experts

    def rnd(rows, cols):
        w = torch.randn(rows, cols, generator=gen, device=device)
        return (w / cols ** 0.5).bfloat16()

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=device)

    t = {"model.embed_tokens.weight": rnd(cfg.vocab_size, D),
         "lm_head.weight": rnd(cfg.vocab_size, D), "model.norm.weight": ones(D)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        t[f"{p}.input_layernorm.weight"] = ones(D)
        t[f"{p}.post_attention_layernorm.weight"] = ones(D)
        t[f"{p}.self_attn.q_proj.weight"] = rnd(cfg.n_heads * hd, D)
        t[f"{p}.self_attn.k_proj.weight"] = rnd(cfg.n_kv_heads * hd, D)
        t[f"{p}.self_attn.v_proj.weight"] = rnd(cfg.n_kv_heads * hd, D)
        t[f"{p}.self_attn.o_proj.weight"] = rnd(D, cfg.n_heads * hd)
        t[f"{p}.block_sparse_moe.gate.weight"] = rnd(E, D)
        for j in range(E):
            ex = f"{p}.block_sparse_moe.experts.{j}"
            t[f"{ex}.w1.weight"] = rnd(F_, D)
            t[f"{ex}.w3.weight"] = rnd(F_, D)
            t[f"{ex}.w2.weight"] = rnd(D, F_)
    return t


def run_checkpoint_path(preset: str = "mixtral-8x7b", n_layers: int = 1) -> dict:
    """Phase 13: an HF-layout checkpoint of ``preset``'s widths at
    ``n_layers`` layers (random bf16, written by the port's safetensors
    writer in two shards), converted by ``lmrs-torch-convert``
    (``convert_cli.main``) and loaded by ``TorchEngine(checkpoint_path=)``
    on the card, bf16 and int8.  Fails unless the checkpoint engine's
    leaves and a packed forward's logits equal, bit for bit, those of an
    engine built from the same params converted in memory, the int8
    engine's leaves equal ``quantize_params`` of the bf16 ones, and 8
    greedy requests on each engine finish with a clean audit.  The files
    live under ``build/`` and are deleted at the end."""
    import contextlib
    import io
    import shutil

    from lmrs_tpu_torch import config as tconfig
    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.engine.api import GenerationRequest
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.models import convert_cli
    from lmrs_tpu_torch.models.loader import convert_hf_llama
    from lmrs_tpu_torch.models.transformer import forward_paged
    from lmrs_tpu_torch.ops.quant import is_quantized, quantize_params
    from lmrs_tpu_torch.utils.safetensors import save_file

    name = f"{preset}-{n_layers}l"
    tconfig._PRESETS[name] = dict(tconfig._PRESETS[preset], n_layers=n_layers)
    cfg = tconfig.model_preset(name)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    hf, ck = CKPT_DIR / "hf", CKPT_DIR / "native"
    hf.mkdir(parents=True)
    secs = {}
    try:
        t0 = time.time()
        tensors = hf_mixtral_tensors(cfg, torch.Generator(device="cuda").manual_seed(13),
                                     "cuda")
        layer_names = [k for k in tensors if k.startswith("model.layers.")]
        written = save_file({k: tensors[k] for k in layer_names},
                            hf / "model-00001-of-00002.safetensors")
        written += save_file({k: v for k, v in tensors.items()
                              if k not in layer_names},
                             hf / "model-00002-of-00002.safetensors")
        del tensors
        secs["write_hf"] = time.time() - t0
        t0 = time.time()
        told = io.StringIO()  # the command's "run with" line, kept off stdout
        with contextlib.redirect_stdout(told):
            rc = convert_cli.main(["--src", str(hf), "--model", name,
                                   "--output", str(ck), "-q"])
        if rc != 0:
            raise AssertionError("lmrs-torch-convert failed on the HF checkpoint")
        secs["convert"] = time.time() - t0
        native = sum(f.stat().st_size for f in ck.iterdir())
        kw = dict(model=name, max_tokens=16, temperature=0.0, num_pages=64)
        t0 = time.time()
        eng = TorchEngine(EngineConfig(checkpoint_path=str(ck), **kw), cfg,
                          device="cuda")
        torch.cuda.synchronize()
        secs["load_bf16"] = time.time() - t0
        t0 = time.time()
        eng8 = TorchEngine(EngineConfig(checkpoint_path=str(ck), quantize="int8",
                                        **kw), cfg, device="cuda")
        torch.cuda.synchronize()
        secs["load_int8"] = time.time() - t0
        t0 = time.time()
        mem = convert_hf_llama(str(hf), cfg)
        mem = {k: (v.to("cuda") if k != "layers" else
                   [{n: t.to("cuda") for n, t in lp.items()} for lp in v])
               for k, v in mem.items()}
        eng_mem = TorchEngine(EngineConfig(**kw), cfg, device="cuda", params=mem)
        secs["convert_in_memory"] = time.time() - t0

        def leaves(p):
            for k, v in p.items():
                if k == "layers":
                    for i, lp in enumerate(v):
                        for n, t in lp.items():
                            yield f"layers.{i}.{n}", t
                else:
                    yield k, v

        def equal(a, b):
            if is_quantized(a):
                return torch.equal(a["q"], b["q"]) and torch.equal(a["s"], b["s"])
            return a.dtype == b.dtype and torch.equal(a, b)

        for (n, a), (_, b) in zip(leaves(eng.params), leaves(eng_mem.params)):
            if not equal(a, b):
                raise AssertionError(f"checkpoint leaf {n} differs from the "
                                     "in-memory conversion")
        for (n, a), (_, b) in zip(leaves(eng8.params),
                                  leaves(quantize_params(eng.params))):
            if not equal(a, b):
                raise AssertionError(f"int8 checkpoint leaf {n} differs from "
                                     "quantize_params of the bf16 leaves")
        # one packed prefill of three prompts through each engine's params
        g = torch.Generator(device="cuda").manual_seed(14)
        lens_ = [300, 200, 100]
        n_tok = sum(lens_)
        tokens = torch.randint(3, 259, (1, n_tok), generator=g, device="cuda")
        pos = torch.cat([torch.arange(n, device="cuda") for n in lens_])[None]
        seg = torch.cat([torch.full((n,), i, device="cuda")
                         for i, n in enumerate(lens_)])[None]
        pages = torch.cat([torch.arange(n, device="cuda") // 128 + 1 + 3 * i
                           for i, n in enumerate(lens_)])[None]
        last = torch.tensor(lens_, device="cuda").cumsum(0) - 1
        logits = []
        for params in (eng.params, eng_mem.params):
            shape = (cfg.n_layers * 16, cfg.n_kv_heads, 128, cfg.hd)
            kp = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
            vp = torch.zeros_like(kp)
            logits.append(forward_paged(
                params, cfg, tokens, pos, kp, vp,
                torch.zeros(1, 16, dtype=torch.int32, device="cuda"),
                torch.tensor([n_tok], dtype=torch.int32, device="cuda"),
                cfg.max_seq_len, token_pages=pages, segment_ids=seg,
                packed_last_idx=last))
        if not torch.equal(logits[0], logits[1]):
            raise AssertionError("checkpoint engine's logits differ from the "
                                 "in-memory engine's")
        del eng_mem, mem
        texts = {}
        for label, engine in (("bf16", eng), ("int8", eng8)):
            t0 = time.time()
            res = engine.generate_batch([
                GenerationRequest(prompt=f"Meeting notes, part {i}: the team "
                                  "reviewed the budget and the schedule.",
                                  request_id=i, temperature=0.0,
                                  max_new_tokens=16) for i in range(8)])
            secs[f"generate_{label}"] = time.time() - t0
            bad = [r.request_id for r in res if r.error is not None]
            if bad or len(res) != 8:
                raise AssertionError(f"{label} checkpoint engine failed requests {bad}")
            if engine.audit():
                raise AssertionError(f"{label} checkpoint engine audit: "
                                     f"{engine.audit()}")
            texts[label] = sum(r.completion_tokens for r in res)
        read = native + native  # each engine read every shard once
        del eng, eng8
        torch.cuda.empty_cache()
        return {"phase": "checkpoint",
                "model": f"{preset} widths, {n_layers} layer(s), random bf16",
                "hf_bytes_written": written, "native_bytes_written": native,
                "native_bytes_read": read, "hf_bytes_read": written * 2,
                "seconds": secs, "completion_tokens": texts,
                "convert_said": told.getvalue().strip(),
                "logits_bit_equal": True, "int8_leaves_equal": True}
    finally:
        del tconfig._PRESETS[name]
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


# ------------------------------------------------------------ phase 14

def run_mixtral_path() -> dict:
    """Phase 14: phase 5's transcript and config at ``mixtral-8x7b``'s
    widths, ``MIXTRAL_LAYERS`` deep (8 experts, 2 a token), int8 weights
    drawn and quantized one
    layer at a time on the card, bf16 KV, the prefix cache on.  Fails
    unless nothing failed, the audit is clean, the reduce formed a tree,
    flash, the write-fused decode and the span kernel launched (the
    verify, ancestor-mask and int8-KV builds not), mixed steps and prefix
    hits happened, and peak memory stayed under 64 GiB; then a decode-step
    profile split into attention, expert products, routing and dispatch,
    the other int8 products and the rest."""
    summarizer, engine, stats, wall, launches = summarize_once(
        "mixtral-8x7b", layers=MIXTRAL_LAYERS, quantize="int8")
    em = stats["engine_metrics"]
    never = ("paged_decode_multi", "ragged_spans_anc", "paged_decode_fused_int8",
             "ragged_spans_int8", "paged_decode_multi_int8",
             "ragged_spans_anc_int8")
    require_launches(launches, "mixtral path",
                     ("flash_prefill", "paged_decode_fused", "ragged_spans"),
                     never=never)
    if em["mixed_batch"]["dispatches"] <= 0:
        raise AssertionError("no mixed step ran on the mixtral path")
    if em["prefix_cache"]["tokens_reused"] <= 0:
        raise AssertionError("no prefix-cache hit on the mixtral path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not peak < 64:
        raise AssertionError(f"mixtral path peak memory {peak:.2f} GiB >= 64")
    step = profile_decode_step(engine)
    if engine.audit():
        raise AssertionError(f"allocator audit after profiling: {engine.audit()}")
    summarizer.shutdown()
    cfg = engine._scheduler.model_cfg
    return {"phase": "mixtral",
            "model": f"mixtral-8x7b ({cfg.n_layers} layers, {cfg.n_experts} "
                     "experts, random-init int8 weights, bf16 KV)",
            "decode_step_profile": step,
            "segments": stats["num_input_segments"],
            "chunks": stats["num_chunks"], "requests": em["requests"],
            "reduce_levels": stats["reduce_levels"],
            "prefill_tokens": em["prefill_tokens"],
            "prefill_dispatches": em["prefill_dispatches"],
            "packed_prefill_dispatches": em["packed_prefill_dispatches"],
            "decode_tokens": em["decode_tokens"],
            "decode_blocks": em["decode_blocks"],
            "decode_block_seconds": em["decode_block_seconds"],
            "decode_tokens_per_sec": em["decode_tokens_per_sec"],
            "mixed_step_seconds": em["mixed_step_seconds"],
            "mixed_batch": em["mixed_batch"], "rpa": em["rpa"],
            "prefix_cache": em["prefix_cache"],
            "preemptions": em["preemptions"], "stalls": em["stalls"],
            "audit": engine.audit(), "wall_seconds": wall,
            "stage_times": stats["stage_times"], "peak_memory_gib": peak,
            "build_peak_memory_gib": stats["build_peak_memory_gib"],
            "failed_requests": stats["failed_requests"],
            "summary_chars": len(stats["summary"]), "launches": launches}


# ------------------------------------------------------------ phase 11

PARITY_DIR = Path(__file__).resolve().parent / "build" / "lmrs_tpu_torch" / "parity"
# phase 11 runs bench-8b's widths at this depth (32 until phases 13-14 took
# the script past ~650 s); its flows and gates do not depend on depth
PARITY_LAYERS = 4


class ObservedEngine:
    """Test double around phase 11's ``TorchEngine``: forwards every call,
    and records the requests of each ``generate_batch`` call and, from each
    result as the scheduler delivers it (at the block boundary right after
    the dispatch that finished it), when the call's own requests (the map
    requests of a stream) finished and when requests submitted into the
    stream (reduce nodes) were first admitted: delivery time less
    ``device_seconds``, the scheduler's clock from first admission."""

    schedules_internally = True

    def __init__(self, engine):
        self.engine = engine
        self.tokenizer = engine.tokenizer
        self.reset()

    def reset(self) -> None:
        self.calls: list[list] = []
        self.map_done: list[float] = []
        self.late_admit: list[float] = []

    def generate_batch(self, requests, on_result=None):
        self.calls.append(list(requests))
        if on_result is None:
            return self.engine.generate_batch(requests)
        own = {r.request_id for r in requests}

        def tap(res, submit):
            now = time.time()
            if res.request_id in own:
                self.map_done.append(now)
            else:
                self.late_admit.append(now - res.device_seconds)
            on_result(res, submit)
        return self.engine.generate_batch(requests, on_result=tap)

    def cancel(self, request_id: int) -> None:
        self.engine.cancel(request_id)

    def engine_metrics(self) -> dict:
        return self.engine.engine_metrics()

    def shutdown(self) -> None:
        pass


class RaiseOnce(ObservedEngine):
    """Test double for phase 11e: the engine, with an ``on_result`` hook
    that raises inside the scheduler loop when the first result lands, while
    the other slots are live; the executor must retry the batch."""

    def __init__(self, engine):
        super().__init__(engine)
        self.raised = 0

    def generate_batch(self, requests, on_result=None):
        def hook(res, submit):
            if not self.raised:
                self.raised += 1
                raise RuntimeError("phase 11e: scripted fault inside the loop")
        return self.engine.generate_batch(requests, on_result=hook)


def metrics_delta(before: dict, after: dict) -> dict:
    """What one sub-phase added to the engine's cumulative metrics."""
    def flat(m):
        return {"requests": m["requests"], "prefill_tokens": m["prefill_tokens"],
                "decode_tokens": m["decode_tokens"],
                "preemptions": m["preemptions"], "cancelled": m["cancelled"],
                "deadline": m["deadline"], "shed": m["shed"],
                "mixed_dispatches": m["mixed_batch"]["dispatches"],
                "span_dispatches": m["rpa"]["dispatches"],
                "prefix_tokens_reused": m["prefix_cache"]["tokens_reused"],
                "decode_block_seconds": m["decode_block_seconds"],
                "mixed_step_seconds": m["mixed_step_seconds"]}
    a, b = flat(before), flat(after)
    return {k: round(b[k] - a[k], 4) for k in a}


def require_pool_back(engine, where: str) -> None:
    """Every page free but those the prefix cache holds; a clean audit."""
    sched = engine._scheduler
    want = sched.cache.num_pages - 1 - sched._prefix_cache.cached_pages
    if sched.cache.allocator.free_count != want:
        raise AssertionError(f"{where}: {sched.cache.allocator.free_count} "
                             f"free pages, want {want}")
    if engine.audit():
        raise AssertionError(f"{where}: allocator audit {engine.audit()}")


def run_parity_path(smi: str) -> dict:
    """Phase 11: the pipeline, executor and CLI parity flows at bench-8b's
    widths (``PARITY_LAYERS`` deep) with phase 5's settings, over ONE
    engine shared by the
    sub-phases (11a stream + save, 11b resume, 11c many, 11d cancel and
    deadlines, 11e retry); each sub-phase zeroes the launch counters just
    before it and reads them just after, and prints its own line."""
    import dataclasses

    from lmrs_tpu_torch.engine.executor import MapExecutor
    from lmrs_tpu_torch.pipeline import TranscriptSummarizer
    from lmrs_tpu_torch.prompts import resolve_map_prompt
    from lmrs_tpu_torch.utils.demo import load_demo_transcript
    from lmrs_tpu_torch.utils.timing import StageTimer

    from lmrs_tpu_torch.config import model_preset

    cfg = dataclasses.replace(
        phase5_config(streaming=True),
        model=dataclasses.replace(model_preset("bench-8b"),
                                  n_layers=PARITY_LAYERS))
    transcript = load_demo_transcript(max_segments=200)
    t_build = time.time()
    engine = TranscriptSummarizer(cfg, device="cuda").executor.engine
    torch.cuda.synchronize()
    build_s = time.time() - t_build
    sched = engine._scheduler
    obs = ObservedEngine(engine)

    def drive(fn):
        em0 = engine.engine_metrics()
        counted = zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_launches(counted)
        return out, {"wall_seconds": wall,
                     **metrics_delta(em0, engine.engine_metrics()),
                     "launches": launches, "card": smi}

    # 11a: the streaming reduce, the chunk dump written inside the stream
    PARITY_DIR.mkdir(parents=True, exist_ok=True)
    dump = PARITY_DIR / "chunks.json"
    dump.unlink(missing_ok=True)
    stream = TranscriptSummarizer(cfg, engine=obs)
    stats, line = drive(lambda: stream.summarize(transcript,
                                                 save_chunks=str(dump)))
    if stats["failed_requests"] != 0:
        raise AssertionError(f"11a: failed_requests = {stats['failed_requests']}")
    if not stats["hierarchical"]:
        raise AssertionError("11a: the streaming reduce did not form a tree")
    require_pool_back(engine, "11a")
    overlap = sum(t < max(obs.map_done) for t in obs.late_admit)
    if overlap < 1:
        raise AssertionError("11a: no reduce request was admitted while a map "
                             "request was in flight")
    require_launches(line["launches"], "parity stream (11a)",
                     ("flash_prefill", "paged_decode_fused", "ragged_spans"))
    saved = json.loads(dump.read_text(encoding="utf-8"))["chunks"]
    if (len(saved) != stats["num_chunks"]
            or not all(c["summary"] and not c["error"] for c in saved)):
        raise AssertionError(f"11a: the dump holds {len(saved)} chunks of "
                             f"{stats['num_chunks']}, or one without a summary")
    map_prompts = {r.prompt for r in obs.calls[0]}
    emit({"phase": "parity-11a-stream-save", **line,
          "chunks": stats["num_chunks"], "reduce_levels": stats["reduce_levels"],
          "stage_times": stats["stage_times"],
          "reduce_requests_admitted_during_map": overlap,
          "reduce_requests": len(obs.late_admit),
          "engine_build_seconds": build_s, "summary_chars": len(stats["summary"])})

    # 11b: a new summarizer over the same engine resumes from that dump
    obs.reset()
    resume = TranscriptSummarizer(cfg, engine=obs)
    stats_b, line = drive(lambda: resume.summarize(transcript,
                                                   resume_from=str(dump)))
    seen = [r for call in obs.calls for r in call]
    if stats_b["num_resumed_chunks"] != stats_b["num_chunks"]:
        raise AssertionError(f"11b: resumed {stats_b['num_resumed_chunks']} of "
                             f"{stats_b['num_chunks']} chunks")
    if any(r.prompt in map_prompts for r in seen) or not seen:
        raise AssertionError("11b: the resumed run sent a map request")
    if resume.executor.total_requests != len(seen) or stats_b["failed_requests"]:
        raise AssertionError("11b: the executor ran other than the reduce requests")
    reduce_tokens = sum(len(sched._encode(r)[0]) for r in seen)
    computed = line["prefill_tokens"] + line["prefix_tokens_reused"]
    if (computed != reduce_tokens if line["preemptions"] == 0
            else computed < reduce_tokens):
        raise AssertionError(f"11b: {computed} prompt tokens prefilled or "
                             f"reused, the reduce prompts hold {reduce_tokens}")
    require_pool_back(engine, "11b")
    emit({"phase": "parity-11b-resume", **line,
          "num_resumed_chunks": stats_b["num_resumed_chunks"],
          "chunks": stats_b["num_chunks"], "reduce_prompt_tokens": reduce_tokens})

    # 11c: two transcripts through one pooled map queue
    obs.reset()
    many = TranscriptSummarizer(phase5_config(), engine=obs)
    data = [transcript, {"segments":
                         load_demo_transcript(400)["segments"][200:]}]
    outs, line = drive(lambda: many.summarize_many(data))
    n0, n1 = (o["num_chunks"] for o in outs)
    first = [r.prompt for r in obs.calls[0]]
    want = [(1, n0), (1, n1), (2, n0), (2, n1)]
    if not all(o["summary"] for o in outs):
        raise AssertionError("11c: an empty summary")
    if not all(f"SECTION {i} of {n}]" in p for p, (i, n) in zip(first, want)):
        raise AssertionError("11c: the first map requests do not alternate "
                             "between the transcripts")
    n_reduce = sum(len(call) for call in obs.calls[1:])
    if (len(first) != n0 + n1
            or many.executor.total_requests != n0 + n1 + n_reduce
            or line["requests"] != n0 + n1 + n_reduce
            or many.executor.failed_requests):
        raise AssertionError(f"11c: {many.executor.total_requests} requests "
                             f"for {n0} + {n1} map and {n_reduce} reduce")
    require_pool_back(engine, "11c")
    emit({"phase": "parity-11c-many", **line, "chunks": [n0, n1],
          "map_requests": n0 + n1, "reduce_requests": n_reduce,
          "reduce_levels": [o["reduce_levels"] for o in outs]})

    # 11d: cancel and deadlines on 8 of phase 5's map prompts, greedy; the
    # 8 shortest fit the pool together (no preemption), and each run starts
    # with the prefix cache empty, so every prompt prefills whole on its own
    # in every run and the rows left alone compute exactly what they do in
    # the clean run
    _n, _p, chunks = stream._prep(transcript, StageTimer())
    base = [stream.executor.build_map_request(c, resolve_map_prompt(),
                                              request_id=i)
            for i, c in enumerate(chunks)]
    pick = sorted(range(len(base)), key=lambda i: len(base[i].prompt))[:8]

    def parity_requests(deadline=None):
        sched._prefix_cache.clear()
        return [dataclasses.replace(
            base[i], request_id=k, temperature=0.0,
            max_new_tokens=16 if k == 0 else 64,
            deadline_s=None if deadline is None else time.time() + deadline)
            for k, i in enumerate(pick)]

    clean, line_clean = drive(lambda: engine.generate_batch(parity_requests()))
    require_pool_back(engine, "11d clean")
    reqs = parity_requests(deadline=3600.0)
    reqs[7].deadline_s = time.time() - 1.0  # passed before admission: shed
    hit: dict[str, int] = {}

    def on_result(res, submit):
        if hit or res.request_id != 0:  # request 0 ends after 16 tokens
            return
        live = sorted(r for r, n in sched.live_tokens().items()
                      if n and r != res.request_id)
        if len(live) < 2:
            raise AssertionError(f"11d: {live} live at the first result")
        hit["cancelled"], hit["deadline"] = live[0], live[1]
        engine.cancel(live[0])
        reqs[live[1]].deadline_s = time.time() - 1.0
    out, line = drive(lambda: engine.generate_batch(reqs, on_result=on_result))
    hit["shed"] = 7
    for reason, rid in hit.items():
        res = out[rid]
        if res.finish_reason != reason or res.error is not None:
            raise AssertionError(f"11d: request {rid} finished "
                                 f"{res.finish_reason}, want {reason}")
        if reason == "shed":
            if res.completion_tokens or res.text:
                raise AssertionError("11d: the shed request produced output")
        elif not (res.text and 0 < res.completion_tokens < 64):
            raise AssertionError(f"11d: {reason} request {rid} kept "
                                 f"{res.completion_tokens} tokens")
    for res, ref in zip(out, clean):
        if res.request_id not in hit.values() and res.text != ref.text:
            raise AssertionError(f"11d: request {res.request_id}'s text "
                                 "differs from the clean run")
    if (line["cancelled"], line["deadline"], line["shed"]) != (1, 1, 1):
        raise AssertionError(f"11d: counters {line}")
    require_pool_back(engine, "11d")
    emit({"phase": "parity-11d-cancel-deadline", **line,
          "clean_wall_seconds": line_clean["wall_seconds"],
          "clean_prefill_tokens": line_clean["prefill_tokens"],
          "clean_preemptions": line_clean["preemptions"],
          "prompt_tokens": [len(base[i].prompt) for i in pick],
          "finish": {reason: [rid, out[rid].completion_tokens]
                     for reason, rid in hit.items()}})

    # 11e: an exception inside the scheduler loop, retried by the executor
    raising = RaiseOnce(engine)
    executor = MapExecutor(raising, dataclasses.replace(cfg.engine,
                                                        retry_delay=0.0))
    retried, line = drive(lambda: executor.run_requests(parity_requests()))
    if raising.raised != 1 or executor.failed_requests != 0:
        raise AssertionError(f"11e: raised {raising.raised}, failed "
                             f"{executor.failed_requests}")
    if [r.text for r in retried] != [r.text for r in clean]:
        raise AssertionError("11e: the retried texts differ from 11d's clean run")
    require_pool_back(engine, "11e")
    emit({"phase": "parity-11e-retry", **line,
          "executor_requests": executor.total_requests})
    return {"phase": "parity",
            "model": f"bench-8b widths ({PARITY_LAYERS} layers, random-init bf16)",
            "card": smi}


# ------------------------------------------------------------ phase 15

SERVE_DIR = Path(__file__).resolve().parent / "build" / "lmrs_tpu_torch" / "serve"
SERVE_TIMEOUT = 300.0  # seconds one HTTP call may wait on the card
SERVE_CAP = 512  # the served engine's token cap (phase 5's requests ask 64)
CHAT, MESSAGES = "/v1/chat/completions", "/v1/messages"
SERVE_SYSTEM = "You summarize meeting transcripts."


class WaveRecorder:
    """The engine behind phase 15's server: forwards every call, and keeps
    a copy of the requests of each ``generate_batch`` (one batcher
    wave)."""

    def __init__(self, engine):
        self.engine = engine
        self.waves: list[list] = []

    def generate_batch(self, requests, on_result=None, on_tokens=None):
        import dataclasses

        self.waves.append([dataclasses.replace(r) for r in requests])
        return self.engine.generate_batch(requests, on_result=on_result,
                                          on_tokens=on_tokens)

    def __getattr__(self, name):
        return getattr(self.engine, name)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(port: int, method: str, path: str, body=None, headers=None,
              timeout: float = SERVE_TIMEOUT) -> tuple[int, str]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def sse_piece(evt: dict) -> str:
    """The text delta an SSE event of either wire carries ('' if none)."""
    if evt.get("choices"):
        return evt["choices"][0]["delta"].get("content") or ""
    if evt.get("type") == "content_block_delta":
        return evt["delta"]["text"]
    return ""


def sse_stream(port: int, path: str, body: dict) -> dict:
    """One streamed completion: its deltas and events, the ms to the first
    text delta and to the end."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_TIMEOUT)
    t0 = time.time()
    first = None
    deltas, events = [], []
    try:
        conn.request("POST", path, body=json.dumps(
            {**body, "stream": True, "stream_options": {"include_usage": True}}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"15a: {path} stream answered {resp.status}")
        for raw in resp:
            line = raw.decode("utf-8").strip()
            if not line.startswith("data: "):
                continue
            if line[6:] == "[DONE]":
                events.append("[DONE]")
                break
            evt = json.loads(line[6:])
            events.append(evt)
            if "error" in evt:
                raise AssertionError(f"15a: {path} stream error {evt}")
            piece = sse_piece(evt)
            if piece:
                first = first or time.time()
                deltas.append(piece)
            if evt.get("type") == "message_stop":
                break
    finally:
        conn.close()
    return {"deltas": deltas, "events": events,
            "first_delta_ms": (first - t0) * 1e3 if first else None,
            "total_ms": (time.time() - t0) * 1e3}


def usage_counts(usage: dict) -> dict:
    """A response's usage less the ledger's measured seconds: the token
    counts and the bill's tenant and tokens, which two runs of the same
    request share (their walls differ)."""
    cost = usage.get("cost") or {}
    return {**usage, "cost": {k: v for k, v in cost.items()
                              if not k.endswith("seconds")}}


def serve_pair(port: int, sched, path: str, body: dict) -> dict:
    """15a's check of one wire: the request non-streamed, then streamed,
    each from an empty prefix cache (the same dispatch shapes, so the same
    greedy tokens): the deltas join to the non-streamed text, and the
    finish reason and usage agree and are right."""
    sched._prefix_cache.clear()
    t0 = time.time()
    status, raw = http_call(port, "POST", path, body)
    latency = (time.time() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"15a: {path} answered {status}: {raw[:300]}")
    doc = json.loads(raw)
    sched._prefix_cache.clear()
    s = sse_stream(port, path, body)
    want_prompt = 1 + len(sched.tokenizer.encode(
        SERVE_SYSTEM + "\n\n" + body["messages"][-1]["content"]))
    if path == CHAT:
        text, usage = doc["choices"][0]["message"]["content"], doc["usage"]
        reason, n_out = doc["choices"][0]["finish_reason"], usage["completion_tokens"]
        n_in = usage["prompt_tokens"]
        last = s["events"][-2]
        stream_ok = (last["choices"][0]["finish_reason"] == reason
                     and usage_counts(last["usage"]) == usage_counts(usage))
        reason_ok = reason == ("length" if n_out == body["max_tokens"] else "stop")
    else:
        text, usage = doc["content"][0]["text"], doc["usage"]
        reason, n_out = doc["stop_reason"], usage["output_tokens"]
        n_in = usage["input_tokens"]
        last = next(e for e in s["events"] if e.get("type") == "message_delta")
        stream_ok = (last["delta"]["stop_reason"] == reason
                     and usage_counts(last["usage"]) == usage_counts(usage))
        reason_ok = reason == ("max_tokens" if n_out == body["max_tokens"]
                               else "end_turn")
    if "".join(s["deltas"]) != text:
        raise AssertionError(f"15a: {path}: the SSE deltas do not join to the "
                             "non-streamed text")
    if not (stream_ok and reason_ok and n_in == want_prompt
            and 0 < n_out <= body["max_tokens"]):
        raise AssertionError(f"15a: {path}: finish {reason}, usage {usage} "
                             f"(prompt {want_prompt}), stream end {last}")
    return {"latency_ms": latency, "first_delta_ms": s["first_delta_ms"],
            "stream_ms": s["total_ms"], "deltas": len(s["deltas"]),
            "finish": reason, "prompt_tokens": n_in,
            "completion_tokens": n_out, "text": text}


def serve_checks(srv, rec, engine, smi: str, build_s: float) -> dict:
    """15a: the wires, streaming, the stop holdback, one 8-request wave,
    a shed deadline and a client that goes away, over the in-process
    server; every launch counter zeroed just before and read after."""
    import dataclasses
    import socket
    import threading

    from lmrs_tpu_torch.pipeline import TranscriptSummarizer
    from lmrs_tpu_torch.prompts import resolve_map_prompt
    from lmrs_tpu_torch.utils.demo import load_demo_transcript
    from lmrs_tpu_torch.utils.timing import StageTimer

    sched, port = engine._scheduler, srv.port
    summ = TranscriptSummarizer(phase5_config(), engine=engine)
    _n, _p, chunks = summ._prep(load_demo_transcript(max_segments=200),
                                StageTimer())
    base = [summ.executor.build_map_request(c, resolve_map_prompt(),
                                            request_id=i)
            for i, c in enumerate(chunks)]
    pick = sorted(range(len(base)), key=lambda i: len(base[i].prompt))[:8]
    prompt = base[pick[0]].prompt
    chat = {"messages": [{"role": "system", "content": SERVE_SYSTEM},
                         {"role": "user", "content": prompt}],
            "max_tokens": 64, "temperature": 0}
    msgs = {"system": SERVE_SYSTEM, "max_tokens": 64, "temperature": 0,
            "messages": [{"role": "user", "content": prompt}]}
    counted = zero_launches()
    em0 = engine.engine_metrics()
    torch.cuda.synchronize()
    t_phase = time.time()
    out = {"chat": serve_pair(port, sched, CHAT, chat),
           "messages": serve_pair(port, sched, MESSAGES, msgs)}

    out["chat"].pop("text")
    out["messages"].pop("text")

    # 8 of phase 5's map prompts inside one batch window: ONE wave
    bodies = [{"messages": ([{"role": "system", "content": b.system_prompt}]
                            if b.system_prompt else [])
               + [{"role": "user", "content": b.prompt}],
               "max_tokens": 64, "temperature": 0,
               "cache_prefix": b.cache_prefix}
              for b in (base[i] for i in pick)]
    sched._prefix_cache.clear()
    waves0, batches0 = len(rec.waves), srv.batcher.batches_run
    # the window closes at the 8th arrival (max_batch), or after 5 s
    srv.batcher.window_s, srv.batcher.max_batch = 5.0, 8
    answers: list = [None] * 8

    def post(k: int) -> None:
        answers[k] = http_call(port, "POST", CHAT, bodies[k])

    threads = [threading.Thread(target=post, args=(k,)) for k in range(8)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT)
    wave_wall = time.time() - t0
    srv.batcher.window_s, srv.batcher.max_batch = 0.02, 256
    if any(a is None or a[0] != 200 for a in answers):
        raise AssertionError(f"15a: the wave's answers {answers}")
    if (len(rec.waves) != waves0 + 1 or len(rec.waves[-1]) != 8
            or srv.batcher.batches_run != batches0 + 1):
        raise AssertionError(f"15a: {srv.batcher.batches_run - batches0} "
                             "waves for 8 requests inside one window")
    texts = {b["messages"][-1]["content"]:
             json.loads(a[1])["choices"][0]["message"]["content"]
             for b, a in zip(bodies, answers)}

    # a stop string: of the wave's map prompts, the one whose text has the
    # latest first match of a short window (a random model often repeats
    # one byte), run alone from an empty cache; its latest-matching window
    # is the stop (no U+FFFD in it: a character still arriving must not
    # match early)
    def windows(text: str) -> list[str]:
        return [text[i:i + n] for n in (1, 2, 3, 4)
                for i in range(len(text) - n + 1)
                if "�" not in text[i:i + n]]

    def latest(text: str) -> int:
        return max(map(text.index, windows(text)), default=-1)

    body = max(bodies, key=lambda b: latest(texts[b["messages"][-1]["content"]]))
    sched._prefix_cache.clear()
    status, raw = http_call(port, "POST", CHAT, body)
    plain = json.loads(raw)["choices"][0]["message"]["content"]
    if status != 200 or not windows(plain):
        raise AssertionError(f"15a: no stop string in {plain!r}")
    stop = max(windows(plain), key=plain.index)
    sched._prefix_cache.clear()
    s = sse_stream(port, CHAT, {**body, "stop": [stop]})
    cut = plain[:plain.index(stop)]
    end = s["events"][-2]["choices"][0]
    if "".join(s["deltas"]) != cut or end["finish_reason"] != "stop":
        raise AssertionError(f"15a: stop {stop!r}: streamed "
                             f"{''.join(s['deltas'])!r}, want {cut!r}")
    out["stop"] = {"stop": stop, "cut_at": len(cut), "text_chars": len(plain),
                   "deltas": len(s["deltas"])}

    # an expired deadline is shed before any work
    status, raw = http_call(port, "POST", CHAT, chat,
                            headers={"X-LMRS-Deadline": "0.001"})
    shed = json.loads(raw)["choices"][0]["finish_reason"]
    if status != 200 or shed != "shed":
        raise AssertionError(f"15a: the 1 ms deadline finished {shed}")

    # a streamed client that goes away after its first delta (a reset,
    # so the server's next write fails): counted cancelled, pages back
    c0 = engine.engine_metrics()["cancelled"]
    served0 = srv.batcher.requests_served
    payload = json.dumps({**chat, "max_tokens": SERVE_CAP,
                          "stream": True}).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=SERVE_TIMEOUT)
    sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 + f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    buf, got_delta, head = b"", False, True
    while not got_delta:
        chunk = sock.recv(65536)
        if not chunk:
            raise AssertionError("15a: the stream ended before a delta")
        buf += chunk
        if head and b"\r\n\r\n" in buf:  # the response head, then frames
            buf, head = buf.split(b"\r\n\r\n", 1)[1], False
        frames = buf.split(b"\n\n")
        buf = frames.pop()
        got_delta = any(f.startswith(b"data: {") and sse_piece(json.loads(f[6:]))
                        for f in frames)
    import struct

    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    sock.close()
    t0 = time.time()
    while (engine.engine_metrics()["cancelled"] == c0
           or srv.batcher.requests_served == served0):
        if time.time() - t0 > SERVE_TIMEOUT:
            raise AssertionError("15a: the abandoned stream was not cancelled")
        time.sleep(0.05)
    require_pool_back(engine, "15a cancel")

    # a warm repeat: the prompt's cached pages make its tail a span dispatch
    sched._prefix_cache.clear()
    for _ in range(2):
        status, raw = http_call(port, "POST", MESSAGES, msgs)
        if status != 200:
            raise AssertionError(f"15a: warm repeat answered {status}")
    torch.cuda.synchronize()
    phase_s = time.time() - t_phase
    launches = read_launches(counted)
    em1 = engine.engine_metrics()
    require_launches(launches, "serving path (phase 15a)",
                     ("flash_prefill", "paged_decode_fused", "ragged_spans"))
    if engine.audit():
        raise AssertionError(f"15a: allocator audit {engine.audit()}")

    # the wave's texts equal one direct generate_batch of the same 8
    sched._prefix_cache.clear()
    direct = engine.generate_batch([dataclasses.replace(r)
                                    for r in rec.waves[waves0]])
    for r, res in zip(rec.waves[waves0], direct):
        if texts[r.prompt] != res.text:
            raise AssertionError(f"15a: wave request {r.request_id}'s text "
                                 "differs from the direct generate_batch")

    status, raw = http_call(port, "GET", "/healthz")
    health = json.loads(raw)
    if status != 200 or not health.get("prefix_summary"):
        raise AssertionError(f"15a: /healthz {status} {raw[:300]}")
    models = json.loads(http_call(port, "GET", "/v1/models")[1])
    metrics = json.loads(http_call(port, "GET", "/metrics")[1])
    status, prom = http_call(port, "GET", "/metrics",
                             headers={"Accept": "text/plain"})
    if (models["data"][0]["id"] != "bench-8b"
            or metrics["http_requests"] != srv.batcher.requests_served
            or "requests" not in metrics["engine"]
            or "lmrs_http_requests_total" not in prom):
        raise AssertionError("15a: /v1/models or /metrics did not parse")
    return {"phase": "serve-15a", "card": smi,
            "model": f"bench-8b ({engine.model_cfg.n_layers} layers, "
                     "random-init bf16, byte tokenizer)",
            "engine_build_seconds": build_s, "phase_seconds": phase_s,
            **out, "wave": {"requests": 8, "wall_seconds": wave_wall,
                            "prompt_chars": [len(b.prompt) for b in
                                             (base[i] for i in pick)]},
            "deadline_0.001": shed,
            "cancel": {"cancelled": em1["cancelled"] - em0["cancelled"]},
            "http_batches": srv.batcher.batches_run,
            "http_requests": srv.batcher.requests_served,
            "prefix_summary_rows": len(health["prefix_summary"]),
            "requests": em1["requests"] - em0["requests"],
            "prefill_tokens": em1["prefill_tokens"] - em0["prefill_tokens"],
            "mixed_dispatches": (em1["mixed_batch"]["dispatches"]
                                 - em0["mixed_batch"]["dispatches"]),
            "launches": launches}


def serve_router_pipeline(srv, engine, smi: str, main_out: dict) -> dict:
    """15b: ``lmrs-torch --backend http`` as a child process with no card,
    over 15a's server and a port nobody listens on: phase 5's transcript,
    byte tokens and 64 tokens a request.  The CLI, like the reference's,
    has no reduce-budget flag (phase 5 sets 600 tokens), so chunks are cut
    at 600 tokens (phase 5: 1,400): the summaries outgrow the default
    6,000-token reduce batch and form a tree."""
    import os

    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    here = Path(__file__).resolve().parent
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    src, dst = SERVE_DIR / "demo.json", SERVE_DIR / "summary.txt"
    src.write_text(json.dumps(load_demo_transcript(max_segments=200)),
                   encoding="utf-8")
    dead = f"127.0.0.1:{free_port()}"
    counted = zero_launches()
    em0 = engine.engine_metrics()
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "lmrs_tpu_torch.cli", "-i", str(src), "-o",
         str(dst), "--backend", "http", "--hosts",
         f"127.0.0.1:{srv.port},{dead}", "--tokenizer", "byte",
         "--max-tokens-per-chunk", "600", "--max-tokens", "64", "--report",
         "-q"],
        cwd=here, capture_output=True, text=True, timeout=900,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(here)})
    wall = time.time() - t0
    torch.cuda.synchronize()
    launches = read_launches(counted)
    em1 = engine.engine_metrics()
    if proc.returncode != 0:
        raise AssertionError(f"15b: lmrs-torch --backend http exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    report = json.loads(Path(str(dst) + ".report.json").read_text(encoding="utf-8"))
    hosts = report["engine_metrics"]["per_host"]
    served = em1["requests"] - em0["requests"]
    if (report["failed_requests"] or not report["hierarchical"]
            or not dst.read_text(encoding="utf-8")):
        raise AssertionError(f"15b: failed {report['failed_requests']}, tree "
                             f"{report['hierarchical']}")
    if (hosts[0]["served"] != report["total_requests"]
            or served != report["total_requests"]
            or hosts[1]["served"] or hosts[1]["healthy"]):
        raise AssertionError(f"15b: placement {hosts}, engine served {served}")
    if engine.audit():
        raise AssertionError(f"15b: allocator audit {engine.audit()}")
    return {"phase": "serve-15b-router", "card": smi, "wall_seconds": wall,
            "phase5_wall_seconds": main_out["wall_seconds"],
            "requests": report["total_requests"],
            "phase5_requests": main_out["requests"],
            "prefill_tokens": em1["prefill_tokens"] - em0["prefill_tokens"],
            "phase5_prefill_tokens": main_out["prefill_tokens"],
            "chunks": report["num_chunks"],
            "reduce_levels": report["reduce_levels"],
            "dead_host": {k: hosts[1][k] for k in ("host", "healthy",
                                                  "served", "failed")},
            "live_host_served": hosts[0]["served"],
            "mixed_dispatches": (em1["mixed_batch"]["dispatches"]
                                 - em0["mixed_batch"]["dispatches"]),
            "prefix_tokens_reused": (em1["prefix_cache"]["tokens_reused"]
                                     - em0["prefix_cache"]["tokens_reused"]),
            "launches": launches}


def serve_cli_child(smi: str) -> dict:
    """15c: ``python -m lmrs_tpu_torch.serving.cli --model bench-8b
    --tokenizer byte`` as a child on the card: ``/healthz`` within a
    bounded wait, one chat completion answered, SIGINT exits 0."""
    import os
    import signal

    here = Path(__file__).resolve().parent
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    log_path = SERVE_DIR / "serve-cli.log"
    port = free_port()
    t0 = time.time()
    with open(log_path, "w", encoding="utf-8") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "lmrs_tpu_torch.serving.cli", "--model",
             "bench-8b", "--tokenizer", "byte", "--port", str(port)],
            cwd=here, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(here)})
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(
                    f"15c: the server exited {proc.returncode} before "
                    f"/healthz: {log_path.read_text()[-2000:]}")
            if time.time() - t0 > SERVE_TIMEOUT:
                raise AssertionError(f"15c: no /healthz in {SERVE_TIMEOUT} s")
            try:
                if http_call(port, "GET", "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                time.sleep(0.25)
        startup = time.time() - t0
        t1 = time.time()
        status, raw = http_call(port, "POST", CHAT, {
            "messages": [{"role": "user", "content": "Summarize: the budget "
                          "review opened the meeting."}],
            "max_tokens": 16, "temperature": 0})
        first_ms = (time.time() - t1) * 1e3
        doc = json.loads(raw)
        if status != 200 or not doc.get("choices"):
            raise AssertionError(f"15c: chat answered {status}: {raw[:300]}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"15c: SIGINT exit {rc}: "
                                 f"{log_path.read_text()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    return {"phase": "serve-15c-cli", "card": smi,
            "argv": "--model bench-8b --tokenizer byte --port P",
            "startup_seconds": startup, "first_request_ms": first_ms,
            "finish": doc["choices"][0]["finish_reason"],
            "completion_tokens": doc["usage"]["completion_tokens"],
            "sigint_exit": rc,
            "peak_memory": "not reported by the server"}


def run_serve_path(smi: str, main_out: dict) -> dict:
    """Phase 15: 15a and 15b over one in-process server on a bench-8b
    ``TorchEngine`` (phase 5's engine settings, a token cap of
    ``SERVE_CAP``), then 15c once that engine is freed.  Each sub-phase
    prints its own line."""
    import dataclasses
    import gc

    from lmrs_tpu_torch.pipeline import TranscriptSummarizer
    from lmrs_tpu_torch.serving.server import EngineHTTPServer

    cfg = phase5_config()
    cfg = at_depth(dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, max_tokens=SERVE_CAP)), VARIANT_LAYERS)
    t0 = time.time()
    engine = TranscriptSummarizer(cfg, device="cuda").executor.engine
    torch.cuda.synchronize()
    build_s = time.time() - t0
    rec = WaveRecorder(engine)
    srv = EngineHTTPServer(rec, port=0, model_name="bench-8b",
                           batch_window_s=0.02)
    srv.start_background()
    try:
        emit(serve_checks(srv, rec, engine, smi, build_s))
        emit(serve_router_pipeline(srv, engine, smi, main_out))
    finally:
        srv.shutdown()
    del srv, rec, engine
    gc.collect()
    torch.cuda.empty_cache()
    out = serve_cli_child(smi)
    emit(out)
    return {"phase": "serve", "card": smi,
            "startup_seconds": out["startup_seconds"]}


# ------------------------------------------------------------ phase 16

KV_DIR = Path(__file__).resolve().parent / "build" / "lmrs_tpu_torch" / "kv_disk"
KV_TTL = 2.0  # 16c's handoff TTL (seconds): the orphan sweep's deadline
KV_WAVE = 8   # 16a/16b's wave of phase 5's map prompts


class LaunchTally:
    """An engine behind 16c/16d's servers: forwards every call and adds the
    kernel launches of each ``generate_batch`` to its own tally (the two
    engines of a pair never run at once here, so the global counters
    attribute exactly)."""

    def __init__(self, engine):
        self.engine = engine
        self.counted = kernel_counters()
        self.tally = {name: 0 for name in self.counted}

    def reset(self) -> None:
        self.tally = {name: 0 for name in self.counted}

    def generate_batch(self, requests, on_result=None, on_tokens=None):
        before = read_launches(self.counted)
        try:
            return self.engine.generate_batch(requests, on_result=on_result,
                                              on_tokens=on_tokens)
        finally:
            torch.cuda.synchronize()
            for n, (fn, a) in self.counted.items():
                self.tally[n] += getattr(fn, a) - before[n]

    def __getattr__(self, name):
        return getattr(self.engine, name)


def kv_engine(**engine_kw):
    """A bench-8b ``TorchEngine`` with phase 5's settings (``engine_kw``
    on top) and the map requests of phase 5's transcript, greedy, shortest
    first."""
    import dataclasses

    from lmrs_tpu_torch.pipeline import TranscriptSummarizer
    from lmrs_tpu_torch.prompts import resolve_map_prompt
    from lmrs_tpu_torch.utils.demo import load_demo_transcript
    from lmrs_tpu_torch.utils.timing import StageTimer

    cfg = at_depth(phase5_config(**engine_kw), VARIANT_LAYERS)
    summ = TranscriptSummarizer(cfg, device="cuda")
    engine = summ.executor.engine
    _n, _p, chunks = summ._prep(load_demo_transcript(max_segments=200),
                                StageTimer())
    base = [summ.executor.build_map_request(c, resolve_map_prompt(),
                                            request_id=i)
            for i, c in enumerate(chunks)]
    base.sort(key=lambda r: len(r.prompt))
    reqs = [dataclasses.replace(r, temperature=0.0) for r in base]
    torch.cuda.synchronize()
    return engine, reqs


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def kv_wave(engine, reqs, rid0: int) -> dict:
    """One greedy wave through ``generate_batch`` (fresh request ids, launch
    counters zeroed just before and read just after): texts, walls, the
    engine's counter deltas and a clean audit."""
    import dataclasses

    sched = engine._scheduler
    counted = zero_launches()
    c0 = dict(sched.counters)
    torch.cuda.synchronize()
    t0 = time.time()
    res = engine.generate_batch([dataclasses.replace(r, request_id=rid0 + k)
                                 for k, r in enumerate(reqs)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    bad = [r.error for r in res if r.error]
    if bad or engine.audit():
        raise AssertionError(f"16: wave errors {bad[:2]}, audit {engine.audit()}")
    return {"texts": [r.text for r in res], "wall_seconds": wall,
            "delta": {k: v - c0[k] for k, v in sched.counters.items()},
            "launches": read_launches(counted)}


def _node_path(node) -> tuple:
    toks = []
    while node is not None and node.parent is not None:
        toks[:0] = node.tokens
        node = node.parent
    return tuple(toks)


def _page_digest(k, v, i: int) -> str:
    import hashlib

    return hashlib.sha256(k[:, i].tobytes() + v[:, i].tobytes()).hexdigest()


def tree_digests(pc, cache) -> dict:
    """Token path up to each cached page's end -> sha256 of its K and V
    bytes, resident pages read from the pool, host-tier pages from their
    payload."""
    ps, out = pc.page_size, {}
    stack = [(pc.root, ())]
    while stack:
        node, path = stack.pop()
        for child in node.children.values():
            p = path + child.tokens
            if child.pages:
                pay = cache.export_pages(child.pages)
            elif child.spill is not None and not child.spill.get("disk"):
                pay = child.spill
            else:
                pay = None
            if pay is not None:
                for i in range(len(child.tokens) // ps):
                    out[p[: len(path) + (i + 1) * ps]] = _page_digest(
                        pay["k"], pay["v"], i)
            stack.append((child, p))
    return out


def record_restores(pc, cache, out: list):
    """Wrap ``prefetch_into``: digest each restored page right after its
    restore (one export: ordered after the scatter on the same stream).
    Returns the unwrap."""
    orig = pc.prefetch_into

    def rec(node, dest, kv_cache, sync=False):
        path = _node_path(node)
        n = orig(node, dest, kv_cache, sync=sync)
        pay = cache.export_pages(dest)
        base = len(path) - len(node.tokens)
        for i in range(len(dest)):
            out.append((path[: base + (i + 1) * pc.page_size],
                        _page_digest(pay["k"], pay["v"], i)))
        return n

    pc.prefetch_into = rec
    return lambda: setattr(pc, "prefetch_into", orig)


def check_restores(restored: list, digests: dict, where: str) -> int:
    bad = [k for k, d in restored if digests.get(k) != d]
    if not restored or bad:
        raise AssertionError(f"{where}: {len(bad)} of {len(restored)} restored "
                             "pages differ from the bytes captured for them")
    return len(restored)


def tier_rates(cache, n: int, reps: int) -> dict:
    """Capture (``export_pages``: gather + pinned D2H + sync) and restore
    (``import_pages(sync=True)``: pinned H2D + scatter) of ``n`` pages,
    median seconds over ``reps`` and GB/s."""
    import statistics

    pages = cache.alloc_pages(n)
    try:
        cap, res = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.time()
            pay = cache.export_pages(pages)
            cap.append(time.time() - t0)
            torch.cuda.synchronize()
            t0 = time.time()
            cache.import_pages(pages, pay, sync=True)
            res.append(time.time() - t0)
    finally:
        cache.allocator.free(pages)
    nbytes = n * cache.page_payload_bytes()
    c, r = statistics.median(cap), statistics.median(res)
    return {"pages": n, "bytes": nbytes, "capture_seconds": c,
            "capture_gb_per_s": nbytes / c / 1e9, "restore_seconds": r,
            "restore_gb_per_s": nbytes / r / 1e9}


def run_host_tier_path(smi: str) -> tuple[dict, dict]:
    """16a and 16b on one bench-8b engine with the default settings (the
    host tier on).  16a: a cold wave of 8 map prompts, a rerun with the
    prefix pages resident (their bytes digested), ``evict(10_000)``
    (every cached page spills to host RAM) and a rerun that restores them;
    the restored rerun's texts equal the resident rerun's (the same pages'
    bytes, the same continuation dispatch shapes).  16b: the engine's host
    pool replaced by a 4-page one over a disk pool under ``build/``; an
    eviction demotes pages to spill files, a rerun restores them disk →
    host → device; then one spill file is corrupted and the rerun holding
    it re-prefills that segment, its texts equal a rerun in which the
    segment was dropped by hand (the same shapes)."""
    import gc
    import shutil

    from lmrs_tpu_torch.engine.host_kv import DiskKVPool, HostKVPool

    t_build = time.time()
    engine, reqs = kv_engine()
    build_s = time.time() - t_build
    sched, cache = engine._scheduler, engine._scheduler.cache
    pc = sched._prefix_cache
    wave = reqs[:KV_WAVE]
    if pc.pool is None:
        raise AssertionError("16a: the host tier is not armed by default")
    cold = kv_wave(engine, wave, 0)
    resident = kv_wave(engine, wave, 100)
    digests = tree_digests(pc, cache)
    m0 = dict(sched.counters)
    torch.cuda.synchronize()
    t0 = time.time()
    spilled = pc.evict(10_000)
    evict_s = time.time() - t0
    pinned = pc.pool.used_bytes
    host_stats = getattr(torch.cuda, "host_memory_stats", None)
    restored: list = []
    unwrap = record_restores(pc, cache, restored)
    try:
        rerun = kv_wave(engine, wave, 200)
    finally:
        unwrap()
    d = {k: v - m0[k] for k, v in sched.counters.items()}
    n_checked = check_restores(restored, digests, "16a")
    if not (d["prefix_spill_pages"] == d["prefix_prefetch_pages"] > 0):
        raise AssertionError(f"16a: spill pages {d['prefix_spill_pages']} != "
                             f"prefetch pages {d['prefix_prefetch_pages']}")
    if d["prefix_spilled_hits"] <= 0:
        raise AssertionError("16a: no spilled hit")
    if rerun["delta"]["prefill_tokens"] >= cold["delta"]["prefill_tokens"]:
        raise AssertionError("16a: the rerun prefilled no fewer tokens than "
                             "the cold wave")
    if rerun["texts"] != resident["texts"]:
        raise AssertionError("16a: restored-prefix texts differ from the "
                             "resident-prefix texts")
    require_launches(cold["launches"], "16a cold wave",
                     ("flash_prefill", "paged_decode_fused"))
    # every rerun prompt is a prefix hit: its tail is a span dispatch
    require_launches(rerun["launches"], "16a rerun",
                     ("paged_decode_fused", "ragged_spans"))
    page = cache.page_payload_bytes()
    out_a = {"phase": "kv-16a", "card": smi, "build_seconds": build_s,
             "page_bytes": page, "prompts": len(wave),
             "cold": {"wall_seconds": cold["wall_seconds"],
                      "launches": nonzero(cold["launches"]),
                      "prefill_tokens": cold["delta"]["prefill_tokens"]},
             "resident_rerun": {
                 "wall_seconds": resident["wall_seconds"],
                 "launches": nonzero(resident["launches"]),
                 "prefill_tokens": resident["delta"]["prefill_tokens"],
                 "spilled_hits": resident["delta"]["prefix_spilled_hits"]},
             "spilled_rerun": {
                 "wall_seconds": rerun["wall_seconds"],
                 "launches": nonzero(rerun["launches"]),
                 "prefill_tokens": rerun["delta"]["prefill_tokens"]},
             "evict_pages": spilled, "evict_capture_seconds": evict_s,
             "evict_capture_gb_per_s": spilled * page / evict_s / 1e9,
             "spill_pages": d["prefix_spill_pages"],
             "prefetch_pages": d["prefix_prefetch_pages"],
             "spilled_hits": d["prefix_spilled_hits"],
             "tokens_prefetched": d["prefix_tokens_prefetched"],
             "restore_seconds": d["prefetch_seconds"],
             "restored_pages_bit_equal": n_checked,
             "texts_equal_resident": True,
             "pinned_host_bytes": pinned,
             "host_allocator": ({k: v for k, v in host_stats().items()
                                 if "bytes" in k}
                                if host_stats else "not measured"),
             "rate_per_page": tier_rates(cache, 1, 5),
             "rate_per_wave": tier_rates(cache, 64, 3),
             "audit": engine.audit()}
    emit(out_a)

    # 16b: a 4-page host pool over a disk pool
    if pc.spilled_pages() or pc.disk is not None:
        raise AssertionError("16b: spilled pages left before the pool swap")
    KV_DIR.mkdir(parents=True, exist_ok=True)
    disk = DiskKVPool(64 * page, str(KV_DIR))
    io = {"write_s": 0.0, "read_s": 0.0}

    def timed(fn, key):
        def call(*a, **kw):
            t = time.time()
            try:
                return fn(*a, **kw)
            finally:
                io[key] += time.time() - t
        return call

    disk.write, disk.read = timed(disk.write, "write_s"), timed(disk.read, "read_s")
    pc.pool = HostKVPool(4 * page, disk=disk)
    m0 = dict(sched.counters)
    pc.evict(10_000)
    if disk.demoted_pages_total <= 0:
        raise AssertionError("16b: nothing demoted to disk")
    restored = []
    unwrap = record_restores(pc, cache, restored)
    try:
        disk_rerun = kv_wave(engine, wave, 300)
    finally:
        unwrap()
    n_disk = check_restores(restored, digests, "16b")
    if disk.promoted_pages_total <= 0:
        raise AssertionError("16b: no disk page promoted")
    if disk_rerun["texts"] != resident["texts"]:
        raise AssertionError("16b: disk-restored texts differ from 16a's")
    # a corrupt spill file: its segment re-prefills
    pc.evict(10_000)
    leaf = next((n for n, _b in disk.entries.values() if not n.children), None)
    if leaf is None:
        raise AssertionError("16b: no disk-tier leaf to corrupt")
    victim = _node_path(leaf)
    raw = bytearray(Path(leaf.spill["path"]).read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    Path(leaf.spill["path"]).write_bytes(bytes(raw))
    fails0 = disk.read_failures_total
    corrupt = kv_wave(engine, wave, 400)
    if disk.read_failures_total != fails0 + 1:
        raise AssertionError("16b: the corrupt file was not read and refused")
    # the same state with that segment dropped by hand
    pc.evict(10_000)
    node, want = pc.root, victim
    while want:
        node = node.children[tuple(want[: pc.page_size])]
        want = want[len(node.tokens):]
    pc._drop_subtree(node)
    dropped = kv_wave(engine, wave, 500)
    if corrupt["texts"] != dropped["texts"]:
        raise AssertionError("16b: corrupt-file texts differ from the "
                             "dropped-segment texts")
    written, read = disk.bytes_written_total, disk.bytes_read_total
    d = {k: v - m0[k] for k, v in sched.counters.items()}
    pc.clear()
    left = list(Path(disk.dir).iterdir())
    shutil.rmtree(KV_DIR, ignore_errors=True)
    if left or engine.audit():
        raise AssertionError(f"16b: files left {left}, audit {engine.audit()}")
    out_b = {"phase": "kv-16b", "card": smi, "host_budget_pages": 4,
             "demoted_pages": disk.demoted_pages_total,
             "promoted_pages": disk.promoted_pages_total,
             "restored_pages_bit_equal": n_disk,
             "texts_equal_16a": True, "read_failures": disk.read_failures_total,
             "corrupt_texts_equal_dropped": True,
             "bytes_written": written, "write_seconds": io["write_s"],
             "bytes_read": read, "read_seconds": io["read_s"],
             "disk_rerun": {"wall_seconds": disk_rerun["wall_seconds"],
                            "launches": nonzero(disk_rerun["launches"])},
             "corrupt_rerun_launches": nonzero(corrupt["launches"]),
             "spill_pages": d["prefix_spill_pages"],
             "prefetch_pages": d["prefix_prefetch_pages"],
             "audit": engine.audit()}
    emit(out_b)
    del engine, sched, cache, pc
    gc.collect()
    torch.cuda.empty_cache()
    return out_a, out_b


def _one_handoff(router, tallies, req, rid: int) -> dict:
    """One request through the disaggregated router, streamed: its text,
    the prefill leg's wall, the decode leg's first delta and wall."""
    import dataclasses

    for t in tallies:
        t.reset()
    legs = {}
    post_prefill = router._post_prefill

    def timed_prefill(*a, **kw):
        t = time.time()
        try:
            return post_prefill(*a, **kw)
        finally:
            legs["prefill_s"] = time.time() - t
            legs["decode_t0"] = time.time()

    router._post_prefill = timed_prefill
    first = {}
    t0 = time.time()
    try:
        res = router.generate_batch(
            [dataclasses.replace(req, request_id=rid)],
            on_tokens=lambda r, d: first.setdefault("t", time.time()))[0]
    finally:
        router._post_prefill = post_prefill
    if res.error or res.finish_reason not in ("stop", "length"):
        raise AssertionError(f"16c: handoff request failed: {res}")
    return {"text": res.text, "wall_s": time.time() - t0,
            "prefill_leg_s": legs["prefill_s"],
            "decode_first_token_s": first["t"] - legs["decode_t0"],
            "first_token_s": first["t"] - t0,
            "launches": [nonzero(t.tally) for t in tallies]}


def run_handoff_path(smi: str) -> tuple[dict, dict]:
    """16c and 16d over two bench-8b engines in this process, then 16c's
    int8 part on a fresh pair.  16c: a prefill-role and a decode-role
    ``EngineHTTPServer`` behind a ``RouterEngine`` with role pools; 4 map
    prompts one at a time, each text equal to the prompt run colocated on
    the decode engine from an empty cache (the same shapes), flash only on
    the prefill engine and decode only on the decode engine, no pins left;
    then the decode server is shut down and a 2-request wave falls back to
    a colocated re-prefill with no failed request while the prefill side's
    orphan sweep reclaims the pins after ``KV_TTL``.  16d: the same engines
    behind ``role="both"`` servers: a warm host's page set exported and
    imported by its sibling over ``/v1/kv`` makes the sibling's run of the
    same prompt a prefix hit (its tail through the span kernel) with the
    warm host's own prefix-hit text; then a same-preamble group of 8
    through a colocated router prefetches into the sibling."""
    import dataclasses
    import gc

    from lmrs_tpu_torch.engine.api import preamble_key
    from lmrs_tpu_torch.serving import server as server_mod
    from lmrs_tpu_torch.serving.handoff import decode_payload, encode_payload
    from lmrs_tpu_torch.serving.router import RouterEngine
    from lmrs_tpu_torch.serving.server import EngineHTTPServer

    t_build = time.time()
    pe, reqs = kv_engine(handoff_ttl_s=KV_TTL)
    de, _ = kv_engine(handoff_ttl_s=KV_TTL)
    build_s = time.time() - t_build
    if not torch.equal(pe.params["embed"], de.params["embed"]):
        raise AssertionError("16c: the two engines drew different weights")
    ptal, dtal = LaunchTally(pe), LaunchTally(de)
    codec = {"encode_s": 0.0, "bytes": [], "decode_s": 0.0}

    def enc(payload):
        t = time.time()
        data = encode_payload(payload)
        codec["encode_s"] += time.time() - t
        codec["bytes"].append(len(data))
        return data

    def dec(data):
        t = time.time()
        try:
            return decode_payload(data)
        finally:
            codec["decode_s"] += time.time() - t

    server_mod.encode_payload, server_mod.decode_payload = enc, dec
    psrv = EngineHTTPServer(ptal, port=0, role="prefill", handoff_ttl_s=KV_TTL)
    dsrv = EngineHTTPServer(dtal, port=0, role="decode", handoff_ttl_s=KV_TTL)
    xfer = []
    fetch = dsrv._fetch_blob

    def timed_fetch(*a, **kw):
        t = time.time()
        try:
            return fetch(*a, **kw)
        finally:
            xfer.append(time.time() - t)

    dsrv._fetch_blob = timed_fetch
    for srv in (psrv, dsrv):
        srv.start_background()
    router = RouterEngine([], timeout_s=SERVE_TIMEOUT,
                          prefill_hosts=[f"127.0.0.1:{psrv.port}"],
                          decode_hosts=[f"127.0.0.1:{dsrv.port}"])
    try:
        rows = []
        for k, req in enumerate(reqs[:4]):
            for e in (pe, de):
                e._scheduler._prefix_cache.clear()
            row = _one_handoff(router, (ptal, dtal), req, 1000 + k)
            de._scheduler._prefix_cache.clear()
            colo = de.generate_batch([dataclasses.replace(
                req, request_id=2000 + k)])[0].text
            if row["text"] != colo:
                raise AssertionError(f"16c: request {k}: handoff text differs "
                                     "from the colocated text")
            pl, dl = row.pop("launches")
            if not (pl.get("flash_prefill", 0) > 0
                    and "paged_decode_fused" not in pl
                    and dl.get("paged_decode_fused", 0) > 0
                    and "flash_prefill" not in dl):
                raise AssertionError(f"16c: request {k}: prefill-engine "
                                     f"launches {pl}, decode-engine {dl}")
            row["prefill_engine_launches"], row["decode_engine_launches"] = pl, dl
            row.pop("text")
            rows.append(row)
        pm, dm = pe._scheduler.metrics, de._scheduler.metrics
        if not (pm["handoff_exports"] == dm["handoff_imports"] == 4):
            raise AssertionError(f"16c: exports {pm['handoff_exports']}, "
                                 f"imports {dm['handoff_imports']}")
        if pe.pinned_handoffs() or pe.audit() or de.audit():
            raise AssertionError(f"16c: pins {pe.pinned_handoffs()}, audits "
                                 f"{pe.audit()} {de.audit()}")
        import_s = de._scheduler.counters["handoff_import_seconds"] / 4
        # the decode server goes away: a wave falls back colocated
        dsrv.shutdown()
        for e in (pe, de):
            e._scheduler._prefix_cache.clear()
        orphaned0 = pe._scheduler.counters["handoff_orphaned_pages"]
        t0 = time.time()
        wave = router.generate_batch([dataclasses.replace(r, request_id=3000 + k)
                                      for k, r in enumerate(reqs[4:6])])
        fallback_s = time.time() - t0
        if any(r.error for r in wave) or router._handoff_fallbacks < 1:
            raise AssertionError(f"16c: fallback wave {wave}, fallbacks "
                                 f"{router._handoff_fallbacks}")
        # the tickets minted for the wave are never acked: the sweep
        # reclaims their pins once KV_TTL passes (during or after the wave)
        t0 = time.time()
        while pe.pinned_handoffs() and time.time() - t0 < KV_TTL + 10:
            time.sleep(0.2)
        swept_s = time.time() - t0
        orphaned = pe._scheduler.counters["handoff_orphaned_pages"] - orphaned0
        if orphaned <= 0 or pe.pinned_handoffs() or pe.audit():
            raise AssertionError(f"16c: orphaned pages {orphaned}, pins "
                                 f"{pe.pinned_handoffs()}, audit {pe.audit()}")
        out_c = {"phase": "kv-16c", "card": smi, "build_seconds": build_s,
                 "requests": rows, "payload_bytes": codec["bytes"][:4],
                 "encode_seconds": codec["encode_s"] / max(1, len(codec["bytes"])),
                 "transfer_seconds": xfer[:4],
                 "decode_payload_seconds": codec["decode_s"] / max(1, len(xfer)),
                 "import_seconds": import_s,
                 "texts_equal_colocated": 4,
                 "handoff_exports": pm["handoff_exports"],
                 "handoff_imports": dm["handoff_imports"],
                 "fallback_wave_seconds": fallback_s,
                 "fallbacks": router._handoff_fallbacks,
                 "orphaned_pages": orphaned,
                 "sweep_wait_after_wave_seconds": swept_s}
    finally:
        router.shutdown()
        psrv.shutdown()
        dsrv.shutdown()
        server_mod.encode_payload, server_mod.decode_payload = (
            encode_payload, decode_payload)

    # 16d: the /v1/kv wire between role="both" servers
    asrv = EngineHTTPServer(ptal, port=0)
    bsrv = EngineHTTPServer(dtal, port=0)
    for srv in (asrv, bsrv):
        srv.start_background()
    router = None
    try:
        for e in (pe, de):
            e._scheduler._prefix_cache.clear()
        req = reqs[0]
        body = {"messages": ([{"role": "system", "content": req.system_prompt}]
                             if req.system_prompt else [])
                + [{"role": "user", "content": req.prompt}],
                "max_tokens": 64, "temperature": 0,
                "cache_prefix": req.cache_prefix}
        status, raw = http_call(asrv.port, "POST", CHAT, body)  # warm
        if status != 200:
            raise AssertionError(f"16d: warm host answered {status}")
        key = preamble_key(req.system_prompt, req.prompt, req.cache_prefix)
        t0 = time.time()
        status, raw = http_call(asrv.port, "POST", "/v1/kv/export",
                                {"preamble": key})
        export_s = time.time() - t0
        if status != 200:
            raise AssertionError(f"16d: export answered {status}: {raw[:200]}")
        ticket = json.loads(raw)
        # the warm host's own prefix-hit text over exactly the exported
        # pages (its cached page past them dropped): the sibling's shapes
        apc = pe._scheduler._prefix_cache
        ids, _n = pe._scheduler._encode(dataclasses.replace(req))
        node, pos = apc.root, 0
        while pos < ticket["tokens"]:
            node = node.children[tuple(ids[pos: pos + apc.page_size])]
            pos += len(node.tokens)
        for child in list(node.children.values()):
            apc._drop_subtree(child)
        status, raw = http_call(asrv.port, "POST", CHAT, body)
        if status != 200:
            raise AssertionError(f"16d: warm host answered {status}")
        warm_text = json.loads(raw)["choices"][0]["message"]["content"]
        t0 = time.time()
        status, raw = http_call(bsrv.port, "POST", "/v1/kv/import",
                                {"ticket": ticket["ticket"],
                                 "source": f"127.0.0.1:{asrv.port}"})
        import_s = time.time() - t0
        if status != 200:
            raise AssertionError(f"16d: import answered {status}: {raw[:200]}")
        gone = http_call(asrv.port, "GET", f"/v1/kv/{ticket['ticket']}")[0]
        dtal.reset()
        c0 = dict(de._scheduler.counters)
        status, raw = http_call(bsrv.port, "POST", CHAT, body)
        text = json.loads(raw)["choices"][0]["message"]["content"]
        sibling_launches = nonzero(dtal.tally)
        hits = de._scheduler.counters["prefix_hits"] - c0["prefix_hits"]
        reused = (de._scheduler.counters["prefix_tokens_reused"]
                  - c0["prefix_tokens_reused"])
        if status != 200 or gone != 410 or hits != 1 or reused <= 0:
            raise AssertionError(f"16d: sibling run {status}, ticket after ack "
                                 f"{gone}, hits {hits}, reused {reused}")
        if sibling_launches.get("ragged_spans", 0) <= 0 or text != warm_text:
            raise AssertionError(f"16d: sibling launches {dtal.tally}, text "
                                 f"equal {text == warm_text}")
        # a same-preamble group of 8 through a colocated router
        router = RouterEngine([f"127.0.0.1:{asrv.port}",
                               f"127.0.0.1:{bsrv.port}"],
                              timeout_s=SERVE_TIMEOUT)
        router._refresh_summaries()
        t0 = time.time()
        while len(router._summaries) < 2 and time.time() - t0 < 10:
            time.sleep(0.05)
        # the servers hold the wave's requests 2 s, so the prefetch legs
        # land before either engine starts the wave
        for srv in (asrv, bsrv):
            srv.batcher.window_s = 2.0
        group = [dataclasses.replace(r, request_id=4000 + k)
                 for k, r in enumerate(reqs[:8])]
        t0 = time.time()
        res = router.generate_batch(group)
        group_s = time.time() - t0
        while router._kv_prefetches + router._kv_failures < 1 \
                and time.time() - t0 < 30:
            time.sleep(0.1)
        prom = router.prometheus_metrics()
        line = next(ln for ln in prom.splitlines()
                    if ln.startswith("lmrs_kv_migrate_prefetches_total"))
        if any(r.error for r in res) or float(line.split()[-1]) <= 0:
            raise AssertionError(f"16d: group errors "
                                 f"{[r.error for r in res if r.error]}, {line}, "
                                 f"failures {router._kv_failures}")
        if pe.audit() or de.audit():
            raise AssertionError(f"16d: audits {pe.audit()} {de.audit()}")
        out_d = {"phase": "kv-16d", "card": smi,
                 "export_tokens": ticket["tokens"], "export_bytes": ticket["bytes"],
                 "export_seconds": export_s, "import_seconds": import_s,
                 "sibling_prefix_hits": hits, "sibling_tokens_reused": reused,
                 "sibling_text_equal_warm_host": True,
                 "sibling_launches": sibling_launches,
                 "ticket_after_ack": gone, "group": len(group),
                 "group_seconds": group_s,
                 "prefetches": router._kv_prefetches,
                 "prefetch_failures": router._kv_failures,
                 "prometheus": line}
    finally:
        if router is not None:
            router.shutdown()
        asrv.shutdown()
        bsrv.shutdown()
    del pe, de, ptal, dtal, asrv, bsrv, psrv, dsrv
    gc.collect()
    torch.cuda.empty_cache()

    # 16c, int8 KV: a fresh pair, engine level, the payload through the codec
    pe, reqs = kv_engine(kv_quantize="int8")
    de, _ = kv_engine(kv_quantize="int8")
    req = reqs[0]
    r = pe.generate_batch([dataclasses.replace(req, request_id=5000,
                                               handoff_export=True)])[0]
    if r.finish_reason != "handoff":
        raise AssertionError(f"16c int8: prefill side finished {r}")
    payload = decode_payload(encode_payload(pe.export_handoff(5000)))
    if not ("kscale" in payload and payload["dtype"] == "int8"):
        raise AssertionError("16c int8: the payload carries no scales")
    pe.release_handoff(5000)
    got = de.generate_batch([dataclasses.replace(
        req, request_id=5001, handoff_state=payload)])[0]
    colo = de.generate_batch([dataclasses.replace(req, request_id=5002)])[0]
    if got.text != colo.text or pe.audit() or de.audit():
        raise AssertionError(f"16c int8: texts equal {got.text == colo.text}, "
                             f"audits {pe.audit()} {de.audit()}")
    out_c["int8"] = {"payload_bytes": len(encode_payload(payload)),
                     "scales_shape": list(payload["kscale"].shape),
                     "text_equal_colocated": True}
    emit(out_c)
    emit(out_d)
    del pe, de
    gc.collect()
    torch.cuda.empty_cache()
    return out_c, out_d


def run_kv_path(smi: str) -> dict:
    """Phase 16: the spill tiers (16a, 16b), the disaggregated handoff
    (16c) and the ``/v1/kv`` wire (16d) at bench-8b widths,
    ``VARIANT_LAYERS`` deep."""
    a, b = run_host_tier_path(smi)
    c, d = run_handoff_path(smi)
    return {"phase": "kv", "card": smi,
            "launches_16a_rerun": a["spilled_rerun"]["launches"],
            "handoffs": c["handoff_exports"], "prefetches": d["prefetches"]}


# ------------------------------------------------------------ phase 17

JOBS_DIR = Path(__file__).resolve().parent / "build" / "lmrs_tpu_torch" / "jobs17"
JOB_SEGMENTS = 60   # demo segments of 17a's job: 16 map prompts ...
JOB_CHUNK = 350     # ... at this many approx tokens a chunk (the served
                    # surface chunks with the approx counter: <= 1,690 bytes)
JOB_STALL = 0.3     # seconds the first 17a server waits before each chunk
                    # record: a kill window between records
LIVE_SEGMENTS = 120  # 17b's transcript: 6, 10 and 14 chunks after its appends


def cut_presets(layers: int) -> None:
    """Every model preset of this process ``layers`` deep (a served
    child's ``--model`` then builds the cut model)."""
    import dataclasses

    from lmrs_tpu_torch import config

    plain = config.model_preset
    config.model_preset = lambda name: dataclasses.replace(
        plain(name), n_layers=layers)


def jobs_child(args: list[str]) -> int:
    """``python3 chip_smoke.py --jobs-child LAYERS STALL <lmrs-serve-torch
    args>``: 17a's server, its model ``LAYERS`` deep.  With ``STALL`` > 0
    each chunk record is appended ``STALL`` seconds late (it changes when
    a record lands, never what it says).  On a clean exit it prints the
    kernels' launch counts as one JSON line (the counters live in this
    process)."""
    from lmrs_tpu_torch.jobs import journal as jl
    from lmrs_tpu_torch.serving import cli

    cut_presets(int(args[0]))
    args = args[1:]
    stall = float(args[0])
    if stall > 0:
        plain_append = jl.Journal.append

        def paced_append(self, rec):
            if rec.get("type") == "chunk_done":
                time.sleep(stall)
            return plain_append(self, rec)

        jl.Journal.append = paced_append
    counted = kernel_counters()
    rc = cli.main(args[1:])
    print(json.dumps({"launches": read_launches(counted)}), flush=True)
    return rc


def _spawn_jobs_server(port: int, stall: float, log_path: Path, model: str,
                       device: str):
    import os

    here = Path(__file__).resolve().parent
    with open(log_path, "w", encoding="utf-8") as log:
        return subprocess.Popen(
            [sys.executable, str(here / "chip_smoke.py"), "--jobs-child",
             str(VARIANT_LAYERS), str(stall), "--model", model, "--tokenizer", "byte", "--port",
             str(port), "--device", device, "--jobs-dir", str(JOBS_DIR / "dir"),
             "--max-tokens-cap", "64", "-q"],
            cwd=here, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(here)})


def _wait_healthz(proc, port: int, log_path: Path, t0: float) -> float:
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"17a: the server exited {proc.returncode} "
                                 f"before /healthz: "
                                 f"{log_path.read_text()[-2000:]}")
        if time.time() - t0 > SERVE_TIMEOUT:
            raise AssertionError(f"17a: no /healthz in {SERVE_TIMEOUT} s")
        try:
            if http_call(port, "GET", "/healthz", timeout=5)[0] == 200:
                return time.time() - t0
        except OSError:
            time.sleep(0.1)


def run_job_kill_path(smi: str, model: str = "bench-8b",
                      device: str = "cuda") -> dict:
    """17a: a job on ``lmrs-serve-torch --jobs-dir`` survives a SIGKILL
    mid-journal and finishes ``done`` on a restarted server."""
    import shutil
    import signal

    from lmrs_tpu_torch.jobs import journal as jl
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    shutil.rmtree(JOBS_DIR, ignore_errors=True)
    JOBS_DIR.mkdir(parents=True)
    port = free_port()
    procs = []
    try:
        t0 = time.time()
        procs.append(_spawn_jobs_server(port, JOB_STALL, JOBS_DIR / "cold.log",
                                        model, device))
        cold_s = _wait_healthz(procs[0], port, JOBS_DIR / "cold.log", t0)
        body = {"transcript": load_demo_transcript(max_segments=JOB_SEGMENTS),
                "params": {"max_tokens_per_chunk": JOB_CHUNK}}
        status, raw = http_call(port, "POST", "/v1/jobs", body)
        if status != 200:
            raise AssertionError(f"17a: submit answered {status}: {raw[:300]}")
        jid = json.loads(raw)["id"]
        wal = JOBS_DIR / "dir" / f"{jid}.wal"
        while True:
            recs = jl.replay(wal)[0]
            n_chunks = max((r.get("num_chunks", 0) for r in recs
                            if r["type"] == "job_header"), default=0)
            done = [r for r in recs if r["type"] == "chunk_done"]
            if len(done) >= 3:
                break
            if time.time() - t0 > SERVE_TIMEOUT:
                raise AssertionError("17a: fewer than 3 chunk records in "
                                     f"{SERVE_TIMEOUT} s")
            time.sleep(0.02)
        # the map wave is over (records land after it): the uninterrupted
        # map stage's engine counters
        first = json.loads(http_call(port, "GET", "/metrics")[1])["engine"]
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=60)
        recs, meta = jl.replay(wal)
        pre = {jl.chunk_key(r["chunk_index"], r["start_time"], r["end_time"]):
               r["summary"] for r in recs if r["type"] == "chunk_done"}
        if not 3 <= len(pre) < n_chunks:
            raise AssertionError(f"17a: {len(pre)} of {n_chunks} chunk "
                                 "records at the kill")
        wal_bytes, wal_records = wal.stat().st_size, meta["records"]
        t1 = time.time()
        procs.append(_spawn_jobs_server(port, 0.0, JOBS_DIR / "resumed.log",
                                        model, device))
        resumed_s = _wait_healthz(procs[1], port, JOBS_DIR / "resumed.log", t1)
        t2 = time.time()
        while True:
            doc = json.loads(http_call(port, "GET", f"/v1/jobs/{jid}")[1])
            if doc["status"] not in ("queued", "running"):
                break
            if time.time() - t2 > SERVE_TIMEOUT:
                raise AssertionError(f"17a: the job is {doc['status']} after "
                                     f"{SERVE_TIMEOUT} s")
            time.sleep(0.1)
        resume_s = time.time() - t2
        second = json.loads(http_call(port, "GET", "/metrics")[1])["engine"]
        procs[1].send_signal(signal.SIGINT)
        rc = procs[1].wait(timeout=120)
        log = (JOBS_DIR / "resumed.log").read_text()
        if rc != 0:
            raise AssertionError(f"17a: SIGINT exit {rc}: {log[-2000:]}")
        launches = json.loads([ln for ln in log.splitlines()
                               if ln.startswith('{"launches"')][-1])["launches"]
        result, prog = doc.get("result") or {}, doc["progress"]
        if doc["status"] != "done" or not doc["recovered"]:
            raise AssertionError(f"17a: resumed job {doc['status']}: "
                                 f"{doc.get('error')}")
        if prog["num_resumed_chunks"] != len(pre):
            raise AssertionError(f"17a: {prog['num_resumed_chunks']} chunks "
                                 f"resumed, {len(pre)} journaled")
        map_requests = result["total_requests"] - prog["reduce_nodes_done"]
        if map_requests != n_chunks - len(pre) or second["requests"] != \
                result["total_requests"]:
            raise AssertionError(f"17a: {map_requests} map requests for "
                                 f"{n_chunks - len(pre)} chunks left")
        recs, meta = jl.replay(wal)
        if meta["corrupt"]:
            raise AssertionError(f"17a: replay found a corrupt record: {meta}")
        state = jl.rebuild_state(recs)
        again = [r for r in recs if r["type"] == "chunk_done"
                 and jl.chunk_key(r["chunk_index"], r["start_time"],
                                  r["end_time"]) in pre]
        if len(again) != len(pre) or any(
                state["chunks"][k]["summary"] != s for k, s in pre.items()):
            raise AssertionError("17a: a journaled chunk was recomputed or "
                                 "its summary changed")
        require_launches(launches, "resumed job server",
                         ("flash_prefill", "paged_decode_fused"))
        # the journal's fsync'd append on this disk: the chunk records
        # again, into a scratch journal in the same directory
        probe = jl.Journal(JOBS_DIR / "probe.wal")
        t3 = time.time()
        for r in recs[:50]:
            probe.append(r)
        fsync_s = (time.time() - t3) / min(50, len(recs))
        probe.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        shutil.rmtree(JOBS_DIR, ignore_errors=True)
    return {"phase": "jobs-17a", "card": smi, "job": jid,
            "num_chunks": n_chunks, "journaled_at_kill": len(pre),
            "cold_startup_seconds": cold_s,
            "resumed_startup_seconds": resumed_s,
            "resume_to_done_seconds": resume_s,
            "uninterrupted_map": {"requests": first["requests"],
                                  "prefill_tokens": first["prefill_tokens"]},
            "resumed": {"map_requests": map_requests,
                        "reduce_requests": prog["reduce_nodes_done"],
                        "prefill_tokens": second["prefill_tokens"]},
            "journal_bytes_at_kill": wal_bytes,
            "journal_records_at_kill": wal_records,
            "journal_records_final": meta["records"],
            "fsync_seconds_per_record": fsync_s,
            "launches": nonzero(launches)}


def _live_call(port: int, method: str, path: str, body=None) -> dict:
    status, raw = http_call(port, method, path, body)
    if status != 200:
        raise AssertionError(f"{method} {path} answered {status}: {raw[:300]}")
    return json.loads(raw)


def _tree_delta(m0: dict, m1: dict) -> dict:
    rows = m1["spec_tree_rows"] - m0["spec_tree_rows"]
    return {"dispatches": m1["spec_tree"]["dispatches"]
            - m0["spec_tree"]["dispatches"],
            "mean_accept_depth": ((m1["spec_accept_depth_sum"]
                                   - m0["spec_accept_depth_sum"]) / rows)
            if rows else 0.0}


def run_live_path(smi: str, model: str = "bench-8b",
                  device: str = "cuda") -> tuple[dict, dict]:
    """17b and 17c over one in-process ``lmrs-serve-torch`` server (jobs and
    live sessions on) on a full ``model`` engine with tree speculation."""
    import dataclasses
    import gc
    import shutil

    from lmrs_tpu_torch.config import (ChunkConfig, EngineConfig, LiveConfig,
                                       PipelineConfig, ReduceConfig)
    from lmrs_tpu_torch.live import SessionManager
    from lmrs_tpu_torch.pipeline import TranscriptSummarizer
    from lmrs_tpu_torch.serving.router import RouterEngine
    from lmrs_tpu_torch.serving.server import EngineHTTPServer
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    cfg = at_depth(PipelineConfig(
        engine=EngineConfig(model=model, max_tokens=64, seed=0,
                            temperature=0.0, speculate_k=4),
        # byte chunks as phase 5's; arity 4 keeps a reduce node's four
        # 64-token summaries inside the 2,048 window
        chunk=ChunkConfig(tokenizer="byte", max_tokens_per_chunk=1400),
        reduce=ReduceConfig(max_summaries_per_batch=4),
        live=LiveConfig(class_default="bulk")), VARIANT_LAYERS)
    live_dir = JOBS_DIR / "live"
    shutil.rmtree(JOBS_DIR, ignore_errors=True)
    engine = TranscriptSummarizer(cfg, device=device).executor.engine
    rec = WaveRecorder(engine)
    srv = EngineHTTPServer(rec, port=0, model_name=model, batch_window_s=0.02,
                           max_tokens_cap=64, jobs_dir=str(JOBS_DIR / "jobs"),
                           live_dir=str(live_dir), pipeline_config=cfg)
    srv.start_background()
    front = router = None
    try:
        p = srv.port
        _live_call(p, "POST", "/v1/sessions", {"session_id": "live17"})
        segs = load_demo_transcript(max_segments=LIVE_SEGMENTS)["segments"]
        cut = [0, int(len(segs) * 0.4), int(len(segs) * 0.7), len(segs)]
        refreshes, prev, reqs3 = [], None, []
        counted = kernel_counters()
        for i in range(3):
            if i == 1:  # refreshes 2-3: the ones with a hint
                zero_launches()
            w0, m0, t0 = len(rec.waves), engine.engine_metrics(), time.time()
            doc = _live_call(p, "POST", "/v1/sessions/live17/segments",
                             {"segments": segs[cut[i]:cut[i + 1]],
                              "refresh": True})["refresh"]
            torch.cuda.synchronize()
            wall, m1 = time.time() - t0, engine.engine_metrics()
            reqs = [r for w in rec.waves[w0:] for r in w]
            hints = {r.draft_hint for r in reqs}
            if hints != {prev}:
                raise AssertionError(f"17b: refresh {i + 1} carried hints "
                                     f"{[h and h[:40] for h in hints]}")
            if i and not (doc["chunk_summaries_reused"] > 0
                          and doc["reduce_nodes_reused"] > 0
                          and doc["dirty_chunks"] < doc["num_chunks"]):
                raise AssertionError(f"17b: refresh {i + 1} reused nothing: "
                                     f"{ {k: v for k, v in doc.items() if k != 'summary'} }")
            if doc["final_error"] or doc["map_failed"]:
                raise AssertionError(f"17b: refresh {i + 1} degraded")
            refreshes.append({
                "wall_seconds": wall, "requests": len(reqs),
                "hint_chars": len(prev or ""),
                "dirty_chunks": doc["dirty_chunks"],
                "num_chunks": doc["num_chunks"],
                "chunk_summaries_reused": doc["chunk_summaries_reused"],
                "reduce_nodes_reused": doc["reduce_nodes_reused"],
                "reduce_nodes_computed": doc["reduce_nodes_computed"],
                "prefill_tokens": m1["prefill_tokens"] - m0["prefill_tokens"],
                "spec_tree": _tree_delta(m0, m1)})
            prev = doc["summary"]
            if i == 2:
                reqs3 = reqs
        launches = read_launches(counted)
        require_launches(launches, "live session's refreshes 2-3",
                         ("flash_prefill", "ragged_spans_anc"),
                         never=("paged_decode_fused", "paged_decode_multi"))
        cold = SessionManager(None, JOBS_DIR / "cold", config=cfg)
        cold.create(session_id="cold")
        cold.append("cold", segs)
        ident = [(c.chunk_index, c.start_time, c.end_time, c.text)
                 for c in cold.get("cold").inc.chunks()]
        if ident != [(c.chunk_index, c.start_time, c.end_time, c.text)
                     for c in srv.live.get("live17").inc.chunks()]:
            raise AssertionError("17b: chunk boundaries differ from a cold "
                                 "session's")
        before = (_live_call(p, "GET", "/v1/sessions/live17"),
                  _live_call(p, "GET", "/v1/sessions/live17/summary"))
        # 17c: a router front over this server
        router = RouterEngine([f"127.0.0.1:{p}"], timeout_s=SERVE_TIMEOUT)
        front = EngineHTTPServer(router, port=0, batch_window_s=0.01)
        front.start_background()
        f, host = front.port, f"127.0.0.1:{p}"
        t0 = time.time()
        job = _live_call(f, "POST", "/v1/jobs", {
            "transcript": load_demo_transcript(max_segments=20)})
        while job["status"] in ("queued", "running"):
            if time.time() - t0 > SERVE_TIMEOUT:
                raise AssertionError("17c: the routed job did not finish")
            time.sleep(0.1)
            job = _live_call(f, "GET", f"/v1/jobs/{job['id']}")
        job_s = time.time() - t0
        t0 = time.time()
        _live_call(f, "POST", "/v1/sessions", {"session_id": "routed17"})
        _live_call(f, "POST", "/v1/sessions/routed17/segments",
                   {"segments": segs[:20], "refresh": True})
        session_s = time.time() - t0
        for kind, ident_, path in (("job", job["id"], f"/v1/jobs/{job['id']}"),
                                   ("session", "routed17",
                                    "/v1/sessions/routed17")):
            if router._job_hosts.get(ident_) != host:
                raise AssertionError(f"17c: the {kind} is not pinned to "
                                     f"{host}")
            if _live_call(f, path=path, method="GET") != _live_call(
                    p, path=path, method="GET"):
                raise AssertionError(f"17c: the routed {kind} doc differs "
                                     "from the host's")
        if job["status"] != "done":
            raise AssertionError(f"17c: the routed job is {job['status']}")
    finally:
        if front is not None:
            front.shutdown()
        if router is not None:
            router.shutdown()
        srv.shutdown()  # closes the session journals
    try:
        again = SessionManager(engine, live_dir, config=cfg)
        if again.recover() != 2:
            raise AssertionError("17b: the sessions did not recover")
        after = (again.status_doc(again.get("live17")),
                 again.summary_doc("live17"))
        for d in (before[0], after[0]):
            # the usage block bills this manager's own refreshes: a
            # recovered manager has run none
            d.pop("recovered"), d.pop("journal"), d.pop("usage", None)
        if after != before:
            raise AssertionError("17b: the recovered session's docs differ")
        # refresh 3's requests again, the hint suppressed and kept
        depth = {}
        for name, keep in (("without_hint", False), ("with_hint", True)):
            m0 = engine.engine_metrics()
            engine.generate_batch([dataclasses.replace(
                r, request_id=k, draft_hint=r.draft_hint if keep else None)
                for k, r in enumerate(reqs3)])
            depth[name] = _tree_delta(m0, engine.engine_metrics())
        audit = engine.audit()
        if audit:
            raise AssertionError(f"17b: allocator audit: {audit}")
    finally:
        shutil.rmtree(JOBS_DIR, ignore_errors=True)
        del srv, rec, engine
        gc.collect()
        torch.cuda.empty_cache()
    return ({"phase": "live-17b", "card": smi, "refreshes": refreshes,
             "launches_refreshes_2_3": nonzero(launches),
             "refresh_3_rerun": depth, "recovered_docs_equal": True},
            {"phase": "router-17c", "card": smi, "pinned_host": host,
             "job_seconds": job_s, "job_chunks": job["progress"]["num_chunks"],
             "session_create_append_refresh_seconds": session_s})


def run_jobs_live_path(smi: str) -> dict:
    """Phase 17: 17a (a job survives a SIGKILL) once the earlier phases'
    engines are freed, then 17b and 17c.  Each sub-phase prints its own
    line."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    a = run_job_kill_path(smi)
    emit(a)
    b, c = run_live_path(smi)
    emit(b)
    emit(c)
    return {"phase": "jobs-live", "card": smi,
            "resumed_map_requests": a["resumed"]["map_requests"],
            "anc_launches": b["launches_refreshes_2_3"]["ragged_spans_anc"]}


# ------------------------------------------------------------ phase 18

OBS_DIR = Path(__file__).resolve().parent / "build" / "lmrs_tpu_torch" / "obs"
# the lifecycle milestones of a request's trace track (decode_block
# instants and queue_wait spans ride between them)
OBS_MILESTONES = ("enqueue", "admit", "prefix_match", "prefill",
                  "first_token", "decode", "preempt", "finish")
OBS_OFF = {"LMRS_ANATOMY": "0", "LMRS_COST_LEDGER": "0", "LMRS_SLO": "0"}
OBS_WAVE = 8  # 18d's requests a wave


def chain_problems(spans: dict) -> list[str]:
    """Requests whose engine track does not run enqueue → admit → prefill
    → first_token → decode → finish (a preempted request may insert
    preempt and a new admit)."""
    from lmrs_tpu_torch.obs.trace import REQ_TID_BASE

    bad = []
    for tid, evs in spans.items():
        if tid < REQ_TID_BASE:
            continue
        names = [e["name"] for e in evs if e["name"] in OBS_MILESTONES]
        ok = (names and names[0] == "enqueue" and names[-1] == "finish"
              and all(x in names for x in ("admit", "prefill", "first_token",
                                           "decode")))
        if ok:
            order = [names.index(x) for x in ("enqueue", "admit",
                                              "first_token", "finish")]
            ok = order == sorted(order) and names.count("first_token") == 1
            # every admit after the first follows a preempt
            ok = ok and names.count("admit") == 1 + names.count("preempt")
        if not ok:
            bad.append(f"track {tid}: {names}")
    return bad


def anatomy_means(an) -> dict:
    """Per step class: iterations kept and the mean of each host segment,
    the residual and the wall (ms), over the anatomy's per-class records
    (``LMRS_ANATOMY_RESERVOIR`` is set past the run's iterations, so the
    means cover every iteration)."""
    from lmrs_tpu_torch.obs import SEGMENTS

    out = {}
    for cls, recs in an._res.items():
        if not recs:
            continue
        n = len(recs)
        row = {"iterations": an._cls_iters[cls], "kept": n,
               "wall_ms": sum(r[0] for r in recs) / n * 1e3}
        for i, seg in enumerate(SEGMENTS):
            row[f"{seg}_ms"] = sum(r[1][i] for r in recs) / n * 1e3
        row["residual_ms"] = sum(r[2] for r in recs) / n * 1e3
        out[cls] = row
    return out


def free_cuda() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def schedule_counts(em: dict) -> dict:
    """A run's dispatch schedule, as its engine metrics count it."""
    return {"decode_tokens": em["decode_tokens"],
            "prefill_tokens": em["prefill_tokens"],
            "mixed_steps": em["mixed_batch"]["dispatches"],
            "preemptions": em["preemptions"]}


def obs_traced_path(smi: str, main_out: dict) -> dict:
    """18a: phase 5's workload and config with the tracer on (ledger,
    anatomy, SLO and attribution on by default)."""
    import os

    import numpy as np

    from lmrs_tpu_torch.obs import (PID_ENGINE, PID_PIPELINE, TID_SCHED,
                                    disable_tracing, enable_tracing,
                                    export_current, validate_trace_file)
    from lmrs_tpu_torch.utils.perf_model import chip_spec

    OBS_DIR.mkdir(parents=True, exist_ok=True)
    os.environ["LMRS_ANATOMY_RESERVOIR"] = "100000"  # lint: ignore[env.direct-read] a write: the knob for this phase
    tr = enable_tracing()
    try:
        summarizer, engine, stats, wall, launches = summarize_once(
            layers=VARIANT_LAYERS)
        path = OBS_DIR / "trace-18a.json"
        n_events, err = export_current(path)
    finally:
        disable_tracing()
        del os.environ["LMRS_ANATOMY_RESERVOIR"]  # lint: ignore[env.direct-read] a write: the knob for this phase
    if err is not None:
        raise AssertionError(f"18a: trace export failed: {err}")
    events = validate_trace_file(path)
    require_launches(launches, "traced main path (18a)",
                     ("flash_prefill", "paged_decode_fused", "ragged_spans"))
    problems = chain_problems(tr.spans_by_tid(PID_ENGINE))
    if problems:
        raise AssertionError(f"18a: {len(problems)} request chains broken, "
                             f"e.g. {problems[:3]}")
    pipe = [e["name"] for e in events if e["pid"] == PID_PIPELINE
            and e["ph"] == "X"]
    if "map_stage" not in pipe or (pipe.count("reduce_level")
                                   != stats["reduce_levels"]):
        raise AssertionError(f"18a: pipeline track {sorted(set(pipe))}: "
                             f"{pipe.count('reduce_level')} reduce_level "
                             f"spans for {stats['reduce_levels']} levels")
    blocks = [e for e in events if e["name"] == "decode_block"
              and e["ph"] == "X" and e["tid"] == TID_SCHED
              and e["pid"] == PID_ENGINE]
    if not blocks or any(not e["args"]["hbm_gb"] > 0 for e in blocks):
        raise AssertionError("18a: a decode_block span without hbm_gb > 0")
    sched = engine._scheduler
    perf = sched._perf
    hbm, mfu = list(perf.h_hbm.samples), list(perf.h_mfu.samples)
    for what, xs in (("decode HBM utilisation", hbm), ("prefill MFU", mfu)):
        if not xs or not all(0.0 < x <= 1.05 for x in xs):
            raise AssertionError(f"18a: {what} samples outside (0, 1.05]: "
                                 f"n={len(xs)}, min {min(xs, default=None)}, "
                                 f"max {max(xs, default=None)}")
    spec = chip_spec()
    if not spec.known:
        raise AssertionError(f"18a: chip_spec() does not know {spec.kind!r}")
    # a mixed step observes its one combined roofline ratio into both
    # histograms; the rest of the HBM samples are clean decode blocks and
    # the rest of the MFU samples clean synchronous prefills
    blocks_only, clean_prefill = list(hbm), []
    for x in mfu:
        if x in blocks_only:
            blocks_only.remove(x)
        else:
            clean_prefill.append(x)
    em = stats["engine_metrics"]
    cost = em["cost"]
    out = {"phase": "obs-18a", "card": smi, "wall_seconds": wall,
           "phase5_wall_seconds": main_out["wall_seconds"],
           "trace_events": n_events, "trace_bytes": path.stat().st_size,
           "decode_block_spans": len(blocks),
           "anatomy_means_ms": anatomy_means(sched._an),
           "anatomy": {k: em["anatomy"][k] for k in (
               "iterations", "aborted_iterations", "wall_ms", "residual_ms",
               "segments_ms", "host_overhead_us_step")},
           "decode_hbm_util": {"p50": float(np.median(hbm)), "n": len(hbm),
                               "min": min(hbm), "max": max(hbm),
                               "decode_blocks_p50": float(np.median(
                                   blocks_only)) if blocks_only else None,
                               "decode_blocks_n": len(blocks_only)},
           "prefill_mfu": {"p50": float(np.median(mfu)), "n": len(mfu),
                           "min": min(mfu), "max": max(mfu),
                           "mixed_step_combined_n": len(mfu)
                           - len(clean_prefill),
                           "clean_prefill_n": len(clean_prefill)},
           "rtt_ms": em["perf_attribution"]["rtt_ms"],
           "chip_spec": {"kind": spec.kind, "peak_flops": spec.peak_flops,
                         "peak_hbm_bw": spec.peak_hbm_bw},
           "ledger_totals": cost["totals"],
           "ledger_attributed_wall_seconds": cost["attributed_wall_seconds"],
           "slo_state": em["slo"]["state"],
           "schedule": schedule_counts(em),
           "decode_block_seconds": em["decode_block_seconds"],
           "decode_blocks": em["decode_blocks"],
           "ttft_ms": em["ttft_ms"], "launches": nonzero(launches)}
    summarizer.shutdown()
    return out


def obs_off_path(smi: str, traced: dict, main_out: dict) -> dict:
    """18b: the same workload and config with tracing off and the ledger,
    anatomy and SLO switched off before the engine is built."""
    import os

    saved = {k: os.environ.get(k) for k in OBS_OFF}
    os.environ.update(OBS_OFF)
    try:
        summarizer, engine, stats, wall, launches = summarize_once(
            layers=VARIANT_LAYERS)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    em = stats["engine_metrics"]
    if "anatomy" in em or em["cost"]["enabled"] or em["slo"]["enabled"]:
        raise AssertionError("18b: an observability switch did not hold")
    if schedule_counts(em) != traced["schedule"]:
        raise AssertionError(f"18b: the schedule moved with obs off: "
                             f"{schedule_counts(em)} against 18a's "
                             f"{traced['schedule']}")
    summarizer.shutdown()
    return {"phase": "obs-18b", "card": smi, "obs_off_wall_seconds": wall,
            "traced_wall_seconds": traced["wall_seconds"],
            "phase5_wall_seconds": main_out["wall_seconds"],
            "decode_tokens": em["decode_tokens"],
            "launches": nonzero(launches)}


def obs_cli_path(smi: str) -> dict:
    """18c: ``python -m lmrs_tpu_torch.cli`` on the card at bench-8b over
    60 demo segments with ``--trace-out F --profile``; then ``--trace-out
    F2 --no-trace`` (on the mock backend: the flag's behaviour does not
    depend on the engine) must write no F2."""
    import os

    from lmrs_tpu_torch.obs import validate_trace_file
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    here = Path(__file__).resolve().parent
    demo = OBS_DIR / "demo.json"
    demo.write_text(json.dumps(load_demo_transcript(max_segments=200)))
    f1, f2 = OBS_DIR / "trace-18c.json", OBS_DIR / "trace-18c-off.json"
    for f in (f1, f2):
        f.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(here)}
    argv = [sys.executable, "-m", "lmrs_tpu_torch.cli", "-i", str(demo),
            "-o", str(OBS_DIR / "summary-18c.txt"), "--limit-segments", "60",
            "--max-tokens", "64", "--max-tokens-per-chunk", "1400", "-q"]
    t0 = time.time()
    proc = subprocess.run(argv + ["--model", "bench-8b", "--tokenizer",
                                  "byte", "--trace-out", str(f1),
                                  "--profile"],
                          cwd=here, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"18c: exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    events = validate_trace_file(f1)
    names = {e["name"] for e in events}
    want = {"map_stage", "enqueue", "first_token", "finish", "decode_block"}
    if not want <= names:
        raise AssertionError(f"18c: trace lacks {sorted(want - names)}")
    off = subprocess.run(argv + ["--backend", "mock", "--trace-out", str(f2),
                                 "--no-trace"],
                         cwd=here, env=env, capture_output=True, text=True,
                         timeout=300)
    if off.returncode != 0 or f2.exists():
        raise AssertionError(f"18c: --no-trace exit {off.returncode}, "
                             f"file written: {f2.exists()}")
    return {"phase": "obs-18c", "card": smi, "cli_seconds": wall,
            "trace_events": len(events), "trace_bytes": f1.stat().st_size,
            "no_trace_exit": off.returncode, "no_trace_file": f2.exists()}


def obs_post(port: int, path: str, body: dict, headers=None) -> dict:
    status, raw = http_call(port, "POST", path, body, headers)
    if status != 200:
        raise AssertionError(f"18d: {path} answered {status}: {raw[:300]}")
    return json.loads(raw)


def obs_get(port: int, path: str, headers=None):
    status, raw = http_call(port, "GET", path, headers=headers)
    if status != 200:
        raise AssertionError(f"18d: GET {path} answered {status}: {raw[:300]}")
    return raw if path == "/metrics" else json.loads(raw)


def obs_wave(port: int, prompts: list[str], **kw) -> list[dict]:
    """One concurrent wave of chat completions (they share a batch
    window); ``kw`` per request: tenants, deadline, max_tokens."""
    import threading

    out: list = [None] * len(prompts)

    def one(i: int) -> None:
        headers = {}
        if kw.get("tenants"):
            headers["X-LMRS-Tenant"] = kw["tenants"][i % len(kw["tenants"])]
        if kw.get("deadline") is not None:
            headers["X-LMRS-Deadline"] = str(kw["deadline"])
        out[i] = obs_post(port, CHAT, {
            "messages": [{"role": "user", "content": prompts[i]}],
            "max_tokens": kw.get("max_tokens", 32), "temperature": 0},
            headers)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT)
    if any(r is None for r in out):
        raise AssertionError("18d: a wave request did not answer")
    return out


def obs_server_path(smi: str, traced: dict):
    """18d: an in-process server with tracing on (as ``--trace`` turns it
    on) over a bench-8b engine; returns (line, server, engine) for 18e."""
    import dataclasses
    import os
    import threading

    from lmrs_tpu_torch.obs import (enable_tracing, validate_postmortem_file,
                                    validate_trace_events)
    from lmrs_tpu_torch.pipeline import TranscriptSummarizer
    from lmrs_tpu_torch.serving.server import EngineHTTPServer
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    enable_tracing()
    cfg = phase5_config()
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, max_tokens=SERVE_CAP))
    engine = TranscriptSummarizer(cfg, device="cuda").executor.engine
    srv = EngineHTTPServer(engine, port=0, model_name="bench-8b",
                           batch_window_s=0.02)
    srv.start_background()
    port, sched = srv.port, engine._scheduler
    segs = load_demo_transcript(max_segments=200)["segments"]
    prompts = ["Summarize: " + " ".join(s["text"] for s in segs[i * 6:
                                                                i * 6 + 6])
               for i in range(OBS_WAVE)]
    # the wave under two tenants: /v1/usage bills what the responses say
    resps = obs_wave(port, prompts, tenants=("alpha", "beta"))
    usage = obs_get(port, "/v1/usage")
    for t in ("alpha", "beta"):
        mine = [r["usage"] for i, r in enumerate(resps)
                if ("alpha", "beta")[i % 2] == t]
        roll = usage["tenants"][t]
        if (roll["prompt_tokens"] != sum(u["prompt_tokens"] for u in mine)
                or roll["generated_tokens"] != sum(u["completion_tokens"]
                                                   for u in mine)):
            raise AssertionError(f"18d: tenant {t}: {roll} against {mine}")
    fed = sched._cost.report()["attributed_wall_seconds_raw"]
    if abs(usage["totals"]["device_seconds"] - fed) > 1e-6:
        raise AssertionError(f"18d: device-seconds {usage['totals']} != the "
                             f"ledger's fed walls {fed}")
    anatomy = obs_get(port, "/v1/anatomy")
    if not (anatomy["enabled"] and anatomy["iterations"] > 0) or engine.audit():
        raise AssertionError(f"18d: anatomy {anatomy}, audit {engine.audit()}")
    trace = obs_get(port, "/v1/trace")
    validate_trace_events(trace["traceEvents"])
    slo = obs_get(port, "/healthz")["slo"]
    if slo["state"] != "ok":
        raise AssertionError(f"18d: /healthz slo {slo}")
    text = obs_get(port, "/metrics", headers={"Accept": "text/plain"})
    fams = [f for f in ("lmrs_decode_hbm_util_ratio", "lmrs_decode_tokens_total",
                        "lmrs_anatomy_wall_seconds_total", "lmrs_slo_state",
                        "lmrs_http_requests_total")
            if f"# TYPE {f} " not in text]
    if fams:
        raise AssertionError(f"18d: /metrics lacks {fams}")
    # a 2 s capture while a request decodes: the Chrome trace names the
    # port's decode kernel
    prof_dir = OBS_DIR / "profile"
    for f in prof_dir.glob("lmrs-profile-*.json"):
        f.unlink()
    t_prof = time.time()
    obs_post(port, "/v1/debug/profile",
             {"duration_s": 2.0, "out_dir": str(prof_dir)})
    during = threading.Thread(target=obs_wave, args=(port, prompts[:1]),
                              kwargs={"max_tokens": 256})
    during.start()
    during.join(timeout=SERVE_TIMEOUT)
    while not list(prof_dir.glob("lmrs-profile-*.json")):
        if time.time() - t_prof > SERVE_TIMEOUT:
            raise AssertionError("18d: no profile written")
        time.sleep(0.5)
    time.sleep(2.0)  # the exporter writes the file in one call; settle
    prof = next(prof_dir.glob("lmrs-profile-*.json"))
    prof_text = prof.read_text()
    prof_bytes = len(prof_text)
    kernels_seen = {k: k in prof_text for k in ("paged_decode_kernel",
                                                  "flash_prefill_kernel",
                                                  "span_attn_kernel")}
    if not kernels_seen["paged_decode_kernel"]:
        raise AssertionError("18d: the profile names no paged_decode_kernel")
    json.loads(prof_text)
    del prof_text
    prof.unlink()
    # a deadline storm: 8 requests whose budget runs out during their
    # decode, set from this server's TTFT and decode-block wall
    rep = sched.metrics_report()
    block_s = rep["decode_block_seconds"] / max(1, rep["decode_blocks"])
    ttft_s = rep["ttft_ms"]["p90"] / 1e3
    budget = ttft_s + 2.5 * block_s
    pm_dir = OBS_DIR / "postmortems"
    for f in pm_dir.glob("*.json"):
        f.unlink()
    os.environ["LMRS_POSTMORTEM_DIR"] = str(pm_dir)  # lint: ignore[env.direct-read] a write: the knob for this phase
    try:
        storm = obs_wave(port, prompts, deadline=budget, max_tokens=SERVE_CAP)
    finally:
        del os.environ["LMRS_POSTMORTEM_DIR"]  # lint: ignore[env.direct-read] a write: the knob for this phase
    # a request that misses the wave's batch window queues behind it and
    # is shed once its budget has passed (before any work): every one ends
    # deadline or shed, and one sweep expires at least LMRS_DEADLINE_STORM
    # (3) of them in flight
    reasons = [r["choices"][0]["finish_reason"] for r in storm]
    pms = sorted(pm_dir.glob("postmortem-deadline_storm-*.json"))
    if (set(reasons) - {"deadline", "shed"} or reasons.count("deadline") < 3
            or not pms):
        raise AssertionError(f"18d: storm reasons {reasons}, postmortems "
                             f"{[p.name for p in pms]}")
    pm = validate_postmortem_file(pms[0])
    if (pm["extra"]["expired_this_sweep"] < 3
            or not any(e["name"] == "decode_block" for e in pm["spans"])):
        raise AssertionError(f"18d: the storm postmortem {pm['extra']} holds "
                             "no ring spans or fewer than 3 expiries")
    if engine.audit():
        raise AssertionError(f"18d: audit after the storm {engine.audit()}")
    line = {"phase": "obs-18d", "card": smi,
            "usage_totals": usage["totals"], "ledger_fed_seconds": fed,
            "anatomy_iterations": anatomy["iterations"],
            "trace_events": len(trace["traceEvents"]),
            "slo_state_before_storm": slo["state"],
            "profile_bytes": prof_bytes, "profile_kernels": kernels_seen,
            "storm_budget_s": budget, "storm_expired": reasons.count("deadline"),
            "storm_shed": reasons.count("shed"),
            "storm_expired_in_one_sweep": pm["extra"]["expired_this_sweep"],
            "storm_postmortems": len(pms),
            "storm_postmortem_spans": len(pm["spans"]),
            "slo_after_storm": obs_get(port, "/healthz")["slo"]["state"]}
    return line, srv, engine


def obs_fleet_path(smi: str, srv, engine) -> dict:
    """18e: a ``RouterEngine`` over 18d's server and a mock server (a child
    process with ``--trace``, so its ring is its own): the stitched trace
    validates and every routed request's trace id is on the router's
    track and on the host that served it; fleet usage totals equal the
    sum of the hosts'; fleet anatomy merges both."""
    import os

    from lmrs_tpu_torch.engine.api import GenerationRequest
    from lmrs_tpu_torch.obs import stitched_chains, validate_trace_events
    from lmrs_tpu_torch.serving.router import RouterEngine

    here = Path(__file__).resolve().parent
    mport = free_port()
    log_path = OBS_DIR / "mock-18e.log"
    with open(log_path, "w", encoding="utf-8") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "lmrs_tpu_torch.serving.cli", "--backend",
             "mock", "--trace", "--port", str(mport), "-q"],
            cwd=here, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(here)})
    router = None
    try:
        t0 = time.time()
        while True:
            if proc.poll() is not None or time.time() - t0 > 60:
                raise AssertionError(f"18e: mock server not up: "
                                     f"{log_path.read_text()[-1000:]}")
            try:
                if http_call(mport, "GET", "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                time.sleep(0.25)
        hosts = [f"127.0.0.1:{srv.port}", f"127.0.0.1:{mport}"]
        router = RouterEngine(hosts, timeout_s=SERVE_TIMEOUT)
        reqs = [GenerationRequest(
            prompt=f"Summarize item {i}: the committee reviewed the budget "
                   f"line {i * 7} and the maintenance plan.", request_id=i,
            max_new_tokens=16, temperature=0.0, tenant="fleet",
            trace_id=f"r18e-{i}") for i in range(8)]
        out = router.generate_batch(reqs)
        if any(r.error for r in out):
            raise AssertionError(f"18e: {[r.error for r in out]}")
        doc = router.stitched_trace()
        validate_trace_events(doc["traceEvents"])
        chains = stitched_chains(doc["traceEvents"])
        served: dict[str, int] = {}
        for r in reqs:
            evs = chains.get(r.trace_id, [])
            routes = [e["args"]["host"] for e in evs if e["name"] == "route"
                      and e["args"].get("role") is not None
                      and e["args"]["host"] in hosts]
            on_host = {e["args"].get("host") for e in evs
                       if e["name"] == "finish"}
            if not routes or routes[-1] not in on_host:
                raise AssertionError(f"18e: {r.trace_id}: routed {routes}, "
                                     f"finished on {sorted(on_host)}")
            served[routes[-1]] = served.get(routes[-1], 0) + 1
        usage = router.usage_report()
        for k in ("prompt_tokens", "generated_tokens", "requests"):
            if usage["totals"].get(k, 0) != sum(
                    h["totals"].get(k, 0) for h in usage["per_host"]):
                raise AssertionError(f"18e: fleet {k} != the hosts' sum")
        anatomy = router.anatomy_report()
        if (len(anatomy["per_host"]) != 2 or anatomy["iterations"] != sum(
                h["iterations"] for h in anatomy["per_host"])):
            raise AssertionError(f"18e: fleet anatomy {anatomy}")
        return {"phase": "obs-18e", "card": smi, "served": served,
                "stitched_traces": len(doc["stitch"]["traces"]),
                "offsets_ms": doc["stitch"]["offsets_ms"],
                "fleet_totals": usage["totals"],
                "fleet_anatomy_iterations": anatomy["iterations"]}
    finally:
        if router is not None:
            router.shutdown()
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def run_obs_path(smi: str, main_out: dict) -> dict:
    """Phase 18: 18a and 18b (each a fresh engine, freed after), 18c (a CLI
    child), then 18d and 18e over one server.  Each sub-phase prints its
    own line."""
    from lmrs_tpu_torch.obs import disable_tracing

    free_cuda()
    a = obs_traced_path(smi, main_out)
    emit(a)
    free_cuda()
    b = obs_off_path(smi, a, main_out)
    emit(b)
    free_cuda()
    emit(obs_cli_path(smi))
    srv = None
    try:
        d, srv, engine = obs_server_path(smi, a)
        emit(d)
        emit(obs_fleet_path(smi, srv, engine))
    finally:
        if srv is not None:
            srv.shutdown()
        disable_tracing()
    free_cuda()
    return {"phase": "obs", "card": smi, "traced_wall_seconds":
            a["wall_seconds"], "obs_off_wall_seconds": b["obs_off_wall_seconds"]}


# ------------------------------------------------------------ phase 19

TRAIN_DIR = Path(__file__).resolve().parent / "build" / "lmrs_tpu_torch" / "train19"
TRAIN_SHAPE = (4, 512)  # 19a's batch: byte tokens of the demo transcript
QUALITY_STEPS = 200     # 19b (tests/test_quality.py's trained_summarizer)
CLI_STEPS = 1500        # 19c (its cli_checkpoint, warmup-cosine)
MAP_TEMPLATE = "List the topics.\n{transcript}\nTopics:"
REDUCE_TEMPLATE = "List the topics.\n{summaries}\nTopics:"
CLI_CHUNK_TOKENS = 384  # forces a multi-chunk map on the held-out transcript
ATTENTION_KERNELS = ("flash_prefill", "paged_decode", "paged_decode_fused",
                     "paged_decode_fused_int8", "ragged_spans",
                     "ragged_spans_int8", "paged_decode_multi",
                     "paged_decode_multi_int8", "ragged_spans_anc",
                     "ragged_spans_anc_int8")


def demo_batch() -> torch.Tensor:
    """19a's fixed [4, 512] batch: the demo transcript's text as byte
    tokens, cut into rows."""
    from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    text = " ".join(s["text"] for s in load_demo_transcript()["segments"])
    ids = ByteTokenizer().encode(text)[: TRAIN_SHAPE[0] * TRAIN_SHAPE[1]]
    return torch.tensor(ids, device="cuda").view(*TRAIN_SHAPE)


def gemma_train_run(tokens: torch.Tensor, remat: bool) -> dict:
    """Three AdamW steps (lr 1e-4) of the whole gemma-2b from the seed-0
    init on one batch: losses, step seconds and peak memory (params, grads
    and AdamW's states included)."""
    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.models.transformer import init_params, param_count
    from lmrs_tpu_torch.training.train import (adamw, make_train_step,
                                               trainable)

    cfg = model_preset("gemma-2b")
    params = trainable(init_params(cfg, 0, "cuda"))
    n_params = param_count(params)
    step = make_train_step(cfg, adamw(params, 1e-4), remat=remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(3):
        t = time.time()
        losses.append(float(step(params, tokens)))  # the step's host sync
        secs.append(time.time() - t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, step
    free_cuda()
    return {"remat": remat, "losses": losses, "step_seconds": secs,
            "params": n_params, "peak_memory_gib": peak}


def run_gemma_train(smi: str) -> dict:
    """19a: the whole gemma-2b trains three steps at full width and depth
    with and without remat, from the same init."""
    import math
    import statistics

    free_cuda()
    tokens = demo_batch()
    counted = kernel_counters()
    before = read_launches(counted)
    runs = [gemma_train_run(tokens, remat) for remat in (False, True)]
    after = read_launches(counted)
    for r in runs:
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"19a: a loss is not finite: {r}")
        if not r["losses"][2] < r["losses"][0]:
            raise AssertionError(f"19a: the 3rd loss is not below the 1st: {r}")
    if abs(runs[0]["losses"][0] - runs[1]["losses"][0]) > 1e-2:
        raise AssertionError(f"19a: first-step losses differ: {runs}")
    if not runs[1]["peak_memory_gib"] < runs[0]["peak_memory_gib"]:
        raise AssertionError(f"19a: remat did not lower the peak: {runs}")
    if after != before:
        raise AssertionError(f"19a: training launched an attention kernel: "
                             f"{before} -> {after}")
    n_tok = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    peak_flops = peaks()[0]
    for r in runs:
        s = statistics.median(r["step_seconds"][1:])
        flops = 6.0 * r["params"] * n_tok  # remat's recompute not counted
        r.update(step_ms=s * 1e3, tokens_per_sec=n_tok / s,
                 share_of_peak=flops / s / peak_flops, flops_per_step=flops)
    return {"phase": "train-19a", "card": smi, "model": "gemma-2b (whole "
            "model, random init bf16, AdamW states bf16)",
            "batch": list(TRAIN_SHAPE), "peak_flops": peak_flops,
            "runs": runs}


def write_pairs(pairs: list[dict], name: str) -> Path:
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    path = TRAIN_DIR / name
    path.write_text("\n".join(json.dumps(p) for p in pairs))
    return path


def train_small(cfg, pairs: list[dict], name: str, steps: int, batch: int,
                seq_len: int, lr, seed: int = 0) -> tuple:
    """Train ``cfg`` from the ``seed`` init on (prompt, summary) ``pairs``
    through ``lmrs-train-torch``'s data path (``load_examples``,
    ``batches``) and ``make_train_step``; ``lr`` is a number or a schedule
    of the step.  Returns (params, final loss, seconds)."""
    from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
    from lmrs_tpu_torch.models.transformer import init_params
    from lmrs_tpu_torch.training.cli import batches, load_examples
    from lmrs_tpu_torch.training.train import (adamw, make_train_step,
                                               set_lr, trainable)

    seqs, masks = load_examples(str(write_pairs(pairs, name)), ByteTokenizer())
    params = trainable(init_params(cfg, seed, "cuda"))
    schedule = lr if callable(lr) else None
    opt = adamw(params, schedule(0) if schedule else lr)
    step = make_train_step(cfg, opt, masked=True)
    it = batches(seqs, masks, batch, seq_len, 0)
    t0 = time.time()
    loss = None
    for i in range(steps):
        if schedule:
            set_lr(opt, schedule(i))
        t, m = next(it)
        loss = step(params, torch.from_numpy(t).cuda(),
                    torch.from_numpy(m).cuda())
    loss = float(loss)
    return params, loss, time.time() - t0


def quality_engine_run(cfg, params, reqs, **engine_kw) -> tuple:
    """The trained model served by a continuous ``TorchEngine`` (4 slots,
    48 tokens, blocks of 8, greedy) over ``reqs``; launch counters zeroed
    just before and read just after."""
    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine

    engine = TorchEngine(
        EngineConfig(scheduler="continuous", max_tokens=48, max_batch_slots=4,
                     seed=0, decode_block=8, **engine_kw),
        cfg, device="cuda", params=params, tokenizer=ByteTokenizer())
    counted = zero_launches()
    outs = engine.generate_batch(reqs)
    torch.cuda.synchronize()
    launches = read_launches(counted)
    if engine.audit():
        raise AssertionError(f"19b: allocator audit: {engine.audit()}")
    return outs, launches, engine.engine_metrics()


def quality_task(seed: int = 0) -> dict:
    """19b's model trained from the ``seed`` init (the reference's recipe)
    and cast to bf16, its 8 held-out requests and the lead-1 score."""
    import dataclasses

    import numpy as np

    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.engine.api import GenerationRequest
    from lmrs_tpu_torch.eval.rouge import rouge_l
    from lmrs_tpu_torch.eval.synthetic import extractive_baseline, make_dataset
    from lmrs_tpu_torch.training.train import map_params

    serve_cfg = model_preset("bench-smoke")
    cfg = dataclasses.replace(serve_cfg, dtype="float32")
    train = make_dataset(192, seed=0)
    pairs = [{"prompt": ex["prompt"], "summary": ex["summary"]} for ex in train]
    params, loss, train_s = train_small(cfg, pairs, "synthetic.jsonl",
                                        QUALITY_STEPS, 16, 320, 4e-3,
                                        seed=seed)
    served = map_params(lambda t: t.detach().to(torch.bfloat16), params)
    train_prompts = {ex["prompt"] for ex in train}
    held = [ex for ex in make_dataset(32, seed=999)
            if ex["prompt"] not in train_prompts][:8]
    if len(held) != 8:
        raise AssertionError("19b: the generator collided on the held-out set")
    reqs = [GenerationRequest(prompt=ex["prompt"], request_id=i,
                              temperature=0.0, max_new_tokens=48)
            for i, ex in enumerate(held)]
    extract = float(np.mean([rouge_l(extractive_baseline(ex["prompt"]),
                                     ex["summary"])["f"] for ex in held]))
    return {"serve_cfg": serve_cfg, "params": served, "loss": loss,
            "train_s": train_s, "held": held, "reqs": reqs,
            "lead1": extract}


def quality_scores(task: dict, outs) -> list[float]:
    from lmrs_tpu_torch.eval.rouge import rouge_l

    return [rouge_l(o.text, ex["summary"])["f"]
            for ex, o in zip(task["held"], outs)]


def run_quality_gate(smi: str) -> dict:
    """19b: ``tests/test_quality.py``'s synthetic gate at bench-smoke's
    widths, trained in f32 on the card, served in bf16 through the
    kernels."""
    import numpy as np

    t0 = time.time()
    task = quality_task()
    loss, extract = task["loss"], task["lead1"]
    if not loss < 0.5:
        raise AssertionError(f"19b: training did not converge: loss {loss}")
    out = {"phase": "quality-19b", "card": smi,
           "model": "bench-smoke widths (dim 128, 2 layers, H 4, K 2, hd 32), "
                    "trained f32, served bf16",
           "train_steps": QUALITY_STEPS, "final_loss": loss,
           "train_seconds": task["train_s"], "lead1_rouge_l": extract}
    runs = (("plain", {}, ("flash_prefill", "paged_decode_fused",
                           "ragged_spans")),
            ("kv_int8", dict(kv_quantize="int8", page_size=32),
             ("flash_prefill", "paged_decode_fused_int8", "ragged_spans_int8")),
            ("spec_linear", dict(speculate_k=4, mixed_batch=False),
             ("flash_prefill", "paged_decode_multi")))
    for name, kw, want in runs:
        outs, launches, metrics = quality_engine_run(
            task["serve_cfg"], task["params"], task["reqs"], **kw)
        scores = quality_scores(task, outs)
        require_launches(launches, f"19b {name} run", want)
        row = {"rouge_l": float(np.mean(scores)), "per_prompt": scores,
               "launches": nonzero(launches)}
        if name == "spec_linear":
            acc = metrics["spec_accepted_tokens"]
            row.update(spec_accepted_tokens=acc,
                       decode_tokens=metrics["decode_tokens"],
                       accepted_per_decode_token=acc / max(
                           1, metrics["decode_tokens"]))
        out[name] = row
    plain, kv8 = out["plain"]["rouge_l"], out["kv_int8"]["rouge_l"]
    if not (plain >= 0.30 and plain > 3 * extract):
        raise AssertionError(f"19b: ROUGE-L {plain} (lead-1 {extract})")
    if not kv8 >= 0.28:
        raise AssertionError(f"19b: ROUGE-L with int8 KV {kv8}")
    out["seconds"] = time.time() - t0
    return out


def _make_cli_transcript(rng):
    """A transcript in the CLI input schema whose ground-truth summary is
    its topic list in order of appearance (``tests/test_quality.py``)."""
    from lmrs_tpu_torch.eval.synthetic import _FILLER, _OPENERS, TOPICS

    n_topics = int(rng.integers(3, 6))
    topics = [TOPICS[i] for i in rng.choice(len(TOPICS), n_topics,
                                            replace=False)]
    segs, t = [], 0.0
    for topic in topics:
        if rng.random() < 0.6:
            segs.append({"start": t, "end": t + 4.0, "speaker": "SPEAKER_00",
                         "text": str(rng.choice(_FILLER))})
            t += float(rng.integers(20, 50))
        opener = str(rng.choice(_OPENERS)).format(t=topic)
        segs.append({"start": t, "end": t + 4.0, "speaker": "SPEAKER_00",
                     "text": opener + "."})
        t += float(rng.integers(20, 50))
    return {"segments": segs}, topics


def _product_format_pairs(transcript, topics):
    """(prompt, summary) pairs in the exact formats the CLI produces: map
    prompts through the real preprocessor and chunker (context header
    included), the reduce prompt through the real aggregator
    (``tests/test_quality.py``)."""
    from types import SimpleNamespace

    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.data.chunker import TranscriptChunker
    from lmrs_tpu_torch.data.preprocessor import (format_timestamp,
                                                  preprocess_transcript)
    from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
    from lmrs_tpu_torch.prompts import safe_format
    from lmrs_tpu_torch.reduce.aggregator import ResultAggregator

    chunker = TranscriptChunker(max_tokens_per_chunk=CLI_CHUNK_TOKENS,
                                overlap_tokens=0, context_tokens=150,
                                tokenizer=ByteTokenizer())
    agg = ResultAggregator(SimpleNamespace(config=EngineConfig(backend="mock")),
                           tokenizer=ByteTokenizer())
    chunks = chunker.chunk_transcript(
        preprocess_transcript(transcript["segments"]))
    pairs, tagged = [], []
    for c in chunks:
        in_chunk = sorted((t for t in topics if t in c.text), key=c.text.find)
        target = " " + ", ".join(in_chunk) + "." if in_chunk else " none."
        pairs.append({"prompt": safe_format(MAP_TEMPLATE,
                                            transcript=c.text_with_context),
                      "summary": target})
        tagged.append(f"[Time: {format_timestamp(c.start_time)} - "
                      f"{format_timestamp(c.end_time)}]\n{target}")
    red = agg._build_request(tagged, REDUCE_TEMPLATE, metadata=None)
    pairs.append({"prompt": red.prompt,
                  "summary": " " + ", ".join(topics) + "."})
    return pairs


def cli_format_pairs(n: int = 1000) -> list[dict]:
    import numpy as np

    rng = np.random.default_rng(0)
    pairs = []
    for _ in range(n):
        transcript, topics = _make_cli_transcript(rng)
        pairs.extend(_product_format_pairs(transcript, topics))
    return pairs


def run_cli_quality(smi: str) -> dict:
    """19c: bench-smoke widths trained in f32 on CLI-format pairs (1,500
    steps, the reference's warmup-cosine schedule), saved as a native
    checkpoint, then ``lmrs-torch --checkpoint`` on a held-out transcript:
    plain, ``--quantize int8`` and ``--kv-quantize int8``."""
    import dataclasses
    import os

    import numpy as np

    from lmrs_tpu_torch import cli
    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.eval.rouge import rouge_l
    from lmrs_tpu_torch.models.loader import save_checkpoint
    from lmrs_tpu_torch.training.train import warmup_cosine_decay

    t0 = time.time()
    pairs = cli_format_pairs()
    data_s = time.time() - t0
    cfg = dataclasses.replace(model_preset("bench-smoke"), dtype="float32")
    schedule = warmup_cosine_decay(0.0, 3e-3, 100, CLI_STEPS, 3e-3 * 0.02)
    params, loss, train_s = train_small(cfg, pairs, "cli.jsonl", CLI_STEPS, 8,
                                        704, schedule)
    if not loss < 0.25:
        raise AssertionError(f"19c: CLI-format training failed: loss {loss}")
    ckpt = TRAIN_DIR / "cli-ckpt"
    save_checkpoint(str(ckpt), params)
    del params
    held, topics = _make_cli_transcript(np.random.default_rng(4242))
    truth = " " + ", ".join(topics) + "."
    inp, mapf, redf = (TRAIN_DIR / n for n in ("held.json", "map.txt",
                                                "reduce.txt"))
    inp.write_text(json.dumps(held))
    mapf.write_text(MAP_TEMPLATE)
    redf.write_text(REDUCE_TEMPLATE)
    out = {"phase": "cli-quality-19c", "card": smi,
           "model": "bench-smoke widths, trained f32, served bf16 from the "
                    "checkpoint", "train_pairs": len(pairs),
           "data_seconds": data_s, "train_steps": CLI_STEPS,
           "final_loss": loss, "train_seconds": train_s, "truth": truth}
    saved = {k: os.environ.get(k) for k in ("TEMPERATURE", "MAX_TOKENS")}
    os.environ.update(TEMPERATURE="0.0", MAX_TOKENS="96")
    try:
        for name, extra in (("plain", []), ("w8", ["--quantize", "int8"]),
                            ("kv8", ["--kv-quantize", "int8"])):
            summary = TRAIN_DIR / f"summary-{name}.txt"
            counted = zero_launches()
            rc = cli.main([
                "--input", str(inp), "--output", str(summary),
                "--device", "cuda", "--model", "bench-smoke",
                "--checkpoint", str(ckpt), "--tokenizer", "byte",
                "--max-tokens-per-chunk", str(CLI_CHUNK_TOKENS),
                "--overlap-tokens", "0", "--prompt-file", str(mapf),
                "--aggregator-prompt-file", str(redf), "--report", "-q",
                *extra])
            torch.cuda.synchronize()
            launches = read_launches(counted)
            if rc != 0:
                raise AssertionError(f"19c {name}: lmrs-torch exited {rc}")
            text = summary.read_text()
            report = json.loads(Path(str(summary) + ".report.json").read_text())
            score = rouge_l(text, truth)["f"]
            decode = ("paged_decode_fused_int8" if name == "kv8"
                      else "paged_decode_fused")
            require_launches(launches, f"19c {name} run",
                             ("flash_prefill", decode))
            if score < 0.45 or report["num_chunks"] < 2 or \
                    report["failed_requests"] != 0:
                raise AssertionError(
                    f"19c {name}: ROUGE-L {score}, {report['num_chunks']} "
                    f"chunks, {report['failed_requests']} failed: {text!r}")
            out[name] = {"rouge_l": score, "summary": text,
                         "chunks": report["num_chunks"],
                         "failed_requests": report["failed_requests"],
                         "launches": nonzero(launches)}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["seconds"] = time.time() - t0
    return out


def run_train_cli_and_static(smi: str) -> dict:
    """19d: (i) ``lmrs-train-torch`` as a child on the card, its checkpoint
    served by ``lmrs-torch --checkpoint``; (ii) phase 5's configuration at
    ``VARIANT_LAYERS`` with ``scheduler="static"`` on 60 demo segments:
    no kernel on that path."""
    from lmrs_tpu_torch import cli
    from lmrs_tpu_torch.pipeline import TranscriptSummarizer
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    t0 = time.time()
    ckpt = TRAIN_DIR / "child-ckpt"
    child = subprocess.run(
        [sys.executable, "-m", "lmrs_tpu_torch.training.cli", "--model",
         "bench-smoke", "--data", str(TRAIN_DIR / "synthetic.jsonl"),
         "--steps", "20", "--output", str(ckpt), "--device", "cuda"],
        capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parent)
    child_s = time.time() - t0
    if child.returncode != 0:
        raise AssertionError(f"19d: lmrs-train-torch exited "
                             f"{child.returncode}: {child.stderr[-2000:]}")
    summary = TRAIN_DIR / "summary-child.txt"
    rc = cli.main(["--input", str(TRAIN_DIR / "held.json"), "--output",
                   str(summary), "--device", "cuda", "--model", "bench-smoke",
                   "--checkpoint", str(ckpt), "--tokenizer", "byte",
                   "--max-tokens", "16", "-q"])
    if rc != 0 or not summary.read_text():
        raise AssertionError(f"19d: lmrs-torch --checkpoint exited {rc}")
    free_cuda()
    cfg = at_depth(phase5_config("bench-8b", scheduler="static"),
                   VARIANT_LAYERS)
    summarizer = TranscriptSummarizer(cfg, device="cuda")
    summarizer.executor.engine  # builds + random-inits the model
    torch.cuda.synchronize()
    counted = zero_launches()
    t1 = time.time()
    stats = summarizer.summarize(load_demo_transcript(max_segments=60))
    torch.cuda.synchronize()
    static_wall = time.time() - t1
    launches = read_launches(counted)
    summarizer.shutdown()
    del summarizer
    free_cuda()
    if not stats["summary"] or stats["failed_requests"] != 0:
        raise AssertionError(f"19d: static path: {stats['failed_requests']} "
                             "failed or an empty summary")
    if any(launches[k] for k in ATTENTION_KERNELS):
        raise AssertionError(f"19d: the static path launched a kernel: "
                             f"{nonzero(launches)}")
    return {"phase": "train-cli-static-19d", "card": smi,
            "train_child_seconds": child_s,
            "train_child_log": child.stderr.strip().splitlines()[-2:],
            "checkpoint_summary_chars": len(summary.read_text()),
            "static_model": f"bench-8b ({VARIANT_LAYERS} layers, random-init "
                            "bf16)",
            "static_wall_seconds": static_wall,
            "static_chunks": stats["num_chunks"],
            "static_requests": stats["total_requests"],
            "static_failed_requests": stats["failed_requests"],
            "static_summary_chars": len(stats["summary"]),
            "static_launches": nonzero(launches),
            "seconds": time.time() - t0}


def run_train_eval_path(smi: str) -> dict:
    """Phase 19: 19a-19d, each on a line of its own."""
    t0 = time.time()
    a = run_gemma_train(smi)
    emit(a)
    b = run_quality_gate(smi)
    emit(b)
    c = run_cli_quality(smi)
    emit(c)
    d = run_train_cli_and_static(smi)
    emit(d)
    return {"phase": "train-eval", "card": smi,
            "step_ms": {("remat" if r["remat"] else "no_remat"): r["step_ms"]
                        for r in a["runs"]},
            "rouge_l": {"19b": b["plain"]["rouge_l"],
                        "19b_kv_int8": b["kv_int8"]["rouge_l"],
                        **{f"19c_{k}": c[k]["rouge_l"]
                           for k in ("plain", "w8", "kv8")}},
            "seconds": time.time() - t0}


# ------------------------------------------------------------ phase 20

FAULTS_DIR = (Path(__file__).resolve().parent / "build" / "lmrs_tpu_torch"
              / "faults20")
# 20a's seeded plan over phase 5's run: allocation pressure all along, one
# dispatch fault inside the map run, one failed batch (the map's retry) and
# one failed prefix-cache adoption
CHAOS_PLAN = {"seed": 20, "faults": [
    {"site": "kv_cache.allocate", "every": 11},
    {"site": "scheduler.step", "at": [6], "max_fires": 1},
    {"site": "engine.batch", "at": [2], "max_fires": 1},
    {"site": "prefix_cache.insert", "at": [3], "max_fires": 1}]}
CHAOS_SITES = ("kv_cache.allocate", "scheduler.step", "engine.batch",
               "prefix_cache.insert")
# 20a's transcript: the first 100 demo segments (15 map chunks, a reduce
# tree), half of phase 5's, so its two full-depth runs fit the budget
CHAOS_SEGMENTS = 100
WEDGE_S = 2.0          # 20b's LMRS_WATCHDOG_S
WEDGE_MARGIN_S = 1.0   # the caller polls every quarter of the threshold
HOST_STALL_S = 3.0     # 20b(i): the heartbeat stall
DEVICE_STALL_S = 5.0   # 20b(ii): the sleep kernel on the engine's stream
WEDGE_WAVE = 8         # 20b's requests: 8 of phase 5's map prompts
CHILD_WEDGE_S = 2.5    # 20c's children's LMRS_WATCHDOG_S
HEDGE_MS = 500.0       # 20d's LMRS_HEDGE_MS
STRAGGLE_S = 4.0       # 20d: the straggler's heartbeat stall


def card_line(smi: str, phase: str) -> None:
    print(f"{phase}: {smi}", flush=True)


def run_chaos_path(smi: str) -> dict:
    """20a: phase 5 at full depth under ``CHAOS_PLAN`` (installed by
    ``make_engine`` from ``EngineConfig.fault_plan``), twice, each on a
    fresh engine with the plan installed afresh."""
    from lmrs_tpu_torch.testing import faults

    card_line(smi, "faults-20a")
    spec = json.dumps(CHAOS_PLAN)
    runs = []
    for _ in range(2):
        faults.uninstall()
        summ, engine, stats, wall, launches = summarize_once(
            segments=CHAOS_SEGMENTS, fault_plan=spec, retry_delay=0.5,
            retry_attempts=5)
        inj = faults.active()
        faults.uninstall()
        if inj is None:
            raise AssertionError("20a: make_engine installed no plan")
        require_launches(launches, "chaos path (20a)",
                         ("flash_prefill", "paged_decode_fused",
                          "ragged_spans"))
        fired = {}
        for site, _n in inj.fires:
            fired[site] = fired.get(site, 0) + 1
        em = stats["engine_metrics"]
        runs.append({"wall_seconds": wall, "fires": list(inj.fires),
                     "fired": fired,
                     "occurrences": {s: inj.occurrences(s)
                                     for s in CHAOS_SITES
                                     + ("scheduler.heartbeat",)},
                     "summary": stats["summary"],
                     "requests": em["requests"],
                     "preemptions": em["preemptions"],
                     "stalls": em["stalls"],
                     "decode_tokens": em["decode_tokens"],
                     "prefill_tokens": em["prefill_tokens"],
                     "launches": nonzero(launches)})
        summ.shutdown()
        del summ, engine
        free_cuda()
    first, second = runs
    if set(first["fired"]) != set(CHAOS_SITES) or any(
            first["fired"][s] != 1 for s in CHAOS_SITES[1:]):
        raise AssertionError(f"20a: fired {first['fired']}")
    if (first["occurrences"], first["fires"], first["summary"]) != (
            second["occurrences"], second["fires"], second["summary"]):
        raise AssertionError("20a: the second run with the same plan "
                             f"differs: {first['occurrences']} vs "
                             f"{second['occurrences']}")
    return {"phase": "faults-20a", "card": smi, "plan": CHAOS_PLAN,
            "runs": [{k: v for k, v in r.items()
                      if k not in ("summary", "fires")} for r in runs],
            "summary_chars": len(first["summary"]),
            "second_run_identical": True, "failed_requests": 0}


class NoEosByte:
    """The byte tokenizer with its end-of-sequence id past the byte range:
    ids above the tokenizer's vocabulary are never sampled, so every 20b
    request runs its whole budget and none finishes before a wedge."""

    def __init__(self):
        from lmrs_tpu_torch.data.tokenizer import ByteTokenizer

        self._t = ByteTokenizer()
        self.pad_id, self.bos_id = self._t.pad_id, self._t.bos_id
        self.eos_id, self.vocab_size = 511, self._t.vocab_size

    def encode(self, text):
        return self._t.encode(text)

    def decode(self, ids):
        return self._t.decode(ids)

    def count(self, text):
        return self._t.count(text)


def phase5_map_requests(cfg, engine) -> list:
    """Phase 5's map requests for ``cfg``, greedy, in chunk order."""
    import dataclasses

    from lmrs_tpu_torch.pipeline import TranscriptSummarizer
    from lmrs_tpu_torch.prompts import resolve_map_prompt
    from lmrs_tpu_torch.utils.demo import load_demo_transcript
    from lmrs_tpu_torch.utils.timing import StageTimer

    summ = TranscriptSummarizer(cfg, engine=engine)
    _n, _p, chunks = summ._prep(load_demo_transcript(max_segments=200),
                                StageTimer())
    return [dataclasses.replace(
        summ.executor.build_map_request(c, resolve_map_prompt(),
                                        request_id=i), temperature=0.0)
        for i, c in enumerate(chunks)]


def wedge_engine():
    """An 8-layer bench-8b ``TorchEngine`` with phase 5's engine settings
    (the prefix cache off: a retried wave then dispatches exactly as the
    undisturbed one did) and ``WEDGE_WAVE`` of phase 5's map prompts,
    greedy."""
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine

    cfg = at_depth(phase5_config(prefix_cache=False), VARIANT_LAYERS)
    engine = TorchEngine(cfg.engine, cfg.model, device="cuda",
                         tokenizer=NoEosByte())
    reqs = phase5_map_requests(cfg, engine)[:WEDGE_WAVE]
    torch.cuda.synchronize()
    return engine, reqs


def _wave_texts(engine, reqs, where: str) -> tuple[list[str], dict, float]:
    """The wave through the executor's retries (counters zeroed just
    before and read just after): texts, launches, wall."""
    from lmrs_tpu_torch.config import EngineConfig
    from lmrs_tpu_torch.engine.executor import MapExecutor

    ex = MapExecutor(engine, EngineConfig(retry_attempts=20, retry_delay=1.0))
    counted = zero_launches()
    t0 = time.time()
    res = ex.run_requests(list(reqs))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(counted)
    bad = [r.error for r in res if r.error]
    if bad or engine.audit():
        raise AssertionError(f"{where}: errors {bad[:2]}, audit "
                             f"{engine.audit()}")
    return [r.text for r in res], launches, wall


def _wedge_checks(engine, srv, out, pm_dir: Path, n_before: int,
                  where: str) -> dict:
    """The wedge's evidence while the engine is still degraded."""
    from lmrs_tpu_torch.obs import validate_postmortem_file

    reasons = [r.finish_reason for r in out]
    if set(reasons) != {"wedged"} or not all(
            r.error and "wedged" in r.error for r in out):
        raise AssertionError(f"{where}: results {reasons}")
    if not engine.wedged():
        raise AssertionError(f"{where}: the engine is not degraded")
    status, raw = http_call(srv.port, "GET", "/healthz", timeout=10)
    if status != 503 or json.loads(raw).get("wedged") is not True:
        raise AssertionError(f"{where}: /healthz {status} {raw[:200]}")
    pms = sorted(pm_dir.glob("postmortem-watchdog-*.json"))
    if len(pms) != n_before + 1:
        raise AssertionError(f"{where}: {len(pms)} watchdog postmortems")
    pm = validate_postmortem_file(pms[-1])
    stalled = pm["extra"]["stalled_s"]
    if not WEDGE_S < stalled <= WEDGE_S + WEDGE_MARGIN_S:
        raise AssertionError(f"{where}: declared after {stalled} s of "
                             f"silence (threshold {WEDGE_S} s)")
    return {"declared_after_silent_seconds": stalled,
            "undelivered": pm["extra"]["undelivered"],
            "healthz": status}


def run_wedge_path(smi: str) -> dict:
    """20b: a host stall and a device stall on an 8-layer engine under a
    ``WEDGE_S`` threshold, then the same wave inline."""
    import dataclasses
    import os
    import shutil
    import threading

    from lmrs_tpu_torch.serving.server import EngineHTTPServer
    from lmrs_tpu_torch.testing import faults
    from lmrs_tpu_torch.testing.faults import FaultPlan

    card_line(smi, "faults-20b")
    shutil.rmtree(FAULTS_DIR, ignore_errors=True)
    pm_dir = FAULTS_DIR / "postmortems"
    pm_dir.mkdir(parents=True)
    engine, reqs = wedge_engine()
    base, base_launches, base_wall = _wave_texts(engine, reqs, "20b baseline")
    srv = EngineHTTPServer(engine, port=0, batch_window_s=0.02)
    srv.start_background()
    env = {"LMRS_WATCHDOG_S": str(WEDGE_S),
           "LMRS_POSTMORTEM_DIR": str(pm_dir), "LMRS_POSTMORTEM_MIN_S": "0"}
    os.environ.update(env)
    out = {}
    try:
        # (i) the host stall: the second loop iteration's heartbeat site
        # sleeps; the abandoned thread keeps its stall after the uninstall
        faults.install(FaultPlan(faults=[
            {"site": "scheduler.heartbeat", "at": [2], "action": "stall",
             "stall_s": HOST_STALL_S}]))
        t0 = time.time()
        res = engine.generate_batch([dataclasses.replace(r, request_id=100 + i)
                                     for i, r in enumerate(reqs)])
        call_s = time.time() - t0
        faults.uninstall()
        host = _wedge_checks(engine, srv, res, pm_dir, 0, "20b(i)")
        t1 = time.time()
        texts, launches, wall = _wave_texts(engine, reqs, "20b(i) retry")
        if texts != base:
            raise AssertionError("20b(i): the retried texts differ from the "
                                 "undisturbed run's")
        require_launches(launches, "20b(i) retried wave",
                         ("flash_prefill", "paged_decode_fused"))
        out["host_stall"] = {**host, "call_seconds": call_s,
                             "stall_seconds": HOST_STALL_S,
                             "retried_wave_seconds": time.time() - t1,
                             "watchdog_fires":
                                 engine._scheduler.metrics["watchdog_fires"]}
        if engine.wedged() or http_call(srv.port, "GET", "/healthz",
                                        timeout=10)[0] != 200:
            raise AssertionError("20b(i): the engine did not re-arm")
        # (ii) the device stall: a sleep kernel queued on the engine's
        # stream once the wave decodes; the dispatch thread then blocks in
        # a CUDA call (the fetch, or a full launch queue) with the GIL
        # released, and this thread declares the wedge
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        torch.cuda._sleep(int(1e8))
        end.record()
        end.synchronize()
        cycles_per_s = 1e8 / (start.elapsed_time(end) / 1e3)
        sched = engine._scheduler
        queued = {}

        def sleeper():
            deadline = time.time() + 120
            while time.time() < deadline:
                live = sched.live_tokens()
                if live and min(live.values()) >= 2:
                    break
                time.sleep(0.002)
            with torch.cuda.device(engine.device):
                torch.cuda._sleep(int(DEVICE_STALL_S * cycles_per_s))
            queued["t"] = time.time()

        th = threading.Thread(target=sleeper, daemon=True)
        th.start()
        res = engine.generate_batch([dataclasses.replace(r, request_id=200 + i)
                                     for i, r in enumerate(reqs)])
        t_ret = time.time()
        th.join(timeout=10)
        if "t" not in queued:
            raise AssertionError("20b(ii): the sleep kernel was never queued")
        dev = _wedge_checks(engine, srv, res, pm_dir, 1, "20b(ii)")
        t1 = time.time()
        texts, launches, wall = _wave_texts(engine, reqs, "20b(ii) retry")
        if texts != base:
            raise AssertionError("20b(ii): the retried texts differ from the "
                                 "undisturbed run's")
        require_launches(launches, "20b(ii) retried wave",
                         ("flash_prefill", "paged_decode_fused"))
        out["device_stall"] = {**dev,
                               "queued_to_declared_seconds":
                                   t_ret - queued["t"],
                               "stall_seconds": DEVICE_STALL_S,
                               "retried_wave_seconds": time.time() - t1,
                               "watchdog_fires": sched.metrics["watchdog_fires"]}
        if engine.wedged() or engine.audit():
            raise AssertionError(f"20b(ii): wedged {engine.wedged()}, audit "
                                 f"{engine.audit()}")
    finally:
        faults.uninstall()
        srv.shutdown()
        for k in env:
            os.environ.pop(k, None)
    engine.shutdown()
    del engine, srv
    free_cuda()
    # the same wave inline: LMRS_WATCHDOG=0 builds no dispatch thread
    os.environ["LMRS_WATCHDOG"] = "0"  # lint: ignore[env.direct-read] a write: the knob for this phase
    try:
        inline, reqs2 = wedge_engine()
    finally:
        del os.environ["LMRS_WATCHDOG"]  # lint: ignore[env.direct-read] a write: the knob for this phase
    if inline._runner is not None:
        raise AssertionError("20b: LMRS_WATCHDOG=0 built a dispatch thread")
    texts, launches, inline_wall = _wave_texts(inline, reqs2, "20b inline")
    if texts != base:
        raise AssertionError("20b: the inline texts differ from the armed "
                             "run's")
    del inline
    free_cuda()
    shutil.rmtree(FAULTS_DIR, ignore_errors=True)
    return {"phase": "faults-20b", "card": smi, "threshold_s": WEDGE_S,
            "layers": VARIANT_LAYERS, "requests": len(reqs),
            "armed_wave_seconds": base_wall,
            "inline_wave_seconds": inline_wall, **out,
            "inline_texts_equal": True,
            "launches": nonzero(base_launches)}


def layers_child(args: list[str]) -> int:
    """``python3 chip_smoke.py --layers-child LAYERS <lmrs-serve-torch
    args>``: the CLI with every preset cut to ``LAYERS`` layers (20c's
    supervisor and its children, 20d's straggler).  Under ``--supervise``
    the supervisor's children are this wrapper again, so they are cut
    too.  On a clean exit a server prints its engine's audit, pinned
    handoffs and counters as one JSON line."""
    import types

    from lmrs_tpu_torch.engine import api
    from lmrs_tpu_torch.serving import cli, supervisor

    layers = int(args[0])
    cut_presets(layers)
    plain_make = api.make_engine
    serve_cli = ["-m", "lmrs_tpu_torch.serving.cli"]

    def popen(cmd, *a, **kw):
        if cmd[1:3] == serve_cli:
            cmd = [cmd[0], str(Path(__file__).resolve()), "--layers-child",
                   str(layers), *cmd[3:]]
        return subprocess.Popen(cmd, *a, **kw)

    supervisor.subprocess = types.SimpleNamespace(
        Popen=popen, TimeoutExpired=subprocess.TimeoutExpired)
    built = []

    def make(*a, **kw):
        built.append(plain_make(*a, **kw))
        return built[-1]

    api.make_engine = make
    rc = cli.main(args[1:])
    if built:
        eng = built[0]
        print(json.dumps({"audit": eng.audit(),
                          "pinned": eng.pinned_handoffs(),
                          "counters": eng._scheduler.counters}), flush=True)
    return rc


def _wait_for(pred, what: str, timeout: float = SERVE_TIMEOUT):
    t0 = time.time()
    while True:
        try:
            if pred():
                return time.time() - t0
        except (OSError, ValueError):
            pass
        if time.time() - t0 > timeout:
            raise AssertionError(f"timed out after {timeout} s waiting for "
                                 f"{what}")
        time.sleep(0.05)


def _healthz(port: int) -> int:
    return http_call(port, "GET", "/healthz", timeout=5)[0]


def run_supervise_path(smi: str) -> dict:
    """20c: ``lmrs-serve-torch --supervise --jobs-dir`` (through
    ``--layers-child``, so the children are ``VARIANT_LAYERS`` deep); child A is
    SIGKILLed mid-job, its successor B (started on a plan file that stalls
    its heartbeat past ``CHILD_WEDGE_S``) wedges on the resumed job and is
    SIGKILLed by the supervisor, child C (the plan file emptied) finishes
    the job; SIGTERM ends the supervisor."""
    import os
    import shutil
    import signal

    from lmrs_tpu_torch.jobs import journal as jl
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    card_line(smi, "faults-20c")
    shutil.rmtree(FAULTS_DIR, ignore_errors=True)
    jobs = FAULTS_DIR / "jobs"
    jobs.mkdir(parents=True)
    plan, pidfile = FAULTS_DIR / "plan.json", FAULTS_DIR / "child.pid"
    # child A: each journal append paced, so the kill lands between records
    plan.write_text(json.dumps({"faults": [
        {"site": "journal.append", "every": 1, "action": "stall",
         "stall_s": JOB_STALL}]}))
    port = free_port()
    here = Path(__file__).resolve().parent
    log_path = FAULTS_DIR / "supervisor.log"
    env = {**os.environ, "PYTHONPATH": str(here),
           "LMRS_FAULT_PLAN": f"@{plan}", "LMRS_WATCHDOG_S": str(CHILD_WEDGE_S),
           "LMRS_SUPERVISE_PIDFILE": str(pidfile),
           "LMRS_SUPERVISE_POLL_S": "0.5", "LMRS_SUPERVISE_BACKOFF_S": "0.2"}
    log = open(log_path, "w", encoding="utf-8")
    t0 = time.time()
    sup = subprocess.Popen(
        [sys.executable, str(here / "chip_smoke.py"), "--layers-child",
         str(VARIANT_LAYERS), "--supervise", "--model", "bench-8b",
         "--tokenizer", "byte", "--device", "cuda", "--port", str(port),
         "--jobs-dir", str(jobs), "--max-tokens-cap", "64", "-q"],
        cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT)

    def pid() -> int:
        return int(pidfile.read_text() or 0)

    try:
        startup_s = _wait_for(lambda: _healthz(port) == 200 and pid() > 0,
                              "child A")
        pid_a = pid()
        body = {"transcript": load_demo_transcript(max_segments=JOB_SEGMENTS),
                "params": {"max_tokens_per_chunk": JOB_CHUNK}}
        status, raw = http_call(port, "POST", "/v1/jobs", body)
        if status != 200:
            raise AssertionError(f"20c: submit answered {status}: {raw[:300]}")
        jid = json.loads(raw)["id"]
        wal = jobs / f"{jid}.wal"

        def chunk_records() -> int:
            return sum(r["type"] == "chunk_done" for r in jl.replay(wal)[0])

        _wait_for(lambda: chunk_records() >= 3, "3 chunk records")
        # child B reads the wedge plan at its start: a heartbeat stall far
        # past its threshold on the resumed job's third loop iteration
        plan.write_text(json.dumps({"faults": [
            {"site": "scheduler.heartbeat", "at": [3], "action": "stall",
             "stall_s": 600.0}]}))
        at_kill_a = chunk_records()
        t_kill = time.time()
        os.kill(pid_a, signal.SIGKILL)
        kill_to_healthy_s = _wait_for(
            lambda: pid() not in (0, pid_a) and _healthz(port) == 200,
            "child B")
        pid_b = pid()
        seen = {}

        def wedged_or_gone() -> bool:
            if pid() != pid_b:
                return True
            if _healthz(port) == 503:
                seen["503"] = time.time()
                return True
            return False

        _wait_for(wedged_or_gone, "child B's wedge")
        # the successor must read a disarmed plan
        plan.write_text(json.dumps({"faults": []}))
        t_b = time.time()
        _wait_for(lambda: pid() not in (0, pid_b), "child C's spawn")
        # the chunks the journal holds done as child C starts (it reads the
        # journal only once its interpreter and engine are up, seconds
        # later); the wedged child journaled its wedged chunks as errors,
        # which a resume maps again by design
        recs = jl.replay(wal)[0]
        journaled = {jl.chunk_key(r["chunk_index"], r["start_time"],
                                  r["end_time"]): r["summary"]
                     for r in recs
                     if r["type"] == "chunk_done" and not r.get("error")}
        _wait_for(lambda: _healthz(port) == 200, "child C")
        wedge_to_healthy_s = time.time() - t_b

        def finished() -> bool:
            doc = json.loads(http_call(port, "GET", f"/v1/jobs/{jid}")[1])
            seen["doc"] = doc
            return doc["status"] not in ("queued", "running")

        resume_to_done_s = _wait_for(finished, "the resumed job")
        doc = seen["doc"]
        sup.send_signal(signal.SIGTERM)
        rc = sup.wait(timeout=120)
    finally:
        if sup.poll() is None:
            # a supervisor killed outright forwards nothing: its child
            # (named in the pidfile) goes too
            sup.kill()
            sup.wait(timeout=60)
            try:
                left = pid()
                if left > 0:
                    os.kill(left, signal.SIGKILL)
            except (OSError, ValueError):
                pass
        log.close()
    text = log_path.read_text()
    if rc != 0:
        raise AssertionError(f"20c: the supervisor exited {rc}: {text[-2000:]}")
    if "engine wedged (watchdog-degraded)" not in text:
        raise AssertionError(f"20c: no wedge kill in the log: {text[-2000:]}")
    if pidfile.exists():
        raise AssertionError("20c: the pidfile outlived the supervisor")
    prog = doc["progress"]
    if doc["status"] != "done" or not doc["recovered"]:
        raise AssertionError(f"20c: the job is {doc['status']}: "
                             f"{doc.get('error')}, reasons "
                             f"{doc.get('degraded_reasons')}, recovered "
                             f"{doc.get('recovered')}; supervisor log: "
                             f"{log_path.read_text()[-3000:]}")
    if prog["num_resumed_chunks"] != len(journaled):
        raise AssertionError(f"20c: {prog['num_resumed_chunks']} chunks "
                             f"resumed, {len(journaled)} journaled")
    recs = jl.replay(wal)[0]
    again = [r for r in recs if r["type"] == "chunk_done"
             and jl.chunk_key(r["chunk_index"], r["start_time"],
                              r["end_time"]) in journaled]
    state = jl.rebuild_state(recs)
    errored = sum(r["type"] == "chunk_done" and bool(r.get("error"))
                  for r in recs)
    if len(again) != len(journaled) or any(
            state["chunks"][k]["summary"] != v for k, v in journaled.items()):
        raise AssertionError("20c: a journaled chunk was re-mapped")
    shutil.rmtree(FAULTS_DIR, ignore_errors=True)
    return {"phase": "faults-20c", "card": smi,
            "child_layers": VARIANT_LAYERS,
            "child_watchdog_s": CHILD_WEDGE_S,
            "startup_seconds": startup_s,
            "kill_to_healthy_seconds": kill_to_healthy_s,
            "wedge_seen_as_503": "503" in seen,
            "wedge_to_healthy_seconds": wedge_to_healthy_s,
            "resume_to_done_seconds": resume_to_done_s,
            "journaled_at_kill": at_kill_a,
            "journaled_before_last_child": len(journaled),
            "errored_records_of_the_wedged_child": errored,
            "num_chunks": max((r.get("num_chunks", 0) for r in recs
                               if r["type"] == "job_header"), default=0),
            "supervisor_seconds": time.time() - t0,
            "sigterm_exit": rc}


def run_hedge_path(smi: str) -> dict:
    """20d: tail hedging over a straggling child server and a server in
    this process, both ``VARIANT_LAYERS`` deep."""
    import dataclasses
    import os
    import signal

    from lmrs_tpu_torch.data.tokenizer import get_tokenizer
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.serving.router import RouterEngine
    from lmrs_tpu_torch.serving.server import EngineHTTPServer

    card_line(smi, "faults-20d")
    FAULTS_DIR.mkdir(parents=True, exist_ok=True)
    here = Path(__file__).resolve().parent
    port = free_port()
    log_path = FAULTS_DIR / "straggler.log"
    env = {**os.environ, "PYTHONPATH": str(here),
           "LMRS_WATCHDOG_S": str(4 * STRAGGLE_S),
           "LMRS_FAULT_PLAN": json.dumps({"faults": [
               {"site": "scheduler.heartbeat", "at": [2], "action": "stall",
                "stall_s": STRAGGLE_S}]})}
    log = open(log_path, "w", encoding="utf-8")
    child = subprocess.Popen(
        [sys.executable, str(here / "chip_smoke.py"), "--layers-child",
         str(VARIANT_LAYERS), "--model", "bench-8b", "--tokenizer", "byte",
         "--device", "cuda", "--port", str(port), "--max-tokens-cap", "64",
         "-q"], cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT)
    # the prefix cache off: the request sent again alone dispatches as the
    # hedge leg did (bf16 texts agree under equal dispatch shapes)
    cfg = at_depth(phase5_config(prefix_cache=False), VARIANT_LAYERS)
    engine = TorchEngine(cfg.engine, cfg.model, device="cuda",
                         tokenizer=get_tokenizer("byte"))
    srv = EngineHTTPServer(engine, port=0, batch_window_s=0.02)
    srv.start_background()
    hosts = [f"127.0.0.1:{port}", f"127.0.0.1:{srv.port}"]
    router = alone = None
    try:
        _wait_for(lambda: _healthz(port) == 200, "the straggler")
        req = phase5_map_requests(cfg, engine)[0]
        os.environ["LMRS_HEDGE_MS"] = str(HEDGE_MS)  # lint: ignore[env.direct-read] a write: the knob for this phase
        router = RouterEngine(hosts, timeout_s=SERVE_TIMEOUT,
                              prefix_route=False)
        t0 = time.time()
        res = router.generate_batch([dataclasses.replace(req)])[0]
        hedge_wall = time.time() - t0
        hedge = router.engine_metrics()["hedge"]
        if res.error or hedge != {"hedges": 1, "wins": 1}:
            raise AssertionError(f"20d: {res.finish_reason} {res.error}, "
                                 f"hedge {hedge}")
        alone = RouterEngine([hosts[1]], timeout_s=SERVE_TIMEOUT)
        t1 = time.time()
        want = alone.generate_batch([dataclasses.replace(req)])[0]
        alone_wall = time.time() - t1
        if want.text != res.text:
            raise AssertionError("20d: the hedged text differs from the "
                                 "winner's own")

        def loser_cancelled() -> bool:
            doc = json.loads(http_call(port, "GET", "/metrics")[1])
            return doc["engine"]["cancelled"] >= 1

        _wait_for(loser_cancelled, "the loser's cancel", timeout=60)
        got = router.generate_batch([dataclasses.replace(req)],
                                    on_tokens=lambda rid, d: None)[0]
        if got.error or router.engine_metrics()["hedge"]["hedges"] != 1:
            raise AssertionError("20d: a streamed request hedged")
    finally:
        os.environ.pop("LMRS_HEDGE_MS", None)
        for r in (router, alone):
            if r is not None:
                r.shutdown()
        srv.shutdown()
        if child.poll() is None:
            child.send_signal(signal.SIGINT)
            try:
                child.wait(timeout=120)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait(timeout=60)
        log.close()
    last = [ln for ln in log_path.read_text().splitlines()
            if ln.startswith('{"audit"')]
    if not last:
        raise AssertionError("20d: the straggler printed no audit: "
                             f"{log_path.read_text()[-2000:]}")
    doc = json.loads(last[-1])
    if doc["audit"] or doc["pinned"]:
        raise AssertionError(f"20d: the loser's audit {doc['audit']}, pins "
                             f"{doc['pinned']}")
    engine.shutdown()
    del engine, srv
    free_cuda()
    return {"phase": "faults-20d", "card": smi, "hedge_ms": HEDGE_MS,
            "straggle_s": STRAGGLE_S, "layers": VARIANT_LAYERS,
            "hedged_wall_seconds": hedge_wall,
            "winner_alone_wall_seconds": alone_wall,
            "hedge": hedge, "loser_cancelled": doc["counters"]["cancelled"],
            "loser_audit": doc["audit"]}


def run_faults_path(smi: str) -> dict:
    """Phase 20: 20a-20d, each on a line of its own."""
    t0 = time.time()
    a = run_chaos_path(smi)
    emit(a)
    b = run_wedge_path(smi)
    emit(b)
    c = run_supervise_path(smi)
    emit(c)
    d = run_hedge_path(smi)
    emit(d)
    return {"phase": "faults", "card": smi,
            "wedge_declared_after_s": {
                "host": b["host_stall"]["declared_after_silent_seconds"],
                "device": b["device_stall"]["declared_after_silent_seconds"]},
            "supervise": {k: c[k] for k in ("startup_seconds",
                                            "kill_to_healthy_seconds",
                                            "wedge_to_healthy_seconds",
                                            "resume_to_done_seconds")},
            "hedged_wall_seconds": d["hedged_wall_seconds"],
            "seconds": time.time() - t0}


# ------------------------------------------------------------ phase 21

FLEET_WAVE = (16, 4)   # 21a: batch map prompts, then interactive ones
FLEET_PAGES = 112      # 21a's pool: phase 5's, so decode growth preempts
FLEET_SLO = {"LMRS_SLO_SPEC": json.dumps({"ttft_p95_ms": 1}),
             "LMRS_SLO_FAST_S": "3", "LMRS_SLO_SLOW_S": "3"}
FLEET_BURN_WAVE = 6    # 21b/21c: host B's requests that burn its SLO


def _env(**env):
    """A context that sets environment variables and puts them back."""
    import os
    from unittest import mock

    return mock.patch.dict(os.environ, env)


def qos_wave(qos: bool) -> dict:
    """21a's wave: ``FLEET_WAVE[0]`` of phase 5's map prompts through
    ``TenantStampEngine(engine, "bulk", qos_class="batch")``, then
    ``FLEET_WAVE[1]`` more as tenant ``live``, class ``interactive``, in
    one ``generate_batch`` over a fresh full-depth bench-8b engine (phase
    5's settings, ``FLEET_PAGES`` pages, 64 tokens each), the tracer on,
    ``LMRS_QOS`` set to ``qos``."""
    import dataclasses
    import gc
    import statistics

    from lmrs_tpu_torch.engine.api import TenantStampEngine
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.obs import trace as t_trace

    from lmrs_tpu_torch.config import model_preset

    cfg = phase5_config()
    ecfg = dataclasses.replace(cfg.engine, num_pages=FLEET_PAGES)
    with _env(LMRS_QOS="1" if qos else "0"):
        engine = TorchEngine(ecfg, model_preset(ecfg.model), device="cuda",
                             tokenizer=NoEosByte())
        base = phase5_map_requests(cfg, engine)
        n_b, n_i = FLEET_WAVE
        reqs = [dataclasses.replace(base[k % len(base)], request_id=k,
                                    max_new_tokens=64)
                for k in range(n_b + n_i)]
        for r in reqs[n_b:]:
            r.tenant, r.qos_class = "live", "interactive"
        stamp = TenantStampEngine(engine, "bulk", qos_class="batch")
        torch.cuda.synchronize()
        t_trace.enable_tracing()
        counted = zero_launches()
        t0 = time.time()
        try:
            res = stamp.generate_batch(reqs)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = read_launches(counted)
            events = sorted(sum(t_trace.get_tracer().spans_by_tid().values(),
                                []), key=lambda e: e["ts"])
        finally:
            t_trace.disable_tracing()
    sched = engine._scheduler
    em = engine.engine_metrics()
    rid = lambda e: e["tid"] - t_trace.REQ_TID_BASE  # noqa: E731
    admits = [rid(e) for e in events if e["name"] == "admit"]
    first = list(dict.fromkeys(admits))
    enq = {rid(e): e["ts"] for e in events if e["name"] == "enqueue"}
    ttft = {}
    for e in events:
        if e["name"] == "first_token" and rid(e) not in ttft:
            ttft[rid(e)] = (e["ts"] - enq[rid(e)]) / 1e3
    reg = sched.registry
    out = {"qos": qos, "wall_seconds": wall, "first_admits": first,
           "reorders": [e["args"] for e in events
                        if e["name"] == "qos_reorder"],
           "qos_preempt": [e["args"] for e in events
                           if e["name"] == "qos_preempt"],
           "preempted": [rid(e) for e in events if e["name"] == "preempt"],
           "preemptions": em["preemptions"],
           "errors": [r.error for r in res if r.error],
           "finish": sorted({r.finish_reason for r in res}),
           "completion_tokens": sorted({r.completion_tokens for r in res}),
           "audit": engine.audit(), "launches": launches,
           "ttft_median_ms": {
               "batch": statistics.median(
                   [v for k, v in ttft.items() if k < n_b]),
               "interactive": statistics.median(
                   [v for k, v in ttft.items() if k >= n_b])},
           "qos_report": engine.qos_report()}
    if qos:
        out["counters"] = {k: reg.counter(k).value for k in (
            "lmrs_qos_reorders_total", "lmrs_qos_preempt_victims_total")}
    engine.shutdown()
    del engine, stamp, sched, reg
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_qos_path(smi: str) -> dict:
    """21a: the QoS-armed wave, then the same wave with ``LMRS_QOS=0``."""
    card_line(smi, "fleet-21a")
    n_b, n_i = FLEET_WAVE
    live = set(range(n_b, n_b + n_i))
    on = qos_wave(True)
    emit({"phase": "fleet-21a-qos", "card": smi, **on,
          "launches": nonzero(on["launches"])})
    if set(on["first_admits"][:n_i]) != live:
        raise AssertionError(f"21a: first admissions {on['first_admits']}: "
                             "the interactive requests were not first")
    c = on["counters"]
    if c["lmrs_qos_reorders_total"] < 1:
        raise AssertionError(f"21a: no QoS reorder ({c})")
    victims = {a["tenant"] for a in on["qos_preempt"]}
    if on["preemptions"] < 1 or victims != {"bulk"} or any(
            k in live for k in on["preempted"]):
        raise AssertionError(f"21a: preemptions {on['preemptions']}, QoS "
                             f"victims {on['qos_preempt']}, preempted "
                             f"{on['preempted']}")
    if c["lmrs_qos_preempt_victims_total"] != on["preemptions"]:
        raise AssertionError(f"21a: QoS victims {c} against "
                             f"{on['preemptions']} preemptions")
    if on["errors"] or on["audit"] or on["finish"] != ["length"]:
        raise AssertionError(f"21a: errors {on['errors'][:2]}, audit "
                             f"{on['audit']}, finish {on['finish']}")
    require_launches(on["launches"], "QoS wave (21a)",
                     ("flash_prefill", "paged_decode_fused", "ragged_spans"))
    off = qos_wave(False)
    emit({"phase": "fleet-21a-fifo", "card": smi, **off,
          "launches": nonzero(off["launches"])})
    if off["reorders"] or off["qos_preempt"]:
        raise AssertionError(f"21a: LMRS_QOS=0 reordered {off['reorders']}")
    if off["first_admits"] != list(range(n_b + n_i)):
        raise AssertionError(f"21a: LMRS_QOS=0 admitted {off['first_admits']}")
    if off["errors"] or off["audit"] or off["finish"] != ["length"]:
        raise AssertionError(f"21a off: errors {off['errors'][:2]}, audit "
                             f"{off['audit']}, finish {off['finish']}")
    return {"qos": {k: on[k] for k in ("wall_seconds", "ttft_median_ms",
                                       "preemptions", "counters")},
            "fifo": {k: off[k] for k in ("wall_seconds", "ttft_median_ms",
                                         "preemptions")}}


def _burn_slo(engine, reqs, rid0: int) -> None:
    """``FLEET_BURN_WAVE`` short requests straight into host B's engine:
    every TTFT misses its 1 ms target."""
    import dataclasses

    res = engine.generate_batch([
        dataclasses.replace(r, request_id=rid0 + k, cache_prefix=-1,
                            max_new_tokens=4)
        for k, r in enumerate(reqs[:FLEET_BURN_WAVE])])
    if any(r.error for r in res):
        raise AssertionError(f"21: burn wave {[r.error for r in res]}")


def run_placement_path(smi: str, ea, eb, reqs, asrv, bsrv) -> dict:
    """21b over two ``role="both"`` servers (A, and B whose SLO cannot be
    met) and a colocated ``RouterEngine``: tenant stickiness, SLO
    placement, then a drain of a warm host with its KV moved to the
    sibling."""
    import dataclasses

    from lmrs_tpu_torch.engine.api import preamble_key
    from lmrs_tpu_torch.serving.router import RouterEngine

    card_line(smi, "fleet-21b")
    na, nb = (f"127.0.0.1:{s.port}" for s in (asrv, bsrv))
    router = RouterEngine([na, nb], timeout_s=SERVE_TIMEOUT)
    log, inner = [], router._post

    def post(host, req, *a, **kw):
        log.append((req.request_id, host.netloc))
        return inner(host, req, *a, **kw)

    router._post = post
    plain = [dataclasses.replace(r, cache_prefix=-1) for r in reqs[1:]]
    try:
        # tenant stickiness: the second request follows the first
        for k in range(2):
            res = router.generate_batch([dataclasses.replace(
                plain[k], request_id=1 + k, tenant="acme")])[0]
            if res.error:
                raise AssertionError(f"21b: tenant request {k}: {res.error}")
        tenant_hosts = [n for _r, n in log[-2:]]
        routed = router.engine_metrics()["tenant_route"]["routed"]
        if tenant_hosts[0] != tenant_hosts[1] or routed < 1:
            raise AssertionError(f"21b: tenant legs {tenant_hosts}, routed "
                                 f"{routed}")
        # SLO placement: B burns its TTFT objective, then is sunk
        _burn_slo(eb, plain, 100)
        for h in router.hosts:
            router._fetch_summary(h)
        hb = next(h for h in router.hosts if h.netloc == nb)
        b_state = eb.slo_report()["state"]
        if router._slo_penalty(hb) < 1:
            raise AssertionError(f"21b: B's published state {b_state}")
        n0 = len(log)
        for k in range(2):
            res = router.generate_batch([dataclasses.replace(
                plain[2 + k], request_id=10 + k)])[0]
            if res.error:
                raise AssertionError(f"21b: SLO request {k}: {res.error}")
        slo_hosts = [n for _r, n in log[n0:]]
        slo = router.engine_metrics()["slo_route"]
        if slo_hosts != [na, na] or slo["penalized"] < 1:
            raise AssertionError(f"21b: SLO legs {slo_hosts}, {slo}")
        # drain: a warm preamble moves to the sibling with the host's exit
        engines = {na: ea, nb: eb}
        req = reqs[0]
        c0 = {n: dict(e._scheduler.counters) for n, e in engines.items()}
        res = router.generate_batch([dataclasses.replace(
            req, request_id=300)])[0]
        warm = log[-1][1]
        sib = nb if warm == na else na
        we, se = engines[warm], engines[sib]
        cold_prefill = (we._scheduler.counters["prefill_tokens"]
                        - c0[warm]["prefill_tokens"])
        if res.error or cold_prefill <= 0:
            raise AssertionError(f"21b: warm-up {res.error}, prefill "
                                 f"{cold_prefill}")
        sc0 = dict(se._scheduler.counters)
        # the answer can arrive before the warm run's end (an export answers
        # 404, busy, until then), and the published summary the drain reads
        # is memoized for 1 s
        key = preamble_key(req.system_prompt, req.prompt, req.cache_prefix)
        _wait_for(lambda: not we._scheduler._run_live and any(
            r["hash"] == key for r in we.prefix_summary()),
            "the warm preamble's summary row")
        t0 = time.time()
        if not router.drain_host(warm):
            raise AssertionError("21b: drain_host refused")
        _wait_for(lambda: not router.migrations_pending(warm),
                  "the drain's KV migration")
        migrate_s = time.time() - t0
        moved = (se._scheduler.counters["kv_migrate_tokens"]
                 - sc0["kv_migrate_tokens"])
        if router._kv_moves < 1 or router._kv_failures or moved <= 0:
            raise AssertionError(f"21b: moves {router._kv_moves}, failures "
                                 f"{router._kv_failures}, tokens {moved}")
        # the warm host's own prefix-hit text over exactly the moved pages
        apc = we._scheduler._prefix_cache
        ids, _n = we._scheduler._encode(dataclasses.replace(req))
        node, pos = apc.root, 0
        while pos < moved:
            node = node.children[tuple(ids[pos: pos + apc.page_size])]
            pos += len(node.tokens)
        for child in list(node.children.values()):
            apc._drop_subtree(child)
        warm_text = we.generate_batch([dataclasses.replace(
            req, request_id=301)])[0].text
        stally = (asrv if sib == na else bsrv).engine
        stally.reset()
        sc1 = dict(se._scheduler.counters)
        res = router.generate_batch([dataclasses.replace(
            req, request_id=302)])[0]
        sib_prefill = (se._scheduler.counters["prefill_tokens"]
                       - sc1["prefill_tokens"])
        hits = se._scheduler.counters["prefix_hits"] - sc1["prefix_hits"]
        spans = stally.tally["ragged_spans"]
        if (res.error or log[-1][1] != sib or hits != 1
                or not 0 < sib_prefill < cold_prefill
                or res.text != warm_text):
            raise AssertionError(
                f"21b: sibling leg on {log[-1][1]}, error {res.error}, hits "
                f"{hits}, prefill {sib_prefill} of {cold_prefill}, text "
                f"equal {res.text == warm_text}")
        require_launches(stally.tally, "sibling's prefix-hit rerun (21b)",
                         ("ragged_spans",))
        idle = router.host_idle(warm)
        removed = router.remove_host(warm)
        last = router.remove_host(sib)
        if not (idle and removed) or last:
            raise AssertionError(f"21b: idle {idle}, removed {removed}, last "
                                 f"host removed {last}")
        if ea.audit() or eb.audit():
            raise AssertionError(f"21b: audits {ea.audit()} {eb.audit()}")
        return {"phase": "fleet-21b", "card": smi,
                "tenant_hosts": tenant_hosts, "tenant_routed": routed,
                "b_slo_state": b_state, "slo_hosts": slo_hosts,
                "slo_penalized": slo["penalized"],
                "warm_host": "A" if warm == na else "B",
                "cold_prefill_tokens": cold_prefill,
                "migrated_tokens": moved, "kv_moves": router._kv_moves,
                "drain_to_migrated_seconds": migrate_s,
                "sibling_prefill_tokens": sib_prefill,
                "sibling_prefix_hits": hits,
                "sibling_span_launches": spans,
                "sibling_text_equal_warm_host": True}
    finally:
        router.shutdown()


def run_autoscale_path(smi: str, eb, reqs, bsrv) -> dict:
    """21c: an ``Autoscaler`` ticked by hand (its clock too) over a router
    with host B alone, whose SLO burns: one tick spawns one supervised
    child (``lmrs-serve-torch --supervise`` through ``--layers-child``, so
    it is ``VARIANT_LAYERS`` deep) on the card, which serves a request;
    once B's burn has cleared and the forecast idles, a tick drains the
    child and a later one removes it, and the supervisor exits 0."""
    import dataclasses
    import types

    from lmrs_tpu_torch.fleet import autoscale
    from lmrs_tpu_torch.obs import MetricsRegistry
    from lmrs_tpu_torch.serving.router import RouterEngine

    card_line(smi, "fleet-21c")
    here = Path(__file__).resolve()
    serve_cli = ["-m", "lmrs_tpu_torch.serving.cli"]
    procs = []

    def popen(cmd, *a, **kw):
        if cmd[1:3] == serve_cli:
            cmd = [cmd[0], str(here), "--layers-child", str(VARIANT_LAYERS),
                   *cmd[3:]]
        procs.append(subprocess.Popen(cmd, *a, **kw))
        return procs[-1]

    plain = autoscale.subprocess
    autoscale.subprocess = types.SimpleNamespace(
        Popen=popen, TimeoutExpired=subprocess.TimeoutExpired)
    nb = f"127.0.0.1:{bsrv.port}"
    router = RouterEngine([nb], timeout_s=SERVE_TIMEOUT)
    pool = autoscale.SupervisedHostPool(
        base_argv=["--model", "bench-8b", "--tokenizer", "byte",
                   "--device", "cuda", "--max-tokens-cap", "64"],
        startup_timeout_s=SERVE_TIMEOUT)

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clk, reg = Clock(), MetricsRegistry()
    scaler = autoscale.Autoscaler(
        router, pool.spawn, remove_cb=pool.remove, clock=clk, registry=reg,
        enabled=True, min_hosts=1, max_hosts=2, cooldown_ticks=1,
        drain_timeout_s=SERVE_TIMEOUT)
    try:
        _burn_slo(eb, [dataclasses.replace(r, cache_prefix=-1)
                       for r in reqs[1:]], 400)
        router._fetch_summary(router.hosts[0])
        if router._slo_penalty(router.hosts[0]) < 1:
            raise AssertionError("21c: B's SLO does not burn")
        t0 = time.time()
        up = scaler.tick()
        startup_s = time.time() - t0
        if len(up["actions"]) != 1 or not up["actions"][0].startswith(
                "spawned:"):
            raise AssertionError(f"21c: scale-up tick {up}")
        child = router.hosts[1]
        sup = pool._procs[child.netloc]
        res = router.generate_batch([dataclasses.replace(
            r, request_id=500 + k, cache_prefix=-1)
            for k, r in enumerate(reqs[1:3])])
        if any(r.error for r in res) or child.served < 1:
            raise AssertionError(f"21c: child served {child.served}, errors "
                                 f"{[r.error for r in res]}")
        # B's burn clears once its samples leave its 3 s windows
        _wait_for(lambda: eb.slo_report()["state"] == "ok", "B's SLO to clear")
        router._fetch_summary(router.hosts[0])
        clk.t += 60.0
        down = scaler.tick()
        if down["actions"] != [f"draining:{child.netloc}"]:
            raise AssertionError(f"21c: scale-down tick {down}")
        _wait_for(lambda: not router.migrations_pending(child.netloc),
                  "the drain's KV migration")
        clk.t += 1.0
        t0 = time.time()
        gone = scaler.tick()
        stop_s = time.time() - t0
        if gone["actions"] != [f"removed:{child.netloc}"] \
                or sup.returncode != 0:
            raise AssertionError(f"21c: removal tick {gone}, supervisor rc "
                                 f"{sup.returncode}")
        counters = {k: reg.counter(k).value for k in (
            "lmrs_autoscale_scale_ups_total", "lmrs_autoscale_drains_total",
            "lmrs_autoscale_scale_downs_total")}
        if list(counters.values()) != [1.0, 1.0, 1.0] or eb.audit():
            raise AssertionError(f"21c: counters {counters}, audit "
                                 f"{eb.audit()}")
        return {"phase": "fleet-21c", "card": smi,
                "spawn_to_healthy_seconds": startup_s,
                "child_served": child.served, "ticks": [up, down, gone],
                "stop_seconds": stop_s, "supervisor_rc": sup.returncode,
                "counters": counters, "report": scaler.report()}
    finally:
        autoscale.subprocess = plain
        router.shutdown()
        pool.shutdown()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_fleet_path(smi: str) -> dict:
    """Phase 21: QoS on the main path (21a), placement and drain (21b), the
    autoscaler (21c)."""
    import gc

    from lmrs_tpu_torch.serving.server import EngineHTTPServer

    t0 = time.time()
    a = run_qos_path(smi)
    ea, reqs = kv_engine()
    with _env(**FLEET_SLO):
        eb, _ = kv_engine()
    asrv = EngineHTTPServer(LaunchTally(ea), port=0)
    bsrv = EngineHTTPServer(LaunchTally(eb), port=0)
    for srv in (asrv, bsrv):
        srv.start_background()
    try:
        b = run_placement_path(smi, ea, eb, reqs, asrv, bsrv)
        emit(b)
        c = run_autoscale_path(smi, eb, reqs, bsrv)
        emit(c)
    finally:
        asrv.shutdown()
        bsrv.shutdown()
    del ea, eb, asrv, bsrv
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "fleet", "card": smi, "qos": a,
            "placement": {k: b[k] for k in ("tenant_routed", "slo_penalized",
                                            "kv_moves", "migrated_tokens")},
            "autoscale": {k: c[k] for k in ("spawn_to_healthy_seconds",
                                            "stop_seconds", "counters")},
            "seconds": time.time() - t0}


# ------------------------------------------------------------ phase 22

TOOLING_OPS = 100_000   # 22's allocator script, over phase 5's pool
TOOLING_PAGES = 112
TOOLING_REPS = 3
TOOLING_BUDGET_S = 20.0


def _best_s(fn, reps: int = TOOLING_REPS) -> tuple[float, object]:
    """The fastest of ``reps`` runs of ``fn`` (seconds) and its result."""
    best, out = float("inf"), None
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t)
    return best, out


def run_tooling_path(smi: str) -> dict:
    """Phase 22 (on the card's host): the native runtime against the
    port's Python versions, both timed, and ``lmrs-lint-torch`` on this
    checkout in a child."""
    import os

    from lmrs_tpu_torch.data.preprocessor import clean_text_py
    from lmrs_tpu_torch.data.tokenizer import ApproxTokenizer
    from lmrs_tpu_torch.engine.kv_cache import PageAllocator
    from lmrs_tpu_torch.runtime import native
    from lmrs_tpu_torch.testing.alloc_script import make_script, replay
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    card_line(smi, "tooling-22")
    t_phase = time.time()
    texts = [s.get("text") or "" for s in load_demo_transcript()["segments"]]
    mb = sum(len(t.encode("utf-8")) for t in texts) / 1e6
    tok = ApproxTokenizer()
    runs = {
        "clean": (lambda: native.clean_text_batch(texts),
                  lambda: [clean_text_py(t) for t in texts]),
        "count": (lambda: native.count_approx_batch(texts),
                  lambda: [tok.count_py(t) for t in texts]),
    }
    out: dict = {"phase": "tooling-22", "card": smi, "segments": len(texts),
                 "megabytes": mb, "parity": {}, "throughput": {}}
    for name, (nat, py) in runs.items():
        s_nat, got = _best_s(nat)
        s_py, want = _best_s(py)
        if got != want:
            bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"22: native {name} differs from the Python "
                                 f"version at segment {bad}: {got[bad]!r} != "
                                 f"{want[bad]!r}")
        out["parity"][name] = "equal"
        out["throughput"][name] = {
            "native_mb_s": mb / s_nat, "python_mb_s": mb / s_py,
            "native_seconds": s_nat, "python_seconds": s_py}
    t = time.perf_counter()
    script, outcomes = make_script(0, TOOLING_OPS, TOOLING_PAGES)
    gen_s = time.perf_counter() - t
    s_nat, got = _best_s(lambda: replay(
        native.NativePageAllocator(TOOLING_PAGES), script))
    s_py, want = _best_s(lambda: replay(PageAllocator(TOOLING_PAGES), script))
    if got != outcomes or want != outcomes:
        bad = next(i for i, o in enumerate(outcomes)
                   if got[i] != o or want[i] != o)
        raise AssertionError(f"22: the allocators disagree at op {bad} "
                             f"{script[bad]}: native {got[bad]}, Python "
                             f"{want[bad]}, script {outcomes[bad]}")
    refused = sum(isinstance(o, str) for o in outcomes)
    out["parity"]["allocator"] = "equal"
    out["throughput"]["allocator"] = {
        "ops": TOOLING_OPS, "refused": refused, "pages": TOOLING_PAGES,
        "native_ops_s": TOOLING_OPS / s_nat,
        "python_ops_s": TOOLING_OPS / s_py, "script_seconds": gen_s}
    here = Path(__file__).resolve().parent
    t = time.time()
    proc = subprocess.run([sys.executable, "-m", "lmrs_tpu_torch.analysis",
                           "--json", str(here)], cwd=here,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(here)})
    lint_s = time.time() - t
    doc = json.loads(proc.stdout) if proc.stdout.strip() else {}
    if proc.returncode != 0 or doc.get("new"):
        raise AssertionError(f"22: lmrs-lint-torch exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    out["lint"] = {"exit": proc.returncode, "new": len(doc["new"]),
                   "accepted": len(doc["accepted"]), "seconds": lint_s}
    out["phase_seconds"] = round(time.time() - t_phase, 3)
    if out["phase_seconds"] > TOOLING_BUDGET_S:
        raise AssertionError(f"22: the phase took {out['phase_seconds']} s, "
                             f"over its {TOOLING_BUDGET_S} s budget")
    return out


def hd256_rows(rows: list[dict], checks: list[dict], main_shapes: list[dict],
               gemma_out: dict, gemma2b_out: dict, tree2b_out: dict,
               launches_3c: dict) -> list[dict]:
    """The kernels line's ``<name>@hd256`` rows: each build's time, plain
    and library times and bound at its main shape (bf16 builds at
    gemma-7b's heads, int8 builds at gemma-2b's, as phases 9, 10 and 12b
    run them), its largest error over phase 3c, and its launches on the
    phase that runs it (phase 3c's own count for a build no phase runs)."""
    by_path = {"flash_prefill": (gemma_out, "gemma-7b path (phase 9)"),
               "paged_decode_fused": (gemma_out, "gemma-7b path (phase 9)"),
               "ragged_spans": (gemma_out, "gemma-7b path (phase 9)"),
               "ragged_spans_int8": (gemma2b_out, "gemma-2b int8 speculative "
                                     "path (phase 10)"),
               "paged_decode_multi_int8": (gemma2b_out, "gemma-2b int8 "
                                           "speculative path (phase 10)"),
               "ragged_spans_anc_int8": (tree2b_out, "gemma-2b int8 tree "
                                         "path (phase 12b)")}
    meta = {r["name"]: r for r in rows}
    out = []
    for name in meta:
        heads = "gemma-2b" if name.endswith("_int8") else "gemma-7b"
        timed = next(r for r in main_shapes if r["name"] == name
                     and r["heads_of"] == heads)
        err = max([r["max_abs_err"] for r in checks + main_shapes
                   if r["name"] == name and "max_abs_err" in r])
        if name in by_path:
            path_out, launched_by = by_path[name]
            n = path_out["launches"][name]
        else:
            n, launched_by = launches_3c[name], "phase 3c only (no phase runs it)"
        out.append({"name": f"{name}@hd256", "route": "cuda",
                    "source": meta[name]["source"],
                    "replaces": meta[name]["replaces"], "launches": n,
                    "launched_by": launched_by, "max_abs_err": err,
                    "ms": timed["ms"], "plain_ms": timed["plain_ms"],
                    "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
                    "library_ms": timed.get("library_ms")})
    return out


def ptxas_entries(log: str) -> list[str]:
    """One line a kernel from ``-Xptxas -v``: its mangled name (template
    arguments show as ``ILi<hd>E...``), registers and spill bytes."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln and name:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used")[1].split(",")[0].strip()
            out.append(f"{name}: {regs}; {spill}")
            name = None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import lmrs_tpu_torch
    from lmrs_tpu_torch.ops import kernels
    from lmrs_tpu_torch.utils.logging import setup_logging

    # the port's logs go to stderr before any phase: stdout is one JSON
    # object a line
    setup_logging(stream=sys.stderr)

    here = Path(__file__).resolve().parent
    if Path(lmrs_tpu_torch.__file__).resolve().parents[1] != here:
        print("chip_smoke: lmrs_tpu_torch must come from this checkout "
              f"({here}), not {lmrs_tpu_torch.__file__}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t_script = time.time()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.time()
    info = kernels.build_all()
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "per_source": {n: {k: v for k, v in i.items() if k != "ptxas"}
                         for n, i in info.items()},
          "ptxas": {n: [ln for ln in i["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, i in info.items()}})
    emit({"phase": "build-hd256",
          "ptxas": {n: [e for e in ptxas_entries(i["ptxas"]) if "ILi256E" in e]
                    for n, i in info.items()}})
    from lmrs_tpu_torch.ops.paged_attention import paged_decode, ragged_spans

    # phase 4's f32 CPU references run in a child while the card runs
    # phases 3-14
    refs = ModelRefs()

    def timed(fn, *args, **kw) -> dict:
        t = time.time()
        out = fn(*args, **kw)
        return {**out, "phase_seconds": round(time.time() - t, 3)}

    gen = torch.Generator(device="cuda").manual_seed(0)
    spans = check_spans(gen)
    spans8 = check_spans(gen, int8=True)
    rows = [check_flash(gen), check_decode(gen),
            {**spans[0], "max_abs_err": max(r["max_abs_err"] for r in spans)},
            check_multi(gen)]
    paged_decode.launches = 0
    rows.append(check_walk(gen))
    walk_launches = paged_decode.launches
    rows8 = [check_decode(gen, int8=True),
             {**spans8[0], "max_abs_err": max(r["max_abs_err"] for r in spans8)},
             check_multi(gen, int8=True)]
    for r in rows[:2] + spans + rows[3:] + rows8[:1] + spans8 + rows8[2:]:
        emit({"phase": "kernels", **r})
    for r in check_split_boundaries(gen):
        emit({"phase": "kernels-split-boundaries", **r})
    anc_checks = check_anc(gen) + check_anc(gen, dict(H=16, K=8, hd=64))
    for r in anc_checks:
        emit({"phase": "kernels-anc", **r})
    anc_main = anc_main_shapes(gen)
    for r in anc_main:
        emit({"phase": "kernels-anc-main-shape", **r})
    for r in check_flash_cases(gen):
        emit({"phase": "kernels-flash-cases", **r})
    for r in flash_main_shapes(gen) + time_main_shapes(gen):
        emit({"phase": "kernels-main-shape", **r})
    hd32 = check_hd32(gen)
    for r in hd32:
        emit({"phase": "hd32", **r})
    anc_launches = ragged_spans.launches_anc_int8  # phases 3 and 3b
    counted = zero_launches()
    hd256 = check_hd256(gen)
    for r in hd256:
        emit({"phase": "hd256", **r})
    hd256_main = hd256_main_shapes(gen)
    for r in hd256_main:
        emit({"phase": "hd256-main-shape", **r})
    launches_3c = read_launches(counted)
    emit(timed(run_cli_default))
    main_out = timed(run_main_path)
    emit(main_out)
    spec_out = timed(run_spec_path)
    emit(spec_out)
    int8_out = timed(run_int8_path)
    emit(int8_out)
    int8_spec_out = timed(run_int8_path, spec=True)
    emit(int8_spec_out)
    gemma_out = timed(run_gemma_path)
    emit(gemma_out)
    # continuation chunks (prompts past 1,024 tokens) are phase 10's span
    # dispatches: without mixed steps or the prefix cache nothing else
    # reaches the span kernel
    gemma2b_out = timed(run_int8_path, spec=True, model="gemma-2b",
                        prefill_chunk=1024)
    emit(gemma2b_out)
    emit(timed(run_parity_path, smi))
    tree_out = timed(run_tree_path)
    emit(tree_out)
    tree2b_out = timed(run_tree_path, "gemma-2b", quantize="int8",
                       kv_quantize="int8")
    emit(tree2b_out)
    emit(timed(run_checkpoint_path))
    emit(timed(run_mixtral_path))
    # phase 4 (its CPU references ready by now; the phases after 14 time
    # host paths, so the child is done before them)
    emit(timed(check_model, refs))
    emit(timed(check_model, refs, int8=True))
    emit(timed(check_model, refs, preset="gemma-7b"))
    emit(timed(check_model, refs, int8=True, preset="gemma-7b"))
    emit(timed(check_tree_dispatch))
    emit(timed(check_tree_dispatch, int8=True))
    emit(timed(check_moe_model, refs))
    emit({"phase": "model-refs", **refs.close()})
    emit(timed(run_serve_path, smi, main_out))
    emit(timed(run_kv_path, smi))
    emit(timed(run_jobs_live_path, smi))
    emit(timed(run_obs_path, smi, main_out))
    emit(timed(run_train_eval_path, smi))
    emit(timed(run_faults_path, smi))
    emit(timed(run_fleet_path, smi))
    emit(run_tooling_path(smi))
    by = {"flash_prefill": (main_out, "main path (phase 5)"),
          "paged_decode_fused": (main_out, "main path (phase 5)"),
          "ragged_spans": (main_out, "main path (phase 5)"),
          "paged_decode_multi": (spec_out, "speculative path (phase 6)"),
          "paged_decode_fused_int8": (int8_out, "int8 path (phase 7)"),
          "ragged_spans_int8": (int8_out, "int8 path (phase 7)"),
          "paged_decode_multi_int8": (int8_spec_out,
                                      "int8 speculative path (phase 8)"),
          "ragged_spans_anc": (tree_out, "tree speculative path (phase 12)")}
    launches = {n: (out["launches"][n], path) for n, (out, path) in by.items()}
    launches["paged_decode"] = (walk_launches, "phase 3 check and timing "
                                "(no caller on any path)")
    launches["ragged_spans_anc_int8"] = (
        anc_launches, "phases 3 and 3b (phase 12b runs the hd-256 build)")
    keys = ("name", "route", "source", "replaces", "launches", "launched_by",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the ancestor-mask builds: main-shape times, the largest error over
    # phases 3 and 3b
    rows_anc = [{**r, "max_abs_err": max(c["max_abs_err"] for c in
                                         anc_checks + hd32 + anc_main
                                         if c["name"] == r["name"])}
                for r in anc_main]
    out_rows = [{**r, "launches": launches[r["name"]][0],
                 "launched_by": launches[r["name"]][1]}
                for r in rows + rows8 + rows_anc]
    out_rows += hd256_rows(rows + rows8 + rows_anc, hd256, hd256_main,
                           gemma_out, gemma2b_out, tree2b_out, launches_3c)
    emit({"phase": "script", "card": smi,
          "seconds": round(time.time() - t_script, 3)})
    emit({"kernels": [{k: r[k] for k in keys} for r in out_rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jobs-child"]:
        sys.exit(jobs_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--layers-child"]:
        sys.exit(layers_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--model-refs"]:
        sys.exit(model_refs_child(sys.argv[2]))
    sys.exit(main())
