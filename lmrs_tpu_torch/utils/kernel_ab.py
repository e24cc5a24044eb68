"""Device times of the attention kernels at fixed shapes, for comparing two
checkouts of the port on one card in one call.

Run it once per checkout, with that checkout's package first on the path,
in turns (parent, change, change, parent)::

    PYTHONPATH=<checkout> python3 lmrs_tpu_torch/utils/kernel_ab.py --tag parent

It prints one JSON object: the package it timed, the card's name and power
limit, and for each kernel and shape the median device ms of one call
(``time_ms``).  Only the public wrappers are called, so an older checkout
of the port times the same way.  ``--prefill`` profiles one fresh-prefill
dispatch instead (``profile_prefill``: bench-8b at full depth, random-init
bf16, one 1,600-token row through ``forward_paged``).  ``--e2e`` times the
end-to-end paths, through the checkout's own ``chip_smoke.py`` (on the
same path): phases 5-8 (bf16, bf16 with linear speculation, int8, int8
with speculation: wall seconds, decode tokens/s) and each one's
decode-step or verify-step profile.  ``--init-sums`` prints, instead, a
checksum of every leaf of bench-8b's and gemma-2b's int8 random-init
params (seed 0, on the card), so two checkouts' int8 weights can be held
equal bit for bit.  Needs a card; exits 1 without one.

Shapes (bench-8b widths: H=32, K=8, hd=128, ps=128, W=16): decode at
``chip_smoke.py`` phase 3's 8 rows (kv_lens 0/1/128/129/700/1500/2048/1000)
and at the main path's 8 x 1,501 tokens; spans at phase 3's mixed step and
1,300-token continuation and at the main path's mixed step (7 decode rows at
1,500 + a 249-token slice at base 384); verify (8 rows x 5 tokens,
max_pos 2048) at phase 3's kv_lens 6/133/130/700/1500/2050/1000/305 and at
the speculative path's 8 x 5 tokens after 1,500; bf16 and int8 pools;
flash prefill at ``chip_smoke.py`` phase 3's packed row (S=2,048, segments
700/512/333/260), at the main path's unpacked 1,600-token row and at a
packed reduce bin (three 600-token segments), q/k/v as strided views of
one qkv product, as ``forward_paged`` passes them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

SLEEP_CYCLES = 2_000_000  # ~1 ms of device spin before each timed call


def time_ms(fn, reps: int = 10) -> float:
    """Median device ms of ``fn`` over ``reps`` calls, each timed with CUDA
    events after a 256 MB read that evicts the 50 MB L2 (the main path
    finds each layer's data cold; a read leaves clean lines, so the timed
    call pays no write-back of the flush).  A device spin is queued before
    the start event, so the host's work in the wrapper (checks,
    allocations, the ctypes call) is done before the event fires and is not
    counted; the median drops the calls where a stall of the shared host
    outlasted the spin."""
    flush = torch.zeros(32 * 2**20, dtype=torch.int64, device="cuda")
    fn()  # warm-up
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _int8(x: dict, rows: int, gen: torch.Generator) -> dict:
    y = dict(x)
    for name in ("k_pages", "v_pages"):
        y[name] = torch.randint(-127, 128, x[name].shape, generator=gen,
                                device="cuda", dtype=torch.int8)
    kh, hd = x["k_pages"].shape[1], x["k_pages"].shape[3]
    for name in ("kscale", "vscale"):
        y[name] = torch.rand(rows, kh, hd, generator=gen, device="cuda") * 0.05 + 0.01
    return y


def flash_inputs(gen: torch.Generator, seg_lens: list[int] | None, s: int,
                 h: int = 32, kh: int = 8, hd: int = 128, b: int = 1,
                 lengths: list[int] | None = None) -> dict:
    """Flash prefill's kwargs for ``b`` rows of ``s`` tokens: q, k, v as
    strided views of one [b, s, (h + 2kh)·hd] qkv product.  ``seg_lens``
    packs segments from position 0 in every row (the rest padding, id -1)
    and sets each length to their sum; otherwise ``lengths`` (default s)."""
    qkv = torch.randn(b, s, (h + 2 * kh) * hd, generator=gen,
                      device="cuda").bfloat16()
    seg = None
    if seg_lens is not None:
        seg = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
        off = 0
        for i, n in enumerate(seg_lens):
            seg[:, off:off + n] = i
            off += n
        lengths = [off] * b
    return dict(q=qkv[..., :h * hd].view(b, s, h, hd),
                k=qkv[..., h * hd:(h + kh) * hd].view(b, s, kh, hd),
                v=qkv[..., (h + kh) * hd:].view(b, s, kh, hd),
                lengths=torch.tensor(lengths or [s] * b, dtype=torch.int32,
                                     device="cuda"),
                segment_ids=seg)


FLASH_SHAPES = {"phase3_packed": ([700, 512, 333, 260], 2048),
                "main_unpacked": (None, 1600),
                "reduce_packed": ([600, 600, 600], 1800)}

# The flash kernel's edge cases, held against its plain version by
# ``chip_smoke.py`` phase 3 and ``tests/test_torch_cuda.py``: n_rep 1-8,
# hd 32/64/128, tiles cut by S or by the lengths, a 1- and a 5-token
# segment (shorter than a tile) and segments starting mid-tile, rows of
# different lengths.  name -> (B, S, H, K, hd, lengths, segment lengths);
# lengths None: the segments' sum.
FLASH_CASES = {
    "main_unpacked": (1, 1600, 32, 8, 128, [1600], None),
    "not_tile_multiple": (1, 1000, 8, 2, 128, [1000], None),
    "padded_tail": (1, 1000, 8, 2, 64, [777], None),
    "packed_short_segments": (1, 700, 8, 2, 128, None, [1, 5, 130, 200, 300]),
    "batch_lengths": (3, 520, 8, 4, 128, [520, 300, 64], None),
    "n_rep1_hd64": (1, 300, 4, 4, 64, [300], None),
    "n_rep8_hd32": (1, 300, 8, 1, 32, [300], None),
    "packed_batch_hd32": (2, 300, 8, 4, 32, None, [100, 150]),
}


def cases(gen: torch.Generator) -> dict:
    """name -> (wrapper, kwargs)."""
    from lmrs_tpu_torch.ops import paged_attention as pa
    from lmrs_tpu_torch.ops.flash_attention import flash_attention

    H, K, hd, ps, W = 32, 8, 128, 128, 16
    bf = lambda *s: torch.randn(*s, generator=gen, device="cuda").bfloat16()  # noqa: E731
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    out = {}
    P = 8 * W + 1
    tables = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).view(8, W).int()
    for shape, lens in (("phase3", [0, 1, 128, 129, 700, 1500, 2048, 1000]),
                        ("main", [1501] * 8)):
        x = dict(q=bf(8, H, hd), k_new=bf(8, K, hd), v_new=bf(8, K, hd),
                 k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
                 page_tables=tables, kv_lens=i32(lens))
        out[f"decode_bf16/{shape}"] = (pa.paged_decode_fused, x)
        out[f"decode_int8/{shape}"] = (pa.paged_decode_fused, _int8(x, 8, gen))
        out[f"walk/{shape}"] = (pa.paged_decode, {k: x[k] for k in (
            "q", "k_pages", "v_pages", "page_tables", "kv_lens")})
    for shape, q_lens, bases, tp in (
            ("mixed", [1] * 7 + [249], [100, 400, 700, 1000, 1300, 1600, 1900, 384], 512),
            ("continuation", [1300] + [0] * 7, [384] + [0] * 7, None),
            ("main_mixed", [1] * 7 + [249], [1500] * 7 + [384], 512)):
        q_starts, total = pa.pack_spans(q_lens)
        tp = tp or total
        x = dict(q=bf(tp, H, hd), k_new=bf(tp, K, hd), v_new=bf(tp, K, hd),
                 k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
                 page_tables=tables, kv_lens=i32(bases),
                 q_starts=i32(q_starts.tolist()), q_lens=i32(q_lens))
        out[f"spans_bf16/{shape}"] = (pa.ragged_spans, x)
        out[f"spans_int8/{shape}"] = (pa.ragged_spans, _int8(x, 8, gen))
    T = 5
    for shape, lens in (("phase3", [6, 133, 130, 700, 1500, 2050, 1000, 305]),
                        ("main", [1500 + T] * 8)):
        x = dict(q=bf(8, T, H, hd), k_new=bf(8, T, K, hd), v_new=bf(8, T, K, hd),
                 k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
                 page_tables=tables, kv_lens=i32(lens), max_pos=2048)
        out[f"verify_bf16/{shape}"] = (pa.paged_decode_multi, x)
        out[f"verify_int8/{shape}"] = (pa.paged_decode_multi, _int8(x, 8, gen))
    for shape, (seg_lens, s) in FLASH_SHAPES.items():
        out[f"flash/{shape}"] = (flash_attention, flash_inputs(gen, seg_lens, s))
    return out


def init_checksums() -> dict:
    """Per-leaf checksums (the sum of the raw bits as integers, and the sum
    weighted by position) of bench-8b's and gemma-2b's int8 random-init
    params, seed 0, on the card: ``init_params(quantize="int8")`` where the
    checkout has it (each layer quantized after its draw), else
    ``quantize_params(init_params(...))`` (the drawn tree quantized)."""
    import inspect

    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.models.transformer import init_params
    from lmrs_tpu_torch.ops.quant import quantize_params

    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int8: torch.int8}

    def checksum(t: torch.Tensor) -> list[int]:
        x = t.contiguous().view(-1).view(bits[t.dtype]).to(torch.int64)
        w = torch.arange(x.numel(), device=x.device) % 1000003 + 1
        return [int(x.sum()), int((x * w).sum())]

    out = {}
    for name in ("bench-8b", "gemma-2b"):
        cfg = model_preset(name)
        if "quantize" in inspect.signature(init_params).parameters:
            p = init_params(cfg, 0, "cuda", quantize="int8")
        else:
            p = quantize_params(init_params(cfg, 0, "cuda"))
        sums = {}
        for k, v in p.items():
            for i, lp in enumerate(v if k == "layers" else [{k: v}]):
                for n, t in lp.items():
                    key = f"layers.{i}.{n}" if k == "layers" else n
                    for part, leaf in (t.items() if isinstance(t, dict) else [("", t)]):
                        sums[key + (f".{part}" if part else "")] = checksum(leaf)
        out[name] = sums
        del p
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--e2e", action="store_true",
                      help="time phases 5-8 instead of the kernels")
    mode.add_argument("--prefill", action="store_true",
                      help="profile one fresh-prefill dispatch instead")
    mode.add_argument("--init-sums", action="store_true",
                      help="checksum the int8 random-init leaves instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    import lmrs_tpu_torch
    from lmrs_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"tag": args.tag, "package": lmrs_tpu_torch.__file__,
           "nvidia_smi": smi}
    if args.init_sums:
        out["init_sums"] = init_checksums()
        print(json.dumps(out), flush=True)
        return 0
    kernels.build_all()
    if args.e2e:
        out["e2e"] = end_to_end()
    elif args.prefill:
        out["prefill"] = prefill_bench8b()
    else:
        gen = torch.Generator(device="cuda").manual_seed(0)
        out["ms"] = {name: time_ms(lambda: fn(**x), 20)
                     for name, (fn, x) in cases(gen).items()}
    print(json.dumps(out), flush=True)
    return 0


def kernel_kind(name: str) -> str:
    """A device kernel's kind by its name: the port's attention kernels
    (the span kernel's two passes are ``span_write_kernel`` and
    ``span_attn_kernel``), cuBLAS products, or the rest (elementwise,
    norms, copies)."""
    name = name.lower()
    for kind in ("flash_prefill", "paged_decode", "ragged_spans"):
        if kind in name:
            return kind
    if "span_write_kernel" in name or "span_attn_kernel" in name:
        return "ragged_spans"
    if any(w in name for w in ("gemm", "cutlass", "sm90_xmma", "nvjet")):
        return "gemm"
    return "other"


def profile_prefill(params, cfg, k_pages, v_pages, table, n: int = 1600,
                    steps: int = 3) -> dict:
    """One fresh-prefill dispatch as the scheduler's ``_dispatch_fresh``
    issues it (one [1, n] row from position 0 through ``forward_paged``,
    the last row sampled): host wall per dispatch (synchronized), host
    issue time, and from ``torch.profiler`` the device time by kernel kind
    (``kernel_kind``) and the flash kernel's launches.  ``table``: [1, W]
    logical pages of the pools that hold n tokens."""
    from torch.profiler import ProfilerActivity, profile

    from lmrs_tpu_torch.models.transformer import forward_paged

    dev = k_pages.device
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(3, 259, (1, n), generator=gen, device=dev)
    positions = torch.arange(n, device=dev)[None]
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    last = torch.tensor([n - 1], device=dev)

    def one():
        forward_paged(params, cfg, tokens, positions, k_pages, v_pages, table,
                      lens, cfg.max_seq_len, last_pos=last)

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    issue_ms = 0.0
    for _ in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one()
        issue_ms += (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
    kinds: dict[str, float] = {}
    launches: dict[str, int] = {}
    for evt in prof.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            kind = kernel_kind(evt.name)
            kinds[kind] = kinds.get(kind, 0.0) + evt.time_range.elapsed_us() / 1e3
            launches[kind] = launches.get(kind, 0) + 1
    busy = sum(kinds.values()) / steps
    return {"tokens": n, "layers": cfg.n_layers,
            "wall_ms_per_dispatch": wall_ms,
            "host_issue_ms_per_dispatch": issue_ms / steps,
            "device_busy_ms_per_dispatch": busy if kinds else "not measured",
            "kernel_ms_per_dispatch": {k: v / steps for k, v in kinds.items()},
            "launches_per_dispatch": {k: v // steps for k, v in launches.items()}}


def prefill_bench8b(n: int = 1600) -> dict:
    """``profile_prefill`` at bench-8b (32 layers, random-init bf16) over
    pools that hold exactly the row's pages."""
    from lmrs_tpu_torch.config import model_preset
    from lmrs_tpu_torch.models.transformer import init_params

    cfg = model_preset("bench-8b")
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    ps = 128
    pages = -(-n // ps) + 1  # + the null page 0
    shape = (cfg.n_layers * pages, cfg.n_kv_heads, ps, cfg.hd)
    k_pages = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    v_pages = torch.zeros_like(k_pages)
    table = torch.arange(1, pages, device="cuda")[None]
    return profile_prefill(params, cfg, k_pages, v_pages, table, n)


def end_to_end() -> dict:
    """Phases 5 (bf16), 6 (bf16, linear speculation), 7 (int8 weights and
    KV) and 8 (int8, speculation) of the checkout's ``chip_smoke.py``: wall
    seconds, decode tokens/s, and the decode-step profile (the verify-step
    profile, 8 rows x 5 tokens, for 6 and 8)."""
    import chip_smoke

    spec = {"speculate_k": 4, "mixed_batch": False}
    int8 = {"quantize": "int8", "kv_quantize": "int8"}
    res = {}
    for name, kw in (("bf16", {}), ("bf16_spec", spec), ("int8", int8),
                     ("int8_spec", {**int8, **spec})):
        summarizer, engine, stats, wall, _ = chip_smoke.summarize_once(**kw)
        step = chip_smoke.profile_decode_step(
            engine, tokens=5 if "speculate_k" in kw else 1)
        summarizer.shutdown()
        res[name] = {"wall_seconds": wall,
                     "decode_tokens_per_sec":
                         stats["engine_metrics"]["decode_tokens_per_sec"],
                     "step_profile": step}
        del summarizer, engine
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    sys.exit(main())
