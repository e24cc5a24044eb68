"""Device times of the paged-attention kernels at fixed shapes, for comparing
two checkouts of the port on one card in one call.

Run it once per checkout, with that checkout's package first on the path,
in turns (parent, change, change, parent)::

    PYTHONPATH=<checkout> python3 lmrs_tpu_torch/utils/kernel_ab.py --tag parent

It prints one JSON object: the package it timed, the card's name and power
limit, and for each kernel and shape the median device ms of one call
(``time_ms``).  Only the public wrappers are called, so an older checkout
of the port times the same way.  ``--e2e`` times the end-to-end paths
instead, through the checkout's own ``chip_smoke.py`` (on the same path):
phases 5-8 (bf16, bf16 with linear speculation, int8, int8 with
speculation: wall seconds, decode tokens/s) and each one's decode-step or
verify-step profile.  Needs a card; exits 1 without one.

Shapes (bench-8b widths: H=32, K=8, hd=128, ps=128, W=16): decode at
``chip_smoke.py`` phase 3's 8 rows (kv_lens 0/1/128/129/700/1500/2048/1000)
and at the main path's 8 x 1,501 tokens; spans at phase 3's mixed step and
1,300-token continuation and at the main path's mixed step (7 decode rows at
1,500 + a 249-token slice at base 384); verify (8 rows x 5 tokens,
max_pos 2048) at phase 3's kv_lens 6/133/130/700/1500/2050/1000/305 and at
the speculative path's 8 x 5 tokens after 1,500; bf16 and int8 pools.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

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


def cases(gen: torch.Generator) -> dict:
    """name -> (wrapper name, kwargs)."""
    from lmrs_tpu_torch.ops import paged_attention as pa

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
        out[f"decode_bf16/{shape}"] = ("paged_decode_fused", x)
        out[f"decode_int8/{shape}"] = ("paged_decode_fused", _int8(x, 8, gen))
        out[f"walk/{shape}"] = ("paged_decode", {k: x[k] for k in (
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
        out[f"spans_bf16/{shape}"] = ("ragged_spans", x)
        out[f"spans_int8/{shape}"] = ("ragged_spans", _int8(x, 8, gen))
    T = 5
    for shape, lens in (("phase3", [6, 133, 130, 700, 1500, 2050, 1000, 305]),
                        ("main", [1500 + T] * 8)):
        x = dict(q=bf(8, T, H, hd), k_new=bf(8, T, K, hd), v_new=bf(8, T, K, hd),
                 k_pages=bf(P, K, ps, hd), v_pages=bf(P, K, ps, hd),
                 page_tables=tables, kv_lens=i32(lens), max_pos=2048)
        out[f"verify_bf16/{shape}"] = ("paged_decode_multi", x)
        out[f"verify_int8/{shape}"] = ("paged_decode_multi", _int8(x, 8, gen))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--e2e", action="store_true",
                    help="time phases 5-8 instead of the kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    import lmrs_tpu_torch
    from lmrs_tpu_torch.ops import kernels
    from lmrs_tpu_torch.ops import paged_attention as pa

    kernels.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"tag": args.tag, "package": lmrs_tpu_torch.__file__,
           "nvidia_smi": smi}
    if args.e2e:
        out["e2e"] = end_to_end()
    else:
        gen = torch.Generator(device="cuda").manual_seed(0)
        out["ms"] = {}
        for name, (fn, x) in cases(gen).items():
            wrapper = getattr(pa, fn)
            out["ms"][name] = time_ms(lambda: wrapper(**x), 20)
    print(json.dumps(out), flush=True)
    return 0


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
