"""Continuous-batching scheduler over the paged KV cache (the main-path
subset of the reference's ``engine/scheduler.py``).

* A request is admitted when a slot is free AND the pool holds pages for
  its prompt + token budget + one decode block of overshoot (admission =
  free pages; a slot never grows, so no preemption is needed).
* Admitted prompts prefill in one dispatch each wave: first-fit-decreasing
  bins of at most ``prefill_chunk`` tokens (``_pack_bins``); a bin holding
  several prompts runs as ONE packed [1, S] row with segment ids
  (``_dispatch_packed``), a lone prompt takes the fresh per-prompt route
  (``_dispatch_fresh``).  The LM head runs on the sampled rows only.
* All decoding slots advance together in blocks of ``decode_block`` steps
  (``_decode_block``): a Python loop whose tokens, lengths and EOS flags
  stay on the device, with ONE host fetch per block.  The prefill's first
  tokens stay on the device too and ride back with that fetch.
* Finished slots (EOS, stop sequence, budget) free their pages and the
  next queued request is admitted.

Chunked prefill, mixed steps, the prefix cache, speculation and preemption
belong to later slices of the port.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from lmrs_tpu_torch.config import EngineConfig, ModelConfig
from lmrs_tpu_torch.engine.api import (GenerationRequest, GenerationResult,
                                       apply_stop_sequences)
from lmrs_tpu_torch.engine.kv_cache import (PagedKVCache, SequencePages,
                                            audit_allocator)
from lmrs_tpu_torch.models.transformer import forward_paged
from lmrs_tpu_torch.ops.sampling import sample_logits

logger = logging.getLogger("lmrs_torch.scheduler")


def _pow2_bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class _SlotState:
    req: GenerationRequest
    prompt_ids: list[int]
    max_new: int
    seq: SequencePages
    generated: list[int] = field(default_factory=list)
    kv_len: int = 0
    phase: str = "prefill"  # "prefill" until the prompt is in the pool
    t_start: float = 0.0


class ContinuousScheduler:
    """Host-side scheduling loop over device-side prefill/decode work."""

    def __init__(self, engine_cfg: EngineConfig, model_cfg: ModelConfig,
                 params, tokenizer, device: torch.device):
        self.cfg = engine_cfg
        self.model_cfg = model_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = device
        self.B = engine_cfg.max_batch_slots
        self.max_len = model_cfg.max_seq_len
        self.decode_block = engine_cfg.decode_block
        # tokens one prefill dispatch may carry: a packed bin's capacity,
        # and the longest prompt this slice takes (no chunked prefill)
        self.prefill_cap = min(engine_cfg.prefill_chunk, self.max_len)
        ps = engine_cfg.page_size
        max_pages_per_slot = -(-self.max_len // ps)
        # an explicit pool size is a memory budget, floored at one
        # full-length sequence + the null page (every request then fits
        # alone, so admission can never deadlock)
        num_pages = max(engine_cfg.num_pages, max_pages_per_slot + 1)
        self.cache = PagedKVCache(model_cfg, num_pages, ps, max_pages_per_slot,
                                  device=device, dtype=params["embed"].dtype)
        self.generator = torch.Generator(device=device).manual_seed(
            engine_cfg.seed + 1)
        # a model vocabulary wider than the tokenizer's (a byte tokenizer on
        # a 512- or 128k-row embedding) has rows no text maps to: they are
        # never sampled, so every generated id decodes
        self._vocab_limit = (tokenizer.vocab_size
                             if tokenizer.vocab_size < model_cfg.vocab_size
                             else None)
        self._double_finish = 0
        self._finished_ids: set[int] = set()
        self.counters = {
            "prefill_tokens": 0, "prefill_dispatches": 0,
            "packed_dispatches": 0, "decode_tokens": 0, "decode_blocks": 0,
            "decode_block_seconds": 0.0, "run_seconds": 0.0,
            "occupancy_sum": 0.0, "peak_pages": 0, "requests": 0,
        }

    # ------------------------------------------------------------- run loop

    def run(self, requests: list[GenerationRequest],
            on_result=None) -> list[GenerationResult]:
        """Run the stream to completion; results come back in submission
        order.  ``on_result(result, submit)`` fires inside the loop as each
        request completes, and ``submit(more)`` feeds new requests into the
        same run.  request_ids must be unique within a run."""
        t_run = time.time()
        queue: deque[tuple] = deque()
        all_requests: list[GenerationRequest] = []
        results: dict[int, GenerationResult] = {}
        fresh: deque[int] = deque()

        def submit(new_requests: list[GenerationRequest]) -> None:
            for req in new_requests:
                all_requests.append(req)
                ids, max_new = self._encode(req)
                if len(ids) > self.prefill_cap:
                    # one dispatch cannot hold it: an error result for this
                    # request alone (chunked prefill is a later slice)
                    results[req.request_id] = GenerationResult(
                        request_id=req.request_id, prompt_tokens=len(ids),
                        finish_reason="error",
                        error=f"prompt of {len(ids)} tokens exceeds "
                              f"prefill_chunk={self.cfg.prefill_chunk}; "
                              "chunked prefill is not in this slice")
                    fresh.append(req.request_id)
                    continue
                queue.append((req, ids, max_new))

        self._finished_ids = set()
        submit(requests)
        B = self.B
        slots: list[_SlotState | None] = [None] * B
        last_tok = np.zeros((B,), np.int64)
        kv_lens = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int64)
        top_p = np.ones((B,), np.float32)
        usable = self.cache.num_pages - 1

        def admit() -> None:
            for b in range(B):
                if slots[b] is not None or not queue:
                    continue
                req, ids, max_new = queue[0]
                reserve = min(len(ids) + max_new + self.decode_block, self.max_len)
                need = min(self.cache.pages_needed(reserve),
                           self.cache.max_pages_per_slot)
                if need > self.cache.allocator.free_count:
                    break  # back-pressure: wait for a slot to free pages
                queue.popleft()
                slots[b] = _SlotState(req=req, prompt_ids=ids, max_new=max_new,
                                      seq=self.cache.open_sequence(reserve),
                                      t_start=time.time())
                kv_lens[b] = 0
                last_tok[b] = 0
                active[b] = False
                temps[b] = req.temperature
                top_k[b] = req.top_k
                top_p[b] = min(max(req.top_p, 0.0), 1.0)
                self.counters["requests"] += 1
                self.counters["peak_pages"] = max(
                    self.counters["peak_pages"],
                    usable - self.cache.allocator.free_count)

        try:
            while True:
                if on_result is not None:
                    while fresh:
                        on_result(results[fresh.popleft()], submit)
                if not (queue or any(s is not None for s in slots)):
                    break
                admit()
                pending = self._advance_prefills(slots)
                for _, rows in pending:
                    for b, _row in rows:
                        st = slots[b]
                        st.phase = "decode"
                        st.kv_len = len(st.prompt_ids)
                        kv_lens[b] = st.kv_len
                        active[b] = True
                if not active.any():
                    continue
                toks, n_valid, tok0s = self._decode_block(
                    slots, last_tok, kv_lens, active, temps, top_k, top_p,
                    pending)
                # first tokens of this wave's prefills, then the block's
                for p, (_, rows) in enumerate(pending):
                    for b, row in rows:
                        slots[b].generated.append(int(tok0s[p][row]))
                for b in range(B):
                    st = slots[b]
                    if st is None or not active[b]:
                        continue
                    new = toks[b, : int(n_valid[b])].tolist()
                    st.generated.extend(new)
                    st.kv_len += len(new)
                    kv_lens[b] = st.kv_len
                    last_tok[b] = st.generated[-1]
                    self.counters["decode_tokens"] += len(new)
                    self._maybe_finish(b, slots, results, fresh, active,
                                       kv_lens, last_tok)
        except Exception:
            # the engine must survive for the next batch: free every live
            # slot's pages (the caller turns the exception into errors)
            for b in range(B):
                if slots[b] is not None:
                    self.cache.close_sequence(slots[b].seq)
                    slots[b] = None
            raise
        finally:
            self.counters["run_seconds"] += time.time() - t_run
        return [results[r.request_id] for r in all_requests]

    # ------------------------------------------------------------ internals

    def _encode(self, req: GenerationRequest) -> tuple[list[int], int]:
        """bos + (system prompt + prompt) ids, middle-truncated so prompt +
        budget fit the window; budget capped at max_seq_len - 1."""
        text = (req.system_prompt + "\n\n" if req.system_prompt else "") + req.prompt
        ids = [self.tokenizer.bos_id] + self.tokenizer.encode(text)
        max_new = min(req.max_new_tokens, self.cfg.max_tokens, self.max_len - 1)
        limit = self.max_len - max_new
        if len(ids) > limit:
            head, tail = limit // 2, limit - limit // 2
            ids = ids[:head] + ids[-tail:]
        return ids, max_new

    def _trim_tokens(self, gen: list[int], max_new: int, stop):
        """(gen, text, stop_hit, hit_eos): budget-, EOS- and stop-trimmed."""
        gen = gen[:max_new]
        eos = self.tokenizer.eos_id
        hit_eos = eos in gen
        if hit_eos:
            gen = gen[: gen.index(eos)]
        text, stop_hit = apply_stop_sequences(self.tokenizer.decode(gen), stop)
        return gen, text, stop_hit, hit_eos

    def _maybe_finish(self, b, slots, results, fresh, active, kv_lens,
                      last_tok) -> None:
        st = slots[b]
        gen, text, stop_hit, hit_eos = self._trim_tokens(
            st.generated, st.max_new, st.req.stop)
        if not (hit_eos or stop_hit or len(gen) >= st.max_new):
            return
        rid = st.req.request_id
        if rid in self._finished_ids:
            self._double_finish += 1
        self._finished_ids.add(rid)
        results[rid] = GenerationResult(
            request_id=rid, text=text, prompt_tokens=len(st.prompt_ids),
            completion_tokens=len(gen),
            finish_reason="stop" if (hit_eos or stop_hit) else "length",
            stop_sequence=stop_hit, device_seconds=time.time() - st.t_start)
        fresh.append(rid)
        self.cache.close_sequence(st.seq)
        slots[b] = None
        active[b] = False
        kv_lens[b] = 0  # a freed row carries length 0: the kernel skips it
        last_tok[b] = 0

    @staticmethod
    def _pack_bins(items: list, capacity: int) -> list[list]:
        """First-fit-decreasing bin packing of (slot, state) items by prompt
        length, bins of at most ``capacity`` tokens."""
        bins: list[tuple[int, list]] = []
        for it in sorted(items, key=lambda t: -len(t[1].prompt_ids)):
            n = len(it[1].prompt_ids)
            for i, (used, lst) in enumerate(bins):
                if used + n <= capacity:
                    lst.append(it)
                    bins[i] = (used + n, lst)
                    break
            else:
                bins.append((n, [it]))
        return [lst for _, lst in bins]

    def _advance_prefills(self, slots) -> list[tuple[torch.Tensor, list]]:
        """Prefill every slot still in prefill phase; returns
        [(tok0 device tensor [N], [(slot, row)])] — first tokens NOT fetched."""
        items = [(b, st) for b, st in enumerate(slots)
                 if st is not None and st.phase == "prefill"]
        pending = []
        for bin_items in self._pack_bins(items, self.prefill_cap):
            if len(bin_items) == 1:
                pending.append(self._dispatch_fresh(*bin_items[0]))
            else:
                pending.append(self._dispatch_packed(bin_items))
        return pending

    def _sample(self, logits, temps, top_k, top_p) -> torch.Tensor:
        if self._vocab_limit is not None:
            logits = logits.clone()
            logits[:, self._vocab_limit:] = float("-inf")
        return sample_logits(logits, temps, top_k, top_p,
                             generator=self.generator)

    def _sampler_params(self, reqs):
        return (np.array([r.temperature for r in reqs], np.float32),
                np.array([r.top_k for r in reqs], np.int64),
                np.array([min(max(r.top_p, 0.0), 1.0) for r in reqs], np.float32))

    def _dispatch_fresh(self, b: int, st: _SlotState):
        """One prompt, one [1, n] row: pages from the slot's table."""
        dev = self.device
        n = len(st.prompt_ids)
        tokens = torch.tensor([st.prompt_ids], dtype=torch.long, device=dev)
        positions = torch.arange(n, device=dev)[None]
        table = torch.tensor(self.cache.page_table_array([st.seq]), device=dev)
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        logits = forward_paged(
            self.params, self.model_cfg, tokens, positions, self.cache.k,
            self.cache.v, table, lens, self.max_len,
            last_pos=torch.tensor([n - 1], device=dev))
        tok0 = self._sample(logits[:, 0], *self._sampler_params([st.req]))
        self.counters["prefill_tokens"] += n
        self.counters["prefill_dispatches"] += 1
        return tok0, [(b, 0)]

    def _dispatch_packed(self, items: list):
        """Several prompts concatenated into one [1, S] row: per-token
        segment ids, within-segment positions and host-built page ids; each
        segment's first token is sampled from its last row."""
        dev = self.device
        ps = self.cache.page_size
        s_real = sum(len(st.prompt_ids) for _, st in items)
        tokens = np.empty((1, s_real), np.int64)
        positions = np.empty((1, s_real), np.int64)
        seg_ids = np.empty((1, s_real), np.int32)
        token_pages = np.empty((1, s_real), np.int64)
        last_idx = np.empty((len(items),), np.int64)
        off = 0
        for si, (_, st) in enumerate(items):
            n = len(st.prompt_ids)
            within = np.arange(n)
            tokens[0, off:off + n] = st.prompt_ids
            positions[0, off:off + n] = within
            seg_ids[0, off:off + n] = si
            token_pages[0, off:off + n] = np.asarray(st.seq.pages)[within // ps]
            last_idx[si] = off + n - 1
            off += n
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        logits = forward_paged(
            self.params, self.model_cfg, t(tokens), t(positions),
            self.cache.k, self.cache.v,
            torch.zeros((1, 1), dtype=torch.long, device=dev),  # unused
            torch.tensor([s_real], dtype=torch.int32, device=dev), self.max_len,
            token_pages=t(token_pages), segment_ids=t(seg_ids),
            packed_last_idx=t(last_idx))
        tok0 = self._sample(logits[0], *self._sampler_params(
            [st.req for _, st in items]))
        self.counters["prefill_tokens"] += s_real
        self.counters["prefill_dispatches"] += 1
        self.counters["packed_dispatches"] += 1
        return tok0, [(b, si) for si, (b, _) in enumerate(items)]

    def _decode_block(self, slots, last_tok, kv_lens, active, temps, top_k,
                      top_p, pending=()):
        """``decode_block`` decode steps for every active slot, tokens kept
        on the device; returns (tokens [B, n] host, n_valid [B] host, first
        tokens of ``pending`` as host arrays) from ONE fetch."""
        dev = self.device
        B, n_steps = self.B, self.decode_block
        max_pages = 1
        for st in slots:
            if st is not None and st.phase == "decode":
                max_pages = max(max_pages, len(st.seq.pages))
        w = min(_pow2_bucket(max_pages, 4), self.cache.max_pages_per_slot)
        table = self.cache.page_table_array(
            [st.seq if (st is not None and st.phase == "decode") else None
             for st in slots])[:, :w]
        table_d = torch.from_numpy(table).to(dev)
        tok = torch.from_numpy(last_tok.copy()).to(dev)
        for tok0, rows in pending:  # first tokens: on-device scatter, no sync
            idx = torch.tensor([b for b, _ in rows], device=dev)
            src = torch.tensor([r for _, r in rows], device=dev)
            tok[idx] = tok0[src]
        lens = torch.from_numpy(kv_lens.astype(np.int64)).to(dev)
        act = torch.from_numpy(active.copy()).to(dev)
        done = ~act
        eos = self.tokenizer.eos_id
        # inactive rows: zero sampler temperature (greedy, masked anyway)
        t_rows = np.where(active, temps, 0.0).astype(np.float32)
        toks, valid = [], []
        t0 = time.time()
        for _ in range(n_steps):
            pos = torch.clamp(lens, max=self.max_len - 1)
            kv_in = torch.where(act, torch.clamp(lens + 1, max=self.max_len),
                                torch.zeros_like(lens)).to(torch.int32)
            logits = forward_paged(
                self.params, self.model_cfg, tok[:, None], pos[:, None],
                self.cache.k, self.cache.v, table_d, kv_in, self.max_len)
            nxt = self._sample(logits[:, 0], t_rows, top_k, top_p)
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            toks.append(nxt)
            valid.append(~done)
            lens = torch.where(done, lens, lens + 1)
            done = done | (nxt == eos)
            tok = nxt
        out_toks = torch.stack(toks, 1)
        out_valid = torch.stack(valid, 1).sum(dim=1)
        fetched = [x.numpy() for x in _one_fetch(
            [out_toks, out_valid] + [t0_ for t0_, _ in pending])]
        self.counters["decode_block_seconds"] += time.time() - t0
        self.counters["decode_blocks"] += 1
        self.counters["occupancy_sum"] += float(active.mean())
        return fetched[0], fetched[1], fetched[2:]

    # ------------------------------------------------------------ reporting

    def audit(self, live_seqs=None) -> list[str]:
        """Invariant audit (empty list = clean): page conservation and
        refcount balance against the live sequences (none between runs),
        and no request finished twice."""
        holders: dict[int, int] = {}
        for seq in live_seqs or ():
            for p in seq.pages:
                holders[p] = holders.get(p, 0) + 1
        violations = audit_allocator(self.cache.allocator,
                                     self.cache.num_pages, holders)
        if self._double_finish:
            violations.append(f"{self._double_finish} request(s) finished "
                              "more than once")
        return violations

    def metrics_report(self) -> dict:
        c = self.counters
        blk = c["decode_block_seconds"]
        return {
            "requests": c["requests"],
            "prefill_tokens": c["prefill_tokens"],
            "prefill_dispatches": c["prefill_dispatches"],
            "packed_prefill_dispatches": c["packed_dispatches"],
            "decode_tokens": c["decode_tokens"],
            "decode_blocks": c["decode_blocks"],
            "decode_block_seconds": round(blk, 4),
            "decode_tokens_per_sec": round(c["decode_tokens"] / blk, 2) if blk else 0.0,
            "mean_decode_occupancy": round(
                c["occupancy_sum"] / c["decode_blocks"], 4) if c["decode_blocks"] else 0.0,
            "peak_kv_pages": c["peak_pages"],
            "peak_kv_page_utilization": round(
                c["peak_pages"] / (self.cache.num_pages - 1), 4),
            "run_seconds": round(c["run_seconds"], 4),
        }


def _one_fetch(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Bring several device tensors to the host in one transfer: flatten,
    concatenate as int64, copy once, split."""
    flat = torch.cat([t.reshape(-1).long() for t in tensors]).cpu()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].reshape(t.shape))
        off += n
    return out
