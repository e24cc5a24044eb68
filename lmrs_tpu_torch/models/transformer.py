"""Decoder-only transformer (Llama-3 / Gemma family).

The port of the reference's ``models/transformer.py``: ``forward_paged``
for the routes the continuous engine serves (fresh prefill, packed fresh
prefill, single-token decode, multi-token verify and ragged spans), and
``forward`` for training (cache-less) and the static engine (a dense
[L, B, S_max, K, hd] cache).  ``forward`` reaches no kernel, as the
reference's reaches no Pallas call: its attention is the plain
``ops.attention.attention`` (XLA's in the reference), so autograd
differentiates it, and ``remat=True`` recomputes each layer in the
backward pass (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``).  Params are a plain dict of tensors (see
``init_params``); each layer's q/k/v projections are stored fused as one
[D, (H + 2K)·hd] matrix and gate/up as one [D, 2F] matrix, so a layer is
four matmuls.  A mixture-of-experts model (``cfg.n_experts``; Mixtral)
has a router [D, E] and expert stacks [E, D, 2F] / [E, F, D] in place of
the dense FFN, run by ``ops.moe.moe_mlp``.  The dense products stay
``torch.matmul`` (the reference left them to XLA); attention goes through
the kernel modules:

* prefill (S > 1): K/V scattered into the pool, then
  ``ops.flash_attention.flash_attention`` over the current tokens;
* decode (S == 1): ``ops.paged_attention.paged_decode_fused`` writes the
  token's K/V and attends the live pages in one kernel;
* multi-token verify (``multi_decode``): ``ops.paged_attention.
  paged_decode_multi`` writes the T tokens' K/V and attends them with
  per-token causality in one kernel — speculative decoding's step;
* spans (``spans=``): ``ops.paged_attention.ragged_spans`` writes every
  span token's K/V and attends prefix + span — mixed steps, continuation
  chunks and prefix-cache hit tails; with ``span_anc`` (tree speculation)
  its ancestor-mask build.

Int8 (the reference's ``quantize``/``kv_quantize``): a projection may be a
quantized ``{"q", "s"}`` leaf (``ops/quant.py``), multiplied by
``qmatmul``; int8 pools come with ``kv_scales`` — per-(slot, kv head,
channel) K and V scales [L, B, K, hd], updated IN PLACE as prompts' first
tokens fix them — and the kernels' int8 variants.

A CUDA tensor runs the kernels, a CPU tensor their plain versions.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from lmrs_tpu_torch.config import ModelConfig
from lmrs_tpu_torch.ops.attention import attention
from lmrs_tpu_torch.ops.flash_attention import flash_attention
from lmrs_tpu_torch.ops.moe import moe_mlp
from lmrs_tpu_torch.ops.norms import rms_norm
from lmrs_tpu_torch.ops.paged_attention import (paged_decode_fused,
                                                paged_decode_multi,
                                                ragged_spans)
from lmrs_tpu_torch.ops.quant import (is_quantized, kv_quant_tokens,
                                      kv_scale_from, qmatmul, quantize_layer,
                                      quantize_weight, segment_scales)
from lmrs_tpu_torch.ops.rope import apply_rope, rope_table

Params = dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def layer_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One layer's leaves and their shapes, in draw order.  A dense layer's
    FFN is ``w_gate_up [D, 2F]``, ``w_down [F, D]``; a mixture-of-experts
    layer's is ``router [D, E]``, ``w_gate_up [E, D, 2F]``, ``w_down
    [E, F, D]``."""
    hd, D, F_ = cfg.hd, cfg.dim, cfg.hidden_dim
    shapes = {"ln_attn": (D,), "ln_mlp": (D,),
              "wqkv": (D, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
              "wo": (cfg.n_heads * hd, D)}
    if cfg.n_experts:
        E = cfg.n_experts
        shapes.update(router=(D, E), w_gate_up=(E, D, 2 * F_),
                      w_down=(E, F_, D))
    else:
        shapes.update(w_gate_up=(D, 2 * F_), w_down=(F_, D))
    return shapes


def top_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The leaves outside the layers and their shapes."""
    shapes = {"embed": (cfg.vocab_size, cfg.dim), "final_norm": (cfg.dim,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.dim, cfg.vocab_size)
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: torch.dtype | None = None,
                quantize: str | None = None) -> Params:
    """Random-init params on ``device``: truncated normal in [-2, 2] over
    sqrt(fan_in), drawn in f32 from one ``torch.Generator`` and cast; norm
    scales zero (the (1 + scale) convention makes that the identity).
    Built layer by layer so only one layer's f32 draw is alive at a time;
    an expert stack is drawn one expert at a time.  ``quantize="int8"``
    quantizes each layer's projections (and the untied head) right after
    their cast draw, so the full-precision tree never exists and the int8
    values are those of ``quantize_params(init_params(...))``."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}; supported: int8")
    dt = dtype or model_dtype(cfg)
    device = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def tn(shape, fan_in):
        if len(shape) == 3:  # an expert stack, one expert at a time
            w = torch.empty(shape, dtype=dt, device=device)
            for i in range(shape[0]):
                w[i] = tn(shape[1:], fan_in)
            return w
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w / math.sqrt(fan_in)).to(dt)

    layers = []
    for _ in range(cfg.n_layers):
        lp = {}
        for name, shape in layer_shapes(cfg).items():
            if name.startswith("ln_"):
                lp[name] = torch.zeros(shape, dtype=dt, device=device)
            else:
                lp[name] = tn(shape, shape[-2])
        layers.append(quantize_layer(lp) if quantize else lp)
    params: Params = {
        "embed": tn((cfg.vocab_size, cfg.dim), cfg.dim),
        "layers": layers,
        "final_norm": torch.zeros(cfg.dim, dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        head = tn((cfg.dim, cfg.vocab_size), cfg.dim)
        params["lm_head"] = quantize_weight(head) if quantize else head
    return params


def param_count(params: Params) -> int:
    """Every parameter, each expert of each layer included."""
    def numel(t):
        return t["q"].numel() if is_quantized(t) else t.numel()

    n = sum(numel(t) for k, t in params.items() if k != "layers")
    return n + sum(numel(t) for lp in params["layers"] for t in lp.values())


def gate_act(cfg: ModelConfig, gate: torch.Tensor) -> torch.Tensor:
    """Gated-FFN activation in f32: SiLU (Llama) or tanh-GELU (Gemma)."""
    gf = gate.float()
    if cfg.activation == "gelu":
        return F.gelu(gf, approximate="tanh")
    if cfg.activation == "silu":
        return F.silu(gf)
    raise ValueError(f"unknown activation {cfg.activation!r}; silu|gelu")


def lm_head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + output projection to f32 logits (+ optional softcap)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = qmatmul(x, w).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def embed_tokens(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (+ Gemma's sqrt(dim) scale)."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = (x.float() * math.sqrt(cfg.dim)).to(x.dtype)
    return x


def qkv_proj(lp: dict, cfg: ModelConfig, h: torch.Tensor):
    """Project a normed [B, S, D] into (q [B, S, H, hd], k, v [B, S, K, hd])
    through the fused ``wqkv``."""
    b, s = h.shape[:2]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qkv = qmatmul(h, lp["wqkv"])
    return (qkv[..., : H * hd].view(b, s, H, hd),
            qkv[..., H * hd: (H + K) * hd].view(b, s, K, hd),
            qkv[..., (H + K) * hd:].view(b, s, K, hd))


def ffn_block(lp: dict, cfg: ModelConfig, h: torch.Tensor):
    """Post-norm FFN body, dense gated or MoE: h [B, S, D] (normed) ->
    (out [B, S, D], aux: the MoE load-balance loss as an f32 scalar, None
    dense, so a dense layer launches nothing for it)."""
    if cfg.n_experts:
        return moe_mlp(lp, cfg, h)
    gate, up = qmatmul(h, lp["w_gate_up"]).chunk(2, dim=-1)
    return qmatmul(gate_act(cfg, gate).to(h.dtype) * up, lp["w_down"]), None


def decoder_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, sin: torch.Tensor,
                  cos: torch.Tensor, kv_length: torch.Tensor | None = None,
                  cache_kv: tuple | None = None):
    """One decoder block (pre-norm attention + FFN): causal attention over
    the sequence, ``kv_length`` [B] masking padded keys; with ``cache_kv``
    (this layer's dense K and V [B, S_max, K, hd]) the block's K/V are
    written into it at ``positions`` and attention reads it.  Returns (x,
    aux)."""
    b, s = x.shape[:2]
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = qkv_proj(lp, cfg, h)
    q = apply_rope(q, positions, sin, cos)
    k = apply_rope(k, positions, sin, cos)
    if cache_kv is not None:
        rows = torch.arange(b, device=x.device)[:, None]
        cache_kv[0][rows, positions] = k
        cache_kv[1][rows, positions] = v
        k, v = cache_kv
    attn = attention(q, k, v, positions, kv_length)
    x = x + qmatmul(attn.reshape(b, s, cfg.n_heads * cfg.hd), lp["wo"])
    ff, aux = ffn_block(lp, cfg, rms_norm(x, lp["ln_mlp"], cfg.norm_eps))
    return x + ff, aux


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
                  dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """Dense per-row KV cache ``{"k", "v"}`` [L, B, max_len, K, hd] (the
    static engine's; the continuous engine's is ``engine/kv_cache``)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dt = dtype or model_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,     # [B, S] int
    positions: torch.Tensor,  # [B, S] absolute positions
    cache: dict[str, torch.Tensor] | None = None,  # dense KV cache or None
    kv_length: torch.Tensor | None = None,  # [B] valid KV AFTER this call
    attn_fn=None,
    return_aux: bool = False,  # also return the layer-mean MoE aux loss
    remat: bool = False,  # recompute each layer in the backward pass
    last_pos: torch.Tensor | None = None,  # [B] LM head on this row only
) -> tuple:
    """Forward pass; returns (logits [B, S, V] f32, cache), plus the
    layer-mean MoE load-balance loss as a third element when
    ``return_aux``.  ``last_pos`` runs the LM head only on row b's token
    ``last_pos[b]`` (logits [B, 1, V]), as ``forward_paged`` does.

    With a cache: K/V of ``tokens`` are written into ``cache["k"]`` /
    ``["v"]`` [L, B, S_max, K, hd] at ``positions`` (in place; the same
    dict comes back) and attention reads the cache, masked causally and by
    ``kv_length`` (prefill S > 1 and decode S == 1 alike).  Without one:
    plain causal self-attention over the sequence, differentiable, each
    layer recomputed in backward under ``remat``.  ``attn_fn`` (ring
    attention over a sequence-sharded mesh) is refused: it arrives with
    the multi-GPU slice."""
    if attn_fn is not None:
        raise ValueError("attn_fn (ring attention) is not in the port yet; "
                         "it arrives with the multi-GPU (A8) slice")
    b, s = tokens.shape
    dev = tokens.device
    x = embed_tokens(params, cfg, tokens)
    positions = positions.long()
    max_pos = cache["k"].shape[2] if cache is not None else s
    sin, cos = rope_table(max_pos, cfg.hd, cfg.rope_theta, device=dev)
    aux = None
    if cache is not None:
        for li, lp in enumerate(params["layers"]):
            x, _ = decoder_layer(lp, cfg, x, positions, sin, cos, kv_length,
                                 (cache["k"][li], cache["v"][li]))
    else:
        def one_layer(lp, x):
            return decoder_layer(lp, cfg, x, positions, sin, cos, kv_length)

        for lp in params["layers"]:
            if remat:
                # keep only each layer's input; recompute the rest in
                # backward (activation memory O(L * [B, S, D]))
                x, layer_aux = torch.utils.checkpoint.checkpoint(
                    one_layer, lp, x, use_reentrant=False)
            else:
                x, layer_aux = one_layer(lp, x)
            if layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
        if aux is not None:
            aux = aux / cfg.n_layers
    if last_pos is not None:
        idx = torch.clamp(last_pos.long().to(dev), 0, s - 1)
        x = x[torch.arange(b, device=dev), idx][:, None]
    logits = lm_head(params, cfg, x)
    if return_aux:
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=dev)
        return logits, cache, aux
    return logits, cache


def forward_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,       # [B, S] int
    positions: torch.Tensor,    # [B, S] absolute positions
    k_pages: torch.Tensor,      # [L*P, K, ps, hd] (updated in place)
    v_pages: torch.Tensor,      # [L*P, K, ps, hd] (updated in place)
    page_tables: torch.Tensor,  # [B, W] LOGICAL page ids (< P)
    kv_lens: torch.Tensor,      # [B] valid tokens AFTER this call's writes
    rope_max: int,
    token_pages: torch.Tensor | None = None,     # [B, S] packed: per-token page
    segment_ids: torch.Tensor | None = None,     # [B, S] packed segments (pad -1)
    packed_last_idx: torch.Tensor | None = None,  # [N] rows to sample (packed)
    last_pos: torch.Tensor | None = None,        # [B] per-row sampled index
    spans: tuple | None = None,  # (q_starts [B], q_lens [B], row_flat [Tp])
    multi_decode: bool = False,  # speculative verify: T tokens per row
    kv_scales: tuple | None = None,  # int8 pools: (k [L, Bs, K, hd], v) f32
    scale_rows: torch.Tensor | None = None,  # [n] slot of each dispatch row
    span_anc: torch.Tensor | None = None,  # [Tp] int32 ancestor bitmasks
) -> torch.Tensor:
    """Forward pass against the paged pool; returns f32 logits — [B, S, V],
    or [B, N, V] with ``packed_last_idx`` / [B, 1, V] with ``last_pos``
    (the LM head runs only on the sampled rows).

    S == 1 is decode: ``kv_lens`` includes the token, whose K/V lands at
    position ``kv_lens - 1`` (= ``positions``).  S > 1 is fresh prefill:
    the tokens are the whole context (row i at position i), written at
    (page_tables[b, pos // ps], pos % ps) — or at ``token_pages`` for a
    PACKED row holding several prompts, whose ``positions`` restart per
    segment and whose attention is same-segment causal; ``kv_lens`` then
    holds the total packed length.

    SPAN mode (``spans``): ``tokens`` is ONE flat [1, Tp] row holding every
    table row's query span (row b's span at ``q_starts[b]``, ``q_lens[b]``
    tokens), ``positions`` their absolute positions, and ``kv_lens`` the
    context BEFORE this dispatch: span token j of row b sits at
    ``kv_lens[b] + j``.  ``row_flat`` is the caller's owner map of the
    flat tokens (the kernel derives ownership from the spans itself).
    Gather the sampled rows with ``packed_last_idx``.  ``span_anc`` turns
    the spans into token TREES (tree speculation): a flat token with a
    nonzero word attends the context plus the span offsets its bits name
    (``ragged_spans``' contract).  ``positions`` stay the caller's — tree
    nodes take depth-based rope positions while their K/V land at their
    span-offset columns.

    MULTI-TOKEN mode (``multi_decode``): each row's S tokens sit at
    consecutive positions ``kv_lens - S + j``, where ``kv_lens`` counts the
    S tokens and is NOT clamped (the write base must be the true position;
    tokens at or past ``rope_max`` are neither written nor attended).  The
    LM head runs on all S rows.

    INT8 pools (``kv_scales``): the scale buffers' slot ``scale_rows[i]``
    belongs to dispatch row i (packed: to SEGMENT i); None = the identity
    (rows are slots: spans, decode, verify).  A prompt's first tokens fix
    its slot's scales, written into the buffers in place: a fresh prefill
    from its valid tokens, a packed one per segment from the segment's own
    tokens, a span row with ``kv_lens == 0`` from its span's tokens; every
    other row quantizes with (and clamps to) its slot's frozen scales.
    Fresh and packed prefill attend their ORIGINAL K/V and store the
    quantized rows; every pool reader dequantizes."""
    dev = tokens.device
    b, s = tokens.shape
    hd, H = cfg.hd, cfg.n_heads
    ps = k_pages.shape[2]
    n_pool = k_pages.shape[0] // cfg.n_layers  # logical pages per layer
    if kv_scales is not None:
        ksc_all, vsc_all = kv_scales
        rows_i = (torch.arange(page_tables.shape[0], device=dev)
                  if scale_rows is None else scale_rows.long().to(dev))
    x = embed_tokens(params, cfg, tokens)
    sin, cos = rope_table(rope_max, hd, cfg.rope_theta, device=dev)
    positions = positions.long()
    tables = page_tables.long()
    kv_lens = kv_lens.to(dev)
    is_decode = s == 1 and spans is None and not multi_decode
    if spans is not None:
        span_starts, span_lens, _row_flat = spans
    elif not (is_decode or multi_decode):
        if token_pages is not None:
            page_idx = token_pages.long()
        else:
            col = torch.clamp(positions // ps, 0, tables.shape[1] - 1)
            page_idx = torch.gather(tables, 1, col)
        offsets = positions % ps

    for li, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q, k, v = qkv_proj(lp, cfg, h)
        q = apply_rope(q, positions, sin, cos)
        k = apply_rope(k, positions, sin, cos)
        base = li * n_pool
        ks = vs = None  # this dispatch's per-row scales (int8 pools)
        if kv_scales is not None:
            ks, vs = _layer_scales(ksc_all[li], vsc_all[li], k, v, rows_i,
                                   kv_lens, spans, segment_ids,
                                   fresh=not (is_decode or multi_decode))
        if spans is not None:
            attn = ragged_spans(
                q[0].contiguous(), k[0].contiguous(), v[0].contiguous(),
                k_pages, v_pages, tables + base, kv_lens, span_starts,
                span_lens, max_pos=rope_max, kscale=ks, vscale=vs,
                anc_masks=span_anc)[None]
        elif multi_decode:
            attn = paged_decode_multi(
                q.contiguous(), k.contiguous(), v.contiguous(), k_pages,
                v_pages, tables + base, kv_lens, max_pos=rope_max,
                kscale=ks, vscale=vs)
        elif is_decode:
            attn = paged_decode_fused(
                q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
                k_pages, v_pages, tables + base, kv_lens, kscale=ks,
                vscale=vs)[:, None]
        else:
            g_pages = page_idx + base
            k_store, v_store = k, v.contiguous()
            if ks is not None:  # quantized rows into the pool
                k_store = kv_quant_tokens(k, ks)
                v_store = kv_quant_tokens(v, vs)
            k_pages[g_pages, :, offsets] = k_store
            v_pages[g_pages, :, offsets] = v_store
            # the current tokens are the whole context: attend them as
            # computed, never their quantized copies
            attn = flash_attention(q, k, v, kv_lens, segment_ids)
        x = x + qmatmul(attn.reshape(b, s, H * hd), lp["wo"])
        x = x + ffn_block(lp, cfg, rms_norm(x, lp["ln_mlp"], cfg.norm_eps))[0]

    if packed_last_idx is not None:
        x = x[:, packed_last_idx.long()]
    elif last_pos is not None:
        idx = torch.clamp(last_pos.long().to(dev), 0, s - 1)
        x = x[torch.arange(b, device=dev), idx][:, None]
    return lm_head(params, cfg, x)


def _layer_scales(ksc, vsc, k, v, rows_i, kv_lens, spans, segment_ids,
                  fresh: bool):
    """One layer's int8 scales for this dispatch (the reference's scale
    ownership, ``transformer.py:474-577``).  ``ksc``/``vsc`` [Bs, K, hd] are
    the layer's slices of the scale buffers, updated in place where a row
    owns its slot's scales.  Returns the scales the kernels and the pool
    scatter quantize with: per dispatch row [n, K, hd] for spans, decode
    and verify; broadcastable per token for fresh [B, 1, K, hd] and packed
    [1, S, K, hd] (each token its segment's) prefill."""
    if spans is not None:
        # a span row whose base is 0 holds its prompt's first tokens and
        # owns its slot's scales, from its own span tokens; the rest reuse
        nb = spans[0].shape[0]
        seg = torch.clamp(spans[2].long(), 0, nb)  # out-of-span: dropped
        own = ((kv_lens == 0) & (spans[1] > 0))[:, None, None]
        s_k = torch.where(own, segment_scales(k[0], seg, nb), ksc[rows_i])
        s_v = torch.where(own, segment_scales(v[0], seg, nb), vsc[rows_i])
        ksc[rows_i], vsc[rows_i] = s_k, s_v
        return s_k, s_v
    if segment_ids is not None:
        # packed prefill: one scale row per segment, from its tokens only
        n_seg = rows_i.shape[0]
        seg = segment_ids[0].long()
        seg = torch.where(seg >= 0, seg, torch.full_like(seg, n_seg))
        s_k = segment_scales(k[0], seg, n_seg)
        s_v = segment_scales(v[0], seg, n_seg)
        ksc[rows_i], vsc[rows_i] = s_k, s_v
        gi = torch.clamp(seg, 0, n_seg - 1)
        return s_k[gi][None], s_v[gi][None]
    if fresh:
        # a fresh prefill's rows own their slots' scales
        valid = (torch.arange(k.shape[1], device=k.device)[None, :]
                 < kv_lens.to(k.device)[:, None])
        s_k, s_v = kv_scale_from(k, valid), kv_scale_from(v, valid)
        ksc[rows_i], vsc[rows_i] = s_k, s_v
        return s_k[:, None], s_v[:, None]
    return ksc[rows_i], vsc[rows_i]  # decode / verify: frozen scales
