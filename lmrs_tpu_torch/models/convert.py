"""Weight bridge: the reference package's stacked ``[L, ...]`` param tree
(as numpy arrays) <-> the port's params (``models/transformer.py``).

The norm scales keep their meaning: both packages compute
``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, so a scale leaf is copied
as is (zero-init = identity), never rebased to ``1 + scale``.

Quantized trees (the reference's ``quantize_params``: each projection a
``{"q": int8, "s": f32}`` leaf with per-output-channel scales) carry
across too: the fused port matrices concatenate the int8 values and the
scales in the same order, and the leaves keep their dtypes whatever
``dtype`` says.

Mixture-of-experts trees carry ``layers.moe`` (router [L, D, E], w_gate /
w_up [L, E, D, F], w_down [L, E, F, D]): the port's layer holds
``router``, ``w_gate_up`` [E, D, 2F] (gate then up along the output axis)
and ``w_down`` [E, F, D]; the router is never quantized.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from lmrs_tpu_torch.config import ModelConfig
from lmrs_tpu_torch.models.transformer import Params
from lmrs_tpu_torch.ops.quant import is_quantized


def _tensor(a: Any, device, dtype: torch.dtype | None) -> torch.Tensor:
    arr = np.array(a)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def params_from_jax(tree: dict, cfg: ModelConfig, device=None,
                    dtype: torch.dtype | None = None) -> Params:
    """Convert the reference tree (``init_params`` layout: wq/wk/wv
    [L, D, H|K, hd], wo [L, H, hd, D], mlp w_gate/w_up [L, D, F], w_down
    [L, F, D], embed [V, D], optional lm_head [D, V]; projections plain or
    quantized) into port params on ``device``.  ``dtype`` None keeps each
    leaf's dtype; quantized leaves always keep int8 values and f32
    scales."""
    device = torch.device("cpu" if device is None else device)
    lt = tree["layers"]
    D = cfg.dim

    def proj(leaves: list, li: int, rows: int, experts: int | None = None):
        """Layer li's matrices as one [rows, out] port matrix (fused
        along the output axis; [E, rows, out] for an expert stack) — or
        one quantized leaf."""
        lead = (rows,) if experts is None else (experts, rows)
        ax = len(lead)
        if is_quantized(leaves[0]):
            q = np.concatenate([np.asarray(a["q"])[li].reshape(*lead, -1)
                                for a in leaves], axis=ax)
            sc = np.concatenate([np.asarray(a["s"])[li].reshape(*lead[:-1], 1, -1)
                                 for a in leaves], axis=ax)
            return {"q": _tensor(q, device, None), "s": _tensor(sc, device, None)}
        w = np.concatenate([np.asarray(a)[li].reshape(*lead, -1)
                            for a in leaves], axis=ax)
        return _tensor(w, device, dtype)

    attn = lt["attn"]
    hq = cfg.n_heads * cfg.hd
    layers = []
    for li in range(cfg.n_layers):
        lp = {
            "ln_attn": _tensor(np.asarray(lt["ln_attn"]["scale"])[li], device, dtype),
            "ln_mlp": _tensor(np.asarray(lt["ln_mlp"]["scale"])[li], device, dtype),
            "wqkv": proj([attn["wq"], attn["wk"], attn["wv"]], li, D),
            "wo": proj([attn["wo"]], li, hq),
        }
        if "moe" in lt:
            moe, E = lt["moe"], cfg.n_experts
            lp["router"] = _tensor(np.asarray(moe["router"])[li], device, dtype)
            lp["w_gate_up"] = proj([moe["w_gate"], moe["w_up"]], li, D, E)
            lp["w_down"] = proj([moe["w_down"]], li, cfg.hidden_dim, E)
        else:
            mlp = lt["mlp"]
            lp["w_gate_up"] = proj([mlp["w_gate"], mlp["w_up"]], li, D)
            lp["w_down"] = proj([mlp["w_down"]], li, cfg.hidden_dim)
        layers.append(lp)
    params: Params = {
        "embed": _tensor(tree["embed"]["weight"], device, dtype),
        "layers": layers,
        "final_norm": _tensor(tree["final_norm"]["scale"], device, dtype),
    }
    if not cfg.tie_embeddings:
        head = tree["lm_head"]["weight"]
        params["lm_head"] = (
            {"q": _tensor(head["q"], device, None),
             "s": _tensor(head["s"], device, None)}
            if is_quantized(head) else _tensor(head, device, dtype))
    return params


def params_to_jax(params: Params, cfg: ModelConfig) -> dict:
    """Inverse of ``params_from_jax``: numpy tree in the reference layout
    (bf16 leaves come back as float32, which holds every bf16 value;
    quantized leaves come back as ``{"q", "s"}`` in the reference's
    shapes, ``s`` with size-1 contracting axes)."""
    def arr(t: torch.Tensor) -> np.ndarray:
        # the bridge's output is host numpy by design: one copy a leaf
        t = t.detach().cpu()  # lint: ignore[tracing.host-sync-in-step]
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()  # lint: ignore[tracing.host-sync-in-step]

    def split(w, widths, shapes, n_contract=1, n_lead=0):
        """Cut a port matrix along its output axis into the reference's
        leaves of ``shapes`` (after ``n_lead`` expert axes, the next
        ``n_contract`` axes contract)."""
        cuts = np.cumsum(widths)[:-1]
        ax = n_lead + 1
        # a type test (a dict or a tensor): no device value is read
        if not is_quantized(w):  # lint: ignore[tracing.python-branch-on-tensor]
            return [p.reshape(sh) for p, sh in
                    zip(np.split(arr(w), cuts, axis=ax), shapes)]
        qs = np.split(arr(w["q"]), cuts, axis=ax)
        ss = np.split(arr(w["s"]), cuts, axis=ax)
        return [{"q": q.reshape(sh),
                 "s": sc.reshape(tuple(sh[:n_lead]) + (1,) * n_contract
                                 + tuple(sh[n_lead + n_contract:]))}
                for q, sc, sh in zip(qs, ss, shapes)]

    def stack(leaves: list):
        if is_quantized(leaves[0]):
            return {k: np.stack([x[k] for x in leaves]) for k in ("q", "s")}
        return np.stack(leaves)

    D, hd, H, K, F_ = cfg.dim, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.hidden_dim
    moe = bool(cfg.n_experts)
    lead = (cfg.n_experts,) if moe else ()
    per = {name: [] for name in ("ln_attn", "ln_mlp", "wq", "wk", "wv", "wo",
                                 "w_gate", "w_up", "w_down")
           + (("router",) if moe else ())}
    for lp in params["layers"]:
        wq, wk, wv = split(lp["wqkv"], [H * hd, K * hd, K * hd],
                           [(D, H, hd), (D, K, hd), (D, K, hd)])
        per["wq"].append(wq)
        per["wk"].append(wk)
        per["wv"].append(wv)
        per["wo"].append(split(lp["wo"], [D], [(H, hd, D)], n_contract=2)[0])
        gate, up = split(lp["w_gate_up"], [F_, F_],
                         [lead + (D, F_), lead + (D, F_)], n_lead=len(lead))
        per["w_gate"].append(gate)
        per["w_up"].append(up)
        per["w_down"].append(split(lp["w_down"], [D], [lead + (F_, D)],
                                   n_lead=len(lead))[0])
        if moe:
            per["router"].append(arr(lp["router"]))
        per["ln_attn"].append(arr(lp["ln_attn"]))
        per["ln_mlp"].append(arr(lp["ln_mlp"]))
    st = {k: stack(v) for k, v in per.items()}
    tree = {
        "embed": {"weight": arr(params["embed"])},
        "layers": {
            "ln_attn": {"scale": st["ln_attn"]},
            "ln_mlp": {"scale": st["ln_mlp"]},
            "attn": {"wq": st["wq"], "wk": st["wk"], "wv": st["wv"],
                     "wo": st["wo"]},
            ("moe" if moe else "mlp"): {
                "w_gate": st["w_gate"], "w_up": st["w_up"],
                "w_down": st["w_down"],
                **({"router": st["router"]} if moe else {})},
        },
        "final_norm": {"scale": arr(params["final_norm"])},
    }
    if "lm_head" in params:
        V = cfg.vocab_size
        tree["lm_head"] = {"weight": split(params["lm_head"], [V], [(D, V)])[0]}
    return tree
