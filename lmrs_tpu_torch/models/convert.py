"""Weight bridge: the reference package's stacked ``[L, ...]`` param tree
(as numpy arrays) <-> the port's params (``models/transformer.py``).

The norm scales keep their meaning: both packages compute
``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, so a scale leaf is copied
as is (zero-init = identity), never rebased to ``1 + scale``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from lmrs_tpu_torch.config import ModelConfig
from lmrs_tpu_torch.models.transformer import Params


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
    [L, F, D], embed [V, D], optional lm_head [D, V]) into port params on
    ``device``.  ``dtype`` None keeps each leaf's dtype."""
    if "moe" in tree["layers"]:
        raise ValueError("mixture-of-experts weights are not ported yet")
    device = torch.device("cpu" if device is None else device)
    lt = tree["layers"]
    D, hd = cfg.dim, cfg.hd

    def leaf(a, li):
        return np.asarray(a)[li]

    layers = []
    for li in range(cfg.n_layers):
        wq = leaf(lt["attn"]["wq"], li).reshape(D, cfg.n_heads * hd)
        wk = leaf(lt["attn"]["wk"], li).reshape(D, cfg.n_kv_heads * hd)
        wv = leaf(lt["attn"]["wv"], li).reshape(D, cfg.n_kv_heads * hd)
        layers.append({
            "ln_attn": _tensor(leaf(lt["ln_attn"]["scale"], li), device, dtype),
            "ln_mlp": _tensor(leaf(lt["ln_mlp"]["scale"], li), device, dtype),
            "wqkv": _tensor(np.concatenate([wq, wk, wv], axis=1), device, dtype),
            "wo": _tensor(leaf(lt["attn"]["wo"], li).reshape(cfg.n_heads * hd, D),
                          device, dtype),
            "w_gate_up": _tensor(np.concatenate(
                [leaf(lt["mlp"]["w_gate"], li), leaf(lt["mlp"]["w_up"], li)],
                axis=1), device, dtype),
            "w_down": _tensor(leaf(lt["mlp"]["w_down"], li), device, dtype),
        })
    params: Params = {
        "embed": _tensor(tree["embed"]["weight"], device, dtype),
        "layers": layers,
        "final_norm": _tensor(tree["final_norm"]["scale"], device, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(tree["lm_head"]["weight"], device, dtype)
    return params


def params_to_jax(params: Params, cfg: ModelConfig) -> dict:
    """Inverse of ``params_from_jax``: numpy tree in the reference layout
    (bf16 leaves come back as float32, which holds every bf16 value)."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    D, hd, H, K = cfg.dim, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    per = {name: [] for name in ("ln_attn", "ln_mlp", "wq", "wk", "wv", "wo",
                                 "w_gate", "w_up", "w_down")}
    for lp in params["layers"]:
        qkv = arr(lp["wqkv"])
        per["wq"].append(qkv[:, : H * hd].reshape(D, H, hd))
        per["wk"].append(qkv[:, H * hd:(H + K) * hd].reshape(D, K, hd))
        per["wv"].append(qkv[:, (H + K) * hd:].reshape(D, K, hd))
        per["wo"].append(arr(lp["wo"]).reshape(H, hd, D))
        gu = arr(lp["w_gate_up"])
        per["w_gate"].append(gu[:, : cfg.hidden_dim])
        per["w_up"].append(gu[:, cfg.hidden_dim:])
        per["w_down"].append(arr(lp["w_down"]))
        per["ln_attn"].append(arr(lp["ln_attn"]))
        per["ln_mlp"].append(arr(lp["ln_mlp"]))
    st = {k: np.stack(v) for k, v in per.items()}
    tree = {
        "embed": {"weight": arr(params["embed"])},
        "layers": {
            "ln_attn": {"scale": st["ln_attn"]},
            "ln_mlp": {"scale": st["ln_mlp"]},
            "attn": {"wq": st["wq"], "wk": st["wk"], "wv": st["wv"],
                     "wo": st["wo"]},
            "mlp": {"w_gate": st["w_gate"], "w_up": st["w_up"],
                    "w_down": st["w_down"]},
        },
        "final_norm": {"scale": arr(params["final_norm"])},
    }
    if "lm_head" in params:
        tree["lm_head"] = {"weight": arr(params["lm_head"])}
    return tree
