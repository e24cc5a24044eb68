"""Weights from local files (the port of the reference's
``models/loader.py``).

* ``convert_hf_llama`` / ``convert_hf_gemma``: a local HuggingFace
  checkpoint (``*.safetensors`` shards; Llama, Gemma or Mixtral names)
  into the port's layout — fused ``wqkv`` [D, (H + 2K)·hd] and
  ``w_gate_up`` [D, 2F] (experts: [E, D, 2F]), every matrix ``[in, out]``,
  norm scales ``w - norm_offset`` (the port multiplies by ``1 + scale``).
  ``hf_params`` is the same conversion with the layers as a generator, so
  a converter never holds more than one layer.
* ``save_checkpoint`` / ``load_checkpoint``: the port's native checkpoint,
  where the reference uses Orbax (which needs JAX): a directory of
  safetensors shards in the port's own layout, ``model.safetensors``
  (embed, final norm, untied head) and one ``layer_NNNNN.safetensors`` per
  layer; a quantized leaf is stored as ``<name>.q`` and ``<name>.s``.
  ``load_checkpoint`` streams one layer at a time onto the device and, with
  ``quantize="int8"``, quantizes each layer as it lands, so a checkpoint
  whose full-precision tree would not fit the card loads into an int8
  engine.

Files are read by ``utils/safetensors.py``.  A tensor missing from the
files raises ``KeyError`` naming it, one of another shape ``ValueError``
naming it and both shapes; tensors a preset does not use (such as
``rotary_emb.inv_freq``) are never looked up.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Iterator

import torch

from lmrs_tpu_torch.config import ModelConfig
from lmrs_tpu_torch.models.transformer import (Params, layer_shapes,
                                               model_dtype, top_shapes)
from lmrs_tpu_torch.ops.quant import (is_quantized, quantize_layer,
                                      quantize_weight)
from lmrs_tpu_torch.utils.safetensors import SafeFile, save_file

logger = logging.getLogger("lmrs_torch.loader")

FORMAT = "lmrs_tpu_torch"
TOP_FILE = "model.safetensors"


def layer_file(i: int) -> str:
    return f"layer_{i:05d}.safetensors"


# ------------------------------------------------- HF safetensors conversion


class _HFFiles:
    """Every tensor name of a directory's ``*.safetensors`` shards."""

    def __init__(self, src_dir: str):
        files = sorted(Path(src_dir).glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors under {src_dir}")
        self._files = [SafeFile(f) for f in files]
        self._where = {name: f for f in self._files for name in f.keys()}

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def get(self, name: str, shape: tuple[int, ...]) -> torch.Tensor:
        if name not in self._where:
            raise KeyError(f"tensor {name!r} is not in the checkpoint")
        f = self._where[name]
        if f.shape(name) != tuple(shape):
            raise ValueError(f"tensor {name!r} has shape {list(f.shape(name))}; "
                             f"the preset needs {list(shape)}")
        return f.get(name)

    def close(self) -> None:
        for f in self._files:
            f.close()


def _hf_layer(src: _HFFiles, cfg: ModelConfig, i: int, off: float,
              dt: torch.dtype) -> dict:
    D, F_, hd = cfg.dim, cfg.hidden_dim, cfg.hd
    H, K = cfg.n_heads, cfg.n_kv_heads
    p = f"model.layers.{i}"

    def t(name, shape):  # an HF [out, in] matrix as [in, out]
        return src.get(f"{p}.{name}", shape).t()

    lp = {
        "ln_attn": (src.get(f"{p}.input_layernorm.weight", (D,)).float()
                    - off).to(dt),
        "ln_mlp": (src.get(f"{p}.post_attention_layernorm.weight", (D,)).float()
                   - off).to(dt),
        "wqkv": torch.cat([t("self_attn.q_proj.weight", (H * hd, D)),
                           t("self_attn.k_proj.weight", (K * hd, D)),
                           t("self_attn.v_proj.weight", (K * hd, D))], 1).to(dt),
        "wo": t("self_attn.o_proj.weight", (D, H * hd)).to(dt).contiguous(),
    }
    if cfg.n_experts:
        E = cfg.n_experts
        m = "block_sparse_moe"
        lp["router"] = t(f"{m}.gate.weight", (E, D)).to(dt).contiguous()
        gate_up = torch.empty((E, D, 2 * F_), dtype=dt)
        down = torch.empty((E, F_, D), dtype=dt)
        for j in range(E):
            ex = f"{m}.experts.{j}"
            gate_up[j, :, :F_] = t(f"{ex}.w1.weight", (F_, D))
            gate_up[j, :, F_:] = t(f"{ex}.w3.weight", (F_, D))
            down[j] = t(f"{ex}.w2.weight", (D, F_))
        lp["w_gate_up"], lp["w_down"] = gate_up, down
    else:
        lp["w_gate_up"] = torch.cat([t("mlp.gate_proj.weight", (F_, D)),
                                     t("mlp.up_proj.weight", (F_, D))], 1).to(dt)
        lp["w_down"] = t("mlp.down_proj.weight", (D, F_)).to(dt).contiguous()
    return lp


def hf_params(src_dir: str, cfg: ModelConfig, *,
              norm_offset: float = 1.0) -> Params:
    """The HF checkpoint in ``src_dir`` as port params on the CPU, in the
    model's dtype (float32 for a float32 preset, else bfloat16, as the
    reference converts), with ``"layers"`` a GENERATOR that converts one
    layer at a time (and closes the files after the last)."""
    src = _HFFiles(src_dir)
    try:
        dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
        D, V = cfg.dim, cfg.vocab_size
        embed = src.get("model.embed_tokens.weight", (V, D)).to(dt)
        top: Params = {
            "embed": embed,
            "final_norm": (src.get("model.norm.weight", (D,)).float()
                           - norm_offset).to(dt),
        }
        if not cfg.tie_embeddings:
            name = ("lm_head.weight" if "lm_head.weight" in src
                    else "model.embed_tokens.weight")
            top["lm_head"] = src.get(name, (V, D)).t().to(dt).contiguous()
    except BaseException:
        src.close()
        raise

    def layers() -> Iterator[dict]:
        try:
            for i in range(cfg.n_layers):
                yield _hf_layer(src, cfg, i, norm_offset, dt)
        finally:
            src.close()

    top["layers"] = layers()
    return top


def convert_hf_llama(src_dir: str, cfg: ModelConfig, *,
                     norm_offset: float = 1.0) -> Params:
    """Convert a local HF Llama-style (or Mixtral, for ``cfg.n_experts``)
    checkpoint into port params on the CPU.  HF per-layer names map to:

        self_attn.{q,k,v}_proj.weight            -> wqkv (fused, [in, out])
        self_attn.o_proj.weight                  -> wo
        mlp.{gate,up}_proj.weight                -> w_gate_up (fused)
        mlp.down_proj.weight                     -> w_down
        block_sparse_moe.gate.weight             -> router [D, E]
        block_sparse_moe.experts.{j}.w1/w3       -> w_gate_up[j] (gate, up)
        block_sparse_moe.experts.{j}.w2          -> w_down[j]
        (input|post_attention)_layernorm.weight  -> ln_attn / ln_mlp (w - offset)

    plus ``model.embed_tokens.weight``, ``model.norm.weight`` and (untied)
    ``lm_head.weight`` [D, V] (the embedding when the file has no head, as
    the reference does).  ``norm_offset``: HF Llama multiplies by ``w``
    (offset 1.0 -> scale = w - 1), HF Gemma already by ``1 + w`` (0.0)."""
    params = hf_params(src_dir, cfg, norm_offset=norm_offset)
    params["layers"] = list(params["layers"])
    logger.info("converted HF checkpoint %s (%d layers)", src_dir,
                cfg.n_layers)
    return params


def convert_hf_gemma(src_dir: str, cfg: ModelConfig) -> Params:
    """Convert a local HF Gemma checkpoint: HF GemmaRMSNorm already
    multiplies by ``1 + w`` (offset 0.0), and the head is tied to the
    embedding (an untied ``cfg`` is refused)."""
    if not cfg.tie_embeddings:
        raise ValueError("Gemma checkpoints tie lm_head to the embedding")
    return convert_hf_llama(src_dir, cfg, norm_offset=0.0)


# ------------------------------------------------------- native checkpoint


def _flat(leaves: dict) -> dict[str, torch.Tensor]:
    out = {}
    for name, t in leaves.items():
        if is_quantized(t):
            out[name + ".q"], out[name + ".s"] = t["q"], t["s"]
        else:
            out[name] = t
    return out


def save_checkpoint(path: str, params: Params) -> int:
    """Write ``params`` (any device; ``params["layers"]`` may be any
    iterable, consumed one layer at a time) as a native checkpoint
    directory; returns the bytes written."""
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    n_bytes, n_layers = 0, 0
    for i, lp in enumerate(params["layers"]):
        n_bytes += save_file(_flat(lp), root / layer_file(i),
                             {"format": FORMAT, "layer": str(i)})
        n_layers = i + 1
    top = {k: v for k, v in params.items() if k != "layers"}
    n_bytes += save_file(_flat(top), root / TOP_FILE,
                         {"format": FORMAT, "layers": str(n_layers)})
    logger.info("saved checkpoint to %s (%d layers, %.1f MiB)", path,
                n_layers, n_bytes / 2**20)
    return n_bytes


def _load_leaves(f: SafeFile, shapes: dict, device, dt) -> dict:
    """Leaves ``shapes`` from ``f``: a plain leaf cast to ``dt``, or a
    quantized one (``.q`` int8 of the leaf's shape, ``.s`` f32 with the
    contracting axis 1)."""
    out = {}
    for name, shape in shapes.items():
        if name + ".q" in f.keys():
            s_shape = shape[:-2] + (1, shape[-1])
            for part, want in ((".q", shape), (".s", s_shape)):
                if f.shape(name + part) != want:
                    raise ValueError(
                        f"tensor {name + part!r} in {f.path} has shape "
                        f"{list(f.shape(name + part))}; the preset needs {list(want)}")
            out[name] = {"q": f.get(name + ".q", device),
                         "s": f.get(name + ".s", device)}
            continue
        if name not in f.keys():
            raise KeyError(f"tensor {name!r} is not in {f.path}")
        if f.shape(name) != shape:
            raise ValueError(f"tensor {name!r} in {f.path} has shape "
                             f"{list(f.shape(name))}; the preset needs {list(shape)}")
        out[name] = f.get(name, device).to(dt)
    return out


def load_checkpoint(path: str, cfg: ModelConfig, device=None,
                    quantize: str | None = None) -> Params:
    """Read a native checkpoint onto ``device`` (the CPU by default) in the
    model's dtype, one layer at a time; ``quantize="int8"`` quantizes each
    layer's projections (and the untied head) as it lands."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}; supported: int8")
    root = Path(path)
    if not (root / TOP_FILE).is_file():
        raise FileNotFoundError(f"no checkpoint at {path} (no {TOP_FILE}; "
                                "convert an HF one with lmrs-torch-convert)")
    device = torch.device("cpu" if device is None else device)
    dt = model_dtype(cfg)
    t0 = time.time()
    with SafeFile(root / TOP_FILE) as f:
        if f.metadata.get("format") != FORMAT:
            raise ValueError(f"{f.path} is not a {FORMAT} checkpoint "
                             f"(metadata {f.metadata})")
        n = int(f.metadata.get("layers", -1))
        if n != cfg.n_layers:
            raise ValueError(f"checkpoint {path} has {n} layers; the preset "
                             f"{cfg.name} has {cfg.n_layers}")
        params: Params = _load_leaves(f, top_shapes(cfg), device, dt)
    if quantize and "lm_head" in params and not is_quantized(params["lm_head"]):
        params["lm_head"] = quantize_weight(params["lm_head"])
    layers, shapes = [], layer_shapes(cfg)
    for i in range(cfg.n_layers):
        with SafeFile(root / layer_file(i)) as f:
            lp = _load_leaves(f, shapes, device, dt)
        layers.append(quantize_layer(lp) if quantize else lp)
    params["layers"] = layers
    logger.info("loaded checkpoint %s onto %s in %.1fs%s", path, device,
                time.time() - t0, " (int8)" if quantize else "")
    return params
