"""Port parity, model: the weight bridge round-trips every leaf, and the
port's ``forward_paged`` matches the JAX package's ``forward_paged`` — f32
logits (atol 1e-4) and pool contents (atol 1e-5) — on the fresh, packed
and decode routes, for a Llama-style and a Gemma-style config (hd=64)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.models.transformer import forward_paged as j_forward_paged
from lmrs_tpu.models.transformer import init_params as j_init_params
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.models.convert import params_from_jax, params_to_jax
from lmrs_tpu_torch.models.transformer import forward_paged as t_forward_paged

BASE = dict(vocab_size=300, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
            hidden_dim=160, max_seq_len=128, dtype="float32")
VARIANTS = {
    "llama": dict(tie_embeddings=False),
    "gemma": dict(tie_embeddings=True, logit_softcap=30.0, embed_scale=True,
                  activation="gelu", norm_eps=1e-6, rope_theta=10000.0),
}
PS, N_POOL = 16, 8


def _cfgs(variant, dtype="float32"):
    kw = {**BASE, **VARIANTS[variant], "dtype": dtype}
    return JModelConfig(name=variant, **kw), TModelConfig(name=variant, **kw)


def _tree(jcfg, seed=0):
    """JAX init_params as numpy, with the zero-init norm scales randomized so
    the (1 + scale) meaning is exercised."""
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(seed)))
    r = np.random.default_rng(seed)
    if jcfg.dtype == "float32":
        for name in ("ln_attn", "ln_mlp"):
            s = tree["layers"][name]["scale"]
            tree["layers"][name]["scale"] = (0.1 * r.standard_normal(s.shape)).astype(s.dtype)
        tree["final_norm"]["scale"] = (0.1 * r.standard_normal(jcfg.dim)).astype(np.float32)
    return tree


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(variant, dtype):
    jcfg, tcfg = _cfgs(variant, dtype)
    tree = _tree(jcfg)
    params = params_from_jax(tree, tcfg)
    assert params["embed"].dtype == getattr(torch, dtype)
    back = params_to_jax(params, tcfg)
    flat, treedef = jax.tree.flatten(tree)
    flat_back, treedef_back = jax.tree.flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def _pools(seed, jcfg):
    r = np.random.default_rng(seed)
    shape = (jcfg.n_layers * N_POOL, jcfg.n_kv_heads, PS, jcfg.hd)
    return (r.standard_normal(shape).astype(np.float32),
            r.standard_normal(shape).astype(np.float32))


def _route_inputs(route, seed):
    r = np.random.default_rng(seed)
    if route == "fresh":
        n = 20
        return dict(tokens=r.integers(3, 300, (1, n)), positions=np.arange(n)[None],
                    page_tables=np.array([[3, 5]]), kv_lens=np.array([n]),
                    last_pos=np.array([n - 1]))
    if route == "packed":
        lens = [12, 18]
        pages = [[2], [4, 6]]
        return dict(
            tokens=r.integers(3, 300, (1, sum(lens))),
            positions=np.concatenate([np.arange(n) for n in lens])[None],
            page_tables=np.zeros((1, 1), np.int64),
            kv_lens=np.array([sum(lens)]),
            token_pages=np.concatenate([np.asarray(p)[np.arange(n) // PS]
                                        for p, n in zip(pages, lens)])[None],
            segment_ids=np.concatenate([np.full(n, i) for i, n in enumerate(lens)])[None],
            packed_last_idx=np.cumsum(lens) - 1)
    lens = np.array([5, 17, 33])
    return dict(tokens=r.integers(3, 300, (3, 1)), positions=(lens - 1)[:, None],
                page_tables=np.array([[1, 0, 0], [2, 3, 0], [4, 5, 6]]),
                kv_lens=lens)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("route", ["fresh", "packed", "decode"])
def test_forward_paged_matches_jax(variant, route):
    jcfg, tcfg = _cfgs(variant)
    tree = _tree(jcfg, seed=1)
    kp, vp = _pools(2, jcfg)
    x = _route_inputs(route, 3)
    ints = {k: v.astype(np.int32) for k, v in x.items()}
    j_logits, j_kp, j_vp = j_forward_paged(
        jax.tree.map(jnp.asarray, tree), jcfg, ints["tokens"], ints["positions"],
        jnp.asarray(kp), jnp.asarray(vp), ints["page_tables"], ints["kv_lens"],
        jcfg.max_seq_len, **{k: jnp.asarray(ints[k]) for k in
                             ("token_pages", "segment_ids", "packed_last_idx",
                              "last_pos") if k in ints})
    t_kp, t_vp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t_logits = t_forward_paged(
        params_from_jax(tree, tcfg), tcfg,
        torch.from_numpy(x["tokens"]), torch.from_numpy(x["positions"]), t_kp, t_vp,
        torch.from_numpy(x["page_tables"]), torch.from_numpy(ints["kv_lens"]),
        tcfg.max_seq_len, **{k: torch.from_numpy(x[k]) for k in
                             ("token_pages", "segment_ids", "packed_last_idx",
                              "last_pos") if k in x})
    assert t_logits.shape == j_logits.shape
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4)
    np.testing.assert_allclose(t_kp.numpy(), np.asarray(j_kp), atol=1e-5)
    np.testing.assert_allclose(t_vp.numpy(), np.asarray(j_vp), atol=1e-5)


def test_config_presets_match_reference():
    """The port's presets carry the reference's widths for the slice's
    models."""
    from lmrs_tpu.config import model_preset as j_preset
    from lmrs_tpu_torch.config import model_preset as t_preset

    for name in ("bench-8b", "bench-smoke", "gemma-2b", "gemma-7b",
                 "quality-tiny", "tiny"):
        j = dataclasses.asdict(j_preset(name))
        t = dataclasses.asdict(t_preset(name))
        assert {k: j[k] for k in t} == t
