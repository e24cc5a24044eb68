"""Port parity, mixture-of-experts: ``ops/moe.py`` and the MoE branch of
``forward_paged`` against the JAX package on the same numpy weights.

(a) ``expert_capacity`` equals the reference's on a sweep of call sizes and
    stays within [1, n].
(b) ``moe_mlp`` against ``lmrs_tpu.ops.moe.moe_mlp`` in f32 at the default
    capacity factor (1.25) and a starved one (0.05, most assignments
    dropped), with a random router, a skewed one (every token's first choice
    is expert 0, so it overflows) and a tie (two equal router columns: equal
    probabilities, the lower expert first), plain and int8: outputs atol
    1e-5, rtol 1e-5 (f32 products summed in another order; 1.2e-6 found),
    aux loss rtol 1e-6.
(c) Expert int8 quantization equals the JAX package's, bit for bit, in the
    port's fused layout; the weight bridge round-trips an MoE tree.
(d) ``forward_paged`` at ``tiny-moe`` widths (2 layers, window 128) on the
    fresh, packed and decode routes at both capacity factors: f32 logits
    atol 1e-4, pools atol 1e-5 (the dense model tests' tolerances).
(e) ``TorchEngine`` against ``JaxEngine`` at a small MoE config with
    capacity factor 8.0 (no assignment dropped, so dispatch shapes do not
    matter, as the reference's own engine test runs it): identical greedy
    texts through packed prefill, mixed steps and the prefix cache."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.config import EngineConfig as JEngineConfig
from lmrs_tpu.config import ModelConfig as JModelConfig
from lmrs_tpu.config import model_preset as j_preset
from lmrs_tpu.engine.api import GenerationRequest as JRequest
from lmrs_tpu.engine.jax_engine import JaxEngine
from lmrs_tpu.models.transformer import forward_paged as j_forward_paged
from lmrs_tpu.models.transformer import init_params as j_init_params
from lmrs_tpu.ops import moe as jmoe
from lmrs_tpu.ops.quant import quantize_params as j_quantize_params
from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.config import model_preset as t_preset
from lmrs_tpu_torch.engine.api import GenerationRequest
from lmrs_tpu_torch.engine.torch_engine import TorchEngine
from lmrs_tpu_torch.models.convert import params_from_jax, params_to_jax
from lmrs_tpu_torch.models.transformer import forward_paged as t_forward_paged
from lmrs_tpu_torch.models.transformer import init_params as t_init_params
from lmrs_tpu_torch.models.transformer import param_count
from lmrs_tpu_torch.ops import moe as tmoe
from lmrs_tpu_torch.ops.quant import (is_quantized, quantize_layer,
                                      quantize_params)
from lmrs_tpu_torch.utils.perf_model import matmul_params as t_matmul_params

from test_torch_engine import CFG, IdTokenizer
from test_torch_model import _pools, _route_inputs

t_ = torch.from_numpy
MOE = dict(n_experts=4, n_experts_per_token=2)


def _tiny_moe(capacity=1.25):
    """tiny-moe's widths (dim 256, 8 over 4 heads, hidden 512, 4 experts)
    at 2 layers, a 128-token window and f32."""
    kw = dict(n_layers=2, max_seq_len=128, dtype="float32",
              expert_capacity_factor=capacity)
    return (dataclasses.replace(j_preset("tiny-moe"), **kw),
            dataclasses.replace(t_preset("tiny-moe"), **kw))


@pytest.fixture(scope="module")
def moe_tree():
    jcfg, _ = _tiny_moe()
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(0)))
    r = np.random.default_rng(0)
    for name in ("ln_attn", "ln_mlp"):  # exercise the (1 + scale) norms
        s = tree["layers"][name]["scale"]
        tree["layers"][name]["scale"] = (0.1 * r.standard_normal(s.shape)).astype(np.float32)
    return tree


# ----------------------------------------------------------------- (a)

@pytest.mark.parametrize("k,e,factor", [(2, 4, 1.25), (2, 8, 1.25),
                                        (1, 4, 0.05), (3, 2, 8.0)])
def test_expert_capacity_matches_reference(k, e, factor):
    kw = dict(n_experts=e, n_experts_per_token=k, expert_capacity_factor=factor)
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    for n in (1, 2, 3, 7, 8, 64, 946, 2048):
        c = tmoe.expert_capacity(n, tcfg)
        assert c == jmoe.expert_capacity(n, jcfg)
        assert 1 <= c <= n


# ----------------------------------------------------------------- (b)

def _layer_case(tree, router):
    """Layer 0's expert params with the router ``router`` makes."""
    mp = {k: v[0].copy() for k, v in tree["layers"]["moe"].items()}
    w = mp["router"]
    if router == "skewed":  # every token prefers expert 0 by far
        w[:, 0] = np.abs(w[:, 0]) * 8.0
    elif router == "tie":   # experts 1 and 2 score equally on every token
        w[:, 2] = w[:, 1]
    return mp


@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("router", ["random", "skewed", "tie"])
@pytest.mark.parametrize("capacity", [1.25, 0.05])
def test_moe_mlp_matches_jax(moe_tree, capacity, router, int8):
    jcfg, tcfg = _tiny_moe(capacity)
    mp = _layer_case(moe_tree, router)
    x = np.random.default_rng(1).standard_normal((2, 37, jcfg.dim)).astype(np.float32)
    if router == "skewed":
        x = np.abs(x)
    # the port's layer: router, gate and up fused along the output axis
    lp = {"router": t_(mp["router"]), "w_down": t_(mp["w_down"]),
          "w_gate_up": t_(np.concatenate([mp["w_gate"], mp["w_up"]], -1))}
    jmp = {k: jnp.asarray(v) for k, v in mp.items()}
    if int8:  # each package quantizes its own layout ((c) holds them equal)
        jmp = jax.tree.map(lambda a: a[0], j_quantize_params(
            {"layers": {"moe": {k: v[None] for k, v in jmp.items()}}})["layers"]["moe"])
        lp = quantize_layer(lp)
    want, want_aux = jmoe.moe_mlp(jmp, jcfg, jnp.asarray(x))
    got, aux = tmoe.moe_mlp(lp, tcfg, t_(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    # the case does what it says: drops at the skew and the starved factor
    _, _, experts = tmoe.route(lp["router"], tcfg, t_(x).reshape(-1, jcfg.dim))
    keep = tmoe.assign_slots(experts, tcfg.n_experts,
                             tmoe.expert_capacity(x.shape[0] * x.shape[1], tcfg))[1]
    if capacity == 0.05 or router == "skewed":
        assert not bool(keep.all())


def test_route_breaks_ties_by_expert_index():
    """Equal probabilities rank the lower expert first, as
    ``jax.lax.top_k`` does, and the gates renormalise with +1e-9."""
    cfg = TModelConfig(dim=4, **MOE)
    router = torch.zeros(4, 4)
    router[0] = torch.tensor([0.0, 1.0, 1.0, 1.0])
    x = torch.tensor([[1.0, 0, 0, 0], [0, 0, 0, 0]])
    probs, gates, experts = tmoe.route(router, cfg, x)
    assert experts.tolist() == [[1, 2], [0, 1]]
    want_p = jax.nn.softmax(jnp.asarray(x.numpy()) @ jnp.asarray(router.numpy()))
    vals, idx = jax.lax.top_k(want_p, 2)
    assert experts.tolist() == np.asarray(idx).tolist()
    np.testing.assert_allclose(gates.numpy(), np.asarray(vals / (vals.sum(-1, keepdims=True) + 1e-9)),
                               rtol=1e-6)


def test_assign_slots_slot_major_with_trash():
    """First choices claim capacity before second ones, in token order; a
    dropped assignment points at the trash slot E·C."""
    experts = torch.tensor([[0, 1], [0, 2], [0, 1]])
    slot, keep = tmoe.assign_slots(experts, 3, 2)
    # slot-major order: (t0,0) (t1,0) (t2,0) (t0,1) (t1,2) (t2,1)
    assert keep.tolist() == [True, True, False, True, True, True]
    assert slot.tolist() == [0, 1, 6, 2, 4, 3]


# ----------------------------------------------------------------- (c)

def test_expert_quantization_matches_jax(moe_tree):
    _, tcfg = _tiny_moe()
    want = params_from_jax(jax.tree.map(np.asarray, j_quantize_params(moe_tree)), tcfg)
    got = quantize_params(params_from_jax(moe_tree, tcfg))
    for lw, lg in zip(want["layers"], got["layers"]):
        assert set(lw) == set(lg)
        assert not is_quantized(lg["router"])  # routing stays full precision
        for name in ("wqkv", "wo", "w_gate_up", "w_down"):
            assert torch.equal(lw[name]["q"], lg[name]["q"]), name
            assert torch.equal(lw[name]["s"], lg[name]["s"]), name
        assert lg["w_gate_up"]["s"].shape == (4, 1, 2 * tcfg.hidden_dim)
    # the bridge carries the quantized MoE tree back unchanged
    back = params_to_jax(want, tcfg)
    flat, tdef = jax.tree.flatten(jax.tree.map(np.asarray, j_quantize_params(moe_tree)))
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef == tdef_b
    for a, b in zip(flat, flat_b):
        np.testing.assert_array_equal(a, b)


def test_moe_params_round_trip_and_counts(moe_tree):
    jcfg, tcfg = _tiny_moe()
    params = params_from_jax(moe_tree, tcfg)
    back = params_to_jax(params, tcfg)
    flat, tdef = jax.tree.flatten(moe_tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef == tdef_b
    for a, b in zip(flat, flat_b):
        np.testing.assert_array_equal(a, b)
    assert param_count(params) == sum(a.size for a in flat)  # every expert
    from lmrs_tpu.utils.perf_model import matmul_params
    for name in ("tiny-moe", "mixtral-8x7b", "bench-8b"):
        assert t_matmul_params(t_preset(name)) == matmul_params(j_preset(name))
    # random init draws the same shapes the reference draws
    t_tree = params_to_jax(t_init_params(tcfg, seed=0), tcfg)
    assert jax.tree.map(np.shape, t_tree) == jax.tree.map(np.shape, moe_tree)


# ----------------------------------------------------------------- (d)

@pytest.mark.parametrize("capacity", [1.25, 0.05])
@pytest.mark.parametrize("route", ["fresh", "packed", "decode"])
def test_forward_paged_moe_matches_jax(moe_tree, route, capacity):
    jcfg, tcfg = _tiny_moe(capacity)
    kp, vp = _pools(2, jcfg)
    x = _route_inputs(route, 3)
    ints = {k: v.astype(np.int32) for k, v in x.items()}
    opt = ("token_pages", "segment_ids", "packed_last_idx", "last_pos")
    j_logits, j_kp, j_vp = j_forward_paged(
        jax.tree.map(jnp.asarray, moe_tree), jcfg, ints["tokens"],
        ints["positions"], jnp.asarray(kp), jnp.asarray(vp),
        ints["page_tables"], ints["kv_lens"], jcfg.max_seq_len,
        **{k: jnp.asarray(ints[k]) for k in opt if k in ints})
    t_kp, t_vp = t_(kp.copy()), t_(vp.copy())
    t_logits = t_forward_paged(
        params_from_jax(moe_tree, tcfg), tcfg, t_(x["tokens"]),
        t_(x["positions"]), t_kp, t_vp, t_(x["page_tables"]),
        t_(ints["kv_lens"]), tcfg.max_seq_len,
        **{k: t_(x[k]) for k in opt if k in x})
    assert t_logits.shape == j_logits.shape
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4)
    np.testing.assert_allclose(t_kp.numpy(), np.asarray(j_kp), atol=1e-5)
    np.testing.assert_allclose(t_vp.numpy(), np.asarray(j_vp), atol=1e-5)


# ----------------------------------------------------------------- (e)

ECFG = dict(CFG, vocab_size=IdTokenizer.vocab_size, expert_capacity_factor=8.0,
            **MOE)
PREAMBLE = "You are summarizing. Keep facts!\n"
BODIES = ["alpha beta gamma delta", "the quick brown fox", "x" * 20,
          "0123456789abcdefghij"]


def test_moe_engine_matches_jax_engine():
    """2 slots, 16-token pages, a 12-page pool, mixed steps and the prefix
    cache on (the default path) at capacity factor 8.0: identical greedy
    texts, a clean audit, mixed steps and prefix hits on the port."""
    jcfg = JModelConfig(name="m", **ECFG)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(3)))
    kw = dict(max_batch_slots=2, page_size=16, num_pages=12, decode_block=4,
              max_tokens=16, prefill_chunk=64, mixed_token_budget=32)
    prompts = [PREAMBLE + b for b in BODIES]
    budgets = [16, 5, 12, 9]  # uneven: prompts prefill beside decoding rows
    jeng = JaxEngine(JEngineConfig(backend="jax", scheduler="continuous",
                                   seed=0, retry_delay=0.0, **kw), jcfg,
                     params=jax.tree.map(jnp.asarray, tree),
                     tokenizer=IdTokenizer())
    want = jeng.generate_batch([JRequest(prompt=p, request_id=i, temperature=0.0,
                                         max_new_tokens=n)
                                for i, (p, n) in enumerate(zip(prompts, budgets))])
    jeng.shutdown()
    tcfg = TModelConfig(name="m", **ECFG)
    eng = TorchEngine(EngineConfig(**kw), tcfg, device="cpu",
                      params=params_from_jax(tree, tcfg), tokenizer=IdTokenizer())
    got = eng.generate_batch([GenerationRequest(prompt=p, request_id=i,
                                                temperature=0.0, max_new_tokens=n)
                              for i, (p, n) in enumerate(zip(prompts, budgets))])
    m = eng.engine_metrics()
    assert eng.audit() == []
    assert m["mixed_batch"]["dispatches"] >= 1
    assert m["prefix_cache"]["tokens_reused"] > 0
    assert all(r.error is None and w.error is None for r, w in zip(got, want))
    assert [r.text for r in got] == [w.text for w in want]
