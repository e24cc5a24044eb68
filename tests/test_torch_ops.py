"""Port parity, ops: the same numpy inputs through the JAX package's op and
its ``lmrs_tpu_torch`` counterpart.  Tolerance: f32 ops atol 1e-5 (both
compute in f32; only summation order differs)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.ops import norms as jnorms
from lmrs_tpu.ops import rope as jrope
from lmrs_tpu.ops import sampling as jsampling
from lmrs_tpu_torch.ops import attention as tattn
from lmrs_tpu_torch.ops import norms as tnorms
from lmrs_tpu_torch.ops import rope as trope
from lmrs_tpu_torch.ops import sampling as tsampling

# lmrs_tpu.ops re-exports a function named ``attention``: fetch the module
jattn = importlib.import_module("lmrs_tpu.ops.attention")

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm(eps):
    r = _rng(0)
    x = r.standard_normal((2, 5, 16)).astype(np.float32)
    scale = (0.1 * r.standard_normal(16)).astype(np.float32)
    want = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(scale), eps))
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), eps).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(theta):
    r = _rng(1)
    x = r.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = r.integers(0, 32, (2, 6))
    js, jc = jrope.rope_table(32, 16, theta)
    ts, tc = trope.rope_table(32, 16, theta)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), js, jc))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), ts, tc).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_attention(softcap):
    r = _rng(2)
    q = r.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = r.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = r.standard_normal((2, 6, 2, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6)).copy()
    lens = np.array([6, 4], np.int32)
    want = np.asarray(jattn.attention(*map(jnp.asarray, (q, k, v, pos, lens)),
                                      logit_softcap=softcap))
    got = tattn.attention(*map(torch.from_numpy, (q, k, v, pos, lens)),
                          logit_softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_packed_attention():
    r = _rng(3)
    q = r.standard_normal((1, 9, 4, 8)).astype(np.float32)
    k = r.standard_normal((1, 9, 2, 8)).astype(np.float32)
    v = r.standard_normal((1, 9, 2, 8)).astype(np.float32)
    seg = np.array([[0, 0, 0, 1, 1, 2, 2, 2, -1]], np.int32)
    lens = np.array([8], np.int32)
    want = np.asarray(jattn.packed_attention(*map(jnp.asarray, (q, k, v, seg, lens))))
    got = tattn.packed_attention(*map(torch.from_numpy, (q, k, v, seg, lens))).numpy()
    # the pad row (index 8) is fully masked: garbage by contract in both
    np.testing.assert_allclose(got[:, :8], want[:, :8], atol=ATOL)


def test_sample_logits_greedy_exact():
    logits = _rng(4).standard_normal((4, 50)).astype(np.float32)
    zeros = np.zeros(4, np.float32)
    ks, ps = np.zeros(4, np.int32), np.ones(4, np.float32)
    want = np.asarray(jsampling.sample_logits(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(zeros),
        jnp.asarray(ks), jnp.asarray(ps)))
    got = tsampling.sample_logits(torch.from_numpy(logits), zeros, ks, ps).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k,top_p", [
    ([0, 5, 0, 3], [1.0, 1.0, 0.9, 0.5]),
    ([1, 0, 10, 0], [0.3, 0.7, 1.0, 1.0]),
])
def test_filter_logits_masks_equal(top_k, top_p):
    logits = (3 * _rng(5).standard_normal((4, 40))).astype(np.float32)
    temps = np.array([0.7, 1.0, 0.3, 2.0], np.float32)
    tk, tp = np.array(top_k, np.int32), np.array(top_p, np.float32)
    want = np.asarray(jsampling.filter_logits(*map(jnp.asarray, (logits, temps, tk, tp))))
    got = tsampling.filter_logits(*map(torch.from_numpy, (logits, temps, tk, tp))).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL)


def test_sample_logits_respects_filter():
    """Sampled rows draw only inside their nucleus; greedy rows stay argmax."""
    logits = (3 * _rng(6).standard_normal((3, 40))).astype(np.float32)
    temps = np.array([0.0, 1.0, 1.0], np.float32)
    tk, tp = np.array([0, 3, 0], np.int32), np.array([1.0, 1.0, 0.5], np.float32)
    allowed = np.isfinite(np.asarray(jsampling.filter_logits(
        *map(jnp.asarray, (logits, temps, tk, tp)))))
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tsampling.sample_logits(torch.from_numpy(logits), temps, tk, tp,
                                      generator=gen).numpy()
        assert tok[0] == logits[0].argmax()
        assert allowed[1, tok[1]] and allowed[2, tok[2]]
