"""Port parity, kernel modules: the plain PyTorch versions of the port's two
CUDA kernels against the JAX package's Pallas kernels (interpret mode on
the CPU) and XLA references, on the same numpy inputs.  Tolerance: f32
atol 2e-5 (the reference's own kernel tests); pool contents exact.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.ops.flash_attention import flash_attention as j_flash
from lmrs_tpu.ops.paged_attention import (paged_decode_pallas_fused,
                                          paged_decode_xla)
from lmrs_tpu_torch.ops import flash_attention as tfa
from lmrs_tpu_torch.ops import paged_attention as tpa

ATOL = 2e-5


def _qkv(seed, b, s, h, kh, hd):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, h, hd)).astype(np.float32),
            r.standard_normal((b, s, kh, hd)).astype(np.float32),
            r.standard_normal((b, s, kh, hd)).astype(np.float32))


@pytest.mark.parametrize("packed", [False, True])
def test_flash_ref_matches_jax_kernel(packed):
    """GQA (8, 2), lengths < S, S=200 not a multiple of the 128 block,
    and (packed) segment ids with a padded tail."""
    b, s, h, kh, hd = (1 if packed else 2), 200, 8, 2, 64
    q, k, v = _qkv(0, b, s, h, kh, hd)
    if packed:
        seg = np.full((1, s), -1, np.int32)
        seg[0, :70], seg[0, 70:131], seg[0, 131:190] = 0, 1, 2
        lens = np.array([190], np.int32)
    else:
        seg, lens = None, np.array([200, 77], np.int32)
    want = np.asarray(j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        q_block=128, kv_block=128, interpret=True,
        segment_ids=None if seg is None else jnp.asarray(seg)))
    got = tfa.flash_attention(
        *map(torch.from_numpy, (q, k, v, lens)),
        segment_ids=None if seg is None else torch.from_numpy(seg)).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=ATOL)
        assert not got[i, n:].any()  # rows past the length: zero (contract)
    assert tfa.flash_attention.launches == 0  # CPU tensors: plain version


def _decode_inputs(seed, b, h, kh, hd, ps, n_pages):
    r = np.random.default_rng(seed)
    return dict(
        q=r.standard_normal((b, h, hd)).astype(np.float32),
        k_new=r.standard_normal((b, kh, hd)).astype(np.float32),
        v_new=r.standard_normal((b, kh, hd)).astype(np.float32),
        k_pages=r.standard_normal((n_pages, kh, ps, hd)).astype(np.float32),
        v_pages=r.standard_normal((n_pages, kh, ps, hd)).astype(np.float32))


def _port_decode(x, tables, lens):
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    out = tpa.paged_decode_fused(t["q"], t["k_new"], t["v_new"], t["k_pages"],
                                 t["v_pages"], torch.from_numpy(tables),
                                 torch.from_numpy(lens))
    return out.numpy(), t["k_pages"].numpy(), t["v_pages"].numpy()


def test_fused_decode_ref_matches_jax():
    """Active rows (mid-page, page boundary) + an inactive row: output and
    pool inside each active row's valid prefix match the Pallas kernel and
    scatter + paged_decode_xla; the inactive row writes nothing and is
    zero."""
    b, h, kh, hd, ps, n_pages = 3, 8, 2, 128, 16, 12
    x = _decode_inputs(0, b, h, kh, hd, ps, n_pages)
    tables = np.array([[3, 5, 7], [9, 2, 0], [0, 0, 0]], np.int32)
    lens = np.array([29, 16, 0], np.int32)
    got, kp, vp = _port_decode(x, tables, lens)

    j = {k: jnp.asarray(v) for k, v in x.items()}
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    j_out, j_kp, j_vp = paged_decode_pallas_fused(
        j["q"], j["k_new"], j["v_new"], j["k_pages"], j["v_pages"], jt, jl,
        interpret=True)
    # scatter + XLA gather reference (active rows)
    ref_kp, ref_vp = x["k_pages"].copy(), x["v_pages"].copy()
    for row in range(2):
        pos = lens[row] - 1
        ref_kp[tables[row, pos // ps], :, pos % ps] = x["k_new"][row]
        ref_vp[tables[row, pos // ps], :, pos % ps] = x["v_new"][row]
    x_out = paged_decode_xla(j["q"], jnp.asarray(ref_kp), jnp.asarray(ref_vp), jt, jl)

    np.testing.assert_allclose(got[:2], np.asarray(j_out)[:2], atol=ATOL)
    np.testing.assert_allclose(got[:2], np.asarray(x_out)[:2], atol=ATOL)
    assert not got[2].any()
    for row in range(2):
        for c in range(-(-lens[row] // ps)):
            page, n = tables[row, c], min(ps, lens[row] - c * ps)
            np.testing.assert_array_equal(kp[page, :, :n], np.asarray(j_kp)[page, :, :n])
            np.testing.assert_array_equal(vp[page, :, :n], np.asarray(j_vp)[page, :, :n])
    # the port writes exactly the two active rows' slots and nothing else
    np.testing.assert_array_equal(kp, ref_kp)
    np.testing.assert_array_equal(vp, ref_vp)


def test_fused_decode_ref_clamps_stale_length():
    """A length past the table (a stale/garbage row) clamps its walk to the
    table and skips its write — the reference kernel's regression case."""
    b, h, kh, hd, ps, n_pages = 2, 4, 4, 128, 16, 12
    x = _decode_inputs(1, b, h, kh, hd, ps, n_pages)
    tables = np.array([[3, 5], [9, 1]], np.int32)
    lens = np.array([20, 180], np.int32)
    got, kp, vp = _port_decode(x, tables, lens)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    j_out, j_kp, j_vp = paged_decode_pallas_fused(
        j["q"], j["k_new"], j["v_new"], j["k_pages"], j["v_pages"],
        jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(got, np.asarray(j_out), atol=ATOL)
    np.testing.assert_array_equal(kp, np.asarray(j_kp))
    np.testing.assert_array_equal(vp, np.asarray(j_vp))
    touched = set(np.flatnonzero((kp != x["k_pages"]).any(axis=(1, 2, 3))))
    assert touched == {5}
    assert tpa.paged_decode_fused.launches == 0  # CPU tensors: plain version
