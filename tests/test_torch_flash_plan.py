"""The flash-prefill kernel's schedule, emulated in plain torch on the CPU.

``csrc/flash_prefill.cu`` runs 128-row query tiles of one head, two
64-row warpgroups each, over 64-column K/V tiles (hd <= 128, emulated
here; hd 256 runs one warpgroup over 32-column tiles); the grid's q-tile index
is reversed so the heaviest causal tiles start first.  A block's kv tiles
start at the first position of its first query's segment, found by a
two-step warp probe (32 lanes 64 positions apart, then the exact 64), and
each warpgroup skips the tiles its rows cannot see and masks only the ones
crossing the diagonal, the length or a segment boundary.  The card tests
hold the kernel itself against the plain version; here the schedule is
held, at S <= 512 and narrow heads:

(a) the launch order against the causal work of each tile (heaviest first);
(b) the segment probe against a plain search, segments of 1 to 5,000;
(c) the tiles each warpgroup visits cover every pair the mask allows, and
    a tile run without the mask holds no pair the mask forbids;
(d) the online softmax over exactly the visited tiles (f32, log2 domain,
    the kernel's NEG convention) against ``flash_attention_ref`` (atol
    1e-5: f32 rounding of a different summation order) and against the
    JAX package's ``flash_attention`` in interpret mode (atol 2e-5, the
    kernel parity tests' tolerance).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.ops.flash_attention import flash_attention as j_flash
from lmrs_tpu_torch.ops import flash_attention as tfa

SRC = (Path(tfa.__file__).resolve().parents[1] / "csrc" / "flash_prefill.cu"
       ).read_text()
BQ, BK, WG_ROWS = 128, 64, 64  # the kernel's query tile, kv tile, warpgroup
NEG = -1e30
LOG2E = 1.4426950408889634
ATOL_REF, ATOL_JAX = 1e-5, 2e-5


def test_tile_sizes_match_the_kernel():
    """The emulated tiles are the hd <= 128 builds' (``Tile<HD>``): two
    64-row warpgroups a block over 64-column kv tiles; the hd-256 build
    runs one warpgroup over 32-column tiles."""
    assert re.search(r"NWG = HD > 128 \? 1 : 2;", SRC)
    assert re.search(rf"BQ = {WG_ROWS} \* NWG;", SRC) and BQ == 2 * WG_ROWS
    assert re.search(rf"BK = HD > 128 \? 32 : {BK};", SRC)
    assert "(gridDim.y - 1 - blockIdx.y) * BQ" in SRC  # reversed q tiles


def launch_order(b: int, s: int, h: int) -> list[tuple[int, int, int]]:
    """(batch row, q tile, head) in the hardware's block order: grid (H, q
    tiles, B), x fastest, q tile = gridDim.y - 1 - blockIdx.y."""
    n_qt = -(-s // BQ)
    return [(bi, n_qt - 1 - y, hi) for bi in range(b) for y in range(n_qt)
            for hi in range(h)]


def run_start(seg: np.ndarray, pos: int) -> int:
    """The kernel's ``run_start``: lane l probes pos - 64(l + 1); the first
    probe that leaves the run bounds it, and 64 exact probes find it."""
    s0, hi = seg[pos], pos
    while True:
        differs = [p < 0 or seg[p] != s0 for p in (hi - 64 * (lane + 1)
                                                   for lane in range(32))]
        if not any(differs):
            hi -= 64 * 32
            continue
        base = hi - 64 * (differs.index(True) + 1)
        inside = [p >= 0 and seg[p] == s0 for p in range(base + 1, base + 65)]
        return base + 1 + inside.index(True)


def block_tiles(seg, length: int, q_start: int) -> list[int]:
    """kv0 of every tile a block streams through its ring."""
    lo = run_start(seg, q_start) if seg is not None else 0
    hi = min(q_start + BQ, length)
    return list(range(lo, hi, BK))


def wg_plan(seg, length: int, s: int, r0: int, tiles: list[int]):
    """The warpgroup of rows [r0, r0 + 64): [(kv0, unmasked)] it computes."""
    if r0 >= length:
        return []
    r_last = min(r0 + WG_ROWS - 1, length - 1)
    wg_lo = run_start(seg, r0) if seg is not None else 0
    out = []
    for kv0 in tiles:
        if kv0 <= r_last and kv0 + BK > wg_lo:
            unmasked = (kv0 + BK - 1 <= r0 and kv0 + BK <= length
                        and (seg is None or seg[kv0] == seg[r_last]))
            out.append((kv0, unmasked))
    return out


def allowed(seg, length: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The contract's mask for query rows x key columns."""
    ok = (cols[None, :] <= rows[:, None]) & (cols[None, :] < length)
    if seg is not None:
        ok &= seg[np.minimum(cols, len(seg) - 1)][None, :] == seg[rows][:, None]
    return ok


def emulate(q, k, v, lengths, seg=None):
    """The kernel's schedule and online softmax in f32 torch."""
    b, s, h, hd = q.shape
    n_rep = h // k.shape[2]
    c = hd ** -0.5 * LOG2E
    out = torch.zeros_like(q)
    for bi, qt, hi in launch_order(b, s, h):
        length = min(int(lengths[bi]), s)
        q_start = qt * BQ
        if q_start >= length:
            continue
        sg = None if seg is None else seg[bi].numpy()
        tiles = block_tiles(sg, length, q_start)
        for r0 in (q_start, q_start + WG_ROWS):
            rows = np.arange(r0, min(r0 + WG_ROWS, s))
            if len(rows) == 0:
                continue
            m = torch.full((len(rows),), NEG)
            l_run = torch.zeros(len(rows))
            acc = torch.zeros(len(rows), hd)
            for kv0, unmasked in wg_plan(sg, length, s, r0, tiles):
                cols = np.arange(kv0, kv0 + BK)
                inb = torch.from_numpy(cols < s)  # TMA zero-fills past S
                cc = torch.from_numpy(np.minimum(cols, s - 1))
                kt = torch.where(inb[:, None], k[bi, cc, hi // n_rep], 0.0)
                vt = torch.where(inb[:, None], v[bi, cc, hi // n_rep], 0.0)
                sc = q[bi, rows, hi] @ kt.T
                if not unmasked:
                    ok = torch.from_numpy(allowed(sg, length, rows, cols))
                    sc = torch.where(ok, sc, torch.full_like(sc, NEG))
                m_new = torch.maximum(m, sc.max(1).values)
                alpha = torch.exp2((m - m_new) * c)
                mref = torch.where(m_new == NEG, 0.0, m_new) * c
                p = torch.exp2(sc * c - mref[:, None])
                l_run = l_run * alpha + p.sum(1)
                acc = acc * alpha[:, None] + p @ vt
                m = m_new
            live = torch.from_numpy(rows < length) & (l_run > 0)
            inv = torch.where(live, 1 / torch.where(live, l_run, 1.0), 0.0)
            out[bi, rows, hi] = acc * inv[:, None]
    return out


def _segments(s: int, lens: list[int]) -> np.ndarray:
    seg = np.full((s,), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        off += n
    return seg


# name: (B, S, H, K, hd, lengths, segment lengths per row or None)
CASES = {
    "unpacked_n_rep4": (1, 400, 8, 2, 32, [400], None),
    "not_tile_multiple": (1, 333, 4, 4, 32, [333], None),
    "padded_tail": (1, 300, 4, 2, 32, [190], None),
    "batch_lengths_n_rep8": (2, 260, 8, 1, 16, [260, 77], None),
    # a 1-token and a 5-token segment, segments starting mid-tile
    "packed_short_segments": (1, 512, 4, 2, 32, [449], [1, 5, 130, 200, 113]),
    "packed_batch_n_rep1": (2, 300, 2, 2, 32, [250, 250], [100, 150]),
}


def _case(name):
    b, s, h, kh, hd, lens, seg_lens = CASES[name]
    r = np.random.default_rng(sorted(CASES).index(name))
    q = r.standard_normal((b, s, h, hd)).astype(np.float32)
    k = r.standard_normal((b, s, kh, hd)).astype(np.float32)
    v = r.standard_normal((b, s, kh, hd)).astype(np.float32)
    seg = None
    if seg_lens is not None:
        seg = np.stack([_segments(s, seg_lens)] * b)
    return q, k, v, np.asarray(lens, np.int32), seg


# ------------------------------------------------------------- (a) order


@pytest.mark.parametrize("s", [1600, 2048, 333])
def test_launch_order_is_heaviest_first(s):
    """Unpacked rows: the kv tiles a block streams never grow along the
    launch order, and the first block is the last q tile."""
    order = launch_order(1, s, 4)
    work = [len(block_tiles(None, s, qt * BQ)) for _, qt, _ in order]
    assert work == sorted(work, reverse=True)
    assert order[0][1] == -(-s // BQ) - 1


# ------------------------------------------------------------- (b) probe


@pytest.mark.parametrize("lens", [[1] * 70, [5000], [3, 2047, 1, 2049, 64, 65],
                                  [700, 512, 333, 260]])
def test_segment_probe_matches_plain_search(lens):
    seg = _segments(sum(lens) + 7, lens)  # + a padded tail of -1
    for pos in range(0, len(seg), 13 if len(seg) > 500 else 1):
        want = pos
        while want > 0 and seg[want - 1] == seg[pos]:
            want -= 1
        assert run_start(seg, pos) == want, pos


# ------------------------------------------------------------- (c) cover


@pytest.mark.parametrize("name", sorted(CASES))
def test_visited_tiles_cover_the_mask(name):
    _, _, _, lens, seg = _case(name)
    b, s = CASES[name][:2]
    for bi in range(b):
        length = min(int(lens[bi]), s)
        sg = None if seg is None else seg[bi]
        rows = np.arange(s)
        need = allowed(sg, length, rows, rows) & (rows < length)[:, None]
        seen = np.zeros_like(need)
        for qt in range(-(-s // BQ)):
            if qt * BQ >= length:
                continue
            tiles = block_tiles(sg, length, qt * BQ)
            for r0 in (qt * BQ, qt * BQ + WG_ROWS):
                wrows = np.arange(r0, min(r0 + WG_ROWS, length))
                for kv0, unmasked in wg_plan(sg, length, s, r0, tiles):
                    cols = np.arange(kv0, min(kv0 + BK, s))
                    seen[np.ix_(wrows, cols)] = True
                    if unmasked:  # no forbidden pair in a mask-free tile
                        assert allowed(sg, length, wrows, cols).all()
        assert not (need & ~seen).any()


# ------------------------------------------------------------- (d) values


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_schedule_matches_plain_version(name):
    q, k, v, lens, seg = _case(name)
    t = [torch.from_numpy(x) for x in (q, k, v, lens)]
    ts = None if seg is None else torch.from_numpy(seg)
    want = tfa.flash_attention_ref(*t, segment_ids=ts)
    got = emulate(*t, seg=ts)
    torch.testing.assert_close(got, want, atol=ATOL_REF, rtol=0)


@pytest.mark.parametrize("name", ["padded_tail", "packed_short_segments"])
def test_emulated_schedule_matches_jax_kernel(name):
    q, k, v, lens, seg = _case(name)
    want = np.asarray(j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        q_block=128, kv_block=128, interpret=True,
        segment_ids=None if seg is None else jnp.asarray(seg)))
    got = emulate(*map(torch.from_numpy, (q, k, v, lens)),
                  seg=None if seg is None else torch.from_numpy(seg)).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=ATOL_JAX)
        assert not got[i, n:].any()
