"""Port parity of the spill tiers: the port's ``PrefixCache`` with its
``HostKVPool`` and ``DiskKVPool`` against the JAX package's, driven by the
same seeded op sequences over fake KV stores (matches, ``stats()``,
spilled and disk page counts and audits equal after every op); spill
files written by either package read by the other (bf16 as raw words and
int8), a torn file and a crc mismatch refused alike; and the engine-level
checks of the reference's spill tests on the port's ``TorchEngine`` at f32
on the CPU (``test_torch_engine.py``'s CFG): greedy texts equal with the
tier on and off, the counters hold, the int8 disarm, the environment
switches, a restore that fails re-prefills, a device error raises.
Tolerances: exact (pages, payload bytes, texts)."""

import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from lmrs_tpu.engine import host_kv as jhk
from lmrs_tpu.engine.kv_cache import PageAllocator as JAllocator
from lmrs_tpu.engine.prefix_cache import PrefixCache as JPrefixCache
from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.engine import host_kv as thk
from lmrs_tpu_torch.engine.api import GenerationRequest
from lmrs_tpu_torch.engine.kv_cache import PageAllocator as TAllocator
from lmrs_tpu_torch.engine.kv_cache import audit_allocator
from lmrs_tpu_torch.engine.prefix_cache import PrefixCache as TPrefixCache
from lmrs_tpu_torch.engine.torch_engine import TorchEngine

from test_torch_engine import CFG, IdTokenizer

PS = 4
PAGE_BYTES = 2 * PS  # fake payload: one byte a token, k and v


class FakeKV:
    """The device pool's stand-in: capture tags each page's content with
    its page id, import records the scatter."""

    def __init__(self):
        self.imports = []

    def capture(self, pages):
        n = len(pages)
        k = np.broadcast_to(np.asarray(pages, np.uint8).reshape(1, n, 1, 1, 1),
                            (1, n, 1, PS, 1)).copy()
        return {"k": k, "v": k.copy(), "dtype": "uint8"}

    def import_pages(self, pages, payload, sync=False):
        self.imports.append((tuple(pages), payload["k"].tobytes()))


def _caches(tmp_path, host_pages, disk_pages):
    """(allocator, cache, fake KV) of each package, identical settings."""
    out = []
    for name, alloc, cache, mod in (("port", TAllocator, TPrefixCache, thk),
                                    ("ref", JAllocator, JPrefixCache, jhk)):
        a = alloc(48)
        disk = (mod.DiskKVPool(disk_pages * PAGE_BYTES, str(tmp_path / name))
                if disk_pages else None)
        pool = mod.HostKVPool(host_pages * PAGE_BYTES, disk=disk)
        kv = FakeKV()
        out.append((a, cache(a, PS, spill_pool=pool, capture_cb=kv.capture,
                             page_bytes=PAGE_BYTES), kv))
    return out


def _audit(a, c, live):
    holders = {}
    for pages in list(live) + [c.retained_pages()]:
        for p in pages:
            holders[p] = holders.get(p, 0) + 1
    return c.audit() + audit_allocator(a, a.num_pages, holders)


def _state(a, c, kv):
    return (c.stats(), c.spilled_pages(), c.disk_pages(), c.cached_pages,
            a.free_count, kv.imports)


@pytest.mark.parametrize("seed,disk", [(0, False), (1, False), (0, True),
                                       (1, True), (2, True)])
def test_tree_op_sequence_matches_reference(tmp_path, seed, disk):
    """Insert, close, evict, match + prefetch, host and disk budget
    squeezes, clear: both packages' trees answer alike after every op."""
    rng = np.random.default_rng(seed)
    pair = _caches(tmp_path, host_pages=6 if disk else 8,
                   disk_pages=6 if disk else 0)
    lives = [[], []]
    prefixes = [[int(b) + i for i in range(int(rng.integers(5, 14)))]
                for b in (10, 40, 70, 100)]
    for _step in range(150):
        op = int(rng.integers(0, 6 if disk else 5))
        pick = int(rng.integers(0, len(prefixes)))
        tail = [int(t) for t in rng.integers(200, 250, 4)]
        r_close = int(rng.integers(0, 1 << 30))
        r_n = int(rng.integers(1, 6))
        r_budget = int(rng.integers(0, 6))
        seen = []
        for (a, c, kv), live in zip(pair, lives):
            obs = None
            if op == 0 and a.free_count >= 6:
                ids = prefixes[pick] + tail
                pages = a.alloc(-(-len(ids) // PS))
                obs = c.insert(ids, pages)
                live.append(pages)
            elif op == 1 and live:
                a.free(live.pop(r_close % len(live)))
            elif op == 2:
                obs = c.evict(r_n)
            elif op == 3:
                pages, tok, chain = c.match_hier(prefixes[pick] + [99])
                got = list(pages)
                obs = [tok, [n for _node, n in chain]]
                for node, n_tok in chain:
                    if a.free_count < n_tok // PS:
                        break
                    dest = a.alloc(n_tok // PS)
                    try:
                        c.prefetch_into(node, dest, kv)
                    except (RuntimeError, LookupError):
                        a.free(dest)
                        obs.append("failed")
                        break
                    got += dest
                if got:
                    live.append(got)
            elif op == 4:
                c.pool.budget_bytes = r_budget * PAGE_BYTES
                c._enforce_host_budget()
                c.pool.budget_bytes = (6 if disk else 8) * PAGE_BYTES
            elif op == 5:
                c.disk.budget_bytes = r_budget * PAGE_BYTES
                c._enforce_host_budget()
                c.disk.budget_bytes = 6 * PAGE_BYTES
            assert _audit(a, c, live) == []
            seen.append((obs, _state(a, c, kv)))
        assert seen[0] == seen[1]
    for (a, c, _kv), live in zip(pair, lives):
        for pages in live:
            a.free(pages)
        c.clear()
        assert _audit(a, c, []) == [] and a.free_count == a.num_pages - 1
        if disk:
            assert c.disk.used_bytes == 0 and not os.listdir(c.disk.dir)


def _payload(kind: str, pkg: str) -> dict:
    """A [L, n, K, ps, hd] page payload, the same bytes in both packages:
    bf16 as raw words (port) or ml_dtypes bfloat16 (reference)."""
    rng = np.random.default_rng(3)
    if kind == "int8":
        k, v = (rng.integers(-128, 128, (2, 3, 2, 4, 8)).astype(np.int8)
                for _ in range(2))
        return {"k": k, "v": v, "dtype": "int8"}
    k, v = (rng.integers(0, 1 << 16, (2, 3, 2, 4, 8)).astype(np.uint16)
            for _ in range(2))
    dt = thk.BF16 if pkg == "port" else np.dtype(ml_dtypes.bfloat16)
    return {"k": k.view(dt), "v": v.view(dt), "dtype": "bfloat16"}


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_spill_files_cross_read(tmp_path, kind, writer):
    """A spill file written by either package reads back in the other
    with the same bytes, dtype name and descriptor."""
    mods = {"port": thk, "ref": jhk}
    reader = "ref" if writer == "port" else "port"
    pay = _payload(kind, writer)
    desc = mods[writer].DiskKVPool(1 << 20, str(tmp_path)).write(pay)
    twin = mods[reader].DiskKVPool(1 << 20, str(tmp_path)).write(
        _payload(kind, reader))
    assert {k: v for k, v in desc.items() if k != "path"} == \
        {k: v for k, v in twin.items() if k != "path"}
    got = mods[reader].DiskKVPool(1 << 20, str(tmp_path)).read(desc)
    assert got["dtype"] == pay["dtype"]
    for key in ("k", "v"):
        assert got[key].tobytes() == pay[key].tobytes()
        assert str(got[key].dtype) in ("bfloat16", "int8", "uint16")
    if reader == "port" and kind == "bf16":
        assert thk.dtype_name(got["k"]) == "bfloat16"
        t = torch.frombuffer(bytearray(got["k"].tobytes()),
                             dtype=torch.bfloat16)
        want = torch.from_numpy(pay["k"].view(np.int16).ravel())
        assert torch.equal(t.view(torch.int16), want)


@pytest.mark.parametrize("damage", ["torn", "crc"])
def test_damaged_spill_files_fail_alike(tmp_path, damage):
    """A torn file and a crc mismatch raise ``DiskReadError`` with the same
    message in both packages."""
    errors = []
    for mod, pkg in ((thk, "port"), (jhk, "ref")):
        pool = mod.DiskKVPool(1 << 20, str(tmp_path / pkg))
        desc = pool.write(_payload("int8", pkg))
        raw = bytearray(open(desc["path"], "rb").read())
        if damage == "torn":
            raw = raw[:-5]
        else:
            raw[len(raw) // 2] ^= 0xFF
        open(desc["path"], "wb").write(bytes(raw))
        with pytest.raises(mod.DiskReadError) as exc:
            pool.read(desc)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------- engine level

PRE = "Summarize the transcript section that follows, briefly.\n"


def _requests(n=4, pre=PRE):
    return [GenerationRequest(prompt=f"{pre}section {i}: the budget vote "
                              f"number {i} passed.", request_id=i,
                              max_new_tokens=8, temperature=0.0,
                              cache_prefix=len(pre)) for i in range(n)]


def _two_preambles():
    """Four requests over two preambles: two cached 4-page nodes."""
    reqs = _requests(2) + _requests(2, pre=PRE.replace("briefly", "in full"))
    return [dataclasses.replace(r, request_id=i) for i, r in enumerate(reqs)]


def _engine(**kw):
    cfg = EngineConfig(**{"page_size": 16, "num_pages": 64,
                          "max_batch_slots": 4, "decode_block": 4,
                          "max_tokens": 8, **kw})
    return TorchEngine(cfg, TModelConfig(**CFG), device="cpu",
                       tokenizer=IdTokenizer())


def _evict_rerun(eng, make=_requests):
    sched = eng._scheduler
    first = [r.text for r in eng.generate_batch(make())]
    pf1 = sched.counters["prefill_tokens"]
    sched._prefix_cache.evict(10_000)
    assert sched.audit() == []
    second = [r.text for r in eng.generate_batch(make())]
    assert sched.audit() == []
    return first, second, pf1, sched.counters["prefill_tokens"] - pf1


def test_spill_tier_identity_and_accounting():
    """Greedy texts equal with the tier on and off; the armed engine
    restores the preamble instead of re-prefilling it; the kill switch
    means evict-means-gone."""
    on = _engine()
    m = on._scheduler.metrics
    assert on._scheduler._prefix_cache.pool is not None
    first_on, second_on, pf1, pf2 = _evict_rerun(on)
    m = on._scheduler.metrics
    assert m["prefix_spilled_hits"] == 1
    assert m["prefix_tokens_prefetched"] > 0
    assert m["prefix_spill_pages"] == m["prefix_prefetch_pages"] > 0
    assert pf2 < pf1
    rep = on.engine_metrics()
    assert rep["host_kv"]["enabled"] and rep["prefix_cache"]["tokens_prefetched"] > 0
    off = _engine(host_kv=False)
    assert off._scheduler._prefix_cache.pool is None
    first_off, second_off, _pf1, pf2_off = _evict_rerun(off)
    assert off._scheduler.metrics["prefix_spill_pages"] == 0
    assert not off.engine_metrics()["host_kv"]["enabled"]
    assert pf2 < pf2_off
    assert first_on == first_off == second_on == second_off


def test_disk_tier_identity_and_accounting(tmp_path):
    """A host budget of four pages over a disk tier, two cached 4-page
    preambles: the LRU one demotes to disk and restores through it, texts
    unchanged, files gone after clear."""
    probe = _engine()
    page = probe._scheduler.cache.page_payload_bytes()
    eng = _engine(kv_disk=True, kv_disk_dir=str(tmp_path),
                  host_kv_gb=4 * page / 2**30)
    first, second, _pf1, _pf2 = _evict_rerun(eng, _two_preambles)
    rep = eng.engine_metrics()["host_kv"]
    assert rep["disk_demoted_pages_total"] > 0
    assert rep["disk_promoted_pages_total"] > 0
    assert first == second
    pc = eng._scheduler._prefix_cache
    pc.clear()
    assert not os.listdir(pc.disk.dir) and eng.audit() == []


def test_failed_restore_reprefills(monkeypatch):
    """A restore that fails for the tier's own reasons (an entry gone, a
    corrupt file) truncates the match: the segment re-prefills, texts
    unchanged, nothing restored, a clean audit."""
    eng = _engine()
    sched = eng._scheduler
    first = [r.text for r in eng.generate_batch(_requests())]
    sched._prefix_cache.evict(10_000)

    def refuse(*a, **kw):
        raise thk.DiskReadError("disk spill corrupt (crc mismatch)")

    monkeypatch.setattr(sched._prefix_cache, "prefetch_into", refuse)
    second = [r.text for r in eng.generate_batch(_requests())]
    assert first == second and sched.audit() == []
    assert sched.metrics["prefix_spilled_hits"] == 0


def test_device_error_in_restore_raises(monkeypatch):
    """A device (torch) error in a restore is not degraded: the run raises,
    the pool recovers, and the next run works."""
    eng = _engine()
    sched = eng._scheduler
    eng.generate_batch(_requests())
    sched._prefix_cache.evict(10_000)

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(sched.cache, "import_pages", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.generate_batch(_requests())
    monkeypatch.undo()
    assert sched.audit() == []
    assert len(eng.generate_batch(_requests())) == 4


def test_int8_pool_disarms_the_tier():
    """int8 KV turns the prefix cache off, so the tier is off too; texts
    equal with and without ``host_kv``."""
    on = _engine(kv_quantize="int8", page_size=32)
    assert on._scheduler._prefix_cache is None
    got = [r.text for r in on.generate_batch(_requests(3))]
    assert on._scheduler.metrics["prefix_spill_pages"] == 0
    assert not on.engine_metrics()["host_kv"]["enabled"]
    off = _engine(kv_quantize="int8", page_size=32, host_kv=False)
    assert got == [r.text for r in off.generate_batch(_requests(3))]


@pytest.mark.parametrize("var,value", [("LMRS_HOST_KV", "0"),
                                       ("LMRS_HOST_KV_SYNC", "1"),
                                       ("LMRS_HOST_KV_GB", "0")])
def test_env_switches(monkeypatch, var, value):
    """``LMRS_HOST_KV=0`` and a zero budget disarm the tier (as in the
    reference); ``LMRS_HOST_KV_SYNC=1`` blocks each restore, texts
    unchanged."""
    monkeypatch.setenv(var, value)
    eng = _engine()
    armed = eng._scheduler._prefix_cache.pool is not None
    assert armed is (var == "LMRS_HOST_KV_SYNC")
    assert eng._scheduler._host_kv_sync is (var == "LMRS_HOST_KV_SYNC")
    first, second, _pf1, _pf2 = _evict_rerun(eng)
    assert first == second
    assert (eng._scheduler.metrics["prefix_prefetch_pages"] > 0) is armed


def test_prefix_summary_counts_spilled_depth():
    """After an eviction the published summary reports the preamble as
    spilled, not resident (the router weighs the two apart)."""
    eng = _engine()
    eng.generate_batch(_requests(3))
    rows = eng.prefix_summary()
    assert rows and rows[0]["resident_tokens"] > 0
    sched = eng._scheduler
    sched._prefix_cache.evict(10_000)
    sched._summary_memo = None
    rows = eng.prefix_summary()
    assert rows[0]["resident_tokens"] == 0 and rows[0]["spilled_tokens"] > 0


def test_bf16_words_keep_their_wire_name():
    """``BF16`` words keep the name ``"bfloat16"`` through the reshapes and
    copies the tiers use, and ``as_dtype`` restores it after a concat."""
    a = np.arange(24, dtype=np.uint16).view(thk.BF16).reshape(2, 3, 4)
    for b in (a.reshape(6, 4), a[:, :2].copy(), np.ascontiguousarray(a),
              thk.as_dtype(np.concatenate([a, a], axis=1), "bfloat16")):
        assert thk.dtype_name(b) == "bfloat16"
    assert thk.np_dtype("int8") == np.int8
    assert dataclasses.is_dataclass(EngineConfig())
