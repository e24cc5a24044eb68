"""The port's fault-injection plane (``lmrs_tpu_torch/testing/faults.py``)
against the JAX package's, and its sites driven through the port's layers
on the CPU.

* The plane: for plans of every trigger kind (``every`` / ``at`` / ``p`` /
  ``max_fires`` / ``stall``) and two seeds, the port's and the JAX
  package's ``FaultInjector`` fed the same sequence of site calls fire at
  the same occurrences and answer ``check`` alike; the ``@path`` form,
  ``injected``'s reinstall-replays-identically rule and ``install_spec``'s
  idempotence.
* The chaos soak (the port of ``tests/test_chaos.py``'s scenarios that
  the port's layers run): seeded workloads through ``MapExecutor`` into
  the port's ``TorchEngine`` (f32, 2 layers, a 20-page pool) and its mock,
  under seeded plans; every request terminates once with a valid reason,
  and the scheduler's audit is clean after every scenario.  Armed but
  silent is token-identical to no plan; a ``scheduler.step`` fault
  recovers the pool and is deterministic, and its greedy texts equal the
  JAX package's engine on the same weights (a model whose greedy next
  byte is the current byte + 1, the argmax over the byte tokenizer's
  ids); a fault inside a mixed step; spill, prefetch and disk-read
  faults; the handoff's export, import, transfer, ack and decode-pod-down
  cases; the journal and recover sites; the server's disconnect probe;
  the router's connect, probe and receive sites.
* Every one of the port's sites is one of the 20 names of the reference
  this slice carries, and each is fired by a test here or in
  ``test_torch_watchdog.py`` (``scheduler.heartbeat``, ``router.hedge``).

Tolerance: exact (occurrences, texts).  Every HTTP call has a timeout of
10 s or less; servers bind ``127.0.0.1:0`` and shut down in teardown.
"""

import dataclasses
import json
import random
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lmrs_tpu.testing import faults as jfaults
from lmrs_tpu_torch.config import EngineConfig
from lmrs_tpu_torch.config import ModelConfig as TModelConfig
from lmrs_tpu_torch.data.tokenizer import ByteTokenizer
from lmrs_tpu_torch.engine.api import GenerationRequest
from lmrs_tpu_torch.engine.executor import MapExecutor
from lmrs_tpu_torch.engine.mock import MockEngine
from lmrs_tpu_torch.engine.torch_engine import TorchEngine
from lmrs_tpu_torch.serving.router import RouterEngine
from lmrs_tpu_torch.serving.server import EngineHTTPServer
from lmrs_tpu_torch.testing import faults
from lmrs_tpu_torch.testing.faults import FaultPlan, InjectedFault

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 10.0
VALID_REASONS = {"stop", "length", "error", "cancelled", "deadline",
                 "shed", "wedged"}
# the reference's sites the port carries (replicated.shard belongs to
# multi-GPU)
SITES = frozenset((
    "migrate.export", "migrate.import",
    "kv_cache.allocate", "handoff.export", "handoff.import",
    "scheduler.step", "scheduler.heartbeat", "prefix.prefetch",
    "prefix_cache.insert", "kv.disk_read", "prefix.spill", "engine.batch",
    "journal.append", "journal.fsync", "jobs.recover",
    "server.client_disconnect", "handoff.transfer", "handoff.ack",
    "router.connect", "router.probe", "router.recv", "router.hedge"))
_WORDS = ("alpha bravo charlie delta echo foxtrot golf hotel india "
          "juliet kilo lima mike november oscar papa").split()
CHAOS_CFG = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 hidden_dim=128, max_seq_len=256, dtype="float32",
                 tie_embeddings=False)
# the cycle model of the JAX comparison: the byte tokenizer's vocabulary
CYCLE_CFG = {**CHAOS_CFG, "vocab_size": 259}


class NoEosTokenizer(ByteTokenizer):
    """Bytes, with an end-of-sequence id above the byte range: ids past the
    tokenizer's vocabulary are never sampled, so no request stops early and
    every scenario keeps its shape (decode rows beside mixed steps)."""

    eos_id = 511


@pytest.fixture(autouse=True)
def no_plan_leaks():
    """Every test starts and ends with both planes disarmed."""
    faults.uninstall()
    jfaults.uninstall()
    yield
    faults.uninstall()
    jfaults.uninstall()


@pytest.fixture(autouse=True)
def ref_surfaces_off(monkeypatch):
    for k in ("LMRS_COST_LEDGER", "LMRS_SLO", "LMRS_ANATOMY", "LMRS_QOS",
              "LMRS_KV_MIGRATE"):
        monkeypatch.setenv(k, "0")


# ------------------------------------------------------------- the plane

PLANS = {
    "every": [{"site": "a", "every": 3}],
    "at": [{"site": "a", "at": [1, 4, 9]}, {"site": "b", "at": [2]}],
    "prob": [{"site": "a", "p": 0.3}, {"site": "b", "p": 0.6}],
    "times": [{"site": "a", "p": 0.5, "max_fires": 2},
              {"site": "b", "every": 2, "max_fires": 3}],
    "stall": [{"site": "a", "every": 4, "action": "stall",
               "stall_s": 0.001},
              {"site": "b", "p": 0.4, "action": "stall", "stall_s": 0.001}],
    "combo": [{"site": "a", "at": [2], "p": 0.25, "max_fires": 4},
              {"site": "a", "every": 5},
              {"site": "b", "p": 0.5, "stall_s": 0.001}],
}
CALLS = ("a", "b", "a", "a", "b", "c") * 7


def _drive(mod, plan_faults, seed, use_check: bool) -> tuple:
    """One injector of ``mod`` through CALLS: the fired occurrences and,
    per call, what ``fire`` (raised?) or ``check`` answered."""
    inj = mod.FaultInjector(mod.FaultPlan(seed=seed, faults=plan_faults))
    answers = []
    for site in CALLS:
        if use_check:
            answers.append(inj.check(site))
        else:
            try:
                inj.fire(site)
                answers.append(False)
            except mod.InjectedFault:
                answers.append(True)
    return answers, list(inj.fires), {s: inj.occurrences(s) for s in "abc"}


@pytest.mark.parametrize("use_check", [False, True])
@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_injector_fires_like_reference(plan, seed, use_check):
    port = _drive(faults, PLANS[plan], seed, use_check)
    ref = _drive(jfaults, PLANS[plan], seed, use_check)
    assert port == ref
    if plan != "stall":
        assert any(port[0]), "the plan never fired"


def test_plan_from_path_matches_reference(tmp_path):
    spec = {"seed": 5, "faults": PLANS["combo"]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(spec))
    for text in (f"@{path}", json.dumps(spec)):
        tp, jp = faults.FaultPlan.from_spec(text), jfaults.FaultPlan.from_spec(text)
        assert tp.seed == jp.seed == 5
        assert ([dataclasses.asdict(f) for f in tp.faults]
                == [dataclasses.asdict(f) for f in jp.faults])
        assert (_drive(faults, tp.faults, tp.seed, False)
                == _drive(jfaults, jp.faults, jp.seed, False))
    with pytest.raises(ValueError):
        faults.FaultSpec(site="x")  # no trigger
    with pytest.raises(ValueError):
        faults.FaultSpec(site="x", every=1, action="explode")


def test_plan_object_reinstalls_replay_identically():
    """All evaluation state lives on the injector: installing the same
    plan object again replays exactly (``at=[1]`` fires every time)."""
    plan = FaultPlan(seed=7, faults=[
        {"site": "s", "at": [1], "max_fires": 1},
        {"site": "q", "p": 0.5, "max_fires": 2}])
    runs = []
    for _ in range(3):
        with faults.injected(plan) as inj:
            outcomes = []
            for site in ("s", "q"):
                for _ in range(6):
                    try:
                        faults.fire(site)
                        outcomes.append(0)
                    except InjectedFault:
                        outcomes.append(1)
            runs.append((outcomes, list(inj.fires)))
        assert faults.active() is None
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][0][0] == 1


def test_install_spec_is_idempotent_per_process():
    """Re-arming the same spec string keeps the live injector (``max_fires``
    spent stays spent: once per process, not per engine built); another
    string replaces it; an empty one disarms."""
    spec = '{"faults": [{"site": "z", "at": [1], "max_fires": 1}]}'
    inj1 = faults.install_spec(spec)
    with pytest.raises(InjectedFault):
        faults.fire("z")
    assert faults.install_spec(spec) is inj1
    faults.fire("z")  # spent: no second fire
    assert faults.install_spec(spec + " ") is not inj1
    assert faults.install_spec("") is None and faults.active() is None


def test_disarmed_sites_are_one_none_test():
    assert faults.active() is None
    faults.fire("kv_cache.allocate")
    assert faults.check("server.client_disconnect") is False


def test_env_plan_is_read_at_import(tmp_path):
    """``LMRS_FAULT_PLAN`` arms the plane at import (the ``@path`` form
    too); a bad plan fails loudly by name."""
    import subprocess
    import sys

    plan = tmp_path / "p.json"
    plan.write_text('{"seed": 3, "faults": [{"site": "x", "every": 2}]}')
    code = ("from lmrs_tpu_torch.testing import faults\n"
            "inj = faults.active()\n"
            "print(inj.plan.seed, [f.site for f in inj.plan.faults])\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "LMRS_FAULT_PLAN": f"@{plan}"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["3", "['x']"]
    env["LMRS_FAULT_PLAN"] = "{not json"
    bad = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert bad.returncode != 0 and "bad LMRS_FAULT_PLAN" in bad.stderr


def test_make_engine_installs_the_config_plan():
    from lmrs_tpu_torch.engine.api import make_engine

    spec = '{"seed": 2, "faults": [{"site": "engine.batch", "at": [1]}]}'
    eng = make_engine(EngineConfig(backend="mock", fault_plan=spec))
    inj = faults.active()
    assert inj is not None and inj.plan.seed == 2
    with pytest.raises(InjectedFault):
        eng.generate_batch([GenerationRequest(prompt="x", request_id=0)])
    assert eng.generate_batch([GenerationRequest(prompt="x", request_id=1)])


def test_port_sites_are_the_reference_sites():
    """Every ``faults.fire``/``faults.check`` site name in the port is one
    of the 22 it carries, and all 22 are there."""
    found = set()
    for path in (REPO / "lmrs_tpu_torch").rglob("*.py"):
        found |= set(re.findall(r'faults\.(?:fire|check)\(\s*"([a-z_.]+)"',
                                path.read_text()))
    # the server's transfer and ack sites are named by their caller
    src = (REPO / "lmrs_tpu_torch/serving/server.py").read_text()
    found |= set(re.findall(r'site="([a-z_.]+)"', src))
    assert found == SITES


# ------------------------------------------------------------- the soak

def chaos_engine(**kw) -> TorchEngine:
    cfg = EngineConfig(**{"max_tokens": 64, "max_batch_slots": 2, "seed": 0,
                          "decode_block": 4, "page_size": 16,
                          "num_pages": 20, **kw})
    return TorchEngine(cfg, TModelConfig(name="chaos", **CHAOS_CFG),
                       device="cpu", tokenizer=NoEosTokenizer())


@pytest.fixture(scope="module")
def engine():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    eng = chaos_engine()
    yield eng
    eng.shutdown()
    torch.set_num_threads(n)


def make_workload(rng, n, deadlines=False, greedy=False, mk=GenerationRequest):
    reqs = []
    for i in range(n):
        prompt = f"chaos {i} " + " ".join(
            rng.choice(_WORDS) for _ in range(rng.randint(2, 24)))
        req = mk(prompt=prompt, request_id=i,
                 temperature=0.0 if greedy else rng.choice((0.0, 0.8)),
                 max_new_tokens=rng.randint(2, 16))
        if deadlines and rng.random() < 0.4:
            req.deadline_s = time.time() + rng.choice((-1.0, 0.05, 30.0))
        reqs.append(req)
    return reqs


def soak(eng, seed, plan_faults, deadlines=False, retries=3, greedy=False,
         retry_delay=0.01, audit=True):
    """One pinned scenario (the reference's ``soak``): a seeded workload
    under a seeded plan through the executor's retries; every request
    terminates once with a valid reason; the audit is clean."""
    rng = random.Random(seed)
    reqs = make_workload(rng, rng.randint(3, 6), deadlines, greedy)
    ex = MapExecutor(eng, EngineConfig(retry_attempts=retries,
                                       retry_delay=retry_delay))
    with faults.injected(FaultPlan(seed=seed, faults=plan_faults)) as inj:
        results = ex.run_requests(reqs)
    assert [r.request_id for r in results] == [r.request_id for r in reqs]
    for res in results:
        assert res.finish_reason in VALID_REASONS, res
        if res.finish_reason in ("stop", "length", "cancelled", "shed"):
            assert res.error is None, res
    if audit:
        assert eng.audit() == []
    return results, inj


ENGINE_PLANS = {
    "oom": [{"site": "kv_cache.allocate", "p": 0.35, "max_fires": 6}],
    "step": [{"site": "scheduler.step", "at": [4], "max_fires": 1}],
    "insert": [{"site": "prefix_cache.insert", "p": 0.6, "max_fires": 8}],
    "combo": [{"site": "kv_cache.allocate", "p": 0.25, "max_fires": 4},
              {"site": "scheduler.step", "at": [7], "max_fires": 1},
              {"site": "prefix_cache.insert", "p": 0.5, "max_fires": 4},
              {"site": "engine.batch", "at": [1], "max_fires": 1}],
}
MOCK_PLANS = {
    "batch": [{"site": "engine.batch", "at": [1], "max_fires": 1}],
    "batch_p": [{"site": "engine.batch", "p": 0.5, "max_fires": 2}],
}


@pytest.mark.parametrize("seed", [11, 23])
@pytest.mark.parametrize("plan", sorted(ENGINE_PLANS))
def test_chaos_engine(engine, seed, plan):
    _, inj = soak(engine, seed, ENGINE_PLANS[plan],
                  deadlines=(plan == "combo"))
    sites = {s for s, _ in inj.fires}
    if plan != "combo":
        assert sites == {ENGINE_PLANS[plan][0]["site"]}, inj.fires


@pytest.mark.parametrize("seed", [3, 5, 9])
@pytest.mark.parametrize("plan", sorted(MOCK_PLANS))
def test_chaos_mock(seed, plan):
    _, inj = soak(MockEngine(seed=0), seed, MOCK_PLANS[plan], deadlines=True,
                  audit=False)
    assert all(s == "engine.batch" for s, _ in inj.fires)


def test_armed_but_silent_plan_is_token_identical(engine):
    def run():
        return engine.generate_batch([GenerationRequest(
            prompt="fault plane ab check", request_id=0, temperature=0.0,
            max_new_tokens=12)])[0]

    base = run()
    with faults.injected(FaultPlan(seed=1, faults=[
            {"site": "no.such.site", "at": [1]}])):
        armed = run()
    after = run()
    assert base.text == armed.text == after.text
    assert base.finish_reason == armed.finish_reason == after.finish_reason


def test_identical_seeds_identical_outcomes(engine):
    def once(eng, seed, plan):
        res, _ = soak(eng, seed, plan, greedy=True,
                      audit=isinstance(eng, TorchEngine))
        return [(r.request_id, r.finish_reason, r.text, r.completion_tokens)
                for r in res]

    assert once(engine, 31, ENGINE_PLANS["insert"]) == \
        once(engine, 31, ENGINE_PLANS["insert"])
    mock = MockEngine(seed=0)
    assert once(mock, 29, MOCK_PLANS["batch_p"]) == \
        once(mock, 29, MOCK_PLANS["batch_p"])


# --------------------------------------- scheduler.step: the JAX package

def _cycle_tree(seed=3):
    """Test-width JAX params whose greedy next byte is the byte after the
    current one (large logit margins: both packages' argmax agree)."""
    import jax

    from lmrs_tpu.config import ModelConfig as JModelConfig
    from lmrs_tpu.models.transformer import init_params as j_init_params

    jcfg = JModelConfig(name="cycle", **CYCLE_CFG)
    tree = jax.tree.map(np.array, j_init_params(jcfg, jax.random.PRNGKey(seed)))
    r = np.random.default_rng(seed)
    emb = r.standard_normal(tree["embed"]["weight"].shape).astype(np.float32)
    head = 0.01 * r.standard_normal(
        tree["lm_head"]["weight"].shape).astype(np.float32)
    ids = np.arange(3, 259)
    head[:, 3 + (ids - 3 + 1) % 256] = 0.1 * emb[ids].T
    tree["embed"]["weight"], tree["lm_head"]["weight"] = emb, head
    tree["layers"]["attn"]["wo"] *= 0.1
    tree["layers"]["mlp"]["w_down"] *= 0.1
    return jcfg, tree


ENGINE_KW = dict(max_tokens=64, max_batch_slots=2, seed=0, decode_block=4,
                 page_size=16, num_pages=20)


@pytest.fixture(scope="module")
def cycle_pair():
    """The port's engine and the JAX package's (built once) over the same
    cycle weights."""
    import jax
    import jax.numpy as jnp

    from lmrs_tpu.config import EngineConfig as JEngineConfig
    from lmrs_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
    from lmrs_tpu.engine.jax_engine import JaxEngine
    from lmrs_tpu_torch.models.convert import params_from_jax

    jcfg, tree = _cycle_tree()
    tcfg = TModelConfig(name="cycle", **CYCLE_CFG)
    port = TorchEngine(EngineConfig(**ENGINE_KW), tcfg, device="cpu",
                       params=params_from_jax(tree, tcfg),
                       tokenizer=ByteTokenizer())
    ref = JaxEngine(JEngineConfig(backend="jax", scheduler="continuous",
                                  **ENGINE_KW), jcfg,
                    params=jax.tree.map(jnp.asarray, tree),
                    tokenizer=JByteTokenizer())
    yield port, ref
    port.shutdown()
    ref.shutdown()


def test_step_fault_recovers_and_matches_reference(cycle_pair):
    """A ``scheduler.step`` fault on the first iteration kills the run; the
    executor retries; the pool is clean and the greedy texts equal a
    fault-free run's, and the JAX package's engine on the same weights
    under the same plan."""
    from lmrs_tpu.engine.api import GenerationRequest as JRequest
    from lmrs_tpu.engine.executor import MapExecutor as JExecutor
    from lmrs_tpu.config import EngineConfig as JEngineConfig

    port, ref = cycle_pair
    plan = [{"site": "scheduler.step", "at": [1], "max_fires": 1}]
    base, _ = soak(port, 99, [], greedy=True)
    faulted, inj = soak(port, 99, plan, greedy=True)
    assert inj.fires == [("scheduler.step", 1)]
    assert [(r.request_id, r.finish_reason, r.text) for r in base] == \
        [(r.request_id, r.finish_reason, r.text) for r in faulted]
    rng = random.Random(99)  # soak's workload draw, in the JAX types
    reqs = make_workload(rng, rng.randint(3, 6), greedy=True, mk=JRequest)
    ex = JExecutor(ref, JEngineConfig(retry_attempts=3, retry_delay=0.01))
    with jfaults.injected(jfaults.FaultPlan(seed=99, faults=plan)) as jinj:
        jres = ex.run_requests(reqs)
    assert jinj.fires == inj.fires
    assert [(r.request_id, r.finish_reason, r.text) for r in jres] == \
        [(r.request_id, r.finish_reason, r.text) for r in faulted]
    assert port.audit() == [] and ref._scheduler.audit() == []


def test_fault_inside_mixed_step(engine):
    """A long prompt admitted while another request decodes prefills in
    mixed steps; OutOfPages inside their capacity growth and a step fault
    mid-run leave every greedy text as the fault-free run's."""
    sched = engine._scheduler
    assert sched._mixed

    def reqs():
        return [
            GenerationRequest(prompt="mixed chaos steady", request_id=0,
                              temperature=0.0, max_new_tokens=24),
            GenerationRequest(prompt="early finisher", request_id=1,
                              temperature=0.0, max_new_tokens=4),
            GenerationRequest(prompt="late long admission words " * 5,
                              request_id=2, temperature=0.0,
                              max_new_tokens=6)]

    def run(plan_faults):
        ex = MapExecutor(engine, EngineConfig(retry_attempts=3,
                                              retry_delay=0.01))
        before = sched.counters["mixed_dispatches"]
        with faults.injected(FaultPlan(seed=91, faults=plan_faults)):
            out = ex.run_requests(reqs())
        assert sched.counters["mixed_dispatches"] > before
        assert all(r.finish_reason in VALID_REASONS for r in out)
        assert engine.audit() == []
        return [(r.request_id, r.finish_reason, r.text) for r in out]

    baseline = run([])
    assert run([{"site": "kv_cache.allocate", "p": 0.4,
                 "max_fires": 6}]) == baseline
    assert run([{"site": "scheduler.step", "at": [6],
                 "max_fires": 1}]) == baseline


def test_spill_prefetch_and_disk_faults_stay_token_identical(tmp_path,
                                                             monkeypatch):
    """Spill tiers under fire: ``prefix.spill`` faults drop victims
    uncached, ``prefix.prefetch`` and ``kv.disk_read`` faults truncate
    matches back to re-prefill; greedy texts stay the fault-free run's and
    the audit (the host pool's accounting included) is clean after every
    wave."""
    eng = chaos_engine(num_pages=48, max_batch_slots=4, kv_disk=True,
                       kv_disk_gb=1.0, kv_disk_dir=str(tmp_path),
                       host_kv_gb=0.0002)
    pre = "Shared chaos preamble: keep every fact, name, and number. "

    def reqs():
        return [GenerationRequest(
            prompt=pre + f"chunk {i}: the team discussed item {i}.",
            request_id=900 + i, temperature=0.0, max_new_tokens=8,
            cache_prefix=len(pre)) for i in range(5)]

    try:
        baseline = [r.text for r in eng.generate_batch(reqs())]
        pc = eng._scheduler._prefix_cache
        assert pc is not None and pc.pool is not None and eng.audit() == []
        plan = [{"site": "prefix.spill", "p": 0.5},
                {"site": "prefix.prefetch", "p": 0.5},
                {"site": "kv.disk_read", "p": 0.5}]
        with faults.injected(FaultPlan(seed=29, faults=plan)) as inj:
            for _ in range(3):
                pc.evict(10_000)
                assert eng.audit() == []
                assert [r.text for r in eng.generate_batch(reqs())] == baseline
                assert eng.audit() == []
        fired = {s for s, _ in inj.fires}
        assert {"prefix.spill", "prefix.prefetch"} <= fired, inj.fires
        if "kv.disk_read" in fired:
            assert eng._scheduler.counters["disk_read_failures"] > 0
    finally:
        eng.shutdown()


def test_disk_read_fault_drops_the_entry(tmp_path):
    """``kv.disk_read`` raises a ``DiskReadError`` inside ``_disk_read``:
    the prefetch drops the demoted entry and re-prefills, counted as a
    read failure; texts unchanged, audit clean.  Two 4-page preambles over
    a 4-page host budget: the eviction demotes one to disk."""
    probe = chaos_engine()
    page = probe._scheduler.cache.page_payload_bytes()
    probe.shutdown()
    eng = chaos_engine(num_pages=48, max_batch_slots=4, kv_disk=True,
                       kv_disk_gb=1.0, kv_disk_dir=str(tmp_path),
                       host_kv_gb=4 * page / 2**30)
    pres = ["Disk tier preamble A: keep every fact, name and number here. ",
            "Disk tier preamble B: keep every fact, name and number here. "]

    def reqs():
        return [GenerationRequest(prompt=pres[i // 2] + f"item {i}",
                                  request_id=i, temperature=0.0,
                                  max_new_tokens=6,
                                  cache_prefix=len(pres[i // 2]))
                for i in range(4)]

    try:
        base = [r.text for r in eng.generate_batch(reqs())]
        pc = eng._scheduler._prefix_cache
        pc.evict(10_000)
        assert len(pc.disk), "nothing demoted to disk"
        with faults.injected(FaultPlan(faults=[
                {"site": "kv.disk_read", "every": 1}])) as inj:
            got = [r.text for r in eng.generate_batch(reqs())]
        assert got == base and inj.fires
        assert eng._scheduler.counters["disk_read_failures"] >= 1
        assert eng.audit() == []
    finally:
        eng.shutdown()


# ------------------------------------------------------- handoff chaos

def _req(rid, **kw):
    return GenerationRequest(
        prompt="chaos handoff probe alpha bravo charlie delta echo",
        request_id=rid, temperature=0.0, max_new_tokens=10, **kw)


@pytest.fixture(scope="module")
def disagg():
    """A prefill-role and a decode-role server over the port's CPU engine
    behind the port's router, and the colocated greedy text."""
    pre_eng = chaos_engine(num_pages=48, handoff_ttl_s=30.0)
    dec_eng = chaos_engine(num_pages=48, handoff_ttl_s=30.0)
    pre = EngineHTTPServer(pre_eng, port=0, role="prefill",
                           handoff_ttl_s=30.0, batch_window_s=0.01)
    dec = EngineHTTPServer(dec_eng, port=0, role="decode",
                           handoff_ttl_s=30.0, batch_window_s=0.01)
    pre.start_background()
    dec.start_background()
    router = RouterEngine([], timeout_s=TIMEOUT,
                          prefill_hosts=[f"127.0.0.1:{pre.port}"],
                          decode_hosts=[f"127.0.0.1:{dec.port}"])
    colo = RouterEngine([f"127.0.0.1:{pre.port}"], timeout_s=TIMEOUT)
    base = colo.generate_batch([_req(0)])[0]
    assert base.error is None and base.completion_tokens > 1
    yield pre, dec, router, base.text
    for r in (router, colo):
        r.shutdown()
    for s in (pre, dec):
        s.shutdown()
    pre_eng.shutdown()
    dec_eng.shutdown()


def _settle(pre, dec) -> None:
    pre.sweep_handoffs(now=time.time() + 3600.0)
    dec.sweep_handoffs(now=time.time() + 3600.0)
    assert pre.engine.pinned_handoffs() == {}
    assert pre.engine.audit() == [] and dec.engine.audit() == []


def test_handoff_baseline_token_identical(disagg):
    pre, dec, router, want = disagg
    res = router.generate_batch([_req(1)])[0]
    assert res.error is None and res.text == want
    assert pre.engine.pinned_handoffs() == {}  # acked
    _settle(pre, dec)


@pytest.mark.parametrize("site", ["handoff.transfer", "handoff.export",
                                  "handoff.import"])
def test_handoff_fault_falls_back_colocated(disagg, site):
    """A transfer dying mid-payload, a pin-time capture fault or a
    decode-side import fault: a marked failure the router falls back from
    with a colocated re-prefill; the request completes identically and
    every pin comes back (by ack or the orphan sweep)."""
    pre, dec, router, want = disagg
    fallbacks = router._handoff_fallbacks
    with faults.injected(FaultPlan(seed=41, faults=[
            {"site": site, "at": [1], "max_fires": 1}])) as inj:
        res = router.generate_batch([_req(2)])[0]
    assert inj.fires == [(site, 1)]
    assert res.error is None and res.text == want
    assert router._handoff_fallbacks == fallbacks + 1
    _settle(pre, dec)


def test_handoff_decode_pod_down_after_export(disagg):
    """A connect fault on the decode leg (occurrence 2: the prefill leg
    was 1): the router re-prefills colocated; the pins are swept."""
    pre, dec, router, want = disagg
    fallbacks = router._handoff_fallbacks
    with faults.injected(FaultPlan(seed=43, faults=[
            {"site": "router.connect", "at": [2], "max_fires": 1}])) as inj:
        res = router.generate_batch([_req(3)])[0]
    assert inj.fires == [("router.connect", 2)]
    assert res.error is None and res.text == want
    assert router._handoff_fallbacks == fallbacks + 1
    _settle(pre, dec)
    for h in router.hosts:
        h.healthy = True


def test_handoff_ack_lost_then_duplicate_rejected(disagg):
    """Both ack attempts vanish: the request completes, the pages stay
    pinned until the sweep, and re-delivering the ticket is refused
    (409) instead of importing twice."""
    import http.client

    pre, dec, router, want = disagg
    with faults.injected(FaultPlan(seed=47, faults=[
            {"site": "handoff.ack", "every": 1, "max_fires": 2}])) as inj:
        res = router.generate_batch([_req(4)])[0]
    assert [s for s, _ in inj.fires] == ["handoff.ack"] * 2
    assert res.error is None and res.text == want
    assert pre.engine.pinned_handoffs()
    tid = next(t for t, r in pre.handoff._tickets.items()
               if not r["consumed"])
    body = json.dumps({
        "messages": [{"role": "user", "content": _req(4).prompt}],
        "max_tokens": 10, "temperature": 0.0,
        "handoff": {"ticket": tid, "source": f"127.0.0.1:{pre.port}"}})
    conn = http.client.HTTPConnection("127.0.0.1", dec.port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/v1/chat/completions", body=body,
                     headers={"Content-Type": "application/json"})
        assert conn.getresponse().status == 409
    finally:
        conn.close()
    _settle(pre, dec)


def test_mock_handoff_sites_mark_errors():
    """The mock's export and import sites degrade per request."""
    m = MockEngine()
    with faults.injected(FaultPlan(faults=[
            {"site": "handoff.export", "at": [1]}])):
        res = m.generate_batch([GenerationRequest(
            prompt="one two three four five six", request_id=0,
            handoff_export=True)])[0]
    assert res.finish_reason == "error" and "handoff export" in res.error
    with faults.injected(FaultPlan(faults=[
            {"site": "handoff.import", "at": [1]}])):
        res = m.generate_batch([GenerationRequest(
            prompt="x", request_id=1,
            handoff_state={"text": "y", "prompt_tokens": 1})])[0]
    assert res.finish_reason == "error" and "handoff import" in res.error
    assert m.pinned_handoffs() == {}


# ------------------------------------------------ server and router sites

def test_client_disconnect_site_cancels_the_request():
    """``server.client_disconnect`` reports the client gone while a slow
    non-streamed request waits: the server cancels it through the
    engine's ``cancel`` hook."""
    import http.client

    class Recording(MockEngine):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.cancels = []

        def cancel(self, request_id):
            self.cancels.append(request_id)
            super().cancel(request_id)

    srv = EngineHTTPServer(Recording(latency_s=1.2), port=0,
                           batch_window_s=0.01)
    srv.start_background()
    try:
        with faults.injected(FaultPlan(faults=[
                {"site": "server.client_disconnect", "at": [1]}])) as inj:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=TIMEOUT)
            try:
                conn.request("POST", "/v1/chat/completions", body=json.dumps(
                    {"messages": [{"role": "user", "content": "hi there"}],
                     "max_tokens": 8}),
                    headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
            finally:
                conn.close()
        assert inj.fires[0] == ("server.client_disconnect", 1)
        assert len(srv.engine.cancels) == 1
        assert body["choices"][0]["finish_reason"] == "cancelled"
    finally:
        srv.shutdown()


def test_router_probe_and_recv_sites():
    """``router.probe`` keeps a condemned host down through a probe;
    ``router.recv`` fails a streamed request mid-stream (a marked error
    once no retry can replay deltas)."""
    srv = EngineHTTPServer(MockEngine(), port=0, batch_window_s=0.01)
    srv.start_background()
    router = RouterEngine([f"127.0.0.1:{srv.port}"], timeout_s=TIMEOUT)
    try:
        host = router.hosts[0]
        host.healthy = False
        with faults.injected(FaultPlan(faults=[
                {"site": "router.probe", "at": [1]}])) as inj:
            assert host.probe() is False
            assert host.probe() is True
        assert inj.fires == [("router.probe", 1)] and host.healthy
        deltas = []
        with faults.injected(FaultPlan(faults=[
                {"site": "router.recv", "at": [2]}])) as inj:
            res = router.generate_batch(
                [GenerationRequest(prompt="stream me a summary please",
                                   request_id=5)],
                on_tokens=lambda rid, d: deltas.append(d))[0]
        assert inj.fires == [("router.recv", 2)]
        assert res.finish_reason == "error" and "injected" in res.error
    finally:
        router.shutdown()
        srv.shutdown()


# ------------------------------------------------------ journal and jobs

def test_journal_sites_degrade_without_losing_the_job(tmp_path):
    """``journal.append`` / ``journal.fsync`` faults mark the journal
    degraded and the job still completes with the fault-free summary;
    ``jobs.recover`` fails one job's recovery (registered ``failed``)
    while the next recovers."""
    from lmrs_tpu_torch.jobs.manager import JobManager
    from lmrs_tpu_torch.config import PipelineConfig
    from lmrs_tpu_torch.utils.demo import load_demo_transcript

    transcript = load_demo_transcript(max_segments=40)
    cfg = PipelineConfig()

    def run(d, plan):
        jm = JobManager(MockEngine(seed=0), d, config=cfg, start_worker=False)
        with faults.injected(FaultPlan(faults=plan)) as inj:
            job = jm.submit(transcript)
            jm.run_job(job)
        jm.shutdown()
        return job, inj

    want, _ = run(tmp_path / "a", [])
    assert want.status == "done"
    for site in ("journal.append", "journal.fsync"):
        job, inj = run(tmp_path / site, [{"site": site, "every": 2}])
        assert inj.fires and {s for s, _ in inj.fires} == {site}
        assert job.status == "done"
        assert job.result["summary"] == want.result["summary"]
    # two interrupted jobs on disk: the first recovery fails, the second
    # re-queues
    d = tmp_path / "rec"
    jm = JobManager(MockEngine(seed=0), d, config=cfg, start_worker=False)
    jobs = [jm.submit(transcript),
            jm.submit(load_demo_transcript(max_segments=20))]
    jm.shutdown()
    jm2 = JobManager(MockEngine(seed=0), d, config=cfg, start_worker=False)
    with faults.injected(FaultPlan(faults=[
            {"site": "jobs.recover", "at": [1]}])) as inj:
        assert jm2.recover() == 1
    assert inj.fires == [("jobs.recover", 1)]
    states = sorted(jm2.get(j.job_id).status for j in jobs)
    assert states == ["failed", "queued"]
    jm2.shutdown()
