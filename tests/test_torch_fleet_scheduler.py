"""Port parity, fair-share QoS in the continuous scheduler: a reference
``JaxEngine`` and a port ``TorchEngine`` on the same tiny f32 weights
(``params_from_jax``) on the CPU, two tenants in both classes under a pool
that preempts, QoS at its default: admission order, preemption victims,
greedy texts and the ``lmrs_qos_*`` counters equal; with ``LMRS_QOS=0``
both admit FIFO.  The policy, mock, server, router and autoscaler are in
``tests/test_torch_fleet.py``."""

from __future__ import annotations

import numpy as np
import pytest

from lmrs_tpu.engine import api as j_api
from lmrs_tpu_torch.engine import api as t_api

# ---------------------------------------------------------- scheduler

# the tiny model of tests/test_torch_engine.py
CFG = dict(vocab_size=300, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
           hidden_dim=160, max_seq_len=128, dtype="float32",
           tie_embeddings=False)
# three slots over a pool that preempts while the two interactive
# requests and one batch request decode
EKW = dict(max_batch_slots=3, page_size=16, num_pages=14, decode_block=4,
           max_tokens=32, prefill_chunk=4096, seed=0)


def contention(mk) -> list:
    """Four batch requests of tenant ``bulk``, then two interactive ones of
    tenant ``live``, all greedy."""
    return [mk(prompt=f"request {i} " + "lorem ipsum " * (2 + i % 3),
               request_id=i, temperature=0.0, max_new_tokens=24 + 2 * i,
               tenant="live" if i >= 4 else "bulk",
               qos_class="interactive" if i >= 4 else "batch")
            for i in range(6)]


def run_scheduler(name: str, qos: bool) -> dict:
    import jax

    from lmrs_tpu.config import EngineConfig as JEngineConfig
    from lmrs_tpu.config import ModelConfig as JModelConfig
    from lmrs_tpu.models.transformer import init_params as j_init_params
    from lmrs_tpu.obs import trace as j_trace
    from lmrs_tpu_torch.config import EngineConfig, ModelConfig
    from lmrs_tpu_torch.engine.torch_engine import TorchEngine
    from lmrs_tpu_torch.models.convert import params_from_jax
    from lmrs_tpu_torch.obs import trace as t_trace

    from test_torch_engine import WideIdTokenizer

    jcfg = JModelConfig(name="t", **CFG)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(7)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LMRS_QOS", "1" if qos else "0")
        tmod = j_trace if name == "ref" else t_trace
        tmod.enable_tracing()
        try:
            if name == "ref":
                from lmrs_tpu.engine.jax_engine import JaxEngine

                eng = JaxEngine(
                    JEngineConfig(backend="jax", scheduler="continuous",
                                  retry_delay=0.0, **EKW), jcfg,
                    params=jax.tree.map(jax.numpy.asarray, tree),
                    tokenizer=WideIdTokenizer())
                mk = j_api.GenerationRequest
            else:
                tcfg = ModelConfig(name="t", **CFG)
                eng = TorchEngine(EngineConfig(**EKW), tcfg, device="cpu",
                                  params=params_from_jax(tree, tcfg),
                                  tokenizer=WideIdTokenizer())
                mk = t_api.GenerationRequest
            res = eng.generate_batch(contention(mk))
            events = sorted(sum(tmod.get_tracer().spans_by_tid().values(),
                                []), key=lambda e: e["ts"])
        finally:
            tmod.disable_tracing()
    base = tmod.REQ_TID_BASE
    marks = []
    for e in events:
        if e["name"] in ("admit", "preempt"):
            marks.append((e["name"], e["tid"] - base))
        elif e["name"] in ("qos_preempt", "qos_reorder"):
            marks.append((e["name"], e["args"]["tenant"]))
    sched = eng._scheduler
    counters = {k: sched.registry.counter(k).value
                for k in ("lmrs_qos_reorders_total",
                          "lmrs_qos_preempt_victims_total")} if qos else {}
    out = {"marks": marks,
           "texts": [(r.text, r.finish_reason, r.completion_tokens)
                     for r in res],
           "preemptions": eng.engine_metrics()["preemptions"],
           "counters": counters, "audit": sched.audit(),
           "qos": eng.qos_report()}
    eng.shutdown()
    return out


@pytest.fixture(scope="module")
def sched_runs():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield {(name, qos): run_scheduler(name, qos)
               for name in ("ref", "port") for qos in (True, False)}
    finally:
        torch.set_num_threads(n)


def test_scheduler_qos_admission_matches_reference(sched_runs):
    ref, port = sched_runs[("ref", True)], sched_runs[("port", True)]
    assert port["marks"] == ref["marks"]
    admits = [rid for name, rid in port["marks"] if name == "admit"]
    # the interactive requests, last in the queue, are admitted first
    assert admits[:2] == [4, 5]
    assert port["counters"] == ref["counters"]
    assert port["counters"]["lmrs_qos_reorders_total"] >= 1


def test_scheduler_qos_victims_are_batch_in_both(sched_runs):
    ref, port = sched_runs[("ref", True)], sched_runs[("port", True)]
    victims = [t for name, t in port["marks"] if name == "qos_preempt"]
    assert victims == [t for name, t in ref["marks"] if name == "qos_preempt"]
    assert victims and set(victims) == {"bulk"}
    assert port["preemptions"] == ref["preemptions"] == len(victims)
    assert port["counters"]["lmrs_qos_preempt_victims_total"] == len(victims)
    assert port["audit"] == ref["audit"] == []


def test_scheduler_qos_texts_and_report_match_reference(sched_runs):
    ref, port = sched_runs[("ref", True)], sched_runs[("port", True)]
    assert port["texts"] == ref["texts"]
    # QoS reorders admission, never a request's tokens
    assert port["texts"] == sched_runs[("port", False)]["texts"]
    assert port["qos"]["enabled"] is True
    assert sorted(port["qos"]) == sorted(ref["qos"])
    assert sorted(port["qos"]["tenants"]) == sorted(ref["qos"]["tenants"])


def test_scheduler_qos_off_is_fifo_in_both(sched_runs):
    ref, port = sched_runs[("ref", False)], sched_runs[("port", False)]
    assert port["marks"] == ref["marks"]
    assert not any(name.startswith("qos") for name, _ in port["marks"])
    admits = [rid for name, rid in port["marks"] if name == "admit"]
    assert admits[:3] == [0, 1, 2]
    assert port["qos"] == ref["qos"] == {"object": "qos", "enabled": False}
    assert port["texts"] == ref["texts"]
