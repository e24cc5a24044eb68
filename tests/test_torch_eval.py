"""Port parity of the evaluation slice: ``eval.rouge`` and
``eval.synthetic`` (copies: every number and example equal to the
reference's), ``eval.parity`` (``run_parity`` over the mock pipeline gives
the reference's report, wall times aside) and the
``python -m lmrs_tpu_torch.eval.parity`` exit codes.  No device, no JAX
compile."""

import json

import pytest

from lmrs_tpu.config import EngineConfig as JEngineConfig
from lmrs_tpu.config import PipelineConfig as JPipelineConfig
from lmrs_tpu.eval import parity as jparity
from lmrs_tpu.eval import rouge as jrouge
from lmrs_tpu.eval import synthetic as jsynthetic
from lmrs_tpu_torch import eval as teval
from lmrs_tpu_torch.config import EngineConfig, PipelineConfig
from lmrs_tpu_torch.eval import parity, rouge, synthetic
from lmrs_tpu_torch.utils.demo import load_demo_transcript

# the reference surfaces the port's mock does not carry (test_torch_mock.py)
REF_OFF = {"LMRS_COST_LEDGER": "0", "LMRS_SLO": "0", "LMRS_ANATOMY": "0",
           "LMRS_QOS": "0"}
PAIRS = [
    ("the cat sat on the mat", "the cat is on the mat"),
    ("Budget, hiring, roadmap.", " budget, hiring."),
    ("", "anything at all"),
    ("police killed the gunman", "the gunman was shot by police"),
    ("a a a b", "a b b b a"),
    ("Ünïcode words: café 2026!", "cafe 2026 words"),
]


@pytest.fixture(autouse=True)
def ref_surfaces_off(monkeypatch):
    for k, v in REF_OFF.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("cand,ref", PAIRS)
def test_rouge_matches_reference(cand, ref):
    assert rouge.tokenize(cand) == jrouge.tokenize(cand)
    for n in (1, 2, 3):
        assert rouge.rouge_n(cand, ref, n) == jrouge.rouge_n(cand, ref, n)
    assert rouge.rouge_l(cand, ref) == jrouge.rouge_l(cand, ref)
    refs = [ref, cand + " extra", "unrelated"]
    assert rouge.rouge_scores(cand, refs) == jrouge.rouge_scores(cand, refs)
    assert teval.rouge_l(cand, ref) == jrouge.rouge_l(cand, ref)  # lazy export


@pytest.mark.parametrize("seed", [0, 999])
def test_synthetic_dataset_matches_reference(seed):
    got, want = synthetic.make_dataset(48, seed), jsynthetic.make_dataset(48, seed)
    assert got == want
    assert [synthetic.extractive_baseline(ex["prompt"]) for ex in got] == \
        [jsynthetic.extractive_baseline(ex["prompt"]) for ex in want]
    assert (synthetic.TOPICS, synthetic._OPENERS, synthetic._FILLER) == \
        (jsynthetic.TOPICS, jsynthetic._OPENERS, jsynthetic._FILLER)


def test_baseline_loading_matches_reference(tmp_path):
    plain = tmp_path / "b.txt"
    plain.write_text("  a plain summary \n")
    rec = tmp_path / "b.json"
    rec.write_text(json.dumps({"summary": " recorded ", "meta": {}}))
    for path in (plain, rec):
        assert parity.load_baseline(path) == jparity.load_baseline(path)
    for body, match in (({"text": "x"}, "no top-level 'summary'"),
                        (["x"], "JSON array")):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps(body))
        for load in (parity.load_baseline, jparity.load_baseline):
            with pytest.raises(ValueError, match=match):
                load(bad)
    got = parity.evaluate_parity(*PAIRS[0], threshold=0.5).to_dict()
    assert got == jparity.evaluate_parity(*PAIRS[0], threshold=0.5).to_dict()


def _mock_reports(transcript):
    baseline = "the team discussed the kernel design and the review timeline"
    got = parity.run_parity(transcript, baseline, PipelineConfig(
        engine=EngineConfig(backend="mock")), threshold=0.01)
    want = jparity.run_parity(transcript, baseline, JPipelineConfig(
        engine=JEngineConfig(backend="mock")), threshold=0.01)
    return got.to_dict(), want.to_dict()


@pytest.mark.parametrize("which", ["demo", "example"])
def test_run_parity_mock_matches_reference(which, request):
    """The mock pipeline's report in both packages: scores, chunk count,
    summary and verdict equal (wall times differ)."""
    transcript = (load_demo_transcript(160) if which == "demo"
                  else request.getfixturevalue("example_transcript"))
    got, want = _mock_reports(transcript)
    for d in (got, want):
        assert d.pop("wall_s") > 0
        d.pop("chunks_per_sec")
    assert got == want
    assert got["chunks"] > 1 and got["summary"]


def _cli(argv, capsys):
    rc = parity._main(argv)
    return rc, capsys.readouterr()


def test_parity_cli_exit_codes(tmp_path, capsys):
    """0 when ROUGE-L clears the gate, 1 when it does not, 2 for an
    unreadable transcript, a baseline without a summary, or a backend the
    port refuses (``jax``, by name)."""
    src = tmp_path / "t.json"
    src.write_text(json.dumps(load_demo_transcript(80)))
    base = tmp_path / "b.txt"
    base.write_text("the team discussed the kernel design")
    args = ["--input", str(src), "--baseline", str(base)]
    rc, out = _cli(args + ["--threshold", "0.0", "--json"], capsys)
    assert rc == 0 and json.loads(out.out)["passed"] is True
    rc, out = _cli(args + ["--threshold", "1.01"], capsys)
    assert rc == 1 and "FAIL" in out.out
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    rc, out = _cli(["--input", str(bad), "--baseline", str(base)], capsys)
    assert rc == 2 and "cannot read transcript" in out.err
    nosum = tmp_path / "n.json"
    nosum.write_text(json.dumps({"text": "x"}))
    rc, out = _cli(["--input", str(src), "--baseline", str(nosum)], capsys)
    assert rc == 2 and "no top-level 'summary'" in out.err
    rc, out = _cli(args + ["--backend", "jax"], capsys)
    assert rc == 2 and "JAX package's engine" in out.err
