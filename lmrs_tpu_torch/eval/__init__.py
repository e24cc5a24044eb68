"""Quality-parity evaluation (the port of the reference's ``eval/``): ROUGE
metrics (``rouge``), the synthetic summarization task of the quality gates
(``synthetic``) and the parity harness (``parity``)."""

__all__ = [
    "rouge_l",
    "rouge_n",
    "rouge_scores",
    "ParityReport",
    "evaluate_parity",
    "run_parity",
]

_ROUGE = {"rouge_l", "rouge_n", "rouge_scores"}


def __getattr__(name: str):
    # Lazy so `python -m lmrs_tpu_torch.eval.parity` doesn't double-import
    # parity.
    if name in _ROUGE:
        from lmrs_tpu_torch.eval import rouge

        return getattr(rouge, name)
    if name in __all__:
        from lmrs_tpu_torch.eval import parity

        return getattr(parity, name)
    raise AttributeError(name)
