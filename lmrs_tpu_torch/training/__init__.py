"""Training and fine-tuning (the port of the reference's ``training/``):
the causal-LM loss and train step (``train``) and ``lmrs-train-torch``
(``cli``)."""

from lmrs_tpu_torch.training.train import causal_lm_loss, make_train_step

__all__ = ["causal_lm_loss", "make_train_step"]
