"""Entity recall, KWS precision/recall and bootstrap CIs: numpy-only copies
of the JAX package's ``metrics`` modules (bootstrap, entity_recall,
nw_align, pr_curve, tokenizer), so the port runs without the JAX package
installed."""

from .bootstrap import evaluate_with_conf_int
from .entity_recall import entity_recall
from .pr_curve import prf_at_threshold

__all__ = ["evaluate_with_conf_int", "entity_recall", "prf_at_threshold"]
