"""Entity recall, KWS precision/recall and bootstrap CIs: numpy-only copies
of the JAX package's ``metrics`` modules (bootstrap, entity_recall,
nw_align, pr_curve, tokenizer), so the port runs without the JAX package
installed."""

from .bootstrap import evaluate_with_conf_int
from .entity_recall import entity_recall
from .pr_curve import find_best_threshold_idx, prf_at_threshold, recall_at_k

__all__ = ["evaluate_with_conf_int", "entity_recall", "find_best_threshold_idx", "prf_at_threshold",
           "recall_at_k"]
