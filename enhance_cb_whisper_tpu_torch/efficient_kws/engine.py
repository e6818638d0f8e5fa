"""Paper-2 engine, its eval half: validate / test for the L/LE/LEF models
(port of enhance_cb_whisper_tpu/efficient_kws/engine.py).

* ``validate`` — per (language × kw_type) dataset: every utterance scored
  against the whole keyword DB; the best-F operating point by the
  ``5PR / (4P + R)`` search; recall@{1, 10, 20, 50, 100, 200}; averages and
  per-language aggregates (with the reference's divisor, kept on purpose);
  ``prcurve_{i}.json`` + ``thresdict.json`` dumps;
* ``test`` — P/R/F1 at the configured ``threshold`` with
  speaker-conditioned bootstrap CIs; a ``pr_data_{dataset}.json`` dump;
* ``enable_int8_scoring`` — the ResNet and head int8 (BN folded,
  per-channel weights, static activation scales calibrated on each
  calibration item's first group against its utterance), the projection
  and the similarity kept float; ``s8_1x1`` names the stages whose
  bottleneck 1×1 convolutions run on the fused kernel K2.

``variables`` is the fp32 (or bf16) :class:`.model.EfficientKWSModel` on the
engine's device.  Where the JAX engine scores the whole keyword DB in one
launch, the port projects the DB once per dataset (:func:`keyword_db`),
zero-pads it to a multiple of ``CHUNK`` rows and runs the classifier
``CHUNK`` rows at a time, so every launch has one shape and the
activations stay bounded (ROADMAP.md, deliberate deviations);
probabilities are per keyword, so the result is the same.  Training
(``init_state``, ``make_train_step``, ``fit``) and the audio mode
(``whisper=``) are ROADMAP.md §1 item 6b and raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..convert import from_flax_efficient_variables
from ..metrics import evaluate_with_conf_int
from ..metrics.pr_curve import binary_pr_curve, find_best_threshold_idx, operating_point, recall_at_k
from ..models.quant import calibrate_act_scales, quantize_efficient_classifier
from ..runtime.precision import reference_precision
from .catalog import _make_chunk_classifier, project_catalog
from .model import EfficientKWSConfig, EfficientKWSModel, masked_sims

RECALL_KS = (1, 10, 20, 50, 100, 200)
CHUNK = 50  # keyword-DB rows per classifier launch
_TRAINING = "paper-2 training is not ported yet: ROADMAP.md §1 item 6b"


@dataclasses.dataclass(frozen=True)
class EfficientTrainConfig:
    """The paper-2 training hyperparameters (a copy of the JAX dataclass;
    the eval reads ``compute_dtype`` alone, the model's dtype)."""

    kw_type: str = "tts"
    kw_p: float = 0.5
    learning_rate: float = 1e-4
    learning_rate_sru: float = 1e-4
    weight_decay: float = 0.0
    beta_1: float = 0.9
    beta_2: float = 0.99
    max_epochs: int = 200
    threshold: float = 0.5
    compute_dtype: str = "float32"


def keyword_db(model: EfficientKWSModel, dataset):
    """``dataset``'s whole keyword DB (every group) through ``model``'s
    projection stack, zero-padded to a multiple of :data:`CHUNK` rows
    (:func:`.catalog.project_catalog`)."""
    return project_catalog(model.eval(), dataset.groups, chunk=CHUNK)


class EfficientKWSEngine:
    def __init__(
        self,
        model_config: EfficientKWSConfig,
        train_config: EfficientTrainConfig = EfficientTrainConfig(),
        whisper: Optional[tuple] = None,
        device="cuda",
    ):
        """Scoring runs on ``device``, the card by default.  The JAX
        engine's training arguments (seed, checkpoint directory, logger,
        the audio mode's layer slice and frame budget) come with item 6b."""
        if whisper is not None:
            raise NotImplementedError(
                "the audio mode (load_embeddings: false, the Whisper encoder inside the "
                "train step) is not ported yet: ROADMAP.md §1 item 6b")
        self.model_config = model_config
        self.train_config = train_config
        self.device = torch.device(device)
        self.dtype = getattr(torch, train_config.compute_dtype or "float32")
        if self.device.type == "cuda":
            reference_precision()
        self._int8 = None  # (quantized parameters, act scales, s8_1x1)

    def build_model(self, state=None) -> EfficientKWSModel:
        """An :class:`EfficientKWSModel` of the engine's configuration and
        compute dtype on its device, in eval mode, loaded from a converted
        ``state`` (a flax ``{"params", "batch_stats"}`` tree or a port
        ``state_dict``) when one is given."""
        model = EfficientKWSModel(self.model_config, dtype=self.dtype)
        if state is not None:
            if "params" in state:
                state = from_flax_efficient_variables(state)
            model.load_converted(state)
        return model.to(self.device).eval()

    # ------------------------------------------------------------- scoring

    @torch.no_grad()
    def enable_int8_scoring(self, variables: EfficientKWSModel, item=None, items=None,
                            s8_1x1=()) -> None:
        """Score groups with the int8 ResNet and head from now on,
        calibrated over ``items`` (several eval items) or one ``item``: each
        item's first keyword group against its utterance, projected in
        float.  ``variables`` keeps driving the projection, so callers pass
        it unchanged to ``validate``/``test``."""
        calib_items = list(items) if items is not None else [item]
        assert calib_items and calib_items[0] is not None
        model = variables.eval()
        rcfg = self.model_config.resnet_config()
        qparams = quantize_efficient_classifier(model, rcfg, device=self.device)

        def item_sims(it):
            g = it["groups"][0]
            kwd_p, kwd_mask_p = model.project(self._tensor(g["kwd"]), self._tensor(g["kwd_mask"]))
            utt_p, utt_mask_p = model.project(self._tensor(it["utt"][None]),
                                              self._tensor(it["utt_mask"][None]))
            return masked_sims(kwd_p, utt_p, kwd_mask_p, utt_mask_p)

        sims = torch.cat([item_sims(it) for it in calib_items])
        scales = calibrate_act_scales(rcfg, qparams, sims)["act_scales"]
        self._int8 = (qparams, scales, tuple(s8_1x1))

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    @torch.no_grad()
    def score_item(self, variables: EfficientKWSModel, db, item):
        """(probabilities, logits) of every keyword of ``db`` (the
        dataset's :func:`keyword_db`) against ``item``'s utterance, numpy
        [n_keywords] and [n_keywords, 2]."""
        model = variables.eval()
        utt_p, utt_mask_p = model.project(self._tensor(item["utt"][None]),
                                          self._tensor(item["utt_mask"][None]))
        if self._int8 is not None:
            qparams, scales, s8 = self._int8
            chunk_logits = _make_chunk_classifier(model, qparams, scales, s8)(utt_p, utt_mask_p)
        else:
            chunk_logits = _make_chunk_classifier(model)(utt_p, utt_mask_p)
        chunk = db["chunk"]
        logits = torch.cat([
            chunk_logits(db["kwd"][i:i + chunk], db["kwd_mask"][i:i + chunk])
            for i in range(0, db["kwd"].shape[0], chunk)
        ]).to(torch.float32)
        n = db["num_keywords"]
        probs = torch.softmax(logits, -1)[:, 1]
        return probs[:n].cpu().numpy(), logits[:n].cpu().numpy()

    # ------------------------------------------------------------------ eval

    def _eval_dataset(self, variables, dataset):
        from ..audio.prefetch import prefetch

        preds, targets, losses = [], [], []
        recalls = {k: [] for k in RECALL_KS}
        speakers = []
        group = dataset.keywords_per_group
        db = keyword_db(variables, dataset)
        for item in prefetch((dataset[i] for i in range(len(dataset))), depth=2):
            p, logits = self.score_item(variables, db, item)
            probs = p * np.asarray(item["hotword_mask"])
            labels = np.asarray(item["hotword_labels"])
            losses.append(sum(self._ce(logits[lo:lo + group], labels[lo:lo + group])
                              for lo in range(0, len(labels), group)))
            preds.append(probs)
            targets.append(labels)
            speakers.append(item.get("speaker"))
            for k in RECALL_KS:
                r = recall_at_k(probs, labels, k)
                if r >= 0:
                    recalls[k].append(r)
        return preds, targets, speakers, float(np.mean(losses)), recalls

    @staticmethod
    def _ce(logits, labels):
        logits = logits - logits.max(-1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        return float(-logp[np.arange(len(labels)), labels].mean())

    def validate(self, variables, datamodule, dump_dir: Optional[str] = None) -> Dict[str, float]:
        datasets = list(datamodule.val_dataset.values())
        n_loaders = len(datasets)
        is_expanded = any(ds.is_expanded() for ds in datasets)
        n_languages = max(1, n_loaders // (4 if is_expanded else 2))
        if n_loaders == 1:
            n_languages = 1

        out: Dict[str, float] = {}
        avg_keys = (
            "metrics/loss", "metrics/precision", "metrics/recall", "metrics/f1",
            "metrics/recall_at_10", "val/recall_at_1", "val/recall_at_20",
            "val/recall_at_50", "val/recall_at_100", "val/recall_at_200",
        )
        avg = {k: 0.0 for k in avg_keys}
        lang = {l: {k: 0.0 for k in avg_keys} for l in range(n_languages)}
        best_thresholds: List[float] = []

        for i, dataset in enumerate(datasets):
            if dataset.is_expanded():
                continue
            preds, targets, _, loss, recalls = self._eval_dataset(variables, dataset)
            precision, recall, thresholds = binary_pr_curve(np.concatenate(preds), np.concatenate(targets))
            bi = find_best_threshold_idx(precision, recall)
            best_thresholds.append(
                float(thresholds[min(bi, len(thresholds) - 1)]) if len(thresholds) else 0.0
            )
            p, r = float(precision[bi]), float(recall[bi])
            f1 = 2 * p * r / (p + r) if (p and r) else 0.0
            metrics = {
                f"metrics/loss_{i}": loss,
                f"metrics/precision_{i}": p,
                f"metrics/recall_{i}": r,
                f"metrics/f1_{i}": f1,
                f"metrics/recall_at_10_{i}": float(np.mean(recalls[10])) if recalls[10] else 0.0,
            }
            for k in RECALL_KS:
                if k != 10:
                    metrics[f"val/recall_at_{k}_{i}"] = float(np.mean(recalls[k])) if recalls[k] else 0.0
            out.update(metrics)

            div = n_loaders // 2 if is_expanded else n_loaders
            div = 1 if n_loaders == 1 else div
            # the reference divides the per-language sums by 4 although
            # only 2 loaders contribute per language: kept, not fixed
            lang_div = 2 if is_expanded else 4
            lang_div = 1 if n_loaders == 1 else lang_div
            l_idx = (i // 2 // 2) if is_expanded else (i // 2)
            l_idx = min(l_idx, n_languages - 1)
            for key in avg_keys:
                mk = f"{key}_{i}"
                if mk in metrics:
                    avg[key] += metrics[mk] / div
                    lang[l_idx][key] += metrics[mk] / lang_div

            if dump_dir is not None:
                os.makedirs(dump_dir, exist_ok=True)
                with open(os.path.join(dump_dir, f"prcurve_{i}.json"), "w") as f:
                    json.dump({"precision": precision.tolist(), "recall": recall.tolist(),
                               "thresholds": thresholds.tolist()}, f)

        out.update(avg)
        for l, metrics in lang.items():
            out.update({f"{k}_l{l}": v for k, v in metrics.items()})
        if dump_dir is not None:
            with open(os.path.join(dump_dir, "thresdict.json"), "w") as f:
                json.dump(best_thresholds, f)
        return out

    def test(self, variables, datamodule, dump_dir: Optional[str] = None,
             num_bootstraps: int = 1000) -> Dict[str, float]:
        datamodule.setup("test")
        dataset = datamodule.test_dataset
        preds, targets, speakers, _, _ = self._eval_dataset(variables, dataset)
        flat_p = np.concatenate(preds)
        flat_t = np.concatenate(targets)
        conditions = None
        if speakers[0] is not None:
            # the reference numbers speakers in set order (ROADMAP.md §3):
            # the bounds follow PYTHONHASHSEED
            speaker2id = {s: i for i, s in enumerate(set(speakers))}
            conditions = np.asarray([speaker2id[s] for s, p in zip(speakers, preds) for _ in range(len(p))])

        threshold = self.model_config.threshold

        def metric(which):
            def f(labels, samples, samples2=None):
                precision, recall, thresholds = binary_pr_curve(samples, labels)
                p, r = operating_point(precision, recall, thresholds, threshold)
                if which == "p":
                    return p
                if which == "r":
                    return r
                return 2 * p * r / (p + r) if (p and r) else 0.0

            return f

        results = {}
        for name, which in (("Precision", "p"), ("Recall", "r"), ("F1", "f1")):
            center, (lb, ub) = evaluate_with_conf_int(
                flat_p, metric(which), flat_t, conditions, num_bootstraps=num_bootstraps, alpha=5,
            )
            results[name] = center
            results[f"{name}_LB"] = lb
            results[f"{name}_UB"] = ub
        print(results)

        if dump_dir is not None:
            precision, recall, thresholds = binary_pr_curve(flat_p, flat_t)
            name = "pr_data_acl6060.json" if "ACL6060" in getattr(dataset, "root", "") else "pr_data_aishell.json"
            os.makedirs(dump_dir, exist_ok=True)
            with open(os.path.join(dump_dir, name), "w") as f:
                json.dump({"precision": precision.tolist(), "recall": recall.tolist(),
                           "thresholds": thresholds.tolist()}, f)
        return results

    # ---------------------------------------------------------------- train

    def init_state(self, sample):
        raise NotImplementedError(_TRAINING)

    def make_train_step(self):
        raise NotImplementedError(_TRAINING)

    def fit(self, datamodule, **kwargs):
        raise NotImplementedError(_TRAINING)
