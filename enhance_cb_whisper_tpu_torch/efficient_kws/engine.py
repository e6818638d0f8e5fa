"""Paper-2 engine: train / validate / test for the L/LE/LEF models (port of
enhance_cb_whisper_tpu/efficient_kws/engine.py).

* training — CE on raw-embedding batches (ghost keywords labelled -100),
  the tts/natural coin for ``kw_type='all'``, AdamW over one group or, with
  a projector, two ("resnet" at ``learning_rate``, "proj" at
  ``learning_rate_sru``) and a per-epoch cosine schedule; ``fit`` runs the
  epoch loop with validation, the best checkpoint per monitor and
  ``final`` each epoch, early stopping and resume;
* the audio mode (``whisper=``, the configs' ``load_embeddings: false``):
  the step embeds the batch's 30 s waveforms itself, the log-mel on the
  fused kernel K1 (:func:`..ops.mel.log_mel_spectrogram`) and the frozen
  Whisper encoder's L2-normalized layer slice, frames past each
  utterance's end zeroed, all without a graph;
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
engine's device; a training state (:class:`EfficientTrainState`) holds it
in train mode, and ``fit`` puts it back there after each validation.
Where the JAX engine scores the whole keyword DB in one launch, the port
projects the DB once per dataset (:func:`keyword_db`), zero-pads it to a
multiple of ``CHUNK`` rows and runs the classifier ``CHUNK`` rows at a
time, so every launch has one shape and the activations stay bounded
(ROADMAP.md, deliberate deviations); probabilities are per keyword, so the
result is the same.  Checkpoints hold the parameters, statistics and
AdamW's state in the JAX package's layout, so each package resumes the
other's run.  The coin comes from the paper-1 noise source
(:class:`..train.kws_train.StepNoise`, seeded per step from ``seed + 1``),
so a test can hand the step the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..convert import from_flax_efficient_variables, to_flax_variables
from ..metrics import evaluate_with_conf_int
from ..metrics.pr_curve import binary_pr_curve, find_best_threshold_idx, operating_point, recall_at_k
from ..models.kws import cross_entropy
from ..models.quant import calibrate_act_scales, quantize_efficient_classifier
from ..runtime.checkpoint import CheckpointManager, EarlyStopping, load_checkpoint
from ..runtime.logging import MetricsLogger
from ..runtime.precision import reference_precision
from ..train.kws_train import StepNoise, adam_tree, init_flax_style, load_adam_tree, step_seed
from ..train.optim import cosine_lr, make_adam, set_learning_rate
from .catalog import _make_chunk_classifier, project_catalog
from .model import EfficientKWSConfig, EfficientKWSModel, masked_sims

RECALL_KS = (1, 10, 20, 50, 100, 200)
CHUNK = 50  # keyword-DB rows per classifier launch


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


@dataclasses.dataclass
class EfficientTrainState:
    """The model (parameters and BatchNorm statistics live in it), its
    AdamW, and the epoch the optimizer's rates were last set for."""

    model: EfficientKWSModel
    optimizer: torch.optim.Optimizer
    epoch: int = 0


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
        seed: int = 123,
        ckpt_dir: str = "checkpoints/efficient_kws",
        logger: Optional[MetricsLogger] = None,
        whisper: Optional[tuple] = None,
        kws_layer_slice: tuple = (10, 22),
        utt_frames_budget: int = 1500,
        device="cuda",
    ):
        """Scoring and training run on ``device``, the card by default.
        ``whisper`` is ``(WhisperConfig, params)`` of the frozen encoder of
        the audio mode (params on ``device``); its layer slice feeds the
        model's last ``n_layers`` slabs, cut to ``min(utt_frames_budget,
        max_source_positions)`` frames."""
        self.model_config = model_config
        self.train_config = train_config
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.logger = logger or MetricsLogger()
        self.device = torch.device(device)
        self.dtype = getattr(torch, train_config.compute_dtype or "float32")
        if self.device.type == "cuda":
            reference_precision()
        self._int8 = None  # (quantized parameters, act scales, s8_1x1)
        self._whisper = None
        if whisper is not None:
            wcfg, wparams = whisper
            budget = min(utt_frames_budget, wcfg.max_source_positions)
            self._whisper = (wcfg, wparams, tuple(kws_layer_slice), budget)

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

    @torch.no_grad()
    def embed_utterances(self, audio: torch.Tensor, frames: torch.Tensor):
        """The audio mode's utterance side: ``audio`` [B, 480000] and its
        valid encoder frames [B] → (stacks [B, n_layers, budget, D], masks
        [B, n_layers, budget]), the log-mel on K1 and the frozen encoder's
        layer slice, L2-normalized, frames past each utterance zeroed, with
        no graph."""
        from ..models.whisper import encoder_kws_stack
        from ..ops.mel import log_mel_spectrogram

        wcfg, wparams, layer_slice, budget = self._whisper
        mel = log_mel_spectrogram(audio, n_mels=wcfg.num_mel_bins)
        stack = encoder_kws_stack(wparams, mel, wcfg, layer_slice=layer_slice, valid_frames=frames)
        utt = stack[:, -self.model_config.n_layers:, :budget].contiguous()
        t = torch.arange(budget, device=utt.device)
        mask = (t[None, :] < torch.clamp_max(frames.to(utt.device), budget)[:, None]).to(torch.float32)
        return utt, mask[:, None, :].expand(utt.shape[:3])

    def init_state(self, sample: Dict[str, Any]) -> EfficientTrainState:
        """A fresh model in train mode on the engine's device, flax's
        initializers drawn on the CPU from ``seed``, its projector as wide
        as ``sample``'s keyword stacks (flax's ``Dense`` takes that width
        from the data), and its AdamW."""
        model = EfficientKWSModel(self.model_config, dtype=self.dtype,
                                  input_dim=int(np.shape(sample["kwd_features"])[-1]))
        init_flax_style(model, torch.Generator().manual_seed(int(self.seed)))
        model = model.to(self.device).train()
        return EfficientTrainState(model, self._optimizer(model), 0)

    def _base_rates(self) -> Dict[str, float]:
        tc = self.train_config
        if self.model_config.proj_mlp:
            return {"resnet": tc.learning_rate, "proj": tc.learning_rate_sru}
        return {"all": tc.learning_rate}

    def _optimizer(self, model: EfficientKWSModel) -> torch.optim.Optimizer:
        """AdamW over one group, or with ``proj_mlp`` two: "proj" for the
        projector and time projector, "resnet" for the rest (the JAX
        package's ``multi_transform`` labels)."""
        if self.model_config.proj_mlp:
            groups: Dict[str, list] = {"resnet": [], "proj": []}
            for name, p in model.named_parameters():
                proj = name.split(".")[0] in ("projector", "time_projector")
                groups["proj" if proj else "resnet"].append(p)
        else:
            groups = {"all": list(model.parameters())}
        tc = self.train_config
        return make_adam(groups, self._base_rates(), tc.beta_1, tc.beta_2, tc.weight_decay,
                         adamw=True)

    def update_epoch_lr(self, state: EfficientTrainState, epoch: int) -> None:
        """The cosine schedule at an epoch boundary: each group's rate for
        ``epoch``."""
        state.epoch = epoch
        for name, lr in self._base_rates().items():
            set_learning_rate(state.optimizer, name,
                              cosine_lr(lr, self.train_config.max_epochs)(epoch))

    def make_train_step(self, state: EfficientTrainState):
        """``step(batch, noise) -> {"loss": 0-d tensor}``, as the JAX
        package's step, in its order: the ``kw_type='all'`` coin on every
        batch leaf (so the audio is chosen before the encoder runs), the
        audio mode's embedding, CE with -100 ignored (BatchNorm on the
        batch, its running statistics moved), then AdamW, which updates
        every parameter (optax's zero gradients too).  ``batch`` is a dict
        of tensors on the engine's device."""
        config = self.train_config
        model, optimizer = state.model, state.optimizer
        params = [p for group in optimizer.param_groups for p in group["params"]]

        def step(batch: Dict[str, torch.Tensor], noise) -> Dict[str, torch.Tensor]:
            if config.kw_type == "all":
                # keep the tts (slot 0) or natural (slot 1) member of each
                # adjacent pair, tts with probability 1 - kw_p
                half = batch["labels"].shape[0] // 2
                pick_tts = noise.coin(half, 1.0 - config.kw_p)
                sel = 2 * torch.arange(half, device=pick_tts.device) + (~pick_tts).long()
                batch = {k: v[sel] for k, v in batch.items()}
            if "utt_audio" in batch:
                batch = dict(batch)
                batch["utt_features"], batch["utt_mask"] = self.embed_utterances(
                    batch.pop("utt_audio"), batch.pop("utt_frames"))
            for p in params:
                p.grad = None
            logits, _ = model(batch["kwd_features"], batch["utt_features"],
                              batch["kwd_mask"], batch["utt_mask"])
            loss = cross_entropy(logits, batch["labels"])
            loss.backward()
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            optimizer.step()
            return {"loss": loss.detach()}

        return step

    def checkpoint_tree(self, state: EfficientTrainState, global_step: int) -> Dict[str, Any]:
        """The checkpoint payload in the JAX package's layout: ``params``,
        ``batch_stats``, the epoch, AdamW's state
        (:func:`..train.kws_train.adam_tree`) and the global step."""
        variables = to_flax_variables(state.model.state_dict())
        return {"params": variables["params"], "batch_stats": variables["batch_stats"],
                "epoch": state.epoch, "opt_state": adam_tree(state.optimizer, {"": state.model}),
                "global_step": global_step}

    def restore_state(self, state: EfficientTrainState, tree: Dict[str, Any]) -> None:
        """Load a checkpoint tree (:meth:`checkpoint_tree`'s or the JAX
        package's) into ``state``: parameters, statistics, the epoch and,
        when the tree holds one, AdamW's state."""
        projector = getattr(state.model, "projector", None)
        state.model.load_converted(from_flax_efficient_variables(
            {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}))
        if getattr(state.model, "projector", None) is not projector:
            raise ValueError("the checkpoint's projector takes stacks of another width than the data's")
        state.epoch = int(tree.get("epoch", state.epoch))
        if tree.get("opt_state") is not None:
            load_adam_tree(state.optimizer, {"": state.model}, tree["opt_state"])

    def fit(self, datamodule, max_epochs: Optional[int] = None,
            early_stopping: Optional[EarlyStopping] = None,
            monitors: Optional[Dict[str, str]] = None,
            limit_train_batches: Optional[int] = None,
            resume_from: Optional[str] = None) -> EfficientTrainState:
        """Train; returns the final training state.  The first batch is
        drawn for :meth:`init_state` from a loader of its own, as the JAX
        package draws it, so the sampler's epochs line up."""
        from ..audio.prefetch import prefetch

        datamodule.setup("fit")
        max_epochs = max_epochs or self.train_config.max_epochs
        state = self.init_state(next(iter(datamodule.train_dataloader())))
        manager = CheckpointManager(
            self.ckpt_dir,
            monitors or {"f1_checkpoint": "metrics/f1:max", "f1_l4_checkpoint": "metrics/f1_l4:max"},
            hparams={**dataclasses.asdict(self.train_config), **dataclasses.asdict(self.model_config)},
        )
        start_epoch, global_step = 0, 0
        if resume_from is not None:
            tree, meta = load_checkpoint(resume_from)
            self.restore_state(state, tree)
            start_epoch = int(tree.get("epoch", meta.get("epoch", -1))) + 1
            global_step = int(tree.get("global_step", 0))
            print(f"resumed from {resume_from} at epoch {start_epoch}")
            restored_best = manager.restore_best()
            if restored_best:
                print(f"restored checkpoint bests: {restored_best}")
        step_fn = self.make_train_step(state)

        for epoch in range(start_epoch, max_epochs):
            self.update_epoch_lr(state, epoch)
            metrics = None
            # the loader's thread reads and collates batch N+1 while the
            # device trains on batch N
            loader = prefetch(datamodule.train_dataloader(), depth=2)
            # stop at the limit without waiting for a batch that is not trained
            batches = loader if limit_train_batches is None else itertools.islice(
                loader, limit_train_batches)
            try:
                for batch in batches:
                    tensors = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                               for k, v in batch.items()}
                    noise = StepNoise(step_seed(self.seed + 1, global_step), self.device)
                    metrics = step_fn(tensors, noise)
                    global_step += 1
            finally:
                loader.close()
            if metrics is not None:  # an epoch can train zero batches
                self.logger.log_metrics({"train/loss": float(metrics["loss"])},
                                        step=global_step, epoch=epoch)
            val = {}
            if getattr(datamodule, "val_dataset", None):
                val = self.validate(state.model, datamodule, dump_dir=self.ckpt_dir)
                state.model.train()  # the eval put the model in eval mode
                self.logger.log_metrics(val, step=global_step, epoch=epoch)
            saved = manager.step(epoch, val, self.checkpoint_tree(state, global_step))
            if self.logger.log_model:
                for path in saved:
                    self.logger.log_artifact(path)
            if val and early_stopping is not None and early_stopping.step(val):
                print(f"early stopping at epoch {epoch}")
                break
        return state
