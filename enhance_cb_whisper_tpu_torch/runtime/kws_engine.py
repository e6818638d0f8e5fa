"""Paper-1 KWS engine: fit / validate / test (port of
enhance_cb_whisper_tpu/runtime/kws_engine.py).

* ``fit`` — the epoch loop over the sampler-driven train loader, one train
  step per batch (:mod:`..train.kws_train`), StepLR at epoch boundaries,
  the suppression/beta schedule prints, validation every N epochs, the
  best checkpoint per monitor + ``final``, early stopping, resume from a
  checkpoint (optimizer state, global step and best values included), a
  batch prefetch thread;
* ``validate`` — per validation dataset: score every utterance against the
  whole keyword catalog, then P/R/F1 at threshold 0.5 from the PR curve,
  per dataloader + averaged + zh/en aggregates;
* ``test`` — the same scoring + speaker-conditioned 1000-bootstrap CIs;
* ``enable_int8_scoring`` — BN-folded int8 ResNet scoring with static
  activation scales calibrated on real similarity maps (:mod:`..models.quant`).

``variables`` is the fp32 :class:`..models.kws.KWSModel` (on the engine's
device) or the int8 parameters :meth:`KWSEngine.enable_int8_scoring`
returns; scoring dispatches on which it is handed.  Utterance stacks are
zero-padded to frame buckets with the width-resize weights padded
alongside, which makes the padding invisible (weights of pad columns are
0).  The JAX engine's ``vmap`` over an utterance batch is a loop here, so
the eval scores one utterance at a time, in dataset order, with no bucket
batching or queue of in-flight calls (those only kept JAX's compiled
shapes few).

The training state (:class:`..train.kws_train.KWSTrainState`) holds the
models in train mode; :meth:`KWSEngine.variables` hands its classifier to
the eval methods, which put it in eval mode, and ``fit`` puts it back.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..catalog.database import calibration_sim_maps_multi, device_put_catalog, make_catalog_score_fn
from ..metrics import evaluate_with_conf_int, prf_at_threshold
from ..models.quant import calibrate_act_scales, make_quantized_kws_apply, quantize_resnet_classifier
from ..models.resnet import ResNetConfig
from ..ops.resize import resize_matrix
from ..train.kws_train import (
    KWSTrainConfig,
    StepNoise,
    checkpoint_tree,
    init_train_state,
    make_train_step,
    restore_train_state,
    step_seed,
    update_epoch_lr,
)
from .checkpoint import CheckpointManager, EarlyStopping, load_checkpoint
from .logging import MetricsLogger
from .precision import reference_precision


def _bucket(n: int, step: int = 128, lo: int = 128) -> int:
    return max(lo, ((n + step - 1) // step) * step)


class KWSEngine:
    def __init__(
        self,
        resnet_config: ResNetConfig = None,
        features_size: Tuple[int, int] = (150, 750),
        device="cuda",
        config: Optional[KWSTrainConfig] = None,
        seed: int = 123,
        ckpt_dir: str = "checkpoints/kws",
        logger: Optional[MetricsLogger] = None,
    ):
        """Scoring and training run on ``device``, the card by default; a
        CPU run passes ``device="cpu"``.  ``config``, ``seed``, ``ckpt_dir``
        and ``logger`` are the training's."""
        self.resnet_config = resnet_config or ResNetConfig(num_channels=12, num_labels=2)
        self.features_size = tuple(features_size)
        self.device = torch.device(device)
        self.config = config or KWSTrainConfig()
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.logger = logger or MetricsLogger()
        if self.device.type == "cuda":
            reference_precision()
        self._catalog_cache: Dict[int, Any] = {}
        self._int8_apply = None

    def enable_int8_scoring(self, variables, dataset, utt_hs: np.ndarray = None,
                            calibration_batches: int = 4, s8_1x1=()):
        """Switch catalog scoring to int8 quantized inference: BN fold,
        per-channel int8 weights, static activation scales calibrated on
        real similarity maps of the first ``calibration_batches`` utterances
        of ``dataset`` against the catalog's first keywords (or on the one
        stack ``utt_hs`` [L, T, D]).  ``s8_1x1`` names the stages whose
        bottleneck 1×1 convs run the fused s8 kernel.  Returns the int8
        parameters: pass them as ``variables`` to later ``score_*`` and eval
        calls; the fp32 model keeps scoring in fp32."""
        if utt_hs is not None:
            utts = [np.asarray(utt_hs)]
        else:
            utts = [np.asarray(dataset[i]["utt_hs"])
                    for i in range(min(calibration_batches, len(dataset)))]
        qparams = quantize_resnet_classifier(variables, self.resnet_config, device=self.device)
        maps = calibration_sim_maps_multi(dataset.catalog, utts, self.features_size)
        scales = calibrate_act_scales(self.resnet_config, qparams, maps)["act_scales"]
        self._int8_apply = make_quantized_kws_apply(
            self.resnet_config, act_scales=scales, s8_1x1=s8_1x1
        )
        return qparams

    def _pick_score_fns(self, variables):
        """(score one utterance, score a batch) for ``variables``: the fp32
        model, or the int8 parameters once int8 scoring is enabled."""
        if self._int8_apply is not None and not isinstance(variables, torch.nn.Module):
            q_apply = self._int8_apply
            kws_apply = lambda images: q_apply(variables, images)  # noqa: E731
        else:
            model = variables.eval()  # BatchNorm on its running statistics
            kws_apply = lambda images: model(images).logits  # noqa: E731
        score = make_catalog_score_fn(kws_apply, out_size=self.features_size)

        def batched(catalog_dev, utts, ws):
            outs = [score(catalog_dev, u, w) for u, w in zip(utts, ws)]
            return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

        return score, batched

    # ------------------------------------------------------------------ state

    def init_state(self):
        """A fresh training state on the engine's device, drawn from
        ``seed``."""
        return init_train_state(self.config, self.resnet_config, seed=self.seed, device=self.device)

    def variables(self, state):
        """The classifier of ``state`` for the eval methods: its own module
        in f32, or an f32 copy when it computes in another dtype (the JAX
        engine validates a bf16-trained state with its f32 model)."""
        if state.kws.model.feature_extractor.dtype == torch.float32:
            return state.kws
        from ..models.kws import KWSModel

        copy = KWSModel(self.resnet_config).to(self.device)
        return copy.load_converted(state.kws.state_dict())

    # ------------------------------------------------------------------- eval

    def _catalog_dev(self, dataset):
        # keyed by id() but holding the dataset alongside: a bare id can be
        # reused after the dataset is collected
        key = id(dataset)
        hit = self._catalog_cache.get(key)
        if hit is None or hit[0] is not dataset:
            hit = (dataset, device_put_catalog(
                dataset.catalog, out_h=self.features_size[0], chunk=8, device=self.device
            ))
            self._catalog_cache[key] = hit
        return hit[1]

    def _pad_utt(self, utt_hs: np.ndarray):
        t_u = utt_hs.shape[1]
        t_pad = _bucket(t_u)
        utt = np.zeros((utt_hs.shape[0], t_pad, utt_hs.shape[2]), np.float32)
        utt[:, :t_u] = utt_hs
        w = np.zeros((self.features_size[1], t_pad), np.float32)
        w[:, :t_u] = resize_matrix(t_u, self.features_size[1], antialias=False)
        return utt, w

    @torch.no_grad()
    def score_utterance(self, variables, dataset, utt_hs: np.ndarray):
        """Probabilities + logits for every catalog keyword vs one utterance."""
        catalog_dev = self._catalog_dev(dataset)
        utt, w = self._pad_utt(np.asarray(utt_hs))
        score_fn, _ = self._pick_score_fns(variables)
        probs, logits = score_fn(catalog_dev, torch.from_numpy(utt).to(self.device),
                                 torch.from_numpy(w).to(self.device))
        n = dataset.catalog.num_keywords
        return probs.cpu().numpy()[:n], logits.cpu().numpy()[:n]

    @torch.no_grad()
    def score_utterances(self, variables, dataset, utt_hs_list):
        """Score several utterances of one frame bucket against the whole
        catalog."""
        catalog_dev = self._catalog_dev(dataset)
        padded = [self._pad_utt(np.asarray(u)) for u in utt_hs_list]
        utt = torch.from_numpy(np.stack([p[0] for p in padded])).to(self.device)
        w = torch.from_numpy(np.stack([p[1] for p in padded])).to(self.device)
        _, batched = self._pick_score_fns(variables)
        probs, logits = batched(catalog_dev, utt, w)
        n = dataset.catalog.num_keywords
        return probs.cpu().numpy()[:, :n], logits.cpu().numpy()[:, :n]

    @staticmethod
    def _ce(logits: np.ndarray, labels: np.ndarray) -> float:
        logits = logits - logits.max(axis=-1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        return float(-logp[np.arange(len(labels)), labels].mean())

    def _eval_dataset(self, variables, dataset):
        from ..audio.prefetch import prefetch

        preds, targets, speakers, losses = [], [], [], []
        group = dataset.catalog.group_size
        # host-side cache loads overlap with device scoring
        for item in prefetch((dataset[i] for i in range(len(dataset))), depth=2):
            probs, logits = self.score_utterance(variables, dataset, item["utt_hs"])
            labels = np.asarray(item["hotword_labels"])
            # per-group CE sum, mirroring the reference's group loop loss
            losses.append(sum(
                self._ce(logits[lo : lo + group], labels[lo : lo + group])
                for lo in range(0, len(labels), group)
            ))
            preds.append(probs * item["hotword_mask"])
            targets.append(labels)
            speakers.append(item.get("speaker"))

        return (
            np.concatenate(preds),
            np.concatenate(targets),
            speakers,
            float(np.mean(losses)),
        )

    def validate(self, variables, datamodule) -> Dict[str, float]:
        datasets = list(datamodule.val_dataset.values())
        avg = {k: 0.0 for k in ("val/loss", "metrics/precision", "metrics/recall", "metrics/f1")}
        zh = {k + "_zh": 0.0 for k in avg}
        en = {k + "_en": 0.0 for k in avg}
        out: Dict[str, float] = {}
        n = len(datasets)
        for i, dataset in enumerate(datasets):
            preds, targets, _, loss = self._eval_dataset(variables, dataset)
            p, r, f1 = prf_at_threshold(preds, targets, 0.5)
            metrics = {
                f"val/loss_{i}": loss,
                f"metrics/precision_{i}": p,
                f"metrics/recall_{i}": r,
                f"metrics/f1_{i}": f1,
            }
            out.update(metrics)
            for key in avg:
                avg[key] += metrics[f"{key}_{i}"] / n
                if i in (0, 1):
                    zh[key + "_zh"] += metrics[f"{key}_{i}"] / 2
                elif i in (2, 3):
                    en[key + "_en"] += metrics[f"{key}_{i}"] / 2
        out.update(avg)
        if n >= 2:
            out.update(zh)
        if n >= 4:
            out.update(en)
        return out

    def test(self, variables, datamodule) -> Dict[str, float]:
        datamodule.setup("test")
        dataset = datamodule.test_dataset
        preds, targets, speakers, _ = self._eval_dataset(variables, dataset)
        speaker2id = {s: i for i, s in enumerate(set(speakers))}
        conditions = np.asarray(
            [
                speaker2id[s]
                for s, n in zip(speakers, [dataset.catalog.num_keywords] * len(speakers))
                for _ in range(n)
            ]
        )

        def at_threshold(which):
            def f(labels, samples, samples2=None):
                p, r, f1 = prf_at_threshold(samples, labels, 0.5)
                return {"p": p, "r": r, "f1": f1}[which]

            return f

        results = {}
        for name, which in (("Precision", "p"), ("Recall", "r"), ("F1", "f1")):
            center, (lb, ub) = evaluate_with_conf_int(
                preds, at_threshold(which), targets, conditions, num_bootstraps=1000, alpha=5
            )
            results[name] = center
            results[f"{name}_LB"] = lb
            results[f"{name}_UB"] = ub
        print(results)
        return results

    # -------------------------------------------------------------------- fit

    def fit(
        self,
        datamodule,
        max_epochs: int = 100,
        check_val_every_n_epoch: int = 1,
        early_stopping: Optional[EarlyStopping] = None,
        monitors: Optional[Dict[str, str]] = None,
        limit_train_batches: Optional[int] = None,
        resume_from: Optional[str] = None,
    ):
        """Train; returns the final training state."""
        from ..audio.prefetch import prefetch

        datamodule.setup("fit")
        state = self.init_state()
        manager = CheckpointManager(
            self.ckpt_dir,
            monitors or {"f1_checkpoint": "metrics/f1:max"},
            hparams=dataclasses.asdict(self.config),
        )
        start_epoch, global_step = 0, 0
        if resume_from is not None:
            tree, meta = load_checkpoint(resume_from)
            restore_train_state(state, tree)
            start_epoch = int(tree.get("epoch", meta.get("epoch", -1))) + 1
            # the step counter (per-step noise and logged steps continue the
            # series) and the best values (or the first validation after the
            # resume would overwrite a better checkpoint)
            global_step = int(tree.get("global_step", 0))
            print(f"resumed from {resume_from} at epoch {start_epoch}")
            restored_best = manager.restore_best()
            if restored_best:
                print(f"restored checkpoint bests: {restored_best}")
        step_fn = make_train_step(self.config, state)

        for epoch in range(start_epoch, max_epochs):
            state.epoch = epoch
            update_epoch_lr(self.config, state)
            if self.config.adversarial_training or self.config.entropy:
                print(f"supression={self.config.suppression(epoch):.2f}")
            if self.config.adversarial_training:
                print(f"beta={self.config.beta(epoch):.2f}")

            metrics = None
            # the loader's thread builds batch N+1 (disk reads, the
            # collator's numpy resize) while the device trains on batch N
            loader = prefetch(datamodule.train_dataloader(), depth=2)
            # stop at the limit without waiting for a batch that is not trained
            batches = loader if limit_train_batches is None else itertools.islice(
                loader, limit_train_batches)
            try:
                for batch in batches:
                    tensors = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                               for k, v in batch.items()}
                    noise = StepNoise(step_seed(self.seed + 1, global_step), self.device)
                    metrics = step_fn(tensors, noise, self.config.beta(epoch),
                                      self.config.suppression(epoch))
                    global_step += 1
            finally:
                loader.close()
            if metrics is not None:  # an epoch can train zero batches
                self.logger.log_metrics({"train/class_loss": float(metrics["class_loss"])},
                                        step=global_step, epoch=epoch)

            val_metrics = {}
            if (epoch + 1) % check_val_every_n_epoch == 0 and datamodule.val_dataset:
                self._catalog_cache.clear()
                val_metrics = self.validate(self.variables(state), datamodule)
                state.kws.train()  # the eval put the classifier in eval mode
                self.logger.log_metrics(val_metrics, step=global_step, epoch=epoch)
            saved = manager.step(epoch, val_metrics, checkpoint_tree(state, global_step))
            if self.logger.log_model:
                for path in saved:
                    self.logger.log_artifact(path)
            if val_metrics and early_stopping is not None and early_stopping.step(val_metrics):
                print(f"early stopping at epoch {epoch}")
                break
        return state
