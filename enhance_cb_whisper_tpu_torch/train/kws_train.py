"""Paper-1 KWS training step: plain CE, DANN adversarial, DANNCE, entropy
(port of enhance_cb_whisper_tpu/train/kws_train.py).

One step (:func:`make_train_step`) does what the JAX package's jitted step
does, in the same order:

* ``kw_type='all'``: per adjacent (tts, natural) pair a coin keeps exactly
  one example, applied to every batch leaf before the features;
* ``device_features``: the similarity einsum + antialiased resize of raw
  hidden-state batches run inside the step
  (:func:`..ops.resize.features_from_hidden_states`);
* DANNCE: per minibatch, an inner Adam (optax's defaults, ``b2=0.999``) on
  the *inputs* maximizing the discriminator's loss plus a KL anchor to the
  original class distribution, with the running statistics frozen; a
  Bernoulli mask picks the examples that take the rewritten input;
* gradient accumulation: each minibatch's backward *sums* into ``.grad``
  and its forward moves the BatchNorm running statistics the next one
  starts from;
* adversarial mode: the discriminator behind the gradient-reversal layer
  with ``beta = domain_adversary_weight * suppression(epoch)``, and three
  optimizer groups (features, classifier, discriminator);
* the entropy regularizer, weighted by the suppression schedule — and
  added unweighted when suppression is off, as the reference does.

**Randomness.** The coin flips, the large heads' dropout masks and the
DANNCE masks come from one noise source handed to each step
(:class:`StepNoise`: drawn on the CPU from a ``torch.Generator`` seeded by
the caller, then moved to the device).  Any object with its three methods
serves, so a test can hand the step the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import flax_entry, from_flax_resnet_variables, to_flax_variables
from ..models.kws import Discriminator, KWSModel, cross_entropy, entropy_loss
from ..models.resnet import ResNetConfig
from ..ops.resize import features_from_hidden_states
from .optim import make_adam, set_learning_rate, step_lr


@dataclasses.dataclass(frozen=True)
class KWSTrainConfig:
    """The reference KWSModel's hyperparameters, plus the JAX package's
    extensions (a copy of the JAX dataclass)."""

    large_heads: bool = False
    adversarial_training: bool = False
    dannce: bool = False
    adversarial_examples_ratio: float = 0.5
    adversarial_examples_lr: float = 1.5e-6
    adversarial_train_steps: int = 5
    adv_kl_weight: float = 1.0
    entropy: bool = False
    domain_adversary_weight: float = 0.1
    entropy_weight: float = 0.1
    supression_decay: float = 1e-3
    early_adversary_supression: bool = True
    num_domains: int = 72
    kw_type: str = "tts"
    kw_p: float = 0.5
    accumulate_grad_batches: int = 1
    learning_rate: float = 1e-4
    features_lr: float = 1e-4
    classifier_lr: float = 1e-4
    discriminator_lr: float = 1e-4
    lr_step: int = 40
    weight_decay: float = 0.0
    beta_1: float = 0.9
    beta_2: float = 0.99
    # bf16 activations and convolutions with f32 parameters, optimizer
    # state and BatchNorm statistics
    compute_dtype: str = "float32"
    # the collator target (size0, size1) when the step takes raw
    # hidden-state batches (RawKWSDataCollator) and computes the features
    # itself
    device_features: Optional[Tuple[int, int]] = None
    # the JAX package's NHWC input layout; the port's model always takes
    # NCHW, so this is accepted and changes nothing
    channels_last: bool = False
    # recompute each ResNet block in the backward pass: the same
    # gradients, a smaller live set of activations
    remat: bool = False

    def suppression(self, epoch: int) -> float:
        """2/(1+exp(-decay*epoch)) - 1."""
        return 2.0 / (1.0 + np.exp(-self.supression_decay * epoch)) - 1.0

    def beta(self, epoch: int) -> float:
        b = self.domain_adversary_weight
        if self.early_adversary_supression:
            b *= self.suppression(epoch)
        return b


@dataclasses.dataclass
class KWSTrainState:
    """The models (parameters and BatchNorm statistics live in them), the
    optimizer, and the epoch the optimizer's rates were last set for."""

    kws: KWSModel
    disc: Optional[Discriminator]
    optimizer: torch.optim.Adam
    epoch: int = 0


class StepNoise:
    """The random draws of one train step, in call order from a CPU
    ``torch.Generator`` seeded with ``seed``, moved to ``device``."""

    def __init__(self, seed: int, device="cuda"):
        self.generator = torch.Generator().manual_seed(int(seed))
        self.device = torch.device(device)

    def _bernoulli(self, p: float, shape) -> torch.Tensor:
        return (torch.rand(shape, generator=self.generator) < p).to(self.device)

    def coin(self, n: int, p: float) -> torch.Tensor:
        """[n] bool, each True with probability ``p``."""
        return self._bernoulli(p, (n,))

    def dropout_keep(self, minibatch: int, n: int, width: int):
        """The large heads' two dropout masks for ``minibatch`` (rate 0.5)."""
        return self._bernoulli(0.5, (n, width)), self._bernoulli(0.5, (n, width))

    def adversarial_mask(self, minibatch: int, n: int, p: float) -> torch.Tensor:
        """DANNCE's [n] mask of the examples that take the rewritten input."""
        return self._bernoulli(p, (n,))


def step_seed(seed: int, global_step: int) -> int:
    """The seed of :class:`StepNoise` for one step: a function of the run's
    seed and the step, so a resumed run draws what an unbroken one would."""
    return int(np.random.SeedSequence([int(seed), int(global_step)]).generate_state(1)[0])


def build_models(config: KWSTrainConfig, resnet_config: ResNetConfig):
    kws = KWSModel(resnet_config, dtype=getattr(torch, config.compute_dtype), remat=config.remat)
    disc = (
        Discriminator(resnet_config.hidden_sizes[-1], config.num_domains, large=config.large_heads)
        if config.adversarial_training
        else None
    )
    return kws, disc


def init_flax_style(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers: LeCun-normal kernels (a normal truncated
    at two standard deviations, rescaled to variance 1/fan_in), zero biases,
    unit BatchNorm scales and variances."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()  # in × kernel size
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def param_groups(config: KWSTrainConfig, kws: KWSModel, disc: Optional[Discriminator]):
    """{group name: parameters}: one group, or features / classifier /
    discriminator under adversarial training."""
    if not config.adversarial_training:
        return {"all": list(kws.parameters())}
    return {
        "features": list(kws.model.feature_extractor.parameters()),
        "classifier": list(kws.model.classifier.parameters()),
        "discriminator": list(disc.parameters()),
    }


def _base_rates(config: KWSTrainConfig) -> Dict[str, float]:
    if not config.adversarial_training:
        return {"all": config.learning_rate}
    return {"features": config.features_lr, "classifier": config.classifier_lr,
            "discriminator": config.discriminator_lr}


def make_optimizer(config: KWSTrainConfig, kws: KWSModel, disc: Optional[Discriminator]):
    return make_adam(param_groups(config, kws, disc), _base_rates(config),
                     config.beta_1, config.beta_2, config.weight_decay)


def init_train_state(config: KWSTrainConfig, resnet_config: ResNetConfig, seed: int = 0,
                     device="cuda") -> KWSTrainState:
    """Fresh models (flax's initializers, drawn on the CPU from ``seed``) in
    train mode on ``device``, and their optimizer."""
    kws, disc = build_models(config, resnet_config)
    generator = torch.Generator().manual_seed(int(seed))
    init_flax_style(kws, generator)
    if disc is not None:
        init_flax_style(disc, generator)
        disc = disc.to(device).train()
    kws = kws.to(device).train()
    return KWSTrainState(kws, disc, make_optimizer(config, kws, disc), 0)


def update_epoch_lr(config: KWSTrainConfig, state: KWSTrainState) -> None:
    """StepLR at an epoch boundary: each group's rate for ``state.epoch``."""
    for name, lr in _base_rates(config).items():
        set_learning_rate(state.optimizer, name, step_lr(lr, config.lr_step)(state.epoch))


def _modules(state: KWSTrainState) -> Dict[str, nn.Module]:
    return {"kws": state.kws, **({"disc": state.disc} if state.disc is not None else {})}


def _group_params(optimizer: torch.optim.Optimizer, modules: Dict[str, nn.Module]):
    """(group name, [(module, parameter name, parameter)]) per optimizer
    group, ``module`` being a key of ``modules``."""
    names = {id(p): (m, n) for m, module in modules.items() for n, p in module.named_parameters()}
    return [(g["name"], [(*names[id(p)], p) for p in g["params"]]) for g in optimizer.param_groups]


def _moment_tree(optimizer, modules: Dict[str, nn.Module], members, key: str) -> Dict[str, Any]:
    """One Adam moment of a group over the whole parameter tree, in the
    flax layout: the group's leaves hold the moment (zeros before the first
    step), every other leaf is optax's masked ``{}``.  Each module's
    parameters sit under its key, or at the root for the key ""."""
    mine = {(m, n) for m, n, _ in members}
    tree: Dict[str, Any] = {}
    for m, module in modules.items():
        root = tree.setdefault(m, {}) if m else tree
        for n, p in module.named_parameters():
            moment = optimizer.state.get(p, {}).get(key) if (m, n) in mine else None
            _, path, a = flax_entry(n, p if moment is None else moment)
            if (m, n) not in mine:
                leaf = {}
            else:
                leaf = np.ascontiguousarray(a) if moment is not None else np.zeros_like(a)
            node = root
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = leaf
    return tree


def _adam_state(optimizer, modules, group) -> Dict[str, Any]:
    """One group's optimizer state as the JAX package's
    ``inject_hyperparams`` serializes it: ``adam`` (chained after
    ``add_decayed_weights`` when the weight decay is on), or ``adamw``
    (Adam's moments, then the decay and the rate, which hold no state)."""
    name, members = group
    lr = next(g["lr"] for g in optimizer.param_groups if g["name"] == name)
    steps = [optimizer.state.get(p, {}).get("step") for _, _, p in members]
    count = np.asarray(int(steps[0]) if steps[0] is not None else 0, np.int32)
    moments = {"count": count, "mu": _moment_tree(optimizer, modules, members, "exp_avg"),
               "nu": _moment_tree(optimizer, modules, members, "exp_avg_sq")}
    if isinstance(optimizer, torch.optim.AdamW):
        inner = {"0": moments, "1": {}, "2": {}}
    else:
        adam = {"0": moments, "1": {}}
        inner = {"0": {}, "1": adam} if optimizer.defaults["weight_decay"] else adam
    return {"count": count, "hyperparams": {"learning_rate": np.asarray(lr, np.float32)},
            "hyperparams_states": {}, "inner_state": inner}


def adam_tree(optimizer: torch.optim.Optimizer, modules: Dict[str, nn.Module]) -> Dict[str, Any]:
    """An Adam or AdamW optimizer's state in the JAX package's layout
    (``train/optim.py``): one ``inject_hyperparams`` state for a single
    group called "all", else ``multi_transform``'s ``inner_states`` per
    group, each moment tree over every parameter of ``modules`` with the
    other groups' leaves masked.  Moments and kernels are in flax's
    layouts."""
    groups = _group_params(optimizer, modules)
    if [name for name, _ in groups] == ["all"]:
        return _adam_state(optimizer, modules, groups[0])
    return {"inner_states": {g[0]: {"inner_state": _adam_state(optimizer, modules, g)}
                             for g in groups}}


def optimizer_tree(state: KWSTrainState) -> Dict[str, Any]:
    """The paper-1 optimizer state in the JAX package's layout
    (:func:`adam_tree`): one group, or under adversarial training the
    features, classifier and discriminator groups."""
    return adam_tree(state.optimizer, _modules(state))


def checkpoint_tree(state: KWSTrainState, global_step: int) -> Dict[str, Any]:
    """The checkpoint payload, all in the JAX package's layout (its ``fit``
    resumes from it and its ``test``/``validate`` read it): ``params`` and
    ``batch_stats``, the optimizer state (:func:`optimizer_tree`), the
    epoch and the global step."""
    kws = to_flax_variables(state.kws.state_dict())
    params = {"kws": kws["params"]}
    if state.disc is not None:
        params["disc"] = to_flax_variables(state.disc.state_dict())["params"]
    return {
        "params": params,
        "batch_stats": {"kws": kws["batch_stats"]},
        "epoch": state.epoch,
        "opt_state": optimizer_tree(state),
        "global_step": global_step,
    }


def _load_adam_state(group, saved: Dict[str, Any], opt: Dict[str, Any],
                     index: Dict[int, int]) -> None:
    """One group's saved ``inject_hyperparams`` state into ``opt`` (an
    ``optimizer.state_dict()``): its rate, and per parameter Adam's step
    and moments in torch's layout."""
    name, members = group
    inner = saved["inner_state"]
    adam = inner["0"] if "count" in inner["0"] else inner["1"]["0"]
    moments = {}
    for key, leaf in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        for m in {m for m, _, _ in members}:
            tree = adam[leaf][m] if m else adam[leaf]
            for n, t in from_flax_resnet_variables({"params": tree}).items():
                moments[(m, n, key)] = t
    step = torch.tensor(float(np.asarray(adam["count"])))
    for m, n, p in members:
        opt["state"][index[id(p)]] = {"step": step.clone(), "exp_avg": moments[(m, n, "exp_avg")],
                                      "exp_avg_sq": moments[(m, n, "exp_avg_sq")]}
    for g in opt["param_groups"]:
        if g["name"] == name:
            g["lr"] = float(np.asarray(saved["hyperparams"]["learning_rate"]))


def load_adam_tree(optimizer: torch.optim.Optimizer, modules: Dict[str, nn.Module],
                   saved: Dict[str, Any]) -> None:
    """Load :func:`adam_tree`'s layout (the port's or the JAX package's)
    into ``optimizer``: each group's rate, step count and moments."""
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(flat)}
    opt = optimizer.state_dict()
    opt["state"] = {}
    for group in _group_params(optimizer, modules):
        single = saved["inner_states"][group[0]]["inner_state"] if "inner_states" in saved else saved
        _load_adam_state(group, single, opt, index)
    optimizer.load_state_dict(opt)


def restore_train_state(state: KWSTrainState, tree: Dict[str, Any]) -> None:
    """Load a checkpoint tree (:func:`checkpoint_tree`'s or the JAX
    package's, the same layout) into ``state``: parameters, BatchNorm
    statistics, the epoch and, when the tree holds one, the optimizer state
    (a checkpoint without it keeps Adam fresh, as the JAX package does)."""
    state.kws.load_converted(from_flax_resnet_variables(
        {"params": tree["params"]["kws"], "batch_stats": tree["batch_stats"]["kws"]}))
    if state.disc is not None:
        state.disc.load_state_dict(from_flax_resnet_variables({"params": tree["params"]["disc"]}))
    state.epoch = int(tree.get("epoch", state.epoch))
    if tree.get("opt_state") is not None:
        load_adam_tree(state.optimizer, _modules(state), tree["opt_state"])


def make_grad_fn(config: KWSTrainConfig, kws: KWSModel, disc: Optional[Discriminator]):
    """The backward half of a step.

    Returns ``grads(batch, noise, beta, suppression) -> (metric_sums,
    n_examples)``: ``batch`` is a dict of tensors on the models' device;
    the gradients are *summed* over the minibatches into each parameter's
    ``.grad`` (which the caller zeroes), the BatchNorm running statistics
    move minibatch by minibatch, and ``metric_sums`` holds 0-d tensors."""

    n_mb = config.accumulate_grad_batches if config.adversarial_training else 1

    def dannce_update(x, d_labels, keep, beta):
        """Rewrite the inputs ``keep`` marks by an inner Adam maximizing
        the discriminator's loss, anchored to the class distribution."""
        kws.eval()  # the running statistics, and no update of them
        try:
            with torch.no_grad():
                old_logp = torch.log_softmax(kws(x).logits, dim=-1)
            x_adv = x.detach().clone().requires_grad_(True)
            inner = torch.optim.Adam([x_adv], lr=config.adversarial_examples_lr,
                                     betas=(0.9, 0.999), eps=1e-8)
            for _ in range(config.adversarial_train_steps):
                out = kws(x_adv)
                d_loss = disc(out.features, d_labels, beta=beta, use_grad_reverse=False).loss
                new_logp = torch.log_softmax(out.logits, dim=-1)
                # torch kl_div(input=old_logp, target=new_logp, log_target=True),
                # reduction 'mean' over all elements
                kl = torch.mean(torch.exp(new_logp) * (new_logp - old_logp))
                loss = d_loss * config.domain_adversary_weight + config.adv_kl_weight * kl
                (x_adv.grad,) = torch.autograd.grad(loss, x_adv)
                inner.step()
        finally:
            kws.train()
        return torch.where(keep[:, None, None, None], x_adv.detach(), x)

    def minibatch_loss(x, c_labels, d_labels, minibatch, noise, beta, suppression):
        out = kws(x)
        c_loss = cross_entropy(out.logits, c_labels)
        loss = c_loss
        metrics = {"class_loss": c_loss.detach()}
        if config.adversarial_training:
            keep = None
            if config.large_heads:
                keep = noise.dropout_keep(minibatch, x.shape[0], out.features.shape[-1] // 2)
            d_logits, d_loss = disc(out.features, d_labels, beta=beta, use_grad_reverse=True,
                                    keep=keep)
            loss = loss + d_loss
            metrics["domain_loss"] = d_loss.detach()
            metrics["disc_correct"] = (d_logits.argmax(-1) == d_labels).sum().to(torch.float32)
        if config.entropy:
            e_loss = entropy_loss(out.logits)
            if config.early_adversary_supression:
                e_loss = e_loss * (suppression * config.entropy_weight)
            # without suppression the reference adds the entropy term
            # unweighted (entropy_weight scales only the suppressed branch)
            loss = loss + e_loss
            metrics["entropy_loss"] = e_loss.detach()
        return loss, metrics

    def accumulate(batch: Dict[str, torch.Tensor], noise, beta: float, suppression: float):
        if config.kw_type == "all":
            # keep the tts (slot 0) or natural (slot 1) member of each
            # adjacent pair, tts with probability 1 - kw_p
            half = batch["labels"].shape[0] // 2
            pick_tts = noise.coin(half, 1.0 - config.kw_p)
            sel = 2 * torch.arange(half, device=pick_tts.device) + (~pick_tts).long()
            batch = {k: v[sel] for k, v in batch.items()}

        if config.device_features is not None and "utt_hs" in batch:
            feats = features_from_hidden_states(batch["kwd_hs"], batch["utt_hs"], batch["kwd_len"],
                                                batch["utt_len"], tuple(config.device_features))
            batch = {"features": feats, "labels": batch["labels"],
                     **({"domain": batch["domain"]} if "domain" in batch else {})}
        features, c_labels = batch["features"], batch["labels"]
        d_labels = batch.get("domain")
        if d_labels is None:
            d_labels = torch.zeros_like(c_labels)
        mb = features.shape[0] // n_mb

        if config.dannce and config.adversarial_training:
            features = torch.cat([
                dannce_update(features[i * mb:(i + 1) * mb], d_labels[i * mb:(i + 1) * mb],
                              noise.adversarial_mask(i, mb, config.adversarial_examples_ratio), beta)
                for i in range(n_mb)
            ])

        sums: Dict[str, torch.Tensor] = {}
        for i in range(n_mb):
            rows = slice(i * mb, (i + 1) * mb)
            loss, metrics = minibatch_loss(features[rows], c_labels[rows], d_labels[rows], i,
                                           noise, beta, suppression)
            loss.backward()
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        return sums, features.shape[0]

    return accumulate


def make_train_step(config: KWSTrainConfig, state: KWSTrainState):
    """``step(batch, noise, beta, suppression) -> metrics``: gradient
    accumulation (:func:`make_grad_fn`) then the optimizer update.  The
    metrics are 0-d tensors on the device: the losses averaged over the
    minibatches, ``disc_correct`` over the examples."""

    accumulate = make_grad_fn(config, state.kws, state.disc)
    n_mb = config.accumulate_grad_batches if config.adversarial_training else 1
    params = [p for group in state.optimizer.param_groups for p in group["params"]]

    def step(batch, noise, beta: float, suppression: float) -> Dict[str, torch.Tensor]:
        for p in params:
            p.grad = None
        sums, n_examples = accumulate(batch, noise, beta, suppression)
        for p in params:  # optax updates every parameter, zero gradients too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        return {k: v / (n_examples if k == "disc_correct" else n_mb) for k, v in sums.items()}

    return step
