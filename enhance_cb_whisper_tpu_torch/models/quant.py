"""int8 quantized ResNet inference for catalog scoring (port of
enhance_cb_whisper_tpu/models/quant.py: paper 1's classifier and paper 2's,
:func:`quantize_resnet_classifier` and :func:`quantize_efficient_classifier`).

Scheme, as in the JAX package:

* BatchNorm (eval mode, running statistics) folded into the preceding
  conv: ``W_eff = W * gamma/sqrt(var+eps)``, ``b_eff = beta - mean*gamma/sqrt(..)``;
* weights: symmetric per-output-channel int8;
* activations: **static** per-site scalar scales from a calibration pass
  (:func:`calibrate_act_scales`; intermediates bf16, the stem max-pool on
  int8 codes), or **dynamic** per-example ``max|x|/127`` when the
  parameters carry no scales (intermediates f32);
* convolutions accumulate exactly in integers; residual adds, the global
  pool and the head stay float; a block's input is quantized once and
  shared by the shortcut and the first block conv.

Folding and quantization run the JAX package's numpy arithmetic on the
same weights (in its ``[kh, kw, in, out]`` layout), so both packages hold
identical int8 codes.  The parameters then live on the device in torch's
layout (:func:`..convert.from_jax_quantized_params`): ``wq`` int8
``[out, in, kh, kw]``, ``s_w`` and ``b`` f32 ``[out]``, the head's
``kernel`` ``[in, out]``, and optionally ``act_scales`` (site → float).

Integer convolutions outside the fused kernel are ``F.conv2d`` in float64,
exact because every partial sum is an integer below 127²·k²·C_in < 2⁵³
(float32 or TF32 would round above 2²⁴).  In static mode the bottleneck
1×1 convolutions of the stages named in ``s8_1x1`` run on the fused s8
matmul + requant kernel K2 (:mod:`..ops.matmul_s8`) instead; this stage set
is the explicit counterpart of the JAX package's ``pallas_1x1`` argument
(read there from the ``ECW_S8_PALLAS`` environment variable, empty by
default; the port reads no environment).  The CLI hands every stage
(:func:`s8_stages`), so each 1×1 conv whose shapes K2 takes runs on it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import from_jax_quantized_params
from ..ops import matmul_s8_cuda
from .resnet import ResNetConfig

_EPS = 1e-5  # BatchNorm epsilon of models/resnet.py


def s8_stages(config: ResNetConfig) -> frozenset:
    """Every stage of ``config``, as ``s8_1x1``: the bottleneck 1×1 convs
    whose K and N are multiples of 128 then run on K2, the others on the
    integer conv."""
    return frozenset(f"stage_{i}" for i in range(len(config.depths)))


def _fold_conv_bn(w_oihw: np.ndarray, gamma, beta, mean, var) -> Dict[str, np.ndarray]:
    """Fold eval-mode BatchNorm into the conv kernel; quantize per channel.
    Works in the JAX package's ``[kh, kw, I, O]`` layout and arithmetic."""
    w = np.ascontiguousarray(np.asarray(w_oihw, np.float32).transpose(2, 3, 1, 0))
    gamma = np.asarray(gamma, np.float32)
    beta = np.asarray(beta, np.float32)
    mean = np.asarray(mean, np.float32)
    var = np.asarray(var, np.float32)
    scale = gamma / np.sqrt(var + _EPS)
    w_eff = w * scale  # broadcast over O (last axis)
    b_eff = beta - mean * scale
    s_w = np.abs(w_eff).reshape(-1, w_eff.shape[-1]).max(axis=0) / 127.0
    s_w = np.maximum(s_w, 1e-12)
    wq = np.clip(np.rint(w_eff / s_w), -127, 127).astype(np.int8)
    return {"wq": wq, "s_w": s_w.astype(np.float32), "b": b_eff.astype(np.float32)}


def _quantize_resnet_tree(state: Mapping[str, np.ndarray], prefix: str,
                          config: ResNetConfig) -> Dict[str, Any]:
    """Fold + quantize a bare ``ResNet`` (embedder + stages) from a flat
    state dict whose keys start with ``prefix``; JAX-layout numpy tree."""

    def fold(module: str) -> Dict[str, np.ndarray]:
        conv, bn = f"{prefix}{module}.convolution", f"{prefix}{module}.normalization"
        return _fold_conv_bn(
            state[f"{conv}.weight"], state[f"{bn}.weight"], state[f"{bn}.bias"],
            state[f"{bn}.running_mean"], state[f"{bn}.running_var"],
        )

    q: Dict[str, Any] = {"embedder": fold("embedder")}
    n_layers = 3 if config.layer_type == "bottleneck" else 2
    for stage_idx, depth in enumerate(config.depths):
        for block_idx in range(depth):
            name = f"stage_{stage_idx}_block_{block_idx}"
            block = {f"layer_{i}": fold(f"{name}.layer_{i}") for i in range(n_layers)}
            if f"{prefix}{name}.shortcut.convolution.weight" in state:
                block["shortcut"] = fold(f"{name}.shortcut")
            q[name] = block
    return q


def quantize_resnet_classifier(model: torch.nn.Module, config: ResNetConfig,
                               device=None) -> Dict[str, Any]:
    """int8 parameters from an fp32 :class:`.kws.KWSModel` (or a bare
    ``ResNetClassifier``), on ``device`` — by default the model's own."""
    if device is None:
        device = next(model.parameters()).device
    state = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    root = "model." if any(k.startswith("model.") for k in state) else ""
    q = _quantize_resnet_tree(state, f"{root}feature_extractor.", config)
    q["classifier"] = {
        "kernel": np.ascontiguousarray(state[f"{root}classifier.weight"].T.astype(np.float32)),
        "bias": state[f"{root}classifier.bias"].astype(np.float32),
    }
    return from_jax_quantized_params(q, device=device)


def quantize_efficient_classifier(model: torch.nn.Module, config: ResNetConfig,
                                  device=None) -> Dict[str, Any]:
    """The same for a paper-2 :class:`..efficient_kws.model.EfficientKWSModel`:
    its bare ResNet under ``model.`` and the head as the sibling
    ``classifier``.  The projection stack stays float."""
    if device is None:
        device = next(model.parameters()).device
    state = {k: v.detach().to(torch.float32).cpu().numpy() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    q = _quantize_resnet_tree(state, "model.", config)
    q["classifier"] = {
        "kernel": np.ascontiguousarray(state["classifier.weight"].T),
        "bias": state["classifier.bias"],
    }
    return from_jax_quantized_params(q, device=device)


def _forward(
    config: ResNetConfig,
    qparams: Dict[str, Any],
    pixel_values: torch.Tensor,
    record: Optional[Dict[str, torch.Tensor]],
    float_stages: frozenset = frozenset(),
    s8_1x1: frozenset = frozenset(),
) -> torch.Tensor:
    """Shared topology walker, NCHW throughout.

    ``record is None`` → quantized int8 forward (static scales if
    ``qparams['act_scales']`` is present, else per-example dynamic);
    ``record`` a dict → f32 forward with the dequantized folded weights,
    recording ``max|x|`` at every activation-quantization site (the
    calibration pass).  ``float_stages`` (e.g. ``{"stem", "stage_0"}``) runs
    those parts with the dequantized folded weights in the compute dtype
    and no activation quantization.  ``s8_1x1`` names the stages whose
    bottleneck 1×1 convs run on the fused kernel (static mode only)."""
    scales = qparams.get("act_scales") if record is None else None
    static = scales is not None
    device = pixel_values.device

    def f32(v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=device)

    def in_float(name: str) -> bool:
        if record is not None or not float_stages:
            return False
        stage = name.rsplit("_block_", 1)[0] if "_block_" in name else name
        return stage in float_stages

    # static mode keeps intermediates bf16 where the JAX package does; the
    # dynamic path and calibration run f32
    cdt = torch.bfloat16 if static else torch.float32
    x = pixel_values.to(cdt)

    def channel(v: torch.Tensor) -> torch.Tensor:
        return v.reshape(1, -1, 1, 1)

    def quant(site, xf):
        """→ (conv input representation, activation scale)."""
        if record is not None:
            record[site] = torch.amax(torch.abs(xf))
            return xf, None
        if static:
            s = f32(scales[site])
        else:
            s = torch.amax(torch.abs(xf), dim=(1, 2, 3), keepdim=True).to(torch.float32) / 127.0
            s = torch.clamp_min(s, 1e-12)
        xq = torch.clamp(torch.round(xf.to(torch.float32) / s), -127, 127).to(torch.int8)
        return xq, s

    def conv(xr, s_x, qc, stride, kernel_size, act):
        pad = kernel_size // 2
        if record is not None:
            w = qc["wq"].to(torch.float32) * qc["s_w"].reshape(-1, 1, 1, 1)
            y = F.conv2d(xr, w, stride=stride, padding=pad) + channel(qc["b"])
        else:
            # exact integer accumulation (see the module docstring)
            z = F.conv2d(xr.to(torch.float64), qc["wq"].to(torch.float64),
                         stride=stride, padding=pad)
            s = s_x.reshape(-1, 1, 1, 1) * channel(qc["s_w"])
            y = (z.to(torch.float32) * s + channel(qc["b"])).to(cdt)
        return torch.relu(y) if act else y

    def convf(xf, qc, stride, kernel_size, act):
        """Dequantized-folded-weight conv: operands rounded to the compute
        dtype, products summed in f32."""
        pad = kernel_size // 2
        w = (qc["wq"].to(torch.float32) * qc["s_w"].reshape(-1, 1, 1, 1)).to(cdt)
        z = F.conv2d(xf.to(cdt).to(torch.float32), w.to(torch.float32),
                     stride=stride, padding=pad)
        y = (z + channel(qc["b"])).to(cdt)
        return torch.relu(y) if act else y

    def chain(xr, s_x, qc, stride, kernel_size, site):
        """conv + ReLU + quantize for the next conv."""
        return quant(site, conv(xr, s_x, qc, stride, kernel_size, act=True))

    def pmm(xr, s_x, qc, s_out, relu, residual=None, res_scale=None):
        """1×1 conv on the fused s8 matmul + requant kernel: int8 codes in,
        int8 codes at ``s_out`` out."""
        b, c, h, w = xr.shape
        n = qc["wq"].shape[0]
        rows = lambda t: t.permute(0, 2, 3, 1).reshape(b * h * w, -1)  # noqa: E731
        y = matmul_s8_cuda.matmul_s8_requant(
            rows(xr), qc["wq"].reshape(n, c).t(),
            s_x * qc["s_w"] / s_out, qc["b"] / s_out,
            relu=relu,
            residual=None if residual is None else rows(residual),
            res_scale=res_scale,
        )
        return y.reshape(b, h, w, n).permute(0, 3, 1, 2)

    def block_residual(x, xr, s_x, qb, stride, pre_quantized):
        if "shortcut" in qb:
            return conv(xr, s_x, qb["shortcut"], stride, 1, act=False)
        if pre_quantized is not None:
            # no shortcut and an int8 input (the pooled stem): dequantize
            return (xr.to(torch.float32) * s_x).to(cdt)
        return x

    def float_input(x, pre_quantized):
        if pre_quantized is not None:  # int8 pooled stem feeding a float block
            xr, s_x = pre_quantized
            return (xr.to(torch.float32) * s_x).to(cdt)
        return x

    def bottleneck(x, name, stride, pre_quantized=None):
        qb = qparams[name]
        if in_float(name):
            x = float_input(x, pre_quantized)
            residual = convf(x, qb["shortcut"], stride, 1, act=False) if "shortcut" in qb else x
            h = convf(x, qb["layer_0"], 1, 1, act=True)
            h = convf(h, qb["layer_1"], stride, 3, act=True)
            h = convf(h, qb["layer_2"], 1, 1, act=False)
            return torch.relu(h + residual)
        xr, s_x = pre_quantized if pre_quantized is not None else quant(f"{name}.in", x)
        residual = block_residual(x, xr, s_x, qb, stride, pre_quantized)
        hr, s_h = chain(xr, s_x, qb["layer_0"], 1, 1, f"{name}.a")
        hr, s_h = chain(hr, s_h, qb["layer_1"], stride, 3, f"{name}.b")
        h = conv(hr, s_h, qb["layer_2"], 1, 1, act=False)
        return torch.relu(h + residual)

    def bottleneck_s8(x, name, stride, pre_quantized, next_site):
        """Bottleneck with its 1×1 convs on the fused kernel.  layer_0 emits
        int8 at the ``.a`` scale.  A block without a shortcut also fuses its
        tail (layer_2 + residual add + ReLU + requantization to the next
        block's input scale) into one launch when the next block runs this
        path too (``next_site``), and hands int8 codes on; a shortcut block
        keeps the float tail (its residual is a strided conv output)."""
        qb = qparams[name]
        xr, s_x = pre_quantized if pre_quantized is not None else quant(f"{name}.in", x)
        s_a = f32(scales[f"{name}.a"])
        hr = pmm(xr, s_x, qb["layer_0"], s_a, relu=True)
        hr, s_b = chain(hr, s_a, qb["layer_1"], stride, 3, f"{name}.b")
        if "shortcut" in qb:
            residual = conv(xr, s_x, qb["shortcut"], stride, 1, act=False)
            h = conv(hr, s_b, qb["layer_2"], 1, 1, act=False)
            return torch.relu(h + residual), None
        if next_site is not None:
            s_next = f32(scales[next_site])
            out = pmm(hr, s_b, qb["layer_2"], s_next, relu=True,
                      residual=xr, res_scale=s_x / s_next)
            return None, (out, s_next)
        h = conv(hr, s_b, qb["layer_2"], 1, 1, act=False)
        residual = (xr.to(torch.float32) * s_x).to(cdt)
        return torch.relu(h + residual), None

    def basic(x, name, stride, pre_quantized=None):
        qb = qparams[name]
        if in_float(name):
            x = float_input(x, pre_quantized)
            residual = convf(x, qb["shortcut"], stride, 1, act=False) if "shortcut" in qb else x
            h = convf(x, qb["layer_0"], stride, 3, act=True)
            h = convf(h, qb["layer_1"], 1, 3, act=False)
            return torch.relu(h + residual)
        xr, s_x = pre_quantized if pre_quantized is not None else quant(f"{name}.in", x)
        residual = block_residual(x, xr, s_x, qb, stride, pre_quantized)
        hr, s_h = chain(xr, s_x, qb["layer_0"], stride, 3, f"{name}.a")
        h = conv(hr, s_h, qb["layer_1"], 1, 3, act=False)
        return torch.relu(h + residual)

    # stem
    if in_float("stem"):
        x = convf(x, qparams["embedder"], 2, 7, act=True)
    else:
        xr, s_x = quant("input", x)
        x = conv(xr, s_x, qparams["embedder"], 2, 7, act=True)
    if record is None and static and not in_float("stage_0"):
        # quantization is monotonic, so it commutes with max-pool: quantize
        # the stem output first and pool the int8 codes (as floats, exact);
        # stage_0_block_0's input site therefore reuses the stem scale
        s_stem = f32(scales["stage_0_block_0.in"])
        xq = torch.clamp(torch.round(x.to(torch.float32) / s_stem), -127, 127)
        x = F.max_pool2d(xq, 3, stride=2, padding=1).to(torch.int8)
        pooled_q = (x, s_stem)
    else:
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        pooled_q = None

    block_fn = bottleneck if config.layer_type == "bottleneck" else basic

    plan = []
    for stage_idx, depth in enumerate(config.depths):
        first_stride = 2 if (stage_idx > 0 or config.downsample_in_first_stage) else 1
        for block_idx in range(depth):
            plan.append((f"stage_{stage_idx}_block_{block_idx}",
                         first_stride if block_idx == 0 else 1))

    use_s8 = record is None and static and bool(s8_1x1) and config.layer_type == "bottleneck"

    def s8_block(name: str) -> bool:
        if not use_s8 or in_float(name):
            return False
        if name.rsplit("_block_", 1)[0] not in s8_1x1:
            return False
        qb = qparams[name]  # the JAX kernel's rule: K, N multiples of 128
        return all(
            qb[l]["wq"].shape[1] % 128 == 0 and qb[l]["wq"].shape[0] % 128 == 0
            for l in ("layer_0", "layer_2")
        )

    xq = None  # int8 (codes, scale) handed between fused blocks
    for idx, (name, stride) in enumerate(plan):
        # stage_0_block_0 in static mode consumes the already-int8 pooled
        # stem output; later blocks consume the previous fused tail's codes
        pre = pooled_q if idx == 0 else xq
        xq = None
        if s8_block(name):
            nxt = plan[idx + 1][0] if idx + 1 < len(plan) else None
            next_site = f"{nxt}.in" if nxt is not None and s8_block(nxt) else None
            x, xq = bottleneck_s8(x, name, stride, pre, next_site)
        else:
            x = block_fn(x, name, stride, pre_quantized=pre)

    features = x.to(torch.float32).mean(dim=(2, 3))
    return features @ qparams["classifier"]["kernel"] + qparams["classifier"]["bias"]


@torch.no_grad()
def quantized_apply(
    config: ResNetConfig,
    qparams: Dict[str, Any],
    pixel_values: torch.Tensor,
    float_stages=(),
    s8_1x1=(),
) -> torch.Tensor:
    """int8 forward matching ``ResNetClassifier`` (eval mode): NCHW
    ``[B, L, H, W]`` similarity maps → logits ``[B, num_labels]``.  Static
    scales when ``qparams['act_scales']`` exists, else per-example dynamic
    quantization.  ``s8_1x1`` is the JAX package's ``pallas_1x1``: stages
    whose bottleneck 1×1 convs run the fused kernel."""
    return _forward(config, qparams, pixel_values, record=None,
                    float_stages=frozenset(float_stages), s8_1x1=frozenset(s8_1x1))


@torch.no_grad()
def calibrate_act_scales(
    config: ResNetConfig,
    qparams: Dict[str, Any],
    images,
    margin: float = 1.0,
) -> Dict[str, Any]:
    """One-pass post-training calibration: run the folded (dequantized-
    weight) f32 network on representative similarity maps and set each
    site's scale to ``margin * max|x| / 127``.  Returns a new parameter dict
    with ``act_scales``, which turns on the static path."""
    device = qparams["classifier"]["kernel"].device
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    record: Dict[str, torch.Tensor] = {}
    _forward(config, qparams, images, record=record)
    sites = list(record)
    maxes = torch.stack([record[s] for s in sites]).cpu().numpy()
    scales = {
        site: float(np.maximum(v, 1e-9)) * margin / 127.0 for site, v in zip(sites, maxes)
    }
    return {**qparams, "act_scales": scales}


def make_quantized_kws_apply(
    config: ResNetConfig,
    act_scales: Optional[Dict[str, float]] = None,
    float_stages=(),
    s8_1x1=(),
):
    """Adapter ``kws_apply(qparams, images) -> logits`` over
    :func:`quantized_apply`; ``act_scales`` (from
    :func:`calibrate_act_scales`) override those in ``qparams``."""
    fs, s8 = tuple(float_stages), tuple(s8_1x1)

    def kws_apply(qparams, images):
        if act_scales is not None:
            qparams = {**qparams, "act_scales": act_scales}
        return quantized_apply(config, qparams, images, float_stages=fs, s8_1x1=s8)

    return kws_apply
