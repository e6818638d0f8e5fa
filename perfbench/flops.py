"""Operations and bytes of the measured work, counted from shapes.

FLOPs count 2 per multiply-add, for the products the program computes at
the shapes it runs (padded catalog rows and beam copies of a prompt
included).  Elementwise work (norms, softmax, activations) is not counted.
"""

from __future__ import annotations

from typing import Sequence

HOP_LENGTH = 160


def _out(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


def resnet_conv_flops(rcfg: dict, num_channels: int, size: Sequence[int]) -> int:
    """Every convolution of one bottleneck-ResNet forward over one map of
    ``size``: stem, block convolutions and shortcuts (copied from
    chip_smoke.py:2785, ``resnet_conv_flops``)."""
    h, w = _out(size[0], 7, 2), _out(size[1], 7, 2)
    flops = 2 * 49 * num_channels * rcfg["embedding_size"] * h * w
    h, w, in_ch = _out(h, 3, 2), _out(w, 3, 2), rcfg["embedding_size"]
    for stage, (width, depth) in enumerate(zip(rcfg["hidden_sizes"], rcfg["depths"])):
        for block in range(depth):
            stride = (2 if stage > 0 else 1) if block == 0 else 1
            ho, wo = _out(h, 3, stride), _out(w, 3, stride)
            red = width // 4
            flops += 2 * (in_ch * red * h * w + 9 * red * red * ho * wo + red * width * ho * wo)
            if in_ch != width or stride != 1:
                flops += 2 * in_ch * width * ho * wo
            h, w, in_ch = ho, wo, width
    return flops


def encoder_flops(cfg: dict, frames: int = 3000) -> int:
    """One Whisper encoder forward on a 30 s mel: the two convolutions and,
    per layer, the Q/K/V/O projections, the FFN and the two attention
    products (copied from chip_smoke.py:3915, ``encoder_flops``)."""
    t, d, f = frames // 2, cfg["d_model"], cfg["encoder_ffn_dim"]
    convs = 2 * 3 * (frames * d * cfg["num_mel_bins"] + t * d * d)
    layer = 2 * t * (4 * d * d + 2 * d * f) + 2 * 2 * t * t * d
    return convs + cfg["encoder_layers"] * layer


def cross_kv_flops(cfg: dict) -> int:
    """The cross-attention K and V of one segment, every decoder layer."""
    d = cfg["d_model"]
    return cfg["decoder_layers"] * 2 * 2 * cfg["max_source_positions"] * d * d


def decoder_token_flops(cfg: dict, length: int) -> int:
    """One decoder position attending ``length`` positions of its own
    cache: per layer the self-attention projections, the cross-attention's
    Q and output projections, both attention products and the FFN; then
    the vocabulary projection."""
    d, f, src = cfg["d_model"], cfg["decoder_ffn_dim"], cfg["max_source_positions"]
    layer = 2 * (4 * d * d + 2 * d * d + 2 * d * f) + 2 * 2 * length * d + 2 * 2 * src * d
    return cfg["decoder_layers"] * layer + 2 * d * cfg["vocab_size"]


def prefill_flops(cfg: dict, rows: int, prompt_len: int) -> int:
    """A causal prefill of ``prompt_len`` positions in each of ``rows``."""
    return rows * sum(decoder_token_flops(cfg, t + 1) for t in range(prompt_len))


def cbw_sim_flops(kws: dict, d_model: int, enc_frames: int, kw_frames: int, maps: int) -> int:
    """The catalog scorer's similarity maps outside the ResNet: the
    utterance's width resize once, then per keyword map the product over D
    at the keyword's native length and the height resize."""
    n_layers = kws["layer_slice"][1] - kws["layer_slice"][0]
    out_h, out_w = kws["features_size"]
    utt = 2 * n_layers * out_w * enc_frames * d_model
    per_map = 2 * n_layers * kw_frames * out_w * d_model + 2 * n_layers * out_h * kw_frames * out_w
    return utt + maps * per_map


def lef_projection_flops(cfg: dict, frames: int) -> int:
    """The LEF projection stack of one [L, frames, D] input: the per-layer
    MLP and the time convolution."""
    d, u, n_layers = cfg["embedding_dim"], cfg["proj_mlp_units"], cfg["n_layers"]
    width = cfg.get("input_dim", d)
    mlp = 2 * frames * (width * (d // 2) + (d // 2) * u)
    conv = 2 * frames * u * u * 3
    return n_layers * (mlp + conv)


def lef_sim_flops(cfg: dict, kw_frames: int, utt_frames: int, maps: int) -> int:
    """Per-layer similarity maps (or the proxy's products) of ``maps``
    projected keywords against the projected utterance."""
    return maps * cfg["n_layers"] * 2 * kw_frames * utt_frames * cfg["proj_mlp_units"]


def k1_bytes(n_samples: int, n_mels: int) -> int:
    """K1's least traffic at [1, n_samples]: the audio read once, the mels
    written once (chip_smoke.py:4661, ``k1_bound``)."""
    return n_samples * 4 + (n_samples // HOP_LENGTH) * n_mels * 4
