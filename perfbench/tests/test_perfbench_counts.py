"""The FLOP and byte counters against hand counts at small shapes: the
reference's products and convolutions counted as they run."""

import torch

from perfbench import flops
from perfbench.reference import lef as ref_lef
from perfbench.reference import resnet as ref_resnet
from perfbench.reference import whisper as ref_whisper
from perfbench.reference.precision import Prec
from perfbench import weights

from tiny import TINY_RESNET


class Counting(Prec):
    """Full fp32 that counts 2 FLOPs per multiply-add of every product
    and convolution it runs."""

    def __init__(self):
        super().__init__("fp32")
        self.flops = 0

    def matmul(self, a, b):
        out = super().matmul(a, b)
        self.flops += 2 * out.numel() * a.shape[-1]
        return out

    def linear(self, x, w, b=None):
        out = super().linear(x, w, b)
        self.flops += 2 * out.numel() * w.shape[1]
        return out

    def conv1d(self, x, w, b=None, stride=1, padding=0):
        out = super().conv1d(x, w, b, stride, padding)
        self.flops += 2 * out.numel() * w[0].numel()
        return out

    def conv2d(self, x, w, stride=1, padding=0):
        out = super().conv2d(x, w, stride, padding)
        self.flops += 2 * out.numel() * w[0].numel()
        return out


def test_resnet_conv_flops():
    spec = weights.resnet_spec(TINY_RESNET, 3, "m.", 0.2)
    w = weights.materialize(spec, 1, 1, "cpu")
    for size in ((30, 150), (17, 33)):
        prec = Counting()
        ref_resnet.features(w, TINY_RESNET, torch.randn(1, 3, *size), "m.", prec)
        assert flops.resnet_conv_flops(TINY_RESNET, 3, size) == prec.flops


def test_encoder_flops():
    cfg = {"d_model": 16, "encoder_layers": 2, "encoder_attention_heads": 2, "encoder_ffn_dim": 24,
           "num_mel_bins": 8, "max_source_positions": 20, "decoder_layers": 0, "decoder_ffn_dim": 24,
           "decoder_attention_heads": 2, "vocab_size": 10, "max_target_positions": 4, "init_std": 0.02}
    w = weights.materialize(weights.whisper_spec(cfg), 1, 1, "cpu")
    prec = Counting()
    ref_whisper.encode(w, cfg, torch.randn(8, 40), prec)
    assert flops.encoder_flops(cfg, frames=40) == prec.flops


def test_decoder_token_and_k1_bytes_by_hand():
    cfg = {"d_model": 4, "decoder_ffn_dim": 8, "decoder_layers": 1, "vocab_size": 10, "max_source_positions": 3}
    # q, k, v, out (self) + q, out (cross): 6 d²; fc1, fc2: 2 d f; scores and
    # values over 5 own positions and 3 source positions; the vocabulary
    assert flops.decoder_token_flops(cfg, 5) == 2 * (6 * 16 + 2 * 32) + 2 * 2 * 5 * 4 + 2 * 2 * 3 * 4 + 2 * 4 * 10
    assert flops.prefill_flops(cfg, 2, 3) == 2 * sum(flops.decoder_token_flops(cfg, t) for t in (1, 2, 3))
    assert flops.k1_bytes(480000, 80) == 2_880_000  # 1.92 MB of audio in, 0.96 MB of mels out


def test_lef_projection_and_sim_flops():
    cfg = {"embedding_dim": 16, "proj_mlp_units": 4, "n_layers": 3, "resnet": TINY_RESNET, "last_bn": 0.2}
    w = weights.materialize(weights.lef_spec(cfg), 1, 1, "cpu")
    prec = Counting()
    utt, _ = ref_lef.project(w, cfg, torch.randn(1, 3, 40, 16), None, prec)
    assert flops.lef_projection_flops(cfg, 40) == prec.flops
    kwd = torch.randn(5, 3, 8, 4)
    prec = Counting()
    ref_lef.sims(kwd, utt, torch.ones(5, 3, 8), torch.ones(1, 3, utt.shape[2]), prec)
    assert flops.lef_sim_flops(cfg, 8, utt.shape[2], 5) == prec.flops
