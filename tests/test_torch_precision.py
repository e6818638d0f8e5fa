"""TF32 stays off on the card: ``reference_precision`` clears both of
PyTorch's TF32 switches and leaves them cleared; the entry points call it
for a CUDA device only, so a CPU run leaves the caller's flags alone.  The
paper-2 catalog scorers read the device from the model they are given."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding.generate import WhisperGenerator
from enhance_cb_whisper_tpu_torch.efficient_kws import catalog
from enhance_cb_whisper_tpu_torch.efficient_kws.engine import EfficientKWSEngine
from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSConfig, EfficientKWSModel
from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, init_whisper_params
from enhance_cb_whisper_tpu_torch.runtime.kws_engine import KWSEngine
from enhance_cb_whisper_tpu_torch.runtime.precision import reference_precision


@pytest.fixture
def tf32_on():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def test_reference_precision_clears_both_flags(tf32_on):
    assert _flags() == (True, True)
    reference_precision()
    assert _flags() == (False, False)
    reference_precision()  # idempotent, and nothing turns them back on
    assert _flags() == (False, False)


def test_cpu_entry_points_leave_the_flags(tf32_on):
    cfg = WhisperConfig(vocab_size=16, d_model=8, encoder_layers=1, encoder_attention_heads=2,
                        decoder_layers=1, decoder_attention_heads=2, encoder_ffn_dim=16,
                        decoder_ffn_dim=16, max_source_positions=4, max_target_positions=8,
                        num_mel_bins=4)
    params = from_jax_whisper_params(init_whisper_params(np.random.default_rng(0), cfg), device="cpu")
    WhisperGenerator(cfg, params, device="cpu")
    KWSEngine(device="cpu")
    p2 = EfficientKWSConfig(n_layers=2, embedding_dim=8, proj_mlp_units=4, resnet_version="resnet-18")
    EfficientKWSEngine(p2, device="cpu")
    model = EfficientKWSModel(p2)
    catalog.make_projected_score_fn(model)
    catalog.make_cascade_score_fn(model)
    assert _flags() == (True, True)


class _ModelOnTheCard:
    """Stands in for a model whose parameters lie on the card: the score
    function builders read only its device before the first call."""

    def parameters(self):
        return iter([SimpleNamespace(device=torch.device("cuda"))])


@pytest.mark.parametrize("builder", ["make_projected_score_fn", "make_cascade_score_fn"])
def test_catalog_scorers_on_the_card_hold_reference_precision(tf32_on, builder):
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        getattr(catalog, builder)(_ModelOnTheCard())
        assert _flags() == (False, False)
        assert matmul.allow_bf16_reduced_precision_reduction is False
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved


def test_reference_precision_forbids_bf16_partial_sums():
    """cuBLAS may reduce split-K partial sums of a bf16 GEMM in bf16 unless
    told not to; the JAX package accumulates in f32."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        reference_precision()
        assert matmul.allow_bf16_reduced_precision_reduction is False
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
