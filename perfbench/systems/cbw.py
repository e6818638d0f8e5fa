"""The program under test for a CB-Whisper configuration: the port's
``CBWhisper`` built from the configuration file.

Whisper's weights go in as an HF state dict (the port's
``load_hf_whisper``), the spotter's under the port's module names, the
catalog as host stacks (``KeywordCatalog.from_arrays``).  The model, its
catalog and its centred head are the deployment's: drawn from the
configuration's ``weights_seed``, the same in every run (the run's seed
drives the traffic).  Tokenization is the stand-in of
``chip_smoke.py:_medium_pipeline`` (chip_smoke.py:707).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import traffic, weights

SALT_WHISPER, SALT_KWS = 1, 2
CENTRE_INDEX = 2**32  # the clip of weights_seed's pool the spotter's head is centred on


def prompt_ids(text: str):
    """Tokenizer stand-in: ``<|startofprev|>`` and the first 8 characters."""
    return [50361] + [100 + (ord(c) % 1000) for c in text][:8]


def decode_text(tokens) -> str:
    """Detokenizer stand-in: the token ids, space-separated."""
    return " ".join(str(int(t)) for t in tokens)


def whisper_config(cfg: dict):
    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig

    return WhisperConfig(**{f.name: cfg[f.name] for f in dataclasses.fields(WhisperConfig)})


def generation_options(cfg: dict):
    from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions

    gen = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["generation"].items()}
    return GenerationOptions(**gen, begin_suppress_tokens=tuple(cfg["begin_suppress_tokens"]),
                             eos_token_id=cfg["eos_token_id"], pad_token_id=cfg["pad_token_id"],
                             decoder_start_token_id=cfg["decoder_start_token_id"],
                             max_target_positions=cfg["max_target_positions"])


def kws_config(kws: dict):
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig

    r = kws["resnet"]
    return ResNetConfig(num_channels=kws["num_channels"], embedding_size=r["embedding_size"],
                        hidden_sizes=tuple(r["hidden_sizes"]), depths=tuple(r["depths"]),
                        layer_type=r["layer_type"], num_labels=2)


def catalog_stacks(cfg: dict, device):
    kws = cfg["kws"]
    n_layers = kws["layer_slice"][1] - kws["layer_slice"][0]
    return weights.keyword_stacks(cfg["weights_seed"], kws["keywords"], n_layers, kws["keyword_frames"],
                                  cfg["d_model"], device)


def centre_audio(cfg: dict) -> np.ndarray:
    return traffic.noise_and_tone(cfg["weights_seed"], CENTRE_INDEX, 30.0)


def build(cfg: dict, device):
    """The port's CBWhisper on ``device``, its spotter's head centred."""
    from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog
    from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper, CBWhisperConfig
    from enhance_cb_whisper_tpu_torch.models.kws import KWSModel
    from enhance_cb_whisper_tpu_torch.models.whisper_loader import load_hf_whisper

    kws = cfg["kws"]
    wcfg = whisper_config(cfg)
    seed = cfg["weights_seed"]
    params = load_hf_whisper(weights.materialize(weights.whisper_spec(cfg), seed, SALT_WHISPER, device),
                             wcfg, device)
    with torch.device(device):
        spotter = KWSModel(kws_config(kws))
    spotter.load_converted(weights.materialize(weights.cbw_kws_spec(kws), seed, SALT_KWS, device))
    stacks = [s.cpu().numpy() for s in catalog_stacks(cfg, device)]
    catalog = KeywordCatalog.from_arrays([f"kw{i}" for i in range(len(stacks))], stacks)
    cb = CBWhisper(
        config=CBWhisperConfig(kws_features_size=tuple(kws["features_size"]), keywords_per_group=kws["keywords"]),
        whisper_config=wcfg, whisper_params=params, kws_model=spotter, catalog=catalog,
        generation_options=generation_options(cfg), prompt_ids_fn=prompt_ids, decode_fn=decode_text,
        kws_layer_slice=tuple(kws["layer_slice"]), device=device,
    )
    centre(cb, cfg)
    return cb


@torch.no_grad()
def centre(cb, cfg: dict) -> None:
    """A random head says "present" for every keyword or for none: centre
    its class-1 bias on the catalog's median margin over one 30 s segment,
    so some keywords pass and others do not (chip_smoke.py:758,
    ``_centre_class1``)."""
    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
    from enhance_cb_whisper_tpu_torch.models.whisper import encoder_kws_stack

    n = cfg["kws"]["keywords"]
    feats, _ = prepare_features(centre_audio(cfg), n_mels=cfg["num_mel_bins"], device=cb.device)
    cb._ensure_catalog()
    stack = encoder_kws_stack(cb.generator.params, feats, cb.whisper_config, layer_slice=cb.kws_layer_slice)
    _, logits = cb._score_fn(cb._catalog_dev, stack[0], cb._utt_w)
    margin = logits[:n, 1] - logits[:n, 0]
    cb.kws_model.model.classifier.bias[1] -= margin.median()
