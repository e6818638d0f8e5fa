"""CLI dispatcher (port of enhance_cb_whisper_tpu/cli/main.py).

``run_cli(argv)`` implements ``{fit,test,validate} --config cfg.yaml
[--set NAME=value ...] [--dotted.key value ...]`` and routes on
``model.class_path``:

* ``model.model.KWSModel``       → paper-1 KWS training (``run_CLI.py fit``)
  and eval (``kws.py test|validate``);
* ``efficient_kws.model.KWSModel`` → paper-2 L/LE/LEF training
  (``run_efficient_kws.py fit``, from hidden-state caches or, with
  ``load_embeddings: false``, from audio through the frozen
  ``kws_whisper_ckpt`` encoder) and eval (``test|validate``) from a
  checkpoint directory or a reference ``.ckpt``, with the reference CLI's
  argument links;
* ``model.cb_whisper.CBWhisper``  → CB-Whisper entity recall (``cb-whisper.py test``).

Models are built through the port's entry points on ``device`` (the card
by default; they turn TF32 off there).  ``fit`` applies the reference
CLI's argument links (``sampling``, ``resample_every_epoch``, ``kw_type``
and ``batch_size`` from the model block to the data block; under
adversarial training the batch size × ``accumulate_grad_batches``),
hands ``device_features`` to the train step, writes its checkpoints under
``trainer.default_root_dir``/checkpoints, and resumes from ``ckpt_path``
(both papers).  The CB-Whisper serving knobs reach the
constructors as in the JAX CLI: ``compute_dtype``, ``vocab_int8``,
``decoder_int8``, ``kv_cache_int8``, ``cross_kv_int8``, and ``encoder_int8``
(with a separate ``encoder_ckpt``).  ``eval_batch_size`` and
``eval_packed`` pick batched or packed decode.  ``kv_staging`` W, a TPU
cache-write layout, does nothing with float caches; with ``kv_cache_int8``
the last W decode tokens are attended at full precision until a flush
quantizes them, as in the JAX package.  ``kws_int8`` (paper 1, paper 2
and CB-Whisper) runs the fused s8 kernel K2 on every bottleneck 1×1 conv
whose shapes it takes, as the JAX CLI does with ``ECW_S8_PALLAS`` naming
every stage; the port reads no environment variable.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import yaml

from .config import apply_overrides, check_placeholders, filter_kwargs, get, load_config

PAPER1_MODELS = ("model.model.KWSModel", "enhance_cb_whisper_tpu.models.kws.KWSModel")
PAPER2_MODELS = (
    "efficient_kws.model.KWSModel",
    "enhance_cb_whisper_tpu.efficient_kws.model.EfficientKWSModel",
)
CBWHISPER_MODELS = (
    "model.cb_whisper.CBWhisper",
    "enhance_cb_whisper_tpu.models.cb_whisper.CBWhisper",
)

def _seed_everything(config):
    seed = config.get("seed_everything", 123)
    np.random.seed(seed if seed is not True else 123)
    return seed if seed is not True else 123


def _early_stopping(config):
    from ..runtime.checkpoint import EarlyStopping

    block = config.get("early_stopping")
    if not block:
        return None
    return EarlyStopping(
        monitor=block.get("monitor", "metrics/f1"),
        patience=block.get("patience", 10),
        mode=block.get("mode", "max"),
        min_delta=block.get("min_delta", 0.0) or 0.0,
    )


def _monitors(config) -> Dict[str, str]:
    monitors = {}
    for name in ("f1_checkpoint", "f1_generalization_checkpoint", "f1_l4_checkpoint"):
        block = config.get(name)
        if block and block.get("monitor"):
            monitors[name] = f"{block['monitor']}:{block.get('mode', 'max')}"
    return monitors or {"f1_checkpoint": "metrics/f1:max"}


def _logger_from_config(config, log_dir):
    """A MetricsLogger from the reference's MLFlowLogger block: local files
    always, a real MLflow client only with a tracking_uri and the package."""
    from ..runtime.logging import MetricsLogger

    largs = get(config, "trainer.logger.init_args", {}) or {}
    return MetricsLogger(
        log_dir,
        run_name=largs.get("run_name", "run"),
        experiment_name=largs.get("experiment_name", "default"),
        tags=largs.get("tags"),
        tracking_uri=largs.get("tracking_uri"),
        log_model=bool(largs.get("log_model", False)),
    )


def _load_kws_variables(ckpt_path: str, resnet_config):
    """A ``KWSModel`` state dict from either a JAX checkpoint directory or a
    reference Lightning ``.ckpt`` (state-dict conversion)."""
    if os.path.isdir(ckpt_path):
        from ..convert import from_flax_resnet_variables
        from ..runtime.checkpoint import load_checkpoint

        state, _ = load_checkpoint(ckpt_path)
        return from_flax_resnet_variables(
            {"params": state["params"]["kws"], "batch_stats": state["batch_stats"]["kws"]}
        )
    import torch

    from ..models.torch_compat import load_hf_resnet_classifier, migrate_legacy_state_dict

    # a Lightning checkpoint pickles its hyperparameters beside the weights
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    sd = migrate_legacy_state_dict(sd)
    return load_hf_resnet_classifier(sd, resnet_config, prefix="model.")


def _load_kws_model(ckpt_path: str, resnet_config, device):
    from ..models.kws import KWSModel

    state = _load_kws_variables(ckpt_path, resnet_config)
    return KWSModel(resnet_config).load_converted(state).to(device).eval()


# --------------------------------------------------------------------- paper 1


def _paper1_kws_resnet(model_args):
    """ResNet-50 config of the paper-1 classifier: 12 input channels unless
    the config says otherwise."""
    from ..models.resnet import ResNetConfig

    return ResNetConfig(num_channels=model_args.get("num_channels", 12), num_labels=2)


def _run_paper1(subcommand: str, config: Dict[str, Any], device):
    from ..data.datamodule import KWSDataMod
    from ..models.quant import s8_stages
    from ..runtime.kws_engine import KWSEngine
    from ..train.kws_train import KWSTrainConfig

    model_args = get(config, "model.init_args", {}) or {}
    data_args = dict(get(config, "data.init_args", {}) or {})
    # the reference CLI's argument links
    for key in ("sampling", "resample_every_epoch", "kw_type", "batch_size"):
        if key in model_args:
            data_args[key] = model_args[key]
    features_size = tuple(data_args.get("features_size") or (150, 750))
    train_config = KWSTrainConfig(**filter_kwargs(model_args, KWSTrainConfig))
    if subcommand == "fit":
        if not data_args.get("train_info"):
            raise ValueError("fit needs a training dataset: data.init_args.train_info is empty")
        if model_args.get("adversarial_training"):
            # one optimizer step per training step: the loader hands over
            # every accumulated minibatch at once
            data_args["batch_size"] = model_args.get("batch_size", 1) * model_args.get(
                "accumulate_grad_batches", 1)
        if data_args.get("device_features"):
            # the step computes the features at the collator's target size
            train_config = dataclasses.replace(train_config, device_features=features_size)

    datamodule = KWSDataMod(**filter_kwargs(data_args, KWSDataMod))
    resnet_config = _paper1_kws_resnet(model_args)
    if subcommand == "fit":
        log_dir = get(config, "trainer.default_root_dir") or "runs/kws"
        engine = KWSEngine(
            resnet_config, features_size=features_size, device=device, config=train_config,
            ckpt_dir=os.path.join(log_dir, "checkpoints"), logger=_logger_from_config(config, log_dir),
        )
        # configs/train.yaml quotes its trainer placeholders, so `--set
        # MAX_EPOCHS=2` fills them as strings
        limit = get(config, "trainer.limit_train_batches")
        return engine.fit(
            datamodule,
            max_epochs=int(get(config, "trainer.max_epochs") or 100),
            check_val_every_n_epoch=int(get(config, "trainer.check_val_every_n_epoch") or 1),
            early_stopping=_early_stopping(config),
            monitors=_monitors(config),
            limit_train_batches=None if limit is None else int(limit),
            resume_from=config.get("ckpt_path"),
        )
    engine = KWSEngine(resnet_config, features_size=features_size, device=device)
    ckpt_path = config.get("ckpt_path")
    assert ckpt_path, "test/validate requires ckpt_path"
    variables = _load_kws_model(ckpt_path, resnet_config, engine.device)
    if subcommand == "validate":
        datamodule.setup("validate")
        metrics = engine.validate(variables, datamodule)
        print(metrics)
        return metrics
    if model_args.get("kws_int8"):
        # int8 catalog scoring calibrated on the first
        # `kws_int8_calibration_batches` test utterances
        datamodule.setup("test")
        variables = engine.enable_int8_scoring(
            variables, datamodule.test_dataset,
            calibration_batches=int(model_args.get("kws_int8_calibration_batches", 4)),
            s8_1x1=s8_stages(resnet_config),
        )
    return engine.test(variables, datamodule)


# --------------------------------------------------------------------- paper 2


def _run_paper2(subcommand: str, config: Dict[str, Any], device):
    from ..efficient_kws.data import EfficientKWSDataMod
    from ..efficient_kws.engine import EfficientKWSEngine, EfficientTrainConfig
    from ..efficient_kws.model import EfficientKWSConfig
    from ..models.quant import s8_stages

    model_args = dict(get(config, "model.init_args", {}) or {})
    if "threshold" in model_args:
        # the eval configs quote their [THRESHOLD] placeholder, so `--set
        # THRESHOLD=0.5` fills it as a string
        model_args["threshold"] = float(model_args["threshold"])
    data_args = dict(get(config, "data.init_args", {}) or {})
    # the reference CLI's argument links
    for key in (
        "n_layers", "sampling", "resample_every_epoch", "batch_size",
        "features_size", "pad_long_before_resize",
        "learn_features", "load_embeddings", "kws_whisper_ckpt",
    ):
        if key in model_args:
            data_args[key] = model_args[key]
    # a link falls back to the model's default when the config omits it
    data_args.setdefault("batch_size", 1)

    model_config = EfficientKWSConfig(**filter_kwargs(model_args, EfficientKWSConfig))
    train_config = EfficientTrainConfig(**filter_kwargs(model_args, EfficientTrainConfig))
    datamodule = EfficientKWSDataMod(**filter_kwargs(data_args, EfficientKWSDataMod))
    if subcommand == "fit":
        if not data_args.get("train_info"):
            raise ValueError("fit needs a training dataset: data.init_args.train_info is empty")
        whisper = None
        if not data_args.get("load_embeddings", True):
            # the audio mode: the frozen Whisper encoder runs inside the step
            from ..models.whisper_loader import load_whisper_from_pretrained

            whisper = load_whisper_from_pretrained(model_args["kws_whisper_ckpt"], device=device)
        log_dir = get(config, "trainer.default_root_dir") or "runs/efficient_kws"
        engine = EfficientKWSEngine(
            model_config, train_config, ckpt_dir=os.path.join(log_dir, "checkpoints"),
            logger=_logger_from_config(config, log_dir), whisper=whisper,
            kws_layer_slice=tuple(model_args.get("kws_layer_slice", (10, 22))),
            utt_frames_budget=tuple(model_args.get("features_size", (150, 1500)))[1],
            device=device,
        )
        limit = get(config, "trainer.limit_train_batches")
        return engine.fit(
            datamodule,
            max_epochs=int(get(config, "trainer.max_epochs") or train_config.max_epochs),
            early_stopping=_early_stopping(config),
            monitors=_monitors(config),
            limit_train_batches=None if limit is None else int(limit),
            resume_from=config.get("ckpt_path"),
        )
    # the eval logs nothing: no run directory (the JAX CLI opens one)
    engine = EfficientKWSEngine(model_config, train_config, device=device)

    ckpt_path = config.get("ckpt_path")
    assert ckpt_path, "test/validate requires ckpt_path"
    if os.path.isdir(ckpt_path):
        from ..runtime.checkpoint import load_checkpoint

        state, _ = load_checkpoint(ckpt_path)
        variables = engine.build_model({"params": state["params"],
                                        "batch_stats": state.get("batch_stats", {})})
    else:
        import torch

        from ..efficient_kws.torch_compat import load_torch_efficient_kws

        # a Lightning checkpoint pickles its hyperparameters beside the weights
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        variables = engine.build_model(load_torch_efficient_kws(ckpt.get("state_dict", ckpt), model_config))
    if model_args.get("kws_int8") and subcommand == "test":
        # int8 group scoring calibrated over the first
        # `kws_int8_calibration_batches` test items
        datamodule.setup("test")
        n_calib = int(model_args.get("kws_int8_calibration_batches", 4))
        ds = datamodule.test_dataset
        engine.enable_int8_scoring(variables, items=[ds[i] for i in range(min(n_calib, len(ds)))],
                                   s8_1x1=s8_stages(model_config.resnet_config()))
    # the JSON dumps land next to the checkpoint: a .ckpt file's directory
    dump_dir = ckpt_path if os.path.isdir(ckpt_path) else (os.path.dirname(ckpt_path) or ".")
    if subcommand == "validate":
        datamodule.setup("validate")
        metrics = engine.validate(variables, datamodule, dump_dir=dump_dir)
        print(metrics)
        return metrics
    return engine.test(variables, datamodule, dump_dir=dump_dir)


# ------------------------------------------------------------------ cb-whisper


def _cbwhisper_kws_resnet(model_args):
    """ResNet config for the KWS classifier: 12 channels (the [10:22] layer
    stack) unless the config overrides it."""
    from ..models.resnet import ResNetConfig

    return ResNetConfig(num_channels=model_args.get("kws_num_channels", 12), num_labels=2)


def _build_generation_options(tokenizer, hf_gc, model_args, whisper_config=None):
    from ..decoding.generate import GenerationOptions
    from .languages import TO_LANGUAGE_CODE

    # the reference configs use capitalized names (`language: English`); a
    # name that resolves to no language token would decode garbage
    language = model_args.get("language", "english")
    lang_ids: tuple = ()
    if language is None:
        # `language: null`: per-utterance detection from the first 30 s
        # window, over the generation config's languages
        lang_token = None
        lang_to_id = getattr(hf_gc, "lang_to_id", None)
        assert lang_to_id, (
            "language: null requires generation_config.lang_to_id for "
            "language detection (multilingual whisper checkpoints ship it)"
        )
        lang_ids = tuple(sorted(int(i) for i in lang_to_id.values()))
    else:
        language = str(language).lower()
        lang_code = TO_LANGUAGE_CODE.get(language, language)
        lang_token = tokenizer.convert_tokens_to_ids(f"<|{lang_code}|>")
        assert lang_token != tokenizer.convert_tokens_to_ids("<|__unk__|>"), (
            f"language {language!r} does not resolve to a whisper language token"
        )
    task_token = tokenizer.convert_tokens_to_ids("<|transcribe|>")
    return GenerationOptions(
        # decode length from the model's positional capacity, not a fixed 448
        max_target_positions=(
            whisper_config.max_target_positions if whisper_config is not None else 448
        ),
        decoder_start_token_id=hf_gc.decoder_start_token_id,
        language_token_id=lang_token,
        lang_token_ids=lang_ids,
        # the reference always transcribes, so the task token stays even
        # under language detection
        task_token_id=task_token,
        no_timestamps_token_id=hf_gc.no_timestamps_token_id,
        prev_sot_token_id=getattr(hf_gc, "prev_sot_token_id", None)
        or tokenizer.convert_tokens_to_ids("<|startofprev|>"),
        eos_token_id=hf_gc.eos_token_id,
        pad_token_id=hf_gc.pad_token_id,
        suppress_tokens=tuple(hf_gc.suppress_tokens or ()),
        begin_suppress_tokens=tuple(hf_gc.begin_suppress_tokens or ()),
        max_initial_timestamp_index=(
            hf_gc.max_initial_timestamp_index
            if getattr(hf_gc, "max_initial_timestamp_index", None) is not None
            else 50  # 0 is a valid setting: `or 50` would override it
        ),
        num_beams=int(model_args.get("num_beams", 5)),
        condition_on_prev_tokens=False,  # set per call by forward
    )


def _compute_dtype(model_args):
    import torch

    name = str(model_args.get("compute_dtype", "float32"))
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"compute_dtype: {name} is not a torch dtype")
    return dtype


def _run_cbwhisper(subcommand: str, config: Dict[str, Any], predictions_out=None, device="cuda"):
    assert subcommand == "test", "CBWhisper supports the test subcommand (cb-whisper.py)"
    import transformers

    from ..audio.io import load_audio_16k, prepare_features
    from ..data.datasets import ACL6060KeywordDataset, AishellHotwordDataset
    from ..models.cb_whisper import CBWhisper, CBWhisperConfig
    from ..models.quant import s8_stages
    from ..models.whisper_loader import load_whisper_from_pretrained

    model_args = get(config, "model.init_args", {}) or {}
    cb_config = CBWhisperConfig(**filter_kwargs(model_args, CBWhisperConfig))

    whisper_ckpt = model_args["whisper_ckpt"]
    encoder_ckpt = model_args.get("encoder_ckpt", whisper_ckpt)
    whisper_config, whisper_params = load_whisper_from_pretrained(whisper_ckpt, device=device)
    if encoder_ckpt != whisper_ckpt:
        encoder_config, encoder_params = load_whisper_from_pretrained(encoder_ckpt, device=device)
    else:
        encoder_config, encoder_params = whisper_config, None

    tokenizer = transformers.WhisperTokenizer.from_pretrained(whisper_ckpt)
    hf_gc = transformers.GenerationConfig.from_pretrained(whisper_ckpt)
    opts = _build_generation_options(tokenizer, hf_gc, model_args, whisper_config)
    opts = dataclasses.replace(opts, condition_on_prev_tokens=True, return_timestamps=True)

    resnet_config = _cbwhisper_kws_resnet(model_args)
    kws_model = _load_kws_model(model_args["kws_ckpt"], resnet_config, device)

    ds_name = model_args["dataset"]
    if ds_name == "aishell":
        dataset = AishellHotwordDataset(
            root=os.path.join(model_args["root"], "hotword"),
            split=model_args.get("split", "test"),
            hotwords_per_group=cb_config.keywords_per_group,
            kw_type=model_args["kw_type"],
            load_audio=True,
            wav_folder=os.path.join(model_args["root"], "wav"),
        )
    else:
        dataset = ACL6060KeywordDataset(
            root=model_args["root"],
            split=model_args.get("split", "test"),
            keywords_per_group=cb_config.keywords_per_group,
            kw_type=model_args["kw_type"],
            load_audio=True,
        )

    # the tokenizer takes plain lists of Python ints (never arrays or tensors)
    def prompt_ids_fn(text):
        return [int(t) for t in tokenizer.get_prompt_ids(text)]

    def decode_fn(tokens):
        return tokenizer.decode([int(t) for t in tokens], skip_special_tokens=True)

    module = CBWhisper(
        config=cb_config,
        whisper_config=whisper_config,
        whisper_params=whisper_params,
        kws_model=kws_model,
        catalog=dataset.catalog,
        generation_options=opts,
        prompt_ids_fn=prompt_ids_fn,
        decode_fn=decode_fn,
        encoder_params=encoder_params,
        encoder_config=encoder_config,
        kws_layer_slice=tuple(model_args.get("kws_layer_slice", (10, 22))),
        device=device,
        # the serving levers (fp32 stays the parity default)
        dtype=_compute_dtype(model_args),
        vocab_int8=bool(model_args.get("vocab_int8", False)),
        decoder_int8=bool(model_args.get("decoder_int8", False)),
        kv_cache_int8=bool(model_args.get("kv_cache_int8", False)),
        cross_kv_int8=bool(model_args.get("cross_kv_int8", False)),
        kv_staging=int(model_args.get("kv_staging", 0)),
    )
    if model_args.get("kws_int8"):
        # int8 spotting, calibrated lazily over the first scored segments
        module.enable_int8_spotting(
            calibration_batches=int(model_args.get("kws_int8_calibration_batches", 4)),
            s8_1x1=s8_stages(resnet_config),
        )
    if model_args.get("encoder_int8"):
        # the s8 KWS encoder (a separate encoder_ckpt only: it feeds the
        # scorer, never the decoder's cross-attention)
        module.enable_int8_kws_encoder(
            calibration_batches=int(model_args.get("kws_int8_calibration_batches", 4)),
        )

    def mel_fn(item):
        wav = load_audio_16k(item["audio"])
        return prepare_features(wav, n_mels=whisper_config.num_mel_bins, device=device)

    return module.run_test(
        dataset, mel_fn,
        num_bootstraps=model_args.get("num_bootstraps", 1000),
        # > 1 decodes several utterances per seek loop (oracle='kws')
        batch_size=model_args.get("eval_batch_size", 1),
        # continuous batching: a finished utterance hands its slot to the
        # next one (CBWhisper.forward_packed, slots=eval_batch_size)
        packed=bool(model_args.get("eval_packed", False)),
        predictions_out=predictions_out,
    )


# --------------------------------------------------------------------- driver


def run_cli(argv: Optional[List[str]] = None, device="cuda", predictions_out: Optional[list] = None):
    """Parse ``argv`` (``sys.argv[1:]`` by default) and run it on ``device``,
    the card unless the caller asks for the CPU.  ``predictions_out``
    collects CB-Whisper's transcripts."""
    argv = list(sys.argv[1:] if argv is None else argv)
    assert argv and argv[0] in ("fit", "test", "validate"), (
        f"usage: <entry> {{fit,test,validate}} --config CONFIG "
        f"[--set NAME=value ...] [--dotted.key value ...]"
    )
    subcommand = argv[0]
    assert len(argv) >= 3 and argv[1] == "--config", "--config CONFIG is required"
    # `--set NAME=value` fills the reference's [NAME] placeholder markers
    # textually before the YAML parse (some reference configs only become
    # valid YAML once filled)
    rest = argv[3:]
    placeholders: Dict[str, Any] = {}
    overrides: List[str] = []
    i = 0
    while i < len(rest):
        if rest[i] == "--set":
            assert i + 1 < len(rest), "--set requires NAME=value"
            name, _, value = rest[i + 1].partition("=")
            placeholders[name] = yaml.safe_load(value) if value else value
            i += 2
        else:
            overrides.append(rest[i])
            i += 1
    config = load_config(argv[2], placeholders=placeholders or None)
    config = apply_overrides(config, overrides)

    leftover = check_placeholders(config)
    if leftover:
        raise SystemExit(
            "config contains unfilled [PLACEHOLDER] values:\n  " + "\n  ".join(leftover)
        )

    _seed_everything(config)
    class_path = get(config, "model.class_path", "")
    if class_path in PAPER1_MODELS:
        return _run_paper1(subcommand, config, device)
    if class_path in PAPER2_MODELS:
        return _run_paper2(subcommand, config, device)
    if class_path in CBWHISPER_MODELS:
        return _run_cbwhisper(subcommand, config, predictions_out=predictions_out, device=device)
    raise SystemExit(f"unknown model.class_path: {class_path}")
