"""CB-Whisper: contextual-biasing ASR with on-the-fly keyword spotting
(port of enhance_cb_whisper_tpu/models/cb_whisper.py: batch 1, batched and
packed, shortform and longform).

Per 30 s segment: ONE encoder forward yields both the L2-normalized layer
stack (keyword spotting) and the encoding that feeds cross-attention (when
the KWS encoder is the ASR encoder); the whole catalog is scored against the
stack; class-1 argmax keywords become the decoder prompt; beam search
decodes; an utterance longer than 30 s takes the generator's seek loop,
one window at a time; entity recall and bootstrap CIs are computed at the
end.  :meth:`CBWhisper.forward_batch` decodes several utterances in one
seek loop and :meth:`CBWhisper.forward_packed` streams them through the
continuous-batching scheduler (``run_test(batch_size, packed)``; the
serving front door is :mod:`..runtime.serving`).
:meth:`CBWhisper.enable_int8_spotting` swaps the fp32 ResNet scorer for
the int8 one after a lazy calibration on the first real segments (a packed
launch's vacant slots never enter it), and
:meth:`CBWhisper.enable_int8_kws_encoder` does the same for a separate KWS
encoder (the s8 encoder of :mod:`.whisper`).  The generator's serving
levers (compute dtype, int8 weights and K/V) pass through the constructor;
in bf16 the KWS stacks come from the bf16 encoder, as in JAX.

Deviation from the JAX package: spotting has NO broad ``except Exception``
(JAX cb_whisper.py:333-336, :350-352).  A failing encoder, scorer or kernel
raises instead of silently yielding an empty prompt, so a broken run cannot
pass.  Tokenization is injected (``prompt_ids_fn`` / ``decode_fn``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..audio.prefetch import prefetch
from ..catalog.database import (
    KeywordCatalog,
    calibration_sim_maps_multi,
    device_put_catalog,
    make_catalog_score_fn,
)
from ..decoding.generate import GenerationOptions, WhisperGenerator
from ..metrics import entity_recall, evaluate_with_conf_int
from ..ops.resize import resize_matrix
from ..runtime.precision import reference_precision
from ..runtime.profiler import RTFxMeter
from .kws import KWSModel
from .quant import calibrate_act_scales, make_quantized_kws_apply, quantize_resnet_classifier
from .whisper import (
    WhisperConfig,
    calibrate_encoder_act_scales,
    encoder_kws_stack,
    quantize_encoder_layers,
    to_compute_dtype,
)


@dataclasses.dataclass
class CBWhisperConfig:
    """Mirror of the reference hyperparameters."""

    prompt: bool = True
    oracle: str = "kws"  # kws | gold | random
    kws_features_size: Tuple[int, int] = (150, 750)
    keyword_prompt_prepend: str = "("
    keyword_prompt_append: str = ")"
    keyword_separator: str = " "
    keywords_per_group: int = 100


class CBWhisper:
    def __init__(
        self,
        config: CBWhisperConfig,
        whisper_config: WhisperConfig,
        whisper_params: Dict[str, Any],
        kws_model: KWSModel,
        catalog: KeywordCatalog,
        generation_options: GenerationOptions,
        prompt_ids_fn: Callable[[str], List[int]],
        decode_fn: Callable[[Sequence[int]], str],
        encoder_params: Optional[Dict[str, Any]] = None,
        encoder_config: Optional[WhisperConfig] = None,
        kws_layer_slice: Tuple[int, int] = (10, 22),
        device="cuda",
        dtype: torch.dtype = torch.float32,
        vocab_int8: bool = False,
        decoder_int8: bool = False,
        kv_cache_int8: bool = False,
        cross_kv_int8: bool = False,
        kv_staging: int = 0,
    ):
        """``whisper_params``/``encoder_params`` are torch parameter dicts on
        ``device`` (:func:`..convert.from_jax_whisper_params`); ``kws_model``
        is moved to ``device`` and put in eval mode.  The card is the
        default: a CPU run passes ``device="cpu"``.  ``dtype``, the int8
        flags and ``kv_staging`` are
        :class:`..decoding.generate.WhisperGenerator`'s serving levers;
        ``dtype`` is the KWS encoder's compute dtype too."""
        self.config = config
        self.whisper_config = whisper_config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            reference_precision()
        self.kws_model = kws_model.to(self.device).eval()
        self.catalog = catalog
        self.opts = generation_options
        self.prompt_ids_fn = prompt_ids_fn
        self.decode_fn = decode_fn
        self.kws_layer_slice = kws_layer_slice
        self.oracle_buffer: List[str] = []

        self.generator = WhisperGenerator(
            whisper_config, whisper_params, device=self.device, dtype=dtype, vocab_int8=vocab_int8,
            decoder_int8=decoder_int8, kv_cache_int8=kv_cache_int8, cross_kv_int8=cross_kv_int8,
            kv_staging=kv_staging,
        )
        self._compute_dtype = dtype
        # a separate KWS encoder keeps its f32 weights for a later int8
        # quantization beside the copy in the compute dtype
        self._encoder_f32 = encoder_params
        self.encoder_params = (
            to_compute_dtype(encoder_params, dtype) if encoder_params is not None else self.generator.params
        )
        self.encoder_config = encoder_config or whisper_config
        self._enc_int8_pending = False
        # single-encode fusion: when the KWS encoder IS the ASR encoder, one
        # forward per segment yields both the KWS stack and the encoding
        self.encode_fused = encoder_params is None and (
            encoder_config is None or encoder_config == whisper_config
        )
        self._score_fn = make_catalog_score_fn(
            lambda images: self.kws_model(images).logits, out_size=config.kws_features_size
        )
        self._int8_pending = False
        self._catalog_dev = None
        self._utt_w = torch.from_numpy(
            resize_matrix(self.encoder_config.max_source_positions,
                          config.kws_features_size[1], antialias=False)
        ).to(self.device)

    # -------------------------------------------------------- keyword spotting

    def _ensure_catalog(self):
        if self._catalog_dev is None:
            self._catalog_dev = device_put_catalog(
                self.catalog, out_h=self.config.kws_features_size[0], chunk=8, device=self.device
            )

    def enable_int8_spotting(self, calibration_batches: int = 4, s8_1x1=()):
        """Switch per-segment keyword spotting to the int8 quantized ResNet
        (:mod:`.quant`).  Calibration is lazy: the stacks of the first
        ``calibration_batches`` scored segments are kept, and the segments
        scored before that set is full go through the fp32 scorer; the
        segment that fills it sets the static activation scales (maxes over
        all of them) and is the first the int8 scorer scores.  ``s8_1x1``
        names the stages whose bottleneck 1×1 convs run the fused s8 kernel
        (the JAX package reads that set from ``ECW_S8_PALLAS``)."""
        self._int8_pending = True
        self._int8_calibration_batches = max(1, int(calibration_batches))
        self._int8_calib_stacks: List[np.ndarray] = []
        self._int8_s8_1x1 = tuple(s8_1x1)

    def enable_int8_kws_encoder(self, calibration_batches: int = 4) -> None:
        """Switch the separate KWS encoder to the s8 encoder
        (:func:`.whisper.quantize_encoder_layers`).  Calibration is lazy:
        the mels of the first ``calibration_batches`` real segments that
        :meth:`spot_keywords` sees are kept, and the segment that fills the
        set is the first the s8 encoder encodes.  The s8 encoder feeds the
        catalog scorer only, so with the KWS encoder being the ASR encoder
        (no separate ``encoder_params``) this raises: quantizing it would
        change the transcripts."""
        if self._encoder_f32 is None:
            raise ValueError(
                "encoder_int8 requires a separate KWS encoder (encoder_ckpt "
                "!= whisper_ckpt): quantizing the shared ASR encoder would "
                "change transcription"
            )
        self._enc_int8_pending = True
        self._enc_int8_batches = max(1, int(calibration_batches))
        self._enc_int8_mels: List[torch.Tensor] = []

    def _maybe_calibrate_encoder_int8(self, feats: torch.Tensor, real_rows=None) -> None:
        if not self._enc_int8_pending:
            return
        rows = self._calib_rows(feats.shape[0], self._enc_int8_batches - len(self._enc_int8_mels), real_rows)
        self._enc_int8_mels.extend(feats[i] for i in rows)
        if len(self._enc_int8_mels) < self._enc_int8_batches:
            return
        scales = calibrate_encoder_act_scales(
            self.encoder_params, torch.stack(self._enc_int8_mels), self.encoder_config, self._compute_dtype,
        )
        self.encoder_params = to_compute_dtype(
            quantize_encoder_layers(self._encoder_f32, scales), self._compute_dtype)
        self._enc_int8_pending = False
        self._enc_int8_mels = []
        self._encoder_f32 = None

    @staticmethod
    def _calib_rows(n_seg: int, needed: int, real_rows=None) -> List[int]:
        """Indices of the segments that feed a pending int8 calibration.
        ``real_rows`` (packed decode's real-row mask) leaves out the vacant
        zero-mel slots: an all-zero segment in the calibration set would
        skew the static activation scales that K2's epilogue then uses."""
        rows = [i for i in range(n_seg) if real_rows is None or real_rows[i]]
        return rows[:needed]

    def _calibrate_int8(self, utt_stacks) -> None:
        rcfg = self.kws_model.config
        qparams = quantize_resnet_classifier(self.kws_model, rcfg, device=self.device)
        maps = calibration_sim_maps_multi(self.catalog, utt_stacks, self.config.kws_features_size)
        scales = calibrate_act_scales(rcfg, qparams, maps)["act_scales"]
        q_apply = make_quantized_kws_apply(rcfg, act_scales=scales, s8_1x1=self._int8_s8_1x1)
        self.kws_qparams = qparams
        # from the host catalog, whole: a model-sharded device catalog
        # (parallel/sharding.py) gives every rank the same scales
        self.kws_act_scales = scales
        self._score_fn = make_catalog_score_fn(
            lambda images: q_apply(qparams, images), out_size=self.config.kws_features_size
        )
        self._int8_pending = False

    def _score_to_keywords(self, stacks: torch.Tensor, real_rows=None) -> List[List[str]]:
        """Catalog scoring + argmax-class-1 dedupe, per segment of ``stacks``
        [n_seg, L, T_enc, D]; ``real_rows`` marks the segments that may
        feed a pending int8 calibration."""
        if self._int8_pending:
            # keep real segment stacks; fp32 scores them until the
            # calibration set is full, then the quantized scorer takes over
            # (this segment included)
            needed = self._int8_calibration_batches - len(self._int8_calib_stacks)
            rows = self._calib_rows(stacks.shape[0], needed, real_rows)
            if rows:
                self._int8_calib_stacks.extend(stacks[rows].cpu().numpy())
            if len(self._int8_calib_stacks) >= self._int8_calibration_batches:
                self._calibrate_int8(self._int8_calib_stacks)
                self._int8_calib_stacks = []
        n = self.catalog.num_keywords
        mask = self.catalog.mask[:n].astype(bool)
        out = []
        for seg in range(stacks.shape[0]):
            _, logits = self._score_fn(self._catalog_dev, stacks[seg], self._utt_w)
            hits = (torch.argmax(logits[:n], dim=-1) == 1).cpu().numpy() & mask
            keywords = [self.catalog.keywords[i] for i in np.nonzero(hits)[0]]
            out.append(list(dict.fromkeys(keywords)))
        return out

    def _features(self, input_features) -> torch.Tensor:
        return torch.as_tensor(input_features, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def spot_keywords(self, input_features, real_rows=None) -> List[List[str]]:
        """Detected keyword strings per segment (argmax class 1, deduped).
        ``real_rows`` marks packed decode's vacant slots (False), which
        never feed a pending int8 calibration."""
        self._ensure_catalog()
        feats = self._features(input_features)
        self._maybe_calibrate_encoder_int8(feats, real_rows)
        stacks = encoder_kws_stack(
            self.encoder_params, feats, self.encoder_config,
            layer_slice=self.kws_layer_slice, dtype=self._compute_dtype,
        )
        return self._score_to_keywords(stacks, real_rows)

    @torch.no_grad()
    def encode_and_spot(self, input_features, start_of_prev: bool = False, real_rows=None):
        """The generator's fused hook: (prompt token ids per segment,
        cross-attention encoding [n_seg, T_enc, D]) from one encoder forward."""
        self._ensure_catalog()
        stacks, enc = encoder_kws_stack(
            self.generator.params, self._features(input_features), self.whisper_config,
            layer_slice=self.kws_layer_slice, return_encoding=True, dtype=self._compute_dtype,
        )
        keywords = self._score_to_keywords(stacks, real_rows)
        return self._format_prompt_tokens(keywords, start_of_prev), enc

    def keyword_spotting(self, input_features, start_of_prev: bool = False,
                         real_rows=None) -> List[List[int]]:
        """The generate() callback: prompt token ids per segment."""
        num_segments = input_features.shape[0]
        if not self.config.prompt:
            return [[] for _ in range(num_segments)]
        if self.config.oracle == "kws":
            keywords = self.spot_keywords(input_features, real_rows=real_rows)
        else:
            keywords = [list(self.oracle_buffer) for _ in range(num_segments)]
        return self._format_prompt_tokens(keywords, start_of_prev)

    def _format_prompt_tokens(self, keywords: List[List[str]], start_of_prev: bool) -> List[List[int]]:
        """Wrap detected keywords in the prompt template and tokenize."""
        cfg = self.config
        out = []
        for kwds in keywords:
            if kwds:
                text = (
                    cfg.keyword_prompt_prepend
                    + cfg.keyword_separator.join(kwds)
                    + cfg.keyword_prompt_append
                )
                ids = list(self.prompt_ids_fn(text))
                if not start_of_prev:
                    ids = ids[1:]  # strip <|startofprev|>
                out.append(ids)
            else:
                out.append([])
        return out

    def _encode_spot_hook(self):
        use = self.encode_fused and self.config.prompt and self.config.oracle == "kws"
        return self.encode_and_spot if use else None

    # ----------------------------------------------------------------- forward

    def forward(self, input_features, attention_mask: Optional[np.ndarray] = None,
                oracle: Optional[List[str]] = None) -> str:
        """Transcribe one utterance with contextual biasing (the seek loop
        when it is longer than 30 s; ``attention_mask`` [1, T] marks its
        true frames); returns the stripped transcript string."""
        self.oracle_buffer = oracle or []
        result = self.generator.generate(
            self._features(input_features),
            self.opts,
            attention_mask=attention_mask,
            keyword_spotting=self.keyword_spotting,
            return_segments=True,
            encode_spot=self._encode_spot_hook(),
        )
        tokens = result["sequences"][0] if isinstance(result, dict) else result[0]
        return self.decode_fn(tokens).strip()

    def forward_batch(self, features_list: List[Any],
                      masks_list: List[Optional[np.ndarray]]) -> List[str]:
        """Transcribe SEVERAL utterances in one seek loop: their mels
        ([1, n_mels, T_i] each) are right-padded to the longest with
        attention masks and decoded as one batch, finished rows dropping
        out.  oracle='kws' only: the gold and random oracles are
        per-utterance state."""
        assert self.config.oracle == "kws", (
            "batched eval supports oracle='kws' only (per-segment spotting); "
            "gold/random oracles are per-utterance state"
        )
        self.oracle_buffer = []
        feats = [self._features(f) for f in features_list]
        t_max = max(f.shape[-1] for f in feats)
        batch = len(feats)
        mels = torch.zeros((batch, feats[0].shape[1], t_max), dtype=torch.float32, device=self.device)
        attn = np.zeros((batch, t_max), np.int32)
        for i, (f, m) in enumerate(zip(feats, masks_list)):
            t = f.shape[-1]
            mels[i, :, :t] = f[0]
            if m is not None:
                attn[i, : m.shape[-1]] = np.asarray(m).reshape(-1)[:t_max]
            else:
                attn[i, :t] = 1
        result = self.generator.generate(
            mels, self.opts, attention_mask=attn, keyword_spotting=self.keyword_spotting,
            return_segments=True, encode_spot=self._encode_spot_hook(),
        )
        sequences = result["sequences"] if isinstance(result, dict) else result
        return [self.decode_fn(sequences[i]).strip() for i in range(batch)]

    def forward_packed(self, stream, slots: int = 4):
        """Continuous-batching transcription over a STREAM of utterances
        (:meth:`..decoding.generate.WhisperGenerator.generate_packed`):
        ``slots`` utterances decode as one batch and a finished slot is
        refilled from the stream.  ``stream`` yields ``(features [1, n_mels,
        T], attention_mask or None)``; yields ``(order, transcript)`` as
        utterances complete (not in stream order).  oracle='kws' only, like
        :meth:`forward_batch`; each utterance gets the transcript of its own
        ``slots=1`` decode."""
        assert self.config.oracle == "kws", (
            "packed eval supports oracle='kws' only (per-segment spotting); "
            "gold/random oracles are per-utterance state"
        )
        self.oracle_buffer = []
        for order, result in self.generator.generate_packed(
            stream, self.opts, slots=slots, keyword_spotting=self.keyword_spotting,
            encode_spot=self._encode_spot_hook(), return_segments=True,
        ):
            yield order, self.decode_fn(result["sequences"]).strip()

    # -------------------------------------------------------------------- test

    @staticmethod
    def _true_frames(features, attention_mask) -> int:
        return int(np.asarray(attention_mask).sum()) if attention_mask is not None else features.shape[-1]

    def run_test(
        self,
        dataset,
        mel_fn: Callable[[dict], Tuple[Any, Optional[np.ndarray]]],
        num_bootstraps: int = 1000,
        rng: Optional[np.random.Generator] = None,
        batch_size: int = 1,
        packed: bool = False,
        predictions_out: Optional[list] = None,
    ) -> Dict[str, float]:
        """Entity recall over an eval dataset.  ``mel_fn(item) ->
        (features, attention_mask)`` supplies the log-mel input (e.g.
        :func:`..audio.io.prepare_features` on the item's audio); it runs in
        a prefetch thread, one or two items ahead of the decode.

        ``batch_size > 1`` (oracle='kws' only) decodes groups of utterances
        in one seek loop (:meth:`forward_batch`); ``packed=True`` streams
        the dataset through the continuous-batching scheduler
        (:meth:`forward_packed`, ``slots=batch_size``), at any batch size.
        ``predictions_out`` gets the transcripts in dataset order."""
        rng = rng or np.random.default_rng(0)
        meter = RTFxMeter()
        preds, refs, mentions, speakers = [], [], [], []

        def decoded_items():
            # the mel of the next items is made while the decode runs
            for idx in range(len(dataset)):
                item = dataset[idx]
                yield item, mel_fn(item)

        if packed:
            audio_seconds = [0.0]

            def stream():
                for item, (features, attention_mask) in prefetch(decoded_items(), depth=2):
                    self._collect_refs(item, refs, mentions, speakers)
                    audio_seconds[0] += self._true_frames(features, attention_mask) / 100.0
                    yield features, attention_mask

            meter.start()
            by_order = dict(self.forward_packed(stream(), slots=batch_size))
            meter.stop(audio_seconds=audio_seconds[0])
            preds.extend(by_order[i] for i in range(len(by_order)))
        elif batch_size > 1:
            pending_feats, pending_masks = [], []

            def flush():
                if not pending_feats:
                    return
                meter.start()
                outs = self.forward_batch(pending_feats, pending_masks)
                frames = sum(self._true_frames(f, m) for f, m in zip(pending_feats, pending_masks))
                meter.stop(audio_seconds=frames / 100.0)
                preds.extend(outs)
                pending_feats.clear()
                pending_masks.clear()

            for item, (features, attention_mask) in prefetch(decoded_items(), depth=2):
                pending_feats.append(features)
                pending_masks.append(attention_mask)
                self._collect_refs(item, refs, mentions, speakers)
                if len(pending_feats) == batch_size:
                    flush()
            flush()
        else:
            for item, (features, attention_mask) in prefetch(decoded_items(), depth=2):
                meter.start()
                labels = np.asarray(item["hotword_labels"])
                if self.config.oracle == "gold":
                    oracle = [self.catalog.keywords[i] for i in np.nonzero(labels)[0]]
                elif self.config.oracle == "random":
                    negatives = [i for i in range(len(self.catalog.keywords)) if not labels[i]]
                    pick = rng.choice(negatives, size=int(labels.sum()), replace=False)
                    oracle = [self.catalog.keywords[i] for i in pick]
                else:
                    oracle = []
                preds.append(self.forward(features, attention_mask, oracle))
                # 100 mel frames per second of audio (hop 160 @ 16 kHz)
                meter.stop(audio_seconds=self._true_frames(features, attention_mask) / 100.0)
                self._collect_refs(item, refs, mentions, speakers)
        if predictions_out is not None:
            predictions_out.extend(preds)
        return self._finalize_test(preds, refs, mentions, speakers, num_bootstraps, meter)

    def _collect_refs(self, item, refs, mentions, speakers):
        refs.append(item["transcript"])
        if item.get("keywords") is not None:
            mentions.append([{**kw, "ner_tag": "UNK"} for kw in item["keywords"]])
        else:
            mentions.append(
                [
                    {
                        "mention": kw,
                        "total_offset": m.start(),
                        "end_offset": m.end(),
                        "ner_tag": "UNK",
                    }
                    for kw in self.catalog.keywords
                    for m in re.finditer(re.escape(kw), item["transcript"])
                ]
            )
        speakers.append(item.get("speaker"))

    def _finalize_test(self, preds, refs, mentions, speakers, num_bootstraps, meter):
        def f_recall(labels, samples, samples2=None):
            refs_, mentions_ = zip(*labels)
            return entity_recall(
                preds=list(samples), refs=list(refs_), mentions=list(mentions_),
                ner_tags="ALL", char_split=True,
            )["ALL"]

        conditions = None
        if speakers[0] is not None:
            speaker2id = {s: i for i, s in enumerate(set(speakers))}
            conditions = [speaker2id[s] for s in speakers]
        center, (lb, ub) = evaluate_with_conf_int(
            list(preds), f_recall, list(zip(refs, mentions)), conditions,
            num_bootstraps=num_bootstraps, alpha=5,
        )
        results = {"Entity Recall": center, "Entity Recall LB": lb, "Entity Recall UB": ub}
        print(f"throughput: {meter.summary()}")
        results["RTFx"] = meter.rtfx
        print(results)
        return results
