"""Whisper generation, shortform path (port of
enhance_cb_whisper_tpu/decoding/generate.py).

One utterance of at most 30 s: pad the mel to the 3000-frame segment,
encode it (or take the encoding from the keyword-spotting hook, which runs
the ONE encoder forward that feeds both spotting and cross-attention),
precompute the cross-attention K/V, prefill ``[<|startofprev|>, keywords,
*init_tokens]`` into a fresh KV cache and run beam or greedy search to
``max_target_positions``.

Not in this slice: the longform seek loop, the temperature-fallback
ladder, batched and packed decode.  ``generate`` raises for inputs that
need them.  Prompt-length bucketing existed only to bound JAX compiles and
is dropped: the prompt is prefilled at its true length.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.whisper import (
    WhisperConfig,
    decoder_forward,
    encoder_forward,
    init_cache,
    precompute_cross_kv,
)
from .beam import beam_search, greedy_search
from .logits_process import LogitsProcessorConfig
from .prompt import strip_prompt

INPUT_STRIDE = 2


@dataclasses.dataclass(frozen=True)
class GenerationOptions:
    """Token ids + decoding knobs (a copy of the JAX package's options)."""

    decoder_start_token_id: int = 50258  # <|startoftranscript|>
    language_token_id: Optional[int] = None  # e.g. <|en|>
    # with language_token_id None and this non-empty, the language is
    # detected per utterance from the first 30 s window (HF detect_language)
    lang_token_ids: Tuple[int, ...] = ()
    task_token_id: Optional[int] = None  # <|transcribe|>
    no_timestamps_token_id: int = 50363
    prev_sot_token_id: Optional[int] = 50361  # <|startofprev|>
    eos_token_id: int = 50257
    pad_token_id: int = 50257
    suppress_tokens: Tuple[int, ...] = ()
    begin_suppress_tokens: Tuple[int, ...] = ()
    max_initial_timestamp_index: int = 50
    num_beams: int = 1
    length_penalty: float = 1.0
    return_timestamps: bool = False
    condition_on_prev_tokens: bool = False
    temperature: Tuple[float, ...] = (0.0,)
    compression_ratio_threshold: Optional[float] = None
    logprob_threshold: Optional[float] = None
    no_speech_threshold: Optional[float] = None
    no_speech_token_id: int = 50362  # <|nospeech|>
    max_target_positions: int = 448

    def init_tokens(self, detected_lang_id: Optional[int] = None) -> List[int]:
        """[sot, lang?, task?, no_ts?]."""
        toks = [self.decoder_start_token_id]
        lang = self.language_token_id if self.language_token_id is not None else detected_lang_id
        if lang is not None:
            toks.append(lang)
        if self.task_token_id is not None:
            toks.append(self.task_token_id)
        if not self.return_timestamps:
            toks.append(self.no_timestamps_token_id)
        return toks

    @property
    def needs_lang_detection(self) -> bool:
        return self.language_token_id is None and len(self.lang_token_ids) > 0


class WhisperGenerator:
    """Shortform Whisper generation around a fixed (config, params).

    ``params`` is the torch parameter dict of :mod:`..models.whisper`
    (:func:`..convert.from_jax_whisper_params`), already on ``device``."""

    def __init__(self, config: WhisperConfig, params: Dict[str, Any], device="cuda"):
        self.config = config
        self.params = params
        self.device = torch.device(device)
        self.n_segment_frames = INPUT_STRIDE * config.max_source_positions

    # ------------------------------------------------------------------ steps

    def _encode(self, mel: torch.Tensor) -> torch.Tensor:
        return encoder_forward(self.params, mel, self.config)[0]

    def _cross_kv_fn(self, enc: torch.Tensor):
        return precompute_cross_kv(self.params, enc, self.config)

    def _decode_step(self, tokens: torch.Tensor, cache: dict, ctx: dict):
        logits, cache = decoder_forward(
            ctx["params"], tokens, ctx["cross_kv"], self.config,
            cache=cache, attention_mask=ctx["attn_mask"],
        )
        return logits[:, -1], cache

    def _prefill(self, prompt: torch.Tensor, ctx: dict, max_length: int):
        """Run the prompt through a fresh cache, positioned at
        ``prompt_len - 1``: the decode loop's first step re-feeds the final
        prompt token (rewriting its own slot with identical K/V).  Returns
        (cache, logits at the final prompt position)."""
        cache = init_cache(self.config, prompt.shape[0], max_length, self.device)
        logits, cache = decoder_forward(
            ctx["params"], prompt, ctx["cross_kv"], self.config,
            cache=cache, attention_mask=ctx["attn_mask"],
        )
        cache["index"] = prompt.shape[1] - 1
        return cache, logits[:, -1]

    def _make_ctx(self, cross_kv, prompt_mask: np.ndarray, max_length: int, reps: int) -> dict:
        """Cross K/V (NOT tiled across beams: the decoder folds beams into
        its cross-attention query axis) + the self-attention mask over the
        full length, tiled to batch*beams; only pad positions inside the
        prompt are masked."""
        batch, plen = prompt_mask.shape
        attn = np.ones((batch, max_length), dtype=np.int64)
        attn[:, :plen] = prompt_mask
        attn_t = torch.from_numpy(np.repeat(attn, reps, axis=0)).to(self.device)
        return {"cross_kv": cross_kv, "attn_mask": attn_t, "params": self.params}

    def _processors(self, opts: GenerationOptions) -> LogitsProcessorConfig:
        return LogitsProcessorConfig(
            suppress_tokens=tuple(opts.suppress_tokens),
            begin_suppress_tokens=tuple(opts.begin_suppress_tokens),
            no_timestamps_token_id=opts.no_timestamps_token_id,
            max_initial_timestamp_index=opts.max_initial_timestamp_index,
            return_timestamps=opts.return_timestamps,
            eos_token_id=opts.eos_token_id,
            vocab_size=self.config.vocab_size,
        )

    def _detect_language_ids(self, cross_kv, batch: int, opts: GenerationOptions) -> np.ndarray:
        """HF ``detect_language``: one [sot] prefill, last-position logits
        restricted to the language tokens, argmax."""
        prompt = torch.full((batch, 1), opts.decoder_start_token_id, dtype=torch.long,
                            device=self.device)
        ctx = self._make_ctx(cross_kv, np.ones((batch, 1), np.int64), opts.max_target_positions, 1)
        _, first_logits = self._prefill(prompt, ctx, opts.max_target_positions)
        lang_ids = np.asarray(sorted(opts.lang_token_ids), dtype=np.int64)
        logits = first_logits[:, torch.from_numpy(lang_ids).to(self.device)]
        return lang_ids[torch.argmax(logits, dim=-1).cpu().numpy()]

    @torch.no_grad()
    def _decode_prompted(
        self,
        cross_kv,
        decoder_input_ids: np.ndarray,
        attention_mask: Optional[np.ndarray],
        opts: GenerationOptions,
        return_timestamps: bool,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Prefill the prompt, run beam/greedy to max_target_positions;
        returns (full sequences incl. prompt [B, max_len], scores [B])."""
        batch, plen = decoder_input_ids.shape
        max_length = opts.max_target_positions
        pmask = (
            np.asarray(attention_mask, dtype=np.int64)
            if attention_mask is not None
            else np.ones((batch, plen), dtype=np.int64)
        )
        processors = self._processors(dataclasses.replace(opts, return_timestamps=return_timestamps))
        K = opts.num_beams
        reps = K if K > 1 else 1
        ctx = self._make_ctx(cross_kv, pmask, max_length, reps)
        prompt = torch.from_numpy(np.asarray(decoder_input_ids, dtype=np.int64)).to(self.device)
        cache, _ = self._prefill(prompt.repeat_interleave(reps, dim=0), ctx, max_length)
        if K == 1:
            seqs, scores = greedy_search(
                self._decode_step, prompt, plen, cache, ctx, processors,
                max_length=max_length, pad_token_id=opts.pad_token_id,
                eos_token_id=opts.eos_token_id,
            )
        else:
            seqs, scores = beam_search(
                self._decode_step, prompt, plen, cache, ctx, processors,
                num_beams=K, max_length=max_length, length_penalty=opts.length_penalty,
                pad_token_id=opts.pad_token_id, eos_token_id=opts.eos_token_id,
            )
        return seqs.cpu().numpy(), scores.cpu().numpy()

    # ------------------------------------------------------------- shortform

    @torch.no_grad()
    def generate(
        self,
        input_features: torch.Tensor,  # [1, n_mels, T <= 3000]
        opts: GenerationOptions,
        attention_mask: Optional[np.ndarray] = None,
        keyword_spotting: Optional[Callable] = None,
        encode_spot: Optional[Callable] = None,
    ) -> np.ndarray:
        """Shortform generate (one utterance of at most 30 s); returns the
        generated tokens [1, max_len - prompt_len] with the keyword prompt
        stripped.  ``attention_mask`` is accepted for API parity; a single
        shortform window decodes the whole padded segment, as in the
        reference."""
        total_frames = input_features.shape[-1]
        if total_frames > self.n_segment_frames or input_features.shape[0] != 1:
            raise NotImplementedError(
                "longform and batched generation are not ported yet: "
                "this slice decodes one utterance of at most 30 s"
            )
        return self._generate_shortform(input_features, opts, keyword_spotting, encode_spot)

    def _generate_shortform(self, input_features, opts, keyword_spotting, encode_spot=None):
        padded_seg = self._pad_segment(input_features)
        enc = None
        if encode_spot is not None:
            tokens_per_seg, enc = encode_spot(padded_seg, start_of_prev=True)
            prompt_ids = list(tokens_per_seg[0])
        elif keyword_spotting is not None:
            prompt_ids = list(keyword_spotting(input_features=padded_seg, start_of_prev=True)[0])
        else:
            prompt_ids = []

        if enc is None:
            enc = self._encode(padded_seg)
        cross_kv = self._cross_kv_fn(enc)
        detected = None
        if opts.needs_lang_detection:
            detected = int(self._detect_language_ids(cross_kv, 1, opts)[0])
        decoder_ids = np.asarray([prompt_ids + opts.init_tokens(detected)], dtype=np.int64)
        seqs, _ = self._decode_prompted(
            cross_kv, decoder_ids, None, opts, return_timestamps=opts.return_timestamps,
        )
        return strip_prompt(seqs, len(prompt_ids))

    def _pad_segment(self, seg: torch.Tensor) -> torch.Tensor:
        seg = torch.as_tensor(seg, dtype=torch.float32, device=self.device)
        pad = self.n_segment_frames - seg.shape[-1]
        return F.pad(seg, (0, pad)) if pad else seg
