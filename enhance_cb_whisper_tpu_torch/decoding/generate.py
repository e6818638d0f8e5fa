"""Whisper generation (port of enhance_cb_whisper_tpu/decoding/generate.py):
shortform, and the longform seek loop with condition-on-prev prompts and
the temperature-fallback ladder.

Shortform (one utterance of at most 30 s): pad the mel to the 3000-frame
segment, encode it (or take the encoding from the keyword-spotting hook,
which runs the ONE encoder forward that feeds both spotting and
cross-attention), precompute the cross-attention K/V, prefill
``[<|startofprev|>, keywords, *init_tokens]`` into a fresh KV cache and run
beam or greedy search to ``max_target_positions``.

Longform (more than 3000 frames, or a batch above 1): every unfinished
row's next 30 s window is decoded together.  Per window: the spotting hook,
one encoder forward, the prompt ``[<|startofprev|>, keywords, previous
text, *init_tokens]``, then the fallback ladder, which re-decodes only the
rows whose output is repetitive or unsure at the next temperature.  The
output's timestamps cut it into segments and move each row's seek.

Sampled rungs draw Gumbel noise from a source ``(rung, segment_idx,
cur_len, shape) -> tensor``.  The default, :func:`cpu_gumbel_noise`, draws
on the CPU, so the CPU and the card sample the same tokens; the JAX
package's own draws can be injected in its place.

Packed (continuous-batching) decode, :meth:`WhisperGenerator.generate_packed`:
a fixed number of batch slots decode one window each per launch, and a
finished utterance's slot is refilled from a stream.  A vacant slot decodes
a zero mel with an empty prompt, is kept out of the ladder and out of int8
calibration (the ``real_rows`` hook argument), and its output is dropped.
Each row conditions on its own history and takes the fixed-width prompt
layout, so an utterance's tokens do not depend on what shares its launch.
:meth:`WhisperGenerator.swap_params` replaces the weights in place (the
serving layer's hot swap).  Each launch is recorded as an
``ecw.scheduler.window`` span (:mod:`..runtime.profiler`; id: the stream
orders of the occupied slots).

The serving levers (``dtype``, ``vocab_int8``, ``decoder_int8``,
``kv_cache_int8``, ``cross_kv_int8``; :mod:`..models.whisper`) reach every
path: shortform, longform and its ladder, packed decode and
``detect_language``.

A direct :meth:`WhisperGenerator._decode_prompted` call at ``num_beams >
1`` and a temperature above 0 is beam-sample (the ladder never asks for
it: its sampled rungs decode with ``num_beams=1``).  Prompt-length
bucketing existed only to bound JAX compiles and is dropped: the prompt is
prefilled at its true length, and a packed run's prompts all have one
width.
"""

from __future__ import annotations

import dataclasses
import inspect
import zlib
from functools import partial
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.whisper import (
    WhisperConfig,
    cross_kv_order,
    decoder_forward,
    decoder_heads,
    encoder_forward,
    init_cache,
    precompute_cross_kv,
    quantize_decoder_layers,
    quantize_vocab_projection,
    to_compute_dtype,
)
from ..runtime import profiler
from ..runtime.precision import reference_precision
from .beam import beam_search, greedy_search
from .logits_process import LogitsProcessorConfig
from .prompt import prepare_decoder_input_ids, segment_prev_tokens, strip_prompt

TIME_PRECISION = 0.02
INPUT_STRIDE = 2

# (rung, segment_idx, cur_len, shape) -> standard Gumbel draws of ``shape``
NoiseSource = Callable[[int, int, int, Tuple[int, ...]], torch.Tensor]


def cpu_gumbel_noise(rung: int, segment_idx: int, cur_len: int,
                     shape: Tuple[int, ...]) -> torch.Tensor:
    """Standard Gumbel draws on the CPU from a generator seeded by
    ``(rung, segment_idx, cur_len)``: the same numbers on every device and
    in every run, whichever step asks first."""
    seed = np.random.SeedSequence([rung, segment_idx, cur_len]).generate_state(1, np.uint64)[0]
    uniform = torch.rand(shape, generator=torch.Generator().manual_seed(int(seed)))
    return -torch.log(-torch.log(uniform.clamp_min(torch.finfo(torch.float32).tiny)))


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


def _nbytes(layers: List[Dict[str, torch.Tensor]]) -> int:
    """Bytes of a per-layer list of cache tensors, from their shapes."""
    return sum(t.numel() * t.element_size() for layer in layers for t in layer.values())


def _compression_ratio(tokens: Sequence[int], vocab_size: int) -> float:
    """zlib compression ratio over token bytes (high = repetitive).  The
    byte width comes from the vocab size, not from the sequence (HF
    ``_retrieve_compression_ratio``: ``int(log2(vocab_size) / 8) + 1``)."""
    if len(tokens) == 0:
        return 0.0
    length = int(np.log2(vocab_size) / 8) + 1
    raw = b"".join(int(t).to_bytes(length, "little") for t in tokens)
    return len(raw) / len(zlib.compress(raw))


@dataclasses.dataclass
class _LongformRow:
    """Host-side longform decode state for ONE utterance (one batch row)."""

    features: Any  # [1, n_mels, T] full-utterance mel
    max_frames: int
    order: int = 0  # batch row of the utterance
    seek: int = 0
    segments: List[dict] = dataclasses.field(default_factory=list)
    condition: bool = False
    # language token detected from this row's FIRST window (None = not yet
    # detected, or detection off)
    lang_token_id: Optional[int] = None

    @property
    def done(self) -> bool:
        return self.seek >= self.max_frames


class WhisperGenerator:
    """Whisper generation around a fixed (config, params).

    ``params`` is the torch parameter dict of :mod:`..models.whisper`
    (:func:`..convert.from_jax_whisper_params`), already on ``device``.

    The serving levers of the JAX package's generator: ``dtype`` (the
    compute dtype, e.g. ``torch.bfloat16``); ``vocab_int8`` and
    ``decoder_int8`` (weight-only int8 vocab projection and decode-loop
    linears, quantized here from the f32 weights); ``kv_cache_int8`` (int8
    self-attention cache) and ``cross_kv_int8`` (int8 cross-attention
    K/V, quantized once per segment).  ``kv_staging`` W > 0 with
    ``kv_cache_int8`` keeps the last W decode tokens in a compute-dtype
    window flushed into the int8 cache every W steps, as the JAX package's
    staged writes do (:func:`..models.whisper.init_cache`); with a float
    cache it changes nothing and is ignored.  ``self.params`` holds the
    weights as the forward uses them: quantized, then cast to ``dtype``."""

    def __init__(self, config: WhisperConfig, params: Dict[str, Any], device="cuda",
                 dtype: torch.dtype = torch.float32, vocab_int8: bool = False,
                 decoder_int8: bool = False, kv_cache_int8: bool = False,
                 cross_kv_int8: bool = False, kv_staging: int = 0):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            reference_precision()
        self.dtype = dtype
        self._vocab_int8 = bool(vocab_int8)
        self._decoder_int8 = bool(decoder_int8)
        self._kv_cache_int8 = bool(kv_cache_int8)
        self._cross_kv_int8 = bool(cross_kv_int8)
        # staged writes change only an int8 cache's results (the window's
        # tokens are attended unquantized until a flush); float caches
        # take none
        self._kv_staging = int(kv_staging) if self._kv_cache_int8 else 0
        self.params = self._serving_params(params)
        self.n_segment_frames = INPUT_STRIDE * config.max_source_positions

    # ------------------------------------------------------------------ util

    def _serving_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The weights as the forward uses them: int8 vocab and decoder
        codes from the f32 weights, then the rest cast to the compute dtype
        (the identity with no lever on)."""
        if self._vocab_int8:
            params = quantize_vocab_projection(params)
        if self._decoder_int8:
            params = quantize_decoder_layers(params)
        return to_compute_dtype(params, self.dtype)

    def swap_params(self, params: Dict[str, Any]) -> None:
        """Hot checkpoint swap for serving: replace the weights in place.

        ``params`` (f32, of the same architecture) is moved to the
        generator's device and given the constructor's serving treatment
        (int8 quantization, the compute dtype) before its keys, shapes and
        dtypes are checked against the current weights.  Any mismatch
        raises ``ValueError`` and leaves the weights as they were.

        Not synchronized with an in-flight decode: a swap from another
        thread mid-utterance would mix checkpoints across its windows.
        Quiesce first, or go through
        ``runtime.serving.TranscriptionService.swap_params``, which drains
        the work in flight before it swaps (an epoch barrier)."""
        def layout(tree):
            if isinstance(tree, dict):
                return {k: layout(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [layout(v) for v in tree]
            return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))

        def to_device(tree):
            if isinstance(tree, dict):
                return {k: to_device(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [to_device(v) for v in tree]
            return torch.as_tensor(tree).to(self.device)

        params = self._serving_params(to_device(params))
        if layout(params) != layout(self.params):
            raise ValueError(
                "swap_params: checkpoint architecture mismatch (keys, shapes or "
                "dtypes differ); build a new WhisperGenerator instead"
            )
        self.params = params

    @torch.no_grad()
    def detect_language(self, input_features, opts: GenerationOptions) -> np.ndarray:
        """HF ``model.detect_language``: the language token id of each batch
        row, detected from its first 30 s window."""
        seg = torch.as_tensor(input_features, dtype=torch.float32, device=self.device)
        seg = self._pad_segment(seg[:, :, : self.n_segment_frames])
        cross_kv = self._cross_kv_fn(self._encode(seg))
        return self._detect_language_ids(cross_kv, seg.shape[0], opts)

    # ------------------------------------------------------------------ steps

    def _encode(self, mel: torch.Tensor) -> torch.Tensor:
        return encoder_forward(self.params, mel, self.config, dtype=self.dtype)[0]

    def _cross_kv_fn(self, enc: torch.Tensor):
        return precompute_cross_kv(self.params, enc, self.config, int8=self._cross_kv_int8)

    def _decode_step(self, tokens: torch.Tensor, cache: dict, ctx: dict):
        """One decode step of every row.  Below f32 it runs one segment's
        rows (its beams) at a time, as the prefill always does: cuBLAS picks
        its GEMM kernel by the number of rows, and a bf16 output rounds the
        resulting last-bit difference to 8 bits, so a packed window's
        tokens would depend on what shares it (a ``slots=4`` service parted
        from ``slots=1`` on the card).  In f32 the steps stay batched."""
        if self.dtype == torch.float32:
            logits, cache = decoder_forward(
                ctx["params"], tokens, ctx["cross_kv"], self.config,
                cache=cache, attention_mask=ctx["attn_mask"], dtype=self.dtype,
            )
            return logits[:, -1], cache
        return self._by_segment(tokens, cache, ctx, prefill=False), cache

    def _by_segment(self, ids: torch.Tensor, cache: dict, ctx: dict, prefill: bool) -> torch.Tensor:
        """``decoder_forward`` of ``ids`` one segment's rows at a time, into
        views of ``cache``, whose index it advances; the last position's
        logits of every row.  A beam cache's ancestry map is item-local, so
        a segment takes its own slice of it."""
        n_seg = ctx["cross_kv"][0]["k"].shape[0]
        reps = ids.shape[0] // n_seg
        index = cache["index"]
        logits = []
        for i in range(n_seg):
            rows = slice(i * reps, (i + 1) * reps)
            part = dict(cache, layers=[{name: slab[rows] for name, slab in layer.items()}
                                       for layer in cache["layers"]])
            if "anc" in cache:
                part["anc"] = cache["anc"][i : i + 1]
            cross_kv = [{name: t[i : i + 1] for name, t in layer.items()} for layer in ctx["cross_kv"]]
            out, _ = decoder_forward(ctx["params"], ids[rows], cross_kv, self.config,
                                     cache=part, attention_mask=ctx["attn_mask"][rows],
                                     dtype=self.dtype, prefill=prefill)
            logits.append(out[:, -1])
        cache["index"] = index + ids.shape[1]
        return torch.cat(logits)

    def _prefill(self, prompt: torch.Tensor, ctx: dict, max_length: int):
        """Run the prompt through a fresh cache, positioned at
        ``prompt_len - 1``: the decode loop's first step re-feeds the final
        prompt token (rewriting its own slot with identical K/V).  Returns
        (cache, logits at the final prompt position).  The prompt takes the
        multi-token write of an int8 cache at any length, as in the JAX
        package, whose prompts are padded to a bucket of 8 or more.

        One segment's rows (its beams) at a time, into views of the cache:
        cuBLAS picks its GEMM kernel by the number of rows, so a batched
        prefill would give a row other bits beside other segments."""
        cache = init_cache(self.config, prompt.shape[0], max_length, self.device,
                           dtype=self.dtype, kv_int8=self._kv_cache_int8,
                           staging_window=self._kv_staging,
                           num_heads=decoder_heads(self.params, self.config))
        profiler.add_counts("ecw.scheduler.window", self_kv_bytes=_nbytes(cache["layers"]))
        logits = self._by_segment(prompt, cache, ctx, prefill=True)
        cache["index"] = prompt.shape[1] - 1
        if "base" in cache:
            # the prompt lies in the int8 slab; the first step re-feeds its
            # last token into window slot 0, past the slab's part
            cache["base"] = prompt.shape[1] - 1
        return cache, logits

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
        temperature: float = 0.0,
        noise: Optional[Callable[[int, Tuple[int, ...]], torch.Tensor]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Prefill the prompt, run beam/greedy/sampling to
        max_target_positions; returns (full sequences incl. prompt
        [B, max_len], scores [B], no-speech probabilities [B]).  ``noise``
        maps (cur_len, shape) to Gumbel draws for a sampled decode: greedy
        at ``num_beams=1``, beam-sample above.  The
        no-speech probability (softmax at ``no_speech_token_id`` of the
        first generated position) is computed only when a threshold will
        read it, else 0."""
        batch, plen = decoder_input_ids.shape
        max_length = opts.max_target_positions
        pmask = (
            np.asarray(attention_mask, dtype=np.int64)
            if attention_mask is not None
            else np.ones((batch, plen), dtype=np.int64)
        )
        processors = self._processors(dataclasses.replace(opts, return_timestamps=return_timestamps))
        use_sampling = temperature > 0.0
        K = opts.num_beams
        reps = K if K > 1 else 1
        ctx = self._make_ctx(cross_kv, pmask, max_length, reps)
        prompt = torch.from_numpy(np.asarray(decoder_input_ids, dtype=np.int64)).to(self.device)
        cache, first_logits = self._prefill(prompt.repeat_interleave(reps, dim=0), ctx, max_length)
        if opts.no_speech_threshold is not None:
            probs = torch.softmax(first_logits.to(torch.float32), dim=-1)
            no_speech_probs = probs[::reps, opts.no_speech_token_id].cpu().numpy()
        else:
            no_speech_probs = np.zeros((batch,), np.float32)
        if K == 1:
            seqs, scores = greedy_search(
                self._decode_step, prompt, plen, cache, ctx, processors,
                max_length=max_length, pad_token_id=opts.pad_token_id,
                eos_token_id=opts.eos_token_id, do_sample=use_sampling,
                temperature=float(temperature) if use_sampling else 1.0, noise=noise,
            )
        else:
            seqs, scores = beam_search(
                self._decode_step, prompt, plen, cache, ctx, processors,
                num_beams=K, max_length=max_length, length_penalty=opts.length_penalty,
                pad_token_id=opts.pad_token_id, eos_token_id=opts.eos_token_id,
                do_sample=use_sampling, temperature=float(temperature) if use_sampling else 1.0,
                noise=noise,
            )
        return seqs.cpu().numpy(), scores.cpu().numpy(), no_speech_probs

    # -------------------------------------------------------------- dispatch

    @torch.no_grad()
    def generate(
        self,
        input_features: torch.Tensor,  # [B, n_mels, T]
        opts: GenerationOptions,
        attention_mask: Optional[np.ndarray] = None,
        keyword_spotting: Optional[Callable] = None,
        return_segments: bool = False,
        encode_spot: Optional[Callable] = None,
        noise: NoiseSource = cpu_gumbel_noise,
    ):
        """Shortform for one utterance of at most 3000 frames: the
        generated tokens [1, max_len - prompt_len] with the keyword prompt
        stripped (``attention_mask`` unused, as in the reference).
        Otherwise the longform seek loop over every row, each ending where
        its ``attention_mask`` [B, T] ends: the right-padded tokens of each
        row's segments [B, n], or with ``return_segments`` a dict with
        those ``"sequences"`` and each row's ``"segments"`` (dicts with
        ``start``, ``end`` in seconds and ``tokens``).

        ``encode_spot(segment_mels, start_of_prev=False) -> (keyword_tokens,
        encoding | None)`` is the single-encode hook (one encoder forward
        feeds spotting and cross-attention); ``keyword_spotting`` returns
        the keyword tokens only.  ``noise`` feeds the ladder's sampled
        rungs."""
        total_frames = input_features.shape[-1]
        if total_frames <= self.n_segment_frames and input_features.shape[0] == 1:
            return self._generate_shortform(input_features, opts, keyword_spotting, encode_spot)
        return self._generate_longform(
            input_features, opts, attention_mask, keyword_spotting, return_segments,
            encode_spot, noise,
        )

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
        seqs, _, _ = self._decode_prompted(
            cross_kv, decoder_ids, None, opts, return_timestamps=opts.return_timestamps,
        )
        return strip_prompt(seqs, len(prompt_ids))

    # -------------------------------------------------------------- longform

    def _pad_segment(self, seg) -> torch.Tensor:
        seg = torch.as_tensor(seg, dtype=torch.float32, device=self.device)
        pad = self.n_segment_frames - seg.shape[-1]
        return F.pad(seg, (0, pad)) if pad else seg

    def _run_longform_window(
        self,
        rows: List[Optional[_LongformRow]],
        opts: GenerationOptions,
        keyword_spotting,
        encode_spot,
        prev_enabled: bool,
        condition_any: bool,
        segment_idx: int,
        noise: NoiseSource,
        fixed_prompt: bool = False,
        fixed_keywords: bool = True,
    ) -> None:
        """Decode ONE 30 s window of every slot in ``rows`` and advance the
        seeks of the occupied ones.

        ``rows[j] is None`` marks a VACANT slot (packed decode at the
        stream's tail): it decodes a zero mel with an empty prompt, so the
        launch keeps its width, stays out of the fallback ladder, and its
        output is dropped.

        ``prev_enabled`` is the caller's condition-on-prev gate: the
        fixed-batch path passes HF's row-0 rule (``len(current_segments[0])
        > 0``), the packed path True, so each utterance conditions on its
        own history alone.  ``condition_any`` is ``any(condition flags)``
        over ALL utterances (finished included) on the fixed-batch path and
        ``condition_on_prev_tokens`` on the packed one.  ``fixed_prompt``
        and ``fixed_keywords`` pick the fixed-width prompt layout
        (:func:`.prompt.prepare_decoder_input_ids`)."""
        timestamp_begin = opts.no_timestamps_token_id + 1
        seek_num_frames = [
            0 if r is None else min(r.max_frames - r.seek, self.n_segment_frames) for r in rows
        ]
        zero_seg = torch.zeros((1, self.config.num_mel_bins, self.n_segment_frames),
                               dtype=torch.float32, device=self.device)
        seg = torch.cat([
            zero_seg if r is None
            else self._pad_segment(r.features[:, :, r.seek : r.seek + seek_num_frames[j]])
            for j, r in enumerate(rows)
        ])

        # vacant slots must not feed a pending int8 calibration: the real-row
        # mask goes to hooks whose signature takes it (CBWhisper's do; a
        # plain test callable need not)
        hook_kwargs = {}
        hook = encode_spot if encode_spot is not None else keyword_spotting
        if hook is not None and any(r is None for r in rows):
            try:
                takes_mask = "real_rows" in inspect.signature(hook).parameters
            except (TypeError, ValueError):  # a callable without a signature
                takes_mask = False
            if takes_mask:
                hook_kwargs["real_rows"] = [r is not None for r in rows]

        enc = None
        if encode_spot is not None:
            keywords_tokens, enc = encode_spot(seg, **hook_kwargs)
        elif keyword_spotting is not None:
            keywords_tokens = keyword_spotting(input_features=seg, **hook_kwargs)
        else:
            keywords_tokens = [[] for _ in rows]
        keywords_tokens = [[] if r is None else keywords_tokens[j] for j, r in enumerate(rows)]

        prev_tokens = [
            [t for s in r.segments for t in segment_prev_tokens(s, timestamp_begin)]
            if r is not None and r.condition else None
            for r in rows
        ]
        use_prev = prev_enabled and any(p is not None and len(p) > 0 for p in prev_tokens)

        if enc is None:
            enc = self._encode(seg)
        cross_kv = self._cross_kv_fn(enc)
        profiler.add_counts("ecw.scheduler.window", cross_kv_bytes=_nbytes(cross_kv))

        # language auto-detection: each row once, on its own first window
        # (frames [0:3000], HF's detect_language operand)
        init_tokens: Any = opts.init_tokens()
        if opts.needs_lang_detection:
            todo = [j for j, r in enumerate(rows) if r is not None and r.lang_token_id is None]
            if todo:
                detected = self._detect_language_ids(cross_kv, len(rows), opts)
                for j in todo:
                    rows[j].lang_token_id = int(detected[j])
            # a vacant slot's output is dropped: any language token keeps its
            # prompt row the same width
            fill = sorted(opts.lang_token_ids)[0]
            init_tokens = [opts.init_tokens(fill if r is None else r.lang_token_id) for r in rows]

        decoder_ids, attn = prepare_decoder_input_ids(
            init_tokens=init_tokens,
            keywords_tokens=keywords_tokens,
            prev_tokens_per_batch=prev_tokens if use_prev else None,
            condition_on_prev=condition_any,
            max_target_positions=opts.max_target_positions,
            pad_token_id=opts.pad_token_id,
            prev_sot_token_id=opts.prev_sot_token_id,
            fixed_width=fixed_prompt,
            fixed_keywords=fixed_keywords,
        )

        cond_local = [False if r is None else r.condition for r in rows]
        seqs, _, should_skip = self._generate_with_fallback(
            cross_kv, decoder_ids, attn, opts, cond_local, list(range(len(rows))),
            segment_idx=segment_idx, noise=noise, vacant=[r is None for r in rows],
        )

        plen = decoder_ids.shape[1]
        for j, r in enumerate(rows):
            if r is None:
                continue
            r.condition = cond_local[j]
            if should_skip[j]:
                # silence detected: drop the segment, advance the window
                r.seek += seek_num_frames[j]
                continue
            seek_seq = self._trim_generated(seqs[j, plen:], opts)
            time_offset = r.seek * TIME_PRECISION / INPUT_STRIDE
            segments, segment_offset = self._retrieve_segment(
                seek_seq, float(time_offset), timestamp_begin, int(seek_num_frames[j]),
            )
            r.segments += segments
            r.seek += segment_offset

    def _generate_longform(
        self, input_features, opts, attention_mask, keyword_spotting,
        return_segments, encode_spot, noise: NoiseSource,
    ):
        batch = input_features.shape[0]
        total = input_features.shape[-1]
        if attention_mask is not None:
            max_frames = np.asarray(attention_mask).sum(-1).astype(np.int64)
        else:
            max_frames = np.full((batch,), total, dtype=np.int64)
        rows = [
            _LongformRow(
                features=input_features[i : i + 1],
                max_frames=int(max_frames[i]),
                order=i,
                condition=opts.condition_on_prev_tokens,
            )
            for i in range(batch)
        ]

        segment_idx = 0
        while any(not r.done for r in rows):
            segment_idx += 1
            self._run_longform_window(
                [r for r in rows if not r.done],
                opts,
                keyword_spotting,
                encode_spot,
                prev_enabled=len(rows[0].segments) > 0,
                condition_any=any(r.condition for r in rows),
                segment_idx=segment_idx,
                noise=noise,
            )

        sequences = self._pad_sequences_right(
            [[t for s in r.segments for t in s["tokens"]] for r in rows],
            opts.pad_token_id,
        )
        if return_segments:
            return {"sequences": sequences, "segments": [r.segments for r in rows]}
        return sequences

    def generate_packed(
        self,
        stream: Iterable,
        opts: GenerationOptions,
        slots: int = 4,
        keyword_spotting: Optional[Callable] = None,
        encode_spot: Optional[Callable] = None,
        return_segments: bool = False,
        noise: NoiseSource = cpu_gumbel_noise,
    ) -> Iterator[Tuple[int, Any]]:
        """Continuous-batching longform decode over a STREAM of utterances.

        ``slots`` utterances decode as one batch, one 30 s window per
        launch; a finished utterance hands its slot to the next one from
        the stream at the next window, so every launch has the same width.

        ``stream`` yields ``(features [1, n_mels, T] or [n_mels, T],
        attention_mask or None)``.  Yields ``(order, result)`` as utterances
        COMPLETE, not in submission order; ``order`` is the 0-based position
        in the stream.  ``result`` is the 1-D int64 token array of the
        utterance's segments (a ``{"sequences", "segments"}`` dict with
        ``return_segments``).  A zero-length utterance completes at once
        without taking a slot.

        Live protocol (``runtime.serving``): the stream may yield ``None``,
        "nothing available right now": the scheduler stops refilling for
        this window, decodes the rows in flight and asks again at the next
        one.  Only ``StopIteration`` ends the stream.  A stream must not
        yield ``None`` while nothing is in flight (the scheduler would
        spin); a live stream blocks then until work arrives or it ends.

        Transcripts do not depend on the schedule: each row conditions on
        its own history (no row-0 gate), and when prompts can vary
        (spotting configured or conditioning on) every row takes the
        fixed-width prompt layout, so its prompt positions and decode
        budget depend on its own content alone.  ``slots=N`` gives every
        utterance the tokens of ``slots=1``.  A single-window utterance
        takes the longform segment surface here, not the shortform one.
        Vacant slots appear only at the stream's tail or when a live stream
        is idle; they are kept out of int8 calibration."""
        it = iter(stream)
        exhausted = False
        order = 0
        slots = max(1, int(slots))  # 0 slots would spin without admitting
        occupied: List[Optional[_LongformRow]] = [None] * slots
        ready: List[Tuple[int, Any]] = []

        def result_of(tokens, segments):
            return {"sequences": tokens, "segments": segments} if return_segments else tokens

        def refill():
            nonlocal exhausted, order
            for s in range(slots):
                while occupied[s] is None and not exhausted:
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    if item is None:
                        # live stream: nothing right now; decode the rows in
                        # flight and ask again next window
                        return
                    features, attention_mask = item
                    features = torch.as_tensor(features, dtype=torch.float32, device=self.device)
                    if features.ndim == 2:
                        features = features[None]
                    max_frames = features.shape[-1]
                    if attention_mask is not None:
                        max_frames = min(max_frames, int(np.asarray(attention_mask).sum()))
                    if max_frames <= 0:
                        ready.append((order, result_of(np.zeros((0,), np.int64), [])))
                        order += 1
                        continue
                    occupied[s] = _LongformRow(
                        features=features, max_frames=max_frames, order=order,
                        condition=opts.condition_on_prev_tokens,
                    )
                    order += 1

        spotting = keyword_spotting is not None or encode_spot is not None
        segment_idx = 0
        while True:
            # results first, refill second: a live stream decides whether to
            # block on its queue by counting the work in flight, so
            # completions must reach it before the next pull
            yield from ready
            ready.clear()
            refill()
            yield from ready  # zero-length utterances admitted just now
            ready.clear()
            if all(r is None for r in occupied):
                if exhausted:
                    break
                continue  # the live stream was idle: ask it again
            segment_idx += 1
            # grad mode is per thread and this generator may be resumed from
            # any thread: no_grad is entered around each window, never held
            # across a yield
            orders = tuple(r.order for r in occupied if r is not None)
            with torch.no_grad(), profiler.span("ecw.scheduler.window", id=orders, slots=slots):
                self._run_longform_window(
                    occupied, opts, keyword_spotting, encode_spot,
                    prev_enabled=True,
                    # a static flag, not any(row.condition): the fixed-width
                    # budget split must not depend on who holds the slots
                    condition_any=opts.condition_on_prev_tokens,
                    segment_idx=segment_idx,
                    noise=noise,
                    fixed_prompt=spotting or opts.condition_on_prev_tokens,
                    # static per call: with no spotter the keyword field is
                    # dropped, so the previous text keeps the whole budget
                    fixed_keywords=spotting,
                )
            for s in range(slots):
                r = occupied[s]
                if r is not None and r.done:
                    tokens = np.asarray([t for seg in r.segments for t in seg["tokens"]], np.int64)
                    ready.append((r.order, result_of(tokens, r.segments)))
                    occupied[s] = None

    @staticmethod
    def _take_rows(cross_kv, rows: List[int]):
        """Rows ``rows`` of the batch axis of every layer's cross K/V
        ([B, T_enc, H, Dh] each, kept in their memory order, and [B, T_enc]
        int8 scales)."""
        idx = torch.as_tensor(rows, dtype=torch.long, device=cross_kv[0]["k"].device)
        return [{name: cross_kv_order(name, [t.index_select(0, idx)]) for name, t in layer.items()}
                for layer in cross_kv]

    def _need_fallback(self, gen_with_eos, score, no_speech_prob, opts, num_beams_used: int):
        """HF ``_need_fallback`` on one row: (fallback, skip).

        ``gen_with_eos`` keeps the trailing eos: both the compression ratio
        and the avg-logprob denominator count it.  Beam scores are already
        length-normalized; greedy/sampled scores are the logprob sum over
        generated tokens incl. eos."""
        avg_lp = (
            float(score)
            if num_beams_used > 1
            else float(score) / max(len(gen_with_eos), 1)
        )
        fallback, skip = False, False
        if opts.compression_ratio_threshold is not None:
            ratio = _compression_ratio(gen_with_eos, self.config.vocab_size)
            if ratio > opts.compression_ratio_threshold:
                fallback = True
        if opts.logprob_threshold is not None and avg_lp < opts.logprob_threshold:
            fallback = True
        if opts.no_speech_threshold is not None:
            if float(no_speech_prob) > opts.no_speech_threshold and (
                opts.logprob_threshold is None or avg_lp < opts.logprob_threshold
            ):
                fallback = False
                skip = True
        return fallback, skip

    def _generate_with_fallback(self, cross_kv, decoder_ids, attn, opts, condition_flags,
                                active, segment_idx: int, noise: NoiseSource,
                                vacant: Optional[List[bool]] = None):
        """Temperature fallback ladder (HF ``generate_with_fallback``):
        retry at the next temperature while the output is repetitive (zlib
        compression ratio) or unsure (mean logprob); a segment whose
        no-speech probability passes its threshold with a low logprob is
        skipped.

        * only the rows that still need fallback are decoded again;
        * sampled rungs (temperature > 0) decode with ``num_beams=1``;
        * per row, conditioning for the NEXT window follows the rung that
          produced the kept result: ``condition_on_prev and temperature <
          0.5`` (written into ``condition_flags[active[row]]``);
        * the last rung's result is kept even if it still fails;
        * ``should_skip`` is per ORIGINAL row (docs/PARITY.md #14);
        * a ``vacant`` row (packed decode's padding slot) never falls back
          and is never skipped: its output is dropped.  Below f32, where
          every segment decodes on its own (:meth:`_decode_step`), a vacant
          row is not decoded at all: its output is the bare prompt.
        Rung ``ti`` of window ``segment_idx`` samples with
        ``noise(ti, segment_idx, ...)``."""
        B, plen = decoder_ids.shape
        bare = np.full((opts.max_target_positions,), opts.pad_token_id, np.int64)
        kept_seqs: List[np.ndarray] = [np.concatenate([row, bare[plen:]]) for row in decoder_ids]
        kept_scores = np.zeros((B,), np.float32)
        should_skip = [False] * B
        fallback_map = list(range(B))  # original row of each current row
        cur_cross_kv, cur_ids, cur_attn = cross_kv, decoder_ids, attn
        if vacant is not None and any(vacant) and self.dtype != torch.float32:
            fallback_map = [i for i, v in enumerate(vacant) if not v]
            if not fallback_map:
                return np.stack(kept_seqs), kept_scores, should_skip
            cur_ids = cur_ids[fallback_map]
            cur_attn = cur_attn[fallback_map] if cur_attn is not None else None
            cur_cross_kv = self._take_rows(cur_cross_kv, fallback_map)
        for ti, temperature in enumerate(opts.temperature):
            do_sample = temperature is not None and float(temperature) > 0.0
            opts_rung = dataclasses.replace(opts, num_beams=1) if do_sample else opts
            seqs, scores, no_speech = self._decode_prompted(
                cur_cross_kv, cur_ids, cur_attn, opts_rung,
                return_timestamps=opts.return_timestamps,
                temperature=float(temperature or 0.0),
                noise=partial(noise, ti, segment_idx),
            )
            new_map: List[int] = []
            new_rows: List[int] = []
            for row in range(seqs.shape[0]):
                orig = fallback_map[row]
                gen_eos = self._trim_generated(seqs[row, plen:], opts, keep_eos=True)
                fallback, skip = self._need_fallback(
                    gen_eos, scores[row], no_speech[row], opts, opts_rung.num_beams,
                )
                if vacant is not None and vacant[orig]:
                    fallback, skip = False, False
                kept_seqs[orig] = seqs[row]
                kept_scores[orig] = float(scores[row])
                should_skip[orig] = skip
                condition_flags[active[orig]] = bool(
                    opts.condition_on_prev_tokens
                    and (temperature is None or float(temperature) < 0.5)
                )
                if fallback:
                    new_map.append(orig)
                    new_rows.append(row)
            fallback_map = new_map
            if not fallback_map or ti == len(opts.temperature) - 1:
                break
            cur_ids = cur_ids[new_rows]
            cur_attn = cur_attn[new_rows] if cur_attn is not None else None
            cur_cross_kv = self._take_rows(cur_cross_kv, new_rows)
        return np.stack(kept_seqs), kept_scores, should_skip

    @staticmethod
    def _trim_generated(tokens: np.ndarray, opts: GenerationOptions,
                        keep_eos: bool = False) -> List[int]:
        """Strip TRAILING padding, then the final eos unless ``keep_eos``
        (HF: padding removed with eos kept for the fallback metrics, eos
        stripped afterwards for segmentation).  A pad token emitted
        MID-sequence is kept, like HF."""
        out = tokens.tolist()
        n_trail = 0
        while n_trail < len(out) and out[-1 - n_trail] == opts.pad_token_id:
            n_trail += 1
        if opts.pad_token_id == opts.eos_token_id and n_trail > 0:
            n_trail -= 1  # the final "pad" is the eos itself: keep it here
        if n_trail:
            out = out[:-n_trail]
        if not keep_eos and out and out[-1] == opts.eos_token_id:
            out.pop()
        return [int(t) for t in out]

    @staticmethod
    def _retrieve_segment(
        seek_sequence: List[int],
        time_offset: float,
        timestamp_begin: int,
        seek_num_frames: int,
    ) -> Tuple[List[dict], int]:
        """Timestamp-driven segmentation + seek advance (HF
        ``_retrieve_segment``): (segments, frames to advance the seek)."""
        seq = np.asarray(seek_sequence, dtype=np.int64)
        ts_mask = seq >= timestamp_begin
        if seq.size == 0:
            return [], seek_num_frames
        single_timestamp_ending = seq.size >= 2 and not ts_mask[-2] and ts_mask[-1]
        consecutive = np.where(ts_mask[:-1] & ts_mask[1:])[0] + 1

        if consecutive.size > 0:
            slices = consecutive.tolist()
            if single_timestamp_ending:
                slices.append(seq.size)
            else:
                # the closing timestamp of the final pair belongs to the
                # last segment
                slices[-1] += 1
            segments = []
            last_slice = 0
            for i, current_slice in enumerate(slices):
                is_last = i == len(slices) - 1
                sliced = seq[last_slice:current_slice]
                start_pos = int(sliced[0]) - timestamp_begin
                end_idx = -1 if (not is_last or single_timestamp_ending) else -2
                end_pos = int(sliced[end_idx]) - timestamp_begin
                segments.append({
                    "start": time_offset + start_pos * TIME_PRECISION,
                    "end": time_offset + end_pos * TIME_PRECISION,
                    "tokens": sliced.tolist(),
                })
                last_slice = current_slice
            if single_timestamp_ending:
                segment_offset = seek_num_frames
            else:
                # seek to the last "end of segment" timestamp (first of the
                # closing pair), discarding the unfinished tail
                last_ts_pos = int(seq[last_slice - 2]) - timestamp_begin
                segment_offset = last_ts_pos * INPUT_STRIDE
        else:
            timestamps = seq[ts_mask]
            # HF computes int(snf * time_precision_features / time_precision)
            # in FLOAT32; its truncation differs from snf // 2 in both
            # directions (snf=1686 -> 842, snf=1756 -> 878)
            last_ts_pos = int(
                np.float32(seek_num_frames)
                * np.float32(TIME_PRECISION / INPUT_STRIDE)
                / np.float32(TIME_PRECISION)
            )
            if timestamps.size > 0 and int(timestamps[-1]) != timestamp_begin:
                last_ts_pos = int(timestamps[-1]) - timestamp_begin
            segments = [{
                "start": time_offset,
                "end": time_offset + last_ts_pos * TIME_PRECISION,
                "tokens": seq.tolist(),
            }]
            segment_offset = seek_num_frames

        if segment_offset <= 0:
            # deliberate deviation (docs/PARITY.md #19): a closing timestamp
            # pair at position 0 gives offset 0 and would stall HF's seek
            # loop; the full window is advanced instead
            segment_offset = seek_num_frames
        return segments, segment_offset

    @staticmethod
    def _pad_sequences_right(seqs: List[List[int]], pad_token_id: int) -> np.ndarray:
        max_len = max((len(s) for s in seqs), default=0)
        out = np.full((len(seqs), max_len), pad_token_id, dtype=np.int64)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = s
        return out
