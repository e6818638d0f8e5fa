"""CB-Whisper's spotting and decoding, written out plainly.

* spotting: the encoder's hidden states of the configured layers, each
  frame L2-normalized; per keyword the cosine-similarity maps of its stack
  against the utterance's, bilinearly resized (align_corners False, no
  antialias) to the spotter's input size; the ResNet's logits;
* the spotter's class-1 bias is centred on the median margin of one
  segment, as the benchmark's set-up does for the program;
* decoding: the beam-search score of a served sequence, from a
  teacher-forced forward: log-softmax of each position's logits, the
  logits processors, the served tokens' values summed over the generated
  positions (through the first end-of-text, or to the cap) and divided by
  their count (length penalty 1).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import resnet, whisper
from .logits import LogitsProcessorConfig, apply_logits_processors
from .precision import Prec

SPOT_BATCH = 26  # maps per ResNet call: bounds the reference's memory


def kws_stack(states: List[torch.Tensor], layer_slice: Sequence[int]) -> torch.Tensor:
    s = torch.stack(states[layer_slice[0]:layer_slice[1]])  # [L, T, D]
    return s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)


def spot_logits(w_kws: Dict[str, torch.Tensor], kws: dict, keywords: List[torch.Tensor],
                stack: torch.Tensor, prec: Prec) -> torch.Tensor:
    """logits [N, 2] of every keyword stack [L, T_k, D] against ``stack``."""
    size = tuple(kws["features_size"])
    maps = [F.interpolate(prec.matmul(k, stack.transpose(-1, -2))[None], size=size, mode="bilinear",
                          align_corners=False, antialias=False)[0] for k in keywords]
    out = []
    for i in range(0, len(maps), SPOT_BATCH):
        out.append(resnet.logits(w_kws, kws["resnet"], torch.stack(maps[i:i + SPOT_BATCH]),
                                 "model.feature_extractor.", "model.classifier", prec))
    return torch.cat(out)


def centre(w_kws: Dict[str, torch.Tensor], logits: torch.Tensor) -> None:
    """Shift the class-1 bias by the median class-1 margin of ``logits``."""
    margin = logits[:, 1] - logits[:, 0]
    w_kws["model.classifier.bias"] = w_kws["model.classifier.bias"] - torch.stack(
        [torch.zeros_like(margin[0]), margin.median()])


def processors(cfg: dict) -> LogitsProcessorConfig:
    gen = cfg["generation"]
    return LogitsProcessorConfig(
        suppress_tokens=tuple(gen.get("suppress_tokens", ())),
        begin_suppress_tokens=tuple(cfg["begin_suppress_tokens"]),
        no_timestamps_token_id=gen["no_timestamps_token_id"],
        max_initial_timestamp_index=gen["max_initial_timestamp_index"],
        return_timestamps=gen["return_timestamps"],
        eos_token_id=cfg["eos_token_id"],
        vocab_size=cfg["vocab_size"],
    )


def beam_score(w: Dict[str, torch.Tensor], cfg: dict, enc: torch.Tensor, prompt_len: int,
               sequence: torch.Tensor, prompt_mask: torch.Tensor, prec: Prec) -> torch.Tensor:
    """The length-normalized beam score of ``sequence`` [max_len] (its
    first ``prompt_len`` tokens the prompt, ``prompt_mask`` their key mask)."""
    eos = cfg["eos_token_id"]
    gen = sequence[prompt_len:]
    ends = torch.nonzero(gen == eos)
    n_gen = int(ends[0, 0]) + 1 if ends.numel() else int(gen.shape[0])
    ids = sequence[: prompt_len + n_gen]
    key_mask = torch.cat([prompt_mask, torch.ones(n_gen, dtype=prompt_mask.dtype, device=ids.device)])
    logits = whisper.decode_logits(w, cfg, ids, key_mask, enc, prec)
    logprobs = torch.log_softmax(logits[prompt_len - 1 : prompt_len - 1 + n_gen], dim=-1)
    proc = processors(cfg)
    tokens = sequence[None]
    total = torch.zeros((), dtype=torch.float64, device=ids.device)
    for i in range(n_gen):
        cur = prompt_len + i
        processed = apply_logits_processors(proc, logprobs[i : i + 1], tokens, cur, prompt_len)
        total = total + processed[0, sequence[cur]].double()
    return total / n_gen
