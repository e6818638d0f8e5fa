"""Whisper's logits processors, the rules beam search applies to each
position's log-probabilities: suppressed tokens, the tokens suppressed at
the first generated position, and HF's ``WhisperTimeStampLogitsProcessor``
(paired and non-decreasing timestamps, a timestamp first, a timestamp
forced where the timestamps' total probability beats every text token).

A frozen copy of the port's plain version
(enhance_cb_whisper_tpu_torch/decoding/logits_process.py), so the
reference imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class LogitsProcessorConfig:
    suppress_tokens: Tuple[int, ...] = ()
    begin_suppress_tokens: Tuple[int, ...] = ()
    no_timestamps_token_id: Optional[int] = None  # timestamps start at +1
    max_initial_timestamp_index: Optional[int] = 50
    return_timestamps: bool = False
    eos_token_id: int = 50257
    vocab_size: int = 51865

    @property
    def timestamp_begin(self) -> Optional[int]:
        if self.no_timestamps_token_id is None:
            return None
        return self.no_timestamps_token_id + 1


def _suppress(logits: torch.Tensor, token_ids: Sequence[int]) -> torch.Tensor:
    if len(token_ids) == 0:
        return logits
    mask = torch.zeros(logits.shape[-1], dtype=torch.bool, device=logits.device)
    mask[torch.as_tensor(list(token_ids), dtype=torch.long, device=logits.device)] = True
    return logits.masked_fill(mask[None, :], NEG_INF)


def apply_logits_processors(
    cfg: LogitsProcessorConfig,
    logits: torch.Tensor,  # [B, vocab] raw logits for the next position
    tokens: torch.Tensor,  # [B, L] all tokens so far (prompt + generated, padded ahead)
    cur_len: int,  # number of valid tokens in ``tokens``
    begin_index: int,  # index of the first generated position
) -> torch.Tensor:
    logits = _suppress(logits.to(torch.float32), cfg.suppress_tokens)
    if len(cfg.begin_suppress_tokens) > 0 and cur_len == begin_index:
        logits = _suppress(logits, cfg.begin_suppress_tokens)
    if cfg.return_timestamps and cfg.no_timestamps_token_id is not None:
        logits = _timestamp_rules(cfg, logits, tokens, cur_len, begin_index)
    return logits


def _timestamp_rules(cfg: LogitsProcessorConfig, logits: torch.Tensor, tokens: torch.Tensor,
                     cur_len: int, begin_index: int) -> torch.Tensor:
    ts_begin = cfg.timestamp_begin
    device = logits.device
    vocab_ids = torch.arange(logits.shape[-1], device=device)[None, :]
    is_ts_col = vocab_ids >= ts_begin

    # never emit <|notimestamps|>
    logits = logits.masked_fill(vocab_ids == cfg.no_timestamps_token_id, NEG_INF)

    n_generated = cur_len - begin_index
    last_tok = tokens[:, cur_len - 1] if cur_len >= 1 else torch.zeros_like(tokens[:, 0])
    penult_tok = tokens[:, cur_len - 2] if cur_len >= 2 else torch.zeros_like(tokens[:, 0])
    last_was_ts = (last_tok >= ts_begin) & (n_generated >= 1)
    # HF: fewer than two generated tokens counts as "penultimate was timestamp"
    penult_was_ts = (penult_tok >= ts_begin) | (n_generated < 2)

    # pairing: ts after ts -> text next; ts after text -> bans ids BELOW eos
    after_pair = last_was_ts & penult_was_ts
    after_single_ts = last_was_ts & ~penult_was_ts
    ban_ts = after_pair[:, None] & is_ts_col
    ban_text = after_single_ts[:, None] & (vocab_ids < cfg.eos_token_id)
    logits = logits.masked_fill(ban_ts | ban_text, NEG_INF)

    # timestamps are non-decreasing relative to the LAST generated timestamp
    pos = torch.arange(tokens.shape[1], device=device)[None, :]
    gen_mask = (pos >= begin_index) & (pos < cur_len)
    is_gen_ts = gen_mask & (tokens >= ts_begin)
    last_ts_pos = torch.where(is_gen_ts, pos, torch.full_like(pos, -1)).amax(dim=1)
    has_ts = last_ts_pos >= 0
    last_ts_val = torch.gather(tokens, 1, last_ts_pos.clamp_min(0)[:, None])[:, 0]
    threshold = torch.where(after_single_ts, last_ts_val, last_ts_val + 1)
    ban_lower = has_ts[:, None] & is_ts_col & (vocab_ids < threshold[:, None])
    logits = logits.masked_fill(ban_lower, NEG_INF)

    # first generated token: a timestamp, capped at max_initial_timestamp
    if cur_len == begin_index:
        ban_first_text = ~is_ts_col
        if cfg.max_initial_timestamp_index is not None:
            last_allowed = ts_begin + cfg.max_initial_timestamp_index
            ban_first_text = ban_first_text | (vocab_ids > last_allowed)
        logits = logits.masked_fill(ban_first_text, NEG_INF)

    # if total timestamp probability >= max text probability, force a timestamp
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(logprobs.masked_fill(~is_ts_col, NEG_INF), dim=-1)
    max_text_logprob = logprobs.masked_fill(is_ts_col, NEG_INF).amax(dim=-1)
    force_ts = ts_logprob > max_text_logprob
    return logits.masked_fill(force_ts[:, None] & ~is_ts_col, NEG_INF)
