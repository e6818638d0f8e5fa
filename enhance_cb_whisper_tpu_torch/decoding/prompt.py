"""Decoder prompt assembly for contextual biasing (host-side token logic).

A numpy-only copy of enhance_cb_whisper_tpu/decoding/prompt.py (that
package's ``decoding/__init__`` imports jax, so the port keeps its own).

Exact reproduction of the reference's budget math in
``PBAWhisper._prepare_decoder_input_ids`` (src/model/pba_whisper.py:478-548):

* total context budget: ``cut_off_length = max_target_positions // 2 - 1``;
* detected-keyword tokens get at most ``(cut_off_length * 3) // 4 - 1``
  of it when also conditioning on previous text, else ``cut_off_length - 1``;
* previous-segment tokens get what remains
  (``cut_off_length - len(keywords) - 1``);
* both are trimmed to their LAST ``cut_off`` tokens and LEFT-padded to the
  batch max (HF ``_pad_to_max_length(padding='left')``);
* when any context exists the final ids are
  ``[<|startofprev|>, keywords, prev, *init_tokens]`` and an attention mask
  marks non-pad positions; otherwise just ``init_tokens``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def pad_to_max_length(
    sequences: Sequence[Sequence[int]],
    pad_token_id: int,
    padding: str = "left",
    bos_token: Optional[int] = None,
    cut_off_length: Optional[int] = None,
) -> np.ndarray:
    """HF ``_pad_to_max_length`` over plain token-id lists."""
    items: List[List[int]] = []
    for seq in sequences:
        seq = list(seq)
        if cut_off_length is not None:
            seq = seq[-cut_off_length:]
        if bos_token is not None:
            seq = [bos_token] + seq
        items.append(seq)
    max_len = max((len(s) for s in items), default=0)
    out = np.full((len(items), max_len), pad_token_id, dtype=np.int64)
    for i, seq in enumerate(items):
        if not seq:
            continue
        if padding == "left":
            out[i, max_len - len(seq):] = seq
        else:
            out[i, : len(seq)] = seq
    return out


def segment_prev_tokens(segment: dict, timestamp_begin: int) -> Sequence[int]:
    """Tokens a finished segment contributes as condition-on-prev context.

    A segment ending in a double timestamp contributes all but its last
    token (HF ``_pad_to_max_length`` ``skip_ending_double_timestamps``,
    transformers #35750: ``len(tokens) > 2 and tokens[-2] >= timestamp_begin``)."""
    toks = segment["tokens"]
    if len(toks) > 2 and toks[-2] >= timestamp_begin:
        return toks[:-1]
    return toks


def _pad_fixed(
    sequences: Sequence[Sequence[int]], pad_token_id: int, width: int
) -> np.ndarray:
    """Left-pad each sequence (cut to its LAST ``width`` tokens) to a
    CONSTANT width — the fixed-layout variant of ``pad_to_max_length``."""
    out = np.full((len(sequences), width), pad_token_id, dtype=np.int64)
    if width == 0:
        return out
    for i, seq in enumerate(sequences):
        seq = list(seq)[-width:]
        if seq:
            out[i, width - len(seq):] = seq
    return out


def _init_rows(init_tokens, cur_bsz: int) -> np.ndarray:
    """Init-token block as [B, n]: a flat sequence is shared by every row;
    a sequence of per-row sequences (language auto-detection — rows carry
    different language tokens but identical widths) is used as-is."""
    if len(init_tokens) and isinstance(init_tokens[0], (list, tuple, np.ndarray)):
        arr = np.asarray([list(t) for t in init_tokens], dtype=np.int64)
        assert arr.shape[0] == cur_bsz, (arr.shape, cur_bsz)
        return arr
    return np.tile(
        np.asarray(list(init_tokens), dtype=np.int64)[None, :], (cur_bsz, 1)
    )


def prepare_decoder_input_ids(
    init_tokens: Sequence[int],
    keywords_tokens: Sequence[Sequence[int]],
    prev_tokens_per_batch: Optional[Sequence[Optional[Sequence[int]]]],
    condition_on_prev: bool,
    max_target_positions: int,
    pad_token_id: int,
    prev_sot_token_id: Optional[int],
    fixed_width: bool = False,
    fixed_keywords: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (decoder_input_ids [B, T], attention_mask [B, T] or None).

    ``prev_tokens_per_batch[i]`` is the concatenated token ids of all previous
    segments for batch row i (None for rows not conditioning), or None/empty
    when there is no history yet.

    ``fixed_width`` (continuous-batching serving mode, ``generate_packed``):
    the keyword and prev fields are left-padded to CONSTANT widths — the
    full reference budget split — instead of the realized batch max.  Under
    the default (HF/reference) layout a row's token POSITIONS, and its
    decode budget ``max_target_positions - plen``, move with the longest
    prompt in the batch, so output depends on who it was co-batched with;
    with a fixed layout they are a function of the row's OWN content only,
    which is what lets the packed scheduler guarantee schedule-independent
    transcripts (and keeps every launch on ONE prompt bucket).
    ``<|startofprev|>`` is emitted per row, only for rows carrying real
    context.  ``fixed_keywords=False`` (no spotter configured — static per
    serving call) drops the keyword field entirely so prev history gets the
    FULL reference budget instead of permanently reserving ~75% of it for
    keywords that can never arrive.
    """
    cur_bsz = len(keywords_tokens)
    cut_off_length = max_target_positions // 2 - 1

    if fixed_width:
        if not fixed_keywords:
            w_kw = 0
            w_prev = cut_off_length if condition_on_prev else 0
        elif condition_on_prev:
            w_kw = (cut_off_length * 3) // 4 - 1
            w_prev = cut_off_length - w_kw - 1
        else:
            w_kw = cut_off_length - 1
            w_prev = 0
        kw = _pad_fixed(keywords_tokens, pad_token_id, max(w_kw, 0))
        prevs = [
            list(p) if p is not None else []
            for p in (prev_tokens_per_batch or [[]] * cur_bsz)
        ]
        prev = _pad_fixed(prevs, pad_token_id, max(w_prev, 0))
        init = _init_rows(init_tokens, cur_bsz)
        if prev_sot_token_id is not None:
            has_ctx = np.asarray(
                [
                    len(list(k)[-w_kw:] if w_kw > 0 else []) > 0
                    or len(p[-w_prev:] if w_prev > 0 else []) > 0
                    for k, p in zip(keywords_tokens, prevs)
                ]
            )
            bos = np.where(has_ctx, prev_sot_token_id, pad_token_id)[:, None]
        else:
            bos = np.zeros((cur_bsz, 0), dtype=np.int64)
        ids = np.concatenate([bos, kw, prev, init], axis=1)
        return ids, (ids != pad_token_id).astype(np.int64)
    init = _init_rows(init_tokens, cur_bsz)

    any_kw = any(len(t) > 0 for t in keywords_tokens)
    has_prev = (
        condition_on_prev
        and prev_tokens_per_batch is not None
        and any(p is not None and len(p) > 0 for p in prev_tokens_per_batch)
    )

    if condition_on_prev and any_kw:
        cut_off_length_keywords = (cut_off_length * 3) // 4 - 1
        kw = pad_to_max_length(
            keywords_tokens, pad_token_id, padding="left", cut_off_length=cut_off_length_keywords
        )
    elif any_kw:
        cut_off_length_keywords = cut_off_length - 1
        kw = pad_to_max_length(
            keywords_tokens, pad_token_id, padding="left", cut_off_length=cut_off_length_keywords
        )
    else:
        kw = np.zeros((cur_bsz, 0), dtype=np.int64)

    if has_prev:
        active = [list(p) if p is not None else [] for p in prev_tokens_per_batch]
        # with keywords: the reference's shared budget (pba_whisper.py:534).
        # without: plain HF semantics (full cut_off_length) — the reference's
        # extra -1 here is an artifact of its keyword plumbing, and the
        # no-keyword path must stay token-exact with HF (docs/PARITY.md #4)
        prev_cut = (
            cut_off_length - kw.shape[1] - 1 if kw.shape[1] > 0 else cut_off_length
        )
        prev = pad_to_max_length(
            active,
            pad_token_id,
            padding="left",
            cut_off_length=prev_cut,
        )
    else:
        prev = np.zeros((cur_bsz, 0), dtype=np.int64)

    if kw.shape[1] > 0 or prev.shape[1] > 0:
        if prev_sot_token_id is not None:
            bos = np.full((cur_bsz, 1), prev_sot_token_id, dtype=np.int64)
        else:  # no <|startofprev|> in the vocab/config: omit it (HF does too)
            bos = np.zeros((cur_bsz, 0), dtype=np.int64)
        ids = np.concatenate([bos, kw, prev, init], axis=1)
        attention_mask = (ids != pad_token_id).astype(np.int64)
        return ids, attention_mask
    return init, None


def strip_prompt(sequences: np.ndarray, prompt_len: int) -> np.ndarray:
    """Shortform output strips the injected prompt
    (src/model/pba_whisper.py:338)."""
    return sequences[:, prompt_len:]
