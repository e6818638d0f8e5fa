"""Beam search and greedy decoding for Whisper (port of
enhance_cb_whisper_tpu/decoding/beam.py).

HF's modern (transformers >= 4.49) beam-search semantics, as in the JAX
package:

* scores accumulate log-softmax values with the processor masks applied
  after normalization;
* eos candidates ranked < num_beams retire into the finished set with score
  ``total / (generated_len + 1)**length_penalty`` — the length WITHOUT the
  decoder prompt and WITH the retiring token; eos stays in the sequence;
* a batch is done once all K finished slots are filled and the best running
  score, normalized at the current generated length, cannot beat the worst
  finished score (``early_stopping=False``);
* at max_length the running beams retire through the same normalization.

The JAX ``while_loop`` is a Python loop here.  Conventions kept: the cache
arrives positioned at ``prompt_len - 1`` and the first step re-feeds the
final prompt token; a staged int8 cache is flushed after every W-th step
(the JAX loop runs whole W-step windows, the steps past its stop changing
nothing but the cache, which the port skips).

A float cache (no ``k_scale`` in its layers) carries the JAX package's
ancestry map: ``cache["anc"]`` [B, K, max_len] int32 names, for each
logical beam and position, the item's physical beam row that holds the
token.  Each logical beam appends its K/V to its own row, and each step
re-parents the map with the beam selection (:func:`_reparent`); the rows
never move, and the decoder reads them through the map
(``ops/beam_attention.py``, kernel K4).  An int8 cache, whose steps attend
in split score blocks, is reordered by beam index each step instead
(:func:`_gather_beams`, ``index_select`` over its written prefix).  The
path follows what the cache holds.

Each step, its stop test included, is an ``ecw.decode.step`` span
(:mod:`..runtime.profiler`); the stop test's read of the device, the one
place a step waits for the card, is its child ``ecw.decode.sync``.  A
beam step's span carries ``reorder_bytes`` (the cache bytes
:func:`_gather_beams` copied, 0 on the map) and ``anc_layers`` (the
decoder layers that read through the map).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..models.whisper import flush_staging
from ..runtime import profiler
from .logits_process import NEG_INF, LogitsProcessorConfig, apply_logits_processors
from .topk import exact_top_k

# decode_fn(tokens_chunk [N, 1], cache, ctx) -> (logits [N, vocab], cache)
DecodeFn = Callable[[torch.Tensor, Any, Any], Tuple[torch.Tensor, Any]]


def _gather_beams(cache: dict, rows: torch.Tensor, length: int) -> int:
    """Reorder the cache's batch·beam rows by ``rows`` [B·K], in place, over
    the written prefix ``[:length]`` of every slab of every layer: the K/V
    and, for an int8 cache, their per-token scales and staging windows
    (whose written slots are fewer than ``length``).  Returns the bytes of
    the prefixes reordered."""
    moved = 0
    for layer in cache["layers"]:
        for slab in layer.values():
            slab[:, :length] = slab[:, :length].index_select(0, rows)
            moved += slab[:, :length].numel() * slab.element_size()
    return moved


def _ancestry_map(cache: Any, batch: int, beams: int) -> Optional[torch.Tensor]:
    """Give a float cache its identity ancestry map [B, K, max_len] int32
    (``cache["anc"]``) and return it; None for an int8 cache, which keeps
    :func:`_gather_beams`."""
    layers = cache["layers"]
    if any("k_scale" in layer for layer in layers):
        return None
    max_len = layers[0]["k"].shape[1]
    ident = torch.arange(beams, dtype=torch.int32, device=layers[0]["k"].device)
    cache["anc"] = ident[None, :, None].expand(batch, beams, max_len).contiguous()
    return cache["anc"]


def _reparent(anc: torch.Tensor, sel_beam: torch.Tensor, length: int) -> None:
    """Each logical beam takes its selected parent's map over the written
    positions ``[:length]``, this step's included, in place; later
    positions stay the identity, so each beam's next token lands in its own
    row (the JAX package's ``where(slot < cur_len, parent, ident)``)."""
    prefix = anc[:, :, :length]
    prefix.copy_(torch.gather(prefix, 1, sel_beam[:, :, None].expand(-1, -1, length)))


def _flush_full_window(cache: Any) -> None:
    """Staged int8 caches: after the W-th step since the last flush, commit
    the window to the int8 slabs (the JAX package flushes once per W-step
    window of its decode loop)."""
    if isinstance(cache, dict) and "base" in cache:
        if cache["index"] - cache["base"] == cache["layers"][0]["ks"].shape[1]:
            flush_staging(cache)


@torch.no_grad()
def beam_search(
    decode_fn: DecodeFn,
    prompt: torch.Tensor,  # [B, P] decoder input ids (int64)
    prompt_len: int,
    cache: Any,  # cache with leading dim B*K, prefilled with the prompt
    ctx: Any,  # per-segment decode context (cross KV etc.)
    processors: LogitsProcessorConfig,
    num_beams: int = 5,
    max_length: int = 448,
    length_penalty: float = 1.0,
    pad_token_id: int = 50257,
    eos_token_id: int = 50257,
    do_sample: bool = False,
    temperature: float = 1.0,
    noise: Optional[Callable[[int, Tuple[int, ...]], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sequences [B, max_length] right-padded, scores [B]).

    ``do_sample=True`` is HF's beam-sample: the processed log-probs are
    divided by ``temperature`` before they accumulate, and the 2K
    candidates are drawn without replacement from the softmax of the
    accumulated scores by Gumbel-top-k, ranking ``total + g`` with ``g =
    noise(cur_len, (B, K, V))`` standard Gumbel draws (the JAX package's
    ``jax.random.gumbel`` can be injected) through the same two-stage
    top-2K as the deterministic search.  Candidate order is sampling
    order; the candidates keep their unperturbed scores."""
    if do_sample and noise is None:
        raise ValueError("sampling needs a noise source")
    device = prompt.device
    batch, plen = prompt.shape
    K = num_beams
    V = processors.vocab_size

    tokens = torch.full((batch, K, max_length), pad_token_id, dtype=torch.long, device=device)
    tokens[:, :, :plen] = prompt[:, None, :]
    running_scores = torch.full((batch, K), NEG_INF, dtype=torch.float32, device=device)
    running_scores[:, 0] = 0.0
    fin_tokens = torch.full_like(tokens, pad_token_id)
    fin_scores = torch.full((batch, K), NEG_INF, dtype=torch.float32, device=device)
    fin_flags = torch.zeros((batch, K), dtype=torch.bool, device=device)
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    rank = torch.arange(2 * K, device=device)[None, :]
    row_base = (torch.arange(batch, device=device) * K)[:, None]
    anc = _ancestry_map(cache, batch, K)

    def normalize(scores: torch.Tensor, length: int) -> torch.Tensor:
        denom = torch.tensor(float(length), dtype=torch.float32, device=device) ** length_penalty
        return scores / denom

    cur_len = prompt_len
    running = cur_len < max_length and not bool(done.all())
    while running:
        with profiler.span("ecw.decode.step", rows=batch * K, anc_layers=0):
            last = tokens[:, :, cur_len - 1].reshape(batch * K, 1)
            logits, cache = decode_fn(last, cache, ctx)
            logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
            logprobs = apply_logits_processors(
                processors, logprobs, tokens.reshape(batch * K, max_length), cur_len, prompt_len,
            ).reshape(batch, K, V)
            if do_sample:
                logprobs = logprobs / temperature
            total = logprobs + running_scores[:, :, None]  # [B, K, V]
            ranked = total
            if do_sample:
                ranked = total + noise(cur_len, (batch, K, V)).to(device, torch.float32)

            # per-beam top-2K, then top-2K of the K*2K pool: the global top-2K
            # of the flattened [K*V] axis with the same (beam-major) tie order
            per_ranked, per_token = exact_top_k(ranked.reshape(batch * K, V), 2 * K)
            pool_ranked = per_ranked.reshape(batch, K * 2 * K)
            pool_token = per_token.reshape(batch, K * 2 * K)
            cand_scores, pool_sel = exact_top_k(pool_ranked, 2 * K)  # [B, 2K]
            cand_beam = pool_sel // (2 * K)
            cand_token = torch.gather(pool_token, 1, pool_sel)
            if do_sample:
                pool_scores = torch.gather(total.reshape(batch * K, V), 1, per_token).reshape(batch, K * 2 * K)
                cand_scores = torch.gather(pool_scores, 1, pool_sel)
            is_eos = cand_token == eos_token_id

            # retire eos candidates (rank < K) into the finished set
            gen_len = cur_len + 1 - prompt_len
            eligible = is_eos & (rank < K) & ~done[:, None]
            cand_fin_score = torch.where(
                eligible, normalize(cand_scores, gen_len), torch.full_like(cand_scores, NEG_INF)
            )
            cand_sequences = torch.gather(
                tokens, 1, cand_beam[:, :, None].expand(batch, 2 * K, max_length)
            ).clone()
            cand_sequences[:, :, cur_len] = eos_token_id

            merged_scores = torch.cat([fin_scores, cand_fin_score], dim=1)  # [B, 3K]
            merged_tokens = torch.cat([fin_tokens, cand_sequences], dim=1)
            merged_flags = torch.cat([fin_flags, eligible], dim=1)
            fin_scores, top_idx = exact_top_k(merged_scores, K)
            fin_tokens = torch.gather(merged_tokens, 1, top_idx[:, :, None].expand(batch, K, max_length))
            fin_flags = torch.gather(merged_flags, 1, top_idx)

            # the next K running beams: best non-eos candidates in rank order
            running_eligible = torch.where(is_eos, torch.full_like(cand_scores, NEG_INF), cand_scores)
            new_running, sel = exact_top_k(running_eligible, K)
            sel_beam = torch.gather(cand_beam, 1, sel)  # [B, K]
            sel_token = torch.gather(cand_token, 1, sel)
            new_tokens = torch.gather(tokens, 1, sel_beam[:, :, None].expand(batch, K, max_length)).clone()
            new_tokens[:, :, cur_len] = sel_token
            if anc is not None:
                _reparent(anc, sel_beam, cur_len)
                moved = 0
            else:
                moved = _gather_beams(cache, (row_base + sel_beam).reshape(-1), cur_len)
            profiler.add_counts("ecw.decode.step", reorder_bytes=moved)
            _flush_full_window(cache)

            # frozen batches keep their previous state
            tokens = torch.where(done[:, None, None], tokens, new_tokens)
            running_scores = torch.where(done[:, None], running_scores, new_running)

            best_possible = normalize(running_scores[:, 0], gen_len)
            worst_finished = fin_scores.amin(dim=1)
            done = done | ((fin_flags.sum(dim=1) >= K) & (worst_finished >= best_possible))
            cur_len += 1
            with profiler.span("ecw.decode.sync"):
                running = cur_len < max_length and not bool(done.all())

    # finalize: running beams retire through the same normalization and
    # compete with the finished hypotheses; done batches keep finished only
    running_norm = normalize(running_scores, cur_len - prompt_len)
    running_norm = torch.where(done[:, None], torch.full_like(running_norm, NEG_INF), running_norm)
    all_scores = torch.cat([fin_scores, running_norm], dim=1)  # [B, 2K]
    all_tokens = torch.cat([fin_tokens, tokens], dim=1)
    best = torch.argmax(all_scores, dim=1)
    sequences = all_tokens[torch.arange(batch, device=device), best]
    scores = all_scores[torch.arange(batch, device=device), best]
    return sequences, scores


@torch.no_grad()
def greedy_search(
    decode_fn: DecodeFn,
    prompt: torch.Tensor,  # [B, P]
    prompt_len: int,
    cache: Any,  # prefilled, leading dim B
    ctx: Any,
    processors: LogitsProcessorConfig,
    max_length: int = 448,
    pad_token_id: int = 50257,
    eos_token_id: int = 50257,
    do_sample: bool = False,
    temperature: float = 1.0,
    noise: Optional[Callable[[int, Tuple[int, ...]], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode (``do_sample=False``) or multinomial sampling at
    ``temperature`` (the fallback ladder's sampled rungs); returns
    (sequences [B, max_length], sum of the log-softmax of the PROCESSED
    scores over generated tokens incl. eos [B], never divided by the
    temperature).

    A sampled step is ``argmax(processed / temperature + g)`` with ``g =
    noise(cur_len, processed.shape)`` standard Gumbel draws: the body of
    ``jax.random.categorical`` in the JAX package, whose draws a caller can
    inject to sample the same tokens."""
    device = prompt.device
    batch, plen = prompt.shape
    if do_sample and noise is None:
        raise ValueError("sampling needs a noise source")
    tokens = torch.full((batch, max_length), pad_token_id, dtype=torch.long, device=device)
    tokens[:, :plen] = prompt
    sum_lp = torch.zeros((batch,), dtype=torch.float32, device=device)
    finished = torch.zeros((batch,), dtype=torch.bool, device=device)

    cur_len = prompt_len
    running = cur_len < max_length and not bool(finished.all())
    while running:
        with profiler.span("ecw.decode.step", rows=batch):
            logits, cache = decode_fn(tokens[:, cur_len - 1 : cur_len], cache, ctx)
            _flush_full_window(cache)
            processed = apply_logits_processors(
                processors, logits.to(torch.float32), tokens, cur_len, prompt_len
            )
            if do_sample:
                gumbel = noise(cur_len, tuple(processed.shape)).to(device, torch.float32)
                next_tok = torch.argmax(processed / temperature + gumbel, dim=-1)
            else:
                next_tok = torch.argmax(processed, dim=-1)
            tok_lp = torch.gather(torch.log_softmax(processed, dim=-1), 1, next_tok[:, None])[:, 0]
            next_tok = torch.where(finished, torch.full_like(next_tok, pad_token_id), next_tok)
            sum_lp = sum_lp + torch.where(finished, torch.zeros_like(tok_lp), tok_lp)
            tokens[:, cur_len] = next_tok
            finished = finished | (next_tok == eos_token_id)
            cur_len += 1
            with profiler.span("ecw.decode.sync"):
                running = cur_len < max_length and not bool(finished.all())
    return tokens, sum_lp
