#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (enhance_cb_whisper_tpu_torch) on one GPU.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py --k1     # K1 alone: its build, phase A (and the features' span) and phase C times
    python3 chip_smoke.py --k3     # K3 alone: its build and phase A3 (checks and times)
    python3 chip_smoke.py --k4     # K4 alone: its build and phase A4 (checks, times, 9 beams)
    python3 chip_smoke.py --serving  # the kernels' build, phase A2 and phase F alone
    python3 chip_smoke.py --levers   # the kernels' build, phase A2 and phase G alone
    python3 chip_smoke.py --train    # phase H (paper-1 training) alone
    python3 chip_smoke.py --paper2   # the kernels' build, phase A2 at paper 2's shapes and phase I alone
    python3 chip_smoke.py --paper2-train  # K1's build, phase A and phase J (paper-2 training) alone
    python3 chip_smoke.py --pipeline  # K1's build, phase A and phase P (the offline cache pipeline) alone
    python3 chip_smoke.py --scale-out  # the kernels' build and phase Q (torch.distributed) alone

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, started together), then:

A.  holds the fused mel kernel K1 (csrc/mel.cu) against its plain torch
    version on the card at 80 and 128 mels: [4, 480000], a 37 s
    [2, 592000] batch, [3, 4960] (31 frames a row, fewer than a tile) and
    [1, 480] (3 frames, both reflected edges in one tile), and at 80 mels
    [1, 760000], the whole 47.5 s utterance of phase B, and at both
    [1, 480000] and [16, 480000], the batch phase J's audio-mode step gives
    it, rtol 1e-4 / atol 1e-5 (the JAX package's Pallas-kernel tolerance);
    then ``prepare_features`` on its own stream: equal to K1 on the
    caller's stream bit for bit, alone and beside another thread's busy
    stream, one device-timed ``ecw.audio.features`` span a call (bins,
    samples, one K1 launch);
A2. holds the fused s8 matmul + requant kernel K2 (csrc/matmul_s8.cu)
    against its plain version at every shape the int8 ResNet-50 scorer
    gives it (22 launches per chunk of 8 keyword maps at 150x750, 9
    distinct shapes) and four ragged M that take each kind of launch plan
    (BM = 64, BM = 128, K split in 2, M = 1 with K split in 8), with ReLU on and off,
    without a residual and with one scaled by an [N] or a 0-d res_scale:
    zero differing int8 codes allowed, and two launches of a split-K plan
    give identical bytes; the int8 runs of B and D record the shapes they
    launch and must launch exactly these; then the same at paper 2's
    shapes (the int8 ResNet-50 on 3 x 150 x 1500 and LEF's 3 x 75 x 750
    maps, chunks of 50: 22 launches each);
A3. holds the fused MaxSim proxy kernel K3 (csrc/maxsim.cu) against its
    plain version (the cascade's stage 1 as chunked torch calls of 128
    rows) at the 100k-keyword LEF cell's shapes, LE's and L's (3,000 and
    1,000 keywords at 150 x 1500), and ragged N, T_u and U (8, 96) with
    partial masks, fp16 products and f32 and fp16 catalogs: max |diff| <= 1e-4 (the order
    of f32 sums), two launches a call; prints its device time beside its
    bound and the chunked path's time at the LEF cell and the L shape;
A4. holds the beam self-attention kernel K4 (csrc/beam_attention.cu)
    against its plain version (the rows gathered by the ancestry map, then
    the decoder's attention) at the serve cells' beam caches: a map [16, 5,
    244], 16 and 20 heads of 64, lengths 124-243, uniform and re-parented
    maps, prompt pads, f32 and bf16, 3, 8, 9 and 17 beams, and the tiny models'
    head sizes 16 and 32 (tolerance: ``K4_TOL``, with its reason), one
    launch a call; prints its device time beside its bytes bound, the
    plain version's time and the host time of a call; then decodes the
    tiny CB-Whisper of phase B at 9 beams, more than a K4 block takes, on
    the CPU and on the card (identical keywords and token sequences, K4
    launched);
B.  checks that building ``CBWhisper`` on the card turns TF32 off; checks
    the CUDA path against the CPU path on a tiny random CB-Whisper, in fp32
    and with int8 spotting on a K2-eligible ResNet (identical keywords and
    transcripts, K2 launched on the card), and on the tiny model's longform
    seek loop (a 2.5-window utterance and a batch of two of unequal
    lengths, condition-on-prev, timestamps, a fallback ladder whose every
    rung trips: identical sequences and segments); then drives the main
    path — ``CBWhisper.run_test`` over three synthetic utterances of 5-30 s
    and one of 47.5 s (two windows), written as a 44.1 kHz WAV and read
    back through the port's resampler — at whisper-medium widths (random
    weights from a numpy seed) with the 12-channel ResNet-50 KWS scorer at
    150x750, layer slice (10, 22), a 100-keyword catalog and beam-5 fp32
    decoding with condition-on-prev and timestamps, each window capped at
    ``MEDIUM_DECODE`` positions (the random decoder never ends a window): once with the fp32
    scorer, once with the int8 scorer (``enable_int8_spotting``, calibrated
    on a warm-up utterance, stages 1-3 on K2), counting each kernel's
    launches over exactly each ``run_test`` (K1 once per utterance, K2 22
    times per chunk of each window, K4 once per decoder layer of every beam
    step, whose span reads ``reorder_bytes`` 0 and ``anc_layers`` 24);
D.  runs the paper-1 KWS eval (``KWSEngine.test``) on the same ResNet-50
    over the 100-keyword catalog and 8 utterance stacks of 300-1500 frames,
    in fp32 and after ``enable_int8_scoring``: P/R/F1 with bootstrap CIs,
    the share of decisions that flip, the time per pair, K2's launches;
E.  drives the port's command line (``run_cli``) on the repo's config
    files: first a tiny random checkpoint directory (Whisper's real vocab
    and special ids at d_model 64) and a 6-keyword ACL-6060 layout, on the
    CPU and on the card (identical transcripts, keywords and entity
    recall); then phase B's whisper-medium written as an HF checkpoint
    directory (config.json, model.safetensors, generation_config.json, a
    tokenizer saved by transformers itself) and read back exactly, phase
    B's ResNet-50 as a reference Lightning .ckpt, and an ACL-6060 test
    layout of phase B's 100 keywords and two utterances (16 kHz and
    44.1 kHz WAVs): ``cb-whisper.py test`` on configs/cb-whisper-acl.yaml
    launches K1 exactly once per utterance, and ``kws.py test`` on
    configs/kws-acl.yaml with ``kws_int8`` (and no environment variable)
    launches K2 exactly 22 x 13 per utterance at phase A2's shapes (the kernel
    line's ``cli_launches``).  Its directory is deleted at the end;
F.  serving: on the tiny model, ``generate_packed`` at ``slots=3`` over
    five mels of 0.6-2.5 windows and one of zero length, with int8
    spotting, condition-on-prev and a ladder whose every rung trips, on
    the CPU and on the card (identical (order, sequences, segments)),
    ``slots=3`` = ``slots=1`` on the card, vacant slots kept out of int8
    calibration (by count), ``forward_batch`` and the CLI with
    ``eval_packed`` CPU = card; then at whisper-medium widths (phase B's
    model and utterances) ``run_test(packed=True, batch_size=1)`` and a
    ``TranscriptionService(slots=4)`` given all four at once (every
    ticket's transcript = its slots=1 one), ``swap_params`` on the live
    service to a second random checkpoint (seed 1; the next utterance
    decodes under it) and to one of another architecture (raises through
    ``result()``), and the same with the int8 scorer; K1 once per
    utterance and K2 exactly 22 x 13 per scored row-window (the kernel
    line's ``packed_launches``, over the int8 service run); walls, RTFx,
    windows and their occupied slots, ms per decode step at slots 1 and 4,
    peak memory;
G.  the serving levers (bf16 compute, weight-only int8 vocab and decoder,
    int8 self- and cross-attention K/V, the int8 cache with staged writes
    (``kv_staging`` 16), the s8 KWS encoder): G1 holds each
    on the tiny model CPU = card (identical keywords and transcripts under
    each int8 lever on fp32 and the s8 KWS encoder on a separate encoder
    copy; beam-sample at 4 beams and T 0.7 with the same injected Gumbel
    draws: identical tokens and scores; bf16 alone and the serving set bf16 + int8 vocab + int8 decoder
    with int8 spotting by the CPU tests' bf16 bound on teacher-forced
    logits); G2 runs phase B's 5.5 s utterance through ``run_test`` at
    whisper-medium widths under fp32, each lever, the serving set with
    ``kws_int8`` (K2 exactly 22 x 13 per scored window, K1 once) and a
    separate KWS encoder in s8 beside its fp32 encode + spot, printing ms
    per decode step, encode + spot, peak memory, device operations per
    decoder forward and the token prefix shared with fp32 (the kernel
    line's ``levers_launches``, over the serving set's run); G3 holds the live
    ``TranscriptionService(slots=4)`` in the serving set to ``slots=1``
    (transcripts and keywords) and a ``swap_params`` on it to a fresh
    generator on the new checkpoint (weights bit for bit, transcript);
H.  paper-1 training, which launches neither kernel (the count of each is
    read over the phase: the kernel line's ``train_launches``): H1 holds
    the train step on the tiny ResNet CPU = card in each mode of
    tests/test_torch_train_step.py (plain with the unweighted entropy; the
    adversarial step with two accumulated minibatches, the large heads'
    dropout, the kw_type='all' coin and DANNCE; device_features; remat;
    bf16), with the same CPU-seeded draws: gradients, running statistics,
    metric sums and the updated weights; H2 runs ``run_cli(["fit", ...])``
    on configs/train.yaml (the 12-channel ResNet-50 at 150x750, batch 20,
    large heads) from a synthetic AISHELL layout at whisper-large-v2 widths
    (12 x 1280, 100 keywords, utterances of 250-1500 frames) written under
    build/chip_smoke/phase_h/ and deleted at the end: the host collator,
    device_features, adversarial training at 8 x 20 examples a step,
    one DANNCE step, a resume from the written checkpoint and ``test`` on
    it (each fit a few batches: the step split is taken on its last); each run prints ms per step, examples/s, peak memory, and a
    torch.profiler split of one step's device time (convolutions forward
    and backward, BatchNorm, the optimizer, the rest) with its idle share;
    the losses must be finite and the weights must move;
I.  paper 2 (the L/LE/LEF eval, ``efficient_kws/``), which launches no K1
    and K2 only under ``kws_int8`` (the kernel line's ``paper2_launches``,
    over I2 and I3): I1 holds a tiny model's probabilities CPU = card for L,
    LE and LEF and, with ``kws_int8`` on a ResNet whose 1x1s take K2, its
    decisions; I2 runs ``run_cli(["test", ...])`` on
    configs/efficient_kws/eval-{L,LE,LEF}-comp-acl.yaml at full width
    (ResNet-50, 3 x 1024 stacks, 150 x 1500) from reference .ckpt files
    over a 100-keyword, 4-utterance ACL-6060 layout written under
    build/chip_smoke/phase_i/ (deleted at the end), and LEF again with
    ``kws_int8``, whose K2 launches must be exactly 22 per chunk of 50 at
    A2's LEF shapes; I3 times bench_catalog100k.py's workload: the
    projected scorer in fp32 (1,024 keywords through ``project_catalog``)
    and bf16 (4,096), and the cascade at 100,352 keywords with a 2,048
    shortlist, each beside its FLOP bound;
J.  paper-2 training (``EfficientKWSEngine.fit``), which launches K1 in
    the audio mode only and K2 never (the kernel line's
    ``paper2_train_launches``, over J2's and J3's CLI runs): J1 holds a
    train step of a tiny L, LE and LEF (12-wide stacks, embedding_dim 8,
    ResNet-18 at 32 x 64) CPU = card from the same weights with the same
    CPU-seeded coin, and the audio mode's embedding of [8, 480000] on the
    card (K1) against the CPU's (the plain mel), then a step of each; J2
    runs ``run_cli(["fit", ...])`` on configs/efficient_kws/train-LEF.yaml
    as written (ResNet-50 on 3 layers, 150 x 1500, batch 16 pairs,
    kw_type all) over a synthetic MLS layout of the six languages at
    whisper-large-v2's 12 x 1280 (wider than embedding_dim 1024), written
    under build/chip_smoke/phase_j/ and deleted at the end: one epoch of
    three batches with its 12 validation sets, then a resume; J3 the same
    config with ``load_embeddings: false`` and a random whisper-large-v2
    written as an HF directory, K1 exactly once a step at [16, 480000];
    each prints ms per step, examples/s, peak memory and a torch.profiler
    split of one step's device time beside its FLOP bound;
P.  the offline cache pipeline (``python -m
    enhance_cb_whisper_tpu_torch.pipeline --extract_hs``): P1 runs it on the
    tiny model (written as an HF directory) over five WAVs on the CPU and on
    the card, identical caches within 1e-4; P2 runs its ``main`` at
    whisper-medium's encoder (random weights, the decoder cut to two layers)
    over 17 WAVs of 5-40 s, half at 44.1 kHz, and a sub-hop WAV and a
    non-WAV file (both skipped), written under build/chip_smoke/phase_p/ and
    deleted at the end: K1 exactly once per batch of <= 8 at [<= 8, 480000]
    (the kernel line's ``pipeline_launches``), every cache equal to
    ``encoder_kws_stack`` of its file through ``prepare_features``, files/s,
    MB/s written, the encoder's ms per file against its FP32 bound and a
    profiled run's idle share; then the f16 caches (< 0.6x the files) and
    the s8 encoder in bf16 (per-frame cosine > 0.999 against f32);
Q.  scale-out (``parallel/``, after D, on phase B's model and utterances),
    its ranks spawned by ``parallel/mesh.py:launch``: a world of 2 on gloo,
    both ranks on cuda:0 (NCCL refuses two ranks on one device), runs the
    paper-1 step data-parallel (configs/train.yaml's ResNet-50 at 150x750,
    2 x 10 of a global batch of 20, BatchNorm over the global batch), then
    at model=2 int8 spotting over the 100-keyword catalog sharded by chunks
    (K2 split between the ranks), the tensor-parallel whisper-medium
    encoder (8 of 16 heads a rank) on K1's mels and the TP longform decode
    of phase B's four utterances, and saves the step's state with Adam's
    moments sharded (``runtime/sharded_checkpoint.py``); a world of 1 on
    NCCL then runs every reference (loss within rtol 1e-5, the classifier
    kernel 1e-4 / 1e-6, equal keywords and K2 total, the encoder within
    2e-4 / 2e-5, identical transcripts), restores the checkpoint (equal
    bytes) and profiles 32 beam-5 decode steps with ``runtime/profiler.py``
    (the busy share, within 1 % of ``key_averages()``); it prints gloo's
    reduce time per TP decode step.  The kernel line's
    ``scale_out_launches`` count the world of 2's launches.  More than one
    rank on the one card is a correctness run, not a scaling figure;
C.  times K1 and K2 and their plain versions on the card, each by the
    median of CUDA-event timings of CUDA-graph replays (device time
    without host gaps) and of eager calls: K1 at [1, 480000], [8, 480000]
    and [1, 760000], with its own run time from the CUPTI trace, its host time
    per call and, for scale, torch.stft's cuFFT sequence, which the port
    never calls; K2 at each shape of a chunk with its launch plan, bound,
    multiple of the bound and GB/s, beside torch._int_mm (cuBLASLt's int8
    product alone) for scale; the same for a chunk of 50 paper-2 LEF maps.

Any failure raises and exits non-zero.  The line before the last is the
kernel summary as JSON, the last line the device as JSON.  Needs one card;
there is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import statistics
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SEED = 0
RTOL, ATOL = 1e-4, 1e-5
KERNEL_SOURCE = "enhance_cb_whisper_tpu_torch/csrc/mel.cu"
REPLACES = "enhance_cb_whisper_tpu/ops/mel_pallas.py:56"
K2_SOURCE = "enhance_cb_whisper_tpu_torch/csrc/matmul_s8.cu"
K2_REPLACES = "enhance_cb_whisper_tpu/ops/matmul_s8.py:61"
K3_SOURCE = "enhance_cb_whisper_tpu_torch/csrc/maxsim.cu"
K3_REPLACES = None  # no TPU kernel: the JAX package leaves the cascade's proxy to XLA
K4_SOURCE = "enhance_cb_whisper_tpu_torch/csrc/beam_attention.cu"
K4_REPLACES = None  # no TPU kernel: the JAX package leaves _ancestry_attention to XLA
S8_STAGES = ("stage_1", "stage_2", "stage_3")
KWS_SIZE = (150, 750)
CHUNK = 8  # keyword maps per scorer call (CBWhisper and KWSEngine)
N_KW = 100
LONGFORM_SECONDS = 47.5  # two windows: 30 s + 17.5 s
# published peaks of one H100 SXM (dense): HBM bytes/s, FP32 FLOP/s, int8 OP/s
HBM_RATE, FP32_RATE, INT8_RATE = 3.35e12, 67e12, 1979e12
BF16_RATE = 989e12  # dense bf16 tensor-core FLOP/s
# decode cap of the random whisper-medium's runs (phases B, F2, G2, G3): its
# decoder never emits eos, so each window decoded to 448 positions (439
# beam steps) before; the cap cuts that depth to make room for phase I
MEDIUM_DECODE = 128


def _audio(batch: int, n_samples: int, rng: np.random.Generator) -> np.ndarray:
    """Noise and tones at different levels, with silent (zero) tails."""
    audio = np.zeros((batch, n_samples), np.float32)
    t = np.arange(n_samples, dtype=np.float64) / 16000.0
    for b in range(batch):
        n = int(n_samples * (0.3 + 0.6 * (b + 1) / batch))
        level = 0.02 + 0.05 * b
        tone = 0.1 * np.sin(2 * np.pi * (200 + 150 * b) * t[:n])
        audio[b, :n] = (rng.standard_normal(n) * level + tone).astype(np.float32)
    return audio


def _close(got, want):
    """(max abs err, max rel err, within rtol/atol everywhere)."""
    diff = (got - want).abs()
    ok = bool((diff <= ATOL + RTOL * want.abs()).all())
    rel = (diff / want.abs().clamp_min(1e-30)).max().item()
    return diff.max().item(), rel, ok


def _stacks(rng: np.random.Generator, n: int, n_layers: int, frames, dim: int):
    """L2-normalized random hidden-state stacks [n_layers, T, dim]."""
    out = []
    for i in range(n):
        s = rng.standard_normal((n_layers, frames(i), dim)).astype(np.float32)
        out.append(s / np.linalg.norm(s, axis=-1, keepdims=True))
    return out


def build_kernels() -> None:
    from enhance_cb_whisper_tpu_torch.ops import beam_attention, matmul_s8_cuda, maxsim_cuda, mel_cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(m.kernel.build) for m in (mel_cuda, matmul_s8_cuda, maxsim_cuda, beam_attention)]
        mel_lib, k2_lib, k3_lib, k4_lib = (job.result() for job in jobs)
    print(f"build: {KERNEL_SOURCE}, {K2_SOURCE}, {K3_SOURCE} and {K4_SOURCE} compiled in parallel and "
          f"loaded in {time.perf_counter() - t0:.1f} s")
    _print_ptxas("K1", mel_lib)
    _print_ptxas("K2", k2_lib)  # four kernels: BM 64/128, with and without a residual
    _print_ptxas("K3", k3_lib)  # four row kernels (bf16/f16 x BM 64/128) and the reduction
    _print_ptxas("K4", k4_lib)  # f32 and bf16


def _print_ptxas(name: str, lib: str) -> None:
    """The registers, shared memory and spills that ptxas -v reported."""
    log = Path(lib).with_suffix(".so.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "spill" in line or "Used" in line:
                print(f"build: {name} ptxas: {line.strip()}")


def _log10_mel_f64(audio, n_mels):
    """The plain version's steps in float64 (DFT and filterbank): a yardstick
    of accuracy for K1 and for the plain version."""
    import torch
    import torch.nn.functional as F

    from enhance_cb_whisper_tpu_torch.ops.mel import mel_filter_bank

    x = F.pad(audio.double()[:, None], (200, 200), mode="reflect")[:, 0]
    frames = x.unfold(-1, 400, 160)[:, :-1]
    n = torch.arange(400, dtype=torch.float64, device=audio.device)
    angle = -2.0 * torch.pi * torch.outer(n, n[:201]) / 400
    window = (0.5 * (1.0 - torch.cos(2.0 * torch.pi * n / 400)))[:, None]
    re, im = frames @ (torch.cos(angle) * window), frames @ (torch.sin(angle) * window)
    fb = torch.from_numpy(mel_filter_bank(n_mels)).to(audio.device, torch.float64)
    return torch.log10(torch.clamp_min((re * re + im * im) @ fb, 1e-10)).transpose(-1, -2)


def phase_a(device) -> float:
    import torch

    from enhance_cb_whisper_tpu_torch.ops import mel_cuda
    from enhance_cb_whisper_tpu_torch.ops.mel import apply_dynamic_range, log10_mel_plain

    rng = np.random.default_rng(SEED)
    worst = 0.0
    # 3000 and 3700 frames a row; 31 frames, fewer than a tile; 3 frames,
    # both reflected edges in one tile; the 47.5 s utterance of phase B
    # (4750 frames), and phase J3's batch and one 30 s segment at 80 and at
    # whisper-large-v3's 128 mels
    cases = [(shape, (80, 128)) for shape in ((4, 480000), (2, 592000), (3, 4960), (1, 480))]
    cases.append(((1, int(16000 * LONGFORM_SECONDS)), (80,)))
    cases.append(((J_BATCH, 480000), (80, 128)))  # phase J3's step: 16 utterances of 30 s
    cases.append(((1, 480000), (80, 128)))
    for (batch, n_samples), mel_counts in cases:
        audio = torch.from_numpy(_audio(batch, n_samples, rng)).to(device)
        for n_mels in mel_counts:
            got = apply_dynamic_range(mel_cuda.log10_mel(audio, n_mels))
            torch.cuda.synchronize()
            want = apply_dynamic_range(log10_mel_plain(audio, n_mels))
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError("mel kernel produced non-finite values")
            max_abs, max_rel, ok = _close(got, want)
            worst = max(worst, max_abs)
            exact = apply_dynamic_range(_log10_mel_f64(audio, n_mels))
            print(f"phase A: mel kernel vs plain [{batch}, {n_samples}] n_mels={n_mels}: "
                  f"max_abs_err={max_abs!r} max_rel_err={max_rel!r} "
                  f"(rtol {RTOL}, atol {ATOL}) {'ok' if ok else 'FAIL'}; max |err| against "
                  f"float64: kernel {(got.double() - exact).abs().max().item()!r}, "
                  f"plain {(want.double() - exact).abs().max().item()!r}")
            if not ok:
                raise RuntimeError("mel kernel disagrees with its plain version")
    return worst


def phase_a_features(device) -> None:
    """``prepare_features`` on the card at 80 and 128 mels: its features
    equal K1 and the epilogue run on the caller's stream, bit for bit; each
    call records one device-timed ``ecw.audio.features`` span with its bins,
    samples and one K1 launch.  Then 16 segments' features made while
    another thread keeps the card busy on the default stream (as a serving
    worker does): each equals its quiet twin, so the caller's stream is
    ordered after the features' own; their spans' device times stay near the
    quiet ones.  For scale, the pageable copy of one 30 s clip to the card
    alone (CUDA events on a stream of its own)."""

    import torch

    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
    from enhance_cb_whisper_tpu_torch.ops import mel_cuda
    from enhance_cb_whisper_tpu_torch.ops.mel import apply_dynamic_range
    from enhance_cb_whisper_tpu_torch.runtime import profiler

    rng = np.random.default_rng(SEED + 5)
    clips = [_audio(1, 16000 * 20, rng)[0] for _ in range(16)]

    def quiet(clip, n_mels):
        padded = np.zeros((480000,), np.float32)
        padded[: clip.size] = clip
        return apply_dynamic_range(mel_cuda.log10_mel(torch.from_numpy(padded[None]).to(device), n_mels))

    def features_spans():
        return [s for s in profiler.spans() if s["name"] == "ecw.audio.features"]

    for n_mels in (80, 128):
        profiler.reset()
        for clip in clips[:4]:
            got, _ = prepare_features(clip, n_mels=n_mels, device=device)
            if not torch.equal(got, quiet(clip, n_mels)):
                raise RuntimeError(f"prepare_features at {n_mels} mels differs from K1 on the caller's stream")
        spans = features_spans()
        attrs = {(s["attrs"]["n_mels"], s["attrs"]["samples"], s["attrs"]["launches"]) for s in spans}
        ms = [s["device_ms"] for s in spans]
        if len(spans) != 4 or attrs != {(n_mels, 480000, 1)} or not all(m is not None and m > 0 for m in ms):
            raise RuntimeError(f"ecw.audio.features spans at {n_mels} mels: {spans}")
        print(f"phase A: prepare_features at {n_mels} mels equals K1 on the caller's stream; "
              f"ecw.audio.features attrs {sorted(attrs)}, device_ms {ms!r}")

    want = [quiet(clip, 128) for clip in clips]
    busy = torch.randn(4096, 4096, device=device)
    stop = threading.Event()

    def worker():
        torch.cuda.set_device(device)
        while not stop.is_set():
            for _ in range(8):
                busy.matmul(busy)
            torch.cuda.synchronize(device)

    thread = threading.Thread(target=worker, daemon=True)
    profiler.reset()
    thread.start()
    try:
        t0 = time.perf_counter()
        made = [prepare_features(clip, n_mels=128, device=device)[0] for clip in clips]
        host_ms = (time.perf_counter() - t0) / len(clips) * 1e3
        sums = [m.sum() for m in made]  # read on the caller's stream at once
        torch.cuda.synchronize(device)
    finally:
        stop.set()
        thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("the busy thread did not stop")
    for m, w, total in zip(made, want, sums):
        if not torch.equal(m, w) or float(total) != float(w.sum()):
            raise RuntimeError("features made beside a busy stream differ from their quiet twins")
    ms = sorted(s["device_ms"] for s in features_spans())
    padded = torch.from_numpy(np.zeros((1, 480000), np.float32))
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        copy_ms = _median_ms(lambda: padded.to(device))
    print(f"phase A: 16 features beside a busy stream equal their quiet twins; ecw.audio.features "
          f"device_ms median {statistics.median(ms)!r} (min {ms[0]!r}, max {ms[-1]!r}), host "
          f"{host_ms!r} ms a call; the pageable copy of [1, 480000] f32 alone {copy_ms!r} ms "
          f"[CUDA events, median of 25]")


def k2_launch_shapes(cfg, size=KWS_SIZE, batch=CHUNK):
    """(M, K, N, residual) of every K2 launch of one int8 ResNet forward
    over ``batch`` maps with ``S8_STAGES`` on the kernel (models/quant.py):
    each bottleneck's layer_0 reduce at its input resolution, and the fused
    tail of each block without a shortcut whose next block is on K2 too."""
    def conv(n, k, s):
        return (n + 2 * (k // 2) - k) // s + 1

    h, w = conv(size[0], 7, 2), conv(size[1], 7, 2)  # stem
    h, w = conv(h, 3, 2), conv(w, 3, 2)  # max-pool 3x3 stride 2 pad 1
    plan, in_ch = [], cfg.embedding_size
    for stage, (width, depth) in enumerate(zip(cfg.hidden_sizes, cfg.depths)):
        for block in range(depth):
            stride = (2 if stage > 0 or cfg.downsample_in_first_stage else 1) if block == 0 else 1
            plan.append((f"stage_{stage}", in_ch, width, stride, h, w))
            h, w = conv(h, 3, stride), conv(w, 3, stride)
            in_ch = width
    shapes = []
    for i, (stage, c_in, width, stride, h, w) in enumerate(plan):
        if stage not in S8_STAGES:
            continue
        shapes.append((batch * h * w, c_in, width // 4, False))
        shortcut = c_in != width or stride != 1
        if not shortcut and i + 1 < len(plan) and plan[i + 1][0] in S8_STAGES:
            shapes.append((batch * h * w, width // 4, width, True))
    return shapes


def _k2_inputs(rng, m, k, n, residual, device):
    """K2's operands with the JAX package's test distributions; ``residual``
    is False, "vector" (res_scale [N]) or "scalar" (a 0-d res_scale, as the
    int8 scorer passes it)."""
    import torch

    def put(a):
        return torch.from_numpy(a).to(device)

    # drawn as int8 directly: paper 2's shapes reach 182 MB an operand
    x = put(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w_nk = put(rng.integers(-127, 128, (n, k), dtype=np.int8))
    scale = put((rng.uniform(0.5, 2.0, n) * 1e-4).astype(np.float32))
    bias = put(rng.normal(0, 0.5, n).astype(np.float32))
    res = {}
    if residual:
        res = dict(residual=put(rng.integers(-127, 128, (m, n), dtype=np.int8)),
                   res_scale=put((rng.uniform(0.5, 2.0, n) * 1e-3).astype(np.float32)))
        if residual == "scalar":
            res["res_scale"] = res["res_scale"][0].clone()
    return x, w_nk.t(), scale, bias, res


# ragged M, one per kind of launch plan: BM = 64; BM = 128; K split in 2; M = 1 with K split in 8
K2_RAGGED = [(14293, 512, 128), (3761, 256, 1024), (961, 2048, 512), (1, 2048, 512)]


def _plan_text(m, k, n) -> str:
    from enhance_cb_whisper_tpu_torch.ops.matmul_s8_cuda import launch_plan

    p = launch_plan(m, k, n)
    return f"tile {p.bm}x128, split {p.split}, {p.ctas} CTAs"


def phase_a2(device, shapes, what=f"chunk of {CHUNK} maps at {KWS_SIZE}", ragged=K2_RAGGED):
    """K2 against its plain version at ``shapes`` (the launches of one
    ``what``) and the ``ragged`` M; returns (differing codes, max |code diff|)."""
    import torch

    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda
    from enhance_cb_whisper_tpu_torch.ops.matmul_s8 import matmul_s8_requant_plain
    from enhance_cb_whisper_tpu_torch.ops.matmul_s8_cuda import launch_plan

    rng = np.random.default_rng(SEED + 4)
    distinct = sorted({(m, k, n) for m, k, n, _ in shapes}) + list(ragged)
    print(f"phase A2: {len(shapes)} K2 launches per {what}, "
          f"{len(distinct) - len(ragged)} distinct shapes, plus {len(ragged)} ragged M")
    total, worst = 0, 0
    for m, k, n in distinct:
        counts = []
        for residual in (False, "vector", "scalar"):
            x, w, scale, bias, res = _k2_inputs(rng, m, k, n, residual, device)
            for relu in (True, False):
                got = matmul_s8_cuda.matmul_s8_requant(x, w, scale, bias, relu=relu, **res)
                torch.cuda.synchronize()
                want = matmul_s8_requant_plain(x, w, scale, bias, relu=relu, **res)
                diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
                counts.append(int((diff > 0).sum()))
                worst = max(worst, int(diff.max()))
                if len(torch.unique(got)) < 10:
                    raise RuntimeError(f"K2 codes at {(m, k, n)} are degenerate")
            if launch_plan(m, k, n).split > 1:  # split-K sums in a fixed order: same bytes
                again = matmul_s8_cuda.matmul_s8_requant(x, w, scale, bias, relu=False, **res)
                first = matmul_s8_cuda.matmul_s8_requant(x, w, scale, bias, relu=False, **res)
                if not torch.equal(again, first):
                    raise RuntimeError(f"K2 at {(m, k, n)} differs between two launches")
        total += sum(counts)
        print(f"phase A2: K2 vs plain (M, K, N)={(m, k, n)} [{_plan_text(m, k, n)}]: differing codes "
              f"{counts} of {m * n} each (residual off, res_scale [N], 0-d res_scale x relu on/off)"
              + ("; two launches identical" if launch_plan(m, k, n).split > 1 else ""))
    if total:
        raise RuntimeError(f"K2 disagrees with its plain version in {total} codes")
    return total, worst

K3_CASES = (  # label, N, L, T_k, T_u, U, catalog dtype, proxy dtype, masks ("ones", "partial", None)
    ("cascade-100k LEF", 100352, 3, 75, 750, 64, "bfloat16", "bfloat16", "ones"),
    ("LE", 3000, 3, 150, 1500, 64, "float32", "bfloat16", "partial"),
    ("L", 1000, 3, 150, 1500, 1024, "float32", "bfloat16", "partial"),
    ("ragged LEF, fp16 products", 1001, 3, 75, 750, 64, "bfloat16", "float16", "partial"),
    ("ragged fp16 catalog, T_u 700", 777, 2, 75, 700, 64, "float16", "float16", "partial"),
    ("ragged f32 catalog, no masks", 333, 2, 40, 260, 128, "float32", "bfloat16", None),
    ("the dry run's U 8", 64, 2, 16, 32, 8, "float32", "bfloat16", "ones"),
    ("U 96, ragged", 300, 2, 20, 300, 96, "bfloat16", "bfloat16", "partial"),
)
K3_TIMED = ("cascade-100k LEF", "L")
K3_ATOL = 1e-4


def phase_a3(device) -> dict:
    """K3 (csrc/maxsim.cu) against the plain version (``maxsim_proxy_fast_plain``
    over chunks of 128 rows, the cascade's stage 1 before K3) on the card at
    each of ``K3_CASES``: max |kernel - plain| <= 1e-4 (only the order of
    the f32 sums differs: in the products, and in the sum of squares, which
    can flip one operand's bf16 rounding), NaN where the plain version has
    NaN, two launches a call.  At ``K3_TIMED`` it prints the kernel's device
    time (CUDA events) beside its bound (the products at the bf16 peak or
    the catalog's bytes at the HBM rate) and the chunked plain path's time,
    which the port no longer calls."""
    import torch

    from enhance_cb_whisper_tpu_torch.efficient_kws import catalog as cat
    from enhance_cb_whisper_tpu_torch.efficient_kws.model import _safe_normalize
    from enhance_cb_whisper_tpu_torch.ops import maxsim_cuda

    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    worst, timed = 0.0, {}
    for label, n, layers, tk, tu, units, kdtype, pdtype, masks in K3_CASES:
        kdtype, pdtype = getattr(torch, kdtype), getattr(torch, pdtype)
        kwd = torch.randn((n, layers, tk, units), generator=gen, device=device)
        utt = torch.randn((1, layers, tu, units), generator=gen, device=device)
        kwd_mask = utt_mask = None
        if masks == "ones":
            kwd_mask = torch.ones((n, layers, tk), device=device, dtype=kdtype)
            utt_mask = torch.ones((1, layers, tu), device=device)
        elif masks == "partial":
            kwd_mask = (torch.rand((n, layers, tk), generator=gen, device=device) > 0.3).float()
            kwd_mask[::9] = 0.0  # keywords with no valid frame
            kwd = kwd * kwd_mask[..., None]  # padded frames are zero, as project_catalog pads
            kwd_mask = kwd_mask.to(kdtype)
            utt_mask = (torch.rand((1, layers, tu), generator=gen, device=device) > 0.2).float()
            utt_mask[:, :, -(tu // 5):] = 0.0
        kwd = kwd.to(kdtype)
        utt_n = _safe_normalize(utt, 1e-6)[0]
        before = maxsim_cuda.kernel.launches
        got = cat.maxsim_proxy_fast(kwd, utt_n, kwd_mask, utt_mask, pdtype)
        torch.cuda.synchronize()
        if maxsim_cuda.kernel.launches - before != maxsim_cuda.LAUNCHES_PER_CALL:
            raise RuntimeError(f"phase A3 {label}: {maxsim_cuda.kernel.launches - before} launches, expected "
                               f"{maxsim_cuda.LAUNCHES_PER_CALL}")

        def plain():
            return torch.cat([cat.maxsim_proxy_fast_plain(
                kwd[i:i + 128], utt_n, None if kwd_mask is None else kwd_mask[i:i + 128], utt_mask, pdtype)
                for i in range(0, n, 128)])

        want = plain()
        nan = torch.isnan(want)
        if got.shape != (n,) or not torch.equal(torch.isnan(got), nan):
            raise RuntimeError(f"phase A3 {label}: shape {tuple(got.shape)} or NaN rows differ from the plain version")
        gap = float((got - want)[~nan].abs().max())
        worst = max(worst, gap)
        plan = maxsim_cuda.launch_plan(n, layers, tk, tu, units)
        print(f"phase A3: K3 {label} N={n} L={layers} T_k={tk} T_u={tu} U={units} {kdtype} -> {pdtype} "
              f"masks={masks} [BM {plan.bm}, {plan.stages} stages, {plan.blocks} blocks, {plan.smem} B smem]: "
              f"max |kernel - plain| {gap!r} (NaN rows {int(nan.sum())}), proxy range "
              f"[{float(want[~nan].min())!r}, {float(want[~nan].max())!r}]")
        if not gap <= K3_ATOL:
            raise RuntimeError(f"phase A3 {label}: K3 differs from the plain version by {gap!r} > {K3_ATOL}")
        if label in K3_TIMED:
            fn = lambda: cat.maxsim_proxy_fast(kwd, utt_n, kwd_mask, utt_mask, pdtype)  # noqa: E731
            ms, plain_ms = _event_ms(fn, reps=9), _event_ms(plain, reps=3)
            ops = 2 * n * layers * tk * tu * units
            bytes_ = kwd.numel() * kwd.element_size() + 4 * n + (
                0 if kwd_mask is None else kwd_mask.numel() * kwd_mask.element_size())
            bound = max(ops / BF16_RATE, bytes_ / HBM_RATE) * 1e3
            print(f"phase A3: K3 {label}: device {ms!r} ms (CUDA events, median of 9), bound {bound!r} ms "
                  f"({ops:.4g} FLOP at {BF16_RATE / 1e12:.0f} TFLOP/s, {bytes_} B at {HBM_RATE / 1e12} TB/s), "
                  f"{ms / bound!r}x the bound ({ops / ms / 1e9!r} TFLOP/s); the chunked plain path "
                  f"{plain_ms!r} ms ({plain_ms / ms!r}x K3)")
            timed[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound}
        del kwd, utt, kwd_mask, utt_mask, want, got
        torch.cuda.empty_cache()
    print(f"phase A3: K3 = plain within {K3_ATOL} at {len(K3_CASES)} shapes (largest gap {worst!r})")
    return {"max_abs_err": worst, **timed[K3_TIMED[0]]}


# the serve cells' beam caches: 16 slots x beam 5 over max_target_positions
# 244, whisper-medium's 16 heads and whisper-large-v3's 20, positions
# 124-243 written over a launch's 120 steps (and other beam counts)
K4_ITEMS, K4_MAX_LEN = 16, 244
K4_CASES = (  # label, beams, heads, head size, length, dtype, map ("uniform": any row anywhere; "beam": re-parented)
    ("medium, first step", 5, 16, 64, 124, "float32", "uniform"),
    ("medium, mid launch", 5, 16, 64, 184, "float32", "uniform"),
    ("medium, last step", 5, 16, 64, 243, "float32", "uniform"),
    ("medium, mid launch, beam map", 5, 16, 64, 184, "float32", "beam"),
    ("v3, first step", 5, 20, 64, 124, "float32", "uniform"),
    ("v3, mid launch", 5, 20, 64, 184, "float32", "uniform"),
    ("v3, last step", 5, 20, 64, 243, "float32", "uniform"),
    ("v3, mid launch, beam map", 5, 20, 64, 184, "float32", "beam"),
    ("medium bf16, mid launch", 5, 16, 64, 184, "bfloat16", "uniform"),
    ("v3 bf16, last step", 5, 20, 64, 243, "bfloat16", "beam"),
    ("medium, 3 beams", 3, 16, 64, 150, "float32", "uniform"),
    ("medium, 8 beams, bf16", 8, 16, 64, 200, "bfloat16", "beam"),
    ("the tiny models' head size 16", 5, 4, 16, 37, "float32", "beam"),
    ("head size 32, 4 beams, bf16", 4, 2, 32, 61, "bfloat16", "uniform"),
    ("medium, 9 beams", 9, 16, 64, 184, "float32", "beam"),
    ("head size 16, 17 beams, bf16", 17, 4, 16, 37, "bfloat16", "uniform"),
)
K4_TIMED = ("medium, mid launch", "v3, mid launch")
# f32: only the order of the f32 sums differs (64-term dots, the softmax's
# sum, a weighted sum over <= 243 positions): ~1e-7 of the output's scale,
# held at 2e-6 of it.  bf16: both sides round each probability and the
# output to bf16, and a last-bit difference in an f32 probability can move
# its rounding by one bf16 step: two bf16 steps (2^-7) of the output's scale.
K4_TOL = {"float32": 2e-6, "bfloat16": 2.0**-7}


def _k4_inputs(gen, beams, heads, head_dim, length, dtype, kind, device):
    """q, the two slabs (this step's token written at ``length - 1``), the
    map and the self-attention mask of a serve cell's beam step: prompts
    of 4-8 leading tokens then 0-24 pads (the fixed-width layout), the
    rest attended."""
    import torch

    rows = K4_ITEMS * beams
    q = (torch.randn((rows, 1, heads, head_dim), generator=gen, device=device) * head_dim**-0.5 * 2).to(dtype)
    slabs = [torch.randn((rows, K4_MAX_LEN, heads, head_dim), generator=gen, device=device).to(dtype)
             for _ in range(2)]
    ident = torch.arange(beams, dtype=torch.int32, device=device)[None, :, None]
    anc = ident.expand(K4_ITEMS, beams, K4_MAX_LEN).contiguous()
    if kind == "uniform":
        anc[:, :, :length - 1] = torch.randint(0, beams, (K4_ITEMS, beams, length - 1), generator=gen,
                                               device=device, dtype=torch.int32)
    else:  # the beam step's own re-parenting from the first written position on
        from enhance_cb_whisper_tpu_torch.decoding.beam import _reparent

        for cur_len in range(9, length):  # after a 8-token prompt
            _reparent(anc, torch.randint(0, beams, (K4_ITEMS, beams), generator=gen, device=device), cur_len)
    mask = torch.ones((K4_ITEMS, K4_MAX_LEN), dtype=torch.int64, device=device)
    lead = torch.randint(4, 9, (K4_ITEMS,), generator=gen, device=device).tolist()
    pads = torch.randint(0, 25, (K4_ITEMS,), generator=gen, device=device).tolist()
    for i, (a, n) in enumerate(zip(lead, pads)):
        mask[i, a:a + n] = 0
    return q, slabs[0], slabs[1], anc, mask.repeat_interleave(beams, dim=0)


def phase_a4(device) -> dict:
    """K4 (csrc/beam_attention.cu) against its plain version (the rows
    gathered by the map, then the decoder's ``_attention``) on the card at
    each of ``K4_CASES``, the serve cells' beam caches: max |kernel - plain|
    within ``K4_TOL`` of the output's scale, one launch a call.  At
    ``K4_TIMED`` and at each case it prints the kernel's device time
    (CUDA-graph replays) beside its bound (every row's written prefix of K
    and V read once at the HBM rate; the FLOPs are 2 per 4 bytes), the
    bytes a map's referenced rows need, the plain version's time and the
    wrapper's host time per call."""
    import torch

    from enhance_cb_whisper_tpu_torch.ops import beam_attention as ba

    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    timed = {}
    for label, beams, heads, head_dim, length, dtype_name, kind in K4_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, anc, mask = _k4_inputs(gen, beams, heads, head_dim, length, dtype, kind, device)
        before = ba.kernel.launches
        got = ba.ancestry_attention(q, k, v, anc, mask, length)
        torch.cuda.synchronize()
        if ba.kernel.launches - before != 1:
            raise RuntimeError(f"phase A4 {label}: {ba.kernel.launches - before} launches, expected 1")
        want = ba.ancestry_attention_plain(q, k, v, anc, mask, length)
        scale = float(want.float().abs().max())
        gap = float((got.float() - want.float()).abs().max())
        elem = q.element_size()
        rows = K4_ITEMS * beams
        vec = heads * head_dim * elem  # one position of one row, all heads
        bytes_ = 2 * rows * length * vec + 2 * q.numel() * elem + anc[:, :, :length].numel() * 4 \
            + rows * length * 8
        # the rows some beam points at, per position: what the kernel reads
        used = int(torch.nn.functional.one_hot(anc[:, :, :length].long(), beams).amax(1).sum())
        needed = 2 * used * vec
        bound = bytes_ / HBM_RATE * 1e3
        ms = _graph_ms(lambda: ba.ancestry_attention(q, k, v, anc, mask, length))
        plain_ms = _graph_ms(lambda: ba.ancestry_attention_plain(q, k, v, anc, mask, length), calls=3, reps=5)
        host = _host_ms(lambda: ba.ancestry_attention(q, k, v, anc, mask, length))
        print(f"phase A4: K4 {label}: map [{K4_ITEMS}, {beams}, {K4_MAX_LEN}] ({kind}), H {heads}, "
              f"Dh {head_dim}, length {length}, {dtype_name}: max |kernel - plain| {gap!r} (output scale "
              f"{scale!r}, tolerance {K4_TOL[dtype_name] * scale!r}); device {ms!r} ms (CUDA-graph replays), "
              f"bound {bound!r} ms ({bytes_} B at {HBM_RATE / 1e12} TB/s), {ms / bound!r}x the bound; the "
              f"referenced rows' K and V {needed} B ({needed / ms / 1e6!r} GB/s); plain {plain_ms!r} ms "
              f"({plain_ms / ms!r}x K4); host {host!r} ms a call")
        if not gap <= K4_TOL[dtype_name] * scale:
            raise RuntimeError(f"phase A4 {label}: K4 differs from the plain version by {gap!r}")
        if label in K4_TIMED:
            timed[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "max_abs_err": gap}
        del q, k, v, anc, mask, got, want
        torch.cuda.empty_cache()
    print(f"phase A4: K4 = plain within its tolerance at {len(K4_CASES)} shapes")
    return timed


def phase_a4_beams(device) -> None:
    """More beams than a K4 block takes: the tiny CB-Whisper of phase B
    decodes at 9 beams on the CPU and on the card, where K4 takes each beam
    step in groups of 8.  Identical keywords and token sequences (every
    token, timestamps included), and K4 launched."""
    import dataclasses

    from enhance_cb_whisper_tpu_torch.ops import beam_attention as ba

    beams = 9

    def make(dev):
        cb = _tiny_pipeline(dev)
        cb.opts = dataclasses.replace(cb.opts, num_beams=beams)
        cb.decode_fn = lambda toks: " ".join(str(int(t)) for t in toks)
        return cb

    rng = np.random.default_rng(SEED + 1)
    waves = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in (6.0, 21.0)]
    before = ba.kernel.launches
    cpu, gpu, _ = _tiny_runs(device, waves, make, int8=False)
    launched = ba.kernel.launches - before
    print(f"phase A4: {beams} beams, tiny CB-Whisper, cpu vs cuda: keywords {gpu[0]}, token sequences equal "
          f"{cpu[1] == gpu[1]} ({[len(p.split()) for p in gpu[1]]} tokens); K4 launches {launched}")
    if cpu != gpu:
        raise RuntimeError(f"phase A4 at {beams} beams: the card's tokens differ from the CPU's: {gpu} vs {cpu}")
    if not launched:
        raise RuntimeError(f"phase A4 at {beams} beams: K4 never launched")


def _k4_mark():
    """Start counting K4's main path: the profiler's ring emptied, the
    launches so far."""
    from enhance_cb_whisper_tpu_torch.ops import beam_attention
    from enhance_cb_whisper_tpu_torch.runtime import profiler

    profiler.reset()
    return time.perf_counter(), beam_attention.kernel.launches


def _check_k4_main_path(label, mark, layers: int) -> int:
    """Since ``mark``: K4 launched once per decoder layer of every beam
    step, and every beam step's span reads ``reorder_bytes`` 0 and
    ``anc_layers`` = the decoder's layers.  Returns the launches."""
    from enhance_cb_whisper_tpu_torch.ops import beam_attention
    from enhance_cb_whisper_tpu_torch.runtime import profiler

    since, before = mark
    launches = beam_attention.kernel.launches - before
    steps = [s["attrs"] for s in profiler.spans(since_s=since)
             if s["name"] == "ecw.decode.step" and "reorder_bytes" in s["attrs"]]
    off = [a for a in steps if a["reorder_bytes"] != 0 or a["anc_layers"] != layers]
    print(f"{label}: K4 launches {launches} = {layers} decoder layers x {len(steps)} beam steps expected "
          f"{layers * len(steps)}; reorder_bytes 0 and anc_layers {layers} on every beam step: {not off} "
          f"(spans dropped {profiler.dropped()})")
    if not steps or off or launches != layers * len(steps) or profiler.dropped():
        raise RuntimeError(f"{label}: the beam steps did not all read through the map with K4")
    return launches


@contextlib.contextmanager
def _recorded_k2_shapes():
    """Records (M, K, N, residual) of every K2 wrapper call made inside the
    block; the real wrapper still runs and counts its launch."""
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda

    real, seen = matmul_s8_cuda.matmul_s8_requant, set()

    def recorded(x, w, scale, bias, **kwargs):
        seen.add((int(x.shape[0]), int(x.shape[1]), int(w.shape[1]), kwargs.get("residual") is not None))
        return real(x, w, scale, bias, **kwargs)

    matmul_s8_cuda.matmul_s8_requant = recorded
    try:
        yield seen
    finally:
        matmul_s8_cuda.matmul_s8_requant = real


def _check_k2_main_path(label, launches, shapes, chunks: int, what: str) -> None:
    """K2 launched exactly ``len(shapes)`` times per chunk over the main
    path's run, and at exactly the shapes phase A2 held against the plain
    version."""
    expected = len(shapes) * chunks
    print(f"{label}: K2 launches {launches['k2']} = {len(shapes)} per chunk x {what} expected "
          f"{expected}; {len(launches['k2_shapes'])} distinct launch shapes, all checked in phase A2: "
          f"{launches['k2_shapes'] == set(shapes)}")
    if launches["k2"] != expected:
        raise RuntimeError(f"{label}: K2 launched {launches['k2']} times, expected {expected}")
    if launches["k2_shapes"] != set(shapes):
        raise RuntimeError(f"{label}: K2 launch shapes {sorted(launches['k2_shapes'])} differ from "
                           f"those phase A2 checked {sorted(set(shapes))}")


def _unzero_residual_bn(kws, value: float = 0.2) -> None:
    """``init_kws_model`` zeroes the last BatchNorm of each residual branch,
    so its folded int8 weights would be all zero and K2's fused tails would
    compute nothing; give those BNs a nonzero scale."""
    import torch

    last = "layer_2.normalization" if kws.config.layer_type == "bottleneck" else "layer_1.normalization"
    with torch.no_grad():
        for name, module in kws.named_modules():
            if name.endswith(last):
                module.weight.fill_(value)


def _tiny_pipeline(device, resnet=None, class1_shift: float = 0.0, whisper_params=None,
                   separate_encoder: bool = False, **levers):
    """A tiny random CB-Whisper (the CPU tests' dims) on ``device``; a given
    ``resnet`` gets nonzero residual-branch BNs (for the int8 path) and its
    class-1 bias lowered by ``class1_shift``; ``whisper_params`` (numpy, the
    JAX layout) replace the seed's Whisper weights; ``separate_encoder``
    gives it a copy of them as a separate KWS encoder; ``levers`` are the
    generator's serving levers."""
    import torch

    from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog
    from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
    from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions
    from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper, CBWhisperConfig
    from enhance_cb_whisper_tpu_torch.models.kws import init_kws_model
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, init_whisper_params

    cfg = WhisperConfig(
        vocab_size=128, num_mel_bins=80, d_model=64, encoder_layers=3, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=1500, max_target_positions=40,
    )
    rng = np.random.default_rng(SEED)
    numpy_params = init_whisper_params(rng, cfg)
    if whisper_params is not None:
        numpy_params = whisper_params
    params = from_jax_whisper_params(numpy_params, device)
    if separate_encoder:
        levers = dict(levers, encoder_params=from_jax_whisper_params(numpy_params, device), encoder_config=cfg)
    keywords = [f"kw{i}" for i in range(6)]
    stacks = _stacks(rng, len(keywords), 2, lambda i: int(rng.integers(3, 12)), 64)
    if resnet is None:
        kws = init_kws_model(
            ResNetConfig(num_channels=2, embedding_size=8, hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1)),
            torch.Generator().manual_seed(SEED))
    else:
        kws = init_kws_model(resnet, torch.Generator().manual_seed(SEED))
        _unzero_residual_bn(kws)
        with torch.no_grad():
            kws.model.classifier.bias[1] -= class1_shift
    opts = GenerationOptions(
        decoder_start_token_id=3, language_token_id=10, task_token_id=11, no_timestamps_token_id=100,
        prev_sot_token_id=99, eos_token_id=2, pad_token_id=0, max_initial_timestamp_index=10,
        num_beams=5, return_timestamps=True, condition_on_prev_tokens=True, max_target_positions=40,
    )
    return CBWhisper(
        config=CBWhisperConfig(kws_features_size=(32, 48)), whisper_config=cfg, whisper_params=params,
        kws_model=kws, catalog=KeywordCatalog.from_arrays(keywords, stacks), generation_options=opts,
        prompt_ids_fn=lambda text: [99] + [10 + (ord(c) % 50) for c in text][:6],
        decode_fn=lambda toks: " ".join(f"w{t}" for t in toks if 4 < t < 99),
        kws_layer_slice=(1, 3), device=device, **levers,
    )


def _tiny_runs(device, waves, make, int8: bool):
    """(spotted keywords, transcripts) per device, and K2 launches on the card."""
    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda

    results, launches = {}, 0
    for dev in ("cpu", device):
        cb = make(dev)
        if int8:
            cb.enable_int8_spotting(calibration_batches=1, s8_1x1=("stage_1",))
        matmul_s8_cuda.kernel.launches = 0
        spotted, preds = [], []
        for wav in waves:
            features, _ = prepare_features(wav, n_mels=80, device=dev)
            spotted.append(cb.spot_keywords(features))
            preds.append(cb.forward(features))
        launches = matmul_s8_cuda.kernel.launches
        results[str(dev)] = (spotted, preds)
    return results["cpu"], results[str(device)], launches


def phase_b_reference(device) -> None:
    """CUDA path (kernels, cuBLAS/cuDNN fp32) vs the CPU path (plain
    versions) of the same tiny model: identical keywords and transcripts,
    with the fp32 scorer and with the int8 one on a K2-eligible ResNet."""
    rng = np.random.default_rng(SEED + 1)
    waves = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in (6.0, 21.0)]
    cpu, gpu, _ = _tiny_runs(device, waves, _tiny_pipeline, int8=False)
    print(f"phase B reference: tiny model cpu vs cuda keywords={gpu[0]} transcripts equal={cpu[1] == gpu[1]}")
    if cpu != gpu:
        raise RuntimeError(f"CUDA path disagrees with the CPU path: {gpu} vs {cpu}")

    k2_tiny, shift, gap_width = _k2_tiny_resnet(waves)
    cpu, gpu, launches = _tiny_runs(
        device, waves, lambda dev: _tiny_pipeline(dev, k2_tiny, class1_shift=shift), int8=True)
    print(f"phase B reference int8: tiny model (K2-eligible ResNet, s8_1x1=stage_1) cpu vs cuda "
          f"keywords={gpu[0]} transcripts equal={cpu[1] == gpu[1]}; class-1 shift {shift!r} in a "
          f"margin gap of {gap_width!r}; K2 launches on the card {launches}")
    if cpu != gpu:
        raise RuntimeError(f"int8 CUDA path disagrees with the CPU path: {gpu} vs {cpu}")
    if launches <= 0:
        raise RuntimeError("the int8 CUDA path never launched K2")


def _k2_tiny_resnet(waves):
    """A tiny ResNet whose stage_1 widths are 128-multiples, so its 1x1
    convs take K2, and the class-1 shift that puts its threshold in the
    widest gap between the tiny model's fp32 margins over ``waves`` (on
    the CPU): a random head decides all keywords alike otherwise.  Returns
    (config, shift, the gap's width)."""
    import torch

    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.models.whisper import encoder_kws_stack

    k2_tiny = ResNetConfig(num_channels=2, embedding_size=32, hidden_sizes=(128, 512), depths=(1, 3))
    cb = _tiny_pipeline("cpu", k2_tiny)
    cb._ensure_catalog()
    margins = []
    with torch.no_grad():
        for wav in waves:
            stack = encoder_kws_stack(cb.encoder_params, prepare_features(wav, device="cpu")[0],
                                      cb.encoder_config, layer_slice=cb.kws_layer_slice)
            _, logits = cb._score_fn(cb._catalog_dev, stack[0], cb._utt_w)
            margins.extend((logits[:6, 1] - logits[:6, 0]).tolist())
    m = np.sort(margins)
    inner = range(len(m) // 4, len(m) - len(m) // 4)
    gap = max(inner, key=lambda i: m[i + 1] - m[i])
    return k2_tiny, float(m[gap] + m[gap + 1]) / 2, float(m[gap + 1] - m[gap])


def check_tf32_off(device) -> None:
    """Building CBWhisper on the card turns TF32 off (the reference runs
    full FP32), whatever the caller had set."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    _tiny_pipeline(device)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"phase B: TF32 allowed (cuBLAS, cuDNN) after building CBWhisper on the card: {flags}")
    if flags != (False, False):
        raise RuntimeError("CBWhisper on the card left TF32 on")


def _seekable_tiny_params(cfg):
    """The tiny model's weights (numpy seed) with a decoder that leaves its
    windows: channel 0 of the decoder's final LayerNorm pinned to 1 and
    every timestamp row of the (tied) embedding at -50 there, so timestamp
    logits sit 50 below the rest, a window's output is its forced first
    timestamp and text, and the seek moves a whole window (a plain random
    decoder closes a timestamp pair every few tokens and crawls ~0.5 s a
    window)."""
    from enhance_cb_whisper_tpu_torch.models.whisper import init_whisper_params

    params = init_whisper_params(np.random.default_rng(SEED), cfg)
    final_norm = params["decoder"]["layer_norm"]
    final_norm["weight"][0], final_norm["bias"][0] = 0.0, 1.0
    params["decoder"]["embed_tokens"]["weight"][101:, 0] = -50.0  # no_timestamps_token_id 100 + 1
    return params


def phase_b_longform_reference(device) -> None:
    """The longform seek loop of a tiny random Whisper, CPU vs card, on the
    same numpy mel: a 2.5-window utterance at batch 1 and a batch of two of
    unequal lengths, condition-on-prev and timestamps on, a ladder
    (0.0, 0.2, 0.4) whose every rung trips (a logprob threshold of 0) and
    the default CPU-seeded noise on both sides.  Sequences, segments and
    the rungs decoded must be identical.  The decoder leaves its windows
    (:func:`_seekable_tiny_params`)."""
    import dataclasses

    import torch

    from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
    from enhance_cb_whisper_tpu_torch.decoding.generate import WhisperGenerator

    t_start = time.perf_counter()
    tiny = _tiny_pipeline("cpu")
    cfg = tiny.whisper_config
    params = _seekable_tiny_params(cfg)
    # beam-5 at temperature 0; the sampled rungs decode with one beam
    opts = dataclasses.replace(tiny.opts, temperature=(0.0, 0.2, 0.4), logprob_threshold=0.0)
    rng = np.random.default_rng(SEED + 7)
    frames = 7500  # 2.5 windows
    inputs = [(rng.standard_normal((1, cfg.num_mel_bins, frames)).astype(np.float32), None)]
    mask = np.zeros((2, frames), np.int64)
    mask[0] = 1
    mask[1, :4100] = 1
    inputs.append((rng.standard_normal((2, cfg.num_mel_bins, frames)).astype(np.float32), mask))
    for mel, attention_mask in inputs:
        out, decodes = {}, {}
        for dev in ("cpu", device):
            gen = WhisperGenerator(cfg, from_jax_whisper_params(params, dev), device=dev)
            decode, calls = gen._decode_prompted, []

            def counted(*args, _decode=decode, _calls=calls, **kwargs):
                _calls.append(kwargs.get("temperature", 0.0))
                return _decode(*args, **kwargs)

            gen._decode_prompted = counted
            out[str(dev)] = gen.generate(torch.from_numpy(mel).to(dev), opts, attention_mask=attention_mask,
                                         return_segments=True)
            decodes[str(dev)] = calls
        cpu, gpu = out["cpu"], out[str(device)]
        same = np.array_equal(cpu["sequences"], gpu["sequences"]) and cpu["segments"] == gpu["segments"]
        windows = decodes["cpu"].count(0.0)
        print(f"phase B reference longform: tiny model, batch {mel.shape[0]} of {mel.shape[-1]} frames"
              f"{'' if attention_mask is None else ' (true lengths ' + str(attention_mask.sum(-1).tolist()) + ')'}: "
              f"{windows} windows, decodes at temperatures {decodes['cpu']}; segments per row "
              f"{[len(r) for r in gpu['segments']]}, ends {[r[-1]['end'] if r else None for r in gpu['segments']]}; "
              f"cpu vs cuda sequences and segments identical: {same}")
        if not same or decodes["cpu"] != decodes[str(device)]:
            raise RuntimeError("the longform seek loop differs between the CPU and the card")
        if windows < 3 or 0.4 not in decodes["cpu"] or not all(cpu["segments"]):
            raise RuntimeError("the longform reference run did not cross windows or climb the ladder")
    print(f"phase B reference longform: {time.perf_counter() - t_start:.1f} s in all")


def _medium_pipeline(device):
    """whisper-medium + the 12-channel ResNet-50 scorer, random weights."""
    import torch

    from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog
    from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
    from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions
    from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper, CBWhisperConfig
    from enhance_cb_whisper_tpu_torch.models.kws import init_kws_model
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, init_whisper_params

    config = WhisperConfig()  # whisper-medium: 51865 vocab, d 1024, 24+24 layers, 16 heads
    rng = np.random.default_rng(SEED)
    params = from_jax_whisper_params(init_whisper_params(rng, config), device)
    stacks = _stacks(rng, N_KW, 12, lambda i: int(rng.integers(4, 20)), config.d_model)
    keywords = [f"kw{i}" for i in range(N_KW)]
    kws = init_kws_model(ResNetConfig.from_version("resnet-50", num_channels=12),
                         torch.Generator().manual_seed(SEED))
    opts = GenerationOptions(
        num_beams=5, return_timestamps=True, condition_on_prev_tokens=True,
        language_token_id=50259, task_token_id=50359, begin_suppress_tokens=(220, 50257),
        max_target_positions=MEDIUM_DECODE,
    )
    cb = CBWhisper(
        config=CBWhisperConfig(), whisper_config=config, whisper_params=params, kws_model=kws,
        catalog=KeywordCatalog.from_arrays(keywords, stacks),
        generation_options=opts,
        prompt_ids_fn=lambda text: [50361] + [100 + (ord(c) % 1000) for c in text][:8],
        decode_fn=lambda toks: " ".join(map(str, toks)),
        kws_layer_slice=(10, 22), device=device,
    )
    return cb, config, opts, kws, stacks


def _write_wav(path: Path, wav_16k: np.ndarray, rate: int = 44100) -> None:
    """``wav_16k`` as a 16-bit mono WAV at ``rate`` (linear interpolation:
    a recording at another rate that the port must resample)."""
    import wave

    n = int(round(len(wav_16k) * rate / 16000))
    t = np.arange(n) * (16000 / rate)
    pcm = np.clip(np.interp(t, np.arange(len(wav_16k)), wav_16k), -1, 1)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((pcm * 32767).astype("<i2").tobytes())


def _centre_class1(cb, segment) -> None:
    """A random head says "present" for every keyword or for none (keyword
    to keyword, its logit margin varies far less than its offset): centre
    its class-1 bias on the catalog's median margin over one 30 s
    ``segment`` so the spotter passes some keywords and not others."""
    import torch

    from enhance_cb_whisper_tpu_torch.models.whisper import encoder_kws_stack

    cb._ensure_catalog()
    with torch.no_grad():
        stack = encoder_kws_stack(cb.generator.params, segment, cb.whisper_config,
                                  layer_slice=cb.kws_layer_slice)
        _, logits = cb._score_fn(cb._catalog_dev, stack[0], cb._utt_w)
        margin = logits[:N_KW, 1] - logits[:N_KW, 0]
        cb.kws_model.model.classifier.bias[1] -= margin.median()


def _drive_slice(cb, config, opts, dataset, device, label, int8_stages=None):
    """Warm up, then ``run_test`` over ``dataset`` with each stage timed;
    returns per-utterance marks, per-window records of the longform
    utterances, and the launches of each kernel over exactly the
    ``run_test`` call."""
    import torch

    from enhance_cb_whisper_tpu_torch.audio.io import load_audio_16k, prepare_features
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda

    scored, spotted, generated, marks, windows, mel_seconds = [], [], [], [], [], []
    score_to_keywords = cb._score_to_keywords
    encode_and_spot, generate = cb.encode_and_spot, cb.generator.generate
    with_fallback, retrieve_segment = cb.generator._generate_with_fallback, cb.generator._retrieve_segment
    forward = cb.forward

    def mel_fn(item):
        """The CLI's front end: a file goes through load_audio_16k.  In
        run_test it runs in the prefetch thread, ahead of the decode: its
        time is host time (K1 is asynchronous) and overlaps the previous
        utterance's decode."""
        t0 = time.perf_counter()
        wav = load_audio_16k(str(item["path"])) if "path" in item else item["audio"]
        out = prepare_features(wav, n_mels=config.num_mel_bins, device=device)
        mel_seconds.append(time.perf_counter() - t0)
        return out

    warm = cb.generator._pad_segment(mel_fn(dataset[0])[0])
    _centre_class1(cb, warm)
    if int8_stages is not None:
        # calibrate on the warm-up utterance: with the default of 4 and three
        # utterances the int8 scorer would never take over
        cb.enable_int8_spotting(calibration_batches=1, s8_1x1=int8_stages)
    # warm-up utterance (cuBLAS/cuDNN handles and heuristics; int8
    # calibration), not counted
    cb.forward(warm)
    torch.cuda.synchronize()
    if int8_stages is not None and cb._int8_pending:
        raise RuntimeError("int8 spotting did not calibrate on the warm-up utterance")
    mel_seconds.clear()

    def timed_forward(*args, **kwargs):
        marks.append({"start": time.perf_counter(), "spot_s": 0.0, "windows": 0})
        return forward(*args, **kwargs)

    score_fn = cb._score_fn

    def counted_score(catalog_dev, utt_stack, utt_w):
        probs, logits = score_fn(catalog_dev, utt_stack, utt_w)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("catalog scorer produced non-finite logits")
        scored.append(int(logits.shape[0]))
        return probs, logits

    def recorded_keywords(stacks_, real_rows=None):
        out = score_to_keywords(stacks_, real_rows)
        spotted.extend(out)
        return out

    def timed_encode_and_spot(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode_and_spot(*args, **kwargs)
        torch.cuda.synchronize()
        marks[-1]["spot_s"] += time.perf_counter() - t0
        marks[-1]["windows"] += 1
        return out

    def timed_fallback(cross_kv, decoder_ids, *args, **kwargs):
        """One longform window's decode (the ladder's single rung here)."""
        t0 = time.perf_counter()
        seqs, scores, skip = with_fallback(cross_kv, decoder_ids, *args, **kwargs)
        seconds = time.perf_counter() - t0  # host arrays: the decode has finished
        n = int((seqs[:, decoder_ids.shape[1]:] != opts.pad_token_id).sum())
        windows.append({"utterance": len(marks) - 1, "prompt": int(decoder_ids.shape[1]),
                        "tokens": n, "seconds": seconds})
        return seqs, scores, skip

    def recorded_segment(seek_sequence, time_offset, timestamp_begin, seek_num_frames):
        segments, advance = retrieve_segment(seek_sequence, time_offset, timestamp_begin, seek_num_frames)
        windows[-1].update(advance=advance, frames=seek_num_frames, segments=len(segments))
        return segments, advance

    def recorded_generate(*args, **kwargs):
        result = generate(*args, **kwargs)  # host arrays: the decode has finished
        marks[-1]["end"] = time.perf_counter()
        tokens = result["sequences"] if isinstance(result, dict) else result
        if tokens.ndim != 2 or tokens.shape[0] != 1 or not (
            (tokens >= 0) & (tokens < config.vocab_size)).all():
            raise RuntimeError(f"decode produced invalid tokens of shape {tokens.shape}")
        generated.append(int((tokens != opts.pad_token_id).sum()))
        return result

    cb._score_fn, cb._score_to_keywords, cb.forward = counted_score, recorded_keywords, timed_forward
    cb.encode_and_spot, cb.generator.generate = timed_encode_and_spot, recorded_generate
    cb.generator._generate_with_fallback = timed_fallback
    cb.generator._retrieve_segment = recorded_segment

    mel_cuda.kernel.launches = 0
    matmul_s8_cuda.kernel.launches = 0
    k4_mark = _k4_mark()
    t_run = time.perf_counter()
    with _recorded_k2_shapes() as k2_shapes:
        results = cb.run_test(dataset, mel_fn, num_bootstraps=100)
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches, "k2_shapes": k2_shapes,
                "k4": _check_k4_main_path(f"phase B {label}", k4_mark, config.decoder_layers)}
    del cb._score_to_keywords, cb.forward, cb.encode_and_spot, cb.generator.generate
    del cb.generator._generate_with_fallback, cb.generator._retrieve_segment
    cb._score_fn = score_fn

    first = 0  # index of the utterance's first window in ``spotted``
    for i, (item, m) in enumerate(zip(dataset, marks)):
        decode = m["end"] - m["start"] - m["spot_s"]
        found = [len(k) for k in spotted[first:first + m["windows"]]]
        first += m["windows"]
        print(f"phase B {label}: utterance {i}: {item['seconds']:.2f} s audio"
              f"{' (44.1 kHz WAV)' if 'path' in item else ''}, {m['windows']} window(s), "
              f"mel {mel_seconds[i]!r} s (host, in the prefetch thread, beside the decode before it); "
              f"wall {m['end'] - m['start']!r} s = encode and spot {m['spot_s']!r} s "
              f"+ prefill and beam-5 decode {decode!r} s ({decode / max(generated[i], 1) * 1e3!r} ms "
              f"per generated token); {generated[i]} generated tokens, keywords spotted per window {found}")
    for w in windows:
        print(f"phase B {label}: utterance {w['utterance']} window: prompt {w['prompt']} tokens, "
              f"{w['tokens']} tokens decoded in {w['seconds']!r} s = {w['seconds'] / max(w['tokens'], 1) * 1e3!r} "
              f"ms per token; seek advance {w.get('advance')} of {w.get('frames')} frames, "
              f"{w.get('segments')} segment(s)")
    n_windows = sum(m["windows"] for m in marks)
    print(f"phase B {label}: run_test {t_end - t_run!r} s for {len(dataset)} utterances ({n_windows} windows), "
          f"of which entity recall and bootstrap CIs {t_end - marks[-1]['end']!r} s; entity recall "
          f"{results['Entity Recall']!r} [{results['Entity Recall LB']!r}, {results['Entity Recall UB']!r}]; "
          f"RTFx {results['RTFx']!r}; mel kernel launches {launches['mel']}; K2 launches {launches['k2']}; "
          f"segments scored {len(scored)} x {scored[0] if scored else 0} keywords")
    if launches["mel"] != len(dataset):
        raise RuntimeError(f"mel kernel launched {launches['mel']} times for {len(dataset)} utterances")
    if not (len(scored) == len(spotted) == n_windows
            and len(generated) == len(marks) == len(mel_seconds) == len(dataset)):
        raise RuntimeError("not every window was scored and every utterance decoded")
    if len(windows) != sum(m["windows"] for item, m in zip(dataset, marks) if item["seconds"] > 30):
        raise RuntimeError("a longform window went undecoded")
    return marks, launches, scored


def _slice_dataset():
    """The main path's utterances: 5.5, 17.25 and 29.75 s of audio, and a
    47.5 s one written as a 44.1 kHz WAV (the CLI reads files)."""
    rng = np.random.default_rng(SEED + 2)
    dataset = []
    for i, seconds in enumerate((5.5, 17.25, 29.75, LONGFORM_SECONDS)):
        wav = _audio(1, int(16000 * seconds), rng)[0]
        item = {
            "seconds": seconds,
            "transcript": f"kw{i} appears in utterance {i}",
            "hotword_labels": np.eye(N_KW, dtype=np.int64)[i],
            "speaker": f"s{i % 2}",
        }
        if seconds > 30:  # the longform utterance arrives as a file, as the CLI reads it
            item["path"] = Path(__file__).resolve().parent / "build" / "chip_smoke" / "longform_44k.wav"
            _write_wav(item["path"], wav)
        else:
            item["audio"] = wav
        dataset.append(item)
    return dataset


def phase_b_slice(device, shapes):
    """The main path at whisper-medium widths, fp32 then int8 scoring.
    Returns (fp32 launches, int8 launches, the CBWhisper, its dataset, the
    catalog's keyword stacks)."""
    import torch

    t0 = time.perf_counter()
    cb, config, opts, kws, stacks = _medium_pipeline(device)
    torch.cuda.synchronize()
    print(f"phase B: whisper-medium + ResNet-50 KWS built in {time.perf_counter() - t0:.1f} s")

    dataset = _slice_dataset()
    fp32_marks, fp32_launches, _ = _drive_slice(cb, config, opts, dataset, device, "fp32")
    # the int8 slice's weights: residual-branch BNs no longer zero
    _unzero_residual_bn(kws)
    int8_marks, int8_launches, scored = _drive_slice(
        cb, config, opts, dataset, device, "int8", int8_stages=S8_STAGES)
    chunks = -(-scored[0] // CHUNK)
    for i, (f, q) in enumerate(zip(fp32_marks, int8_marks)):
        print(f"phase B: utterance {i}: encode and spot int8 {q['spot_s']!r} s vs fp32 {f['spot_s']!r} s")
    _check_k2_main_path("phase B int8", int8_launches, shapes, chunks * len(scored),
                        f"{chunks} chunks x {len(scored)} windows")
    if fp32_launches["k2"] != 0:
        raise RuntimeError("the fp32 scorer launched K2")
    return fp32_launches, int8_launches, cb, dataset, stacks


def _device_breakdown(label, fn):
    """Device time of ``fn()`` by kernel family (torch.profiler) beside its
    wall time: cuDNN convolutions, K2, GEMMs, the rest.  The second of two
    profiled calls is read (the first pays the tracer's start-up).  The
    tracer slows the host, so the idle share is taken against the median
    wall of three unprofiled calls made just before.  Returns (that wall,
    the device time), in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    plain_wall_ms = statistics.median(walls)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"K2 matmul_s8_requant": 0.0, "convolutions (cuDNN)": 0.0,
                "GEMMs (cuBLAS/CUTLASS, 1x1 convs among them)": 0.0, "other kernels": 0.0}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
        name = evt.key.lower()
        if "matmul_s8_requant" in name:
            families["K2 matmul_s8_requant"] += us
        elif "conv" in name or "cudnn" in name:
            families["convolutions (cuDNN)"] += us
        elif "gemm" in name or "cutlass" in name:
            families["GEMMs (cuBLAS/CUTLASS, 1x1 convs among them)"] += us
        else:
            families["other kernels"] += us
    device_ms = sum(families.values()) / 1e3
    parts = ", ".join(f"{k} {v / 1e3!r} ms" for k, v in families.items())
    print(f"{label}: wall {plain_wall_ms!r} ms unprofiled (median of 3: {walls!r}), "
          f"{wall_ms!r} ms under the profiler; device {device_ms!r} ms (idle share "
          f"{1 - device_ms / plain_wall_ms!r} of the unprofiled wall): {parts}")
    return plain_wall_ms, device_ms


class _EvalSet:
    """A KWS eval dataset: catalog + utterance stacks with labels."""

    def __init__(self, catalog, items):
        self.catalog, self.items = catalog, items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _EvalModule:
    def __init__(self, dataset):
        self.test_dataset = dataset

    def setup(self, stage):
        pass


def phase_d(device, kws, stacks, shapes) -> dict:
    """The paper-1 KWS eval at full width, fp32 then int8."""
    import torch

    from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda
    from enhance_cb_whisper_tpu_torch.runtime.kws_engine import KWSEngine

    rng = np.random.default_rng(SEED + 5)
    catalog = KeywordCatalog.from_arrays([f"kw{i}" for i in range(N_KW)], stacks)
    frames = np.linspace(300, 1500, 8).astype(int)
    utts = _stacks(rng, len(frames), 12, lambda i: int(frames[i]), stacks[0].shape[-1])
    items = []
    for i, utt in enumerate(utts):
        labels = np.zeros(N_KW, np.int64)
        labels[rng.choice(N_KW, size=int(rng.integers(2, 6)), replace=False)] = 1
        items.append({"utt_hs": utt, "hotword_labels": labels,
                      "hotword_mask": catalog.mask[:N_KW].copy(), "speaker": f"s{i % 3}"})
    dataset = _EvalSet(catalog, items)
    module = _EvalModule(dataset)
    engine = KWSEngine(kws.config, features_size=KWS_SIZE, device=device)
    # centre the class-1 bias on this data's median margin (see phase B)
    _, logits = engine.score_utterance(kws, dataset, utts[0])
    with torch.no_grad():
        kws.model.classifier.bias[1] -= float(np.median(logits[:, 1] - logits[:, 0]))

    out = {}
    for mode in ("fp32", "int8"):
        variables = kws
        if mode == "int8":
            t0 = time.perf_counter()
            variables = engine.enable_int8_scoring(kws, dataset, calibration_batches=4,
                                                   s8_1x1=S8_STAGES)
            torch.cuda.synchronize()
            print(f"phase D: int8 quantization + calibration on 4 utterances "
                  f"{time.perf_counter() - t0!r} s")
        engine._eval_dataset(variables, dataset)  # warm-up
        torch.cuda.synchronize()
        _device_breakdown(f"phase D {mode}: one utterance ({catalog.num_padded // CHUNK} chunks)",
                          lambda: engine.score_utterance(variables, dataset, utts[-1]))
        matmul_s8_cuda.kernel.launches = 0
        t0 = time.perf_counter()
        with _recorded_k2_shapes() as k2_shapes:
            preds, targets, _, loss = engine._eval_dataset(variables, dataset)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"k2": matmul_s8_cuda.kernel.launches, "k2_shapes": k2_shapes}
        results = engine.test(variables, module)
        if not (np.isfinite(preds).all() and preds.shape == (len(items) * N_KW,)
                and all(np.isfinite(v) for v in results.values())):
            raise RuntimeError(f"KWS eval {mode} produced invalid output")
        out[mode] = (preds, results, launches)
        print(f"phase D {mode}: P {results['Precision']!r} [{results['Precision_LB']!r}, "
              f"{results['Precision_UB']!r}] R {results['Recall']!r} [{results['Recall_LB']!r}, "
              f"{results['Recall_UB']!r}] F1 {results['F1']!r} [{results['F1_LB']!r}, "
              f"{results['F1_UB']!r}]; loss {loss!r}; {seconds!r} s for {len(items)} utterances x "
              f"{N_KW} keywords = {seconds / (len(items) * N_KW) * 1e3!r} ms per pair; "
              f"K2 launches {launches['k2']}")
    flips = float(np.mean((out["fp32"][0] >= 0.5) != (out["int8"][0] >= 0.5)))
    print(f"phase D: decisions at 0.5 that flip between fp32 and int8: {flips!r} of "
          f"{len(out['fp32'][0])} pairs; max |p_int8 - p_fp32| "
          f"{float(np.abs(out['int8'][0] - out['fp32'][0]).max())!r}")
    chunks = -(-catalog.num_padded // CHUNK)
    _check_k2_main_path("phase D int8", out["int8"][2], shapes, chunks * len(items),
                        f"{chunks} chunks x {len(items)} utterances")
    if out["fp32"][2]["k2"] != 0:
        raise RuntimeError("the fp32 KWS eval launched K2")
    return out


# --------------------------------------------------------------- phase E: CLI

PHASE_E_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase_e"
CONFIGS = Path(__file__).resolve().parent / "configs"
# phase B's multilingual ids: GenerationOptions' defaults and its language,
# task and begin-suppress ids
GENERATION_CONFIG = {
    "decoder_start_token_id": 50258, "eos_token_id": 50257, "pad_token_id": 50257,
    "no_timestamps_token_id": 50363, "prev_sot_token_id": 50361,
    "begin_suppress_tokens": [220, 50257], "suppress_tokens": [], "max_initial_timestamp_index": 50,
    "lang_to_id": {"<|en|>": 50259},
}


def _bytes_to_unicode() -> dict:
    """GPT-2's byte -> printable character table, the byte-level BPE alphabet."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) \
        + list(range(ord("®"), ord("ÿ") + 1))
    cs, extra = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + extra)
            extra += 1
    return dict(zip(bs, map(chr, cs)))


def _write_tokenizer(directory: Path) -> None:
    """A Whisper tokenizer saved by the installed ``transformers.WhisperTokenizer``
    itself, so its files are that version's format: the 256 byte tokens at
    ids 0-255 and no merges, fillers to 50256 (three characters each, so a
    random decoder's transcripts stay short), then the multilingual specials
    at Whisper's ids (<|endoftext|> 50257, <|startoftranscript|> 50258, 99
    languages from <|en|> 50259, <|transcribe|> 50359, <|startofprev|> 50361,
    <|notimestamps|> 50363) and the 1501 timestamps up to 51864."""
    import tempfile

    import transformers

    from enhance_cb_whisper_tpu_torch.cli.languages import LANGUAGES

    byte_chars = _bytes_to_unicode()
    vocab = {byte_chars[b]: b for b in range(256)}
    # fillers: three letters or digits each, which no merge can produce
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    fillers = ("".join(t) for t in itertools.product(alphabet, repeat=3))
    vocab.update({f: i for i, f in zip(range(256, 50257), fillers)})
    specials = (["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{c}|>" for c in list(LANGUAGES)[:99]]
                + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
                   "<|nocaptions|>", "<|notimestamps|>"])
    vocab.update({tok: 50257 + i for i, tok in enumerate(specials)})
    vocab.update({f"<|{i * 0.02:.2f}|>": 50364 + i for i in range(1501)})
    with tempfile.TemporaryDirectory(dir=directory) as tmp:
        vocab_file, merges_file = Path(tmp) / "vocab.json", Path(tmp) / "merges.txt"
        vocab_file.write_text(json.dumps(vocab))
        merges_file.write_text("#version: 0.2\n")
        tokenizer = transformers.WhisperTokenizer(
            str(vocab_file), str(merges_file), unk_token="<|endoftext|>", bos_token="<|endoftext|>",
            eos_token="<|endoftext|>", pad_token="<|endoftext|>", additional_special_tokens=specials[1:])
        tokenizer.save_pretrained(str(directory))


def _write_whisper_checkpoint(directory: Path, config, params) -> dict:
    """An HF checkpoint directory: config.json, model.safetensors,
    generation_config.json and the tokenizer.  Returns the state written."""
    import dataclasses

    from safetensors.torch import save_file

    from enhance_cb_whisper_tpu_torch.models.whisper_loader import hf_whisper_state

    directory.mkdir(parents=True, exist_ok=True)
    state = {k: v.cpu() for k, v in hf_whisper_state(params).items()}
    save_file(state, str(directory / "model.safetensors"))
    (directory / "config.json").write_text(json.dumps(
        {"model_type": "whisper", "architectures": ["WhisperForConditionalGeneration"],
         **dataclasses.asdict(config)}))
    (directory / "generation_config.json").write_text(json.dumps(GENERATION_CONFIG))
    _write_tokenizer(directory)
    return state


def _write_lightning_kws(path: Path, kws) -> None:
    """The port's ``KWSModel`` as a reference Lightning checkpoint."""
    import torch

    from enhance_cb_whisper_tpu_torch.models.torch_compat import lightning_resnet_classifier

    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": lightning_resnet_classifier(kws.state_dict(), kws.config)}, str(path))


def _write_acl(root: Path, keywords, stacks, utterances) -> None:
    """An ACL-6060 ``test`` layout (``2/acl_6060/eval``): the keyword list and
    stacks, and per utterance its WAV, hidden-state stack, transcript,
    tagged transcript and XML segment (one document per speaker)."""
    base = root / "2" / "acl_6060" / "eval"
    text = base / "text"
    for sub in (text / "txt", text / "tagged_terminology", text / "xml", base / "hs",
                base / "keywords-hs" / "tts"):
        sub.mkdir(parents=True, exist_ok=True)
    (text / "keywords.txt").write_text("\n".join(keywords) + "\n")
    width = len(str(len(keywords) - 1))
    for i, stack in enumerate(stacks):
        np.save(base / "keywords-hs" / "tts" / f"{str(i).zfill(width)}.npy", stack)
    docs = {}
    for i, u in enumerate(utterances, 1):
        _write_wav(base / "segmented_wavs" / "gold" / f"sent_{i}.wav", u["wav"], u["rate"])
        np.save(base / "hs" / f"sent_{i}.npy", u["hs"])
        docs.setdefault(u["speaker"], []).append(f'<seg id="{i}">{u["transcript"]}</seg>')
    (text / "txt" / "ACL.6060.eval.en-xx.en.txt").write_text(
        "\n".join(u["transcript"] for u in utterances) + "\n")
    (text / "tagged_terminology" / "ACL.6060.eval.tagged.en-xx.en.txt").write_text(
        "\n".join(u["tagged"] for u in utterances) + "\n")
    (text / "xml" / "ACL.6060.eval.en-xx.en.xml").write_text(
        '<mteval><srcset setid="acl" srclang="en">'
        + "".join(f'<doc docid="{s}">' + "".join(segs) + "</doc>" for s, segs in docs.items())
        + "</srcset></mteval>")


def _utterances(rng, seconds_rates, keywords, layers, dim):
    """Synthetic utterances: audio, a random hidden-state stack (50 frames a
    second), a transcript naming two keywords and its tagged form."""
    out = []
    for i, (seconds, rate) in enumerate(seconds_rates):
        a, b = (keywords[j] for j in rng.choice(len(keywords), 2, replace=False))
        out.append({
            "seconds": seconds, "rate": rate, "speaker": f"s{i % 2}",
            "wav": _audio(1, int(16000 * seconds), rng)[0],
            "hs": _stacks(rng, 1, layers, lambda _: int(50 * seconds), dim)[0],
            "transcript": f"we spoke of {a} and then of {b} today",
            "tagged": f"we spoke of [{a}] and then of [{b}] today",
        })
    return out


def _gap_shift(margins) -> float:
    """A class-1 bias shift into the widest gap among the middle half of
    ``margins``: decisions then differ by keyword and sit far from 0.5."""
    m = np.sort(np.asarray(margins, np.float64))
    inner = range(len(m) // 4, len(m) - len(m) // 4 - 1)
    gap = max(inner, key=lambda i: m[i + 1] - m[i])
    return float(m[gap] + m[gap + 1]) / 2


@contextlib.contextmanager
def _recorded_cli_run():
    """Per-utterance marks of a CB-Whisper CLI run: the host seconds of its
    audio read (in run_test's prefetch thread, beside the decode before
    it), the start and end of its transcription and the keywords spotted
    in it."""
    import torch

    import enhance_cb_whisper_tpu_torch.audio.io as audio_io
    from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper

    marks, loads = [], []
    load, forward, score = audio_io.load_audio_16k, CBWhisper.forward, CBWhisper._score_to_keywords

    def timed_load(path):
        t0 = time.perf_counter()
        out = load(path)
        loads.append(time.perf_counter() - t0)
        return out

    def timed_forward(self, *args, **kwargs):
        marks.append({"start": time.perf_counter(), "keywords": []})
        out = forward(self, *args, **kwargs)  # a host string: the decode has finished
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        marks[-1]["end"] = time.perf_counter()
        marks[-1]["load"] = loads[len(marks) - 1]
        return out

    def recorded_score(self, stacks, *args, **kwargs):
        out = score(self, stacks, *args, **kwargs)
        marks[-1]["keywords"].extend(out)
        return out

    audio_io.load_audio_16k, CBWhisper.forward, CBWhisper._score_to_keywords = (
        timed_load, timed_forward, recorded_score)
    try:
        yield marks
    finally:
        audio_io.load_audio_16k, CBWhisper.forward, CBWhisper._score_to_keywords = load, forward, score


def _cb_argv(root: Path, *overrides):
    """``cb-whisper.py test`` on the repo's flagship config, its
    placeholders filled by ``--set``."""
    return ["test", "--config", str(CONFIGS / "cb-whisper-acl.yaml"),
            "--set", f"ACL_ROOT={root / 'acl'}", "--set", f"WHISPER_LOCAL_DIR={root / 'whisper'}",
            "--set", f"KWS_CKPT={root / 'kws.ckpt'}", *overrides]


def _write_tiny_cli(root: Path):
    """A tiny random checkpoint directory (Whisper's real vocab and
    specials, d_model 64), a 2-channel ResNet-50 ``.ckpt`` whose class-1
    bias sits in the widest gap of the keywords' margins on these
    utterances, and a 6-keyword ACL layout of a 6.0 s and a 9.5 s WAV under
    ``root``.  Returns the ``cb-whisper.py test`` argv for them and the
    number of keywords and of utterances."""
    import torch

    from enhance_cb_whisper_tpu_torch.audio.io import load_audio_16k, prepare_features
    from enhance_cb_whisper_tpu_torch.catalog.database import (
        KeywordCatalog,
        device_put_catalog,
        make_catalog_score_fn,
    )
    from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
    from enhance_cb_whisper_tpu_torch.models.kws import init_kws_model
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.models.whisper import (
        WhisperConfig,
        encoder_kws_stack,
        init_whisper_params,
    )
    from enhance_cb_whisper_tpu_torch.ops.resize import resize_matrix

    cfg = WhisperConfig(
        num_mel_bins=80, d_model=64, encoder_layers=3, encoder_attention_heads=4, decoder_layers=2,
        decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128, max_target_positions=40,
    )
    rng = np.random.default_rng(SEED + 9)
    params = from_jax_whisper_params(init_whisper_params(rng, cfg), "cpu")
    _write_whisper_checkpoint(root / "whisper", cfg, params)
    keywords = [f"kw{i}" for i in range(6)]
    stacks = _stacks(rng, len(keywords), 2, lambda i: int(rng.integers(3, 12)), cfg.d_model)
    utterances = _utterances(rng, ((6.0, 16000), (9.5, 44100)), keywords, 2, cfg.d_model)
    _write_acl(root / "acl", keywords, stacks, utterances)

    kws = init_kws_model(ResNetConfig.from_version("resnet-50", num_channels=2),
                         torch.Generator().manual_seed(SEED))
    score = make_catalog_score_fn(lambda x: kws(x).logits, out_size=(32, 48))
    catalog = device_put_catalog(KeywordCatalog.from_arrays(keywords, stacks), out_h=32, chunk=8,
                                 device="cpu")
    utt_w = torch.from_numpy(resize_matrix(cfg.max_source_positions, 48, antialias=False))
    margins = []
    with torch.no_grad():
        for i in range(len(utterances)):
            path = root / "acl" / "2" / "acl_6060" / "eval" / "segmented_wavs" / "gold" / f"sent_{i + 1}.wav"
            features, _ = prepare_features(load_audio_16k(str(path)), device="cpu")
            stack = encoder_kws_stack(params, features, cfg, layer_slice=(1, 3))
            logits = score(catalog, stack[0], utt_w)[1][: len(keywords)]
            margins.extend((logits[:, 1] - logits[:, 0]).tolist())
        kws.model.classifier.bias[1] -= _gap_shift(margins)
    _write_lightning_kws(root / "kws.ckpt", kws)

    argv = _cb_argv(root, "--model.init_args.kws_features_size", "[32, 48]",
                    "--model.init_args.kws_layer_slice", "[1, 3]",
                    "--model.init_args.kws_num_channels", "2", "--model.init_args.num_bootstraps", "200")
    return argv, len(keywords), len(utterances)


def phase_e_tiny(root: Path) -> None:
    """The CLI on the tiny checkpoint directory of :func:`_write_tiny_cli`:
    ``run_cli(..., device="cpu")`` and ``run_cli(...)`` (the card) give
    identical transcripts, keywords and entity recall with its bounds, and
    the card's run launches K1 once per utterance."""
    from enhance_cb_whisper_tpu_torch.cli import run_cli
    from enhance_cb_whisper_tpu_torch.ops import mel_cuda

    t0 = time.perf_counter()
    argv, n_keywords, n_utterances = _write_tiny_cli(root)
    runs = {}
    for dev in ("cpu", "cuda"):
        preds = []
        mel_cuda.kernel.launches = 0
        with _recorded_cli_run() as marks:
            if dev == "cpu":
                results = run_cli(list(argv), device="cpu", predictions_out=preds)
            else:
                results = run_cli(list(argv), predictions_out=preds)  # the default device: the card
        runs[dev] = (preds, [m["keywords"] for m in marks], results, mel_cuda.kernel.launches)
    (cpu_preds, cpu_kw, cpu_res, _), (gpu_preds, gpu_kw, gpu_res, mel) = runs["cpu"], runs["cuda"]
    recall = [(r["Entity Recall"], r["Entity Recall LB"], r["Entity Recall UB"]) for r in (cpu_res, gpu_res)]
    print(f"phase E tiny: run_cli on the CPU and on the card ({time.perf_counter() - t0:.1f} s with the "
          f"files): keywords per utterance {gpu_kw}; transcripts identical {cpu_preds == gpu_preds}, "
          f"keywords identical {cpu_kw == gpu_kw}; entity recall [LB, UB] cpu {recall[0]!r} "
          f"cuda {recall[1]!r}; mel kernel launches on the card {mel}")
    if cpu_preds != gpu_preds or cpu_kw != gpu_kw or recall[0] != recall[1]:
        raise RuntimeError("the CLI on the card disagrees with the CLI on the CPU")
    if len(gpu_preds) != n_utterances or mel != n_utterances:
        raise RuntimeError(f"the card's CLI run launched K1 {mel} times for {n_utterances} utterances")
    counts = [len(seg) for u in gpu_kw for seg in u]
    if not 0 < sum(counts) < n_keywords * len(counts):
        raise RuntimeError(f"the tiny CLI run spotted no keyword or every keyword: {gpu_kw}")


def phase_e_medium(root: Path, config, params, kws, stacks, shapes) -> dict:
    """The CLI at whisper-medium widths, from files: writes phase B's random
    Whisper as an HF checkpoint directory (config.json, model.safetensors,
    generation_config.json, tokenizer), phase B's centred ResNet-50 as a
    reference Lightning .ckpt and an ACL-6060 test layout (phase B's 100
    keyword stacks; a 12.5 s utterance as a 16 kHz WAV and a 27 s one as a
    44.1 kHz WAV, each with a hidden-state stack); checks that
    ``load_whisper_from_pretrained`` reads every tensor back exactly; runs
    ``cb-whisper.py test`` on the flagship config (fp32, beam 5, oracle kws,
    150x750, slice (10, 22), 100 keywords per group), K1 exactly once per
    utterance; then ``kws.py test`` with ``kws_int8`` and no environment
    variable set, K2 exactly 22 x 13 per utterance at phase A2's shapes."""
    import torch

    from enhance_cb_whisper_tpu_torch.cli import run_cli
    from enhance_cb_whisper_tpu_torch.models.whisper_loader import hf_whisper_state, load_whisper_from_pretrained
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda

    rng = np.random.default_rng(SEED + 11)
    t0 = time.perf_counter()
    written = _write_whisper_checkpoint(root / "whisper", config, params)
    t_write = time.perf_counter() - t0
    size = sum(t.numel() * t.element_size() for t in written.values())
    t0 = time.perf_counter()
    read_config, read = load_whisper_from_pretrained(str(root / "whisper"))
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    read, original = hf_whisper_state(read), hf_whisper_state(params)
    same = read_config == config and sorted(read) == sorted(written) and all(
        torch.equal(read[k], original[k]) for k in original)
    print(f"phase E: whisper-medium checkpoint directory of {len(written)} tensors, {size} B: written in "
          f"{t_write!r} s, read back to the card by load_whisper_from_pretrained in {t_read!r} s; config "
          f"and every tensor equal to what was written: {same}")
    del read, original, written
    if not same:
        raise RuntimeError("load_whisper_from_pretrained read back other tensors than were written")

    keywords = [f"kw{i}" for i in range(len(stacks))]
    utterances = _utterances(rng, ((12.5, 16000), (27.0, 44100)), keywords, 12, config.d_model)
    _write_acl(root / "acl", keywords, stacks, utterances)
    _write_lightning_kws(root / "kws.ckpt", kws)

    mel_cuda.kernel.launches = 0
    matmul_s8_cuda.kernel.launches = 0
    preds = []
    t0 = time.perf_counter()
    with _recorded_cli_run() as marks:
        # the flagship config as it stands but for its bootstrap count: a
        # random decoder's 448-token transcripts make each of the 1000
        # resamples' alignments cost ~0.3 s on the host
        results = run_cli(_cb_argv(root, "--model.init_args.num_bootstraps", "20"), predictions_out=preds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches}
    for u, m in zip(utterances, marks):
        seconds = m["end"] - m["start"]
        print(f"phase E cb-whisper.py test: utterance of {u['seconds']} s ({u['rate']} Hz WAV): WAV read "
              f"{m['load']!r} s (prefetch thread); transcription wall {seconds!r} s, RTFx "
              f"{u['seconds'] / seconds!r}, keywords spotted {m['keywords']}")
    print(f"phase E cb-whisper.py test: run_cli {wall!r} s in all; entity recall "
          f"{results['Entity Recall']!r} [{results['Entity Recall LB']!r}, {results['Entity Recall UB']!r}]; "
          f"RTFx {results['RTFx']!r}; mel kernel launches {launches['mel']}, K2 launches {launches['k2']}; "
          f"transcript lengths {[len(p) for p in preds]}")
    if launches["mel"] != len(utterances) or len(marks) != len(utterances) or launches["k2"]:
        raise RuntimeError(f"cb-whisper.py test launched K1 {launches['mel']} and K2 {launches['k2']} times "
                           f"for {len(utterances)} utterances")
    if len(preds) != len(utterances) or not all(isinstance(p, str) for p in preds) or not all(
            np.isfinite(results[k]) and 0 <= results[k] <= 1
            for k in ("Entity Recall", "Entity Recall LB", "Entity Recall UB")):
        raise RuntimeError(f"cb-whisper.py test gave invalid output: {results}")

    argv = ["test", "--config", str(CONFIGS / "kws-acl.yaml"), "--set", f"AISHELL_ROOT={root}",
            "--set", "MODALITY=tts", "--set", f"ACL_ROOT={root / 'acl'}", "--set", f"CKPT={root / 'kws.ckpt'}",
            "--model.init_args.kws_int8", "true", "--model.init_args.kws_int8_calibration_batches", "2"]
    matmul_s8_cuda.kernel.launches = 0
    t0 = time.perf_counter()
    with _recorded_k2_shapes() as k2_shapes:
        kws_results = run_cli(argv)
        torch.cuda.synchronize()
    kws_wall = time.perf_counter() - t0
    k2 = {"k2": matmul_s8_cuda.kernel.launches, "k2_shapes": k2_shapes}
    print(f"phase E kws.py test (kws_int8): run_cli {kws_wall!r} s; "
          f"P {kws_results['Precision']!r} R {kws_results['Recall']!r} F1 {kws_results['F1']!r} "
          f"[{kws_results['F1_LB']!r}, {kws_results['F1_UB']!r}]")
    chunks = -(-len(keywords) // CHUNK)
    _check_k2_main_path("phase E kws.py test", k2, shapes, chunks * len(utterances),
                        f"{chunks} chunks x {len(utterances)} utterances")
    if not all(np.isfinite(v) for v in kws_results.values()):
        raise RuntimeError(f"kws.py test gave invalid output: {kws_results}")
    return {"mel": launches["mel"], "k2": k2["k2"]}


def phase_e(config, params, kws, stacks, shapes) -> dict:
    """The port's CLI: the tiny CPU = card run, then whisper-medium from
    files.  Its directory (a 3.1 GB checkpoint among it) is deleted when the
    phase ends, pass or fail."""
    import shutil

    t0 = time.perf_counter()
    try:
        phase_e_tiny(PHASE_E_DIR / "tiny")
        launches = phase_e_medium(PHASE_E_DIR / "medium", config, params, kws, stacks, shapes)
    finally:
        shutil.rmtree(PHASE_E_DIR, ignore_errors=True)
    print(f"phase E: {time.perf_counter() - t0:.1f} s in all")
    return launches


# ---------------------------------------------------------- phase F: serving

PHASE_F_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase_f"
RESULT_TIMEOUT = 300  # seconds a ticket may take before the run fails


@contextlib.contextmanager
def _recorded_windows(gen):
    """Each packed window of ``gen`` while the block runs: its width, its
    occupied slots, the temperatures and rows of its decodes, and its
    decode's wall time and steps (calls of the decode step)."""
    import torch

    windows = []
    run_window, decode_prompted = gen._run_longform_window, gen._decode_prompted
    with_fallback, decode_step = gen._generate_with_fallback, gen._decode_step

    def recorded_window(rows, *args, **kwargs):
        windows.append({"width": len(rows), "occupied": sum(r is not None for r in rows),
                        "orders": [None if r is None else r.order for r in rows],
                        "decodes": [], "steps": 0, "decode_s": 0.0})
        return run_window(rows, *args, **kwargs)

    def recorded_decode(cross_kv, ids, *args, **kwargs):
        windows[-1]["decodes"].append((int(ids.shape[0]), kwargs.get("temperature", 0.0)))
        return decode_prompted(cross_kv, ids, *args, **kwargs)

    def timed_fallback(*args, **kwargs):
        if gen.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = with_fallback(*args, **kwargs)  # host arrays: the decode has finished
        windows[-1]["decode_s"] += time.perf_counter() - t0
        return out

    def counted_step(*args, **kwargs):
        windows[-1]["steps"] += 1
        return decode_step(*args, **kwargs)

    gen._run_longform_window, gen._decode_prompted = recorded_window, recorded_decode
    gen._generate_with_fallback, gen._decode_step = timed_fallback, counted_step
    try:
        yield windows
    finally:
        del gen._run_longform_window, gen._decode_prompted, gen._generate_with_fallback, gen._decode_step


def _packed_results(pairs):
    """``generate_packed(..., return_segments=True)``'s yields as plain
    values: {order: (tokens, [(start, end, tokens) per segment])}."""
    return {order: (r["sequences"].tolist(), [(s["start"], s["end"], [int(t) for t in s["tokens"]])
                                             for s in r["segments"]])
            for order, r in pairs}


def phase_f1(device) -> None:
    """Packed decode on the tiny random CB-Whisper (the K2-eligible ResNet
    of phase B, int8 spotting with stage_1 on K2; a decoder that leaves its
    windows), over five mels of 0.6-2.5 windows and one of zero length,
    with spotting and condition-on-prev:

    * ``generate_packed`` at ``slots=3`` with a ladder whose every rung
      trips (0.0, 0.2, 0.4; logprob threshold 0): the CPU and the card
      give identical (order, sequences, segments);
    * on the card, ``slots=3`` gives every utterance the tokens of
      ``slots=1`` (temperature 0; int8 calibrated on the first window,
      whose first row is the first utterance either way);
    * vacant slots appear at the stream's tail, and a pending int8
      calibration keeps exactly the real rows of every window;
    * ``forward_batch`` of two utterances: the CPU = the card;
    * ``run_cli`` of the tiny checkpoint with ``eval_packed: true`` and
      ``eval_batch_size: 2``: the CPU and the card give the same
      transcripts and entity recall, K1 once per utterance on the card."""
    import dataclasses
    import shutil

    import torch

    from enhance_cb_whisper_tpu_torch.cli import run_cli
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.models.whisper import encoder_kws_stack
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda

    t_start = time.perf_counter()
    k2_tiny = ResNetConfig(num_channels=2, embedding_size=32, hidden_sizes=(128, 512), depths=(1, 3))
    params = _seekable_tiny_params(_tiny_pipeline("cpu").whisper_config)
    base = _tiny_pipeline("cpu", k2_tiny, whisper_params=params)
    cfg = base.whisper_config
    rng = np.random.default_rng(SEED + 13)
    mels = [rng.standard_normal((1, cfg.num_mel_bins, n)).astype(np.float32)
            for n in (1800, 7500, 4100, 3000, 5200)]
    stream = [(m, None) for m in mels]
    stream.insert(2, (np.zeros((1, cfg.num_mel_bins, 600), np.float32), np.zeros((1, 600), np.int64)))

    # the class-1 bias in the widest gap of the keywords' margins on the
    # first windows (CPU, fp32)
    base._ensure_catalog()
    margins = []
    with torch.no_grad():
        for m in mels:
            segment = base.generator._pad_segment(torch.from_numpy(m[:, :, :base.generator.n_segment_frames]))
            stack = encoder_kws_stack(base.encoder_params, segment, cfg, layer_slice=base.kws_layer_slice)
            _, logits = base._score_fn(base._catalog_dev, stack[0], base._utt_w)
            margins.extend((logits[:6, 1] - logits[:6, 0]).tolist())
    shift = _gap_shift(margins)

    def make(dev, calibration_batches=1):
        cb = _tiny_pipeline(dev, k2_tiny, class1_shift=shift, whisper_params=params)
        cb.enable_int8_spotting(calibration_batches=calibration_batches, s8_1x1=("stage_1",))
        return cb

    def packed(cb, opts, slots):
        return _packed_results(cb.generator.generate_packed(
            iter(stream), opts, slots=slots, keyword_spotting=cb.keyword_spotting,
            encode_spot=cb._encode_spot_hook(), return_segments=True))

    ladder = dataclasses.replace(base.opts, temperature=(0.0, 0.2, 0.4), logprob_threshold=0.0)
    out, windows = {}, {}
    for dev in ("cpu", device):
        cb = make(dev)
        matmul_s8_cuda.kernel.launches = 0
        with _recorded_windows(cb.generator) as recorded:
            out[str(dev)] = packed(cb, ladder, 3)
        windows[str(dev)] = [(w["width"], w["occupied"], w["decodes"]) for w in recorded]
        k2 = matmul_s8_cuda.kernel.launches
    cpu, gpu = out["cpu"], out[str(device)]
    temperatures = {t for w in windows["cpu"] for _, t in w[2]}
    occupancy = [w[1] for w in windows["cpu"]]
    print(f"phase F1: tiny generate_packed slots=3, ladder (0.0, 0.2, 0.4) whose every rung trips, int8 "
          f"spotting: {len(occupancy)} windows, occupied slots per window {occupancy}, decodes at "
          f"temperatures {sorted(temperatures)}; results in order of completion {list(gpu)}, tokens per "
          f"utterance {[len(gpu[k][0]) for k in sorted(gpu)]}; cpu vs cuda (order, sequences, segments) "
          f"identical: {list(cpu.items()) == list(gpu.items())}; K2 launches on the card {k2}")
    if list(cpu.items()) != list(gpu.items()) or windows["cpu"] != windows[str(device)]:
        raise RuntimeError("packed decode on the card disagrees with the CPU")
    if sorted(gpu) != list(range(len(stream))) or gpu[2] != ([], []) or not all(
            gpu[k][0] for k in gpu if k != 2):
        raise RuntimeError(f"packed decode lost an utterance or decoded the empty one: {gpu}")
    if 0.4 not in temperatures or min(occupancy) >= 3 or k2 <= 0:
        raise RuntimeError("the packed reference run did not climb the ladder, leave a slot vacant or launch K2")

    plain = base.opts  # temperature 0: no sampled rung
    slots3, slots1 = packed(make(device), plain, 3), packed(make(device), plain, 1)
    print(f"phase F1: on the card, slots=3 and slots=1 (int8 calibrated on the first window) give every "
          f"utterance the same tokens and segments: {slots3 == slots1}")
    if slots3 != slots1:
        raise RuntimeError(f"slots=3 differs from slots=1 on the card: {slots3} vs {slots1}")

    cb = make(device, calibration_batches=10**6)  # never completes: every real row is kept
    with _recorded_windows(cb.generator) as recorded:
        packed(cb, plain, 3)
    real = sum(w["occupied"] for w in recorded)
    vacant = sum(w["width"] - w["occupied"] for w in recorded)
    print(f"phase F1: int8 calibration over slots=3: {len(cb._int8_calib_stacks)} segments kept for "
          f"{real} real and {vacant} vacant row-windows (occupied per window "
          f"{[w['occupied'] for w in recorded]})")
    if len(cb._int8_calib_stacks) != real or vacant == 0:
        raise RuntimeError("a vacant slot entered the int8 calibration set")

    batch = {}
    for dev in ("cpu", device):
        batch[str(dev)] = make(dev).forward_batch([torch.from_numpy(m) for m in mels[:2]], [None, None])
    print(f"phase F1: forward_batch of two utterances, cpu vs cuda transcripts identical: "
          f"{batch['cpu'] == batch[str(device)]} (lengths {[len(t) for t in batch['cpu']]})")
    if batch["cpu"] != batch[str(device)] or not all(batch["cpu"]):
        raise RuntimeError("forward_batch on the card disagrees with the CPU")

    try:
        argv, _, n_utterances = _write_tiny_cli(PHASE_F_DIR / "tiny")
        argv += ["--model.init_args.eval_packed", "true", "--model.init_args.eval_batch_size", "2"]
        runs = {}
        for dev in ("cpu", "cuda"):
            preds = []
            mel_cuda.kernel.launches = 0
            kwargs = {"device": "cpu"} if dev == "cpu" else {}  # the default device: the card
            results = run_cli(list(argv), predictions_out=preds, **kwargs)
            runs[dev] = (preds, tuple(results[k] for k in ("Entity Recall", "Entity Recall LB",
                                                           "Entity Recall UB")), mel_cuda.kernel.launches)
    finally:
        shutil.rmtree(PHASE_F_DIR, ignore_errors=True)
    print(f"phase F1: run_cli with eval_packed true, eval_batch_size 2: transcripts identical "
          f"{runs['cpu'][0] == runs['cuda'][0]}, entity recall [LB, UB] cpu {runs['cpu'][1]!r} cuda "
          f"{runs['cuda'][1]!r}; mel kernel launches on the card {runs['cuda'][2]}")
    if runs["cpu"][:2] != runs["cuda"][:2] or runs["cuda"][2] != n_utterances or len(runs["cuda"][0]) != n_utterances:
        raise RuntimeError("the packed CLI on the card disagrees with the CPU")
    print(f"phase F1: {time.perf_counter() - t_start:.1f} s in all")


def _second_checkpoint(params, seed: int):
    """Another random checkpoint of ``params``'s architecture, drawn on its
    device from ``seed`` at ``init_whisper_params``'s scales: every matrix
    normal(0, 0.02), the encoder's sinusoid positions, LayerNorms and
    biases as they are."""
    import torch

    def draw(tree, path, gen):
        if isinstance(tree, dict):
            return {k: draw(v, path + (k,), gen) for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v, path + (str(i),), gen) for i, v in enumerate(tree)]
        if tree.ndim < 2 or path[:2] == ("encoder", "embed_positions"):
            return tree
        return torch.randn(tree.shape, generator=gen, device=tree.device) * 0.02

    first = params["decoder"]["embed_tokens"]["weight"]
    return draw(params, (), torch.Generator(device=first.device).manual_seed(seed))


def _gemm_row_variance(params) -> None:
    """Whether cuBLAS gives a row the same fp32 bits whatever the rows
    beside it: rows 0-4 of the decoder's products at M = 20 (a beam-5
    decode step at slots=4) against the same 5 rows alone (slots=1), and
    the encoder's at M = 6000 against 1500 (4 windows against 1).  Printed,
    not checked: packed transcripts stay the same only while no beam
    choice is that close."""
    import torch
    import torch.nn.functional as F

    layer = params["decoder"]["layers"][0]
    gen = torch.Generator(device=layer["fc1"]["weight"].device).manual_seed(SEED)
    cases = [("decoder fc1", layer["fc1"]["weight"], 5, 20), ("decoder fc2", layer["fc2"]["weight"], 5, 20),
             ("vocab projection", params["decoder"]["embed_tokens"]["weight"], 5, 20),
             ("encoder fc1", params["encoder"]["layers"][0]["fc1"]["weight"], 1500, 6000)]
    parts = []
    for name, w, m_small, m_big in cases:
        x = torch.randn((m_big, w.shape[1]), generator=gen, device=w.device)
        big, small = F.linear(x, w)[:m_small], F.linear(x[:m_small].clone(), w)
        parts.append(f"{name} (M {m_small} vs {m_big}): bitwise equal {torch.equal(big, small)}, "
                     f"max |diff| {(big - small).abs().max().item()!r}")
    print("phase F2: cuBLAS fp32 rows alone vs beside others: " + "; ".join(parts))


def _serving_kit(device, cb, shapes, phase: str):
    """Phase F2's serving checks around phase B's model (``cb``), for F2
    and G3: ``fresh`` builds a CBWhisper over its weights, ``reference``
    runs ``run_test(packed=True, batch_size=1)``, ``serve`` submits to a
    live service, ``same`` holds a service's transcripts and keywords to
    the slots=1 ones; every line is printed under ``phase``."""
    import torch

    from enhance_cb_whisper_tpu_torch.audio.io import load_audio_16k, prepare_features
    from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda

    config = cb.whisper_config
    per_window = len(shapes) * -(-cb.catalog.num_padded // CHUNK)  # K2 launches per scored row

    def prompt_ids_fn(text):
        """One token per spotted keyword (up to 48), so each utterance's
        prompt names its own keywords (phase B's fake tokenizer keeps 8
        characters, which most keyword sets share)."""
        return [50361] + [100 + int(k[2:]) for k in text.strip("()").split()][:48]

    def fresh(int8=False, params=None, **levers):
        """A CBWhisper over phase B's weights (or ``params``) and ResNet-50
        (its own generator, so a swap stays in it); the fp32 scorer, or
        int8; ``levers`` are the generator's serving levers."""
        module = CBWhisper(
            config=cb.config, whisper_config=config,
            whisper_params=cb.generator.params if params is None else params,
            kws_model=cb.kws_model, catalog=cb.catalog, generation_options=cb.opts,
            prompt_ids_fn=prompt_ids_fn, decode_fn=cb.decode_fn, kws_layer_slice=cb.kws_layer_slice,
            device=device, **levers,
        )
        if int8:
            module.enable_int8_spotting(calibration_batches=1, s8_1x1=S8_STAGES)
        return module

    def mel_fn(item):
        wav = load_audio_16k(str(item["path"])) if "path" in item else item["audio"]
        return prepare_features(wav, n_mels=config.num_mel_bins, device=device)

    def report(label, wall, audio_seconds, windows, launches, texts, peak):
        steps = sum(w["steps"] for w in windows)
        decode_s = sum(w["decode_s"] for w in windows)
        occupied = [w["occupied"] for w in windows]
        print(f"{phase} {label}: wall {wall!r} s for {audio_seconds!r} s of audio, RTFx "
              f"{audio_seconds / wall!r}; {len(windows)} windows of width {[w['width'] for w in windows]}, "
              f"occupied slots {occupied} (mean {np.mean(occupied)!r}); decode {decode_s!r} s over {steps} "
              f"steps = {decode_s / max(steps, 1) * 1e3!r} ms per step; mel kernel launches "
              f"{launches['mel']}, K2 launches {launches['k2']}; peak memory allocated {peak} B; "
              f"tokens per transcript {[len(t.split()) for t in texts]}, {len(set(texts))} distinct; "
              f"first tokens {[t.split()[:6] for t in texts]}")

    @contextlib.contextmanager
    def keywords_by_utterance(module, windows):
        """The keywords spotted for each utterance, window by window."""
        score, spotted = module._score_to_keywords, {}

        def recorded(stacks, real_rows=None):
            out = score(stacks, real_rows)
            for order, keywords in zip(windows[-1]["orders"], out):
                if order is not None:
                    spotted.setdefault(order, []).append(keywords)
            return out

        module._score_to_keywords = recorded
        try:
            yield spotted
        finally:
            del module._score_to_keywords

    def check_launches(label, launches, windows, n_utterances, int8):
        rows = sum(w["width"] for w in windows)
        if launches["mel"] != n_utterances:
            raise RuntimeError(f"{label}: K1 launched {launches['mel']} times for {n_utterances} utterances")
        if int8:
            _check_k2_main_path(label, launches, shapes, rows * per_window // len(shapes),
                                f"{per_window // len(shapes)} chunks x {rows} scored rows")
        elif launches["k2"]:
            raise RuntimeError(f"{label}: the fp32 scorer launched K2")

    def reference(label, module, items, int8=False):
        """``run_test(packed=True, batch_size=1)``: the slots=1 transcripts."""
        preds = []
        mel_cuda.kernel.launches = matmul_s8_cuda.kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _recorded_windows(module.generator) as windows, _recorded_k2_shapes() as k2_shapes, \
                keywords_by_utterance(module, windows) as spotted:
            results = module.run_test(items, mel_fn, num_bootstraps=20, batch_size=1, packed=True,
                                      predictions_out=preds)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches, "k2_shapes": k2_shapes}
        report(label, wall, sum(i["seconds"] for i in items), windows, launches, preds,
               torch.cuda.max_memory_allocated())
        print(f"{phase} {label}: run_test RTFx {results['RTFx']!r}, entity recall "
              f"{results['Entity Recall']!r}")
        check_launches(label, launches, windows, len(items), int8)
        if len(preds) != len(items) or not all(preds) or any(w["width"] != 1 for w in windows):
            raise RuntimeError(f"{label}: invalid output {preds}")
        return preds, spotted

    def serve(label, svc, module, items, int8=False):
        """All of ``items`` submitted at once; their transcripts in order."""
        mel_cuda.kernel.launches = matmul_s8_cuda.kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _recorded_windows(module.generator) as windows, _recorded_k2_shapes() as k2_shapes, \
                keywords_by_utterance(module, windows) as spotted:
            features = [mel_fn(item) for item in items]  # K1, once per utterance
            tickets = [svc.submit(f, m) for f, m in features]
            texts = [svc.result(t, timeout=RESULT_TIMEOUT) for t in tickets]
            torch.cuda.synchronize()
        first_ticket = tickets[0]
        spotted = {order - first_ticket: keywords for order, keywords in spotted.items()}
        wall = time.perf_counter() - t0
        launches = {"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches, "k2_shapes": k2_shapes}
        report(label, wall, sum(i["seconds"] for i in items), windows, launches, texts,
               torch.cuda.max_memory_allocated())
        check_launches(label, launches, windows, len(items), int8)
        if any(w["width"] != svc._slots for w in windows):
            raise RuntimeError(f"{label}: a window launched narrower than the service's slots")
        return texts, launches, spotted

    def same(label, got, want):
        """Ticket transcripts and keywords against the slots=1 ones; on a
        difference, the first token (decode step) where the schedules part
        and the keywords spotted differently."""
        (texts, spotted), (solo_texts, solo_spotted) = got, want
        ok = texts == solo_texts and spotted == solo_spotted
        print(f"{phase} {label}: every ticket's transcript and keywords per window equal its slots=1 ones: "
              f"{ok}; keywords spotted per utterance and window "
              f"{[[len(k) for k in spotted[i]] for i in sorted(spotted)]}")
        if not ok:
            for i, (g, w) in enumerate(zip(texts, solo_texts)):
                g, w = g.split(), w.split()
                if g != w:
                    k = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
                    print(f"{phase} {label}: utterance {i} parts at generated token {k}: slots=4 "
                          f"{g[max(0, k - 3):k + 3]} vs slots=1 {w[max(0, k - 3):k + 3]}")
                for n, (a, b) in enumerate(zip(spotted.get(i, []), solo_spotted.get(i, []))):
                    if a != b:
                        print(f"{phase} {label}: utterance {i} window {n} keywords only at slots=4 "
                              f"{sorted(set(a) - set(b))}, only at slots=1 {sorted(set(b) - set(a))}")
            raise RuntimeError(f"{label}: the service's transcripts depend on the schedule")

    return types.SimpleNamespace(fresh=fresh, mel_fn=mel_fn, reference=reference, serve=serve, same=same)


def phase_f2(device, cb, dataset, shapes) -> dict:
    """Serving at whisper-medium widths: phase B's model, ResNet-50 scorer,
    100-keyword catalog, beam-5 fp32 decode with timestamps and
    condition-on-prev, and phase B's four utterances (the 47.5 s one read
    from its WAV):

    1. ``run_test(packed=True, batch_size=1)``, then a
       ``TranscriptionService(slots=4)`` given all four at once: every
       ticket's transcript equals its ``slots=1`` transcript;
    2. ``swap_params`` to a second random checkpoint (seed 1) on the live
       service and one more submission, which decodes under the new
       weights (equal to a ``slots=1`` run under them); a checkpoint of
       another architecture then raises through ``result()``;
    3. 1 again with the int8 scorer (``enable_int8_spotting(1, s8_1x1=
       stages 1-3)``, calibrated on the first window in both runs).

    K1 launches exactly once per utterance and K2 exactly 22 x 13 per row
    of every window (vacant slots are scored too), at phase A2's shapes;
    over the fp32 service run, K4 once per decoder layer of every beam
    step, each step's span reading ``reorder_bytes`` 0.
    Returns the launches of the int8 service run."""
    from enhance_cb_whisper_tpu_torch.runtime.serving import TranscriptionService

    t_start = time.perf_counter()
    kit = _serving_kit(device, cb, shapes, "phase F2")
    fresh, reference, serve, same = kit.fresh, kit.reference, kit.serve, kit.same
    # phase D re-centred the shared head on its own data: centre it on this
    # run's first utterance again (the JSON line's K2 count does not see this)
    _centre_class1(cb, cb.generator._pad_segment(kit.mel_fn(dataset[0])[0]))
    _gemm_row_variance(cb.generator.params)

    solo = reference("fp32 run_test(packed=True, batch_size=1)", fresh(), dataset)
    module = fresh()
    svc = TranscriptionService(module, slots=4)
    try:
        k4_mark = _k4_mark()
        texts, _, spotted = serve("fp32 TranscriptionService(slots=4)", svc, module, dataset)
        _check_k4_main_path("phase F2 fp32 TranscriptionService(slots=4)", k4_mark,
                            cb.whisper_config.decoder_layers)
        same("fp32", (texts, spotted), solo)

        params2 = _second_checkpoint(cb.generator.params, seed=1)
        ref_module = fresh()
        ref_module.generator.swap_params(params2)
        item = dataset[1]
        solo_new, _ = reference("seed 1 run_test(packed=True, batch_size=1)", ref_module, [item])
        del ref_module
        t0 = time.perf_counter()
        svc.swap_params(params2)
        swapped = serve("seed 1 after swap_params on the live service", svc, module, [item])[0]
        print(f"phase F2: swap_params + one utterance {time.perf_counter() - t0!r} s; the new weights' "
              f"transcript equals slots=1 under seed 1: {swapped == solo_new}; differs from seed 0's: "
              f"{swapped[0] != solo[0][1]}")
        if swapped != solo_new or swapped[0] == solo[0][1]:
            raise RuntimeError("the swapped service did not decode under the new weights")
        del params2

        bad = dict(cb.generator.params, decoder=dict(cb.generator.params["decoder"]))
        embed = bad["decoder"]["embed_tokens"]["weight"]
        bad["decoder"]["embed_tokens"] = {"weight": embed[:, : embed.shape[1] // 2]}
        svc.swap_params(bad)
        try:
            svc.result(svc._next_ticket, timeout=RESULT_TIMEOUT)
            raise AssertionError("unreachable: a mismatched checkpoint was accepted")
        except RuntimeError as err:
            cause = err.__cause__
            print(f"phase F2: swap_params of another architecture raised through result(): {err!r} from "
                  f"{cause!r}")
            if not (isinstance(cause, ValueError) and "architecture mismatch" in str(cause)):
                raise
    finally:
        svc.close(wait=False)
        svc._worker.join(RESULT_TIMEOUT)
    if svc._worker.is_alive():
        raise RuntimeError("the serving worker did not stop")
    del module, svc

    solo8 = reference("int8 run_test(packed=True, batch_size=1)", fresh(int8=True), dataset, int8=True)
    module = fresh(int8=True)
    with TranscriptionService(module, slots=4) as svc:
        texts8, launches8, spotted8 = serve("int8 TranscriptionService(slots=4)", svc, module, dataset, int8=True)
    same("int8", (texts8, spotted8), solo8)
    print(f"phase F2: {time.perf_counter() - t_start:.1f} s in all")
    return launches8


# ------------------------------------------------------ phase G: serving levers

# name -> the CBWhisper keyword arguments of each lever alone (the compute
# dtype by name: torch is imported inside the phases)
G_LEVERS = {
    "bf16": {"dtype": "bfloat16"},
    "vocab_int8": {"vocab_int8": True},
    "decoder_int8": {"decoder_int8": True},
    "kv_cache_int8": {"kv_cache_int8": True},
    # staged writes into the int8 cache: the last 16 tokens unquantized
    # until each flush, as the JAX package's kv_staging does
    "kv_cache_int8 + kv_staging 16": {"kv_cache_int8": True, "kv_staging": 16},
    "cross_kv_int8": {"cross_kv_int8": True},
}
# the serving set of configs/cb-whisper-acl.yaml's knobs; it runs with int8
# spotting (kws_int8) on K2
G_SERVING = {"dtype": "bfloat16", "vocab_int8": True, "decoder_int8": True}
BF16_SCALE = 0.02  # the CPU tests' bf16 bound (tests/test_torch_levers.py): a share of max |logit|


def _levers(spec) -> dict:
    import torch

    return {k: getattr(torch, v) if k == "dtype" else v for k, v in spec.items()}


def _bf16_forced_check(label, make, wave, device) -> None:
    """bf16 on the card against bf16 on the CPU, by the CPU tests' rule: the
    CPU's shortform decode of ``wave`` teacher-forced through both, every
    logit within 0.02 x the logits' scale of the CPU's, and the same argmax
    wherever the CPU's top-two margin exceeds twice that bound."""
    import torch

    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
    from enhance_cb_whisper_tpu_torch.models.whisper import decoder_forward

    cbs = {"cpu": make("cpu"), str(device): make(device)}
    gen = cbs["cpu"].generator
    segment = gen._pad_segment(prepare_features(wave, n_mels=80, device="cpu")[0][:, :, : gen.n_segment_frames])
    tokens = gen.generate(segment, cbs["cpu"].opts)
    ids = tokens[:, : int((tokens != cbs["cpu"].opts.pad_token_id).sum())]
    logits = {}
    for dev, cb in cbs.items():
        g = cb.generator
        with torch.no_grad():
            cross_kv = g._cross_kv_fn(g._encode(segment.to(dev)))
            out, _ = decoder_forward(g.params, torch.as_tensor(ids[:, :-1], device=dev), cross_kv, g.config,
                                     dtype=g.dtype)
        logits[dev] = out[0].float().cpu().numpy()
    want, got = logits["cpu"], logits[str(device)]
    bound = BF16_SCALE * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * bound
    agree = bool((got.argmax(-1) == want.argmax(-1))[decided].all())
    print(f"phase G1 {label}: {ids.shape[1] - 1} positions teacher-forced, card vs CPU max |logit diff| "
          f"{err!r} (bound {bound!r}); argmax equal at all {int(decided.sum())} decided positions: {agree}; "
          f"argmax equal at all positions: {bool((got.argmax(-1) == want.argmax(-1)).all())}")
    if err >= bound or not agree:
        raise RuntimeError(f"{label}: bf16 on the card is out of the CPU tests' bound")


def _beam_sample_check(device, wave) -> None:
    """Beam-sample (4 beams at temperature 0.7) on the tiny model, CPU =
    card: the same Gumbel draws (the CPU noise source, injected into both)
    sample the same tokens, and other tokens than beam search."""
    import dataclasses
    from functools import partial

    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
    from enhance_cb_whisper_tpu_torch.decoding.generate import cpu_gumbel_noise

    out = {}
    for dev in ("cpu", device):
        cb = _tiny_pipeline(dev)
        gen = cb.generator
        segment = gen._pad_segment(prepare_features(wave, n_mels=80, device=dev)[0][:, :, : gen.n_segment_frames])
        cross_kv = gen._cross_kv_fn(gen._encode(segment))
        opts = dataclasses.replace(cb.opts, num_beams=4)
        prompt = np.asarray([[3, 10, 11]], np.int64)
        sampled = gen._decode_prompted(cross_kv, prompt, None, opts, False, temperature=0.7,
                                       noise=partial(cpu_gumbel_noise, 1, 1))
        beam = gen._decode_prompted(cross_kv, prompt, None, opts, False)
        out[str(dev)] = (sampled[0], float(sampled[1][0]), beam[0])
    cpu, card = out["cpu"], out[str(device)]
    same = bool((cpu[0] == card[0]).all())
    print(f"phase G1 beam-sample (4 beams, T 0.7, injected CPU draws): tokens cpu = cuda {same}; scores "
          f"{cpu[1]!r} / {card[1]!r}; other tokens than beam search {bool((card[0] != card[2]).any())}")
    if not same or abs(cpu[1] - card[1]) > 1e-4 or (card[0] == card[2]).all():
        raise RuntimeError("beam-sample: the card disagrees with the CPU, or sampled beam search's tokens")


def phase_g1(device) -> None:
    """Each lever on the tiny random CB-Whisper (phase B's), CPU = card.
    Over phase B's two waves (6 s and 21 s: shortform and the seek loop,
    beam-5): identical keywords and transcripts under each int8 lever on
    fp32 (the int8 vocab, the int8 decoder, the int8 self-attention cache,
    whose beams reorder its scales, the int8 cross K/V) and under the s8
    KWS encoder on a separate encoder copy.  bf16 alone, and the serving
    set (bf16 + int8 vocab + int8 decoder, with int8 spotting on phase B's
    K2-eligible ResNet), by the CPU tests' bf16 rule
    (:func:`_bf16_forced_check`); their keywords and transcripts are
    printed."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    waves = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in (6.0, 21.0)]
    for name, spec in G_LEVERS.items():
        if "dtype" in spec:
            continue
        cpu, gpu, _ = _tiny_runs(device, waves, lambda dev, spec=spec: _tiny_pipeline(dev, **_levers(spec)),
                                 int8=False)
        print(f"phase G1 {name}: tiny model cpu vs cuda keywords={gpu[0]} transcripts equal={cpu[1] == gpu[1]}")
        if cpu != gpu:
            raise RuntimeError(f"{name}: the card disagrees with the CPU: {gpu} vs {cpu}")

    built = []

    def s8_encoder(dev):
        cb = _tiny_pipeline(dev, separate_encoder=True)
        cb.enable_int8_kws_encoder(calibration_batches=1)
        built.append(cb)
        return cb

    cpu, gpu, _ = _tiny_runs(device, waves, s8_encoder, int8=False)
    quantized = all("act_scales" in cb.encoder_params["encoder"]["layers"][0] for cb in built)
    print(f"phase G1 s8 KWS encoder (separate encoder copy): cpu vs cuda keywords={gpu[0]} transcripts "
          f"equal={cpu[1] == gpu[1]}; both encoders quantized after the first segment: {quantized}")
    if cpu != gpu or not quantized:
        raise RuntimeError(f"s8 KWS encoder: the card disagrees with the CPU: {gpu} vs {cpu}")
    del built

    _beam_sample_check(device, waves[0])

    k2_tiny, shift, _ = _k2_tiny_resnet(waves)
    for label, spec, int8 in (("bf16", G_LEVERS["bf16"], False), ("serving set + kws_int8", G_SERVING, True)):
        def make(dev, spec=spec, int8=int8):
            if int8:
                return _tiny_pipeline(dev, k2_tiny, class1_shift=shift, **_levers(spec))
            return _tiny_pipeline(dev, **_levers(spec))

        cpu, gpu, launches = _tiny_runs(device, waves, make, int8=int8)
        print(f"phase G1 {label}: tiny model keywords cpu {cpu[0]} cuda {gpu[0]}; transcripts equal "
              f"{cpu[1] == gpu[1]}; K2 launches on the card {launches}")
        if int8 and launches <= 0:
            raise RuntimeError(f"{label}: the card never launched K2")
        _bf16_forced_check(label, make, waves[0], device)
    print(f"phase G1: {time.perf_counter() - t0:.1f} s in all")


def _launches_per_step(gen, steps: int = 4):
    """Device operations (kernels, copies, sets) per beam-5 decoder forward
    of ``gen``, from a torch.profiler window over ``steps`` steps; None
    when the trace shows no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    beams = 5
    with torch.no_grad():
        cross_kv = gen._cross_kv_fn(gen._encode(torch.zeros(
            (1, gen.config.num_mel_bins, gen.n_segment_frames), device=gen.device)))
        prompt = torch.tensor([[50258, 50259, 50359]] * beams, device=gen.device)
        ctx = gen._make_ctx(cross_kv, np.ones((1, 3), np.int64), gen.config.max_target_positions, beams)
        cache, _ = gen._prefill(prompt, ctx, gen.config.max_target_positions)
        gen._decode_step(prompt[:, -1:], cache, ctx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                gen._decode_step(prompt[:, -1:], cache, ctx)
            torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n / steps if n else None


def _lever_run(module, item, label, mel_fn):
    """``run_test`` over the one utterance ``item``, with encode + spot (the
    fused hook or the separate encoder's ``spot_keywords``) and prefill +
    decode timed between synchronizations, the decode steps counted, the
    keywords recorded, each kernel's launches counted over exactly the
    ``run_test`` call, and the peak memory allocated during it."""
    import torch

    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda

    gen = module.generator
    rec = {"spot_s": 0.0, "decode_s": 0.0, "steps": 0, "keywords": []}
    spot_name = "encode_and_spot" if module._encode_spot_hook() is not None else "spot_keywords"
    spot, decode_prompted, decode_step = getattr(module, spot_name), gen._decode_prompted, gen._decode_step
    score_to_keywords = module._score_to_keywords

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec[key] += time.perf_counter() - t0
            return out
        return run

    def counted_step(*args, **kwargs):
        rec["steps"] += 1
        return decode_step(*args, **kwargs)

    def recorded_keywords(stacks, real_rows=None):
        out = score_to_keywords(stacks, real_rows)
        rec["keywords"].extend(out)
        return out

    setattr(module, spot_name, timed(spot, "spot_s"))
    gen._decode_prompted, gen._decode_step = timed(decode_prompted, "decode_s"), counted_step
    module._score_to_keywords = recorded_keywords
    preds = []
    mel_cuda.kernel.launches = matmul_s8_cuda.kernel.launches = 0
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with _recorded_k2_shapes() as k2_shapes:
            module.run_test([item], mel_fn, num_bootstraps=10, predictions_out=preds)
            torch.cuda.synchronize()
    finally:
        delattr(module, spot_name)
        del gen._decode_prompted, gen._decode_step, module._score_to_keywords
    rec.update(wall=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated(), resident=resident,
               launches={"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches, "k2_shapes": k2_shapes},
               tokens=preds[0].split() if preds else [], per_step=_launches_per_step(gen))
    if len(preds) != 1 or not rec["tokens"] or rec["launches"]["mel"] != 1:
        raise RuntimeError(f"{label}: {len(preds)} transcripts, {len(rec['tokens'])} tokens, "
                           f"K1 launched {rec['launches']['mel']} times for one utterance")
    return rec


def phase_g2(device, cb, dataset, shapes) -> dict:
    """The levers at whisper-medium widths (phase B's weights, ResNet-50
    scorer, 100-keyword catalog, beam-5 with timestamps and
    condition-on-prev), each through ``CBWhisper.run_test`` over phase B's
    5.5 s utterance: fp32, each lever alone, the serving set (bf16 + int8
    vocab + int8 decoder) with int8 spotting on K2, and a separate KWS
    encoder (a copy of the ASR encoder) as the s8 encoder, beside its own
    fp32 encode + spot of the window (each int8 mode calibrated on the
    utterance's window before its timed run).  Prints, per run, ms per
    decode step against fp32, encode + spot, peak and resident memory, the
    decode loop's linear count and device operations per step, and the
    token prefix shared with fp32.  The serving set launches K2 exactly 22
    x 13 per scored window at phase A2's shapes and K1 once.  Returns the
    serving set's launches."""
    import torch

    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
    from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper

    t_start = time.perf_counter()
    config = cb.whisper_config
    item = dataset[0]

    def mel_fn(it):
        return prepare_features(it["audio"], n_mels=config.num_mel_bins, device=device)

    _centre_class1(cb, cb.generator._pad_segment(mel_fn(item)[0]))
    linears = config.decoder_layers * 8 + 1  # the decode loop's linears per step, the vocab projection included
    runs = [("fp32", {}, False, False)] + [(name, spec, False, False) for name, spec in G_LEVERS.items()] + [
        ("serving set + kws_int8", G_SERVING, True, False),
        ("separate KWS encoder s8", {}, False, True),
    ]
    out = {}
    for label, spec, kws_int8, separate in runs:
        module = CBWhisper(
            config=cb.config, whisper_config=config, whisper_params=cb.generator.params, kws_model=cb.kws_model,
            catalog=cb.catalog, generation_options=cb.opts, prompt_ids_fn=cb.prompt_ids_fn,
            decode_fn=cb.decode_fn, kws_layer_slice=cb.kws_layer_slice, device=device,
            encoder_params=cb.generator.params if separate else None,
            encoder_config=config if separate else None, **_levers(spec),
        )
        # int8 calibrations on the utterance's window before the timed run
        segment = module.generator._pad_segment(mel_fn(item)[0])
        if kws_int8:
            module.enable_int8_spotting(calibration_batches=1, s8_1x1=S8_STAGES)
            module.encode_and_spot(segment)
        if label.endswith("s8"):
            # the same separate encoder in fp32 first: encode + spot of the window
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fp32_keywords = module.spot_keywords(segment)
                torch.cuda.synchronize()
                fp32_spot_s = time.perf_counter() - t0
            module.enable_int8_kws_encoder(calibration_batches=1)
            module.spot_keywords(segment)
        out[label] = rec = _lever_run(module, item, label, mel_fn)
        base = out["fp32"]
        prefix = next((i for i, (a, b) in enumerate(zip(rec["tokens"], base["tokens"])) if a != b),
                      min(len(rec["tokens"]), len(base["tokens"])))
        per_step = rec["per_step"]
        print(f"phase G2 {label}: {rec['decode_s'] / rec['steps'] * 1e3!r} ms per decode step "
              f"(fp32 {base['decode_s'] / base['steps'] * 1e3!r}) over {rec['steps']} steps; encode + spot "
              f"{rec['spot_s']!r} s (fp32 {base['spot_s']!r}); run_test wall {rec['wall']!r} s; peak memory "
              f"allocated {rec['peak']} B, {rec['resident']} B resident before the run; {linears} decode-loop "
              f"linears per step, {per_step if per_step is None else round(per_step, 1)} device operations "
              f"per decoder forward (beam 5); {len(rec['tokens'])} tokens, prefix shared with fp32 {prefix}; "
              f"K1 launches {rec['launches']['mel']}, K2 launches {rec['launches']['k2']}; keywords per "
              f"window {[len(k) for k in rec['keywords']]}")
        if kws_int8:
            chunks = -(-cb.catalog.num_padded // CHUNK)
            _check_k2_main_path(f"phase G2 {label}", rec["launches"], shapes, chunks * len(rec["keywords"]),
                                f"{chunks} chunks x {len(rec['keywords'])} scored windows")
        elif rec["launches"]["k2"]:
            raise RuntimeError(f"phase G2 {label}: the fp32 scorer launched K2")
        if label.endswith("s8"):
            if "act_scales" not in module.encoder_params["encoder"]["layers"][0]:
                raise RuntimeError("phase G2: the KWS encoder was not quantized")
            print(f"phase G2 s8 KWS encoder: encode + spot {rec['spot_s']!r} s in run_test vs the same separate "
                  f"encoder in fp32 {fp32_spot_s!r} s (spot_keywords on the window, its second call); keywords "
                  f"s8 {rec['keywords']} beside fp32 {fp32_keywords}")
        del module
        torch.cuda.empty_cache()
    print(f"phase G2: {time.perf_counter() - t_start:.1f} s in all")
    return out["serving set + kws_int8"]["launches"]


def phase_g3(device, cb, dataset, shapes) -> None:
    """The live ``TranscriptionService(slots=4)`` in the serving set (bf16 +
    int8 vocab + int8 decoder, int8 spotting on K2) over phase B's 17.25 s
    and 47.5 s utterances: every ticket's transcript and keywords per
    window equal its ``run_test(packed=True, batch_size=1)`` ones; then
    ``swap_params`` to a second random checkpoint (seed 1) on the live
    service re-quantizes it to exactly a fresh generator's weights on that
    checkpoint, and the 17.25 s utterance decodes as under that fresh
    generator (with the service's calibrated scorer), not as under seed 0.  K1 once per
    utterance, K2 exactly 22 x 13 per scored row-window (phase F2's
    checks)."""
    import torch

    from enhance_cb_whisper_tpu_torch.runtime.serving import TranscriptionService

    t_start = time.perf_counter()
    kit = _serving_kit(device, cb, shapes, "phase G3")
    levers = _levers(G_SERVING)
    items = [dataset[1], dataset[3]]
    solo = kit.reference("serving set run_test(packed=True, batch_size=1)", kit.fresh(int8=True, **levers),
                         items, int8=True)
    module = kit.fresh(int8=True, **levers)
    with TranscriptionService(module, slots=4) as svc:
        texts, _, spotted = kit.serve("serving set TranscriptionService(slots=4)", svc, module, items, int8=True)
        kit.same("serving set", (texts, spotted), solo)

        params2 = _second_checkpoint(cb.generator.params, seed=1)
        ref = kit.fresh(params=params2, **levers)
        ref._score_fn, ref._int8_pending = module._score_fn, False  # the service's calibrated int8 scorer
        item = dataset[1]
        solo_new, _ = kit.reference("serving set, seed 1, fresh generator", ref, [item], int8=True)
        t0 = time.perf_counter()
        svc.swap_params(params2)
        swapped = kit.serve("serving set, seed 1 after swap_params on the live service", svc, module, [item],
                            int8=True)[0]

        def leaves(tree, path=""):
            if isinstance(tree, dict):
                return [x for k, v in tree.items() for x in leaves(v, f"{path}.{k}")]
            if isinstance(tree, list):
                return [x for i, v in enumerate(tree) for x in leaves(v, f"{path}.{i}")]
            return [(path, tree)]

        mine, theirs = leaves(module.generator.params), leaves(ref.generator.params)
        same_weights = [p for p, _ in mine] == [p for p, _ in theirs] and all(
            a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b) in zip(mine, theirs))
        print(f"phase G3: swap_params + one utterance {time.perf_counter() - t0!r} s; the swapped weights "
              f"(int8 codes, scales, bf16 casts) equal a fresh generator's on seed 1: {same_weights}; its "
              f"transcript equals the fresh generator's: {swapped == solo_new}; differs from seed 0's: "
              f"{swapped[0] != solo[0][0]}")
        if not same_weights or swapped != solo_new or swapped[0] == solo[0][0]:
            raise RuntimeError("phase G3: the swapped service does not decode as a fresh generator")
        del ref, params2
    print(f"phase G3: {time.perf_counter() - t_start:.1f} s in all")


# ------------------------------------------------------- phase H: training

PHASE_H_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase_h"
TINY_RESNET = dict(num_channels=3, embedding_size=8, hidden_sizes=(8, 16, 24, 32),
                   depths=(1, 1, 1, 1), num_labels=2)
H1_ADV = dict(adversarial_training=True, entropy=True, num_domains=4, accumulate_grad_batches=2)
# the modes of tests/test_torch_train_step.py: (config, batch size, raw batch)
H1_MODES = {
    "plain_unsuppressed_entropy": (dict(num_domains=4, entropy=True,
                                        early_adversary_supression=False), 4, False),
    "adversarial_large_heads_all_dannce": (dict(
        H1_ADV, large_heads=True, kw_type="all", dannce=True, adversarial_train_steps=2,
        adversarial_examples_lr=0.01), 16, False),
    "device_features": (dict(num_domains=4, device_features=(32, 40)), 8, True),
    "remat": (dict(H1_ADV, remat=True), 4, False),
    "bfloat16": (dict(num_domains=4, entropy=True, early_adversary_supression=False,
                      compute_dtype="bfloat16"), 4, False),
}
H_LAYERS, H_DIM, H_KEYWORDS = 12, 1280, 100  # whisper-large-v2's layer slice and width


def _h1_batch(n, raw, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n).astype(np.int64)
    domain = rng.integers(0, 4, n).astype(np.int64)
    if not raw:
        return {"features": rng.standard_normal((n, 3, 48, 48), dtype=np.float32),
                "labels": labels, "domain": domain}
    from enhance_cb_whisper_tpu_torch.data.collators import RawKWSDataCollator

    items = [{"label": int(labels[i]), "mask": 1, "domain": int(domain[i]),
              "kwd_hs": rng.standard_normal((3, int(rng.integers(2, 12)), 8)).astype(np.float32),
              "utt_hs": rng.standard_normal((3, int(rng.integers(20, 60)), 8)).astype(np.float32)}
             for i in range(n)]
    return RawKWSDataCollator(bucket_kwd=4, bucket_utt=16)(items)


def _h1_step(kwargs, n, raw, device, template):
    """One step of the tiny model on ``device`` from ``template``'s weights:
    (gradients, statistics, updated parameters, metric sums) as numpy."""
    import torch

    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.train import kws_train as kt

    config = kt.KWSTrainConfig(**dict(kwargs, learning_rate=1e-3, features_lr=1e-3,
                                      classifier_lr=1e-3, discriminator_lr=1e-3))
    state = kt.init_train_state(config, ResNetConfig(**TINY_RESNET), seed=0, device=device)
    if template is not None:
        state.kws.load_state_dict(template[0])
        if state.disc is not None:
            state.disc.load_state_dict(template[1])
    start = ({k: v.detach().cpu().clone() for k, v in state.kws.state_dict().items()},
             {k: v.detach().cpu().clone() for k, v in state.disc.state_dict().items()}
             if state.disc is not None else None)
    modules = {"kws": state.kws, **({"disc": state.disc} if state.disc is not None else {})}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in params:
        p.grad = None
    batch = {k: torch.from_numpy(v).to(device) for k, v in _h1_batch(n, raw, SEED + 40).items()}
    # the same draws on both devices: CPU-seeded, then moved
    noise = kt.StepNoise(kt.step_seed(SEED, 0), device)
    sums, _ = kt.make_grad_fn(config, state.kws, state.disc)(batch, noise, 0.1, 0.5)
    grads = {f"{m}.{k}": p.grad.detach().cpu().numpy().copy()
             for m, mod in modules.items() for k, p in mod.named_parameters()}
    stats = {k: v.detach().cpu().numpy().copy() for k, v in state.kws.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    state.optimizer.step()
    updated = {f"{m}.{k}": p.detach().cpu().numpy().copy()
               for m, mod in modules.items() for k, p in mod.named_parameters()}
    return start, grads, stats, updated, {k: float(v) for k, v in sums.items()}


def _rel_l2(got: dict, want: dict) -> float:
    a = np.concatenate([got[k].ravel() for k in want])
    b = np.concatenate([want[k].ravel() for k in want])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_h1(device) -> None:
    """Each train-step mode of the CPU tests on the tiny model: one step on
    the CPU and one on the card from the same weights with the same draws.
    fp32 (remat included): every gradient within rtol 1e-4 + 2e-4 x the
    leaf's largest magnitude, every running statistic within rtol 1e-4,
    atol 1e-5, the metric sums within 1e-5 relative, and the updated
    weights within 2.5e-3 (one Adam step of rate 1e-3 moves a weight by
    about the rate whatever its gradient's size, so a gradient at rounding
    level can step the other way) with at least 95 % of them within 1e-5.
    bf16: the card's gradient no further from the CPU's in relative L2 than
    twice the CPU's own bf16-vs-fp32 distance, the statistics within 0.05."""
    cpu_f32 = None
    for name, (kwargs, n, raw) in H1_MODES.items():
        t0 = time.perf_counter()
        start, g_cpu, s_cpu, u_cpu, m_cpu = _h1_step(kwargs, n, raw, "cpu", None)
        _, g_dev, s_dev, u_dev, m_dev = _h1_step(kwargs, n, raw, device, start)
        if name == "plain_unsuppressed_entropy":
            cpu_f32 = g_cpu
        if kwargs.get("compute_dtype") == "bfloat16":
            bound = 2 * _rel_l2(g_cpu, cpu_f32)
            gap, s_gap = _rel_l2(g_dev, g_cpu), _rel_l2(s_dev, s_cpu)
            ok = gap <= bound and s_gap <= 0.05
            print(f"phase H1 {name}: grad rel L2 card vs CPU {gap!r} (bound {bound!r}), "
                  f"statistics {s_gap!r} (bound 0.05), metrics card {m_dev} CPU {m_cpu}")
            if not ok:
                raise RuntimeError(f"phase H1 {name}: the card's bf16 step is off the CPU's")
            continue
        worst_grad = max(float(np.abs(g_dev[k] - g_cpu[k]).max() / (np.abs(g_cpu[k]).max() or 1.0))
                         for k in g_cpu)
        for k in g_cpu:
            np.testing.assert_allclose(g_dev[k], g_cpu[k], rtol=1e-4,
                                       atol=2e-4 * (float(np.abs(g_cpu[k]).max()) or 1.0),
                                       err_msg=f"phase H1 {name} grad {k}")
        for k in s_cpu:
            np.testing.assert_allclose(s_dev[k], s_cpu[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"phase H1 {name} statistic {k}")
        for k in m_cpu:
            if abs(m_dev[k] - m_cpu[k]) > 1e-5 * max(abs(m_cpu[k]), 1e-6) + 1e-6:
                raise RuntimeError(f"phase H1 {name}: metric {k} card {m_dev[k]!r} CPU {m_cpu[k]!r}")
        diffs = np.concatenate([np.abs(u_dev[k] - u_cpu[k]).ravel() for k in u_cpu])
        if diffs.max() > 2.5e-3 or (diffs <= 1e-5).mean() < 0.95:
            raise RuntimeError(f"phase H1 {name}: updated weights max diff {diffs.max()!r}, "
                               f"{(diffs <= 1e-5).mean()!r} within 1e-5")
        print(f"phase H1 {name}: card = CPU (worst grad diff / leaf scale {worst_grad!r}, "
              f"updated weights max diff {diffs.max()!r}, {(diffs <= 1e-5).mean()!r} within 1e-5; "
              f"metrics {m_dev}) in {time.perf_counter() - t0:.1f} s")


def _h_stack(gen, frames, device):
    """An L2-normalized [12, frames, 1280] f32 stack drawn on the card."""
    import torch

    x = torch.randn(H_LAYERS, frames, H_DIM, generator=gen, device=device)
    return (x / x.norm(dim=-1, keepdim=True)).cpu().numpy()


def _write_h_data(root: Path, device, utt_frames, n_codes: int, seed: int) -> None:
    """A synthetic AISHELL layout at whisper-large-v2 widths: ``kws/`` (100
    keywords of 20-60 frames, tts and natural; ``n_codes`` utterances with
    two positives each, stacks of ``utt_frames`` frames, linked to one file
    per distinct stack) and ``hotword/{dev,test}/`` (the 100 keywords as
    hotwords, 4 utterances each)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    kws = root / "kws"
    (kws / "hs").mkdir(parents=True, exist_ok=True)
    keywords = [f"kw{i:02d}" for i in range(H_KEYWORDS)]
    (kws / "keywords.txt").write_text("\n".join(keywords) + "\n")
    kw_frames = rng.integers(20, 61, H_KEYWORDS)
    for kw_type in ("tts", "natural"):
        d = kws / "keywords-hs" / kw_type
        d.mkdir(parents=True, exist_ok=True)
        for i in range(H_KEYWORDS):
            np.save(d / f"{i:02d}.npy", _h_stack(gen, int(kw_frames[i]), device))
    distinct = root / "stacks"
    distinct.mkdir(exist_ok=True)
    for j, frames in enumerate(utt_frames):
        np.save(distinct / f"{j}.npy", _h_stack(gen, int(frames), device))
    rev = sorted(keywords, key=lambda x: x[::-1])
    lines = []
    for u in range(n_codes):
        code = f"UTT{u:04d}"
        (kws / "hs" / f"{code}.npy").symlink_to(distinct / f"{u % len(utt_frames)}.npy")
        parts = [code]
        for p in sorted(rng.choice(H_KEYWORDS, size=2, replace=False).tolist()):
            parts += [keywords[p], str(p), str(rev.index(keywords[p]))]
        lines.append("\t".join(parts))
    (kws / "positives.tsv").write_text("\n".join(lines) + "\n")
    for split in ("dev", "test"):
        sd = root / "hotword" / split
        (sd / "hs").mkdir(parents=True, exist_ok=True)
        (sd / "hotword.txt").write_text("\n".join(keywords) + "\n")
        for kw_type in ("tts", "natural"):
            (sd / "keywords-hs").mkdir(exist_ok=True)
            (sd / "keywords-hs" / kw_type).symlink_to(kws / "keywords-hs" / kw_type)
        text = []
        for u in range(4):
            code = f"BAC009S{u + 1:04d}W{u + 1:04d}"
            (sd / "hs" / f"{code}.npy").symlink_to(distinct / f"{(2 * u + 1) % len(utt_frames)}.npy")
            text.append(f"{code} 前缀{keywords[(7 * u) % H_KEYWORDS]}后缀{keywords[(7 * u + 3) % H_KEYWORDS]}")
        (sd / "text").write_text("\n".join(text) + "\n")


@contextlib.contextmanager
def _recorded_steps():
    """Time each train step the engine makes (synchronised) and keep the
    last one's step function and batch for the profiler."""
    import torch

    import enhance_cb_whisper_tpu_torch.runtime.kws_engine as ke

    real = ke.make_train_step
    rec = {"ms": [], "examples": [], "starts": [], "ends": [], "losses": [], "last": None}

    def make(config, state):
        step = real(config, state)
        rec["initial"] = [p.detach().clone() for p in state.kws.parameters()]

        def timed(batch, noise, beta, suppression):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(batch, noise, beta, suppression)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec["ms"].append((t1 - t0) * 1e3)
            rec["starts"].append(t0)
            rec["ends"].append(t1)
            rec["examples"].append(int(batch["labels"].shape[0]))
            rec["losses"].append(float(out["class_loss"]))
            rec["last"] = (step, batch, noise, beta, suppression)
            return out

        return timed

    ke.make_train_step = make
    try:
        yield rec
    finally:
        ke.make_train_step = real


def _step_breakdown(label, rec, peak_rate=FP32_RATE) -> None:
    """Device time of one train step on the last batch of a run, by what
    launched it (torch.profiler, the second of two profiled steps): the
    convolutions forward and backward, BatchNorm, the optimizer, the rest;
    the idle share against the median of three unprofiled steps; and the
    step's bound, its convolution and matmul operations (counted by
    ``FlopCounterMode`` over one step) at ``peak_rate`` (the bytes, a few
    hundred MB of weights, optimizer state and activations read once, are
    a smaller bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    step, batch, noise, beta, suppression = rec["last"]
    with FlopCounterMode(display=False) as counter:
        step(batch, noise, beta, suppression)
    flops = counter.get_total_flops()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, noise, beta, suppression)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(batch, noise, beta, suppression)
            torch.cuda.synchronize()
    parts = {"conv forward": 0.0, "conv backward": 0.0, "batchnorm": 0.0, "optimizer": 0.0}
    kernels = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels += us
            continue
        name = evt.key
        if name in ("aten::cudnn_convolution", "aten::convolution_overrideable"):
            parts["conv forward"] += us
        elif name.startswith("aten::convolution_backward") or "cudnn_convolution_backward" in name:
            parts["conv backward"] += us
        elif "batch_norm" in name:
            parts["batchnorm"] += us
        elif "_foreach" in name or name.startswith("Optimizer.step"):
            parts["optimizer"] += us
    parts["other"] = kernels - sum(parts.values())
    text = ", ".join(f"{k} {v / 1e3!r} ms" for k, v in parts.items())
    bound_ms = flops / peak_rate * 1e3
    print(f"{label}: one step of {int(batch['labels'].shape[0])} examples: wall {wall!r} ms "
          f"unprofiled (median of 3: {walls!r}); device {kernels / 1e3!r} ms (idle share "
          f"{1 - kernels / 1e3 / wall!r}): {text}; {flops / 1e12!r} TFLOP of convolutions and "
          f"matmuls, bound {bound_ms!r} ms at {peak_rate / 1e12:g} TFLOP/s, the step "
          f"{wall / bound_ms!r}x it")


def _report_run(label, rec, seconds) -> None:
    import torch

    if not rec["ms"]:
        raise RuntimeError(f"{label}: no train step ran")
    losses = np.asarray(rec["losses"])
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{label}: a non-finite loss {losses}")
    examples = sum(rec["examples"])
    span = rec["ends"][-1] - rec["starts"][0]
    later = rec["ms"][1:] or rec["ms"]
    print(f"{label}: {len(rec['ms'])} steps of {rec['examples'][0]} examples in {seconds!r} s "
          f"(CLI call); step {statistics.median(later)!r} ms median after the first "
          f"(first {rec['ms'][0]!r} ms), {examples / span!r} examples/s from the first step's "
          f"start to the last one's end, {rec['examples'][0] / statistics.median(later) * 1e3!r} "
          f"examples/s within a step; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB; loss {losses.tolist()}")


def _h_argv(root: Path, run: str, *overrides):
    return ["fit", "--config", str(CONFIGS / "train.yaml"),
            "--set", "MAX_EPOCHS=2", "--set", "EVERY_N_EPOCHS=1",
            "--set", f"DEFAULT_ROOT_DIR={PHASE_H_DIR / run}", "--set", f"RUN_NAME={run}",
            "--set", "MODALITY=tts", "--set", "TRAIN_DATASET_NAME=aishell",
            "--set", f"TRAIN_DATASET_ROOT={root}", "--set", f"AISHELL_ROOT={root}",
            "--set", f"ACL_ROOT={root}",
            "--data.init_args.val_info", f"[{{name: aishell, root: '{root}', kw_type: tts}}]",
            *overrides]


def _h_fit(label, device, argv):
    import torch

    from enhance_cb_whisper_tpu_torch.cli import run_cli

    torch.cuda.reset_peak_memory_stats()
    with _recorded_steps() as rec:
        t0 = time.perf_counter()
        state = run_cli(argv, device=device)
        seconds = time.perf_counter() - t0
    # a loader cut by limit_train_batches leaves its thread finishing one
    # more batch: let it end before the next run is timed
    for thread in threading.enumerate():
        if thread is not threading.current_thread() and thread.daemon:
            thread.join(timeout=120)
    _report_run(label, rec, seconds)
    return state, rec


def _moved(label, state, rec, ckpt_dir: Path) -> None:
    """The run's weights against those it started from."""
    import torch

    moved = max(float((p.detach() - q).abs().max())
                for p, q in zip(state.kws.parameters(), rec["initial"]))
    if not moved > 0:
        raise RuntimeError(f"{label}: the parameters did not move")
    if not all(bool(torch.isfinite(p).all()) for p in state.kws.parameters()):
        raise RuntimeError(f"{label}: non-finite parameters")
    print(f"{label}: largest weight change from the run's first weights {moved!r}; "
          f"checkpoints {sorted(p.name for p in ckpt_dir.iterdir())}")


def phase_h2(device) -> None:
    """paper-1 training at full width from files through ``run_cli(["fit",
    ...])`` on configs/train.yaml (the 12-channel ResNet-50 at 150x750,
    batch 20, large heads): the host collator (one epoch of two batches),
    device_features (two epochs of two batches; ten before phase Q took
    the time), bf16 (two batches), adversarial training with 8 x 20
    accumulated examples a step (one step) and one DANNCE step, then a
    resume from the written checkpoint (one batch) and ``test`` on it."""
    import shutil

    from enhance_cb_whisper_tpu_torch.cli import run_cli

    shutil.rmtree(PHASE_H_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        main_root, short_root = PHASE_H_DIR / "aishell", PHASE_H_DIR / "aishell_short"
        _write_h_data(main_root, device, np.linspace(250, 1500, 8).astype(int), 50, SEED + 50)
        # the adversarial steps take 160 examples a batch: at up to 1500
        # frames the raw batch would be 15 GB on the host, and the
        # prefetch queue keeps up to four alive, so they read 250-500
        _write_h_data(short_root, device, np.linspace(250, 500, 8).astype(int), 80, SEED + 51)
        print(f"phase H2: data written in {time.perf_counter() - t0:.1f} s (100 keywords of "
              f"20-60 frames, 50 utterances of 250-1500 frames and 80 of 250-500, "
              f"{H_LAYERS} x {H_DIM})")

        state, rec = _h_fit("phase H2 host collator", device,
                            _h_argv(main_root, "host", "--trainer.limit_train_batches", "2",
                                    "--trainer.max_epochs", "1"))
        _step_breakdown("phase H2 host collator", rec)
        _moved("phase H2 host collator", state, rec, PHASE_H_DIR / "host" / "checkpoints")
        state, rec = _h_fit("phase H2 device_features", device,
                            _h_argv(main_root, "device", "--data.init_args.device_features", "true",
                                    "--trainer.limit_train_batches", "2"))
        _step_breakdown("phase H2 device_features", rec)
        _moved("phase H2 device_features", state, rec, PHASE_H_DIR / "device" / "checkpoints")
        # the bf16 lever (bf16 activations and convolutions, f32 weights)
        state, rec = _h_fit("phase H2 device_features bf16", device,
                            _h_argv(main_root, "bf16", "--data.init_args.device_features", "true",
                                    "--model.init_args.compute_dtype", "bfloat16",
                                    "--trainer.max_epochs", "1", "--trainer.limit_train_batches", "2"))
        _step_breakdown("phase H2 device_features bf16", rec, peak_rate=BF16_RATE)
        adv = ("--model.init_args.adversarial_training", "true", "--data.init_args.device_features",
               "true", "--trainer.max_epochs", "1")
        state, rec = _h_fit("phase H2 adversarial", device,
                            _h_argv(short_root, "adversarial", *adv,
                                    "--trainer.limit_train_batches", "1"))
        _step_breakdown("phase H2 adversarial", rec)
        _moved("phase H2 adversarial", state, rec, PHASE_H_DIR / "adversarial" / "checkpoints")
        state, rec = _h_fit("phase H2 DANNCE", device,
                            _h_argv(short_root, "dannce", *adv, "--model.init_args.dannce", "true",
                                    "--trainer.limit_train_batches", "1"))
        _moved("phase H2 DANNCE", state, rec, PHASE_H_DIR / "dannce" / "checkpoints")
        final = PHASE_H_DIR / "device" / "checkpoints" / "final"
        state, rec = _h_fit("phase H2 resume", device,
                            _h_argv(main_root, "device", "--data.init_args.device_features", "true",
                                    "--trainer.max_epochs", "3", "--trainer.limit_train_batches", "1",
                                    "--ckpt_path", str(final)))
        if state.epoch != 2:
            raise RuntimeError(f"phase H2 resume: trained epoch {state.epoch}, expected 2")
        t0 = time.perf_counter()
        test_argv = ["test", *_h_argv(main_root, "device", "--ckpt_path", str(final))[1:]]
        results = run_cli(test_argv, device=device)
        if not all(np.isfinite(v) for v in results.values()):
            raise RuntimeError(f"phase H2 test: {results}")
        print(f"phase H2 test on the written checkpoint in {time.perf_counter() - t0:.1f} s: {results}")
    finally:
        shutil.rmtree(PHASE_H_DIR, ignore_errors=True)


def phase_h(device) -> dict:
    """Phase H: K1's and K2's launches over the training path (none)."""
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda

    mel_cuda.kernel.launches = matmul_s8_cuda.kernel.launches = 0
    t0 = time.perf_counter()
    phase_h1(device)
    phase_h2(device)
    launches = {"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches}
    print(f"phase H: {time.perf_counter() - t0:.1f} s; kernel launches on the training path {launches}")
    return launches


# ------------------------------------------------------- phase I: paper 2

PHASE_I_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase_i"
P2_SIZE = (150, 1500)  # features_size of configs/efficient_kws/eval-*.yaml
P2_LEF_MAPS = (75, 750)  # LEF's maps: both frame axes halved
P2_CHUNK = 50  # keyword-DB rows per classifier launch (efficient_kws.engine.CHUNK)
P2_N_KW = 100
P2_VARIANTS = {"L": {}, "LE": {"learn_features": True, "proj_mlp": True},
               "LEF": {"learn_features": True, "proj_mlp": True, "frames_conv": True}}


def p2_k2_shapes() -> dict:
    """K2's launches per chunk of the paper-2 int8 ResNet-50 (3 channels):
    L and LE at 150 x 1500 maps, LEF at 75 x 750."""
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig

    cfg = ResNetConfig.from_version("resnet-50", num_channels=3)
    return {"L/LE": k2_launch_shapes(cfg, size=P2_SIZE, batch=P2_CHUNK),
            "LEF": k2_launch_shapes(cfg, size=P2_LEF_MAPS, batch=P2_CHUNK)}


def resnet_conv_flops(cfg, size) -> int:
    """FLOPs (2 per multiply-add) of every convolution of one ResNet forward
    over one map of ``size``: stem, block convolutions and shortcuts."""
    def conv(n, k, s):
        return (n + 2 * (k // 2) - k) // s + 1

    h, w = conv(size[0], 7, 2), conv(size[1], 7, 2)
    flops = 2 * 49 * cfg.num_channels * cfg.embedding_size * h * w
    h, w, in_ch = conv(h, 3, 2), conv(w, 3, 2), cfg.embedding_size
    for stage, (width, depth) in enumerate(zip(cfg.hidden_sizes, cfg.depths)):
        for block in range(depth):
            stride = (2 if stage > 0 or cfg.downsample_in_first_stage else 1) if block == 0 else 1
            ho, wo = conv(h, 3, stride), conv(w, 3, stride)
            if cfg.layer_type == "bottleneck":
                red = width // 4
                flops += 2 * (in_ch * red * h * w + 9 * red * red * ho * wo + red * width * ho * wo)
            else:
                flops += 2 * 9 * (in_ch * width + width * width) * ho * wo
            if in_ch != width or stride != 1:
                flops += 2 * in_ch * width * ho * wo
            h, w, in_ch = ho, wo, width
    return flops


def _init_p2_model(model, seed: int):
    """Random weights for a paper-2 model, drawn on the CPU from ``seed``:
    He-normal convolutions, LeCun-normal linears with zero biases, identity
    BatchNorm statistics, and the last BatchNorm of each residual branch at
    0.2 (nonzero, so K2's fused tails compute something)."""
    import torch
    from torch import nn

    from enhance_cb_whisper_tpu_torch.models.resnet import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    last = "layer_2.normalization" if model.config.resnet_config().layer_type == "bottleneck" \
        else "layer_1.normalization"
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                gain = 1.0 if isinstance(m, nn.Linear) else 2.0
                m.weight.normal_(0.0, float(np.sqrt(gain / m.weight[0].numel())), generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(0.2 if name.endswith(last) else 1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model.eval()


def _p2_centre(engine, model, dataset, n_items: int) -> float:
    """Move the class-1 bias into the widest gap of the first items' real
    margins (:func:`_gap_shift`): both decisions occur, far from 0.5."""
    import torch

    from enhance_cb_whisper_tpu_torch.efficient_kws.engine import keyword_db

    margins = []
    db = keyword_db(model, dataset)
    for i in range(n_items):
        item = dataset[i]
        _, logits = engine.score_item(model, db, item)
        margins.extend((logits[:, 1] - logits[:, 0])[item["hotword_mask"] > 0].tolist())
    shift = _gap_shift(margins)
    with torch.no_grad():
        model.classifier.bias[1] -= shift
    return shift


def _p2_datamodule(root: Path, size, n_layers: int, group: int):
    from enhance_cb_whisper_tpu_torch.efficient_kws.data import EfficientKWSDataMod

    dm = EfficientKWSDataMod(batch_size=1, features_size=size, n_layers=n_layers, keywords_per_group=group,
                             test_info={"name": "acl", "root": str(root), "kw_type": "tts"})
    dm.setup("test")
    return dm


def phase_i1(device) -> None:
    """CPU = card on a tiny paper-2 model (2 layers, D 16, U 8, ResNet-18 at
    32 x 64) over a 10-keyword ACL-6060 layout, the keyword DB scored 4 rows
    at a time (chunks that cross its 4-keyword groups): every keyword's
    probability within rtol 1e-4 / atol 1e-5 for L, LE and LEF and
    ``test``'s metrics equal; then LE with ``kws_int8`` on a ResNet whose
    stage_1 1x1s take K2: probabilities within 1e-3, the same decisions and
    metrics, K2 launched on the card."""
    import copy
    import dataclasses

    import torch

    from enhance_cb_whisper_tpu_torch.efficient_kws import engine as engine_mod
    from enhance_cb_whisper_tpu_torch.efficient_kws.engine import EfficientKWSEngine, keyword_db
    from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSConfig, EfficientKWSModel
    from enhance_cb_whisper_tpu_torch.models.quant import s8_stages
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda

    rng = np.random.default_rng(SEED + 8)
    keywords = [f"term{i}" for i in range(10)]
    stacks = _stacks(rng, len(keywords), 3, lambda i: int(rng.integers(4, 20)), 16)
    _write_acl(PHASE_I_DIR / "tiny", keywords, stacks,
               _utterances(rng, [(1.0, 16000), (1.5, 16000), (0.8, 16000)], keywords, 3, 16))
    dm = _p2_datamodule(PHASE_I_DIR / "tiny", (32, 64), 2, 4)
    ds = dm.test_dataset
    tiny_k2 = ResNetConfig(num_channels=2, embedding_size=32, hidden_sizes=(128, 512), depths=(1, 3))

    @dataclasses.dataclass(frozen=True)
    class K2Tiny(EfficientKWSConfig):
        def resnet_config(self):
            return tiny_k2

    runs = [(v, EfficientKWSConfig(n_layers=2, embedding_dim=16, proj_mlp_units=8, resnet_version="resnet-18",
                                   **P2_VARIANTS[v]), False) for v in P2_VARIANTS]
    runs.append(("LE kws_int8", K2Tiny(n_layers=2, embedding_dim=16, proj_mlp_units=8, **P2_VARIANTS["LE"]), True))
    chunk, engine_mod.CHUNK = engine_mod.CHUNK, 4
    try:
        for label, cfg, int8 in runs:
            cpu_model = _init_p2_model(EfficientKWSModel(cfg), SEED)
            engines = {dev: EfficientKWSEngine(cfg, device=dev) for dev in ("cpu", device)}
            _p2_centre(engines["cpu"], cpu_model, ds, len(ds))
            models = {"cpu": cpu_model, device: copy.deepcopy(cpu_model).to(device)}
            probs, results = {}, {}
            for dev, engine in engines.items():
                if int8:
                    engine.enable_int8_scoring(models[dev], items=[ds[0], ds[1]], s8_1x1=s8_stages(tiny_k2))
                matmul_s8_cuda.kernel.launches = 0
                db = keyword_db(models[dev], ds)
                probs[dev] = np.concatenate([engine.score_item(models[dev], db, ds[i])[0] for i in range(len(ds))])
                launches = matmul_s8_cuda.kernel.launches
                results[dev] = engine.test(models[dev], dm, num_bootstraps=100)
            got, want = torch.from_numpy(probs[device]), torch.from_numpy(probs["cpu"])
            max_abs, _, ok = _close(got, want)
            if int8:  # bf16 intermediates can round a code the other way: the engine tests' 1e-3
                ok = max_abs <= 1e-3
            same = bool(((got > 0.5) == (want > 0.5)).all())
            print(f"phase I1 {label}: tiny model cpu vs cuda, {len(ds)} utterances x {len(keywords)} keywords: "
                  f"max |p diff| {max_abs!r} ({'atol 1e-3' if int8 else f'rtol {RTOL}, atol {ATOL}'}) "
                  f"{'ok' if ok else 'over'}; decisions equal {same}; test() equal "
                  f"{results['cpu'] == results[device]}; K2 launches on the card {launches}")
            if not (same and ok and results["cpu"] == results[device]):
                raise RuntimeError(f"phase I1 {label}: the card disagrees with the CPU: {results}")
            if int8 and launches <= 0:
                raise RuntimeError("phase I1: the int8 paper-2 scorer never launched K2")
    finally:
        engine_mod.CHUNK = chunk


def phase_i2(device, shapes) -> dict:
    """The CLI at full width on the card: an ACL-6060 test layout of 100
    keywords (12-layer 1024-wide stacks of 4-39 frames) and 4 utterances of
    500-1500 frames, a reference Lightning .ckpt per variant (random
    weights, the class-1 bias in a gap of the margins), then
    ``run_cli(["test", "--config", configs/efficient_kws/eval-{L,LE,LEF}-
    comp-acl.yaml, ...])`` and LEF once more with ``kws_int8``: wall, device
    ms per pair and idle share (one 30 s utterance, torch.profiler), peak
    memory, P/R/F1, and under int8 K2's launches against ``shapes``."""
    import torch

    from enhance_cb_whisper_tpu_torch.cli import run_cli
    from enhance_cb_whisper_tpu_torch.efficient_kws import engine as engine_mod
    from enhance_cb_whisper_tpu_torch.efficient_kws.engine import EfficientKWSEngine, keyword_db
    from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSConfig, EfficientKWSModel
    from enhance_cb_whisper_tpu_torch.efficient_kws.torch_compat import lightning_efficient_kws
    from enhance_cb_whisper_tpu_torch.models.quant import s8_stages
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda

    rng = np.random.default_rng(SEED + 9)
    root = PHASE_I_DIR / "acl"
    keywords = [f"term{i}" for i in range(P2_N_KW)]
    t0 = time.perf_counter()
    stacks = _stacks(rng, P2_N_KW, 12, lambda i: int(rng.integers(4, 40)), 1024)
    utterances = _utterances(rng, [(30.0, 16000), (30.0, 16000), (20.0, 16000), (10.0, 16000)], keywords, 12, 1024)
    _write_acl(root, keywords, stacks, utterances)
    dm = _p2_datamodule(root, P2_SIZE, 3, P2_CHUNK)
    ds = dm.test_dataset
    print(f"phase I2: ACL-6060 layout of {P2_N_KW} keywords and {len(utterances)} utterances of "
          f"{[u['hs'].shape[1] for u in utterances]} frames (12 x 1024 stacks) written and read in "
          f"{time.perf_counter() - t0:.1f} s")
    if engine_mod.CHUNK != P2_CHUNK:
        raise RuntimeError(f"phase I2: the engine scores {engine_mod.CHUNK} rows a launch, A2 held {P2_CHUNK}")
    launches = {"mel": 0, "k2": 0}
    runs = [(v, False) for v in P2_VARIANTS] + [("LEF", True)]
    for i, (variant, int8) in enumerate(runs):
        label = f"phase I2 {variant}" + (" kws_int8" if int8 else "")
        cfg = EfficientKWSConfig(**P2_VARIANTS[variant])  # n_layers 3, D 1024, U 64, ResNet-50
        model = _init_p2_model(EfficientKWSModel(cfg), SEED + i).to(device)
        engine = EfficientKWSEngine(cfg, device=device)
        shift = _p2_centre(engine, model, ds, 2)
        ckpt = PHASE_I_DIR / f"{variant}.ckpt"
        torch.save({"state_dict": lightning_efficient_kws(model.state_dict(), cfg)}, str(ckpt))
        if int8:
            engine.enable_int8_scoring(model, items=[ds[j] for j in range(4)], s8_1x1=s8_stages(cfg.resnet_config()))
        db = keyword_db(model, ds)
        _, device_ms = _device_breakdown(f"{label}: one 30 s utterance x {P2_N_KW} keywords",
                                         lambda: engine.score_item(model, db, ds[0]))
        argv = ["test", "--config", str(CONFIGS / "efficient_kws" / f"eval-{variant}-comp-acl.yaml"),
                "--set", f"CKPT={ckpt}", "--set", "THRESHOLD=0.5", "--set", f"ACL_ROOT={root}"]
        if int8:
            argv += ["--model.init_args.kws_int8", "true"]
        del model, engine, db
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mel_cuda.kernel.launches = matmul_s8_cuda.kernel.launches = 0
        t0 = time.perf_counter()
        with _recorded_k2_shapes() as k2_shapes:
            results = run_cli(argv)  # the default device: the card
        wall = time.perf_counter() - t0
        run = {"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches, "k2_shapes": k2_shapes}
        peak = torch.cuda.max_memory_allocated() / 2**30
        pairs = len(ds) * P2_N_KW
        print(f"{label}: run_cli {wall!r} s for {len(ds)} utterances x {P2_N_KW} keywords "
              f"({wall / pairs * 1e3!r} ms per pair, checkpoint read and int8 calibration included); device "
              f"{device_ms / P2_N_KW!r} ms per pair (above); peak {peak!r} GiB; class-1 shift {shift!r}; "
              f"P {results['Precision']!r} [{results['Precision_LB']!r}, {results['Precision_UB']!r}] "
              f"R {results['Recall']!r} F1 {results['F1']!r}; K1 launches {run['mel']}, K2 launches {run['k2']}")
        if not all(np.isfinite(v) and 0 <= v <= 1 for v in results.values()):
            raise RuntimeError(f"{label}: invalid metrics {results}")
        if int8:
            chunks = -(-P2_N_KW // P2_CHUNK)
            _check_k2_main_path(label, run, shapes, chunks * len(ds), f"{chunks} chunks x {len(ds)} utterances")
        elif run["k2"]:
            raise RuntimeError(f"{label}: the fp32 scorer launched K2")
        launches = {k: launches[k] + run[k] for k in launches}
    return launches


def _event_ms(fn, reps: int = 3) -> float:
    """Median device time of ``fn()`` by CUDA events, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_i3(device) -> dict:
    """Catalog scoring at the paper's scale (bench_catalog100k.py's
    workload: LEF, ResNet-50, U 64, a 1500-frame utterance, chunks of 128,
    random weights): ``project_catalog`` of 1,024 raw keywords [3, 150,
    1024] and ``make_projected_score_fn`` over them in fp32; the bench's
    bf16 projected catalog [N, 3, 75, 64] at N = 4,096; and
    ``make_cascade_score_fn`` at N = 100,352 with a shortlist of 2,048 (bf16
    proxy).  Keywords/s, device ms (CUDA events), peak memory and each run's
    bound: the ResNet's convolution FLOPs per pair (plus the proxy's
    similarity FLOPs for the cascade) at the FP32 or bf16 peak, or the
    catalog's bytes at the HBM rate, whichever is larger.  The cascade must
    launch K3 twice a score, and its ``ecw.catalog.proxy`` spans must say so;
    returns K1's, K2's and K3's launches over the phase."""
    import torch

    from enhance_cb_whisper_tpu_torch.efficient_kws.catalog import (
        make_cascade_score_fn,
        make_projected_score_fn,
        project_catalog,
    )
    from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSConfig, EfficientKWSModel
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, maxsim_cuda, mel_cuda
    from enhance_cb_whisper_tpu_torch.runtime import profiler

    mel_cuda.kernel.launches = matmul_s8_cuda.kernel.launches = 0
    chunk, layers, units = 128, 3, 64
    cfg = EfficientKWSConfig(**P2_VARIANTS["LEF"])
    model = _init_p2_model(EfficientKWSModel(cfg), SEED + 20).to(device)
    bf16 = EfficientKWSModel(cfg, dtype=torch.bfloat16).to(device).eval()
    bf16.load_state_dict(model.state_dict())
    gen = torch.Generator(device=device).manual_seed(SEED)
    utt = torch.randn((1, layers, P2_SIZE[1], 1024), generator=gen, device=device)
    utt_mask = torch.ones((1, layers, P2_SIZE[1]), device=device)
    flops = resnet_conv_flops(cfg.resnet_config(), P2_LEF_MAPS)

    def random_catalog(n):
        """The bench's pre-projected LEF catalog, made on the card in bf16."""
        return {"kwd": torch.randn((n, layers, P2_LEF_MAPS[0], units), generator=gen, device=device,
                                   dtype=torch.bfloat16),
                "kwd_mask": torch.ones((n, layers, P2_LEF_MAPS[0]), device=device, dtype=torch.bfloat16),
                "mask": torch.ones((n,), device=device), "num_keywords": n, "chunk": chunk}

    def report(label, n, score, catalog, rate, extra_flops=0, exact=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = _event_ms(lambda: score(catalog, utt, utt_mask))
        peak = torch.cuda.max_memory_allocated() / 2**30
        probs = score(catalog, utt, utt_mask)
        scored = n if exact is None else exact
        ops = scored * flops + extra_flops
        cat_bytes = catalog["kwd"].numel() * catalog["kwd"].element_size()
        bound = max(ops / rate, cat_bytes / HBM_RATE) * 1e3
        print(f"phase I3 {label}: {n} keywords in {ms!r} ms (device, CUDA events, median of 3) = "
              f"{n / ms * 1e3!r} keywords/s ({scored / ms * 1e3!r} exactly scored/s); bound {bound!r} ms "
              f"({ops:.4g} FLOP at {rate / 1e12:.0f} TFLOP/s, {cat_bytes} B of catalog), {ms / bound!r}x it; "
              f"peak {peak!r} GiB")
        if not (bool(torch.isfinite(probs).all()) and probs.shape == (n,)):
            raise RuntimeError(f"phase I3 {label}: invalid scores")
        return probs

    # fp32: 1,024 raw keyword stacks on the card, projected in groups of 128
    groups = [{"kwd": torch.randn((chunk, layers, P2_SIZE[0], 1024), generator=gen, device=device),
               "kwd_mask": torch.ones((chunk, layers, P2_SIZE[0]), device=device),
               "mask": torch.ones((chunk,), device=device)} for _ in range(8)]
    # the catalog entry points turn TF32 and bf16 partial sums off themselves
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = matmul.allow_bf16_reduced_precision_reduction = True
    t0 = time.perf_counter()
    catalog = project_catalog(model, groups, chunk=chunk)
    torch.cuda.synchronize()
    if matmul.allow_tf32 or torch.backends.cudnn.allow_tf32 or matmul.allow_bf16_reduced_precision_reduction:
        raise RuntimeError("phase I3: project_catalog left TF32 or bf16 partial sums on")
    print(f"phase I3: project_catalog of 1024 keywords [3, {P2_SIZE[0]}, 1024] -> {tuple(catalog['kwd'].shape)} in "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    del groups
    fp32 = report("projected fp32", 1024, make_projected_score_fn(model, chunk=chunk), catalog, FP32_RATE)
    cat16 = {**catalog, "kwd": catalog["kwd"].to(torch.bfloat16), "kwd_mask": catalog["kwd_mask"].to(torch.bfloat16)}
    probs16 = make_projected_score_fn(bf16, chunk=chunk)(cat16, utt, utt_mask)
    print(f"phase I3: bf16 against fp32 on the same 1024 keywords: max |p diff| "
          f"{(probs16 - fp32).abs().max().item()!r}, spread of fp32 p {(fp32.max() - fp32.min()).item()!r}")
    del catalog, cat16
    report("projected bf16", 4096, make_projected_score_fn(bf16, chunk=chunk), random_catalog(4096), BF16_RATE)
    n, shortlist = 100352, 2048
    big = random_catalog(n)
    proxy_flops = n * layers * P2_LEF_MAPS[0] * P2_SIZE[1] // 2 * units * 2
    maxsim_cuda.kernel.launches = 0
    since = time.perf_counter()
    casc = report(f"cascade bf16 proxy, shortlist {shortlist}", n,
                  make_cascade_score_fn(bf16, chunk=chunk, shortlist=shortlist), big, BF16_RATE,
                  extra_flops=proxy_flops, exact=shortlist)
    # report scores 1 (warm-up) + 3 (timed) + 1 (the returned scores) times,
    # each one maxsim_proxy_fast call over all n rows
    calls = 5
    k3 = maxsim_cuda.kernel.launches
    spans = [s["attrs"] for s in profiler.spans(since_s=since) if s["name"] == "ecw.catalog.proxy"]
    print(f"phase I3: K3 launches over {calls} cascade scores {k3}; the proxy spans' launches "
          f"{[a.get('launches') for a in spans]}")
    if k3 != calls * maxsim_cuda.LAUNCHES_PER_CALL:
        raise RuntimeError(f"phase I3: the cascade launched K3 {k3} times, expected "
                           f"{calls} x {maxsim_cuda.LAUNCHES_PER_CALL}")
    if len(spans) != calls or any(a.get("launches") != maxsim_cuda.LAUNCHES_PER_CALL for a in spans):
        raise RuntimeError(f"phase I3: the ecw.catalog.proxy spans do not show K3's launches: {spans}")
    rows = torch.nonzero(casc).ravel()
    again = make_projected_score_fn(bf16, chunk=chunk)(
        {**big, "kwd": big["kwd"][rows], "kwd_mask": big["kwd_mask"][rows], "mask": big["mask"][rows]},
        utt, utt_mask)
    gap = (again - casc[rows]).abs().max().item()
    print(f"phase I3: cascade rows scored {len(rows)} (at most {shortlist}); the full scorer on those rows "
          f"gives them within {gap!r}")
    if len(rows) > shortlist or gap > 1e-3:
        raise RuntimeError("phase I3: the cascade's shortlist disagrees with the full scorer")
    return {"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches, "k3": k3}


def phase_i(device, shapes) -> dict:
    """Paper 2 on the card: I1, I2, I3.  Returns the kernels' launches over
    I2 and I3 (the kernel line's ``paper2_launches``); the phase's files
    are deleted at the end, pass or fail."""
    import shutil

    t0 = time.perf_counter()
    try:
        phase_i1(device)
        launches = phase_i2(device, shapes)
        more = phase_i3(device)
    finally:
        shutil.rmtree(PHASE_I_DIR, ignore_errors=True)
    launches = {k: launches.get(k, 0) + more[k] for k in more}
    print(f"phase I: {time.perf_counter() - t0:.1f} s; kernel launches over I2 and I3 {launches}")
    return launches


# ------------------------------------------------ phase J: paper-2 training

PHASE_J_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase_j"
J_LANGS = ("English", "German", "French", "Spanish", "Polish", "Portuguese")
J_KEYWORDS, J_GHOST = 20, 3  # keywords a language; one has no cache (a ghost)
J_TRAIN_UTTS, J_DEV_UTTS = 8, 2  # utterances a language
J_FRAMES = (500, 900, 1200, 1500)  # the distinct utterance stacks' lengths
J_BATCH = 16  # train-LEF.yaml's batch of (tts, natural) pairs: 16 examples a step
J1_TINY = dict(n_layers=2, embedding_dim=8, proj_mlp_units=4, resnet_version="resnet-18")
J1_WIDTH = 12  # the tiny stacks' width, wider than embedding_dim
J1_WHISPER = dict(vocab_size=64, num_mel_bins=80, d_model=J1_WIDTH, encoder_layers=4,
                  encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
                  encoder_ffn_dim=24, decoder_ffn_dim=24, max_source_positions=1500,
                  max_target_positions=16)
WHISPER_LARGE_V2 = dict(vocab_size=51865, num_mel_bins=80, d_model=1280, encoder_layers=32,
                        encoder_attention_heads=20, decoder_layers=32, decoder_attention_heads=20,
                        encoder_ffn_dim=5120, decoder_ffn_dim=5120, max_source_positions=1500,
                        max_target_positions=448)


def _j1_batch(rng, n_pairs, audio: bool):
    """A kw_type='all' batch of ``n_pairs`` (tts, natural) pairs at J1's
    tiny dims: 12-wide unit-norm stacks with zero-padded, masked tails;
    with ``audio``, 30 s waveforms of 1-3 s and their valid encoder frames
    instead of the utterance stacks."""
    n = 2 * n_pairs

    def stacks(t_pad, lo, hi):
        x = rng.standard_normal((n, 2, t_pad, J1_WIDTH)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        mask = np.zeros((n, 2, t_pad), np.float32)
        for i, t in enumerate(rng.integers(lo, hi, n)):
            x[i, :, t:] = 0.0
            mask[i, :, :t] = 1.0
        return x, mask

    kwd, kwd_mask = stacks(32, 4, 20)
    batch = {"kwd_features": kwd, "kwd_mask": kwd_mask,
             "labels": rng.integers(0, 2, n).astype(np.int64),
             "domain": rng.integers(0, 12, n).astype(np.int64)}
    if audio:
        wav = _audio(n, 480000, rng)
        lengths = rng.integers(16000, 48000, n)
        for i, length in enumerate(lengths):
            wav[i, length:] = 0.0
        batch["utt_audio"] = wav
        batch["utt_frames"] = np.ceil((lengths // 160) / 2).astype(np.int64)
    else:
        batch["utt_features"], batch["utt_mask"] = stacks(64, 20, 64)
    return batch


def _j1_snapshot(state, metrics):
    """(loss, weights, statistics, AdamW's moments) of a state, as numpy."""
    from enhance_cb_whisper_tpu_torch.convert import to_flax_variables
    from enhance_cb_whisper_tpu_torch.train.kws_train import adam_tree

    variables = to_flax_variables(state.model.state_dict())
    opt = adam_tree(state.optimizer, {"": state.model})
    groups = [g["inner_state"] for g in opt["inner_states"].values()] if "inner_states" in opt else [opt]
    moments = {}
    for which in ("mu", "nu"):
        for g in groups:
            moments.update({f"{which} {k}": v for k, v in _flat_np(g["inner_state"]["0"][which]).items()})
    return float(metrics["loss"]), _flat_np(variables["params"]), _flat_np(variables["batch_stats"]), moments


def _j1_pair(variant, device, whisper=None):
    """One train step of the tiny ``variant`` on the CPU and one on
    ``device``, from the same weights, on the same batch with the same
    CPU-seeded coin.  ``whisper`` maps each device to its frozen encoder
    (the audio mode).  Returns {device: snapshot}."""
    import torch

    from enhance_cb_whisper_tpu_torch.efficient_kws.engine import EfficientKWSEngine, EfficientTrainConfig
    from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSConfig
    from enhance_cb_whisper_tpu_torch.train.kws_train import StepNoise, step_seed

    cfg = EfficientKWSConfig(**J1_TINY, **P2_VARIANTS[variant])
    train = EfficientTrainConfig(kw_type="all", learning_rate=1e-3, learning_rate_sru=2e-3)
    batch = _j1_batch(np.random.default_rng(SEED + 60), 4, whisper is not None)
    snap, start = {}, None
    for dev in ("cpu", device):
        kwargs = dict(whisper=whisper[dev], kws_layer_slice=(1, 5), utt_frames_budget=64) if whisper else {}
        engine = EfficientKWSEngine(cfg, train, seed=SEED, device=dev, **kwargs)
        state = engine.init_state(batch)
        if start is None:
            start = {k: v.clone() for k, v in state.model.state_dict().items()}
        state.model.load_state_dict(start)
        metrics = engine.make_train_step(state)({k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                                                StepNoise(step_seed(SEED, 0), dev))
        snap[dev] = _j1_snapshot(state, metrics)
    return snap


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_np(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _j1_compare(label, cpu, card, lr=2e-3) -> str:
    """The card's step against the CPU's: the loss within 1e-5 relative;
    AdamW's moments (the first is 0.1 x the gradient after one step) within
    rtol 1e-4 + 2e-4 x the leaf's largest magnitude, but LEF's time-
    convolution bias, whose gradient vanishes ahead of a BatchNorm, only by
    its size (below 1e-4 of the largest moment on both); the statistics
    within rtol 1e-4 + 1e-5 x the leaf's scale (the time projector's means
    plus that bias's own gap, which they follow); every weight within two
    rates (Adam moves a weight by about its rate whatever its gradient's
    size, so a rounding-level gradient can step the other way), at least
    95 % of them within rtol 1e-4 + 1e-5 x the leaf's scale."""
    loss_c, p_c, s_c, m_c = cpu
    loss_d, p_d, s_d, m_d = card
    if abs(loss_d - loss_c) > 1e-5 * abs(loss_c) + 1e-6:
        raise RuntimeError(f"{label}: loss card {loss_d!r} CPU {loss_c!r}")
    top = max(float(np.abs(v).max()) for v in m_c.values())
    worst = 0.0
    for k, want in m_c.items():
        got = m_d[k]
        if "time_projector.conv_" in k and k.endswith(".bias"):
            if max(np.abs(want).max(), np.abs(got).max()) > 1e-4 * top:
                raise RuntimeError(f"{label}: {k} is no longer rounding noise")
            continue
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4 * scale, err_msg=f"{label} {k}")
        worst = max(worst, float(np.abs(got - want).max()) / scale)
    for k, want in s_c.items():
        drift = 0.0
        if k.startswith("time_projector.bn_") and k.endswith(".mean"):
            bias = k.replace(".bn_", ".conv_").replace(".mean", ".bias")
            drift = float(np.abs(p_d[bias] - p_c[bias]).max())
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(s_d[k], want, rtol=1e-4, atol=1e-5 * scale + drift,
                                   err_msg=f"{label} statistic {k}")
    diffs, near = [], []
    for k, want in p_c.items():
        diff = np.abs(p_d[k] - want)
        diffs.append(float(diff.max()))
        near.append((diff <= 1e-4 * np.abs(want) + 1e-5 * (float(np.abs(want).max()) or 1.0)).ravel())
    share = float(np.concatenate(near).mean())
    if max(diffs) > 2 * lr or share < 0.95:
        raise RuntimeError(f"{label}: weights max diff {max(diffs)!r}, {share!r} within the tolerance")
    return (f"loss {loss_d!r} (CPU {loss_c!r}), worst moment diff / leaf scale {worst!r}, "
            f"weights max diff {max(diffs)!r}, {share!r} within rtol 1e-4 + 1e-5 x scale")


def _j1_whisper(device):
    from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, init_whisper_params

    cfg = WhisperConfig(**J1_WHISPER)
    return cfg, from_jax_whisper_params(init_whisper_params(np.random.default_rng(SEED + 61), cfg), device)


def phase_j1(device) -> None:
    """CPU = card on the tiny model (2 layers of 12-wide stacks, embedding_dim
    8, ResNet-18 at 32 x 64): a train step of L, LE and LEF from the same
    weights with the same CPU-seeded coin (:func:`_j1_pair`,
    :func:`_j1_compare`'s tolerances); then the audio mode (LE, a random
    4-layer Whisper encoder of width 12): the step's embedding of [8,
    480000] on the card (K1) and on the CPU (the plain mel) within rtol
    1e-3 / atol 1e-4 (K1 and its plain version agree to 1e-4 / 1e-5, which
    the encoder carries on), zeros past each utterance, then a step each
    with K1 launched once on the card (:func:`_j1_compare_audio`)."""
    import torch

    from enhance_cb_whisper_tpu_torch.efficient_kws.engine import EfficientKWSEngine
    from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSConfig
    from enhance_cb_whisper_tpu_torch.ops import mel_cuda

    for variant in P2_VARIANTS:
        t0 = time.perf_counter()
        snap = _j1_pair(variant, device)
        text = _j1_compare(f"phase J1 {variant}", snap["cpu"], snap[device])
        print(f"phase J1 {variant}: card = CPU ({text}) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    whisper = {dev: _j1_whisper(dev) for dev in ("cpu", device)}
    b = _j1_batch(np.random.default_rng(SEED + 62), 4, True)
    embeds = {}
    for dev in ("cpu", device):
        engine = EfficientKWSEngine(EfficientKWSConfig(**J1_TINY, **P2_VARIANTS["LE"]), whisper=whisper[dev],
                                    kws_layer_slice=(1, 5), utt_frames_budget=64, device=dev)
        mel_cuda.kernel.launches = 0
        utt, mask = engine.embed_utterances(torch.from_numpy(b["utt_audio"]).to(dev),
                                            torch.from_numpy(b["utt_frames"]).to(dev))
        embeds[dev] = (utt.cpu(), mask.cpu(), mel_cuda.kernel.launches)
    (u_c, m_c, _), (u_d, m_d, launched) = embeds["cpu"], embeds[device]
    gap = float((u_d - u_c).abs().max())
    tails_zero = all(not u_d[i, :, int(n):].any() for i, n in enumerate(b["utt_frames"]) if n < 64)
    if not (torch.allclose(u_d, u_c, rtol=1e-3, atol=1e-4) and torch.equal(m_d, m_c) and tails_zero
            and launched == 1):
        raise RuntimeError(f"phase J1 audio: embedding card vs CPU max diff {gap!r}, masks equal "
                           f"{torch.equal(m_d, m_c)}, zero tails {tails_zero}, K1 launches {launched}")
    mel_cuda.kernel.launches = 0
    snap = _j1_pair("LE", device, whisper)
    if mel_cuda.kernel.launches != 1:
        raise RuntimeError(f"phase J1 audio: the card's step launched K1 {mel_cuda.kernel.launches} times")
    text = _j1_compare_audio(snap["cpu"], snap[device])
    print(f"phase J1 audio: embedding [8, 480000] card (K1) vs CPU (plain mel) max diff {gap!r} "
          f"(rtol 1e-3, atol 1e-4), masks equal, zero past each utterance; one step: {text}; K1 "
          f"launched once in the step, in {time.perf_counter() - t0:.1f} s")


def _j1_compare_audio(cpu, card) -> str:
    """An audio-mode step, card against CPU: its inputs already differ by
    K1's rounding (above), so the loss within 1e-4 relative and every
    weight within two rates, at least 95 % within rtol 1e-4 + 1e-5 x scale."""
    loss_c, p_c, _, _ = cpu
    loss_d, p_d, _, _ = card
    diffs = np.concatenate([np.abs(p_d[k] - v).ravel() for k, v in p_c.items()])
    near = np.concatenate([(np.abs(p_d[k] - v) <= 1e-4 * np.abs(v) + 1e-5 * (float(np.abs(v).max()) or 1.0)).ravel()
                           for k, v in p_c.items()])
    if abs(loss_d - loss_c) > 1e-4 * abs(loss_c) or diffs.max() > 2 * 2e-3 or near.mean() < 0.95:
        raise RuntimeError(f"phase J1 audio step: loss card {loss_d!r} CPU {loss_c!r}, weights max diff "
                           f"{diffs.max()!r}, {near.mean()!r} within the tolerance")
    return f"loss {loss_d!r} (CPU {loss_c!r}), weights max diff {diffs.max()!r}, {near.mean()!r} close"


def _write_j_data(root: Path, device, seed: int) -> dict:
    """A synthetic MLS layout of the six languages at whisper-large-v2's
    widths: per language ``J_KEYWORDS`` keywords of 20-60 frames (tts and
    natural, one of them without a cache), ``J_TRAIN_UTTS`` training
    utterances (stacks of 500-1500 frames and 16 kHz WAVs of 10-30 s) with
    two positives each, and a dev split of ``J_DEV_UTTS`` utterances.
    Distinct stacks and WAVs are written once and linked per language."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    pool = root / "pool"
    pool.mkdir(parents=True, exist_ok=True)
    for j in range(J_KEYWORDS):
        for kw_type in ("tts", "natural"):
            np.save(pool / f"kw_{kw_type}_{j}.npy", _h_stack(gen, int(rng.integers(20, 61)), device))
    for j, frames in enumerate(J_FRAMES):
        np.save(pool / f"utt_{j}.npy", _h_stack(gen, frames, device))
        # the WAV is as long as its stack's frames say (50 a second)
        _write_wav(pool / f"utt_{j}.wav", _audio(1, frames * 320, rng)[0], rate=16000)
    for lang in J_LANGS:
        keywords = [f"{lang[:3].lower()}kw{i:02d}" for i in range(J_KEYWORDS)]
        rev = sorted(keywords, key=lambda x: x[::-1])
        base = root / f"mls_{lang.lower()}_opus"
        for split, n_utts in (("train", J_TRAIN_UTTS), ("dev", J_DEV_UTTS)):
            d = base / split
            (d / "hs").mkdir(parents=True, exist_ok=True)
            (d / "keywords.txt").write_text("\n".join(keywords) + "\n")
            for kw_type in ("tts", "natural"):
                (d / "keywords-hs" / kw_type).mkdir(parents=True, exist_ok=True)
                for i in range(J_KEYWORDS):
                    if i != J_GHOST:
                        (d / "keywords-hs" / kw_type / f"{i:02d}.npy").symlink_to(pool / f"kw_{kw_type}_{i}.npy")
            lines, codes, text, mentions = [], [], [], []
            for u in range(n_utts):
                code = f"{10 + u}_{20 + u}_{u:06d}"
                j = u % len(J_FRAMES)
                (d / "hs" / f"{code}.npy").symlink_to(pool / f"utt_{j}.npy")
                if split == "train":
                    wav = d / "audio" / str(10 + u) / str(20 + u) / f"{code}.wav"
                    wav.parent.mkdir(parents=True, exist_ok=True)
                    wav.symlink_to(pool / f"utt_{j}.wav")
                    parts = [code]
                    picks = rng.choice([i for i in range(J_KEYWORDS) if i != J_GHOST], 2, replace=False)
                    for p in sorted(picks.tolist()):
                        parts += [keywords[p], str(p), str(rev.index(keywords[p]))]
                    lines.append("\t".join(parts))
                else:
                    kw = keywords[(5 * u + 1) % J_KEYWORDS]
                    transcript = f"we spoke of {kw} today"
                    codes.append(code)
                    text.append(f"{code}\t{transcript}")
                    start = transcript.index(kw)
                    mentions.append("\t".join([code, kw, str(start), str(start + len(kw))]))
            if split == "train":
                (d / "positives.tsv").write_text("\n".join(lines) + "\n")
            else:
                (d / "uttid").write_text("\n".join(codes) + "\n")
                (d / "transcripts.txt").write_text("\n".join(text) + "\n")
                (d / "positives.tsv").write_text("\n".join(mentions) + "\n")
    size = sum(p.stat().st_size for p in pool.iterdir())
    return {"bytes": size}


def _write_large_v2(directory: Path, device) -> float:
    """A random whisper-large-v2 (32 + 32 layers of 1280, 80 mels) as an HF
    checkpoint directory: ``config.json`` and ``model.safetensors`` in fp16
    (the loader upcasts), the weights drawn on the card.  Returns the
    seconds it took."""
    import dataclasses

    import torch
    from safetensors.torch import save_file

    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig
    from enhance_cb_whisper_tpu_torch.models.whisper_loader import hf_whisper_state

    t0 = time.perf_counter()
    config = WhisperConfig(**WHISPER_LARGE_V2)
    gen = torch.Generator(device=device).manual_seed(SEED + 70)

    def lin(n_in, n_out, bias=True):
        p = {"weight": torch.randn(n_out, n_in, generator=gen, device=device) * 0.02}
        if bias:
            p["bias"] = torch.zeros(n_out, device=device)
        return p

    def ln():
        return {"weight": torch.ones(config.d_model, device=device),
                "bias": torch.zeros(config.d_model, device=device)}

    def attn():
        d = config.d_model
        return {"q_proj": lin(d, d), "k_proj": lin(d, d, bias=False), "v_proj": lin(d, d),
                "out_proj": lin(d, d)}

    def layer(cross):
        out = {"self_attn": attn(), "self_attn_layer_norm": ln(),
               "fc1": lin(config.d_model, config.encoder_ffn_dim),
               "fc2": lin(config.encoder_ffn_dim, config.d_model), "final_layer_norm": ln()}
        if cross:
            out.update(encoder_attn=attn(), encoder_attn_layer_norm=ln())
        return out

    from enhance_cb_whisper_tpu_torch.models.whisper import sinusoid_positions

    d = config.d_model
    params = {
        "encoder": {
            "conv1": {"weight": torch.randn(d, config.num_mel_bins, 3, generator=gen, device=device) * 0.02,
                      "bias": torch.zeros(d, device=device)},
            "conv2": {"weight": torch.randn(d, d, 3, generator=gen, device=device) * 0.02,
                      "bias": torch.zeros(d, device=device)},
            "embed_positions": {"weight": torch.from_numpy(
                sinusoid_positions(config.max_source_positions, d)).to(device)},
            "layer_norm": ln(),
            "layers": [layer(False) for _ in range(config.encoder_layers)],
        },
        "decoder": {
            "embed_tokens": {"weight": torch.randn(config.vocab_size, d, generator=gen, device=device) * 0.02},
            "embed_positions": {"weight": torch.randn(config.max_target_positions, d, generator=gen,
                                                      device=device) * 0.02},
            "layer_norm": ln(),
            "layers": [layer(True) for _ in range(config.decoder_layers)],
        },
    }
    directory.mkdir(parents=True, exist_ok=True)
    state = {k: v.to(torch.float16).cpu() for k, v in hf_whisper_state(params).items()}
    del params
    save_file(state, str(directory / "model.safetensors"))
    (directory / "config.json").write_text(json.dumps(
        {"model_type": "whisper", "architectures": ["WhisperForConditionalGeneration"],
         **dataclasses.asdict(config)}))
    return time.perf_counter() - t0


@contextlib.contextmanager
def _recorded_p2_steps():
    """Time each paper-2 train step the engine makes (synchronised), count
    its examples (after the kw_type='all' coin), and keep the last step's
    engine, step function and batch for the profiler."""
    import torch

    from enhance_cb_whisper_tpu_torch.efficient_kws import engine as pe

    real = pe.EfficientKWSEngine.make_train_step
    rec = {"ms": [], "examples": [], "starts": [], "ends": [], "losses": [], "last": None}

    def make(self, state):
        step = real(self, state)
        rec["initial"] = [p.detach().clone() for p in state.model.parameters()]
        halve = self.train_config.kw_type == "all"

        def timed(batch, noise):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(batch, noise)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec["ms"].append((t1 - t0) * 1e3)
            rec["starts"].append(t0)
            rec["ends"].append(t1)
            rec["examples"].append(int(batch["labels"].shape[0]) // (2 if halve else 1))
            rec["losses"].append(float(out["loss"]))
            rec["last"] = (self, step, batch, noise)
            return out

        return timed

    pe.EfficientKWSEngine.make_train_step = make
    try:
        yield rec
    finally:
        pe.EfficientKWSEngine.make_train_step = real


@contextlib.contextmanager
def _recorded_k1_shapes():
    """Records the shape of every K1 wrapper call made inside the block; the
    real wrapper still runs and counts its launch."""
    from enhance_cb_whisper_tpu_torch.ops import mel_cuda

    real, seen = mel_cuda.log10_mel, []

    def recorded(audio, n_mels=80):
        seen.append(tuple(audio.shape))
        return real(audio, n_mels)

    mel_cuda.log10_mel = recorded
    try:
        yield seen
    finally:
        mel_cuda.log10_mel = real


def _p2_step_breakdown(label, rec) -> None:
    """One paper-2 train step on the run's last batch: its FLOPs
    (``FlopCounterMode``: convolutions, matmuls and attention) and bound at
    the FP32 peak, the median wall of three unprofiled steps, and the device
    time of the second of two profiled steps by kernel family (K1, the
    frozen encoder's GEMMs and attention, taken from a profiled
    ``embed_utterances`` of the same audio, the other GEMMs, convolutions,
    BatchNorm, the optimizer, the rest) with its idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    engine, step, batch, noise = rec["last"]
    examples = rec["examples"][-1]

    def families(prof):
        parts = {"K1 log10_mel": 0.0, "GEMMs and attention": 0.0, "convolutions": 0.0,
                 "BatchNorm": 0.0, "optimizer": 0.0, "other": 0.0}
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
            name = evt.key.lower()
            if "mel" in name:
                parts["K1 log10_mel"] += us
            elif "batch_norm" in name or "bn_" in name or "welford" in name:
                parts["BatchNorm"] += us
            elif any(s in name for s in ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")):
                parts["convolutions"] += us
            elif any(s in name for s in ("gemm", "cutlass", "flash", "fmha", "attention", "sm90_xmma")):
                parts["GEMMs and attention"] += us
            elif "multi_tensor" in name or "adam" in name:
                parts["optimizer"] += us
            else:
                parts["other"] += us
        return parts

    with FlopCounterMode(display=False) as counter:
        step(batch, noise)
    flops = counter.get_total_flops()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, noise)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(batch, noise)
            torch.cuda.synchronize()
    parts = families(prof)
    device_ms = sum(parts.values()) / 1e3
    if "utt_audio" in batch:
        # as many utterances as the step embeds (K1 takes contiguous rows)
        audio, frames = batch["utt_audio"][::2].contiguous(), batch["utt_frames"][::2].contiguous()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as eprof:
                engine.embed_utterances(audio, frames)
                torch.cuda.synchronize()
        encoder = families(eprof)["GEMMs and attention"]
        parts = {"K1 log10_mel": parts["K1 log10_mel"], "encoder GEMMs and attention": encoder,
                 "other GEMMs": parts["GEMMs and attention"] - encoder,
                 **{k: v for k, v in parts.items() if k not in ("K1 log10_mel", "GEMMs and attention")}}
    text = ", ".join(f"{k} {v / 1e3!r} ms" for k, v in parts.items())
    bound_ms = flops / FP32_RATE * 1e3
    print(f"{label}: one step of {examples} examples: wall {wall!r} ms unprofiled (median of 3: "
          f"{walls!r}); device {device_ms!r} ms (idle share {1 - device_ms / wall!r}): {text}; "
          f"{flops / 1e12!r} TFLOP (convolutions, matmuls, attention), bound {bound_ms!r} ms at "
          f"{FP32_RATE / 1e12:g} TFLOP/s, the step {wall / bound_ms!r}x it")


def _j_argv(root: Path, run: str, *overrides):
    return ["fit", "--config", str(CONFIGS / "efficient_kws" / "train-LEF.yaml"),
            "--set", f"MLS_ROOT={root}", "--set", f"DEFAULT_ROOT_DIR={PHASE_J_DIR / run}",
            "--trainer.max_epochs", "1", *overrides]


def _j_fit(label, argv):
    """``run_cli(argv)`` on the card with each step and K1 and K2's launches
    recorded; the weights must move and stay finite.  Returns (state,
    record, K1 shapes)."""
    import torch

    from enhance_cb_whisper_tpu_torch.cli import run_cli

    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mel_cuda.kernel.launches = matmul_s8_cuda.kernel.launches = 0
    with _recorded_p2_steps() as rec, _recorded_k1_shapes() as k1:
        t0 = time.perf_counter()
        state = run_cli(argv)  # the default device: the card
        seconds = time.perf_counter() - t0
    rec["launches"] = {"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches}
    _report_run(label, rec, seconds)
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(state.model.parameters(), rec["initial"]))
    if not moved > 0 or not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
        raise RuntimeError(f"{label}: the weights did not move or are not finite ({moved!r})")
    print(f"{label}: largest weight change {moved!r}; projector input width "
          f"{state.model.projector.proj_0_0.in_features} (embedding_dim "
          f"{state.model.config.embedding_dim})")
    return state, rec, k1


def phase_j2(device) -> dict:
    """configs/efficient_kws/train-LEF.yaml as written (ResNet-50 on 3 layers,
    features 150 x 1500, batch 16 pairs, kw_type all, utterance-examples
    sampling) through ``run_cli(["fit", ...])`` from the hidden-state
    caches at whisper-large-v2's 12 x 1280 (wider than embedding_dim 1024):
    one epoch of three batches with the 12 validation sets, then a resume
    from its ``final`` for one epoch of two.  Returns K1's and K2's launches
    over the two CLI runs."""
    import shutil

    root = PHASE_J_DIR / "mls"
    state, rec, _ = _j_fit("phase J2 caches", _j_argv(root, "caches", "--trainer.limit_train_batches", "3"))
    launches = dict(rec["launches"])
    _p2_step_breakdown("phase J2 caches", rec)
    final = PHASE_J_DIR / "caches" / "checkpoints" / "final"
    print(f"phase J2: checkpoints {sorted(p.name for p in final.parent.iterdir())}")
    state, rec, _ = _j_fit("phase J2 resume", _j_argv(root, "caches", "--trainer.max_epochs", "2",
                                                      "--trainer.limit_train_batches", "2",
                                                      "--ckpt_path", str(final)))
    if state.epoch != 1 or len(rec["ms"]) != 2:
        raise RuntimeError(f"phase J2 resume: epoch {state.epoch}, {len(rec['ms'])} steps")
    shutil.rmtree(PHASE_J_DIR / "caches", ignore_errors=True)
    return {k: launches[k] + rec["launches"][k] for k in launches}


def phase_j3(device) -> dict:
    """The same config with ``load_embeddings: false``: the frozen encoder is
    a random whisper-large-v2 written as an HF directory, each step embeds
    its 16 utterances' 30 s audio (K1, then the encoder's layer slice (10,
    22), the last 3 slabs); K1 launches exactly once a step, at [16,
    480000], and K2 never.  Returns their launches over the CLI run."""
    seconds = _write_large_v2(PHASE_J_DIR / "large-v2", device)
    print(f"phase J3: random whisper-large-v2 written as an HF directory (fp16 safetensors, "
          f"{(PHASE_J_DIR / 'large-v2' / 'model.safetensors').stat().st_size} B) in {seconds:.1f} s")
    state, rec, k1 = _j_fit("phase J3 audio", _j_argv(
        PHASE_J_DIR / "mls", "audio", "--trainer.limit_train_batches", "2",
        "--model.init_args.load_embeddings", "false",
        "--model.init_args.kws_whisper_ckpt", str(PHASE_J_DIR / "large-v2")))
    steps, launches = len(rec["ms"]), rec["launches"]
    print(f"phase J3: K1 launches {launches['mel']} over {steps} steps at {sorted(set(k1))}, "
          f"K2 launches {launches['k2']}")
    if launches["mel"] != steps or set(k1) != {(J_BATCH, 480000)}:
        raise RuntimeError(f"phase J3: K1 launched {launches['mel']} times at {k1} over {steps} steps")
    _p2_step_breakdown("phase J3 audio", rec)
    return launches


def phase_j(device) -> dict:
    """Phase J: paper-2 training, J1, J2, J3; the phase's files are deleted
    at the end, pass or fail.  Returns K1's and K2's launches over J2's and
    J3's CLI runs (the kernel line's ``paper2_train_launches``)."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(PHASE_J_DIR, ignore_errors=True)
    try:
        phase_j1(device)
        t1 = time.perf_counter()
        info = _write_j_data(PHASE_J_DIR / "mls", device, SEED + 71)
        print(f"phase J: MLS layout of {len(J_LANGS)} languages x {J_KEYWORDS} keywords, "
              f"{J_TRAIN_UTTS} training and {J_DEV_UTTS} dev utterances each ({H_LAYERS} x {H_DIM}; "
              f"{info['bytes']} B of distinct files) written in {time.perf_counter() - t1:.1f} s")
        cached = phase_j2(device)
        audio = phase_j3(device)
        launches = {k: cached[k] + audio[k] for k in cached}
    finally:
        shutil.rmtree(PHASE_J_DIR, ignore_errors=True)
    if launches["k2"]:
        raise RuntimeError(f"phase J: training launched K2 {launches['k2']} times")
    print(f"phase J: {time.perf_counter() - t0:.1f} s; kernel launches over J2 and J3 {launches}")
    return launches


# ------------------------------------------------------ phase P: the offline pipeline

PHASE_P_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase_p"
P_SLICE = (10, 22)
P_BATCH = 8  # the pipeline's default batch_size
# 16 files of 5-30 s, every other one a 44.1 kHz recording, and one of 40 s
P_SECONDS = tuple(float(s) for s in np.linspace(5.0, 30.0, 16)) + (40.0,)


def _p_corpus(root: Path, seconds, seed: int) -> dict:
    """WAVs under ``root`` (two nesting levels), every other one at 44.1 kHz,
    plus one shorter than a hop and one named ``.mp3`` that is not audio;
    returns code -> seconds of the decodable files."""
    import wave

    rng = np.random.default_rng(seed)
    codes = {}
    for i, s in enumerate(seconds):
        code = f"utt{i:02d}"
        wav = _audio(1, int(s * 16000), rng)[0]
        path = root / ("a" if i % 2 else "b") / f"{code}.wav"
        if i % 2:
            _write_wav(path, wav, 44100)
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            with wave.open(str(path), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
        codes[code] = s
    _write_wav(root / "short.wav", np.zeros(100, np.float32), 16000)
    (root / "notaudio.mp3").write_bytes(b"ID3 not an mp3")
    return codes


def _p_extract(argv, label: str):
    """``pipeline.main(argv)`` timed (wall, synchronized), with K1's launches
    and launch shapes over exactly the call and its printed lines."""
    import io

    import torch

    from enhance_cb_whisper_tpu_torch import pipeline
    from enhance_cb_whisper_tpu_torch.ops import mel_cuda

    out = io.StringIO()
    mel_cuda.kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _recorded_k1_shapes() as shapes, contextlib.redirect_stdout(out):
        pipeline.main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    printed = out.getvalue().splitlines()
    print(f"{label}: pipeline.main {wall!r} s; K1 launches {mel_cuda.kernel.launches} at {shapes}; "
          f"printed {printed}")
    return wall, {"mel": mel_cuda.kernel.launches, "shapes": shapes}, printed


@contextlib.contextmanager
def _p_host_times():
    """Host seconds inside the pipeline, summed by part: the checkpoint's
    load, the WAVs' decode and resampling (the loader thread, beside the
    card's work) and the cache writes."""
    from enhance_cb_whisper_tpu_torch import pipeline
    from enhance_cb_whisper_tpu_torch.models import whisper_loader

    rec = {"checkpoint load": 0.0, "decode + resample (loader thread)": 0.0, "cache writes": 0.0}
    targets = ((whisper_loader, "load_whisper_from_pretrained", "checkpoint load"),
               (pipeline, "_load_padded", "decode + resample (loader thread)"),
               (pipeline, "save_hidden_states", "cache writes"))
    originals = [getattr(module, name) for module, name, _ in targets]

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                rec[key] += time.perf_counter() - t0
        return run

    for (module, name, key), fn in zip(targets, originals):
        setattr(module, name, timed(fn, key))
    try:
        yield rec
    finally:
        for (module, name, _), fn in zip(targets, originals):
            setattr(module, name, fn)


def _p_caches(directory: Path) -> dict:
    return {p.stem: np.load(p) for p in sorted(directory.glob("*.npy"))}


def phase_p1(device) -> None:
    """The pipeline on the tiny random Whisper (phase B's dims, written as
    an HF directory) over five WAVs of 0.5-8 s at batch 3: the CPU's
    caches (the plain mel) = the card's (K1), within 1e-4."""
    import torch

    from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, init_whisper_params
    from enhance_cb_whisper_tpu_torch.pipeline import extract_hidden_states

    t0 = time.perf_counter()
    root = PHASE_P_DIR / "tiny"
    cfg = WhisperConfig(
        vocab_size=128, num_mel_bins=80, d_model=64, encoder_layers=3, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=1500, max_target_positions=40,
    )
    params = from_jax_whisper_params(init_whisper_params(np.random.default_rng(SEED), cfg), "cpu")
    _write_whisper_checkpoint(root / "ckpt", cfg, params)
    codes = _p_corpus(root / "audio", (0.5, 2.25, 4.0, 6.5, 8.0), SEED + 81)
    caches = {}
    for dev in ("cpu", device):
        extract_hidden_states(str(root / "audio"), str(root / "ckpt"), str(root / str(dev)), layer_slice=(1, 3),
                              batch_size=3, device=dev)
        caches[str(dev)] = _p_caches(root / str(dev))
    cpu, card = caches["cpu"], caches[str(device)]
    if sorted(cpu) != sorted(card) or sorted(card) != sorted(codes):
        raise RuntimeError(f"phase P1: caches written cpu {sorted(cpu)} card {sorted(card)}, files {sorted(codes)}")
    err = max(float(np.abs(card[c] - cpu[c]).max()) for c in cpu)
    print(f"phase P1: tiny model, {len(cpu)} caches CPU (plain mel) vs card (K1): shapes equal "
          f"{all(cpu[c].shape == card[c].shape for c in cpu)}, max |diff| {err!r} (tolerance 1e-4); "
          f"{time.perf_counter() - t0:.1f} s")
    if err > 1e-4 or any(cpu[c].shape != card[c].shape for c in cpu):
        raise RuntimeError("phase P1: the card's caches differ from the CPU's")
    torch.cuda.empty_cache()


def _p_breakdown(argv, wall_s: float) -> None:
    """Device time of one more profiled ``pipeline.main(argv)`` by kernel
    family, its idle share against the unprofiled wall ``wall_s``."""
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    from enhance_cb_whisper_tpu_torch import pipeline

    with contextlib.redirect_stdout(io.StringIO()), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipeline.main(argv)
        torch.cuda.synchronize()
    families = {"K1 log10_mel": 0.0, "GEMMs": 0.0, "attention": 0.0, "convolutions": 0.0, "copies": 0.0,
                "other kernels": 0.0}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
        name = evt.key.lower()
        if "log10_mel" in name or "mel_kernel" in name:
            families["K1 log10_mel"] += us
        elif "gemm" in name or "cutlass" in name:
            families["GEMMs"] += us
        elif "flash" in name or "attention" in name or "fmha" in name:
            families["attention"] += us
        elif "conv" in name or "cudnn" in name:
            families["convolutions"] += us
        elif "memcpy" in name or "memset" in name:
            families["copies"] += us
        else:
            families["other kernels"] += us
    device_s = sum(families.values()) / 1e6
    parts = ", ".join(f"{k} {v / 1e3!r} ms" for k, v in families.items())
    print(f"phase P2 breakdown: device {device_s!r} s over the run (idle share {1 - device_s / wall_s!r} of "
          f"the unprofiled wall {wall_s!r} s): {parts}")


def encoder_flops(cfg, frames: int = 3000) -> int:
    """FLOPs of one Whisper encoder forward on a 30 s mel: the two
    convolutions and, per layer, the Q/K/V/O projections, the FFN and the
    two attention products."""
    t, d, f = frames // 2, cfg.d_model, cfg.encoder_ffn_dim
    convs = 2 * 3 * (frames * d * cfg.num_mel_bins + t * d * d)
    layer = 2 * t * (4 * d * d + 2 * d * f) + 2 * 2 * t * t * d
    return convs + cfg.encoder_layers * layer


def phase_p2(device) -> dict:
    """The pipeline's CLI at whisper-medium's encoder (24 layers, d_model
    1024, random fp32 weights from the numpy seed, the decoder cut to two
    layers: the pipeline never runs it) written as an HF directory, over 17
    WAVs of 5-40 s (half at 44.1 kHz), a sub-hop WAV and a non-WAV file, at
    batch 8: K1 exactly once per batch at [<= 8, 480000]; both bad files
    skipped with their messages; every cache equal to ``encoder_kws_stack``
    of the same file through ``prepare_features`` on the card; files/s, MB/s
    written, the encoder's ms per file against its FP32 FLOP bound and, from
    a profiled run, the idle share.  Then the f16 caches (< 0.6x the f32
    files, within 2e-3) and ``--encoder_int8 --compute_dtype bfloat16``
    (per-frame cosine > 0.999 against f32).  Returns K1's launches over the
    f32 run."""
    import shutil

    import torch

    from enhance_cb_whisper_tpu_torch.audio.io import load_audio_16k, prepare_features
    from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
    from enhance_cb_whisper_tpu_torch.models.whisper import (
        WhisperConfig,
        encoder_kws_stack,
        init_whisper_params,
    )
    from enhance_cb_whisper_tpu_torch.models.whisper_loader import load_whisper_from_pretrained
    from enhance_cb_whisper_tpu_torch.ops.mel import N_SAMPLES
    from enhance_cb_whisper_tpu_torch.pipeline import find_audio_files

    t_start = time.perf_counter()
    root = PHASE_P_DIR / "medium"
    config = WhisperConfig(decoder_layers=2)
    params = from_jax_whisper_params(init_whisper_params(np.random.default_rng(SEED), config), "cpu")
    t0 = time.perf_counter()
    _write_whisper_checkpoint(root / "ckpt", config, params)
    del params
    codes = _p_corpus(root / "audio", P_SECONDS, SEED + 82)
    print(f"phase P2: whisper-medium encoder checkpoint ({config.encoder_layers} layers, d_model "
          f"{config.d_model}) and {len(codes)} WAVs written in {time.perf_counter() - t0:.1f} s")
    base = ["--extract_hs", "-a", str(root / "audio"), "-w", str(root / "ckpt")]

    with _p_host_times() as host:
        wall, launches, printed = _p_extract(base + ["-t", str(root / "f32")], "phase P2 f32")
    f32 = _p_caches(root / "f32")
    n_items = len(codes) + 2
    batches = -(-n_items // P_BATCH)
    shapes_ok = all(s[0] <= P_BATCH and s[1:] == (N_SAMPLES,) for s in launches["shapes"])
    skipped = [line for line in printed if "skipped" in line or "cannot decode" in line]
    if sorted(f32) != sorted(codes) or launches["mel"] != batches or not shapes_ok or len(skipped) != 2:
        raise RuntimeError(f"phase P2: caches {sorted(f32)}, K1 {launches}, skipped {skipped}")
    size = sum((root / "f32" / f"{c}.npy").stat().st_size for c in f32)
    print(f"phase P2 f32: {len(f32)} caches of {len(codes) + 2} files ({size} B) in {wall!r} s: "
          f"{len(f32) / wall!r} files/s, {size / wall / 1e6!r} MB/s written; K1 once per batch "
          f"({batches} batches of <= {P_BATCH}); skipped: {skipped}; host seconds {host}")

    # each cache against the same file encoded on its own
    t0 = time.perf_counter()
    config_r, params_r = load_whisper_from_pretrained(str(root / "ckpt"), device=device)
    load_s = time.perf_counter() - t0
    files = find_audio_files(str(root / "audio"))
    err, enc_ms = 0.0, []
    with torch.no_grad():
        for code, cache in f32.items():
            wav = load_audio_16k(files[code])[:N_SAMPLES]
            features, _ = prepare_features(wav, n_mels=config.num_mel_bins, device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stack = encoder_kws_stack(params_r, features, config_r, layer_slice=P_SLICE)
            torch.cuda.synchronize()
            enc_ms.append((time.perf_counter() - t0) * 1e3)
            want = stack[0, :, : cache.shape[1]].cpu().numpy()
            err = max(err, float(np.abs(want - cache).max()))
    del params_r
    torch.cuda.empty_cache()
    bound_ms = encoder_flops(config) / FP32_RATE * 1e3
    enc = statistics.median(enc_ms[1:])
    print(f"phase P2 f32 caches vs encoder_kws_stack per file: max |diff| {err!r} (tolerance 1e-5); "
          f"checkpoint load {load_s!r} s; encoder + stack {enc!r} ms per 30 s file (median of "
          f"{len(enc_ms) - 1}), its FP32 bound {bound_ms!r} ms ({encoder_flops(config) / 1e12!r} TFLOP at "
          f"{FP32_RATE / 1e12:g} TFLOP/s): {enc / bound_ms!r}x it")
    if err > 1e-5:
        raise RuntimeError("phase P2: a cache differs from its file's encoder_kws_stack")
    _p_breakdown(base + ["-t", str(root / "profiled")], wall)
    shutil.rmtree(root / "profiled", ignore_errors=True)

    wall16, _, _ = _p_extract(base + ["-t", str(root / "f16"), "--cache_dtype", "float16"], "phase P2 f16")
    f16 = _p_caches(root / "f16")
    ratio = max((root / "f16" / f"{c}.npy").stat().st_size / (root / "f32" / f"{c}.npy").stat().st_size
                for c in f16)
    err16 = max(float(np.abs(f16[c].astype(np.float32) - f32[c]).max()) for c in f32)
    print(f"phase P2 f16: {len(f16) / wall16!r} files/s; largest f16/f32 file size ratio {ratio!r}; "
          f"max |f16 - f32| {err16!r} (tolerance 2e-3)")
    if sorted(f16) != sorted(f32) or ratio >= 0.6 or err16 > 2e-3:
        raise RuntimeError("phase P2: the f16 caches fail their checks")
    shutil.rmtree(root / "f16", ignore_errors=True)

    wall8, _, _ = _p_extract(base + ["-t", str(root / "int8"), "--encoder_int8", "--compute_dtype", "bfloat16"],
                             "phase P2 encoder_int8 + bf16")
    i8 = _p_caches(root / "int8")
    cos = min(float((i8[c] * f32[c]).sum(-1).min()) for c in f32)
    print(f"phase P2 encoder_int8 + bf16: {len(i8) / wall8!r} files/s; least per-frame cosine against f32 "
          f"{cos!r} (bound 0.999)")
    if sorted(i8) != sorted(f32) or not cos > 0.999:
        raise RuntimeError("phase P2: the encoder_int8 caches are too far from the f32 ones")
    print(f"phase P2: {time.perf_counter() - t_start:.1f} s in all")
    return launches


def phase_p(device) -> dict:
    """Phase P: the offline cache pipeline, P1 and P2; its files are deleted
    at the end, pass or fail.  Returns K1's launches over P2's f32 run (the
    kernel line's ``pipeline_launches``)."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(PHASE_P_DIR, ignore_errors=True)
    try:
        phase_p1(device)
        launches = phase_p2(device)
    finally:
        shutil.rmtree(PHASE_P_DIR, ignore_errors=True)
    print(f"phase P: {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------ phase Q: scale-out

PHASE_Q_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "phase_q"
Q_TIMEOUT = 600.0  # seconds for one launch of ranks; a hung rank fails the run
Q_DP_BATCH = 20  # configs/train.yaml's batch
Q_WINDOW = (32, 48)  # the profiled decode steps of the 1-rank beam-5 decode of phase B's 5.5 s utterance
# decode cap of phase Q's TP longform runs: two ranks time-share the one card
# and every row-parallel linear's sum crosses the host (1.4 ms a gloo call,
# ~76 a step: ~350 ms a TP step against ~33 ms on one rank), so phase Q
# decodes a fifth of MEDIUM_DECODE's depth
Q_DECODE = 24
Q_THREADS = 4  # torch threads of a phase Q rank (its CPU-side init), of the machine's 8 cores


def _q_train_config():
    """configs/train.yaml's paper-1 step (large heads, plain CE; no
    adversary, so one minibatch)."""
    from enhance_cb_whisper_tpu_torch.train import kws_train as kt

    return kt.KWSTrainConfig(large_heads=True, num_domains=2, learning_rate=5e-5, features_lr=5e-5,
                             classifier_lr=5e-5, discriminator_lr=5e-5, lr_step=7, beta_2=0.99)


def _q_batch(device):
    """The global batch of 20 12-layer 150x750 similarity maps (seeded)."""
    import torch

    rng = np.random.default_rng(SEED + 60)
    return {"features": torch.from_numpy(rng.standard_normal((Q_DP_BATCH, 12, *KWS_SIZE), dtype=np.float32)
                                         ).to(device),
            "labels": torch.from_numpy(rng.integers(0, 2, Q_DP_BATCH)).to(device),
            "domain": torch.from_numpy(rng.integers(0, 2, Q_DP_BATCH)).to(device)}


def _q_digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _q_flat_moments(state):
    """Adam's first moments, flattened in parameter order and padded to an
    even length (the sharded leaf of the checkpoint)."""
    import torch

    opt = state.optimizer
    flat = torch.cat([opt.state[p]["exp_avg"].flatten() for g in opt.param_groups for p in g["params"]])
    return torch.cat([flat, flat.new_zeros(flat.numel() % 2)])


def _q_dp(device, mesh):
    """One train step of the 12-channel ResNet-50 at 150x750 on the global
    batch of 20: data-parallel over ``mesh``'s ``data`` ranks, or one rank's
    step without a mesh.  Returns (state, metrics, ms)."""
    import torch

    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.parallel.sharding import make_sharded_train_step
    from enhance_cb_whisper_tpu_torch.train import kws_train as kt

    config = _q_train_config()
    state = kt.init_train_state(config, ResNetConfig.from_version("resnet-50", num_channels=12),
                                seed=SEED, device=device)
    step = kt.make_train_step(config, state) if mesh is None else make_sharded_train_step(config, state, mesh)
    batch = _q_batch(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(batch, kt.StepNoise(SEED, device=device), 0.0, 0.0)
    torch.cuda.synchronize()
    return state, {k: float(v) for k, v in metrics.items()}, (time.perf_counter() - t0) * 1e3


def _q_cb(device, params, kws_state, stacks, positions=Q_DECODE):
    """Phase B's pipeline (whisper-medium, the ResNet-50 scorer, the
    100-keyword catalog, beam 5 capped at ``positions``) on ``params``."""
    import torch

    from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog
    from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions
    from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper, CBWhisperConfig
    from enhance_cb_whisper_tpu_torch.models.kws import KWSModel
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig

    kws = KWSModel(ResNetConfig.from_version("resnet-50", num_channels=12)).load_converted(
        {k: torch.as_tensor(v) for k, v in kws_state.items()})
    opts = GenerationOptions(
        num_beams=5, return_timestamps=True, condition_on_prev_tokens=True,
        language_token_id=50259, task_token_id=50359, begin_suppress_tokens=(220, 50257),
        max_target_positions=positions,
    )
    return CBWhisper(
        config=CBWhisperConfig(), whisper_config=WhisperConfig(), whisper_params=params, kws_model=kws,
        catalog=KeywordCatalog.from_arrays([f"kw{i}" for i in range(N_KW)], stacks),
        generation_options=opts,
        prompt_ids_fn=lambda text: [50361] + [100 + (ord(c) % 1000) for c in text][:8],
        decode_fn=lambda toks: " ".join(map(str, toks)),
        kws_layer_slice=(10, 22), device=device,
    )


def _q_features(device, audio):
    """Each utterance's mels through K1, and its attention mask."""
    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features

    return [prepare_features(a, n_mels=80, device=device) for a in audio]


def _q_spot(cb, feats, mesh):
    """int8 spotting (stages 1-3 on K2, calibrated on the first window)
    over each utterance's first window, the catalog sharded over ``mesh``'s
    ``model`` ranks or whole; returns (keywords, K2 launches)."""
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda
    from enhance_cb_whisper_tpu_torch.parallel.sharding import shard_catalog

    cb._ensure_catalog()
    if mesh is not None:
        cb._catalog_dev = shard_catalog(cb._catalog_dev, mesh)
    cb.enable_int8_spotting(calibration_batches=1, s8_1x1=S8_STAGES)
    before = matmul_s8_cuda.kernel.launches
    keywords = [cb.spot_keywords(cb.generator._pad_segment(f[:, :, :3000]))[0] for f, _ in feats]
    return keywords, matmul_s8_cuda.kernel.launches - before


@contextlib.contextmanager
def _q_counted_reduces():
    """The number of ``all_reduce`` calls in the block."""
    import torch.distributed as dist

    real = dist.all_reduce
    rec = {"calls": 0}

    def counted(*args, **kwargs):
        rec["calls"] += 1
        return real(*args, **kwargs)

    dist.all_reduce = counted
    try:
        yield rec
    finally:
        dist.all_reduce = real


def _q_reduce_ms(device, group, calls: int = 200) -> float:
    """ms per gloo ``all_reduce`` of a beam-5 decode step's [5, 1, 1024]
    f32 activation over ``group`` (every rank of it calls this), from
    device to device: what each row-parallel linear of a TP decode step
    pays on top of its GEMM."""
    import torch
    import torch.distributed as dist

    x = torch.randn(5, 1, 1024, device=device)
    for _ in range(10):
        dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def _q_decode(cb, feats):
    """Each utterance through ``CBWhisper.forward`` (spotting, prompt, beam
    search, seek): (texts, decode steps, seconds)."""
    import torch

    steps = {"n": 0}
    step = cb.generator._decode_step

    def counted(*args, **kwargs):
        steps["n"] += 1
        return step(*args, **kwargs)

    cb.generator._decode_step = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = [cb.forward(f, attention_mask=m) for f, m in feats]
    torch.cuda.synchronize()
    cb.generator._decode_step = step
    return texts, steps["n"], time.perf_counter() - t0


def _q_mesh_rank(params, kws_state, stacks, audio, ckpt_dir):
    """A rank of the world of 2 (gloo, both on cuda:0): the data-parallel
    step (data=2), then at model=2 the sharded int8 catalog, the TP encoder
    and the TP longform decode; saves the step's state sharded."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, encoder_forward
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda
    from enhance_cb_whisper_tpu_torch.parallel.mesh import make_mesh, rank_device
    from enhance_cb_whisper_tpu_torch.parallel.sharding import shard_catalog, whisper_param_sharding
    from enhance_cb_whisper_tpu_torch.runtime.sharded_checkpoint import save_sharded

    device = rank_device()
    torch.set_num_threads(Q_THREADS)
    mel_cuda.kernel.launches = matmul_s8_cuda.kernel.launches = 0
    rank = dist.get_rank()
    out = {"rank": rank, "device": str(device)}
    t0 = time.perf_counter()
    marks = out["marks"] = {}
    dp_mesh = make_mesh({"data": 2, "model": 1})
    state, out["dp_metrics"], out["dp_ms"] = _q_dp(device, dp_mesh)
    out["dp_kernel"] = state.kws.model.classifier.weight.detach().cpu().numpy()
    out["dp_digest"] = _q_digest(state.kws.state_dict().values())
    flat = _q_flat_moments(state)
    half = flat.numel() // 2
    moments = DTensor.from_local(flat[rank * half:(rank + 1) * half], dp_mesh["data"], [Shard(0)],
                                 run_check=False)
    t1 = time.perf_counter()
    save_sharded(ckpt_dir, {"kws": dict(state.kws.state_dict()), "exp_avg": moments, "step": 1})
    out["save_s"] = time.perf_counter() - t1
    out["moments_digest"] = _q_digest([flat])
    del state, flat, moments
    torch.cuda.empty_cache()
    marks["dp_and_save"] = time.perf_counter() - t0

    tp_mesh = make_mesh({"data": 1, "model": 2})
    feats = _q_features(device, audio)
    out["keywords"], out["k2_spot"] = _q_spot(_q_cb(device, params, kws_state, stacks), feats, tp_mesh)
    marks["spot"] = time.perf_counter() - t0 - sum(marks.values())

    config = WhisperConfig()
    params_tp = whisper_param_sharding(params, tp_mesh, config)
    seg = feats[2][0][:, :, :3000]
    with torch.no_grad():
        out["encoder"] = encoder_forward(params_tp, seg, config)[0].cpu().numpy()
    marks["encoder"] = time.perf_counter() - t0 - sum(marks.values())

    cb = _q_cb(device, params, kws_state, stacks)
    cb._ensure_catalog()
    cb._catalog_dev = shard_catalog(cb._catalog_dev, tp_mesh)
    cb.generator.params = cb.encoder_params = params_tp
    with _q_counted_reduces() as rec:
        out["texts"], out["steps"], out["decode_s"] = _q_decode(cb, feats)
    out["reduce_calls"] = rec["calls"]
    marks["decode"] = time.perf_counter() - t0 - sum(marks.values())
    out["reduce_ms"] = _q_reduce_ms(device, tp_mesh.get_group("model"))
    out["launches"] = {"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches}
    out["seconds"] = time.perf_counter() - t0
    return out


def _q_window(cb, feat, mask, prof_dir=None):
    """Decode one utterance, timing steps ``Q_WINDOW`` (synchronised at
    both ends) and, with ``prof_dir``, tracing them
    (``runtime/profiler.py:trace``); returns (wall s, profile or None)."""
    import torch

    from enhance_cb_whisper_tpu_torch.runtime.profiler import trace

    window = {"step": 0, "t0": None, "t1": None, "prof": None}
    stack = contextlib.ExitStack()
    step = cb.generator._decode_step

    class WindowDone(Exception):
        """Ends the decode after the window: its later steps time nothing."""

    def windowed(*args, **kwargs):
        if window["step"] == Q_WINDOW[0]:
            torch.cuda.synchronize()
            if prof_dir is not None:
                window["prof"] = stack.enter_context(trace(prof_dir))
            window["t0"] = time.perf_counter()
        result = step(*args, **kwargs)
        window["step"] += 1
        if window["step"] == Q_WINDOW[1]:
            torch.cuda.synchronize()
            window["t1"] = time.perf_counter()
            stack.close()
            raise WindowDone
        return result

    cb.generator._decode_step = windowed
    try:
        cb.forward(feat, attention_mask=mask)
    except WindowDone:
        pass
    finally:
        cb.generator._decode_step = step
        stack.close()
    if window["t1"] is None:
        raise RuntimeError(f"phase Q: the decode took {window['step']} steps, fewer than {Q_WINDOW[1]}")
    return window["t1"] - window["t0"], window["prof"]


def _q_ref_rank(params, kws_state, stacks, audio, ckpt_dir):
    """The world of 1 (NCCL): every reference of the mesh rank's checks on
    one rank, the TP encoder over a 1-rank model group (NCCL's reduce), the
    2-rank checkpoint restored, and a profiled window of beam-5 decode
    steps beside the same steps unprofiled."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, encoder_forward
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda
    from enhance_cb_whisper_tpu_torch.parallel.mesh import make_mesh, rank_device
    from enhance_cb_whisper_tpu_torch.parallel.sharding import whisper_param_sharding
    from enhance_cb_whisper_tpu_torch.runtime.profiler import device_op_breakdown
    from enhance_cb_whisper_tpu_torch.runtime.sharded_checkpoint import restore_sharded

    device = rank_device()
    torch.set_num_threads(Q_THREADS)
    mel_cuda.kernel.launches = matmul_s8_cuda.kernel.launches = 0
    out = {}
    t0 = time.perf_counter()
    marks = out["marks"] = {}
    state, out["dp_metrics"], out["dp_ms"] = _q_dp(device, None)
    out["dp_kernel"] = state.kws.model.classifier.weight.detach().cpu().numpy()
    template = {"kws": {k: torch.zeros_like(v) for k, v in state.kws.state_dict().items()},
                "exp_avg": torch.zeros_like(_q_flat_moments(state)), "step": 0}
    del state
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    restored = restore_sharded(ckpt_dir, template)
    out["restore_s"] = time.perf_counter() - t1
    out["restored_digest"] = _q_digest(restored["kws"].values())
    out["restored_moments_digest"] = _q_digest([restored["exp_avg"]])
    out["restored_step"] = restored["step"]
    del restored, template
    marks["dp_and_restore"] = time.perf_counter() - t0

    feats = _q_features(device, audio)
    out["keywords"], out["k2_spot"] = _q_spot(_q_cb(device, params, kws_state, stacks), feats, None)
    marks["spot"] = time.perf_counter() - t0 - sum(marks.values())
    config = WhisperConfig()
    seg = feats[2][0][:, :, :3000]
    mesh = make_mesh({"data": 1, "model": 1})
    with torch.no_grad():
        out["encoder"] = encoder_forward(params, seg, config)[0].cpu().numpy()
        out["encoder_nccl"] = encoder_forward(whisper_param_sharding(params, mesh, config), seg, config)[0].cpu().numpy()
    marks["encoder"] = time.perf_counter() - t0 - sum(marks.values())

    out["texts"], out["steps"], out["decode_s"] = _q_decode(_q_cb(device, params, kws_state, stacks), feats)
    marks["decode"] = time.perf_counter() - t0 - sum(marks.values())

    # steps Q_WINDOW of the 5.5 s utterance's beam-5 decode at MEDIUM_DECODE,
    # unprofiled, then under the profiler (the same tokens: the decode is
    # deterministic)
    cb = _q_cb(device, params, kws_state, stacks, positions=MEDIUM_DECODE)
    wall, _ = _q_window(cb, *feats[0])
    log_dir = tempfile.mkdtemp(prefix="phase_q_trace_")
    t1 = time.perf_counter()
    prof_wall, prof = _q_window(cb, *feats[0], prof_dir=log_dir)
    marks["profiled_decode"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    total, ops = device_op_breakdown(log_dir)
    marks["breakdown"] = time.perf_counter() - t1
    events = prof.key_averages()

    def self_device_s(kind):
        return sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
                   for e in events if e.device_type == kind) / 1e6

    out["window"] = {"steps": Q_WINDOW[1] - Q_WINDOW[0], "wall_s": wall, "profiled_wall_s": prof_wall,
                     "device_s": total, "ops_self_s": self_device_s(DeviceType.CPU),
                     "device_events_s": self_device_s(DeviceType.CUDA), "ops": ops[:6],
                     "kernels": sum(o["count"] for o in ops)}
    marks["profile_rest"] = time.perf_counter() - t0 - sum(marks.values())
    out["launches"] = {"mel": mel_cuda.kernel.launches, "k2": matmul_s8_cuda.kernel.launches}
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_q(device, cb, stacks, dataset) -> dict:
    """Phase Q: the scale-out paths on the card through
    ``parallel/mesh.py:launch``.  A world of 2 ranks on gloo, both on
    cuda:0 (NCCL refuses two ranks on one device; gloo reduces CUDA
    tensors and the catalog's gathers stage through pinned host memory):
    the data-parallel step at data=2 (10 + 10 of the global 20), then at
    model=2 the int8-sharded 100-keyword catalog, the tensor-parallel
    whisper-medium encoder (16 heads, 8 a rank) on K1's mels and the TP
    longform decode of phase B's utterances; its DP state saved sharded.
    Then a world of 1 on NCCL: every reference, the restore by one rank,
    and a torch.profiler window of beam-5 decode steps (the busy share).
    The whisper-medium weights reach the ranks as CUDA IPC handles of
    phase B's tensors (no copy).  Returns the world of 2's K1 and K2
    launches (the kernel line's ``scale_out_launches``)."""
    import shutil

    import torch

    from enhance_cb_whisper_tpu_torch.audio.io import load_audio_16k
    from enhance_cb_whisper_tpu_torch.parallel.mesh import launch, shutdown

    t0 = time.perf_counter()
    shutil.rmtree(PHASE_Q_DIR, ignore_errors=True)
    PHASE_Q_DIR.mkdir(parents=True)
    audio = [item["audio"] if "audio" in item else load_audio_16k(str(item["path"])) for item in dataset]
    kws_state = {k: v.detach().cpu().numpy() for k, v in cb.kws_model.state_dict().items()}
    args = (cb.generator.params, kws_state, [np.asarray(s) for s in stacks], audio, str(PHASE_Q_DIR / "dp_ckpt"))
    try:
        t1 = time.perf_counter()
        mesh = launch(_q_mesh_rank, 2, backend="gloo", device="cuda", timeout=Q_TIMEOUT, args=args)
        t_mesh = time.perf_counter() - t1
        t1 = time.perf_counter()
        ref = launch(_q_ref_rank, 1, backend="nccl", device="cuda", timeout=Q_TIMEOUT, args=args)[0]
        t_ref = time.perf_counter() - t1
    finally:
        shutdown()  # the fork server and its resource tracker: no process outlives the phase
        shutil.rmtree(PHASE_Q_DIR, ignore_errors=True)
        torch.cuda.ipc_collect()  # the ranks' handles on phase B's weights
    a, b = mesh

    def split(marks):
        return ", ".join(f"{k} {v:.1f}" for k, v in marks.items())

    print(f"phase Q: world of 2 (gloo, {a['device']} and {b['device']}) {t_mesh:.1f} s "
          f"(rank 0 {a['seconds']:.1f} s inside: {split(a['marks'])}), world of 1 (NCCL) {t_ref:.1f} s "
          f"({ref['seconds']:.1f} s inside: {split(ref['marks'])})")

    # 1. data parallelism: 2 x 10 = 1 x 20, and the two ranks' states equal
    loss, want = a["dp_metrics"]["class_loss"], ref["dp_metrics"]["class_loss"]
    kernel_err = float(np.abs(a["dp_kernel"] - ref["dp_kernel"]).max())
    print(f"phase Q DP: class_loss {loss!r} at data=2 vs {want!r} on one rank; classifier kernel "
          f"max diff {kernel_err!r}; the first step {a['dp_ms']:.1f} ms (2 ranks x {Q_DP_BATCH // 2} on one "
          f"card, warm-up included) vs {ref['dp_ms']:.1f} ms (1 x {Q_DP_BATCH})")
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    np.testing.assert_allclose(a["dp_kernel"], ref["dp_kernel"], rtol=1e-4, atol=1e-6)
    if a["dp_digest"] != b["dp_digest"]:
        raise RuntimeError("phase Q DP: the two ranks' states differ after the step")
    # 5. the checkpoint: saved by 2 ranks, restored by 1, equal
    if (ref["restored_digest"], ref["restored_moments_digest"], ref["restored_step"]) != (
            a["dp_digest"], a["moments_digest"], 1):
        raise RuntimeError("phase Q checkpoint: the restored state differs from the saved one")
    print(f"phase Q checkpoint: ResNet-50 state + Adam's moments sharded over data saved by 2 ranks in "
          f"{max(a['save_s'], b['save_s']):.2f} s, restored whole by 1 in {ref['restore_s']:.2f} s: equal")

    # 2. the int8 catalog at model=2: the same keywords, K2 split between the ranks
    if a["keywords"] != ref["keywords"] or b["keywords"] != ref["keywords"]:
        raise RuntimeError(f"phase Q catalog: keywords {a['keywords']} / {b['keywords']} vs {ref['keywords']}")
    if a["k2_spot"] + b["k2_spot"] != ref["k2_spot"] or not a["k2_spot"] or not b["k2_spot"]:
        raise RuntimeError(f"phase Q catalog: K2 {a['k2_spot']} + {b['k2_spot']} vs {ref['k2_spot']} on one rank")
    print(f"phase Q catalog (kws_int8, model=2): keywords equal ({[len(k) for k in ref['keywords']]} a window); "
          f"K2 {a['k2_spot']} + {b['k2_spot']} launches = {ref['k2_spot']} on one rank")

    # 3. the TP encoder
    for name, got in (("model=2 (gloo)", a["encoder"]), ("model=1 (NCCL)", ref["encoder_nccl"])):
        err = float(np.abs(got - ref["encoder"]).max())
        print(f"phase Q TP encoder {name}: max abs diff {err!r} from the unsharded encoder")
        np.testing.assert_allclose(got, ref["encoder"], rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(a["encoder"], b["encoder"])

    # 4. the TP longform decode: token-identical, every rank the same
    if a["texts"] != ref["texts"] or b["texts"] != ref["texts"]:
        raise RuntimeError("phase Q TP decode: transcripts differ from the 1-rank decode")
    per_step = a["reduce_calls"] / a["steps"]
    print(f"phase Q TP decode ({Q_DECODE} positions): {len(ref['texts'])} utterances token-identical; "
          f"{a['steps']} decode steps in {a['decode_s']:.2f} s ({a['decode_s'] / a['steps'] * 1e3:.1f} ms a step) "
          f"vs 1 rank {ref['steps']} in {ref['decode_s']:.2f} s ({ref['decode_s'] / ref['steps'] * 1e3:.1f} ms); "
          f"{a['reduce_calls']} all_reduce calls ({per_step:.1f} a step, the encoder's included) at "
          f"{a['reduce_ms']:.3f} ms a gloo call on [5, 1, 1024] f32: {per_step * a['reduce_ms']:.1f} ms a step")

    # 6. the profiled window
    w = ref["window"]
    busy = w["device_s"] / w["wall_s"]
    agree = abs(w["device_s"] - w["ops_self_s"]) / w["ops_self_s"]
    print(f"phase Q profile: {w['steps']} beam-5 decode steps of whisper-medium (1 rank, {MEDIUM_DECODE} "
          f"positions): {w['wall_s'] * 1e3:.1f} ms unprofiled ({w['profiled_wall_s'] * 1e3:.1f} ms profiled), "
          f"device {w['device_s'] * 1e3:.1f} ms in {w['kernels']} kernels and copies: busy {busy:.1%}, idle "
          f"{1 - busy:.1%} of the unprofiled wall; key_averages: the ops' self CUDA time "
          f"{w['ops_self_s'] * 1e3:.1f} ms ({agree:.2%} apart), the device events' {w['device_events_s'] * 1e3:.1f} ms; "
          f"top {[(o['name'][:40], o['seconds'], o['count']) for o in w['ops'][:4]]}")
    if agree > 0.01:
        raise RuntimeError(f"phase Q profile: device_op_breakdown and key_averages disagree by {agree:.2%}")

    launches = {k: a["launches"][k] + b["launches"][k] for k in ("mel", "k2")}
    if not launches["mel"] or not launches["k2"]:
        raise RuntimeError(f"phase Q: the ranks launched K1/K2 {launches}")
    print(f"phase Q: {time.perf_counter() - t0:.1f} s; the world of 2's launches {launches} "
          f"(per rank {a['launches']} and {b['launches']}; the world of 1 {ref['launches']})")
    return launches


def _median_ms(fn, reps: int = 25) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(fn, calls: int = 10, reps: int = 15) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    median over ``reps`` replays, so host launch gaps are not timed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _median_ms(graph.replay, reps) / calls


def _cupti_ms(fn, kernel: str, calls: int = 20):
    """Mean run time on the card of the kernel whose name holds ``kernel``,
    over ``calls`` eager calls of ``fn``, from torch.profiler's CUPTI trace:
    the kernel alone, without the gaps between launches; None if the trace
    holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and kernel in evt.key:
            us = getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)
            return us / evt.count / 1e3
    return None


def _host_ms(fn, calls: int = 200) -> float:
    """Host time of one ``fn()``: ``calls`` calls enqueued back to back with
    no synchronisation between them, on the host's clock."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e3


def _stft_log10_mel(audio, window, fb):
    """log10 mel by several library calls: torch.stft (cuFFT, reflect
    padding) → |·|² → drop the last frame → filterbank product → log10.
    For scale only: the port never makes these calls."""
    import torch

    spec = torch.stft(audio, 400, 160, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    mel = fb.t() @ (spec.abs() ** 2)[..., :-1]
    return torch.log10(torch.clamp_min(mel, 1e-10))


def phase_c(device):
    """K1 at [1, 480000], [8, 480000] and the longform [1, 760000], 80 mels,
    and at [1, 480000] and [16, 480000], 128 mels (whisper-large-v3): device
    time from CUDA-graph replays, beside the least time of one graph node; the kernel's own run
    time (CUPTI); the eager wrapper's time and its host time per call; the
    plain version's eager time (it copies its tables to the card on every
    call, so it cannot be captured); and for scale the cuFFT sequence of
    :func:`_stft_log10_mel`."""
    import torch

    from enhance_cb_whisper_tpu_torch.ops import mel_cuda
    from enhance_cb_whisper_tpu_torch.ops.mel import apply_dynamic_range, log10_mel_plain, mel_filter_bank

    rng = np.random.default_rng(SEED + 3)
    one = torch.zeros(1, device=device)
    floor = _graph_ms(lambda: one.fill_(1.0))
    print(f"phase C: one kernel node that writes one float: {floor!r} ms [CUDA-graph replays], "
          f"the least time of any launch in this timing")
    window = torch.hann_window(400, periodic=True, device=device)
    out = {}
    for batch, n_samples, n_mels in ((1, 480000, 80), (8, 480000, 80), (1, int(16000 * LONGFORM_SECONDS), 80),
                                     (1, 480000, 128), (J_BATCH, 480000, 128)):
        fb = torch.from_numpy(mel_filter_bank(n_mels)).to(device)
        audio = torch.from_numpy(_audio(batch, n_samples, rng)).to(device)
        kernel = lambda: mel_cuda.log10_mel(audio, n_mels)  # noqa: E731
        plain = lambda: log10_mel_plain(audio, n_mels)  # noqa: E731
        stft = lambda: _stft_log10_mel(audio, window, fb)  # noqa: E731
        g1, g2 = _graph_ms(kernel), _graph_ms(kernel)
        # plain, kernel, kernel, plain: drift in clocks shows as a spread
        p1, e1, e2, p2 = (_median_ms(f) for f in (plain, kernel, kernel, plain))
        ms, eager, plain_ms = (statistics.median(pair) for pair in ((g1, g2), (e1, e2), (p1, p2)))
        alone, host = _cupti_ms(kernel, "log_mel_kernel"), _host_ms(kernel)
        try:
            stft_ms = _graph_ms(stft)
            stft_err = (apply_dynamic_range(stft()) - apply_dynamic_range(plain())).abs().max().item()
            stft_text = f"{stft_ms!r} ms [CUDA-graph replays], max |diff| vs plain {stft_err!r}"
        except RuntimeError as err:
            stft_text = f"not measured: {err}"
        print(f"phase C: K1 [{batch}, {n_samples}] n_mels={n_mels}: device {ms!r} ms ({g1!r}, {g2!r}) "
              f"[CUDA-graph replays], of which the kernel runs {alone!r} ms [CUPTI, mean of 20]; "
              f"eager wrapper {eager!r} ms ({e1!r}, {e2!r}), its host time {host!r} ms a call "
              f"[mean of 200 enqueued back to back]; plain torch "
              f"eager {plain_ms!r} ms ({p1!r}, {p2!r}); medians of 25 CUDA-event timings each")
        print(f"phase C: [{batch}, {n_samples}] n_mels={n_mels} torch.stft (cuFFT) -> |.|^2 -> drop last frame -> "
              f"filterbank -> log10, several library calls the port never makes, for scale only: "
              f"{stft_text}")
        out[(batch, n_samples, n_mels)] = (ms, plain_ms)
    return out


def k1_bound(n_samples: int = 480000, n_mels: int = 80) -> dict:
    """Least time of log-mel at [1, n_samples]: audio in + mel out over HBM,
    against the function's least FP32 work over the FP32 peak — per frame a
    Hann window, a real FFT (2.5 N log2 N operations), the power spectrum,
    the filterbank's nonzero taps and the log.  ``dft_ms`` is, for
    information, the same count for K1's own direct DFT (a product with the
    dense DFT tables and the dense filterbank)."""
    from enhance_cb_whisper_tpu_torch.ops.mel import HOP_LENGTH, N_FFT, N_FREQS, mel_filter_bank

    frames = n_samples // HOP_LENGTH
    taps = int(np.count_nonzero(mel_filter_bank(n_mels)))
    ops = frames * (N_FFT + 2.5 * N_FFT * np.log2(N_FFT) + 3 * N_FREQS + 2 * taps + n_mels)
    dft_ops = frames * (N_FFT * N_FREQS * 2 * 2 + 3 * N_FREQS + N_FREQS * n_mels * 2 + n_mels)
    bytes_ = n_samples * 4 + frames * n_mels * 4
    t_ops, t_bytes = ops / FP32_RATE * 1e3, bytes_ / HBM_RATE * 1e3
    return {"ms": max(t_ops, t_bytes), "by": "bytes" if t_bytes >= t_ops else "operations",
            "ops": float(ops), "taps": taps, "bytes": bytes_, "dft_ms": dft_ops / FP32_RATE * 1e3}


def print_k1_bound() -> dict:
    """Prints K1's bound at the longform [1, 760000], at [1, 480000] with
    128 mels (whisper-large-v3) and at [1, 480000]; returns the last."""
    for n_samples, n_mels in ((int(16000 * LONGFORM_SECONDS), 80), (480000, 128), (480000, 80)):
        k1 = k1_bound(n_samples, n_mels)
        print(f"phase C: K1 bound at [1, {n_samples}] n_mels={n_mels} {k1['ms']!r} ms, {k1['by']}-bound "
              f"({k1['bytes']} B; {k1['ops']!r} FP32 operations with a real FFT per frame and "
              f"{k1['taps']} nonzero filterbank taps); K1's direct DFT would need "
              f"{k1['dft_ms']!r} ms at the FP32 peak")
    return k1


def _int_mm_ms(x, w):
    """Device time of ``torch._int_mm`` (cuBLASLt s8 x s8 -> s32) on K2's
    operands: the product alone, 4 B per output and no epilogue, so not the
    same function; a yardstick only, never called by the port."""
    import torch

    try:
        return _graph_ms(lambda: torch._int_mm(x, w))
    except RuntimeError as err:
        print(f"phase C: torch._int_mm at {tuple(x.shape)} x {tuple(w.shape)} not measured: {err}")
        return None


def phase_c_k2(device, shapes, what=f"chunk of {CHUNK} maps"):
    """K2 and its plain version at each shape of a ``what``: device time (CUDA
    graph) and eager wrapper time, summed over the chunk's 22 launches;
    the byte and operation bound of the same work; the launch plan; and,
    for scale, cuBLASLt's int8 product alone.  No single PyTorch call
    computes an s8 matmul with this requant epilogue: no library time."""
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda
    from enhance_cb_whisper_tpu_torch.ops.matmul_s8 import matmul_s8_requant_plain

    rng = np.random.default_rng(SEED + 6)
    totals = {"ms": 0.0, "plain_ms": 0.0, "eager_ms": 0.0, "plain_eager_ms": 0.0,
              "bound_ms": 0.0, "ops": 0, "bytes": 0}
    per_shape = {}
    for shape in shapes:
        per_shape.setdefault(shape, 0)
        per_shape[shape] += 1
    for (m, k, n, residual), count in per_shape.items():
        # the int8 scorer's fused tails pass a 0-d res_scale
        x, w, scale, bias, res = _k2_inputs(rng, m, k, n, residual and "scalar", device)
        kernel = lambda: matmul_s8_cuda.matmul_s8_requant(x, w, scale, bias, **res)  # noqa: E731
        plain = lambda: matmul_s8_requant_plain(x, w, scale, bias, **res)  # noqa: E731
        p1, k1, k2, p2 = (_graph_ms(f) for f in (plain, kernel, kernel, plain))
        ms, plain_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
        eager, plain_eager = _median_ms(kernel), _median_ms(plain)
        int_mm = _int_mm_ms(x, w)
        ops = 2 * m * n * k
        bytes_ = m * k + k * n + m * n + 2 * 4 * n + ((m * n + 4) if residual else 0)
        bound = max(ops / INT8_RATE, bytes_ / HBM_RATE) * 1e3
        print(f"phase C: K2 (M, K, N)={(m, k, n)} residual={residual} x{count} per {what} "
              f"[{_plan_text(m, k, n)}]: device {ms!r} ms ({k1!r}, {k2!r}) [CUDA-graph replays], "
              f"bound {bound!r} ms ({bytes_} B, {ops} int8 ops), {ms / bound!r}x the bound, "
              f"{bytes_ / ms / 1e6!r} GB/s; eager wrapper {eager!r} ms per launch; plain {plain_ms!r} ms "
              f"({p1!r}, {p2!r}), plain eager {plain_eager!r} ms; torch._int_mm "
              f"{'not measured' if int_mm is None else repr(int_mm) + ' ms'} "
              f"(product alone, not the same function)")
        totals["ms"] += ms * count
        totals["plain_ms"] += plain_ms * count
        totals["eager_ms"] += eager * count
        totals["plain_eager_ms"] += plain_eager * count
        totals["bound_ms"] += bound * count
        totals["ops"] += ops * count
        totals["bytes"] += bytes_ * count
    print(f"phase C: K2 per {what} ({len(shapes)} launches): device {totals['ms']!r} ms "
          f"({totals['ms'] / totals['bound_ms']!r}x the bound), plain {totals['plain_ms']!r} ms; eager "
          f"{totals['eager_ms']!r} ms ({totals['eager_ms'] / len(shapes)!r} ms per launch), plain eager "
          f"{totals['plain_eager_ms']!r} ms; bound {totals['bound_ms']!r} ms "
          f"({totals['bytes']} B, {totals['ops']} int8 ops: bytes-bound)")
    return totals


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv) -> int:
    import torch

    if argv not in ([], ["--k1"], ["--k3"], ["--k4"], ["--serving"], ["--levers"], ["--train"], ["--paper2"],
                    ["--paper2-train"], ["--pipeline"], ["--scale-out"]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.runtime.precision import reference_precision

    # the JAX reference runs its einsums at precision="highest": full fp32
    reference_precision()
    device = torch.device("cuda", 0)

    t_start = time.perf_counter()
    if argv == ["--train"]:  # the training phase alone
        phase_h(device)
        print(f"chip_smoke --train: passed in {time.perf_counter() - t_start:.1f} s")
        print(_card())
        return 0
    if argv == ["--k1"]:  # K1 alone: build, phase A, K1's timings
        from enhance_cb_whisper_tpu_torch.ops import mel_cuda

        mel_lib = mel_cuda.kernel.build()
        print(f"build: {KERNEL_SOURCE} compiled and loaded in {time.perf_counter() - t_start:.1f} s")
        _print_ptxas("K1", mel_lib)
        phase_a(device)
        phase_a_features(device)
        phase_c(device)
        print_k1_bound()
        print(_card())
        return 0
    if argv == ["--k3"]:  # K3 alone: build and phase A3
        from enhance_cb_whisper_tpu_torch.ops import maxsim_cuda

        k3_lib = maxsim_cuda.kernel.build()
        print(f"build: {K3_SOURCE} compiled and loaded in {time.perf_counter() - t_start:.1f} s")
        _print_ptxas("K3", k3_lib)
        phase_a3(device)
        print(f"chip_smoke --k3: passed in {time.perf_counter() - t_start:.1f} s")
        print(_card())
        return 0
    if argv == ["--k4"]:  # K4 alone: build and phase A4
        from enhance_cb_whisper_tpu_torch.ops import beam_attention

        k4_lib = beam_attention.kernel.build()
        print(f"build: {K4_SOURCE} compiled and loaded in {time.perf_counter() - t_start:.1f} s")
        _print_ptxas("K4", k4_lib)
        phase_a4(device)
        phase_a4_beams(device)
        print(f"chip_smoke --k4: passed in {time.perf_counter() - t_start:.1f} s")
        print(_card())
        return 0
    if argv in (["--paper2-train"], ["--pipeline"]):  # K1, phase A and phase J or P alone
        from enhance_cb_whisper_tpu_torch.ops import mel_cuda

        mel_lib = mel_cuda.kernel.build()
        print(f"build: {KERNEL_SOURCE} compiled and loaded in {time.perf_counter() - t_start:.1f} s")
        _print_ptxas("K1", mel_lib)
        phase_a(device)
        (phase_j if argv == ["--paper2-train"] else phase_p)(device)
        print(f"chip_smoke {argv[0]}: passed in {time.perf_counter() - t_start:.1f} s")
        print(_card())
        return 0
    build_kernels()
    shapes = k2_launch_shapes(ResNetConfig.from_version("resnet-50", num_channels=12))
    p2_shapes = p2_k2_shapes()
    if argv == ["--paper2"]:  # phase A2 at paper 2's shapes and phase I alone
        for name, group in p2_shapes.items():
            phase_a2(device, group, f"chunk of {P2_CHUNK} paper-2 {name} maps", ragged=())
        phase_i(device, p2_shapes["LEF"])
        phase_c_k2(device, p2_shapes["LEF"], f"chunk of {P2_CHUNK} paper-2 LEF maps")
        print(f"chip_smoke --paper2: passed in {time.perf_counter() - t_start:.1f} s")
        print(_card())
        return 0
    if argv == ["--serving"]:  # phase A2 and the serving phase F alone
        phase_a2(device, shapes)
        phase_f1(device)
        cb = _medium_pipeline(device)[0]
        _unzero_residual_bn(cb.kws_model)
        phase_f2(device, cb, _slice_dataset(), shapes)
        print(f"chip_smoke --serving: passed in {time.perf_counter() - t_start:.1f} s")
        print(_card())
        return 0
    if argv == ["--scale-out"]:  # phase Q alone, on phase B's model and utterances
        cb, _, _, kws, stacks = _medium_pipeline(device)
        _unzero_residual_bn(kws)
        dataset = _slice_dataset()
        from enhance_cb_whisper_tpu_torch.audio.io import prepare_features

        _centre_class1(cb, cb.generator._pad_segment(prepare_features(dataset[0]["audio"], device=device)[0]))
        phase_q(device, cb, stacks, dataset)
        print(f"chip_smoke --scale-out: passed in {time.perf_counter() - t_start:.1f} s")
        print(_card())
        return 0
    if argv == ["--levers"]:  # phase A2 and the serving levers' phase G alone
        phase_a2(device, shapes)
        phase_g1(device)
        cb, _, _, kws, _ = _medium_pipeline(device)
        _unzero_residual_bn(kws)
        dataset = _slice_dataset()
        phase_g2(device, cb, dataset, shapes)
        phase_g3(device, cb, dataset, shapes)
        print(f"chip_smoke --levers: passed in {time.perf_counter() - t_start:.1f} s")
        print(_card())
        return 0

    max_abs_err = phase_a(device)
    phase_a_features(device)
    mismatches, k2_err = phase_a2(device, shapes)
    for name, group in p2_shapes.items():
        more, err = phase_a2(device, group, f"chunk of {P2_CHUNK} paper-2 {name} maps", ragged=())
        mismatches, k2_err = mismatches + more, max(k2_err, err)
    k3 = phase_a3(device)
    k4 = phase_a4(device)[K4_TIMED[0]]
    phase_a4_beams(device)
    check_tf32_off(device)
    phase_b_reference(device)
    phase_b_longform_reference(device)
    fp32_launches, int8_launches, cb, dataset, stacks = phase_b_slice(device, shapes)
    phase_d(device, cb.kws_model, stacks, shapes)
    scale_out_launches = phase_q(device, cb, stacks, dataset)
    cli_launches = phase_e(cb.whisper_config, cb.generator.params, cb.kws_model, stacks, shapes)
    phase_f1(device)
    packed_launches = phase_f2(device, cb, dataset, shapes)
    phase_g1(device)
    levers_launches = phase_g2(device, cb, dataset, shapes)
    phase_g3(device, cb, dataset, shapes)
    del cb
    train_launches = phase_h(device)
    paper2_launches = phase_i(device, p2_shapes["LEF"])
    paper2_train_launches = phase_j(device)
    pipeline_launches = phase_p(device)
    times = phase_c(device)
    k2 = phase_c_k2(device, shapes)
    phase_c_k2(device, p2_shapes["LEF"], f"chunk of {P2_CHUNK} paper-2 LEF maps")
    k1 = print_k1_bound()
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    print(_card())
    ms, plain_ms = times[(1, 480000, 80)]
    print(json.dumps({"kernels": [
        {"name": "log10_mel", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": fp32_launches["mel"], "cli_launches": cli_launches["mel"],
         "packed_launches": packed_launches["mel"], "levers_launches": levers_launches["mel"],
         "train_launches": train_launches["mel"], "paper2_launches": paper2_launches["mel"],
         "paper2_train_launches": paper2_train_launches["mel"], "pipeline_launches": pipeline_launches["mel"],
         "scale_out_launches": scale_out_launches["mel"], "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": k1["ms"], "bound_by": k1["by"], "library_ms": None},
        {"name": "matmul_s8_requant", "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": int8_launches["k2"], "cli_launches": cli_launches["k2"],
         "packed_launches": packed_launches["k2"], "levers_launches": levers_launches["k2"],
         "train_launches": train_launches["k2"], "paper2_launches": paper2_launches["k2"],
         "paper2_train_launches": paper2_train_launches["k2"], "scale_out_launches": scale_out_launches["k2"],
         "max_abs_err": k2_err, "mismatches": mismatches,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "maxsim_proxy", "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
         "paper2_launches": paper2_launches["k3"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": "operations", "library_ms": None},
        {"name": "beam_attention", "route": "cuda", "source": K4_SOURCE, "replaces": K4_REPLACES,
         "launches": fp32_launches["k4"], "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
