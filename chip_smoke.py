#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (enhance_cb_whisper_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, then:

A. holds the fused mel kernel (csrc/mel.cu) against its plain torch version
   on the card: [4, 480000] at 80 and 128 mels and a 37 s [2, 592000]
   batch, rtol 1e-4 / atol 1e-5 (the JAX package's Pallas-kernel tolerance);
B. checks the CUDA path against the CPU path on a tiny random CB-Whisper
   (identical keywords and transcripts), then drives the main path —
   ``CBWhisper.run_test`` over three synthetic utterances of 5-30 s — at
   whisper-medium widths (random weights from a numpy seed), with the
   12-channel ResNet-50 KWS scorer at 150x750, layer slice (10, 22), a
   100-keyword catalog and beam-5 fp32 decoding, counting the kernel's
   launches over exactly that run;
C. times the kernel and its plain version (median of CUDA-event timings)
   at [1, 480000] and [8, 480000].

Any failure raises and exits non-zero.  The line before the last is the
kernel summary as JSON, the last line the device as JSON.  Needs one card;
there is no CPU fallback.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
RTOL, ATOL = 1e-4, 1e-5
KERNEL_SOURCE = "enhance_cb_whisper_tpu_torch/csrc/mel.cu"
REPLACES = "enhance_cb_whisper_tpu/ops/mel_pallas.py:56"


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


def phase_a(device) -> float:
    import torch

    from enhance_cb_whisper_tpu_torch.ops import mel_cuda
    from enhance_cb_whisper_tpu_torch.ops.mel import apply_dynamic_range, log10_mel_plain

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for batch, n_samples in ((4, 480000), (2, 592000)):
        audio = torch.from_numpy(_audio(batch, n_samples, rng)).to(device)
        for n_mels in (80, 128):
            got = apply_dynamic_range(mel_cuda.log10_mel(audio, n_mels))
            torch.cuda.synchronize()
            want = apply_dynamic_range(log10_mel_plain(audio, n_mels))
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError("mel kernel produced non-finite values")
            max_abs, max_rel, ok = _close(got, want)
            worst = max(worst, max_abs)
            print(f"phase A: mel kernel vs plain [{batch}, {n_samples}] n_mels={n_mels}: "
                  f"max_abs_err={max_abs!r} max_rel_err={max_rel!r} "
                  f"(rtol {RTOL}, atol {ATOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("mel kernel disagrees with its plain version")
    return worst


def _tiny_pipeline(device):
    """A tiny random CB-Whisper (the CPU tests' dims) on ``device``."""
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
    params = from_jax_whisper_params(init_whisper_params(rng, cfg), device)
    keywords = [f"kw{i}" for i in range(6)]
    stacks = []
    for _ in keywords:
        s = rng.standard_normal((2, int(rng.integers(3, 12)), 64)).astype(np.float32)
        stacks.append(s / np.linalg.norm(s, axis=-1, keepdims=True))
    kws = init_kws_model(
        ResNetConfig(num_channels=2, embedding_size=8, hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1)),
        torch.Generator().manual_seed(SEED),
    )
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
        kws_layer_slice=(1, 3), device=device,
    )


def phase_b_reference(device) -> None:
    """CUDA path (mel kernel, cuBLAS/cuDNN fp32) vs the CPU path (plain
    mel) of the same tiny model: identical keywords and transcripts."""
    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features

    rng = np.random.default_rng(SEED + 1)
    waves = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in (6.0, 21.0)]
    results = {}
    for dev in ("cpu", device):
        cb = _tiny_pipeline(dev)
        spotted, preds = [], []
        for wav in waves:
            features, _ = prepare_features(wav, n_mels=80, device=dev)
            spotted.append(cb.spot_keywords(features))
            preds.append(cb.forward(features))
        results[str(dev)] = (spotted, preds)
    cpu, gpu = results["cpu"], results[str(device)]
    print(f"phase B reference: tiny model cpu vs cuda keywords={gpu[0]} transcripts equal={cpu[1] == gpu[1]}")
    if cpu != gpu:
        raise RuntimeError(f"CUDA path disagrees with the CPU path: {gpu} vs {cpu}")


def phase_b_slice(device):
    """The main path at whisper-medium widths; returns the K1 launch count
    of exactly the run_test call."""
    import torch

    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
    from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog
    from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
    from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions
    from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper, CBWhisperConfig
    from enhance_cb_whisper_tpu_torch.models.kws import init_kws_model
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.models.whisper import (
        WhisperConfig,
        encoder_kws_stack,
        init_whisper_params,
    )
    from enhance_cb_whisper_tpu_torch.ops import mel_cuda

    t0 = time.perf_counter()
    config = WhisperConfig()  # whisper-medium: 51865 vocab, d 1024, 24+24 layers, 16 heads
    rng = np.random.default_rng(SEED)
    params = from_jax_whisper_params(init_whisper_params(rng, config), device)
    n_kw = 100
    stacks = []
    for _ in range(n_kw):
        s = rng.standard_normal((12, int(rng.integers(4, 20)), config.d_model)).astype(np.float32)
        stacks.append(s / np.linalg.norm(s, axis=-1, keepdims=True))
    keywords = [f"kw{i}" for i in range(n_kw)]
    kws = init_kws_model(ResNetConfig.from_version("resnet-50", num_channels=12),
                         torch.Generator().manual_seed(SEED))
    opts = GenerationOptions(
        num_beams=5, return_timestamps=True, condition_on_prev_tokens=True,
        language_token_id=50259, task_token_id=50359, begin_suppress_tokens=(220, 50257),
    )
    cb = CBWhisper(
        config=CBWhisperConfig(), whisper_config=config, whisper_params=params, kws_model=kws,
        catalog=KeywordCatalog.from_arrays(keywords, stacks),
        generation_options=opts,
        prompt_ids_fn=lambda text: [50361] + [100 + (ord(c) % 1000) for c in text][:8],
        decode_fn=lambda toks: " ".join(map(str, toks)),
        kws_layer_slice=(10, 22), device=device,
    )
    torch.cuda.synchronize()
    print(f"phase B: whisper-medium + ResNet-50 KWS built in {time.perf_counter() - t0:.1f} s")

    # instrumentation: segments scored, keywords, tokens and the time of
    # each stage, per utterance (each stage ends in a device synchronisation)
    scored, spotted, generated, marks = [], [], [], []
    score_fn, score_to_keywords = cb._score_fn, cb._score_to_keywords
    encode_and_spot, generate = cb.encode_and_spot, cb.generator.generate

    def counted_score(catalog_dev, utt_stack, utt_w):
        probs, logits = score_fn(catalog_dev, utt_stack, utt_w)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("catalog scorer produced non-finite logits")
        scored.append(int(logits.shape[0]))
        return probs, logits

    def recorded_keywords(stacks_):
        out = score_to_keywords(stacks_)
        spotted.extend(out)
        return out

    def timed_encode_and_spot(*args, **kwargs):
        torch.cuda.synchronize()
        marks[-1]["spot_start"] = time.perf_counter()
        out = encode_and_spot(*args, **kwargs)
        torch.cuda.synchronize()
        marks[-1]["spot_end"] = time.perf_counter()
        return out

    def recorded_generate(*args, **kwargs):
        tokens = generate(*args, **kwargs)  # host array: the decode has finished
        marks[-1]["end"] = time.perf_counter()
        if tokens.ndim != 2 or tokens.shape[0] != 1 or not (
            (tokens >= 0) & (tokens < config.vocab_size)).all():
            raise RuntimeError(f"decode produced invalid tokens of shape {tokens.shape}")
        generated.append(int((tokens != opts.pad_token_id).sum()))
        return tokens

    cb._score_fn, cb._score_to_keywords = counted_score, recorded_keywords
    cb.encode_and_spot, cb.generator.generate = timed_encode_and_spot, recorded_generate

    rng = np.random.default_rng(SEED + 2)
    dataset = []
    for i, seconds in enumerate((5.5, 17.25, 29.75)):
        wav = _audio(1, int(16000 * seconds), rng)[0]
        dataset.append({
            "audio": wav,
            "transcript": f"kw{i} appears in utterance {i}",
            "hotword_labels": np.eye(n_kw, dtype=np.int64)[i],
            "speaker": f"s{i % 2}",
        })

    def mel_fn(item):
        marks.append({"start": time.perf_counter()})
        out = prepare_features(item["audio"], n_mels=config.num_mel_bins, device=device)
        torch.cuda.synchronize()
        marks[-1]["mel_end"] = time.perf_counter()
        return out

    # a random head says "present" for every keyword or for none (keyword
    # to keyword, its logit margin varies far less than its offset); centre
    # its class-1 bias on the catalog's median margin over a warm-up
    # utterance so the spotter passes some keywords and not others
    warm = cb.generator._pad_segment(mel_fn(dataset[0])[0])
    cb._ensure_catalog()
    with torch.no_grad():
        stack = encoder_kws_stack(cb.generator.params, warm, config, layer_slice=cb.kws_layer_slice)
        _, logits = score_fn(cb._catalog_dev, stack[0], cb._utt_w)
        margin = logits[:n_kw, 1] - logits[:n_kw, 0]
        kws.model.classifier.bias[1] -= margin.median()
    # warm-up utterance (cuBLAS/cuDNN handles and heuristics), not counted
    cb.forward(warm)
    torch.cuda.synchronize()
    scored.clear(); spotted.clear(); generated.clear(); marks.clear()

    mel_cuda.launches = 0
    t_run = time.perf_counter()
    results = cb.run_test(dataset, mel_fn, num_bootstraps=100)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = mel_cuda.launches

    for i, (item, m) in enumerate(zip(dataset, marks)):
        decode = m["end"] - m["spot_end"]
        print(f"phase B: utterance {i}: {len(item['audio']) / 16000:.2f} s audio, "
              f"wall {m['end'] - m['start']!r} s = mel {m['mel_end'] - m['start']!r} s "
              f"+ encode and spot {m['spot_end'] - m['spot_start']!r} s "
              f"+ prefill and beam-5 decode {decode!r} s ({decode / max(generated[i], 1) * 1e3!r} ms "
              f"per generated token); {generated[i]} generated tokens, "
              f"{len(spotted[i])} keywords spotted {spotted[i][:5]}")
    print(f"phase B: run_test {t_end - t_run!r} s for {len(dataset)} utterances, of which "
          f"entity recall and bootstrap CIs {t_end - marks[-1]['end']!r} s; entity recall "
          f"{results['Entity Recall']!r} [{results['Entity Recall LB']!r}, {results['Entity Recall UB']!r}]; "
          f"mel kernel launches {launches}; segments scored {len(scored)} x {scored[0] if scored else 0} keywords")
    if launches < len(dataset):
        raise RuntimeError(f"mel kernel launched {launches} times for {len(dataset)} utterances")
    if not (len(scored) == len(spotted) == len(generated) == len(marks) == len(dataset)):
        raise RuntimeError("not every segment was scored and decoded")
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


def phase_c(device):
    import torch

    from enhance_cb_whisper_tpu_torch.ops import mel_cuda
    from enhance_cb_whisper_tpu_torch.ops.mel import log10_mel_plain

    rng = np.random.default_rng(SEED + 3)
    out = {}
    for batch in (1, 8):
        audio = torch.from_numpy(_audio(batch, 480000, rng)).to(device)
        kernel = lambda: mel_cuda.log10_mel(audio, 80)  # noqa: E731
        plain = lambda: log10_mel_plain(audio, 80)  # noqa: E731
        # plain, kernel, kernel, plain: drift in clocks shows as a spread
        p1, k1, k2, p2 = (_median_ms(f) for f in (plain, kernel, kernel, plain))
        ms, plain_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
        print(f"phase C: [{batch}, 480000] n_mels=80 mel kernel {ms!r} ms ({k1!r}, {k2!r}); "
              f"plain torch {plain_ms!r} ms ({p1!r}, {p2!r}); median of 25 CUDA-event timings each")
        out[batch] = (ms, plain_ms)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # the JAX reference runs its einsums at precision="highest": full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from enhance_cb_whisper_tpu_torch.ops import mel_cuda

    t0 = time.perf_counter()
    mel_cuda.build()
    print(f"build: {KERNEL_SOURCE} compiled and loaded in {time.perf_counter() - t0:.1f} s")

    max_abs_err = phase_a(device)
    phase_b_reference(device)
    launches = phase_b_slice(device)
    times = phase_c(device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    ms, plain_ms = times[1]
    print(json.dumps({"kernels": [{
        "name": "log10_mel", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
