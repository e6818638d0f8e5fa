"""Tiny versions of the benchmark's configurations and mixes, for runs of
the whole harness on the CPU: the same code paths at widths a test holds."""

from __future__ import annotations

import copy

import torch

from perfbench import harness

TINY_RESNET = {"embedding_size": 8, "hidden_sizes": [8, 16, 24, 32], "depths": [1, 1, 1, 1],
               "layer_type": "bottleneck"}
SEED = 2**31 + 977  # above 32 signed bits: a run's seed may be that large


def config(cell: str) -> dict:
    bench = harness.load_benchmark()
    entry = harness.by_name(bench["workloads"], cell, "workload")
    cfg = copy.deepcopy(harness.load_json(harness.ROOT / harness.by_name(bench["configs"], entry["config"],
                                                                         "configuration")["file"]))
    if entry["config"].startswith("cbw"):
        cfg.update(d_model=64, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
                   decoder_attention_heads=2, encoder_ffn_dim=128, decoder_ffn_dim=128, max_target_positions=40)
        cfg["kws"].update(resnet=TINY_RESNET, num_channels=2, layer_slice=[1, 3], features_size=[30, 150],
                          keywords=8, keyword_frames=[2, 5])
    else:
        cfg.update(embedding_dim=128, resnet=TINY_RESNET)
    return cfg


def mix(cell: str) -> dict:
    m = copy.deepcopy(harness.load_json(harness.BENCH_DIR / "workloads" / f"{cell}.json"))
    if m["driver"] in ("serve", "spot"):
        m.update(slots=2, outstanding=4, seconds=[2.0, 6.0], block=2, check_launches=2, check_requests=2,
                 check_requests_min=2, check_pool=4, trace_requests=2)
    else:
        m.update(keywords=512 if m.get("shortlist") else 256, keyword_frames=16, utterance_frames=40, chunk=64,
                 check_pool=3, check_requests=2, check_requests_min=2, trace_requests=2)
        if m.get("shortlist"):
            m["shortlist"] = 128
    return m


def env(cell: str, trace: bool = False, seed: int = SEED) -> harness.Env:
    return harness.Env(cell, config(cell), mix(cell), seed, torch.device("cpu"), trace)
