"""The port's CLI against the JAX CLI, in one process on the CPU.

The ``tests/test_cli_cbwhisper.py`` recipe: a tiny random HF Whisper
checkpoint directory (``config.json`` by ``transformers``, the weights
under HF's names in ``model.safetensors``), a synthetic ACL-6060 layout
(``tests/fixtures.py:make_acl``), a stubbed tokenizer and
``GenerationConfig``, and the hard-wired ResNet-50 shrunk through
``_cbwhisper_kws_resnet`` (both CLIs) to a K2-eligible ResNet (stage_1
widths are 128-multiples).  Its weights sit in a JAX checkpoint directory
(``state.msgpack``), with the class-1 bias centred between the keywords'
margins so that some keywords are spotted and others not.

* ``cb-whisper.py test`` through both CLIs gives identical transcripts,
  identical spotted keywords per segment and equal entity recall with its
  bootstrap bounds (equal only within one process: the CIs number speakers
  by ``enumerate(set(...))``), in fp32 and under ``kws_int8``.  The port's
  ``kws_int8`` takes K2 wherever its shapes allow with no environment
  variable set (the kernel's plain version here); the JAX CLI does so with
  ``ECW_S8_PALLAS`` naming every stage (Pallas in interpret mode).  The config's placeholders are
  filled by ``--set`` and one value by a dotted override.
* ``kws.py test`` and ``validate`` through both CLIs give equal metrics
  (validation loss to rtol 1e-5, the f32 sums running in another order).
* ``eval_batch_size: 2`` (batched decode) and ``eval_packed`` (packed
  decode, 2 slots) through both CLIs give identical transcripts, keywords
  and entity recall.
* The serving knobs, each alone with greedy decode, through both CLIs give
  identical transcripts, keywords and entity recall: ``compute_dtype:
  bfloat16``, ``vocab_int8``, ``decoder_int8``, ``kv_cache_int8``,
  ``kv_cache_int8`` with ``kv_staging``, ``cross_kv_int8``, and
  ``encoder_int8`` with a separate encoder checkpoint (the same weights
  under another path).
* An unfilled placeholder exits both CLIs with the same message; a staging
  window as long as the decode raises; ``fit``
  without ``train_info`` raises, for paper 1 and paper 2; ``kv_staging`` alone is accepted; the language table equals ``transformers``' and the
  generation options match the JAX CLI's for ``language: null`` and
  ``max_initial_timestamp_index: 0``.
* The kernels' lazy loaders and launch counters are safe under threads (the
  CLI's eval computes its mels in a prefetch thread while it decodes).
"""

import dataclasses
import os
import shutil
import types

import numpy as np
import pytest
import torch
import yaml
from safetensors.torch import save_file

import enhance_cb_whisper_tpu.cli.main as jax_cli
import enhance_cb_whisper_tpu.models.resnet as jax_resnet
from enhance_cb_whisper_tpu.models.cb_whisper import CBWhisper as JaxCBWhisper
from enhance_cb_whisper_tpu.runtime.checkpoint import save_checkpoint
from enhance_cb_whisper_tpu_torch.audio.io import load_audio_16k, prepare_features
from enhance_cb_whisper_tpu_torch.catalog.database import device_put_catalog, make_catalog_score_fn
from enhance_cb_whisper_tpu_torch.cli import main as port_cli
from enhance_cb_whisper_tpu_torch.cli.languages import TO_LANGUAGE_CODE
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.data.datasets import ACL6060KeywordDataset
from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper
from enhance_cb_whisper_tpu_torch.models.kws import init_kws_model
from enhance_cb_whisper_tpu_torch.models.quant import s8_stages
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, encoder_kws_stack, init_whisper_params
from enhance_cb_whisper_tpu_torch.models.whisper_loader import hf_whisper_state, load_whisper_from_pretrained
from enhance_cb_whisper_tpu_torch.ops.resize import resize_matrix
from enhance_cb_whisper_tpu_torch.runtime.kws_engine import KWSEngine

from fixtures import make_acl

transformers = pytest.importorskip("transformers")

KW_LAYERS = 2
OUT = (32, 48)
RESNET = dict(num_channels=KW_LAYERS, embedding_size=32, hidden_sizes=(128, 512), depths=(1, 3),
              num_labels=2)
# what the JAX CLI needs to route the int8 scorer as the port's always does
ALL_STAGES = ",".join(sorted(s8_stages(ResNetConfig(**RESNET))))
GC = dict(decoder_start_token_id=3, no_timestamps_token_id=100, eos_token_id=2, pad_token_id=0,
          suppress_tokens=None, begin_suppress_tokens=None, max_initial_timestamp_index=10,
          prev_sot_token_id=99)


class FakeTokenizer:
    handed = []  # the type of every token sequence decode() was handed

    def convert_tokens_to_ids(self, token):
        return {"<|en|>": 10, "<|transcribe|>": 11, "<|startofprev|>": 99}.get(token, 12)

    def get_prompt_ids(self, text):
        return [99] + [20 + (ord(c) % 60) for c in text][:6]

    def decode(self, tokens, skip_special_tokens=True):
        FakeTokenizer.handed.append(
            "ints" if type(tokens) is list and all(type(t) is int for t in tokens) else type(tokens))
        return " ".join(f"w{t}" for t in tokens if 12 < t < 99)


def _flax_variables(model):
    """A torch KWSModel's weights in the flax tree that JAX checkpoints hold."""
    params, stats = {}, {}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        a = t.numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf.startswith("running_"):
            tree, path = stats, path + [{"running_mean": "mean", "running_var": "var"}[leaf]]
        else:
            tree = params
            if leaf == "bias":
                path = path + ["bias"]
            elif a.ndim == 4:
                path, a = path + ["kernel"], a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                path, a = path + ["kernel"], a.T
            else:
                path = path + ["scale"]
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return {"params": params, "batch_stats": stats}


def _centre(model, margins):
    """Lower the class-1 bias into the widest gap among the middle margins,
    so decisions differ by keyword and sit far from the threshold."""
    m = np.sort(np.asarray(margins))
    inner = range(len(m) // 4, len(m) - len(m) // 4 - 1)
    gap = max(inner, key=lambda i: m[i + 1] - m[i])
    with torch.no_grad():
        model.model.classifier.bias[1] -= float(m[gap] + m[gap + 1]) / 2


def _save_kws(model, path):
    v = _flax_variables(model)
    save_checkpoint(path, {"params": {"kws": v["params"]}, "batch_stats": {"kws": v["batch_stats"]}})
    return path


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Checkpoints, data and the stubs both CLIs read.  The port runs on one
    torch thread: beside the other test workers, more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("cli")
    whisper_ckpt = str(root / "whisper")
    hf_config = transformers.WhisperConfig(
        vocab_size=128, num_mel_bins=8, d_model=32,
        encoder_layers=3, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_source_positions=1500, max_target_positions=40,
        pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=3,
        suppress_tokens=None, begin_suppress_tokens=None,
    )
    # config.json by transformers, random weights under HF's names written
    # directly (transformers' model classes take ~17 s to import here)
    hf_config.save_pretrained(whisper_ckpt)
    params = from_jax_whisper_params(
        init_whisper_params(np.random.default_rng(0), WhisperConfig.from_hf(hf_config.to_dict())),
        device="cpu")
    save_file(hf_whisper_state(params), os.path.join(whisper_ckpt, "model.safetensors"))
    # the same weights under another path: a separate KWS encoder
    encoder_ckpt = str(root / "encoder")
    shutil.copytree(whisper_ckpt, encoder_ckpt)
    acl = str(root / "acl")
    make_acl(acl, kw_layers=KW_LAYERS, whisper_dim=32, n_keywords=6, n_utts=3, ghost=(2,))
    make_acl(acl, kw_layers=KW_LAYERS, whisper_dim=32, n_keywords=6, n_utts=3, split="dev", seed=5)

    mp = pytest.MonkeyPatch()
    mp.setattr(transformers.WhisperTokenizer, "from_pretrained",
               classmethod(lambda cls, p: FakeTokenizer()))
    mp.setattr(transformers.GenerationConfig, "from_pretrained",
               classmethod(lambda cls, p: types.SimpleNamespace(**GC)))
    jax_tiny = jax_resnet.ResNetConfig(**RESNET)
    mp.setattr(jax_cli, "_cbwhisper_kws_resnet", lambda model_args: jax_tiny)
    mp.setattr(port_cli, "_cbwhisper_kws_resnet", lambda model_args: ResNetConfig(**RESNET))
    mp.setattr(port_cli, "_paper1_kws_resnet", lambda model_args: ResNetConfig(**RESNET))
    # the JAX paper-1 runner builds its ResNet-50 config inline
    mp.setattr(jax_resnet, "ResNetConfig", lambda num_channels, num_labels: jax_tiny)

    # a random ResNet (nonzero residual-branch BNs, so int8 tails compute)
    # centred on this data's margins: the CB-Whisper one on the tiny
    # encoder's stacks of the test utterances, the KWS ones on the cached
    # stacks of the split they score
    cfg, params = load_whisper_from_pretrained(whisper_ckpt, device="cpu")
    dataset = ACL6060KeywordDataset(acl, split="test", keywords_per_group=2, kw_type="tts",
                                    load_audio=True)
    real = dataset.catalog.mask[: dataset.catalog.num_keywords] > 0
    datasets = {"test": dataset,
                "dev": ACL6060KeywordDataset(acl, split="dev", keywords_per_group=2, kw_type="tts")}
    ckpts = {}
    for name in ("cb", "test", "dev"):
        model = init_kws_model(ResNetConfig(**RESNET), torch.Generator().manual_seed(1))
        with torch.no_grad():
            for key, module in model.named_modules():
                if key.endswith("layer_2.normalization"):
                    module.weight.fill_(0.2)
        margins = []
        if name == "cb":
            score = make_catalog_score_fn(lambda x: model(x).logits, out_size=OUT)
            catalog = device_put_catalog(dataset.catalog, out_h=OUT[0], chunk=8, device="cpu")
            utt_w = torch.from_numpy(resize_matrix(1500, OUT[1], antialias=False))
            with torch.no_grad():
                for i in range(len(dataset)):
                    features, _ = prepare_features(load_audio_16k(dataset[i]["audio"]), n_mels=8,
                                                   device="cpu")
                    stack = encoder_kws_stack(params, features, cfg, layer_slice=(1, 3))
                    logits = score(catalog, stack[0], utt_w)[1].numpy()[: len(real)][real]
                    margins.extend(logits[:, 1] - logits[:, 0])
        else:
            ds = datasets[name]
            engine = KWSEngine(ResNetConfig(**RESNET), features_size=OUT, device="cpu")
            for i in range(len(ds)):
                logits = engine.score_utterance(model, ds, ds[i]["utt_hs"])[1]
                logits = logits[ds.catalog.mask[: len(logits)] > 0]
                margins.extend(logits[:, 1] - logits[:, 0])
        _centre(model, margins)
        ckpts[name] = _save_kws(model, str(root / f"kws_{name}"))
    yield {"root": root, "whisper": whisper_ckpt, "encoder": encoder_ckpt, "acl": acl, "kws": ckpts}
    mp.undo()
    torch.set_num_threads(threads)


def _cb_config(env, path, **extra):
    init_args = {
        "dataset": "acl", "split": "test", "root": "[ACL_ROOT]", "kw_type": "tts",
        "encoder_ckpt": env["whisper"], "whisper_ckpt": env["whisper"], "kws_ckpt": "[KWS_CKPT]",
        "language": "English", "prompt": True, "oracle": "kws", "num_beams": 5,
        "kws_features_size": list(OUT), "keywords_per_group": 2, "kws_layer_slice": [1, 3],
        "num_bootstraps": 50, **extra,
    }
    config = {"seed_everything": 123,
              "model": {"class_path": "model.cb_whisper.CBWhisper", "init_args": init_args}}
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


def _count_k2_calls(monkeypatch):
    """Calls of the port's K2 wrapper (its plain version here)."""
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda

    calls, real = [], matmul_s8_cuda.matmul_s8_requant
    monkeypatch.setattr(matmul_s8_cuda, "matmul_s8_requant",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def _record_keywords(monkeypatch, cls, sink):
    real = cls._score_to_keywords

    def recorded(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        sink.extend(out)
        return out

    monkeypatch.setattr(cls, "_score_to_keywords", recorded)


# the int8, batched and packed runs decode greedily: the JAX side compiles
# once more per batch shape, and a second beam search would only compile
# the same program again
CB_MODES = {
    "fp32": ({}, []),
    "int8": ({"kws_int8": True, "kws_int8_calibration_batches": 2, "num_beams": 1}, []),
    "batch2": ({"num_beams": 1}, ["--model.init_args.eval_batch_size", "2"]),
    "packed2": ({"num_beams": 1}, ["--model.init_args.eval_packed", "true",
                                   "--model.init_args.eval_batch_size", "2"]),
    # the serving levers (ROADMAP §1 item 4), each alone
    "bf16": ({"num_beams": 1}, ["--model.init_args.compute_dtype", "bfloat16"]),
    "vocab_int8": ({"num_beams": 1}, ["--model.init_args.vocab_int8", "true"]),
    "decoder_int8": ({"num_beams": 1}, ["--model.init_args.decoder_int8", "true"]),
    "kv_cache_int8": ({"num_beams": 1}, ["--model.init_args.kv_cache_int8", "true"]),
    # staged writes into the int8 cache: the window's tokens unquantized
    # until a flush, as in the JAX package
    "kv_staging_int8": ({"num_beams": 1}, ["--model.init_args.kv_cache_int8", "true",
                                           "--model.init_args.kv_staging", "4"]),
    "cross_kv_int8": ({"num_beams": 1}, ["--model.init_args.cross_kv_int8", "true"]),
    # the s8 KWS encoder needs a separate encoder checkpoint
    "encoder_int8": ({"num_beams": 1, "kws_int8_calibration_batches": 2, "encoder_ckpt": "[ENCODER]"},
                     ["--model.init_args.encoder_int8", "true"]),
}


@pytest.mark.parametrize("mode", list(CB_MODES))
def test_cbwhisper_cli_matches_jax(env, tmp_path, monkeypatch, mode):
    extra, overrides = CB_MODES[mode]
    cfg = _cb_config(env, tmp_path / "cb.yaml", **extra)
    argv = ["test", "--config", cfg, "--set", f"ACL_ROOT={env['acl']}", "--set", f"ENCODER={env['encoder']}",
            "--set", f"KWS_CKPT={env['kws']['cb']}", "--model.init_args.num_bootstraps", "40", *overrides]
    if mode == "int8":
        monkeypatch.setenv("ECW_S8_PALLAS", ALL_STAGES)
    jax_preds, jax_kw, port_preds, port_kw = [], [], [], []
    real_run_test = JaxCBWhisper.run_test
    monkeypatch.setattr(JaxCBWhisper, "run_test",
                        lambda self, *a, **kw: real_run_test(self, *a, **{**kw, "predictions_out": jax_preds}))
    _record_keywords(monkeypatch, JaxCBWhisper, jax_kw)
    _record_keywords(monkeypatch, CBWhisper, port_kw)

    want = jax_cli.run_cli(list(argv))
    monkeypatch.delenv("ECW_S8_PALLAS", raising=False)  # the port reads no environment
    FakeTokenizer.handed.clear()
    k2_calls = _count_k2_calls(monkeypatch)
    got = port_cli.run_cli(list(argv), device="cpu", predictions_out=port_preds)
    assert bool(k2_calls) == (mode == "int8")  # kws_int8 alone reached K2's wrapper

    assert FakeTokenizer.handed == ["ints"] * 3  # plain lists of Python ints
    assert len(port_preds) == 3 and port_preds == jax_preds
    assert port_kw == jax_kw[: len(port_kw)]
    if mode not in ("batch2", "packed2"):
        assert len(port_kw) == 3  # one segment per utterance
    else:  # one list per row of each window of the seek loop, vacant slots too
        assert len(port_kw) == len(jax_kw) > 3
    spotted = {len(k) for k in port_kw}
    assert max(spotted) > 0 and min(spotted) < 4  # keywords spotted, not all of them
    for key in ("Entity Recall", "Entity Recall LB", "Entity Recall UB"):
        assert got[key] == want[key], key
    assert 0.0 <= got["Entity Recall"] <= 1.0


def _kws_config(env, path, split="test", **extra):
    config = {
        "seed_everything": 123,
        "ckpt_path": env["kws"][split],
        "trainer": {"default_root_dir": str(env["root"] / "runs")},
        "model": {"class_path": "model.model.KWSModel",
                  "init_args": {"num_channels": KW_LAYERS, "kw_type": "tts", **extra}},
        "data": {"init_args": {
            "batch_size": 4, "sampling": "random", "hotwords_per_group": 2,
            "features_size": list(OUT), "test_split": "test",
            "val_info": [{"name": "acl", "root": env["acl"], "kw_type": "tts"}],
            "test_info": {"name": "acl", "root": env["acl"], "kw_type": "tts"},
        }},
    }
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


@pytest.mark.parametrize("subcommand, mode", [("test", "fp32"), ("test", "int8"), ("validate", "fp32")])
def test_kws_cli_matches_jax(env, tmp_path, monkeypatch, subcommand, mode):
    extra = {"kws_int8": True, "kws_int8_calibration_batches": 2} if mode == "int8" else {}
    if mode == "int8":
        monkeypatch.setenv("ECW_S8_PALLAS", ALL_STAGES)
    split = "dev" if subcommand == "validate" else "test"
    argv = [subcommand, "--config", _kws_config(env, tmp_path / "kws.yaml", split, **extra)]
    want = jax_cli.run_cli(list(argv))
    monkeypatch.delenv("ECW_S8_PALLAS", raising=False)
    k2_calls = _count_k2_calls(monkeypatch)
    got = port_cli.run_cli(list(argv), device="cpu")
    assert bool(k2_calls) == (mode == "int8")
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if "loss" in key:
            np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)
        else:
            assert got[key] == value, key
    f1 = got["F1"] if subcommand == "test" else got["metrics/f1"]
    assert 0 < f1 < 1


def test_unfilled_placeholder_exits_as_jax(env, tmp_path):
    cfg = _cb_config(env, tmp_path / "cb.yaml")
    argv = ["test", "--config", cfg, "--set", f"ACL_ROOT={env['acl']}"]
    with pytest.raises(SystemExit) as want:
        jax_cli.run_cli(list(argv))
    with pytest.raises(SystemExit) as got:
        port_cli.run_cli(list(argv), device="cpu")
    assert str(got.value) == str(want.value) and "KWS_CKPT" in str(got.value)


@pytest.mark.parametrize("override, item, error", [
    # staging with an int8 cache runs (CB_MODES "kv_staging_int8"), but not
    # with a window as long as the decode, as in the JAX package
    (["--model.init_args.kv_staging", "4096", "--model.init_args.kv_cache_int8", "true"], "item 4",
     (ValueError, "staging_window must be in")),
    # paper 2 trains (tests/test_torch_efficient_fit.py), but not from a
    # config that names no training dataset
    (["--model.class_path", "efficient_kws.model.KWSModel"], "item 6", (ValueError, "train_info")),
], ids=["override0-item 4", "override1-item 6"])
def test_unported_knobs_raise(env, tmp_path, override, item, error):
    subcommand = "fit" if "efficient_kws.model.KWSModel" in override else "test"
    argv = [subcommand, "--config", _cb_config(env, tmp_path / "cb.yaml"), "--set",
            f"ACL_ROOT={env['acl']}", "--set", f"KWS_CKPT={env['kws']['cb']}", *override]
    with pytest.raises(error[0], match=error[1]):
        port_cli.run_cli(argv, device="cpu")


def test_kws_fit_raises(env, tmp_path):
    """``fit`` runs (``tests/test_torch_fit.py``), but not without a
    training dataset."""
    with pytest.raises(ValueError, match="train_info"):
        port_cli.run_cli(["fit", "--config", _kws_config(env, tmp_path / "kws.yaml")], device="cpu")


def test_kv_staging_is_accepted(env, tmp_path, monkeypatch):
    reached = []
    monkeypatch.setattr(CBWhisper, "run_test", lambda self, *a, **kw: reached.append(kw) or {"ok": 1})
    argv = ["test", "--config", _cb_config(env, tmp_path / "cb.yaml", kv_staging=8), "--set",
            f"ACL_ROOT={env['acl']}", "--set", f"KWS_CKPT={env['kws']['cb']}"]
    assert port_cli.run_cli(argv, device="cpu") == {"ok": 1} and reached


def test_language_table_matches_transformers():
    from transformers.models.whisper.tokenization_whisper import TO_LANGUAGE_CODE as HF

    assert TO_LANGUAGE_CODE == HF


@pytest.mark.parametrize("language, gc_extra", [
    ("English", {}),
    (None, {"lang_to_id": {"<|en|>": 10, "<|de|>": 14, "<|fr|>": 12}}),
    ("english", {"max_initial_timestamp_index": 0}),
])
def test_generation_options_match_jax(language, gc_extra):
    gc = types.SimpleNamespace(**{**GC, **gc_extra})
    args = {"language": language, "num_beams": 3}
    want = jax_cli._build_generation_options(FakeTokenizer(), gc, args)
    got = port_cli._build_generation_options(FakeTokenizer(), gc, args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_language_null_needs_lang_to_id():
    gc = types.SimpleNamespace(**GC)
    for cli in (jax_cli, port_cli):
        with pytest.raises(AssertionError, match="lang_to_id"):
            cli._build_generation_options(FakeTokenizer(), gc, {"language": None})


@pytest.mark.parametrize("module", ["ops.mel_cuda", "ops.matmul_s8_cuda", "ops.maxsim_cuda",
                                    "ops.beam_attention", "audio.io"],
                         ids=["mel_cuda", "matmul_s8_cuda", "maxsim_cuda", "beam_attention", "resampler"])
def test_kernel_loader_and_launch_count_are_thread_safe(monkeypatch, module):
    """Each native library of the port (K1-K4 and the host resampler), with
    a stub in place of its build: many threads asking for the library at
    once build it once and share it; a build that fails raises in the
    thread that hit it and the next caller builds again; launch counts from
    many threads add up exactly."""
    import importlib
    import sys
    import threading
    import time

    mod = importlib.import_module(f"enhance_cb_whisper_tpu_torch.{module}")
    lib = mod.resampler if module == "audio.io" else mod.kernel
    builds = []

    def stub_load():
        builds.append(threading.get_ident())
        time.sleep(0.05)  # a slow build: the other threads arrive meanwhile
        if len(builds) == 1:
            raise RuntimeError("nvcc failed")
        return lambda *args: 0

    monkeypatch.setattr(lib, "_entry", None)
    monkeypatch.setattr(lib, "_call", lib._load_and_call)
    monkeypatch.setattr(lib, "_load", stub_load)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lib.entry()
    barrier = threading.Barrier(8)
    libs = []

    def ask():
        barrier.wait()
        libs.append(lib.entry())

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(builds) == 2 and len(libs) == 8 and all(one is libs[0] for one in libs)

    # CPython switches threads only at calls and loop ends, so an unlocked
    # count seldom loses one here; the total is held exact all the same

    monkeypatch.setattr(lib, "launches", 0)
    # the CPU build of torch has no CUDA stream to fetch: stand-ins for card 0
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda idx: None, raising=False)
    card = torch.device("cuda", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        def count():
            barrier.wait()
            for _ in range(5000):
                lib.launch(card)

        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert lib.launches == 8 * 5000
