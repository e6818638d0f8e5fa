"""The scale-out dry run: the data × model mesh through every sharded path
(port of enhance_cb_whisper_tpu/parallel/dryrun.py).

Run as ``python -m enhance_cb_whisper_tpu_torch.parallel.dryrun N
[--device cpu|cuda]``: it spawns N ranks (:func:`.mesh.launch`; NCCL when
each rank has a GPU of its own, gloo otherwise, on the CPU too), lays them
out as ``data = N / 2`` × ``model = 2`` (``model = 1`` for odd N) and runs
the JAX dry run's stages in its order, each checked as JAX's is:

  1. the full adversarial paper-1 train step (entropy, two accumulated
     minibatches) with the batch over ``data`` — equal to one rank's step;
  2. keyword-catalog scoring with the rows over ``model`` — equal to the
     unsharded scorer; 2b. paper 2's cascade over a model-sharded projected
     catalog — equal to the unsharded cascade, its planted match kept;
  3. the tensor-parallel Whisper encoder — equal to the unsharded one;
  4. the flagship: batched longform CB-Whisper decode (spotting → prompt →
     beam search → seek) with utterances over ``data`` and the catalog over
     ``model`` — token-identical to one rank's decode;
  5. the same decode with the Whisper params tensor-parallel (``model > 1``);
  6. the packed (continuous-batching) decode, each ``data`` group over its
     share of a corpus of mixed lengths;
  7. the packed decode with the int8 self- and cross-attention K/V, staged
     cache writes and per-row language detection, greedy.

Every stage function takes the mesh and its inputs (weights as numpy
trees in the JAX package's layouts, mels, batches), so a test can hand it
the JAX package's and hold the result to JAX's single-device run.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..catalog.database import KeywordCatalog, device_put_catalog, make_catalog_score_fn
from ..convert import from_flax_resnet_variables, from_jax_whisper_params, to_flax_variables
from ..decoding.generate import GenerationOptions
from ..models.cb_whisper import CBWhisper, CBWhisperConfig
from ..models.kws import KWSModel, init_kws_model
from ..models.resnet import ResNetConfig
from ..models.whisper import WhisperConfig, encoder_forward, init_whisper_params
from ..ops.resize import resize_matrix
from ..train import kws_train as kt
from .mesh import dim_rank, dim_size, gather_objects, launch, make_mesh, rank_device, replicate, shard_batch
from .sharding import make_sharded_train_step, shard_catalog, whisper_param_sharding

# the JAX dry run's tiny models
FLAGSHIP_WHISPER = dict(
    vocab_size=64, num_mel_bins=8, d_model=32,
    encoder_layers=2, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64,
    max_source_positions=16, max_target_positions=24,
    decoder_start_token_id=3, eos_token_id=2, pad_token_id=0,
)
FLAGSHIP_RESNET = dict(num_channels=2, embedding_size=8, hidden_sizes=(8, 16, 24, 32),
                       depths=(1, 1, 1, 1), num_labels=2)
TRAIN_RESNET = dict(FLAGSHIP_RESNET, num_channels=3)


# --------------------------------------------------------------------------
# inputs


def flagship_inputs(seed: int = 0, n_data: int = 2, n_model: int = 1,
                    kws_state: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, Any]:
    """The flagship stage's inputs, drawn from ``np.random.default_rng(seed)``
    in the JAX stage's order (Whisper params in the JAX layout, ``8 ×
    n_model`` keyword stacks, a batch of ``max(2, n_data)`` longform mels,
    a corpus of twice as many mels of mixed lengths): one seed gives both
    packages the same values.  ``kws_state`` (the ResNet's
    ``state_dict`` as numpy) defaults to :func:`..models.kws.init_kws_model`
    from ``seed + 1``; the JAX stage draws its own with flax."""
    cfg = WhisperConfig(**FLAGSHIP_WHISPER)
    nprng = np.random.default_rng(seed)
    wparams = init_whisper_params(nprng, cfg)
    n_kw = 8 * max(n_model, 1)
    stacks = [nprng.standard_normal((2, int(nprng.integers(2, 6)), 32)).astype(np.float32)
              for _ in range(n_kw)]
    stacks = [s / np.linalg.norm(s, axis=-1, keepdims=True) for s in stacks]
    batch = max(2, n_data)
    total = cfg.max_source_positions * 2 * 2 + 20
    mels = nprng.standard_normal((batch, 8, total), dtype=np.float32)
    mels_list = [nprng.standard_normal((1, 8, total + (i % 4) * 17 - 25), np.float32)
                 for i in range(2 * batch)]
    if kws_state is None:
        model = init_kws_model(ResNetConfig(**FLAGSHIP_RESNET), torch.Generator().manual_seed(seed + 1))
        kws_state = {k: v.numpy() for k, v in model.state_dict().items()}
    return {"whisper": wparams, "stacks": stacks, "mels": mels, "mels_list": mels_list,
            "kws": kws_state, "batch": batch}


def flagship_options(num_beams: int = 5, lang_detect: bool = False) -> GenerationOptions:
    return GenerationOptions(
        decoder_start_token_id=3, language_token_id=None, task_token_id=None,
        lang_token_ids=(40, 41, 42) if lang_detect else (),
        no_timestamps_token_id=50, prev_sot_token_id=49,
        eos_token_id=2, pad_token_id=0,
        suppress_tokens=(), begin_suppress_tokens=(),
        max_initial_timestamp_index=8, num_beams=num_beams,
        return_timestamps=True, condition_on_prev_tokens=True,
        max_target_positions=24,
    )


def flagship_prompt_ids(text: str) -> List[int]:
    return [49] + [20 + (ord(c) % 28) for c in text][:6]


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else rank_device()


def _kws_model(state: Dict[str, np.ndarray], resnet: Dict[str, Any]) -> KWSModel:
    return KWSModel(ResNetConfig(**resnet)).load_converted(
        {k: torch.as_tensor(v) for k, v in state.items()})


def build_flagship(inputs: Dict[str, Any], device=None, kv_int8: bool = False, xkv_int8: bool = False,
                   kv_staging: int = 0, num_beams: int = 5, lang_detect: bool = False) -> CBWhisper:
    """The flagship CB-Whisper of :func:`flagship_inputs` on ``device``."""
    device = _device(device)
    stacks = inputs["stacks"]
    return CBWhisper(
        config=CBWhisperConfig(kws_features_size=(32, 48), keywords_per_group=8),
        whisper_config=WhisperConfig(**FLAGSHIP_WHISPER),
        whisper_params=from_jax_whisper_params(inputs["whisper"], device=device),
        kws_model=_kws_model(inputs["kws"], FLAGSHIP_RESNET),
        catalog=KeywordCatalog.from_arrays([f"kw{i}" for i in range(len(stacks))], stacks, group_size=8),
        generation_options=flagship_options(num_beams, lang_detect),
        prompt_ids_fn=flagship_prompt_ids,
        decode_fn=lambda toks: " ".join(map(str, toks)),
        kws_layer_slice=(0, 2), device=device,
        kv_cache_int8=kv_int8, cross_kv_int8=xkv_int8, kv_staging=kv_staging,
    )


def _plain_rows(result) -> Dict[str, list]:
    """A decode's ``{"sequences", "segments"}`` as plain lists per row: the
    sequences as the decode pads them, each segment as (start, end,
    tokens)."""
    segs = [[(float(s["start"]), float(s["end"]), [int(t) for t in s["tokens"]]) for s in row]
            for row in result["segments"]]
    seqs = [np.asarray(s).tolist() for s in result["sequences"]]
    return {"sequences": seqs, "segments": segs}


def _run_flagship(cb: CBWhisper, mels: np.ndarray, mels_list, packed: bool, slots: int):
    opts = cb.opts
    if packed:
        out = dict(cb.generator.generate_packed(
            ((torch.from_numpy(m), None) for m in mels_list), opts, slots=slots,
            keyword_spotting=cb.keyword_spotting, encode_spot=cb._encode_spot_hook(),
            return_segments=True))
        return _plain_rows({"sequences": [out[i]["sequences"] for i in range(len(mels_list))],
                            "segments": [out[i]["segments"] for i in range(len(mels_list))]})
    result = cb.generator.generate(
        torch.from_numpy(mels).to(cb.device), opts, keyword_spotting=cb.keyword_spotting,
        return_segments=True, encode_spot=cb._encode_spot_hook())
    return _plain_rows(result)


def _repad(rows: List[list], pad: int) -> List[list]:
    """Rows unpadded by their own decodes, right-padded to the longest."""
    def own(row):
        return row[: max((i + 1 for i, t in enumerate(row) if t != pad), default=0)]

    rows = [own(r) for r in rows]
    width = max(len(r) for r in rows)
    return [r + [pad] * (width - len(r)) for r in rows]


def flagship_longform_stage(mesh, inputs: Dict[str, Any], num_beams: int = 5, tp: bool = False,
                            packed: bool = False, kv_int8: bool = False, xkv_int8: bool = False,
                            lang_detect: bool = False, kv_staging: int = 0, reference: bool = True,
                            device=None):
    """The mesh-parallel longform CB-Whisper decode (the JAX stage, with
    its options).  Returns ``(ref, got)``: one rank's decode of the whole
    batch (``None`` without ``reference``) and the mesh's, each
    ``{"sequences", "segments"}`` with one list per utterance in batch or
    corpus order, identical on every rank.

    On the mesh, utterance rows go over the ``data`` groups in contiguous
    blocks; the catalog's rows go over ``model`` and, with ``tp``, the
    Whisper params too, so the ranks of one ``model`` group decode the same
    rows in lockstep.  ``packed``: each ``data`` group streams its block of
    the corpus through ``batch / data`` slots.  Tensor parallelism takes
    float K/V caches only (an int8 cache's per-token scale spans every
    head)."""
    if tp and (kv_int8 or xkv_int8):
        raise ValueError("tensor parallelism takes float K/V caches: an int8 K/V scale spans all heads")
    device = _device(device)
    kwargs = dict(kv_int8=kv_int8, xkv_int8=xkv_int8, kv_staging=kv_staging, num_beams=num_beams,
                  lang_detect=lang_detect)
    batch = int(inputs["batch"])
    mels, mels_list = inputs["mels"], inputs["mels_list"]
    ref = _run_flagship(build_flagship(inputs, device, **kwargs), mels, mels_list, packed, batch) \
        if reference else None

    cb = build_flagship(inputs, device, **kwargs)
    cb._ensure_catalog()
    cb._catalog_dev = shard_catalog(cb._catalog_dev, mesh, axis="model")
    if tp:
        gen = cb.generator
        gen.params = whisper_param_sharding(gen.params, mesh, cb.whisper_config)
        if cb.encode_fused:
            cb.encoder_params = gen.params
    n_data, r_data = dim_size(mesh, "data"), dim_rank(mesh, "data")
    if packed:
        assert len(mels_list) % n_data == 0 and batch % n_data == 0
        share = len(mels_list) // n_data
        local = _run_flagship(cb, None, mels_list[r_data * share:(r_data + 1) * share], True,
                              batch // n_data)
    else:
        local = _run_flagship(cb, shard_batch(mels, mesh, "data"), None, False, 0)
    parts = gather_objects(local, mesh.get_group("data")) if n_data > 1 else [local]
    got = {key: [row for part in parts for row in part[key]] for key in ("sequences", "segments")}
    pad = cb.opts.pad_token_id
    if not packed:
        got["sequences"] = _repad(got["sequences"], pad)
        if ref is not None:
            ref["sequences"] = _repad(ref["sequences"], pad)
    return ref, got


# --------------------------------------------------------------------------
# training


class ArrayNoise:
    """A train step's noise source serving given draws (numpy): the
    ``kw_type='all'`` coin, the large heads' dropout masks (two per
    minibatch) and DANNCE's masks per minibatch, each drawn for the global
    batch."""

    def __init__(self, coin=None, keep=(), adversarial=(), device="cpu"):
        self._coin, self._keep, self._adv = coin, list(keep), list(adversarial)
        self.device = torch.device(device)

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=bool)).to(self.device)

    def coin(self, n, p):
        assert self._coin.shape == (n,)
        return self._t(self._coin)

    def dropout_keep(self, minibatch, n, width):
        a, b = self._keep[2 * minibatch], self._keep[2 * minibatch + 1]
        assert a.shape == b.shape == (n, width)
        return self._t(a), self._t(b)

    def adversarial_mask(self, minibatch, n, p):
        assert self._adv[minibatch].shape == (n,)
        return self._t(self._adv[minibatch])


def _train_state(config: kt.KWSTrainConfig, resnet: Dict[str, Any], variables, device, seed: int):
    state = kt.init_train_state(config, ResNetConfig(**resnet), seed=seed, device=device)
    if variables is not None:
        state.kws.load_converted({k: v.to(device) for k, v in from_flax_resnet_variables(
            {"params": variables["params"]["kws"], "batch_stats": variables["batch_stats"]["kws"]}).items()})
        if state.disc is not None:
            state.disc.load_state_dict(from_flax_resnet_variables({"params": variables["params"]["disc"]}))
    return state


def _train_result(state, metrics) -> Dict[str, Any]:
    kws = to_flax_variables(state.kws.state_dict())
    params = {"kws": kws["params"]}
    if state.disc is not None:
        params["disc"] = to_flax_variables(state.disc.state_dict())["params"]
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": params,
            "batch_stats": {"kws": kws["batch_stats"]}}


def dp_train_stage(mesh, config: kt.KWSTrainConfig, batch: Dict[str, np.ndarray], resnet=TRAIN_RESNET,
                   variables=None, noise=None, beta: float = 0.1, suppression: float = 0.5,
                   seed: int = 0, reference: bool = True, device=None):
    """One paper-1 train step with the batch over ``data``
    (:func:`.sharding.make_sharded_train_step`), from ``variables`` (the
    flax layout ``{"params": {"kws", "disc"?}, "batch_stats": {"kws"}}``) or
    the port's init from ``seed``, with ``noise`` (an :class:`ArrayNoise`)
    or ``StepNoise(seed)``.  Returns ``(ref, got)``: one rank's step over
    the whole batch (``None`` without ``reference``) and the mesh's, each
    the metrics and the parameters and statistics after the step (flax
    layout, numpy)."""
    device = _device(device)
    tensors = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}

    def draws():
        if noise is None:
            return kt.StepNoise(seed, device=device)
        noise.device = device
        return noise

    ref = None
    if reference:
        state = _train_state(config, resnet, variables, device, seed)
        metrics = kt.make_train_step(config, state)(tensors, draws(), beta, suppression)
        ref = _train_result(state, metrics)
    state = _train_state(config, resnet, variables, device, seed)
    replicate([*state.kws.state_dict().values(),
               *(state.disc.state_dict().values() if state.disc is not None else ())], mesh)
    metrics = make_sharded_train_step(config, state, mesh)(tensors, draws(), beta, suppression)
    return ref, _train_result(state, metrics)


# --------------------------------------------------------------------------
# catalog scoring


def catalog_stage(mesh, kws_state: Dict[str, np.ndarray], stacks, utt: np.ndarray, resnet=TRAIN_RESNET,
                  out_size=(32, 48), chunk: int = 8, device=None):
    """Catalog scoring with the rows over ``model``: returns ``(ref, got)``
    ``(probs [N_pad], logits [N_pad, 2])`` of one rank's scorer and the
    sharded one (``utt`` [L, T_u, D] L2-normalised)."""
    device = _device(device)
    model = _kws_model(kws_state, resnet).to(device).eval()
    score = make_catalog_score_fn(lambda x: model(x).logits, out_size=out_size)
    catalog = KeywordCatalog.from_arrays([f"k{i}" for i in range(len(stacks))], stacks, group_size=8)
    cat_dev = device_put_catalog(catalog, out_h=out_size[0], chunk=chunk, device=device)
    utt_t = torch.from_numpy(utt).to(device)
    w = torch.from_numpy(resize_matrix(utt.shape[1], out_size[1], antialias=False)).to(device)
    with torch.no_grad():
        ref = score(cat_dev, utt_t, w)
        got = score(shard_catalog(cat_dev, mesh), utt_t, w)
    return ref, got


def int8_spotting_stage(mesh, inputs: Dict[str, Any], s8_1x1=(), device=None):
    """int8 keyword spotting (:meth:`..models.cb_whisper.CBWhisper.
    enable_int8_spotting`, calibrated on the first segment) with the catalog
    over ``model``: returns ``(ref, got)``, each ``{"act_scales",
    "keywords"}`` of the first window of every flagship mel."""
    device = _device(device)

    def run(sharded: bool):
        cb = build_flagship(inputs, device)
        cb._ensure_catalog()
        if sharded:
            cb._catalog_dev = shard_catalog(cb._catalog_dev, mesh)
        cb.enable_int8_spotting(calibration_batches=1, s8_1x1=s8_1x1)
        seg = cb.generator._pad_segment(torch.from_numpy(inputs["mels"][:, :, : cb.generator.n_segment_frames]))
        keywords = cb.spot_keywords(seg)
        return {"act_scales": cb.kws_act_scales, "keywords": keywords}

    return run(False), run(True)


def cascade_stage(mesh, model_state: Dict[str, np.ndarray], config, groups, utt, utt_mask,
                  chunk: int = 4, shortlist: int = 8, device=None):
    """Paper 2's cascade over a projected catalog with its rows over
    ``model``: returns ``(ref, got)`` probabilities [N_pad]."""
    from ..efficient_kws.catalog import make_cascade_score_fn, project_catalog
    from ..efficient_kws.model import EfficientKWSModel

    device = _device(device)
    model = EfficientKWSModel(config).load_converted(
        {k: torch.as_tensor(v) for k, v in model_state.items()}).to(device).eval()
    cat = project_catalog(model, groups, chunk=chunk)
    casc = make_cascade_score_fn(model, chunk=chunk, shortlist=shortlist)
    ref = casc(cat, utt, utt_mask)
    got = casc(shard_catalog(cat, mesh), utt, utt_mask)
    return ref, got


def tp_encoder_stage(mesh, whisper_params, config_kwargs: Dict[str, Any], mel: np.ndarray, device=None):
    """The Whisper encoder with its params tensor-parallel over ``model``:
    returns ``(ref, got)`` last hidden states [B, T_enc, D]."""
    device = _device(device)
    cfg = WhisperConfig(**config_kwargs)
    params = from_jax_whisper_params(whisper_params, device=device)
    mel_t = torch.from_numpy(mel).to(device)
    with torch.no_grad():
        ref = encoder_forward(params, mel_t, cfg)[0]
        got = encoder_forward(whisper_param_sharding(params, mesh, cfg), mel_t, cfg)[0]
    return ref, got


# --------------------------------------------------------------------------
# the command


def _close(a, b, rtol, atol, what):
    a, b = np.asarray(torch.as_tensor(a).cpu()), np.asarray(torch.as_tensor(b).cpu())
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _main_rank(n: int) -> List[str]:
    from ..efficient_kws.model import EfficientKWSConfig, EfficientKWSModel

    lines = []
    model_axis = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh({"data": n // model_axis, "model": model_axis})
    lines.append(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
    nprng = np.random.default_rng(0)

    # 1. the full adversarial train step, batch over `data`
    config = kt.KWSTrainConfig(adversarial_training=True, entropy=True, num_domains=4,
                               accumulate_grad_batches=2)
    batch_size = max(8, 2 * n)
    batch = {"features": nprng.standard_normal((batch_size, 3, 32, 32), dtype=np.float32),
             "labels": nprng.integers(0, 2, batch_size), "domain": nprng.integers(0, 4, batch_size)}
    ref, got = dp_train_stage(mesh, config, batch)
    for k in ref["metrics"]:
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5, err_msg=k)
    _close(got["params"]["kws"]["model"]["classifier"]["kernel"],
           ref["params"]["kws"]["model"]["classifier"]["kernel"], 1e-4, 1e-6, "classifier kernel")
    lines.append(f"dp train step ok: {got['metrics']}")

    # 2. catalog scoring, rows over `model`
    stacks = [nprng.standard_normal((3, int(nprng.integers(2, 6)), 16)).astype(np.float32)
              for _ in range(8 * model_axis)]
    kws = init_kws_model(ResNetConfig(**TRAIN_RESNET), torch.Generator().manual_seed(1))
    utt = nprng.standard_normal((3, 20, 16)).astype(np.float32)
    (p_ref, _), (p_got, _) = catalog_stage(mesh, {k: v.numpy() for k, v in kws.state_dict().items()}, stacks, utt)
    _close(p_got, p_ref, 1e-4, 1e-6, "sharded catalog probabilities")
    lines.append(f"sharded catalog scoring ok: {tuple(p_got.shape)}")

    # 2b. the paper-2 cascade over a model-sharded projected catalog
    ecfg = EfficientKWSConfig(n_layers=2, embedding_dim=16, learn_features=True, proj_mlp=True,
                              proj_mlp_units=8, resnet_version="resnet-18")
    groups = [{"kwd": nprng.standard_normal((4, 2, 16, 16), dtype=np.float32),
               "kwd_mask": np.ones((4, 2, 16), np.float32), "mask": np.ones((4,), np.float32)}
              for _ in range(2 * model_axis)]
    eutt = nprng.standard_normal((1, 2, 32, 16), dtype=np.float32)
    eutt[0, :, 8:24, :] = groups[1]["kwd"][1]  # planted match (row 5)
    torch.manual_seed(2)
    emodel = EfficientKWSModel(ecfg)
    c_ref, c_got = cascade_stage(mesh, {k: v.numpy() for k, v in emodel.state_dict().items()}, ecfg, groups,
                                 eutt, np.ones((1, 2, 32), np.float32))
    assert 5 in torch.nonzero(c_got.cpu()).ravel().tolist(), "sharded cascade missed the planted match"
    _close(c_got, c_ref, 1e-4, 1e-6, "sharded cascade")
    lines.append(f"sharded cascade scoring ok: {int(torch.count_nonzero(c_got))} shortlisted")

    # 3. the tensor-parallel Whisper encoder
    wcfg = dict(FLAGSHIP_WHISPER, encoder_attention_heads=2, decoder_attention_heads=2,
                max_target_positions=16)
    wparams = init_whisper_params(nprng, WhisperConfig(**wcfg))
    mel = nprng.standard_normal((max(2, dim_size(mesh, "data")), 8, 32)).astype(np.float32)
    e_ref, e_got = tp_encoder_stage(mesh, wparams, wcfg, mel)
    _close(e_got, e_ref, 2e-4, 2e-5, "tp encoder")
    lines.append(f"tp encoder ok: {tuple(e_got.shape)}")

    # 4-7. the flagship decode on the mesh
    inputs = flagship_inputs(0, dim_size(mesh, "data"), model_axis)
    stages = [("mesh longform decode", {})]
    if model_axis > 1:
        stages.append(("tp longform decode", {"tp": True}))
    stages += [("packed mesh serving decode", {"packed": True}),
               ("packed int8-kv + language-detect mesh decode",
                {"packed": True, "kv_int8": True, "xkv_int8": True, "lang_detect": True, "num_beams": 1,
                 "kv_staging": 4})]
    for name, kwargs in stages:
        ref, got = flagship_longform_stage(mesh, inputs, **kwargs)
        assert got["sequences"] == ref["sequences"], f"{name} diverged:\nref: {ref['sequences']}\ngot: {got['sequences']}"
        assert got["segments"] == ref["segments"], f"{name}: segments diverged"
        lines.append(f"{name} ok: {[len(s) for s in got['segments']]} segments")
    lines.append(f"dryrun({n}) passed")
    return lines


def main(n: int, device: str = "cuda", timeout: float = 900.0) -> None:
    """Run the stages on ``n`` ranks and print rank 0's report."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    from enhance_cb_whisper_tpu_torch.parallel import dryrun  # importable by name in the ranks

    nccl = device == "cuda" and n <= torch.cuda.device_count()
    lines = launch(dryrun._main_rank, n, backend="nccl" if nccl else "gloo", device=device, timeout=timeout,
                   args=(n,))[0]
    for line in lines:
        print(line)


def _parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, nargs="?", default=4, help="number of ranks")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--timeout", type=float, default=900.0, help="seconds before the ranks are killed")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = _parse()
    main(args.n, args.device, args.timeout)
