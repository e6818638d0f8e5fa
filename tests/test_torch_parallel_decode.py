"""The port's flagship decode on the mesh, on the CPU (gloo, data=2 × model=2).

One launch of 4 ranks (``tests/torch_parallel_ranks.py:decode_cases``)
decodes the inputs of ``parallel/dryrun.py:flagship_inputs`` (the JAX dry
run's tiny Whisper, 16 keywords, two longform utterances of ~2.3 windows,
a corpus of four of mixed lengths) in four ways:

* ``mesh``: utterances over ``data``, the catalog over ``model``;
* ``tp``: the same with the Whisper params tensor-parallel over ``model``;
* ``packed``: each ``data`` group streams its half of the corpus through
  one slot;
* ``levers``: ``packed`` with the int8 self- and cross-attention K/V, staged
  writes (W = 4), per-row language detection, greedy.

``mesh`` and ``tp`` are held token for token (sequences and segments) to
the JAX package's single-device decode of the same weights and mels;
``packed`` and ``levers`` to the port's single-rank run, whose equality
with JAX ``tests/test_torch_packed.py`` and ``test_torch_kv_staging.py``
hold.  Every rank must return the same tokens.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from enhance_cb_whisper_tpu.catalog import KeywordCatalog as JaxCatalog
from enhance_cb_whisper_tpu.decoding.generate import GenerationOptions as JaxOptions
from enhance_cb_whisper_tpu.models import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.models.cb_whisper import CBWhisper as JaxCBWhisper
from enhance_cb_whisper_tpu.models.cb_whisper import CBWhisperConfig as JaxCBConfig
from enhance_cb_whisper_tpu.models.kws import KWSModel as JaxKWS
from enhance_cb_whisper_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from enhance_cb_whisper_tpu_torch.convert import to_flax_variables
from enhance_cb_whisper_tpu_torch.parallel import dryrun
from enhance_cb_whisper_tpu_torch.parallel.mesh import launch


def _jax_decode(inputs):
    """JAX's single-device decode of the flagship inputs (the JAX dry run's
    reference run, with the port's ResNet weights)."""
    opts = dryrun.flagship_options()
    stacks = inputs["stacks"]
    cb = JaxCBWhisper(
        config=JaxCBConfig(kws_features_size=(32, 48), keywords_per_group=8),
        whisper_config=JaxWhisperConfig(**dryrun.FLAGSHIP_WHISPER),
        whisper_params=inputs["whisper"],
        kws_model=JaxKWS(JaxResNetConfig(**dryrun.FLAGSHIP_RESNET)),
        kws_variables=to_flax_variables({k: torch.from_numpy(v) for k, v in inputs["kws"].items()}),
        catalog=JaxCatalog.from_arrays([f"kw{i}" for i in range(len(stacks))], stacks, group_size=8),
        generation_options=JaxOptions(**{f: getattr(opts, f) for f in opts.__dataclass_fields__}),
        prompt_ids_fn=dryrun.flagship_prompt_ids,
        decode_fn=lambda toks: " ".join(map(str, toks)),
        kws_layer_slice=(0, 2),
    )
    out = cb.generator.generate(inputs["mels"], cb.opts, keyword_spotting=cb.keyword_spotting,
                                return_segments=True, encode_spot=cb._encode_spot_hook())
    plain = dryrun._plain_rows(out)
    plain["sequences"] = dryrun._repad(plain["sequences"], opts.pad_token_id)
    return plain


@pytest.fixture(scope="module")
def results():
    """Each rank's results and JAX's: the ranks run while JAX decodes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    inputs = dryrun.flagship_inputs(0, n_data=2, n_model=2)
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(launch, ranks.decode_cases, 4, backend="gloo", device="cpu", timeout=120,
                                args=(inputs,))
        want = _jax_decode(inputs)
        per_rank = ranks_run.result()
    torch.set_num_threads(threads)
    return per_rank, want


def _rounded(segments):
    return [[(round(s, 6), round(e, 6), toks) for s, e, toks in row] for row in segments]


@pytest.mark.parametrize("case", ["mesh", "tp"])
def test_mesh_longform_matches_jax_single_device(results, case):
    per_rank, want = results
    got = per_rank[0][case]["got"]
    assert any(len(toks) for toks in want["sequences"])
    assert got["sequences"] == want["sequences"]
    assert _rounded(got["segments"]) == _rounded(want["segments"])


@pytest.mark.parametrize("case", ["packed", "levers"])
def test_packed_mesh_matches_one_rank(results, case):
    per_rank, _ = results
    ref, got = per_rank[0][case]["ref"], per_rank[0][case]["got"]
    assert len(got["sequences"]) == 4 and any(len(s) > 0 for s in got["segments"])
    assert got == ref


def test_every_rank_returns_the_same_tokens(results):
    per_rank, _ = results
    for case in ranks.DECODE_CASES:
        for other in per_rank[1:]:
            assert other[case]["got"] == per_rank[0][case]["got"], case
