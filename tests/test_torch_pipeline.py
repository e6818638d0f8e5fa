"""The port's offline dataset pipeline vs the JAX package's, on the CPU.

Both pipelines read the same numpy-seeded WAVs (16 kHz and 44.1 kHz, one
longer than 30 s, a partial last batch) and the same tiny random HF
Whisper checkpoint written with ``transformers``; the port runs with
``device="cpu"``.  Held: the set of caches written and the files skipped
(a sub-hop WAV, a file that is not WAV); f32 caches at the encoder-stack
tolerances of ``test_torch_whisper.py`` (rtol 1e-4, atol 2e-5); f16 caches
within 2e-3 of the f32 ones and of JAX's f16 caches; ``encoder_int8``
caches at per-frame cosine > 0.999 against the f32 caches (JAX's own bound)
and > 0.9999 against JAX's int8 caches (an activation on a rounding edge
may take the neighbouring code, as in ``test_torch_quant_encoder.py``).
The cut WAVs are byte-equal; the TTS loop's files, voices, retries and
voice dump are equal; ``main``'s flags reach each stage; the audio mode's
in-step embedding equals the port's cache of the same audio."""

import os
import wave

import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu import pipeline as jp
from enhance_cb_whisper_tpu_torch import pipeline as tp
from enhance_cb_whisper_tpu_torch.catalog.store import load_hidden_states, save_hidden_states

transformers = pytest.importorskip("transformers")

SLICE = (1, 4)
D_MODEL = 32
RTOL, ATOL = 1e-4, 2e-5
# (code, seconds, rate): a partial last batch at batch_size 3, two rates, a
# file cut at 30 s, a file that starts with the "audio-" prefix
WAVS = (("utt0", 1.0, 16000), ("utt1", 2.5, 44100), ("utt2", 0.7, 16000),
        ("audio-utt3", 31.0, 16000), ("utt4", 4.2, 44100))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_wav(path, data, rate):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(data, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tiny random HF checkpoint (``tests/test_pipeline.py``'s) and an
    audio tree: the WAVs above one or two directories deep, a WAV shorter
    than one hop and a file named ``.mp3`` that is not audio."""
    root = tmp_path_factory.mktemp("pipeline")
    ckpt = root / "ckpt"
    hf_config = transformers.WhisperConfig(
        vocab_size=128, num_mel_bins=80, d_model=D_MODEL,
        encoder_layers=4, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_source_positions=1500, max_target_positions=40,
        pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=3,
        suppress_tokens=None, begin_suppress_tokens=None,
    )
    torch.manual_seed(0)
    transformers.WhisperForConditionalGeneration(hf_config).save_pretrained(str(ckpt))
    audio = root / "audio"
    (audio / "a" / "b").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, (code, seconds, rate) in enumerate(WAVS):
        where = audio / ("a" if i % 2 else "a/b")
        _write_wav(where / f"{code}.wav", rng.standard_normal(int(seconds * rate)) * 0.1, rate)
    _write_wav(audio / "short.wav", rng.standard_normal(100) * 0.1, 16000)
    (audio / "notaudio.mp3").write_bytes(b"ID3 not really an mp3")
    return str(ckpt), str(audio), root


def _both(corpus, name, **kw):
    """Run both pipelines into ``<name>/jax`` and ``<name>/port``; returns
    {side: (caches by code, printed lines)}."""
    ckpt, audio, root = corpus
    out = {}
    for side, run in (("jax", jp.extract_hidden_states), ("port", tp.extract_hidden_states)):
        target = root / name / side
        extra = {"device": "cpu"} if side == "port" else {}
        printed = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("builtins.print", lambda *a, **k: printed.append(" ".join(map(str, a))))
            run(audio, ckpt, str(target), layer_slice=SLICE, batch_size=3, **kw, **extra)
        out[side] = ({f[:-4]: np.load(target / f) for f in sorted(os.listdir(target))}, printed)
    return out


@pytest.fixture(scope="module")
def f32_caches(corpus):
    """f32 caches of both packages, through a code filter with blank lines
    that leaves out utt2."""
    codes = corpus[2] / "codes.txt"
    codes.write_text("utt0\tx\n\nutt1 y\n   \naudio-utt3\nutt3\nutt4\n")
    return _both(corpus, "f32", codes=str(codes))


def test_find_audio_files_matches_jax(corpus):
    audio = corpus[1]
    got = tp.find_audio_files(audio)
    assert got == jp.find_audio_files(audio)
    assert set(got) == {"utt0", "utt1", "utt2", "utt3", "utt4", "short", "notaudio"}
    assert tp.find_audio_files(audio, exts=(".wav",)) == jp.find_audio_files(audio, exts=(".wav",))


def test_f32_caches_match_jax(f32_caches):
    jax_caches, jax_printed = f32_caches["jax"]
    port, printed = f32_caches["port"]
    # blank lines dropped (utt2 is filtered out), "audio-" prefix stripped
    assert sorted(port) == sorted(jax_caches) == ["utt0", "utt1", "utt3", "utt4"]
    assert "ignoring 2 blank lines" in printed[0] and printed[0] == jax_printed[0]
    for code, want in jax_caches.items():
        got = port[code]
        assert got.dtype == np.float32 and got.shape == want.shape, code
        assert got.shape[:1] == (SLICE[1] - SLICE[0],) and got.shape[2] == D_MODEL
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=code)
    # t_len = ceil((samples // 160) / 2) of the 16 kHz samples, 30 s at most
    assert port["utt0"].shape[1] == 50 and port["utt3"].shape[1] == 1500
    assert port["utt1"].shape[1] == int(np.ceil((-(-int(2.5 * 44100) * 160 // 441) // 160) / 2))
    np.testing.assert_allclose(np.linalg.norm(port["utt4"], axis=-1), 1.0, rtol=1e-5)


def test_skipped_files_and_f16_caches(corpus, f32_caches):
    """No code filter (an all-blank codes file): the sub-hop WAV and the
    non-WAV file are skipped with their messages, utt2 is written; f16
    caches halve the files and round within 2e-3."""
    blank = corpus[2] / "blank.txt"
    blank.write_text("\n \n")
    runs = _both(corpus, "f16", cache_dtype="float16", codes=str(blank))
    (jax16, _), (port16, printed) = runs["jax"], runs["port"]
    printed = "\n".join(printed)
    assert sorted(port16) == sorted(jax16) == ["utt0", "utt1", "utt2", "utt3", "utt4"]
    assert "short.wav: audio shorter than one frame, skipped" in printed
    assert "notaudio.mp3: cannot decode" in printed and "PCM WAV only" in printed
    f32 = f32_caches["port"][0]
    for code, got in port16.items():
        assert got.dtype == np.float16, code
        np.testing.assert_allclose(got.astype(np.float32), jax16[code].astype(np.float32),
                                   rtol=0, atol=2e-3, err_msg=code)
        if code in f32:
            np.testing.assert_allclose(got.astype(np.float32), f32[code], rtol=0, atol=2e-3)
    target = corpus[2] / "f16" / "port"
    assert os.path.getsize(target / "utt3.npy") < 0.6 * os.path.getsize(corpus[2] / "f32" / "port" / "utt3.npy")
    assert load_hidden_states(str(target / "utt3.npy")).dtype == np.float32


def test_encoder_int8_caches(corpus, f32_caches):
    runs = _both(corpus, "int8", encoder_int8=True)
    jax8, port8 = runs["jax"][0], runs["port"][0]
    f32 = f32_caches["port"][0]
    assert sorted(port8) == sorted(jax8)
    for code, got in port8.items():
        assert got.shape == jax8[code].shape and got.dtype == np.float32
        # the caches are L2-normalized per frame: the rowwise dot is the cosine
        assert (got * jax8[code]).sum(-1).min() > 0.9999, code
        if code in f32:
            assert (got * f32[code]).sum(-1).min() > 0.999, code


def test_save_hidden_states_matches_jax(tmp_path):
    from enhance_cb_whisper_tpu.catalog.store import save_hidden_states as jax_save

    hs = np.random.default_rng(3).standard_normal((2, 5, 4)).astype(np.float32)
    for dtype in (np.float32, np.float16):
        jax_save(str(tmp_path / f"j{dtype.__name__}.bin"), hs, dtype=dtype)
        save_hidden_states(str(tmp_path / f"t{dtype.__name__}.bin"), hs, dtype=dtype)
        a = (tmp_path / f"j{dtype.__name__}.npy").read_bytes()
        assert (tmp_path / f"t{dtype.__name__}.npy").read_bytes() == a
    assert not list(tmp_path.glob("*.bin"))


def _cut_inputs(root):
    wavs = root / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(5)
    _write_wav(wavs / "doc1.wav", rng.standard_normal(3 * 16000) * 0.3, 16000)
    _write_wav(wavs / "doc2.wav", rng.uniform(-1.2, 1.2, 2 * 22050), 22050)  # clipped
    (root / "segments.xml").write_text(
        "<docs>"
        '<doc code="doc1">'
        '<segment id="1" start="0.1" end="1.25"><current>one</current></segment>'
        '<segment id="2" start="1.5" end="1.5"><current>empty span</current></segment>'
        '<segment id="3" start="2.0" end="2.9"><current> </current></segment>'
        '<segment id="4" start="2.0" end="2.9"><current>four</current></segment>'
        "</doc>"
        '<doc code="doc2"><segment id="7" start="0.333" end="1.777"><current>x</current></segment></doc>'
        "</docs>"
    )
    (root / "aligned.tsv").write_text(
        "hello\tdoc1\t0.25\t0.5\n"
        "unaligned\tdoc1\t0.1\t0.1\n"
        "short row\n"
        + "world\tdoc2\t0.01\t1.99\n" * 9  # 12 lines: two-digit names
    )
    return wavs


def _tree(d):
    return {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}


def test_cut_outputs_are_byte_equal_to_jax(tmp_path):
    wavs = _cut_inputs(tmp_path)
    jp.cut_audios(str(wavs), str(tmp_path / "segments.xml"), str(tmp_path / "cut_jax"))
    tp.main(["--cut_audios", "-a", str(wavs), "-s", str(tmp_path / "segments.xml"),
             "-t", str(tmp_path / "cut_port")])
    want = _tree(tmp_path / "cut_jax")
    assert sorted(want) == ["doc1-seg1.wav", "doc1-seg4.wav", "doc2-seg7.wav"]
    assert _tree(tmp_path / "cut_port") == want

    jp.get_keywords_audios(str(wavs), str(tmp_path / "aligned.tsv"), str(tmp_path / "kw_jax"))
    tp.main(["--cut_audios", "-a", str(wavs), "-k", str(tmp_path / "aligned.tsv"),
             "-t", str(tmp_path / "kw_port")])
    want = _tree(tmp_path / "kw_jax")
    assert sorted(want)[:2] == ["00.wav", "03.wav"] and len(want) == 10
    assert _tree(tmp_path / "kw_port") == want


class _FirstRng:
    def choice(self, seq):
        return seq[0]


def _tts_runs(root, module, keywords, runs):
    """Runs of ``module.keyword_tts`` over one keyword file, each with its
    own (synthesizer failures by keyword, kwargs); returns the calls, the
    printed lines, the mp3 names and the voice dump after each run."""
    d = root / module.__name__.split(".")[0]
    (d / "tts").mkdir(parents=True)
    (d / "tts" / "0.mp3").write_bytes(b"existing")  # index 0 resumed over
    kw_file = d / "keywords.txt"
    kw_file.write_text(keywords)
    voices = [{"ShortName": "vA", "Name": "Voice A"}, {"ShortName": "vB", "Name": "Voice B"}]
    history = []
    for failures, kwargs in runs:
        calls, printed = [], []
        left = dict(failures)

        def synthesize(text, voice_name, out_path):
            if left.get(text, 0):
                left[text] -= 1
                raise ConnectionError(f"flaky network for {text}")
            calls.append((text, voice_name))
            with open(out_path, "wb") as f:
                f.write(b"mp3 " + text.encode())

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("builtins.print", lambda *a, **k: printed.append(" ".join(map(str, a))))
            module.keyword_tts(str(d / "tts"), str(kw_file), "en-US", synthesize=synthesize,
                               list_voices=lambda loc: voices, rng=_FirstRng(), **kwargs)
        dump = (d / "keywords_voice.txt").read_text()
        history.append((calls, printed, _tree(d / "tts"), dump))
    return history


def test_keyword_tts_matches_jax(tmp_path):
    """Resume over an existing mp3, a per-keyword voice, the explicit
    voice, retries, giving up, and a second run that resumes and merges
    the voice dump."""
    keywords = "alpha\nbeta\tvB\ngamma\ndelta\nepsilon\tvA\n" * 2
    runs = [({"beta": 1, "gamma": 5}, {"max_retries": 2}),
            ({"delta": 2}, {"voice": "vB"})]
    got = _tts_runs(tmp_path, tp, keywords, runs)
    want = _tts_runs(tmp_path, jp, keywords, runs)
    assert got == want
    calls, printed, files, dump = got[0]
    assert ("beta", "Voice B") in calls and "gamma: giving up after 2 attempts" in printed
    assert files["0.mp3"] == b"existing" and "1.mp3" in files and "2.mp3" not in files
    assert not [line for line in dump.splitlines() if line.startswith("gamma")]
    assert got[1][3].splitlines()[:3] == ["alpha\tvA", "beta\tvB", "gamma\tvB"]


def test_keyword_tts_without_backend_raises_like_jax(tmp_path):
    (tmp_path / "tts").mkdir()
    (tmp_path / "kw.txt").write_text("alpha\n")
    with pytest.raises(RuntimeError) as want:
        jp.keyword_tts(str(tmp_path / "tts"), str(tmp_path / "kw.txt"), "en-US")
    with pytest.raises(RuntimeError) as got:
        tp.main(["--tts", "-t", str(tmp_path / "tts"), "-k", str(tmp_path / "kw.txt"), "-l", "en-US"])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="nope.*not available"):
        tp.keyword_tts(str(tmp_path / "tts"), str(tmp_path / "kw.txt"), "en-US", voice="nope",
                       synthesize=lambda *a: None, list_voices=lambda loc: [{"ShortName": "vA"}])


def test_main_extract_flags(corpus, f32_caches, monkeypatch):
    """``--extract_hs`` hands -a -w -t -u and the dtype flags to
    :func:`extract_hidden_states`, and ``--device`` defaults to the card."""
    seen = []
    monkeypatch.setattr(tp, "extract_hidden_states", lambda *a, **k: seen.append((a, k)))
    tp.main(["--extract_hs", "-a", "A", "-w", "W", "-t", "T"])
    tp.main(["--extract_hs", "-a", "A", "-w", "W", "-t", "T", "-u", "codes.txt",
             "--cache_dtype", "float16", "--encoder_int8", "--compute_dtype", "bfloat16",
             "--device", "cpu"])
    assert seen[0] == (("A", "W", "T"), dict(codes=None, cache_dtype="float32", encoder_int8=False,
                                             compute_dtype="float32", device="cuda"))
    assert seen[1] == (("A", "W", "T"), dict(codes="codes.txt", cache_dtype="float16", encoder_int8=True,
                                             compute_dtype="bfloat16", device="cpu"))
    with pytest.raises(SystemExit):
        tp.main(["--extract_hs", "--cache_dtype", "bfloat16"])


def test_audio_mode_embedding_equals_the_cache(corpus, f32_caches):
    """``EfficientKWSEngine.embed_utterances`` (the audio mode's in-step
    encoder) gives the cache the pipeline wrote for the same audio, frames
    past the utterance zeroed."""
    from enhance_cb_whisper_tpu_torch.audio.io import load_audio_16k
    from enhance_cb_whisper_tpu_torch.efficient_kws.engine import EfficientKWSEngine
    from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSConfig
    from enhance_cb_whisper_tpu_torch.models.whisper_loader import load_whisper_from_pretrained

    ckpt, audio, _ = corpus
    engine = EfficientKWSEngine(
        EfficientKWSConfig(n_layers=2, embedding_dim=D_MODEL, learn_features=True, proj_mlp=True),
        whisper=load_whisper_from_pretrained(ckpt, device="cpu"), kws_layer_slice=SLICE,
        utt_frames_budget=160, device="cpu",
    )
    files = tp.find_audio_files(audio)
    codes = ("utt0", "utt1")
    padded = np.zeros((len(codes), 480000), np.float32)
    valid = []
    for i, code in enumerate(codes):
        wav = load_audio_16k(files[code])
        padded[i, : wav.shape[0]] = wav
        valid.append(int(np.ceil((wav.shape[0] // 160) / 2)))
    utt, mask = engine.embed_utterances(torch.from_numpy(padded), torch.tensor(valid))
    cached = f32_caches["port"][0]
    for i, code in enumerate(codes):
        n = valid[i]
        assert cached[code].shape[1] == n
        np.testing.assert_allclose(utt[i, :, :n].numpy(), cached[code][-2:], rtol=RTOL, atol=ATOL)
        assert not utt[i, :, n:].any() and int(mask[i].sum()) == 2 * n
