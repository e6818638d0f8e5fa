"""Offline dataset-build pipeline (port of enhance_cb_whisper_tpu/pipeline.py).

The producer of the hidden-state caches that every dataset of both papers
reads, and the audio-prep utilities:

* :func:`extract_hidden_states`: decode and resample the audio on the host
  (a loader thread, one batch ahead), then per batch one log-mel launch on
  ``device`` (the fused kernel K1 on the card) and the Whisper encoder's
  layer slice, L2-normalized, truncated to ``ceil(unpadded_frames / 2)``
  frames and saved as one ``.npy`` per file;
* :func:`cut_audios`: slice XML-defined segments out of WAVs;
* :func:`get_keywords_audios`: slice keyword spans given by ``aligned.tsv``;
* :func:`keyword_tts`: keyword speech synthesis, through injected
  ``synthesize``/``list_voices`` callables or edge-tts on a networked host.

Run as ``python -m enhance_cb_whisper_tpu_torch.pipeline --extract_hs -a
<AUDIO_DIR> -w <WHISPER_CKPT_DIR> -t <OUT_DIR>`` (see :func:`main`).
"""

from __future__ import annotations

import os
import wave
from glob import glob
from math import ceil
from typing import List, Optional

import numpy as np
import torch

from .audio.io import load_audio_16k, read_wav
from .audio.prefetch import prefetch
from .catalog.store import save_hidden_states
from .ops.mel import HOP_LENGTH, N_SAMPLES, log_mel_spectrogram


def find_audio_files(root: str, exts=(".wav", ".mp3", ".opus")) -> dict:
    """code -> path over 1-3 nesting levels; an ``audio-`` prefix is not
    part of the code."""
    out = {}
    for depth in ("*", "*/*", "*/*/*"):
        for ext in exts:
            for path in glob(os.path.join(root, depth + ext)):
                code = os.path.splitext(os.path.basename(path))[0]
                if code.startswith("audio-"):
                    code = code[len("audio-"):]
                out[code] = path
    return out


def _wanted_codes(codes: Optional[str]) -> Optional[List[str]]:
    """The code filter's entries: the first field of each line.  Blank lines
    are dropped (one would substring-match every file); an all-blank file
    means no filter."""
    if codes is None:
        return None
    with open(codes) as f:
        parsed = [line.split("\t")[0].strip().split(" ")[0].strip() for line in f]
    wanted = [c for c in parsed if c]
    if len(wanted) != len(parsed):
        print(f"ignoring {len(parsed) - len(wanted)} blank lines in {codes}")
    return wanted or None


def _load_padded(chunk):
    """(codes, valid encoder frames, 30 s waveforms) of the files in
    ``chunk`` that decode and hold at least one hop; the others are
    skipped with a message."""
    wavs, valid, keep = [], [], []
    for code, path in chunk:
        try:
            wav = load_audio_16k(path)
        except RuntimeError as e:
            print(f"{path}: {e}")
            continue
        wav = wav[:N_SAMPLES]
        t_len = int(ceil((wav.shape[0] // HOP_LENGTH) / 2.0))
        if t_len == 0:
            # a zero-frame cache would break catalog construction later
            print(f"{path}: audio shorter than one frame, skipped")
            continue
        padded = np.zeros((N_SAMPLES,), np.float32)
        padded[: wav.shape[0]] = wav
        wavs.append(padded)
        valid.append(t_len)
        keep.append(code)
    return keep, valid, wavs


def extract_hidden_states(
    audios: str,
    whisper_ckpt: str,
    target: str,
    codes: Optional[str] = None,
    layer_slice=(10, 22),
    batch_size: int = 8,
    n_mels: Optional[int] = None,
    cache_dtype: str = "float32",
    encoder_int8: bool = False,
    compute_dtype: str = "float32",
    device="cuda",
):
    """Write ``<target>/<code>.npy``, the [n_layers, t_len, D] stack of
    encoder layers ``layer_slice`` for every audio file under ``audios``
    whose code contains an entry of the ``codes`` file (all files without
    one).

    Per batch of ``batch_size`` files: each file is decoded, resampled to
    16 kHz, cut at 30 s and zero-padded to 30 s on the host; the batch's
    log-mel is ONE launch at ``[B, 480000]`` on ``device``; the encoder runs
    one segment at a time (:func:`..models.whisper.encoder_forward`); the
    stacks are cast to ``cache_dtype`` on the device, and each file keeps
    ``ceil((samples // 160) / 2)`` frames.  A partial last batch runs at its
    real size (no zero rows).  A loader thread decodes the next batch, and
    the previous batch's files are written, while the card encodes.

    Only PCM WAV decodes here: other files (``.mp3``, ``.opus``) are skipped
    with the decoder's message, as the JAX package skips them on a machine
    without ffmpeg; so is a file shorter than one hop.

    ``cache_dtype="float16"`` halves the files and the device-to-host
    bytes (loaders upcast).  ``encoder_int8`` runs the s8 encoder
    (:func:`..models.whisper.quantize_encoder`), its activation scales
    calibrated on the first batch's mels; its caches are approximate
    (per-frame cosine ~1 - 1e-4 against f32).  Pair it with
    ``compute_dtype="bfloat16"``."""
    from .models.whisper import encoder_kws_stack, quantize_encoder
    from .models.whisper_loader import load_whisper_from_pretrained
    from .runtime.precision import reference_precision

    assert os.path.isdir(audios), f"audio directory not found: {audios}"
    os.makedirs(target, exist_ok=True)
    device = torch.device(device)
    if device.type == "cuda":
        reference_precision()

    config, params = load_whisper_from_pretrained(whisper_ckpt, device=device)
    n_mels = n_mels or config.num_mel_bins
    out_dtype = getattr(torch, cache_dtype)
    cdt = getattr(torch, compute_dtype)

    wanted = _wanted_codes(codes)
    items = [
        (code, path)
        for code, path in find_audio_files(audios).items()
        if wanted is None or any(c in code for c in wanted)
    ]
    chunks = [items[i : i + batch_size] for i in range(0, len(items), batch_size)]

    # each batch's stacks go to host memory by a copy queued behind its
    # encoder; the files of batch N are written once batch N+1 is queued
    in_flight = []

    def _drain(depth: int):
        while len(in_flight) > depth:
            keep, valid, host, done = in_flight.pop(0)
            if done is not None:
                done.synchronize()
            stacks = host.numpy()
            for j, code in enumerate(keep):
                save_hidden_states(os.path.join(target, code + ".npy"),
                                   stacks[j, :, : valid[j], :], dtype=stacks.dtype)

    loader = prefetch((_load_padded(chunk) for chunk in chunks), depth=2)
    for n, (keep, valid, wavs) in enumerate(loader):
        if not wavs:
            continue
        audio = torch.from_numpy(np.stack(wavs)).to(device, non_blocking=True)
        mel = log_mel_spectrogram(audio, n_mels=n_mels)
        if encoder_int8 and n == 0:
            # static activation scales from this corpus's first batch (as in
            # the JAX package, none if all of its files were skipped); the
            # int8 codes replace the f32 weights from here on
            params = quantize_encoder(params, mel, config, dtype=cdt)
        frames = torch.as_tensor(valid, dtype=torch.int64, device=device)
        stacks = encoder_kws_stack(params, mel, config, layer_slice=tuple(layer_slice),
                                   valid_frames=frames, dtype=cdt)
        stacks = stacks[:, :, : max(valid)].to(out_dtype)
        host = torch.empty(stacks.shape, dtype=out_dtype, pin_memory=device.type == "cuda")
        host.copy_(stacks, non_blocking=True)
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        in_flight.append((keep, valid, host, done))
        _drain(1)
        print(f"extracted {min((n + 1) * batch_size, len(items))}/{len(items)}")
    _drain(0)


def _write_wav(path: str, data: np.ndarray, rate: int):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(data, -1, 1) * 32767).astype("<i2").tobytes())


def get_keywords_audios(wav: str, keywords: str, keywords_audios: str):
    """Cut keyword spans per aligned.tsv: ``keyword \\t source_utt \\t
    start_s \\t end_s``; an output is named by its line's index."""
    assert os.path.isdir(wav), f"audio directory not found: {wav}"
    os.makedirs(keywords_audios, exist_ok=True)
    files = find_audio_files(wav, exts=(".wav",))
    with open(keywords) as f:
        metadata = []
        for line in f:
            parts = line.split("\t")
            metadata.append(
                {
                    "keyword": parts[0].strip(),
                    "source": parts[1].strip(),
                    "start": float(parts[2]),
                    "end": float(parts[3]),
                }
                if len(parts) == 4
                else None
            )
    zfill = len(str(len(metadata) - 1))
    for idx, m in enumerate(metadata):
        if m is None or m["start"] == m["end"]:
            continue
        data, rate = read_wav(files[m["source"]])
        lo, hi = int(m["start"] * rate), int(m["end"] * rate)
        _write_wav(
            os.path.join(keywords_audios, str(idx).zfill(zfill) + ".wav"), data[lo:hi], rate
        )


def cut_audios(wav: str, segments: str, segments_audios: str):
    """Slice the XML-defined segments with a transcript out of each
    document's WAV as ``<code>-seg<id>.wav``."""
    import xml.etree.ElementTree as ET

    assert os.path.isdir(wav)
    os.makedirs(segments_audios, exist_ok=True)
    files = find_audio_files(wav, exts=(".wav",))
    tree = ET.parse(segments)
    for doc in tree.getroot():
        code = doc.attrib["code"]
        data, rate = read_wav(files[code])
        for segment in doc:
            transcript = segment.find("current").text
            if not transcript or transcript.strip() == "":
                continue
            start, end = float(segment.attrib["start"]), float(segment.attrib["end"])
            if start == end:
                continue
            _write_wav(
                os.path.join(segments_audios, f"{code}-seg{segment.attrib['id']}.wav"),
                data[int(start * rate) : int(end * rate)],
                rate,
            )


def keyword_tts(
    tts_folder: str,
    keyword_file: str,
    locale: str,
    voice: Optional[str] = None,
    synthesize=None,  # (text, voice_name, out_path) -> None
    list_voices=None,  # (locale) -> [{"ShortName", "Name"}]
    max_retries: int = 3,
    rng=None,
):
    """Keyword speech synthesis, one zero-filled ``<index>.mp3`` per line of
    ``keyword_file``.

    Synthesis is injectable, so the loop runs offline; the default backend
    is edge-tts, which needs the ``edge_tts`` package and the network.
    Keywords whose mp3 exists are skipped (a run resumes).  The voice is the
    keyword file's second column, else ``voice``, else a random voice of
    the locale.  A failed synthesis is retried up to ``max_retries`` times,
    then skipped with a message.  The chosen voices are merged into
    ``<keywords>_voice.txt`` in keyword-file order, keeping earlier runs'
    assignments."""
    import random

    assert os.path.isdir(tts_folder), (
        "the provided folder for storing the synthesized speech does not exist"
    )
    assert os.path.exists(keyword_file), "there is no file with keywords list"

    if synthesize is None or list_voices is None:
        try:
            import asyncio

            import edge_tts
        except ImportError as e:
            raise RuntimeError(
                "keyword_tts requires the edge-tts package and network egress "
                "(or injected synthesize/list_voices callables); this "
                "environment has neither. Run this stage on a networked host."
            ) from e

        def list_voices(locale):  # noqa: F811
            voices = asyncio.run(edge_tts.VoicesManager.create())
            return voices.find(Locale=locale)

        def synthesize(text, voice_name, out_path):  # noqa: F811
            asyncio.run(edge_tts.Communicate(text, voice_name).save(out_path))

    done = {
        int(os.path.splitext(os.path.basename(p))[0])
        for p in glob(os.path.join(tts_folder, "*.mp3"))
    }
    with open(keyword_file) as f:
        keywords = [
            {
                "keyword": line.split("\t")[0].strip(),
                "voice": line.split("\t")[1].strip() if len(line.split("\t")) != 1 else None,
                "idx": idx,
            }
            for idx, line in enumerate(f.readlines())
        ]
    zfill = len(str(len(keywords) - 1))
    todo = [k for k in keywords if k["idx"] not in done]

    def _find_voice(voices, short_name):
        for x in voices:
            if x["ShortName"] == short_name:
                return x
        raise ValueError(
            f"voice {short_name!r} is not available for locale {locale!r} "
            f"(have: {[x['ShortName'] for x in voices][:10]}...)"
        )

    l_voices = list_voices(locale)
    rng = rng or random
    for item in todo:
        if item["voice"] is None:
            v = rng.choice(l_voices) if voice is None else _find_voice(l_voices, voice)
        else:
            v = _find_voice(l_voices, item["voice"])
        out = os.path.join(tts_folder, str(item["idx"]).zfill(zfill) + ".mp3")
        for attempt in range(max_retries):
            try:
                synthesize(item["keyword"], v.get("Name", v["ShortName"]), out)
                # record the voice only for keywords actually synthesized
                item["voice"] = v["ShortName"]
                break
            # the backend is a network client (or an injected callable)
            # whose failures have no common type: any of them is retried
            except Exception as e:
                print(f"{item['keyword']}: {e}")
        else:
            print(f"{item['keyword']}: giving up after {max_retries} attempts")

    dump = (
        keyword_file
        if "voice" in os.path.basename(keyword_file)
        else os.path.splitext(keyword_file)[0] + "_voice.txt"
    )
    known = {}
    if os.path.exists(dump) and dump != keyword_file:
        with open(dump) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2 and parts[1]:
                    known[parts[0]] = parts[1]
    known.update({k["keyword"]: k["voice"] for k in todo if k["voice"]})
    with open(dump, "w") as f:
        f.write(
            "\n".join(
                "\t".join([k["keyword"], known[k["keyword"]]])
                for k in keywords
                if k["keyword"] in known
            )
        )


def main(argv: Optional[List[str]] = None):
    import argparse

    parser = argparse.ArgumentParser(description="Utilities for building datasets")
    parser.add_argument("--tts", action="store_true")
    parser.add_argument("--cut_audios", action="store_true")
    parser.add_argument("--extract_hs", action="store_true")
    parser.add_argument("-a", "--audios", type=str)
    parser.add_argument("-k", "--keywords", type=str)
    parser.add_argument("-t", "--target", type=str)
    parser.add_argument("-u", "--utterances", type=str, default="")
    parser.add_argument("-s", "--segments", type=str)
    parser.add_argument("-l", "--locale", type=str)
    parser.add_argument("-v", "--voice", type=str, default="")
    parser.add_argument("-w", "--whisper", type=str)
    parser.add_argument(
        "--cache_dtype", type=str, default="float32",
        choices=("float32", "float16"),
        help="float16 halves cache files + device-fetch bytes (loaders upcast)",
    )
    parser.add_argument(
        "--encoder_int8", action="store_true",
        help="s8xs8->s32 encoder (scales calibrated on the first batch); "
             "approximate caches — validate on real audio first",
    )
    parser.add_argument(
        "--compute_dtype", type=str, default="float32",
        choices=("float32", "bfloat16"),
        help="encoder intermediate dtype (pair bfloat16 with --encoder_int8)",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the mel and the encoder run (cuda, or cpu)")
    args = parser.parse_args(argv)

    if args.tts:
        keyword_tts(args.target, args.keywords, args.locale, args.voice or None)
    elif args.cut_audios:
        if args.segments:
            cut_audios(args.audios, args.segments, args.target)
        else:
            get_keywords_audios(args.audios, args.keywords, args.target)
    elif args.extract_hs:
        extract_hidden_states(
            args.audios, args.whisper, args.target,
            codes=args.utterances or None,
            cache_dtype=args.cache_dtype,
            encoder_int8=args.encoder_int8,
            compute_dtype=args.compute_dtype,
            device=args.device,
        )


if __name__ == "__main__":
    main()
