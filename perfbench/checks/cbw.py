"""Judges a CB-Whisper cell's sampled requests against the plain reference.

The reference makes its own weights and catalog from the configuration's
``weights_seed`` and its own features from the requests' audio,
re-derives the spotter's centred head, and reads the program's outputs
only to judge them.  Numbers compared (each the
largest over the sampled requests and their windows):

* ``mel_gap``: features, max |program - reference| (log-mel units);
* ``enc_gap``: the encoder's output (what cross-attention reads), max
  |difference| over the reference's max |value|;
* ``kws_gap``: the spotter's logits of every catalog keyword, max
  |difference| (they read the encoder's hidden states of the spotter's
  layers, so they judge that stack too);
* ``score_gap`` (decoding cells): the served sequence's beam score against
  the reference's teacher-forced score of the same tokens, |difference|.

With ``control`` set, the reference in that lower precision stands in for
the program: its own features, encoder, spotter and head, and its own
teacher-forced scores of the program's served tokens.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import traffic, weights
from ..reference import cbw as ref_cbw
from ..reference import mel as ref_mel
from ..reference import whisper as ref_whisper
from ..reference.precision import Prec, full_fp32
from ..systems import cbw as system

N_SAMPLES = 480000  # a 30 s window


class _Side:
    """One side's weights and centred spotter head, at one precision."""

    def __init__(self, cfg, device, prec: Prec, w, keywords):
        self.cfg, self.prec, self.w, self.keywords = cfg, prec, w, keywords
        self.wk = weights.materialize(weights.cbw_kws_spec(cfg["kws"]), cfg["weights_seed"], system.SALT_KWS, device)
        mel = self.mel(system.centre_audio(cfg), device)
        _, states = ref_whisper.encode(w, cfg, mel, prec)
        ref_cbw.centre(self.wk, self.spot(states)[: cfg["kws"]["keywords"]])

    def mel(self, audio: np.ndarray, device) -> torch.Tensor:
        padded = np.zeros((max(N_SAMPLES, audio.size),), np.float32)
        padded[: audio.size] = audio
        return ref_mel.log_mel(torch.from_numpy(padded).to(device), self.cfg["num_mel_bins"], self.prec)

    def spot(self, states) -> torch.Tensor:
        stack = ref_cbw.kws_stack(states, self.cfg["kws"]["layer_slice"])
        return ref_cbw.spot_logits(self.wk, self.cfg["kws"], self.keywords, stack, self.prec)


def _segment(mel: torch.Tensor, seek: int, frames: Optional[int]) -> torch.Tensor:
    """The window the encoder saw: ``frames`` mel frames from ``seek``,
    zero-padded to 3000 (the whole 30 s features when ``frames`` is None)."""
    if frames is None:
        return mel[:, :3000]
    seg = mel[:, seek : seek + frames]
    return F.pad(seg, (0, 3000 - seg.shape[1]))


@torch.no_grad()
def readings(env, items: List[dict], control: Optional[str] = None) -> Dict[str, float]:
    """``items``: per sampled request its ``clip``, the program's
    ``features`` [80, T] and its ``windows``: ``seek``, ``frames``, ``enc``
    [1500, D], ``logits`` [N, 2] and, when it decoded, ``prompt`` [P],
    ``prompt_mask`` [P], ``sequence`` [max_len] and ``score``."""
    cfg, device = env.config, env.device
    full_fp32()
    w = weights.materialize(weights.whisper_spec(cfg), cfg["weights_seed"], system.SALT_WHISPER, device)
    keywords = system.catalog_stacks(cfg, device)
    ref = _Side(cfg, device, Prec("fp32"), w, keywords)
    low = _Side(cfg, device, Prec(control), w, keywords) if control else None
    n_kw = cfg["kws"]["keywords"]
    gaps = {"mel_gap": 0.0, "enc_gap": 0.0, "kws_gap": 0.0}
    for item in items:
        audio = traffic.audio(env.mix, item["clip"])
        mel_ref = ref.mel(audio, device)
        mel_cand = low.mel(audio, device) if low else item["features"].to(device, torch.float32)
        gaps["mel_gap"] = max(gaps["mel_gap"], float((mel_cand - mel_ref).abs().max()))
        for win in item["windows"]:
            enc_ref, states = ref_whisper.encode(w, cfg, _segment(mel_ref, win["seek"], win["frames"]), ref.prec)
            logits_ref = ref.spot(states)[:n_kw]
            if low:
                enc_cand, states_low = ref_whisper.encode(w, cfg, _segment(mel_cand, win["seek"], win["frames"]),
                                                          low.prec)
                logits_cand = low.spot(states_low)[:n_kw]
            else:
                enc_cand = win["enc"].to(device, torch.float32)
                logits_cand = win["logits"][:n_kw].to(device, torch.float32)
            scale = float(enc_ref.abs().max())
            gaps["enc_gap"] = max(gaps["enc_gap"], float((enc_cand - enc_ref).abs().max()) / scale)
            gaps["kws_gap"] = max(gaps["kws_gap"], float((logits_cand - logits_ref).abs().max()))
            if "sequence" not in win:
                continue
            seq = torch.as_tensor(win["sequence"], dtype=torch.long, device=device)
            pmask = torch.as_tensor(win["prompt_mask"], dtype=torch.long, device=device)
            plen = int(pmask.shape[0])
            score_ref = float(ref_cbw.beam_score(w, cfg, enc_ref, plen, seq, pmask, ref.prec))
            score_cand = (float(ref_cbw.beam_score(w, cfg, enc_cand, plen, seq, pmask, low.prec))
                          if low else float(win["score"]))
            gaps["score_gap"] = max(gaps.get("score_gap", 0.0), abs(score_cand - score_ref))
    return gaps
