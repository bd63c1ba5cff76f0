"""Arabic diacritization (tashkeel restoration) stage.

The reference conditions its training data on the external CATT
Tashkeel model loaded from a sibling checkout (reference:
util_models.py:12-40) and re-interleaves the diacritized segments with
punctuation (reference: preprocess.py:109-158). The external-model shim
keeps that contract behind the same ``do_tashkeel`` interface; an
``IdentityDiacritizer`` keeps the stage runnable without the external
repo.

A copy of ``pl_bert_tpu/preprocess/diacritize.py`` (1-122), with one
deliberate difference: the external checkouts are looked for where
``PLBERT_CATT_DIR`` / ``PLBERT_MANTOQ_DIR`` point, else in ``catt/`` and
``mantoq/`` at the root of this repository (git-ignored), never beside
it as JAX's ``../../../catt`` does, so a run imports no code from outside
its own checkout unless it is told to.
"""

from __future__ import annotations

import os
import sys
from typing import Protocol

from pl_bert_tpu_torch.preprocess.phonemize import separate_text_into_segments


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def checkout_path(path: str | None, env: str, name: str) -> str:
    """An external checkout's root: ``path``, else ``$env``, else
    ``<repo>/<name>``."""
    return path or os.environ.get(env) or os.path.join(_REPO, name)


class Diacritizer(Protocol):
    def do_tashkeel(self, segments: list[str]) -> list[str]: ...


class IdentityDiacritizer:
    def do_tashkeel(self, segments: list[str]) -> list[str]:
        return list(segments)


class CattTashkeel:
    """Shim around the external CATT encoder-decoder Tashkeel model
    (3-layer, ckpt best_ed_mlm_ns_epoch_178.pt, max_seq 1024 — reference
    util_models.py:12-40). Requires a ``catt/`` checkout (``checkout_path``)."""

    def __init__(self, catt_path: str | None = None, device: str | None = None):
        catt_path = checkout_path(catt_path, "PLBERT_CATT_DIR", "catt")
        if not os.path.isdir(catt_path):
            raise RuntimeError(
                f"CATT checkout not found at {catt_path}; clone it or use "
                "the identity diacritizer"
            )
        import torch

        sys.path.insert(0, catt_path)
        try:
            from ed_pl import TashkeelModel
            from tashkeel_tokenizer import TashkeelTokenizer
            from utils import remove_non_arabic
        finally:
            sys.path.remove(catt_path)

        self.remove_non_arabic = remove_non_arabic
        self.tokenizer = TashkeelTokenizer()
        ckpt = os.path.join(catt_path, "models/best_ed_mlm_ns_epoch_178.pt")
        self.device = device or (
            "cuda" if torch.cuda.is_available() else "cpu"
        )
        self.model = TashkeelModel(
            self.tokenizer, max_seq_len=1024, n_layers=3, learnable_pos_emb=False
        )
        self.model.load_state_dict(torch.load(ckpt, map_location=self.device))
        self.model.eval().to(self.device)

    def do_tashkeel(self, segments: list[str]) -> list[str]:
        cleaned = [self.remove_non_arabic(s) for s in segments]
        return self.model.do_tashkeel_batch(cleaned, batch_size=16, verbose=False)


class MantoqG2P:
    """Shim around the external mantoq Arabic G2P (reference:
    util_models.py:41-51)."""

    def __init__(self, mantoq_path: str | None = None):
        mantoq_path = checkout_path(mantoq_path, "PLBERT_MANTOQ_DIR", "mantoq")
        if not os.path.isdir(mantoq_path):
            raise RuntimeError(f"mantoq checkout not found at {mantoq_path}")
        sys.path.insert(0, mantoq_path)
        try:
            import mantoq
        finally:
            sys.path.remove(mantoq_path)
        self._g2p = mantoq.g2p

    def do_tashkeel(self, segments: list[str]) -> list[str]:
        return [self._g2p(s)[0] for s in segments]


def diacritize_text(text: str, diacritizer: Diacritizer | None = None) -> str:
    """Diacritize word segments and re-interleave punctuation in place
    (reference: preprocess.py:109-158)."""
    from pl_bert_tpu_torch.text.normalize import separate_words_and_punctuation

    tokens = separate_words_and_punctuation(text)
    segments, punctuations, segment_indices = separate_text_into_segments(tokens)
    diacritized_segments = (
        diacritizer.do_tashkeel(segments) if diacritizer is not None else segments
    )

    diacritized_tokens: list[str] = []
    for segment in diacritized_segments:
        diacritized_tokens.extend(segment.split())

    out = ""
    token_idx = 0
    punct_idx = 0
    boundary = set(segment_indices)
    for i in range(len(tokens)):
        if i in boundary:
            if punct_idx < len(punctuations):
                out += punctuations[punct_idx]
                punct_idx += 1
        else:
            if token_idx < len(diacritized_tokens):
                if out and not out.endswith(" "):
                    out += " "
                out += diacritized_tokens[token_idx]
                token_idx += 1
    return out
