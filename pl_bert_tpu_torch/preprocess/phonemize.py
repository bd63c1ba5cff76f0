"""Phonemization: G2P backends + punctuation-preserving segment logic.

The reference phonemizes via the ``phonemizer`` package's espeak-ng
wrapper (reference: preprocess.py:427-457) and re-interleaves
punctuation around phonemized word segments (reference:
preprocess.py:32-107). Neither ``phonemizer`` nor a Python espeak
binding exists in this environment, so the espeak-ng C library is bound
directly with ctypes (``EspeakBackend``); an ``IdentityG2P`` backend
serves as the deterministic no-dependency fallback for tests and dry
runs.

A copy of ``pl_bert_tpu/preprocess/phonemize.py`` (1-235).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Protocol

from pl_bert_tpu_torch.text.symbols import PUNCTUATION


class G2PBackend(Protocol):
    def phonemize_segment(self, text: str) -> str:
        """Whitespace-separated words → whitespace-separated phoneme words."""
        ...


class IdentityG2P:
    """Fallback backend: each word maps to itself (lowercased). Keeps the
    pipeline runnable end-to-end without espeak-ng."""

    def phonemize_segment(self, text: str) -> str:
        return text.lower()


def espeak_phoneme_mode(tie: bool = False) -> int:
    """``phonememode`` for ``espeak_TextToPhonemes`` reproducing the
    ``phonemizer`` package's configuration (the reference's backend,
    preprocess.py:435).

    Per espeak-ng's ``speak_lib.h``: bit 1 selects IPA phoneme names
    (0x02); bit 7 + bits 8-23 inject a tie character between the letters
    of multi-letter phonemes. ``phonemizer`` passes exactly 0x02 when no
    tie is requested (its default) — in particular it does NOT set
    bit 0, and stress marks are not a mode bit at all: espeak always
    emits them in IPA mode and ``phonemizer`` strips them afterwards
    when ``with_stress=False`` (see :func:`strip_stress`).
    """
    if tie:
        return 0x02 | 0x80 | (0x361 << 8)  # U+0361 combining tie
    return 0x02


def strip_stress(phonemes: str) -> str:
    """Remove stress marks — the ``phonemizer`` package's
    ``with_stress=False`` post-processing (its regex strips ˈ ˌ ' and -,
    covering espeak's occasional apostrophe/hyphen separators too). The
    reference runs with ``with_stress=True`` (preprocess.py:435), which
    keeps them."""
    return (
        phonemes.replace("ˈ", "").replace("ˌ", "")
        .replace("'", "").replace("-", "")
    )


class EspeakBackend:
    """Direct ctypes binding to libespeak-ng.

    Equivalent of ``phonemizer.backend.EspeakBackend(language=...,
    preserve_punctuation=True, with_stress=True)`` as configured at
    reference preprocess.py:435 — punctuation preservation is handled by
    the segment interleaving in :func:`phonemize_text`, IPA selection by
    :func:`espeak_phoneme_mode`, and stress marks by keeping (or
    stripping, :func:`strip_stress`) what espeak emits.
    """

    _ESPEAK_CHARS_UTF8 = 1
    # espeak_AUDIO_OUTPUT: 2 = AUDIO_OUTPUT_SYNCHRONOUS — phonemization
    # only, no audio device (3 would be SYNCH_PLAYBACK and try to open one)
    _AUDIO_OUTPUT_SYNCHRONOUS = 2
    # without this option bit, espeak_Initialize exit(1)s the WHOLE
    # process when its espeak-ng-data directory is missing, instead of
    # returning an error our RuntimeError path can report
    _INITIALIZE_DONT_EXIT = 0x8000

    def __init__(self, language: str = "ar", with_stress: bool = True) -> None:
        # PLBERT_ESPEAK_LIB: explicit library path override — for hosts
        # where libespeak-ng lives outside the default search path, and
        # for the in-repo ABI stub (tests/espeak_stub/) that exercises
        # this binding's FFI loop without the real library
        path = (
            os.environ.get("PLBERT_ESPEAK_LIB")
            or ctypes.util.find_library("espeak-ng")
            or ctypes.util.find_library("espeak")
        )
        if path is None:
            raise RuntimeError(
                "libespeak-ng not found — install espeak-ng or use the "
                "'identity' g2p backend"
            )
        self._lib = ctypes.cdll.LoadLibrary(path)
        self._lib.espeak_Initialize.restype = ctypes.c_int
        self._lib.espeak_SetVoiceByName.restype = ctypes.c_int
        self._lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
        self._lib.espeak_TextToPhonemes.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int,
            ctypes.c_int,
        ]
        rate = self._lib.espeak_Initialize(
            self._AUDIO_OUTPUT_SYNCHRONOUS, 0, None, self._INITIALIZE_DONT_EXIT
        )
        if rate <= 0:
            raise RuntimeError(
                "espeak_Initialize failed (espeak-ng-data missing?)"
            )
        self._language = language.encode()
        if self._lib.espeak_SetVoiceByName(self._language) != 0:
            raise RuntimeError(f"espeak voice '{language}' unavailable")
        self._mode = espeak_phoneme_mode()
        self._with_stress = with_stress

    def phonemize_segment(self, text: str) -> str:
        # espeak's voice is PROCESS-GLOBAL state: constructing another
        # backend with a different language would silently retarget this
        # one, so re-assert the voice per call (cheap vs phonemization)
        if self._lib.espeak_SetVoiceByName(self._language) != 0:
            raise RuntimeError(
                f"espeak voice {self._language!r} became unavailable"
            )
        raw = text.encode("utf-8")
        buf = ctypes.create_string_buffer(raw)
        ptr = ctypes.c_void_p(ctypes.addressof(buf))
        pieces = []
        # espeak processes one "clause" per call and advances the pointer
        while ptr.value:
            out = self._lib.espeak_TextToPhonemes(
                ctypes.byref(ptr), self._ESPEAK_CHARS_UTF8, self._mode
            )
            if out:
                pieces.append(out.decode("utf-8"))
        joined = " ".join(" ".join(pieces).split())
        return joined if self._with_stress else strip_stress(joined)


_BACKENDS = {"espeak": EspeakBackend, "identity": IdentityG2P}


def get_g2p_backend(name: str, language: str = "ar", with_stress: bool = True):
    if name == "identity":
        return IdentityG2P()
    if name == "espeak":
        return EspeakBackend(language=language, with_stress=with_stress)
    raise ValueError(f"unknown g2p backend: {name} (have {sorted(_BACKENDS)})")


def separate_text_into_segments(
    tokens: list[str],
) -> tuple[list[str], list[str], list[int]]:
    """Group consecutive non-punctuation tokens into segments.

    Returns (segments, punctuations, segment_end_indices) where
    ``segment_end_indices[k]`` is the token index at which segment k
    ended (i.e. where a punctuation token or end-of-list appeared) —
    the layout :func:`phonemize_text` uses to re-interleave punctuation
    (reference: preprocess.py:32-64).
    """
    segments: list[str] = []
    punctuations: list[str] = []
    segment_indices: list[int] = []
    current: list[str] = []
    for i, token in enumerate(tokens):
        if token in PUNCTUATION:
            if current:
                segments.append(" ".join(current))
                segment_indices.append(i)
                current = []
            punctuations.append(token)
        else:
            current.append(token)
    if current:
        segments.append(" ".join(current))
        segment_indices.append(len(tokens))
    return segments, punctuations, segment_indices


def phonemize_text(text: str, backend: G2PBackend) -> list[str]:
    """Text → per-token phoneme strings with punctuation preserved in
    place (reference: preprocess.py:66-107). Output list has one entry
    per original word/punctuation token.

    DELIBERATE PARITY FLAW — consecutive punctuation drops: for tokens
    like ``[w1, ',', ',', w2]`` the re-interleave emits only ONE comma
    and the following words' phonemes shift one slot earlier, because a
    punctuation token is emitted only at a segment *boundary* index and
    consecutive punctuation creates one boundary. This is bit-faithful
    to the reference's own logic (reference: preprocess.py:88-107 has
    the identical behavior) and is pinned by
    tests/test_preprocess.py::test_consecutive_punctuation_parity_flaw —
    do NOT "fix" it without breaking parity intentionally and updating
    that test.

    SECOND parity flaw of the same origin — LEADING punctuation drops:
    for tokens like ``[',', w1]`` the comma precedes any segment, no
    boundary index matches it, and the output has one entry fewer than
    the token list (also bit-faithful to reference preprocess.py:88-107;
    pinned by test_leading_punctuation_parity_flaw). Both flaws mean the
    "one entry per token" contract holds only for well-formed text;
    consumers needing exact alignment (pipeline._tokenize_record) guard
    with a length check rather than trusting it.
    """
    from pl_bert_tpu_torch.text.normalize import separate_words_and_punctuation

    tokens = separate_words_and_punctuation(text)
    segments, punctuations, segment_indices = separate_text_into_segments(tokens)

    phonemized_words: list[str] = []
    for segment in segments:
        phonemized_words.extend(backend.phonemize_segment(segment).split())

    phonemes: list[str] = []
    seg_idx = 0
    punct_idx = 0
    boundary = set(segment_indices)
    for i in range(len(tokens)):
        if i in boundary:
            if punct_idx < len(punctuations):
                phonemes.append(punctuations[punct_idx])
                punct_idx += 1
        else:
            if seg_idx < len(phonemized_words):
                phonemes.append(phonemized_words[seg_idx])
                seg_idx += 1
    return phonemes
