"""ELECTRONIC converter — URLs/hashtags (behavioral parity: reference
converters/Electronic.py:10-239).

A copy of ``pl_bert_tpu/text/converters/Electronic.py`` (1-101).
"""

import re

from pl_bert_tpu_torch.text.converters.numbers import cardinal_words, digit_words

_HTTP = re.compile(r"https?://")

# glyph readings; inside plain (non-http) tokens every multi-word reading is
# space-spelled except "dot"
_GLYPHS = {
    "/": "slash", ":": "colon", ".": "dot", "#": "hash", "-": "dash",
    "é": "e acute", "(": "opening parenthesis", ")": "closing parenthesis",
    "_": "underscore", ",": "comma", "%": "percent", "~": "tilde",
    ";": "semicolon", "'": "single quote", '"': "double quote",
}
_DIGIT_NAMES = {
    "0": "o", "1": "one", "2": "two", "3": "three", "4": "four",
    "5": "five", "6": "six", "7": "seven", "8": "eight", "9": "nine",
}
_SENSIBLE = {
    **_GLYPHS,
    **{d: ("zero" if d == "0" else _DIGIT_NAMES[d]) for d in _DIGIT_NAMES},
}


def _spell(word: str) -> str:
    """Space-pad a word's letters ("slash" → "s l a s h")."""
    return " ".join(word.replace(" ", ""))


def _glyph_reading(char: str, http: bool) -> str:
    if char not in _GLYPHS:
        return char
    word = _GLYPHS[char]
    if char == ".":
        return "dot"
    if http and char in "/:#-é":
        return word if char != "é" else _spell(word)
    if http:  # http-mode still spells out the rarer glyphs
        if char == ";":
            return "s e m i colon"
        return _spell(word)
    return _spell(word)


def _digit_reading(char: str, http: bool) -> str:
    if char == "0":
        return "o"
    return _spell(_DIGIT_NAMES[char])


class Electronic:
    """"site.com/a1"→"site dot com slash a one" style spelled URLs;
    "#Tag"→"hash tag t a g"."""

    def convert(self, token: str) -> str:
        token = token.lower()
        if token == "::":
            return token
        if token.startswith("#") and len(token) > 1:
            return self.convert_hash_tag(token)

        http = _HTTP.match(token) is not None
        out: list[str] = []
        i = 0
        while i < len(token):
            if http and token[i:].startswith(".com"):
                out.append("dot com")
                i += 4
                continue
            run = 0
            while i + run < len(token) and token[i + run].isdigit():
                run += 1
            if run == 2 and token[i] != "0":
                out.append(_spell(cardinal_words(token[i : i + run])))
                i += run
            elif run > 0 and token[i : i + run] != "0" * run:
                out.append(_spell(digit_words(token[i : i + run])))
                i += run
            else:
                c = token[i]
                if c.isdigit():
                    out.append(_digit_reading(c, http))
                else:
                    out.append(_glyph_reading(c, http))
                i += 1
        return " ".join(out)

    def convert_hash_tag(self, token: str) -> str:
        # letters run together into words; special glyphs/digits get their
        # own space-separated reading
        out = "hash tag "
        for char in token[1:].lower():
            if char in _SENSIBLE:
                sep = "" if out.endswith(" ") else " "
                out += f"{sep}{_SENSIBLE[char]} "
            else:
                out += char
        return out.strip()
