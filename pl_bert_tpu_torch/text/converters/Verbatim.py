"""VERBATIM converter (behavioral parity: reference converters/Verbatim.py:7-160).

A copy of ``pl_bert_tpu/text/converters/Verbatim.py`` (1-50).
"""

# whole-token / single-char special readings
SYMBOL_WORDS = {
    "feet": "feet",
    "&": "and", "_": "underscore", "#": "number", "€": "euro",
    "$": "dollar", "£": "pound", "~": "tilde", "%": "percent",
    "²": "squared", "³": "cubed", "×": "times", "=": "equals",
    ">": "greater than", "µ": "micro",
}

_GREEK = {
    "α": "alpha", "β": "beta", "γ": "gamma", "δ": "delta", "ε": "epsilon",
    "ζ": "zeta", "η": "eta", "θ": "theta", "ι": "iota", "κ": "kappa",
    "λ": "lambda", "μ": "mu", "ν": "nu", "ξ": "xi", "ο": "omicron",
    "π": "pi", "ρ": "rho", "σ": "sigma", "ς": "sigma", "ϲ": "sigma",
    "τ": "tau", "υ": "upsilon", "φ": "phi", "χ": "chi", "ψ": "psi",
    "ω": "omega",
}
for _g, _name in list(_GREEK.items()):
    SYMBOL_WORDS[_g] = _name
    SYMBOL_WORDS[_g.upper()] = _name
SYMBOL_WORDS["Ϲ"] = "sigma"

# digit/dot/dash spellings used inside multi-char verbatim tokens
SPELLED_CHARS = {
    ".": "dot", "-": "d a s h",
    "0": "o", "1": "o n e", "2": "t w o", "3": "t h r e e", "4": "f o u r",
    "5": "f i v e", "6": "s i x", "7": "s e v e n", "8": "e i g h t",
    "9": "n i n e",
}


class Verbatim:
    """Symbol names for known glyphs; otherwise chars spelled out
    (".6-cM" → "dot s i x d a s h c m")."""

    def convert(self, token: str) -> str:
        if token in SYMBOL_WORDS:
            return SYMBOL_WORDS[token]
        if len(token) == 1:
            return token
        return " ".join(self.convert_char(c) for c in token)

    def convert_char(self, char: str) -> str:
        if char in SPELLED_CHARS:
            return SPELLED_CHARS[char]
        if char in SYMBOL_WORDS:
            return SYMBOL_WORDS[char]
        return char.lower()
