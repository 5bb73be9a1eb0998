"""The Moses detokenizer, as the JAX package runs it through
``sacremoses.MosesDetokenizer`` (the rules of ``mosesdecoder``'s
``scripts/tokenizer/detokenizer.perl``), for the port's metrics.

The port keeps its own copy because the card's environment has no
``sacremoses``. It carries the rules for the languages the recipes
detokenize, English and Spanish (``lang`` names the target language); any
other ``lang`` raises ``ValueError``. One pass over the whitespace-split
tokens decides, token by token, whether a space goes before it
(``prepend_space``):

* XML entities are unescaped first (``&amp;`` last) and `` @-@ `` joins;
* a token starting with a CJK character joins a preceding CJK token;
* currency symbols and opening brackets/¿/¡ take the next token without a
  space; closing punctuation joins the previous token;
* English ``'s``-style contractions join the previous token;
* quotes alternate between opening (space before, none after) and
  closing (no space before), counted per quote kind; an English ``'``
  after a word ending in ``s`` is a possessive;
* spaces collapse to one and the ends are stripped.

Character classes come from Python's ``unicodedata``: letters and letter
numbers (``Nl``) outside the CJK ranges for Perl's ``IsAlpha`` (the table
sacremoses ships has no CJK ideographs or Hangul syllables), currency
symbols (``Sc``) for ``IsSc``. They agree with sacremoses' tables on every
character below U+0345 and in the CJK ranges; beyond, they differ on some
combining marks and recent letters, which decide a rule only as the
second character of a contraction. ``tests/test_torch_recipe.py`` holds
the two to each other on English and Spanish token streams.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Sequence

__all__ = ["MosesDetokenizer"]

# (&bar; &#124;) (&lt; &gt;) (&bra; &ket;) &quot; &apos; (&#91; &#93;) &amp;
_UNESCAPE = (("&bar;", "|"), ("&#124;", "|"), ("&lt;", "<"), ("&gt;", ">"),
             ("&bra;", "["), ("&ket;", "]"), ("&quot;", '"'),
             ("&apos;", "'"), ("&#91;", "["), ("&#93;", "]"),
             ("&amp;", "&"))
# code point ranges sacremoses calls CJK (exclusive bounds)
_CJK = ((4352, 4607), (11904, 42191), (43072, 43135), (44032, 55215),
        (63744, 64255), (65072, 65103), (65381, 65500), (94208, 101119),
        (110592, 110895), (110960, 111359), (131072, 196607))
_PUNCT = re.compile(r"^[\,\.\?\!\:\;\\\%\}\]\)]+$")
_OPEN_QUOTE = re.compile(r"""^[\'\"„“`]+$""")


def _is_cjk(ch: str) -> bool:
    code = ord(ch)
    for start, end in _CJK:
        if code < end:
            return code > start
    return False


def _is_alpha(ch: str) -> bool:
    return ((ch.isalpha() or unicodedata.category(ch) == "Nl")
            and not _is_cjk(ch))


def _is_currency(token: str) -> bool:
    return all(unicodedata.category(c) == "Sc" or c in "([{¿¡"
               for c in token)


class MosesDetokenizer:
    LANGUAGES = ("en", "es")

    def __init__(self, lang: str = "en"):
        if lang not in self.LANGUAGES:
            raise ValueError(f"lang: {lang!r} has no detokenizer rules here "
                             f"(the port carries {self.LANGUAGES})")
        self.lang = lang

    def detokenize(self, tokens: Sequence[str]) -> str:
        text = " {} ".format(" ".join(tokens)).replace(" @-@ ", "-")
        for entity, char in _UNESCAPE:
            text = text.replace(entity, char)
        words: List[str] = text.split()
        lang = self.lang
        quotes = {"'": 0, '"': 0, "``": 0, "`": 0, "''": 0}
        out, space = "", " "
        for i, tok in enumerate(words):
            if _is_cjk(tok[0]):
                joins = i > 0 and _is_cjk(words[i - 1][-1])
                out += tok if joins else space + tok
                space = " "
            elif _is_currency(tok):
                out += space + tok
                space = ""
            elif _PUNCT.search(tok):
                out += tok
                space = " "
            elif (lang == "en" and i > 0 and len(tok) > 1 and tok[0] == "'"
                  and _is_alpha(tok[1])):
                out += tok
                space = " "
            elif _OPEN_QUOTE.search(tok):
                quote = '"' if re.search(r"^[„“”]+$", tok) else tok
                quotes[quote] = quotes.get(quote, 0)
                if quotes[quote] % 2 == 0:
                    if (lang == "en" and tok == "'" and i > 0
                            and words[i - 1].endswith("s")):
                        out += tok  # a possessive: "the Jones' house"
                        space = " "
                    else:
                        out += space + tok
                        space = ""
                        quotes[quote] += 1
                else:
                    out += tok
                    space = " "
                    quotes[quote] += 1
            else:
                out += space + tok
                space = " "
        return re.sub(r" {2,}", " ", out).strip()
