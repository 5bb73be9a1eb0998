"""The Moses punctuation normalizer and word tokenizer, as the JAX
package's corpus preparation runs them through ``sacremoses``
(``MosesPunctNormalizer(lang).normalize`` and
``MosesTokenizer(lang).tokenize`` with their default options; the rules of
``mosesdecoder``'s ``normalize-punctuation.perl`` and ``tokenizer.perl``).

The port keeps its own copy because the card's environment has no
``sacremoses``. It carries the languages the preparation scripts clean,
English, Spanish and German (nonbreaking prefixes, apostrophe and number
rules); any other ``lang`` raises ``ValueError``.

Character classes come from Python's ``unicodedata``, as in
:mod:`.detokenize`: letters and letter numbers outside the CJK ranges for
Perl's ``IsAlpha``, those and decimal digits for ``IsAlnum``, the ``N*``
categories for ``IsN``, ``str.islower`` for ``IsLower``. They agree with
sacremoses' tables on every character below U+0345 and in the CJK
ranges (beyond, on some combining marks and recent letters, they differ).
``tests/test_torch_prep.py`` holds both stages to sacremoses on English,
Spanish and German text.
"""

from __future__ import annotations

import functools
import re
import unicodedata
from typing import List

from .detokenize import _is_alpha

__all__ = ["MosesPunctNormalizer", "MosesTokenizer"]

_LANGUAGES = ("en", "es", "de")


def _check_lang(lang: str) -> str:
    if lang not in _LANGUAGES:
        raise ValueError(f"lang: {lang!r} has no Moses rules here (the port "
                         f"carries {_LANGUAGES})")
    return lang


# ------------------------------------------------------------ normalizer
_EXTRA_WHITESPACE = (
    (r"\r", r""), (r"\(", r" ("), (r"\)", r") "), (r" +", r" "),
    (r"\) ([.!:?;,])", r")\g<1>"), (r"\( ", r"("), (r" \)", r")"),
    (r"(\d) %", r"\g<1>%"), (r" :", r":"), (r" ;", r";"),
)
_PENN = ((r"`", r"'"), (r"''", r' " '))
_UNICODE = (
    ("„", r'"'), ("“", r'"'), ("”", r'"'), ("–", r"-"), ("—", r" - "),
    (r" +", r" "), ("´", r"'"), ("([a-zA-Z])‘([a-zA-Z])", r"\g<1>'\g<2>"),
    ("([a-zA-Z])’([a-zA-Z])", r"\g<1>'\g<2>"), ("‘", r"'"), ("‚", r"'"),
    ("’", r"'"), (r"''", r'"'), ("´´", r'"'), ("…", r"..."),
)
_NBSP = "\u00A0"
_FRENCH_QUOTES = (
    (f"{_NBSP}«{_NBSP}", r'"'), (f"«{_NBSP}", r'"'), ("«", r'"'),
    (f"{_NBSP}»{_NBSP}", r'"'), (f"{_NBSP}»", r'"'), ("»", r'"'),
)
_PSEUDO_SPACES = (
    (f"{_NBSP}%", r"%"), (f"nº{_NBSP}", "nº "), (f"{_NBSP}:", r":"),
    (f"{_NBSP}ºC", " ºC"), (f"{_NBSP}cm", r" cm"), (f"{_NBSP}\\?", "?"),
    (f"{_NBSP}\\!", "!"), (f"{_NBSP};", r";"), (f",{_NBSP}", r", "),
    (r" +", r" "),
)
_QUOTE_COMMA = {
    "en": ((r'"([,.]+)', r'\g<1>"'),),
    "es": ((r',"', r'",'), (r'(\.+)"(\s*[^<])', r'"\g<1>\g<2>')),
}
_QUOTE_COMMA["de"] = _QUOTE_COMMA["es"]
_NUMBERS = {
    "en": ((f"(\\d){_NBSP}(\\d)", r"\g<1>.\g<2>"),),
    "es": ((f"(\\d){_NBSP}(\\d)", r"\g<1>,\g<2>"),),
}
_NUMBERS["de"] = _NUMBERS["es"]


class MosesPunctNormalizer:
    """``sacremoses.MosesPunctNormalizer(lang)`` at its defaults (Penn
    quotes, quotes before commas and numbers normalized, no Unicode
    punctuation replacement, control characters kept)."""

    def __init__(self, lang: str = "en"):
        lang = _check_lang(lang)
        rules = (_EXTRA_WHITESPACE + _PENN + _UNICODE + _FRENCH_QUOTES
                 + _PSEUDO_SPACES + _QUOTE_COMMA[lang] + _NUMBERS[lang])
        self._rules = [(re.compile(p), r) for p, r in rules]

    def normalize(self, text: str) -> str:
        text = str(text)
        for pattern, repl in self._rules:
            text = pattern.sub(repl, text)
        return text.strip()


# ------------------------------------------------------------- tokenizer
# mosesdecoder's nonbreaking_prefix.{en,es,de}, comments and blank lines
# dropped, each line stripped ("+" stands for the space before
# "#NUMERIC_ONLY#")
_NONBREAKING = {
    "en": (
        "A B C D E F G H I J K L M N O P Q R S T U V W X Y Z Adj Adm Adv "
        "Asst Bart Bldg Brig Bros Capt Cmdr Col Comdr Con Corp Cpl DR Dr Drs "
        "Ens Gen Gov Hon Hr Hosp Insp Lt MM MR MRS MS Maj Messrs Mlle Mme Mr "
        "Mrs Ms Msgr Op Ord Pfc Ph Prof Pvt Rep Reps Res Rev Rt Sen Sens Sfc "
        "Sgt Sr St Supt Surg v vs i.e rev e.g Rs No+#NUMERIC_ONLY# Nos "
        "Art+#NUMERIC_ONLY# Nr pp+#NUMERIC_ONLY# Jan Feb Mar Apr Jun Jul Aug "
        "Sep Oct Nov Dec"),
    "es": (
        "A B C D E F G H I J K L M N O P Q R S T U V W X Y Z A.C Apdo Av Bco "
        "CC.AA Da Dep Dn Dr Dra EE.UU Excmo FF.CC Fil Gral J.C Let Lic N.B "
        "P.D P.V.P Prof Pts Rte S.A S.A.R S.E S.L S.R.C Sr Sra Srta Sta Sto "
        "T.V.E Tel Ud Uds V.B V.E Vd Vds a/c adj admón afmo apdo av c c.f "
        "c.g cap cm cta dcha doc ej entlo esq etc f.c gr grs izq kg km mg mm "
        "nÃºm núm p p.a p.ej ptas pÃ¡g pÃ¡gs pág págs q.e.g.e q.e.s.m s s.s.s "
        "vid vol"),
    "de": (
        "A B C D E F G H I J K L M N O P Q R S T U V W X Y Z a b c d e f "
        "g h i j k l m n o p q r s t u v w x y z I II III IV V VI VII "
        "VIII IX X XI XII XIII XIV XV XVI XVII XVIII XIX XX i ii iii iv v "
        "vi vii viii ix x xi xii xiii xiv xv xvi xvii xviii xix xx Adj "
        "Adm Adv Asst Bart Bldg Brig Bros Capt Cmdr Col Comdr Con Corp "
        "Cpl DR Dr Ens Gen Gov Hon Hosp Insp Lt MM MR MRS MS Maj Messrs "
        "Mlle Mme Mr Mrs Ms Msgr Op Ord Pfc Ph Prof Pvt Rep Reps Res Rev "
        "Rt Sen Sens Sfc Sgt Sr St Supt Surg Mio Mrd bzw v vs usw d.h z.B "
        "u.a etc Mrd MwSt ggf d.J D.h m.E vgl I.F z.T sogen ff u.E g.U "
        "g.g.A c.-à-d Buchst u.s.w sog u.ä Std evtl Zt Chr u.U o.ä Ltd "
        "b.A z.Zt spp sen SA k.o jun i.H.v dgl dergl Co zzt usf s.p.a Dkr "
        "Corp bzgl BSE No Nos Art Nr pp ca Ca 1 2 3 4 5 6 7 8 9 10 11 12 "
        "13 14 15 16 17 18 19 20 21 22 23 24 25 26 27 28 29 30 31 32 33 "
        "34 35 36 37 38 39 40 41 42 43 44 45 46 47 48 49 50 51 52 53 54 "
        "55 56 57 58 59 60 61 62 63 64 65 66 67 68 69 70 71 72 73 74 75 "
        "76 77 78 79 80 81 82 83 84 85 86 87 88 89 90 91 92 93 94 95 96 "
        "97 98 99"),
}
_SCAN_END = 0x20000  # past every non-CJK letter and number


@functools.lru_cache(maxsize=None)
def _char_class(name: str) -> str:
    """The body of a regex character class (ranges) of ``IsAlpha``,
    ``IsAlnum`` or ``IsN``, over the code points below ``_SCAN_END``."""
    def member(ch: str) -> bool:
        cat = unicodedata.category(ch)
        if name == "IsN":
            return cat[0] == "N"
        return _is_alpha(ch) or (name == "IsAlnum" and cat == "Nd")

    ranges, start = [], None
    for code in range(_SCAN_END + 1):
        inside = code < _SCAN_END and member(chr(code))
        if inside and start is None:
            start = code
        elif not inside and start is not None:
            ranges.append((start, code - 1))
            start = None
    return "".join(re.escape(chr(a)) if a == b
                   else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in ranges)


@functools.lru_cache(maxsize=None)
def _tokenizer_rules():
    alpha, alnum, num = (_char_class(n) for n in ("IsAlpha", "IsAlnum", "IsN"))
    compile_ = re.compile
    return {
        "pad": (compile_(rf"([^{alnum}\s\.'\`\,\-])"), r" \1 "),
        "comma": [(compile_(rf"([^{num}])[,]"), r"\1 , "),
                  (compile_(rf"[,]([^{num}])"), r" , \1"),
                  (compile_(rf"([{num}])[,]$"), r"\1 , ")],
        "en": [(compile_(rf"([^{alpha}])[']([^{alpha}])"), r"\1 ' \2"),
               (compile_(rf"([^{alpha}{num}])[']([{alpha}])"), r"\1 ' \2"),
               (compile_(rf"([{alpha}])[']([^{alpha}])"), r"\1 ' \2"),
               (compile_(rf"([{alpha}])[']([{alpha}])"), r"\1 '\2"),
               (compile_(rf"([{num}])[']([s])"), r"\1 '\2")],
        "es": [(compile_(r"\'"), " ' ")],
        "de": [(compile_(r"\'"), " ' ")],
    }


_DEDUP_SPACE = re.compile(r"\s+")
_ASCII_JUNK = re.compile(r"[\000-\037]")
_TRAILING_DOT_APOSTROPHE = re.compile(r"\.' ?$")
_ESCAPE_XML = ((re.compile(r"&"), r"&amp;"), (re.compile(r"\|"), r"&#124;"),
               (re.compile(r"<"), r"&lt;"), (re.compile(r">"), r"&gt;"),
               (re.compile(r"\'"), r"&apos;"), (re.compile(r"\""), r"&quot;"),
               (re.compile(r"\["), r"&#91;"), (re.compile(r"]"), r"&#93;"))


class MosesTokenizer:
    """``sacremoses.MosesTokenizer(lang).tokenize(text)`` at its defaults
    (no aggressive dash splits, XML escaped, no protected patterns),
    returning the token list."""

    def __init__(self, lang: str = "en"):
        self.lang = _check_lang(lang)
        self.nonbreaking = [w.replace("+", " ")
                            for w in _NONBREAKING[lang].split()]
        self.numeric_only = [w.rpartition(" ")[0] for w in self.nonbreaking
                             if re.search(r"[\s]+(\#NUMERIC_ONLY\#)", w)]

    @staticmethod
    def _replace_multidots(text: str) -> str:
        text = re.sub(r"\.([\.]+)", r" DOTMULTI\1", text)
        while re.search(r"DOTMULTI\.", text):
            text = re.sub(r"DOTMULTI\.([^\.])", r"DOTDOTMULTI \1", text)
            text = re.sub(r"DOTMULTI\.", "DOTDOTMULTI", text)
        return text

    @staticmethod
    def _restore_multidots(text: str) -> str:
        while re.search(r"DOTDOTMULTI", text):
            text = re.sub(r"DOTDOTMULTI", r"DOTMULTI.", text)
        return re.sub(r"DOTMULTI", r".", text)

    def _nonbreaking_prefixes(self, text: str) -> str:
        tokens = text.split()
        n = len(tokens)
        for i, token in enumerate(tokens):
            m = re.search(r"^(\S+)\.$", token)
            if not m:
                continue
            prefix = m.group(1)
            if (("." in prefix and any(_is_alpha(c) for c in prefix))
                    or (prefix in self.nonbreaking
                        and prefix not in self.numeric_only)
                    or (i != n - 1 and tokens[i + 1]
                        and tokens[i + 1][0].islower())):
                continue
            if (prefix in self.numeric_only and i + 1 < n
                    and re.search(r"^[0-9]+", tokens[i + 1])):
                continue
            tokens[i] = prefix + " ."
        return " ".join(tokens)

    def tokenize(self, text: str) -> List[str]:
        rules = _tokenizer_rules()
        text = _DEDUP_SPACE.sub(" ", str(text))
        text = _ASCII_JUNK.sub("", text).strip()
        pattern, repl = rules["pad"]
        text = pattern.sub(repl, text)
        text = self._replace_multidots(text)
        for pattern, repl in rules["comma"]:
            text = pattern.sub(repl, text)
        for pattern, repl in rules[self.lang]:
            text = pattern.sub(repl, text)
        text = self._nonbreaking_prefixes(text)
        text = _DEDUP_SPACE.sub(" ", text).strip()
        text = _TRAILING_DOT_APOSTROPHE.sub(" . ' ", text)
        text = self._restore_multidots(text)
        for pattern, repl in _ESCAPE_XML:
            text = pattern.sub(repl, text)
        return text.split()
