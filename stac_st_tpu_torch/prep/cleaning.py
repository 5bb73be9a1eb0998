"""Text cleaning for conversational speech corpora — exact-behavior port
(copy of ``stac_st_tpu/prep/cleaning.py``).

The reference preps share one cleaning pipeline with four per-corpus
profiles (``fisher_callhome_prepare.py:501-735``, ``callhome_prepare.py:
482-734``, ``mslt_prepare.py:560-695``, ``common_voice_prepare.py:464-690``).
This module reproduces their *behavior exactly* — every substitution, in the
reference order, including the quirks that shape the released manifests:

- ``normalize_punctuation`` applies ~90 ordered rules: bracketed-span
  removal, apostrophe normalization, bare event words (``noise`` is removed
  as a *substring*, so ``background noise`` → ``background ``), then three
  corpus-specific slash/annotation tables (fisher train/dev/dev2/test), then
  per-character noisy-punctuation → space, lone ``.``/``?`` sentences
  dropped, whitespace collapsed.
- ``remove_punctuation`` protects ``<space>`` and ``'`` with sentinel words
  before stripping ``string.punctuation``.
- ``clean_transcription`` protects LDC markup (``</ < >`` — plus
  ``[[ [ { ]] ] }`` for CALLHOME-family corpora) with sentinel words
  through punctuation stripping, folds ``Á Í Ó Ú`` (not ``É`` — faithful),
  removes or spaces out ``¨ · ´ ¿ ¡`` per profile, folds ``N → n`` per
  profile, lowercases, then strips event labels.
- ``remove_labels``'s reference gate ``if is_match is not True`` compares a
  Match object to ``True`` and therefore ALWAYS runs the ``[noise]`` /
  ``[laughter]`` strip — reproduced (the released manifests depend on it).

Profile deltas (vs fisher): CALLHOME adds bracket/brace sentinels and a
leading strip-everything-``<...>`` rule in ``remove_labels``; MSLT keeps
apostrophes in transcriptions (``'`` removed from the punct class), maps the
stray marks to a space instead of deleting, and re-strips ``¿ ¡`` after
label removal; CommonVoice is MSLT without the ``N → n`` fold, and runs
``normalize_punctuation`` *before* ``clean_transcription`` (MSLT runs it
after).

Full-pipeline helpers mirror the reference call chains, including the
Moses punctuation-normalizer/tokenizer stages
(``fisher_callhome_prepare.py:366-367,439-446``), which the JAX package
runs through sacremoses and the port through its own copies
(:mod:`..utils.moses`, :mod:`..utils.detokenize`).
"""

from __future__ import annotations

import re
import string
import unicodedata
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Tuple

from ..utils.detokenize import MosesDetokenizer
from ..utils.moses import MosesPunctNormalizer, MosesTokenizer

__all__ = [
    "CleaningProfile", "FISHER", "CALLHOME", "MSLT", "COMMONVOICE",
    "clean_transcription", "clean_translation", "normalize_punctuation",
    "remove_punctuation", "remove_labels", "finalize_transcription",
    "process_translation", "mslt_clean_transcript", "cv_clean_transcript",
    "strip_accents",
]


@dataclass(frozen=True)
class CleaningProfile:
    """Per-corpus switches for :func:`clean_transcription` /
    :func:`remove_labels`."""

    name: str
    #: also sentinel-protect ``[[ [ {`` / ``]] ] }`` (CALLHOME tags)
    callhome_brackets: bool
    #: ``'`` participates in the transcription punctuation strip
    strip_apostrophe: bool
    #: what ``¨ · ´ ¿ ¡`` become ("" fisher/callhome, " " mslt/cv)
    stray_replacement: str
    #: fold ``N`` → ``n`` before lowercasing
    fold_upper_n: bool
    #: remove_labels leads with a strip-everything ``<...>`` rule
    strip_all_angle_labels: bool
    #: re-strip ``¿ ¡`` → " " after remove_labels
    inverted_after_labels: bool


FISHER = CleaningProfile("fisher", False, True, "", True, False, False)
CALLHOME = CleaningProfile("callhome", True, True, "", True, True, False)
MSLT = CleaningProfile("mslt", True, False, " ", True, True, True)
COMMONVOICE = CleaningProfile("commonvoice", True, False, " ", False, True, True)


# ---------------------------------------------------------------------------
# normalize_punctuation — one ordered rule table shared by all four preps
# (identical across the reference files; order is load-bearing, e.g. the
# corpus-specific ``i/he`` → ``i`` rules must precede the generic ``/`` →
# space rule, and bare ``noise`` removal precedes ``background noise``).
# ---------------------------------------------------------------------------

_NORM_RULES_SRC: Tuple[Tuple[str, str], ...] = (
    # bracketed spans (with content)
    (r"\([^)]*\)", " "),
    (r"\[[^]]+\]", " "),
    # punctuation normalization
    (r"_", ""),
    (r"`", "'"),
    (r"´", "'"),
    (r"\¨", "'"),
    # bare event words (substring semantics — faithful)
    (r"noise", ""),
    (r"laughter", ""),
    (r"background noise", ""),
    (r"background speech", ""),
    # fisher_train table
    (r"i\/he", "i"),
    (r"i\/she", "i"),
    (r" \/\?", "\\?"),
    (r" \/ ", " "),
    (r"a\/c", ""),
    (r"stay\/", "stay"),
    (r"boys\/", "boys"),
    (r"right\/", "right"),
    (r"follow\/", "follow"),
    (r"Jose\/Josefina", "Jose"),
    (r"welfare\/foreign", "welfare"),
    (r"\<foreign lang=\"English\"", ""),
    (r"\/foreign/", ""),
    (r"\<plural\>", ""),
    (r"\<barely makes any sense\>", ""),
    (r"\<kind of a weird phrase\>", ""),
    (r"\<last word does not fit there\>", ""),
    (r"\<players with the meaning of singers\>", ""),
    (r"\<this phrase barely made any sense whatsoever\>", ""),
    (r"\<colorcito does not exist as a word so I have no ideea what he "
     r"means about that\>", ""),
    (r"\<foreign", ""),
    (r"foreign\>", ""),
    # fisher_dev table
    (r"her\/his", "her"),
    (r"o\/", "o"),
    (r"co\/", "co"),
    (r"L \/ ", ""),
    (r"\<\?\?\?\>", ""),
    (r"\<from Texas\>", ""),
    (r"\<weird phrase\>", ""),
    (r"\<this makes no sense\>", ""),
    (r"Salvador\>", "Salvador"),
    # fisher_dev2 table
    (r"A\/C", ""),
    (r"She\/he", "She"),
    (r"you\/he", "you"),
    (r"you\/she", "you"),
    (r"Um\/", "Um"),
    (r"name\/", "name"),
    (r"American\/", "American"),
    (r"\<\?\>", ""),
    (r"\<metaphoric meaning\>", ""),
    (r"\<missing text \? \>", ""),
    (r"\<broken phrase but I tried to guess what would it mean if it was "
     r"complete\>", ""),
    # fisher_test table
    (r"she\/he", "she"),
    (r"her\/him", "her"),
    (r"is\/", "is"),
    (r"and\/or", "and"),
    (r"Then\/Well", "Then"),
    (r"fine\/well", "fine"),
    (r"Likewise\/Equally", "Likewise"),
    (r"boyfriend\/girlfriend", "boyfriend"),
    (r"living room \/ dining room", "living room"),
    (r"\<very bad phrase\>", ""),
    (r"\<poorly written phrase\>", ""),
    (r"\<this phrase barely even made sense\>", ""),
    (r"\<very poorly written phrase but I think this is what was supposed "
     r"to mean\>", ""),
    (r"what\)\)", "what"),
    # leftover noisy punctuation characters → space
    (r"\(", " "),
    (r"\)", " "),
    (r"\<", " "),
    (r"\>", " "),
    (r"\[", " "),
    (r"\]", " "),
    (r"\{", " "),
    (r"\}", " "),
    (r"\\", " "),
    (r"\/", " "),
    (r"\;", " "),
    (r"~", " "),
    (r"=", " "),
    (r"\·", " "),
    # lone period / question-mark sentences
    (r"^\.\s*$", ""),
    (r"^\?\s*$", ""),
    # whitespace collapse + edge trim
    (r"\s+", " "),
    (r"^\s+", ""),
    (r"\s+$", ""),
)

_NORM_RULES = tuple((re.compile(p), r) for p, r in _NORM_RULES_SRC)


def normalize_punctuation(text: str) -> str:
    """Shared annotation/slash/punctuation normalization
    (ref ``fisher_callhome_prepare.py:523-645``)."""
    for pattern, repl in _NORM_RULES:
        text = pattern.sub(repl, text)
    return text.lstrip()


# ---------------------------------------------------------------------------
# remove_punctuation — sentinel-protected string.punctuation strip
# ---------------------------------------------------------------------------

_PUNCT_CLASS = re.compile(r"[{}]".format(string.punctuation))
_WS = re.compile(r"\s+")


def remove_punctuation(text: str) -> str:
    """Strip ``string.punctuation`` keeping ``'`` and the literal token
    ``<space>`` (ref ``:501-520``)."""
    text = text.replace("<space>", "spacemark")
    text = text.replace("'", "apostrophe")
    text = _PUNCT_CLASS.sub("", text)
    text = text.replace("spacemark", "<space>")
    text = text.replace("apostrophe", "'")
    text = _WS.sub(" ", text)
    return text.strip(" \t\n\r\f\v")


# ---------------------------------------------------------------------------
# remove_labels — LDC event-label table (applied to lowercased text)
# ---------------------------------------------------------------------------

_LABEL_RULES_SRC: Tuple[Tuple[str, str], ...] = (
    (r"<\s*[/]*\s*\s*for[ei][ei]g[nh]\s*\w*>", ""),
    # (the <lname>(...)</lname> capture is handled in code below)
    (r"<lname[\/]*>", ""),
    (r"<laugh>", ""),
    (r"<\/laugh>", ""),
    (r"<\s*cough[\/]*>", "[noise]"),
    (r"<sneeze[\/]*>", "[noise]"),
    (r"<breath[\/]*>", "[noise]"),
    (r"<lipsmack[\/]*>", "[noise]"),
    (r"<background>", ""),
    (r"<\/background>", ""),
    (r"<[/]?background[/]?>", "[noise]"),
    (r"<laugh>", ""),
    (r"<\/laugh>", ""),
    (r"<[/]?laugh[/]?>", "[laughter]"),
    (r"<foreign langenglishhip hop", ""),
    (r"<foreign langenglishonline", ""),
    (r"<foreign langenglish", ""),
    (r"</foreign", ""),
    (r"<[/]?foreing\s*\w*>", ""),
    (r"</b", ""),
    (r"<foreign langengullís>", ""),
    (r"foreign>", ""),
    (r">", ""),
)

_LABEL_RULES_HEAD = (re.compile(_LABEL_RULES_SRC[0][0]), _LABEL_RULES_SRC[0][1])
_LABEL_RULES_TAIL = tuple((re.compile(p), r) for p, r in _LABEL_RULES_SRC[1:])
_STRIP_ALL_ANGLE = re.compile(r"\<[^<>]*\>")
_LNAME_SPAN = re.compile(r"<lname>\([^<]*\)<\/lname>")
_BRACKET_NOISE = re.compile(r"\[noise\]")
_BRACKET_LAUGHTER = re.compile(r"\[laughter\]")
_EDGE_WS = re.compile(r"^\s\s*|\s\s*$")
_LEAD_WS = re.compile(r"^\s\s*")


def remove_labels(text: str, profile: CleaningProfile = FISHER) -> str:
    """Strip ``<laugh>``-style event labels (ref ``:695-735``; CALLHOME
    variant leads with a remove-everything-``<...>`` rule,
    ``callhome_prepare.py:683-687``)."""
    if profile.strip_all_angle_labels:
        text = _STRIP_ALL_ANGLE.sub("", text)
    pattern, repl = _LABEL_RULES_HEAD
    text = pattern.sub(repl, text)
    spans = _LNAME_SPAN.findall(text)
    if spans:
        text = spans[0]
    for pattern, repl in _LABEL_RULES_TAIL:
        text = pattern.sub(repl, text)
    # Reference gate `if is_match is not True` is always true (re.search
    # returns a Match/None, never True) — so this block always runs.
    text = _BRACKET_NOISE.sub("", text)
    text = _BRACKET_LAUGHTER.sub("", text)
    text = _EDGE_WS.sub("", text)
    text = _LEAD_WS.sub(" ", text)
    return text


# ---------------------------------------------------------------------------
# clean_transcription / clean_translation
# ---------------------------------------------------------------------------

# punctuation classes with and without the apostrophe
_PUNCT_WITH_APOS = re.compile(r"[{}]".format(string.punctuation))
_PUNCT_NO_APOS = re.compile(r"[{}]".format(string.punctuation).replace("'", ""))

_SENTINELS_IN = (("</", "lendarrow"), ("<", "larrow"), (">", "rarrow"))
_CALLHOME_SENTINELS_IN = (
    ("[[", "larrow"), ("[", "larrow"), ("{", "larrow"),
    ("]]", "rarrow"), ("]", "rarrow"), ("}", "rarrow"),
)
_SENTINELS_OUT = (("larrow", "<"), ("rarrow", ">"), ("lendarrow", "</"))
_ACCENT_FOLDS = (("Á", "á"), ("Í", "í"), ("Ó", "ó"), ("Ú", "ú"))
_STRAY_MARKS = ("¨", "·", "´", "¿", "¡")


def clean_transcription(text: str, profile: CleaningProfile = FISHER) -> str:
    """LDC transcript cleaning (ref ``:648-681``; CALLHOME/MSLT/CV variants
    per profile). Markup survives the punctuation strip via sentinel words,
    ``Á Í Ó Ú`` fold to lowercase (``É`` faithfully does not), stray marks
    are removed/spaced, text is lowercased, labels stripped."""
    for src, dst in _SENTINELS_IN:
        text = text.replace(src, dst)
    if profile.callhome_brackets:
        for src, dst in _CALLHOME_SENTINELS_IN:
            text = text.replace(src, dst)
    punct = _PUNCT_WITH_APOS if profile.strip_apostrophe else _PUNCT_NO_APOS
    text = punct.sub("", text)
    for src, dst in _SENTINELS_OUT:
        text = text.replace(src, dst)
    for src, dst in _ACCENT_FOLDS:
        text = text.replace(src, dst)
    for mark in _STRAY_MARKS:
        text = text.replace(mark, profile.stray_replacement)
    if profile.fold_upper_n:
        text = text.replace("N", "n")
    text = text.lower()
    text = remove_labels(text, profile)
    if profile.inverted_after_labels:
        text = text.replace("¿", " ")
        text = text.replace("¡", " ")
    return text


def clean_translation(text: str) -> str:
    """Translation-side cleaning (ref ``:684-692``): strip, lowercase,
    drop inverted punctuation."""
    text = text.strip()
    text = text.lower()
    text = text.replace("¿", "")
    text = text.replace("¡", "")
    return text


# ---------------------------------------------------------------------------
# Moses stages + full pipelines (ref call chains)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _moses_normalizer(lang: str):
    return MosesPunctNormalizer(lang=lang)


@lru_cache(maxsize=None)
def _moses_tokenizer(lang: str):
    return MosesTokenizer(lang=lang)


def finalize_transcription(text: str, lang: str = "es") -> str:
    """Post-mapping transcription finish: ``normalize_punctuation`` then
    Moses punctuation normalization (ref ``:366-367``)."""
    text = normalize_punctuation(text)
    return _moses_normalizer(lang).normalize(text)


def process_translation(text: str, lang: str = "en") -> str:
    """Full translation chain (ref ``get_translations_from_path:429-448``):
    clean → normalize_punctuation → Moses normalize → remove_punctuation →
    Moses tokenize → space-join."""
    text = clean_translation(text)
    text = normalize_punctuation(text)
    text = _moses_normalizer(lang).normalize(text)
    text = remove_punctuation(text)
    tokens: List[str] = _moses_tokenizer(lang).tokenize(text)
    return " ".join(tokens)


def mslt_clean_transcript(text: str, lang: str) -> str:
    """MSLT transcript chain (ref ``mslt_prepare.py:442-457``):
    clean_transcription(MSLT) → normalize_punctuation → Moses normalize →
    remove_punctuation → Moses tokenize → join."""
    text = clean_transcription(text, MSLT)
    text = normalize_punctuation(text)
    text = _moses_normalizer(lang).normalize(text)
    text = remove_punctuation(text)
    return " ".join(_moses_tokenizer(lang).tokenize(text))


def cv_clean_transcript(text: str, lang: str) -> str:
    """CommonVoice transcript chain (ref ``common_voice_prepare.py:447-461``
    — note normalize_punctuation runs BEFORE clean_transcription there):
    normalize_punctuation → clean_transcription(CV) → Moses normalize →
    remove_punctuation → Moses tokenize → join."""
    text = normalize_punctuation(text)
    text = clean_transcription(text, COMMONVOICE)
    text = _moses_normalizer(lang).normalize(text)
    text = remove_punctuation(text)
    return " ".join(_moses_tokenizer(lang).tokenize(text))


def covost_clean_transcript(text: str, lang: str) -> str:
    """CoVoST2 translation chain (ref ``convert_covost_splits_to_json.py:
    107-120``): CV order (normalize_punctuation first) with the MSLT
    transcription profile (keeps the ``N → n`` fold), then Moses normalize →
    remove_punctuation → Moses tokenize → join."""
    text = normalize_punctuation(text)
    text = clean_transcription(text, MSLT)
    text = _moses_normalizer(lang).normalize(text)
    text = remove_punctuation(text)
    return " ".join(_moses_tokenizer(lang).tokenize(text))


def covost_clean_all(text: str, lang: str, accented_letters: bool = True):
    """Full CoVoST2 per-row cleaning (ref ``:372-427``): chain + accent
    handling + ≥3-words gate (None ≙ reference ``continue``). The reference
    CLI default keeps accents (``--keep-accents`` True)."""
    words = covost_clean_transcript(str(text), lang)
    words = _finish_clean_all(words, lang, accented_letters)
    if words is not None and lang not in ["ja", "ch"]:
        if len(words.split(" ")) < 3:
            return None
    return words


def strip_accents(text: str) -> str:
    """ASCII-fold accents (ref ``common_voice_prepare.py:442-444``)."""
    return unicodedata.normalize("NFD", text).encode(
        "ascii", "ignore"
    ).decode("utf-8")


def _finish_clean_all(words: str, lang: str, accented_letters: bool):
    """Shared tail of the reference clean_all_transcript functions:
    accent strip, whitespace collapse, too-short gate (None ≙ ref False)."""
    if not accented_letters:
        words = strip_accents(words)
        words = words.replace("'", " ")
        words = words.replace("’", " ")
    words = re.sub(" +", " ", words)
    words = words.lstrip().rstrip()
    if lang in ["ja", "ch"]:
        chars = " ".join(words.replace(" ", "_"))
        if len(chars) < 3:
            return None
    return words


def mslt_clean_all(lines, lang: str, accented_letters: bool = True):
    """MSLT clean_all_transcript (ref ``mslt_prepare.py:334-374``): join
    lines, full transcript chain, accent handling, length gate (< 2 words →
    None; the reference returns False)."""
    words = " ".join(i.strip() for i in lines)
    words = mslt_clean_transcript(words, lang)
    words = _finish_clean_all(words, lang, accented_letters)
    if words is not None and lang not in ["ja", "ch"]:
        if len(words.split(" ")) < 2:
            return None
    return words


def whisper_clean_output(text: str) -> str:
    """Whisper-baseline hypothesis cleanup (ref ``eval_whisper.py:53-77``):
    normalize_punctuation → clean_transcription (CV order, MSLT profile —
    the file keeps the ``N → n`` fold) → Moses en normalize →
    remove_punctuation → collapse/strip."""
    words = str(text)
    words = normalize_punctuation(words)
    words = clean_transcription(words, MSLT)
    words = _moses_normalizer("en").normalize(words)
    words = remove_punctuation(words)
    words = re.sub(" +", " ", words)
    return words.lstrip().rstrip()


def remove_special_turn_tokens(text: str) -> str:
    """Strip ``[turn]`` / ``[xt]`` markers (ref ``eval_whisper.py``
    remove_special_tokens)."""
    specials = ["[turn]", "[xt]"]
    text = re.sub(" +", " ", text)
    text = " ".join(w for w in text.split(" ") if w not in specials)
    return re.sub(" +", " ", text)


def moses_detokenize(text: str, lang: str = "en") -> str:
    """Moses detokenization of a space-tokenized string."""
    return MosesDetokenizer(lang=lang).detokenize(text.strip().split(" "))


def cv_clean_all(text: str, lang: str, accented_letters: bool = False):
    """CommonVoice per-row cleaning (ref ``common_voice_prepare.py:289-322``):
    full transcript chain, accent handling, length gate (< 3 words → None)."""
    words = cv_clean_transcript(str(text), lang)
    words = _finish_clean_all(words, lang, accented_letters)
    if words is not None and lang not in ["ja", "ch"]:
        if len(words.split(" ")) < 3:
            return None
    return words
