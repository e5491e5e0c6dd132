"""Text cleaning pipeline for the TTS frontend.

Behavioral rebuild of the reference cleaners
(reference models/parser.py:156-219): ASCII transliteration, lowercasing,
number/currency/ordinal expansion, abbreviation replacement, whitespace
collapsing. ASCII folding is done with NFKD decomposition plus a small
Latin fold table instead of the `unidecode` package.

The port's copy of speech_masters_thesis_tpu/text/cleaners.py (pure Python).
"""

from __future__ import annotations

import re
import unicodedata

from speech_masters_thesis_tpu_torch.text.numbers import number_to_words, ordinal_words

_LATIN_FOLD = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ß": "ss",
    "ø": "o", "Ø": "O", "đ": "d", "Đ": "D", "þ": "th", "Þ": "Th",
    "ð": "d", "Ð": "D", "ł": "l", "Ł": "L", "’": "'", "‘": "'",
    "“": '"', "”": '"', "—": "-", "–": "-", "…": "...",
}

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expansion) for abbr, expansion in [
        ("mrs", "missus"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

_REPLACEMENTS = [
    (re.compile(rf"\b{pattern}\b", re.IGNORECASE), expansion) for pattern, expansion in [
        ("_", "underscore"),
        ("src", "source"),
        ("dll", "d l l"),
        ("btw", "by the way"),
        ("http", "h t t p"),
        ("www", "w w w"),
        (r"c\+\+", "c plus plus"),
    ]
]

_COMMA_NUMBER_RE = re.compile(r"([0-9][0-9,]+[0-9])")
_DECIMAL_RE = re.compile(r"([0-9]+\.[0-9]+)")
_POUNDS_RE = re.compile(r"£([0-9,]*[0-9]+)")
_DOLLARS_RE = re.compile(r"\$([0-9.,]*[0-9]+)")
_ORDINAL_RE = re.compile(r"[0-9]+(st|nd|rd|th)")
_NUMBER_RE = re.compile(r"[0-9]+")
_WHITESPACE_RE = re.compile(r"\s+")


def convert_to_ascii(text: str) -> str:
    text = "".join(_LATIN_FOLD.get(ch, ch) for ch in text)
    decomposed = unicodedata.normalize("NFKD", text)
    return decomposed.encode("ascii", "ignore").decode("ascii")


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_WHITESPACE_RE, " ", text)


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    # Year-style reading for 1001-2999 (reference parser.py:159-171).
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return f"two thousand {number_to_words(num % 100, andword='')}"
        if num % 100 == 0:
            return f"{number_to_words(num // 100, andword='')} hundred"
        return number_to_words(num, andword="", zero="oh", group=2).replace(", ", " ")
    return number_to_words(num, andword="")


def expand_numbers(text: str) -> str:
    text = re.sub(_COMMA_NUMBER_RE, lambda m: m.group(1).replace(",", ""), text)
    text = re.sub(_POUNDS_RE, r"\1 pounds", text)
    text = re.sub(_DOLLARS_RE, _expand_dollars, text)
    text = re.sub(_DECIMAL_RE, lambda m: m.group(1).replace(".", " point "), text)
    text = re.sub(_ORDINAL_RE, lambda m: ordinal_words(int(_NUMBER_RE.match(m.group(0)).group(0))), text)
    text = " ".join(re.split(r"(\d+)", text))
    text = re.sub(_NUMBER_RE, _expand_number, text)
    return text


def replace_abbreviations(text: str) -> str:
    for regex, expansion in _ABBREVIATIONS:
        text = re.sub(regex, expansion, text)
    for regex, expansion in _REPLACEMENTS:
        text = re.sub(regex, expansion, text)
    return text


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = replace_abbreviations(text)
    text = collapse_whitespace(text)
    return text


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}
