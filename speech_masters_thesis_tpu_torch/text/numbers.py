"""Number-to-words normalization (self-contained; no `inflect` dependency).

Covers the subset of `inflect.engine()` the reference text cleaners exercise
(reference models/parser.py:145-181): cardinal words with an optional
``andword``, two-digit grouping for years, "oh" zeros, and ordinals.

The port's copy of speech_masters_thesis_tpu/text/numbers.py (pure Python).
"""

from __future__ import annotations

import re

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int, zero: str = "zero") -> str:
    if n == 0:
        return zero
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    return _TENS[tens] + ("-" + _UNITS[unit] if unit else "")


def _three_digits(n: int, andword: str = "") -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_UNITS[hundreds] + " hundred")
    if rest:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n, andword: str = "and", zero: str = "zero", group: int = 0) -> str:
    """Spells out an integer (or an ordinal string like '23rd').

    group=2 reads the digit string two digits at a time, joined by ", "
    (inflect's year style): 1999 -> "nineteen, ninety-nine".
    """
    if isinstance(n, str):
        m = re.fullmatch(r"(\d+)(st|nd|rd|th)", n.strip(), flags=re.IGNORECASE)
        if m:
            return ordinal_words(int(m.group(1)))
        n = int(n.strip())
    n = int(n)
    if n < 0:
        return "minus " + number_to_words(-n, andword=andword, zero=zero, group=group)

    if group == 2:
        digits = str(n)
        if len(digits) % 2 == 1:
            chunks = [digits[0]] + [digits[i:i + 2] for i in range(1, len(digits), 2)]
        else:
            chunks = [digits[i:i + 2] for i in range(0, len(digits), 2)]
        words = []
        for chunk in chunks:
            value = int(chunk)
            if len(chunk) == 2 and chunk[0] == "0" and value != 0:
                words.append(f"{zero} {_UNITS[value]}")
            elif value == 0:
                words.append(zero if len(chunk) == 1 else f"{zero} {zero}")
            else:
                words.append(_two_digits(value, zero=zero))
        return ", ".join(words)

    if n == 0:
        return zero
    parts = []
    remainder = n
    for scale_value, scale_name in _SCALES:
        count, remainder = divmod(remainder, scale_value)
        if count:
            parts.append(f"{_three_digits(count, andword='')} {scale_name}")
    if remainder:
        parts.append(_three_digits(remainder, andword=andword))
    return ", ".join(parts)


def ordinal_words(n: int) -> str:
    cardinal = number_to_words(n, andword="")
    head, sep, last = cardinal.rpartition(" ")
    prefix = head + sep
    if "-" in last:
        tens, _, unit = last.rpartition("-")
        prefix, last = prefix + tens + "-", unit
    if last in _ORDINAL_SPECIAL:
        return prefix + _ORDINAL_SPECIAL[last]
    if last.endswith("y"):
        return prefix + last[:-1] + "ieth"
    return prefix + last + "th"
