"""Text -> phoneme-id frontend.

Behavioral rebuild of the reference ``CMUDictParser``
(reference models/parser.py:70-323). The symbol table layout is a data
contract shared with reference checkpoints and datasets:

    [pad '_'] + ['-'] + list("!'(),.:;? ") + [A-Za-z] + ['@'+ARPAbet x84]

for 148 symbols total (reference configs set encoder.n_vocab: 148); blank
tokens used by ``intersperse_blanks`` get id == len(symbols).

The port's copy of speech_masters_thesis_tpu/text/parser.py (pure Python).
"""

from __future__ import annotations

import re
from typing import List, Optional

from speech_masters_thesis_tpu_torch.text.cleaners import CLEANERS
from speech_masters_thesis_tpu_torch.text.cmudict import CMUDict

_PAD = "_"
_SPECIAL = "-"
_PUNCTUATION = "!'(),.:;? "
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

_CURLY_RE = re.compile(r"(.*?)\{(.+?)\}(.*)")
_WORD_RE = re.compile(r"[\w']+|[.,!?;]")


class CMUDictParser:
    """Callable mapping text to a list of symbol ids, with ARPAbet lookups."""

    def __init__(self, cmu_dict_path: Optional[str] = None):
        self.cmu_dict = CMUDict(cmu_dict_path) if cmu_dict_path else None

        self.symbols = [_PAD] + list(_SPECIAL) + list(_PUNCTUATION) + list(_LETTERS)
        if self.cmu_dict:
            self.symbols = self.symbols + ["@" + s for s in self.cmu_dict.valid_symbols]

        self._symbol_to_id = {s: i for i, s in enumerate(self.symbols)}
        self._id_to_symbol = {i: s for i, s in enumerate(self.symbols)}

    def __call__(self, text: str) -> List[int]:
        return self.text_to_sequence(text, ["english_cleaners"], self.cmu_dict)

    # -- encoding ------------------------------------------------------------
    def text_to_sequence(self, text: str, cleaner_names: List[str], dictionary=None) -> List[int]:
        """Text (optionally with {ARPAbet} spans) -> list of symbol ids.

        Words found in the dictionary are replaced by their first ARPAbet
        pronunciation; words are joined by the space symbol, and a trailing
        space is stripped (reference parser.py:228-268).
        """
        sequence: List[int] = []
        space = self._symbols_to_sequence(" ")
        while text:
            m = _CURLY_RE.match(text)
            if not m:
                clean_text = self._clean(text, cleaner_names)
                if dictionary is not None:
                    for word in _WORD_RE.findall(clean_text):
                        pronunciations = dictionary.lookup(word)
                        if pronunciations:
                            sequence += self._arpabet_to_sequence(pronunciations[0])
                        else:
                            sequence += self._symbols_to_sequence(word)
                        sequence += space
                else:
                    sequence += self._symbols_to_sequence(clean_text)
                break
            sequence += self._symbols_to_sequence(self._clean(m.group(1), cleaner_names))
            sequence += self._arpabet_to_sequence(m.group(2))
            text = m.group(3)

        if dictionary is not None and sequence and sequence[-1] == space[0]:
            sequence = sequence[:-1]
        return sequence

    def sequence_to_text(self, sequence: List[int]) -> str:
        result = ""
        for symbol_id in sequence:
            if symbol_id in self._id_to_symbol:
                s = self._id_to_symbol[symbol_id]
                if len(s) > 1 and s[0] == "@":
                    s = "{%s}" % s[1:]
                result += s
        return result.replace("}{", " ")

    # -- helpers ---------------------------------------------------------------
    def _clean(self, text: str, cleaner_names: List[str]) -> str:
        for name in cleaner_names:
            cleaner = CLEANERS.get(name)
            if cleaner is None:
                raise ValueError(f"Unknown cleaner: {name}")
            text = cleaner(text)
        return text

    def _symbols_to_sequence(self, symbols) -> List[int]:
        return [self._symbol_to_id[s] for s in symbols if s in self._symbol_to_id and s != _PAD and s != "~"]

    def _arpabet_to_sequence(self, text: str) -> List[int]:
        return self._symbols_to_sequence(["@" + s for s in text.split()])


def intersperse_blanks(token_ids: List[int], blank_id: int) -> List[int]:
    """[t0, t1] -> [blank, t0, blank, t1, blank] (reference ljspeech.py:100-103)."""
    out = [blank_id] * (len(token_ids) * 2 + 1)
    out[1::2] = token_ids
    return out
