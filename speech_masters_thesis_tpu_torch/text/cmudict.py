"""CMUdict pronunciation dictionary loader.

Reference: models/parser.py:8-67. The ARPAbet symbol inventory and its order
are a data-format contract (token ids depend on it) and must not change.

The port's copy of speech_masters_thesis_tpu/text/cmudict.py (pure Python).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

# 84 ARPAbet symbols, reference order (models/parser.py:19-25).
ARPABET_SYMBOLS = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1", "AH2",
    "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0", "ER1", "ER2",
    "EY", "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0", "IH1", "IH2",
    "IY", "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2", "P", "R", "S", "SH", "T",
    "TH", "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2", "V", "W", "Y", "Z", "ZH",
]

_ALT_ENTRY_RE = re.compile(r"\([0-9]+\)")


class CMUDict:
    """Word -> list of ARPAbet pronunciation strings."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        self.valid_symbols = list(ARPABET_SYMBOLS)
        self._valid_symbol_set = set(self.valid_symbols)
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = self._parse(f)
        else:
            entries = self._parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries: Dict[str, List[str]] = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        return self._entries.get(word.upper())

    def _parse(self, lines) -> Dict[str, List[str]]:
        entries: Dict[str, List[str]] = {}
        for line in lines:
            if not line:
                continue
            head = line[0]
            if not ("A" <= head <= "Z" or head == "'"):
                continue
            parts = line.split("  ")
            if len(parts) < 2:
                continue
            word = _ALT_ENTRY_RE.sub("", parts[0])
            phones = parts[1].strip().split(" ")
            if all(p in self._valid_symbol_set for p in phones):
                entries.setdefault(word, []).append(" ".join(phones))
        return entries
