"""The port's text frontend against the JAX package's: the same ids for the
synthetic corpus's sentences with its miniature cmudict and for
tests/test_text.py's cases (cleaners, numbers, ordinals, the symbol table,
ARPAbet and curly spans, the cmudict parser, blank interspersal)."""

import io

import pytest

from scripts import make_synth_dataset as jsynth
from speech_masters_thesis_tpu.text import cleaners as jcleaners
from speech_masters_thesis_tpu.text import cmudict as jcmudict
from speech_masters_thesis_tpu.text import numbers as jnumbers
from speech_masters_thesis_tpu.text import parser as jparser
from speech_masters_thesis_tpu_torch.scripts import make_synth_dataset as synth
from speech_masters_thesis_tpu_torch.text import cleaners, cmudict, numbers, parser

FAKE_CMUDICT = """\
HELLO  HH AH0 L OW1
WORLD  W ER1 L D
WORLD(1)  W ER1 L D D
PRINTING  P R IH1 N T IH0 NG
;;; comment line
BADPHONE  QQ ZZ
"""

TEXTS = [
    "Dr. Smith bought 2 apples.", "in 1876,", "$1.50", "It cost $5", "the 3rd time", "Mt.  Vesuvius  erupted",
    "café naïve", "Hello world.", "zzz hello", "Printing, in the only sense with which we are at present concerned",
    "On the 21st of March 1999, £3 and $1,000,000 went 1st.", "Mrs. and Mr. Jones, Capt. Smith & co.",
]


def _cmudict_file(tmp_path, words):
    path = tmp_path / "cmudict.dict"
    path.write_text("".join(f"{w}  {p}\n" for w, p in words.items()), encoding="utf-8")
    return str(path)


def test_synth_sentences_and_dictionary_match_the_jax_corpus_writer():
    assert synth.SENTENCES == jsynth.SENTENCES and synth.WORDS == jsynth.WORDS


@pytest.mark.parametrize("blanks", [False, True])
def test_synth_sentences_give_the_jax_ids(tmp_path, blanks):
    path = _cmudict_file(tmp_path, synth.WORDS)
    ours, theirs = parser.CMUDictParser(path), jparser.CMUDictParser(path)
    assert ours.symbols == theirs.symbols and len(ours.symbols) == 148
    for text in synth.SENTENCES:
        ids, jids = ours(text), theirs(text)
        if blanks:
            ids = parser.intersperse_blanks(ids, len(ours.symbols))
            jids = jparser.intersperse_blanks(jids, len(theirs.symbols))
        assert ids == jids and len(ids) > 0
        assert ours.sequence_to_text(ids) == theirs.sequence_to_text(jids)


@pytest.mark.parametrize("text", TEXTS)
def test_cleaners_and_parser_match_jax(text):
    assert cleaners.english_cleaners(text) == jcleaners.english_cleaners(text)
    ours, theirs = parser.CMUDictParser(), jparser.CMUDictParser()
    for p, module in ((ours, cmudict), (theirs, jcmudict)):
        p.cmu_dict = module.CMUDict(io.StringIO(FAKE_CMUDICT))
        p.symbols = p.symbols + ["@" + s for s in p.cmu_dict.valid_symbols]
        p._symbol_to_id = {s: i for i, s in enumerate(p.symbols)}
        p._id_to_symbol = dict(enumerate(p.symbols))
    assert ours(text) == theirs(text)
    curly = f"Turn {{HH AW1 S}} {text}"
    assert (ours.text_to_sequence(curly, ["english_cleaners"], ours.cmu_dict)
            == theirs.text_to_sequence(curly, ["english_cleaners"], theirs.cmu_dict))


def test_numbers_match_jax():
    for n in list(range(0, 130)) + [999, 1000, 1234, 1999, 2015, 10 ** 6, 123456789]:
        for kwargs in ({}, {"andword": ""}, {"andword": "", "zero": "oh", "group": 2}):
            assert numbers.number_to_words(n, **kwargs) == jnumbers.number_to_words(n, **kwargs), (n, kwargs)
        if n:
            assert numbers.ordinal_words(n) == jnumbers.ordinal_words(n)


def test_cmudict_and_symbols_match_jax():
    ours, theirs = cmudict.CMUDict(io.StringIO(FAKE_CMUDICT)), jcmudict.CMUDict(io.StringIO(FAKE_CMUDICT))
    assert cmudict.ARPABET_SYMBOLS == jcmudict.ARPABET_SYMBOLS and len(ours) == len(theirs) == 3
    for word in ("hello", "WORLD", "badphone", "printing", "nothing"):
        assert ours.lookup(word) == theirs.lookup(word)
    assert parser.intersperse_blanks([5, 9], 148) == jparser.intersperse_blanks([5, 9], 148) == [148, 5, 148, 9, 148]
