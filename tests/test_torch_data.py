"""The port's data path against the JAX package's, on the CPU.

One synthetic corpus (the port's scripts/make_synth_dataset.py, 14 clips of
0.3-0.8 s) read by both packages with equal ``random`` seeds: ``load_wav``
(the JAX package's scipy path, and its native reader), LJSpeech items and
collated batches through both DataLoaders (shuffled, two epochs, segment
crops; in order with the partial batch), ``get_dataloaders``, and VQLatent
on seeded pickles (crops, consecutive-duplicate removal, padding). Audio,
tokens, lengths and pad values must be equal bit for bit; the host log-mel
(the port's MelSpectrogram on CPU tensors against JAX's on its CPU backend)
within 1e-3 absolute (fp32, another FFT).
"""

import copy
import json
import os
import pickle
import random

import numpy as np
import pytest

from speech_masters_thesis_tpu import native
from speech_masters_thesis_tpu.data import batching as jbatching
from speech_masters_thesis_tpu.data.ljspeech import LJSpeech as JaxLJSpeech
from speech_masters_thesis_tpu.data.vqlatent import VQLatent as JaxVQLatent
from speech_masters_thesis_tpu.ops import stft as jstft
from speech_masters_thesis_tpu.train import harness as jharness
from speech_masters_thesis_tpu.utils import audio_io as jaudio_io
from speech_masters_thesis_tpu.utils.config import Config as JaxConfig
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.data import batching
from speech_masters_thesis_tpu_torch.data.ljspeech import LJSpeech
from speech_masters_thesis_tpu_torch.data.vqlatent import VQLatent
from speech_masters_thesis_tpu_torch.ops import stft
from speech_masters_thesis_tpu_torch.scripts.make_synth_dataset import write_corpus
from speech_masters_thesis_tpu_torch.train import harness
from speech_masters_thesis_tpu_torch.utils import audio_io
from speech_masters_thesis_tpu_torch.utils.config import Config

MEL_ATOL = 1e-3
KEYS = ("token", "token_len", "spect", "spect_len", "audio", "audio_len", "speaker")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    write_corpus(str(root / "LJ"), str(root / "cmudict.dict"), n=14, min_sec=0.3, max_sec=0.8, seed=3)
    return str(root / "LJ"), str(root / "cmudict.dict")


def _config(corpus, segment_length=-1, **dataset):
    path, cmudict = corpus
    d = dict(configs.LJSPEECH, dataset_path=path, cmudict_path=cmudict, segment_length=segment_length, **dataset)
    return {"dataset": d, "model": {}, "train": {"batch_size": 3, "seed": 7, "num_workers": 0}}


def _items(ds, seed):
    random.seed(seed)
    return [ds[i] for i in range(len(ds))]


def _items_or_errors(ds, seed):
    random.seed(seed)
    out = []
    for i in range(len(ds)):
        try:
            out.append(ds[i])
        except ValueError as e:
            out.append(e)
    return out


def _same_item(ours, theirs):
    for key in ("token", "audio", "speaker"):
        if theirs[key] is None:
            assert ours[key] is None, key
        else:
            assert ours[key].dtype == theirs[key].dtype and np.array_equal(ours[key], theirs[key]), key
    if theirs["spect"] is None:
        assert ours["spect"] is None
    else:
        assert ours["spect"].shape == theirs["spect"].shape
        np.testing.assert_allclose(ours["spect"], theirs["spect"], rtol=0, atol=MEL_ATOL)


def _same_batch(ours, theirs):
    assert set(ours) == set(theirs) == set(KEYS)
    for key in KEYS:
        if theirs[key] is None:
            assert ours[key] is None, key
        elif key == "spect":
            assert ours[key].shape == theirs[key].shape and ours[key].dtype == theirs[key].dtype
            np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=MEL_ATOL)
            pad = theirs[key] == jbatching.MEL_PAD
            assert np.array_equal(ours[key][pad], theirs[key][pad])  # the pad value bit for bit
        else:
            assert ours[key].dtype == theirs[key].dtype and np.array_equal(ours[key], theirs[key]), key


@pytest.mark.parametrize("native_reader", [False, True])
def test_load_wav_equals_jax(corpus, monkeypatch, native_reader):
    if not native_reader:
        monkeypatch.setattr(native, "read_wav", lambda path: None)  # the JAX package's scipy path
    wavs = sorted(os.listdir(os.path.join(corpus[0], "wavs")))
    for name in wavs[:5]:
        path = os.path.join(corpus[0], "wavs", name)
        for sr in (22050, 16000):
            ours, theirs = audio_io.load_wav(path, sr), jaudio_io.load_wav(path, sr)
            assert ours.dtype == theirs.dtype == np.float32 and np.array_equal(ours, theirs)


def test_save_wav_writes_the_jax_bytes(tmp_path):
    audio = np.random.RandomState(0).uniform(-1.2, 1.2, 777).astype(np.float32)
    audio_io.save_wav(str(tmp_path / "a.wav"), audio, 16000)
    jaudio_io.save_wav(str(tmp_path / "b.wav"), audio, 16000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


def test_host_mel_matches_jax():
    audio = np.random.RandomState(1).uniform(-0.5, 0.5, 9000).astype(np.float32)
    args = (22050, 1024, 256, 1024, 80, 0.0, 8000.0)
    ours = stft.host_mel(stft.cached_mel(*args), audio)
    theirs = jstft.host_mel(jstft.cached_mel(*args), audio)
    assert ours.shape == theirs.shape == (1, (9000 + 768 - 1024) // 256 + 1, 80) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=MEL_ATOL)
    assert stft.cached_mel(*args) is stft.cached_mel(*args)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("segment_length", [-1, 4096])
def test_ljspeech_items_match_jax(corpus, split, segment_length):
    cfg = _config(corpus, segment_length)
    ours, theirs = LJSpeech(cfg, split), JaxLJSpeech(JaxConfig(cfg), split)
    assert len(ours) == len(theirs) == (10 if split == "val" else 4)
    for a, b in zip(_items(ours, 5), _items(theirs, 5)):
        _same_item(a, b)
        assert len(a["audio"]) % 512 == 0 and (segment_length < 0 or len(a["audio"]) <= segment_length)
    assert ours._token_cache.keys() == theirs._token_cache.keys()


def test_ljspeech_elides_features_like_jax(corpus):
    cfg = _config(corpus, use_token=False, use_spect=False)
    ours, theirs = LJSpeech(cfg, "val"), JaxLJSpeech(JaxConfig(cfg), "val")
    for a, b in zip(_items(ours, 1), _items(theirs, 1)):
        assert a["token"] is None and a["spect"] is None
        _same_item(a, b)
    with pytest.raises(ValueError):
        LJSpeech(cfg, "test")


@pytest.mark.parametrize("num_workers,segment_length", [(0, 4096), (2, -1)])
def test_loaders_match_jax_over_two_epochs(corpus, num_workers, segment_length):
    """Shuffled from seed + epoch, wrap-padded, crops drawn in the JAX order.
    With prefetch threads the crops' draws from ``random`` interleave as the
    threads run (in both packages), so the threaded case reads whole clips."""
    cfg = _config(corpus, segment_length)
    cfg["train"]["num_workers"] = num_workers
    ours = harness.get_dataloaders(cfg)
    theirs = jharness.get_dataloaders(JaxConfig(cfg))
    for loader, jloader in zip(ours, theirs):
        assert len(loader) == len(jloader)
        for _ in range(2):
            random.seed(11)
            port_batches = list(loader)
            random.seed(11)
            jax_batches = list(jloader)
            assert len(port_batches) == len(jax_batches)
            for a, b in zip(port_batches, jax_batches):
                _same_batch(a, b)
    train, val = ours
    assert train.shuffle and train.pad_last and not val.shuffle and not val.pad_last
    assert [b["audio"].shape[0] for b in list(val)] == [3, 3, 3, 1]  # the partial batch kept


def test_collate_buckets_pads_and_lengths_match_jax():
    rng = np.random.RandomState(2)
    items = [{"token": rng.randint(1, 9, n).astype(np.int32), "spect": rng.randn(f, 80).astype(np.float32),
              "audio": rng.randn(a).astype(np.float32), "speaker": None, "token_len": n - 1 if n > 5 else None}
             for n, f, a in ((5, 17, 5000), (40, 3, 100), (33, 16, 4096))]
    ours, theirs = batching.collate(copy.deepcopy(items)), jbatching.collate(copy.deepcopy(items))
    _same_batch(ours, theirs)
    assert ours["token"].shape == (3, 64) and ours["spect"].shape == (3, 32, 80) and ours["audio"].shape == (3, 8192)
    assert list(ours["token_len"]) == [5, 39, 32] and ours["spect"][1, 5, 0] == np.float32(batching.MEL_PAD)
    kwargs = {"audio_multiple": 65536, "token_multiple": 8}
    _same_batch(batching.collate(items, **kwargs), jbatching.collate(items, **kwargs))


def test_loader_reshuffles_and_wraps_epochs_like_jax():
    """Each pass reshuffles from seed + epoch and wraps its short batch to
    the epoch head, as the JAX loader does."""
    data = list(range(11))
    ours = batching.DataLoader(data, 4, shuffle=True, seed=3)
    theirs = jbatching.DataLoader(data, 4, shuffle=True, seed=3)
    ours._make_batch = theirs._make_batch = lambda idxs: list(idxs)
    passes = []
    for _ in range(3):
        batches = [list(b) for b in ours]
        assert batches == [list(b) for b in theirs]
        assert [len(b) for b in batches] == [4, 4, 4] and sorted(sum(batches, [])[:11]) == data
        passes.append(batches)
    assert passes[0] != passes[1] != passes[2]
    assert ours.epoch == theirs.epoch == 3 and len(ours) == len(theirs) == 3


@pytest.fixture(scope="module")
def vq_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("vqlatent")
    rng = np.random.RandomState(4)
    for split, n in (("train", 5), ("val", 3)):
        os.makedirs(root / split)
        for i in range(n):
            q = rng.randint(0, 6, rng.randint(3, 40)).tolist()
            item = {"x": rng.randn(len(q) * 128).astype(np.float32), "q": q}
            if i % 2:
                item["speaker"] = i
            with open(root / split / f"{split}_{i:06d}.pkl", "wb") as f:
                pickle.dump(item, f)
    (root / "metadata.json").write_text(json.dumps({"compression_factor": 128, "vocab_size": 6}))
    return str(root)


@pytest.mark.parametrize("segment_length", [-1, 16])
@pytest.mark.parametrize("remove_consecutive", [False, True])
@pytest.mark.parametrize("use_spect", [False, True])
def test_vqlatent_items_match_jax(vq_corpus, segment_length, remove_consecutive, use_spect):
    d = dict(configs.VQLATENT, dataset_path=vq_corpus, segment_length=segment_length,
             remove_consecutive=remove_consecutive, use_spect=use_spect)
    cfg = {"dataset": d, "model": {"vocab_size": 6}}
    for split in ("train", "val"):
        ours, theirs = VQLatent(cfg, split), JaxVQLatent(JaxConfig(cfg), split)
        assert ours.pkl_files == theirs.pkl_files == sorted(ours.pkl_files)
        items, jitems = _items_or_errors(ours, 9), _items_or_errors(theirs, 9)
        for a, b in zip(items, jitems):
            if isinstance(b, Exception):
                # de-duplicated codes that fit the segment leave the audio uncropped, longer than
                # its padding target: both packages raise there (the reference's quirk)
                assert type(a) is type(b) and remove_consecutive and segment_length > 0
                continue
            assert a.keys() == b.keys()
            for key in ("token_len", "spect_len", "audio_len"):
                assert a[key] == b[key], key
            _same_item(a, b)
            assert a["token"][0] == VQLatent.BOS
        items = [a for a in items if not isinstance(a, Exception)]
        jitems = [b for b in jitems if not isinstance(b, Exception)]
        if items:
            _same_batch(batching.collate(items), jbatching.collate(jitems))
    with pytest.raises(AssertionError):
        VQLatent({"dataset": d, "model": {"vocab_size": 7}}, "train")


def test_get_dataloaders_resolves_vqlatent_by_config(vq_corpus):
    cfg = Config({"dataset": dict(configs.VQLATENT, dataset_path=vq_corpus), "model": {"vocab_size": 6},
                  "train": {"batch_size": 2, "seed": 0}})
    train, val = harness.get_dataloaders(cfg)
    assert isinstance(train.dataset, VQLatent) and len(train) == 3 and len(val) == 2
