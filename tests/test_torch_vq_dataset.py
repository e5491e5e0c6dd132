"""The port's tokenizer (scripts/generate_vq_dataset.py) against the JAX
package, on the CPU at tests/fixtures/vqvae_tiny.yaml's width.

A port checkpoint (seeded parameters, the codebook initialized from a
batch) and its ``config.json`` are tokenized with ``--platform cpu``. Its
codes equal, bit for bit, the JAX ``VQVAE.encode`` of the same audio, with
the checkpoint's weights carried to JAX by
``tools/import_torch_checkpoint.import_vqvae`` (both fp32; each clip alone,
which the encoder's masks make equal to the padded batch's valid frames).
Each pickle's audio is the JAX loader's clip; both packages' ``VQLatent``
read the pickles into equal items; ``metadata.json`` holds the bytes the JAX
script writes for that config; the sanity wav and the token histogram, which
``--no-sanity`` leaves out.
"""

import json
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.data.ljspeech import LJSpeech as JaxLJSpeech
from speech_masters_thesis_tpu.data.vqlatent import VQLatent as JaxVQLatent
from speech_masters_thesis_tpu.models.vqvae.model import VQVAE as JaxVQVAE
from speech_masters_thesis_tpu.models.vqvae.model import compression_factor as jax_compression_factor
from speech_masters_thesis_tpu.ops.basic import sequence_mask
from speech_masters_thesis_tpu.train import harness as jharness
from speech_masters_thesis_tpu.utils.config import Config as JaxConfig
from speech_masters_thesis_tpu.utils.config import load_config as jax_load_config
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.data.vqlatent import VQLatent
from speech_masters_thesis_tpu_torch.scripts import generate_vq_dataset
from speech_masters_thesis_tpu_torch.scripts.make_synth_dataset import write_corpus
from speech_masters_thesis_tpu_torch.train import checkpoint, harness
from speech_masters_thesis_tpu_torch.train.optim import build_optimizer
from speech_masters_thesis_tpu_torch.train.state import TrainState
from speech_masters_thesis_tpu_torch.utils.config import Config, setup_logdir
from tools.import_torch_checkpoint import import_vqvae

SEED = 9


@pytest.fixture(scope="module")
def tokenized(tmp_path_factory):
    root = tmp_path_factory.mktemp("vqds")
    write_corpus(str(root / "LJ"), str(root / "cmudict.dict"), n=13, min_sec=0.3, max_sec=0.7, seed=SEED)
    model_cfg = jax_load_config("tests/fixtures/vqvae_tiny.yaml").to_dict()
    dataset = jax_load_config("tests/fixtures/ljspeech_tiny.yaml").to_dict()
    dataset["dataset"].update(dataset_path=str(root / "LJ"), cmudict_path=str(root / "cmudict.dict"))
    config = Config(model_cfg).merge(dataset, {"train": {"log_dir": str(root / "vqvae"), "seed": SEED,
                                                         "batch_size": 2, "num_workers": 0, "total_epochs": 1}})
    setup_logdir(config)
    model = harness.get_model(config, device="cpu")
    rng = np.random.RandomState(SEED)
    harness.init_model_variables(model, {"audio": torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 4096)).astype(np.float32)),
                                         "audio_len": torch.tensor([4096, 3000])}, SEED)
    state = TrainState.create(model, build_optimizer(model.parameters(), config.optimizer)[0])
    checkpoint.save_checkpoint(config, 7, 0, state)
    out = root / "VQ-Latent"
    metadata = generate_vq_dataset.main(["--log_dir", str(root / "vqvae"), "--ckpt_num", "7", "--save_path",
                                         str(out), "--platform", "cpu", "--batch_size", "3",
                                         "--bucket_multiple", "4096"])
    return {"root": root, "out": out, "config": config, "metadata": metadata,
            "state_dict": {k: v.numpy() for k, v in model.state_dict().items()}}


def _pickles(out, split):
    items = []
    for name in sorted(os.listdir(out / split)):
        with open(out / split / name, "rb") as f:
            items.append(pickle.load(f))
    return items


def test_pickles_hold_the_loader_clips_and_their_codes(tokenized):
    jconfig = JaxConfig(tokenized["config"].to_dict())
    jconfig.dataset.update(segment_length=-1, use_token=False, use_spect=False, use_audio=True)
    factor = tokenized["metadata"]["compression_factor"]
    for split, n in (("train", 3), ("val", 10)):
        names = sorted(os.listdir(tokenized["out"] / split))
        assert names == [f"{split}_{i:06d}.pkl" for i in range(n)]
        data = JaxLJSpeech(jconfig, split)
        for i, item in enumerate(_pickles(tokenized["out"], split)):
            assert list(item) == ["x", "q"] and item["x"].dtype == np.float32
            assert np.array_equal(item["x"], data[i]["audio"])
            assert len(item["q"]) == len(item["x"]) // factor and all(type(q) is int for q in item["q"])


def test_codes_equal_the_jax_encode_bit_for_bit(tokenized):
    jconfig = JaxConfig(tokenized["config"].to_dict())
    jmodel = jharness.get_model(jconfig)
    assert isinstance(jmodel, JaxVQVAE)
    variables = jax.tree.map(jnp.asarray, import_vqvae(tokenized["state_dict"], jconfig))

    @jax.jit
    def encode(x):
        mask = sequence_mask(jnp.asarray([x.shape[-1]]), x.shape[-1])
        return jmodel.apply(variables, x, mask, method=JaxVQVAE.encode)[0]

    frames = 0
    for split in ("train", "val"):
        for item in _pickles(tokenized["out"], split):
            codes = np.asarray(encode(jnp.asarray(item["x"][None])))[0]
            assert codes.tolist() == item["q"]
            frames += len(item["q"])
    assert frames > 100 and len({q for s in ("train", "val") for i in _pickles(tokenized["out"], s) for q in i["q"]}) > 3


@pytest.mark.parametrize("segment_length", [-1, 4])
def test_both_vqlatents_read_the_pickles_alike(tokenized, segment_length):
    d = dict(configs.VQLATENT, dataset_path=str(tokenized["out"]), segment_length=segment_length)
    cfg = {"dataset": d, "model": {"vocab_size": tokenized["metadata"]["vocab_size"]}}
    for split in ("train", "val"):
        ours, theirs = VQLatent(cfg, split), JaxVQLatent(JaxConfig(cfg), split)
        assert len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            random.seed(i)
            a = ours[i]
            random.seed(i)
            b = theirs[i]
            assert a.keys() == b.keys()
            for key, value in b.items():
                if isinstance(value, np.ndarray):
                    assert a[key].dtype == value.dtype and np.array_equal(a[key], value), key
                else:
                    assert a[key] == value, key


def test_metadata_is_the_jax_scripts(tokenized):
    jconfig = JaxConfig(tokenized["config"].to_dict())
    expected = {"compression_factor": jax_compression_factor(jconfig), "vocab_size": int(jconfig.model.l_bins)}
    assert (tokenized["out"] / "metadata.json").read_text(encoding="utf-8") == json.dumps(expected)
    assert tokenized["metadata"] == expected == {"compression_factor": 128, "vocab_size": 32}


def test_sanity_wav_and_token_histogram(tokenized):
    out = tokenized["out"]
    histogram = np.load(out / "token_histogram.npy")
    codes = [q for s in ("train", "val") for item in _pickles(out, s) for q in item["q"]]
    assert histogram.shape == (32,) and histogram.sum() == len(codes)
    assert np.array_equal(histogram, np.bincount(codes, minlength=32))
    assert os.path.getsize(out / "sanity.wav") > 44


def test_no_sanity_writes_the_same_pickles_and_no_sanity_files(tokenized):
    out = tokenized["root"] / "VQ-Latent-no-sanity"
    generate_vq_dataset.main(["--log_dir", str(tokenized["root"] / "vqvae"), "--ckpt_num", "7", "--save_path",
                              str(out), "--platform", "cpu", "--batch_size", "3", "--bucket_multiple", "4096",
                              "--no-sanity"])
    assert sorted(os.listdir(out)) == ["metadata.json", "train", "val"]
    for split in ("train", "val"):
        for a, b in zip(_pickles(out, split), _pickles(tokenized["out"], split), strict=True):
            assert a["q"] == b["q"] and np.array_equal(a["x"], b["x"])
