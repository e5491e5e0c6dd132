"""The PyTorch port as a package: no jax anywhere in it, configs, registry."""

import os
import subprocess
import sys

import pytest

from speech_masters_thesis_tpu.utils.config import load_config
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.models.vqtts.model import VQTTS
from speech_masters_thesis_tpu_torch.models.vqvae.blocks import GatedHiFiBlock, ResNetBlock, get_block
from speech_masters_thesis_tpu_torch.models.vqvae.model import VQVAE, compression_factor
from speech_masters_thesis_tpu_torch.utils.registry import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import speech_masters_thesis_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert "speech_masters_thesis_tpu" not in sys.modules
print(" ".join(names))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 61  # every module was imported
    for module in ("models.ema", "models.base", "train.harness", "train.loop", "train.optim",
                   "train.state", "ops.attention", "ops.hash", "models.transformer_lm.model",
                   "models.glow_tts.model", "ops.wn_coupling", "ops.enc_layer", "ops.mas",
                   "ops.griffin_lim", "inference", "models.vqtts.model", "models.vqtts.bottleneck",
                   "text.numbers", "text.cleaners", "text.cmudict", "text.parser", "data.batching",
                   "data.ljspeech", "data.vqlatent", "utils.audio_io", "utils.config", "utils.scalars",
                   "train.checkpoint", "train.artifacts", "scripts.train", "scripts.generate_vq_dataset",
                   "scripts.make_synth_dataset"):
        assert f"speech_masters_thesis_tpu_torch.{module}" in names, module


def test_config_dict_equals_yaml():
    assert configs.VQVAE_TPU == load_config(
        os.path.join(REPO, "configs/models/vqvae_tpu.yaml")).to_dict()["model"]


@pytest.mark.parametrize("kind", ["models", "datasets"])
def test_cli_name_tables_equal_the_yaml_files(kind):
    """configs.MODELS / configs.DATASETS: each name is a YAML stem under
    configs/ and holds that file's sections, key for key."""
    table = configs.MODELS if kind == "models" else configs.DATASETS
    assert set(table) == ({"vqvae_tpu", "transformer_lm_tpu", "glow_tts_tpu", "vqtts_tpu"} if kind == "models"
                          else {"ljspeech", "ljspeech_tpu", "vqlatent"})
    for name, sections in table.items():
        assert sections == load_config(os.path.join(REPO, "configs", kind, f"{name}.yaml")).to_dict(), name


def test_optimizer_config_equals_yaml():
    cfg = load_config(os.path.join(REPO, "configs/models/vqvae_tpu.yaml")).to_dict()
    assert configs.VQVAE_TPU_OPTIMIZER == cfg["optimizer"]
    assert cfg["scheduler"] is None


@pytest.mark.parametrize("name", ["models.vqvae.vqvae.VQVAE", "vqvae"])
def test_get_model_resolves_vqvae(name):
    cfg = {**configs.VQVAE_TPU, "_import_": name}
    model = get_model(cfg, device="cpu")
    assert isinstance(model, VQVAE)
    assert compression_factor(cfg) == 128
    blocks = [m for m in model.modules() if isinstance(m, GatedHiFiBlock)]
    assert len(blocks) == 14  # 7 in the encoder, 7 in the decoder
    assert {b.dilations for b in blocks} == {(1, 3, 9, 27)}
    assert "bottleneck.level_blocks.0.k" in model.state_dict()
    assert not any(k.endswith(("k_sum", "k_elem")) for k in model.state_dict())


@pytest.mark.parametrize("name", ["models.vqtts.vqtts.VQTTS", "vqtts"])
def test_get_model_resolves_vqtts(name):
    """VQ-TTS at vqtts_tpu width: a depth-3 codec (8 GatedHiFi blocks each
    way), the grouped codebook of 149 x 512 codes, the ``base`` quant
    decoder; ``get_block("base")`` is ``ResNetBlock``."""
    cfg = {**configs.VQTTS_TPU, "_import_": name}
    model = get_model(cfg, device="cpu", dataset_config=configs.LJSPEECH_TPU)
    assert isinstance(model, VQTTS)
    assert compression_factor(cfg) == 256
    blocks = [m for m in model.modules() if isinstance(m, GatedHiFiBlock)]
    assert len(blocks) == 16 and {b.dilations for b in blocks} == {(1, 3, 9)}
    assert get_block("base") is ResNetBlock and isinstance(model.quant_decoder, ResNetBlock)
    assert tuple(model.state_dict()["quant_bottleneck.k"].shape) == (149 * 512, 128)
    assert not any(k.endswith(("k_sum", "k_elem")) for k in model.state_dict())


def test_registry_and_blocks_reject_what_is_not_ported():
    with pytest.raises(KeyError):
        get_model({**configs.VQVAE_TPU, "_import_": "models.nonexistent.Model"}, device="cpu")
    for block_type in ("wavenet", "hifi"):
        with pytest.raises(NotImplementedError):
            get_block(block_type)
    with pytest.raises(NotImplementedError):  # the codec's blocks stay gated_hifi
        get_model({**configs.VQVAE_TPU, "block_type": "base"}, device="cpu")
    with pytest.raises(ValueError):
        get_block("nonexistent")
