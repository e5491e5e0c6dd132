"""The port's offline programs on the CPU: loading from a training log dir
(``inference.load_model_from_logdir``), ``GlowTTSSynthesizer`` and
``LMSampler`` from a log dir, and ``scripts/synthesize.py`` and
``scripts/sample_from_lm.py`` end to end with ``--platform cpu``.

* ``encode_text`` against the JAX method (inference.py:74), both called
  unbound on a stub that carries ``parser`` and ``config``, with the
  synthetic corpus's miniature CMUdict.
* The model loaded from a log dir equals the one saved there, bit for bit
  (the LM's frozen codec and codebook buffers included).
* Glow-TTS at tests/test_torch_glow.py's tiny width and weights (JAX's,
  converted): ``synthesize`` at noise scale 0 from the log dir gives JAX
  ``GlowTTS.infer``'s frame count and its mel within 1e-4 of max|ref|
  (``test_infer_matches_jax``'s bound), with no duration within 1e-5 of an
  integer, where ``ceil`` could round the two sides apart. The flow cache
  is built after the load: built on the freshly initialized weights, the
  mel would be another.
* ``LMSampler`` from the log dir draws the saved model's codes and audio at
  one seed.
"""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.inference import GlowTTSSynthesizer as JaxSynthesizer
from speech_masters_thesis_tpu.models.glow_tts.model import GlowTTS as JaxGlowTTS
from speech_masters_thesis_tpu.text import parser as jparser
from speech_masters_thesis_tpu.utils.config import Config as JaxConfig
from speech_masters_thesis_tpu.utils.config import load_config as jax_load_config
from speech_masters_thesis_tpu_torch import inference
from speech_masters_thesis_tpu_torch.inference import GlowTTSSynthesizer, LMSampler, load_model_from_logdir
from speech_masters_thesis_tpu_torch.scripts import sample_from_lm, synthesize
from speech_masters_thesis_tpu_torch.scripts import make_synth_dataset as synth
from speech_masters_thesis_tpu_torch.text import parser
from speech_masters_thesis_tpu_torch.train import checkpoint, harness, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState
from speech_masters_thesis_tpu_torch.utils.config import Config, setup_logdir
from test_torch_glow import jax_variables, port_model, tiny_config
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MAX_FRAMES = 256
TEXT = "Hello world"
TEXTS = [*synth.SENTENCES, TEXT, "  printing, hello!  ", "World?"]
LM_STEPS = 6


def _cmudict(root) -> str:
    path = root / "cmudict.dict"
    path.write_text("".join(f"{w}  {p}\n" for w, p in synth.WORDS.items()), encoding="utf-8")
    return str(path)


def _save_logdir(log_dir, config: dict, model) -> None:
    """``config.json`` and ``ckpt.last`` of ``model``, as the CLI writes them."""
    config = Config(copy.deepcopy(config)).merge({"train": {"log_dir": str(log_dir), "total_epochs": 1}})
    setup_logdir(config)
    opt, _ = optim.build_optimizer(model.parameters(), {"name": "sgd", "lr": 0.0})
    checkpoint.save_checkpoint(config, 0, -1, TrainState.create(model, opt))


@pytest.fixture(scope="module")
def glow(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline_glow")
    config = tiny_config()
    config["dataset"]["cmudict_path"] = _cmudict(root)
    jmodel = JaxGlowTTS(config=config)
    variables = jax_variables(jmodel)
    model = port_model(config, variables)
    _save_logdir(root / "glow", config, model)
    return {"root": root, "dir": str(root / "glow"), "config": config, "jmodel": jmodel, "variables": variables,
            "model": model}


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline_lm")
    codec = jax_load_config(os.path.join("tests", "fixtures", "vqvae_tiny.yaml")).to_dict()["model"]
    config = {"model": {"_import_": "models.transformer_lm.transformer_lm.TransformerLM", "fused_attention": True,
                        "vocab_size": codec["l_bins"], "embed_dim": 32, "max_len": 16, "num_layers": 2,
                        "d_model": 32, "nhead": 2, "dim_feedforward": 64, "dropout": 0.0, "activation": "relu",
                        "layer_norm_eps": 1e-5, "norm_first": False, "loss_type": "ce"},
              "vqvae_model_config": codec,
              "dataset": jax_load_config(os.path.join("tests", "fixtures", "ljspeech_tiny.yaml")).to_dict()["dataset"]}
    model = harness.get_model(config, device="cpu")
    harness.init_model_variables(model, None, 5)
    with torch.no_grad():
        model.vqvae_bottleneck.k.copy_(torch.randn(model.vqvae_bottleneck.k.shape, generator=torch.Generator().manual_seed(6)))
        model.vqvae_bottleneck.k_sum.copy_(model.vqvae_bottleneck.k)
        model.vqvae_bottleneck.initialized.fill_(True)
    _save_logdir(root / "lm", config, model)
    return {"root": root, "dir": str(root / "lm"), "model": model.eval()}


@pytest.mark.parametrize("blanks", [False, True])
def test_encode_text_matches_jax(tmp_path, blanks):
    path = _cmudict(tmp_path)
    ours = types.SimpleNamespace(parser=parser.CMUDictParser(path), config={"dataset": {"intersperse_blanks": blanks}})
    theirs = types.SimpleNamespace(parser=jparser.CMUDictParser(path),
                                   config=JaxConfig({"dataset": {"intersperse_blanks": blanks}}))
    for text in TEXTS:
        ids, jids = GlowTTSSynthesizer.encode_text(ours, text), JaxSynthesizer.encode_text(theirs, text)
        assert ids.dtype == jids.dtype == np.int32 and ids.tolist() == jids.tolist(), text


def _same_state(model, loaded) -> None:
    saved, got = model.state_dict(), loaded.state_dict()
    assert saved.keys() == got.keys() and all(torch.equal(v, got[k]) for k, v in saved.items())
    buffers = dict(loaded.named_buffers())
    assert all(torch.equal(v, buffers[k]) for k, v in model.named_buffers())
    assert not loaded.training


def test_logdir_models_equal_the_saved_ones(glow, lm):
    for fixture in (glow, lm):
        loaded, config = load_model_from_logdir(fixture["dir"], "last", device="cpu")
        _same_state(fixture["model"], loaded)
        assert config.train.log_dir == fixture["dir"]


def test_synthesize_from_the_logdir_matches_jax_infer(glow):
    synth_ = GlowTTSSynthesizer(glow["dir"], "last", max_frames=MAX_FRAMES, device="cpu")
    assert synth_.model.decoder.flows[2].start.folded_weight is not None  # the flow cache is built
    ids = synth_.encode_text(TEXT)
    tokens, lens = jnp.asarray(ids[None]), jnp.asarray([len(ids)], jnp.int32)
    jmodel, variables = glow["jmodel"], glow["variables"]
    _, _, logw, _ = jmodel.apply(variables, tokens, lens, train=False,
                                 method=lambda m, *a, **k: m.encoder(*a, **k))
    durations = np.exp(np.asarray(logw))[0, :len(ids)]
    assert np.abs(durations - np.round(durations)).min() > 1e-5
    jmel, jz = jmodel.apply(variables, tokens, lens, jax.random.PRNGKey(0), max_frames=MAX_FRAMES, noise_scale=0.0,
                            method=JaxGlowTTS.infer)
    ref = np.asarray(jmel)[0, :int(jz[0])]
    mel, audio = synth_.synthesize(TEXT, seed=4, noise_scale=0.0, invert_audio=False)
    assert audio is None and mel.shape == ref.shape and mel.shape[0] > 0
    assert np.abs(mel - ref).max() <= 1e-4 * np.abs(ref).max()
    # the model-taking constructor on the loaded model: the same mel, bit for bit
    same, _ = GlowTTSSynthesizer(synth_.model, synth_.config, max_frames=MAX_FRAMES).synthesize(
        TEXT, seed=9, noise_scale=0.0, invert_audio=False)
    assert np.array_equal(same, mel)


def test_lm_sampler_from_the_logdir_draws_the_saved_models_codes(lm):
    audio, codes = LMSampler(lm["dir"], "last", device="cpu").sample(2, LM_STEPS, seed=3)
    want_audio, want_codes = lm["model"].sample(2, LM_STEPS, torch.Generator().manual_seed(3))
    assert np.array_equal(codes, want_codes.numpy()) and np.array_equal(audio, want_audio.numpy())
    assert codes.shape == (2, LM_STEPS) and audio.shape == (2, LM_STEPS * 128)


@pytest.mark.parametrize("vocoder", ["device", "host"])
def test_synthesize_script_writes_a_wav(glow, vocoder):
    out = glow["root"] / f"synthesis_{vocoder}.wav"
    result = synthesize.main(["--log_dir", glow["dir"], "--ckpt_num", "last", "--platform", "cpu", "--text", TEXT,
                              "--max_frames", str(MAX_FRAMES), "--gl_iters", "2", "--vocoder", vocoder,
                              "--out", str(out)])
    hop = glow["config"]["dataset"]["hop_length"]
    assert os.path.exists(out) and result["out"] == str(out) and result["frames"] > 0
    assert result["mel"].shape == (min(result["frames"], MAX_FRAMES), glow["config"]["dataset"]["n_mels"])
    assert result["audio"].shape[0] >= result["mel"].shape[0] * hop - 2 * hop
    assert np.isfinite(result["audio"]).all() and result["rtf"] > 0


def test_sample_from_lm_script_writes_its_files(lm):
    save = lm["root"] / "samples"
    result = sample_from_lm.main(["--log_dir", lm["dir"], "--ckpt_num", "last", "--platform", "cpu",
                                  "--n_samples", "2", "--n_steps", str(LM_STEPS), "--seed", "3",
                                  "--save_path", str(save)])
    _, want = LMSampler(lm["dir"], "last", device="cpu").sample(2, LM_STEPS, seed=3)
    assert np.array_equal(result["codes"], want)
    for name in ("sample_0.wav", "sample_1.wav", "tokens.txt", "samples_mel.npy"):
        assert os.path.exists(save / name), name
    with open(save / "tokens.txt", encoding="utf-8") as f:
        assert [list(map(int, line.split())) for line in f] == want.tolist()
    grid = np.load(save / "samples_mel.npy")
    assert grid.shape[:3] == (2, 2, 80) and np.array_equal(grid[0], grid[1])


def test_offline_scripts_want_the_card_unless_asked_for_the_cpu(glow, lm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthesize.main(["--log_dir", glow["dir"], "--ckpt_num", "last"])
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_from_lm.main(["--log_dir", lm["dir"], "--ckpt_num", "last"])
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.LMSampler(lm["dir"], "last")
