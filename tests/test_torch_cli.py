"""The port's training CLI (scripts/train.py), run in process with
``--platform cpu`` at the tiny fixture widths, on a seeded synthetic corpus.

* The VQ-VAE CLI writes ``config.json`` (the merged config), ``ckpt.{N,last}``,
  ``scalars.jsonl`` under the JAX CLI's tags and the val artifacts.
* Its first logged train loss against the JAX CLI's first step: JAX's
  ``init_model_variables`` draws the variables (codebook not initialized),
  ``convert.vqvae_state_dict_from_jax`` carries them into a port checkpoint
  that the CLI loads with ``--load_ckpt``, and the JAX ``make_train_step``
  runs on the JAX ``get_dataloaders``' first batch (equal ``random`` and
  ``np.random`` seeds). Dropout is 0 in both. The codebook's lazy init runs
  inside that first step on both sides, from the step's train-mode
  encodings; its draw is made deterministic in both (the first valid rows,
  cycled, no noise: the two packages' random streams differ by design), so
  the initialized and EMA-updated codebook can be compared too. fp32, other
  summation orders: the loss and the codebook within rtol 1e-4.
* The Glow-TTS CLI runs DDI, saves ``ckpt.0`` and starts the EMA from the
  DDI'd parameters; the LM CLI grafts a port codec through its
  ``config.json`` and ``ckpt.<n>``; each flag for what the port lacks
  raises; without ``--platform cpu`` the run wants the card; Ctrl-C lets
  the running step end and ``ckpt.last`` records the steps taken.
* ``mas_log_prior`` on bf16 statistics and fp32 frames (the bf16 step's
  flows on a mel computed from audio) against the JAX package's, which
  promotes at its products.
"""

import json
import os
import random
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.vqvae import bottleneck as jbottleneck
from speech_masters_thesis_tpu.ops import mas as jmas
from speech_masters_thesis_tpu.train import harness as jharness
from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.train import optim as joptim
from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
from speech_masters_thesis_tpu.utils.config import Config as JaxConfig
from speech_masters_thesis_tpu.utils.config import load_config as jax_load_config
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.convert import codebook_from_jax, vqvae_state_dict_from_jax
from speech_masters_thesis_tpu_torch.models.ema import default_mu
from speech_masters_thesis_tpu_torch.models.vqvae import bottleneck
from speech_masters_thesis_tpu_torch.ops.mas import mas_log_prior
from speech_masters_thesis_tpu_torch.scripts import generate_vq_dataset
from speech_masters_thesis_tpu_torch.scripts import train as train_cli
from speech_masters_thesis_tpu_torch.scripts.make_synth_dataset import write_corpus
from speech_masters_thesis_tpu_torch.train import checkpoint, harness
from speech_masters_thesis_tpu_torch.train.optim import build_optimizer
from speech_masters_thesis_tpu_torch.train.state import TrainState
from speech_masters_thesis_tpu_torch.utils.config import Config, load_config
from speech_masters_thesis_tpu_torch.utils.scalars import read_scalars

SEED = 3
LOSS_RTOL = 1e-4
CODEBOOK_RTOL = 1e-4


def _fixture(name):
    return jax_load_config(os.path.join("tests", "fixtures", name)).to_dict()


def _write_json(path, data):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_corpus(str(root / "LJ"), str(root / "cmudict.dict"), n=14, min_sec=0.3, max_sec=0.6, seed=SEED)
    dataset = _fixture("ljspeech_tiny.yaml")
    dataset["dataset"].update(dataset_path=str(root / "LJ"), cmudict_path=str(root / "cmudict.dict"))
    vq = _fixture("vqvae_tiny.yaml")
    vq["model"]["p_dropout"] = 0.0
    return {"root": root, "lj": _write_json(root / "lj.json", dataset), "vq": _write_json(root / "vq.json", vq),
            "glow": _write_json(root / "glow.json", _fixture("glow_tts_tiny.yaml"))}


def _argv(files, model, log_dir, *extra):
    return ["--model", model, "--dataset", files["lj"], "--log_dir", str(log_dir), "--batch_size", "2",
            "--seed", str(SEED), "--platform", "cpu", "--num_workers", "0", *extra]


@pytest.fixture(scope="module")
def codec_run(files):
    log_dir = files["root"] / "vqvae"
    state = train_cli.main(_argv(files, files["vq"], log_dir, "--total_epochs", "2", "--ckpt_every_n_steps", "2",
                                 "--log_every_n_steps", "1", "--eval_every_n_epochs", "1", "--ema"))
    return log_dir, state


def test_vqvae_cli_writes_its_log_dir(files, codec_run):
    log_dir, state = codec_run
    assert sorted(os.listdir(log_dir / "ckpts")) == ["ckpt.2", "ckpt.4", "ckpt.last"] and state.step == 4
    config = load_config(str(log_dir / "config.json"))
    assert config.model == _fixture("vqvae_tiny.yaml")["model"] | {"p_dropout": 0.0}
    assert config.dataset.segment_length == 4096 and config.train.batch_size == 2 and config.train.ema
    rows = read_scalars(str(log_dir))
    tags = {r["tag"] for r in rows}
    assert {"loss/train_loss", "loss/train_loss_stft", "metrics/train_fit", "metrics/train_usage",
            "loss/val_loss", "loss/val_loss_commit"} <= tags
    assert sorted({r["step"] for r in rows if r["tag"] == "loss/train_loss"}) == [1, 2, 3, 4]
    assert sorted({r["step"] for r in rows if r["tag"] == "loss/val_loss"}) == [1, 2]  # the epoch
    assert all(np.isfinite(r["value"]) for r in rows)
    for epoch in (1, 2):
        for side in ("gt", "pred"):
            assert os.path.getsize(log_dir / "audio" / f"val_audio_{epoch}_{side}.wav") > 44
        grid = np.load(log_dir / "spect" / f"val_spect_{epoch}.npy")
        assert grid.shape[:3] == (2, 4, 80) and np.isfinite(grid).all()
    last = checkpoint.load_payload(checkpoint.ckpt_dir(str(log_dir), "last"))
    assert (last["step"], last["epoch"]) == (4, 2)
    assert bool(last["codebook"]["bottleneck.level_blocks.0.initialized"])


def _first_valid_rows_jax(rng, x, weights, k):
    del rng
    order = jnp.argsort(jnp.where(weights > 0, 0, 1), stable=True)
    return x[order[jnp.arange(k) % jnp.sum(weights > 0)]]


def _first_valid_rows(generator, x, weights, k):
    del generator
    order = torch.argsort((weights <= 0).to(torch.int32), stable=True)
    return x[order[torch.arange(k, device=x.device) % int(torch.sum(weights > 0))]]


def test_first_logged_loss_and_lazy_codebook_init_match_the_jax_cli(files, tmp_path, monkeypatch):
    monkeypatch.setattr(jbottleneck, "_sample_rows", _first_valid_rows_jax)
    monkeypatch.setattr(bottleneck, "sample_rows", _first_valid_rows)
    vq, dataset = _fixture("vqvae_tiny.yaml"), json.load(open(files["lj"], encoding="utf-8"))
    vq["model"]["p_dropout"] = 0.0
    train = {"log_dir": str(tmp_path / "jax"), "seed": SEED, "batch_size": 2, "num_workers": 0, "ema": False}
    jconfig = JaxConfig(vq).merge(JaxConfig(dataset), JaxConfig({"train": train}))

    # the JAX CLI's first step (train.py's order: seeds, model, variables, loaders, optimizer, step)
    random.seed(SEED)
    np.random.seed(SEED)
    jmodel = jharness.get_model(jconfig)
    variables = jharness.init_model_variables(jmodel, jconfig, jax.random.PRNGKey(SEED))
    host = jax.tree.map(np.asarray, variables)  # the JAX step donates its state
    assert not bool(host["codebook"]["bottleneck"]["level_0"]["initialized"])
    batch = next(iter(jharness.get_dataloaders(jconfig)[0]))
    tx, _ = joptim.build_optimizer(jconfig)
    jstate = JaxTrainState.create(variables, tx, use_ema=False)
    jstep = jloop.make_train_step(jmodel, tx, default_mu(2, 1), False)
    jstate, jscalars = jstep(jstate, batch, jax.random.PRNGKey(SEED + 1))

    # the same variables as a port checkpoint, loaded by the port CLI
    config = Config(vq).merge({"train": {"log_dir": str(tmp_path / "start"), "total_epochs": 1}})
    model = harness.get_model(config, device="cpu")
    model.load_state_dict(vqvae_state_dict_from_jax(host, vq["model"]), strict=True)
    with torch.no_grad():
        for name, value in codebook_from_jax(host["codebook"]).items():
            model.get_buffer(name).copy_(value)
    start = TrainState.create(model, build_optimizer(model.parameters(), config.optimizer)[0])
    path = checkpoint.save_checkpoint(config, 0, 0, start)
    log_dir = tmp_path / "port"
    train_cli.main(_argv(files, files["vq"], log_dir, "--load_ckpt", path, "--max_steps", "1", "--total_epochs",
                         "1", "--log_every_n_steps", "1", "--ckpt_every_n_steps", "1", "--eval_every_n_epochs", "5"))

    first = {r["tag"]: r["value"] for r in read_scalars(str(log_dir)) if r["step"] == 1}
    for key in ("loss", "loss_recon", "loss_stft", "loss_commit"):
        ours, theirs = first[f"loss/train_{key}"], float(jscalars[key])
        assert abs(ours - theirs) <= LOSS_RTOL * abs(theirs), (key, ours, theirs)
    # the codebook after step 1: the lazy init from step 1's encodings, then the EMA update
    codebook = checkpoint.load_payload(checkpoint.ckpt_dir(str(log_dir), 1))["codebook"]
    jcodebook = jax.tree.map(np.asarray, jstate.model_state["codebook"]["bottleneck"]["level_0"])
    assert bool(codebook["bottleneck.level_blocks.0.initialized"]) and bool(jcodebook["initialized"])
    for name in ("k", "k_sum", "k_elem"):
        ours, theirs = codebook[f"bottleneck.level_blocks.0.{name}"].numpy(), jcodebook[name]
        np.testing.assert_allclose(ours, theirs, rtol=CODEBOOK_RTOL, atol=CODEBOOK_RTOL * np.abs(theirs).max())
    assert not np.array_equal(jcodebook["k"], np.zeros_like(jcodebook["k"]))


def test_glow_cli_runs_ddi_then_ckpt0_and_starts_the_ema_there(files):
    log_dir = files["root"] / "glow"
    train_cli.main(_argv(files, files["glow"], log_dir, "--total_epochs", "1", "--ema", "--log_every_n_steps", "1",
                         "--eval_every_n_epochs", "1"))
    at0 = checkpoint.load_payload(checkpoint.ckpt_dir(str(log_dir), 0))
    assert (at0["step"], at0["epoch"], at0["sched"]) == (0, 0, 0)
    actnorm = [k for k, v in at0["model"].items() if k.startswith("decoder.flows.") and k.endswith((".logs", ".bias"))
               and v.dim() == 3]
    assert len(actnorm) == 2 * 3 and all(bool(at0["model"][k].abs().sum() > 0) for k in actnorm)
    assert at0["ema"].keys() <= at0["model"].keys()
    assert all(torch.equal(at0["ema"][k], at0["model"][k]) for k in at0["ema"])  # the EMA starts from DDI
    last = checkpoint.load_payload(checkpoint.ckpt_dir(str(log_dir), "last"))
    assert last["step"] == 2 and not all(torch.equal(last["ema"][k], at0["ema"][k]) for k in actnorm)
    assert os.path.getsize(log_dir / "audio" / "val_audio_1_pred.wav") > 44  # Griffin-Lim of the mel
    assert all(np.isfinite(r["value"]) for r in read_scalars(str(log_dir)))
    # a resume from ckpt.0 runs no DDI and writes no new ckpt.0
    again = files["root"] / "glow_resume"
    train_cli.main(_argv(files, files["glow"], again, "--total_epochs", "1", "--ema", "--load_ckpt",
                         checkpoint.ckpt_dir(str(log_dir), 0)))
    assert sorted(os.listdir(again / "ckpts")) == ["ckpt.last"]


def test_lm_cli_grafts_the_codec_from_its_log_dir(files, codec_run):
    codec_dir, _ = codec_run
    tokens = files["root"] / "tokens"
    generate_vq_dataset.main(["--log_dir", str(codec_dir), "--ckpt_num", "2", "--save_path", str(tokens),
                              "--platform", "cpu", "--batch_size", "4", "--bucket_multiple", "4096"])
    vq_cfg = load_config(str(codec_dir / "config.json")).model
    lm = {"model": {"_import_": "models.transformer_lm.transformer_lm.TransformerLM", "fused_attention": True,
                    "vocab_size": vq_cfg.l_bins, "embed_dim": 32, "max_len": 64, "num_layers": 1, "d_model": 32,
                    "nhead": 2, "dim_feedforward": 64, "dropout": 0.1, "activation": "relu", "layer_norm_eps": 1e-5,
                    "norm_first": False, "loss_type": "ce", "vqvae": {"log_dir": str(codec_dir), "ckpt_num": 2}},
          "optimizer": configs.TRANSFORMER_LM_TPU_OPTIMIZER, "scheduler": configs.TRANSFORMER_LM_TPU_SCHEDULER}
    dataset = {"dataset": dict(configs.VQLATENT, dataset_path=str(tokens), segment_length=8)}
    log_dir = files["root"] / "lm"
    state = train_cli.main(["--model", _write_json(files["root"] / "lm.json", lm), "--dataset",
                            _write_json(files["root"] / "vql.json", dataset), "--log_dir", str(log_dir),
                            "--batch_size", "2", "--platform", "cpu", "--total_epochs", "1", "--ema",
                            "--eval_every_n_epochs", "1", "--num_workers", "0"])
    codec = checkpoint.restore_model_state(checkpoint.ckpt_dir(str(codec_dir), 2))
    lm_state = checkpoint.load_payload(checkpoint.ckpt_dir(str(log_dir), "last"))["model"]
    decoder = [k for k in lm_state if k.startswith("vqvae_decoder.")]
    assert decoder and all(torch.equal(lm_state[k], codec["decoders.0." + k[len("vqvae_decoder."):]]) for k in decoder)
    assert torch.equal(lm_state["vqvae_bottleneck.k"], codec["bottleneck.level_blocks.0.k"])
    assert torch.equal(state.model.vqvae_bottleneck.k_elem, codec["bottleneck.level_blocks.0.k_elem"])
    assert not any(p.requires_grad for p in state.model.vqvae_decoder.parameters())
    assert {"loss/train_loss", "metrics/train_accuracy", "loss/val_loss"} <= {r["tag"] for r in read_scalars(str(log_dir))}
    assert os.path.exists(log_dir / "audio" / "val_audio_1_pred.wav")


@pytest.mark.parametrize("flag", [["--n_devices", "2"], ["--multihost_coordinator", "localhost:1234"],
                                  ["--num_processes", "2"], ["--steps_per_dispatch", "4"],
                                  ["--profile_steps", "3"], ["--prng_impl", "rbg"], ["--process_id", "3"]])
def test_unported_flags_raise(files, tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_cli.main(_argv(files, files["vq"], tmp_path / "x", *flag))
    assert not os.path.exists(tmp_path / "x")


def test_ctrl_c_ends_the_running_step_and_saves_the_steps_taken(files, tmp_path, monkeypatch):
    """SIGINT at the end of the third step (the second epoch's first): the
    step ends, its window is logged, no val epoch follows, and ckpt.last
    records 3 steps for both the run and the schedule."""
    make_step, calls = harness.make_train_step_for, []

    def interrupting(*args):
        step = make_step(*args)

        def run(state, batch, seed):
            scalars = step(state, batch, seed)
            calls.append(state.step)
            if len(calls) == 3:
                signal.raise_signal(signal.SIGINT)
            return scalars
        return run
    monkeypatch.setattr(harness, "make_train_step_for", interrupting)
    log_dir = tmp_path / "interrupted"
    state = train_cli.main(_argv(files, files["vq"], log_dir, "--total_epochs", "3", "--log_every_n_steps", "10",
                                 "--eval_every_n_epochs", "1", "--ema"))
    assert calls == [1, 2, 3] and state.step == 3
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler
    last = checkpoint.load_payload(checkpoint.ckpt_dir(str(log_dir), "last"))
    assert (last["step"], last["sched"]) == (3, 3)
    assert all(torch.equal(last["ema"][k], v) for k, v in state.ema_params.items())  # the third step's EMA
    rows = read_scalars(str(log_dir))
    assert sorted({r["step"] for r in rows if r["tag"] == "loss/train_loss"}) == [2, 3]  # epoch 0's end, the drain
    assert sorted({r["step"] for r in rows if r["tag"] == "loss/val_loss"}) == [1]


def test_cli_wants_the_card_unless_asked_for_the_cpu(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(files, files["vq"], tmp_path / "x") if a not in ("--platform", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_vq_dataset.main(["--log_dir", str(tmp_path), "--ckpt_num", "1", "--save_path", str(tmp_path / "t")])
    with pytest.raises(KeyError, match="vqvae_tpu"):
        train_cli.main(_argv(files, "vqvae", tmp_path / "y"))


def test_fp16_is_accepted_and_names_resolve(files, tmp_path):
    state = train_cli.main(_argv(files, files["vq"], tmp_path / "fp16", "--fp16", "--total_epochs", "1"))
    assert state.step == 2 and load_config(str(tmp_path / "fp16" / "config.json")).train.fp16
    for name, sections in configs.MODELS.items():
        assert harness.get_model(Config(sections).merge({"dataset": configs.LJSPEECH_TPU}), device="cpu") is not None, name


def test_mas_log_prior_promotes_bf16_statistics_like_jax():
    rng = np.random.RandomState(0)
    x_m, x_logs = (rng.randn(2, 7, 6).astype(np.float32) for _ in range(2))
    z = rng.randn(2, 11, 6).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    ours = mas_log_prior(bf(x_m), bf(x_logs) * 0.3, torch.from_numpy(z))
    theirs = np.asarray(jmas.mas_log_prior(jnp.asarray(x_m, jnp.bfloat16), jnp.asarray(x_logs, jnp.bfloat16) * 0.3,
                                           jnp.asarray(z)))
    assert ours.dtype == torch.float32 and theirs.dtype == np.float32
    # the rank-1 terms are bf16 sums on both sides, reduced in other orders: one bf16 ulp of the table
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=2 ** -7 * np.abs(theirs).max())
    with pytest.raises(RuntimeError):  # unpromoted, the products would refuse the mixed dtypes
        torch.matmul(bf(x_m), torch.from_numpy(z).transpose(1, 2))
