"""The port's checkpoints (train/checkpoint.py), on the CPU at
tests/fixtures/vqvae_tiny.yaml's width (dropout 0.1, Adam + both EMAs).

Save then restore into a freshly built state is bitwise for the
parameters, the Adam moments and counts, the EMA parameters, the codebook's
four buffers (``k_sum``, ``k_elem`` and ``initialized`` are not in the
``state_dict``), the schedule's step, the step and the epoch; one train step
from the restored state equals the same step from the live state bit for
bit (one torch thread: the CPU's threaded convs sum in a varying order).
``latest_checkpoint`` puts ``last`` after every number; a missing or
unexpected key raises; the LM's codec graft reads a checkpoint through
``restore_model_state``.
"""

import copy
import os

import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.utils.config import load_config
from speech_masters_thesis_tpu_torch.models.ema import default_mu
from speech_masters_thesis_tpu_torch.models.transformer_lm.model import load_vqvae_into_lm
from speech_masters_thesis_tpu_torch.train import checkpoint, harness
from speech_masters_thesis_tpu_torch.train.optim import build_optimizer
from speech_masters_thesis_tpu_torch.train.state import TrainState
from speech_masters_thesis_tpu_torch.utils.config import Config
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

OPTIMIZER = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.01, "eps": 1e-9}
SEED = 5


def _config(log_dir):
    model = load_config("tests/fixtures/vqvae_tiny.yaml").to_dict()["model"]
    return Config({"model": model, "optimizer": OPTIMIZER, "scheduler": None,
                   "train": {"log_dir": str(log_dir), "total_epochs": 9, "ema": True, "bf16": False,
                             "grad_clip_norm": 1.0}})


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"audio": torch.from_numpy(rng.uniform(-0.8, 0.8, (2, 2048)).astype(np.float32)),
            "audio_len": torch.tensor([2048, 1536], dtype=torch.int32)}


def _state(config, init_seed):
    model = harness.get_model(config, device="cpu")
    harness.init_model_variables(model, None, init_seed)
    opt, schedule = build_optimizer(harness.trainable_parameters(model), config.optimizer)
    state = TrainState.create(model, opt, use_ema=True)
    return state, harness.make_train_step_for(config, schedule, default_mu(2, 1))


def _snapshot(state):
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "optim": copy.deepcopy(state.optimizer.state_dict()),
            "ema": {k: v.clone() for k, v in state.ema_params.items()},
            "codebook": {k: v.clone() for k, v in state.codebook.items()}, "step": state.step}


def _assert_bitwise(a, b):
    for part in ("model", "ema", "codebook"):
        assert a[part].keys() == b[part].keys(), part
        for k in a[part]:
            assert a[part][k].dtype == b[part][k].dtype and torch.equal(a[part][k], b[part][k]), (part, k)
    sa, sb = a["optim"]["state"], b["optim"]["state"]
    assert sa.keys() == sb.keys() and a["optim"]["param_groups"] == b["optim"]["param_groups"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a["step"] == b["step"]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Two steps (the lazy codebook init in the first), a checkpoint at step
    2 epoch 1, a third step live; then a fresh state from another seed,
    restored, and the same third step."""
    config = _config(tmp_path_factory.mktemp("run"))
    state, step = _state(config, init_seed=SEED)
    for i in range(2):
        step(state, _batch(i), SEED)
    path = checkpoint.save_checkpoint(config, 2, 1, state)
    saved = _snapshot(state)
    live = {k: v.clone() for k, v in step(state, _batch(2), SEED).items()}
    after_live = _snapshot(state)

    fresh, fresh_step = _state(config, init_seed=SEED + 1)
    fresh, global_step, epoch = checkpoint.restore_checkpoint(path, fresh)
    restored = _snapshot(fresh)
    again = {k: v.clone() for k, v in fresh_step(fresh, _batch(2), SEED).items()}
    return dict(config=config, path=path, saved=saved, restored=restored, global_step=global_step, epoch=epoch,
                live=live, again=again, after_live=after_live, after_again=_snapshot(fresh))


def test_restore_is_bitwise(resumed):
    _assert_bitwise(resumed["saved"], resumed["restored"])
    assert (resumed["global_step"], resumed["epoch"]) == (2, 1) and resumed["restored"]["step"] == 2
    codebook = resumed["restored"]["codebook"]
    prefix = "bottleneck.level_blocks.0."
    assert set(codebook) == {prefix + n for n in ("k", "k_sum", "k_elem", "initialized")}
    assert bool(codebook[prefix + "initialized"]) and not torch.equal(codebook[prefix + "k_elem"],
                                                                      torch.ones_like(codebook[prefix + "k_elem"]))


def test_resumed_step_equals_the_live_step_bitwise(resumed):
    assert resumed["live"].keys() == resumed["again"].keys()
    for k, v in resumed["live"].items():
        assert torch.equal(v, resumed["again"][k]), k
    _assert_bitwise(resumed["after_live"], resumed["after_again"])


def test_payload_has_the_reference_layout(resumed):
    payload = checkpoint.load_payload(resumed["path"])
    assert set(payload) == {"config", "model", "optim", "sched", "ema", "codebook", "step", "epoch"}
    assert payload["sched"] == 2 and payload["config"] == resumed["config"].to_dict()
    assert resumed["path"] == os.path.join(resumed["config"].train.log_dir, "ckpts", "ckpt.2")


def test_last_saves_total_epochs_and_latest_orders_last_after_numbers(tmp_path):
    config = _config(tmp_path)
    state, _ = _state(config, SEED)
    assert checkpoint.latest_checkpoint(str(tmp_path)) is None
    for step in (10, 2, 100):
        checkpoint.save_checkpoint(config, step, 0, state)
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("ckpt.100")
    path = checkpoint.save_checkpoint(config, 7, -1, state)
    assert path.endswith("ckpt.last") and checkpoint.latest_checkpoint(str(tmp_path)) == path
    assert checkpoint.load_payload(path)["epoch"] == 9
    assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path / "ckpts"))


@pytest.mark.parametrize("part", ["model", "codebook", "ema", "payload"])
def test_restore_raises_on_a_missing_key(tmp_path, part):
    config = _config(tmp_path)
    state, _ = _state(config, SEED)
    path = checkpoint.save_checkpoint(config, 1, 0, state)
    payload = torch.load(path, weights_only=True)
    if part == "payload":
        del payload["sched"]
    else:
        payload[part].pop(next(iter(payload[part])))
    torch.save(payload, path)
    fresh, _ = _state(config, SEED)
    with pytest.raises((KeyError, RuntimeError)):
        checkpoint.restore_checkpoint(path, fresh)


def test_restore_raises_on_an_unexpected_key_and_on_a_missing_ema(tmp_path):
    config = _config(tmp_path)
    state, _ = _state(config, SEED)
    path = checkpoint.save_checkpoint(config, 1, 0, state)
    payload = torch.load(path, weights_only=True)
    payload["codebook"]["bottleneck.level_blocks.0.extra"] = torch.zeros(1)
    torch.save(payload, path)
    with pytest.raises(KeyError):
        checkpoint.restore_checkpoint(path, _state(config, SEED)[0])
    path = checkpoint.save_checkpoint(config, 2, 0, state)
    model = harness.get_model(config, device="cpu")
    no_ema = TrainState.create(model, build_optimizer(model.parameters(), OPTIMIZER)[0], use_ema=False)
    with pytest.raises(ValueError):
        checkpoint.restore_checkpoint(path, no_ema)


def test_restore_model_state_feeds_the_lm_graft(resumed):
    """The codec's decoder, codebook and its EMA statistics reach the LM's
    frozen codec from the checkpoint file."""
    state = checkpoint.restore_model_state(resumed["path"])
    vq_cfg = resumed["config"].to_dict()["model"]
    lm_cfg = {"_import_": "transformer_lm", "fused_attention": False, "vocab_size": vq_cfg["l_bins"],
              "embed_dim": 16, "max_len": 32, "num_layers": 1, "d_model": 16, "nhead": 2, "dim_feedforward": 32,
              "dropout": 0.0, "activation": "relu", "layer_norm_eps": 1e-5, "norm_first": False, "loss_type": "ce"}
    lm = harness.get_model({"model": lm_cfg}, vqvae_model_config=vq_cfg, device="cpu")
    load_vqvae_into_lm(lm, state)
    saved = resumed["saved"]
    for name in ("k", "k_sum", "k_elem", "initialized"):
        assert torch.equal(lm.get_buffer(f"vqvae_bottleneck.{name}"),
                           saved["codebook"][f"bottleneck.level_blocks.0.{name}"])
    for name, p in lm.vqvae_decoder.named_parameters():
        assert torch.equal(p, saved["model"][f"decoders.0.{name}"])
    model = harness.get_model(resumed["config"], device="cpu")
    checkpoint.load_model_state(model, state)
    assert torch.equal(model.bottleneck.level_blocks[0].k_sum, saved["codebook"]["bottleneck.level_blocks.0.k_sum"])
    with pytest.raises(AttributeError):
        checkpoint.load_model_state(model, {**state, "bottleneck.nothing": torch.zeros(1)})
