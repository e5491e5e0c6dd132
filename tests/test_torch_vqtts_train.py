"""The port's VQ-TTS train and val steps against the JAX package's, on the CPU.

Model: tests/test_vqtts.py's tiny config as tests/test_torch_vqtts.py builds
it for train mode: dropout 0 at every site (the encoder's, the codec's, the
quant decoder's fixed 0.1 on both sides, no prenet, whose JAX rate is fixed
at 0.1 and drawn by threefry), revival off (threshold 0), a seeded
codebook marked initialized, the same numpy-drawn variables on both sides.
1 and 3 steps of ``make_train_step`` (AdamW, lr 1e-3, eps 1e-6, weight decay
0.01, parameter EMA 0.9), then ``make_val_step`` on the EMA parameters.

Tolerances (fp32, other op orders): losses and ``q_acc`` rtol 1e-4 (as
tests/test_torch_train.py); parameters and EMA parameters atol 5e-5 (an
update moves a parameter by about lr = 1e-3; Adam passes on an element's
relative gradient error); the codebook's EMA state rtol 1e-4 / atol 1e-6;
the val step's losses rtol 1e-4 and ``yh`` 1e-4 of max|yh|.

The lazy codebook init runs inside step 1, from that step's
``generators["codebook"]``: checked by replaying the draw and by its law.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.vqtts import model as jvqtts_model
from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.train import optim as joptim
from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
from speech_masters_thesis_tpu.utils.config import Config
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.convert import codebook_from_jax, vqtts_params_from_jax
from speech_masters_thesis_tpu_torch.models.glow_tts.attention import ChannelLayerNorm, RelativeSelfAttention
from speech_masters_thesis_tpu_torch.models.vqtts.model import VQTTS
from speech_masters_thesis_tpu_torch.models.vqvae.bottleneck import sample_rows
from speech_masters_thesis_tpu_torch.train import harness, loop, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState

from test_torch_vqtts import (
    LOSS_KEYS,
    _QuantDecoderNoDropout,
    batch_numpy,
    jax_variables,
    port_model,
    tiny_config,
)

# eps 1e-6, as tests/test_torch_glow_train.py: the key biases' true gradient is zero (the softmax is
# invariant to them), so both sides hold fp32 rounding there, which eps 1e-9 would scale to a full step
OPTIMIZER = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.01, "eps": 1e-6}
EMA_MU = 0.9


def _no_quant_dropout(model: VQTTS) -> None:
    for m in model.quant_decoder.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


def _batches(arrays):
    x, x_len, y, y_len = arrays
    jbatch = {"token": jnp.asarray(x), "token_len": jnp.asarray(x_len), "audio": jnp.asarray(y),
              "audio_len": jnp.asarray(y_len), "speaker": None}
    batch = {"token": torch.from_numpy(x).long(), "token_len": torch.from_numpy(x_len).long(),
             "audio": torch.from_numpy(y), "audio_len": torch.from_numpy(y_len).long()}
    return jbatch, batch


@pytest.fixture(scope="module")
def steps():
    """Three train steps on each side from the same variables, the states
    after steps 1 and 3, and the val step on the EMA parameters."""
    config = tiny_config(train=True)
    arrays = batch_numpy(seed=12)
    jbatch, batch = _batches(arrays)
    out = {"config": config}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvqtts_model, "ResNetBlock", _QuantDecoderNoDropout)
        jmodel = jvqtts_model.VQTTS(config=config)
        variables = jax_variables(jmodel, config, seed=13)
        tx, _ = joptim.build_optimizer(Config({**config, "optimizer": OPTIMIZER, "scheduler": None}))
        jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx, use_ema=True)
        jstep = jloop.make_train_step(jmodel, tx, EMA_MU, use_ema=True)
        model = port_model(config, variables)
        _no_quant_dropout(model)
        opt, schedule = optim.build_optimizer(model.parameters(), OPTIMIZER)
        state = TrainState.create(model, opt, use_ema=True)
        step = loop.make_train_step(schedule, EMA_MU, use_ema=True)
        out["params0"] = {k: v.detach().clone() for k, v in model.named_parameters()}
        for i in range(1, 4):
            jstate, jscalars = jstep(jstate, jbatch, jax.random.PRNGKey(0))
            scalars = step(state, batch, 0)
            if i in (1, 3):
                out[i] = (jax.tree.map(np.asarray, jscalars), jax.tree.map(np.asarray, jstate),
                          {k: v.numpy() for k, v in scalars.items()},
                          {k: v.detach().clone() for k, v in state.params.items()},
                          {k: v.clone() for k, v in state.ema_params.items()},
                          {k: v.clone() for k, v in state.codebook.items()})
        jloss, jmetrics = jloop.make_val_step(jmodel, use_ema=True)(jstate, jbatch)
    loss, metrics = loop.make_val_step(use_ema=True)(state, batch)
    out["val"] = (jax.tree.map(np.asarray, (jloss, jmetrics)), loss, metrics)
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(steps, n_steps):
    jscalars, jstate, scalars, params, ema, codebook = steps[n_steps]
    model_cfg = steps["config"]["model"]
    assert bool(scalars["finite"]) and bool(jscalars["finite"])
    assert set(scalars) == set(jscalars)
    for key in LOSS_KEYS + ("q_acc",):
        np.testing.assert_allclose(scalars[key], jscalars[key], rtol=1e-4, err_msg=key)
    want, want_ema = (vqtts_params_from_jax(tree, model_cfg) for tree in (jstate.params, jstate.ema_params))
    assert set(want) == set(params)
    for name, value in want.items():
        np.testing.assert_allclose(params[name].numpy(), value.numpy(), rtol=0, atol=5e-5, err_msg=name)
        np.testing.assert_allclose(ema[name].numpy(), want_ema[name].numpy(), rtol=0, atol=5e-5, err_msg=name)
    for name, value in codebook_from_jax(jstate.model_state["codebook"]).items():
        np.testing.assert_allclose(codebook[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
    moved = [n for n, v in params.items() if float((v - steps["params0"][n]).abs().max()) > 1e-4]
    assert len(moved) > 0.9 * len(params)
    assert int(jstate.step) == n_steps


def test_val_step_on_the_ema_matches_jax(steps):
    (jloss, jmetrics), loss, metrics = steps["val"]
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(loss[key]), float(jloss[key]), rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(float(metrics["q_acc"]), float(jmetrics["q_acc"]), rtol=1e-4)
    yh, jyh = loss["yh"].numpy(), jloss["yh"]
    np.testing.assert_allclose(yh, jyh, rtol=0, atol=1e-4 * np.abs(jyh).max())
    np.testing.assert_array_equal(loss["y"].numpy(), np.asarray(jloss["y"]))


def test_lazy_init_runs_in_step_one_from_the_codebook_generator():
    """A fresh codebook is initialized inside the first train step, from the
    step's ``generators["codebook"]`` (the draw replays exactly), with valid
    encodings plus small noise; later steps do not draw it again."""
    config = tiny_config(train=True)
    arrays = batch_numpy(seed=14)
    model = harness.get_model(copy.deepcopy(config), device="cpu")
    harness.init_model_variables(model, None, seed=15)
    bn = model.quant_bottleneck
    assert not bool(bn.initialized) and not bn.init_seen
    seen = []
    original = bn._maybe_init

    def spy(x_flat, m_flat, generator):
        seen.append((x_flat.detach().clone(), m_flat.clone()))
        original(x_flat, m_flat, generator)
        seen[-1] += (bn.k.clone(),)

    bn._maybe_init = spy
    opt, schedule = optim.build_optimizer(model.parameters(), configs.VQTTS_TPU_OPTIMIZER)
    state = TrainState.create(model, opt, use_ema=True)
    step = loop.make_train_step(schedule, EMA_MU, use_ema=True)
    _, batch = _batches(arrays)
    scalars = step(state, batch, 16)
    loop.raise_if_not_finite(scalars, state.step)
    assert bool(bn.initialized) and bn.init_seen
    (x_flat, m_flat, k_init), = seen
    gen = loop.step_generators(16, 0, torch.device("cpu"))["codebook"]
    torch.testing.assert_close(k_init, sample_rows(gen, x_flat, m_flat, bn.k_bins), rtol=0, atol=0)
    nearest = torch.cdist(k_init, x_flat).min(dim=1)
    assert bool((m_flat[nearest.indices] > 0).all())
    assert float(nearest.values.max()) < 0.03  # noise N(0, (0.01/sqrt(C))^2) a channel: norms near 0.01
    k1 = bn.k.clone()
    step(state, batch, 16)
    assert len(seen) == 2 and not torch.equal(bn.k, k1)  # called, returned at once; the EMA moved k
    assert torch.equal(state.codebook["quant_bottleneck.initialized"], torch.tensor(True))


@torch.no_grad()
def test_init_model_variables_and_train_state_for_vqtts():
    """The text encoder takes Glow-TTS's initializers, the codec, quant
    decoder and head the codec's (zero_out layers zero); no codebook init;
    ``TrainState.codebook`` is the grouped bottleneck's four buffers."""
    model = harness.get_model({"model": copy.deepcopy(configs.VQTTS_TPU),
                               "dataset": copy.deepcopy(configs.LJSPEECH_TPU)}, device="cpu")
    harness.init_model_variables(model, None, seed=3)
    te = model.text_encoder
    H = te.hidden_channels
    assert abs(te.emb.weight.std().item() * np.sqrt(H) - 1.0) < 0.05
    norms = [m for m in te.modules() if isinstance(m, ChannelLayerNorm)]
    assert norms and all(bool((n.gamma == 1).all()) and bool((n.beta == 0).all()) for n in norms)
    q = next(m for m in te.modules() if isinstance(m, RelativeSelfAttention)).conv_q.weight
    assert float(q.abs().max()) <= np.sqrt(6.0 / (2 * H)) + 1e-6  # xavier-uniform's limit
    gates = [m.gate.weight for m in model.modules() if hasattr(m, "gate")]
    assert len(gates) == 16 and all(float(g.abs().sum()) == 0 for g in gates)
    assert all(float(layer.model[5].weight.abs().sum()) == 0 for layer in model.quant_decoder.model)
    dil = model.quant_decoder.model[0].model[2]
    assert dil.dilation == (27,) and dil.in_channels == 128 and dil.out_channels == 256
    assert abs(dil.weight.std().item() * np.sqrt(dil.weight[0].numel()) - 1.0) < 0.1
    assert model.quant_proj.weight.shape == (512, 128, 1)
    bn = model.quant_bottleneck
    assert tuple(bn.k.shape) == (149 * 512, 128) and not bool(bn.initialized)
    state = TrainState.create(model, optim.build_optimizer(model.parameters(), configs.VQTTS_TPU_OPTIMIZER)[0])
    assert set(state.codebook) == {f"quant_bottleneck.{n}" for n in ("k", "k_sum", "k_elem", "initialized")}
    assert state.codebook["quant_bottleneck.k"] is bn.k
    assert harness.frozen_param_mask(model) is None
