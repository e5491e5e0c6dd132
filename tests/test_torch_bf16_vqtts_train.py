"""The port's bf16 mixed-precision VQ-TTS train step against the JAX
package's ``make_train_step(..., bf16=True)``, on the CPU.

Model: tests/test_vqtts.py's tiny config as tests/test_torch_vqtts_train.py
builds it (dropout 0 everywhere, no prenet, no revival, a seeded codebook
marked initialized) with fused blocks on B5's route (``fused_encoder:
true``): the codec's GatedHiFi blocks (B1) and the text encoder's layers
(B5) run the JAX package's Pallas kernels in interpret mode in their bf16
modes. The variables cross as fp32 masters; SGD, so an update is lr times
the gradient. MAS aligns on -pairwise_l2, whose bf16 encodings tie within
an ulp: the port's MAS on JAX's distance table gives JAX's path bit for
bit, and each of the port's steps takes JAX's path, recorded inside JAX's
jitted step (tests/test_torch_bf16_glow_train.py's design); the same for
the grouped bottleneck's codes, an argmin over fp32 distances of bf16
encodings: JAX's encodings give JAX's codes through the port's bottleneck,
and the steps take JAX's codes.

Tolerances: the losses within LOSS_RTOL (2^-8); fp32 masters and codebook.
Unlike the VQ-VAE's and Glow's steps, the parameters after the step do not
show the rounding points: every group's distance from JAX's bf16 step is
the same (0.98-1.03x) for the port's bf16 and fp32 steps (measured), since
the gradients pass through the bf16 audio encodings (the alignment loss's
distances, the log-STFT term), whose bf16 rounding differs between any two
implementations; B5's and B1's rounding points are held by their VJP tests
(tests/test_torch_bf16_enc_layer.py, tests/test_torch_bf16_gated_hifi.py).
The config's route (``fused_encoder: false``) runs the text encoder's
unfused layer, ``enc_layer_reference``, which in bf16 rounds the layer's
product operands as B5's bf16 mode does: held against the JAX package's
flax TextEncoder in bf16 within CHAIN_RTOL (2^-6) relative L2, a chain of
bf16 roundings (XLA rounds where it materializes a tensor, which no
op-by-op rounding reproduces: the encodings measured 5.6e-3 from JAX's,
against 6.7e-3 for every op rounded to bf16 and 6.0e-3 for the port's
fp32 encoder), the log-durations, two more conv + LayerNorm layers on,
within twice that.
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
from speech_masters_thesis_tpu_torch.convert import vqtts_params_from_jax
from speech_masters_thesis_tpu_torch.models.vqtts import bottleneck as port_bottleneck
from speech_masters_thesis_tpu_torch.models.vqtts import model as port_vqtts_model
from speech_masters_thesis_tpu_torch.train import harness, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState

from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from test_torch_vqtts import LOSS_KEYS, _QuantDecoderNoDropout, batch_numpy, jax_variables, port_model, tiny_config
from test_torch_vqtts_train import _batches, _no_quant_dropout

SGD = {"name": "sgd", "lr": 1e-2, "momentum": 0.0, "weight_decay": 0.0}
EMA_MU = 0.9
LOSS_RTOL = 2.0 ** -8
CHAIN_RTOL = 2.0 ** -6


def _config(fused_encoder: bool) -> dict:
    config = tiny_config(train=True)
    config["model"].update(fused_blocks=True, fused_encoder=fused_encoder)
    return config


class _Codes:
    """The port's bottleneck module's ``torch`` with ``min`` over the
    distance table answering JAX's codes (the decision injected, as MAS's
    path is)."""

    def __init__(self, codes: np.ndarray):
        self.codes = torch.from_numpy(codes.astype(np.int64)).reshape(-1)

    def __getattr__(self, name):
        return getattr(torch, name)

    def min(self, distance, dim):
        return distance.gather(dim, self.codes[:, None])[:, 0], self.codes


def _port_step(config, variables, batch, bf16: bool, path: np.ndarray, codes: np.ndarray):
    model = port_model(config, variables)
    _no_quant_dropout(model)
    opt, schedule = optim.build_optimizer(model.parameters(), SGD)
    state = TrainState.create(model, opt, use_ema=True)
    step = harness.make_train_step_for({"train": {"ema": True, "bf16": bf16}}, schedule, EMA_MU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_vqtts_model, "maximum_path_auto", lambda value, mask: torch.from_numpy(path))
        mp.setattr(port_bottleneck, "torch", _Codes(codes))
        scalars = step(state, batch, 0)
    return ({k: v.float().numpy() for k, v in scalars.items()},
            {k: v.detach().clone() for k, v in state.params.items()}, model)


@pytest.fixture(scope="module")
def steps():
    """One bf16 SGD step on each side (B5's route), with JAX's MAS input and
    path and its bottleneck's input and codes from inside its jitted step."""
    config = _config(fused_encoder=True)
    jbatch, batch = _batches(batch_numpy(seed=12))
    mas, vq = [], []

    class RecordingBottleneck(jvqtts_model.GroupedBottleneck):
        def __call__(self, y_enc, x_id, attn, update_k: bool = True):
            out = super().__call__(y_enc, x_id, attn, update_k)
            jax.debug.callback(lambda *a: vq.append([np.asarray(t) for t in a]), y_enc, x_id, attn, out[0])
            return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvqtts_model, "ResNetBlock", _QuantDecoderNoDropout)
        mp.setattr(jvqtts_model, "GroupedBottleneck", RecordingBottleneck)
        inner = jvqtts_model.maximum_path_auto

        def recording(value, mask):
            out = inner(value, mask)
            jax.debug.callback(lambda *a: mas.append([np.asarray(t) for t in a]), value, mask, out)
            return out
        mp.setattr(jvqtts_model, "maximum_path_auto", recording)
        jmodel = jvqtts_model.VQTTS(config=config)
        variables = jax_variables(jmodel, config, seed=13)
        tx, _ = joptim.build_optimizer(Config({**config, "optimizer": SGD, "scheduler": None}))
        jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx, use_ema=True)
        jstate1, jscalars = jloop.make_train_step(jmodel, tx, EMA_MU, use_ema=True, bf16=True)(
            jstate, jbatch, jax.random.PRNGKey(0))
        jax.block_until_ready(jscalars)
    (jvalue, jmask, jpath), = mas
    (y_enc, x_id, attn, codes), = vq
    path = jpath.astype(np.float32)
    return {"config": config, "variables": variables, "jax_mas": (jvalue, jmask, path),
            "jax_vq": (y_enc, x_id, attn, codes),
            "jax": (jax.tree.map(np.asarray, jscalars),
                    vqtts_params_from_jax(jax.tree.map(np.asarray, jstate1.params), config["model"])),
            "port16": _port_step(config, variables, batch, True, path, codes)}


def test_bf16_vqtts_step_losses_match_jax(steps):
    jscalars, _ = steps["jax"]
    scalars = steps["port16"][0]
    assert bool(scalars["finite"]) and bool(jscalars["finite"])
    for key in LOSS_KEYS:
        np.testing.assert_allclose(scalars[key], jscalars[key], rtol=LOSS_RTOL, err_msg=key)


def test_bf16_vqtts_mas_path_equals_jax(steps):
    jvalue, jmask, path = steps["jax_mas"]
    assert jvalue.dtype == np.float32 and path.sum() > 0  # -pairwise_l2 is fp32 on both sides
    ours = port_vqtts_model.maximum_path_auto(torch.from_numpy(jvalue), torch.from_numpy(jmask.astype(np.float32)))
    np.testing.assert_array_equal(ours.numpy(), path)


def test_bf16_vqtts_codes_equal_jax(steps):
    """JAX's bf16 encodings and alignment give JAX's codes through the port's
    grouped bottleneck (its distances in fp32 against the fp32 codebook)."""
    y_enc, x_id, attn, codes = steps["jax_vq"]
    assert y_enc.dtype == jnp.bfloat16 and attn.dtype == np.float32
    bn = port_model(steps["config"], steps["variables"]).quant_bottleneck
    with torch.no_grad():
        ours = bn(torch.from_numpy(y_enc.astype(np.float32)).to(torch.bfloat16), torch.from_numpy(x_id).long(),
                  torch.from_numpy(attn))[0]
    np.testing.assert_array_equal(ours.numpy(), codes)


def test_bf16_vqtts_step_keeps_fp32_masters_and_codebook(steps):
    _, params, model = steps["port16"]
    assert all(p.dtype == torch.float32 for p in params.values())
    bn = model.quant_bottleneck
    assert bn.k.dtype == bn.k_sum.dtype == bn.k_elem.dtype == torch.float32
    params0 = vqtts_params_from_jax(steps["variables"]["params"], steps["config"]["model"])
    moved = sum(float((params[k] - v).abs().max()) > 0 for k, v in params0.items())
    assert moved > 0.9 * len(params)


def test_unfused_encoder_bf16_matches_the_flax_layers():
    """The config's route: the text encoder (unfused layers) on bf16
    parameters against the JAX package's TextEncoder in bf16."""
    config = _config(fused_encoder=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvqtts_model, "ResNetBlock", _QuantDecoderNoDropout)
        jmodel = jvqtts_model.VQTTS(config=config)
        variables = jax_variables(jmodel, config, seed=5)
        x, x_len, _, _ = batch_numpy(seed=6)
        p16 = jloop._to_bf16(jax.tree.map(jnp.asarray, variables["params"]))
        jx, _, jlogw, _ = jmodel.apply({"params": p16}, jnp.asarray(x), jnp.asarray(x_len), train=False,
                                       method=lambda m, a, b, train: m.text_encoder(a, b, train=train))
    assert jx.dtype == jnp.bfloat16
    model = port_model(config, variables)
    enc16 = copy.deepcopy(model.text_encoder).to(torch.bfloat16)
    assert not enc16.fused
    with torch.no_grad():
        ours, _, logw, mask = enc16(torch.from_numpy(x).long(), torch.from_numpy(x_len).long())
    assert ours.dtype == logw.dtype == mask.dtype == torch.bfloat16
    valid = mask[..., 0] > 0
    for name, a, ref, tol in (("x_enc", ours, jx, CHAIN_RTOL), ("logw", logw, jlogw, 2 * CHAIN_RTOL)):
        ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))[valid]
        l2 = ((a.float()[valid] - ref).norm() / ref.norm()).item()
        assert l2 <= tol, (name, l2)
