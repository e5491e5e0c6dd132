"""The port's bf16 mixed-precision VQ-VAE train step against the JAX
package's ``make_train_step(..., bf16=True)``, on the CPU.

Model: tests/fixtures/vqvae_tiny.yaml with fused blocks (the JAX block's
Pallas kernel in interpret mode, in its bf16 mode), zero_out false,
linf_approx false, p_dropout 0 and revival_threshold 0, so no randomness
enters the step. The variables are drawn from a numpy seed and go across
through convert.py as fp32 masters; each side builds its own bf16 compute
copy inside the step. Audio is 2 x 2048 samples, lengths 2048 and 1600 (each
block's lengths are bf16-exact: the JAX block sums a bf16 mask in bf16).
The optimizer is SGD, so a parameter's update is lr times its gradient and
the parameters after the step carry the gradients' error unchanged (Adam's
first update is lr * sign(g), which would hide its size).

Tolerances, at bf16 scale: the losses within LOSS_RTOL (2^-8) of JAX's (the
port's fp32 step's loss is 1.4% off JAX's bf16 step's); the
codes of the first step's forward equal at CODE_AGREEMENT (0.99) of the
valid frames, each mismatch a near-tie (its squared-distance gap within
TIE_RTOL of the encoding's squared norm: the encodings themselves differ
by bf16 roundings). The rounding points are JAX's: the port's bf16 step's
parameters are closer to JAX's bf16 step's than the port's fp32 step's are,
by ROUNDING_RATIO (0.4 of the distance; measured 0.31, and 0.46 for a port
whose GatedHiFi block rounds none of its product operands). One rounding
point of the block skipped moves the ratio by 0.001, below the step's bf16
noise: tests/test_torch_bf16_gated_hifi.py's VJP test catches that.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.vqvae.model import VQVAE as JaxVQVAE
from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.train import optim as joptim
from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
from speech_masters_thesis_tpu.utils.config import Config, load_config
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.convert import codebook_from_jax, params_from_jax, vqvae_state_dict_from_jax
from speech_masters_thesis_tpu_torch.models.glow_tts.model import GlowTTS
from speech_masters_thesis_tpu_torch.models.transformer_lm.model import TransformerLM
from speech_masters_thesis_tpu_torch.models.vqtts.model import VQTTS
from speech_masters_thesis_tpu_torch.models.vqvae.model import VQVAE
from speech_masters_thesis_tpu_torch.train import harness, loop, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SGD = {"name": "sgd", "lr": 1e-2, "momentum": 0.0, "weight_decay": 0.0}
ADAM = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.01, "eps": 1e-9}
EMA_MU = 0.9
LOSS_KEYS = ("loss", "loss_recon", "loss_stft", "loss_commit")
LOSS_RTOL = 2.0 ** -8
CODE_AGREEMENT = 0.99
TIE_RTOL = 2.0 ** -6
ROUNDING_RATIO = 0.4



def _model_cfg():
    cfg = load_config("tests/fixtures/vqvae_tiny.yaml").to_dict()["model"]
    cfg.update(zero_out=False, p_dropout=0.0, revival_threshold=0.0, fused_blocks=True)
    cfg["loss"]["linf_approx"] = False
    return cfg


def _batch():
    rng = np.random.RandomState(3)
    audio = rng.uniform(-0.8, 0.8, (2, 2048)).astype(np.float32)
    return audio, np.array([2048, 1600], np.int32)


def _variables(cfg):
    """Seeded variables; their shapes from the unfused model, which declares
    the same parameter tree and traces no Pallas kernel."""
    model = JaxVQVAE(config={"model": {**cfg, "fused_blocks": False}})
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key, "codebook": key},
        jnp.zeros((1, 256)), jnp.full((1,), 256), train=False))
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.2).astype(np.float32), shapes["params"])
    k = rng.randn(cfg["l_bins"], cfg["emb_width"]).astype(np.float32)
    codebook = {"bottleneck": {"level_0": {
        "k": k, "k_sum": k.copy(), "k_elem": np.ones(cfg["l_bins"], np.float32),
        "initialized": np.ones((), bool)}}}
    return {"params": params, "codebook": codebook}


def _port_model(cfg, variables):
    model = harness.get_model({"model": copy.deepcopy(cfg)}, device="cpu")
    model.load_state_dict(vqvae_state_dict_from_jax(variables, cfg), strict=True)
    with torch.no_grad():
        for name, value in codebook_from_jax(variables["codebook"]).items():
            model.get_buffer(name).copy_(value)
    return model


def _port_step(cfg, variables, batch, bf16):
    """One SGD step of the port; (scalars, params after, the model)."""
    model = _port_model(cfg, variables)
    opt, schedule = optim.build_optimizer(model.parameters(), SGD)
    state = TrainState.create(model, opt, use_ema=True)
    step = harness.make_train_step_for({"train": {"ema": True, "bf16": bf16}}, schedule, EMA_MU)
    scalars = step(state, batch, 0)
    return ({k: v.float().numpy() for k, v in scalars.items()},
            {k: v.detach().clone() for k, v in state.params.items()}, model)


def _codes_and_h(model, audio, lengths):
    """The encoder's codes and encodings with a bf16 copy of the parameters
    (the codebook stays fp32), as the step's forward computes them."""
    m16 = copy.deepcopy(model)
    for p in m16.parameters():
        p.data = p.data.to(torch.bfloat16)
    x = torch.from_numpy(audio).to(torch.bfloat16)
    mask = (torch.arange(audio.shape[1])[None, :] < torch.from_numpy(lengths)[:, None]).to(torch.bfloat16)
    with torch.no_grad():
        h, h_mask = m16.encoders[0](x[..., None], mask[..., None])
        codes = m16.bottleneck.encode([h], [h_mask[..., 0]])[0]
    return codes, h.float(), h_mask[..., 0] > 0, m16.bottleneck.level_blocks[0]


@pytest.fixture(scope="module")
def steps():
    """One bf16 step on each side from the same variables, and the port's
    fp32 step."""
    cfg = _model_cfg()
    jmodel = JaxVQVAE(config={"model": cfg})
    variables = _variables(cfg)
    audio, lengths = _batch()

    tx, _ = joptim.build_optimizer(Config({"model": cfg, "optimizer": SGD, "scheduler": None}))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx, use_ema=True)
    jstep = jloop.make_train_step(jmodel, tx, EMA_MU, use_ema=True, bf16=True)
    jbatch = {"audio": jnp.asarray(audio), "audio_len": jnp.asarray(lengths), "speaker": None}
    jstate1, jscalars = jstep(jstate, jbatch, jax.random.PRNGKey(0))

    batch = {"audio": torch.from_numpy(audio), "audio_len": torch.from_numpy(lengths)}
    port16 = _port_step(cfg, variables, batch, bf16=True)
    port32 = _port_step(cfg, variables, batch, bf16=False)
    return {"cfg": cfg, "jmodel": jmodel, "variables": variables, "audio": audio, "lengths": lengths,
            "jax": (jax.tree.map(np.asarray, jscalars), params_from_jax(jax.tree.map(np.asarray, jstate1.params), cfg)),
            "port16": port16, "port32": port32}


def test_bf16_step_losses_match_jax(steps):
    jscalars, _ = steps["jax"]
    scalars, _, _ = steps["port16"]
    assert bool(scalars["finite"]) and bool(jscalars["finite"])
    for key in LOSS_KEYS:
        np.testing.assert_allclose(scalars[key], jscalars[key], rtol=LOSS_RTOL, err_msg=key)


def test_bf16_step_codes_match_jax(steps):
    """The codes of the step's forward: the encoder on a bf16 copy of the
    parameters before the step, the fp32 codebook."""
    _, _, model = steps["port16"]
    audio, lengths, variables, jmodel = steps["audio"], steps["lengths"], steps["variables"], steps["jmodel"]
    codes, h, valid, bn = _codes_and_h(_port_model(steps["cfg"], variables), audio, lengths)
    mask = (np.arange(audio.shape[1])[None, :] < lengths[:, None]).astype(np.float32)
    p16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), variables["params"])
    jcodes, _ = jmodel.apply({"params": p16, "codebook": jax.tree.map(jnp.asarray, variables["codebook"])},
                             jnp.asarray(audio).astype(jnp.bfloat16), jnp.asarray(mask).astype(jnp.bfloat16),
                             method=jmodel.encode)
    jcodes = torch.from_numpy(np.array(jcodes)).to(codes.dtype)
    agree = (codes == jcodes)[valid].float().mean().item()
    assert agree >= CODE_AGREEMENT, f"codes agree on {agree}"
    dist = bn._distances(h.reshape(-1, h.shape[-1])).reshape(*h.shape[:2], -1)
    for b, t in (~(codes == jcodes) & valid).nonzero().tolist():
        gap = abs((dist[b, t, codes[b, t]] - dist[b, t, jcodes[b, t]]).item())
        assert gap <= TIE_RTOL * (h[b, t] ** 2).sum().item(), f"frame {(b, t)}: gap {gap} is no near-tie"
    assert model.bottleneck.level_blocks[0].k.dtype == torch.float32


def test_bf16_step_keeps_fp32_masters_and_codebook(steps):
    _, params, model = steps["port16"]
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in model.parameters())
    bn = model.bottleneck.level_blocks[0]
    assert bn.k.dtype == bn.k_sum.dtype == bn.k_elem.dtype == torch.float32


def test_bf16_step_rounds_where_jax_rounds(steps):
    """(a) the port's bf16 step from JAX's bf16 step, (b) the port's fp32 step
    from JAX's bf16 step, over every parameter after the step: a <= 0.4 b. A
    port without bf16 rounding points moves toward (b) (module docstring)."""
    _, jparams = steps["jax"]
    dist = lambda ours: torch.sqrt(sum(((ours[k] - v) ** 2).sum() for k, v in jparams.items())).item()
    a, b = dist(steps["port16"][1]), dist(steps["port32"][1])
    assert a <= ROUNDING_RATIO * b, f"bf16 step {a:.3e} vs fp32 step {b:.3e} from JAX's bf16 step"


def test_params_from_jax_then_bf16_equals_jax_to_bf16(steps):
    """convert.py carries the fp32 masters; each side's bf16 copy is then the
    same bits (compared as their exact fp32 values)."""
    params = jax.tree.map(jnp.asarray, steps["variables"]["params"])
    theirs = params_from_jax(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jloop._to_bf16(params)),
                             steps["cfg"])
    for name, value in params_from_jax(jax.tree.map(np.asarray, params), steps["cfg"]).items():
        assert torch.equal(value.to(torch.bfloat16).float(), theirs[name]), name


def test_two_bf16_train_steps_adamw_ema():
    """The port's counterpart of tests/test_train_integration.py's
    test_bf16_train_step: two steps, a finite loss, fp32 masters."""
    cfg = _model_cfg()
    model = harness.get_model({"model": cfg}, device="cpu")
    audio, lengths = _batch()
    batch = {"audio": torch.from_numpy(audio), "audio_len": torch.from_numpy(lengths)}
    harness.init_model_variables(model, batch, seed=4)
    opt, schedule = optim.build_optimizer(model.parameters(), ADAM)
    state = TrainState.create(model, opt, use_ema=True)
    step = harness.make_train_step_for({"train": {"ema": True, "bf16": True}}, schedule, EMA_MU)
    for _ in range(2):
        scalars = step(state, batch, 4)
    assert bool(scalars["finite"]) and np.isfinite(float(scalars["loss"]))
    assert scalars["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(p.dtype == torch.float32 for p in state.ema_params.values())


def test_bf16_setting_defaults_off_and_other_models_raise():
    """train.py's --bf16 defaults off; every model of the package takes the
    bf16 step (the VQ-VAE: B1; the Transformer LM: B2; Glow-TTS on both
    decoder routes: B3 or B6, B4, B5; VQ-TTS: B1, B4, B5); a model that
    declares no bf16 mode raises in it."""
    assert configs.TRAIN["bf16"] is False
    assert VQVAE.BF16_TRAINING and VQTTS.BF16_TRAINING and GlowTTS.BF16_TRAINING and TransformerLM.BF16_TRAINING
    step = loop.make_train_step(lambda _: 0.1, EMA_MU, use_ema=False, bf16=True)
    model = torch.nn.Linear(2, 2)  # no BF16_TRAINING
    state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=0.1), use_ema=False)
    with pytest.raises(NotImplementedError, match="BF16_TRAINING"):
        step(state, {}, 0)
    config = {"model": {**copy.deepcopy(configs.GLOW_TTS_TPU), "fused_flow_step": True},
              "dataset": copy.deepcopy(configs.LJSPEECH_TPU)}
    glow = harness.get_model(config, device="cpu")
    assert glow.decoder.fused_flow_step and not hasattr(glow, "check_bf16")
