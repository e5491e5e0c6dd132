"""The port's Glow-TTS against the JAX package's, on the CPU.

Model: tests/fixtures/glow_tts_tiny.yaml (encoder 2 layers of 16 channels,
2 heads of 8, window 4; decoder 3 flow blocks, WN hidden 16, 2 layers,
k 5) with ``fused_blocks`` and ``fused_encoder`` on and ``fused_flow_step``
off, so the JAX model runs its Pallas coupling-conditioner and encoder-layer
kernels in interpret mode and the port runs their plain versions; the data
settings are configs/datasets/ljspeech_tpu.yaml's (80 mels, 148 + 1 tokens).
Every leaf of the JAX params is drawn from a numpy seed (no zero leaf: the
coupling end convs, ActNorm and the prenet's proj included) and goes across
through ``convert.glow_tts_params_from_jax``.

Tolerances (fp32, other op orders): eval losses rtol 1e-5; ``yh`` 1e-4 of
max|yh| given JAX's own normal draw (24 flow steps each way amplify the
rounding); ``infer``'s z_lengths exactly and its mel 1e-4 of max|mel|.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.glow_tts.model import GlowTTS as JaxGlowTTS
from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.utils.config import load_config
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.convert import glow_tts_params_from_jax
from speech_masters_thesis_tpu_torch.device import cuda_device
from speech_masters_thesis_tpu_torch.inference import GlowTTSSynthesizer
from speech_masters_thesis_tpu_torch.models.glow_tts.flows import build_flow_cache
from speech_masters_thesis_tpu_torch.models.glow_tts.model import GlowTTS
from speech_masters_thesis_tpu_torch.train import harness, loop, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState
from speech_masters_thesis_tpu_torch.utils import registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X_LENS, Y_LENS = (12, 8), (40, 30)
HOP = configs.LJSPEECH_TPU["hop_length"]


def tiny_config() -> dict:
    model = load_config(os.path.join(REPO, "tests/fixtures/glow_tts_tiny.yaml")).to_dict()["model"]
    model.update(fused_blocks=True, fused_encoder=True, fused_flow_step=False)
    return {"model": model, "dataset": copy.deepcopy(configs.LJSPEECH_TPU)}


def _orthogonal(rng, n):
    q = np.linalg.qr(rng.randn(n, n))[0]
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def jax_variables(jmodel, seed: int = 1) -> dict:
    """Every param leaf from a numpy seed: kernels N(0, 1/fan_in), the
    coupling end convs at a quarter of that, weight norm's g |1 + N(0, 0.1^2)|,
    LayerNorm scales 1 + N(0, 0.1^2), biases, ActNorm and the rest
    N(0, 0.1^2), relative tables and the embedding N(0, 1/width),
    InvConvNear a rotation."""
    x, x_len, y, y_len = batch_numpy()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": key, "dropout": key}, jnp.asarray(x),
                                                jnp.asarray(x_len), jnp.asarray(y), jnp.asarray(y_len),
                                                train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [p.key for p in path]
        name = names[-1]
        if name == "weight":                      # InvConvNear
            value = _orthogonal(rng, leaf.shape[0])
        elif name in ("embedding", "emb_rel_k", "emb_rel_v"):
            value = rng.randn(*leaf.shape) / np.sqrt(leaf.shape[-1])
        elif name == "g":
            value = np.abs(1.0 + 0.1 * rng.randn(*leaf.shape))
        elif leaf.ndim >= 2:
            value = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
            if "end" in names:
                value *= 0.25
        elif name == "scale":
            value = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:
            value = 0.1 * rng.randn(*leaf.shape)
        return value.astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(draw, shapes["params"])}


def batch_numpy(seed: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 149, (2, max(X_LENS))).astype(np.int32)
    y = (rng.randn(2, max(Y_LENS), configs.LJSPEECH_TPU["n_mels"]) - 4.0).astype(np.float32)
    return x, np.asarray(X_LENS, np.int32), y, np.asarray(Y_LENS, np.int32)


def port_model(config: dict, variables: dict) -> GlowTTS:
    model = harness.get_model(copy.deepcopy(config), device="cpu")
    model.load_state_dict(glow_tts_params_from_jax(variables["params"]), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def glow():
    config = tiny_config()
    jmodel = JaxGlowTTS(config=config)
    variables = jax_variables(jmodel)
    return config, jmodel, variables, port_model(config, variables)


def test_eval_forward_matches_jax(glow):
    config, jmodel, variables, model = glow
    x, x_len, y, y_len = batch_numpy()
    jout, _ = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(x_len), jnp.asarray(y),
                           jnp.asarray(y_len), train=False)
    # with no "sample" rng the JAX model draws its latent noise from PRNGKey(0)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), jout["yh"].shape))
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x).long(), torch.from_numpy(x_len).long(), torch.from_numpy(y),
                       torch.from_numpy(y_len).long(), noise=torch.from_numpy(noise))
    for key in ("loss_mle", "loss_length", "loss"):
        np.testing.assert_allclose(float(out[key]), float(jout[key]), rtol=1e-5, err_msg=key)
    yh, jyh = out["yh"].numpy(), np.asarray(jout["yh"])
    assert yh.shape == jyh.shape
    assert np.abs(yh - jyh).max() <= 1e-4 * np.abs(jyh).max()


def test_infer_matches_jax(glow):
    config, jmodel, variables, model = glow
    x, x_len, _, _ = batch_numpy()
    rng = jax.random.PRNGKey(3)
    max_frames, noise_scale = 96, 0.667
    jmel, jz = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(x_len), rng, max_frames=max_frames,
                            noise_scale=noise_scale, method=JaxGlowTTS.infer)
    noise = np.array(jax.random.normal(rng, jmel.shape))
    # ceil(exp(logw)) would flip where a duration sits on an integer
    _, _, logw, _ = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(x_len), train=False,
                                 method=lambda m, *a, **k: m.encoder(*a, **k))
    durations = np.exp(np.asarray(logw))[np.arange(x.shape[1])[None, :] < x_len[:, None]]
    assert np.abs(durations - np.round(durations)).min() > 1e-5
    mel, z = model.infer(torch.from_numpy(x).long(), torch.from_numpy(x_len).long(),
                         noise=torch.from_numpy(noise), max_frames=max_frames, noise_scale=noise_scale)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    assert np.abs(mel.numpy() - np.asarray(jmel)).max() <= 1e-4 * np.abs(np.asarray(jmel)).max()
    assert int(z.min()) > 0


def test_flow_cache_infers_the_same(glow):
    config, _, variables, _ = glow
    model = port_model(config, variables)
    x, x_len, _, _ = batch_numpy()
    args = (torch.from_numpy(x).long(), torch.from_numpy(x_len).long())
    plain, z = model.infer(*args, generator=torch.Generator().manual_seed(5), max_frames=64)
    build_flow_cache(model)
    cached, z2 = model.infer(*args, generator=torch.Generator().manual_seed(5), max_frames=64)
    assert torch.equal(z, z2)
    torch.testing.assert_close(cached, plain, rtol=0, atol=1e-5 * float(plain.abs().max()))


def test_synthesizer_caches_its_own_copy(glow):
    """GlowTTSSynthesizer builds the flow cache on a copy it owns: the
    caller's model keeps its uncached weight-norm route and its gradients,
    and the synthesizer's mel is the caller's ``infer``."""
    config, _, variables, _ = glow
    model = port_model(config, variables)
    x, x_len, y, y_len = (torch.from_numpy(a) for a in batch_numpy())
    args = (x.long(), x_len.long(), y, y_len.long())
    noise = torch.randn(2, max(Y_LENS), configs.LJSPEECH_TPU["n_mels"], generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        before, _ = model(*args, noise=noise)
    synth = GlowTTSSynthesizer(model, config, max_frames=64, gl_iters=2)
    assert synth.model.decoder.flows[2].start.folded_weight is not None
    assert model.decoder.flows[2].start.folded_weight is None and model.decoder.flows[1].weight_inv is None
    after, _ = model(*args, noise=noise)
    for key in ("loss_mle", "loss_length", "yh"):
        assert torch.equal(after[key].detach(), before[key]), key
    after["loss"].backward()
    assert model.decoder.flows[2].start.weight_g.grad is not None
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    plain, z = model.infer(x.long(), x_len.long(), generator=gen(), max_frames=64, noise_scale=0.667)
    mel, audio, z2 = synth.synthesize_ids(x.long(), gen(), 0.667, x_len.long())
    assert torch.equal(z, z2)
    torch.testing.assert_close(mel, plain.detach(), rtol=0, atol=1e-5 * float(plain.abs().max()))
    assert audio.shape == (2, 64 * HOP) and bool(torch.isfinite(audio).all())


def test_val_step_with_on_device_spect_matches_jax(glow):
    """make_val_step on the EMA params with raw audio in the batch: the mel is
    computed inside the step (dataset.on_device_spect)."""
    config, jmodel, variables, model = glow
    x, x_len, _, _ = batch_numpy()
    rng = np.random.RandomState(7)
    samples = max(Y_LENS) * HOP
    audio = (0.3 * rng.randn(2, samples)).astype(np.float32)
    audio_len = np.asarray([samples, Y_LENS[1] * HOP + 100], np.int32)
    opt_cfg = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0, "eps": 1e-9}
    from speech_masters_thesis_tpu.train import optim as joptim
    from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
    from speech_masters_thesis_tpu.utils.config import Config
    tx, _ = joptim.build_optimizer(Config({**config, "optimizer": opt_cfg, "scheduler": None}))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx, use_ema=True)
    jbatch = {"token": jnp.asarray(x), "token_len": jnp.asarray(x_len), "spect": None, "spect_len": None,
              "audio": jnp.asarray(audio), "audio_len": jnp.asarray(audio_len), "speaker": None}
    jloss, _ = jloop.make_val_step(jmodel, use_ema=True)(jstate, jbatch)

    state = TrainState.create(model, optim.build_optimizer(model.parameters(), opt_cfg)[0], use_ema=True)
    batch = {"token": torch.from_numpy(x).long(), "token_len": torch.from_numpy(x_len).long(),
             "audio": torch.from_numpy(audio), "audio_len": torch.from_numpy(audio_len).long()}
    loss, metrics = loop.make_val_step(use_ema=True)(state, batch)
    assert metrics == {}
    for key in ("loss_mle", "loss_length", "loss"):
        np.testing.assert_allclose(float(loss[key]), float(jloss[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(loss["y"].numpy(), np.asarray(jloss["y"]), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jloss["y"])).max())
    assert loss["yh"].shape == loss["y"].shape and bool(torch.isfinite(loss["yh"]).all())


@pytest.mark.parametrize("build", ["harness", "registry"])
def test_get_model_builds_on_the_card_by_default(build, monkeypatch):
    """With no device given, get_model asks for the card: here (no GPU) it
    raises cuda_device's error; with a card it would build there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_device()
    config = tiny_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if build == "harness":
            harness.get_model(config)
        else:
            registry.get_model(config["model"], dataset_config=config["dataset"])
    model = harness.get_model(config, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_init_model_variables_follows_the_jax_initializers():
    config = tiny_config()
    model = harness.get_model(config, device="cpu")
    harness.init_model_variables(model, None, seed=0)
    sd = model.state_dict()
    actnorm = [f"decoder.flows.{i}.{leaf}" for i in range(0, 9, 3) for leaf in ("logs", "bias")]
    zero = [k for k in sd if k.endswith((".end.weight", ".end.bias", "pre.proj.weight", "pre.proj.bias"))]
    assert len(zero) == 3 * 2 + 2
    for name in zero + actnorm:
        assert torch.count_nonzero(sd[name]) == 0, name
    for i in range(0, 9, 3):
        w = sd[f"decoder.flows.{i + 1}.weight"]
        torch.testing.assert_close(w @ w.t(), torch.eye(4), atol=1e-5, rtol=0)
        assert float(torch.det(w)) > 0
    cpl = model.decoder.flows[2]
    v, g = cpl.start.weight_v, cpl.start.weight_g
    torch.testing.assert_close(g.view(-1), v.flatten(1).norm(dim=1))
    with torch.no_grad():
        out, _ = model(*(torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
                         for a in batch_numpy()))
    assert all(bool(torch.isfinite(out[k])) for k in ("loss_mle", "loss_length"))


def test_routes_above_the_kernel_bounds_compute_the_same(glow):
    """T above fused_max_t takes the plain encoder layer and the plain
    conditioner (flows), the JAX package's own routing; on the CPU both
    routes compute the same values."""
    config, _, variables, model = glow
    x, x_len, y, y_len = (torch.from_numpy(a) for a in batch_numpy())
    args = (x.long(), x_len.long(), y, y_len.long())
    noise = torch.randn(2, max(Y_LENS), configs.LJSPEECH_TPU["n_mels"], generator=torch.Generator().manual_seed(1))
    unfused = port_model(config, variables)
    unfused.encoder.fused_max_t = 0
    for flow in unfused.decoder.flows[2::3]:
        flow.fused_max_t = 0
    with torch.no_grad():
        ref, _ = model(*args, noise=noise)
        out, _ = unfused(*args, noise=noise)
    for key in ("loss_mle", "loss_length"):
        torch.testing.assert_close(out[key], ref[key], rtol=1e-6, atol=0)
    torch.testing.assert_close(out["yh"], ref["yh"], rtol=0, atol=1e-5 * float(ref["yh"].abs().max()))


@pytest.mark.parametrize("option", ["block_length", "proximal_bias", "heads_share"])
def test_relative_attention_options_not_ported_raise(option):
    from speech_masters_thesis_tpu_torch.models.glow_tts.attention import RelativeSelfAttention

    kwargs = {"block_length": {"block_length": 4}, "proximal_bias": {"proximal_bias": True},
              "heads_share": {"heads_share": False}}[option]
    with pytest.raises(NotImplementedError):
        RelativeSelfAttention(16, 16, 2, window_size=4, **kwargs)
