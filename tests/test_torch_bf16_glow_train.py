"""The port's bf16 mixed-precision Glow-TTS train step against the JAX
package's ``make_train_step(..., bf16=True)``, on the CPU.

Model: tests/fixtures/glow_tts_tiny.yaml with the fused encoder (B5) and
coupling (B3), the flow step off, dropout 0 and no prenet (as
tests/test_torch_glow_train.py), so the JAX side runs both Pallas kernels
in interpret mode in their bf16 modes and no randomness enters the step;
then the same with ``fused_flow_step: true`` (``flow_steps``): at p = 0 the
JAX decoder keeps its B6 route on the CPU (encoder.py:292-294) and runs the
whole-flow-step kernel's bf16 mode in interpret mode, the port B6's plain
bf16 versions through ``FlowStepFunction``.
Then the CLI's batch on ljspeech_tpu (``on_device_spect``): raw audio,
whose mel both steps compute in fp32, so both packages' flows and B3 run
fp32 on the bf16 weights, promoted.
The variables are drawn from a numpy seed and cross as fp32 masters
(convert.py); each side builds its own bf16 compute copy in the step. The
batch is a mel batch (the flows then run in bf16 on both sides). The
optimizer is SGD, so a parameter's update is lr times its gradient.

Tolerances, at bf16 scale: the losses within LOSS_RTOL (2^-8) of JAX's; the
MAS path equal to JAX's on JAX's log-prior (both sides run B4 in fp32 on
a prior of bf16 terms promoted to fp32; on its own prior the port's path may flip near
ties, an ulp of a prior of magnitude ~100 being 0.5, so each step takes
JAX's path, recorded inside JAX's jitted step); fp32 masters; and the
rounding points are JAX's: the
port's bf16 step's parameters lie closer to JAX's bf16 step's than the
port's fp32 step's do, by ROUNDING_RATIO (tests/test_torch_bf16_train.py's
design). Lengths: a bf16 mask's sums round above 256 as JAX's do, and the
flows' lengths (flows.mask_lengths, ActNorm's and InvConvNear's logdet
lengths) take those rounded values.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.glow_tts import model as jax_glow_model
from speech_masters_thesis_tpu.models.glow_tts.model import GlowTTS as JaxGlowTTS
from speech_masters_thesis_tpu.ops.pallas import wn_coupling as jax_wn_coupling
from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.train import optim as joptim
from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
from speech_masters_thesis_tpu.utils.config import Config
from speech_masters_thesis_tpu_torch.convert import glow_tts_params_from_jax
from speech_masters_thesis_tpu_torch.models.glow_tts import flows
from speech_masters_thesis_tpu_torch.models.glow_tts import model as port_glow_model
from speech_masters_thesis_tpu_torch.ops.basic import sequence_mask
from speech_masters_thesis_tpu_torch.train import harness, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState

from test_torch_glow import HOP, batch_numpy, jax_variables, port_model, tiny_config
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SGD = {"name": "sgd", "lr": 1e-2, "momentum": 0.0, "weight_decay": 0.0}
EMA_MU = 0.9
LOSS_KEYS = ("loss", "loss_mle", "loss_length")
LOSS_RTOL = 2.0 ** -8
ROUNDING_RATIO = 0.5


def _config(flow_step: bool = False) -> dict:
    config = tiny_config()
    config["model"]["encoder"].update(p_dropout=0.0, prenet=False)
    config["model"]["decoder"]["p_dropout"] = 0.0
    config["model"]["fused_flow_step"] = flow_step
    return config


def _batches():
    x, x_len, y, y_len = batch_numpy()
    jbatch = {"token": jnp.asarray(x), "token_len": jnp.asarray(x_len), "spect": jnp.asarray(y),
              "spect_len": jnp.asarray(y_len), "speaker": None}
    batch = {"token": torch.from_numpy(x).long(), "token_len": torch.from_numpy(x_len).long(),
             "spect": torch.from_numpy(y), "spect_len": torch.from_numpy(y_len).long()}
    return jbatch, batch


def _audio_batches():
    """The CLI's Glow batch on ljspeech_tpu (``on_device_spect``): raw audio
    whose mel each side's step computes, Y_LENS frames of it valid."""
    x, x_len, _, y_len = batch_numpy()
    audio = np.random.RandomState(5).uniform(-0.5, 0.5, (2, int(y_len.max()) * HOP)).astype(np.float32)
    audio_len = (y_len * HOP).astype(np.int32)
    jbatch = {"token": jnp.asarray(x), "token_len": jnp.asarray(x_len), "spect": None, "spect_len": None,
              "audio": jnp.asarray(audio), "audio_len": jnp.asarray(audio_len), "speaker": None}
    batch = {"token": torch.from_numpy(x).long(), "token_len": torch.from_numpy(x_len).long(), "spect": None,
             "spect_len": None, "audio": torch.from_numpy(audio), "audio_len": torch.from_numpy(audio_len).long()}
    return jbatch, batch


def _port_step(config, variables, batch, bf16: bool, path: np.ndarray):
    """One SGD step of the port with MAS's path replaced by ``path`` (JAX's):
    both sides then align alike and the step shows the rest's rounding."""
    model = port_model(config, variables).train()
    opt, schedule = optim.build_optimizer(model.parameters(), SGD)
    state = TrainState.create(model, opt, use_ema=True)
    step = harness.make_train_step_for({"train": {"ema": True, "bf16": bf16}}, schedule, EMA_MU)
    inner, seen = port_glow_model.maximum_path_auto, []

    def jax_path(value, mask):
        seen.append((inner(value, mask), value))
        return torch.from_numpy(path)
    port_glow_model.maximum_path_auto = jax_path
    try:
        scalars = step(state, batch, 0)
    finally:
        port_glow_model.maximum_path_auto = inner
    return ({k: v.float().numpy() for k, v in scalars.items()},
            {k: v.detach().clone() for k, v in state.params.items()}, model, seen[0][0].numpy(), seen[0][1])


def _steps(config: dict, batches=_batches) -> dict:
    """One bf16 SGD step on each side from the same variables, the port's
    fp32 step, JAX's log-prior and path from inside its jitted step."""
    jmodel = JaxGlowTTS(config=config)
    variables = jax_variables(jmodel)
    tx, _ = joptim.build_optimizer(Config({**config, "optimizer": SGD, "scheduler": None}))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx, use_ema=True)
    jbatch, batch = batches()
    inner, mas = jax_glow_model.maximum_path_auto, []

    def recording(value, mask):
        out = inner(value, mask)
        jax.debug.callback(lambda *a: mas.append([np.asarray(t) for t in a]), value, mask, out)
        return out
    jax_glow_model.maximum_path_auto = recording
    try:
        jstep = jloop.make_train_step(jmodel, tx, EMA_MU, use_ema=True, bf16=True)
        jstate1, jscalars = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        jax.block_until_ready(jscalars)
    finally:
        jax_glow_model.maximum_path_auto = inner
    (jlogp, jmask, jpath), = mas
    path = jpath.astype(np.float32)
    return {"config": config, "variables": variables, "jax_mas": (jlogp, jmask, path),
            "jax": (jax.tree.map(np.asarray, jscalars),
                    glow_tts_params_from_jax(jax.tree.map(np.asarray, jstate1.params), config["model"])),
            "port16": _port_step(config, variables, batch, True, path),
            "port32": _port_step(config, variables, batch, False, path)}


@pytest.fixture(scope="module")
def steps():
    return _steps(_config())


@pytest.fixture(scope="module")
def flow_steps(monkeypatch_module):
    """``steps`` on the B6 route, counting the port's bf16 flow-step calls."""
    calls, inner = [], flows.flow_step

    def counting(x, *args):
        calls.append(x.dtype)
        return inner(x, *args)
    monkeypatch_module.setattr(flows, "flow_step", counting)
    out = _steps(_config(flow_step=True))
    out["calls"] = calls
    return out


@pytest.fixture(scope="module")
def audio_steps():
    """``steps`` on the audio batch, recording the dtype of x0 at every B3
    call: the port's wrapper and the JAX package's (at each trace, with
    its start weight's dtype: bf16 in the bf16 step's traces)."""
    port_calls, jax_calls = [], []
    inner, jinner = flows.wn_coupling, jax_wn_coupling.apply_fused_wn_coupling

    def port_recording(x0, *args):
        port_calls.append(str(x0.dtype).removeprefix("torch."))
        return inner(x0, *args)

    def jax_recording(spec, seed, lens, x0, ws, *args):
        jax_calls.append((str(x0.dtype), str(ws.dtype)))
        return jinner(spec, seed, lens, x0, ws, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flows, "wn_coupling", port_recording)
        mp.setattr(jax_wn_coupling, "apply_fused_wn_coupling", jax_recording)
        out = _steps(_config(), _audio_batches)
    out["b3_dtypes"] = port_calls, jax_calls
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_bf16_glow_step_losses_match_jax(steps):
    jscalars, _ = steps["jax"]
    scalars = steps["port16"][0]
    assert bool(scalars["finite"]) and bool(jscalars["finite"])
    for key in LOSS_KEYS:
        np.testing.assert_allclose(scalars[key], jscalars[key], rtol=LOSS_RTOL, err_msg=key)


def test_bf16_glow_step_mas_path_equals_jax(steps):
    """JAX's log-prior (fp32: its numpy constant promotes the bf16 terms)
    gives JAX's path through the port's MAS bit for bit; the port's own
    path (near ties flip with an ulp of a bf16 term) covers the same
    frames."""
    jlogp, jmask, path = steps["jax_mas"]
    assert jlogp.dtype == np.float32 and jmask.dtype == jnp.bfloat16
    ours = port_glow_model.maximum_path_auto(torch.from_numpy(jlogp),
                                             torch.from_numpy(jmask.astype(np.float32)).to(torch.bfloat16))
    np.testing.assert_array_equal(ours.numpy(), path)
    own, logp = steps["port16"][3], steps["port16"][4]
    assert own.shape == path.shape and own.dtype == np.float32 and logp.dtype == torch.float32
    np.testing.assert_array_equal(own.sum(axis=1), path.sum(axis=1))  # each frame aligned once, as JAX's


def test_bf16_glow_step_keeps_fp32_masters(steps):
    _, params, model, _, _ = steps["port16"]
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters() if p.requires_grad and p.grad is not None)
    moved = sum(float((params[k] - v).abs().max()) > 0 for k, v in steps["port32"][1].items())
    assert moved > 0.9 * len(params)


def test_bf16_glow_step_rounds_where_jax_rounds(steps):
    """(a) the port's bf16 step from JAX's bf16 step, (b) the port's fp32
    step from JAX's bf16 step, over every parameter after the step: a <=
    ROUNDING_RATIO b."""
    _, jparams = steps["jax"]
    params0 = glow_tts_params_from_jax(steps["variables"]["params"], steps["config"]["model"])
    dist = lambda ours: torch.sqrt(sum(((ours[k] - v) ** 2).sum() for k, v in jparams.items())).item()  # noqa: E731
    a, b = dist(steps["port16"][1]), dist(steps["port32"][1])
    step = torch.sqrt(sum(((jparams[k] - v) ** 2).sum() for k, v in params0.items())).item()
    assert a <= ROUNDING_RATIO * b, f"bf16 step {a:.3e} vs fp32 step {b:.3e} from JAX's bf16 step ({step:.3e})"


def test_bf16_glow_flow_step_route_matches_jax(flow_steps):
    """The B6 route (fused_flow_step: true): the bf16 step's losses within
    LOSS_RTOL of JAX's, fp32 masters, every flow step through flow_step in
    bf16 (n_blocks calls in the bf16 step, fp32 ones in the fp32 step), and
    the rounding points JAX's (the rounding ratio, as above)."""
    jscalars, jparams = flow_steps["jax"]
    scalars, params, model = flow_steps["port16"][:3]
    assert bool(scalars["finite"]) and bool(jscalars["finite"])
    for key in LOSS_KEYS:
        np.testing.assert_allclose(scalars[key], jscalars[key], rtol=LOSS_RTOL, err_msg=key)
    assert model.decoder.fused_flow_step and all(p.dtype == torch.float32 for p in params.values())
    n_blocks = flow_steps["config"]["model"]["decoder"]["n_blocks"]
    assert flow_steps["calls"] == [torch.bfloat16] * n_blocks + [torch.float32] * n_blocks
    params0 = glow_tts_params_from_jax(flow_steps["variables"]["params"], flow_steps["config"]["model"])
    dist = lambda ours: torch.sqrt(sum(((ours[k] - v) ** 2).sum() for k, v in jparams.items())).item()  # noqa: E731
    a, b = dist(flow_steps["port16"][1]), dist(flow_steps["port32"][1])
    step = torch.sqrt(sum(((jparams[k] - v) ** 2).sum() for k, v in params0.items())).item()
    assert a <= ROUNDING_RATIO * b, f"bf16 step {a:.3e} vs fp32 step {b:.3e} from JAX's bf16 step ({step:.3e})"


def test_bf16_glow_step_on_audio_matches_jax(audio_steps):
    """The CLI's Glow step (glow_tts on ljspeech_tpu, ``--bf16``): the mel is
    computed from the batch's audio in fp32 on both sides, so the flows run
    in fp32 with their bf16 weights promoted, B3 in its fp32 mode in both
    packages, while the encoder runs bf16. The losses within LOSS_RTOL of
    JAX's, the MAS prior fp32, and the rounding points JAX's (as above)."""
    port_dtypes, jax_dtypes = audio_steps["b3_dtypes"]
    n_blocks = audio_steps["config"]["model"]["decoder"]["n_blocks"]
    step_traces = [x0 for x0, w in jax_dtypes if w == "bfloat16"]
    assert step_traces and set(step_traces) == {"float32"} and len(step_traces) % n_blocks == 0
    assert port_dtypes == ["float32"] * (2 * n_blocks)  # the bf16 step's, then the fp32 step's
    jscalars, jparams = audio_steps["jax"]
    scalars, params = audio_steps["port16"][:2]
    assert bool(scalars["finite"]) and bool(jscalars["finite"])
    for key in LOSS_KEYS:
        np.testing.assert_allclose(scalars[key], jscalars[key], rtol=LOSS_RTOL, err_msg=key)
    assert audio_steps["jax_mas"][0].dtype == np.float32 and audio_steps["port16"][4].dtype == torch.float32
    params0 = glow_tts_params_from_jax(audio_steps["variables"]["params"], audio_steps["config"]["model"])
    dist = lambda ours: torch.sqrt(sum(((ours[k] - v) ** 2).sum() for k, v in jparams.items())).item()  # noqa: E731
    a, b = dist(params), dist(audio_steps["port32"][1])
    step = torch.sqrt(sum(((jparams[k] - v) ** 2).sum() for k, v in params0.items())).item()
    assert a <= ROUNDING_RATIO * b, f"bf16 step {a:.3e} vs fp32 step {b:.3e} from JAX's bf16 step ({step:.3e})"


@pytest.mark.parametrize("length", [256, 257, 263, 301, 383])
def test_bf16_lengths_round_as_jax(length):
    """A bf16 mask of ``length`` frames (of 384): mask_lengths and the
    ActNorm / InvConvNear logdet lengths against JAX's bf16 mask sums."""
    lens = np.array([384, length], np.int32)
    mask = sequence_mask(torch.from_numpy(lens), 384)[..., None].to(torch.bfloat16)
    jmask = jnp.asarray(mask.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jnp.sum(jmask[..., 0], axis=1).astype(jnp.int32))
    got = flows.mask_lengths(mask)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[1]) == int(torch.tensor(float(length)).to(torch.bfloat16).item())  # 263 -> 264, 301 -> 300
    x = torch.ones(2, 384, 8, dtype=torch.bfloat16)
    an, inv = flows.ActNorm(8), flows.InvConvNear(8, 4)
    with torch.no_grad():
        an.logs.fill_(0.5)
        logdet_a = an.to(torch.bfloat16)(x, mask, got)[1]
        logdet_i = inv.to(torch.bfloat16)(x, mask, got)[1]
    want_a = np.asarray((jnp.sum(jnp.full((8,), 0.5, jnp.bfloat16)) * jnp.sum(jmask, axis=(1, 2))).astype(jnp.float32))
    np.testing.assert_array_equal(logdet_a.float().numpy(), want_a)
    assert logdet_i.dtype == torch.float32
    np.testing.assert_allclose(logdet_i.numpy(), 0.0, atol=1e-5)  # the identity's log|det| is 0 at every length
