"""The port's VQ-VAE training step against the JAX package's, on the CPU.

Model: tests/fixtures/vqvae_tiny.yaml with zero_out false, linf_approx
false, p_dropout 0 and revival_threshold 0 (so no randomness enters the
step), flax blocks on the JAX side. The variables have the model's shapes
with every leaf drawn from a numpy seed and go across through convert.py;
the codebook is a seeded numpy array, marked initialized. Audio is 2 x 2048
samples with ragged lengths.

Tolerances (fp32, other op orders): losses and quantizer metrics rtol 1e-4;
codebook state rtol 1e-4 / atol 1e-6; parameters and EMA parameters after
AdamW atol 5e-5 at lr 1e-3. An update moves a parameter by about lr, and
Adam's normalised update passes on an element's relative gradient error;
the log-magnitude STFT loss makes fp32 gradients ill-conditioned (its
1/|Y| near the clamp), so small gradient elements agree only to a few
percent between two fp32 implementations.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_masters_thesis_tpu.models.vqvae.bottleneck import BottleneckBlock as JaxBlock
from speech_masters_thesis_tpu.models.vqvae.model import VQVAE as JaxVQVAE
from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.train import optim as joptim
from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
from speech_masters_thesis_tpu.utils.config import Config, load_config
from speech_masters_thesis_tpu_torch.convert import (
    codebook_from_jax,
    params_from_jax,
    vqvae_state_dict_from_jax,
)
from speech_masters_thesis_tpu_torch.models import ema as tema
from speech_masters_thesis_tpu_torch.models.vqvae.bottleneck import BottleneckBlock
from speech_masters_thesis_tpu_torch.train import harness, loop, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState

OPTIMIZER = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0.01, "eps": 1e-9}
EMA_MU = 0.9
LOSS_KEYS = ("loss", "loss_recon", "loss_stft", "loss_commit")
METRIC_KEYS = ("fit", "prenorm", "entropy", "used_curr", "usage", "dk")


def _model_cfg():
    cfg = load_config("tests/fixtures/vqvae_tiny.yaml").to_dict()["model"]
    cfg.update(zero_out=False, p_dropout=0.0, revival_threshold=0.0, fused_blocks=False)
    cfg["loss"]["linf_approx"] = False
    return cfg


def _batch(t=2048, seed=3):
    rng = np.random.RandomState(seed)
    audio = rng.uniform(-0.8, 0.8, (2, t)).astype(np.float32)
    lengths = np.array([t, t - 448], np.int32)
    return audio, lengths


def _variables(cfg, model, seed=1):
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key, "codebook": key},
        jnp.zeros((1, 256)), jnp.full((1,), 256), train=False))
    rng = np.random.RandomState(seed)
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


@pytest.fixture(scope="module")
def steps():
    """Three train steps on each side from the same variables; the states
    after step 1 and step 3, and the val step on the EMA params."""
    cfg = _model_cfg()
    jmodel = JaxVQVAE(config={"model": cfg})
    variables = _variables(cfg, jmodel)
    audio, lengths = _batch()

    tx, _ = joptim.build_optimizer(Config({"model": cfg, "optimizer": OPTIMIZER, "scheduler": None}))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx, use_ema=True)
    jstep = jloop.make_train_step(jmodel, tx, EMA_MU, use_ema=True)
    jbatch = {"audio": jnp.asarray(audio), "audio_len": jnp.asarray(lengths), "speaker": None}

    model = _port_model(cfg, variables)
    opt, schedule = optim.build_optimizer(model.parameters(), OPTIMIZER)
    state = TrainState.create(model, opt, use_ema=True)
    step = loop.make_train_step(schedule, EMA_MU, use_ema=True)
    batch = {"audio": torch.from_numpy(audio), "audio_len": torch.from_numpy(lengths)}

    out = {}
    for i in range(1, 4):
        jstate, jscalars = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        scalars = step(state, batch, 0)
        if i in (1, 3):
            out[i] = {
                "jax": (jax.tree.map(np.asarray, jscalars), jax.tree.map(np.asarray, jstate)),
                "port": ({k: v.numpy() for k, v in scalars.items()},
                         {k: v.detach().clone() for k, v in state.params.items()},
                         {k: v.clone() for k, v in state.ema_params.items()},
                         {k: v.clone() for k, v in state.codebook.items()}),
            }
    jloss, jmetrics = jloop.make_val_step(jmodel, use_ema=True)(jstate, jbatch)
    loss, metrics = loop.make_val_step(use_ema=True)(state, batch)
    out["val"] = (jax.tree.map(np.asarray, jloss), jmetrics, loss, metrics)
    out["cfg"] = cfg
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(steps, n_steps):
    cfg = steps["cfg"]
    (jscalars, jstate), (scalars, params, ema, codebook) = steps[n_steps]["jax"], steps[n_steps]["port"]
    assert bool(scalars["finite"]) and bool(jscalars["finite"])
    for key in LOSS_KEYS + METRIC_KEYS:
        np.testing.assert_allclose(scalars[key], jscalars[key], rtol=1e-4, err_msg=key)
    for name, want in params_from_jax(jstate.params, cfg).items():
        np.testing.assert_allclose(params[name].numpy(), want.numpy(), rtol=0, atol=5e-5, err_msg=name)
    for name, want in params_from_jax(jstate.ema_params, cfg).items():
        np.testing.assert_allclose(ema[name].numpy(), want.numpy(), rtol=0, atol=5e-5, err_msg=name)
    for name, want in codebook_from_jax(jstate.model_state["codebook"]).items():
        np.testing.assert_allclose(codebook[name].numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert int(jstate.step) == n_steps


def test_val_step_uses_ema_params_like_jax(steps):
    jloss, jmetrics, loss, metrics = steps["val"]
    assert jmetrics == {} and metrics == {}
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(loss[key]), float(jloss[key]), rtol=1e-4, err_msg=key)
    np.testing.assert_array_equal(loss["y"].numpy(), np.asarray(jloss["y"]))


def test_eval_forward_stops_encoder_gradients():
    """Eval mode: no gradient of the reconstruction terms reaches the
    encoder, in JAX and in the port; the commit term still does."""
    cfg = _model_cfg()
    jmodel = JaxVQVAE(config={"model": cfg})
    variables = _variables(cfg, jmodel, seed=5)
    audio, lengths = _batch(seed=6)

    def jloss(params, terms):
        loss_dict, _ = jmodel.apply({"params": params, "codebook": variables["codebook"]},
                                    jnp.asarray(audio), jnp.asarray(lengths), train=False)
        return sum(loss_dict[k] for k in terms)

    cases = ((("loss_recon", "loss_stft"), False), (("loss_commit",), True))
    jgrads_all = jax.jit(lambda p: [jax.grad(jloss)(p, terms)["encoder"] for terms, _ in cases])(
        variables["params"])
    model = _port_model(cfg, variables)
    encoder = [p for name, p in model.named_parameters() if name.startswith("encoders.")]
    for (terms, reaches), jgrads in zip(cases, jgrads_all):
        jnorm = sum(float(jnp.sum(g ** 2)) for g in jax.tree.leaves(jgrads))
        loss_dict, _ = model(torch.from_numpy(audio), torch.from_numpy(lengths), train=False)
        grads = torch.autograd.grad(sum(loss_dict[k] for k in terms), encoder, allow_unused=True)
        norm = sum(float((g ** 2).sum()) for g in grads if g is not None)
        assert (jnorm > 0) == reaches and (norm > 0) == reaches, (terms, jnorm, norm)
        if reaches:
            np.testing.assert_allclose(norm, jnorm, rtol=1e-3)


def _codebook(k, threshold, mu=0.99):
    k_bins, emb = k.shape
    jvars = {"k": k, "k_sum": k * 2.0, "k_elem": np.full(k_bins, 2.0, np.float32),
             "initialized": np.ones((), bool)}
    block = BottleneckBlock(k_bins, emb, mu, threshold)
    with torch.no_grad():
        block.k.copy_(torch.from_numpy(k))
        block.k_sum.copy_(torch.from_numpy(k * 2.0))
        block.k_elem.fill_(2.0)
        block.initialized.fill_(True)
    return jvars, block


def test_codebook_update_matches_jax():
    """EMA of k_sum/k_elem and the metrics, revival off (threshold 0)."""
    rng = np.random.RandomState(7)
    k = rng.randn(32, 16).astype(np.float32)
    x = rng.randn(2, 40, 16).astype(np.float32)
    mask = np.ones((2, 40), np.float32)
    mask[1, 25:] = 0.0
    jvars, block = _codebook(k, threshold=0.0)
    (jcodes, jxq, jcommit, jmetrics), mutated = JaxBlock(32, 16, 0.99, 0.0).apply(
        {"codebook": jvars}, jnp.asarray(x), jnp.asarray(mask), update_k=True,
        rngs={"codebook": jax.random.PRNGKey(0)}, mutable=["codebook"])
    codes, xq, commit, metrics = block(torch.from_numpy(x), torch.from_numpy(mask), update_k=True,
                                      generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(xq.detach().numpy(), np.asarray(jxq), atol=1e-6)
    np.testing.assert_allclose(float(commit), float(jcommit), rtol=1e-5)
    for key in METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5, err_msg=key)
    for name in ("k", "k_sum", "k_elem"):
        np.testing.assert_allclose(getattr(block, name).numpy(), np.asarray(mutated["codebook"][name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _nearest_valid(rows, x, mask):
    """For each row: distance to the nearest encoding, and whether that is valid."""
    flat = x.reshape(-1, x.shape[-1])
    dist = torch.cdist(rows, flat)
    d, idx = dist.min(dim=1)
    return rows - flat[idx], mask.reshape(-1)[idx] > 0


@pytest.mark.parametrize("revive", [False, True])
def test_init_and_revival_draw_valid_rows_plus_noise(revive):
    """Lazy init (first batch) and revival (every code under the threshold)
    draw valid encodings with replacement plus N(0, (0.01/sqrt(C))^2) noise."""
    C = 64
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 300, C).astype(np.float32))
    mask = torch.ones(2, 300)
    mask[1, 120:] = 0.0
    x[1, 120:] += 50.0  # padding rows far from every valid one
    block = BottleneckBlock(256, C, 0.99, 1e9 if revive else 1.0)
    gen = torch.Generator().manual_seed(9)
    if revive:
        block.k.copy_(torch.randn(256, C))
        block.initialized.fill_(True)
        block(x, mask, update_k=True, generator=gen)
        assert not bool(block.k_elem.ge(1e9).any())  # every code was revived
    else:
        assert not bool(block.initialized)
        block._maybe_init(x.reshape(-1, C), mask.reshape(-1), gen)
        assert bool(block.initialized)
        torch.testing.assert_close(block.k_sum, block.k)
        torch.testing.assert_close(block.k_elem, torch.ones(256))
    noise, valid = _nearest_valid(block.k, x, mask)
    assert bool(valid.all())
    std = 0.01 / np.sqrt(C)
    assert abs(noise.std().item() / std - 1.0) < 0.05
    assert abs(noise.mean().item()) < 5 * std / np.sqrt(noise.numel())


@pytest.mark.parametrize("name,args", [
    ("dummy_schedule", (3e-4,)),
    ("linear_warmup_schedule", (1e-3, 7)),
    ("noam_schedule", (1.0, 192, 40)),
    ("cosine_schedule", (2e-3, 25)),
])
def test_schedules_match_jax(name, args):
    ours, theirs = getattr(optim, name)(*args), getattr(joptim, name)(*args)
    for count in range(60):
        # the JAX schedules run in float32, the port's in float64
        np.testing.assert_allclose(ours(count), float(theirs(jnp.asarray(count))), rtol=1e-6,
                                   atol=1e-7 * args[0], err_msg=f"{name} at {count}")


def test_build_schedule_reads_the_config_sections():
    opt = {"lr": 0.5}
    assert optim.build_schedule(opt)(10) == 0.5
    noam = optim.build_schedule(opt, {"name": "noam", "warmup_steps": 4},
                                {"encoder": {"hidden_channels": 16}})
    assert noam(3) == optim.noam_schedule(0.5, 16, 4)(3)
    with pytest.raises(ValueError, match="total_steps"):
        optim.build_schedule(opt, {"name": "cosine"})


def _run_optimizer(ours, tx, grads_seq, params0):
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    opt = ours(params)
    jparams = [jnp.asarray(p) for p in params0]
    state = tx.init(jparams)
    for grads in grads_seq:
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    return [p.detach().numpy() for p in params], [np.asarray(p) for p in jparams]


def test_adamw_and_sgd_match_optax():
    rng = np.random.RandomState(10)
    params0 = [rng.randn(5, 7).astype(np.float32), rng.randn(11).astype(np.float32)]
    grads_seq = [[rng.randn(*p.shape).astype(np.float32) for p in params0] for _ in range(6)]
    adam = dict(name="adam", lr=3e-3, betas=[0.9, 0.98], eps=1e-9, weight_decay=0.05)
    ours, theirs = _run_optimizer(lambda ps: optim.build_optimizer(ps, adam)[0],
                                  optax.adamw(3e-3, b1=0.9, b2=0.98, eps=1e-9, weight_decay=0.05),
                                  grads_seq, params0)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    sgd = dict(name="sgd", lr=0.1, momentum=0.9, weight_decay=0.01)
    ours, theirs = _run_optimizer(
        lambda ps: optim.build_optimizer(ps, sgd)[0],
        optax.chain(optax.add_decayed_weights(0.01), optax.sgd(0.1, momentum=0.9)), grads_seq, params0)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(11)
    grads = [rng.randn(4, 3).astype(np.float32), rng.randn(6).astype(np.float32)]
    theirs, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = optim.clip_by_global_norm(ours, max_norm)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g ** 2).sum() for g in grads)), rtol=1e-6)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_ema_matches_jax():
    from speech_masters_thesis_tpu.models import ema as jema

    rng = np.random.RandomState(12)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    ours = tema.init_ema({k: torch.from_numpy(v) for k, v in params.items()})
    theirs = jema.init_ema({k: jnp.asarray(v) for k, v in params.items()})
    for _ in range(3):
        new = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        tema.ema_step(ours, {k: torch.from_numpy(v) for k, v in new.items()}, 0.984)
        theirs = jema.ema_step(theirs, {k: jnp.asarray(v) for k, v in new.items()}, 0.984)
    for k in params:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=1e-6, atol=1e-7)
    assert tema.default_mu(16, 1) == jema.default_mu(16, 1)
    assert tema.eval_params(params, ours, True) is ours and tema.eval_params(params, ours, False) is params


def test_step_generators_and_nan_guard():
    a = loop.step_generators(5, 3, torch.device("cpu"))
    b = loop.step_generators(5, 3, torch.device("cpu"))
    c = loop.step_generators(5, 4, torch.device("cpu"))
    draw = lambda g: torch.rand(4, generator=g)
    assert torch.equal(draw(a["dropout"]), draw(b["dropout"]))
    assert not torch.equal(draw(a["codebook"]), draw(c["codebook"]))
    assert not torch.equal(draw(b["dropout"]), draw(b["codebook"]))
    loop.raise_if_not_finite({"loss": torch.tensor(1.0), "finite": torch.tensor(True)}, 1)
    with pytest.raises(loop.NanLossError, match="step 7"):
        loop.raise_if_not_finite({"loss": torch.tensor(float("nan")), "finite": torch.tensor(False)}, 7)


def test_val_step_runs_supervised_step_on_the_ema(monkeypatch):
    """The val step is the model's ``supervised_step`` in eval mode, with the
    EMA tensors in place of the parameters, so it evaluates any task."""
    cfg = _model_cfg()
    model = _port_model(cfg, _variables(cfg, JaxVQVAE(config={"model": cfg}), seed=14))
    state = TrainState.create(model, optim.build_optimizer(model.parameters(), OPTIMIZER)[0], use_ema=True)
    with torch.no_grad():
        for e in state.ema_params.values():
            e.mul_(0.5)
    seen = []
    original = type(model).supervised_step

    def spy(self, batch, train=True, generators=None):
        seen.append((train, generators, self.encoders[0].level_blocks[0].blocks[0].weight))
        return original(self, batch, train=train, generators=generators)

    monkeypatch.setattr(type(model), "supervised_step", spy)
    audio, lengths = _batch(seed=15)
    batch = {"audio": torch.from_numpy(audio), "audio_len": torch.from_numpy(lengths)}
    loss, _ = loop.make_val_step(use_ema=True)(state, batch)
    ((train, generators, weight),) = seen
    name = "encoders.0.level_blocks.0.blocks.0.weight"
    assert train is False and generators is None
    assert weight is state.ema_params[name] and not torch.equal(weight, state.params[name])
    assert torch.equal(loss["y"], batch["audio"])


def test_train_state_codebook_and_frozen_mask_for_the_vqvae():
    """The VQ-VAE freezes nothing: every parameter trains; its codebook state
    is the bottleneck's four buffers."""
    model = harness.get_model({"model": _model_cfg()}, device="cpu")
    assert harness.frozen_param_mask(model) is None
    trainable = harness.trainable_parameters(model)
    assert len(trainable) == len(list(model.parameters())) and all(p.requires_grad for p in trainable)
    state = TrainState.create(model, optim.build_optimizer(trainable, OPTIMIZER)[0])
    prefix = "bottleneck.level_blocks.0."
    assert set(state.codebook) == {prefix + k for k in ("k", "k_sum", "k_elem", "initialized")}
    assert state.codebook[prefix + "k"] is model.get_buffer(prefix + "k")


def test_harness_init_runs_the_lazy_codebook_init():
    cfg = _model_cfg()
    cfg["zero_out"] = True
    model = harness.get_model({"model": cfg}, device="cpu")
    audio, lengths = _batch(seed=13)
    block = model.bottleneck.level_blocks[0]
    assert not bool(block.initialized)
    harness.init_model_variables(model, {"audio": torch.from_numpy(audio),
                                         "audio_len": torch.from_numpy(lengths)}, seed=4)
    assert bool(block.initialized) and float(block.k.abs().sum()) > 0
    gates = [m.gate.weight for m in model.modules() if hasattr(m, "gate")]
    assert gates and all(float(g.detach().abs().sum()) == 0 for g in gates)  # zero_out honoured
    expand = model.encoders[0].level_blocks[0].blocks[0].weight
    assert abs(expand.std().item() * np.sqrt(expand[0].numel()) - 1.0) < 0.3  # lecun-normal
