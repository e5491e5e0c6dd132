"""The port's Transformer LM against the JAX package's, on the CPU.

Model: 2 layers, d_model 64, 4 heads, ff 128, vocab 24 (+ PAD and BOS), and
for the frozen codec tests/fixtures/vqvae_tiny.yaml (zero_out false, flax
blocks on the JAX side; compression 128). Every leaf of the JAX variables
is drawn from a numpy seed and goes across through convert.py. Tokens are
BOS followed by seeded codes + OFFSET, padded with PAD to ragged lengths.
The JAX LM's ``fused_attention`` path runs its Pallas kernel in interpret
mode; the port's runs the plain ``attention_reference`` on the CPU.

Tolerances (fp32, other op orders): losses and accuracy rtol 1e-5; logits
and audio 1e-5 of their scale; the decode path 1e-5 against the JAX decode
and against the full forward. Train steps (Adam at lr 1e-3, clip by global
norm 0.5, 1 and 3 steps): losses rtol 1e-5, parameters and EMA parameters
atol 5e-5 (5% of lr). Adam's eps is 1e-6 here, not the config's 1e-9: the
key bias's true gradient is exactly zero (the softmax is invariant to it),
so both frameworks hand Adam rounding noise of about 1e-8 there, which
eps 1e-9 would turn into a step of up to lr in either direction. Frozen
codec parameters must stay bitwise unchanged in the port.
"""

import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.transformer_lm.model import TransformerEncoderLayer as JaxLayer
from speech_masters_thesis_tpu.models.transformer_lm.model import TransformerLM as JaxLM
from speech_masters_thesis_tpu.train import harness as jharness
from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.train import optim as joptim
from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
from speech_masters_thesis_tpu.utils.config import Config, load_config
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.convert import codebook_from_jax, transformer_lm_params_from_jax
from speech_masters_thesis_tpu_torch.models.transformer_lm import model as lm_model
from speech_masters_thesis_tpu_torch.models.transformer_lm.model import (
    BOS,
    OFFSET,
    PAD,
    TransformerLM,
    load_vqvae_into_lm,
)
from speech_masters_thesis_tpu_torch.train import harness, loop, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState
from speech_masters_thesis_tpu_torch.utils.registry import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, D_MODEL, HEADS, LAYERS = 24, 64, 4, 2
T, LENS = 12, (12, 8)
COMPRESSION = 128  # vqvae_tiny: strides 2, downs (3, 2, 2)
# the LM config's Adam, at a larger lr and eps (see the module docstring)
OPTIMIZER = {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.98], "weight_decay": 0, "eps": 1e-6}
SCHEDULER = {"name": "linear", "warmup_steps": 2}
CLIP, EMA_MU = 0.5, 0.9


def _lm_cfg(loss_type="ce", fused=True, layers=LAYERS):
    return {"_import_": "models.transformer_lm.transformer_lm.TransformerLM",
            "fused_attention": fused, "vocab_size": VOCAB, "embed_dim": D_MODEL, "max_len": 128,
            "num_layers": layers, "d_model": D_MODEL, "nhead": HEADS, "dim_feedforward": 128,
            "dropout": 0.0, "activation": "relu", "layer_norm_eps": 1e-5, "norm_first": False,
            "loss_type": loss_type}


def _vq_cfg():
    cfg = load_config(os.path.join(REPO, "tests/fixtures/vqvae_tiny.yaml")).to_dict()["model"]
    cfg.update(zero_out=False, fused_blocks=False)
    return cfg


def _tokens(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(OFFSET, VOCAB + OFFSET, (len(LENS), T)).astype(np.int32)
    tokens[:, 0] = BOS
    for b, n in enumerate(LENS):
        tokens[b, n:] = PAD
    return tokens, np.asarray(LENS, np.int32)


def _jax_model(lm_cfg, vq_cfg=None):
    config = {"model": lm_cfg}
    if vq_cfg is not None:
        config["vqvae_model_config"] = {"model": vq_cfg}
    return JaxLM(config=config)


def _variables(jmodel, seed=1):
    """The model's variables with every leaf drawn from a numpy seed: kernels
    N(0, 1/fan_in), the embedding N(0, 1), LayerNorm scales 1 + N(0, 0.1^2),
    biases N(0, 0.1^2); a seeded codebook, marked initialized."""
    tokens, lens = _tokens()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": key, "dropout": key, "codebook": key},
                                                jnp.asarray(tokens), jnp.asarray(lens), train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "embedding":
            value = rng.randn(*leaf.shape)
        elif leaf.ndim >= 2:
            value = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            value = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:
            value = 0.1 * rng.randn(*leaf.shape)
        return value.astype(np.float32)

    variables = {"params": jax.tree_util.tree_map_with_path(draw, shapes["params"])}
    if "codebook" in shapes:
        k_shape = shapes["codebook"]["vqvae_bottleneck"]["k"].shape
        k = rng.randn(*k_shape).astype(np.float32)
        variables["codebook"] = {"vqvae_bottleneck": {
            "k": k, "k_sum": k.copy(), "k_elem": np.ones(k_shape[0], np.float32),
            "initialized": np.ones((), bool)}}
    return variables


def _port_model(lm_cfg, variables, vq_cfg=None):
    model = harness.get_model({"model": copy.deepcopy(lm_cfg)}, vqvae_model_config=vq_cfg, device="cpu")
    state = transformer_lm_params_from_jax(variables["params"], vq_cfg)
    buffers = codebook_from_jax(variables["codebook"]) if vq_cfg is not None else {}
    if vq_cfg is not None:
        state["vqvae_bottleneck.k"] = buffers["vqvae_bottleneck.k"]
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        for name, value in buffers.items():
            model.get_buffer(name).copy_(value)
    return model


def _port_batch(tokens, lens):
    return {"token": torch.from_numpy(tokens.astype(np.int64)), "token_len": torch.from_numpy(lens)}


def _jax_batch(tokens, lens):
    return {"token": jnp.asarray(tokens), "token_len": jnp.asarray(lens), "audio": None,
            "audio_len": None, "speaker": None}


def test_lm_config_dicts_equal_yaml():
    cfg = load_config(os.path.join(REPO, "configs/models/transformer_lm_tpu.yaml")).to_dict()
    assert configs.TRANSFORMER_LM_TPU == cfg["model"]
    assert configs.TRANSFORMER_LM_TPU_OPTIMIZER == cfg["optimizer"]
    assert configs.TRANSFORMER_LM_TPU_SCHEDULER == cfg["scheduler"]


def test_params_from_jax_one_layer():
    """One layer's JAX params map onto torch ``nn.TransformerEncoderLayer``'s
    keys and layout (the reference checkpoint's), and the port's layer, the
    torch layer and the JAX layer then agree."""
    jmodel = _jax_model(_lm_cfg(layers=1))
    variables = _variables(jmodel, seed=2)
    sd = transformer_lm_params_from_jax(variables["params"])
    prefix = "transformer.layers.0."
    layer_sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    ref = torch.nn.TransformerEncoderLayer(D_MODEL, HEADS, 128, dropout=0.0, batch_first=True)
    assert set(layer_sd) == set(ref.state_dict())
    jparams = variables["params"]["layer_0"]
    np.testing.assert_array_equal(layer_sd["self_attn.in_proj_weight"].numpy(),
                                  jparams["self_attn"]["in_proj"]["kernel"].T)
    np.testing.assert_array_equal(layer_sd["linear1.weight"].numpy(), jparams["linear1"]["kernel"].T)
    np.testing.assert_array_equal(layer_sd["norm2.weight"].numpy(), jparams["norm2"]["scale"])
    ref.load_state_dict(layer_sd)
    ref.eval()
    port = lm_model.TransformerEncoderLayer(D_MODEL, HEADS, 128, 0.0)
    port.load_state_dict(layer_sd)

    x = np.random.RandomState(3).randn(2, T, D_MODEL).astype(np.float32)
    causal = np.tril(np.ones((T, T), bool))
    jout = JaxLayer(D_MODEL, HEADS, 128, 0.0).apply(
        {"params": jparams}, jnp.asarray(x), jnp.where(causal, 0.0, -1e9)[None, None], train=False)
    with torch.no_grad():
        ref_out = ref(torch.from_numpy(x), src_mask=torch.from_numpy(~causal))
        out = port(torch.from_numpy(x), torch.full((2,), T, dtype=torch.int32), train=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("loss_type", ["ce", "mmi", "focal"])
def test_lm_forward_matches_jax(loss_type, fused):
    cfg = _lm_cfg(loss_type, fused)
    jmodel = _jax_model(cfg)
    variables = _variables(jmodel, seed=4)
    tokens, lens = _tokens(seed=5)
    (jloss, jmetrics) = jmodel.apply(variables, jnp.asarray(tokens), jnp.asarray(lens), train=False)
    model = _port_model(cfg, variables)
    with torch.no_grad():
        loss_dict, metrics = model(torch.from_numpy(tokens.astype(np.int64)), torch.from_numpy(lens),
                                   train=False)
    assert loss_dict["yh"] is None and jloss["yh"] is None
    np.testing.assert_allclose(float(loss_dict["loss"]), float(jloss["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]), float(jmetrics["accuracy"]), rtol=1e-5)
    # train mode at dropout 0 is the same function
    with torch.no_grad():
        train_loss, _ = model(torch.from_numpy(tokens.astype(np.int64)), torch.from_numpy(lens))
    np.testing.assert_allclose(float(train_loss["loss"]), float(loss_dict["loss"]), rtol=1e-6)


@pytest.fixture(scope="module")
def codec_lm():
    cfg, vq_cfg = _lm_cfg(), _vq_cfg()
    jmodel = _jax_model(cfg, vq_cfg)
    variables = _variables(jmodel, seed=6)
    return cfg, vq_cfg, jmodel, variables


def test_eval_forward_reconstructs_through_the_frozen_codec(codec_lm):
    cfg, vq_cfg, jmodel, variables = codec_lm
    tokens, lens = _tokens(seed=7)
    (jloss, _) = jmodel.apply(variables, jnp.asarray(tokens), jnp.asarray(lens), train=False)
    model = _port_model(cfg, variables, vq_cfg)
    with torch.no_grad():
        loss_dict, _ = model(torch.from_numpy(tokens.astype(np.int64)), torch.from_numpy(lens),
                             train=False)
    want = np.asarray(jloss["yh"])
    assert want.shape == (len(LENS), (T - 1) * COMPRESSION) and loss_dict["yh"].shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(loss_dict["yh"].numpy(), want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(float(loss_dict["loss"]), float(jloss["loss"]), rtol=1e-5)


@pytest.fixture(scope="module")
def steps(codec_lm):
    """Three train steps on each side from the same variables, with the
    frozen-parameter mask; the states after steps 1 and 3, then the val step
    on the EMA parameters."""
    cfg, vq_cfg, jmodel, variables = codec_lm
    tokens, lens = _tokens(seed=8)
    jvars = jax.tree.map(jnp.asarray, variables)
    tx, _ = joptim.build_optimizer(
        Config({"model": cfg, "optimizer": OPTIMIZER, "scheduler": SCHEDULER}), CLIP,
        frozen_mask=jharness.frozen_param_mask(jmodel, jvars["params"]))
    jstate = JaxTrainState.create(jvars, tx, use_ema=True)
    jstep = jloop.make_train_step(jmodel, tx, EMA_MU, use_ema=True)

    model = _port_model(cfg, variables, vq_cfg)
    opt, schedule = optim.build_optimizer(harness.trainable_parameters(model), OPTIMIZER, SCHEDULER)
    state = TrainState.create(model, opt, use_ema=True)
    step = loop.make_train_step(schedule, EMA_MU, use_ema=True, grad_clip_norm=CLIP)
    frozen0 = {k: v.detach().clone() for k, v in model.named_parameters()
               if k.startswith(TransformerLM.FROZEN_PREFIXES)}
    codebook0 = {k: v.clone() for k, v in state.codebook.items()}

    out = {"frozen0": frozen0, "codebook0": codebook0, "vq_cfg": vq_cfg,
           "jparams0": jax.tree.map(np.asarray, jvars["params"])}
    for i in range(1, 4):
        jstate, jscalars = jstep(jstate, _jax_batch(tokens, lens), jax.random.PRNGKey(0))
        scalars = step(state, _port_batch(tokens, lens), 0)
        if i in (1, 3):
            out[i] = ((jax.tree.map(np.asarray, jscalars), jax.tree.map(np.asarray, jstate)),
                      ({k: v.numpy() for k, v in scalars.items()},
                       {k: v.detach().clone() for k, v in state.params.items()},
                       {k: v.clone() for k, v in state.ema_params.items()},
                       {k: v.clone() for k, v in state.codebook.items()}))
    val_tokens, val_lens = _tokens(seed=9)
    jloss, jmetrics = jloop.make_val_step(jmodel, use_ema=True)(jstate, _jax_batch(val_tokens, val_lens))
    loss, metrics = loop.make_val_step(use_ema=True)(state, _port_batch(val_tokens, val_lens))
    out["val"] = (jax.tree.map(np.asarray, jloss), jax.tree.map(np.asarray, jmetrics), loss, metrics)
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(steps, n_steps):
    vq_cfg = steps["vq_cfg"]
    (jscalars, jstate), (scalars, params, ema, codebook) = steps[n_steps]
    assert bool(scalars["finite"]) and bool(jscalars["finite"])
    assert set(scalars) == set(jscalars) == {"loss", "accuracy", "finite"}
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(scalars[key], jscalars[key], rtol=1e-5, err_msg=key)
    want_params = transformer_lm_params_from_jax(jstate.params, vq_cfg)
    want_ema = transformer_lm_params_from_jax(jstate.ema_params, vq_cfg)
    assert set(want_params) == set(params)
    for name, want in want_params.items():
        np.testing.assert_allclose(params[name].numpy(), want.numpy(), rtol=0, atol=5e-5, err_msg=name)
        np.testing.assert_allclose(ema[name].numpy(), want_ema[name].numpy(), rtol=0, atol=5e-5,
                                   err_msg=name)
    # the frozen codec: bitwise unchanged in the port, unchanged in JAX too
    for name, before in steps["frozen0"].items():
        assert torch.equal(params[name], before), name
    j0 = transformer_lm_params_from_jax(steps["jparams0"], vq_cfg)
    for name in steps["frozen0"]:
        np.testing.assert_array_equal(want_params[name].numpy(), j0[name].numpy(), err_msg=name)
    for name, before in steps["codebook0"].items():
        assert torch.equal(codebook[name], before), name
    # every trainable parameter moved
    for name, value in params.items():
        if name not in steps["frozen0"]:
            assert not torch.equal(value, j0[name]), name
    assert int(jstate.step) == n_steps


def test_val_step_matches_jax(steps):
    jloss, jmetrics, loss, metrics = steps["val"]
    np.testing.assert_allclose(float(loss["loss"]), float(jloss["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]), float(jmetrics["accuracy"]), rtol=1e-5)
    assert loss["y"] is None and jloss["y"] is None
    want = np.asarray(jloss["yh"])
    assert loss["yh"].shape == want.shape == (len(LENS), (T - 1) * COMPRESSION)
    np.testing.assert_allclose(loss["yh"].numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def _jax_decode_logits(jmodel, variables, tokens):
    """The JAX package's KV-cached decode, one token at a time
    (tests/test_transformer_lm.py:147-172)."""
    b, t = tokens.shape
    kc = jnp.zeros((LAYERS, b, t, HEADS, D_MODEL // HEADS))
    vc = jnp.zeros_like(kc)

    def step(m, tok, kc, vc, pos):
        x = m.embedding(tok) * math.sqrt(m.d_model)
        x = x + jax.lax.dynamic_slice_in_dim(m.pe, pos, 1, axis=0)[None]
        new_k, new_v = [], []
        for i, layer in enumerate(m.layers):
            x, k_c, v_c = layer.decode_step(x, kc[i], vc[i], pos)
            new_k.append(k_c)
            new_v.append(v_c)
        return m.classifier(m.final_norm(x)[:, 0]), jnp.stack(new_k), jnp.stack(new_v)

    outs = []
    for pos in range(t):
        logits, kc, vc = jmodel.apply(variables, jnp.asarray(tokens[:, pos:pos + 1]), kc, vc, pos,
                                      method=step)
        outs.append(np.asarray(logits))
    return np.stack(outs, axis=1)


def _port_decode_logits(model, tokens):
    """The port's decode path, one token at a time against its caches."""
    b, t = tokens.shape
    layers = model.transformer.layers
    caches = torch.zeros(2, len(layers), b, t, HEADS, D_MODEL // HEADS)
    outs = []
    with torch.no_grad():
        for pos in range(t):
            x = model.embedding(tokens[:, pos:pos + 1]) * math.sqrt(D_MODEL) + model.pe[None, pos:pos + 1]
            for i, layer in enumerate(layers):
                x = layer.decode_step(x, caches[0, i], caches[1, i], pos)
            outs.append(model.classifier(model.transformer.norm(x)[:, 0]))
    return torch.stack(outs, dim=1)


def test_decode_step_matches_jax_decode_and_the_full_forward(codec_lm):
    cfg, vq_cfg, jmodel, variables = codec_lm
    tokens, _ = _tokens(seed=10)
    tokens = tokens.copy()
    tokens[:, 1:] = np.random.RandomState(11).randint(OFFSET, VOCAB + OFFSET, (len(LENS), T - 1))
    model = _port_model(cfg, variables, vq_cfg)
    ours = _port_decode_logits(model, torch.from_numpy(tokens.astype(np.int64)))
    want = _jax_decode_logits(jmodel, variables, tokens)
    scale = np.abs(want).max()
    np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=1e-5 * scale)
    lens = torch.full((len(LENS),), T, dtype=torch.int32)
    with torch.no_grad():
        full = model.classifier(model._backbone(torch.from_numpy(tokens.astype(np.int64)), lens,
                                                train=False))
    np.testing.assert_allclose(ours.numpy(), full.numpy(), rtol=0, atol=1e-5 * scale)


def test_sampling_is_deterministic_per_generator(codec_lm):
    cfg, vq_cfg, _, variables = codec_lm
    model = _port_model(cfg, variables, vq_cfg)
    n_steps = 9
    audio, codes = model.sample(3, n_steps, torch.Generator().manual_seed(42))
    audio2, codes2 = model.sample(3, n_steps, torch.Generator().manual_seed(42))
    _, codes3 = model.sample(3, n_steps, torch.Generator().manual_seed(43))
    assert codes.shape == (3, n_steps) and codes.dtype == torch.int64
    assert int(codes.min()) >= 0 and int(codes.max()) < VOCAB
    assert audio.shape == (3, n_steps * COMPRESSION) and bool(torch.isfinite(audio).all())
    assert torch.equal(codes, codes2) and torch.equal(audio, audio2)
    assert not torch.equal(codes, codes3)
    # the codes fed back are code + OFFSET: the sampled sequence's own
    # teacher-forced logits equal the decode's, so replaying the draws'
    # uniforms against them gives the same codes
    gen = torch.Generator().manual_seed(42)
    seq = torch.cat([torch.full((3, 1), BOS), codes[:, :-1] + OFFSET], dim=1)
    with torch.no_grad():
        logits = model.classifier(model._backbone(seq, torch.full((3,), n_steps, dtype=torch.int32),
                                                  train=False))
    tiny = torch.finfo(torch.float32).tiny
    for pos in range(n_steps):
        u = torch.rand((3, VOCAB), generator=gen).clamp_(min=tiny)
        assert torch.equal(torch.argmax(logits[:, pos] - torch.log(-torch.log(u)), dim=-1), codes[:, pos])
    with pytest.raises(ValueError, match="max_len"):
        model.sample(1, 128, torch.Generator())


def test_harness_init_takes_flax_defaults_and_freezes_the_codec():
    vq_cfg = _vq_cfg()
    model = get_model(_lm_cfg(), vqvae_model_config=vq_cfg, device="cpu")
    harness.init_model_variables(model, None, seed=3)
    layer = model.transformer.layers[0]
    for w, fan_in in ((layer.linear1.weight, D_MODEL), (layer.linear2.weight, 128),
                      (layer.self_attn.in_proj_weight, D_MODEL), (model.classifier.weight, D_MODEL)):
        std = 1.0 / math.sqrt(fan_in)
        assert abs(w.std().item() / std - 1.0) < 0.1  # lecun normal, truncated at 2 sigma
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    for b in (layer.linear1.bias, layer.self_attn.in_proj_bias, layer.self_attn.out_proj.bias,
              layer.norm1.bias):
        assert not b.detach().any()
    assert bool((layer.norm1.weight == 1).all())
    emb = model.embedding.weight.detach()
    assert not emb[PAD].any() and abs(emb[1:].std().item() - 1.0) < 0.1
    conv = model.vqvae_decoder.level_blocks[0].blocks[0].weight  # the codec keeps its own init
    assert abs(conv.std().item() * math.sqrt(conv[0].numel()) - 1.0) < 0.3

    mask = harness.frozen_param_mask(model)
    assert set(mask) == {n for n, _ in model.named_parameters()}
    frozen = {n for n, keep in mask.items() if not keep}
    assert frozen == {n for n, _ in model.named_parameters() if n.startswith(("vqvae_decoder.",
                                                                             "vqvae_bottleneck."))}
    assert frozen  # the decoder's parameters; the codebook is a buffer
    trainable = harness.trainable_parameters(model)
    assert len(trainable) == len(mask) - len(frozen) and all(p.requires_grad for p in trainable)
    assert not any(p.requires_grad for n, p in model.named_parameters() if n in frozen)
    state = TrainState.create(model, optim.build_optimizer(trainable, OPTIMIZER)[0])
    assert set(state.codebook) == {f"vqvae_bottleneck.{k}" for k in ("k", "k_sum", "k_elem", "initialized")}


def test_load_vqvae_into_lm_grafts_decoder_and_codebook():
    vq_cfg = _vq_cfg()
    vqvae = get_model(copy.deepcopy(vq_cfg), device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in vqvae.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
        vqvae.bottleneck.level_blocks[0].k.copy_(torch.randn(vqvae.bottleneck.level_blocks[0].k.shape,
                                                             generator=gen))
    lm = get_model(_lm_cfg(), vqvae_model_config=vq_cfg, device="cpu")
    load_vqvae_into_lm(lm, vqvae.state_dict())
    for name, p in vqvae.decoders[0].named_parameters():
        assert torch.equal(lm.vqvae_decoder.get_parameter(name), p), name
    assert torch.equal(lm.vqvae_bottleneck.k, vqvae.bottleneck.level_blocks[0].k)
    assert bool(lm.vqvae_bottleneck.initialized)
    codes = torch.randint(0, vq_cfg["l_bins"], (2, 5), generator=gen)
    with torch.no_grad():
        y, _ = vqvae.decoders[0](vqvae.bottleneck.level_blocks[0].decode(codes), torch.ones(2, 5, 1))
        np.testing.assert_array_equal(lm.reconstruct(codes, torch.ones(2, 5)).numpy(), y[..., 0].numpy())
    partial = {k: v for k, v in vqvae.state_dict().items() if not k.endswith("out.weight")}
    with pytest.raises(KeyError, match="lacks"):
        load_vqvae_into_lm(get_model(_lm_cfg(), vqvae_model_config=vq_cfg, device="cpu"), partial)
