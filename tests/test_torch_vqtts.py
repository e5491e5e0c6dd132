"""The port's VQ-TTS against the JAX package's, on the CPU: the modules and
the eval forward.

Model: tests/test_vqtts.py's tiny config (codec width 8 x 2, 4 GatedHiFi
branches a block, 3 levels of 256x down; text encoder 2 layers of 12, 2
heads, window 4, prenet, mean_only; 11 + 1 tokens, 6 codes each, emb 8),
the JAX side unfused (flax blocks and encoder, MAS through its
``maximum_path``), the port's plain versions. Every leaf of the JAX params
is drawn from a numpy seed (the zero-init leaves included), the codebook is
a seeded numpy array marked initialized, and both go across through
``convert.vqtts_state_dict_from_jax`` / ``codebook_from_jax``. Inputs: 2
sequences of 5 and 4 tokens, 2048 and 1792 samples (8 and 7 code frames).

Tolerances (fp32, other op orders): eval losses rtol 1e-5; ``yh`` 1e-5 of
max|yh|; ``q_acc`` exactly (the codes and the predicted codes are the same
integers); ``ResNetBlock`` 1e-5 of max|out|; ``GroupedBottleneck``'s codes
exactly, ``y_d`` 1e-6, commit and fit rtol 1e-5, the EMA state rtol 1e-5 /
atol 1e-6; ``pairwise_l2`` rtol 1e-5 / atol 1e-5; the train-mode gradients
(dropout 0, no prenet, whose JAX rate is fixed at 0.1) 1e-4 of each leaf's
max|ref|, floored at 3e-4 of the largest leaf's (test_torch_glow_train.py's
rule).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.vqtts import model as jvqtts_model
from speech_masters_thesis_tpu.models.vqtts.bottleneck import GroupedBottleneck as JaxGrouped
from speech_masters_thesis_tpu.models.vqtts.model import VQTTS as JaxVQTTS
from speech_masters_thesis_tpu.models.vqtts.model import pairwise_l2 as jax_pairwise_l2
from speech_masters_thesis_tpu.models.vqvae.blocks import ResNetBlock as JaxResNetBlock
from speech_masters_thesis_tpu.utils.config import Config, load_config
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.convert import (
    codebook_from_jax,
    vqtts_params_from_jax,
    vqtts_state_dict_from_jax,
)
from speech_masters_thesis_tpu_torch.models.vqtts.bottleneck import GroupedBottleneck
from speech_masters_thesis_tpu_torch.models.vqtts.model import VQTTS, pairwise_l2
from speech_masters_thesis_tpu_torch.models.vqvae.blocks import ResNetBlock
from speech_masters_thesis_tpu_torch.train import harness

from test_vqtts import VQTTS_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_KEYS = ("loss", "loss_recon", "loss_stft", "loss_commit", "loss_dur", "loss_align", "loss_ce")
GRAD_RTOL, GRAD_FLOOR = 1e-4, 3e-4


def tiny_config(train: bool = False) -> dict:
    """The JAX test's config, unfused; for the train-mode comparisons dropout
    0 everywhere the config reaches, no prenet, no revival."""
    config = copy.deepcopy(VQTTS_CONFIG)
    config["model"].update(_import_="models.vqtts.vqtts.VQTTS", fused_blocks=False, fused_encoder=False)
    if train:
        config["model"].update(p_dropout=0.0, revival_threshold=0.0)
        config["model"]["encoder"].update(p_dropout=0.0, prenet=False)
    return config


class _QuantDecoderNoDropout(JaxResNetBlock):
    """The JAX model's quant decoder at p=0: its 0.1 is fixed in the model and
    drawn by threefry, which the port's generators cannot reproduce."""

    p_dropout: float = 0.0


def jax_model(config: dict, train: bool = False, monkeypatch=None) -> JaxVQTTS:
    if train:
        monkeypatch.setattr(jvqtts_model, "ResNetBlock", _QuantDecoderNoDropout)
    return JaxVQTTS(config=config)


def batch_numpy(seed: int = 2):
    rng = np.random.RandomState(seed)
    t_audio = 256 * 8
    tokens = rng.randint(0, 12, (2, 5)).astype(np.int32)
    token_lens = np.array([5, 4], np.int32)
    audio = rng.uniform(-0.5, 0.5, (2, t_audio)).astype(np.float32)
    audio_lens = np.array([t_audio, t_audio - 256], np.int32)
    return tokens, token_lens, audio, audio_lens


def jax_variables(jmodel: JaxVQTTS, config: dict, seed: int = 1) -> dict:
    """Every param leaf from a numpy seed: kernels N(0, 1/fan_in), embedding
    and relative tables N(0, 1/width), LayerNorm scales 1 + N(0, 0.1^2), the
    rest N(0, 0.1^2); the codebook N(0, 1), initialized."""
    x, x_len, y, y_len = (jnp.asarray(a) for a in batch_numpy())
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": key, "dropout": key, "codebook": key},
                                                x, x_len, y, y_len, train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("embedding", "emb_rel_k", "emb_rel_v"):
            value = rng.randn(*leaf.shape) / np.sqrt(leaf.shape[-1])
        elif leaf.ndim >= 2:
            value = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            value = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:
            value = 0.1 * rng.randn(*leaf.shape)
        return value.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    k_bins = shapes["codebook"]["quant_bottleneck"]["k"].shape
    k = rng.randn(*k_bins).astype(np.float32)
    codebook = {"quant_bottleneck": {"k": k, "k_sum": k.copy(), "k_elem": np.ones(k_bins[0], np.float32),
                                     "initialized": np.ones((), bool)}}
    return {"params": params, "codebook": codebook}


def port_model(config: dict, variables: dict) -> VQTTS:
    model = harness.get_model(copy.deepcopy(config), device="cpu")
    model.load_state_dict(vqtts_state_dict_from_jax(variables, config["model"]), strict=True)
    with torch.no_grad():
        for name, value in codebook_from_jax(variables["codebook"]).items():
            model.get_buffer(name).copy_(value)
    return model


def torch_batch(arrays) -> tuple:
    x, x_len, y, y_len = arrays
    return (torch.from_numpy(x).long(), torch.from_numpy(x_len).long(), torch.from_numpy(y),
            torch.from_numpy(y_len).long())


@pytest.fixture(scope="module")
def eval_case():
    config = tiny_config()
    jmodel = jax_model(config)
    variables = jax_variables(jmodel, config)
    arrays = batch_numpy()
    fwd = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))
    jout, jmetrics = fwd(variables, *(jnp.asarray(a) for a in arrays))
    return config, variables, arrays, jax.tree.map(np.asarray, (jout, jmetrics))


def test_eval_forward_matches_jax(eval_case):
    config, variables, arrays, (jout, jmetrics) = eval_case
    model = port_model(config, variables)
    with torch.no_grad():
        out, metrics = model(*torch_batch(arrays), train=False)
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(out[key]), float(jout[key]), rtol=1e-5, err_msg=key)
    yh, jyh = out["yh"].numpy(), jout["yh"]
    assert yh.shape == arrays[2].shape
    np.testing.assert_allclose(yh, jyh, rtol=0, atol=1e-5 * np.abs(jyh).max())
    assert float(metrics["q_acc"]) == float(jmetrics["q_acc"])


def test_eval_yh_decodes_the_predicted_relative_codes(eval_case):
    """Eval ``yh`` is the decoder at the predicted RELATIVE codes looked up in
    the full codebook (the reference's quirk), not at the quantized encodings."""
    config, variables, arrays, (jout, _) = eval_case
    model = port_model(config, variables)
    x, x_len, y, y_len = torch_batch(arrays)
    seen = []
    hook = model.audio_decoder.register_forward_hook(lambda m, inp, out: seen.append(inp[0]))
    with torch.no_grad():
        model(x, x_len, y, y_len, train=False)
    hook.remove()
    assert len(seen) == 2
    k = model.quant_bottleneck.k
    rows = seen[1].reshape(-1, k.shape[1])
    # every row of the second decode is a codebook row among the first l_bins
    dist = torch.cdist(rows, k[:model.l_bins])
    assert float(dist.min(dim=1).values.max()) == 0.0
    assert not torch.equal(seen[0], seen[1])


def test_train_mode_gradients_match_jax_grad(monkeypatch):
    config = tiny_config(train=True)
    jmodel = jax_model(config, train=True, monkeypatch=monkeypatch)
    variables = jax_variables(jmodel, config, seed=3)
    arrays = batch_numpy(seed=4)
    key = jax.random.PRNGKey(5)

    def loss_fn(params):
        (ld, _), _ = jmodel.apply({"params": params, "codebook": variables["codebook"]},
                                  *(jnp.asarray(a) for a in arrays), train=True,
                                  rngs={"dropout": key, "codebook": key}, mutable=["codebook"])
        return ld["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = vqtts_params_from_jax(jax.tree.map(np.asarray, jgrads), config["model"])

    model = port_model(config, variables)
    for m in model.quant_decoder.modules():  # the port's quant decoder at p=0 too
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    gens = {"dropout": torch.Generator().manual_seed(0), "codebook": torch.Generator().manual_seed(0),
            "device_dropout": torch.Generator().manual_seed(0)}
    out, _ = model(*torch_batch(arrays), train=True, generators=gens)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss), rtol=1e-5)
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(want)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        assert grads[name] is not None, name
        scale = max(float(w.abs().max()), GRAD_FLOOR * largest)
        err = float((grads[name] - w).abs().max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)
    # the text encoder learns through the duration, alignment and commit paths
    assert any(float(g.abs().max()) > 0 for n, g in grads.items() if n.startswith("text_encoder."))


@pytest.mark.parametrize("reverse", [True, False])
def test_resnet_block_matches_jax(reverse):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 37, 8).astype(np.float32)
    mask = np.ones((2, 37, 1), np.float32)
    mask[1, 29:] = 0.0
    jblock = JaxResNetBlock(8, 4, m_conv=2.0, dilation_growth_rate=3, zero_out=True, reverse_dilation=reverse)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                                                train=False))
    params = jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.3).astype(np.float32), shapes["params"])
    jout, jm = jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), train=False)
    block = ResNetBlock(8, 4, m_conv=2.0, dilation_growth_rate=3, zero_out=True, reverse_dilation=reverse)
    dilations = [layer.model[2].dilation[0] for layer in block.model]
    assert dilations == ([27, 9, 3, 1] if reverse else [1, 3, 9, 27])
    assert all(float(layer.model[5].weight.detach().abs().sum()) == 0 for layer in block.model)  # zero_out
    with torch.no_grad():
        for i, layer in enumerate(block.model):
            for j, conv in (("Conv_0", 2), ("Conv_1", 5)):
                tree = params[f"ResLayer_{i}"][j]
                layer.model[conv].weight.copy_(torch.from_numpy(np.transpose(tree["kernel"], (2, 1, 0)).copy()))
                layer.model[conv].bias.copy_(torch.from_numpy(tree["bias"]))
        out, m = block(torch.from_numpy(x), torch.from_numpy(mask))
    assert m is not None and torch.equal(m, torch.from_numpy(mask))
    jout = np.asarray(jout)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-5 * np.abs(jout).max())


def _grouped_case(seed: int, n_vocab: int = 5, l_bins: int = 7, c: int = 8):
    """Encodings [2, 9, c], ids [2, 4], a hard monotonic alignment (the second
    sequence 3 tokens over 7 frames) and a seeded codebook."""
    rng = np.random.RandomState(seed)
    y = rng.randn(2, 9, c).astype(np.float32)
    ids = rng.randint(0, n_vocab, (2, 4)).astype(np.int32)
    attn = np.zeros((2, 4, 9), np.float32)
    for b, bounds in enumerate(((0, 2, 5, 7, 9), (0, 3, 4, 7))):
        for t in range(len(bounds) - 1):
            attn[b, t, bounds[t]:bounds[t + 1]] = 1.0
    k = rng.randn(n_vocab * l_bins, c).astype(np.float32)
    return y, ids, attn, k


@pytest.mark.parametrize("update_k", [False, True])
def test_grouped_bottleneck_matches_jax(update_k):
    """Codes within each frame's group, y_d, commit, fit and (train mode,
    revival off) the EMA update on the absolute codes, against JAX."""
    n_vocab, l_bins, c = 5, 7, 8
    y, ids, attn, k = _grouped_case(7, n_vocab, l_bins, c)
    jvars = {"codebook": {"k": k, "k_sum": 2.0 * k, "k_elem": np.full(n_vocab * l_bins, 2.0, np.float32),
                          "initialized": np.ones((), bool)}}
    jbn = JaxGrouped(k_bins=n_vocab * l_bins, emb_width=c, mu=0.99, threshold=0.0, n_vocab=n_vocab, l_bins=l_bins)
    (jq, jyd, jcommit, jmetrics), mutated = jbn.apply(
        jvars, jnp.asarray(y), jnp.asarray(ids), jnp.asarray(attn), update_k=update_k,
        rngs={"codebook": jax.random.PRNGKey(0)}, mutable=["codebook"])
    bn = GroupedBottleneck(n_vocab * l_bins, c, 0.99, 0.0, n_vocab, l_bins)
    with torch.no_grad():
        for name, value in jvars["codebook"].items():
            getattr(bn, name).copy_(torch.from_numpy(np.asarray(value)))
    q, yd, commit, metrics = bn(torch.from_numpy(y), torch.from_numpy(ids), torch.from_numpy(attn),
                                update_k=update_k, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    # each valid frame's code is the nearest centroid of its own phoneme's group
    for b in range(2):
        for j in range(9):
            if attn[b, :, j].sum() == 0:
                continue
            group = k.reshape(n_vocab, l_bins, c)[ids[b, attn[b, :, j].argmax()]]
            assert q[b, j] == np.argmin(((y[b, j] - group) ** 2).sum(-1))
    np.testing.assert_allclose(yd.detach().numpy(), np.asarray(jyd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(commit), float(jcommit), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5, err_msg=key)
    for name in ("k", "k_sum", "k_elem"):
        np.testing.assert_allclose(getattr(bn, name).numpy(), np.asarray(mutated["codebook"][name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    if update_k:
        assert not np.allclose(bn.k_sum.numpy(), 2.0 * k)  # the update moved the EMA


def test_grouped_bottleneck_passes_the_encoder_gradient_in_eval():
    """As in the JAX package (and unlike the base block's eval forward), the
    straight-through value carries the encoder's gradient in both modes."""
    y, ids, attn, k = _grouped_case(8)
    bn = GroupedBottleneck(35, 8, 0.99, 0.0, 5, 7)
    with torch.no_grad():
        bn.k.copy_(torch.from_numpy(k))
        bn.initialized.fill_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    _, yd, _, _ = bn(yt, torch.from_numpy(ids), torch.from_numpy(attn), update_k=False)
    (grad,) = torch.autograd.grad(yd.sum(), yt)
    valid = torch.from_numpy(attn.sum(1) > 0)
    assert bool((grad[valid] == 1).all()) and bool((grad[~valid] == 0).all())


class _CountsHostReads(torch.Tensor):
    """A tensor that counts its reads on the host (``bool``), each a sync on the card."""
    reads = 0

    def __bool__(self):
        type(self).reads += 1
        return super().__bool__()


def test_grouped_lazy_init_draws_valid_rows_plus_noise():
    """The first train forward initializes every group's codes with valid
    encodings (padding rows, placed far away, never) drawn with replacement
    plus N(0, (0.01/sqrt(C))^2) noise, from the generator it is given; then
    ``initialized`` is set and later forwards do not draw again."""
    C, n_vocab, l_bins = 64, 4, 64
    rng = np.random.RandomState(9)
    y = torch.from_numpy(rng.randn(2, 150, C).astype(np.float32))
    y[1, 100:] += 50.0
    ids = torch.from_numpy(rng.randint(0, n_vocab, (2, 10)))
    attn = torch.zeros(2, 10, 150)
    for b, frames in enumerate((150, 100)):
        edges = np.linspace(0, frames, 11).astype(int)
        for t in range(10):
            attn[b, t, edges[t]:edges[t + 1]] = 1.0
    bn = GroupedBottleneck(n_vocab * l_bins, C, 0.99, 0.0, n_vocab, l_bins)
    snapshots = []
    original = bn._update_k
    bn._update_k = lambda *a: (snapshots.append(bn.k.clone()), original(*a))[1]
    assert not bool(bn.initialized) and not bn.init_seen
    _CountsHostReads.reads = 0
    bn._buffers["initialized"] = bn.initialized.as_subclass(_CountsHostReads)
    bn(y, ids, attn, update_k=True, generator=torch.Generator().manual_seed(10))
    reads = _CountsHostReads.reads
    assert reads == 1 and bn.init_seen and bool(bn.initialized)
    k_init = snapshots[0]
    flat, m = y.reshape(-1, C), attn.sum(1).reshape(-1)
    dist = torch.cdist(k_init, flat)
    _, idx = dist.min(dim=1)
    assert bool((m[idx] > 0).all())
    noise = k_init - flat[idx]
    std = 0.01 / np.sqrt(C)
    assert abs(noise.std().item() / std - 1.0) < 0.05
    assert abs(noise.mean().item()) < 5 * std / np.sqrt(noise.numel())
    # the same generator state draws the same rows: the init is the generator's
    replay = GroupedBottleneck(n_vocab * l_bins, C, 0.99, 0.0, n_vocab, l_bins)
    replay._maybe_init(flat, m, torch.Generator().manual_seed(10))
    torch.testing.assert_close(replay.k, k_init, rtol=0, atol=0)
    # later train forwards skip the check (and its sync with the card) and draw nothing
    k_first = bn.k.clone()
    bn(y, ids, attn, update_k=True, generator=torch.Generator().manual_seed(11))
    assert _CountsHostReads.reads == reads + 1  # the assert's own read above
    assert len(snapshots) == 2 and torch.equal(snapshots[1], k_first)


def test_pairwise_l2_matches_jax_and_direct():
    rng = np.random.RandomState(11)
    a = rng.randn(2, 6, 16).astype(np.float32)
    b = rng.randn(2, 13, 16).astype(np.float32)
    ours = pairwise_l2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    theirs = np.asarray(jax_pairwise_l2(jnp.asarray(a), jnp.asarray(b)))
    direct = np.sqrt(((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(-1))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, direct, rtol=1e-5, atol=1e-5)
    same = pairwise_l2(torch.from_numpy(a), torch.from_numpy(a))
    assert float(same.min()) == pytest.approx(1e-6)  # the clamp at 1e-12 on the diagonal


def test_convert_equals_export_vqtts(eval_case):
    """``vqtts_state_dict_from_jax`` is ``export_vqtts``, key for key and value
    for value, and is the port's ``state_dict``; ``codebook_from_jax`` adds
    the codebook's other buffers."""
    from tools.import_torch_checkpoint import export_vqtts

    config, variables, _, _ = eval_case
    ref = export_vqtts(variables, Config(config))
    ours = vqtts_state_dict_from_jax(variables, config["model"])
    assert set(ref) == set(ours)
    for key, value in ref.items():
        assert tuple(ours[key].shape) == value.shape, key
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    model = harness.get_model(copy.deepcopy(config), device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ours.items()}
    buffers = codebook_from_jax(variables["codebook"])
    assert set(buffers) == {f"quant_bottleneck.{n}" for n in ("k", "k_sum", "k_elem", "initialized")}
    assert all(tuple(model.get_buffer(n).shape) == tuple(v.shape) for n, v in buffers.items())


def test_configs_equal_the_yaml():
    cfg = load_config(os.path.join(REPO, "configs/models/vqtts_tpu.yaml")).to_dict()
    assert configs.VQTTS_TPU == cfg["model"]
    assert configs.VQTTS_TPU_OPTIMIZER == cfg["optimizer"]
    assert cfg["scheduler"] is None
    assert configs.VQTTS_TPU["fused_blocks"] and not configs.VQTTS_TPU["fused_encoder"]
