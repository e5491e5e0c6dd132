"""The port's Glow-TTS training path against the JAX package's, on the CPU.

* The plain recompute backwards of the coupling conditioner (B3) and of the
  encoder layer (B5) against ``jax.grad`` through the JAX package's Pallas
  kernels in interpret mode (p=0): dx and every weight gradient within 1e-4
  of the leaf's max|ref|, floored at 3e-4 of the largest leaf's, at valid
  rows for B5; the key bias's true gradient is zero (the softmax is
  invariant to it), so there both sides hold fp32 rounding and are held
  within 1e-6 of the largest leaf.
* Each plain backward against autograd through its own plain forward in
  fp64 (1e-10), at p=0 and p>0; the autograd Functions on the CPU against
  autograd through the plain route, through the weight norm to
  ``weight_v``/``weight_g``.
* The dropout hash streams: the uint32 formula element by element, one seed
  reproducing and another differing, keep rates within 5 sigma, the sites
  and layers independent.
* GlowTTS at tests/fixtures/glow_tts_tiny.yaml width (fused encoder and
  coupling, flow step off, dropout 0 and no prenet, whose JAX dropout is
  fixed at 0.1 and drawn by threefry): 1 and 3 train steps of Adam with the
  Noam schedule and the parameter EMA against the JAX ``make_train_step``
  (losses rtol 1e-5; parameters and EMA atol 5e-5, 5% of the largest step's
  learning rate, with warm-up 4 so that the parameters move by some 1e-3),
  and ``ddi_init`` against the JAX ``GlowTTS.ddi_init`` (rtol 1e-5, and
  1e-4 of the leaf's max where a value nears 0: the fp32 variance
  E[x^2] - E[x]^2 cancels on both sides where the mel's mean dominates).
* Train mode at p>0: finite and deterministic per generator, the prenet's,
  the layers' seeds and the duration predictor's masks drawn from it in
  order; the Noam rates of configs.GLOW_TTS_TPU against the JAX schedule.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.glow_tts.model import GlowTTS as JaxGlowTTS
from speech_masters_thesis_tpu.ops.pallas.enc_layer import EncLayerSpec, fused_enc_layer
from speech_masters_thesis_tpu.ops.pallas.wn_coupling import WNSpec, fused_wn_coupling
from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.train import optim as joptim
from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
from speech_masters_thesis_tpu.utils.config import Config
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.convert import glow_tts_params_from_jax
from speech_masters_thesis_tpu_torch.models.glow_tts import flows
from speech_masters_thesis_tpu_torch.models.glow_tts.flows import build_flow_cache
from speech_masters_thesis_tpu_torch.ops import enc_layer as el
from speech_masters_thesis_tpu_torch.ops import hash as ophash
from speech_masters_thesis_tpu_torch.ops import wn_coupling as wn
from speech_masters_thesis_tpu_torch.ops.basic import sequence_mask
from speech_masters_thesis_tpu_torch.train import harness, loop, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState

from test_torch_glow import batch_numpy, jax_variables, port_model, tiny_config

GRAD_RTOL, GRAD_FLOOR = 1e-4, 3e-4
OPTIMIZER = {"name": "adam", "lr": 0.01, "betas": [0.9, 0.98], "weight_decay": 0, "eps": 1e-6}
SCHEDULER = {"name": "noam", "warmup_steps": 4}
EMA_MU = 0.9
M32 = 0xFFFFFFFF


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dtype)


def _lens(rng, B, T):
    lens = rng.randint(max(1, T // 2), T + 1, (B,)).astype(np.int32)
    lens[0] = T
    return lens


def _assert_grads(ours: dict, ref: dict, rtol: float = GRAD_RTOL, zero=()):
    """Each leaf within rtol of max(its max|ref|, GRAD_FLOOR of the largest
    leaf's); a leaf in ``zero`` (true gradient 0) holds fp32 rounding on both
    sides, about 5e-8 of the largest leaf here: each side within 1e-6 of it."""
    top = max(np.abs(r).max() for r in ref.values())
    for name, r in ref.items():
        if name in zero:
            assert max(np.abs(r).max(), np.abs(np.asarray(ours[name])).max()) <= 1e-6 * top, name
            continue
        scale = max(np.abs(r).max(), GRAD_FLOOR * top)
        err = np.abs(np.asarray(ours[name]) - r).max()
        assert err <= rtol * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# plain backwards against the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,n_layers", [(7, 2), (33, 4)])
def test_wn_backward_plain_matches_jax_grad(T, n_layers):
    half, H, C, B, k = 6, 8, 12, 2, 5
    rng = np.random.RandomState(T + n_layers)
    lens = _lens(rng, B, T)
    valid = (np.arange(T)[None, :] < lens[:, None])[..., None]
    x0 = (rng.randn(B, T, half) * valid).astype(np.float32)
    g = rng.randn(B, T, C).astype(np.float32)
    w = lambda *shape: (rng.randn(*shape) / np.sqrt(shape[-2] if len(shape) > 1 else 10)).astype(np.float32)  # noqa: E731
    rs = [2 * H if i < n_layers - 1 else H for i in range(n_layers)]
    jw = {"ws": w(half, H), "bs": w(1, H), "wins": tuple(w(k, H, 2 * H) for _ in range(n_layers)),
          "bins": tuple(w(1, 2 * H) for _ in range(n_layers)), "wrss": tuple(w(H, r) for r in rs),
          "brss": tuple(w(1, r) for r in rs), "wend": w(H, C), "bend": w(1, C)}
    spec = WNSpec(half=half, hidden=H, out_channels=C, kernel_size=k, dilation_rate=2, n_layers=n_layers,
                  p_drop=0.0, interpret=True)

    def loss(x0_, p):
        out = fused_wn_coupling(spec, jnp.float32(0.0), jnp.asarray(lens), x0_, p["ws"], p["bs"], p["wins"],
                                p["bins"], p["wrss"], p["brss"], p["wend"], p["bend"])
        return jnp.sum(out * jnp.asarray(g))

    jdx, jgrads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x0), jax.tree.map(jnp.asarray, jw))
    conv = lambda a: np.transpose(np.asarray(a), (2, 1, 0))  # noqa: E731  [k, in, out] -> [out, in, k]
    ref = {"ws": conv(jgrads["ws"][None]), "bs": np.asarray(jgrads["bs"])[0], "wend": conv(jgrads["wend"][None]),
           "bend": np.asarray(jgrads["bend"])[0]}
    for i in range(n_layers):
        ref.update({f"win{i}": conv(jgrads["wins"][i]), f"bin{i}": np.asarray(jgrads["bins"][i])[0],
                    f"wrs{i}": conv(jgrads["wrss"][i][None]), f"brs{i}": np.asarray(jgrads["brss"][i])[0]})
    weights = wn.WNWeights(
        ws=_t(conv(jw["ws"][None])), bs=_t(jw["bs"][0]), win=tuple(_t(conv(a)) for a in jw["wins"]),
        bin=tuple(_t(b[0]) for b in jw["bins"]), wrs=tuple(_t(conv(a[None])) for a in jw["wrss"]),
        brs=tuple(_t(b[0]) for b in jw["brss"]), wend=_t(conv(jw["wend"][None])), bend=_t(jw["bend"][0]),
        dilations=tuple(2 ** i for i in range(n_layers)))
    dx0, grads = wn.wn_coupling_backward_reference(_t(x0), torch.from_numpy(lens), weights, _t(g))
    assert len(ref) == 4 + 4 * n_layers
    _assert_grads({"x0": dx0.numpy(), **{n: t.numpy() for n, t in grads.tensors().items()}},
                  {"x0": np.asarray(jdx), **ref})


@pytest.mark.parametrize("T", [3, 17])
def test_enc_backward_plain_matches_jax_grad(T):
    C, heads, window, F, k, B = 16, 2, 4, 24, 3, 2
    D = C // heads
    rng = np.random.RandomState(100 + T)
    lens = _lens(rng, B, T)
    valid = np.arange(T)[None, :] < lens[:, None]
    x = rng.randn(B, T, C).astype(np.float32)
    g = (rng.randn(B, T, C) * valid[..., None]).astype(np.float32)
    w = lambda *shape, fan: (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    p = {"wq": w(C, C, fan=C), "bq": w(1, C, fan=10), "wk": w(C, C, fan=C), "bk": w(1, C, fan=10),
         "wv": w(C, C, fan=C), "bv": w(1, C, fan=10), "rk": w(2 * window + 1, D, fan=D),
         "rv": w(2 * window + 1, D, fan=D), "wo": w(C, C, fan=C), "bo": w(1, C, fan=10),
         "g1": 1 + w(1, C, fan=100), "be1": w(1, C, fan=10), "w1": w(k, C, F, fan=k * C),
         "b1": w(1, F, fan=10), "w2": w(k, F, C, fan=k * F), "b2": w(1, C, fan=10),
         "g2": 1 + w(1, C, fan=100), "be2": w(1, C, fan=10)}
    spec = EncLayerSpec(channels=C, n_heads=heads, window=window, filter_channels=F, kernel_size=k, interpret=True)

    def loss(x_, params):
        out = fused_enc_layer(spec, jnp.float32(0.0), jnp.asarray(lens), x_, *params)
        return jnp.sum(out * jnp.asarray(g))

    jdx, jgrads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), [jnp.asarray(p[n]) for n in spec.param_names])
    conv = lambda a: np.transpose(np.asarray(a) if np.ndim(a) == 3 else np.asarray(a)[None], (2, 1, 0))  # noqa: E731
    port = lambda n, a: conv(a) if n[0] == "w" else np.asarray(a)[0] if n[0] in "bg" else np.asarray(a)  # noqa: E731
    weights = el.EncLayerWeights(*[_t(port(n, p[n])) for n in el.PARAM_NAMES], n_heads=heads, window=window)
    dx, grads = el.enc_layer_backward_reference(_t(x), torch.from_numpy(lens), weights, _t(g))
    ref = {n: port(n, jgrads[i]) for i, n in enumerate(spec.param_names)}
    assert set(ref) == set(el.PARAM_NAMES)
    _assert_grads({"x": dx.numpy()[valid], **{n: t.numpy() for n, t in grads.items()}},
                  {"x": np.asarray(jdx)[valid], **ref}, zero={"bk"})  # the softmax ignores a shift of every key


# ---------------------------------------------------------------------------
# the decompositions, in fp64, with dropout
# ---------------------------------------------------------------------------
def _wn_case(dtype=torch.float64, B=3, T=11, half=4, H=6, L=3, k=5, C=8):
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen, dtype=dtype) * 0.5  # noqa: E731
    w = wn.WNWeights(ws=r(H, half, 1), bs=r(H), win=tuple(r(2 * H, H, k) for _ in range(L)),
                     bin=tuple(r(2 * H) for _ in range(L)),
                     wrs=tuple(r(2 * H if i < L - 1 else H, H, 1) for i in range(L)),
                     brs=tuple(r(2 * H if i < L - 1 else H) for i in range(L)),
                     wend=r(C, H, 1), bend=r(C), dilations=tuple(2 ** i for i in range(L)))
    return w, torch.tensor([T, 7, 3], dtype=torch.int32), r(B, T, 2 * half), r(B, T, C)


def _enc_case(dtype=torch.float64, B=3, T=9, C=8, H=2, window=2, Fc=12, k=3):
    gen = torch.Generator().manual_seed(1)
    D, R = C // H, 2 * window + 1
    shapes = {"wq": (C, C, 1), "bq": (C,), "wk": (C, C, 1), "bk": (C,), "wv": (C, C, 1), "bv": (C,),
              "rk": (R, D), "rv": (R, D), "wo": (C, C, 1), "bo": (C,), "g1": (C,), "be1": (C,),
              "w1": (Fc, C, k), "b1": (Fc,), "w2": (C, Fc, k), "b2": (C,), "g2": (C,), "be2": (C,)}
    tensors = [torch.randn(*shapes[n], generator=gen, dtype=dtype) * 0.5 + (1.0 if n[0] == "g" else 0.0)
               for n in el.PARAM_NAMES]
    lens = torch.tensor([T, 6, 2], dtype=torch.int32)
    valid = sequence_mask(lens, T).to(dtype)[..., None]
    return (el.EncLayerWeights(*tensors, n_heads=H, window=window), lens,
            torch.randn(B, T, C, generator=gen, dtype=dtype), torch.randn(B, T, C, generator=gen, dtype=dtype) * valid)


@pytest.mark.parametrize("p_drop", [0.0, 0.3])
def test_wn_backward_plain_equals_autograd_fp64(p_drop):
    w, lens, x, g = _wn_case()
    x0 = x[..., :4]
    leaves = [t.clone().requires_grad_(True) for t in w.flat()]
    xl = x0.clone().requires_grad_(True)
    out = wn.wn_coupling_reference(xl, lens, wn.WNWeights.from_flat(leaves, w.dilations), 5, p_drop)
    want = torch.autograd.grad(out, [xl, *leaves], g)
    dx0, grads = wn.wn_coupling_backward_reference(x0, lens, w, g, 5, p_drop)
    for got, ref in zip([dx0, *grads.flat()], want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("p_drop", [0.0, 0.3])
def test_enc_backward_plain_equals_autograd_fp64(p_drop):
    w, lens, x, g = _enc_case()
    leaves = [t.clone().requires_grad_(True) for t in w.tensors().values()]
    xl = x.clone().requires_grad_(True)
    out = el.enc_layer_reference(xl, lens, w.with_tensors(leaves), 7, p_drop)
    want = torch.autograd.grad(out, [xl, *leaves], g)
    dx, grads = el.enc_layer_backward_reference(x, lens, w, g, 7, p_drop)
    for got, ref in zip([dx, *grads.values()], want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# the dropout hash streams
# ---------------------------------------------------------------------------
def _fmix(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _kept(seed: int, stream: int, counter: int, p: float) -> bool:
    key = _fmix((_fmix(seed) + (stream + 1) * 0x9E3779B9) & M32)
    return _fmix((_fmix(key ^ counter) + key) & M32) >= int(p * 2 ** 32)


def _masks(kind: str, seed, p: float) -> torch.Tensor:
    lens = torch.tensor([40, 33], dtype=torch.int32)
    if kind == "wn":
        return wn.keep_mask(seed, lens, 40, 2, 24, p)              # [B, T, 2H], layer 2
    if kind == "enc attention":
        return el.attention_keep(seed, lens, 2, 40, p)              # [B, heads, T, T]
    return el.dropout_keep(seed, lens, 40, 48, el.SITE_FFN_MID, p)  # [B, T, F]


@pytest.mark.parametrize("kind", ["wn", "enc attention", "enc rows"])
def test_masks_equal_the_uint32_formula(kind):
    seed, p = 123456789, 0.25
    mask = _masks(kind, seed, p)
    rng = np.random.RandomState(3)
    for _ in range(64):
        idx = tuple(int(rng.randint(n)) for n in mask.shape)
        if kind == "wn":
            stream, counter = idx[0] * wn.WN_STREAMS + 2, idx[1] * 24 + idx[2]
        elif kind == "enc attention":
            stream, counter = idx[0] * el.ENC_STREAMS + idx[1], idx[2] * 40 + idx[3]
        else:
            stream, counter = idx[0] * el.ENC_STREAMS + el.SITE_FFN_MID * 16, idx[1] * 48 + idx[2]
        want = ophash.keep_scale(p) if _kept(seed, stream, counter, p) else 0.0
        assert float(mask[idx]) == want, (idx, float(mask[idx]), want)
    assert set(torch.unique(mask).tolist()) == {0.0, np.float32(1 / (1 - p))}


@pytest.mark.parametrize("kind", ["wn", "enc attention", "enc rows"])
def test_masks_reproduce_per_seed_and_keep_rate(kind):
    p = 0.1
    a, b, other = _masks(kind, torch.tensor([77]), p), _masks(kind, 77, p), _masks(kind, 78, p)
    assert torch.equal(a, b)
    assert float(((a > 0) != (other > 0)).float().mean()) > p
    n = a.numel()
    assert abs(float((a > 0).float().mean()) - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)


def test_sites_and_layers_are_independent():
    """Two masks drop the same element as often as independent draws would:
    p^2 within 5 sigma, for each pair of sites of a layer, two layers of a
    conditioner and two heads."""
    p, seed, T, C = 0.2, 9, 64, 32
    lens = torch.tensor([T, T], dtype=torch.int32)
    rows = {s: el.dropout_keep(seed, lens, T, C, s, p) for s in (el.SITE_ATTN_Y, el.SITE_FFN_MID, el.SITE_FFN_Y)}
    att = el.attention_keep(seed, lens, 2, T, p)
    pairs = [(rows[1], rows[2]), (rows[1], rows[3]), (rows[2], rows[3]), (att[:, 0], att[:, 1]),
             (att[:, 0, :, :C], rows[1]), (wn.keep_mask(seed, lens, T, 0, C, p), wn.keep_mask(seed, lens, T, 1, C, p))]
    for a, b in pairs:
        both = float(((a == 0) & (b == 0)).float().mean())
        n = a.numel()
        assert abs(both - p * p) <= 5 * np.sqrt(p * p * (1 - p * p) / n), both


# ---------------------------------------------------------------------------
# the autograd Functions on the CPU, through the weight norm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_coupling_function_grads_equal_the_plain_route(p_drop):
    """The fused route (WNCouplingFunction, plain backward) and the plain
    route (autograd through wn_coupling_reference) of one coupling block in
    train mode, with the same seed: the same output and gradients of the
    input, weight_v, weight_g and the biases."""
    torch.manual_seed(0)
    block = flows.CouplingBlock(16, 12, 5, 2, 3, fused=True, p_dropout=p_drop)
    with torch.no_grad():
        for prm in block.parameters():
            prm.copy_(torch.randn(prm.shape) * 0.3 + (1.0 if prm.ndim == 3 and prm.shape[1:] == (1, 1) else 0.0))
    lens = torch.tensor([21, 14], dtype=torch.int32)
    mask = sequence_mask(lens, 21)[..., None]
    x = torch.randn(2, 21, 16) * mask
    results = []
    for max_t in (768, 0):
        block.fused_max_t = max_t
        block.zero_grad()
        xl = x.clone().requires_grad_(True)
        z, logdet = block(xl, mask, lens, train=True, generator=torch.Generator().manual_seed(4))
        ((z * torch.linspace(-1, 1, 16)).sum() + logdet.sum()).backward()
        results.append((z.detach(), xl.grad, {n: prm.grad.clone() for n, prm in block.named_parameters()}))
    (z0, dx0, g0), (z1, dx1, g1) = results
    torch.testing.assert_close(z0, z1, rtol=0, atol=1e-6)
    torch.testing.assert_close(dx0, dx1, rtol=0, atol=1e-5)
    assert any(n.endswith("weight_v") for n in g0) and any(n.endswith("weight_g") for n in g0)
    _assert_grads({n: g.numpy() for n, g in g0.items()}, {n: g.numpy() for n, g in g1.items()}, rtol=1e-5)


@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_encoder_function_grads_equal_the_plain_route(p_drop):
    """The fused route (EncLayerFunction, plain backward) and the plain route
    (autograd through enc_layer_reference) of a TextEncoder in train mode
    with the same generator: the same outputs and gradients of every
    parameter, the embedding and the prenet's included."""
    config = tiny_config()
    enc_cfg = config["model"]["encoder"]
    results = []
    for max_t in (512, 0):
        model = harness.get_model(copy.deepcopy(config), device="cpu")
        harness.init_model_variables(model, None, seed=3)
        enc = model.encoder
        enc.p_dropout = p_drop
        enc.fused_max_t = max_t
        with torch.no_grad():
            enc.pre.proj.weight.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(2))
        x, x_len, _, _ = batch_numpy()
        x_m, _, logw, _ = enc(torch.from_numpy(x).long(), torch.from_numpy(x_len).long(), train=True,
                              generator=torch.Generator().manual_seed(5))
        ((x_m * torch.linspace(-1, 1, x_m.shape[-1])).sum() + logw.sum()).backward()
        results.append((x_m.detach(), {n: prm.grad for n, prm in enc.named_parameters() if prm.grad is not None}))
    (m0, g0), (m1, g1) = results
    assert enc_cfg["prenet"] and set(g0) == set(g1) and "emb.weight" in g0 and "pre.conv_layers.0.weight" in g0
    torch.testing.assert_close(m0, m1, rtol=0, atol=1e-5)
    _assert_grads({n: g.numpy() for n, g in g0.items()}, {n: g.numpy() for n, g in g1.items()}, rtol=1e-5,
                  zero={n for n in g1 if n.endswith("conv_k.bias")})


def test_flow_cache_refuses_training():
    block = flows.CouplingBlock(16, 12, 5, 1, 2, fused=True, p_dropout=0.1)
    build_flow_cache(block)
    lens = torch.tensor([9], dtype=torch.int32)
    x, mask = torch.randn(1, 9, 16), torch.ones(1, 9, 1)
    with pytest.raises(RuntimeError, match="flow cache"):
        block(x, mask, lens, train=True, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="flow cache"):
        wn.wn_coupling(x[..., :8], lens, block.conditioner_weights(), torch.zeros(1, dtype=torch.int64), 0.1)
    with torch.no_grad():
        block(x, mask, lens)


# ---------------------------------------------------------------------------
# GlowTTS: train steps and DDI against JAX
# ---------------------------------------------------------------------------
def _no_dropout_config() -> dict:
    config = tiny_config()
    config["model"]["encoder"].update(p_dropout=0.0, prenet=False)
    config["model"]["decoder"]["p_dropout"] = 0.0
    return config


def _batches():
    x, x_len, y, y_len = batch_numpy()
    jbatch = {"token": jnp.asarray(x), "token_len": jnp.asarray(x_len), "spect": jnp.asarray(y),
              "spect_len": jnp.asarray(y_len), "speaker": None}
    batch = {"token": torch.from_numpy(x).long(), "token_len": torch.from_numpy(x_len).long(),
             "spect": torch.from_numpy(y), "spect_len": torch.from_numpy(y_len).long()}
    return jbatch, batch


@pytest.fixture(scope="module")
def steps():
    """Three train steps on each side from the same variables (dropout 0);
    the states after steps 1 and 3."""
    config = _no_dropout_config()
    jmodel = JaxGlowTTS(config=config)
    variables = jax_variables(jmodel)
    tx, _ = joptim.build_optimizer(Config({**config, "optimizer": OPTIMIZER, "scheduler": SCHEDULER}))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx, use_ema=True)
    jstep = jloop.make_train_step(jmodel, tx, EMA_MU, use_ema=True)
    model = port_model(config, variables)
    opt, schedule = optim.build_optimizer(model.parameters(), OPTIMIZER, SCHEDULER, config["model"])
    state = TrainState.create(model, opt, use_ema=True)
    step = loop.make_train_step(schedule, EMA_MU, use_ema=True)
    jbatch, batch = _batches()
    out = {"params0": {k: v.detach().clone() for k, v in model.named_parameters()}, "config": config}
    for i in range(1, 4):
        jstate, jscalars = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        scalars = step(state, batch, 0)
        if i in (1, 3):
            out[i] = (jax.tree.map(np.asarray, jscalars), jax.tree.map(np.asarray, jstate),
                      {k: v.numpy() for k, v in scalars.items()},
                      {k: v.detach().clone() for k, v in state.params.items()},
                      {k: v.clone() for k, v in state.ema_params.items()})
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(steps, n_steps):
    jscalars, jstate, scalars, params, ema = steps[n_steps]
    assert bool(scalars["finite"]) and bool(jscalars["finite"])
    for key in ("loss", "loss_mle", "loss_length"):
        np.testing.assert_allclose(scalars[key], jscalars[key], rtol=1e-5, err_msg=key)
    want, want_ema = (glow_tts_params_from_jax(tree, steps["config"]["model"])
                      for tree in (jstate.params, jstate.ema_params))
    assert set(want) == set(params)
    for name, value in want.items():
        np.testing.assert_allclose(params[name].numpy(), value.numpy(), rtol=0, atol=5e-5, err_msg=name)
        np.testing.assert_allclose(ema[name].numpy(), want_ema[name].numpy(), rtol=0, atol=5e-5, err_msg=name)
    moved = [n for n, v in params.items() if float((v - steps["params0"][n]).abs().max()) > 1e-4]
    assert len(moved) > 0.9 * len(params)  # all but the untouched embedding rows' and the like
    assert int(jstate.step) == n_steps


def test_ddi_init_matches_jax():
    config = _no_dropout_config()
    jmodel = JaxGlowTTS(config=config)
    variables = jax_variables(jmodel)
    jbatch, batch = _batches()
    want = glow_tts_params_from_jax(jmodel.ddi_init(variables, jbatch)["params"], config["model"])
    model = port_model(config, variables)
    assert harness.maybe_ddi_init(model, config, batch)
    got = model.state_dict()
    names = [f"decoder.flows.{3 * b}.{leaf}" for b in range(config["model"]["decoder"]["n_blocks"])
             for leaf in ("logs", "bias")]
    for name in names:
        assert not torch.equal(got[name], glow_tts_params_from_jax(variables["params"], config["model"])[name])
        # rtol 1e-5, and 1e-4 of the leaf's max|ref| where a value nears 0: both sides take the
        # variance as E[x^2] - E[x]^2 in fp32, which cancels where the mel's mean (-4) dominates
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-4 * np.abs(want[name].numpy()).max(), err_msg=name)


def test_ddi_whitens_each_actnorm_output():
    """After DDI, each ActNorm's output over the batch's valid frames has
    per-channel mean 0 and variance 1 (the port's own check of what the
    init is for, with the training config's dropout on)."""
    config = tiny_config()
    model = harness.get_model(config, device="cpu")
    harness.init_model_variables(model, None, seed=0)
    _, batch = _batches()
    model.ddi_init(batch, {"device_dropout": torch.Generator().manual_seed(1)})
    seen = []
    hooks = [f.register_forward_hook(lambda m, inp, out: seen.append((out[0], inp[1])))
             for f in model.decoder.flows if isinstance(f, flows.ActNorm)]
    with torch.no_grad():
        model(batch["token"], batch["token_len"], batch["spect"], batch["spect_len"], train=True,
              generators={"device_dropout": torch.Generator().manual_seed(1)})
    for hook in hooks:
        hook.remove()
    assert len(seen) == config["model"]["decoder"]["n_blocks"]
    for z, mask in seen:  # the same generator seed: every ActNorm sees its DDI pass's input again
        n = mask.sum()
        mean = (z * mask).sum(dim=(0, 1)) / n
        var = (z * z * mask).sum(dim=(0, 1)) / n - mean ** 2
        torch.testing.assert_close(mean, torch.zeros_like(mean), rtol=0, atol=1e-4)
        torch.testing.assert_close(var, torch.ones_like(var), rtol=0, atol=1e-3)


def test_maybe_ddi_init_only_when_asked():
    config = tiny_config()
    model = harness.get_model(config, device="cpu")
    _, batch = _batches()
    for cfg in ({**config, "model": {**config["model"], "ddi": False}}, {**config, "train": {"load_ckpt": "x"}}):
        assert not harness.maybe_ddi_init(model, cfg, batch)
    assert all(torch.count_nonzero(f.logs) == 0 for f in model.decoder.flows if isinstance(f, flows.ActNorm))


# ---------------------------------------------------------------------------
# train mode at p > 0
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dropout_model():
    config = tiny_config()
    model = port_model(config, jax_variables(JaxGlowTTS(config=config)))
    _, batch = _batches()
    return model, batch


def _train_loss(model, batch, seed: int):
    out, _ = model.supervised_step(batch, train=True, generators={"device_dropout": torch.Generator().manual_seed(seed)})
    return out


def test_train_mode_with_dropout_is_finite_and_deterministic(dropout_model):
    model, batch = dropout_model
    a, b, c = (_train_loss(model, batch, s) for s in (3, 3, 4))
    assert a["yh"] is None
    for key in ("loss", "loss_mle", "loss_length"):
        assert bool(torch.isfinite(a[key]))
        assert torch.equal(a[key], b[key]), key
    assert not torch.equal(a["loss"], c["loss"])
    with torch.no_grad():
        ev, _ = model.supervised_step(batch, train=False)
    assert not torch.equal(a["loss_mle"], ev["loss_mle"])


def test_train_mode_needs_the_device_generator(dropout_model):
    model, batch = dropout_model
    with pytest.raises(ValueError, match="device_dropout"):
        model.supervised_step(batch, train=True)


def test_encoder_masks_come_from_the_generator_in_order(dropout_model):
    """Replaying the generator by hand: the prenet's three masks, then one
    kernel seed per layer, then the duration predictor's two masks."""
    model, batch = dropout_model
    enc = model.encoder
    x, x_len = batch["token"], batch["token_len"]
    with torch.no_grad():
        x_m, _, logw, x_mask = enc(x, x_len, train=True, generator=torch.Generator().manual_seed(8))
        gen = torch.Generator().manual_seed(8)
        h = enc.pre(enc.emb(x) * np.sqrt(enc.hidden_channels), x_mask, True, gen)
        lens = x_len.to(torch.int32)
        for i in range(len(enc.attn_layers)):
            seed = torch.randint(0, 2 ** 32, (1,), generator=gen, dtype=torch.int64)
            h = el.enc_layer_reference(h, lens, enc.layer_weights(i), seed, enc.p_dropout)
        h = h * x_mask
        want_m = h @ enc.proj_m.weight[:, :, 0].t() + enc.proj_m.bias
        want_w = enc.proj_w(h, x_mask, enc.p_dropout, gen)
    torch.testing.assert_close(x_m, want_m * x_mask, rtol=0, atol=1e-6)
    torch.testing.assert_close(logw, want_w, rtol=0, atol=1e-6)
    assert enc.p_dropout > 0 and enc.pre is not None


def test_noam_rates_match_jax():
    config = {"model": configs.GLOW_TTS_TPU, "optimizer": configs.GLOW_TTS_TPU_OPTIMIZER,
              "scheduler": configs.GLOW_TTS_TPU_SCHEDULER}
    jschedule = joptim.build_schedule(Config(copy.deepcopy(config)))
    schedule = optim.build_schedule(config["optimizer"], config["scheduler"], config["model"])
    for count in (0, 1, 3999):
        np.testing.assert_allclose(schedule(count), float(jschedule(count)), rtol=1e-6)
    assert abs(schedule(0) - 192 ** -0.5 * 4000 ** -1.5) < 1e-12  # dim_model is the encoder width
