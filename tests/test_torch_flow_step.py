"""The port's whole-flow-step route (B6: ActNorm -> InvConvNear -> coupling
conditioner) against the JAX package's, on the CPU.

* The plain B6 forward against the JAX ``fused_flow_step`` in interpret mode
  (p=0), B = 2, T in {32, 7}, C = 8, H = 16, 2 layers, k in {3, 5}, dilation
  rate in {1, 2}, ragged lengths: xc and out within atol 2e-6; the plain
  backward against ``jax.vjp`` through that kernel with random cotangents of
  both outputs: dx, daln, dalb, dmt and every conditioner weight within 1e-5
  of each leaf's max|ref|; and against autograd of the plain forward in
  fp64 (1e-10), at p=0 and p>0.
* ``InvConvNear.dense_matrix_t`` against the JAX one (exactly), and x @ mt
  against the port's ``InvConvNear.forward`` (1e-6).
* ``FlowSpecDecoder(fused=True, fused_flow_step=True)`` against the JAX
  decoder on its B6 route with the same converted params: z (2e-6 of
  max|z|) and logdet (5e-5 of its max|ref|), and the gradient of sum(z^2) - mean(logdet) for every param within 5e-5 of
  its leaf's max|ref| + 1 (the JAX package's own fused-vs-unfused check).
* In train mode at p=0.05 with one generator seed, the B6 route against the
  B3 route: z and logdet within 1e-5 (they draw the same masks) and both
  generators left in the same state; reverse, DDI and squeezed T > 768 take
  B3 (the JAX package's routing).
* GlowTTS at tests/fixtures/glow_tts_tiny.yaml with ``fused_flow_step: true``:
  the eval losses (rtol 1e-5) and yh (1e-4 of max|yh|) against the JAX
  model, and 1 and 3 train steps (dropout 0, no prenet) against the JAX
  ``make_train_step`` at test_torch_glow_train.py's tolerances.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.glow_tts.encoder import FlowSpecDecoder as JaxFlowSpecDecoder
from speech_masters_thesis_tpu.models.glow_tts.flows import InvConvNear as JaxInvConvNear
from speech_masters_thesis_tpu.models.glow_tts.model import GlowTTS as JaxGlowTTS
from speech_masters_thesis_tpu.ops.pallas.wn_coupling import WNSpec, fused_flow_step
from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.train import optim as joptim
from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
from speech_masters_thesis_tpu.utils.config import Config
from speech_masters_thesis_tpu_torch.convert import _flow_decoder, glow_tts_params_from_jax
from speech_masters_thesis_tpu_torch.models.glow_tts import flows
from speech_masters_thesis_tpu_torch.models.glow_tts.encoder import FlowSpecDecoder
from speech_masters_thesis_tpu_torch.ops import flow_step as fs
from speech_masters_thesis_tpu_torch.ops import wn_coupling as wn
from speech_masters_thesis_tpu_torch.ops.basic import sequence_mask
from speech_masters_thesis_tpu_torch.train import loop, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState

from test_torch_glow import _orthogonal, batch_numpy, jax_variables, port_model, tiny_config
from test_torch_glow_train import EMA_MU, OPTIMIZER, SCHEDULER, _batches, _no_dropout_config

B, C, H, L = 2, 8, 16, 2
HALF = C // 2


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dtype)


def _conv(a) -> np.ndarray:
    """[k, in, out] (or [in, out]) -> PyTorch's [out, in, k]."""
    a = np.asarray(a)
    return np.transpose(a if a.ndim == 3 else a[None], (2, 1, 0))


def _dense_mt(weight: np.ndarray, c: int) -> np.ndarray:
    return np.asarray(JaxInvConvNear(channels=c, n_split=4).apply(
        {"params": {"weight": jnp.asarray(weight)}}, jnp.float32, method=JaxInvConvNear.dense_matrix_t))


def _case(T: int, k: int, rate: int):
    """Seeded inputs in the JAX kernel's layouts, and the port's weights."""
    rng = np.random.RandomState(100 * T + 10 * k + rate)
    lens = rng.randint(T // 2, T + 1, (B,)).astype(np.int32)
    lens[0] = T
    valid = (np.arange(T)[None, :] < lens[:, None])[..., None]
    w = lambda *shape, fan: (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    rs = [2 * H if i < L - 1 else H for i in range(L)]
    j = {"x": (rng.randn(B, T, C) * valid).astype(np.float32),
         "aln": w(1, C, fan=10), "alb": w(1, C, fan=10), "mt": _dense_mt(_orthogonal(rng, 4), C),
         "ws": w(HALF, H, fan=HALF), "bs": w(1, H, fan=10),
         "wins": tuple(w(k, H, 2 * H, fan=k * H) for _ in range(L)), "bins": tuple(w(1, 2 * H, fan=10) for _ in range(L)),
         "wrss": tuple(w(H, r, fan=H) for r in rs), "brss": tuple(w(1, r, fan=10) for r in rs),
         "wend": w(H, C, fan=H), "bend": w(1, C, fan=10)}
    spec = WNSpec(half=HALF, hidden=H, out_channels=C, kernel_size=k, dilation_rate=rate, n_layers=L, p_drop=0.0,
                  interpret=True)
    weights = wn.WNWeights(
        ws=_t(_conv(j["ws"])), bs=_t(j["bs"][0]), win=tuple(_t(_conv(a)) for a in j["wins"]),
        bin=tuple(_t(b[0]) for b in j["bins"]), wrs=tuple(_t(_conv(a)) for a in j["wrss"]),
        brs=tuple(_t(b[0]) for b in j["brss"]), wend=_t(_conv(j["wend"])), bend=_t(j["bend"][0]),
        dilations=tuple(rate ** i for i in range(L)))
    port = (_t(j["x"]), torch.from_numpy(lens), _t(j["aln"][0]), _t(j["alb"][0]), _t(j["mt"]), weights)
    return lens, j, spec, port


def _jax_flow_step(spec, lens, x, aln, alb, mt, params):
    return fused_flow_step(spec, jnp.float32(0.0), jnp.asarray(lens), x, aln, alb, mt, *params)


CASES = [(32, 5, 1), (32, 3, 2), (7, 5, 2), (7, 3, 1)]


@pytest.mark.parametrize("T,k,rate", CASES)
def test_plain_forward_matches_pallas_interpret(T, k, rate):
    lens, j, spec, port = _case(T, k, rate)
    params = [jnp.asarray(j[n]) if n in ("ws", "bs", "wend", "bend") else tuple(map(jnp.asarray, j[n]))
              for n in ("ws", "bs", "wins", "bins", "wrss", "brss", "wend", "bend")]
    xc_ref, out_ref = _jax_flow_step(spec, lens, *(jnp.asarray(j[n]) for n in ("x", "aln", "alb", "mt")), params)
    xc, out = fs.flow_step(*port)
    np.testing.assert_allclose(xc.numpy(), np.asarray(xc_ref), rtol=0, atol=2e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=0, atol=2e-6)


@pytest.mark.parametrize("T,k,rate", CASES)
def test_plain_backward_matches_jax_vjp(T, k, rate):
    lens, j, spec, port = _case(T, k, rate)
    names = ("x", "aln", "alb", "mt", "ws", "bs", "wins", "bins", "wrss", "brss", "wend", "bend")
    primals = [jax.tree.map(jnp.asarray, j[n]) for n in names]
    (xc_ref, out_ref), vjp = jax.vjp(lambda *a: _jax_flow_step(spec, lens, *a[:4], a[4:]), *primals)
    rng = np.random.RandomState(T + k)
    g_xc, g_out = (rng.randn(B, T, C).astype(np.float32) for _ in range(2))
    jg = dict(zip(names, vjp((jnp.asarray(g_xc), jnp.asarray(g_out)))))
    ref = {"dx": np.asarray(jg["x"]), "daln": np.asarray(jg["aln"])[0], "dalb": np.asarray(jg["alb"])[0],
           "dmt": np.asarray(jg["mt"]), "ws": _conv(jg["ws"]), "bs": np.asarray(jg["bs"])[0],
           "wend": _conv(jg["wend"]), "bend": np.asarray(jg["bend"])[0]}
    for i in range(L):
        ref.update({f"win{i}": _conv(jg["wins"][i]), f"bin{i}": np.asarray(jg["bins"][i])[0],
                    f"wrs{i}": _conv(jg["wrss"][i]), f"brs{i}": np.asarray(jg["brss"][i])[0]})
    dx, daln, dalb, dmt, grads = fs.flow_step_backward(*port, _t(g_xc), _t(g_out), torch.zeros(1, dtype=torch.int64))
    ours = {"dx": dx, "daln": daln, "dalb": dalb, "dmt": dmt, **grads.tensors()}
    assert set(ours) == set(ref) and len(ref) == 8 + 4 * L
    for name, r in ref.items():
        err = np.abs(ours[name].numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (name, err, np.abs(r).max())


@pytest.mark.parametrize("p_drop", [0.0, 0.3])
def test_plain_backward_equals_autograd_fp64(p_drop):
    _, _, _, (x, lens, aln, alb, mt, w) = _case(7, 5, 2)
    dt = torch.float64
    w = wn.WNWeights.from_flat([t.to(dt) for t in w.flat()], w.dilations)
    x, aln, alb, mt = (t.to(dt) for t in (x, aln, alb, mt))
    gen = torch.Generator().manual_seed(2)
    g_xc, g_out = (torch.randn(B, 7, C, generator=gen, dtype=dt) for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (x, aln, alb, mt, *w.flat())]
    xc, out = fs.flow_step_reference(leaves[0], lens, *leaves[1:4], wn.WNWeights.from_flat(leaves[4:], w.dilations),
                                     9, p_drop)
    want = torch.autograd.grad((xc, out), leaves, (g_xc, g_out))
    dx, daln, dalb, dmt, grads = fs.flow_step_backward_reference(x, lens, aln, alb, mt, w, g_xc, g_out, 9, p_drop)
    for got, ref in zip([dx, daln, dalb, dmt, *grads.flat()], want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("channels", [8, 160])
def test_dense_matrix_t_matches_jax_and_the_layer(channels):
    rng = np.random.RandomState(channels)
    weight = _orthogonal(rng, 4).astype(np.float32)
    layer = flows.InvConvNear(channels, 4)
    with torch.no_grad():
        layer.weight.copy_(_t(weight))
    mt = layer.dense_matrix_t()
    np.testing.assert_array_equal(mt.detach().numpy(), _dense_mt(weight, channels))
    lens = torch.tensor([9, 6], dtype=torch.int32)
    mask = sequence_mask(lens, 9)[..., None]
    x = _t(rng.randn(2, 9, channels)) * mask
    z, _ = layer(x, mask, lens)
    torch.testing.assert_close(x @ mt, z, rtol=0, atol=1e-6)
    (x @ mt).sum().backward()
    assert layer.weight.grad is not None and bool(layer.weight.grad.abs().sum() > 0)


# ---------------------------------------------------------------------------
# the decoder's B6 route
# ---------------------------------------------------------------------------
DEC = dict(hidden_channels=16, kernel_size=5, dilation_rate=2, n_blocks=2, n_layers=2, n_split=4, n_sqz=2)


def _decoder_params(seed: int):
    """JAX decoder params (every leaf drawn, end convs and ActNorm included),
    the port's FlowSpecDecoder with them on its B6 route, the inputs."""
    rng = np.random.RandomState(seed)
    T, lens = 32, np.array([32, 22])
    x = (rng.randn(B, T, HALF) * (np.arange(T)[None, :] < lens[:, None])[..., None]).astype(np.float32)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    jdec = JaxFlowSpecDecoder(in_channels=HALF, fused=True, p_dropout=0.05, **DEC)
    shapes = jax.eval_shape(lambda: jdec.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(mask),
                                              train=False))

    def draw(path, leaf):
        name = path[-1].key
        if name == "weight":
            return _orthogonal(rng, 4).astype(np.float32)
        if name == "g":
            return np.abs(1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if leaf.ndim >= 2:
            scale = 0.25 if "end" in [p.key for p in path] else 1.0
            return (scale * rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    dec = FlowSpecDecoder(HALF, fused=True, fused_flow_step=True, p_dropout=0.05, **DEC)
    dec.load_state_dict(_to_port(params))
    return jdec, params, dec, x, mask


def _to_port(tree) -> dict:
    sd = {}
    _flow_decoder(jax.tree.map(np.asarray, tree), "d", sd)
    return {k[2:]: v for k, v in sd.items()}


def test_decoder_matches_jax_flow_step_route():
    jdec, params, dec, x, mask = _decoder_params(0)

    def jloss(p):
        z, ld = jdec.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask), train=False)
        return jnp.sum(z ** 2) - jnp.mean(ld), (z, ld)

    (_, (jz, jld)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, params))
    z, ld = dec(_t(x), _t(mask))
    (torch.sum(z ** 2) - torch.mean(ld)).backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), rtol=0, atol=2e-6 * np.abs(np.asarray(jz)).max())
    # the logdet sums terms of both signs: 5e-5 of its max|ref|
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld), rtol=0, atol=5e-5 * np.abs(np.asarray(jld)).max())
    want = _to_port(jgrads)
    got = {n: p.grad for n, p in dec.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    for name, r in want.items():
        r = r.numpy()
        assert np.abs(got[name].numpy() - r).max() <= 5e-5 * (np.abs(r).max() + 1.0), name


def test_train_mode_b6_route_equals_b3_route():
    """Same generator seed, dropout 0.05: the two routes draw the same masks,
    so z and logdet agree, and they consume the generator alike."""
    _, _, dec, x, mask = _decoder_params(1)
    results = []
    for flow_step in (True, False):
        dec.fused_flow_step = flow_step
        gen = torch.Generator().manual_seed(11)
        with torch.no_grad():
            z, ld = dec(_t(x), _t(mask), train=True, generator=gen)
        results.append((z, ld, gen.get_state()))
    (z6, ld6, s6), (z3, ld3, s3) = results
    torch.testing.assert_close(z6, z3, rtol=0, atol=1e-5)
    torch.testing.assert_close(ld6, ld3, rtol=0, atol=1e-5)
    assert torch.equal(s6, s3)
    with torch.no_grad():
        z_eval, _ = dec(_t(x), _t(mask))
    assert not torch.allclose(z6, z_eval, atol=1e-3)  # dropout did act


@pytest.mark.parametrize("case", ["forward", "reverse", "ddi", "long"])
def test_routing(case, monkeypatch):
    """Which wrapper each decoder pass calls: B6 only for the forward
    direction without DDI at squeezed T <= fused_max_t (768)."""
    calls = []
    for name in ("flow_step", "flow_step_reference", "wn_coupling", "wn_coupling_reference"):
        fn = getattr(flows, name)
        monkeypatch.setattr(flows, name, lambda *a, _fn=fn, _name=name, **k: calls.append(_name) or _fn(*a, **k))
    dec = FlowSpecDecoder(HALF, fused=True, fused_flow_step=True, **DEC)
    T = 2 * 770 if case == "long" else 32
    x = torch.randn(1, T, HALF, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(1, T, 1)
    with torch.no_grad():
        dec(x, mask, reverse=case == "reverse", ddi=case == "ddi")
    want = {"forward": "flow_step", "reverse": "wn_coupling", "ddi": "wn_coupling", "long": "wn_coupling_reference"}
    assert calls == [want[case]] * DEC["n_blocks"]


# ---------------------------------------------------------------------------
# GlowTTS on the B6 route against the JAX model
# ---------------------------------------------------------------------------
def _flow_step_config(config: dict) -> dict:
    config = copy.deepcopy(config)
    config["model"]["fused_flow_step"] = True
    return config


def test_eval_forward_matches_jax():
    config = _flow_step_config(tiny_config())
    jmodel = JaxGlowTTS(config=config)
    variables = jax_variables(jmodel)
    model = port_model(config, variables)
    assert model.decoder.fused_flow_step
    x, x_len, y, y_len = batch_numpy()
    jout, _ = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(x_len), jnp.asarray(y), jnp.asarray(y_len),
                           train=False)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), jout["yh"].shape))
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x).long(), torch.from_numpy(x_len).long(), torch.from_numpy(y),
                       torch.from_numpy(y_len).long(), noise=torch.from_numpy(noise))
    for key in ("loss_mle", "loss_length", "loss"):
        np.testing.assert_allclose(float(out[key]), float(jout[key]), rtol=1e-5, err_msg=key)
    assert np.abs(out["yh"].numpy() - np.asarray(jout["yh"])).max() <= 1e-4 * np.abs(np.asarray(jout["yh"])).max()


@pytest.fixture(scope="module")
def steps():
    """Three train steps on each side on the B6 route (dropout 0); the states
    after steps 1 and 3."""
    config = _flow_step_config(_no_dropout_config())
    jmodel = JaxGlowTTS(config=config)
    variables = jax_variables(jmodel)
    tx, _ = joptim.build_optimizer(Config({**config, "optimizer": OPTIMIZER, "scheduler": SCHEDULER}))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx, use_ema=True)
    jstep = jloop.make_train_step(jmodel, tx, EMA_MU, use_ema=True)
    model = port_model(config, variables)
    assert model.decoder.fused_flow_step and config["model"]["decoder"]["p_dropout"] == 0.0  # both on B6
    opt, schedule = optim.build_optimizer(model.parameters(), OPTIMIZER, SCHEDULER, config["model"])
    state = TrainState.create(model, opt, use_ema=True)
    step = loop.make_train_step(schedule, EMA_MU, use_ema=True)
    jbatch, batch = _batches()
    out = {"config": config}
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
    want, want_ema = (glow_tts_params_from_jax(tree) for tree in (jstate.params, jstate.ema_params))
    assert set(want) == set(params)
    for name, value in want.items():
        np.testing.assert_allclose(params[name].numpy(), value.numpy(), rtol=0, atol=5e-5, err_msg=name)
        np.testing.assert_allclose(ema[name].numpy(), want_ema[name].numpy(), rtol=0, atol=5e-5, err_msg=name)
