"""The port's bf16 mixed-precision Transformer LM train step against the JAX
package's ``make_train_step(..., bf16=True)``, on the CPU.

Model: tests/test_torch_lm.py's LM (2 layers, d_model 64, 4 heads, vocab
24, dropout 0, no codec) on its small-T attention route, so the JAX side
runs its Pallas attention kernel in interpret mode in its bf16 mode and the
port its plain bf16 versions (``FusedAttentionFunction`` on the CPU); no
randomness enters the step. The variables are drawn from a numpy seed and
cross as fp32 masters (convert.py); each side builds its own bf16 compute
copy in the step. The optimizer is SGD, so a parameter's update is lr
times its gradient, and the parameter EMA runs on the masters.

Tolerances (tests/test_torch_bf16_glow_train.py's design): the losses
within LOSS_RTOL (2^-8) of JAX's at each step; fp32 masters; and the
rounding points are JAX's: after 1 and 3 steps the port's bf16 parameters
lie closer to JAX's bf16 step's than the port's fp32 step's do, by
ROUNDING_RATIO. The backbone stays in bf16: every attention call of the
bf16 step takes bf16 q, k, v, which needs the positional table cast to the
activations' dtype before the add (JAX's model.py:318-322); the same check
run on a backbone without that cast sees fp32 and fails.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.train import optim as joptim
from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
from speech_masters_thesis_tpu.utils.config import Config
from speech_masters_thesis_tpu_torch.convert import transformer_lm_params_from_jax
from speech_masters_thesis_tpu_torch.models.transformer_lm import model as lm_model
from speech_masters_thesis_tpu_torch.models.transformer_lm.model import TransformerLM
from speech_masters_thesis_tpu_torch.ops.basic import dropout
from speech_masters_thesis_tpu_torch.train import loop, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState

from test_torch_lm import _jax_batch, _jax_model, _lm_cfg, _port_batch, _port_model, _tokens, _variables
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SGD = {"name": "sgd", "lr": 1e-2, "momentum": 0.0, "weight_decay": 0.0}
EMA_MU = 0.9
LOSS_RTOL = 2.0 ** -8
ROUNDING_RATIO = 0.5
SUM_RTOL = 2.0 ** -7  # tests/test_torch_bf16_wn_coupling.py's, for a bf16 output against fp32
STEPS = (1, 3)


def _port_steps(cfg, variables, tokens, lens, bf16: bool) -> dict:
    """step -> (scalars, fp32 masters) after each of max(STEPS) SGD steps."""
    model = _port_model(cfg, variables)
    opt, schedule = optim.build_optimizer(model.parameters(), SGD)
    state = TrainState.create(model, opt, use_ema=True)
    step = loop.make_train_step(schedule, EMA_MU, use_ema=True, bf16=bf16)
    out = {}
    for i in range(1, max(STEPS) + 1):
        scalars = step(state, _port_batch(tokens, lens), 0)
        out[i] = ({k: float(v) for k, v in scalars.items()}, {k: v.detach().clone() for k, v in state.params.items()})
    return out


@pytest.fixture(scope="module")
def steps():
    cfg = _lm_cfg()
    jmodel = _jax_model(cfg)
    variables = _variables(jmodel)
    tokens, lens = _tokens(seed=8)
    tx, _ = joptim.build_optimizer(Config({"model": cfg, "optimizer": SGD, "scheduler": None}))
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx, use_ema=True)
    jstep = jloop.make_train_step(jmodel, tx, EMA_MU, use_ema=True, bf16=True)
    jax_out = {}
    for i in range(1, max(STEPS) + 1):
        jstate, jscalars = jstep(jstate, _jax_batch(tokens, lens), jax.random.PRNGKey(0))
        jax_out[i] = ({k: float(v) for k, v in jscalars.items()},
                      transformer_lm_params_from_jax(jax.tree.map(np.asarray, jstate.params), None))
    return {"params0": transformer_lm_params_from_jax(variables["params"], None), "jax": jax_out,
            "port16": _port_steps(cfg, variables, tokens, lens, True),
            "port32": _port_steps(cfg, variables, tokens, lens, False),
            "model": lambda: _port_model(cfg, variables), "batch": _port_batch(tokens, lens)}


@pytest.mark.parametrize("n_steps", STEPS)
def test_bf16_lm_steps_match_jax(steps, n_steps):
    """The losses of every step up to n_steps within LOSS_RTOL, fp32
    masters, every parameter moved."""
    for i in range(1, n_steps + 1):
        jscalars, _ = steps["jax"][i]
        scalars, params = steps["port16"][i]
        assert scalars["finite"] and jscalars["finite"]
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(scalars[key], jscalars[key], rtol=LOSS_RTOL, err_msg=f"{key} step {i}")
    params = steps["port16"][n_steps][1]
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(not torch.equal(params[k], v) for k, v in steps["params0"].items())


@pytest.mark.parametrize("n_steps", STEPS)
def test_bf16_lm_steps_round_where_jax_rounds(steps, n_steps):
    """(a) the port's bf16 parameters from JAX's bf16 step's, (b) the port's
    fp32 step's from JAX's bf16 step's, over every parameter: a <=
    ROUNDING_RATIO b."""
    jparams = steps["jax"][n_steps][1]
    dist = lambda ours: math.sqrt(sum(float(((ours[k] - v) ** 2).sum()) for k, v in jparams.items()))  # noqa: E731
    a, b = dist(steps["port16"][n_steps][1]), dist(steps["port32"][n_steps][1])
    moved = dist(steps["params0"])
    assert a <= ROUNDING_RATIO * b, f"bf16 step {a:.3e} vs fp32 step {b:.3e} from JAX's bf16 step ({moved:.3e})"


@pytest.mark.parametrize("train", [False, True], ids=["sdpa", "plain-dropout"])
def test_bf16_attention_routes_above_the_small_t_bound(train, monkeypatch):
    """Above T = 1,024 the bf16 attention runs in bf16 on its other routes:
    SDPA without dropout (eval), the plain _attend with dropout (train);
    without dropout its output lies within SUM_RTOL relative L2 of the fp32
    module's on the same bf16-exact weights and inputs."""
    torch.manual_seed(4)
    attn = lm_model.MultiHeadSelfAttention(64, 2, dropout_p=0.1, fused=True)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    T = lm_model.SMALL_T_MAX + 1
    x = torch.randn(1, T, 64).to(torch.bfloat16)
    lens = torch.tensor([T - 7], dtype=torch.int32)
    routes = []
    for name in ("_attend", "_attend_sdpa", "_attend_smallt"):
        inner = getattr(lm_model.MultiHeadSelfAttention, name)
        monkeypatch.setattr(lm_model.MultiHeadSelfAttention, name,
                            lambda self, *a, _n=name, _f=inner: (routes.append(_n), _f(self, *a))[1])
    out = functional_call(attn, {n: p.to(torch.bfloat16) for n, p in attn.named_parameters()},
                          (x, lens, train, torch.Generator().manual_seed(0)))
    assert routes == ["_attend" if train else "_attend_sdpa"]
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
    if not train:
        ref = attn(x.float(), lens, False)
        assert ((out.float() - ref).norm() / ref.norm()).item() <= SUM_RTOL


def _unfixed_backbone(self, tokens, lens, train, generator=None):
    """``TransformerLM._backbone`` without the positional table's cast: the
    fault the bf16 step must not have."""
    x = self.embedding(tokens) * math.sqrt(self.d_model)
    x = x + self.pe[None, :x.shape[1]]
    if train and self.dropout_p > 0:
        x = dropout(x, self.dropout_p, generator)
    for layer in self.transformer.layers:
        x = layer(x, lens, train, generator)
    return self.transformer.norm(x)


def _attention_dtypes(steps, monkeypatch) -> set:
    """The dtypes of q, k, v at every small-T attention call of one bf16 train step."""
    seen, inner = [], lm_model.fused_attention

    def recording(q, k, v, *args):
        seen.append((q.dtype, k.dtype, v.dtype))
        return inner(q, k, v, *args)
    monkeypatch.setattr(lm_model, "fused_attention", recording)
    model = steps["model"]()
    opt, schedule = optim.build_optimizer(model.parameters(), SGD)
    state = TrainState.create(model, opt, use_ema=False)
    loop.make_train_step(schedule, EMA_MU, use_ema=False, bf16=True)(state, steps["batch"], 0)
    assert len(seen) == len(model.transformer.layers)
    return {d for call in seen for d in call}


def test_bf16_backbone_stays_bf16(steps, monkeypatch):
    """Every attention call of the bf16 step sees bf16 (the pe cast); on a
    backbone that adds pe uncast the same check fails: the activations turn
    fp32 (and torch's products then refuse the bf16 weights)."""
    assert _attention_dtypes(steps, monkeypatch) == {torch.bfloat16}
    monkeypatch.setattr(TransformerLM, "_backbone", _unfixed_backbone)
    try:
        unfixed = _attention_dtypes(steps, monkeypatch)
    except RuntimeError as err:
        assert "dtype" in str(err)
        unfixed = None
    assert unfixed != {torch.bfloat16}
