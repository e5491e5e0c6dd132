"""The port's Glow-TTS kernels' plain versions and DSP against the JAX package,
on the CPU.

* B3 (coupling conditioner): ``wn_coupling`` on a CPU tensor (its plain
  version) against the Pallas ``fused_wn_coupling`` in interpret mode, at
  T in {7, 33, 64}, 2 and 4 layers, k in {3, 5}, rtol/atol 1e-5 of max|ref|;
  and the port's CouplingBlock against the JAX one on its flax path.
* B5 (encoder layer): ``enc_layer`` on a CPU tensor against the Pallas
  ``fused_enc_layer`` in interpret mode at valid rows (the kernel's softmax
  over padding rows is uniform over its padded width), T in {3, 17, 64}
  (3 is below the window), 1e-5 of max|ref|.
* B4 (MAS): the plain version bit for bit against JAX ``maximum_path`` and
  the Pallas ``maximum_path_pallas`` in interpret mode, with ragged masks and
  exact ties.
* generate_path, mas_log_prior, MelSpectrogram (1e-5 of max|mel|), STFT's
  inverse, Griffin-Lim with the same initial phase (1e-4 of max|audio|),
  the flows' invertibility and the flow cache, the weight mapping against
  tools/import_torch_checkpoint.py, and the configs against the YAML.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.glow_tts.flows import CouplingBlock as JaxCouplingBlock
from speech_masters_thesis_tpu.models.glow_tts.model import GlowTTS as JaxGlowTTS
from speech_masters_thesis_tpu.ops import basic as jbasic
from speech_masters_thesis_tpu.ops import griffin_lim as jgl
from speech_masters_thesis_tpu.ops import mas as jmas
from speech_masters_thesis_tpu.ops import stft as jstft
from speech_masters_thesis_tpu.ops.pallas.enc_layer import EncLayerSpec, fused_enc_layer
from speech_masters_thesis_tpu.ops.pallas.mas import maximum_path_pallas
from speech_masters_thesis_tpu.ops.pallas.wn_coupling import WNSpec, fused_wn_coupling
from speech_masters_thesis_tpu.utils.config import Config, load_config
from speech_masters_thesis_tpu_torch import configs
from speech_masters_thesis_tpu_torch.convert import _flow_decoder, glow_tts_params_from_jax
from speech_masters_thesis_tpu_torch.models.glow_tts import flows
from speech_masters_thesis_tpu_torch.models.glow_tts.encoder import FlowSpecDecoder
from speech_masters_thesis_tpu_torch.ops import basic, griffin_lim, mas, stft
from speech_masters_thesis_tpu_torch.ops.enc_layer import EncLayerWeights, enc_layer
from speech_masters_thesis_tpu_torch.ops.wn_coupling import WNWeights, wn_coupling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lens(rng, B, T):
    lens = rng.randint(max(1, T // 2), T + 1, (B,)).astype(np.int32)
    lens[0] = T
    return lens


def _close(ours: np.ndarray, ref: np.ndarray, rtol: float):
    scale = np.abs(ref).max()
    assert np.abs(ours - ref).max() <= rtol * scale, (np.abs(ours - ref).max(), scale)


# ---------------------------------------------------------------------------
# B3
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", [7, 33, 64])
@pytest.mark.parametrize("n_layers", [2, 4])
@pytest.mark.parametrize("k", [3, 5])
def test_wn_coupling_plain_matches_pallas_interpret(T, n_layers, k):
    half, H, C, B = 6, 8, 12, 2
    rng = np.random.RandomState(T * 10 + n_layers + k)
    lens = _lens(rng, B, T)
    valid = (np.arange(T)[None, :] < lens[:, None])[..., None]
    x0 = (rng.randn(B, T, half) * valid).astype(np.float32)

    def w(*shape, fan):
        return (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)

    ws, bs = w(half, H, fan=half), w(1, H, fan=10)
    wins = tuple(w(k, H, 2 * H, fan=k * H) for _ in range(n_layers))
    bins = tuple(w(1, 2 * H, fan=10) for _ in range(n_layers))
    rs = [2 * H if i < n_layers - 1 else H for i in range(n_layers)]
    wrss = tuple(w(H, r, fan=H) for r in rs)
    brss = tuple(w(1, r, fan=10) for r in rs)
    wend, bend = w(H, C, fan=H), w(1, C, fan=10)
    spec = WNSpec(half=half, hidden=H, out_channels=C, kernel_size=k, dilation_rate=1,
                  n_layers=n_layers, p_drop=0.0, interpret=True)
    ref = np.asarray(fused_wn_coupling(spec, jnp.float32(0.0), jnp.asarray(lens), jnp.asarray(x0),
                                       jnp.asarray(ws), jnp.asarray(bs), wins, bins, wrss, brss,
                                       jnp.asarray(wend), jnp.asarray(bend)))
    conv = lambda a: _t(np.transpose(a, (2, 1, 0)))  # noqa: E731  [k, in, out] -> [out, in, k]
    weights = WNWeights(ws=conv(ws[None]), bs=_t(bs[0]), win=tuple(conv(a) for a in wins),
                        bin=tuple(_t(b[0]) for b in bins), wrs=tuple(conv(a[None]) for a in wrss),
                        brs=tuple(_t(b[0]) for b in brss), wend=conv(wend[None]), bend=_t(bend[0]),
                        dilations=(1,) * n_layers)
    ours = wn_coupling(_t(x0), torch.from_numpy(lens), weights).numpy()
    _close(ours, ref, 1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_block_matches_jax_flax_path(reverse):
    C, H, T, B = 16, 12, 21, 2
    rng = np.random.RandomState(4)
    lens = _lens(rng, B, T)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    x = (rng.randn(B, T, C) * mask).astype(np.float32)
    jblock = JaxCouplingBlock(in_channels=C, hidden_channels=H, kernel_size=5, dilation_rate=2, n_layers=3,
                              fused=False)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                                                train=False))
    params = jax.tree_util.tree_map(lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32) + (
        1.0 if s.ndim == 1 and s.shape[0] == H else 0.0), shapes["params"])
    z_ref, ld_ref = jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), reverse=reverse,
                                 train=False)
    block = flows.CouplingBlock(C, H, 5, 2, 3, fused=True)
    sd = {}
    _flow_decoder({"actnorm_0": {"logs": np.zeros(C), "bias": np.zeros(C)}, "invconv_0": {"weight": np.eye(4)},
                   "coupling_0": params}, "decoder", sd)
    prefix = "decoder.flows.2."
    block.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    z, ld = block(_t(x), _t(mask), torch.from_numpy(lens), reverse=reverse)
    _close(z.detach().numpy(), np.asarray(z_ref), 1e-5)
    if not reverse:
        np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ld_ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# B5
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", [3, 17, 64])
def test_enc_layer_plain_matches_pallas_interpret(T):
    C, heads, window, F, k, B = 16, 2, 4, 24, 3, 2
    D = C // heads
    rng = np.random.RandomState(T)
    lens = _lens(rng, B, T)
    x = rng.randn(B, T, C).astype(np.float32)

    def w(*shape, fan):
        return (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)

    p = {"wq": w(C, C, fan=C), "bq": w(1, C, fan=10), "wk": w(C, C, fan=C), "bk": w(1, C, fan=10),
         "wv": w(C, C, fan=C), "bv": w(1, C, fan=10), "rk": w(2 * window + 1, D, fan=D),
         "rv": w(2 * window + 1, D, fan=D), "wo": w(C, C, fan=C), "bo": w(1, C, fan=10),
         "g1": 1 + w(1, C, fan=100), "be1": w(1, C, fan=10), "w1": w(k, C, F, fan=k * C),
         "b1": w(1, F, fan=10), "w2": w(k, F, C, fan=k * F), "b2": w(1, C, fan=10),
         "g2": 1 + w(1, C, fan=100), "be2": w(1, C, fan=10)}
    spec = EncLayerSpec(channels=C, n_heads=heads, window=window, filter_channels=F, kernel_size=k,
                        interpret=True)
    ref = np.asarray(fused_enc_layer(spec, jnp.float32(0.0), jnp.asarray(lens), jnp.asarray(x),
                                     *[jnp.asarray(p[n]) for n in spec.param_names]))
    conv = lambda a: _t(np.transpose(a if a.ndim == 3 else a[None], (2, 1, 0)))  # noqa: E731
    weights = EncLayerWeights(
        wq=conv(p["wq"]), bq=_t(p["bq"][0]), wk=conv(p["wk"]), bk=_t(p["bk"][0]), wv=conv(p["wv"]),
        bv=_t(p["bv"][0]), rk=_t(p["rk"]), rv=_t(p["rv"]), wo=conv(p["wo"]), bo=_t(p["bo"][0]),
        g1=_t(p["g1"][0]), be1=_t(p["be1"][0]), w1=conv(p["w1"]), b1=_t(p["b1"][0]), w2=conv(p["w2"]),
        b2=_t(p["b2"][0]), g2=_t(p["g2"][0]), be2=_t(p["be2"][0]), n_heads=heads, window=window)
    ours = enc_layer(_t(x), torch.from_numpy(lens), weights).numpy()
    valid = np.arange(T)[None, :] < lens[:, None]
    _close(ours[valid], ref[valid], 1e-5)


# ---------------------------------------------------------------------------
# B4
# ---------------------------------------------------------------------------
def _mas_inputs(seed, B, t_x, t_y, ties):
    rng = np.random.RandomState(seed)
    value = rng.randn(B, t_x, t_y).astype(np.float32)
    if ties:
        value = np.round(value * 4) / 4  # multiples of 0.25: exact ties in the DP
    x_len = _lens(rng, B, t_x)
    y_len = np.maximum(_lens(rng, B, t_y), x_len)
    mask = ((np.arange(t_x)[None, :, None] < x_len[:, None, None])
            & (np.arange(t_y)[None, None, :] < y_len[:, None, None])).astype(np.float32)
    return value, mask


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(3, 5, 12), (2, 17, 40)])
def test_maximum_path_bitwise_equals_jax_and_pallas(shape, ties):
    value, mask = _mas_inputs(sum(shape) + ties, *shape, ties)
    ours = mas.maximum_path_auto(_t(value), _t(mask)).numpy()
    ref = np.asarray(jmas.maximum_path(jnp.asarray(value), jnp.asarray(mask)))
    pallas = np.asarray(maximum_path_pallas(jnp.asarray(value), jnp.asarray(mask), interpret=True))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, pallas)
    # a monotone path that covers every valid frame once
    np.testing.assert_array_equal(ours.sum(axis=1), mask[:, 0, :])


def test_generate_path_and_log_prior_match_jax():
    rng = np.random.RandomState(0)
    duration = np.ceil(rng.uniform(0.2, 4.0, (2, 6))).astype(np.float32)
    mask = np.ones((2, 6, 30), np.float32)
    mask[1, 4:] = 0
    mask[1, :, 20:] = 0
    np.testing.assert_array_equal(basic.generate_path(_t(duration), _t(mask)).numpy(),
                                  np.asarray(jbasic.generate_path(jnp.asarray(duration), jnp.asarray(mask))))
    x_m, x_logs, z = rng.randn(2, 6, 5), 0.3 * rng.randn(2, 6, 5), rng.randn(2, 30, 5)
    ours = mas.mas_log_prior(_t(x_m), _t(x_logs), _t(z)).numpy()
    ref = np.asarray(jmas.mas_log_prior(*(jnp.asarray(a, jnp.float32) for a in (x_m, x_logs, z))))
    _close(ours, ref, 1e-6)


# ---------------------------------------------------------------------------
# DSP
# ---------------------------------------------------------------------------
def _audio(frames=24, hop=256, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(frames * hop) / 22050.0
    return (0.4 * np.sin(2 * np.pi * 220 * t)[None] + 0.05 * rng.randn(2, frames * hop)).astype(np.float32)


def test_mel_spectrogram_matches_jax():
    ds = configs.LJSPEECH_TPU
    audio = _audio()
    ref = np.asarray(jstft.MelSpectrogram(ds["sample_rate"], ds["n_fft"], ds["hop_length"], ds["win_length"],
                                          ds["n_mels"], *jstft.mel_band_edges(Config(ds)))(jnp.asarray(audio)))
    ours = stft.mel_from_config(ds)(_t(audio)).numpy()
    assert ours.shape == ref.shape == (2, 24, 80)
    _close(ours, ref, 1e-5)
    np.testing.assert_array_equal(stft.mel_filterbank(22050, 1024, 80, 0.0, 8000.0),
                                  jstft.mel_filterbank(22050, 1024, 80, 0.0, 8000.0))
    np.testing.assert_array_equal(stft.window_sumsquare(stft.hann_window(1024), 7, 256, 1024),
                                  jstft.window_sumsquare(jstft.hann_window(1024), 7, 256, 1024))


def test_stft_inverse_matches_jax_and_rejects_no_overlap():
    rng = np.random.RandomState(1)
    mag = np.abs(rng.randn(2, 10, 513)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, 10, 513)).astype(np.float32)
    ref = np.asarray(jstft.STFT(1024, 256, 1024).inverse(jnp.asarray(mag), jnp.asarray(phase)))
    ours = stft.STFT(1024, 256, 1024).inverse(_t(mag), _t(phase)).numpy()
    assert ours.shape == ref.shape == (2, 2560)
    _close(ours, ref, 1e-5)
    with pytest.raises(ValueError):
        stft.STFT(256, 256).inverse(_t(mag[..., :129]), _t(phase[..., :129]))


def test_griffin_lim_matches_jax_with_the_same_phase():
    ds = configs.LJSPEECH_TPU
    log_mel = np.asarray(stft.mel_from_config(ds)(_t(_audio(frames=16))))
    rng = np.random.RandomState(2)
    phase0 = rng.uniform(-np.pi, np.pi, (2, 16, 513)).astype(np.float32)
    n_iter = 8
    jstft_op = jstft.STFT(ds["n_fft"], ds["hop_length"], ds["win_length"])
    pinv = jgl._mel_pinv(ds["sample_rate"], ds["n_fft"], ds["n_mels"], 0.0, 8000.0)
    jmag = jnp.maximum(jnp.einsum("bfm,mk->bfk", jnp.exp(jnp.asarray(log_mel)), jnp.asarray(pinv),
                                  precision=jax.lax.Precision.HIGHEST), 0.0)
    ref = np.asarray(jgl.griffin_lim_jnp(jmag, jstft_op, jnp.asarray(phase0), n_iter=n_iter))
    ours = griffin_lim.make_mel_vocoder(ds, n_iter=n_iter)(_t(log_mel), phase0=_t(phase0)).numpy()
    assert ours.shape == ref.shape == (2, 16 * 256)
    _close(ours, ref, 1e-4)


# ---------------------------------------------------------------------------
# flows, the flow cache, weights and configs
# ---------------------------------------------------------------------------
def _randomized(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("weight") and p.ndim == 2:       # InvConvNear
                p.copy_(flows.invconv_qr_init(p.shape[0], gen))
            elif p.ndim == 3 and p.shape[1:] != (1, 1) and "logs" not in name and "bias" not in name:
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p[0].numel()))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen) + (1.0 if "weight_g" in name else 0.0))
    return module


@pytest.mark.parametrize("layer", ["actnorm", "invconv", "coupling", "decoder"])
def test_flows_invert(layer):
    C, T = 16, 18
    rng = np.random.RandomState(5)
    lens = torch.tensor([T, 10 if layer == "decoder" else 11], dtype=torch.int32)  # squeezing keeps even lengths
    mask = (torch.arange(T)[None, :] < lens[:, None]).float()[..., None]
    x = _t(rng.randn(2, T, C)) * mask
    if layer == "decoder":
        module = _randomized(FlowSpecDecoder(C // 2, 12, 5, 1, 3, 2, fused=True, fused_flow_step=False), 1)
        x = x[..., :C // 2]
        z, logdet = module(x, mask)
        back, _ = module(z, mask, reverse=True)
        flows.build_flow_cache(module)
        back_cached, _ = module(z, mask, reverse=True)
        assert logdet.shape == (2,)
        torch.testing.assert_close(back_cached, back, rtol=0, atol=1e-6)
    else:
        module = _randomized({"actnorm": flows.ActNorm(C), "invconv": flows.InvConvNear(C, 4),
                              "coupling": flows.CouplingBlock(C, 12, 5, 1, 2, fused=True)}[layer], 2)
        z, logdet = module(x, mask, lens)
        back, _ = module(z, mask, lens, reverse=True)
        assert logdet.shape == (2,)
    torch.testing.assert_close(back.detach(), x, rtol=0, atol=1e-4)


def test_flow_cache_holds_folded_weights_and_inverses():
    module = _randomized(FlowSpecDecoder(8, 12, 5, 1, 2, 2, fused=True, fused_flow_step=False), 3)
    wn = module.flows[2].start
    plain = wn.weight()
    flows.build_flow_cache(module)
    assert wn.folded_weight is not None and torch.equal(wn.weight(), plain)
    inv = module.flows[1].weight_inv
    torch.testing.assert_close(inv @ module.flows[1].weight, torch.eye(4), atol=1e-6, rtol=0)
    assert "flows.2.start.folded_weight" not in module.state_dict()
    flows.clear_flow_cache(module)
    assert wn.folded_weight is None and module.flows[1].weight_inv is None


def test_convert_equals_export_glow_tts():
    from tools.import_torch_checkpoint import export_glow_tts

    config = {"model": copy.deepcopy(configs.GLOW_TTS_TPU), "dataset": configs.LJSPEECH_TPU}
    config["model"]["encoder"].update(hidden_channels=8, filter_channels=16, n_layers=2)
    config["model"]["decoder"].update(hidden_channels=8, n_blocks=2, n_layers=2)
    jmodel = JaxGlowTTS(config=config)
    x, lens = jnp.zeros((1, 6), jnp.int32), jnp.full((1,), 6, jnp.int32)
    y, y_len = jnp.zeros((1, 12, 80)), jnp.full((1,), 12, jnp.int32)
    variables = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0), "dropout":
                                                    jax.random.PRNGKey(0)}, x, lens, y, y_len, train=False))
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), variables["params"])
    ref = export_glow_tts({"params": params}, Config(config))
    ours = glow_tts_params_from_jax(params)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)


def test_glow_configs_equal_the_yaml():
    cfg = load_config(os.path.join(REPO, "configs/models/glow_tts_tpu.yaml")).to_dict()
    assert configs.GLOW_TTS_TPU == cfg["model"]
    assert configs.GLOW_TTS_TPU_OPTIMIZER == cfg["optimizer"]
    assert configs.GLOW_TTS_TPU_SCHEDULER == cfg["scheduler"]
    ds = load_config(os.path.join(REPO, "configs/datasets/ljspeech_tpu.yaml")).to_dict()
    assert configs.LJSPEECH_TPU == ds["dataset"]
