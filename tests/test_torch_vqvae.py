"""The port's VQ-VAE inference path against the JAX package's, on the CPU.

Model: tests/fixtures/vqvae_tiny.yaml with zero_out false (so every residual
branch carries signal) and linf_approx false. The JAX variables take the model's
parameter shapes with every leaf drawn from a numpy seed, and go across
through convert.py; the
codebook is the same seeded numpy array on both sides. Audio is 2 x 2048
samples with ragged lengths. Codes must be bitwise equal; decode within
atol 1e-5; the eval forward's loss terms within rtol 1e-5. The training
step is tests/test_torch_train.py's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.vqvae.model import VQVAE as JaxVQVAE
from speech_masters_thesis_tpu.ops import losses as jlosses
from speech_masters_thesis_tpu.utils.config import Config, load_config
from speech_masters_thesis_tpu_torch.convert import vqvae_state_dict_from_jax
from speech_masters_thesis_tpu_torch.models.vqvae.bottleneck import BottleneckBlock
from speech_masters_thesis_tpu_torch.models.vqvae.model import VQVAE, compression_factor
from speech_masters_thesis_tpu_torch.ops import losses as tlosses
from speech_masters_thesis_tpu_torch.ops import stft as tstft
from speech_masters_thesis_tpu_torch.utils.registry import get_model
from tools.import_torch_checkpoint import export_vqvae


def _model_cfg():
    cfg = load_config("tests/fixtures/vqvae_tiny.yaml").to_dict()["model"]
    cfg["zero_out"] = False
    cfg["loss"]["linf_approx"] = False
    return cfg


def _audio(t=2048, seed=3):
    rng = np.random.RandomState(seed)
    audio = rng.uniform(-0.8, 0.8, (2, t)).astype(np.float32)
    lengths = np.array([t, t - 448], np.int32)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return audio, lengths, mask


@pytest.fixture(scope="module")
def models():
    cfg = _model_cfg()
    jax_models = {fused: JaxVQVAE(config={"model": {**cfg, "fused_blocks": fused}})
                  for fused in (False, True)}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jax_models[False].init(
        {"params": key, "dropout": key, "codebook": key},
        jnp.zeros((1, 256)), jnp.full((1,), 256), train=False))
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.2).astype(np.float32),
                          shapes["params"])
    k = rng.randn(cfg["l_bins"], cfg["emb_width"]).astype(np.float32)
    codebook = {"bottleneck": {"level_0": {
        "k": k, "k_sum": k, "k_elem": np.ones(cfg["l_bins"], np.float32),
        "initialized": np.ones((), bool)}}}
    assert jax.tree.structure(codebook) == jax.tree.structure(shapes["codebook"])
    variables = {"params": params, "codebook": codebook}

    port = get_model(copy.deepcopy(cfg), device="cpu")
    port.load_state_dict(vqvae_state_dict_from_jax(variables, cfg), strict=True)
    return cfg, jax_models, variables, port


@pytest.mark.parametrize("fused", [False, True])
def test_codes_bitwise_equal(models, fused):
    _, jax_models, variables, port = models
    audio, _, mask = _audio()
    encode = jax.jit(lambda v, a, m: jax_models[fused].apply(v, a, m, method=JaxVQVAE.encode))
    jcodes, jmask = encode(variables, jnp.asarray(audio), jnp.asarray(mask))
    with torch.no_grad():
        codes, code_mask = port.encode(torch.from_numpy(audio), torch.from_numpy(mask))
    assert len(np.unique(np.asarray(jcodes))) > 4  # the codebook is really exercised
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(code_mask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("fused", [False, True])
def test_decode_matches(models, fused):
    cfg, jax_models, variables, port = models
    rng = np.random.RandomState(4)
    codes = rng.randint(0, cfg["l_bins"], (2, 16)).astype(np.int32)
    decode = jax.jit(lambda v, c: jax_models[fused].apply(v, c, method=JaxVQVAE.decode))
    theirs = decode(variables, jnp.asarray(codes))
    with torch.no_grad():
        ours = port.decode(torch.from_numpy(codes).long())
    assert ours.shape == (2, 16 * compression_factor(cfg))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-5)


def test_eval_forward_losses_match(models):
    _, jax_models, variables, port = models
    audio, lengths, _ = _audio()
    forward = jax.jit(lambda v, a, n: jax_models[True].apply(v, a, n, train=False, rngs={}))
    loss_dict, metrics = forward(variables, jnp.asarray(audio), jnp.asarray(lengths))
    with torch.no_grad():
        ours, our_metrics = port(torch.from_numpy(audio), torch.from_numpy(lengths), train=False)
    assert metrics == {} and our_metrics == {}
    for key in ("loss", "loss_recon", "loss_stft", "loss_commit"):
        np.testing.assert_allclose(float(ours[key]), float(loss_dict[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(ours["yh"].numpy(), np.asarray(loss_dict["yh"]), rtol=0, atol=1e-5)


def test_convert_matches_export_vqvae(models):
    """Independent oracle: tools.import_torch_checkpoint.export_vqvae."""
    cfg, _, variables, port = models
    ours = vqvae_state_dict_from_jax(variables, cfg)
    theirs = export_vqvae(variables, Config({"model": cfg}))
    assert sorted(ours) == sorted(theirs) == sorted(port.state_dict())
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def test_bottleneck_eval_forward_matches():
    """Commit loss, fit and prenorm against the flax BottleneckBlock."""
    from speech_masters_thesis_tpu.models.vqvae.bottleneck import BottleneckBlock as JaxBlock

    rng = np.random.RandomState(6)
    k = rng.randn(32, 16).astype(np.float32)
    x = rng.randn(2, 24, 16).astype(np.float32)
    mask = np.ones((2, 24), np.float32)
    mask[1, 15:] = 0.0
    codebook = {"k": k, "k_sum": k, "k_elem": np.ones(32, np.float32),
                "initialized": np.ones((), bool)}
    jcodes, jxq, jcommit, jmetrics = JaxBlock(32, 16, 0.99, 1.0).apply(
        {"codebook": codebook}, jnp.asarray(x), jnp.asarray(mask), update_k=False)
    block = BottleneckBlock(32, 16, 0.99, 1.0)
    block.k.copy_(torch.from_numpy(k))
    with torch.no_grad():
        codes, xq, commit, metrics = block(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(xq.numpy(), np.asarray(jxq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(commit), float(jcommit), rtol=1e-5)
    for key in ("fit", "prenorm"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5, err_msg=key)
    # the eval forward leaves the codebook alone and passes no gradient to x;
    # the update needs a generator (tests/test_torch_train.py checks it)
    xt = torch.from_numpy(x).requires_grad_(True)
    _, xq, commit, _ = block(xt, torch.from_numpy(mask))
    assert not xq.requires_grad and commit.requires_grad
    np.testing.assert_array_equal(block.k.numpy(), k)
    with pytest.raises(ValueError, match="Generator"):
        block(torch.from_numpy(x), torch.from_numpy(mask), update_k=True)


@pytest.mark.parametrize("window,log", [("hann", True), ("hamming", False)])
def test_spectral_loss_matches(window, log):
    audio, _, mask = _audio(t=1024, seed=7)
    yh = audio + 0.05 * np.random.RandomState(8).randn(*audio.shape).astype(np.float32)
    args = ((256, 128), (64, 32), (200, 128))
    theirs = jlosses.MultiResolutionSpectralLoss(*args, window=window, log=log)(
        jnp.asarray(audio), jnp.asarray(yh), jnp.asarray(mask))
    ours = tlosses.MultiResolutionSpectralLoss(*args, window=window, log=log)(
        torch.from_numpy(audio), torch.from_numpy(yh), torch.from_numpy(mask))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-5)


def test_stft_magnitude_and_mask_match():
    from speech_masters_thesis_tpu.ops.stft import STFT as JaxSTFT

    audio, _, mask = _audio(t=1000, seed=9)
    theirs = np.asarray(JaxSTFT(256, 50, 240)(jnp.asarray(audio)))
    ours = tstft.STFT(256, 50, 240)(torch.from_numpy(audio)).numpy()
    assert ours.shape == theirs.shape == (2, 20, 129)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tlosses.downsample_mask(torch.from_numpy(mask), 256, 50).numpy(),
        np.asarray(jlosses.downsample_mask(jnp.asarray(mask), 256, 50)))


def test_stft_equals_windowed_dft_basis():
    """The framed rFFT is the reference's conv against the windowed DFT basis."""
    stft = tstft.STFT(128, 32, 100, window_type="hamming")
    audio = torch.from_numpy(_audio(t=512, seed=12)[0])
    real, imag = stft.real_imag(audio)
    basis = torch.from_numpy(tstft.dft_basis(128) * stft.window.double().numpy())
    spec = stft._frames(audio).double() @ basis.t()
    torch.testing.assert_close(real.double(), spec[..., :65], rtol=0, atol=1e-5)
    torch.testing.assert_close(imag.double(), spec[..., 65:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("linf_topk", [64, 4096])
def test_recon_loss_matches_exact_topk(linf_topk):
    audio, _, mask = _audio(t=1024, seed=10)
    yh = audio + 0.1 * np.random.RandomState(11).randn(*audio.shape).astype(np.float32)
    kw = dict(l1=0.3, l2=1.0, linf=0.02, linf_topk=linf_topk)
    theirs = jlosses.MultiNormReconstructionLoss(**kw, linf_approx=False)(
        jnp.asarray(audio), jnp.asarray(yh), jnp.asarray(mask))
    ours = tlosses.MultiNormReconstructionLoss(**kw, linf_approx=True)(
        torch.from_numpy(audio), torch.from_numpy(yh), torch.from_numpy(mask))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-5)


def test_port_model_rejects_what_is_not_ported():
    cfg = _model_cfg()
    with pytest.raises(ValueError, match="folded_convs"):
        VQVAE({**cfg, "folded_convs": True})
    with pytest.raises(NotImplementedError):
        VQVAE({**cfg, "block_type": "wavenet"})
    with pytest.raises(NotImplementedError, match="use_bottleneck"):
        VQVAE({**cfg, "use_bottleneck": False})
    model = VQVAE(cfg)
    audio, lengths, _ = _audio(t=1024)
    # the training forward is ported; it needs its generators
    with pytest.raises(ValueError, match="Generator"):
        model(torch.from_numpy(audio), torch.from_numpy(lengths), train=True)
