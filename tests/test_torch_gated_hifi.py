"""The port's GatedHiFi block (speech_masters_thesis_tpu_torch/ops/gated_hifi.py)
against the JAX package's, on the CPU.

The same numpy weights and inputs go through the port's plain version, the
JAX fused Pallas kernel in interpret mode (dropout off, as
tests/test_fused_block.py runs it) and the flax block; dropout and the
backward are tests/test_torch_gated_hifi_bwd.py's. Valid positions match
within rtol 2e-5 / atol 2e-6 (fp32; summation order differs), and the port's
output is exactly 0 past each sequence's length. The CUDA kernel itself runs
only on the card (chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.vqvae import blocks as jblocks
from speech_masters_thesis_tpu_torch.models.vqvae import blocks as tblocks
from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops import gated_hifi as gh

RTOL, ATOL = 2e-5, 2e-6
W = 16


def _inputs(B, T, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, T, W)).astype(np.float32)
    lens = rng.randint(T // 2, T, (B,)).astype(np.int32)
    lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    return x, lens, mask


def _torch_block(depth, seed, res_scale=False):
    """Port block (shipped kernels 3,5,7,.. and dilations 1,3,9,..) with every
    weight and bias drawn from numpy, gate and Conv_1 included."""
    block = tblocks.GatedHiFiBlock(W, depth, dilation_growth_rate=3, kernel_size_growth_rate=2,
                                   zero_out=False, res_scale=res_scale)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy((rng.randn(*p.shape) * 0.2).astype(np.float32)))
    return block


def _flax_params(sd, depth):
    conv = lambda name: {"kernel": np.transpose(sd[f"{name}.weight"], (2, 1, 0)),
                         "bias": sd[f"{name}.bias"]}
    params = {"gate": conv("gate")}
    for d in range(depth):
        params[f"branch_in_{d}"] = conv(f"blocks.{d}.0")
        params[f"branch_res_{d}"] = {"Conv_0": conv(f"blocks.{d}.1.model.2"),
                                     "Conv_1": conv(f"blocks.{d}.1.model.5")}
    return {"params": params}


@pytest.mark.parametrize("depth,T,res_scale", [(4, 100, False), (4, 700, False), (2, 700, True)])
def test_reference_matches_jax_kernel_and_flax(depth, T, res_scale):
    block = _torch_block(depth, seed=depth * 10 + T, res_scale=res_scale)
    sd = {k: v.numpy() for k, v in block.state_dict().items()}
    x, lens, mask = _inputs(2, T, seed=T)
    xm = x * mask

    weights = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    assert weights.kernels == (3, 5, 7, 9)[:depth]
    with torch.no_grad():
        ours = gh.gated_hifi_reference(torch.from_numpy(xm), torch.from_numpy(lens), weights,
                                       block.res_scale).numpy()
        ours_block, _ = block(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(ours_block.numpy(), ours)

    kw = dict(n_in=W, n_depth=depth, dilation_growth_rate=3, kernel_size_growth_rate=2,
              zero_out=False, res_scale=res_scale)
    variables = _flax_params(sd, depth)
    y_kernel, _ = jblocks.GatedHiFiBlock(fused=True, **kw).apply(
        variables, jnp.asarray(x), jnp.asarray(mask), train=False)
    y_flax, _ = jblocks.GatedHiFiBlock(fused=False, **kw).apply(
        variables, jnp.asarray(x), jnp.asarray(mask), train=False)

    valid = mask.astype(bool)[..., 0]
    np.testing.assert_allclose(ours[valid], np.asarray(y_kernel)[valid], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours[valid], np.asarray(y_flax)[valid], rtol=RTOL, atol=ATOL)
    assert np.all(ours[~valid] == 0.0)


def test_bias_leak_past_length_reaches_valid_frames():
    """The convs pad only outside [0, T): the expand bias inside [len, T)
    feeds valid frames near the length, so the output there depends on T."""
    block = _torch_block(4, seed=3)
    weights = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    x, _, _ = _inputs(1, 300, seed=4)
    x[:, 200:] = 0.0
    lens = torch.tensor([200], dtype=torch.int32)
    with torch.no_grad():
        long = gh.gated_hifi_reference(torch.from_numpy(x), lens, weights)[0, :200]
        short = gh.gated_hifi_reference(torch.from_numpy(x[:, :200].copy()), lens, weights)[0]
    assert not torch.allclose(long[-50:], short[-50:])
    torch.testing.assert_close(long[:50], short[:50], rtol=RTOL, atol=ATOL)


def test_res_layer_matches_flax():
    rng = np.random.RandomState(5)
    layer = tblocks.ResLayer(2 * W, 2 * W, dilation=9, kernel_size=7, zero_out=False)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy((rng.randn(*p.shape) * 0.2).astype(np.float32)))
    sd = {k: v.numpy() for k, v in layer.state_dict().items()}
    conv = lambda name: {"kernel": np.transpose(sd[f"{name}.weight"], (2, 1, 0)),
                         "bias": sd[f"{name}.bias"]}
    params = {"params": {"Conv_0": conv("model.2"), "Conv_1": conv("model.5")}}
    x = rng.uniform(-1, 1, (2, 150, 2 * W)).astype(np.float32)
    with torch.no_grad():
        ours = layer(torch.from_numpy(x)).numpy()
    theirs = jblocks.ResLayer(2 * W, 2 * W, dilation=9, kernel_size=7, zero_out=False).apply(
        params, jnp.asarray(x), train=False)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=RTOL, atol=ATOL)


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    block = _torch_block(4, seed=6)
    weights = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    x, lens, mask = _inputs(2, 130, seed=7)
    xm, lens = torch.from_numpy(x * mask), torch.from_numpy(lens)
    before = gh.gated_hifi.launches
    with torch.no_grad():
        out = gh.gated_hifi(xm, lens, weights)
        ref = gh.gated_hifi_reference(xm, lens, weights)
    assert gh.gated_hifi.launches == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_wrapper_rejects_dropout():
    """Dropout rates outside [0, 1) raise; a valid rate on a CPU tensor runs
    the plain version with the seed's masks and counts no launch."""
    block = _torch_block(2, seed=8)
    weights = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    x, lens, _ = _inputs(1, 64, seed=9)
    x, lens = torch.from_numpy(x), torch.from_numpy(lens)
    for p_drop in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError, match="p_drop"):
            gh.gated_hifi(x, lens, weights, p_drop=p_drop)
    before = gh.gated_hifi.launches
    with torch.no_grad():
        out = gh.gated_hifi(x, lens, weights, p_drop=0.1, seed=3)
        ref = gh.gated_hifi_reference(x, lens, weights, p_drop=0.1, seed=3)
        no_drop = gh.gated_hifi_reference(x, lens, weights)
    assert gh.gated_hifi.launches == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert not torch.allclose(out, no_drop)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    _build.build.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_launch_check_takes_any_halo_and_bounds_the_batch(monkeypatch):
    """The forward's stages hold no halo window (each conv tap is a shifted
    k-slice), so the launch check no longer caps the dilations by a block's
    shared memory: a halo of 4 * 729 frames passes. It still raises on what
    the kernels do not take, a batch over the grid's 65535 included. CPU
    tensors, with the device-capability check stubbed to Hopper."""
    monkeypatch.setattr(gh.torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    block = tblocks.GatedHiFiBlock(64, 4, dilation_growth_rate=9, kernel_size_growth_rate=2, zero_out=False)
    weights = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    assert weights.dilations == (1, 9, 81, 729)
    gh._check_call(torch.zeros(2, 100, 64), torch.full((2,), 100, dtype=torch.int32), weights)
    with pytest.raises(ValueError, match="65535"):
        gh._check_call(torch.zeros(65536, 1, 64), torch.ones(65536, dtype=torch.int32), weights)
    with pytest.raises(ValueError, match="lens"):
        gh._check_call(torch.zeros(2, 100, 64), torch.full((2,), 100, dtype=torch.int64), weights)
