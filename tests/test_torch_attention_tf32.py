"""B2's forward, the LM's small-T attention, as its kernel computes it
(csrc/attention_fwd.cu through csrc/attention_common.cuh): S = Q K^T and
O += P V on the tensor cores in 3xTF32 (csrc/tf32_mma.cuh), emulated on the
CPU by ops/tf32.py in the kernel's k-order, each k-step's MMAs added to the
accumulators in fp32 (``rz_steps=1``), over key tiles of 64 with the online
softmax updated once a tile (row max, the O accumulators and the row sum
rescaled, the dropout draw at each element's own (r, c)).

* p=0, against JAX's ``fused_attention`` (the Pallas kernel in interpret
  mode, as tests/test_torch_attention.py runs it): within chip_smoke's
  ATTN_FWD_RTOL of max|ref| with 3 TF32 products, while a single TF32
  product misses it.
* p=0.1, against the plain version in fp64 with the port's hash masks (the
  JAX kernel draws the TPU's own bits): the same tolerance.

B=2, H=2, D=32, ragged lengths; T = 37 (one partial key tile), 130 (three)
and 258 (the LM's train length: five, the last of 2 rows).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_FWD_RTOL
from speech_masters_thesis_tpu.ops.pallas.attention import SmallTAttnSpec
from speech_masters_thesis_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from speech_masters_thesis_tpu_torch.ops import attention as att
from speech_masters_thesis_tpu_torch.ops import tf32
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TILE = 64  # keys a tile (csrc/attention_common.cuh: ROWS)
B, H, D = 2, 2, 32
SEED = 77
TS = [37, 130, 258]


def _inputs(T: int):
    rng = np.random.RandomState(T)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    lens = rng.randint(1, T + 1, (B,)).astype(np.int32)
    lens[0] = T
    return q, k, v, lens


def kernel_forward(q, k, v, lens, scale: float, passes: int = 3, seed: int = 0, p_drop: float = 0.0):
    """attention_fwd_kernel's o [B, T, H, D]: per (sequence, head), the key
    tiles in order, S and P V in the kernel's products, the online softmax a
    tile."""
    Bn, T, Hn, _ = q.shape
    keep = att.keep_mask(seed, Bn, Hn, T, p_drop) if p_drop > 0.0 else None
    pos = torch.arange(T)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for b in range(Bn):
        n = min(max(int(lens[b]), 0), T)
        kend = torch.minimum(pos + 1, torch.tensor(n))  # each row's keys [0, kend)
        for h in range(Hn):
            m = torch.full((T,), -math.inf)
            l = torch.zeros(T)
            acc = torch.zeros(T, D)
            for k0 in range(0, n, TILE):
                cols = torch.arange(k0, min(k0 + TILE, T))
                valid = cols[None, :] < kend[:, None]
                s = tf32.matmul(q[b, :, h], k[b, cols, h].t(), passes, rz_steps=1) * scale
                s = torch.where(valid, s, torch.tensor(-math.inf))
                m_new = torch.maximum(m, s.max(dim=1).values)
                corr = torch.where(m_new == -math.inf, torch.ones(T), torch.exp(m - m_new))
                p = torch.where(valid, torch.exp(s - m_new[:, None]), torch.zeros(()))
                l = l * corr + p.sum(dim=1)
                if keep is not None:
                    p = p * keep[b, h][:, cols]
                acc = tf32.matmul(p, v[b, cols, h], passes, acc=acc * corr[:, None], rz_steps=1)
                m = m_new
            out[b, :, h] = acc * torch.where(kend > 0, 1.0 / l, torch.zeros(()))[:, None]
    return out


@pytest.mark.parametrize("T", TS)
def test_forward_matches_jax_kernel(T):
    """p=0: 3 TF32 products within ATTN_FWD_RTOL of JAX's interpret-mode
    kernel; 1 product misses it."""
    q, k, v, lens = _inputs(T)
    scale = 1.0 / math.sqrt(D)
    spec = SmallTAttnSpec(n_heads=H, d_head=D, scale=scale, p_drop=0.0, interpret=True)
    lens_f32 = jax.lax.bitcast_convert_type(jnp.asarray(lens), jnp.float32)
    ref = np.asarray(jax_fused_attention(spec, jnp.float32(0.0), lens_f32, *(jnp.asarray(a) for a in (q, k, v))))
    tol = ATTN_FWD_RTOL * np.abs(ref).max()
    args = tuple(torch.from_numpy(a) for a in (q, k, v, lens))
    errs = {passes: np.abs(kernel_forward(*args, scale, passes).numpy() - ref).max() for passes in (3, 1)}
    print(f"T={T}: max|err| with 3 TF32 products {errs[3]:.3e}, with 1 {errs[1]:.3e} (tol {tol:.3e})")
    assert errs[3] <= tol
    assert errs[1] > tol


@pytest.mark.parametrize("T", TS)
def test_forward_dropout_matches_fp64(T):
    """p=0.1: within ATTN_FWD_RTOL of the fp64 plain version with the port's
    hash masks (the same bits the kernel draws)."""
    q, k, v, lens = (torch.from_numpy(a) for a in _inputs(T))
    scale, p = 1.0 / math.sqrt(D), 0.1
    ref = att.attention_reference(q.double(), k.double(), v.double(), lens, SEED, scale, p)
    ours = kernel_forward(q, k, v, lens, scale, 3, SEED, p)
    err, tol = (ours.double() - ref).abs().max().item(), ATTN_FWD_RTOL * ref.abs().max().item()
    print(f"T={T}, p={p}: max|err| {err:.3e} (tol {tol:.3e})")
    assert err <= tol
