"""Causal Transformer LM over VQ codes (counterpart of
speech_masters_thesis_tpu/models/transformer_lm/model.py), NTC layout.

torch ``nn.TransformerEncoderLayer`` semantics (post-LN, ReLU FF, dropout on
the attention probabilities, a final LayerNorm), with the reference
checkpoint's parameter keys: ``embedding.weight``,
``transformer.layers.{i}.self_attn.in_proj_weight`` (packed q, k, v rows,
torch MHA layout), ``...out_proj``, ``linear1``, ``linear2``, ``norm1``,
``norm2``, ``transformer.norm`` and ``classifier``. Masked logits are -1e9,
not -inf, as in the JAX package.

Self-attention takes one of three routes (``MultiHeadSelfAttention``):
``fused_attention`` and T <= 1024 go through ``ops/attention.py`` (the
small-T kernels on the card, with dropout on P inside the kernel); with
T > 1024 and no dropout, ``F.scaled_dot_product_attention`` with an explicit
boolean causal and key mask stands where the JAX package calls jax's stock
flash kernel (no kernel of the package's own); everything else is the plain
``_attend``.

The frozen VQ-VAE bottleneck and decoder (``vqvae_bottleneck``,
``vqvae_decoder``) reconstruct audio from codes in the eval forward and in
``sample``; ``load_vqvae_into_lm`` grafts a VQ-VAE's weights into them, and
``FROZEN_PREFIXES`` keeps them out of the optimizer. Randomness is explicit:
train mode draws every dropout mask, and each layer's attention dropout
seed, from ``generators["device_dropout"]`` on the model's device; ``sample``
draws from the generator it is given.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.models.base import TokenToWaveformModel
from speech_masters_thesis_tpu_torch.models.vqvae.bottleneck import BottleneckBlock
from speech_masters_thesis_tpu_torch.models.vqvae.encdec import Decoder
from speech_masters_thesis_tpu_torch.models.vqvae.model import codec_kwargs
from speech_masters_thesis_tpu_torch.ops.attention import NEG_INF, fused_attention, valid_pairs
from speech_masters_thesis_tpu_torch.ops.basic import dropout, sequence_mask, softmax_f32
from speech_masters_thesis_tpu_torch.ops.losses import focal_loss, masked_cross_entropy, mmi_loss
from speech_masters_thesis_tpu_torch.parallel import mesh

PAD = 0
BOS = 1
OFFSET = 2
SMALL_T_MAX = 1024  # the small-T route's bound (the JAX package's VMEM bound)


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    position = np.arange(max_len)[:, None].astype(np.float64)
    div_term = np.exp(np.arange(0, d_model, 2).astype(np.float64) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def _maybe_dropout(x: torch.Tensor, p: float, train: bool, generator: Optional[torch.Generator]):
    return dropout(x, p, generator) if train and p > 0 else x


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A Dense layer as flax runs it: in bf16 the product is rounded to bf16
    before its bias is added (flax's Dense adds the bias to the dot's
    output), so two roundings as in the JAX LM; otherwise one fused product."""
    if x.dtype == torch.bfloat16:
        return F.linear(x, weight) + bias
    return F.linear(x, weight, bias)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return _dense(x, layer.weight, layer.bias)


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with a packed in-projection (torch MHA layout)."""

    def __init__(self, d_model: int, n_heads: int, dropout_p: float = 0.0, fused: bool = False):
        super().__init__()
        self.d_model, self.n_heads, self.dropout_p, self.fused = d_model, n_heads, dropout_p, fused
        self.d_head = d_model // n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def _qkv(self, x: torch.Tensor):
        """q, k, v as [B, T, H, D] views of one [B, T, 3C] projection."""
        b, t, _ = x.shape
        qkv = _dense(x, self.in_proj_weight, self.in_proj_bias)
        return [part.view(b, t, self.n_heads, self.d_head) for part in qkv.split(self.d_model, dim=-1)]

    def forward(self, x: torch.Tensor, lens: torch.Tensor, train: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, C]; lens: [B] int32 valid key lengths (causal and key mask)."""
        q, k, v = self._qkv(x)
        t = x.shape[1]
        dropping = train and self.dropout_p > 0
        if self.fused and t <= SMALL_T_MAX:
            out = self._attend_smallt(q, k, v, lens, train, generator)
        elif self.fused and not dropping:
            out = self._attend_sdpa(q, k, v, lens)
        else:
            out = self._attend(q, k, v, lens, train, generator)
        return _linear(self.out_proj, out.reshape(x.shape[0], t, self.d_model))

    def _attend(self, q, k, v, lens, train, generator):
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_head)
        logits = logits + torch.where(valid_pairs(lens, q.shape[1]), 0.0, NEG_INF).to(logits.dtype)
        probs = _maybe_dropout(softmax_f32(logits), self.dropout_p, train, generator)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    def _attend_smallt(self, q, k, v, lens, train, generator):
        """ops/attention.py's small-T attention; a dropping layer draws its
        mask seed from ``generator`` on the device (no host sync)."""
        p = self.dropout_p if train else 0.0
        if p > 0.0:
            if generator is None:
                raise ValueError("attention dropout in train mode needs a torch.Generator")
            seed = mesh.mix_seed(torch.randint(0, 2 ** 32, (1,), generator=generator, device=q.device,
                                               dtype=torch.int64))
        else:
            seed = torch.zeros(1, dtype=torch.int64, device=q.device)
        return fused_attention(q, k, v, lens, seed, 1.0 / math.sqrt(self.d_head), p)

    def _attend_sdpa(self, q, k, v, lens):
        """T > 1024 without dropout: PyTorch's fused attention with an explicit
        causal and key mask (where the JAX package calls jax's stock flash
        kernel). Rows past the length attend over the valid prefix."""
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=valid_pairs(lens, q.shape[1]), scale=1.0 / math.sqrt(self.d_head))
        return out.transpose(1, 2)

    def decode_step(self, x_t: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    position: int) -> torch.Tensor:
        """One token against a KV cache.

        x_t: [B, 1, C]; k_cache/v_cache: [B, T_max, H, D], written in place at
        ``position`` (the JAX version returns new caches). Attends over
        positions 0..position, which is what the JAX version's -1e9 fill of
        the later positions gives. Returns y [B, 1, C].
        """
        q, k, v = self._qkv(x_t)
        k_cache[:, position] = k[:, 0]
        v_cache[:, position] = v[:, 0]
        kc, vc = k_cache[:, :position + 1], v_cache[:, :position + 1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kc) / math.sqrt(self.d_head)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), vc)
        return self.out_proj(out.reshape(x_t.shape[0], 1, self.d_model))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: attn -> add & norm -> FF -> add & norm."""

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int, dropout_p: float,
                 layer_norm_eps: float = 1e-5, fused_attention: bool = False):
        super().__init__()
        self.dropout_p = dropout_p
        self.self_attn = MultiHeadSelfAttention(d_model, n_heads, dropout_p, fused=fused_attention)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=layer_norm_eps)

    def _ff(self, x: torch.Tensor, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        h = _maybe_dropout(torch.relu(_linear(self.linear1, x)), self.dropout_p, train, generator)
        return _linear(self.linear2, h)

    def forward(self, x: torch.Tensor, lens: torch.Tensor, train: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.self_attn(x, lens, train, generator)
        x = self.norm1(x + _maybe_dropout(h, self.dropout_p, train, generator))
        h = self._ff(x, train, generator)
        return self.norm2(x + _maybe_dropout(h, self.dropout_p, train, generator))

    def decode_step(self, x_t, k_cache, v_cache, position: int) -> torch.Tensor:
        x_t = self.norm1(x_t + self.self_attn.decode_step(x_t, k_cache, v_cache, position))
        return self.norm2(x_t + self._ff(x_t, False, None))


class _Encoder(nn.Module):
    """The layer stack and the final LayerNorm (the reference's
    ``transformer``, an ``nn.TransformerEncoder``)."""

    def __init__(self, layers, norm: nn.LayerNorm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class TransformerLM(TokenToWaveformModel):
    """LM built from a ``model:`` config dict (see ``configs.TRANSFORMER_LM_TPU``),
    with the frozen codec of ``vqvae_model_config`` (a VQ-VAE ``model:``
    section, e.g. ``configs.VQVAE_TPU``) when one is given.

    bf16 training (``train.loop.make_train_step(bf16=True)``) follows the
    JAX LM's dtypes: the fp32 positional table is cast to the activations'
    dtype before the add (an fp32 add would promote the whole backbone, and
    every attention call with it, to fp32), the attention bias to the
    logits' dtype, the softmax reduces in fp32 (``softmax_f32``), the small-T
    kernel runs its bf16 mode, each Dense layer rounds its product before the
    bias as flax's does (``_dense``), and the losses take log_softmax of
    fp32 logits."""

    PAD = PAD
    BOS = BOS
    OFFSET = OFFSET
    # parameter prefixes kept out of the optimizer (train/harness.py:frozen_param_mask)
    FROZEN_PREFIXES = ("vqvae_bottleneck", "vqvae_decoder")
    BF16_TRAINING = True  # B2's kernels have a bf16 mode (train.loop.make_train_step)

    def __init__(self, model_cfg: dict, vqvae_model_config: Optional[dict] = None):
        super().__init__()
        cfg = model_cfg
        self.d_model, self.vocab_size = cfg["d_model"], cfg["vocab_size"]
        self.n_heads, self.max_len = cfg["nhead"], cfg["max_len"]
        self.loss_type, self.dropout_p = cfg["loss_type"], cfg["dropout"]
        if self.loss_type not in ("ce", "mmi", "focal"):
            raise ValueError(f"Loss function {self.loss_type} not supported")
        self.embedding = nn.Embedding(cfg["vocab_size"] + OFFSET, cfg["embed_dim"])
        self.register_buffer("pe", torch.from_numpy(sinusoidal_table(cfg["max_len"], cfg["d_model"])),
                             persistent=False)
        layers = [TransformerEncoderLayer(cfg["d_model"], cfg["nhead"], cfg["dim_feedforward"],
                                          cfg["dropout"], cfg["layer_norm_eps"],
                                          fused_attention=cfg.get("fused_attention", False))
                  for _ in range(cfg["num_layers"])]
        self.transformer = _Encoder(layers, nn.LayerNorm(cfg["d_model"], eps=cfg["layer_norm_eps"]))
        self.classifier = nn.Linear(cfg["d_model"], cfg["vocab_size"])

        self.vqvae_bottleneck: Optional[BottleneckBlock] = None
        self.vqvae_decoder: Optional[Decoder] = None
        if vqvae_model_config is not None:
            vq = vqvae_model_config
            self.vqvae_bottleneck = BottleneckBlock(vq["l_bins"], vq["emb_width"], vq["mu"],
                                                    vq["revival_threshold"])
            self.vqvae_decoder = Decoder(**codec_kwargs(vq))

    def _backbone(self, tokens: torch.Tensor, lens: torch.Tensor, train: bool,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embedding(tokens) * math.sqrt(self.d_model)
        x = _maybe_dropout(x + self.pe[None, :x.shape[1]].to(x.dtype), self.dropout_p, train, generator)
        for layer in self.transformer.layers:
            x = layer(x, lens, train, generator)
        return self.transformer.norm(x)

    def reconstruct(self, codes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """VQ codes [B, T] -> waveform [B, T * compression] via the frozen codec."""
        y = self.vqvae_bottleneck.decode(codes)
        y, out_mask = self.vqvae_decoder(y, mask[..., None].to(y.dtype))
        return (y * out_mask)[..., 0]

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, y: Optional[torch.Tensor] = None,
                y_lengths: Optional[torch.Tensor] = None, speaker=None, train: bool = True,
                generators: Optional[Mapping[str, torch.Generator]] = None):
        """x: [B, T] shifted VQ codes (PAD=0, BOS=1, code + OFFSET); x_lengths [B].

        Returns ({"loss", "yh"}, {"accuracy"}); ``yh`` is the audio of the
        argmax codes through the frozen codec in eval mode (None in train
        mode or without a codec). Train mode with dropout needs
        ``generators["device_dropout"]`` on the model's device. ``y``,
        ``y_lengths`` and ``speaker`` are accepted and unused.
        """
        del y, y_lengths, speaker
        generator = (generators or {}).get("device_dropout")
        if train and self.dropout_p > 0 and generator is None:
            raise ValueError("TransformerLM in train mode needs generators['device_dropout']")
        b, t = x.shape
        key_mask = sequence_mask(x_lengths, t)
        lens = key_mask.sum(dim=-1).to(torch.int32)
        logits = _linear(self.classifier, self._backbone(x, lens, train, generator))

        targets = x[:, 1:].reshape(-1)
        logits_flat = logits[:, :-1].reshape(targets.shape[0], -1)
        loss_mask = (targets >= OFFSET).to(torch.float32)
        shifted = torch.clamp(targets - OFFSET, min=0)
        if self.loss_type == "ce":
            loss = masked_cross_entropy(logits_flat, shifted, loss_mask)
        elif self.loss_type == "mmi":
            loss = mmi_loss(logits_flat, shifted, self.vocab_size, mask=loss_mask)
        else:
            loss = focal_loss(logits_flat, shifted, gamma=10.0, mask=loss_mask)
        correct = (shifted == torch.argmax(logits_flat, dim=-1)).to(torch.float32)
        accuracy = (mesh.global_sum(torch.sum(correct * loss_mask))
                    / torch.clamp(mesh.global_sum(torch.sum(loss_mask)), min=1.0))

        yh = None
        if not train and self.vqvae_bottleneck is not None:
            yh = self.reconstruct(torch.argmax(logits[:, :-1], dim=-1), key_mask[:, :-1])
        return {"loss": loss, "yh": yh}, {"accuracy": accuracy}

    @torch.no_grad()
    def sample(self, batch_size: int, n_steps: int, generator: torch.Generator, sigma: float = 1.0):
        """Draws codes [B, n_steps] from the LM, then reconstructs audio.

        KV-cached: one token per step against caches of shape
        [L, B, n_steps + 1, H, D]; each step's code is a categorical draw
        (Gumbel-max) from ``generator`` on the model's device. As in the JAX
        package (a documented deviation from the reference), the token fed
        back is the code + OFFSET, as in training. Returns (audio
        [B, n_steps * compression] or None without a codec, codes).
        """
        if n_steps + 1 > self.max_len:
            raise ValueError(f"n_steps + 1 = {n_steps + 1} exceeds max_len {self.max_len}")
        device = self.embedding.weight.device
        layers = self.transformer.layers
        caches = torch.zeros(2, len(layers), batch_size, n_steps + 1, self.n_heads,
                             self.d_model // self.n_heads, device=device)
        tokens = torch.full((batch_size, 1), BOS, dtype=torch.int64, device=device)
        codes = torch.empty(batch_size, n_steps, dtype=torch.int64, device=device)
        tiny = torch.finfo(torch.float32).tiny
        for position in range(n_steps):
            x = self.embedding(tokens) * math.sqrt(self.d_model) + self.pe[None, position:position + 1]
            for i, layer in enumerate(layers):
                x = layer.decode_step(x, caches[0, i], caches[1, i], position)
            logits = self.classifier(self.transformer.norm(x)[:, 0]) / sigma
            u = torch.rand(logits.shape, generator=generator, device=device).clamp_(min=tiny)
            nxt = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
            codes[:, position] = nxt
            tokens = (nxt + OFFSET)[:, None]
        audio = None
        if self.vqvae_bottleneck is not None:
            audio = self.reconstruct(codes, torch.ones(codes.shape, device=device))
        return audio, codes


@torch.no_grad()
def load_vqvae_into_lm(lm: TransformerLM, vqvae_state_dict: Mapping[str, torch.Tensor]) -> None:
    """Grafts a port VQ-VAE's decoder and codebook into the LM's frozen codec.

    Counterpart of ``load_vqvae_into_variables``: ``decoders.0.*`` go to
    ``vqvae_decoder.*`` and ``bottleneck.level_blocks.0.*`` (the codebook
    ``k``, and ``k_sum``/``k_elem``/``initialized`` where present) to
    ``vqvae_bottleneck.*``. Raises when a decoder parameter or ``k`` is
    missing.
    """
    if lm.vqvae_decoder is None:
        raise ValueError("the LM was built without vqvae_model_config")
    targets = {**dict(lm.named_parameters()), **dict(lm.named_buffers())}
    renames = (("decoders.0.", "vqvae_decoder."), ("bottleneck.level_blocks.0.", "vqvae_bottleneck."))
    filled = set()
    for name, value in vqvae_state_dict.items():
        for src, dst in renames:
            if name.startswith(src) and dst + name[len(src):] in targets:
                targets[dst + name[len(src):]].copy_(value)
                filled.add(dst + name[len(src):])
    needed = {n for n, _ in lm.vqvae_decoder.named_parameters(prefix="vqvae_decoder")}
    missing = sorted((needed | {"vqvae_bottleneck.k"}) - filled)
    if missing:
        raise KeyError(f"the VQ-VAE state_dict lacks {missing[:5]} ({len(missing)} in all)")
    lm.vqvae_bottleneck.initialized.fill_(True)
