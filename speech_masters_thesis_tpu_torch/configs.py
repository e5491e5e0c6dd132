"""Model configurations as plain dicts (no YAML parser needed at run time).

``VQVAE_TPU`` is the ``model:`` section of ``configs/models/vqvae_tpu.yaml``
and ``VQVAE_TPU_OPTIMIZER`` its ``optimizer:`` section (its ``scheduler:`` is
null); ``TRANSFORMER_LM_TPU``, ``TRANSFORMER_LM_TPU_OPTIMIZER`` and
``TRANSFORMER_LM_TPU_SCHEDULER`` are the three sections of
``configs/models/transformer_lm_tpu.yaml``. Key for key; tests hold them
equal.
"""

from __future__ import annotations

VQVAE_TPU = {
    "_import_": "models.vqvae.vqvae.VQVAE",
    "levels": 3,
    "downs_t": [3, 2, 2],
    "strides_t": [2, 2, 2],
    "emb_width": 128,
    "l_bins": 512,
    "mu": 0.99,
    "multipliers": [2, 1, 1],
    "width": 64,
    "depth": 4,
    "m_conv": 1.0,
    "revival_threshold": 1.0,
    "use_bottleneck": True,
    "dilation_growth_rate": 3,
    "dilation_cycle": None,
    "kernel_size_growth_rate": 2,
    "kernel_size_cycle": None,
    "reverse_decoder_dilation": True,
    "zero_out": True,
    "block_type": "gated_hifi",
    "fused_blocks": True,
    "remat": False,
    "ddi": False,
    "loss": {
        "commit": 0.05,
        "multispectral": 1.0,
        "l1": 0.0,
        "l2": 1.0,
        "linf": 0.02,
        "linf_topk": 2048,
        "linf_approx": True,
        "n_ffts": [2048, 1024, 512],
        "hop_lengths": [240, 120, 50],
        "win_lengths": [1200, 600, 240],
        "window": "hann",
        "log": True,
    },
}

VQVAE_TPU_OPTIMIZER = {
    "name": "adam",
    "lr": 0.0001,
    "betas": [0.9, 0.98],
    "weight_decay": 0,
    "eps": 1e-9,
}

TRANSFORMER_LM_TPU = {
    "_import_": "models.transformer_lm.transformer_lm.TransformerLM",
    "fused_attention": True,
    "vocab_size": 512,
    "embed_dim": 512,
    "max_len": 5000,
    "num_layers": 12,
    "d_model": 512,
    "nhead": 16,
    "dim_feedforward": 2048,
    "dropout": 0.1,
    "activation": "relu",
    "layer_norm_eps": 1e-5,
    "norm_first": False,
    "loss_type": "ce",
    "vqvae": {"log_dir": "./logs/vqvae", "ckpt_num": 32500},
}

TRANSFORMER_LM_TPU_OPTIMIZER = {
    "name": "adam",
    "lr": 0.0002,
    "betas": [0.9, 0.98],
    "weight_decay": 0,
    "eps": 1e-9,
}

TRANSFORMER_LM_TPU_SCHEDULER = {"name": "linear", "warmup_steps": 1000}
