"""Model configurations as plain dicts (no YAML parser needed at run time).

``VQVAE_TPU`` is the ``model:`` section of ``configs/models/vqvae_tpu.yaml``
and ``VQVAE_TPU_OPTIMIZER`` its ``optimizer:`` section (its ``scheduler:`` is
null); ``TRANSFORMER_LM_TPU``, ``TRANSFORMER_LM_TPU_OPTIMIZER`` and
``TRANSFORMER_LM_TPU_SCHEDULER`` are the three sections of
``configs/models/transformer_lm_tpu.yaml``; ``GLOW_TTS_TPU``,
``GLOW_TTS_TPU_OPTIMIZER`` and ``GLOW_TTS_TPU_SCHEDULER`` those of
``configs/models/glow_tts_tpu.yaml``; ``VQTTS_TPU`` and
``VQTTS_TPU_OPTIMIZER`` those of ``configs/models/vqtts_tpu.yaml`` (its
``scheduler:`` is null), and ``LJSPEECH_TPU`` the ``dataset:``
section of ``configs/datasets/ljspeech_tpu.yaml``. Key for key; tests hold
them equal. ``TRAIN`` holds the defaults of train.py's train settings that
the port's step reads (``--ema``, ``--grad_clip_norm``, ``--bf16``).
"""


from __future__ import annotations

TRAIN = {"ema": False, "grad_clip_norm": None, "bf16": False}

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

GLOW_TTS_TPU = {
    "_import_": "models.glow_tts.glow_tts.GlowTTS",
    "fused_blocks": True,
    "fused_flow_step": False,
    "fused_encoder": True,
    "n_speakers": 1,
    "gin_channels": 0,
    "intersperse_blanks": None,
    "encoder": {
        "n_vocab": 148,
        "out_channels": None,
        "hidden_channels": 192,
        "filter_channels": 768,
        "filter_channels_dp": 256,
        "kernel_size": 3,
        "p_dropout": 0.1,
        "n_layers": 6,
        "n_heads": 2,
        "window_size": 4,
        "prenet": True,
        "mean_only": True,
    },
    "decoder": {
        "in_channels": None,
        "hidden_channels": 192,
        "kernel_size": 5,
        "n_blocks": 12,
        "n_layers": 4,
        "n_sqz": 2,
        "n_split": 4,
        "sigmoid_scale": False,
        "p_dropout": 0.05,
        "dilation_rate": 1,
    },
    "ddi": False,
}

GLOW_TTS_TPU_OPTIMIZER = {
    "name": "adam",
    "lr": 1.0,
    "betas": [0.9, 0.98],
    "weight_decay": 0,
    "eps": 1e-9,
}

GLOW_TTS_TPU_SCHEDULER = {"name": "noam", "warmup_steps": 4000}

VQTTS_TPU = {
    "_import_": "models.vqtts.vqtts.VQTTS",
    "fused_blocks": True,
    "fused_encoder": False,
    "n_speakers": 1,
    "gin_channels": 0,
    "encoder": {
        "n_vocab": 148,
        "out_channels": 128,
        "hidden_channels": 192,
        "filter_channels": 768,
        "filter_channels_dp": 256,
        "kernel_size": 3,
        "p_dropout": 0.1,
        "n_layers": 6,
        "n_heads": 2,
        "window_size": 4,
        "prenet": True,
        "mean_only": True,
    },
    "levels": 3,
    "downs_t": [3, 3, 2],
    "strides_t": [2, 2, 2],
    "emb_width": 128,
    "l_bins": 512,
    "mu": 0.99,
    "multipliers": [2, 1, 1],
    "width": 64,
    "depth": 3,
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
    "ddi": False,
    "loss": {
        "commit": 0.05,
        "multispectral": 1.0,
        "align": 0.1,
        "l1": 0.0,
        "l2": 1.0,
        "linf": 0.02,
        "linf_topk": 2048,
        "n_ffts": [2048, 1024, 512],
        "hop_lengths": [240, 120, 50],
        "win_lengths": [1200, 600, 240],
        "window": "hann",
        "log": False,
    },
}

VQTTS_TPU_OPTIMIZER = {
    "name": "adam",
    "lr": 0.0001,
    "betas": [0.9, 0.98],
    "weight_decay": 0,
    "eps": 1e-9,
}

LJSPEECH_TPU = {
    "_import_": "datasets.ljspeech.LJSpeech",
    "dataset_path": "./data/LJSpeech-1.1",
    "cmudict_path": "./data/cmudict.dict",
    "sample_rate": 22050,
    "n_fft": 1024,
    "hop_length": 256,
    "win_length": 1024,
    "n_mels": 80,
    "intersperse_blanks": True,
    "segment_length": -1,
    "on_device_spect": True,
    "use_token": True,
    "use_spect": True,
    "use_audio": True,
}
