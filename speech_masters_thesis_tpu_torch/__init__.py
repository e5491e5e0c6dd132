"""PyTorch/CUDA port of speech_masters_thesis_tpu, for one NVIDIA H100.

Mirrors the JAX package's layout (``ops/``, ``models/vqvae/``, ...) so every
module has a counterpart there. Public functions keep the JAX package's NTC
layout ([batch, time, channels]). Parameters use the reference torch
``state_dict`` layout (``encoders.0.level_blocks.{l}.blocks.{i}...``), so a
reference checkpoint loads with ``load_state_dict``.

This package imports torch and never jax. Kernels written for Hopper live in
``csrc/`` and are built on first use by ``ops/_build.py``.
"""
