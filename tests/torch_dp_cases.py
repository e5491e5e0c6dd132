"""Train steps of the port's four models at tiny widths, for the
data-parallel tests (tests/test_torch_data_parallel.py): run in the test's
process with no process group (the 1-process step on the global batch) and
in ranks that ``worker`` starts over gloo. Imports torch and the port, not
JAX, so a spawned rank starts quickly.

Every case's global batch has 4 rows with ragged lengths spread unevenly:
rank 0 of 2 holds the two long rows and rank 1 the two short ones. The
configs arrive as plain dicts (the YAML fixtures read by the test).
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from speech_masters_thesis_tpu_torch.models.vqtts.model import VQTTS
from speech_masters_thesis_tpu_torch.parallel import mesh
from speech_masters_thesis_tpu_torch.scripts import train as train_cli
from speech_masters_thesis_tpu_torch.train import checkpoint, harness, loop, optim
from speech_masters_thesis_tpu_torch.train.state import TrainState

CASES = ("vqvae", "lm", "glow", "vqtts")
# the update is lr x the gradient: no normalisation hides an error
OPTIMIZER = {"name": "sgd", "lr": 0.05, "momentum": 0.0, "weight_decay": 0.0}
EMA_MU = 0.9
INIT_SEED, STEP_SEED = 7, 11
P_TRAIN = 0.1


def _with_dropout(name: str, config: Mapping, p: float) -> dict:
    config = copy.deepcopy(dict(config))
    model = config["model"]
    if name in ("vqvae", "vqvae_jax", "vqtts"):
        model["p_dropout"] = p
    if name.startswith("lm"):
        model["dropout"] = p
    if name in ("glow", "vqtts"):
        model["encoder"]["p_dropout"] = p
    if name == "glow":
        model["decoder"]["p_dropout"] = p / 2
    return config


def build(name: str, configs: Mapping, p: float = 0.0, state_file: Optional[str] = None):
    """(TrainState, train step) of a case, from its seeded initializers, or
    from ``state_file`` (a model state, as ``restore_model_state`` gives)."""
    model = harness.get_model(_with_dropout(name, configs[name], p), device="cpu")
    harness.init_model_variables(model, None, INIT_SEED)
    if state_file is not None:
        checkpoint.load_model_state(model, torch.load(state_file, weights_only=True))
    if isinstance(model, VQTTS):  # the quant decoder's dropout is fixed in the model: the case's p here too
        for m in model.quant_decoder.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = p
    opt, schedule = optim.build_optimizer(model.parameters(), OPTIMIZER)
    return TrainState.create(model, opt, use_ema=True), loop.make_train_step(schedule, EMA_MU, use_ema=True)


def batch(name: str, configs: Mapping) -> Dict[str, torch.Tensor]:
    """The case's global batch (rows 0-1 long, rows 2-3 short)."""
    rng = np.random.RandomState(CASES.index(name.split("_")[0]) + 1)
    if name.startswith("vqvae"):
        lengths = np.array([2048, 1920, 640, 512])
        return {"audio": torch.from_numpy(rng.uniform(-0.8, 0.8, (4, 2048)).astype(np.float32)),
                "audio_len": torch.from_numpy(lengths)}
    if name.startswith("lm"):
        lengths = np.array([24, 22, 9, 6])
        vocab = configs[name]["model"]["vocab_size"]
        tokens = rng.randint(2, vocab + 2, (4, 24))
        tokens[:, 0] = 1  # BOS
        for b, n in enumerate(lengths):
            tokens[b, n:] = 0  # PAD
        return {"token": torch.from_numpy(tokens), "token_len": torch.from_numpy(lengths)}
    x_len = np.array([20, 18, 8, 6]) if name == "glow" else np.array([12, 11, 5, 4])
    tokens = rng.randint(1, 60, (4, int(x_len.max())))
    out = {"token": torch.from_numpy(tokens), "token_len": torch.from_numpy(x_len)}
    if name == "glow":
        n_mels = configs[name]["dataset"]["n_mels"]
        y_len = np.array([64, 60, 24, 18])
        out.update(spect=torch.from_numpy(rng.randn(4, 64, n_mels).astype(np.float32)),
                   spect_len=torch.from_numpy(y_len))
    else:
        y_len = np.array([6144, 5632, 2560, 2048])
        out.update(audio=torch.from_numpy(rng.uniform(-0.5, 0.5, (4, 6144)).astype(np.float32)),
                   audio_len=torch.from_numpy(y_len))
    return out


def snapshot(state: TrainState, scalars: Mapping[str, torch.Tensor]) -> dict:
    return {"scalars": {k: v.detach().clone() for k, v in scalars.items()},
            "params": {k: v.detach().clone() for k, v in state.params.items()},
            "ema": {k: v.clone() for k, v in state.ema_params.items()},
            "codebook": {k: v.clone() for k, v in state.codebook.items()}}


def run(name: str, configs: Mapping, p: float = 0.0, steps: int = 1, rows: Optional[slice] = None,
        state_file: Optional[str] = None) -> dict:
    """``steps`` train steps on the case's global batch (or its ``rows``),
    each rank on its rows of it; the state and scalars after the last."""
    state, step = build(name, configs, p, state_file)
    full = batch(name, configs)
    if rows is not None:
        full = {k: v[rows] for k, v in full.items()}
    for _ in range(steps):
        scalars = step(state, mesh.shard_batch(full), STEP_SEED)
    return snapshot(state, scalars)


def worker(rank: int, world: int, port: int, configs: Mapping, out_dir: str,
           state_files: Mapping[str, str]) -> None:
    """One rank: joins the gloo group, runs every case at p = 0 (one step)
    and at p = P_TRAIN (two steps), and saves what it holds."""
    torch.set_num_threads(1)
    mesh.initialize(f"localhost:{port}", world, rank, torch.device("cpu"))
    try:
        out = {}
        for name in configs:
            out[name] = run(name, configs, state_file=state_files.get(name))
            if name in CASES:
                out[name + "@p"] = run(name, configs, p=P_TRAIN, steps=2)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


def cli(argv: list) -> None:
    """A process of a multi-process CLI run, on one thread."""
    torch.set_num_threads(1)
    train_cli.main(argv)
