"""Training CLI (counterpart of train.py).

    python -m speech_masters_thesis_tpu_torch.scripts.train --model vqvae_tpu \\
        --dataset ljspeech --log_dir ./logs/vqvae --bf16 --ema

train.py's flags, and its order: seed ``random`` and ``np.random``; the log
dir (``config.json``); the model and its seeded parameters; the graft of a
trained codec into the LM and the summary; DDI on one train batch when the
model asks for it and no checkpoint is loaded; the optimizer, schedule and
frozen mask; the TrainState, so the EMA starts from the DDI'd parameters;
``--load_ckpt`` restores, else a DDI'd model is saved as ``ckpt.0``; the
optional sanity val epoch; epochs until ``--total_epochs``, or until
``--max_steps`` is reached at an epoch's end, with val every
``--eval_every_n_epochs``; ``ckpt.last`` at the end and on
KeyboardInterrupt (Ctrl-C lets the running step end, and the checkpoint
records the steps taken). The VQ-VAE's codebook initializes lazily in the
first train step, from that step's encodings, as the JAX CLI's does.

``--model`` / ``--dataset`` take a name of ``configs.MODELS`` /
``configs.DATASETS`` (the YAML stems under ``configs/``) or a ``.json``
path with the same sections; the default model is ``vqvae_tpu``, since the
reference's ``vqvae`` config is not in the port's table. Scalars go to
``<log_dir>/scalars.jsonl`` under the JAX CLI's TensorBoard tags. The run
goes on the card (it raises when there is none) unless ``--platform cpu``.
Flags for what the port does not have raise NotImplementedError and name
the ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import logging
import random
from typing import List, Optional

import numpy as np
import torch

from speech_masters_thesis_tpu_torch.device import cuda_device
from speech_masters_thesis_tpu_torch.models.base import TASK_OUTPUT
from speech_masters_thesis_tpu_torch.models.ema import default_mu
from speech_masters_thesis_tpu_torch.train import artifacts, checkpoint, harness, loop
from speech_masters_thesis_tpu_torch.train.optim import build_optimizer
from speech_masters_thesis_tpu_torch.train.state import TrainState
from speech_masters_thesis_tpu_torch.utils.config import build_config, setup_logdir
from speech_masters_thesis_tpu_torch.utils.scalars import ScalarWriter

logger = logging.getLogger("train")

TRAIN_FLAGS = ("log_dir", "seed", "batch_size", "ema", "grad_clip_norm", "fp16", "bf16", "num_workers",
               "n_devices", "total_epochs", "load_ckpt", "ckpt_every_n_steps", "log_every_n_steps",
               "eval_every_n_epochs", "run_sanity_val_epoch", "max_steps", "total_steps", "profile_steps",
               "steps_per_dispatch")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="vqvae_tpu",
                        help="Name in configs.MODELS or path to a .json config")
    parser.add_argument("--dataset", type=str, default="ljspeech",
                        help="Name in configs.DATASETS or path to a .json config")
    parser.add_argument("--log_dir", type=str, default="./logs/vqvae")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--ema", default=False, action="store_true")
    parser.add_argument("--grad_clip_norm", type=float, default=None)
    parser.add_argument("--fp16", default=False, action="store_true",
                        help="Accepted for CLI parity and logged; use --bf16 for mixed precision")
    parser.add_argument("--bf16", default=False, action="store_true",
                        help="Forward in bfloat16 over fp32 master weights")
    parser.add_argument("--num_workers", type=int, default=2, help="Loader prefetch threads")
    parser.add_argument("--n_devices", "--n_gpus", dest="n_devices", type=int, default=-1)
    parser.add_argument("--total_epochs", type=int, default=1000)
    parser.add_argument("--load_ckpt", type=str, default=None)
    parser.add_argument("--ckpt_every_n_steps", type=int, default=10000)
    parser.add_argument("--log_every_n_steps", type=int, default=10)
    parser.add_argument("--eval_every_n_epochs", type=int, default=5)
    parser.add_argument("--run_sanity_val_epoch", default=False, action="store_true")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="Stop at the end of the epoch that reaches this step")
    parser.add_argument("--total_steps", type=int, default=None,
                        help="Annealing horizon for scheduler: cosine (T_max)")
    parser.add_argument("--profile_steps", type=int, default=0)
    parser.add_argument("--steps_per_dispatch", type=int, default=1)
    parser.add_argument("--prng_impl", type=str, default="threefry", choices=["threefry", "rbg"])
    parser.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda", "gpu"],
                        help="'cpu' runs on the CPU; default: the card")
    parser.add_argument("--multihost_coordinator", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=1)
    parser.add_argument("--process_id", type=int, default=0)
    return parser.parse_args(argv)


def reject_unported(args: argparse.Namespace) -> None:
    """Raises NotImplementedError for a flag whose feature the port lacks."""
    unported = [
        (args.n_devices > 1, "--n_devices > 1", "A.4 (data parallel)"),
        (args.multihost_coordinator is not None, "--multihost_coordinator", "A.4 (data parallel)"),
        (args.num_processes > 1, "--num_processes > 1", "A.4 (data parallel)"),
        (args.process_id != 0, f"--process_id {args.process_id}", "A.4 (data parallel)"),
        (args.steps_per_dispatch > 1, "--steps_per_dispatch > 1", "A.6 (training tools)"),
        (args.profile_steps > 0, "--profile_steps > 0", "A.6 (training tools: utils/profiling.py)"),
        (args.prng_impl != "threefry", f"--prng_impl {args.prng_impl}",
         "A, 'Not to port' (the rbg/threefry PRNG switch: the port has one generator scheme)"),
    ]
    for bad, flag, item in unported:
        if bad:
            raise NotImplementedError(f"{flag} is not ported: ROADMAP.md {item}")


def main(argv: Optional[List[str]] = None) -> TrainState:
    """Runs the CLI; returns the final TrainState."""
    args = parse_args(argv)
    reject_unported(args)
    device = torch.device("cpu") if args.platform == "cpu" else cuda_device()
    config = build_config(args.model, args.dataset, {k: getattr(args, k) for k in TRAIN_FLAGS})
    seed = config.train.seed
    random.seed(seed)  # dataset crops
    np.random.seed(seed)
    logger.info("Training on %s", torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU")
    if config.train.fp16:
        logger.info("--fp16 requested: the port has no fp16 mode and no GradScaler; --bf16 is its mixed precision")
    setup_logdir(config)
    writer = ScalarWriter(config.train.log_dir)

    model = harness.get_model(config, device=device)
    harness.elide_features(config, model)
    harness.init_model_variables(model, None, seed)
    harness.load_pretrained_submodules(model, config)
    harness.print_top_level_summary(model)

    train_loader, val_loader = harness.get_dataloaders(config)
    ddi_ran = False
    if config.model.get("ddi") and not config.train.load_ckpt and hasattr(model, "ddi_init"):
        logger.info("Running DDI ...")
        ddi_ran = harness.maybe_ddi_init(model, config, loop.to_device(next(iter(train_loader)), device))

    optimizer, schedule = build_optimizer(harness.trainable_parameters(model), config.optimizer,
                                          config.get("scheduler"), config.model, config.train)
    state = TrainState.create(model, optimizer, use_ema=config.train.ema)

    global_step, epoch = 0, 0
    if config.train.load_ckpt:
        state, global_step, epoch = checkpoint.restore_checkpoint(config.train.load_ckpt, state)
        logger.info("Restored checkpoint %s at step %d epoch %d", config.train.load_ckpt, global_step, epoch)
    elif ddi_ran:
        checkpoint.save_checkpoint(config, 0, 0, state)

    train_step = harness.make_train_step_for(config, schedule, default_mu(config.train.batch_size, 1))
    val_step = loop.make_val_step(config.train.ema)
    artifact_fn = (artifacts.save_audio_and_computed_spect if TASK_OUTPUT[type(model).TASK] == "waveform"
                   else artifacts.save_spect_and_inverted_audio)

    def ckpt_cb(st, gs, ep):
        checkpoint.save_checkpoint(config, gs, ep, st)

    def run_val():
        return loop.val_epoch(state=state, epoch=epoch, config=config, val_step=val_step, dataloader=val_loader,
                              writer=writer, artifact_fn=artifact_fn)

    if config.train.run_sanity_val_epoch:
        logger.info("Running sanity val epoch")
        logger.info("Sanity val epoch done: %s", run_val())

    try:
        while epoch < config.train.total_epochs:
            state, global_step = loop.train_epoch(
                state=state, global_step=global_step, epoch=epoch, config=config, train_step=train_step,
                dataloader=train_loader, seed=seed + 1, writer=writer, save_ckpt=ckpt_cb)
            epoch += 1
            if epoch % config.train.eval_every_n_epochs == 0:
                run_val()
            if config.train.max_steps and global_step >= config.train.max_steps:
                logger.info("Reached max_steps=%d", config.train.max_steps)
                break
    except KeyboardInterrupt as interrupt:  # train_epoch's carries the steps it took
        global_step = getattr(interrupt, "global_step", global_step)
        logger.info("Interrupted at step %d; saving final checkpoint", global_step)

    checkpoint.save_checkpoint(config, global_step, -1, state)
    writer.close()
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
