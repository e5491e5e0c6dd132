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

Data parallel (``parallel/mesh.py``), one process (rank) per GPU:
``--n_devices N`` starts N local ranks, each on its own GPU (``-1``, the
default, takes every visible GPU, as the JAX CLI takes every device; one
GPU is one rank, run in this process with no process group, today's run);
with ``--platform cpu``, N ranks on the CPU over gloo (``-1`` is one).
``--multihost_coordinator host:port --num_processes P --process_id i``
joins P such processes (each with its local ranks) into one group, and
with ``--num_processes 1`` sets up a one-rank group. ``--batch_size`` is
the global batch, which must divide over the ranks; every rank loads it
and trains on its rows, and rank 0 writes the log dir. NCCL on the card,
gloo on the CPU; the kernels build once, behind a file lock.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
from typing import List, Optional

import numpy as np
import torch

from speech_masters_thesis_tpu_torch.device import cuda_device
from speech_masters_thesis_tpu_torch.models.base import TASK_OUTPUT
from speech_masters_thesis_tpu_torch.models.ema import default_mu
from speech_masters_thesis_tpu_torch.parallel import mesh
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
        (args.steps_per_dispatch > 1, "--steps_per_dispatch > 1", "A.6 (training tools)"),
        (args.profile_steps > 0, "--profile_steps > 0", "A.6 (training tools: utils/profiling.py)"),
        (args.prng_impl != "threefry", f"--prng_impl {args.prng_impl}",
         "A, 'Not to port' (the rbg/threefry PRNG switch: the port has one generator scheme)"),
    ]
    for bad, flag, item in unported:
        if bad:
            raise NotImplementedError(f"{flag} is not ported: ROADMAP.md {item}")


def local_ranks(args: argparse.Namespace) -> int:
    """This process's ranks: ``--n_devices`` GPUs (-1: every visible one) or CPU ranks (-1: one)."""
    if args.platform == "cpu":
        return max(args.n_devices, 1)
    cuda_device()  # raises when there is no card
    visible = torch.cuda.device_count()
    n = visible if args.n_devices == -1 else args.n_devices
    if not 1 <= n <= visible:
        raise ValueError(f"--n_devices {args.n_devices}: {visible} GPU(s) visible")
    return n


def rendezvous(args: argparse.Namespace, n_local: int) -> Optional[str]:
    """The group's coordinator (None: one rank, no group)."""
    if not 0 <= args.process_id < args.num_processes:
        raise ValueError(f"--process_id {args.process_id} with --num_processes {args.num_processes}")
    if args.num_processes > 1 and args.multihost_coordinator is None:
        raise ValueError("--num_processes > 1 needs --multihost_coordinator host:port")
    if args.multihost_coordinator is not None:
        return args.multihost_coordinator
    return f"localhost:{mesh.free_port()}" if n_local > 1 else None


def main(argv: Optional[List[str]] = None) -> Optional[TrainState]:
    """Runs the CLI; returns the final TrainState of a run in this process
    (None when it started its local ranks in processes of their own)."""
    args = parse_args(argv)
    reject_unported(args)
    n_local = local_ranks(args)
    coordinator = rendezvous(args, n_local)
    if n_local > 1:  # a rank a process, spawned; one that fails raises here
        torch.multiprocessing.start_processes(_rank_main, args=(args, n_local, coordinator), nprocs=n_local,
                                              join=True, start_method="spawn")
        return None
    return _run(args, 0, n_local, coordinator)


def _rank_main(local_rank: int, args: argparse.Namespace, n_local: int, coordinator: str) -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format=f"%(asctime)s rank {local_rank} %(name)s %(levelname)s %(message)s")
    if args.platform == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_local))
    _run(args, local_rank, n_local, coordinator)


def _run(args: argparse.Namespace, local_rank: int, n_local: int, coordinator: Optional[str]) -> TrainState:
    """One rank's run: joins the group when there is one, trains, leaves it."""
    if args.platform == "cpu":
        device = torch.device("cpu")
    elif coordinator is None:
        device = cuda_device()
    else:
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    if coordinator is not None:
        mesh.initialize(coordinator, args.num_processes * n_local, args.process_id * n_local + local_rank, device)
    try:
        return _train(args, device)
    finally:
        mesh.shutdown()


def _train(args: argparse.Namespace, device: torch.device) -> TrainState:
    config = build_config(args.model, args.dataset, {k: getattr(args, k) for k in TRAIN_FLAGS})
    if config.train.batch_size % mesh.world_size():
        raise ValueError(f"Global batch {config.train.batch_size} must divide across {mesh.world_size()} ranks")
    seed = config.train.seed
    random.seed(seed)  # dataset crops
    np.random.seed(seed)
    logger.info("Training on %s (rank %d of %d)",
                torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU", mesh.rank(),
                mesh.world_size())
    if config.train.fp16:
        logger.info("--fp16 requested: the port has no fp16 mode and no GradScaler; --bf16 is its mixed precision")
    setup_logdir(config)
    writer = ScalarWriter(config.train.log_dir) if mesh.rank() == 0 else None

    model = harness.get_model(config, device=device)
    harness.elide_features(config, model)
    harness.init_model_variables(model, None, seed)
    harness.load_pretrained_submodules(model, config)
    mesh.broadcast_module(model)
    if mesh.rank() == 0:
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
    if writer is not None:
        writer.close()
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
