"""The port's data-parallel training (parallel/mesh.py) against its
1-process step and the JAX package's n-device step, on the CPU.

Two ranks over gloo, spawned with ``torch.multiprocessing`` and joined with
a timeout (a hung rank fails the test), run one SGD step of each of the four
models at tiny widths (tests/torch_dp_cases.py), dropout 0, on a global
batch of 4 rows whose ragged lengths are spread unevenly: rank 0 holds the
two long rows, rank 1 the two short ones. The VQ-VAE starts with its
codebook uninitialized (the lazy init runs inside the step) and a revival
threshold that revives most codes. Every loss, metric, parameter, EMA
parameter and codebook tensor equals the 1-process step on the same global
batch within rtol 1e-5, atol 1e-6 (fp32, other summation orders); so does
the LM with its MMI loss, a function of the global code distribution. A control
takes the DDP mean instead, each rank's own masked means averaged: it
misses that tolerance on the same batch. The VQ-VAE at
tests/test_torch_train.py's setup (JAX's weights, an initialized codebook)
is held to JAX's step on a 2-device mesh of conftest's virtual devices at
the multi-device dryrun's equality tolerance (rtol 2e-4, atol 1e-5). At
p = 0.1 the replicas stay bitwise equal over 2 steps. The kernel seed mix
equals JAX's int32 formula. The CLI: one rank with and without a one-rank
group writes the same ``ckpt.last`` bit for bit; two ranks from
``--n_devices 2`` and from two processes joined by
``--multihost_coordinator`` write the 1-rank run's within the tolerance
above.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dp_cases as cases
from speech_masters_thesis_tpu.models.vqvae.model import VQVAE as JaxVQVAE
from speech_masters_thesis_tpu.train import loop as jloop
from speech_masters_thesis_tpu.train import optim as joptim
from speech_masters_thesis_tpu.train.state import TrainState as JaxTrainState
from speech_masters_thesis_tpu.utils.config import Config as JaxConfig
from speech_masters_thesis_tpu.utils.config import load_config as jax_load_config
from speech_masters_thesis_tpu_torch.convert import codebook_from_jax, params_from_jax, vqvae_state_dict_from_jax
from speech_masters_thesis_tpu_torch.ops.basic import draw_seed
from speech_masters_thesis_tpu_torch.parallel import mesh
from speech_masters_thesis_tpu_torch.scripts import train as train_cli
from speech_masters_thesis_tpu_torch.scripts.make_synth_dataset import write_corpus
from speech_masters_thesis_tpu_torch.train import checkpoint
from speech_masters_thesis_tpu_torch.utils.scalars import read_scalars
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread, as the ranks)
from test_torch_train import LOSS_KEYS, METRIC_KEYS, _model_cfg, _variables

RTOL, ATOL = 1e-5, 1e-6
ORACLE_RTOL, ORACLE_ATOL = 2e-4, 1e-5  # __graft_entry__._equality_oracle's
WORLD = 2
JOIN_TIMEOUT_S = 240
REVIVAL_THRESHOLD = 1.005  # mu 0.99: a code stays only with 2 or more rows in the batch
PARTS = ("params", "ema", "codebook")


def _fixture(name):
    return jax_load_config(os.path.join("tests", "fixtures", name)).to_dict()


def _configs() -> dict:
    dataset = _fixture("ljspeech_tiny.yaml")["dataset"]
    vq = _fixture("vqvae_tiny.yaml")
    vq["model"].update(zero_out=False, revival_threshold=REVIVAL_THRESHOLD)
    glow = _fixture("glow_tts_tiny.yaml")
    glow["model"]["encoder"]["prenet"] = False  # its dropout rate is fixed in the model
    vqtts = _fixture("vqtts_tiny.yaml")
    vqtts["model"]["encoder"]["prenet"] = False
    vqtts["model"]["zero_out"] = False
    lm = {"_import_": "models.transformer_lm.transformer_lm.TransformerLM", "fused_attention": True,
          "vocab_size": 16, "embed_dim": 32, "max_len": 64, "num_layers": 2, "d_model": 32, "nhead": 2,
          "dim_feedforward": 64, "dropout": 0.0, "activation": "relu", "layer_norm_eps": 1e-5,
          "norm_first": False, "loss_type": "ce"}
    return {"vqvae": vq, "lm": {"model": lm}, "glow": {**glow, "dataset": dataset},
            "vqtts": {**vqtts, "dataset": dataset}, "vqvae_jax": {"model": _model_cfg()},
            "lm_mmi": {"model": dict(lm, loss_type="mmi")}}


def _join(procs) -> None:
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    assert not hung, f"ranks {hung} did not end within {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs), [p.exitcode for p in procs]


def _start(target, args_of_rank) -> list:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of_rank(r)) for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The configs, the JAX-initialized VQ-VAE's state file, what the two
    ranks hold after their steps, and JAX's step on a 2-device mesh (which
    compiles while the ranks run)."""
    root = tmp_path_factory.mktemp("dp")
    configs = _configs()
    cfg = configs["vqvae_jax"]["model"]
    jmodel = JaxVQVAE(config={"model": cfg})
    variables = _variables(cfg, jmodel)
    state_files = {"vqvae_jax": str(root / "vqvae_jax.pt")}
    torch.save({**vqvae_state_dict_from_jax(variables, cfg), **codebook_from_jax(variables["codebook"])},
               state_files["vqvae_jax"])
    port = mesh.free_port()
    procs = _start(cases.worker, lambda r: (r, WORLD, port, configs, str(root), state_files))
    try:
        jax_out = _jax_step(configs, cfg, jmodel, variables)
    finally:
        _join(procs)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True) for r in range(WORLD)]
    return {"configs": configs, "state_files": state_files, "jax": jax_out, "ranks": ranks}


def _jax_step(configs, cfg, jmodel, variables) -> dict:
    """JAX's train step on a 2-device mesh of conftest's virtual CPU devices."""
    tx, _ = joptim.build_optimizer(JaxConfig({"model": cfg, "optimizer": cases.OPTIMIZER, "scheduler": None}))
    mesh2 = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    replicated, rows = NamedSharding(mesh2, P()), NamedSharding(mesh2, P("data"))
    jstate = jax.tree.map(lambda a: jax.device_put(a, replicated),
                          JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx, use_ema=True))
    batch = cases.batch("vqvae_jax", configs)
    jbatch = {"audio": jax.device_put(batch["audio"].numpy(), rows),
              "audio_len": jax.device_put(batch["audio_len"].numpy().astype(np.int32), rows), "speaker": None}
    jstep = jloop.make_train_step(jmodel, tx, cases.EMA_MU, use_ema=True, mesh=mesh2)
    jstate, jscalars = jstep(jstate, jbatch, jax.random.PRNGKey(0))
    return {"scalars": {k: float(v) for k, v in jscalars.items()}, "state": jax.tree.map(np.asarray, jstate)}


@pytest.fixture(scope="module")
def ranks(setup):
    return setup["ranks"]


@pytest.fixture(scope="module")
def one_process(setup):
    return {name: cases.run(name, setup["configs"], state_file=setup["state_files"].get(name))
            for name in setup["configs"]}


def _excess(ours: dict, ref: dict) -> dict:
    """Per scalar and tensor: max |ours - ref| - (ATOL + RTOL |ref|), > 0 where the tolerance is missed."""
    out = {}
    for k, v in ref["scalars"].items():
        out[k] = abs(float(ours["scalars"][k]) - float(v)) - (ATOL + RTOL * abs(float(v)))
    for part in PARTS:
        for k, v in ref[part].items():
            a, b = ours[part][k].double(), v.double()
            out[f"{part} {k}"] = float(((a - b).abs() - (ATOL + RTOL * b.abs())).max())
    return out


@pytest.mark.parametrize("name", cases.CASES + ("lm_mmi", "vqvae_jax"))
def test_two_ranks_equal_the_one_process_step(ranks, one_process, name):
    missed = {k: e for k, e in _excess(ranks[0][name], one_process[name]).items() if e > 0}
    assert not missed, missed
    for part in PARTS:  # and the replicas hold the same state, bit for bit
        assert all(torch.equal(v, ranks[1][name][part][k]) for k, v in ranks[0][name][part].items()), part
    if name == "vqvae":  # the lazy init ran inside the step, and revived some codes but not all
        usage = float(one_process[name]["scalars"]["usage"])
        assert 0 < usage < one_process[name]["codebook"]["bottleneck.level_blocks.0.k"].shape[0], usage


@pytest.mark.parametrize("name", cases.CASES)
def test_averaging_per_rank_means_misses_the_tolerance(setup, one_process, name):
    """DDP's mean: each rank's step on its own rows as a 1-process step, the
    losses and (SGD, so linear) the parameters averaged over the ranks."""
    halves = [cases.run(name, setup["configs"], rows=slice(2 * r, 2 * r + 2)) for r in range(WORLD)]
    averaged = {"scalars": {"loss": sum(h["scalars"]["loss"] for h in halves) / WORLD},
                **{part: {k: sum(h[part][k] for h in halves) / WORLD for k in one_process[name][part]
                          if one_process[name][part][k].is_floating_point()} for part in ("params", "ema")},
                "codebook": {}}
    ref = {"scalars": {"loss": one_process[name]["scalars"]["loss"]},
           **{part: {k: one_process[name][part][k] for k in averaged[part]} for part in ("params", "ema")},
           "codebook": {}}
    excess = _excess(averaged, ref)
    assert excess["loss"] > 0 and max(excess.values()) > 0, excess["loss"]


@pytest.mark.parametrize("name", cases.CASES)
def test_replicas_stay_bitwise_equal_with_dropout(ranks, name):
    a, b = ranks[0][name + "@p"], ranks[1][name + "@p"]
    for part in PARTS:
        unequal = [k for k, v in a[part].items() if not torch.equal(v, b[part][k])]
        assert not unequal, (part, unequal[:5])
    assert all(torch.equal(v, b["scalars"][k]) for k, v in a["scalars"].items())


def test_vqvae_two_ranks_match_jax_on_a_two_device_mesh(setup, ranks, one_process):
    """The scalars and the codebook at the dryrun's tolerance; the parameters
    as close to JAX's as the 1-process step's are (the log-magnitude STFT
    loss makes fp32 gradients ill-conditioned: tests/test_torch_train.py)."""
    ours, jax_out = ranks[0]["vqvae_jax"], setup["jax"]
    for key in LOSS_KEYS + METRIC_KEYS:
        np.testing.assert_allclose(float(ours["scalars"][key]), jax_out["scalars"][key], rtol=ORACLE_RTOL,
                                   atol=ORACLE_ATOL, err_msg=key)
    cfg = setup["configs"]["vqvae_jax"]["model"]
    for name, want in codebook_from_jax(jax_out["state"].model_state["codebook"]).items():
        np.testing.assert_allclose(ours["codebook"][name].numpy(), want.numpy(), rtol=ORACLE_RTOL,
                                   atol=ORACLE_ATOL, err_msg=name)
    for part, jax_tree in (("params", jax_out["state"].params), ("ema", jax_out["state"].ema_params)):
        want = params_from_jax(jax_tree, cfg)
        two = max(float((ours[part][k] - v).abs().max()) for k, v in want.items())
        one = max(float((one_process["vqvae_jax"][part][k] - v).abs().max()) for k, v in want.items())
        assert two <= one + ATOL, (two, one)


def test_seed_mix_equals_the_jax_int32_formula(monkeypatch):
    """bits + rank * 1640531527 in int32 (wrapping), as the JAX kernels'
    shard_map wrappers mix axis_index into the seed, for ranks 0-7; the
    port's seeds are the same 32 bits read as uint32."""
    seeds = np.array([0, 1, 12345, 2 ** 31 - 1, 2 ** 31, 3_000_000_000, 2 ** 32 - 1], np.uint32)
    gen = torch.Generator().manual_seed(3)
    drawn = int(draw_seed(torch.Generator().manual_seed(3), "cpu"))
    for rank in range(8):
        want = _jax_mix(seeds, rank)
        monkeypatch.setattr(mesh, "_GROUP", mesh._Group(8, rank, torch.device("cpu")))
        assert [mesh.mix_seed(int(s)) for s in seeds] == want, rank
        assert mesh.mix_seed(torch.from_numpy(seeds.astype(np.int64))).tolist() == want, rank
        assert int(draw_seed(gen.manual_seed(3), "cpu")) == _jax_mix([drawn], rank)[0]
        with mesh.local():  # the data-dependent init draws rank 0's seeds
            assert int(draw_seed(gen.manual_seed(3), "cpu")) == drawn
    assert (rank + 1) * 1640531527 > 2 ** 32  # the wrap was exercised


def _jax_mix(seeds, rank: int) -> list:
    """The JAX kernels' mix on each seed's 32 bits, read back as uint32."""
    bits = jnp.asarray(np.asarray(seeds, np.uint32).view(np.int32))
    mixed = bits + jnp.asarray(rank, jnp.int32) * jnp.int32(1640531527)
    return np.asarray(mixed).view(np.uint32).tolist()


CLI_SEED = 3


def _cli_argv(files: dict, log_dir, *extra) -> list:
    return ["--model", files["vq"], "--dataset", files["lj"], "--log_dir", str(log_dir), "--batch_size", "4",
            "--seed", str(CLI_SEED), "--platform", "cpu", "--num_workers", "0", "--total_epochs", "1", "--ema",
            "--eval_every_n_epochs", "1", "--log_every_n_steps", "1", *extra]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The VQ-VAE CLI (dropout 0, SGD) for one epoch, one step at global batch 4: one rank
    (``--n_devices 1``), one rank in a one-rank group, two ranks from
    ``--n_devices 2``, and two processes of one rank each joined by
    ``--multihost_coordinator``; each run's ``ckpt.last``."""
    root = tmp_path_factory.mktemp("dp_cli")
    write_corpus(str(root / "LJ"), str(root / "cmudict.dict"), n=14, min_sec=0.3, max_sec=0.6, seed=CLI_SEED)
    dataset = _fixture("ljspeech_tiny.yaml")
    dataset["dataset"].update(dataset_path=str(root / "LJ"), cmudict_path=str(root / "cmudict.dict"))
    vq = _fixture("vqvae_tiny.yaml")
    vq["model"]["p_dropout"] = 0.0
    # no log-magnitude STFT term: its 1/|Y| near the clamp makes the fp32 gradient ill-conditioned
    # (tests/test_torch_train.py), so the ranks' other summation order would move it past the tolerance
    vq["model"]["loss"]["log"] = False
    vq["optimizer"] = dict(cases.OPTIMIZER, lr=1e-3)
    files = {}
    for name, config in (("lj", dataset), ("vq", vq)):
        files[name] = str(root / f"{name}.json")
        with open(files[name], "w", encoding="utf-8") as f:
            json.dump(config, f)
    port = mesh.free_port()  # the joined processes run beside the runs below
    procs = _start(cases.cli, lambda r: (_cli_argv(files, root / "hosts", "--multihost_coordinator", f"localhost:{port}",
                                                   "--num_processes", str(WORLD), "--process_id", str(r)),))
    try:
        train_cli.main(_cli_argv(files, root / "one", "--n_devices", "1"))
        train_cli.main(_cli_argv(files, root / "group", "--n_devices", "1", "--multihost_coordinator",
                                 f"localhost:{mesh.free_port()}", "--num_processes", "1", "--process_id", "0"))
        assert train_cli.main(_cli_argv(files, root / "two", "--n_devices", "2")) is None
    finally:
        _join(procs)
    return {run: checkpoint.load_payload(checkpoint.ckpt_dir(str(root / run), "last"))
            for run in ("one", "group", "two", "hosts")} | {"root": root}


def _tensors(payload: dict) -> dict:
    out = {f"model {k}": v for k, v in payload["model"].items()}
    out.update({f"ema {k}": v for k, v in payload["ema"].items()})
    out.update({f"codebook {k}": v for k, v in payload["codebook"].items()})
    return out


def test_cli_one_rank_writes_the_same_checkpoint_with_a_one_rank_group(cli_runs):
    one, group = cli_runs["one"], cli_runs["group"]
    assert (one["step"], one["sched"]) == (group["step"], group["sched"]) == (1, 1)
    a, b = _tensors(one), _tensors(group)
    assert a.keys() == b.keys() and all(torch.equal(v, b[k]) for k, v in a.items())
    assert one["optim"]["param_groups"] == group["optim"]["param_groups"]


def test_cli_two_ranks_train_on_the_global_batch(cli_runs):
    """Two ranks of two rows each, from either launch (local ranks; processes
    joined at a coordinator): the 1-rank run's checkpoint within the step's
    tolerance; rank 0 alone logged the scalars."""
    one = _tensors(cli_runs["one"])
    for run in ("two", "hosts"):
        assert cli_runs[run]["step"] == 1
        ours = _tensors(cli_runs[run])
        for k, v in one.items():
            if v.is_floating_point():
                torch.testing.assert_close(ours[k], v, rtol=RTOL, atol=ATOL, msg=f"{run}: {k}")
            else:
                assert torch.equal(ours[k], v), (run, k)
    rows = {run: read_scalars(str(cli_runs["root"] / run)) for run in ("one", "two")}
    assert [r["tag"] for r in rows["two"]] == [r["tag"] for r in rows["one"]]


@pytest.mark.parametrize("flag", [["--n_devices", "2"], ["--multihost_coordinator", "localhost:1234"],
                                  ["--num_processes", "2"], ["--process_id", "1"]])
def test_data_parallel_flags_are_ported(flag):
    train_cli.reject_unported(train_cli.parse_args(flag))


@pytest.mark.parametrize("flag", [["--steps_per_dispatch", "2"], ["--profile_steps", "1"]])
def test_training_tools_flags_still_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        train_cli.reject_unported(train_cli.parse_args(flag))
