"""The port's data axis (parallel/, and the trainer on W processes) against
the one-process port and the JAX package, on the CPU.

A W-rank step must be the one-process step on the ranks' batches put end
to end, as the JAX step is one function of the global array. The test
starts one 2-rank gloo group (tests/torch_parallel_worker.py; a free port,
one thread a rank, hard timeouts; the ranks import only the port) and
holds what it returns against references it computes itself:

  * DDP (with --grad_checkpointing) and FSDP2 after 2 steps of test_vit,
    and both on test_convnext (FSDP2 on each stages.S.blocks.B), (fp32,
    mixup and cutmix, drop_path 0.1, --device_augment with
    erasing) against the one-process port on the global batch: the
    model's inputs and every drop-path mask bit for bit, the global
    losses to 1e-6 relative, the first step's gradients to 1e-5 of their
    largest, params and EMA to 1e-5 absolute but where AdamW magnifies a
    near-zero gradient's rounding (`_assert_adam_close`); the eval totals,
    plain and EMA, against the one-process eval of the ranks' eval
    batches put end to end. (The kernel route's autograd Functions under
    both wrappers run on the card: chip_smoke.py phases 32-33.)
  * DDP on test_vit, fed JAX's mixup draws with drop_path 0, against JAX's
    step on the global batch with test_torch_train.py's tolerances.
  * Checkpoints from the 2-rank FSDP run into one process, and from one
    process into 2-rank FSDP shards.
  * main() on 2 ranks: one rank prints, one log.txt.

The mesh's parsing and errors, the batch checks and the per-process
streams are held against the JAX package's, with jax.process_index and
process_count monkeypatched in the test.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from vision_transformers_torch_xla_tpu_torch.ckpt.checkpoint import (
    CheckpointManager,
)
from vision_transformers_torch_xla_tpu_torch.core.config import TrainConfig
from vision_transformers_torch_xla_tpu_torch.data import loader, native
from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
from vision_transformers_torch_xla_tpu_torch.parallel import mesh, sharding

# the port tools/test_multiprocess.py takes for its JAX group
JAX_GROUP_PORT = 19584
GROUP_TIMEOUT_S = 240


def _free_port() -> int:
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port != JAX_GROUP_PORT:
            return port


# ---- the mesh, the batch checks, the per-process streams -----------------

MESHES = [([("data", -1)], 1), ([("data", -1)], 4), ([("data", 4)], 4),
          ([("data", -1), ("model", 1)], 2), ([("data", 2), ("model", 1)], 2),
          ([("data", -1), ("model", -1)], 4), ([("data", 3)], 4),
          ([("data", -1), ("model", 3)], 4), ([("data", 8)], 4)]


@pytest.mark.parametrize("axes,n", MESHES)
def test_mesh_sizes_match_jax_create_mesh(axes, n):
    """The sizes and errors of JAX's create_mesh; a mesh smaller than the
    devices is JAX's subset of the first devices, which the port's mesh
    takes as its first ranks (parallel/mesh.py::create_mesh)."""
    import jax

    from vision_transformers_torch_xla_tpu.parallel.mesh import (
        create_mesh as jax_create_mesh,
    )

    devices = jax.devices("cpu")[:n]
    try:
        jax_mesh = jax_create_mesh(axes, devices=devices)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("{", r"\{")
                           .replace("}", r"\}")):
            mesh.mesh_sizes(axes, n)
        return
    want = dict(jax_mesh.shape)
    got = mesh.mesh_sizes(axes, n)
    assert got == want
    used = int(np.prod(list(got.values())))
    assert sorted(d.id for d in jax_mesh.devices.flat) == \
        [d.id for d in devices[:used]]


@pytest.mark.parametrize("spec,sharding,error", [
    ("data:2,model:2", "replicated", None),
    ("data,model:-1", "replicated", None),
    ("data", "sp", None), ("data", "zero", ValueError)])
def test_the_rest_of_m6_raises(spec, sharding, error):
    """What the rest of M6 raised before it was ported now passes
    check_axes, and the mesh's sizes are JAX create_mesh's on 8 devices
    under the same rules; an unknown --param_sharding still raises."""
    import jax

    from vision_transformers_torch_xla_tpu.parallel import mesh as jax_mesh

    cfg = TrainConfig(mesh_shape=spec, param_sharding=sharding)
    if error is not None:
        with pytest.raises(error, match="param_sharding"):
            mesh.check_axes(cfg.parse_mesh_shape(), cfg.param_sharding)
        return
    mesh.check_axes(cfg.parse_mesh_shape(), cfg.param_sharding)
    axes = cfg.parse_mesh_shape()
    try:
        want = jax_mesh.create_mesh(axes, devices=jax.devices("cpu")[:8])
    except ValueError as e:   # two inferred sizes: JAX's error
        with pytest.raises(ValueError, match=str(e)):
            mesh.mesh_sizes(axes, 8)
        return
    assert mesh.mesh_sizes(axes, 8) == dict(want.shape)

    class Named:   # the port's DeviceMesh names its axes as JAX's mesh
        mesh_dim_names = tuple(want.axis_names)

    assert mesh.axis_rules(sharding, Named()) == \
        jax_mesh.axis_rules(sharding, want)
    mesh.check_axes(TrainConfig(mesh_shape="data,model:1",
                                param_sharding="fsdp").parse_mesh_shape(),
                    "fsdp")


def test_convnext_refuses_the_model_axis():
    """Tensor parallelism and sp over `model` on a ConvNeXt raise naming
    ROADMAP M6b (JAX runs both under GSPMD)."""
    from vision_transformers_torch_xla_tpu_torch.models import create_model
    from vision_transformers_torch_xla_tpu_torch.parallel.split import (
        ModelAxis,
    )

    model = create_model("test_convnext", device="meta")
    axis = ModelAxis(None, 0, 2)
    with pytest.raises(NotImplementedError, match="M6b"):
        sharding.split_heads(model, axis)
    with pytest.raises(NotImplementedError, match="M6b"):
        sharding.split_tokens(model, axis)
    units = sharding.fsdp_units(model)
    assert len(units) == 9 and units[0] is model.stages[0].blocks[0]


class _StopAfterChecks(Exception):
    pass


@pytest.mark.parametrize("batch,mult,procs,data", [
    (4, 1.5, 2, 2), (3, 1.0, 2, 4), (4, 1.5, 1, 4), (8, 1.5, 4, 4),
    (4, 1.0, 1, 1)])
def test_batch_checks_match_jax(monkeypatch, batch, mult, procs, data):
    import jax

    from vision_transformers_torch_xla_tpu.core.config import (
        TrainConfig as JaxTrainConfig,
    )
    from vision_transformers_torch_xla_tpu.launch import main as jax_main

    class Mesh:
        shape = {"data": data}

    def stop(*a, **k):
        raise _StopAfterChecks

    monkeypatch.setattr(jax_main, "create_mesh", lambda *a, **k: Mesh())
    monkeypatch.setattr(jax_main, "build_dataset", stop)
    monkeypatch.setattr(jax, "process_count", lambda: procs)
    kw = dict(batch_size=batch, eval_batch_mult=mult, device="cpu")
    try:
        jax_main.setup(JaxTrainConfig(**kw))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            trainer.check_batches(TrainConfig(**kw), procs, data)
        assert str(got.value) == str(e)
    except _StopAfterChecks:
        trainer.check_batches(TrainConfig(**kw), procs, data)


def test_axis_rules_match_jax():
    from vision_transformers_torch_xla_tpu.parallel import mesh as jax_mesh

    for name in ("replicated", "fsdp", "sp"):
        assert mesh.axis_rules(name) == jax_mesh.axis_rules(name)

    class DataMesh:   # a DeviceMesh of the data axis alone
        mesh_dim_names = ("data",)
        axis_names = ("data",)

    assert dict(mesh.axis_rules("fsdp", DataMesh()))["embed"] == "data"
    assert dict(mesh.axis_rules("replicated", DataMesh()))["heads"] is None
    assert mesh.axis_rules("fsdp", DataMesh()) == \
        jax_mesh.axis_rules("fsdp", DataMesh())


@pytest.mark.parametrize("native_path", [True, False])
@pytest.mark.parametrize("index", [0, 1, 2])
def test_synthetic_streams_match_jax_per_process(monkeypatch, native_path,
                                                 index):
    import jax

    from vision_transformers_torch_xla_tpu.data import loader as jax_loader
    from vision_transformers_torch_xla_tpu.data import native as jax_native

    if native_path and not native.available():
        pytest.fail("native/libvtx_io.so does not load")
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    if not native_path:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    kw = dict(batch_size=3, image_size=16, num_classes=10, seed=5)
    got = loader.SyntheticDataset(**kw, process_index=index)
    want = jax_loader.SyntheticDataset(**kw)
    for (gx, gy), (wx, wy), _ in zip(got, want, range(2)):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    other = loader.SyntheticDataset(**kw, process_index=index + 1)
    assert not np.array_equal(next(iter(other))[0], next(iter(got))[0])


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("is_train", [True, False])
def test_folder_streams_match_jax_per_process(monkeypatch, tmp_path, index,
                                              is_train):
    import jax
    from PIL import Image

    from vision_transformers_torch_xla_tpu.data.loader import (
        FolderDataset as JaxFolderDataset,
    )

    rng = np.random.default_rng(0)
    for cls in ("a", "b"):
        (tmp_path / cls).mkdir()
        for i in range(5):
            arr = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(tmp_path / cls / f"{i}.png")
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    kw = dict(batch_size=2, image_size=16, is_train=is_train, seed=1)
    got = loader.FolderDataset(str(tmp_path), **kw, process_index=index,
                               process_count=2)
    want = JaxFolderDataset(str(tmp_path), **kw)
    assert got.info.num_examples == want.info.num_examples == 10
    assert [s for s, _ in got.samples] == [s for s, _ in want.samples]
    pairs = list(zip(got, want))
    assert len(pairs) == 2
    for (gx, gy), (wx, wy) in pairs:
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_unreached_parameters_come_from_the_model():
    class TwoHeads(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.used = torch.nn.Linear(3, 2)
            self.spare = torch.nn.Linear(3, 2)

        def forward(self, x, deterministic=True):
            return self.used(x.mean(dim=(1, 2)))

    with torch.device("meta"):
        model = TwoHeads()
    assert sharding.unreached_parameters(model, (2, 4, 4, 3)) == [
        "spare.weight", "spare.bias"]


# ---- one 2-rank gloo group against the references -------------------------

def _jax_draw(rng, h, w, cfg):
    """The draws of JAX mixup_cutmix (mixup.py:66-78) by its own calls."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.train.mixup import _rand_bbox

    k_gate, k_switch, k_lam, k_box = jax.random.split(rng, 4)
    apply = bool(jax.random.bernoulli(k_gate, cfg.prob))
    cut = bool(jax.random.bernoulli(k_switch, cfg.switch_prob))
    lam_mix = jax.random.beta(k_lam, cfg.mixup_alpha, cfg.mixup_alpha)
    lam_cut = jax.random.beta(k_lam, cfg.cutmix_alpha, cfg.cutmix_alpha)
    box = [int(v) for v in _rand_bbox(k_box, h, w, lam_cut)]
    lam = float(jnp.asarray(lam_cut if cut else lam_mix, jnp.float32))
    return {"apply": apply, "cutmix": cut, "lam": lam, "box": box}


def _jax_run(workdir):
    """JAX's steps on the global batches (test_vit, fp32, drop_path 0,
    AdamW + EMA as the JAX trainer builds them). Writes the converted
    initial weights and the mixup draws for the ranks, then returns a
    function that runs the steps and returns the metrics and the final
    params and EMA by timm name."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from vision_transformers_torch_xla_tpu.models import (
        create_model as jax_create_model,
    )
    from vision_transformers_torch_xla_tpu.train import optim as jo
    from vision_transformers_torch_xla_tpu.train import steps as jsteps
    from vision_transformers_torch_xla_tpu.train.mixup import (
        MixupConfig as JaxMixupConfig,
    )
    from vision_transformers_torch_xla_tpu.train.schedules import (
        cosine_schedule_fn as jax_schedule,
    )
    from vision_transformers_torch_xla_tpu.train.state import (
        create_train_state as jax_train_state,
    )
    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        flax_to_state_dict,
    )

    cfg = worker.config(**worker.JAX_RUN)
    model = jax_create_model(
        cfg.model, num_classes=cfg.nb_classes, img_size=cfg.input_size,
        drop_path_rate=cfg.drop_path, global_pool=cfg.global_pool,
        act_layer=cfg.act_layer or None,
        init_values=cfg.layer_scale_init_value or None, dtype=jnp.float32,
        param_dtype=jnp.float32)
    sample = jnp.zeros((2, cfg.input_size, cfg.input_size, 3), jnp.float32)
    params = jax.tree.map(np.asarray, nn.meta.unbox(jax.jit(
        lambda k: model.init(k, sample, True))(jax.random.key(0)))["params"])
    torch.save(flax_to_state_dict(params), os.path.join(workdir, "jax.pth"))
    steps_per_epoch = cfg.synthetic_train_size // (cfg.batch_size *
                                                   worker.WORLD)
    sched = jax_schedule(cfg.lr, cfg.min_lr, cfg.epochs, steps_per_epoch,
                         warmup_epochs=cfg.warmup_epochs,
                         start_warmup_value=cfg.warmup_lr,
                         warmup_steps=cfg.warmup_steps)
    tx = jo.maybe_fused_optimizer(
        "adamw", sched, params, weight_decay=cfg.weight_decay,
        opt_eps=cfg.opt_eps, opt_betas=cfg.opt_betas,
        ema_decay=cfg.model_ema_decay)
    mix = JaxMixupConfig(mixup_alpha=cfg.mixup, cutmix_alpha=cfg.cutmix,
                         num_classes=cfg.nb_classes,
                         label_smoothing=cfg.smoothing)
    step = jax.jit(jsteps.make_train_step(model.apply, tx, jsteps.StepConfig(
        mixup=mix, num_classes=cfg.nb_classes, ema_decay=cfg.model_ema_decay,
        lr_schedule=sched)))
    rng = jax.random.key(worker.SEED)
    draws = [_jax_draw(jax.random.split(jax.random.fold_in(rng, s), 5)[0],
                       cfg.input_size, cfg.input_size, mix)
             for s in range(worker.STEPS)]
    with open(os.path.join(workdir, "jax_draws.json"), "w") as f:
        json.dump(draws, f)

    def run():
        state = jax_train_state(params, tx, with_ema=True)
        metrics = []
        for s in range(worker.STEPS):
            images, labels = worker.global_batch(s, raw=False)
            state, m = step(state, jnp.asarray(images),
                            jnp.asarray(labels.astype(np.int32)), rng)
            metrics.append({k: float(v) for k, v in m.items()})
        return {"metrics": metrics, "draws": draws,
                "params": flax_to_state_dict(state.params),
                "ema": flax_to_state_dict(state.ema_params)}

    return run


def _one_process(name, workdir):
    """The one-process port on the global batches (its batch size the
    global one), and the eval of the ranks' eval batches put end to end."""
    cfg = worker.config(**worker.RUNS[name],
                        batch_size=worker.WORLD * worker.B)
    ctx = trainer.setup(cfg)
    losses, norms, seen = worker.run_steps(ctx, slice(None))
    rank_cfg = worker.config(**worker.RUNS[name])
    streams = [iter(loader.build_dataset(rank_cfg, False, r,
                                         worker.WORLD)[0])
               for r in range(worker.WORLD)]
    per_rank = [[next(s) for _ in range(worker.EVAL_BATCHES)]
                for s in streams]
    batches = [[np.concatenate(parts) for parts in zip(*(b[i] for b in
                                                         per_rank))]
               for i in range(worker.EVAL_BATCHES)]
    stats = {}
    for prefix, params in (("", ctx.state.params),
                           ("ema_", ctx.state.ema_params)):
        totals = dict.fromkeys(("top1", "top5", "count", "loss_sum"), 0.0)
        for images, labels in batches:
            m = ctx.eval_step(params, torch.from_numpy(images),
                              torch.from_numpy(labels))
            for k in totals:
                totals[k] += float(m[k])
        n = totals["count"]
        stats.update({f"{prefix}acc1": 100.0 * totals["top1"] / n,
                      f"{prefix}acc5": 100.0 * totals["top5"] / n,
                      f"{prefix}loss": totals["loss_sum"] / n,
                      f"{prefix}count": n})
    if name == "fsdp":
        CheckpointManager(os.path.join(workdir, "one_ckpt")).save(
            0, ctx.state, metadata={"epoch": 0})
    return {"losses": losses, "grad_norms": norms, "seen": seen,
            "eval": stats, "state": worker.gathered(ctx.state)}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("group"))
    # what the ranks read (JAX's weights and draws, the one-process
    # checkpoint) first; the rest of the references while they run
    jax_steps = _jax_run(workdir)
    ref = {"fsdp": _one_process("fsdp", workdir)}
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    script = os.path.join(os.path.dirname(__file__),
                          "torch_parallel_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(worker.WORLD), str(port),
         workdir], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(worker.WORLD)]
    logs = []
    try:
        for name in worker.RUNS:
            if name not in ref:
                ref[name] = _one_process(name, workdir)
        ref["jax"] = jax_steps()
        for p in procs:
            out, err = p.communicate(timeout=GROUP_TIMEOUT_S)
            logs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = []
    for r in range(worker.WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            info = json.load(f)
        ranks.append((dict(np.load(os.path.join(workdir, f"rank{r}.npz"))),
                      info))
    return {"ref": ref, "ranks": ranks, "workdir": workdir}


@pytest.mark.parametrize("name", list(worker.RUNS))
def test_the_draws_are_the_global_batchs_bit_for_bit(group, name):
    seen = group["ref"][name]["seen"]
    b = worker.B
    for r, (arrays, _) in enumerate(group["ranks"]):
        rows = slice(r * b, (r + 1) * b)
        for kind in ("inputs", "masks"):
            n = len(seen[kind])
            assert n == len([k for k in arrays
                             if k.startswith(f"{name}/{kind}/")]), kind
            for i in range(n):
                np.testing.assert_array_equal(
                    arrays[f"{name}/{kind}/{i}"], seen[kind][i][rows].numpy(),
                    err_msg=f"rank {r} {kind} {i}")
    masks = torch.cat([m.flatten() for m in seen["masks"]])
    assert 0 < masks.sum() < masks.numel()     # drop_path 0.1 dropped some


NEAR_ZERO = 1e-2


def _assert_adam_close(got, want, grads, atol, lr, what):
    """Every entry within `atol`, but where AdamW divides a gradient by its
    own magnitude: an entry whose gradient at some step is below NEAR_ZERO
    of its tensor's largest carries that gradient's rounding, magnified,
    into its update (up to lr a step), and is held to 2·lr a step. The key
    third of each qkv bias, whose gradient is zero in exact arithmetic, is
    such an entry."""
    diff = np.abs(got - want)
    far = diff > atol
    if far.any():
        near_zero = np.zeros_like(far)
        for g in grads:
            near_zero |= np.abs(g) < NEAR_ZERO * np.abs(g).max()
        assert not (far & ~near_zero).any(), (
            what, float(diff[far & ~near_zero].max()))
    assert diff.max() <= 2 * lr * worker.STEPS, (what, float(diff.max()))


@pytest.mark.parametrize("name", list(worker.RUNS))
def test_two_steps_equal_one_process_on_the_global_batch(group, name):
    ref = group["ref"][name]
    for arrays, info in group["ranks"]:
        got = info[name]
        assert got["sharded"] == name.endswith("fsdp")
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"],
                                   rtol=1e-5)
        grads = [{k: g.numpy() for k, g in step.items()}
                 for step in ref["seen"]["grads"]]
        # the first step's gradients, from the same params: up to the
        # reduction order
        for k, want in grads[0].items():
            got = arrays[f"{name}/grads/0/{k}"]
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k
        for key, want in ref["state"].items():
            k = key.split("/", 1)[1]
            _assert_adam_close(arrays[f"{name}/{key}"], want,
                               [step[k] for step in grads], 1e-5,
                               worker.BASE["lr"], key)


@pytest.mark.parametrize("name", list(worker.RUNS))
def test_eval_totals_equal_one_process(group, name):
    want = group["ref"][name]["eval"]
    for _, info in group["ranks"]:
        got = info[name]["eval"]
        assert set(got) == set(want)
        for k in want:
            if k.endswith("loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
            else:
                assert got[k] == want[k], k
    assert want["count"] == worker.EVAL_BATCHES * worker.WORLD * int(
        worker.B * 1.5)


def test_ddp_matches_jax_on_the_global_batch(group):
    """test_torch_train.py's tolerances: losses and grad norms to 1e-5
    relative; params and EMA to 1e-4, and to 1e-6 but for the entries whose
    gradient is near zero (`_assert_adam_close`; that file counts them)."""
    want = group["ref"]["jax"]
    assert any(d["apply"] for d in want["draws"])
    for arrays, info in group["ranks"]:
        got = info["jax"]
        for s, m in enumerate(want["metrics"]):
            np.testing.assert_allclose(got["losses"][s], m["loss"],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["grad_norms"][s], m["grad_norm"],
                                       rtol=1e-5)
        for which in ("params", "ema"):
            for k, w in want[which].items():
                diff = arrays[f"jax/{which}/{k}"] - w.numpy()
                assert np.abs(diff).max() <= 1e-4, (which, k)
                _assert_adam_close(
                    arrays[f"jax/{which}/{k}"], w.numpy(),
                    [arrays[f"jax/grads/{s}/{k}"]
                     for s in range(worker.STEPS)], 1e-6, worker.BASE["lr"],
                    f"{which}/{k}")


def test_an_fsdp_checkpoint_restores_in_one_process(group):
    arrays = group["ranks"][0][0]
    cfg = worker.config(**worker.RUNS["fsdp"], resume=os.path.join(
        group["workdir"], "fsdp_ckpt"))
    ctx = trainer.setup(cfg)
    assert ctx.state.step == worker.STEPS
    assert ctx.state.opt_state["count"] == worker.STEPS
    for k, v in worker.gathered(ctx.state).items():
        np.testing.assert_array_equal(v, arrays[f"fsdp/{k}"], err_msg=k)


def test_a_one_process_checkpoint_restores_into_fsdp_shards(group):
    for _, info in group["ranks"]:
        got = info["restored"]
        assert got["sharded"] and got["worst"] == 0.0
        assert got["step"] == got["count"] == worker.STEPS


def test_main_on_two_ranks_prints_once_and_logs_once(group):
    (_, first), (_, second) = group["ranks"]
    assert "epoch 0 [1/2] loss" in first["main_stdout"]
    assert "devices: 2 (2 processes, FSDP2)" in first["main_stdout"]
    assert second["main_stdout"] == ""
    assert first["main"] == second["main"]
    assert first["main"]["count"] == worker.EVAL_BATCHES * worker.WORLD * \
        int(worker.B * 1.5)
    with open(os.path.join(group["workdir"], "main", "log.txt")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["epoch"] == 0
    assert CheckpointManager(os.path.join(group["workdir"], "main",
                                          "checkpoints")).all_epochs() == [0]
