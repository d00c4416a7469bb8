"""The port's model axis (tensor parallelism over the heads and the MLP's
hidden columns, --param_sharding sp over the tokens) and a mesh smaller
than the world, against the one-process port and the JAX package, on the
CPU.

A step on the mesh must be the one-process step on the global batch, as
the JAX step is one function of the global array whatever the mesh. The
test starts three gloo groups at once (tests/torch_tp_worker.py; free
ports, one thread a rank, hard timeouts; the ranks import only the port):
`a` data:1,model:2 on 2 ranks (tp, sp), `b` data:2,model:2 on 4 (tp with
DDP and with FSDP2 on the data axis), `c` data:2 on 3 ranks (the third
sits out). It holds what they return against references it computes
itself:

  * each run after 2 steps of test_vit (fp32, mixup and cutmix, drop_path
    0.1, --device_augment with erasing, EMA; tp and sp with
    --grad_checkpointing) against the one-process port on the global
    batch: the model's inputs and every drop-path mask bit for bit, the
    global losses to 1e-6 relative and the grad norms to 1e-5, the first
    step's gradients to 1e-5 of their largest, params and EMA to 1e-5
    absolute but where AdamW magnifies a near-zero gradient's rounding
    (test_torch_parallel.py::_assert_adam_close; the split layers sum
    their partial products in another order than one matmul does); the
    eval totals, plain and EMA, against the one-process eval of the data
    indices' eval batches put end to end, and the train loop's meters
    counting each data index once;
  * the same global batch, fed JAX's mixup draws with drop_path 0, through
    JAX's step on a CPU mesh of the same shape under the same rules
    (conftest.py's 8 devices, as tests/test_sharded_train.py and
    tests/test_sp.py build it), from the converted JAX weights, with
    test_torch_parallel.py's tolerances (losses and grad norms 1e-5
    relative, params and EMA 1e-4);
  * checkpoints from the split runs into one process (timm's whole
    tensors, which load with strict=True), and from one process into the
    split parts;
  * the kernel routes split (qkv_proj and the fused MLP on each rank's
    heads and columns; qkv_proj and qkv_cols on the gathered tokens under
    sp), their plain versions on the CPU, against the unsplit model;
  * a mesh of 2 on 3 ranks: ranks 0 and 1 train as a 2-rank run does,
    rank 2 sits out and exits 0, and main() saves and logs with the third
    rank gone.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_tp_worker as worker
from test_torch_parallel import _assert_adam_close, _free_port, _jax_draw
from vision_transformers_torch_xla_tpu_torch.ckpt.checkpoint import (
    CheckpointManager,
)
from vision_transformers_torch_xla_tpu_torch.data import loader
from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
from vision_transformers_torch_xla_tpu_torch.models import create_model

GROUP_TIMEOUT_S = 240
# the run, its group, its one-process reference (by global batch)
SPLIT_RUNS = {"tp": "a", "sp": "a", "tp_dp": "b", "tp_fsdp": "b",
              "subset": "c"}
JAX_MESH = {"jax_tp": ("a", "replicated"), "jax_sp": ("a", "sp"),
            "jax_tp_dp": ("b", "replicated"), "jax_tp_fsdp": ("b", "fsdp")}


def _jax_setup(workdir):
    """The JAX model and its initial params (test_vit, fp32, drop_path 0);
    writes the converted weights and the mixup draws for the ranks."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from vision_transformers_torch_xla_tpu.models import (
        create_model as jax_create_model,
    )
    from vision_transformers_torch_xla_tpu.train.mixup import (
        MixupConfig as JaxMixupConfig,
    )
    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        flax_to_state_dict,
    )

    cfg = worker.config("a", **worker.JAX_RUN)
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
    mix = JaxMixupConfig(mixup_alpha=cfg.mixup, cutmix_alpha=cfg.cutmix,
                         num_classes=cfg.nb_classes,
                         label_smoothing=cfg.smoothing)
    rng = jax.random.key(worker.SEED)
    draws = [_jax_draw(jax.random.split(jax.random.fold_in(rng, s), 5)[0],
                       cfg.input_size, cfg.input_size, mix)
             for s in range(worker.STEPS)]
    with open(os.path.join(workdir, "jax_draws.json"), "w") as f:
        json.dump(draws, f)
    return {"model": model, "params": params, "cfg": cfg, "mix": mix,
            "sample": sample, "rng": rng, "draws": draws}


def _jax_on_mesh(ref, group, param_sharding):
    """JAX's steps on the group's global batches over a CPU mesh of the
    group's shape, params placed by the rules of `param_sharding` and the
    batch over 'data', as the JAX trainer places them
    (launch/main.py:170-235)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vision_transformers_torch_xla_tpu.parallel import sharding as shd
    from vision_transformers_torch_xla_tpu.parallel.mesh import (
        axis_rules as jax_axis_rules,
        create_mesh as jax_create_mesh,
    )
    from vision_transformers_torch_xla_tpu.train import optim as jo
    from vision_transformers_torch_xla_tpu.train import steps as jsteps
    from vision_transformers_torch_xla_tpu.train.schedules import (
        cosine_schedule_fn as jax_schedule,
    )
    from vision_transformers_torch_xla_tpu.train.state import (
        create_train_state as jax_train_state,
    )
    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        flax_to_state_dict,
    )

    axes = [(a.split(":")[0], int(a.split(":")[1]))
            for a in worker.GROUPS[group]["mesh"].split(",")]
    n_dev = int(np.prod([s for _, s in axes]))
    mesh = jax_create_mesh(axes, devices=jax.devices("cpu")[:n_dev])
    rules = jax_axis_rules(param_sharding, mesh)
    model, cfg = ref["model"], ref["cfg"]
    abstract = jax.eval_shape(lambda k: model.init(k, ref["sample"], True),
                              {"params": jax.random.key(0)})
    shardings = shd.params_sharding(mesh, abstract, rules)["params"]
    params = jax.device_put(ref["params"], shardings)
    n = worker.processes(group) * worker.B
    sched = jax_schedule(cfg.lr, cfg.min_lr, cfg.epochs,
                         cfg.synthetic_train_size // n,
                         warmup_epochs=cfg.warmup_epochs,
                         start_warmup_value=cfg.warmup_lr,
                         warmup_steps=cfg.warmup_steps)
    tx = jo.maybe_fused_optimizer(
        "adamw", sched, params, weight_decay=cfg.weight_decay,
        opt_eps=cfg.opt_eps, opt_betas=cfg.opt_betas,
        ema_decay=cfg.model_ema_decay)
    step = jax.jit(jsteps.make_train_step(model.apply, tx, jsteps.StepConfig(
        mixup=ref["mix"], num_classes=cfg.nb_classes,
        ema_decay=cfg.model_ema_decay, lr_schedule=sched)))
    state = jax_train_state(params, tx, with_ema=True)
    batch = NamedSharding(mesh, P("data"))
    metrics = []
    with nn.logical_axis_rules(rules):
        for s in range(worker.STEPS):
            images, labels = worker.global_batch(s, n, raw=False)
            state, m = step(state, jax.device_put(jnp.asarray(images), batch),
                            jax.device_put(jnp.asarray(
                                labels.astype(np.int32)), batch),
                            ref["rng"])
            metrics.append({k: float(v) for k, v in m.items()})
    qkv = state.params["blocks_0"]["attn"]["qkv"]["kernel"]
    return {"metrics": metrics, "qkv_spec": str(qkv.sharding.spec),
            "params": flax_to_state_dict(jax.device_get(state.params)),
            "ema": flax_to_state_dict(jax.device_get(state.ema_params))}


def _one_process(group, workdir=None):
    """The one-process port on the group's global batches (its batch size
    the global one), the eval of the data indices' eval batches put end
    to end, and, with `workdir`, the one-process checkpoint."""
    n = worker.processes(group) * worker.B
    run = {"a": "tp", "b": "tp_dp", "c": "subset"}[group]
    cfg = worker.config(group, **worker.RUNS[run], mesh_shape="data",
                        batch_size=n)
    ctx = trainer.setup(cfg)
    losses, norms, seen = worker.run_steps(ctx, slice(None), n)
    d = worker.data_size(group)
    eval_rows = int(worker.B * worker.EVAL_MULT) * worker.processes(group) \
        // d
    streams = [iter(loader.build_dataset(cfg, False, r, d, eval_rows)[0])
               for r in range(d)]
    per_index = [[next(s) for _ in range(worker.EVAL_BATCHES)]
                 for s in streams]
    batches = [[np.concatenate(parts) for parts in zip(*(b[i] for b in
                                                         per_index))]
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
        c = totals["count"]
        stats.update({f"{prefix}acc1": 100.0 * totals["top1"] / c,
                      f"{prefix}acc5": 100.0 * totals["top5"] / c,
                      f"{prefix}loss": totals["loss_sum"] / c,
                      f"{prefix}count": c})
    if workdir is not None:
        CheckpointManager(os.path.join(workdir, "one_ckpt")).save(
            0, ctx.state, metadata={"epoch": 0})
    return {"losses": losses, "grad_norms": norms, "seen": seen,
            "eval": stats, "state": worker.gathered(ctx.state), "n": n,
            "data": d}


def _start(group, workdir):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    script = os.path.join(os.path.dirname(__file__), "torch_tp_worker.py")
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, script, group, str(r), str(port), workdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(worker.GROUPS[group]["world"])]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp"))
    t0 = time.perf_counter()
    # what the ranks read first (JAX's weights and draws, the one-process
    # checkpoint); the rest of the references while they run
    jax_ref = _jax_setup(workdir)
    ref = {"a": _one_process("a", workdir)}
    procs = {g: _start(g, workdir) for g in worker.GROUPS}
    logs, codes = {}, {}
    try:
        ref["b"] = _one_process("b")
        ref["c"] = _one_process("c")
        for name, (group, sharding) in JAX_MESH.items():
            ref[name] = _jax_on_mesh(jax_ref, group, sharding)
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        for g, ps in procs.items():
            for r, p in enumerate(ps):
                out, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
                logs[(g, r)] = err[-3000:]
                codes[(g, r)] = p.returncode
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    assert all(c == 0 for c in codes.values()), (codes, logs)
    ranks = {}
    for g, ps in procs.items():
        for r in range(len(ps)):
            with open(os.path.join(workdir, f"{g}_rank{r}.json")) as f:
                info = json.load(f)
            ranks[(g, r)] = (dict(np.load(os.path.join(
                workdir, f"{g}_rank{r}.npz"))), info)
    return {"ref": ref, "ranks": ranks, "workdir": workdir,
            "seconds": time.perf_counter() - t0}


def _ranks_of(groups, name):
    """The (arrays, info) of every rank that ran `name`."""
    g = SPLIT_RUNS.get(name) or JAX_MESH[name][0]
    return [v for (grp, _), v in sorted(groups["ranks"].items())
            if grp == g and name in v[1]]


@pytest.mark.parametrize("name", list(SPLIT_RUNS))
def test_split_draws_are_the_global_batchs_bit_for_bit(groups, name):
    ref = groups["ref"][SPLIT_RUNS[name]]
    seen = ref["seen"]
    per = ref["n"] // ref["data"]
    ranks = _ranks_of(groups, name)
    assert len(ranks) == worker.processes(SPLIT_RUNS[name])
    for arrays, info in ranks:
        d = info[name]["data_index"]
        rows = slice(d * per, (d + 1) * per)
        for kind in ("inputs", "masks"):
            n = len(seen[kind])
            assert n == len([k for k in arrays
                             if k.startswith(f"{name}/{kind}/")]), kind
            for i in range(n):
                np.testing.assert_array_equal(
                    arrays[f"{name}/{kind}/{i}"], seen[kind][i][rows].numpy(),
                    err_msg=f"data index {d} {kind} {i}")
    masks = torch.cat([m.flatten() for m in seen["masks"]])
    assert 0 < masks.sum() < masks.numel()     # drop_path 0.1 dropped some


@pytest.mark.parametrize("name", list(SPLIT_RUNS))
def test_split_steps_equal_one_process_on_the_global_batch(groups, name):
    ref = groups["ref"][SPLIT_RUNS[name]]
    grads = [{k: g.numpy() for k, g in step.items()}
             for step in ref["seen"]["grads"]]
    for arrays, info in _ranks_of(groups, name):
        got = info[name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"],
                                   rtol=1e-5)
        # the first step's gradients, from the same params: up to the
        # order of the sums; under sp with no factor of M
        for k, want in grads[0].items():
            g = arrays[f"{name}/grads/0/{k}"]
            assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max(), k
        for key, want in ref["state"].items():
            k = key.split("/", 1)[1]
            _assert_adam_close(arrays[f"{name}/{key}"], want,
                               [step[k] for step in grads], 1e-5,
                               worker.BASE["lr"], key)


# the parameters each rank holds a part of under the model axis: q, k and
# v of its heads (qkv), proj's and fc2's columns, fc1's rows
SPLIT_NAMES = [f"blocks.{i}.{m}" for i in range(6) for m in (
    "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
    "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight")]


@pytest.mark.parametrize("name", ["tp", "sp", "tp_dp", "tp_fsdp", "subset"])
def test_each_rank_holds_its_heads_and_columns(groups, name):
    want = sorted(SPLIT_NAMES) if name.startswith("tp") else []
    for _, info in _ranks_of(groups, name):
        assert info[name]["split"] == want
        assert info[name]["sharded"] == (name == "tp_fsdp")


def test_qkv_parts_are_each_ranks_heads():
    """A rank's qkv rows are q, k and v of its own H/M heads, and joining
    the parts gives timm's order back (Split.rows and join without a
    group: the parts put end to end as join does)."""
    from vision_transformers_torch_xla_tpu_torch.parallel.split import (
        ModelAxis,
        Split,
    )

    h, hd, c, m = 4, 3, 5, 2
    whole = torch.arange(3 * h * hd * c, dtype=torch.float32).reshape(
        3 * h * hd, c)
    parts = [Split(0, 3, ModelAxis(None, i, m)).rows(whole)
             for i in range(m)]
    for i, part in enumerate(parts):
        q, k, v = whole.reshape(3, h, hd, c)[:, i * h // m:(i + 1) * h // m]\
            .reshape(3, -1, c)
        assert torch.equal(part, torch.cat([q, k, v]))
    pieces = [p.chunk(3, 0) for p in parts]
    assert torch.equal(torch.cat([pieces[r][j] for j in range(3)
                                  for r in range(m)]), whole)


@pytest.mark.parametrize("name", list(JAX_MESH))
def test_split_steps_match_jax_on_the_same_mesh(groups, name):
    """test_torch_parallel.py's tolerances against JAX's step on a CPU mesh
    of the run's shape: losses and grad norms to 1e-5 relative; params
    and EMA to 1e-4, and to 1e-6 but for the entries whose gradient is
    near zero (`_assert_adam_close`)."""
    want = groups["ref"][name]
    assert any(d["apply"] for d in json.load(open(os.path.join(
        groups["workdir"], "jax_draws.json"))))
    if name != "jax_sp":    # JAX's TP rules put qkv's columns on 'model'
        assert "model" in want["qkv_spec"], want["qkv_spec"]
    ranks = _ranks_of(groups, name)
    assert ranks
    for arrays, info in ranks:
        got = info[name]
        for s, m in enumerate(want["metrics"]):
            np.testing.assert_allclose(got["losses"][s], m["loss"],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["grad_norms"][s], m["grad_norm"],
                                       rtol=1e-5)
        for which in ("params", "ema"):
            for k, w in want[which].items():
                diff = arrays[f"{name}/{which}/{k}"] - w.numpy()
                assert np.abs(diff).max() <= 1e-4, (which, k)
                _assert_adam_close(
                    arrays[f"{name}/{which}/{k}"], w.numpy(),
                    [arrays[f"{name}/grads/{s}/{k}"]
                     for s in range(worker.STEPS)], 1e-6, worker.BASE["lr"],
                    f"{which}/{k}")


@pytest.mark.parametrize("name", list(SPLIT_RUNS))
def test_split_eval_totals_count_each_sample_once(groups, name):
    want = groups["ref"][SPLIT_RUNS[name]]["eval"]
    for _, info in _ranks_of(groups, name):
        got = info[name]["eval"]
        assert set(got) == set(want)
        for k in want:
            if k.endswith("loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
            else:
                assert got[k] == want[k], k
    g = SPLIT_RUNS[name]
    assert want["count"] == worker.EVAL_BATCHES * worker.processes(g) * \
        int(worker.B * worker.EVAL_MULT)


def test_meters_count_each_data_index_once(groups):
    """The train loop's meters, synchronized over the data axis: each of
    the D data indices' logged steps once, not once for each model peer."""
    for _, info in _ranks_of(groups, "tp_dp"):
        counts = info["tp_dp"]["meters"]["counts"]
        assert counts and set(counts.values()) == {
            worker.STEPS * worker.data_size("b")}, counts


@pytest.mark.parametrize("name", ["tp", "tp_fsdp"])
def test_a_split_checkpoint_restores_in_one_process(groups, name):
    path = os.path.join(groups["workdir"], f"{name}_ckpt")
    arrays = _ranks_of(groups, name)[0][0]
    cfg = worker.config(SPLIT_RUNS[name], **worker.RUNS[name],
                        mesh_shape="data", resume=path)
    ctx = trainer.setup(cfg)
    assert ctx.state.step == worker.STEPS
    assert ctx.state.opt_state["count"] == worker.STEPS
    for k, v in worker.gathered(ctx.state).items():
        np.testing.assert_array_equal(v, arrays[f"{name}/{k}"], err_msg=k)
    # timm's whole tensors: they load into the one-process model strictly
    saved = CheckpointManager(path).restore_raw()
    model = create_model(cfg.model, num_classes=cfg.nb_classes,
                         img_size=cfg.input_size,
                         global_pool=cfg.global_pool)
    model.load_state_dict(saved["params"], strict=True)


def test_a_one_process_checkpoint_restores_into_split_parts(groups):
    for _, info in _ranks_of(groups, "tp"):
        got = info["tp"]["restored"]
        assert got["split"] == sorted(SPLIT_NAMES) and got["worst"] == 0.0
        assert got["step"] == got["count"] == worker.STEPS


@pytest.mark.parametrize("case", ["heads", "tokens", "tokens_long"])
def test_kernel_routes_split_as_the_whole_model(groups, case):
    """The routes' plain versions on the CPU, split: qkv_proj (K1/K2) and
    the fused MLP (K3, mlp_gelu_columns) on each rank's heads and columns;
    under sp qkv_proj and, at 1,025 tokens, qkv_cols (K4-K6) on the
    gathered sequence. Logits and gradients to 1e-5 of their largest."""
    want_route = "qkv_cols" if case == "tokens_long" else "qkv_proj"
    for _, info in _ranks_of(groups, "tp"):
        got = info["kernel_routes"][case]
        assert got["route"] == want_route and got["fused_mlp"]
        assert got["logits"] <= 1e-5 and got["grads"] <= 1e-5, got


def test_a_mesh_smaller_than_the_world_leaves_the_last_rank_out(groups):
    (_, first), (_, second), (_, third) = [
        groups["ranks"][("c", r)] for r in range(3)]
    assert third == {"sat_out": True, "main": {}, "main_stdout": ""}
    assert "subset" in first and "subset" in second
    assert first["main"] == second["main"] and first["main"]["count"] == \
        worker.EVAL_BATCHES * 2 * int(worker.B * worker.EVAL_MULT)
    assert "devices: 2 (2 processes, DDP): cpu; mesh {'data': 2}" in \
        first["main_stdout"]
    assert second["main_stdout"] == ""
    with open(os.path.join(groups["workdir"], "main_c", "log.txt")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["epoch"] == 0
    assert CheckpointManager(os.path.join(groups["workdir"], "main_c",
                                          "checkpoints")).all_epochs() == [0]
