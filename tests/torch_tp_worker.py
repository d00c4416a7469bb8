"""One rank of the gloo groups that tests/test_torch_tp.py starts, and the
runs it shares with the test's one-process and JAX references.

    python tests/torch_tp_worker.py GROUP RANK PORT WORKDIR

GROUP names the mesh (`GROUPS`): `a` is data:1,model:2 on 2 ranks, `b`
data:2,model:2 on 4, `c` data:2 on 3 (a mesh smaller than the world).
Each rank joins a gloo group on 127.0.0.1:PORT (one thread, a two-minute
timeout), then runs through the port's trainer (launch/main.py::setup,
its train and eval steps, main()):

  * `tp`, `sp`, `tp_dp`, `tp_fsdp`, `subset`: test_vit at 32 px, fp32,
    mixup and cutmix, drop_path 0.1, --device_augment with erasing, EMA
    (`tp` and `sp` with --grad_checkpointing). STEPS steps on the rank's
    data index's rows of the test's global batches, then the eval of
    EVAL_BATCHES batches of the data index's stream, plain and EMA. It
    keeps the model's inputs and drop-path masks of every step, the
    global losses and grad norms, the whole first-step gradients and the
    whole params and EMA after the steps. `tp` and `tp_fsdp` then save a
    checkpoint; `tp` restores the one-process checkpoint the test wrote
    into its parts; `tp_dp` runs one more epoch's train loop and keeps
    its meters' counts.
  * `jax_tp`, `jax_sp`, `jax_tp_dp`, `jax_tp_fsdp`: test_vit (drop_path
    0, no augmentation) from the weights the test converted from its JAX
    model, fed JAX's mixup draws.
  * `kernel_routes` (group a): a ViT of head dim 64 and widths that are
    multiples of 128 on the kernel routes (qkv_proj, the fused MLP, and
    under sp qkv_cols at 1,025 tokens; the kernels' plain versions on the
    CPU), split, against the unsplit model in the same process.
  * `main` (group c): main() with --output_dir on all three ranks.

Results go to WORKDIR/<group>_rank<r>.npz (arrays) and .json. It imports
only the port, torch and numpy.
"""
from __future__ import annotations

import contextlib
import copy
import datetime
import io
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from vision_transformers_torch_xla_tpu_torch.core.config import (  # noqa: E402
    TrainConfig,
)
from vision_transformers_torch_xla_tpu_torch.models import (  # noqa: E402
    layers,
)
from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (  # noqa: E402,E501
    full,
    local,
    local_rows,
    unwrap,
)
from vision_transformers_torch_xla_tpu_torch.train.mixup import (  # noqa: E402
    MixupDraw,
)

B = 4                      # per process; the global batch is B x processes
STEPS = 2
SEED = 0
SIZE = 32
EVAL_BATCHES = 2
EVAL_MULT = 1.5

GROUPS = {
    "a": dict(world=2, mesh="data:1,model:2",
              runs=("tp", "sp", "jax_tp", "jax_sp", "kernel_routes")),
    "b": dict(world=4, mesh="data:2,model:2",
              runs=("tp_dp", "tp_fsdp", "jax_tp_dp", "jax_tp_fsdp")),
    "c": dict(world=3, mesh="data:2", runs=("subset", "main")),
}
BASE = dict(model="test_vit", input_size=SIZE, nb_classes=10,
            data_set="synthetic", batch_size=B, epochs=1, warmup_epochs=0,
            lr=1e-3, min_lr=1e-5, device="cpu", precision="fp32",
            mixup=0.8, cutmix=1.0, drop_path=0.1,
            device_augment=True, reprob=0.5, model_ema=True,
            model_ema_decay=0.9, synthetic_train_size=64,
            synthetic_val_size=48, log_freq=1, seed=SEED, save_ckpt=False,
            eval_batch_mult=EVAL_MULT)
RUNS = {"tp": dict(param_sharding="replicated", grad_checkpointing=True),
        "sp": dict(param_sharding="sp", grad_checkpointing=True),
        "tp_dp": dict(param_sharding="replicated"),
        "tp_fsdp": dict(param_sharding="fsdp"),
        "subset": dict(param_sharding="replicated")}
JAX_RUN = dict(drop_path=0.0, device_augment=False, reprob=0.0)
JAX_RUNS = {"jax_tp": "replicated", "jax_sp": "sp",
            "jax_tp_dp": "replicated", "jax_tp_fsdp": "fsdp"}


def processes(group: str) -> int:
    """The processes of the group's mesh (the world of a and b, the first
    two ranks of c)."""
    sizes = [int(a.split(":")[1]) for a in GROUPS[group]["mesh"].split(",")]
    return int(np.prod(sizes))


def data_size(group: str) -> int:
    return int(GROUPS[group]["mesh"].split(",")[0].split(":")[1])


def config(group: str, **kw) -> TrainConfig:
    return TrainConfig(**{**BASE, "mesh_shape": GROUPS[group]["mesh"],
                          **kw})


def global_batch(step: int, n: int, raw: bool = True):
    """The test's global batch of `step` (n rows): raw [0, 1] pixels for
    the on-device augmentation, else standard normal ones."""
    rng = np.random.default_rng(100 + step)
    images = rng.random((n, SIZE, SIZE, 3)) if raw else \
        rng.standard_normal((n, SIZE, SIZE, 3))
    return (images.astype(np.float32),
            rng.integers(0, 10, n).astype(np.int64))


@contextlib.contextmanager
def record_draws(ctx):
    """Keep the model's input of each train forward and every keep mask
    the model draws (models/layers.py::_keep_mask)."""
    seen = {"inputs": [], "masks": []}
    draw = layers._keep_mask

    def keep_mask(*args):
        mask = draw(*args)
        seen["masks"].append(mask.clone())
        return mask

    def pre_hook(module, args, kwargs):
        deterministic = args[1] if len(args) > 1 else \
            kwargs.get("deterministic", True)
        if not deterministic:
            seen["inputs"].append(args[0].detach().clone())

    handle = unwrap(ctx.model).register_forward_pre_hook(pre_hook,
                                                         with_kwargs=True)
    layers._keep_mask = keep_mask
    try:
        yield seen
    finally:
        layers._keep_mask = draw
        handle.remove()


def run_steps(ctx, rows: slice, n: int, raw: bool = True, draws=()):
    """STEPS train steps on `rows` of each global batch of n rows; returns
    the global losses and grad norms, and the draws and whole gradients
    seen."""
    from vision_transformers_torch_xla_tpu_torch.launch.main import (
        global_metrics,
    )

    losses, norms = [], []
    splits = ctx.state.splits
    with record_draws(ctx) as seen:
        for s in range(STEPS):
            images, labels = global_batch(s, n, raw)
            kw = {"mixup_draw": draws[s]} if draws else {}
            ctx.state, m = ctx.train_step(
                ctx.state, torch.from_numpy(images[rows]),
                torch.from_numpy(labels[rows]), SEED, **kw)
            m = global_metrics(ctx, m)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            seen.setdefault("grads", []).append(
                {k: full(p.grad, splits.get(k)).clone()
                 for k, p in ctx.state.params.items()})
    return losses, norms, seen


def gathered(state) -> dict:
    """{'params/<name>', 'ema/<name>': whole tensors as numpy}."""
    out = {}
    for which, tree in (("params", state.params), ("ema", state.ema_params)):
        for k, v in tree.items():
            out[f"{which}/{k}"] = full(v.detach(),
                                       state.splits.get(k)).numpy().copy()
    return out


def eval_totals(ctx) -> dict:
    from vision_transformers_torch_xla_tpu_torch.launch.main import evaluate

    stats = evaluate(ctx, max_batches=EVAL_BATCHES)
    stats.update(evaluate(ctx, use_ema=True, max_batches=EVAL_BATCHES))
    return stats


def jax_draws(workdir: str):
    with open(os.path.join(workdir, "jax_draws.json")) as f:
        return [MixupDraw(d["apply"], d["cutmix"], d["lam"], tuple(d["box"]))
                for d in json.load(f)]


def restored_fit(ctx, path: str) -> dict:
    """Each param, moment and EMA part of `ctx` against its rows of the
    checkpoint at `path`: the largest difference, and the step."""
    saved = torch.load(path, weights_only=True)
    st = ctx.state
    worst = 0.0
    for live, whole in ((st.params, saved["params"]),
                        (st.ema_params, saved["ema_params"]),
                        (st.opt_state["mu"], saved["opt_state"]["mu"]),
                        (st.opt_state["nu"], saved["opt_state"]["nu"])):
        for k, t in live.items():
            diff = local(t.detach()) - local_rows(whole[k], t,
                                                  st.splits.get(k))
            worst = max(worst, float(diff.abs().max()) if diff.numel()
                        else 0.0)
    return {"worst": worst, "step": st.step,
            "count": st.opt_state["count"], "split": sorted(st.splits)}


def epoch_meters(ctx) -> dict:
    """One epoch's train loop (STEPS steps); the counts of its meters
    after they are synchronized."""
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    kept = []

    class Kept(trainer.MetricLogger):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            kept.append(self)

    plain = trainer.MetricLogger
    trainer.MetricLogger = Kept
    try:
        stats = trainer.train_one_epoch(ctx, 0, max_steps=STEPS)
    finally:
        trainer.MetricLogger = plain
    return {"stats": stats, "counts": {k: m.count for k, m in
                                       kept[0].meters.items()}}


def kernel_routes(rank: int, world: int) -> dict:
    """A ViT on the kernel routes, split over the model axis (heads, then
    tokens under sp), against the unsplit model: the largest difference
    of the logits and of the whole gradients, over their largest."""
    import torch.distributed as dist

    from vision_transformers_torch_xla_tpu_torch.models.layers import (
        attention_route,
        init_weights,
    )
    from vision_transformers_torch_xla_tpu_torch.models.vit import (
        VisionTransformer,
    )
    from vision_transformers_torch_xla_tpu_torch.parallel import sharding
    from vision_transformers_torch_xla_tpu_torch.parallel.split import (
        ModelAxis,
    )

    axis = ModelAxis(dist.group.WORLD, rank, world)
    out = {}
    cases = {"heads": (64, 128), "tokens": (64, 128),
             "tokens_long": (512, 128)}
    for case, (img, dim) in cases.items():
        model = VisionTransformer(
            img_size=img, patch_size=16, embed_dim=dim, depth=1,
            num_heads=dim // 64, mlp_ratio=2.0 if case == "heads" else 4.0,
            act_layer="gelu_tanh", use_pallas_attn=True, use_pallas_mlp=True,
            num_classes=10, dtype=torch.float32)
        init_weights(model, torch.Generator().manual_seed(3))
        whole = copy.deepcopy(model)
        splits = sharding.split_heads(model, axis) if case == "heads" \
            else sharding.split_tokens(model, axis) or {}
        x = torch.randn(2 if case != "tokens_long" else 1, img, img, 3,
                        generator=torch.Generator().manual_seed(4))
        y, want = model(x), whole(x)
        y.square().sum().backward()
        want.square().sum().backward()
        worst = 0.0
        for (k, p), (_, q) in zip(model.named_parameters(),
                                  whole.named_parameters()):
            g = full(p.grad, splits.get(k))
            if case != "heads":   # each peer's part of M x the gradient
                g = g.clone()
                dist.all_reduce(g)
                g = g / world
            worst = max(worst, float((g - q.grad).abs().max()
                                     / q.grad.abs().max()))
        s = (img // 16) ** 2 + 1
        out[case] = {
            "route": attention_route(True, False, False, dim // 64, 64, s),
            "fused_mlp": model.blocks[0].mlp._fused(
                torch.zeros(1, 1, dim)),
            "logits": float((y - want).abs().max() / want.abs().max()),
            "grads": worst}
    return out


def main(group: str, rank: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from vision_transformers_torch_xla_tpu_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    torch.set_num_threads(1)
    world = GROUPS[group]["world"]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    n = processes(group) * B
    arrays, info = {}, {}
    mesh_group = None
    for name in GROUPS[group]["runs"]:
        if name == "kernel_routes":
            info[name] = kernel_routes(rank, world)
            continue
        if name == "main":
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                info["main"] = trainer.main(config(
                    group, **RUNS["subset"], output_dir=os.path.join(
                        workdir, f"main_{group}"),
                    save_ckpt=True, limit_steps_per_epoch=STEPS,
                    limit_eval_batches=EVAL_BATCHES))
            info["main_stdout"] = out.getvalue()
            continue
        if name in JAX_RUNS:
            cfg = config(group, **JAX_RUN, param_sharding=JAX_RUNS[name],
                         finetune=os.path.join(workdir, "jax.pth"))
        else:
            cfg = config(group, **RUNS[name])
        ctx = trainer.setup(cfg)
        if ctx is None:   # past the mesh
            info["sat_out"] = True
            continue
        mesh_group = ctx.mesh.group
        per = n // ctx.shard.count
        rows = slice(ctx.shard.index * per, (ctx.shard.index + 1) * per)
        if name in JAX_RUNS:
            losses, norms, seen = run_steps(ctx, rows, n, raw=False,
                                            draws=jax_draws(workdir))
        else:
            losses, norms, seen = run_steps(ctx, rows, n)
        got = {"losses": losses, "grad_norms": norms,
               "split": sorted(ctx.state.splits),
               "data_index": ctx.shard.index,
               "sharded": any(local(p) is not p
                              for p in ctx.state.params.values())}
        if name not in JAX_RUNS:
            got["eval"] = eval_totals(ctx)
            arrays.update({f"{name}/inputs/{i}": x.numpy()
                           for i, x in enumerate(seen["inputs"])})
            arrays.update({f"{name}/masks/{i}": x.numpy()
                           for i, x in enumerate(seen["masks"])})
        arrays.update({f"{name}/{k}": v
                       for k, v in gathered(ctx.state).items()})
        arrays.update({f"{name}/grads/{s}/{k}": g.numpy()
                       for s, grads in enumerate(seen["grads"])
                       for k, g in grads.items()})
        if name in ("tp", "tp_fsdp"):
            CheckpointManager(os.path.join(workdir, f"{name}_ckpt"),
                              group=ctx.mesh.group).save(
                0, ctx.state, metadata={"epoch": 0})
        if name == "tp":
            one = os.path.join(workdir, "one_ckpt")
            back = trainer.setup(config(group, **RUNS[name], resume=one))
            got["restored"] = restored_fit(
                back, os.path.join(one, "0", "state.pt"))
        if name == "tp_dp":
            got["meters"] = epoch_meters(ctx)
        info[name] = got
        del ctx
    if mesh_group is not None:
        dist.barrier(group=mesh_group)
    np.savez(os.path.join(workdir, f"{group}_rank{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"{group}_rank{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
