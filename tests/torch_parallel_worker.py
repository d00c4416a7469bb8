"""One rank of the 2-rank gloo group that tests/test_torch_parallel.py
starts, and the runs it shares with the test's one-process references.

    python tests/torch_parallel_worker.py RANK WORLD PORT WORKDIR

Each rank joins a gloo group on 127.0.0.1:PORT (one thread, a two-minute
timeout), then runs through the port's trainer (launch/main.py::setup,
its train and eval steps, main()):

  * `ddp` and `fsdp`: test_vit at 32 px, fp32, mixup and cutmix,
    drop_path 0.1, --device_augment with erasing, EMA; DDP with
    --grad_checkpointing. (The kernel route's autograd Functions under
    both wrappers run on the card: chip_smoke.py phases 32-33.)
    `convnext_ddp` and `convnext_fsdp`: the same on test_convnext.
    STEPS steps on this rank's rows of the test's global batches, then the
    eval of 2 batches of the rank's own stream, plain and EMA. It keeps
    the model's inputs and drop-path masks of every step (`record_draws`),
    the global losses, and the gathered params and EMA. The fsdp run then
    saves a checkpoint and restores the one-process checkpoint the test
    wrote into a fresh FSDP state.
  * `jax`: DDP on test_vit (drop_path 0, no augmentation) from the weights
    the test converted from its JAX model, fed JAX's mixup draws.
  * `main`: main() under FSDP with --output_dir, stdout kept per rank.

Results go to WORKDIR/rank<r>.npz (arrays) and WORKDIR/rank<r>.json. It
imports only the port, torch and numpy.
"""
from __future__ import annotations

import contextlib
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

WORLD = 2
B = 4                      # per rank; the global batch is WORLD * B
STEPS = 2
SEED = 0
SIZE = 32
EVAL_BATCHES = 2

BASE = dict(model="test_vit", input_size=SIZE, nb_classes=10,
            data_set="synthetic", batch_size=B, epochs=1, warmup_epochs=0,
            lr=1e-3, min_lr=1e-5, device="cpu", precision="fp32",
            mixup=0.8, cutmix=1.0, drop_path=0.1,
            device_augment=True, reprob=0.5, model_ema=True,
            model_ema_decay=0.9, synthetic_train_size=64,
            synthetic_val_size=48, log_freq=1, seed=SEED, save_ckpt=False)
RUNS = {"ddp": dict(param_sharding="replicated", grad_checkpointing=True),
        "fsdp": dict(param_sharding="fsdp"),
        # ConvNeXt: FSDP2 wraps each stages.S.blocks.B, then the root
        "convnext_ddp": dict(model="test_convnext",
                             param_sharding="replicated"),
        "convnext_fsdp": dict(model="test_convnext", param_sharding="fsdp")}
JAX_RUN = dict(drop_path=0.0, device_augment=False, reprob=0.0,
               param_sharding="replicated")


def config(**kw) -> TrainConfig:
    return TrainConfig(**{**BASE, **kw})


def global_batch(step: int, raw: bool = True):
    """The test's global batch of `step`: raw [0, 1] pixels for the
    on-device augmentation, else standard normal ones."""
    rng = np.random.default_rng(100 + step)
    n = WORLD * B
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


def run_steps(ctx, rows: slice, raw: bool = True, draws=()):
    """STEPS train steps on `rows` of each global batch; returns the
    global losses and grad norms, and the draws seen."""
    from vision_transformers_torch_xla_tpu_torch.launch.main import (
        global_metrics,
    )

    losses, norms = [], []
    with record_draws(ctx) as seen:
        for s in range(STEPS):
            images, labels = global_batch(s, raw)
            kw = {"mixup_draw": draws[s]} if draws else {}
            ctx.state, m = ctx.train_step(
                ctx.state, torch.from_numpy(images[rows]),
                torch.from_numpy(labels[rows]), SEED, **kw)
            m = global_metrics(ctx, m)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            seen.setdefault("grads", []).append(
                {k: full(p.grad).clone() for k, p in ctx.state.params.items()})
    return losses, norms, seen


def gathered(state) -> dict:
    """{'params/<name>', 'ema/<name>': whole tensors as numpy}."""
    out = {}
    for which, tree in (("params", state.params), ("ema", state.ema_params)):
        for k, v in tree.items():
            out[f"{which}/{k}"] = full(v.detach()).numpy()
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
    """Each param, moment and EMA shard of `ctx` against its rows of the
    checkpoint at `path`: the largest difference, and the step."""
    saved = torch.load(path, weights_only=True)
    st = ctx.state
    worst = 0.0
    for live, whole in ((st.params, saved["params"]),
                        (st.ema_params, saved["ema_params"]),
                        (st.opt_state["mu"], saved["opt_state"]["mu"]),
                        (st.opt_state["nu"], saved["opt_state"]["nu"])):
        for k, t in live.items():
            diff = local(t.detach()) - local_rows(whole[k], t)
            worst = max(worst, float(diff.abs().max()) if diff.numel()
                        else 0.0)
    return {"worst": worst, "step": st.step,
            "count": st.opt_state["count"],
            "sharded": all(local(t) is not t for t in st.params.values())}


def main(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from vision_transformers_torch_xla_tpu_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    rows = slice(rank * B, (rank + 1) * B)
    arrays, info = {}, {}
    for name, kw in RUNS.items():
        ctx = trainer.setup(config(**kw))
        losses, norms, seen = run_steps(ctx, rows)
        info[name] = {"losses": losses, "grad_norms": norms,
                      "eval": eval_totals(ctx),
                      "sharded": all(local(p) is not p
                                     for p in ctx.state.params.values())}
        arrays.update({f"{name}/inputs/{i}": x.numpy()
                       for i, x in enumerate(seen["inputs"])})
        arrays.update({f"{name}/masks/{i}": x.numpy()
                       for i, x in enumerate(seen["masks"])})
        arrays.update({f"{name}/{k}": v
                       for k, v in gathered(ctx.state).items()})
        arrays.update({f"{name}/grads/{s}/{k}": g.numpy()
                       for s, grads in enumerate(seen["grads"])
                       for k, g in grads.items()})
        if name == "fsdp":
            CheckpointManager(os.path.join(workdir, "fsdp_ckpt")).save(
                0, ctx.state, metadata={"epoch": 0})
            one = os.path.join(workdir, "one_ckpt")
            back = trainer.setup(config(**kw, resume=one))
            info["restored"] = restored_fit(
                back, os.path.join(one, "0", "state.pt"))
        del ctx

    ctx = trainer.setup(config(**JAX_RUN,
                               finetune=os.path.join(workdir, "jax.pth")))
    losses, norms, seen = run_steps(ctx, rows, raw=False,
                                    draws=jax_draws(workdir))
    info["jax"] = {"losses": losses, "grad_norms": norms}
    arrays.update({f"jax/{k}": v for k, v in gathered(ctx.state).items()})
    arrays.update({f"jax/grads/{s}/{k}": g.numpy()
                   for s, grads in enumerate(seen["grads"])
                   for k, g in grads.items()})
    del ctx

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        info["main"] = trainer.main(config(
            param_sharding="fsdp", output_dir=os.path.join(workdir, "main"),
            save_ckpt=True, limit_steps_per_epoch=STEPS,
            limit_eval_batches=EVAL_BATCHES))
    info["main_stdout"] = out.getvalue()
    dist.barrier()
    dist.destroy_process_group()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
