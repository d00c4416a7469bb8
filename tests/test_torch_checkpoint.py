"""The port's checkpoints and resume on the CPU, against the JAX package.

`CheckpointManager` is held to the JAX manager (Orbax as the JAX package
configures it) on the same sequences of saves. The trainer runs with
`device="cpu"`, my_vit_mini at 32 px (10 classes) cut to 2 blocks, 2
steps an epoch and 2 eval batches. One module-scoped pair of runs is shared read-only: an
uninterrupted 2-epoch run, and the same run stopped after epoch 0 as a
preemption would stop it (the LR schedule spans the run's `--epochs`, so
the stopped run has the same schedule). A resumed run must equal the
uninterrupted one bitwise: params, EMA, mu, nu, step and count.
`merge_into_params` and `resample_pos_embed` are held to JAX's at 1e-5.
"""
import json
import os
import shutil
import threading
import urllib.request

import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ckpt.checkpoint import (
    CheckpointManager,
    auto_resume,
)
from vision_transformers_torch_xla_tpu_torch.core.config import TrainConfig
from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
from vision_transformers_torch_xla_tpu_torch.models import create_model
from vision_transformers_torch_xla_tpu_torch.models.layers import (
    init_weights,
)
from vision_transformers_torch_xla_tpu_torch.models.pretrained import (
    _infer_prefix_tokens,
    merge_into_params,
    resample_pos_embed,
)
from vision_transformers_torch_xla_tpu_torch.train.fused import FusedAdamW
from vision_transformers_torch_xla_tpu_torch.train.state import (
    create_train_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 2


@pytest.fixture(scope="module", autouse=True)
def shallow():
    """The trainer's and the server's models cut to DEPTH blocks."""
    from vision_transformers_torch_xla_tpu_torch.launch import serve as srv

    with pytest.MonkeyPatch.context() as mp:
        for mod in (trainer, srv):
            mp.setattr(mod, "create_model",
                       lambda name, _c=mod.create_model, **kw: _c(
                           name, depth=DEPTH, **kw))
        yield


def _cfg(out, **kw):
    base = dict(model="my_vit_mini", input_size=32, nb_classes=10,
                data_set="synthetic", batch_size=4, epochs=2,
                limit_steps_per_epoch=2, limit_eval_batches=2,
                warmup_epochs=0, lr=1e-3, device="cpu", log_freq=1,
                synthetic_train_size=64, synthetic_val_size=32,
                model_ema=True, output_dir=str(out))
    base.update(kw)
    return TrainConfig(**base)


class Preempted(Exception):
    pass


def _preempted_main(cfg, at_epoch: int):
    """main(cfg), stopped as a preemption would stop it when `at_epoch`
    starts (after the previous epoch's checkpoint)."""
    run_epoch = trainer.train_one_epoch

    def stop(ctx, epoch, *args):
        if epoch == at_epoch:
            raise Preempted
        return run_epoch(ctx, epoch, *args)

    trainer.train_one_epoch = stop
    try:
        with pytest.raises(Preempted):
            trainer.main(cfg)
    finally:
        trainer.train_one_epoch = run_epoch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(whole, stopped, whole_stats): an uninterrupted 2-epoch run, and
    the same run stopped after epoch 0 (its checkpoint of epoch 0 only)."""
    whole = tmp_path_factory.mktemp("whole")
    stats = trainer.main(_cfg(whole))
    stopped = tmp_path_factory.mktemp("stopped")
    _preempted_main(_cfg(stopped), at_epoch=1)
    return whole, stopped, stats


def _same(a, b, path="state"):
    """Bitwise equality of two saved states; fails naming the entry."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, path


def _newest(out):
    return CheckpointManager(os.path.join(out, "checkpoints")).restore_raw()


def _tiny_state(seed=0, ema=True):
    model = create_model("my_vit_mini", num_classes=10, img_size=32,
                         depth=DEPTH, dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(seed))
    tx = FusedAdamW(1e-3, ema_decay=0.9 if ema else None)
    return model, tx, create_train_state(model, tx, with_ema=ema)


# ---- the manager ----------------------------------------------------------

def test_round_trip_restores_into_the_live_tensors(tmp_path):
    model, tx, state = _tiny_state(seed=0)
    images = torch.randn(2, 32, 32, 3, generator=torch.Generator()
                         .manual_seed(1))
    model(images).sum().backward()
    grads = {k: p.grad for k, p in state.params.items()}
    tx.fused_update(grads, state.opt_state, state.params, state.ema_params)
    state.step = 7
    mngr = CheckpointManager(str(tmp_path / "ck"))
    assert mngr.save(3, state, metadata={"epoch": 3, "note": "x"})
    saved = {k: v.clone() for k, v in state.state_dict()["params"].items()}

    fresh_model, _, fresh = _tiny_state(seed=5)
    ptrs = {k: p.data_ptr() for k, p in fresh.params.items()}
    ema_ptrs = {k: e.data_ptr() for k, e in fresh.ema_params.items()}
    mu_ptrs = {k: m.data_ptr() for k, m in fresh.opt_state["mu"].items()}
    restored, meta = mngr.restore(fresh)
    assert restored is fresh and meta == {"epoch": 3, "note": "x"}
    assert fresh.step == 7 and fresh.opt_state["count"] == 1
    _same(fresh.state_dict(), state.state_dict())
    # the model trains the restored values: same tensors, same storage
    live = dict(fresh_model.named_parameters())
    for k, p in fresh.params.items():
        assert live[k] is p and p.data_ptr() == ptrs[k]
        assert torch.equal(live[k], saved[k])
    assert all(e.data_ptr() == ema_ptrs[k]
               for k, e in fresh.ema_params.items())
    assert all(m.data_ptr() == mu_ptrs[k]
               for k, m in fresh.opt_state["mu"].items())


def test_save_copies_the_state_at_the_call(tmp_path):
    """An in-place update after save() does not reach the checkpoint."""
    _, _, state = _tiny_state()
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(0, state)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    _same(mngr.restore_raw()["params"], before)


SAVES = [
    # (max_to_keep, save_interval_epochs, epochs saved in order)
    (3, 2, [0, 1, 2, 3, 4, 5, 3]),
    (2, 1, [0, 1, 2, 3, 2]),
    (3, 2, [1, 2, 3, 4, 5]),
    (2, 3, [0, 1, 2, 3, 4, 5, 6, 7]),
]


@pytest.mark.parametrize("keep,interval,epochs", SAVES,
                         ids=[f"keep{k}-every{i}-from{e[0]}"
                              for k, i, e in SAVES])
def test_rotation_and_interval_match_jax(tmp_path, keep, interval, epochs):
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.ckpt.checkpoint import (
        CheckpointManager as JaxManager,
    )

    _, _, state = _tiny_state(ema=False)
    ours = CheckpointManager(str(tmp_path / "ours"), max_to_keep=keep,
                             save_interval_epochs=interval)
    theirs = JaxManager(str(tmp_path / "jax"), max_to_keep=keep,
                        save_interval_epochs=interval)
    got, want = [], []
    for e in epochs:
        ours.save(e, state, metadata={"epoch": e})
        theirs.save(e, {"w": jnp.ones((2,))}, metadata={"epoch": e})
        got.append(ours.latest_epoch())
        want.append(theirs.latest_epoch())
    theirs.wait()
    on_disk = sorted(int(d) for d in os.listdir(tmp_path / "jax")
                     if d.isdigit())
    theirs.close()
    assert got == want
    assert ours.all_epochs() == on_disk
    assert ours.metadata() == {"epoch": on_disk[-1]}


def test_restore_of_nothing_and_an_interrupted_save(tmp_path):
    _, _, state = _tiny_state()
    mngr = CheckpointManager(str(tmp_path))
    assert mngr.restore(state) == (None, None)
    assert mngr.restore_raw() is None
    assert auto_resume(mngr, state) == (None, 0)
    mngr.save(0, state, metadata={"epoch": 0})
    # a save cut before its rename is not an epoch
    os.makedirs(tmp_path / ".tmp-4")
    torch.save({}, tmp_path / ".tmp-4" / "state.pt")
    assert mngr.latest_epoch() == 0
    restored, start = auto_resume(mngr, state)
    assert restored is state and start == 1


def test_restore_refuses_another_model(tmp_path):
    _, _, state = _tiny_state()
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(0, state)
    other = create_model("my_vit_mini", num_classes=7, img_size=32,
                         depth=DEPTH, dtype=torch.float32)
    init_weights(other, torch.Generator().manual_seed(0))
    tx = FusedAdamW(1e-3, ema_decay=0.9)
    with pytest.raises(ValueError, match="head"):
        mngr.restore(create_train_state(other, tx, with_ema=True))
    deeper = create_model("my_vit_mini", num_classes=10, img_size=32,
                          depth=DEPTH + 1, dtype=torch.float32)
    init_weights(deeper, torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match=f"blocks.{DEPTH}"):
        mngr.restore(create_train_state(deeper, tx, with_ema=True))


# ---- resume through the trainer ---------------------------------------------

def test_trainer_writes_a_checkpoint_and_log_per_epoch(runs):
    whole, stopped, stats = runs
    assert stats["epoch"] == 1
    assert CheckpointManager(os.path.join(whole, "checkpoints")
                             ).all_epochs() == [0, 1]
    assert CheckpointManager(os.path.join(stopped, "checkpoints")
                             ).all_epochs() == [0]
    lines = [json.loads(l) for l in open(os.path.join(whole, "log.txt"))]
    assert [r["epoch"] for r in lines] == [0, 1]
    assert lines[-1] == stats


def test_auto_resume_equals_the_uninterrupted_run(runs, tmp_path):
    whole, stopped, stats = runs
    work = tmp_path / "cont"
    shutil.copytree(stopped, work)
    got = trainer.main(_cfg(work))
    assert got["epoch"] == 1 and got == stats
    _same(_newest(work), _newest(whole))
    saved = _newest(work)
    assert saved["step"] == 4 and saved["opt_state"]["count"] == 4
    lines = open(os.path.join(work, "log.txt")).readlines()
    assert len(lines) == 2


def test_setup_resumes_into_the_models_parameters(runs, tmp_path):
    _, stopped, _ = runs
    work = tmp_path / "cont"
    shutil.copytree(stopped, work)
    ctx = trainer.setup(_cfg(work))
    assert ctx.start_epoch == 1 and ctx.state.step == 2
    saved = _newest(stopped)["params"]
    for name, p in ctx.model.named_parameters():
        assert p is ctx.state.params[name]
        assert torch.equal(p, saved[name]), name


@pytest.mark.parametrize("which", ["root", "epoch_dir"])
def test_explicit_resume_equals_the_uninterrupted_run(runs, tmp_path, which):
    whole, stopped, stats = runs
    src = os.path.join(stopped, "checkpoints")
    got = trainer.main(_cfg(tmp_path / "dst", resume=src if which == "root"
                            else os.path.join(src, "0")))
    assert got["epoch"] == 1 and got == stats
    _same(_newest(tmp_path / "dst"), _newest(whole))


def test_resume_missing_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        trainer.main(_cfg(tmp_path, resume=str(tmp_path / "nope")))


def test_resume_from_a_pth_loads_the_weights_only(runs, tmp_path):
    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        save_checkpoint,
    )

    whole, _, _ = runs
    params = _newest(whole)["params"]
    path = str(tmp_path / "w.pth")
    save_checkpoint(path, params)
    ctx = trainer.setup(_cfg(tmp_path / "out", resume=path))
    assert ctx.start_epoch == 0 and ctx.state.step == 0
    _same({k: p.detach() for k, p in ctx.state.params.items()}, params)


def test_finetune_from_a_checkpoints_directory_takes_its_ema(runs,
                                                             tmp_path):
    whole, _, _ = runs
    ctx = trainer.setup(_cfg(tmp_path, finetune=os.path.join(
        whole, "checkpoints")))
    assert ctx.start_epoch == 0 and ctx.state.step == 0
    _same({k: p.detach() for k, p in ctx.state.params.items()},
          _newest(whole)["ema_params"])


def test_eval_from_resume_returns_the_trained_state(runs):
    whole, _, stats = runs
    got = trainer.main(_cfg("", eval_only=True,
                            resume=os.path.join(whole, "checkpoints")))
    assert set(got) == {"acc1", "acc5", "loss", "count"}
    assert got["acc1"] == stats["acc1"] and got["loss"] == stats["loss"]


def test_serve_from_a_checkpoints_directory(runs):
    """launch/serve.py --ckpt <checkpoints> --use_ema answers with the
    top-5 of the restored EMA's forward."""
    from vision_transformers_torch_xla_tpu_torch.launch.serve import (
        InferenceEngine,
        serve,
    )

    whole, _, _ = runs
    engine = InferenceEngine("my_vit_mini", os.path.join(whole, "checkpoints"),
                             image_size=32, num_classes=10, use_ema=True,
                             device="cpu")
    with open(os.path.join(REPO, "tests", "data", "serve_0.jpg"), "rb") as f:
        data = f.read()
    srv = serve(engine, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/predict", data=data,
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            topk = json.loads(r.read())["topk"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    # the same bf16 model on the saved EMA, in this process
    ema = _newest(whole)["ema_params"]
    assert any(not torch.equal(ema[k], _newest(whole)["params"][k])
               for k in ema)
    model = create_model("my_vit_mini", num_classes=10, img_size=32,
                         global_pool="avg", depth=DEPTH)
    model.load_state_dict(ema, strict=True)
    with torch.inference_mode():
        probs = torch.softmax(model.eval()(torch.from_numpy(
            engine._decode(data)[None])), -1)[0].numpy()
    want = np.argsort(probs)[::-1][:5].tolist()
    assert [c for c, _ in topk] == want
    np.testing.assert_allclose([p for _, p in topk], probs[want], rtol=1e-6)


# ---- merging loaded weights -------------------------------------------------

@pytest.mark.parametrize("old,new,prefix", [(14, 16, 1), (16, 14, 1),
                                            (14, 16, 0), (16, 14, 0)])
def test_resample_pos_embed_matches_jax(old, new, prefix):
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.models.vit import (
        resample_pos_embed as jax_resample,
    )

    x = np.random.default_rng(old * 10 + prefix).standard_normal(
        (1, prefix + old * old, 24)).astype(np.float32)
    want = np.asarray(jax_resample(jnp.asarray(x), (new, new), (old, old),
                                   num_prefix_tokens=prefix))
    got = resample_pos_embed(torch.from_numpy(x), (new, new), (old, old),
                             num_prefix_tokens=prefix).numpy()
    assert got.shape == want.shape == (1, prefix + new * new, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[:, :prefix], x[:, :prefix])


@pytest.mark.parametrize("old,new", [(197, 257), (257, 197), (196, 256),
                                     (10, 50), (201, 261)])
def test_infer_prefix_tokens_matches_jax(old, new):
    from vision_transformers_torch_xla_tpu.models.pretrained import (
        _infer_prefix_tokens as jax_infer,
    )

    assert _infer_prefix_tokens(old, new) == jax_infer(old, new)


@pytest.mark.parametrize("old_img,new_img", [(224, 256), (256, 224)])
def test_merge_into_params_matches_jax(old_img, new_img):
    """A 14 x 14 (or 16 x 16) checkpoint with 10 classes grafted onto a
    16 x 16 (14 x 14) model with 7: the pos_embed resampled, the head
    skipped, the rest copied, as JAX merges the same weights."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.models.pretrained import (
        merge_into_params as jax_merge,
    )
    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        flax_to_state_dict,
    )

    kw = dict(embed_dim=32, depth=1, num_heads=2, dtype=torch.float32)
    src = create_model("my_vit_mini", num_classes=10, img_size=old_img, **kw)
    init_weights(src, torch.Generator().manual_seed(1))
    dst = create_model("my_vit_mini", num_classes=7, img_size=new_img, **kw)
    init_weights(dst, torch.Generator().manual_seed(2))
    loaded = {k: v.detach().clone() for k, v in src.state_dict().items()}
    before = {k: v.detach().clone() for k, v in dst.state_dict().items()}
    params, n = merge_into_params(dict(dst.named_parameters()), loaded)
    assert n == len(loaded) - 2  # all but head.weight, head.bias

    # JAX: the same trees in flax layout (dst's init as the params)
    from vision_transformers_torch_xla_tpu.models import (
        create_model as jax_create,
    )

    jm = jax_create("my_vit_mini", num_classes=7, img_size=new_img,
                    embed_dim=32, depth=1, num_heads=2, dtype=jnp.float32)
    jparams = jax.jit(lambda k: jm.init(k, jnp.zeros(
        (1, new_img, new_img, 3)), True))(jax.random.key(0))["params"]
    jparams = _fill_flax(jparams, before)
    jloaded = _fill_flax(jax_create(
        "my_vit_mini", num_classes=10, img_size=old_img, embed_dim=32,
        depth=1, num_heads=2, dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, old_img, old_img, 3)), True)[
        "params"], loaded)
    merged, jn = jax_merge(jparams, jloaded)
    assert jn == n
    want = flax_to_state_dict(jax.tree.map(np.asarray, merged))
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert torch.equal(params["head.weight"], before["head.weight"])
    assert torch.equal(params["blocks.0.attn.qkv.weight"],
                       loaded["blocks.0.attn.qkv.weight"])


def _fill_flax(tree, state_dict):
    """A flax ViT params tree holding a port state dict's values (the
    inverse of flax_to_state_dict for the keys of these models)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        flax_to_state_dict,
    )

    flat, treedef = jax.tree_util.tree_flatten_with_path(nn.meta.unbox(tree))
    probe = flax_to_state_dict(jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(v), i, np.float32)
                  for i, (_, v) in enumerate(flat)]))
    leaves = [None] * len(flat)
    for name, marked in probe.items():
        i = int(marked.reshape(-1)[0])
        v = state_dict[name].detach().numpy()
        # undo the converter's transposes and reshapes by leaf shape
        shape = np.shape(flat[i][1])
        if v.ndim == 2:
            v = v.T
        elif v.ndim == 4:  # OIHW conv -> (p·p·C, D)
            v = v.transpose(2, 3, 1, 0).reshape(shape)
        leaves[i] = jnp.asarray(v.reshape(shape))
    return jax.tree_util.tree_unflatten(treedef, leaves)
