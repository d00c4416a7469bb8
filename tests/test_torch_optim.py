"""The port's optimizer factory against JAX `create_optimizer`, on the CPU.

Every name of JAX train/optim.py::_lookup, with and without `lookahead_`,
takes 3 steps on a small parameter dict in both packages: the same
values, each in its package's layout (a dense weight (out, in) here and
(in, out) in flax, a conv's OIHW and HWIO, a patch stem's (O, C, p, p)
and flax's (p·p·C, O) kernel), the same seeded gradients, a cosine lr
schedule and weight decay 0.05; AdaHessian gets the same Hessian
diagonal. The tensors are sized so that adafactor factors the dense
weight and the patch stem (a dense view) and not the depthwise conv.
Params agree to 1e-5 relative to their largest value (lion's sign update
moves each entry by exactly lr, radam's first steps are momentum alone).

Then `--update_freq` (optax.MultiSteps) with a wd schedule, layer decay
and clipping; the unknown and sharded cases; and the fused route.
"""
import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.train import optim
from vision_transformers_torch_xla_tpu_torch.train import schedules
from vision_transformers_torch_xla_tpu_torch.train.fused import FusedAdamW
from vision_transformers_torch_xla_tpu_torch.train.transforms import (
    Optimizer,
)

NAMES = ("sgd", "nesterov", "momentum", "adam", "adamw", "nadam", "nadamw",
         "radam", "adadelta", "adagrad", "adamax", "adafactor", "rmsprop",
         "rmsproptf", "novograd", "lamb", "lars", "lion", "adamp", "sgdp",
         "adahessian")

# name -> (torch shape, kind): 'dense' (out, in) <-> (in, out), 'conv'
# OIHW <-> HWIO, 'patch' (O, C, p, p) <-> (p·p·C, O), 'same' both alike
PARAMS = {
    "stem.0.weight": ((128, 32, 2, 2), "patch"),
    "stem.0.bias": ((128,), "same"),
    "stages.0.blocks.0.conv_dw.weight": ((128, 1, 3, 3), "conv"),
    "stages.0.blocks.0.mlp.fc1.weight": ((160, 128), "dense"),
    "stages.0.blocks.0.mlp.fc1.bias": ((160,), "same"),
    "stages.0.blocks.0.gamma": ((128,), "same"),
    "pos_embed": ((1, 5, 8), "same"),
}
SCHED = dict(base_value=1e-2, final_value=1e-4, epochs=1, niter_per_ep=4,
             warmup_steps=1, start_warmup_value=1e-3)


def to_flax(k: str, w: np.ndarray) -> np.ndarray:
    kind = PARAMS[k][1]
    if kind == "dense":
        return w.T
    if kind == "conv":
        return w.transpose(2, 3, 1, 0)
    if kind == "patch":
        return w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0])
    return w


def _values(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, (s, _) in PARAMS.items()}


def _jax_run(opt, steps, grads, hdiags, **kw):
    import jax.numpy as jnp
    import optax

    from vision_transformers_torch_xla_tpu.train import optim as jo
    from vision_transformers_torch_xla_tpu.train.schedules import (
        cosine_schedule_fn,
    )

    # flax-style names (`stages_0_blocks_0_…`): JAX's layer-decay kind and
    # group read them; the wd mask's keywords match either spelling
    def flat(tree):
        return {k.replace(".", "_"): jnp.asarray(to_flax(k, v))
                for k, v in tree.items()}

    params = flat(_values(0))
    tx = jo.create_optimizer(opt, cosine_schedule_fn(**SCHED), params,
                             weight_decay=0.05, **kw)
    state = tx.init(params)
    for s in range(steps):
        extra = {}
        if hdiags is not None:
            extra["hessian_diag"] = flat(hdiags[s])
        upd, state = tx.update(flat(grads[s]), state, params, **extra)
        params = optax.apply_updates(params, upd)
    return {k: np.asarray(params[k.replace(".", "_")]) for k in PARAMS}


def _port_run(opt, steps, grads, hdiags, **kw):
    params = {k: torch.from_numpy(v) for k, v in _values(0).items()}
    tx = optim.create_optimizer(opt, schedules.cosine_schedule_fn(**SCHED),
                                params, weight_decay=0.05,
                                dense_views=("stem.0.weight",), **kw)
    state = tx.init(params)
    for s in range(steps):
        extra = {}
        if hdiags is not None:
            extra["hessian_diag"] = {k: torch.from_numpy(v)
                                     for k, v in hdiags[s].items()}
        tx.fused_update({k: torch.from_numpy(v) for k, v in grads[s].items()},
                        state, params, **extra)
    return tx, state, {k: to_flax(k, v.numpy()) for k, v in params.items()}


def _compare(got, want, tol=1e-5):
    assert set(got) == set(want)
    for k in want:
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= tol, (k, err)


@pytest.mark.parametrize("lookahead", ["", "lookahead_"])
@pytest.mark.parametrize("name", NAMES)
def test_every_optimizer_matches_jax_for_three_steps(name, lookahead):
    opt = lookahead + name
    grads = [_values(10 + s, 0.1) for s in range(3)]
    hdiags = [_values(20 + s, 0.1) for s in range(3)] \
        if name == "adahessian" else None
    want = _jax_run(opt, 3, grads, hdiags)
    tx, _, got = _port_run(opt, 3, grads, hdiags)
    assert isinstance(tx, FusedAdamW if opt == "adamw" else Optimizer)
    start = {k: to_flax(k, v) for k, v in _values(0).items()}
    assert any(np.abs(got[k] - start[k]).max() > 0 for k in got)
    _compare(got, want)


def test_adafactor_factors_the_dense_view():
    """The patch stem (O, C, p, p) factors as flax's (p·p·C, O) kernel;
    the depthwise conv does not factor, and 1-D params do not."""
    params = {k: torch.from_numpy(v) for k, v in _values(0).items()}
    tx = optim.create_optimizer("adafactor", 1e-3, params,
                                dense_views=("stem.0.weight",))
    st = tx.init(params)["0"]["0"]
    assert set(st["v_row"]) == {"stem.0.weight",
                                "stages.0.blocks.0.mlp.fc1.weight"}
    assert "stages.0.blocks.0.conv_dw.weight" in st["v"]
    assert st["v_row"]["stem.0.weight"].shape == (128,)


@pytest.mark.parametrize("opt", ["adamw", "lookahead_lamb", "sgd"])
def test_update_freq_layer_decay_and_wd_schedule_match_jax(opt):
    """MultiSteps(2) over [clip, L2 or decoupled wd on a cosine schedule,
    the optimizer, ConvNeXt layer decay 0.8]: 6 micro-steps, 3 updates;
    the schedules advance once per update."""
    from vision_transformers_torch_xla_tpu.train.schedules import (
        cosine_schedule_fn,
    )

    kw = dict(update_freq=2, layer_decay=0.8, clip_grad=0.5)
    grads = [_values(30 + s, 0.3) for s in range(6)]
    want = _jax_run(opt, 6, grads, None, weight_decay_schedule=
                    cosine_schedule_fn(0.05, 0.2, 1, 4), **kw)
    tx, state, got = _port_run(opt, 6, grads, None,
                               weight_decay_schedule=schedules
                               .cosine_schedule_fn(0.05, 0.2, 1, 4), **kw)
    _compare(got, want)
    assert state["gradient_step"] == 3 and state["mini_step"] == 0
    inner = state["inner"]
    assert (inner["inner"] if "inner" in inner else inner)["count"] == 3


def test_micro_steps_between_updates_leave_the_params():
    params = {"w": torch.ones(3, 2)}
    tx = optim.create_optimizer("adamw", 0.1, params, update_freq=3)
    state = tx.init(params)
    for s in range(3):
        tx.fused_update({"w": torch.full((3, 2), float(s + 1))}, state,
                        params)
        assert torch.equal(params["w"], torch.ones(3, 2)) == (s < 2)
    # the mean of the three gradients (2) reached adam: one lr step down
    torch.testing.assert_close(params["w"], torch.full((3, 2), 0.9))


def test_an_unknown_optimizer_raises():
    params = {"w": torch.zeros(2, 2)}
    for opt in ("sgdw", "lookahead_bogus", "fusedlamb2"):
        with pytest.raises(ValueError, match="unsupported optimizer"):
            optim.create_optimizer(opt, 1e-3, params)
    assert optim.is_second_order("lookahead_adahessian")
    assert not optim.is_second_order("adamw")


def test_whole_tensor_optimizers_refuse_a_model_axis_part():
    """lamb's trust ratio needs a whole tensor's norm: on the model
    axis's parts (or FSDP's shards) it raises naming the optimizer; an
    elementwise update does not."""
    params = {"w": torch.ones(2, 2)}
    grads = {"w": torch.ones(2, 2)}
    for opt, raises in (("lamb", True), ("adafactor", True),
                        ("sgdp", True), ("adam", False)):
        tx = optim.create_optimizer(opt, 1e-3, params)
        state = tx.init(params)
        if raises:
            with pytest.raises(NotImplementedError, match=repr(opt)):
                tx.fused_update(grads, state, params,
                                splits={"w": object()})
        else:
            assert tx.check_unsharded(params, {"w": object()}) is None
