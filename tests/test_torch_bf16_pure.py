"""`--precision bf16_pure` (params, grads and EMA in bf16; compute bf16,
logits fp32): two train steps of the port against the JAX package's, on
the CPU.

The tiny ViT of tests/test_torch_train.py is built in both packages with
dtype and param_dtype bf16 and the attention kernels on (JAX's in interpret
mode, the port's plain versions), on the same weights and batches, with
the JAX mixup draws fed to the port and AdamW (wd 0.05, warmup + cosine lr,
EMA 0.9) through each package's fused update.

The two packages keep AdamW's moments differently: JAX's init makes them
zeros in the params' dtype (train/fused.py:69-73) and its first update
makes them fp32 (the grads are cast to fp32, :93-100); the port's are fp32
from the start. After step 1 both hold fp32 moments of the same values.

Tolerances. Both compute in bf16 with fp32 statistics, but round at
different points (XLA's CPU dots and the port's matmuls, the two attention
implementations), so their bf16 grads differ by about 1% of the largest.
The loss and the grad norm agree to 1e-2 relative (2.6 bf16 ulps; they
differed by 1.2e-3 and 3.3e-4 when the test was written). After step 1
the fp32 moments hold m = 0.1·g and v = 0.001·g²: m agrees to 2e-2 of each
tensor's largest value and v to 4e-2 (1.3e-2 and 2.0e-2 measured). The
params and EMA are bf16. Adam's first step moves an element by lr·sign(g),
so an element whose two grads have opposite signs (a grad that is rounding
noise: the key part of each qkv bias has an exact gradient of zero) moves
the other way; and where a param is about as small as its updates, the
grads' 1% moves it by more than a bf16 ulp. So each element lies within
one bf16 ulp of JAX's or within a reversed step each step (2·lr·STEPS),
and the share of elements beyond one ulp is bounded: 5% of the params and
1% of the EMA (3.8% and 0.55% measured).
"""
import numpy as np
import pytest
import torch

from test_torch_train import CFG, _jax_draw, _normal
from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
    flax_to_state_dict,
)
from vision_transformers_torch_xla_tpu_torch.models.vit import (
    VisionTransformer,
)
from vision_transformers_torch_xla_tpu_torch.train import mixup
from vision_transformers_torch_xla_tpu_torch.train import optim as port_optim
from vision_transformers_torch_xla_tpu_torch.train import schedules
from vision_transformers_torch_xla_tpu_torch.train.state import (
    create_train_state,
)
from vision_transformers_torch_xla_tpu_torch.train.steps import (
    StepConfig,
    make_train_step,
)

LR = 1e-3
STEPS, BATCH = 2, 2
LOSS_RTOL = NORM_RTOL = 1e-2
MU_REL, NU_REL = 2e-2, 4e-2
FAR_SHARE = {"params": 0.05, "ema": 0.01}


def _fp32(tree):
    import jax

    return jax.tree.map(lambda p: np.asarray(p, np.float32), tree)


@pytest.fixture(scope="module")
def two_steps():
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.core.dtypes import get_policy
    from vision_transformers_torch_xla_tpu.models.vit import (
        VisionTransformer as JaxViT,
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

    policy = get_policy("bf16_pure")
    assert policy.param_dtype == policy.compute_dtype == jnp.bfloat16
    jmodel = JaxViT(**CFG, dtype=policy.compute_dtype,
                    param_dtype=policy.param_dtype, use_pallas_attn=True)
    # the same params as the kernel model's, made under jit (the plain
    # model's init needs no interpret mode)
    plain = jmodel.clone(use_pallas_attn=False)
    params = jax.jit(lambda k: nn.meta.unbox(plain.init(
        k, jnp.zeros((2, 32, 32, 3))))["params"])(jax.random.key(0))
    sched = dict(base_value=LR, final_value=LR / 100, epochs=1,
                 niter_per_ep=STEPS, warmup_steps=1, start_warmup_value=LR)
    jtx = jo.maybe_fused_optimizer("adamw", jax_schedule(**sched), params,
                                   weight_decay=0.05, ema_decay=0.9)
    # the update under jit, as the JAX trainer runs it (eager, each leaf's
    # ops would compile one by one); the step stays eager, since the
    # interpret-mode kernels do not lower under jit
    jtx = jtx._replace(fused_update=jax.jit(jtx.fused_update))
    jcfg = jsteps.StepConfig(mixup=JaxMixupConfig(num_classes=10),
                             num_classes=10, ema_decay=0.9)
    jstep = jsteps.make_train_step(jmodel.apply, jtx, jcfg)
    jstate = jax_train_state(params, jtx, with_ema=True)
    init_dtypes = {str(m.dtype) for m in jax.tree.leaves(jstate.opt_state.mu)}

    model = VisionTransformer(**CFG, dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16,
                              use_pallas_attn=True)
    model.load_state_dict(flax_to_state_dict(_fp32(params)), strict=True)
    pparams = dict(model.named_parameters())
    tx = port_optim.maybe_fused_optimizer(
        "adamw", schedules.cosine_schedule_fn(**sched), pparams,
        weight_decay=0.05, ema_decay=0.9)
    pcfg = StepConfig(mixup=mixup.MixupConfig(num_classes=10),
                      num_classes=10, ema_decay=0.9)
    pstep = make_train_step(model, tx, pcfg)
    pstate = create_train_state(model, tx, with_ema=True)

    rng = jax.random.key(0)
    out = {"jax": [], "port": [], "init_mu_dtypes": init_dtypes}
    for s in range(STEPS):
        images = _normal((BATCH, 32, 32, 3), 100 + s)
        labels = np.random.default_rng(200 + s).integers(
            0, 10, BATCH).astype(np.int32)
        mix_rng = jax.random.split(jax.random.fold_in(rng, s), 5)[0]
        draw = _jax_draw(mix_rng, 32, 32, jcfg.mixup)
        with pltpu.force_tpu_interpret_mode():
            jstate, jm = jstep(jstate, jnp.asarray(images),
                               jnp.asarray(labels), rng)
        pstate, pm = pstep(pstate, torch.from_numpy(images),
                           torch.from_numpy(labels), 0, mixup_draw=draw)
        if s == 0:
            out["jax_moments"] = {
                "mu": flax_to_state_dict(_fp32(jstate.opt_state.mu)),
                "nu": flax_to_state_dict(_fp32(jstate.opt_state.nu)),
                "dtypes": {str(m.dtype) for m in jax.tree.leaves(
                    (jstate.opt_state.mu, jstate.opt_state.nu))}}
            out["port_moments"] = {
                k: {n: t.clone() for n, t in pstate.opt_state[k].items()}
                for k in ("mu", "nu")}
        out["jax"].append({k: float(v) for k, v in jm.items()})
        out["port"].append({k: float(v) for k, v in pm.items()})
    out.update(jstate=jstate, pstate=pstate)
    return out


def test_bf16_pure_loss_and_grad_norm_match_jax(two_steps):
    for s, (got, want) in enumerate(zip(two_steps["port"],
                                        two_steps["jax"])):
        assert set(got) == set(want) == {"loss", "grad_norm"}
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL, err_msg=f"step {s}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=NORM_RTOL, err_msg=f"step {s}")


def test_bf16_pure_moments_after_the_first_step_match_jax(two_steps):
    """JAX: bf16 zeros at init, fp32 after step 1; the port: fp32 all
    along. After step 1 the values agree."""
    assert two_steps["init_mu_dtypes"] == {"bfloat16"}
    assert two_steps["jax_moments"]["dtypes"] == {"float32"}
    for which, rel in (("mu", MU_REL), ("nu", NU_REL)):
        want = two_steps["jax_moments"][which]
        got = two_steps["port_moments"][which]
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == torch.float32, (which, k)
            w = w.numpy()
            err = np.abs(got[k].numpy() - w).max() / max(np.abs(w).max(),
                                                          1e-30)
            assert err <= rel, (which, k, err)


def test_bf16_pure_params_and_ema_match_jax_within_a_bf16_ulp(two_steps):
    jstate, pstate = two_steps["jstate"], two_steps["pstate"]
    assert pstate.step == int(jstate.step) == STEPS
    for which, jtree, ptree in (("params", jstate.params, pstate.params),
                                ("ema", jstate.ema_params,
                                 pstate.ema_params)):
        want = flax_to_state_dict(_fp32(jtree))
        assert set(want) == set(ptree)
        n_far = n_all = 0
        for k, w in want.items():
            got = ptree[k].detach()
            assert got.dtype == torch.bfloat16, (which, k)
            got, w = got.float().numpy(), w.numpy()
            # one bf16 ulp of the larger magnitude: 2^(exponent - 7)
            big = np.maximum(np.abs(got), np.abs(w))
            ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
            diff = np.abs(got - w)
            far = diff > ulp
            assert (diff[far] <= 2 * STEPS * LR + ulp[far]).all(), (which, k)
            n_far += int(far.sum())
            n_all += diff.size
        assert n_far <= FAR_SHARE[which] * n_all, (which, n_far, n_all)
