"""Every kernel of the port in float16 and float32, as the JAX kernels run in
any float dtype.

On the CPU: each plain version (K1-K12, what the wrappers run for CPU
tensors) against the JAX Pallas kernel in interpret mode on the same
float16 inputs, made from a numpy seed (the float32 and bfloat16 cases are
in the per-kernel test files). Both sides round at the same points, to
float16 where the JAX kernels `astype` to the inputs' dtype, and sum in
float32 in other orders and block sizes; a flipped float16 rounding moves
a stored value by one ulp (2^-11 relative), so values agree to FP16_RTOL of
their largest magnitude and the fp32 row stats to STATS_RTOL.

On the card (`cuda` marker, skipped here): each kernel's fp32 and fp16
instantiation, launched through its wrapper, against its plain version on
the same CUDA tensors: fp32 differs by summation order and expf only
(CUDA_RTOL[fp32] of the largest value), fp16 by flipped fp16 roundings;
their fp32 outputs to CUDA_FP32_OUT_RTOL.
"""
import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa
from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked as fb
from vision_transformers_torch_xla_tpu_torch.ops import mlp_fused as mf

B, S, H, D = 2, 130, 2, 64   # S ragged against the TPU kernels' 128 and 256
FP16_RTOL = 5e-3
STATS_RTOL = 1e-4
CUDA_RTOL = {torch.float32: 1e-4, torch.float16: 5e-3}
# the fp32 outputs (row stats, lse, bias partials) of each instantiation:
# summation order, and in fp16 the fp16 roundings of the terms they sum
CUDA_FP32_OUT_RTOL = {torch.float32: 1e-4, torch.float16: 1e-3}
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10",
           "K11", "K12")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _rand(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return x.astype(np.float16).astype(np.float32)


def _close(got, want, rtol, name):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=name)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32)).half()


def _jax_f32(x):
    import jax.numpy as jnp

    return np.asarray(x.astype(jnp.float32))


def _pad_s(x, axis, multiple):
    import jax.numpy as jnp

    s = x.shape[axis]
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, -(-s // multiple) * multiple - s)
    return jnp.pad(x, widths)


def _case_k1_k2(kernel):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _hp_bwd_pi_call,
        _hp_fwd_stats_call,
        _pi_perm,
    )

    qkv, do = _rand((B, S, 3 * H * D), 1), _rand((B, S, H * D), 2)
    scale = D ** -0.5
    x, g = jnp.asarray(qkv, jnp.float16), jnp.asarray(do, jnp.float16)
    with pltpu.force_tpu_interpret_mode():
        o, st = _hp_fwd_stats_call(x, scale, S, H, D)
        dpi, dbp = _hp_bwd_pi_call(x, g, o, st, scale, S, H, D)
    st = np.asarray(st)                    # (H/2, B, S, 4) = [m0, m1, r0, r1]
    stats = np.stack([st[..., :2].transpose(1, 0, 3, 2).reshape(B, H, S),
                      st[..., 2:].transpose(1, 0, 3, 2).reshape(B, H, S)],
                     -1)
    if kernel == "K1":
        o_p, st_p = fa.attn_fwd(_t(qkv), H, scale, with_stats=True)
        assert o_p.dtype == torch.float16
        _close(o_p, _jax_f32(o), FP16_RTOL, "o")
        _close(st_p, stats, STATS_RTOL, "stats")
        return
    _, inv = _pi_perm(H, D)
    dqkv, dbias = fa.attn_bwd(_t(qkv), _t(do), _t(_jax_f32(o)),
                              torch.from_numpy(stats).float(), H, scale)
    assert dqkv.dtype == torch.float16 and dbias.dtype == torch.float32
    _close(dqkv, _jax_f32(dpi)[..., inv], FP16_RTOL, "dqkv")
    _close(dbias.sum(0), np.asarray(dbp).sum(axis=1).reshape(-1)[inv],
           STATS_RTOL * 10, "dbias")


def _case_k3():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.mlp_fused import _fc2_bwd_call

    dy, w2 = _rand((B, S, 128), 3, 0.5), _rand((128, 256), 4, 0.05)
    h = _rand((B, S, 256), 5, 2.0)
    with pltpu.force_tpu_interpret_mode():
        dh, a, db1 = _fc2_bwd_call(*(jnp.asarray(x, jnp.float16)
                                     for x in (dy, w2.T, h)))
    got = mf.fc2_bwd(_t(dy), _t(w2), _t(h))
    assert got[0].dtype == got[1].dtype == torch.float16
    _close(got[0], _jax_f32(dh), FP16_RTOL, "dh")
    _close(got[1], _jax_f32(a), FP16_RTOL, "a")
    _close(got[2], np.asarray(db1).sum(axis=(0, 1)), STATS_RTOL * 10, "db1")


def _case_k4_k5_k6(kernel):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops import flash_blocked as jfb

    s = 300                                # padded to 512 by the JAX side
    q, k, v, do = (_rand((1, H, s, D), 10 + i) for i in range(4))
    scale = D ** -0.5

    def prep(x):
        return _pad_s(jnp.asarray(x, jnp.float16).reshape(H, s, D), 1,
                      jfb.BLOCK_Q)

    with pltpu.force_tpu_interpret_mode():
        o, lse = jfb._flash_fwd(prep(q), prep(k), prep(v), scale, s)
        dq, dk, dv = jfb._flash_bwd(prep(q), prep(k), prep(v), o, lse,
                                    prep(do), scale, s)
    o_j = _jax_f32(o[:, :s]).reshape(1, H, s, D)
    lse_j = np.asarray(lse[:, :s, 0]).reshape(1, H, s)
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    if kernel == "K4":
        o_p, lse_p = fb.flash_fwd(tq, tk, tv, scale)
        assert o_p.dtype == torch.float16
        _close(o_p, o_j, FP16_RTOL, "o")
        np.testing.assert_allclose(lse_p.numpy(), lse_j, atol=1e-3, rtol=0)
        return
    # the backward from JAX's own o and lse, as its _flash_bwd takes them
    o_t, lse_t = _t(o_j), torch.from_numpy(lse_j)
    delta = fb.flash_delta(o_t, tdo)
    outs = [torch.empty_like(tq) for _ in range(2 if kernel == "K5" else 1)]
    if kernel == "K5":
        fb.flash_bwd_dkdv(tq, tk, tv, tdo, lse_t, delta, *outs, scale)
        want = (dk, dv)
    else:
        fb.flash_bwd_dq(tq, tk, tv, tdo, lse_t, delta, *outs, scale)
        want = (dq,)
    for name, got, w in zip(("d1", "d2"), outs, want):
        _close(got, _jax_f32(w[:, :s]).reshape(1, H, s, D), FP16_RTOL, name)


def _case_k7_k8(kernel):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _bwd_call,
        _fwd_call,
    )

    q, k, v, do = (_rand((B, H, S, D), 20 + i) for i in range(4))
    x = [_pad_s(jnp.asarray(t, jnp.float16).reshape(B * H, S, D), 1, 128)
         for t in (q, k, v, do)]
    with pltpu.force_tpu_interpret_mode():
        o = _fwd_call(*x[:3], D ** -0.5, S)
        grads = _bwd_call(*x, D ** -0.5, S)
    want = [_jax_f32(t[:, :S]).reshape(B, H, S, D) for t in (o, *grads)]
    t = [_t(a) for a in (q, k, v, do)]
    got = [fa.fused_fwd(*t[:3])] if kernel == "K7" else fa.fused_bwd(*t)
    for name, g, w in zip(("o",) if kernel == "K7" else ("dq", "dk", "dv"),
                          got, want if kernel == "K7" else want[1:]):
        assert g.dtype == torch.float16
        _close(g, w, FP16_RTOL, name)


def _case_k9_k10(kernel):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _hp_bwd_call,
        _hp_fwd_call,
    )

    qkv, do = _rand((B, S, 3 * H * D), 30), _rand((B, S, H * D), 31)
    x, g = jnp.asarray(qkv, jnp.float16), jnp.asarray(do, jnp.float16)
    with pltpu.force_tpu_interpret_mode():
        o = _hp_fwd_call(x, D ** -0.5, S, H, D)
        dqkv = _hp_bwd_call(x, g, D ** -0.5, S, H, D)
    if kernel == "K9":
        _close(fa.hp_fwd(_t(qkv), H), _jax_f32(o), FP16_RTOL, "o")
    else:
        _close(fa.hp_bwd(_t(qkv), _t(do), H), _jax_f32(dqkv), FP16_RTOL,
               "dqkv")


def _case_k11_k12(kernel):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _qkv_bwd_call,
        _qkv_fwd_call,
    )

    qkv, do = _rand((B, S, 3, H, D), 40), _rand((B, S, H * D), 41)
    x = _pad_s(jnp.asarray(qkv, jnp.float16).reshape(B, S, 3 * H, D), 1, 128)
    g = _pad_s(jnp.asarray(do, jnp.float16).reshape(B, S, H, D), 1, 128)
    with pltpu.force_tpu_interpret_mode():
        o = _qkv_fwd_call(x, D ** -0.5, S)
        dqkv = _qkv_bwd_call(x, g, D ** -0.5, S)
    if kernel == "K11":
        _close(fa.qkv_fwd(_t(qkv)), _jax_f32(o[:, :S]).reshape(B, S, H * D),
               FP16_RTOL, "o")
    else:
        _close(fa.qkv_bwd(_t(qkv), _t(do)),
               _jax_f32(dqkv[:, :S]).reshape(qkv.shape), FP16_RTOL, "dqkv")


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_versions_match_jax_kernels_fp16(kernel):
    if kernel in ("K1", "K2"):
        _case_k1_k2(kernel)
    elif kernel == "K3":
        _case_k3()
    elif kernel in ("K4", "K5", "K6"):
        _case_k4_k5_k6(kernel)
    elif kernel in ("K7", "K8"):
        _case_k7_k8(kernel)
    elif kernel in ("K9", "K10"):
        _case_k9_k10(kernel)
    else:
        _case_k11_k12(kernel)


# ---- on the card: each fp32 and fp16 instantiation against its plain
# version on the same CUDA tensors

def _card_cases(dev, dtype, shape=(2, 197, 3, 64)):
    """kernel -> (launch through the wrapper, the plain version, the
    wrapper's launch count's name), on seeded (B, S, H, D) = `shape`
    inputs in `dtype`."""
    b, s, h, d = shape
    scale = d ** -0.5

    def r(shape, seed, k=1.0):
        return torch.from_numpy(_rand(shape, seed, k)).to(dev, dtype)

    qkv, do = r((b, s, 3 * h * d), 50), r((b, s, h * d), 51)
    q, k, v = fb.heads(qkv, h)
    dob = do.view(b, s, h, d).transpose(1, 2)
    o1, st = fa.attn_fwd_reference(qkv, h, scale, with_stats=True)
    lq, lk, lv = fb.heads(r((b, 1100, 3 * h * d), 52), h)
    ldo = r((b, 1100, h * d), 53).view(b, 1100, h, d).transpose(1, 2)
    lo, lse = fb.flash_fwd_reference(lq, lk, lv, scale)
    delta = fb.flash_delta(lo, ldo)
    dy, w2, hid = r((b, s, 128), 54, 0.5), r((128, 256), 55, 0.05), \
        r((b, s, 256), 56, 2.0)
    qkv5 = qkv.view(b, s, 3, h, d)

    def dkdv(plain):
        if plain:
            return fb.flash_bwd_dkdv_reference(lq, lk, lv, ldo, lse, delta,
                                               scale)
        outs = [torch.empty_like(lq) for _ in range(2)]
        return fb.flash_bwd_dkdv(lq, lk, lv, ldo, lse, delta, *outs, scale)

    def dq(plain):
        if plain:
            return fb.flash_bwd_dq_reference(lq, lk, lv, ldo, lse, delta,
                                             scale)
        return fb.flash_bwd_dq(lq, lk, lv, ldo, lse, delta,
                               torch.empty_like(lq), scale)

    return {
        "K1": (lambda: fa.attn_fwd(qkv, h, scale, with_stats=True),
               lambda: (o1, st), (fa, "ATTN_FWD_LAUNCHES")),
        "K2": (lambda: fa.attn_bwd(qkv, do, o1, st, h, scale),
               lambda: fa.attn_bwd_reference(qkv, do, o1, st, h, scale),
               (fa, "ATTN_BWD_LAUNCHES")),
        "K3": (lambda: mf.fc2_bwd(dy, w2, hid),
               lambda: mf.fc2_bwd_reference(dy, w2, hid),
               (mf, "FC2_BWD_LAUNCHES")),
        "K4": (lambda: fb.flash_fwd(lq, lk, lv, scale), lambda: (lo, lse),
               (fb, "FLASH_FWD_LAUNCHES")),
        "K5": (lambda: dkdv(False), lambda: dkdv(True),
               (fb, "FLASH_BWD_DKDV_LAUNCHES")),
        "K6": (lambda: (dq(False),), lambda: (dq(True),),
               (fb, "FLASH_BWD_DQ_LAUNCHES")),
        "K7": (lambda: (fa.fused_fwd(q, k, v, scale),),
               lambda: (fa.fused_fwd_reference(q, k, v, scale),),
               (fa, "FUSED_FWD_LAUNCHES")),
        "K8": (lambda: fa.fused_bwd(q, k, v, dob, scale),
               lambda: fa.fused_bwd_reference(q, k, v, dob, scale),
               (fa, "FUSED_BWD_LAUNCHES")),
        "K9": (lambda: (fa.hp_fwd(qkv, h, scale),),
               lambda: (o1,), (fa, "HP_FWD_LAUNCHES")),
        "K10": (lambda: (fa.hp_bwd(qkv, do, h, scale),),
                lambda: (fa.hp_bwd_reference(qkv, do, h, scale),),
                (fa, "HP_BWD_LAUNCHES")),
        "K11": (lambda: (fa.qkv_fwd(qkv5, scale=scale),),
                lambda: (fa.fused_fwd_reference(q, k, v, scale).transpose(
                    1, 2).reshape(b, s, h * d),), (fa, "QKV_FWD_LAUNCHES")),
        "K12": (lambda: (fa.qkv_bwd(qkv5, do, scale=scale),),
                lambda: (fa.hp_bwd_reference(qkv, do, h, scale).view(
                    qkv5.shape),), (fa, "QKV_BWD_LAUNCHES")),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 197, 3, 64), (2, 65, 3, 128),
                                   (2, 63, 3, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernels_fp32_fp16_match_plain_on_cuda(cuda_device, kernel, dtype,
                                               shape):
    # the main shape, and the edges of the fp32 K2's 64-row tiles at both
    # ends of its head dims
    run, plain, (mod, count) = _card_cases(cuda_device, dtype, shape)[kernel]
    before = getattr(mod, count)
    got = run()
    torch.cuda.synchronize()
    assert getattr(mod, count) == before + 1
    want = plain()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (kernel, i)
        assert torch.isfinite(g.float()).all(), (kernel, i)
        err = (g.float() - w.float()).abs().max().item()
        # row stats, lse and bias partials are fp32 in every instantiation
        rel = CUDA_RTOL[dtype] if g.dtype == dtype else \
            CUDA_FP32_OUT_RTOL[dtype]
        assert err <= rel * w.float().abs().max().item(), (kernel, i, err)
