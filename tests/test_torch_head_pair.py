"""The port's head-pair attention (S <= 1024) against the JAX package's.

The JAX side runs the Pallas kernels `_hp_fwd_kernel` (K9) and
`_hp_bwd_kernel` (K10) in interpret mode on the CPU, as
tests/test_pallas_attention.py does. K9's plain version in the port is
`attn_fwd_reference(with_stats=False)`, K1's, because the two TPU kernels
compute o in the same cast order; the first test confirms it. K10's is
`hp_bwd_reference`. Then `fused_attention_qkv_cols` at S = 197 and 130,
value and gradient, against the JAX function, which routes those through
`_hp_partitioned`. The `cuda` cases hold the kernels against their plain
versions through that route on the card and skip without one. The JAX
package is imported inside the JAX helpers, so that the `cuda` cases also
run where flax is missing.

Tolerances, relative to the largest |value| of the JAX side:
* fp32 inputs: 1e-5. Every cast is the identity; only summation order
  differs.
* bf16 inputs: 2e-2. The two share every rounding point (q̂ in K9, bf16(p)
  and ds in K10, the bf16 outputs), but another fp32 summation order can
  flip one of them, which moves an output by a few bf16 ulps.
"""
import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa

H, D = 2, 64
FP32_RTOL = 1e-5
BF16_RTOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rtol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=name)


def _inputs(s, dtype, seed):
    """qkv and dO in `dtype`, and their values as fp32 numpy arrays."""
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(_rand((2, s, 3 * H * D), seed)).to(dt)
    do = torch.from_numpy(_rand((2, s, H * D), seed + 1)).to(dt)
    return qkv, do, qkv.float().numpy(), do.float().numpy()


def _jax_hp(qkv, do, bf16):
    """JAX `_hp_fwd_call` and `_hp_bwd_call` in interpret mode."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _hp_bwd_call,
        _hp_fwd_call,
    )

    dt = jnp.bfloat16 if bf16 else jnp.float32
    x, g = jnp.asarray(qkv, dt), jnp.asarray(do, dt)
    s = qkv.shape[1]
    with pltpu.force_tpu_interpret_mode():
        o = _hp_fwd_call(x, D ** -0.5, s, H, D)
        dqkv = _hp_bwd_call(x, g, D ** -0.5, s, H, D)
    return (np.asarray(o.astype(jnp.float32)),
            np.asarray(dqkv.astype(jnp.float32)))


@pytest.mark.parametrize("s", [197, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax_hp_kernels(dtype, s):
    qkv, do, qkv_np, do_np = _inputs(s, dtype, seed=s)
    want_o, want_dqkv = _jax_hp(qkv_np, do_np, dtype == "bfloat16")
    rtol = BF16_RTOL if dtype == "bfloat16" else FP32_RTOL
    before = (fa.HP_FWD_LAUNCHES, fa.HP_BWD_LAUNCHES)
    o = fa.hp_fwd(qkv, H)
    # K9's plain version is K1's without stats
    assert torch.equal(o, fa.attn_fwd_reference(qkv, H, D ** -0.5)[0])
    dqkv = fa.hp_bwd(qkv, do, H)
    assert (fa.HP_FWD_LAUNCHES, fa.HP_BWD_LAUNCHES) == before
    assert o.dtype == dqkv.dtype == qkv.dtype
    assert o.shape == (2, s, H * D) and dqkv.shape == qkv.shape
    _close(o.float(), want_o, rtol, "o")
    for i, name in enumerate(("dq", "dk", "dv")):
        cols = slice(i * H * D, (i + 1) * H * D)
        _close(dqkv.float()[..., cols], want_dqkv[..., cols], rtol, name)


@pytest.mark.parametrize("s", [197, 130])
def test_qkv_cols_matches_jax_fp32(s):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        fused_attention_qkv_cols as jax_qkv_cols,
    )

    qkv = _rand((2, s, 3 * H * D), s + 7)
    do = _rand((2, s, H * D), s + 8)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda x: jax_qkv_cols(x, H), jnp.asarray(qkv))
        (want_g,) = vjp(jnp.asarray(do))
    x = torch.from_numpy(qkv).requires_grad_()
    got = fa.fused_attention_qkv_cols(x, H)
    assert type(got.grad_fn).__name__ == "HeadPairAttentionBackward"
    got.backward(torch.from_numpy(do))
    assert got.shape == (2, s, H * D)
    _close(got.detach(), np.asarray(want), FP32_RTOL, "o")
    _close(x.grad, np.asarray(want_g), FP32_RTOL, "dqkv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_cols_wide_heads_match_jax(dtype):
    # F8: 2 heads of 192 at S = 197, a head dim JAX's head-pair kernels
    # take (a multiple of 64, an even head count), through the head-pair
    # route; the JAX function in interpret mode, the port's plain versions
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        fused_attention_qkv_cols as jax_qkv_cols,
    )

    b, s, d = 1, 197, 192
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(_rand((b, s, 3 * H * d), 41)).to(dt)
    do = torch.from_numpy(_rand((b, s, H * d), 42)).to(dt)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda x: jax_qkv_cols(x, H),
                            jnp.asarray(qkv.float().numpy(), jdt))
        (want_g,) = vjp(jnp.asarray(do.float().numpy(), jdt))
    x = qkv.clone().requires_grad_()
    got = fa.fused_attention_qkv_cols(x, H)
    assert type(got.grad_fn).__name__ == "HeadPairAttentionBackward"
    got.backward(do)
    assert got.shape == (b, s, H * d) and x.grad.dtype == dt
    rtol = BF16_RTOL if dtype == "bfloat16" else FP32_RTOL
    _close(got.detach().float(), np.asarray(want.astype(jnp.float32)), rtol,
           "o")
    _close(x.grad.float(), np.asarray(want_g.astype(jnp.float32)), rtol,
           "dqkv")


def test_hp_bwd_refuses_a_do_that_does_not_fit():
    qkv = torch.zeros((1, 10, 3 * H * D))
    with pytest.raises(ValueError, match="does not fit"):
        fa.hp_bwd(qkv, torch.zeros((1, 9, H * D)), H)
    with pytest.raises(ValueError, match="not 3 x"):
        fa.hp_bwd(torch.zeros((1, 10, 100)), torch.zeros((1, 10, 32)), H)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 197, 12, 64), (1, 1024, 2, 64),
                                   (3, 77, 3, 48), (2, 130, 2, 128)])
def test_kernels_match_plain_through_qkv_cols(cuda_device, shape):
    # same bf16 inputs and cast order: o as K1's test, the grads by a
    # flipped bf16 rounding of ds or of a stored gradient
    b, s, h, d = shape
    qkv = torch.from_numpy(_rand((b, s, 3 * h * d), 31)).to(
        cuda_device, torch.bfloat16).requires_grad_()
    do = torch.from_numpy(_rand((b, s, h * d), 32)).to(cuda_device,
                                                       torch.bfloat16)
    before = (fa.HP_FWD_LAUNCHES, fa.HP_BWD_LAUNCHES, fa.ATTN_FWD_LAUNCHES)
    o = fa.fused_attention_qkv_cols(qkv, h)
    o.backward(do)
    torch.cuda.synchronize()
    assert (fa.HP_FWD_LAUNCHES, fa.HP_BWD_LAUNCHES, fa.ATTN_FWD_LAUNCHES) \
        == (before[0] + 1, before[1] + 1, before[2])
    x = qkv.detach()
    o_r = fa.attn_fwd_reference(x, h, d ** -0.5)[0]
    assert (o.float() - o_r.float()).abs().max().item() <= 2e-2
    g_r = fa.hp_bwd_reference(x, do, h, d ** -0.5)
    err = (qkv.grad.float() - g_r.float()).abs().max().item()
    assert err <= 2e-2 * g_r.float().abs().max().item()


@pytest.mark.cuda
def test_hp_kernels_contract_on_cuda(cuda_device):
    x = torch.zeros((1, 64, 3 * H * D), device=cuda_device,
                    dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        fa.hp_fwd(x, H)
    # fp32 is a kernel dtype: K9's and K10's fp32 instantiations launch and
    # match their plain versions (summation order only)
    qkv = torch.from_numpy(_rand((1, 64, 3 * H * D), 96)).to(cuda_device)
    do = torch.from_numpy(_rand((1, 64, H * D), 95)).to(cuda_device)
    before = (fa.HP_FWD_LAUNCHES, fa.HP_BWD_LAUNCHES)
    o, g = fa.hp_fwd(qkv, H), fa.hp_bwd(qkv, do, H)
    torch.cuda.synchronize()
    assert (fa.HP_FWD_LAUNCHES, fa.HP_BWD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    _close(o.cpu(), fa.attn_fwd_reference(qkv, H, D ** -0.5)[0].cpu(), 1e-4)
    _close(g.cpu(), fa.hp_bwd_reference(qkv, do, H, D ** -0.5).cpu(), 1e-4)
    # past the CUDA-core kernels' head dim it raises (over 128 it runs:
    # test_wide_heads_hp_match_plain_on_cuda)
    wide = fa.MAX_CUDA_CORE_HEAD_DIM + 2
    y = torch.zeros((1, 64, 3 * H * wide), device=cuda_device,
                    dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.hp_bwd(y, torch.zeros((1, 64, H * wide), device=cuda_device,
                                 dtype=torch.bfloat16), H)


# F8: head dims over 128 through fused_attention_qkv_cols at S <= 1024. K9
# and K10 run the wide tensor-core tiles up to 256 in bf16 and fp16 (two
# calls bitwise equal), the CUDA cores in fp32 and past 256; o and dqkv to
# WIDE_REL of their largest value (as tests/test_torch_fused_attention.py's
# wide heads)
WIDE_REL = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [
    (dt, d) for dt in ("bfloat16", "float16") for d in (136, 192, 256)] + [
    (dt, 320) for dt in ("bfloat16", "float16", "float32")] + [
    ("float32", 192), ("bfloat16", 1024)])
def test_wide_heads_hp_match_plain_on_cuda(cuda_device, dtype, d):
    b, s, h = 2, 197, 2
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(_rand((b, s, 3 * h * d), 80)).to(cuda_device, dt)
    do = torch.from_numpy(_rand((b, s, h * d), 81)).to(cuda_device, dt)
    route = "tensor_cores" if dtype != "float32" and \
        d <= fa.MAX_WIDE_HEAD_DIM else "cuda_cores"
    assert fa.attn_kernel_route(qkv, h) == route
    assert fa.bwd_kernel_route(*fa.heads(qkv, h), fa._head_major(do, h)) == \
        route
    x = qkv.clone().requires_grad_()
    before = (fa.HP_FWD_LAUNCHES, fa.HP_BWD_LAUNCHES)
    o = fa.fused_attention_qkv_cols(x, h)
    o.backward(do)
    again = fa.hp_bwd(qkv, do, h)
    torch.cuda.synchronize()
    assert (fa.HP_FWD_LAUNCHES, fa.HP_BWD_LAUNCHES) == \
        (before[0] + 1, before[1] + 2)
    assert torch.equal(x.grad, again)
    rel = WIDE_REL[dtype]
    o_r = fa.attn_fwd_reference(qkv, h, d ** -0.5)[0]
    g_r = fa.hp_bwd_reference(qkv, do, h, d ** -0.5)
    for got, want in ((o, o_r), (x.grad, g_r)):
        assert got.dtype == dt
        err = (got.float() - want.float()).abs().max().item()
        assert err <= rel * want.float().abs().max().item()
