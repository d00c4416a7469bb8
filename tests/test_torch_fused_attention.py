"""The port's op-level fused attention against the JAX package's.

The JAX side runs the Pallas kernels `_fwd_kernel` (K7), `_bwd_kernel`
(K8), `_qkv_fwd_kernel` (K11) and `_qkv_bwd_kernel` (K12) in interpret mode
on the CPU, as tests/test_pallas_attention.py does, on inputs padded to
S = 128·n as the JAX entry points pad them. The port's kernels take no
padding; its wrappers run their plain versions for CPU tensors:
`fused_fwd_reference` for K7 and K11, `fused_bwd_reference` for K8 and K12.
Then the entry points `fused_attention`, `fused_attention_qkv` and
`multi_head_attention` (both routes), value and gradients, against the JAX
functions, with S = 1100 on the plain route of both, and `masked_attention`
and `attention_bshd` against theirs. `fused_kernel_route` picks K7's and
K11's kernel from dtype, layout and head dim on CPU tensors ('cuda_cores'
in every dtype past the tensor cores' head dim of 128, whose values and
gradients match JAX's kernels at D = 136 and 192), and 'reference' for S >
1024, which both entry points then run on `reference_attention`, as JAX
does. The `cuda` cases hold the kernels against their plain versions on
the card (the tensor-core K7 and K11 in bf16 and fp16 at the edges of their
128-row tiles, copying exactly where the route says; the CUDA-core K7, K8,
K11 and K12 at head dims over 128 in every dtype) and skip without one. The JAX
package is imported inside the JAX helpers, so that the `cuda` cases also
run where flax is missing.

Tolerances, relative to the largest |value| of the JAX side:
* fp32 inputs: 1e-5. Every cast is the identity; only summation order
  differs.
* bf16 inputs: 2e-2. The two share every rounding point (bf16(p) after the
  fp32 normalisation, ds, the bf16 outputs), but another fp32 summation
  order can flip one of them, which moves an output by a few bf16 ulps.

The cast order is K7's, not K1's: at D = 48 in bf16 (seed 100, (B, H, S) =
(1, 2, 197)) the port's plain K7 is off JAX K7 by at most 2.4e-4 and differs
in 0.02% of the outputs, where K1's plain version (`attn_fwd_reference`:
bf16(q·scale), p cast before it is normalised) is off by 2.0e-3 and differs
in 55% of them.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ops import attention as at
from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa
from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked as fb

# (B, H, S, D): S ragged against the TPU's 128 and not; D = 48 is not a
# multiple of 64, D = 128 is a whole lane row
SHAPES = [(1, 2, 197, 64), (2, 3, 130, 48), (1, 1, 128, 128)]
FP32_RTOL = 1e-5
BF16_RTOL = 2e-2
COUNTS = ("FUSED_FWD_LAUNCHES", "FUSED_BWD_LAUNCHES", "QKV_FWD_LAUNCHES",
          "QKV_BWD_LAUNCHES")


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


def _counts():
    return tuple(getattr(fa, c) for c in COUNTS)


def _f32(x):
    import jax.numpy as jnp

    return np.asarray(x.astype(jnp.float32))


def _pad_s(x, axis):
    """Pad the sequence axis to a multiple of 128, as the JAX entry points
    do (:873-875, :889-897)."""
    import jax.numpy as jnp

    s = x.shape[axis]
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, -(-s // 128) * 128 - s)
    return jnp.pad(x, widths)


def _jax_k7_k8(q, k, v, do, bf16):
    """JAX `_fwd_call` and `_bwd_call` in interpret mode on (B, H, S, D)
    inputs -> o, dq, dk, dv (B, H, S, D)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _bwd_call,
        _fwd_call,
    )

    b, h, s, d = q.shape
    dt = jnp.bfloat16 if bf16 else jnp.float32
    x = [_pad_s(jnp.asarray(t, dt).reshape(b * h, s, d), 1)
         for t in (q, k, v, do)]
    with pltpu.force_tpu_interpret_mode():
        o = _fwd_call(*x[:3], d ** -0.5, s)
        grads = _bwd_call(*x, d ** -0.5, s)
    return [_f32(t[:, :s]).reshape(b, h, s, d) for t in (o, *grads)]


def _jax_k11_k12(qkv, do, bf16):
    """JAX `_qkv_fwd_call` and `_qkv_bwd_call` in interpret mode on a
    (B, S, 3, H, D) qkv and (B, S, H·D) dO -> o (B, S, H·D), dqkv (B, S, 3,
    H, D)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _qkv_bwd_call,
        _qkv_fwd_call,
    )

    b, s, _, h, d = qkv.shape
    dt = jnp.bfloat16 if bf16 else jnp.float32
    x = _pad_s(jnp.asarray(qkv, dt).reshape(b, s, 3 * h, d), 1)
    g = _pad_s(jnp.asarray(do, dt).reshape(b, s, h, d), 1)
    with pltpu.force_tpu_interpret_mode():
        o = _qkv_fwd_call(x, d ** -0.5, s)
        dqkv = _qkv_bwd_call(x, g, d ** -0.5, s)
    return (_f32(o[:, :s]).reshape(b, s, h * d),
            _f32(dqkv[:, :s]).reshape(qkv.shape))


def _jax_k7_fwd(q, k, v):
    """JAX `_fwd_call` in interpret mode on fp32 (B, H, S, D) q, k, v -> o
    (B, H, S, D)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _fwd_call,
    )

    b, h, s, d = q.shape
    x = [_pad_s(jnp.asarray(t).reshape(b * h, s, d), 1) for t in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        o = _fwd_call(*x, d ** -0.5, s)
    return _f32(o[:, :s]).reshape(b, h, s, d)


def _jax_k11_fwd(qkv):
    """JAX `_qkv_fwd_call` in interpret mode on an fp32 (B, S, 3, H, D) qkv
    -> o (B, S, H·D)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _qkv_fwd_call,
    )

    b, s, _, h, d = qkv.shape
    x = _pad_s(jnp.asarray(qkv).reshape(b, s, 3 * h, d), 1)
    with pltpu.force_tpu_interpret_mode():
        o = _qkv_fwd_call(x, d ** -0.5, s)
    return _f32(o[:, :s]).reshape(b, s, h * d)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k7_k8_match_jax_kernels(dtype, shape):
    b, h, s, d = shape
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(_rand(shape, 10 * s + i)).to(dt)
                   for i in range(4))
    want = _jax_k7_k8(*(t.float().numpy() for t in (q, k, v, do)),
                      dtype == "bfloat16")
    rtol = BF16_RTOL if dtype == "bfloat16" else FP32_RTOL
    before = _counts()
    o = fa.fused_fwd(q, k, v)
    grads = fa.fused_bwd(q, k, v, do)
    assert _counts() == before
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
        assert got.dtype == dt and got.shape == shape
        _close(got.float(), w, rtol, name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k11_k12_match_jax_kernels(dtype, shape):
    b, h, s, d = shape
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(_rand((b, s, 3, h, d), 20 * s)).to(dt)
    do = torch.from_numpy(_rand((b, s, h * d), 20 * s + 1)).to(dt)
    want_o, want_g = _jax_k11_k12(qkv.float().numpy(), do.float().numpy(),
                                  dtype == "bfloat16")
    rtol = BF16_RTOL if dtype == "bfloat16" else FP32_RTOL
    before = _counts()
    o = fa.qkv_fwd(qkv)
    dqkv = fa.qkv_bwd(qkv, do)
    # the (B, S, 3·H·D) view of the same buffer gives the same results
    flat = qkv.reshape(b, s, 3 * h * d)
    assert torch.equal(fa.qkv_fwd(flat, h), o)
    assert torch.equal(fa.qkv_bwd(flat, do, h), dqkv.reshape(flat.shape))
    assert _counts() == before
    assert o.dtype == dqkv.dtype == dt
    assert o.shape == (b, s, h * d) and dqkv.shape == qkv.shape
    _close(o.float(), want_o, rtol, "o")
    for i, name in enumerate(("dq", "dk", "dv")):
        _close(dqkv.float()[:, :, i], want_g[:, :, i], rtol, name)


# The fp32 K7 and K11 at the edges of csrc/attn_fwd_simt.cuh's register
# tiles: S around one 64-row query and key tile, the model's 197 and the
# contract's 1024; head dims on the narrow tiles (48 runs at 64 with zero
# columns) and the wide ones (136 at 192, 256)
FP32_K7_EDGE_S = (1, 64, 65, 197, 1024)
FP32_K7_EDGE_D = (48, 64, 136, 256)


@pytest.mark.parametrize("d", FP32_K7_EDGE_D)
@pytest.mark.parametrize("s", FP32_K7_EDGE_S)
def test_fp32_plain_k7_k11_match_jax_at_tile_edges(s, d):
    b, h = 1, 2
    qkv = torch.from_numpy(_rand((b, s, 3, h, d), 50 * s + d))
    q, k, v = (t.contiguous() for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))
    before = _counts()
    o7 = fa.fused_fwd(q, k, v)
    o11 = fa.qkv_fwd(qkv)
    assert _counts() == before
    _close(o7, _jax_k7_fwd(q.numpy(), k.numpy(), v.numpy()), FP32_RTOL,
           "K7 o")
    _close(o11, _jax_k11_fwd(qkv.numpy()), FP32_RTOL, "K11 o")


def test_bf16_d48_cast_order_is_k7s():
    b, h, s, d = 1, 2, 197, 48
    qkv = torch.from_numpy(_rand((b, s, 3, h, d), 100)).to(torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    want = _jax_k7_k8(*(t.float().numpy() for t in (q, k, v, q)), True)[0]
    port = fa.fused_fwd_reference(q, k, v, d ** -0.5).float().numpy()
    k1 = fa.attn_fwd_reference(qkv.reshape(b, s, 3 * h * d), h, d ** -0.5)[0]
    k1 = k1.float().reshape(b, s, h, d).transpose(1, 2).numpy()
    port_err, k1_err = np.abs(port - want).max(), np.abs(k1 - want).max()
    port_diff, k1_diff = (port != want).mean(), (k1 != want).mean()
    assert port_err <= k1_err / 4, (port_err, k1_err)
    assert port_diff <= 0.01 and k1_diff >= 0.3, (port_diff, k1_diff)


@pytest.mark.parametrize("s", [197, 1100])
def test_fused_attention_matches_jax_fp32(s):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        fused_attention as jax_fused_attention,
    )

    shape = (1, 2, s, 32 if s > fa.MAX_SEQ else 64)
    q, k, v, do = (_rand(shape, s + i) for i in range(4))
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax_fused_attention,
                            *(jnp.asarray(t) for t in (q, k, v)))
        want_g = vjp(jnp.asarray(do))
    x = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    before = _counts()
    got = fa.fused_attention(*x)
    grad_fn = type(got.grad_fn).__name__
    assert (grad_fn == "FusedAttentionBackward") == (s <= fa.MAX_SEQ)
    got.backward(torch.from_numpy(do))
    assert _counts() == before
    _close(got.detach(), np.asarray(want), FP32_RTOL, "o")
    for name, t, w in zip(("dq", "dk", "dv"), x, want_g):
        _close(t.grad, np.asarray(w), FP32_RTOL, name)


@pytest.mark.parametrize("s", [197, 1100])
def test_fused_attention_qkv_matches_jax_fp32(s):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        fused_attention_qkv as jax_fused_attention_qkv,
    )

    h, d = 2, (32 if s > fa.MAX_SEQ else 64)
    qkv = _rand((1, s, 3, h, d), s + 5)
    do = _rand((1, s, h * d), s + 6)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax_fused_attention_qkv, jnp.asarray(qkv))
        (want_g,) = vjp(jnp.asarray(do))
    x = torch.from_numpy(qkv).requires_grad_()
    before = _counts()
    got = fa.fused_attention_qkv(x)
    grad_fn = type(got.grad_fn).__name__
    assert (grad_fn == "FusedAttentionQkvBackward") == (s <= fa.MAX_SEQ)
    got.backward(torch.from_numpy(do))
    assert _counts() == before
    assert got.shape == (1, s, h * d)
    _close(got.detach(), np.asarray(want), FP32_RTOL, "o")
    _close(x.grad, np.asarray(want_g), FP32_RTOL, "dqkv")


@pytest.mark.parametrize("entry", ["fused_attention", "fused_attention_qkv"])
@pytest.mark.parametrize("d", [136, 192, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_heads_take_the_kernels_and_match_jax(dtype, entry, d):
    # F8: a head dim over 128 at S <= 1024, which JAX pads to a multiple of
    # 8 and runs in its kernels, runs the port's autograd Function on the
    # wide tensor-core tiles in bf16, the CUDA cores in fp32 (here their
    # plain versions), with values and gradients as JAX's
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops import flash_attention as jfa

    b, h, s = 1, 2, 40
    dt = getattr(torch, dtype)
    if entry == "fused_attention":
        ins = [_rand((b, h, s, d), d + i) for i in range(3)]
        do = _rand((b, h, s, d), d + 3)
    else:
        ins = [_rand((b, s, 3, h, d), d + 4)]
        do = _rand((b, s, h * d), d + 5)
    x = [torch.from_numpy(t).to(dt).requires_grad_() for t in ins]
    g = torch.from_numpy(do).to(dt)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(getattr(jfa, entry),
                            *(jnp.asarray(t.detach().float().numpy(), jdt)
                              for t in x))
        want_g = vjp(jnp.asarray(g.float().numpy(), jdt))
    views = x if len(x) == 3 else x[0].permute(2, 0, 3, 1, 4).unbind(0)
    route = "cuda_cores" if dtype == "float32" else "tensor_cores"
    assert fa.fused_kernel_route(*views) == route
    assert fa.bwd_kernel_route(*views, views[0]) == route
    before = _counts()
    got = getattr(fa, entry)(*x)
    assert type(got.grad_fn).__name__.startswith("Fused")
    got.backward(g)
    assert _counts() == before
    rtol = BF16_RTOL if dtype == "bfloat16" else FP32_RTOL
    _close(got.detach().float(), _f32(want), rtol, "o")
    for i, (t, w) in enumerate(zip(x, want_g)):
        assert t.grad.dtype == dt
        _close(t.grad.float(), _f32(w), rtol, f"grad {i}")


@pytest.mark.parametrize("use_pallas", [True, False])
def test_multi_head_attention_matches_jax(use_pallas):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.attention import (
        multi_head_attention as jax_mha,
    )
    from vision_transformers_torch_xla_tpu_torch.ops import (
        multi_head_attention,
    )

    shape = (2, 3, 130, 48)
    q, k, v, do = (_rand(shape, 40 + i) for i in range(4))
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda *t: jax_mha(*t, scale=0.2, use_pallas=use_pallas),
            *(jnp.asarray(t) for t in (q, k, v)))
        want_g = vjp(jnp.asarray(do))
    x = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = multi_head_attention(*x, scale=0.2, use_pallas=use_pallas)
    assert (type(got.grad_fn).__name__ == "FusedAttentionBackward") \
        == use_pallas
    got.backward(torch.from_numpy(do))
    _close(got.detach(), np.asarray(want), FP32_RTOL, "o")
    for name, t, w in zip(("dq", "dk", "dv"), x, want_g):
        _close(t.grad, np.asarray(w), FP32_RTOL, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_and_bshd_attention_match_jax(dtype):
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.ops.attention import (
        attention_bshd as jax_bshd,
        masked_attention as jax_masked,
    )

    b, h, s, d = 2, 3, 37, 32
    q, k, v = (_rand((b, h, s, d), 50 + i) for i in range(3))
    # additive mask broadcast over heads, with whole columns masked out
    mask = np.where(_rand((b, 1, s, s), 53) > 1.0, -1e9, 0.0).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    rtol = BF16_RTOL if dtype == "bfloat16" else FP32_RTOL
    jx = [jnp.asarray(t, jdt) for t in (q, k, v)]
    tx = [torch.from_numpy(t).to(tdt) for t in (q, k, v)]
    got = at.masked_attention(*tx, torch.from_numpy(mask))
    assert got.dtype == tdt
    _close(got.float(), _f32(jax_masked(*jx, jnp.asarray(mask))), rtol,
           "masked")
    # the (B, S, H, D) layout
    jt = [t.transpose(0, 2, 1, 3) for t in jx]
    tt = [t.transpose(1, 2) for t in tx]
    got = at.attention_bshd(*tt, scale=0.3)
    assert got.shape == (b, s, h, d) and got.dtype == tdt
    _close(got.float(), _f32(jax_bshd(*jt, scale=0.3)), rtol, "bshd")


def test_ops_exports_multi_head_attention():
    from vision_transformers_torch_xla_tpu_torch import ops

    assert ops.multi_head_attention is at.multi_head_attention


def test_fused_wrappers_refuse_what_does_not_fit():
    x = torch.zeros((1, 2, 10, 8))
    with pytest.raises(ValueError, match="one shape"):
        fa.fused_fwd(x, torch.zeros((1, 2, 9, 8)), x)
    with pytest.raises(ValueError, match="one shape"):
        fa.fused_bwd(x, x, x, torch.zeros((1, 2, 10)))
    with pytest.raises(ValueError, match="neither"):
        fa.qkv_fwd(torch.zeros((1, 10, 2, 2, 8)))
    with pytest.raises(ValueError, match="neither"):
        fa.qkv_fwd(torch.zeros((1, 10, 48)))
    with pytest.raises(ValueError, match="not 3 x"):
        fa.qkv_fwd(torch.zeros((1, 10, 50)), 2)
    with pytest.raises(ValueError, match="does not fit"):
        fa.qkv_bwd(torch.zeros((1, 10, 3, 2, 8)), torch.zeros((1, 10, 8)))
    with pytest.raises(ValueError, match=r"\(B, S, 3, H, D\)"):
        fa.fused_attention_qkv(torch.zeros((1, 10, 2, 2, 8)))


def _stand_in(record, scale):
    """One strided kernel launch, played on the CPU by the plain version:
    records the (B, H, S, D) it is handed and whether it got strides."""
    def launch(ins, outs, strides):
        record.append((tuple(ins[0].shape), strides is not None))
        outs[0].copy_(fa.fused_fwd_reference(*ins, scale))
    return launch


def _views(case):
    """(B, H, S, D) q, k, v for each case of `_launch_views`."""
    if case == "odd_head_dim":                  # G2: D = 7
        return [torch.from_numpy(_rand((2, 3, 10, 7), 80 + i))
                for i in range(3)]
    if case == "odd_row_stride":                # G3: rows 9 apart
        return [torch.from_numpy(_rand((2, 3, 10, 9), 80 + i))[..., :8]
                for i in range(3)]
    if case == "head_dim_not_contiguous":       # G3
        return [torch.from_numpy(_rand((2, 3, 8, 10), 80 + i)).transpose(
            -1, -2) for i in range(3)]
    if case == "odd_offset":                    # G3: data 2-byte aligned
        return [torch.from_numpy(_rand((2 * 3 * 10 * 8 + 1,), 80 + i))
                .to(torch.bfloat16)[1:].view(2, 3, 10, 8) for i in range(3)]
    return [torch.from_numpy(_rand((5, 3, 10, 8), 80 + i))   # in place
            for i in range(3)]


@pytest.mark.parametrize("case", ["odd_head_dim", "odd_row_stride",
                                  "head_dim_not_contiguous", "odd_offset",
                                  "in_place"])
def test_launch_views_repairs_what_the_kernels_do_not_take(case):
    # G2 and G3 of the op-level kernels on the CPU, the launch played by
    # the plain version: views the kernels cannot read in place are copied
    # once (`padded_copy`) with the head dim padded to even and the result
    # sliced back
    q, k, v = _views(case)
    b, h, s, d = q.shape
    o = torch.full((b, h, s, d), float("nan"), dtype=q.dtype)
    record, before = [], fb.COPIES
    fa._launch_views(_stand_in(record, 0.125), (q, k, v), (o,), "test")
    torch.testing.assert_close(o, fa.fused_fwd_reference(q, k, v, 0.125),
                               rtol=0, atol=1e-6)
    assert fb.COPIES == before + (case != "in_place")
    assert record == [((b, h, s, d + d % 2), True)]


def _route_case(case):
    """(B, H, S, D) q, k, v on the CPU for each case of `fused_kernel_route`."""
    dt = torch.float32 if case == "fp32" else (
        torch.float16 if case == "fp16" else torch.bfloat16)
    d = {"d48": 48, "d6": 6, "odd_d": 7, "d136": 136, "fp16_d256": 256,
         "fp32_d192": 192, "d320": 320, "fp16_d320": 320, "d137": 137
         }.get(case, 64)
    if case == "fp32_d192":
        dt = torch.float32
    if case in ("fp16_d256", "fp16_d320"):
        dt = torch.float16
    if case == "s1100":
        return [torch.zeros((1, 2, 1100, d), dtype=dt) for _ in range(3)]
    if case == "qkv_views":
        qkv = torch.zeros((2, 10, 3, 4, d), dtype=dt)
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)
    q, k, v = (torch.zeros((2, 4, 10, d), dtype=dt) for _ in range(3))
    if case == "layouts_differ":
        k = torch.zeros((2, 10, 4, d), dtype=dt).transpose(1, 2)
    if case == "unaligned":
        n = q.numel()
        q, k, v = (torch.zeros(n + 1, dtype=dt)[1:].view(q.shape)
                   for _ in range(3))
    return q, k, v


@pytest.mark.parametrize("case, route", [
    ("fp32", "cuda_cores"), ("bf16", "tensor_cores"),
    ("fp16", "tensor_cores"), ("qkv_views", "tensor_cores"),
    ("d48", "tensor_cores"), ("d6", "tensor_cores_copy"),
    ("odd_d", "tensor_cores_copy"), ("layouts_differ", "tensor_cores_copy"),
    ("unaligned", "tensor_cores_copy"), ("d136", "tensor_cores"),
    ("fp16_d256", "tensor_cores"), ("fp32_d192", "cuda_cores"),
    ("d137", "tensor_cores_copy"), ("d320", "cuda_cores"),
    ("fp16_d320", "cuda_cores"), ("s1100", "reference")])
def test_fused_kernel_route(case, route):
    # fp32 stays on the CUDA cores; bf16 and fp16 take the tensor cores,
    # in place where TMA reads q, k, v (one layout, a head dim that is a
    # multiple of 8, 16-byte-aligned data and strides), else after a copy,
    # up to a head dim of 256 (the wide tiles); a wider one takes the CUDA
    # cores in every dtype; past the kernels' S the entry points take
    # reference_attention, as JAX's do
    assert fa.fused_kernel_route(*_route_case(case)) == route


def _bwd_route_case(case):
    """(B, H, S, D) q, k, v, dO on the CPU for each case of
    `bwd_kernel_route`."""
    if case == "qkv_views":        # K12's and K10's layouts
        q, k, v = _route_case(case)
        b, h, s, d = q.shape
        do = torch.zeros((b, s, h * d), dtype=q.dtype).view(
            b, s, h, d).transpose(1, 2)
        return q, k, v, do
    if case == "do_unaligned":
        q, k, v = _route_case("bf16")
        do = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
        return q, k, v, do
    q, k, v = _route_case(case)
    return q, k, v, torch.zeros(q.shape, dtype=q.dtype)


@pytest.mark.parametrize("case, route", [
    ("fp32", "cuda_cores"), ("bf16", "tensor_cores"),
    ("fp16", "tensor_cores"), ("qkv_views", "tensor_cores"),
    ("d48", "tensor_cores"), ("d6", "tensor_cores_copy"),
    ("odd_d", "tensor_cores_copy"), ("layouts_differ", "tensor_cores_copy"),
    ("do_unaligned", "tensor_cores_copy"), ("d136", "tensor_cores"),
    ("fp16_d256", "tensor_cores"), ("fp32_d192", "cuda_cores"),
    ("d137", "tensor_cores_copy"), ("d320", "cuda_cores"),
    ("fp16_d320", "cuda_cores"), ("s1100", "reference")])
def test_bwd_kernel_route(case, route):
    # K8, K10 and K12: fp32 stays on the CUDA cores; bf16 and fp16 take the
    # tensor cores, in place where TMA reads q, k, v (one layout) and dO (its
    # own), else after one copy of all four, up to a head dim of 256; a
    # wider one takes the CUDA cores in every dtype; past the kernels' S,
    # the gradient of reference_attention
    assert fa.bwd_kernel_route(*_bwd_route_case(case)) == route


def _plain_check(o, grads, q, k, v, do, scale):
    """The kernels' o and (dq, dk, dv) against the plain versions on the same
    bf16 inputs: o as K1's test, the grads by a flipped bf16 rounding of ds
    or of a stored gradient."""
    o_r = fa.fused_fwd_reference(q, k, v, scale)
    assert (o.float() - o_r.float()).abs().max().item() <= 2e-2
    for g, g_r in zip(grads, fa.fused_bwd_reference(q, k, v, do, scale)):
        err = (g.float() - g_r.float()).abs().max().item()
        assert err <= 2e-2 * g_r.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 197, 64), (1, 2, 1024, 64),
                                   (3, 3, 130, 48), (2, 2, 77, 128)])
def test_kernels_match_plain_on_cuda(cuda_device, shape):
    b, h, s, d = shape
    q, k, v = (torch.from_numpy(_rand(shape, 60 + i)).to(
        cuda_device, torch.bfloat16).requires_grad_() for i in range(3))
    do = torch.from_numpy(_rand(shape, 63)).to(cuda_device, torch.bfloat16)
    before = _counts()
    o = fa.fused_attention(q, k, v)
    o.backward(do)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, *before[2:])
    x = [t.detach() for t in (q, k, v)]
    _plain_check(o, [t.grad for t in (q, k, v)], *x, do, d ** -0.5)
    # K11 and K12 on a (B, S, 3, H, D) buffer holding the same heads
    qkv = torch.stack([t.transpose(1, 2) for t in x], dim=2)
    qkv.requires_grad_()
    do2 = do.transpose(1, 2).reshape(b, s, h * d)
    o2 = fa.fused_attention_qkv(qkv)
    o2.backward(do2)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1,
                         before[3] + 1)
    grads = qkv.grad.permute(2, 0, 3, 1, 4).unbind(0)
    _plain_check(o2.view(b, s, h, d).transpose(1, 2), grads, *x, do,
                 d ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 64, 128])
@pytest.mark.parametrize("s", [17, 128, 129, 197, 256, 257, 1024])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tensor_core_k7_k11_match_plain_on_cuda(cuda_device, dtype, s, d):
    # one and two 128-key tiles and their ragged edges, up to the contract's
    # S = 1024: K7 on separate (B, H, S, D) q, k, v and K11 on a (B, S, 3,
    # H, D) buffer holding the same heads, o as K1's test holds it
    b, h = 2, 3
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(_rand((b, s, 3, h, d), 30 * s + d)).to(
        cuda_device, dt)
    q, k, v = (t.contiguous() for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))
    o_r = fa.fused_fwd_reference(q, k, v, d ** -0.5)
    for count, run, ins in (
            ("FUSED_FWD_LAUNCHES", lambda: fa.fused_fwd(q, k, v), (q, k, v)),
            ("QKV_FWD_LAUNCHES", lambda: fa.qkv_fwd(qkv).view(
                b, s, h, d).transpose(1, 2),
             qkv.permute(2, 0, 3, 1, 4).unbind(0))):
        before, copies = getattr(fa, count), fb.COPIES
        o = run()
        torch.cuda.synchronize()
        assert getattr(fa, count) == before + 1
        assert fb.COPIES - copies == int(
            fa.fused_kernel_route(*ins) == "tensor_cores_copy")
        assert o.dtype == dt and torch.isfinite(o.float()).all()
        assert (o.float() - o_r.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 64, 128])
@pytest.mark.parametrize("s", [17, 64, 65, 128, 129, 197, 256, 257, 1024])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tensor_core_k8_k10_k12_match_plain_on_cuda(cuda_device, monkeypatch,
                                                    dtype, s, d):
    # one and two 64-row and 128-row tiles and their ragged edges, up to the
    # contract's S = 1024: K8 on separate (B, H, S, D) q, k, v, dO, K12 on a
    # (B, S, 3, H, D) buffer and K10 on its (B, S, 3·H·D) view, each against
    # the plain version by a flipped rounding of ds or of a stored gradient;
    # copies exactly where the route says; two calls bitwise equal. Nothing
    # reaches csrc/hp_bwd.cu or the plain versions on the card.
    def refuse(*args, **kwargs):
        raise AssertionError("a bf16/fp16 call left the tensor cores")

    b, h = 2, 3
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(_rand((b, s, 3, h, d), 40 * s + d)).to(
        cuda_device, dt)
    do_s = torch.from_numpy(_rand((b, s, h * d), 40 * s + d + 1)).to(
        cuda_device, dt)
    heads5 = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    q, k, v = (t.contiguous() for t in heads5)
    do = do_s.view(b, s, h, d).transpose(1, 2).contiguous()
    want = [t.float() for t in fa.fused_bwd_reference(q, k, v, do,
                                                      d ** -0.5)]
    flat = qkv.view(b, s, 3 * h * d)
    with monkeypatch.context() as m:
        for name in ("build_hp_bwd_kernels", "fused_bwd_reference",
                     "hp_bwd_reference"):
            m.setattr(fa, name, refuse)
        for count, run, ins in (
                ("FUSED_BWD_LAUNCHES", lambda: fa.fused_bwd(q, k, v, do),
                 (q, k, v, do)),
                ("QKV_BWD_LAUNCHES", lambda: fa.qkv_bwd(qkv, do_s).permute(
                    2, 0, 3, 1, 4).unbind(0),
                 (*heads5, do_s.view(b, s, h, d).transpose(1, 2))),
                ("HP_BWD_LAUNCHES", lambda: fa.hp_bwd(flat, do_s, h).view(
                    b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0),
                 (*heads5, do_s.view(b, s, h, d).transpose(1, 2)))):
            before, copies = getattr(fa, count), fb.COPIES
            grads = run()
            again = run()
            torch.cuda.synchronize()
            assert getattr(fa, count) == before + 2
            assert fb.COPIES - copies == 2 * int(
                fa.bwd_kernel_route(*ins) == "tensor_cores_copy")
            for g, g2, w in zip(grads, again, want):
                assert g.dtype == dt and torch.isfinite(g.float()).all()
                assert torch.equal(g, g2)
                err = (g.float() - w).abs().max().item()
                assert err <= 2e-2 * w.abs().max().item(), (count, err)


@pytest.mark.cuda
def test_views_of_a_qkv_buffer_need_no_copy_on_cuda(cuda_device):
    # multi_head_attention(use_pallas=True) on the (B, H, S, D) views that
    # permuting a (B, S, 3, H, D) projection gives
    b, s, h, d = 2, 197, 4, 64
    qkv = torch.from_numpy(_rand((b, s, 3, h, d), 70)).to(
        cuda_device, torch.bfloat16).requires_grad_()
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    assert not q.is_contiguous()
    do = torch.from_numpy(_rand((b, h, s, d), 71)).to(cuda_device,
                                                      torch.bfloat16)
    before = _counts()
    o = at.multi_head_attention(q, k, v, use_pallas=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, *before[2:])
    x = qkv.detach().permute(2, 0, 3, 1, 4).unbind(0)
    _plain_check(o, qkv.grad.permute(2, 0, 3, 1, 4).unbind(0), *x, do,
                 d ** -0.5)


def _cuda_views(shape, seed, dev, make=None):
    """Seeded bf16 (B, H, S, D) q, k, v, dO on the card, each made by
    `make` from a contiguous tensor (a strided view), and the leaves."""
    ts = [torch.from_numpy(_rand(shape, seed + i)).to(dev, torch.bfloat16)
          for i in range(4)]
    return [make(t) if make else t for t in ts]


def _run_and_check(q, k, v, do):
    """fused_attention forward + backward on the card against the plain
    versions; returns the (K7, K8) launches it added."""
    before = _counts()
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.fused_attention(*x)
    o.backward(do)
    torch.cuda.synchronize()
    assert o.shape == q.shape
    _plain_check(o, [t.grad for t in x], q, k, v, do, q.shape[-1] ** -0.5)
    return _counts()[0] - before[0], _counts()[1] - before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [47, 63, 7])
def test_odd_head_dims_run_on_cuda(cuda_device, d):
    # G2: the head dim is zero-padded to even inside the wrapper
    before = fb.COPIES
    assert _run_and_check(*_cuda_views((2, 3, 130, d), 90, cuda_device)) \
        == (1, 1)
    assert fb.COPIES == before + 2             # the forward and the backward


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["every_other_column", "odd_row_stride",
                                    "odd_offset"])
def test_strided_views_are_copied_on_cuda(cuda_device, layout):
    # G3: views whose strides break the kernels' rule take one copy
    make = {"every_other_column": lambda t: torch.cat([t, t], -1)[..., ::2],
            "odd_row_stride": lambda t: torch.nn.functional.pad(
                t, (0, 1))[..., :-1],
            "odd_offset": lambda t: torch.cat(
                [t.flatten(), t.flatten()[:1]])[1:].view(t.shape)}[layout]
    views = _cuda_views((2, 4, 100, 64), 95, cuda_device, make)
    before = fb.COPIES
    assert _run_and_check(*views) == (1, 1)
    assert fb.COPIES == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(65537, 1, 8, 8), (1, 65537, 8, 8)])
def test_batch_and_heads_over_65535_on_cuda(cuda_device, shape):
    # G4: (b, h, query tile) ride the grid's x, which takes 2^31 - 1
    # blocks: one launch each way, no copy
    before = fb.COPIES
    assert _run_and_check(*_cuda_views(shape, 97, cuda_device)) == (1, 1)
    assert fb.COPIES == before


@pytest.mark.cuda
def test_fused_kernels_contract_on_cuda(cuda_device):
    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    x = torch.zeros((1, 2, 64, 64), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        fa.fused_fwd(x, x, x)
    with pytest.raises(TypeError, match="float64"):
        fa.qkv_fwd(torch.zeros((1, 64, 3, 2, 64), device=cuda_device,
                               dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):  # mixed dtypes
        fa.fused_fwd(x.float(), x.float(), x.half())
    # fp32 is a kernel dtype: K7's and K11's fp32 instantiations launch
    f = torch.from_numpy(_rand((1, 64, 3, 2, 64), 97)).to(cuda_device)
    before = _counts()
    o7 = fa.fused_fwd(*f.permute(2, 0, 3, 1, 4).unbind(0))
    o11 = fa.qkv_fwd(f)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1], before[2] + 1, before[3])
    o_r = fa.fused_fwd_reference(*f.permute(2, 0, 3, 1, 4).unbind(0),
                                 64 ** -0.5)
    torch.testing.assert_close(o7, o_r, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(o11, o_r.transpose(1, 2).reshape(1, 64, 128),
                               atol=1e-5, rtol=1e-4)
    # an odd head dim runs (G2); past the CUDA-core kernels' head dim it
    # raises (over 128 it runs on them: test_wide_heads_match_plain_on_cuda)
    y = torch.from_numpy(_rand((1, 2, 64, 63), 98)).to(**bf)
    dq, dk, dv = fa.fused_bwd(y, y, y, y)
    torch.cuda.synchronize()
    for g, r in zip((dq, dk, dv), fa.fused_bwd_reference(y, y, y, y,
                                                         63 ** -0.5)):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 2e-2 * r.float().abs().max().item()
    big = torch.zeros((1, 2, 64, fa.MAX_CUDA_CORE_HEAD_DIM + 2), **bf)
    with pytest.raises(ValueError, match="head_dim"):
        fa.fused_bwd(big, big, big, big)
    z = torch.zeros((1, 2, 1100, 64), **bf)
    with pytest.raises(ValueError, match="sequence"):
        fa.fused_fwd(z, z, z)
    # a head dim that is not contiguous runs on one copy (G3)
    w = torch.from_numpy(_rand((1, 2, 64, 128), 99)).to(**bf)[..., ::2]
    o = fa.fused_fwd(w, w, w)
    torch.cuda.synchronize()
    o_r = fa.fused_fwd_reference(w, w, w, 64 ** -0.5)
    assert (o.float() - o_r.float()).abs().max().item() <= 2e-2
    # S > 1024 takes the plain route and launches none of K7, K8, K11, K12
    before = _counts()
    z.requires_grad_()
    fa.fused_attention(z, z, z).sum().backward()
    q = torch.zeros((1, 1100, 3, 2, 64), **bf, requires_grad=True)
    fa.fused_attention_qkv(q).sum().backward()
    torch.cuda.synchronize()
    assert _counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 197, 136), (1, 2, 77, 192),
                                   (2, 4, 197, 256), (1, 3, 65, 137),
                                   (1, 1, 64, 1024)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_wide_heads_match_plain_on_cuda(cuda_device, dtype, shape):
    # F8: a head dim over 128 runs K7, K8, K11 and K12 in the inputs' dtype
    # (the wide tensor-core tiles up to 256 in bf16 and fp16, the CUDA
    # cores in fp32 and past 256), one launch each, against their plain
    # versions; the tensor-core backward run twice is bitwise the same
    b, h, s, d = shape
    dt = getattr(torch, dtype)
    x = [torch.from_numpy(_rand(shape, 70 + i)).to(cuda_device, dt)
         for i in range(3)]
    do = torch.from_numpy(_rand(shape, 73)).to(cuda_device, dt)
    rel = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-4}[dtype]
    tc = dtype != "float32" and d <= fa.MAX_WIDE_HEAD_DIM
    want_route = ("tensor_cores" if d % 8 == 0 else "tensor_cores_copy") \
        if tc else "cuda_cores"
    assert fa.fused_kernel_route(*x) == want_route
    assert fa.bwd_kernel_route(*x, do) == want_route
    if tc:
        assert torch.equal(fa.fused_fwd(*x), fa.fused_fwd(*x))
        assert all(torch.equal(a, c) for a, c in zip(
            fa.fused_bwd(*x, do), fa.fused_bwd(*x, do)))
    qkv = torch.stack([t.transpose(1, 2) for t in x], dim=2)
    for run in ("fused", "qkv"):
        leaves = [t.clone().requires_grad_() for t in
                  (x if run == "fused" else (qkv,))]
        before = _counts()
        if run == "fused":
            o = fa.fused_attention(*leaves)
            o.backward(do)
            grads = [t.grad for t in leaves]
        else:
            o = fa.fused_attention_qkv(*leaves)
            o.backward(do.transpose(1, 2).reshape(b, s, h * d))
            o = o.view(b, s, h, d).transpose(1, 2)
            grads = leaves[0].grad.permute(2, 0, 3, 1, 4).unbind(0)
        torch.cuda.synchronize()
        after = _counts()
        assert sum(a - c for a, c in zip(after, before)) == 2
        want = (fa.fused_fwd_reference(*x, d ** -0.5),
                *fa.fused_bwd_reference(*x, do, d ** -0.5))
        for got, w in zip((o, *grads), want):
            assert got.dtype == dt
            err = (got.float() - w.float()).abs().max().item()
            assert err <= rel * w.float().abs().max().item()


# ---- the fp32 K7 and K11 on csrc/attn_fwd_simt.cuh's register tiles
# (attn_fwd_simt_kernel<kD, true>): the edges of its tiles, and both sides
# of each score-block limit (S 784 / 785 at kD 32, 688 / 689 at 64, 496 /
# 497 at 128, 448 / 449 at 192 (and D 136 there), 384 / 385 at 256: past
# them the kernel recomputes s instead of storing it)
FP32_K7_CUDA_SHAPES = [(2, 2, s, d) for s in (1, 63, 64, 65, 197, 513, 1024)
                       for d in (32, 48, 64, 128, 136, 192, 256)] + [
    (2, 2, 784, 32), (2, 2, 785, 32), (2, 2, 688, 64), (2, 2, 689, 64),
    (2, 2, 496, 128), (2, 2, 497, 128), (2, 2, 448, 192), (2, 2, 449, 192),
    (2, 2, 448, 136), (2, 2, 449, 136), (2, 2, 384, 256), (2, 2, 385, 256)]
FP32_K7_EDGE_REL = 1e-5  # of the largest |o|: fp32 summation order, expf


def _fp32_o_close(o, q, k, v):
    o_ref = fa.fused_fwd_reference(q, k, v, q.shape[-1] ** -0.5)
    err = (o - o_ref).abs().max().item()
    assert torch.isfinite(o).all()
    assert err <= FP32_K7_EDGE_REL * o_ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FP32_K7_CUDA_SHAPES)
def test_fp32_k7_k11_match_plain_at_tile_edges_on_cuda(cuda_device, shape):
    # K7 twice on separate (B, H, S, D) q, k, v and K11 on a (B, S, 3, H, D)
    # buffer holding the same heads: the three o bitwise equal, no copy,
    # within FP32_K7_EDGE_REL of the plain version's largest |o|
    b, h, s, d = shape
    qkv = torch.from_numpy(_rand((b, s, 3, h, d), 60 * s + d)).to(
        cuda_device)
    q, k, v = (t.contiguous() for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))
    assert fa.fused_kernel_route(q, k, v) == "cuda_cores"
    before, copies = _counts(), fb.COPIES
    o7, again = fa.fused_fwd(q, k, v), fa.fused_fwd(q, k, v)
    o11 = fa.qkv_fwd(qkv).view(b, s, h, d).transpose(1, 2)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 2, before[1], before[2] + 1, before[3])
    assert fb.COPIES == copies
    assert torch.equal(o7, again) and torch.equal(o7, o11)
    _fp32_o_close(o7, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d130", "pair_offset", "odd_row_stride",
                                  "odd_offset"])
def test_fp32_views_on_the_register_tiles_on_cuda(cuda_device, case):
    # what the kernel reads in place and what _launch_views copies once:
    # D 130 (rows not 16-byte aligned) and views two floats late take the
    # kernel's 8-byte copies, no copy in Python (K11 on a D 130 buffer too,
    # bitwise K7's o); an odd row stride or views one float late (not
    # pair-aligned) are copied once
    d = 130 if case == "d130" else 256
    shape = (2, 2, 197, d)
    make = {
        "d130": lambda t: t,
        "pair_offset": lambda t: torch.cat(
            [t.flatten(), t.flatten()[:2]])[2:].view(t.shape),
        "odd_row_stride": lambda t: torch.nn.functional.pad(
            t, (0, 1))[..., :-1],
        "odd_offset": lambda t: torch.cat(
            [t.flatten(), t.flatten()[:1]])[1:].view(t.shape)}[case]
    q, k, v = (make(torch.from_numpy(_rand(shape, 80 + i)).to(cuda_device))
               for i in range(3))
    copies = fb.COPIES
    o = fa.fused_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fb.COPIES - copies == int(case in ("odd_row_stride",
                                              "odd_offset"))
    _fp32_o_close(o, q, k, v)
    if case == "d130":
        qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], dim=2)
        o11 = fa.qkv_fwd(qkv)
        torch.cuda.synchronize()
        assert fb.COPIES == copies
        assert torch.equal(o11.view(2, 197, 2, d).transpose(1, 2), o)


# one session per call, in a fresh process: in a long one (the whole cuda
# suite) torch.profiler's sessions stop recording kernels
FP32_K7_TRACED_D = (64, 192, 256)
_K7_TRACE = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa
out = {}
for d in %r:
    x = torch.randn(2, 197, 3, 2, d, device="cuda")
    q, k, v = (t.contiguous() for t in x.permute(2, 0, 3, 1, 4).unbind(0))
    for name, fn in (("fused_fwd", lambda: fa.fused_fwd(q, k, v)),
                     ("qkv_fwd", lambda: fa.qkv_fwd(x))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[f"{name}{d}"] = sorted(e.key for e in prof.key_averages()
                                   if e.device_type.name == "CUDA"
                                   and "anonymous namespace" in e.key)
print(json.dumps(out))
""" % (FP32_K7_TRACED_D,)


@pytest.fixture(scope="module")
def fp32_k7_trace():
    """The csrc/ kernels (anonymous namespace) one fp32 call of K7 and of
    K11 launches at each of FP32_K7_TRACED_D, traced by torch.profiler."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    res = subprocess.run([sys.executable, "-c", _K7_TRACE],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", FP32_K7_TRACED_D)
def test_fp32_k7_k11_launch_the_register_tiled_kernel_alone(fp32_k7_trace,
                                                            d):
    kd = next(kd for kd in (32, 64, 128, 192, 256) if d <= kd)
    for name in ("fused_fwd", "qkv_fwd"):
        names = fp32_k7_trace[f"{name}{d}"]
        assert len(names) == 1 and \
            f"::attn_fwd_simt_kernel<{kd}, true, " in names[0], (name, names)
