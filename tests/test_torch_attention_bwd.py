"""The port's attention backward against the JAX package's head-pair kernel.

The JAX side runs the Pallas kernels `_hp_fwd_stats_kernel` and
`_hp_bwd_pi_kernel` in interpret mode on the CPU, as
tests/test_pallas_attention.py does. The port's wrappers run their plain
versions (`attn_fwd_reference`, `attn_bwd_reference`) for CPU tensors. The
JAX kernel writes dqkv in its pair-interleaved column order and its bias
partials as (H/2, B, 6D); the test un-permutes both with `_pi_perm`'s
inverse. The `cuda`-marked cases hold the CUDA kernels against their plain
version (the tensor-core ones in bf16 and fp16, two runs bitwise equal)
and skip where there is no card; the copy's argument for the backward is
checked on the CPU.

Tolerances, all relative to the largest |value| of the reference:
* fp32 inputs: 1e-5. Every cast is the identity; only summation order
  differs.
* bf16 inputs: dqkv 2e-2. The two share every rounding point (q̂, do_n,
  t, qn, the bf16 outputs), but a different fp32 summation order can flip a
  bf16 rounding of t, a value of up to a few units, which moves a gradient
  by a few bf16 ulps. The fp32 bias partials, 1e-3: they sum 2·S such
  values, and a flip moves one term.
"""
import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa
from vision_transformers_torch_xla_tpu_torch.ops.bias_grad import bias_add

B, H, D = 2, 2, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_k1_k2(qkv, do, h, scale, bf16):
    """JAX K1 (stats) then K2 in interpret mode -> o, st in the port's
    (B, H, S, 2) layout, dqkv in the standard column order, and the bias
    partials summed over B."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _hp_bwd_pi_call,
        _hp_fwd_stats_call,
        _pi_perm,
    )

    b, s, c = qkv.shape
    d = c // (3 * h)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    x, g = jnp.asarray(qkv, dt), jnp.asarray(do, dt)
    with pltpu.force_tpu_interpret_mode():
        o, st = _hp_fwd_stats_call(x, scale, s, h, d)
        dpi, dbp = _hp_bwd_pi_call(x, g, o, st, scale, s, h, d)
    _, inv = _pi_perm(h, d)
    st = np.asarray(st)                    # (H/2, B, S, 4) = [m0, m1, r0, r1]
    m = st[..., :2].transpose(1, 0, 3, 2).reshape(b, h, s)
    rinv = st[..., 2:].transpose(1, 0, 3, 2).reshape(b, h, s)
    dqkv = np.asarray(dpi.astype(jnp.float32))[..., inv]
    dbias = np.asarray(dbp).sum(axis=1).reshape(-1)[inv]
    return (np.asarray(o.astype(jnp.float32)), np.stack([m, rinv], -1),
            dqkv, dbias)


@pytest.mark.parametrize("s", [197, 17])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attn_bwd_reference_matches_k2(dtype, s):
    qkv = _normal((B, s, 3 * H * D), seed=s)
    do = _normal((B, s, H * D), seed=s + 1)
    scale = D ** -0.5
    o, st, dqkv_want, dbias_want = _jax_k1_k2(qkv, do, H, scale,
                                              dtype == "bfloat16")
    dt = getattr(torch, dtype)
    dqkv, dbias = fa.attn_bwd(
        *(torch.tensor(a).to(dt) for a in (qkv, do, o)),
        torch.tensor(st, dtype=torch.float32), H, scale)
    assert dqkv.shape == (B, s, 3 * H * D) and dqkv.dtype == dt
    assert dbias.shape == (B, 3 * H * D) and dbias.dtype == torch.float32
    bf16 = dtype == "bfloat16"
    assert _rel_err(dqkv.float().numpy(), dqkv_want) <= (2e-2 if bf16 else 1e-5)
    assert _rel_err(dbias.sum(0).numpy(), dbias_want) <= \
        (1e-3 if bf16 else 1e-5)


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attn_bwd_reference_matches_k2_wide_heads(dtype, d):
    # F8: K1 (with stats) and K2 at head dims over 128 that JAX's head-pair
    # kernels take; limits as test_attn_bwd_reference_matches_k2. At D 192
    # the scale is not a power of two, so q̂ holds the port to JAX's
    # rounding of the scale to the element type (_q_hat)
    b, s = 1, 40
    qkv = _normal((b, s, 3 * H * d), seed=d)
    do = _normal((b, s, H * d), seed=d + 1)
    scale = d ** -0.5
    bf16 = dtype == "bfloat16"
    o, st, dqkv_want, dbias_want = _jax_k1_k2(qkv, do, H, scale, bf16)
    dt = getattr(torch, dtype)
    o_got, st_got = fa.attn_fwd(torch.tensor(qkv).to(dt), H, scale,
                                with_stats=True)
    assert _rel_err(o_got.float().numpy(), o) <= (2e-2 if bf16 else 1e-5)
    if not bf16:  # the backward below takes JAX's stats, as the test above
        np.testing.assert_allclose(st_got.numpy(), st, rtol=1e-5, atol=1e-5)
    dqkv, dbias = fa.attn_bwd(
        *(torch.tensor(a).to(dt) for a in (qkv, do, o)),
        torch.tensor(st, dtype=torch.float32), H, scale)
    assert dqkv.shape == (b, s, 3 * H * d) and dqkv.dtype == dt
    assert _rel_err(dqkv.float().numpy(), dqkv_want) <= \
        (2e-2 if bf16 else 1e-5)
    assert _rel_err(dbias.sum(0).numpy(), dbias_want) <= \
        (1e-3 if bf16 else 1e-5)


# the plain fp32 K2, which csrc/attn_bwd_simt.cu is held to on the card, at
# the edges of its 32-key and 64-query tiles: S 1 to 197 at D 136 (the 192
# tiles with zero columns) and 256, against JAX's K2 on JAX's stats (1e-5)
K2_FP32_PLAIN_S = (1, 31, 33, 63, 65, 197)


@pytest.mark.parametrize("s", K2_FP32_PLAIN_S)
@pytest.mark.parametrize("d", [136, 256])
def test_attn_bwd_reference_matches_k2_wide_tile_edges(d, s):
    b, h = 1, 2
    qkv = _normal((b, s, 3 * h * d), seed=d + s)
    do = _normal((b, s, h * d), seed=d + s + 1)
    scale = d ** -0.5
    o, st, dqkv_want, dbias_want = _jax_k1_k2(qkv, do, h, scale, False)
    dqkv, dbias = fa.attn_bwd(*(torch.tensor(a) for a in (qkv, do, o)),
                              torch.tensor(st, dtype=torch.float32), h,
                              scale)
    assert dqkv.shape == (b, s, 3 * h * d) and dqkv.dtype == torch.float32
    assert _rel_err(dqkv.numpy(), dqkv_want) <= 1e-5
    assert _rel_err(dbias.sum(0).numpy(), dbias_want) <= 1e-5


def _jax_proj_attention_grads(x, w, b, cot, bf16):
    """jax.grad of sum(qkv_proj_attention(x, w, b) · cot) in interpret
    mode; x in the compute dtype, w and b fp32."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        qkv_proj_attention,
    )

    dt = jnp.bfloat16 if bf16 else jnp.float32
    args = [jnp.asarray(x, dt), jnp.asarray(w)] + \
        ([jnp.asarray(b)] if b is not None else [])

    def loss(*a):
        o = qkv_proj_attention(a[0], a[1], a[2] if b is not None else None, H)
        return jnp.sum(o.astype(jnp.float32) * cot)

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_proj_attention_grads(x, w, b, cot, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    xt = torch.from_numpy(x).to(dt).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_() if b is not None else None
    o = fa.qkv_proj_attention(xt, wt, bt, H)
    (o.float() * torch.from_numpy(cot)).sum().backward()
    assert wt.grad.dtype == torch.float32
    return [t.grad.float().numpy() for t in (xt, wt, bt) if t is not None]


def _proj_inputs(has_bias, s=197):
    x = _normal((B, s, H * D), 11)
    w = _normal((H * D, 3 * H * D), 12, 0.1)
    b = _normal((3 * H * D,), 13, 0.1) if has_bias else None
    cot = _normal((B, s, H * D), 14)
    return x, w, b, cot


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("has_bias", [True, False])
def test_qkv_proj_attention_grads_match_jax(has_bias, dtype):
    """dx, dW and db through the port's autograd Function against jax.grad
    through the JAX custom VJP. dx is in the compute dtype: in bf16 it is
    held to 2e-2 of its largest value (bf16 dqkv, bf16 product)."""
    bf16 = dtype == "bfloat16"
    x, w, b, cot = _proj_inputs(has_bias)
    want = _jax_proj_attention_grads(x, w, b, cot, bf16)
    got = _port_proj_attention_grads(x, w, b, cot, bf16)
    assert len(got) == len(want) == (3 if has_bias else 2)
    for name, g, ref in zip(("dx", "dW", "db"), got, want):
        assert g.shape == ref.shape, name
        assert _rel_err(g, ref) <= (2e-2 if bf16 else 1e-5), name


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_qkv_proj_attention_wide_heads_match_jax(dtype, d):
    """F8: the values, dx, dW and db of `qkv_proj_attention` with 2 heads
    of 192 and 256, against the JAX custom VJP on its kernels (interpret
    mode); limits as test_qkv_proj_attention_grads_match_jax."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        qkv_proj_attention,
    )

    bf16 = dtype == "bfloat16"
    x = _normal((1, 40, H * d), 31)
    w = _normal((H * d, 3 * H * d), 32, 0.05)
    b = _normal((3 * H * d,), 33, 0.1)
    cot = _normal((1, 40, H * d), 34)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want_o = np.asarray(qkv_proj_attention(
            jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b), H).astype(
                jnp.float32))
    with torch.no_grad():
        got_o = fa.qkv_proj_attention(
            torch.from_numpy(x).to(getattr(torch, dtype)),
            torch.from_numpy(w), torch.from_numpy(b), H)
    tol = 2e-2 if bf16 else 1e-5
    assert _rel_err(got_o.float().numpy(), want_o) <= tol
    want = _jax_proj_attention_grads(x, w, b, cot, bf16)
    got = _port_proj_attention_grads(x, w, b, cot, bf16)
    for name, g, ref in zip(("dx", "dW", "db"), got, want):
        assert g.shape == ref.shape, name
        assert _rel_err(g, ref) <= tol, name


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_qkv_weight_and_bias_grads_are_fp32_sums():
    """At bf16 compute, dW = xᵀ·dqkv and db = Σ dqkv are accumulated in
    fp32 from the bf16 operands, as the JAX VJP does
    (preferred_element_type=f32). The relative L2 error against JAX is
    ~2.5e-4 for dW and ~8e-5 for db here: what is left are a few bf16
    roundings of dqkv that the two kernels' summation orders flip. dW or db
    rounded to bf16, as autograd through a bf16 projection gives them, is
    off by ~1.5e-3 (and the old autograd path by ~3e-3)."""
    x, w, b, cot = _proj_inputs(True)
    _, dw_want, db_want = _jax_proj_attention_grads(x, w, b, cot, True)
    _, dw, db = _port_proj_attention_grads(x, w, b, cot, True)
    assert _rel_l2(dw, dw_want) <= 5e-4
    assert _rel_l2(db, db_want) <= 5e-4


def test_dense_bias_grad_is_an_fp32_sum():
    """A bf16 Dense's bias gradient: dy summed in fp32 (JAX bias_add's
    ones-vector dot, preferred_element_type=f32), then cast to the fp32
    bias. A sum rounded to bf16 first is off by up to 2^-9 relative."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.ops.bias_grad import (
        bias_add as jax_bias_add,
    )
    from vision_transformers_torch_xla_tpu_torch.models.layers import Dense

    x = _normal((4, 197, 64), 21)
    cot = _normal((4, 197, 96), 23)
    dense = Dense(64, 96)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(_normal((96, 64), 22, 0.1)))
        dense.bias.copy_(torch.from_numpy(_normal((96,), 24, 0.1)))
    y = dense(torch.from_numpy(x))
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert dense.bias.grad.dtype == torch.float32
    # JAX: the same bf16 product, then bias_add; db depends on dy only
    y_jax = jnp.asarray((y.detach() - dense.bias.detach().to(y.dtype)).float()
                        .numpy(), jnp.bfloat16)
    db_want = np.asarray(jax.grad(lambda bb: jnp.sum(
        jax_bias_add(y_jax, bb).astype(jnp.float32) * cot))(
        jnp.asarray(dense.bias.detach().numpy())))
    np.testing.assert_allclose(dense.bias.grad.numpy(), db_want, rtol=1e-5,
                               atol=1e-5)
    out = bias_add(torch.zeros(3, 2, dtype=torch.bfloat16), torch.ones(2))
    assert out.dtype == torch.bfloat16


def test_attn_bwd_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((B, 33, 3 * H * D)).astype(
        np.float32)).to(torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((B, 33, H * D)).astype(
        np.float32)).to(torch.bfloat16)
    o, st = fa.attn_fwd(qkv, H, with_stats=True)
    before = fa.ATTN_BWD_LAUNCHES
    got = fa.attn_bwd(qkv, do, o, st, H)
    want = fa.attn_bwd_reference(qkv, do, o, st, H, D ** -0.5)
    assert fa.ATTN_BWD_LAUNCHES == before
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_attn_bwd_checks_its_operands():
    qkv = torch.zeros((1, 8, 3 * H * D))
    o = torch.zeros((1, 8, H * D))
    st = torch.zeros((1, H, 8, 2))
    with pytest.raises(ValueError, match="do not fit"):
        fa.attn_bwd(qkv, o, o, st[:, :1], H)
    meta = [t.to("meta") for t in (qkv, o, o, st)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.attn_bwd(*meta, H)


def test_no_grad_forward_skips_the_stats():
    """Without a gradient the projection + attention is the serving path;
    with one it is the autograd Function that saves K1's stats."""
    x = torch.from_numpy(_normal((1, 9, H * D), 1))
    w = torch.from_numpy(_normal((H * D, 3 * H * D), 2, 0.1))
    with torch.no_grad():
        plain = fa.qkv_proj_attention(x, w.requires_grad_(), None, H)
    assert plain.grad_fn is None
    out = fa.qkv_proj_attention(x, w, None, H)
    assert type(out.grad_fn).__name__ == "QkvProjAttentionBackward"
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d,h", [(2, 3), (6, 1), (48, 2)])
def test_padded_head_dim_leaves_the_backward_unchanged(dtype, d, h):
    """The copy's argument for K2: q, k, v, dO and O zero-padded to a
    multiple of 8 give the same dqkv on the real columns (zeros beyond)
    and the same bias partials, at the real head dim's scale. The zero
    columns add exact zeros to every product; only the fp32 summation
    order of the longer rows may differ (1e-5 relative), which in bf16 and
    fp16 can flip no rounding at these sizes (it did not: 0 there)."""
    dt = getattr(torch, dtype)
    b, s = 2, 21
    dp = -(-d // 8) * 8

    def pad(x, parts):
        y = x.reshape(*x.shape[:-1], parts, h, d)
        z = torch.zeros((*y.shape[:-1], dp - d), dtype=x.dtype)
        return torch.cat([y, z], dim=-1).reshape(*x.shape[:-1], -1)

    def real(x, parts):
        y = x.reshape(*x.shape[:-1], parts, h, dp)
        assert not y[..., d:].any()
        return y[..., :d].reshape(*x.shape[:-1], -1)

    qkv = torch.from_numpy(_normal((b, s, 3 * h * d), d)).to(dt)
    do = torch.from_numpy(_normal((b, s, h * d), d + 1)).to(dt)
    o, st = fa.attn_fwd_reference(qkv, h, d ** -0.5, with_stats=True)
    dqkv, dbias = fa.attn_bwd_reference(qkv, do, o, st, h, d ** -0.5)
    dqkv_p, dbias_p = fa.attn_bwd_reference(pad(qkv, 3), pad(do, 1),
                                            pad(o, 1), st, h, d ** -0.5)
    exact = dtype != "float32"
    torch.testing.assert_close(real(dqkv_p, 3), dqkv,
                               rtol=0 if exact else 1e-5,
                               atol=0 if exact else 1e-6)
    torch.testing.assert_close(real(dbias_p, 3), dbias, rtol=1e-5,
                               atol=1e-6)


# the model's shape, a long sequence at D = 128, the tensor-core kernels'
# ragged edges (S around one and two 128-row tiles, up to 1024, at both
# head dims of the kernels), the head dims that take one copy, the fp32
# kernel's edges (S around its 64-row tiles, D 32) and B or H over 65535
KERNEL_SHAPES = [(2, 197, 12, 64), (1, 1024, 2, 128)] + [
    (2, s, 3, d) for s in (17, 64, 65, 197, 256, 257, 1024)
    for d in (64, 128)] + [(3, 77, 3, 48), (2, 33, 3, 2), (2, 1, 3, 32),
                           (2, 63, 3, 32), (1, 8, 65537, 8),
                           (65537, 8, 1, 8)]
# bf16 and fp16 as the module docstring says; fp32 differs by summation
# order and expf only
BWD_RTOL = {"bfloat16": (2e-2, 1e-3), "float16": (2e-2, 1e-3),
            "float32": (1e-5, 1e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_attn_bwd_kernel_matches_plain(cuda_device, shape, dtype):
    b, s, h, d = shape
    dev, dt = cuda_device, getattr(torch, dtype)
    qkv = torch.from_numpy(_normal((b, s, 3 * h * d), 5)).to(dev, dt)
    do = torch.from_numpy(_normal((b, s, h * d), 6)).to(dev, dt)
    o, st = fa.attn_fwd(qkv, h, with_stats=True)
    before = fa.ATTN_BWD_LAUNCHES
    dqkv, dbias = fa.attn_bwd(qkv, do, o, st, h)
    again = fa.attn_bwd(qkv, do, o, st, h)
    torch.cuda.synchronize()
    assert fa.ATTN_BWD_LAUNCHES == before + 2
    # no float atomics: a second run is bitwise the first
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])
    dqkv_r, dbias_r = fa.attn_bwd_reference(qkv, do, o, st, h, d ** -0.5)
    dqkv_rtol, dbias_rtol = BWD_RTOL[dtype]
    assert _rel_err(dqkv.float().cpu(), dqkv_r.float().cpu()) <= dqkv_rtol
    assert _rel_err(dbias.cpu(), dbias_r.cpu()) <= dbias_rtol


@pytest.mark.cuda
def test_proj_attention_backward_runs_the_kernels(cuda_device):
    """One forward + backward with a gradient: K1 once (with stats), K2
    once, and the gradients agree with the CPU's plain versions."""
    x, w, b, cot = _proj_inputs(True)
    want = _port_proj_attention_grads(x, w, b, cot, True)
    xt = torch.from_numpy(x).to(cuda_device, torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).to(cuda_device).requires_grad_()
    bt = torch.from_numpy(b).to(cuda_device).requires_grad_()
    f0, b0 = fa.ATTN_FWD_LAUNCHES, fa.ATTN_BWD_LAUNCHES
    o = fa.qkv_proj_attention(xt, wt, bt, H)
    (o.float() * torch.from_numpy(cot).to(cuda_device)).sum().backward()
    torch.cuda.synchronize()
    assert (fa.ATTN_FWD_LAUNCHES - f0, fa.ATTN_BWD_LAUNCHES - b0) == (1, 1)
    for g, ref in zip((xt.grad, wt.grad, bt.grad), want):
        assert _rel_err(g.float().cpu(), ref) <= 2e-2


# F8: head dims over the tensor cores' 128. K1 and K2 run the wide
# tensor-core tiles up to 256 in bf16 and fp16 (csrc/attn_fwd_tc.cu,
# csrc/attn_bwd_tc.cu); every fp32 call and every head dim past 256 the
# CUDA cores (csrc/attn_bwd.cu, csrc/attn_fwd.cu, D 320 and 1024 too). o to WIDE_O_REL of its largest
# value (a
# flipped rounding of p or of o itself: bf16 2^-8, fp16 2^-11 per ulp; fp32
# summation order and expf only), the stats to 1e-4, the backward as
# BWD_RTOL.
WIDE_CASES = [(dt, (2, 197, 2, d)) for dt in ("bfloat16", "float16")
              for d in (136, 192, 256)] + [
    (dt, (1, 77, 2, 320)) for dt in ("bfloat16", "float16", "float32")] + [
    ("float32", (2, 197, 2, d)) for d in (136, 256)] + [
    (dt, (1, 64, 1, 1024)) for dt in ("bfloat16", "float32")]
WIDE_O_REL = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", WIDE_CASES)
def test_wide_heads_k1_k2_match_plain_on_cuda(cuda_device, dtype, shape):
    b, s, h, d = shape
    dev, dt = cuda_device, getattr(torch, dtype)
    qkv = torch.from_numpy(_normal((b, s, 3 * h * d), 7)).to(dev, dt)
    do = torch.from_numpy(_normal((b, s, h * d), 8)).to(dev, dt)
    wide_tc = dtype != "float32" and d <= fa.MAX_WIDE_HEAD_DIM
    assert fa.attn_kernel_route(qkv, h) == \
        ("tensor_cores" if wide_tc else "cuda_cores")
    f0, b0 = fa.ATTN_FWD_LAUNCHES, fa.ATTN_BWD_LAUNCHES
    o, st = fa.attn_fwd(qkv, h, with_stats=True)
    o2, st2 = fa.attn_fwd(qkv, h, with_stats=True)
    assert fa.attn_kernel_route(qkv, h, do, o) == \
        ("tensor_cores" if wide_tc else "cuda_cores")
    dqkv, dbias = fa.attn_bwd(qkv, do, o, st, h)
    again = fa.attn_bwd(qkv, do, o, st, h)
    torch.cuda.synchronize()
    assert (fa.ATTN_FWD_LAUNCHES - f0, fa.ATTN_BWD_LAUNCHES - b0) == (2, 2)
    # both kernels are deterministic: a second run is bitwise the first
    assert torch.equal(o, o2) and torch.equal(st, st2)
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])
    o_r, st_r = fa.attn_fwd_reference(qkv, h, d ** -0.5, with_stats=True)
    assert o.dtype == dt
    assert _rel_err(o.float().cpu(), o_r.float().cpu()) <= WIDE_O_REL[dtype]
    torch.testing.assert_close(st, st_r, rtol=1e-4, atol=1e-4)
    dqkv_r, dbias_r = fa.attn_bwd_reference(qkv, do, o, st, h, d ** -0.5)
    dqkv_rtol, dbias_rtol = BWD_RTOL[dtype]
    assert dqkv.dtype == dt
    assert _rel_err(dqkv.float().cpu(), dqkv_r.float().cpu()) <= dqkv_rtol
    assert _rel_err(dbias.cpu(), dbias_r.cpu()) <= dbias_rtol


# K2 on the wide tensor-core tiles (csrc/attn_bwd_tc.cu's 64-key dk/dv
# blocks streaming 32-query tiles, 64-query dq blocks) at their edges: S
# around those tiles up to MAX_SEQ; D 136, 192, 200 and 256 read in place
# (136 and 200 zero-filled to the next compiled tile), 130 and 250 after one
# `padded_copy` (TMA reads rows of a multiple of 8); bf16 and fp16, each
# call twice and bitwise equal, held as BWD_RTOL. fp32 (route 'cuda_cores':
# csrc/attn_bwd_simt.cu's 32-key blocks and 64-query tiles, no copy) at the
# same S and head dims and at 130 (4-byte copies of its rows), held to
# fp32's BWD_RTOL.
WIDE_K2_EDGE_CASES = [
    (dt, (1, s, 2, d)) for dt in ("bfloat16", "float16", "float32")
    for s in (1, 63, 64, 65, 127, 128, 129, 197, 1024)
    for d in (136, 192, 200, 256)] + [
    (dt, (2, s, 2, d)) for dt in ("bfloat16", "float16") for s in (65, 197)
    for d in (130, 250)] + [
    ("float32", (2, s, 2, 130)) for s in (31, 33, 65, 197)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", WIDE_K2_EDGE_CASES)
def test_wide_k2_matches_plain_at_tile_edges_on_cuda(cuda_device, dtype,
                                                     shape):
    from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked

    b, s, h, d = shape
    dev, dt = cuda_device, getattr(torch, dtype)
    qkv = torch.from_numpy(_normal((b, s, 3 * h * d), 11 + s + d)).to(dev, dt)
    do = torch.from_numpy(_normal((b, s, h * d), 12 + s + d)).to(dev, dt)
    o, st = fa.attn_fwd(qkv, h, with_stats=True)
    fp32 = dtype == "float32"
    copy = d % 8 != 0 and not fp32
    assert fa.attn_kernel_route(qkv, h, do, o) == \
        ("cuda_cores" if fp32 else
         "tensor_cores_copy" if copy else "tensor_cores")
    copies, before = flash_blocked.COPIES, fa.ATTN_BWD_LAUNCHES
    dqkv, dbias = fa.attn_bwd(qkv, do, o, st, h)
    again = fa.attn_bwd(qkv, do, o, st, h)
    torch.cuda.synchronize()
    assert fa.ATTN_BWD_LAUNCHES == before + 2
    assert flash_blocked.COPIES - copies == 2 * copy
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])
    dqkv_r, dbias_r = fa.attn_bwd_reference(qkv, do, o, st, h, d ** -0.5)
    dqkv_rtol, dbias_rtol = BWD_RTOL[dtype]
    assert dqkv.dtype == dt and torch.isfinite(dqkv.float()).all()
    assert _rel_err(dqkv.float().cpu(), dqkv_r.float().cpu()) <= dqkv_rtol
    assert _rel_err(dbias.cpu(), dbias_r.cpu()) <= dbias_rtol


# The csrc/ kernels one fp32 call of K2 launches at head dims 129-256 (in a
# fresh process, as tests/test_torch_flash_blocked.py's traces): the four
# launches of csrc/attn_bwd_simt.cu and no other, the run-time head dim's
# attn_bwd_wide_kernel<float> among them neither
K2_FP32_TRACE_D = (136, 192, 200, 256)
_K2_FP32_TRACE = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa
out = {}
for d in %r:
    h, s = 2, 197
    qkv = torch.randn(2, s, 3 * h * d, device="cuda")
    do = torch.randn(2, s, h * d, device="cuda")
    o, st = fa.attn_fwd(qkv, h, with_stats=True)
    fa.attn_bwd(qkv, do, o, st, h)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fa.attn_bwd(qkv, do, o, st, h)
        torch.cuda.synchronize()
    out[str(d)] = sorted(
        e.key for e in prof.key_averages()
        if e.device_type.name == "CUDA" and "anonymous namespace" in e.key)
print(json.dumps(out))
""" % (K2_FP32_TRACE_D,)


@pytest.fixture(scope="module")
def k2_fp32_trace():
    """The csrc/ kernels one fp32 call of K2 launches at each of
    K2_FP32_TRACE_D, traced by torch.profiler in a fresh process."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    res = subprocess.run([sys.executable, "-c", _K2_FP32_TRACE],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", K2_FP32_TRACE_D)
def test_fp32_wide_k2_launches_the_register_tiled_kernels_alone(
        k2_fp32_trace, d):
    kd = 192 if d <= 192 else 256
    names = k2_fp32_trace[str(d)]
    wants = ("::attn_bwd_rows_simt_kernel(",
             f"::attn_bwd_dkdv_wide_simt_kernel<{kd}>(",
             f"::attn_bwd_dq_sum_simt_kernel<{kd}>(",
             "::attn_bwd_bias_simt_kernel(")
    assert len(names) == len(wants) and all(
        any(w in n for n in names) for w in wants), names
