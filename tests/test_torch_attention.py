"""The port's attention forward against the JAX package's head-pair kernel.

The JAX side runs the Pallas kernel `_hp_fwd_stats_kernel` in interpret
mode on the CPU, as tests/test_pallas_attention.py does. The port's wrapper
runs its plain version, `attn_fwd_reference`, for CPU tensors. The
`cuda`-marked cases hold the CUDA kernels (the tensor-core ones in bf16
and fp16 at the edges of their 128-row tiles, and after the padded copy)
against that plain version and skip where there is no card. On the CPU,
the dispatch rule (`attn_kernel_route`) and the copy's argument (a head dim
zero-padded to a multiple of 8 leaves the plain version's o and row stats
unchanged) are checked directly.

Tolerances: fp32 inputs agree to 1e-5 (only the summation order differs).
bf16 inputs share every rounding point (bf16(q·scale), bf16(p), bf16(o)),
but a different fp32 summation order can flip a bf16 rounding, which moves
o by a few bf16 ulps (2^-8 at |o| in [0.5, 1)): atol 2e-2. The fp32 row
stats agree to rtol 1e-5 in both.
"""
import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa

B, H, D = 2, 2, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)


def _jax_k1(qkv: np.ndarray, h: int, scale: float, bf16: bool):
    """JAX K1 in interpret mode -> o (B, S, H·D), st re-laid to (B, H, S, 2)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        _hp_fwd_stats_call,
    )

    b, s, c = qkv.shape
    d = c // (3 * h)
    x = jnp.asarray(qkv, jnp.bfloat16 if bf16 else jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        o, st = _hp_fwd_stats_call(x, scale, s, h, d)
    # st is (H/2, B, S, 4) = [m_0, m_1, rinv_0, rinv_1] per head pair
    st = np.asarray(st)
    m = st[..., :2].transpose(1, 0, 3, 2).reshape(b, h, s)
    rinv = st[..., 2:].transpose(1, 0, 3, 2).reshape(b, h, s)
    return np.asarray(o.astype(jnp.float32)), np.stack([m, rinv], axis=-1)


@pytest.mark.parametrize("s", [197, 17])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attn_fwd_reference_matches_k1(dtype, s):
    qkv = _qkv(B, s, H, D, seed=s)
    scale = D ** -0.5
    o_want, st_want = _jax_k1(qkv, H, scale, dtype == "bfloat16")
    x = torch.from_numpy(qkv).to(getattr(torch, dtype))
    o, st = fa.attn_fwd_reference(x, H, scale, with_stats=True)
    atol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert o.shape == (B, s, H * D) and o.dtype == x.dtype
    np.testing.assert_allclose(o.float().numpy(), o_want, atol=atol, rtol=0)
    np.testing.assert_allclose(st.numpy(), st_want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("has_bias", [True, False])
def test_qkv_proj_attention_matches_jax(has_bias):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        qkv_proj_attention as jax_qkv_proj_attention,
    )

    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 197, H * D)).astype(np.float32)
    w = (rng.standard_normal((H * D, 3 * H * D)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(3 * H * D) * 0.1).astype(np.float32) \
        if has_bias else None
    with pltpu.force_tpu_interpret_mode():
        want = jax_qkv_proj_attention(
            jnp.asarray(x), jnp.asarray(w),
            jnp.asarray(b) if has_bias else None, H)
    got = fa.qkv_proj_attention(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(b) if has_bias else None, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_attn_fwd_on_cpu_is_the_plain_version():
    x = torch.from_numpy(_qkv(B, 33, H, D, seed=3)).to(torch.bfloat16)
    before = fa.ATTN_FWD_LAUNCHES
    o, st = fa.attn_fwd(x, H, with_stats=True)
    o_ref, st_ref = fa.attn_fwd_reference(x, H, D ** -0.5, with_stats=True)
    assert fa.ATTN_FWD_LAUNCHES == before
    assert torch.equal(o, o_ref) and torch.equal(st, st_ref)
    assert fa.attn_fwd(x, H)[1] is None


def test_attn_fwd_refuses_other_devices():
    x = torch.empty((1, 8, 3 * H * D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.attn_fwd(x, H)
    with pytest.raises(ValueError, match="3 x"):
        fa.attn_fwd(torch.zeros((1, 8, 100)), H)


# the model's shape (12 heads), a long sequence at D = 128, and the
# tensor-core kernels' ragged edges: S around one and two 128-row tiles, up
# to the contract's 1024, at both head dims of the kernels; and head dims
# that take one copy (not a multiple of 8, odd head counts)
KERNEL_SHAPES = [(2, 197, 12, 64), (1, 1024, 2, 128)] + [
    (2, s, 3, d) for s in (17, 64, 65, 197, 256, 257, 1024)
    for d in (64, 128)] + [(3, 77, 3, 48), (2, 33, 3, 2), (2, 40, 1, 6)]


def _padded_qkv(qkv: np.ndarray, h: int, dp: int) -> np.ndarray:
    """qkv (B, S, 3·H·D) with each head's D columns zero-padded to dp."""
    b, s, c = qkv.shape
    x = qkv.reshape(b, s, 3, h, c // (3 * h))
    pad = np.zeros((b, s, 3, h, dp - x.shape[-1]), qkv.dtype)
    return np.concatenate([x, pad], axis=-1).reshape(b, s, 3 * h * dp)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d,h", [(64, 2), (128, 2), (48, 3), (2, 3)])
def test_kernel_route_by_dtype_and_head_dim(dtype, d, h):
    """bf16 and fp16 take the tensor-core kernels, in place when TMA reads
    the (B, S, 3·H·D) buffer (a head dim that is a multiple of 8, which
    makes H·D one too, and 16-byte-aligned data), after one padded copy
    otherwise; fp32 the CUDA-core loops. The rule depends on neither the
    head count nor S."""
    dt = getattr(torch, dtype)
    b, s, c = 2, 5, 3 * h * d
    want = ("cuda_cores" if dtype == "float32" else
            "tensor_cores" if d % 8 == 0 else "tensor_cores_copy")
    qkv = torch.zeros((b, s, c), dtype=dt)
    do = torch.zeros((b, s, h * d), dtype=dt)
    assert fa.attn_kernel_route(qkv, h) == want
    assert fa.attn_kernel_route(qkv, h, do, do.clone()) == want
    assert c % 8 == 0 or want != "tensor_cores"
    if dtype != "float32":
        # data that is not 16-byte aligned takes the copy too: the qkv
        # buffer, or dO of the backward
        odd = torch.zeros(b * s * c + 1, dtype=dt)[1:].view(b, s, c)
        odd_do = torch.zeros(b * s * h * d + 1, dtype=dt)[1:].view(b, s, -1)
        assert fa.attn_kernel_route(odd, h) == "tensor_cores_copy"
        assert fa.attn_kernel_route(qkv, h, odd_do, do) == \
            "tensor_cores_copy"


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d,h", [(2, 3), (6, 1), (48, 2)])
def test_padded_head_dim_leaves_the_forward_unchanged(dtype, d, h):
    """The copy's argument: q, k, v zero-padded to a multiple of 8 give the
    same o on the real columns (and zeros beyond) and the same row stats,
    at the real head dim's scale."""
    dt = getattr(torch, dtype)
    qkv = _qkv(2, 21, h, d, seed=d)
    dp = -(-d // 8) * 8
    x = torch.from_numpy(qkv).to(dt)
    xp = torch.from_numpy(_padded_qkv(qkv, h, dp)).to(dt)
    o, st = fa.attn_fwd_reference(x, h, d ** -0.5, with_stats=True)
    op, stp = fa.attn_fwd_reference(xp, h, d ** -0.5, with_stats=True)
    op = op.view(2, 21, h, dp)
    torch.testing.assert_close(op[..., :d].reshape(o.shape), o, rtol=0,
                               atol=0)
    assert not op[..., d:].any()
    torch.testing.assert_close(stp, st, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_attn_fwd_kernel_matches_plain(cuda_device, shape, dtype):
    b, s, h, d = shape
    x = torch.from_numpy(_qkv(b, s, h, d, seed=5)).to(cuda_device,
                                                       getattr(torch, dtype))
    before = fa.ATTN_FWD_LAUNCHES
    o, st = fa.attn_fwd(x, h, with_stats=True)
    o9 = fa.hp_fwd(x, h)
    torch.cuda.synchronize()
    assert fa.ATTN_FWD_LAUNCHES == before + 1
    o_ref, st_ref = fa.attn_fwd_reference(x, h, d ** -0.5, with_stats=True)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(o9.float(), o_ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(st, st_ref, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_attn_fwd_kernel_contract(cuda_device):
    x = torch.zeros((1, 8, 3 * H * D), device=cuda_device)
    with pytest.raises(TypeError, match="float64"):
        fa.attn_fwd(x.double(), H)
    # fp32 is a kernel dtype: K1's fp32 instantiation launches and matches
    # its plain version (summation order only)
    y = torch.from_numpy(_qkv(1, 40, H, D, seed=6)).to(cuda_device)
    before = fa.ATTN_FWD_LAUNCHES
    o, st = fa.attn_fwd(y, H, with_stats=True)
    torch.cuda.synchronize()
    assert fa.ATTN_FWD_LAUNCHES == before + 1 and o.dtype == torch.float32
    o_ref, st_ref = fa.attn_fwd_reference(y, H, D ** -0.5, with_stats=True)
    torch.testing.assert_close(o, o_ref, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-5, atol=0)
    # K1 takes S <= 1024; longer sequences are the blocked kernels' (K4)
    with pytest.raises(ValueError, match="flash_blocked"):
        fa.attn_fwd(torch.zeros((1, 1025, 3 * H * D), device=cuda_device,
                                dtype=torch.bfloat16), H)
    # a call that needs a gradient goes through the autograd Function,
    # whose backward is the attention-backward kernel (K2)
    w = torch.zeros((H * D, 3 * H * D), device=cuda_device,
                    requires_grad=True)
    out = fa.qkv_proj_attention(torch.zeros((1, 8, H * D), device=cuda_device,
                                            dtype=torch.bfloat16), w, None, H)
    assert type(out.grad_fn).__name__ == "QkvProjAttentionBackward"
