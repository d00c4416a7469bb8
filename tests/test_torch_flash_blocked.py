"""The port's blocked flash attention against the JAX package's.

ops/flash_blocked.py's plain versions (what the wrappers run on the CPU)
against JAX `flash_attention_blocked` and its `_flash_fwd` in interpret mode,
as tests/test_flash_blocked.py runs them: forward o and lse, and dq, dk, dv
of the port's autograd Function `FlashAttentionBlocked` against jax.grad.
Inputs come from a numpy seed. Then the port's `fused_attention_qkv_cols`
(S > 1024) against the JAX function, its S <= 1024 route (the head-pair
kernels, tests/test_torch_head_pair.py), and the wrappers' contract. The
`cuda` cases hold each kernel (K4, K5, K6) against its plain version on
the card and skip without one. The JAX package is imported inside the
JAX helpers, so that the `cuda` cases also run where flax is missing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa
from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked as fb

# fp32: both sides run the same online-softmax arithmetic in other orders
# and block sizes; the tolerance of tests/test_flash_blocked.py
ATOL = 2e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jfb():
    from vision_transformers_torch_xla_tpu.ops import flash_blocked

    return flash_blocked


def _jax_fwd(q, k, v, scale):
    """JAX's padded forward kernel in interpret mode -> o, lse (B, H, S)."""
    jfb = _jfb()
    b, h, s, d = q.shape
    sp = max(jfb._round_up(s, jfb.BLOCK_Q), jfb.BLOCK_Q)

    def prep(x):
        return jnp.pad(jnp.asarray(x).reshape(b * h, s, d),
                       ((0, 0), (0, sp - s), (0, 0)))

    with pltpu.force_tpu_interpret_mode():
        o, lse = jfb._flash_fwd(prep(q), prep(k), prep(v), scale, s)
    return (np.asarray(o[:, :s].astype(jnp.float32)).reshape(b, h, s, d),
            np.asarray(lse[:, :s, 0]).reshape(b, h, s))


def _jax_grads(q, k, v, dtype=jnp.float32):
    jfb = _jfb()

    def loss(q, k, v):
        o = jfb.flash_attention_blocked(q, k, v)
        return (o.astype(jnp.float32) ** 2).sum()

    with pltpu.force_tpu_interpret_mode():
        g = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in g]


def _graph(fn):
    """Names of the autograd nodes reachable from fn."""
    names, todo = set(), [fn]
    while todo:
        node = todo.pop()
        if node is not None and type(node).__name__ not in names:
            names.add(type(node).__name__)
            todo.extend(n for n, _ in node.next_functions)
    return names


def _port_grads(q, k, v, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = fb.flash_attention_blocked(*t)
    assert "FlashAttentionBlockedBackward" in _graph(o.grad_fn)
    (o.float() ** 2).sum().backward()
    return [x.grad.float().numpy() for x in t]


def _plain_fwd_and_jax(s, d):
    """The plain K4 and JAX's `_flash_fwd` in interpret mode on (1, 2, s,
    d) fp32 inputs -> o, lse as numpy arrays, the port's then JAX's."""
    b, h = 1, 2
    q, k, v = (_rand((b, h, s, d), seed) for seed in (s, s + 1, s + 2))
    scale = d ** -0.5
    want_o, want_lse = _jax_fwd(q, k, v, scale)
    o, lse = fb.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    assert o.dtype == torch.float32 and o.shape == (b, h, s, d)
    assert lse.shape == (b, h, s)
    return o.numpy(), lse.numpy(), want_o, want_lse


@pytest.mark.parametrize("s", [300, 512, 1025])
def test_plain_fwd_matches_jax_fp32(s):
    o, lse, want_o, want_lse = _plain_fwd_and_jax(s, 64)
    np.testing.assert_allclose(o, want_o, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, want_lse, atol=ATOL, rtol=0)


# The fp32 K4 (csrc/flash_fwd_simt.cu) at the edges of its 64-key tiles and
# 16-row warps: S around one and two tiles, the compile-time head dims 64
# and 128 and the ones that take them with zero columns (32, 48). Both
# sides run the online softmax in fp32, in other orders and blocks (JAX:
# 256 keys a block), so o and lse are held to FP32_FWD_EDGE_REL of their
# largest magnitudes.
FP32_FWD_EDGE_S = (1, 63, 65, 127, 129)
FP32_FWD_EDGE_REL = 1e-5
# and past 128 (flash_fwd_wide_simt_kernel, and K5's
# flash_bwd_dkdv_wide_simt_kernel in csrc/flash_bwd_simt.cu): S around the
# 32-key groups of their score tiles and key blocks and past the 64-row
# query tiles, the compile-time head dims 192 and 256 and 136 (the 192
# tiles with zero columns)
FP32_WIDE_EDGE_S = (1, 31, 33, 65, 129, 300)
FP32_WIDE_EDGE_D = (136, 192, 256)
FP32_FWD_EDGE_CASES = [(s, d) for s in FP32_FWD_EDGE_S
                       for d in (32, 48, 64, 128)] + [
    (s, d) for s in FP32_WIDE_EDGE_S for d in FP32_WIDE_EDGE_D]


@pytest.mark.parametrize("s,d", FP32_FWD_EDGE_CASES)
def test_plain_fwd_matches_jax_fp32_at_tile_edges(s, d):
    o, lse, want_o, want_lse = _plain_fwd_and_jax(s, d)
    for got, want in ((o, want_o), (lse, want_lse)):
        np.testing.assert_allclose(
            got, want, rtol=0, atol=FP32_FWD_EDGE_REL * np.abs(want).max())


@pytest.mark.parametrize("s", [300, 512, 1025])
def test_plain_grads_match_jax_fp32(s):
    b, h, d = 1, 1, 64
    q, k, v = (_rand((b, h, s, d), seed) for seed in (s + 3, s + 4, s + 5))
    want = _jax_grads(q, k, v)
    got = _port_grads(q, k, v)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


def test_plain_matches_jax_bf16():
    # bf16 inputs, both sides round p and ds to bf16 before their products.
    # The JAX kernel rounds p = exp(s - m) against the running max of each
    # 256-key block and rescales later; the plain version rounds against the
    # row's final max. Each p so carries its own bf16 rounding (2^-9
    # relative), and o (|o| < 1) and the stored bf16 grads differ by a few
    # bf16 ulps: atol 2e-2 on o (2^-8 at 0.5..1 is 3.9e-3, x5), 1e-3 on the
    # fp32 lse, and 3e-2 of the largest |grad| on dq, dk, dv.
    b, h, s, d = 1, 2, 1025, 64
    q, k, v = (_rand((b, h, s, d), seed) for seed in (7, 8, 9))
    scale = d ** -0.5
    qb, kb, vb = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                  for x in (q, k, v))
    want_o, want_lse = _jax_fwd(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (qb, kb, vb)), scale)
    o, lse = fb.flash_fwd(*(torch.from_numpy(x).bfloat16()
                            for x in (qb, kb, vb)), scale)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), want_o, atol=2e-2, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-3, rtol=0)
    want = _jax_grads(qb[:, :1], kb[:, :1], vb[:, :1], jnp.bfloat16)
    got = _port_grads(qb[:, :1], kb[:, :1], vb[:, :1], torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=3e-2 * np.abs(w).max(),
                                   rtol=0, err_msg=name)


# fp16: both sides round p, ds and the stored o, dk, dv to fp16 (2^-11
# relative); JAX rounds p against the running max of its 256-key blocks,
# the plain version against the row's final max, so a value moves by a
# flipped rounding or two: o, dk and dv within FP16_REL of their largest
# magnitude (one fp16 ulp, 1.2e-4 at a largest 0.25-0.41, seen at D 64 and
# 192), lse (fp32) within FP16_LSE_ATOL (9.5e-7 seen)
FP16_REL = 2e-3
FP16_LSE_ATOL = 1e-5


@pytest.mark.parametrize("d", [64, 192])
def test_plain_k4_k5_match_jax_fp16(d):
    # the plain K4 and K5, which the fp16 tensor-core kernels are held to
    # on the card, against JAX's _fwd_kernel and _bwd_dkdv_kernel in
    # interpret mode on the same fp16 inputs; K5 on JAX's lse and delta
    b, h, s = 1, 2, 1025
    q, k, v, do = (_rand((b, h, s, d), 300 + d + i).astype(np.float16)
                   for i in range(4))
    scale = d ** -0.5
    o_j, lse_j, _, dk_j, dv_j = _jax_bwd(q, k, v, do, scale)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = fb.flash_fwd(*t[:3], scale)
    delta = fb.flash_delta(torch.from_numpy(o_j.copy()), t[3])
    dk, dv = fb.flash_bwd_dkdv_reference(*t, torch.from_numpy(lse_j.copy()),
                                         delta, scale)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=0,
                               atol=FP16_LSE_ATOL)
    for name, g, w in (("o", o, o_j), ("dk", dk, dk_j), ("dv", dv, dv_j)):
        w = w.astype(np.float32)
        assert g.dtype == torch.float16 and g.shape == (b, h, s, d)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=FP16_REL * np.abs(w).max(),
                                   err_msg=name)


# K6's plain version, which the bf16 and fp16 tensor-core K6 are held to on
# the card, against JAX's _bwd_dq_kernel (through _flash_bwd in interpret
# mode) at the wide tiles' head dims, on JAX's lse and delta, with S
# around the 64-key tiles: dq within TC_REL (bf16) or FP16_REL (fp16) of
# the call's largest gradient (dq, dk, dv: at S = 1 ds is rounding noise,
# see FP32_BWD_EDGE_REL); each D and each S in five (D, S) pairs
K6_PLAIN_CASES = ((136, 65), (192, 1), (192, 300), (256, 65), (256, 300))


@pytest.mark.parametrize("d,s", K6_PLAIN_CASES)
@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
def test_plain_k6_matches_jax_wide_and_fp16(dtype, d, s):
    b, h = 1, 2
    dt = getattr(torch, dtype)
    q, k, v, do = (jnp.asarray(_rand((b, h, s, d), 400 + s + d + i),
                               getattr(jnp, dtype)) for i in range(4))
    scale = d ** -0.5
    o_j, lse_j, *want = _jax_bwd(q, k, v, do, scale)
    t = [torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(dt)
         for x in (q, k, v, do)]
    delta = fb.flash_delta(torch.from_numpy(o_j.astype(np.float32)).to(dt),
                           t[3])
    dq = fb.flash_bwd_dq_reference(
        *t, torch.from_numpy(lse_j.astype(np.float32)), delta, scale)
    want = [w.astype(np.float32) for w in want]
    rel = TC_REL["bfloat16"] if dtype == "bfloat16" else FP16_REL
    assert dq.dtype == dt and dq.shape == (b, h, s, d)
    np.testing.assert_allclose(dq.float().numpy(), want[0], rtol=0,
                               atol=rel * max(np.abs(w).max() for w in want))


def test_qkv_cols_matches_jax_fp32():
    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        fused_attention_qkv_cols as jax_qkv_cols,
    )

    b, s, h, d = 1, 1030, 2, 64
    qkv = _rand((b, s, 3 * h * d), 11)
    do = _rand((b, s, h * d), 12)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda x: jax_qkv_cols(x, h), jnp.asarray(qkv))
        (want_g,) = vjp(jnp.asarray(do))
    x = torch.from_numpy(qkv).requires_grad_()
    got = fa.fused_attention_qkv_cols(x, h)
    assert type(got.grad_fn).__name__ == "FlashAttentionBlockedBackward"
    got.backward(torch.from_numpy(do))
    assert got.shape == (b, s, h * d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               atol=ATOL, rtol=0)


def test_qkv_cols_wide_heads_match_jax_fp32():
    # F8: 2 heads of 192 at S = 1025 through the blocked route (K4-K6),
    # which JAX's flash_attention_blocked takes at any head dim
    from vision_transformers_torch_xla_tpu.ops.flash_attention import (
        fused_attention_qkv_cols as jax_qkv_cols,
    )

    b, s, h, d = 1, 1025, 2, 192
    qkv = _rand((b, s, 3 * h * d), 13)
    do = _rand((b, s, h * d), 14)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda x: jax_qkv_cols(x, h), jnp.asarray(qkv))
        (want_g,) = vjp(jnp.asarray(do))
    x = torch.from_numpy(qkv).requires_grad_()
    got = fa.fused_attention_qkv_cols(x, h)
    assert type(got.grad_fn).__name__ == "FlashAttentionBlockedBackward"
    got.backward(torch.from_numpy(do))
    assert got.shape == (b, s, h * d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               atol=ATOL, rtol=0)


def test_qkv_cols_short_sequence_takes_the_head_pair_route():
    # S = 1024 is the head-pair kernels' (K9, K10), not the blocked ones'
    x = torch.zeros((1, 1024, 3 * 2 * 64), requires_grad=True)
    before = fb.FLASH_FWD_LAUNCHES
    out = fa.fused_attention_qkv_cols(x, 2)
    assert out.shape == (1, 1024, 2 * 64)
    assert type(out.grad_fn).__name__ == "HeadPairAttentionBackward"
    assert fb.FLASH_FWD_LAUNCHES == before


def test_cpu_runs_plain_versions_without_counting():
    q, k, v = (torch.from_numpy(_rand((1, 2, 40, 32), s)) for s in (1, 2, 3))
    before = (fb.FLASH_FWD_LAUNCHES, fb.FLASH_BWD_DKDV_LAUNCHES,
              fb.FLASH_BWD_DQ_LAUNCHES)
    o, lse = fb.flash_fwd(q, k, v)
    o_r, lse_r = fb.flash_fwd_reference(q, k, v, 32 ** -0.5)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    dqkv = fb.flash_bwd(q, k, v, o, lse, o, 0.2)
    assert dqkv.shape == (1, 40, 3 * 2 * 32)
    for g, r in zip(fb.heads(dqkv, 2),
                    fb.flash_bwd_reference(q, k, v, o, lse, o, 0.2)):
        assert torch.equal(g, r)
    assert (fb.FLASH_FWD_LAUNCHES, fb.FLASH_BWD_DKDV_LAUNCHES,
            fb.FLASH_BWD_DQ_LAUNCHES) == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    meta = torch.empty((1, 2, 40, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fb.flash_fwd(meta, meta, meta)
    x = torch.zeros((1, 2, 40, 32))
    with pytest.raises(ValueError, match="do not fit"):
        fb.flash_bwd(x, x, x, x, torch.zeros((1, 2, 39)), x)
    # the backward kernels' wrappers check what they hand the kernels
    row = torch.empty((1, 2, 40), device="meta")
    short = torch.empty((1, 2, 39, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="q's shape"):
        fb.flash_bwd_dkdv(meta, meta, meta, short, row, row, meta, meta)
    with pytest.raises(ValueError, match="q's shape"):
        fb.flash_bwd_dkdv(meta, meta, meta, meta, row, row, meta, short)
    with pytest.raises(ValueError, match=r"\(B, H, S\)"):
        fb.flash_bwd_dq(meta, meta, meta, meta, row[:, :, :39], row, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fb.flash_bwd_dq(meta, meta, meta, meta, row, row, meta)


def _k4_layout(kind, b, h, s, d, seed, dev="cpu", dtype=torch.bfloat16):
    """q, k, v (B, H, S, D) in one of the layouts K4 meets."""
    def r(shape, i):
        return torch.from_numpy(_rand(shape, seed + i)).to(dev, dtype)
    if kind == "qkv":            # views of the model's (B, S, 3·H·D) buffer
        return fb.heads(r((b, s, 3 * h * d), 0), h)
    if kind == "dense":
        return [r((b, h, s, d), i) for i in range(3)]
    if kind == "transposed":     # (B, H, D, S) memory: D not contiguous
        return [r((b, h, d, s), i).transpose(-1, -2) for i in range(3)]
    if kind == "mixed":          # q, k, v in three different layouts
        qkv = fb.heads(r((b, s, 3 * h * d), 0), h)
        return [qkv[0], r((b, h, s, d), 1), r((b, s, h, d), 2).transpose(1, 2)]
    raise ValueError(kind)


@pytest.mark.parametrize("kind,d,ready", [
    ("qkv", 64, True), ("qkv", 48, True), ("dense", 128, True),
    ("qkv", 47, False), ("dense", 40, True), ("dense", 36, False),
    ("transposed", 64, False), ("mixed", 64, False)])
def test_k4_tma_rule_and_copy(kind, d, ready):
    # TMA reads q, k, v in place when they share one layout with 16-byte
    # strides and data and a head dim that is a multiple of 8; else one
    # contiguous copy, the head dim zero-padded to a multiple of 8
    q, k, v = _k4_layout(kind, 2, 3, 20, d, 40)
    assert fb.tma_ready(q, k, v) is ready
    before = fb.COPIES
    qc, kc, vc = fb.padded_copy((q, k, v), fb.TMA_ALIGN, "test")
    assert fb.COPIES == before + 1
    assert fb.tma_ready(qc, kc, vc)
    dp = -(-d // 8) * 8
    for t, c in zip((q, k, v), (qc, kc, vc)):
        assert c.shape == (2, 3, 20, dp)
        assert torch.equal(c[..., :d], t) and not c[..., d:].any()
    o, lse = fb.flash_fwd_reference(qc, kc, vc, d ** -0.5)
    o_r, lse_r = fb.flash_fwd_reference(q, k, v, d ** -0.5)
    assert torch.equal(o[..., :d], o_r) and not o[..., d:].any()
    torch.testing.assert_close(lse, lse_r, rtol=0, atol=1e-6)


# The per-kernel rule (TENSOR_CORE_RULE): K4, K5 and K6 on the tensor cores
# in bf16 and fp16 to a head dim of 256; everything else on
# csrc/flash_blocked.cu's library
ROUTE_DS = (64, 128, 136, 192, 256, 264)


@pytest.mark.parametrize("d", ROUTE_DS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_kernel_route_rule(dtype, d):
    dt = getattr(torch, dtype)

    def meta(*shape):
        return torch.empty(shape, dtype=dt, device="meta")

    wide = dtype != "float32" and d <= 256
    want = {"flash_fwd": wide, "flash_bwd_dkdv": wide, "flash_bwd_dq": wide}
    # the model's layout: q, k, v views of one (B, S, 3·H·D) buffer, dO a
    # view of (B, S, H, D) memory; read in place on either route
    q, k, v = fb.heads(meta(2, 1100, 3 * 4 * d), 4)
    do = meta(2, 1100, 4, d).transpose(1, 2)
    # a head dim TMA cannot read (not a multiple of 8): a copy on the
    # tensor cores, in place on the CUDA cores
    odd = fb.heads(meta(2, 1100, 3 * 4 * (d - 2)), 4)
    # the head dim not contiguous: a copy on either route
    tr = [meta(2, 4, d, 1100).transpose(-1, -2) for _ in range(3)]
    for kernel, tc in want.items():
        base = "tensor_cores" if tc else "cuda_cores"
        assert fb.tensor_cores(kernel, q) is tc, kernel
        assert fb.kernel_route(kernel, q, k, v) == base
        assert fb.kernel_route(kernel, q, k, v, do) == base
        assert fb.kernel_route(kernel, *odd) == \
            ("tensor_cores_copy" if tc else "cuda_cores")
        assert fb.kernel_route(kernel, *tr) == base + "_copy"
        assert fb.kernel_route(kernel, q, k, v, tr[0]) == base + "_copy"


def test_k4_tma_layout_of_size_one_dims():
    # a dimension of size 1 is never stepped: its stride takes the row
    # width, whatever torch reports
    q = torch.zeros((1, 5, 64), dtype=torch.bfloat16).unsqueeze(1)
    assert q.shape == (1, 1, 5, 64)
    assert fb._tma_layout(q) == (64, 64, 64)
    assert fb.tma_ready(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("qkv", (2, 1370, 12, 64)), ("qkv", (1, 1025, 4, 48)),
    ("qkv", (1, 2048, 2, 128)), ("qkv", (3, 77, 3, 48)),
    ("dense", (2, 300, 2, 96)), ("qkv", (5462, 40, 12, 64)),
    ("transposed", (2, 260, 4, 64)), ("dense", (2, 200, 2, 47)),
    ("mixed", (2, 1030, 2, 64))])
def test_k4_matches_plain_on_cuda(cuda_device, kind, shape):
    # the tensor-core K4 against flash_fwd_reference: D 48/64/96/128, ragged
    # S, B·H = 65544 > 65535, and the layouts that take a copy (odd D,
    # transposed, mixed); o to 2% of max |o| (a flipped bf16 rounding of
    # bf16(p) or of o), lse to 1e-4 (fp32 summation order and exp2)
    b, s, h, d = shape
    q, k, v = _k4_layout(kind, b, h, s, d, 50, cuda_device)
    copies = not fb.tma_ready(q, k, v)
    before = (fb.FLASH_FWD_LAUNCHES, fb.COPIES)
    o, lse = fb.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (fb.FLASH_FWD_LAUNCHES, fb.COPIES) == \
        (before[0] + 1, before[1] + copies)
    o_r, lse_r = fb.flash_fwd_reference(q, k, v, d ** -0.5)
    assert o.shape == o_r.shape and lse.shape == (b, h, s)
    o_err = (o.float() - o_r.float()).abs().max().item()
    assert o_err <= 2e-2 * o_r.float().abs().max().item()
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1370, 12, 64), (2, 1025, 3, 64),
                                   (1, 2048, 2, 128), (2, 197, 4, 40)])
def test_kernels_match_plain(cuda_device, shape):
    # same bf16 inputs and cast order; o differs by bf16(p) roundings of
    # the online max and a flipped rounding of o itself (a few bf16 ulps of
    # its largest value), the grads by fp32 summation order
    b, s, h, d = shape
    qkv = torch.from_numpy(_rand((b, s, 3 * h * d), 21)).to(cuda_device,
                                                           torch.bfloat16)
    q, k, v = fb.heads(qkv, h)
    do = torch.from_numpy(_rand((b, s, h * d), 22)).to(
        cuda_device, torch.bfloat16).view(b, s, h, d).transpose(1, 2)
    before = (fb.FLASH_FWD_LAUNCHES, fb.FLASH_BWD_DKDV_LAUNCHES,
              fb.FLASH_BWD_DQ_LAUNCHES)
    o, lse = fb.flash_fwd(q, k, v)
    dqkv = fb.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (fb.FLASH_FWD_LAUNCHES, fb.FLASH_BWD_DKDV_LAUNCHES,
            fb.FLASH_BWD_DQ_LAUNCHES) == tuple(n + 1 for n in before)
    o_r, lse_r = fb.flash_fwd_reference(q, k, v, d ** -0.5)
    o_err = (o.float() - o_r.float()).abs().max().item()
    assert o_err <= 2e-2 * o_r.float().abs().max().item()
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=0)
    for g, r in zip(fb.heads(dqkv, h),
                    fb.flash_bwd_reference(q, k, v, o, lse, do, d ** -0.5)):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 2e-2 * r.float().abs().max().item()


def _bwd_on_card(q, k, v, do):
    """K4, then K5 and K6 into views of one (B, S, 3·H·D) dqkv buffer, as
    `flash_bwd` lays them out; returns o, lse and (dq, dk, dv) beside the
    plain versions' on the same o, lse and delta."""
    b, h, s, d = q.shape
    o, lse = fb.flash_fwd(q, k, v)
    delta = fb.flash_delta(o, do)
    dq, dk, dv = fb.heads(torch.empty((b, s, 3 * h * d), dtype=q.dtype,
                                      device=q.device), h)
    fb.flash_bwd_dkdv(q, k, v, do, lse, delta, dk, dv)
    fb.flash_bwd_dq(q, k, v, do, lse, delta, dq)
    scale = d ** -0.5
    ref = (fb.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale),
           *fb.flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale))
    return o, lse, (dq, dk, dv), ref


def _counts():
    return (fb.FLASH_FWD_LAUNCHES, fb.FLASH_BWD_DKDV_LAUNCHES,
            fb.FLASH_BWD_DQ_LAUNCHES, fb.COPIES)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("qkv", (5462, 40, 12, 64)), ("transposed", (2, 260, 4, 64)),
    ("dense", (2, 200, 2, 47)), ("mixed", (2, 1030, 2, 64)),
    ("qkv", (2, 300, 2, 96))])
def test_k5_k6_layouts_on_cuda(cuda_device, kind, shape):
    # the tensor-core K5 and K6 against their plain versions at B·H = 65544
    # > 65535 and on the layouts that take one copy of q, k, v and dO (odd
    # D, transposed, mixed; the padded outputs go through temporaries);
    # dO is a view of (B, S, H, D) memory, as the model's backward has it.
    # Grads to 2% of their largest value (flipped bf16 roundings)
    b, s, h, d = shape
    q, k, v = _k4_layout(kind, b, h, s, d, 60, cuda_device)
    do = torch.from_numpy(_rand((b, s, h, d), 64)).to(
        cuda_device, torch.bfloat16).transpose(1, 2)
    copies = int(not fb.tma_ready(q, k, v))
    before = _counts()
    _, _, got, ref = _bwd_on_card(q, k, v, do)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1,
                         before[3] + 3 * copies)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.isfinite(g.float()).all()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 2e-2 * r.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.float16, 5e-3)])
@pytest.mark.parametrize("kind,shape", [
    ("qkv", (1, 1370, 12, 64)), ("qkv", (2, 197, 3, 40)),
    ("transposed", (1, 260, 2, 64)), ("qkv", (1, 1100, 2, 128))])
def test_kernels_fp32_fp16_on_cuda(cuda_device, dtype, rel, kind, shape):
    # K4, K5 and K6 of fp32 and fp16 (fp32: the CUDA cores; fp16: K4 and K5
    # on the tensor cores, K6 on the CUDA cores) against their plain
    # versions in the same dtype: fp32 differs by summation order and
    # expf only (1e-4 of the largest value), fp16 by flipped fp16
    # roundings of p, ds and the outputs (5e-3); lse to 1e-4
    b, s, h, d = shape
    q, k, v = _k4_layout(kind, b, h, s, d, 70, cuda_device, dtype)
    do = torch.from_numpy(_rand((b, s, h, d), 74)).to(
        cuda_device, dtype).transpose(1, 2)
    before = _counts()
    o, lse, got, ref = _bwd_on_card(q, k, v, do)
    torch.cuda.synchronize()
    assert _counts()[:3] == tuple(n + 1 for n in before[:3])
    o_r, lse_r = fb.flash_fwd_reference(q, k, v, d ** -0.5)
    assert o.dtype == dtype
    assert (o.float() - o_r.float()).abs().max().item() <= \
        rel * o_r.float().abs().max().item()
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=0)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= rel * r.float().abs().max().item()


@pytest.mark.cuda
def test_kernels_contract_on_cuda(cuda_device):
    x = torch.zeros((1, 2, 1100, 64), device=cuda_device,
                    dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        fb.flash_fwd(x, x, x)
    # fp32 is a kernel dtype: the CUDA-core K4 launches
    before = fb.FLASH_FWD_LAUNCHES
    o, _ = fb.flash_fwd(x.float(), x.float(), x.float())
    assert fb.FLASH_FWD_LAUNCHES == before + 1 and o.dtype == torch.float32
    # past the CUDA-core kernels' head dim it raises (over 128 they run:
    # test_wide_heads_blocked_match_plain_on_cuda)
    y = torch.zeros((1, 2, 1100, fb.MAX_CUDA_CORE_HEAD_DIM + 2),
                    device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fb.flash_fwd(y, y, y)
    qkv = torch.zeros((1, 1100, 3 * 2 * 64), device=cuda_device,
                      dtype=torch.bfloat16, requires_grad=True)
    before = fb.FLASH_FWD_LAUNCHES
    out = fa.fused_attention_qkv_cols(qkv, 2)
    assert fb.FLASH_FWD_LAUNCHES == before + 1
    assert type(out.grad_fn).__name__ != "NoneType"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [
    (dt, d) for dt in ("bfloat16", "float16") for d in (136, 192, 256)] + [
    (dt, 320) for dt in ("bfloat16", "float16", "float32")] + [
    ("float32", 256), ("bfloat16", 1024), ("float32", 136),
    ("float32", 192)])
def test_wide_heads_blocked_match_plain_on_cuda(cuda_device, dtype, d):
    # F8: K4, K5 and K6 at a head dim over 128 through
    # fused_attention_qkv_cols at S > 1024, against their plain versions:
    # K4, K5 and K6 on the tensor cores' wide tiles in bf16 and fp16 to
    # 256, the rest on the CUDA cores (the fp32 K4 and K5 to 256 on the
    # wide register tiles of csrc/flash_fwd_simt.cu and
    # csrc/flash_bwd_simt.cu, K6 and every dtype past 256 on
    # csrc/flash_blocked.cu's 64-column chunks); bf16 to 2e-2 of the
    # largest value, fp16 5e-3, fp32 1e-4 (as
    # test_kernels_fp32_fp16_on_cuda); lse to 1e-4; K4 run twice bitwise
    # equal
    b, s, h = 1, 1100, 2
    dt = getattr(torch, dtype)
    rel = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-4}[dtype]
    qkv = torch.from_numpy(_rand((b, s, 3 * h * d), 90)).to(cuda_device, dt)
    do = torch.from_numpy(_rand((b, s, h * d), 91)).to(cuda_device, dt)
    q, k, v = fb.heads(qkv, h)
    tc = dtype != "float32" and d <= 256
    assert [fb.tensor_cores(n, q) for n in fb.TENSOR_CORE_RULE] == \
        [tc, tc, tc]
    x = qkv.clone().requires_grad_()
    before = _counts()
    out = fa.fused_attention_qkv_cols(x, h)
    out.backward(do)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1,
                         before[3])
    o, lse = fb.flash_fwd(q, k, v)
    assert torch.equal(o.transpose(1, 2).reshape(b, s, h * d), out)
    o_r, lse_r = fb.flash_fwd_reference(q, k, v, d ** -0.5)
    assert out.dtype == dt
    assert (o.float() - o_r.float()).abs().max().item() <= \
        rel * o_r.float().abs().max().item()
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=0)
    g4 = do.view(b, s, h, d).transpose(1, 2)
    ref = fb.flash_bwd_reference(q, k, v, o, lse, g4, d ** -0.5)
    for g, r in zip(fb.heads(x.grad, h), ref):
        assert g.dtype == dt and torch.isfinite(g.float()).all()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= rel * r.float().abs().max().item()


# ---- the tensor-core K4 and K5 in fp16 and at head dims 129-256
# (csrc/flash_fwd.cu, csrc/flash_bwd.cu) against their plain versions at
# the blocked kernels' edge sequences (around the 64-key and 128-row tiles,
# past 1024, the 518-px model's 1370), in the qkv-view and dense layouts:
# D 64 and 256 compiled, D 136 on the 192 tiles with zero-filled columns,
# D 130 after one padded copy. bf16 within 2e-2 and fp16 within 5e-3 of
# the plain version's largest value (flipped roundings of p, ds and the
# stored outputs): of o, and of the call's dk and dv together (at S = 1,
# ds = p (dO·v - dO·o) is 0 but for rounding, since o = v, and so is dk);
# lse within 1e-4
TC_EDGE_S = (1, 63, 64, 65, 127, 129, 1025, 1370)
TC_REL = {"bfloat16": 2e-2, "float16": 5e-3}
TC_EDGE_CASES = [
    (dtype, layout, s, d) for dtype in TC_REL for layout in ("qkv", "dense")
    for s in TC_EDGE_S for d in (64, 136, 192, 256)] + [
    (dtype, "qkv", s, 130) for dtype in TC_REL for s in (65, 1370)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,layout,s,d", TC_EDGE_CASES)
def test_tc_k4_k5_match_plain_at_edges_on_cuda(cuda_device, dtype, layout,
                                               s, d):
    dt = getattr(torch, dtype)
    b, h = 1, 2
    q, k, v = _k4_layout(layout, b, h, s, d, 110, cuda_device, dt)
    do = torch.from_numpy(_rand((b, s, h, d), 114)).to(
        cuda_device, dt).transpose(1, 2)
    copy = d % 8 != 0
    want = "tensor_cores_copy" if copy else "tensor_cores"
    assert fb.kernel_route("flash_fwd", q, k, v) == want
    assert fb.kernel_route("flash_bwd_dkdv", q, k, v, do) == want
    scale = d ** -0.5
    o_r, lse_r = fb.flash_fwd_reference(q, k, v, scale)
    delta = fb.flash_delta(o_r, do)
    _, dk, dv = fb.heads(torch.empty((b, s, 3 * h * d), dtype=dt,
                                     device=cuda_device), h)
    before = _counts()
    o, lse = fb.flash_fwd(q, k, v)
    fb.flash_bwd_dkdv(q, k, v, do, lse_r, delta, dk, dv)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2],
                         before[3] + 2 * copy)
    rel = TC_REL[dtype]
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=0)
    want_grads = fb.flash_bwd_dkdv_reference(q, k, v, do, lse_r, delta,
                                             scale)
    grad_max = max(r.float().abs().max().item() for r in want_grads)
    for g, r in zip((o, dk, dv), (o_r, *want_grads)):
        assert g.dtype == dt and torch.isfinite(g.float()).all()
        err = (g.float() - r.float()).abs().max().item()
        ref_max = r.float().abs().max().item() if g is o else grad_max
        assert err <= rel * ref_max, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float16", 64), ("float16", 128),
                                     ("bfloat16", 192), ("float16", 256)])
def test_k5_tensor_cores_and_k6_cuda_cores_share_a_backward(cuda_device,
                                                            dtype, d):
    # one `flash_bwd` where K5 and K6 both run on the tensor cores
    # (csrc/flash_bwd.cu), into views of one dqkv buffer, against the plain
    # backward
    dt = getattr(torch, dtype)
    b, s, h = 1, 1370, 2
    qkv = torch.from_numpy(_rand((b, s, 3 * h * d), 120)).to(cuda_device, dt)
    q, k, v = fb.heads(qkv, h)
    do = torch.from_numpy(_rand((b, s, h, d), 121)).to(
        cuda_device, dt).transpose(1, 2)
    assert fb.kernel_route("flash_bwd_dkdv", q, k, v, do) == "tensor_cores"
    assert fb.kernel_route("flash_bwd_dq", q, k, v, do) == "tensor_cores"
    o, lse = fb.flash_fwd_reference(q, k, v, d ** -0.5)
    before = _counts()
    dqkv = fb.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2] + 1, before[3])
    rel = TC_REL[dtype]
    for g, r in zip(fb.heads(dqkv, h),
                    fb.flash_bwd_reference(q, k, v, o, lse, do, d ** -0.5)):
        assert g.dtype == dt and torch.isfinite(g.float()).all()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= rel * r.float().abs().max().item(), err


# K6 on the tensor cores (csrc/flash_bwd.cu) in fp16 at D 64 and 128 and in
# bf16 and fp16 past 128 (the wide tiles at 192 and 256, 136 and 200 with
# zero-filled columns, 130 after one `padded_copy`) at TC_EDGE_CASES'
# sequences, each call twice and bitwise equal, dq within TC_REL of the
# call's largest plain gradient (dq, dk, dv: at S = 1 ds is rounding noise)
TC_K6_EDGE_CASES = [
    (dtype, layout, s, d) for dtype in TC_REL for layout in ("qkv", "dense")
    for s in TC_EDGE_S
    for d in ((64, 128) if dtype == "float16" else ()) + (136, 192, 200, 256)
] + [(dtype, "qkv", s, 130) for dtype in TC_REL for s in (65, 1370)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,layout,s,d", TC_K6_EDGE_CASES)
def test_tc_k6_matches_plain_at_edges_on_cuda(cuda_device, dtype, layout, s,
                                              d):
    dt = getattr(torch, dtype)
    b, h = 1, 2
    q, k, v = _k4_layout(layout, b, h, s, d, 130, cuda_device, dt)
    do = torch.from_numpy(_rand((b, s, h, d), 134)).to(
        cuda_device, dt).transpose(1, 2)
    copy = d % 8 != 0
    assert fb.kernel_route("flash_bwd_dq", q, k, v, do) == \
        ("tensor_cores_copy" if copy else "tensor_cores")
    scale = d ** -0.5
    o_r, lse_r = fb.flash_fwd_reference(q, k, v, scale)
    delta = fb.flash_delta(o_r, do)
    dq, _, _ = fb.heads(torch.empty((b, s, 3 * h * d), dtype=dt,
                                    device=cuda_device), h)
    again = torch.empty_like(dq)
    before = _counts()
    fb.flash_bwd_dq(q, k, v, do, lse_r, delta, dq)
    fb.flash_bwd_dq(q, k, v, do, lse_r, delta, again)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2] + 2,
                         before[3] + 2 * copy)
    assert torch.equal(dq, again)
    want = fb.flash_bwd_reference(q, k, v, o_r, lse_r, do, scale)
    grad_max = max(r.float().abs().max().item() for r in want)
    assert dq.dtype == dt and torch.isfinite(dq.float()).all()
    err = (dq.float() - want[0].float()).abs().max().item()
    assert err <= TC_REL[dtype] * grad_max, err


# ---- the fp32 K5 and K6 (csrc/flash_bwd_simt.cu: flash_bwd_dkdv_simt_kernel
# and flash_bwd_dq_simt_kernel) at the edges of their 64-row tiles: S
# around one and two tiles, the compile-time head dims 64 and 128 and the
# ones that take them with zero columns (32, 48)
FP32_BWD_EDGE_S = (1, 63, 65, 129)
FP32_BWD_EDGE_D = (32, 48, 64, 128)
# of the call's largest gradient (of dq, dk and dv): both sides in fp32,
# other summation orders (JAX scales dk and dq per 256-key block, the plain
# version once). At S = 1, ds = p (dO·v - dO·o) is 0 but for rounding (o =
# v), so dq and dk are rounding noise and only dv sets the scale
FP32_BWD_EDGE_REL = 1e-5


def _jax_bwd(q, k, v, do, scale):
    """JAX's forward, then its dk/dv and dq kernels (`_bwd_dkdv_kernel`,
    `_bwd_dq_kernel`, through `_flash_bwd`) in interpret mode on the padded
    inputs -> o, lse (B, H, S) and dq, dk, dv (B, H, S, D), unpadded."""
    jfb = _jfb()
    b, h, s, d = q.shape
    sp = max(jfb._round_up(s, jfb.BLOCK_Q), jfb.BLOCK_Q)

    def prep(x):
        return jnp.pad(jnp.asarray(x).reshape(b * h, s, d),
                       ((0, 0), (0, sp - s), (0, 0)))

    def back(x):
        return np.asarray(x[:, :s]).reshape(b, h, s, -1)

    with pltpu.force_tpu_interpret_mode():
        qp, kp, vp = prep(q), prep(k), prep(v)
        o, lse = jfb._flash_fwd(qp, kp, vp, scale, s)
        dq, dk, dv = jfb._flash_bwd(qp, kp, vp, o, lse, prep(do), scale, s)
    return back(o), back(lse)[..., 0], back(dq), back(dk), back(dv)


# the wide fp32 K6 (flash_bwd_dq_wide_simt_kernel): S at the edges of its
# 64-row query blocks and 128-key tiles and past two tiles, D 136 and 200
# (the 192 and 256 tiles with zero columns) and 256
FP32_WIDE_K6_EDGE_S = (63, 64, 127, 128, 257)
FP32_WIDE_K6_EDGE_D = (136, 200, 256)


@pytest.mark.parametrize("s,d", [
    (s, d) for s in FP32_BWD_EDGE_S for d in FP32_BWD_EDGE_D] + [
    (s, d) for s in FP32_WIDE_EDGE_S for d in FP32_WIDE_EDGE_D] + [
    (s, d) for s in FP32_WIDE_K6_EDGE_S for d in FP32_WIDE_K6_EDGE_D])
def test_fp32_bwd_references_match_k5_k6_at_tile_edges(s, d):
    # the plain K5 and K6, which the fp32 kernels are held to on the card,
    # against JAX's kernels on the same lse and delta (delta = rowsum(dO o),
    # as JAX's _flash_bwd computes it); past D 128 the plain K5 (dk, dv) is
    # the wide fp32 K5's, K6's (dq) the wide fp32 K6's
    b, h = 1, 2
    q, k, v, do = (_rand((b, h, s, d), s + d + i) for i in range(4))
    scale = d ** -0.5
    o, lse, *want = _jax_bwd(q, k, v, do, scale)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    lse_t = torch.from_numpy(lse.copy())
    delta = fb.flash_delta(torch.from_numpy(o.copy()), t[3])
    dk, dv = fb.flash_bwd_dkdv_reference(*t, lse_t, delta, scale)
    dq = fb.flash_bwd_dq_reference(*t, lse_t, delta, scale)
    limit = FP32_BWD_EDGE_REL * max(np.abs(w).max() for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.dtype == torch.float32 and g.shape == (b, h, s, d)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=limit,
                                   err_msg=name)


# the same edges on the card, in the three layouts the kernels meet: views
# of a (B, S, 3·H·D) qkv buffer and contiguous (B, H, S, D) tensors (16-byte
# rows: 16-byte copies, but at D 48's zero columns) and views of a buffer
# whose rows start one float late (4-byte copies); and B·H over 65535
K5K6_FP32_EDGE_CASES = [
    (layout, (1, s, 2, d)) for layout in ("qkv", "dense")
    for s in FP32_BWD_EDGE_S + (1025,) for d in FP32_BWD_EDGE_D] + [
    ("unaligned", (1, s, 2, d)) for s in (65, 1025) for d in (48, 64)] + [
    ("qkv", (1, 8, 65537, 8)), ("dense", (65537, 8, 1, 8))]


def _fp32_bwd_operands(layout, b, s, h, d, seed, dev):
    """q, k, v, dO (B, H, S, D) fp32 on `dev`, dO a view of (B, S, H, D)
    memory as the model's backward has it."""
    def r(shape, i):
        return torch.from_numpy(_rand(shape, seed + i)).to(dev)
    if layout == "qkv":
        q, k, v = fb.heads(r((b, s, 3 * h * d), 0), h)
    elif layout == "unaligned":
        q, k, v = fb.heads(r((b, s, 3 * h * d + 1), 0)[..., 1:], h)
    else:
        q, k, v = (r((b, h, s, d), i) for i in range(3))
    return q, k, v, r((b, s, h, d), 5).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,shape", K5K6_FP32_EDGE_CASES)
def test_fp32_k5_k6_match_plain_at_tile_edges_on_cuda(cuda_device, layout,
                                                      shape):
    # each kernel run twice, bitwise equal (no float atomics), within
    # FP32_BWD_EDGE_REL of the plain version's largest gradient of the call;
    # no copy
    b, s, h, d = shape
    q, k, v, do = _fp32_bwd_operands(layout, b, s, h, d, 80, cuda_device)
    scale = d ** -0.5
    o, lse = fb.flash_fwd_reference(q, k, v, scale)
    delta = fb.flash_delta(o, do)
    before = _counts()
    runs = []
    for _ in range(2):
        dq, dk, dv = fb.heads(torch.empty((b, s, 3 * h * d),
                                          device=cuda_device), h)
        fb.flash_bwd_dkdv(q, k, v, do, lse, delta, dk, dv)
        fb.flash_bwd_dq(q, k, v, do, lse, delta, dq)
        runs.append((dq, dk, dv))
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 2, before[2] + 2, before[3])
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    want = (fb.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale),
            *fb.flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale))
    limit = FP32_BWD_EDGE_REL * max(w.abs().max().item() for w in want)
    for g, w in zip(runs[0], want):
        assert torch.isfinite(g).all()
        err = (g - w).abs().max().item()
        assert err <= limit, (err, limit)


# the fp32 K4's edges on the card: S around its 64-key tiles and 128-row
# blocks to the 518-px model's 1370, the head dims of K5K6's cases and 96,
# the same three layouts, and B·H over 65535
K4_FP32_EDGE_CASES = [
    (layout, (1, s, 2, d)) for layout in ("qkv", "dense")
    for s in (1, 63, 64, 65, 127, 128, 129, 197, 1025, 1370)
    for d in FP32_BWD_EDGE_D + (96,)] + [
    ("unaligned", (1, s, 2, d)) for s in (65, 1370) for d in (48, 64)] + [
    ("qkv", (1, 8, 65537, 8)), ("dense", (65537, 8, 1, 8))]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,shape", K4_FP32_EDGE_CASES)
def test_fp32_k4_matches_plain_at_tile_edges_on_cuda(cuda_device, layout,
                                                     shape):
    # run twice, bitwise equal (no float atomics), o and lse within
    # FP32_FWD_EDGE_REL of the plain version's largest magnitudes; no copy
    b, s, h, d = shape
    q, k, v, _ = _fp32_bwd_operands(layout, b, s, h, d, 90, cuda_device)
    before = _counts()
    (o, lse), (o2, lse2) = (fb.flash_fwd(q, k, v) for _ in range(2))
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 2, *before[1:])   # no copy
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    want = fb.flash_fwd_reference(q, k, v, d ** -0.5)
    for g, w in zip((o, lse), want):
        assert torch.isfinite(g).all()
        err = (g - w).abs().max().item()
        assert err <= FP32_FWD_EDGE_REL * w.abs().max().item(), err


# the fp32 K4 and K5 past 128 (flash_fwd_wide_simt_kernel,
# flash_bwd_dkdv_wide_simt_kernel) on the card: S around the 32-key groups
# of K4's score tiles and K5's key blocks, their 64-row query tiles and
# K4's 256-key score tiles up to the 518-px model's 1370; D 136 and 200
# (the 192 and 256 tiles with zero columns), 192 and 256; the three
# layouts; B·H over 65535
K4K5_FP32_WIDE_EDGE_CASES = [
    (layout, (1, s, 2, d)) for layout in ("qkv", "dense", "unaligned")
    for s in (1, 31, 32, 33, 63, 65, 129, 1025, 1370)
    for d in (136, 192, 200, 256)] + [
    ("qkv", (1, 8, 65537, 136)), ("dense", (65537, 8, 1, 136))]
# lse past D 128: at S = 1 it is one score, a sum of up to 256 products whose
# rounding does not shrink with |lse|, so it is held within
# FP32_FWD_EDGE_REL of max(|lse|, 1)
WIDE_LSE_FLOOR = 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("layout,shape", K4K5_FP32_WIDE_EDGE_CASES)
def test_fp32_wide_k4_k5_match_plain_at_tile_edges_on_cuda(cuda_device,
                                                           layout, shape):
    # each call twice, bitwise equal (no float atomics), no copy: o within
    # FP32_FWD_EDGE_REL of the plain version's largest magnitude (lse of
    # max(its largest, WIDE_LSE_FLOOR)), dk and dv (on the plain forward's
    # lse and delta) within FP32_BWD_EDGE_REL of the call's largest plain
    # gradient
    b, s, h, d = shape
    q, k, v, do = _fp32_bwd_operands(layout, b, s, h, d, 70 + s + d,
                                     cuda_device)
    scale = d ** -0.5
    before = _counts()
    (o, lse), (o2, lse2) = (fb.flash_fwd(q, k, v) for _ in range(2))
    o_r, lse_r = fb.flash_fwd_reference(q, k, v, scale)
    delta = fb.flash_delta(o_r, do)
    runs = []
    for _ in range(2):
        _, dk, dv = fb.heads(torch.empty((b, s, 3 * h * d),
                                         device=cuda_device), h)
        fb.flash_bwd_dkdv(q, k, v, do, lse_r, delta, dk, dv)
        runs.append((dk, dv))
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 2, before[1] + 2, *before[2:])
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o - o_r).abs().max().item() <= \
        FP32_FWD_EDGE_REL * o_r.abs().max().item()
    assert (lse - lse_r).abs().max().item() <= FP32_FWD_EDGE_REL * max(
        lse_r.abs().max().item(), WIDE_LSE_FLOOR)
    want = fb.flash_bwd_reference(q, k, v, o_r, lse_r, do, scale)
    limit = FP32_BWD_EDGE_REL * max(w.abs().max().item() for w in want)
    for g, w in zip(runs[0], want[1:]):
        assert torch.isfinite(g).all()
        err = (g - w).abs().max().item()
        assert err <= limit, (err, limit)


# the wide fp32 K6 (flash_bwd_dq_wide_simt_kernel) on the card: S around
# the 32-key groups and 128-key tiles of its scores, its 16-key row pieces
# of K and its 64-row query blocks up to the 518-px model's 1370; D 136
# and 200 (the 192 and 256 tiles with zero columns), 192 and 256; the
# three layouts; B·H over 65535
K6_FP32_WIDE_EDGE_CASES = [
    (layout, (1, s, 2, d)) for layout in ("qkv", "dense", "unaligned")
    for s in (1, 17, 31, 33, 63, 65, 127, 128, 129, 257, 1025, 1370)
    for d in (136, 192, 200, 256)] + [
    ("qkv", (1, 8, 65537, 136)), ("dense", (65537, 8, 1, 256))]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,shape", K6_FP32_WIDE_EDGE_CASES)
def test_fp32_wide_k6_matches_plain_at_tile_edges_on_cuda(cuda_device,
                                                          layout, shape):
    # twice, bitwise equal (no float atomics), no copy: dq (on the plain
    # forward's lse and delta) within FP32_BWD_EDGE_REL of the call's
    # largest plain gradient
    b, s, h, d = shape
    q, k, v, do = _fp32_bwd_operands(layout, b, s, h, d, 170 + s + d,
                                     cuda_device)
    scale = d ** -0.5
    o_r, lse_r = fb.flash_fwd_reference(q, k, v, scale)
    delta = fb.flash_delta(o_r, do)
    before = _counts()
    runs = []
    for _ in range(2):
        dq = fb.heads(torch.empty((b, s, 3 * h * d), device=cuda_device),
                      h)[0]
        runs.append(fb.flash_bwd_dq(q, k, v, do, lse_r, delta, dq))
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2] + 2, before[3])
    assert torch.equal(*runs)
    want = fb.flash_bwd_reference(q, k, v, o_r, lse_r, do, scale)
    limit = FP32_BWD_EDGE_REL * max(w.abs().max().item() for w in want)
    assert torch.isfinite(runs[0]).all()
    err = (runs[0] - want[0]).abs().max().item()
    assert err <= limit, (err, limit)


# a head dim past the register tiles' 256
FP32_CHUNKED_D = 320
# one session in a fresh process: in a long one (the whole cuda suite)
# torch.profiler's sessions stop recording kernels
_K5K6_TRACE = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked as fb
out = {}
for layout in ("qkv", "unaligned"):
    for d in %r:
        h, s = 2, 300
        late = layout == "unaligned"
        x = torch.randn(1, s, 3 * h * d + late, device="cuda")[..., late:]
        q, k, v = fb.heads(x, h)
        do = torch.randn(1, h, s, d, device="cuda")
        o, lse = fb.flash_fwd_reference(q, k, v, d ** -0.5)
        delta = fb.flash_delta(o, do)
        g = torch.empty(1, h, s, d, device="cuda")
        calls = {"dkdv": lambda: fb.flash_bwd_dkdv(q, k, v, do, lse, delta,
                                                   g, g.clone()),
                 "dq": lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, g),
                 "fwd": lambda: fb.flash_fwd(q, k, v)}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            out[f"{name}{d}{layout}"] = sorted(
                e.key for e in prof.key_averages()
                if e.device_type.name == "CUDA"
                and "anonymous namespace" in e.key)
print(json.dumps(out))
""" % (FP32_BWD_EDGE_D + FP32_WIDE_EDGE_D + (FP32_CHUNKED_D,),)


@pytest.fixture(scope="module")
def fp32_k5k6_trace():
    """The csrc/ kernels one fp32 call of K5, of K6 and of K4 launches at
    each of FP32_BWD_EDGE_D, FP32_WIDE_EDGE_D and FP32_CHUNKED_D, in a qkv
    view and in one whose rows start a float late, traced by
    torch.profiler."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    res = subprocess.run([sys.executable, "-c", _K5K6_TRACE],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["qkv", "unaligned"])
@pytest.mark.parametrize("d", FP32_BWD_EDGE_D)
def test_fp32_k5_k6_launch_the_register_tiled_kernels_alone(fp32_k5k6_trace,
                                                            d, layout):
    # <head dim, block rows, streamed buffers>: 128 rows and two buffers
    # at D <= 64, 64 rows and one at D <= 128
    args = "64, 128, 2" if d <= 64 else "128, 64, 1"
    for name in ("dkdv", "dq"):
        names = fp32_k5k6_trace[f"{name}{d}{layout}"]
        assert len(names) == 1 and \
            f"::flash_bwd_{name}_simt_kernel<{args}>(" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["qkv", "unaligned"])
@pytest.mark.parametrize("d", FP32_BWD_EDGE_D)
def test_fp32_k4_launches_the_register_tiled_kernel_alone(fp32_k5k6_trace,
                                                          d, layout):
    # <head dim>: 64 or 128 at compile time
    args = "64" if d <= 64 else "128"
    names = fp32_k5k6_trace[f"fwd{d}{layout}"]
    assert len(names) == 1 and \
        f"::flash_fwd_simt_kernel<{args}>(" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["qkv", "unaligned"])
@pytest.mark.parametrize("d", FP32_WIDE_EDGE_D)
def test_fp32_wide_k4_k5_launch_their_kernels_alone(fp32_k5k6_trace, d,
                                                    layout):
    # past 128 K4, K5 and K6 on the wide register tiles (<kD>, 192 or 256)
    kd = 192 if d <= 192 else 256
    for name in ("fwd", "dkdv", "dq"):
        kernel = f"flash_{'fwd' if name == 'fwd' else 'bwd_' + name}" \
            f"_wide_simt_kernel<{kd}>("
        names = fp32_k5k6_trace[f"{name}{d}{layout}"]
        assert len(names) == 1 and f"::{kernel}" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["qkv", "unaligned"])
def test_fp32_past_256_launches_the_chunked_loops_alone(fp32_k5k6_trace,
                                                        layout):
    # past 256 the fp32 K4, K5 and K6 run csrc/flash_blocked.cu's run-time
    # head dim in 64-column chunks
    for name in ("fwd", "dkdv", "dq"):
        kernel = f"flash_{'fwd' if name == 'fwd' else 'bwd_' + name}" \
            "_wide_kernel<float>("
        names = fp32_k5k6_trace[f"{name}{FP32_CHUNKED_D}{layout}"]
        assert len(names) == 1 and f"::{kernel}" in names[0], names


# The kernels one call of the tensor-core K4 and K5, and of K6 beside them,
# launch (torch.profiler, in a fresh process as fp32_k5k6_trace): K4, K5
# and K6 on csrc/flash_fwd.cu's and csrc/flash_bwd.cu's kernels, which
# take tensor maps
TC_TRACE_CASES = (("float16", 64), ("float16", 128), ("bfloat16", 192),
                  ("float16", 192), ("bfloat16", 256), ("float16", 256))
_TC_TRACE = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked as fb
out = {}
for dtype, d in %r:
    dt = getattr(torch, dtype)
    h, s = 2, 1100
    q, k, v = fb.heads(torch.randn(1, s, 3 * h * d, device="cuda").to(dt), h)
    do = torch.randn(1, h, s, d, device="cuda").to(dt)
    o, lse = fb.flash_fwd_reference(q, k, v, d ** -0.5)
    delta = fb.flash_delta(o, do)
    g = torch.empty(1, h, s, d, device="cuda", dtype=dt)
    calls = {"dkdv": lambda: fb.flash_bwd_dkdv(q, k, v, do, lse, delta, g,
                                               g.clone()),
             "dq": lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, g),
             "fwd": lambda: fb.flash_fwd(q, k, v)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[f"{name}{dtype}{d}"] = sorted(
            e.key for e in prof.key_averages()
            if e.device_type.name == "CUDA"
            and "anonymous namespace" in e.key)
print(json.dumps(out))
""" % (TC_TRACE_CASES,)


@pytest.fixture(scope="module")
def tc_trace():
    """The csrc/ kernels one call of K4, K5 and K6 launches at each of
    TC_TRACE_CASES on a qkv buffer's views, traced by torch.profiler."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    res = subprocess.run([sys.executable, "-c", _TC_TRACE],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", TC_TRACE_CASES)
def test_tc_k4_k5_launch_their_kernels_alone(tc_trace, dtype, d):
    # <element type, compiled head dim>; K6 on csrc/flash_bwd.cu's tensor
    # cores too, its wide tiles past 128 a kernel of their own
    t = {"bfloat16": "__nv_bfloat16", "float16": "__half"}[dtype]
    kd = next(x for x in (64, 128, 192, 256) if d <= x)
    k6 = "flash_bwd_dq_kernel" if d <= 128 else "flash_bwd_dq_tc_wide_kernel"
    for name, kernel in (("fwd", "flash_fwd_kernel"),
                         ("dkdv", "flash_bwd_dkdv_kernel"), ("dq", k6)):
        names = tc_trace[f"{name}{dtype}{d}"]
        assert len(names) == 1 and \
            f"::{kernel}<{t}, {kd}>(CUtensorMap" in names[0], names
