"""The fp32 backward of K8, K10 and K12 (one function over three layouts)
at the edges of its tiles.

On the CPU the wrappers run their plain versions: `fused_bwd` (K8) on
separate (B, H, S, D) q, k, v and dO, `hp_bwd` (K10) on a (B, S, 3·H·D)
qkv buffer and `qkv_bwd` (K12) on a (B, S, 3, H, D) one, each against the
JAX kernel in interpret mode (`_bwd_call`, `_hp_bwd_call`,
`_qkv_bwd_call`) at S around the kernels' 64-row tiles and head dims 32 to
128, and at three of those S at 136 and 256, in fp32. Inputs come from a
numpy seed.

The `cuda` cases hold the kernels of csrc/hp_bwd_simt.cu
(hp_bwd_stats_simt_kernel, hp_bwd_dkdv_simt_kernel and
hp_bwd_dq_sum_kernel to D 128; past it the wide tiles,
hp_bwd_stats_wide_simt_kernel and hp_bwd_dkdv_wide_simt_kernel, with the
same sum) against those plain
versions on the card, each call twice and bitwise equal, in every layout
they meet (views of a qkv buffer, separate tensors, rows that are not
16-byte aligned, strides the kernels refuse and the wrapper copies once),
and check in a profiler trace that one call launches those three kernels
alone; they skip without a card. The JAX package is imported inside the
JAX helpers, so that the `cuda` cases also run where flax is missing.
"""
import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa
from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked as fb

EDGE_S = (1, 63, 65, 129, 197)
EDGE_D = (32, 48, 64, 128)
# (S, D): every EDGE_S at EDGE_D, and the wide tiles' head dims (136
# zero-filled to 192, 256) at three of them
EDGE_SD = [(s, d) for s in EDGE_S for d in EDGE_D] + [
    (s, d) for s in (1, 65, 197) for d in (136, 256)]
# of the call's largest gradient (of dq, dk and dv): both sides in fp32,
# other summation orders and exp. At S = 1, ds = p (dp - dp·p) is 0 but
# for rounding, so dq and dk are rounding noise and dv sets the scale
EDGE_REL = 1e-5
KERNELS = ("k8", "k10", "k12")
H = 2   # the JAX head-pair kernel (K10) takes heads in pairs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_grads(kernel, qkv, do):
    """The JAX kernel's dq, dk, dv (B, H, S, D) in interpret mode, from a
    (B, S, 3·H·D) qkv and (B, S, H·D) dO, padded as the JAX entry points
    pad S (to a multiple of 128) where the kernel wants it."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops import flash_attention as jfa

    b, s, c = qkv.shape
    d = c // (3 * H)
    sp = -(-s // 128) * 128
    scale = d ** -0.5
    x5 = qkv.reshape(b, s, 3, H, d)

    def pad(x, axis):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, sp - s)
        return jnp.pad(jnp.asarray(x), widths)

    with pltpu.force_tpu_interpret_mode():
        if kernel == "k8":
            q, k, v = (pad(x5[:, :, i].transpose(0, 2, 1, 3).reshape(
                b * H, s, d), 1) for i in range(3))
            g = pad(do.reshape(b, s, H, d).transpose(0, 2, 1, 3).reshape(
                b * H, s, d), 1)
            grads = [np.asarray(t[:, :s]).reshape(b, H, s, d)
                     for t in jfa._bwd_call(q, k, v, g, scale, s)]
            return grads
        if kernel == "k10":
            dqkv = np.asarray(jfa._hp_bwd_call(jnp.asarray(qkv),
                                               jnp.asarray(do), scale, s, H,
                                               d))
        else:
            dqkv = np.asarray(jfa._qkv_bwd_call(
                pad(qkv.reshape(b, s, 3 * H, d), 1),
                pad(do.reshape(b, s, H, d), 1), scale, s))[:, :s]
    g5 = dqkv.reshape(b, s, 3, H, d)
    return [g5[:, :, i].transpose(0, 2, 1, 3) for i in range(3)]


def _port_grads(kernel, qkv, do):
    """The port's wrapper on the same values: dq, dk, dv (B, H, S, D)."""
    b, s, c = qkv.shape
    d = c // (3 * H)
    if kernel == "k8":
        q, k, v = (x.contiguous() for x in fb.heads(qkv, H))
        g = do.view(b, s, H, d).transpose(1, 2).contiguous()
        return fa.fused_bwd(q, k, v, g)
    if kernel == "k10":
        return fb.heads(fa.hp_bwd(qkv, do, H), H)
    dqkv = fa.qkv_bwd(qkv.view(b, s, 3, H, d), do)
    return fb.heads(dqkv.reshape(b, s, c), H)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("s,d", EDGE_SD)
def test_plain_fp32_bwd_matches_jax_at_tile_edges(s, d, kernel):
    qkv = _rand((1, s, 3 * H * d), 31 * s + d)
    do = _rand((1, s, H * d), 31 * s + d + 1)
    want = _jax_grads(kernel, qkv, do)
    got = _port_grads(kernel, torch.from_numpy(qkv), torch.from_numpy(do))
    limit = EDGE_REL * max(np.abs(w).max() for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == (1, H, s, d)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=limit,
                                   err_msg=name)


# ---- the card: csrc/hp_bwd_simt.cu against the plain versions

# (kernel, layout, (B, S, H, D)): S around the 64-row tiles and 128-row
# blocks up to the kernels' MAX_SEQ, D 32 to 256 (64, 128, 192 and 256
# compiled, the others zero-filled); K10 and K12 in place in their buffers,
# K8 on
# separate contiguous tensors, on views whose rows start two floats late
# (the kernels' 4-byte copies: no copy in Python) and on views of odd row
# stride (`_launch_views` copies them once); B·H over 65535
CUDA_EDGE_S = (1, 63, 64, 65, 127, 128, 129, 197, 1024)
CUDA_EDGE_D = (32, 48, 64, 96, 128, 136, 192, 256)
CUDA_EDGE_CASES = [
    (kernel, layout, (1, s, H, d))
    for kernel, layout in (("k10", "qkv"), ("k12", "qkv"), ("k8", "dense"))
    for s in CUDA_EDGE_S for d in CUDA_EDGE_D] + [
    ("k8", layout, (2, s, 3, d)) for layout in ("late", "odd_stride")
    for s in (65, 197) for d in (48, 64)] + [
    ("k10", "qkv", (1, 8, 65537, 8)), ("k8", "dense", (65537, 8, 1, 8))]


def _cuda_call(kernel, layout, shape, dev):
    """(the wrapper's call, its plain version's) on seeded fp32 operands
    laid out as `layout`; each returns dq, dk, dv."""
    b, s, h, d = shape
    scale = d ** -0.5

    def r(shape, i):
        return torch.from_numpy(_rand(shape, 4000 + s + d + i)).to(dev)

    do = r((b, s, h * d), 9)
    if kernel in ("k10", "k12"):
        qkv = r((b, s, 3 * h * d), 0)

        def want():
            return fb.heads(fa.hp_bwd_reference(qkv, do, h, scale), h)
        if kernel == "k10":
            return lambda: fb.heads(fa.hp_bwd(qkv, do, h), h), want
        qkv5 = qkv.view(b, s, 3, h, d)
        return (lambda: fb.heads(fa.qkv_bwd(qkv5, do).reshape(qkv.shape), h),
                want)
    if layout == "dense":
        q, k, v = (r((b, h, s, d), i) for i in range(3))
    else:
        extra = 2 if layout == "late" else 1
        buf = r((b, s, 3 * h * d + extra), 0)
        q, k, v = fb.heads(buf[..., extra:] if layout == "late"
                           else buf[..., :-1], h)
    g = do.view(b, s, h, d).transpose(1, 2)
    return (lambda: fa.fused_bwd(q, k, v, g),
            lambda: fa.fused_bwd_reference(q, k, v, g, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,layout,shape", CUDA_EDGE_CASES)
def test_fp32_bwd_matches_plain_at_tile_edges_on_cuda(cuda_device, kernel,
                                                      layout, shape):
    # each call run twice, bitwise equal (no float atomics), dq, dk, dv
    # within EDGE_REL of the plain version's largest gradient; one copy
    # exactly where _stride_array refuses the views (odd row stride)
    call, plain = _cuda_call(kernel, layout, shape, cuda_device)
    copies = fb.COPIES
    runs = [call(), call()]
    torch.cuda.synchronize()
    assert fb.COPIES - copies == 2 * (layout == "odd_stride")
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    want = plain()
    limit = EDGE_REL * max(w.abs().max().item() for w in want)
    for g, w in zip(runs[0], want):
        assert torch.isfinite(g).all()
        err = (g - w).abs().max().item()
        assert err <= limit, (err, limit)


# one session in a fresh process: in a long one (the whole cuda suite)
# torch.profiler's sessions stop recording kernels; EDGE_D and the wide
# tiles' head dims
TRACE_D = EDGE_D + (136, 192, 256)
_TRACE = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa
from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked as fb
out = {}
for d in %r:
    b, s, h = 2, 197, 2
    qkv = torch.randn(b, s, 3 * h * d, device="cuda")
    do = torch.randn(b, s, h * d, device="cuda")
    q, k, v = (x.contiguous() for x in fb.heads(qkv, h))
    g = do.view(b, s, h, d).transpose(1, 2)
    calls = {"k8": lambda: fa.fused_bwd(q, k, v, g),
             "k10": lambda: fa.hp_bwd(qkv, do, h),
             "k12": lambda: fa.qkv_bwd(qkv.view(b, s, 3, h, d), do)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[f"{name}{d}"] = sorted(
            e.key for e in prof.key_averages()
            if e.device_type.name == "CUDA"
            and "anonymous namespace" in e.key)
print(json.dumps(out))
""" % (TRACE_D,)


@pytest.fixture(scope="module")
def fp32_bwd_trace():
    """The csrc/ kernels one fp32 call of K8, K10 and K12 launches at each
    of TRACE_D, traced by torch.profiler."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    res = subprocess.run([sys.executable, "-c", _TRACE],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("d", TRACE_D)
def test_fp32_bwd_launches_the_register_tiled_kernels_alone(fp32_bwd_trace,
                                                            d, kernel):
    # <head dim, block rows, streamed buffers>: the dk/dv blocks 128 keys
    # and two buffers at D <= 64, 64 keys and one at D <= 128; the stats
    # blocks 128 queries, with two buffers and one; past 128 the wide
    # tiles at the next compiled head dim
    if d > 128:
        kd = 192 if d <= 192 else 256
        wants = [f"::hp_bwd_stats_wide_simt_kernel<{kd}>(",
                 f"::hp_bwd_dkdv_wide_simt_kernel<{kd}>(",
                 "::hp_bwd_dq_sum_kernel("]
    else:
        stats, dkdv = (("64, 128, 2", "64, 128, 2") if d <= 64
                       else ("128, 128, 1", "128, 64, 1"))
        wants = [f"::hp_bwd_stats_simt_kernel<{stats}>(",
                 f"::hp_bwd_dkdv_simt_kernel<{dkdv}>(",
                 "::hp_bwd_dq_sum_kernel("]
    names = fp32_bwd_trace[f"{kernel}{d}"]
    assert len(names) == 3 and all(any(w in n for n in names)
                                   for w in wants), names
