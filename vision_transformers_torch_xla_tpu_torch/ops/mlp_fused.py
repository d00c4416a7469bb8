"""The transformer MLP with a fused backward (fc1 -> gelu_tanh -> fc2).

Counterpart of vision_transformers_torch_xla_tpu/ops/mlp_fused.py. The
forward is the plain one: two products and the GELU in the compute dtype
(:149-157). The backward fuses what autograd would do in three passes over
device memory into the product that gives da anyway:

    dh  = (dy · W2ᵀ) ⊙ gelu_tanh′(h)   da in fp32, never stored
    a   = gelu_tanh(h)                  regenerated, so the forward does
                                        not keep it for dW2
    db1 = Σ dh                          fp32 partials per row tile

`fc2_bwd` -> csrc/mlp_fused.cu, the port of `_fc2_bwd_kernel` (:65,
ROADMAP K3): bf16 and fp16 on the tensor cores (TMA, mbarriers, wgmma, the
epilogue's dh and a stored by TMA), fp32 on the CUDA cores, as the JAX
kernel runs in the inputs' dtype. Its plain version
`fc2_bwd_reference` runs only for tensors on the CPU; for CUDA tensors the
wrapper launches the kernel or raises.
dx, dW1, dW2 and db2 stay torch products and sums on dh, a and dy, as the
JAX package left them to XLA.

`MlpGelu` is the custom VJP `_mlp_gelu` (:134-187) as an autograd Function
and `mlp_gelu` the public entry (:190), with the JAX layout of the weights:
w1 (D, K), w2 (K, O). models/layers.py::Mlp passes its timm (out, in)
weights transposed.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vision_transformers_torch_xla_tpu_torch.ops import cuda_build
from vision_transformers_torch_xla_tpu_torch.ops.cuda_build import (
    KERNEL_DTYPES,
)
from vision_transformers_torch_xla_tpu_torch.ops.flash_attention import (
    weight_grad,
)

_SQRT_2_OVER_PI = 0.7978845608028654  # sqrt(2/pi), gelu tanh constant
_GELU_C = 0.044715

WIDTH_MULTIPLE = 128   # every width of the fused MLP (the JAX lane rule)
ROW_TILE = 128         # rows of dy and h per kernel block: one db1 partial
MAX_ROWS = 2 ** 31 - 1  # the kernels count rows in int; tiles ride grid x
DATA_ALIGN = 16        # bytes: the bf16/fp16 kernel's tensor maps' data

# Launches of the fc2-backward kernel in this process. Only the wrapper's
# launches add to it; callers may reset it to 0.
FC2_BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def build_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the fc2-backward kernel's library."""
    lib = cuda_build.load_library("mlp_fused", ("mlp_fused.cu",))
    lib.vtx_fc2_bwd.restype = ctypes.c_int
    lib.vtx_fc2_bwd.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    lib.vtx_fc2_bwd_smem.restype = ctypes.c_int
    lib.vtx_fc2_bwd_smem.argtypes = []
    lib.vtx_cuda_error_string.restype = ctypes.c_char_p
    lib.vtx_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def gelu_tanh_val_grad(hf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gelu(h), gelu′(h)) of the tanh approximation, fp32 in and out
    (:50-62):  g(x) = 0.5 x (1 + t),  t = tanh(c (x + 0.044715 x³)),
    g′(x) = 0.5 (1 + t) + 0.5 x (1 - t²) c (1 + 3·0.044715 x²)."""
    c = _SQRT_2_OVER_PI
    t = torch.tanh(c * (hf + _GELU_C * hf * hf * hf))
    val = 0.5 * hf * (1.0 + t)
    grad = 0.5 * (1.0 + t) + 0.5 * hf * (1.0 - t * t) * c * (
        1.0 + 3.0 * _GELU_C * hf * hf)
    return val, grad


def fc2_bwd_reference(dy: torch.Tensor, w2: torch.Tensor, h: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fc2-backward kernel, in its cast order.

    dy (B, S, O), w2 (O, K) (fc2's timm weight), h (B, S, K) -> dh and a
    (B, S, K) in h's dtype and db1 (K,) fp32. da = dy·w2 accumulates in
    fp32 from the working-dtype values; gelu and gelu′ are fp32 from fp32(h);
    dh = da·gelu′ is rounded once; db1 sums the fp32 dh, before that
    rounding (:74-87)."""
    da = torch.matmul(dy.float(), w2.float())
    a, gp = gelu_tanh_val_grad(h.float())
    dh = da * gp
    return dh.to(h.dtype), a.to(h.dtype), dh.sum(dim=(0, 1))


def _check_cuda(dy: torch.Tensor, w2: torch.Tensor, h: torch.Tensor) -> None:
    """The kernel's contract; raises on what it does not take: devices,
    dtypes, layouts (contiguous; the bf16 and fp16 kernel reads and writes
    through TMA tensor maps, which need 16-byte-aligned data), widths and a
    row count that fits an int."""
    tensors = (dy, w2, h)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"fc2_bwd runs on cpu or cuda tensors, not "
                         f"{[str(t.device) for t in tensors]}")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= set(KERNEL_DTYPES):
        raise TypeError(f"the fc2-backward kernel takes tensors of one of "
                        f"{KERNEL_DTYPES}, not {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fc2_bwd takes contiguous tensors")
    if dy.dtype != torch.float32 and any(t.data_ptr() % DATA_ALIGN
                                         for t in tensors):
        raise ValueError(f"fc2_bwd takes {dy.dtype} tensors whose data is "
                         f"{DATA_ALIGN}-byte aligned")
    o, k = w2.shape
    if o % WIDTH_MULTIPLE or k % WIDTH_MULTIPLE:
        raise ValueError(f"fc2_bwd takes widths that are multiples of "
                         f"{WIDTH_MULTIPLE}, not out {o}, hidden {k}")
    rows = dy.shape[0] * dy.shape[1]
    if rows > MAX_ROWS:
        raise ValueError(f"fc2_bwd takes at most {MAX_ROWS} rows, not {rows}")


def fc2_bwd(dy: torch.Tensor, w2: torch.Tensor, h: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dh = (dy·w2) ⊙ gelu_tanh′(h), a = gelu_tanh(h) and db1 = Σ dh (fp32).

    dy (B, S, O), w2 (O, K) = fc2's timm weight in dy's dtype, h (B, S, K).
    Returns dh and a (B, S, K) in h's dtype and db1 (K,) fp32, the sum of
    the kernel's per-row-tile partials."""
    global FC2_BWD_LAUNCHES
    b, s, o = dy.shape
    k = w2.shape[1]
    if w2.shape != (o, k) or h.shape != (b, s, k):
        raise ValueError(f"dy {tuple(dy.shape)}, w2 {tuple(w2.shape)} and h "
                         f"{tuple(h.shape)} do not fit")
    if dy.device.type == "cpu":
        return fc2_bwd_reference(dy, w2, h)
    _check_cuda(dy, w2, h)
    rows = b * s
    dh = torch.empty_like(h)
    a = torch.empty_like(h)
    part = torch.empty((-(-rows // ROW_TILE), k), dtype=torch.float32,
                       device=h.device)
    lib = build_kernels()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.vtx_fc2_bwd(dy.data_ptr(), w2.data_ptr(), h.data_ptr(),
                             dh.data_ptr(), a.data_ptr(), part.data_ptr(),
                             rows, o, k, cuda_build.dtype_code(h.dtype),
                             stream)
    if rc:
        raise RuntimeError("fc2-backward kernel launch failed: "
                           + lib.vtx_cuda_error_string(rc).decode())
    FC2_BWD_LAUNCHES += 1
    return dh, a, part.sum(dim=0)


class MlpGelu(torch.autograd.Function):
    """fc1 -> gelu_tanh -> fc2 under one gradient, as the JAX custom VJP.

    Forward: the plain products and GELU in x's dtype (:149-157); x, h, w1
    and w2 are saved, not a.
    Backward: `fc2_bwd` gives dh, a and db1; dx = dh·w1ᵀ in the compute
    dtype, dW1 = xᵀ·dh and dW2 = aᵀ·dy with fp32 accumulators, db2 = Σ dy
    in fp32."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        h = torch.matmul(x, w1.to(x.dtype))
        if b1 is not None:
            h = h + b1.to(x.dtype)
        y = torch.matmul(F.gelu(h, approximate="tanh"), w2.to(x.dtype))
        if b2 is not None:
            y = y + b2.to(x.dtype)
        ctx.save_for_backward(x, h, w1, w2)
        ctx.bias_dtypes = tuple(b.dtype if b is not None else None
                                for b in (b1, b2))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, h, w1, w2 = ctx.saved_tensors
        dy = dy.contiguous()
        # fc2's (O, K) timm layout: w2 came in as its transposed view
        dh, a, db1 = fc2_bwd(dy, w2.to(dy.dtype).t().contiguous(), h)
        need = ctx.needs_input_grad
        dx = torch.matmul(dh, w1.to(dh.dtype).t()) if need[0] else None
        dw1 = weight_grad(x, dh).to(w1.dtype) if need[1] else None
        dw2 = weight_grad(a, dy).to(w2.dtype) if need[3] else None
        b1_dtype, b2_dtype = ctx.bias_dtypes
        db1_out = db1.to(b1_dtype) \
            if b1_dtype is not None and need[2] else None
        db2 = dy.sum(dim=(0, 1), dtype=torch.float32).to(b2_dtype) \
            if b2_dtype is not None and need[4] else None
        return dx, dw1, db1_out, dw2, db2


def _check_widths(x: torch.Tensor, w1: torch.Tensor,
                  w2: torch.Tensor) -> None:
    if x.shape[-1] % WIDTH_MULTIPLE or w1.shape[1] % WIDTH_MULTIPLE or \
            w2.shape[1] % WIDTH_MULTIPLE:
        raise ValueError(
            f"mlp_gelu needs widths that are multiples of {WIDTH_MULTIPLE}, "
            f"got d={x.shape[-1]} hidden={w1.shape[1]} out={w2.shape[1]}")


def mlp_gelu(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
             w2: torch.Tensor, b2: Optional[torch.Tensor]) -> torch.Tensor:
    """Transformer MLP (fc1 -> tanh-gelu -> fc2) with the fused backward.

    x: (B, S, D) in the compute dtype; w1: (D, K); w2: (K, O); biases
    optional but paired. D, K and O must be multiples of 128, as in the JAX
    function; models/layers.py::Mlp takes its plain path otherwise."""
    if (b1 is None) != (b2 is None):
        raise ValueError("mlp_gelu: biases must be both present or both absent")
    _check_widths(x, w1, w2)
    return MlpGelu.apply(x, w1, b1, w2, b2)


def mlp_gelu_columns(x: torch.Tensor, w1: torch.Tensor,
                     b1: Optional[torch.Tensor],
                     w2: torch.Tensor) -> torch.Tensor:
    """One model-axis rank's part of `mlp_gelu` (parallel/split.py): w1 and
    b1 are its columns of fc1, w2 the same rows of fc2's (K, O) weight.
    Returns the partial fc2 product without fc2's bias, which the caller
    sums over the ranks before it adds the bias once. The backward is the
    same custom VJP: K3 runs on the rank's columns, its db1 partials
    those columns' own, and no collective enters it."""
    _check_widths(x, w1, w2)
    return MlpGelu.apply(x, w1, b1, w2, None)
