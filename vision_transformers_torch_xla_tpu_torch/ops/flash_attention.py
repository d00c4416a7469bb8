"""Attention over the fused qkv projection: Hopper kernels and plain versions.

Counterpart of vision_transformers_torch_xla_tpu/ops/flash_attention.py
::qkv_proj_attention (:703) and its custom VJP `_qkv_proj_attention`
(:630-700). The projection x·W (+b) runs in the compute dtype through
torch.matmul, as XLA ran it outside the Pallas calls. The attention reads
q, k and v straight from the (B, S, 3·H·D) projection output:

* `attn_fwd` -> csrc/attn_fwd.cu, the port of `_hp_fwd_stats_kernel`
  (:291, ROADMAP K1), which also writes the softmax row stats;
* `attn_bwd` -> csrc/attn_bwd.cu, the port of `_hp_bwd_pi_kernel` (:495,
  ROADMAP K2), which recomputes the probabilities from those stats and
  writes dqkv in the standard column order plus fp32 qkv-bias partials.

`fused_attention_qkv_cols` (:459) is attention off a qkv buffer the caller
projected. For S <= MAX_SEQ it is the head-pair custom VJP
`_hp_partitioned` (:437-456) as the autograd Function `HeadPairAttention`:

* `hp_fwd` -> csrc/attn_fwd.cu without stats, the port of `_hp_fwd_kernel`
  (:171, ROADMAP K9): the same function as K1's o, in the same cast order;
* `hp_bwd` -> csrc/hp_bwd.cu, the port of `_hp_bwd_kernel` (:212, ROADMAP
  K10), which recomputes the probabilities from q and k alone.

Longer sequences go to the blocked kernels of ops/flash_blocked.py (K4-K6).

Each wrapper runs its plain version (`attn_fwd_reference`,
`attn_bwd_reference`, `hp_bwd_reference`) only for tensors on the CPU. For
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vision_transformers_torch_xla_tpu_torch.ops import cuda_build
from vision_transformers_torch_xla_tpu_torch.ops.bias_grad import bias_add
from vision_transformers_torch_xla_tpu_torch.ops.flash_blocked import (
    FlashAttentionBlocked,
)

MAX_SEQ = 1024       # longer sequences are ops/flash_blocked.py's (K4-K6)
MAX_HEAD_DIM = 128
MAX_GRID_DIM = 65535  # batch and heads ride the grid's y and z dimensions

# Launches of the attention kernels in this process. Only the wrappers'
# launches add to them; callers may reset them to 0.
ATTN_FWD_LAUNCHES = 0
ATTN_BWD_LAUNCHES = 0
HP_FWD_LAUNCHES = 0
HP_BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _load(name: str, fn: str, argtypes) -> ctypes.CDLL:
    lib = cuda_build.load_library(name, (f"{name}.cu",))
    getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, fn).argtypes = argtypes
    lib.vtx_cuda_error_string.restype = ctypes.c_char_p
    lib.vtx_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def build_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the forward kernel's library."""
    return _load("attn_fwd", "vtx_attn_fwd",
                 [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P])


def build_bwd_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the backward kernels' library."""
    return _load("attn_bwd", "vtx_attn_bwd",
                 [_P] * 10 + [_I, _I, _I, _I, ctypes.c_float, _P])


def build_hp_bwd_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the head-pair backward's library."""
    return _load("hp_bwd", "vtx_hp_bwd",
                 [_P] * 4 + [_I, _I, _I, _I, ctypes.c_float, _P])


def _head_dim(qkv: torch.Tensor, num_heads: int) -> int:
    c = qkv.shape[-1]
    if c % (3 * num_heads):
        raise ValueError(f"qkv width {c} is not 3 x {num_heads} heads")
    return c // (3 * num_heads)


def _scale(qkv: torch.Tensor, num_heads: int,
           scale: Optional[float]) -> float:
    d = _head_dim(qkv, num_heads)
    return float(scale if scale is not None else d ** -0.5)


def _check_cuda(name: str, tensors, s: int, d: int, b: int,
                num_heads: int) -> None:
    """The kernels' contract; raises on what they do not take."""
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.bfloat16 for t in tensors[:3]):
        raise TypeError(f"the attention kernels take bfloat16, not "
                        f"{[t.dtype for t in tensors[:3]]}")
    if s > MAX_SEQ:
        raise ValueError(
            f"sequence {s} > {MAX_SEQ}: {name} takes S <= {MAX_SEQ}; longer "
            f"sequences go through fused_attention_qkv_cols to "
            f"ops/flash_blocked.py")
    if d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be even and <= {MAX_HEAD_DIM}")
    if b > MAX_GRID_DIM or num_heads > MAX_GRID_DIM:
        raise ValueError(f"batch {b} and heads {num_heads} must be <= "
                         f"{MAX_GRID_DIM}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.vtx_cuda_error_string(rc).decode())


def attn_fwd_reference(qkv: torch.Tensor, num_heads: int, scale: float,
                       with_stats: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the forward kernel, in its cast order.

    qkv: (B, S, 3·H·D) -> o (B, S, H·D) in qkv's dtype, and with_stats the
    (B, H, S, 2) fp32 row stats [m, 1/Σp]."""
    b, s, c = qkv.shape
    d = c // (3 * num_heads)
    t = qkv.reshape(b, s, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q = (t[0].float() * scale).to(qkv.dtype).float()
    scores = torch.matmul(q, t[1].float().transpose(-1, -2))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    rinv = 1.0 / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), t[2].float()) * rinv
    o = o.to(qkv.dtype).transpose(1, 2).reshape(b, s, num_heads * d)
    return o, (torch.cat([m, rinv], dim=-1) if with_stats else None)


def _launch_fwd(qkv: torch.Tensor, num_heads: int, scale: float,
                with_stats: bool, name: str
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of csrc/attn_fwd.cu; the stats pointer is null without
    stats."""
    b, s, _ = qkv.shape
    d = _head_dim(qkv, num_heads)
    _check_cuda(name, (qkv,), s, d, b, num_heads)
    o = torch.empty((b, s, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    st = torch.empty((b, num_heads, s, 2), dtype=torch.float32,
                     device=qkv.device) if with_stats else None
    lib = build_kernels()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.vtx_attn_fwd(qkv.data_ptr(), o.data_ptr(),
                              st.data_ptr() if st is not None else None,
                              b, s, num_heads, d, scale, stream)
    _raise_on(lib, rc, "attention forward")
    return o, st


def attn_fwd(qkv: torch.Tensor, num_heads: int, scale: Optional[float] = None,
             with_stats: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Softmax attention of the heads packed in a (B, S, 3·H·D) qkv buffer.

    Returns o (B, S, H·D) and, with_stats, (B, H, S, 2) fp32 [m, 1/Σp]."""
    global ATTN_FWD_LAUNCHES
    scale = _scale(qkv, num_heads, scale)
    if qkv.device.type == "cpu":
        return attn_fwd_reference(qkv, num_heads, scale, with_stats)
    out = _launch_fwd(qkv, num_heads, scale, with_stats, "attn_fwd")
    ATTN_FWD_LAUNCHES += 1
    return out


def hp_fwd(qkv: torch.Tensor, num_heads: int,
           scale: Optional[float] = None) -> torch.Tensor:
    """The head-pair forward (K9): o (B, S, H·D) of a (B, S, 3·H·D) qkv
    buffer, without row stats. `_hp_fwd_kernel` (:194-209) computes o in
    `_hp_fwd_stats_kernel`'s cast order, so its kernel is csrc/attn_fwd.cu
    with the stats pointer null and its plain version
    `attn_fwd_reference(with_stats=False)`."""
    global HP_FWD_LAUNCHES
    scale = _scale(qkv, num_heads, scale)
    if qkv.device.type == "cpu":
        return attn_fwd_reference(qkv, num_heads, scale)[0]
    o, _ = _launch_fwd(qkv, num_heads, scale, False, "hp_fwd")
    HP_FWD_LAUNCHES += 1
    return o


def attn_bwd_reference(qkv: torch.Tensor, do: torch.Tensor, o: torch.Tensor,
                       st: torch.Tensor, num_heads: int, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, in its cast order.

    qkv (B, S, 3·H·D), do and o (B, S, H·D), st (B, H, S, 2) [m, 1/Σp] ->
    dqkv (B, S, 3·H·D) in qkv's dtype, columns [dq | dk | dv] in the
    standard order, and the (B, 3·H·D) fp32 qkv-bias partials (dq, dk, dv
    in fp32, summed over the sequence)."""
    b, s, c = qkv.shape
    h = num_heads
    d = c // (3 * h)
    dt = qkv.dtype
    t = qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)      # (3,B,H,S,D)
    q = (t[0].float() * scale).to(dt).float()                  # q̂
    k, v = t[1].float(), t[2].float()
    g = do.reshape(b, s, h, d).transpose(1, 2).float()         # (B,H,S,D)
    out = o.reshape(b, s, h, d).transpose(1, 2).float()
    m, rinv = st[..., 0:1], st[..., 1:2]                       # (B,H,S,1)
    pu = torch.exp(torch.matmul(q, k.transpose(-1, -2)) - m)
    do_n = (g * rinv).to(dt).float()
    dv = torch.matmul(pu.to(dt).float().transpose(-1, -2), do_n)
    delta = (g * out).sum(dim=-1, keepdim=True)
    dp = torch.matmul(g, v.transpose(-1, -2))
    tt = ((dp - delta) * pu).to(dt).float()
    dq = torch.matmul(tt, k) * (rinv * scale)
    qn = (q * rinv).to(dt).float()
    dk = torch.matmul(tt.transpose(-1, -2), qn)
    grads = torch.stack([dq, dk, dv])                          # (3,B,H,S,D)
    dqkv = grads.to(dt).permute(1, 3, 0, 2, 4).reshape(b, s, c)
    dbias = grads.sum(dim=3).permute(1, 0, 2, 3).reshape(b, c)
    return dqkv, dbias


def attn_bwd(qkv: torch.Tensor, do: torch.Tensor, o: torch.Tensor,
             st: torch.Tensor, num_heads: int, scale: Optional[float] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient of `attn_fwd` with respect to qkv, from the forward's o and
    row stats st. Returns dqkv (B, S, 3·H·D) and the (B, 3·H·D) fp32
    qkv-bias partials."""
    global ATTN_BWD_LAUNCHES
    b, s, c = qkv.shape
    scale = _scale(qkv, num_heads, scale)
    d = c // (3 * num_heads)
    hd = num_heads * d
    if do.shape != (b, s, hd) or o.shape != (b, s, hd) or \
            st.shape != (b, num_heads, s, 2):
        raise ValueError(f"do {tuple(do.shape)}, o {tuple(o.shape)}, st "
                         f"{tuple(st.shape)} do not fit qkv {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return attn_bwd_reference(qkv, do, o, st, num_heads, scale)
    _check_cuda("attn_bwd", (qkv, do, o, st), s, d, b, num_heads)
    if st.dtype != torch.float32:
        raise TypeError(f"row stats must be float32, not {st.dtype}")
    dev = qkv.device
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((b, c), dtype=torch.float32, device=dev)
    # scratch of the prep launch: q̂, q̂/Σp, dO/Σp and rowsum(dO·O)
    scratch = torch.empty((3, b, num_heads, s, d), dtype=qkv.dtype, device=dev)
    delta = torch.empty((b, num_heads, s), dtype=torch.float32, device=dev)
    lib = build_bwd_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vtx_attn_bwd(
            qkv.data_ptr(), do.data_ptr(), o.data_ptr(), st.data_ptr(),
            dqkv.data_ptr(), dbias.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), scratch[2].data_ptr(), delta.data_ptr(),
            b, s, num_heads, d, scale, stream)
    _raise_on(lib, rc, "attention backward")
    ATTN_BWD_LAUNCHES += 1
    return dqkv, dbias


def hp_bwd_reference(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                     scale: float) -> torch.Tensor:
    """Plain PyTorch version of the head-pair backward kernel (K10), in its
    cast order (:223-245), which is not K2's.

    qkv (B, S, 3·H·D), do (B, S, H·D) -> dqkv (B, S, 3·H·D) in qkv's dtype,
    columns [dq | dk | dv]. s = (q·kᵀ in fp32 from the raw values)·scale;
    p = exp(s - m) / Σ, normalised in fp32; dv = bf16(p)ᵀ·dO; dp = dO·vᵀ;
    ds = bf16(p (dp - Σ dp·p)); dq = ds·k·scale and dk = dsᵀ·q·scale."""
    b, s, c = qkv.shape
    h = num_heads
    d = c // (3 * h)
    dt = qkv.dtype
    q, k, v = qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4).float()
    g = do.reshape(b, s, h, d).transpose(1, 2).float()       # (B,H,S,D)
    sc = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return torch.stack([dq, dk, dv]).to(dt).permute(1, 3, 0, 2, 4).reshape(
        b, s, c)


def hp_bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
           scale: Optional[float] = None) -> torch.Tensor:
    """Gradient of `hp_fwd` with respect to its qkv buffer, from qkv and dO
    alone: dqkv (B, S, 3·H·D), columns [dq | dk | dv]."""
    global HP_BWD_LAUNCHES
    b, s, c = qkv.shape
    scale = _scale(qkv, num_heads, scale)
    d = c // (3 * num_heads)
    if do.shape != (b, s, num_heads * d):
        raise ValueError(f"do {tuple(do.shape)} does not fit qkv "
                         f"{tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return hp_bwd_reference(qkv, do, num_heads, scale)
    _check_cuda("hp_bwd", (qkv, do), s, d, b, num_heads)
    dqkv = torch.empty_like(qkv)
    # scratch: each query row's [m, Σ exp, Σ dp·p] from the dq launch
    stats = torch.empty((b, num_heads, s, 3), dtype=torch.float32,
                        device=qkv.device)
    lib = build_hp_bwd_kernels()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.vtx_hp_bwd(qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                            stats.data_ptr(), b, s, num_heads, d, scale,
                            stream)
    _raise_on(lib, rc, "head-pair attention backward")
    HP_BWD_LAUNCHES += 1
    return dqkv


class HeadPairAttention(torch.autograd.Function):
    """The head-pair custom VJP `_hp_partitioned` (:437-456): forward
    `hp_fwd` (K9), which saves only qkv; backward `hp_bwd` (K10)."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return hp_fwd(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return hp_bwd(qkv, do.contiguous(), ctx.num_heads, ctx.scale), \
            None, None


def weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """xᵀ·g over every leading row, accumulated in fp32 (JAX: the einsums
    with preferred_element_type=f32, :683-685 and mlp_fused.py:170-173)."""
    x2 = x.reshape(-1, x.shape[-1])
    g2 = g.reshape(-1, g.shape[-1])
    if x2.device.type == "cuda" and x2.dtype == torch.bfloat16:
        # bf16 operands on the tensor cores, fp32 accumulator and output
        return torch.mm(x2.t(), g2, out_dtype=torch.float32)
    # the fp32 product of the working-dtype values: exact per product
    return torch.matmul(x2.t().float(), g2.float())


class QkvProjAttention(torch.autograd.Function):
    """Projection + attention under one gradient, as the JAX custom VJP.

    Forward: qkv = x·W (+b), then `attn_fwd` with stats; x, qkv, o, st and
    W are saved. Backward: `attn_bwd` gives dqkv and the bias partials;
    dx = dqkv·Wᵀ in the compute dtype, dW = xᵀ·dqkv and db in fp32."""

    @staticmethod
    def forward(ctx, x, w, b, num_heads: int, scale: float):
        qkv = torch.matmul(x, w.to(x.dtype))
        if b is not None:
            qkv = bias_add(qkv, b)
        o, st = attn_fwd(qkv, num_heads, scale, with_stats=True)
        ctx.save_for_backward(x, qkv, o, st, w)
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.b_dtype = b.dtype if b is not None else None
        return o

    @staticmethod
    def backward(ctx, do):
        x, qkv, o, st, w = ctx.saved_tensors
        dqkv, dbias = attn_bwd(qkv, do.contiguous(), o, st, ctx.num_heads,
                               ctx.scale)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = torch.matmul(dqkv, w.to(dqkv.dtype).t()) if need_x else None
        dw = weight_grad(x, dqkv).to(w.dtype) if need_w else None
        db = dbias.sum(dim=0).to(ctx.b_dtype) if need_b else None
        return dx, dw, db, None, None


def qkv_proj_attention(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor], num_heads: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Fused qkv projection + attention.

    x: (B, S, D) in the compute dtype; w: (D, 3·H·hd) in the JAX layout
    (the module passes its timm (3·H·hd, D) weight transposed); b:
    (3·H·hd,) or None. Returns (B, S, H·hd). When a gradient is needed the
    call goes through `QkvProjAttention` (K1 with stats, then K2 in the
    backward); otherwise the forward runs without stats."""
    d = w.shape[1] // (3 * num_heads)
    scale = float(scale if scale is not None else d ** -0.5)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return QkvProjAttention.apply(x, w, b, num_heads, scale)
    qkv = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        qkv = bias_add(qkv, b)
    return attn_fwd(qkv, num_heads, scale)[0]


def fused_attention_qkv_cols(qkv: torch.Tensor, num_heads: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Attention straight off the fused qkv projection (:459).

    qkv: (B, S, 3·H·D) laid out [q heads | k heads | v heads] -> (B, S, H·D).
    S <= MAX_SEQ runs the head-pair kernels under `HeadPairAttention` (K9
    forward, K10 backward); longer S the blocked kernels
    (ops/flash_blocked.py, K4-K6) under `FlashAttentionBlocked`. Both read
    the buffer by stride, with no copy in or out, and write its gradient
    once. The JAX function's head-pair layout rule (head_dim a multiple of
    64, an even head count) is a TPU one: the port's kernels take any even
    head_dim <= 128 and any head count."""
    _, s, _ = qkv.shape
    scale = _scale(qkv, num_heads, scale)
    if s <= MAX_SEQ:
        return HeadPairAttention.apply(qkv, num_heads, scale)
    return FlashAttentionBlocked.apply(qkv, num_heads, scale)
