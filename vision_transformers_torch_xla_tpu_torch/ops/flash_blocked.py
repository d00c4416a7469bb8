"""Blocked flash attention (online softmax) for long sequences.

Counterpart of vision_transformers_torch_xla_tpu/ops/flash_blocked.py: the
long-sequence path (S > 1024, high-resolution ViTs). Three kernels, each
on the tensor cores where TENSOR_CORE_RULE says so and on the CUDA cores
otherwise (the JAX kernels take any float dtype and head dim):

* `flash_fwd`, the port of `_fwd_kernel` (:33, ROADMAP K4): o and the row
  logsumexp lse = m + log(l); bf16 and fp16 at a head dim <= 256 ->
  csrc/flash_fwd.cu (TMA and wgmma; 64-key tiles past 128);
* `flash_bwd_dkdv`, the port of `_bwd_dkdv_kernel` (:109, K5), and
  `flash_bwd_dq`, the port of `_bwd_dq_kernel` (:157, K6), both from
  p = exp(s - lse) and delta = rowsum(dO·O), which a torch op computes
  (`flash_delta`; JAX computes it outside Pallas too); both in bf16 and
  fp16 at a head dim <= 256 -> csrc/flash_bwd.cu (TMA and wgmma; past 128
  K5's two warpgroups split dV and dK, and K6 holds 64 queries on one
  warpgroup); `flash_bwd` runs the three, K5 and K6 each from its own
  rule's library.

Everything else, up to MAX_CUDA_CORE_HEAD_DIM (fp32; every dtype past
256), goes to csrc/flash_blocked.cu, CUDA-core loops
that round where the JAX kernels cast to the inputs' dtype and compute in
fp32 (`tensor_cores` decides, per kernel); its fp32 K4, K5 and K6 at a
head dim <= 256 are the register-tiled kernels of csrc/flash_fwd_simt.cu
and csrc/flash_bwd_simt.cu (wide tiles past 128),
linked into the same library, which read every fp32 view with a
contiguous head dim in place (16-byte copies where its rows are 16-byte
aligned, else 4-byte ones). No launch gives way to another library or to
the plain version: a failed build or launch raises.

`FlashAttentionBlocked` is the custom VJP `_flash_attention_padded`
(:247-266) as an autograd Function, and `flash_attention_blocked` the
public entry (:269). The wrappers take (B, H, S, D) tensors of any
strides, so views of a fused (B, S, 3·H·D) qkv buffer go in as they are
(`heads`). The tensor-core kernels read them through TMA tensor maps, which
need 16-byte-aligned data and strides and a head dim that is a multiple of
8 (`tma_ready`); the CUDA-core kernels need q, k and v of one layout with
a contiguous head dim (`kernel_route` says which, before the launch).
Other inputs are first copied once into contiguous
buffers with the head dim zero-padded (`padded_copy`, which the strided
kernels of ops/flash_attention.py share; `COPIES` counts its calls), and
outputs the kernels cannot write in place go through temporaries. o comes
back as a (B, H, S, D) view of (B, S, H, D) memory, and K5 and K6 write dq,
dk, dv into the tensors they are given, which `flash_bwd` makes views of
one (B, S, 3·H·D) buffer. The grids are one-dimensional, so B·H is not
bound by a grid's y limit. The TPU padding of S to 256 (:274-281) is a
tiling device: the kernels mask the ragged last tile and the plain versions
work on the unpadded S.

Each wrapper runs its plain version (`flash_fwd_reference`,
`flash_bwd_dkdv_reference`, `flash_bwd_dq_reference`) only for tensors on
the CPU. For CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Optional, Tuple

import torch

from vision_transformers_torch_xla_tpu_torch.ops import cuda_build
from vision_transformers_torch_xla_tpu_torch.ops.cuda_build import (
    KERNEL_DTYPES,
)

log = logging.getLogger(__name__)

# Each kernel's tensor-core instantiations: (dtypes, widest head dim). K4
# (csrc/flash_fwd.cu), K5 and K6 (csrc/flash_bwd.cu's dk/dv and dq) in bf16
# and fp16 to 256; the rest runs on the CUDA cores
TENSOR_CORE_RULE = {
    "flash_fwd": ((torch.bfloat16, torch.float16), 256),
    "flash_bwd_dkdv": ((torch.bfloat16, torch.float16), 256),
    "flash_bwd_dq": ((torch.bfloat16, torch.float16), 256)}
MAX_CUDA_CORE_HEAD_DIM = 1024  # the CUDA-core kernels' widest head
TMA_ALIGN = 8  # elements: the tensor maps want 16-byte strides and data

# Launches of the blocked kernels in this process. Only the wrappers'
# launches add to them; callers may reset them to 0.
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_DKDV_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0
# Kernel calls whose operands `padded_copy` copied first (K4-K6 here; K7,
# K8, K10-K12 in ops/flash_attention.py)
COPIES = 0

# the CUDA-core library's sources: K4-K6's loops (every dtype past a head
# dim of 256), and the fp32 K4, K5 and K6 at a head dim <= 256 linked in
CUDA_CORE_SOURCES = ("flash_blocked.cu", "flash_bwd_simt.cu",
                     "flash_fwd_simt.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LAYOUT = [_L] * 3  # element strides of batch, head and row


def _load(name: str, sigs, sources=None) -> ctypes.CDLL:
    lib = cuda_build.load_library(name, sources or (f"{name}.cu",))
    for fn, argtypes in sigs.items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = argtypes
    lib.vtx_cuda_error_string.restype = ctypes.c_char_p
    lib.vtx_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


_FWD_ARGS = [_P] * 5 + [_I] * 4 + [ctypes.c_float] + _LAYOUT * 2
_DKDV_ARGS = [_P] * 8 + [_I] * 4 + [ctypes.c_float] + _LAYOUT * 3
_DQ_ARGS = [_P] * 7 + [_I] * 4 + [ctypes.c_float] + _LAYOUT * 3


# every library's functions end with the element type's code and the stream
_FWD_SIGS = {"vtx_flash_fwd": _FWD_ARGS + [_I, _P]}
_BWD_SIGS = {"vtx_flash_bwd_dkdv": _DKDV_ARGS + [_I, _P],
             "vtx_flash_bwd_dq": _DQ_ARGS + [_I, _P]}


def build_fwd_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the tensor-core forward's library
    (K4)."""
    return _load("flash_fwd", _FWD_SIGS)


def build_bwd_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the tensor-core backward's library
    (K5, K6)."""
    return _load("flash_bwd", _BWD_SIGS)


def build_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the CUDA-core library (K4-K6 where
    TENSOR_CORE_RULE does not take them), from CUDA_CORE_SOURCES."""
    return _load("flash_blocked", {**_FWD_SIGS, **_BWD_SIGS},
                 CUDA_CORE_SOURCES)


def tensor_cores(kernel: str, q: torch.Tensor) -> bool:
    """Whether `kernel` ('flash_fwd', 'flash_bwd_dkdv' or 'flash_bwd_dq')
    on q's dtype and head dim runs on the tensor cores (csrc/flash_fwd.cu,
    csrc/flash_bwd.cu, as TENSOR_CORE_RULE says); else on
    csrc/flash_blocked.cu's library."""
    dtypes, widest = TENSOR_CORE_RULE[kernel]
    return q.dtype in dtypes and q.shape[-1] <= widest


def kernel_route(kernel: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, do: Optional[torch.Tensor] = None) -> str:
    """Where one call of `kernel` on q, k, v (and, for the backward, do)
    goes, decided before the launch: 'tensor_cores' (read in place by TMA,
    `tma_ready`), 'tensor_cores_copy' (the same kernel after one
    `padded_copy`, the head dim padded to a multiple of 8), 'cuda_cores'
    (csrc/flash_blocked.cu's library, in place: q, k, v of one layout with
    a contiguous head dim) or 'cuda_cores_copy' (that library after one
    contiguous copy)."""
    tc = tensor_cores(kernel, q)
    ready = _in_place(tc, q, k, v) and (do is None
                                        or _in_place(tc, do, do, do))
    return ("tensor_cores" if tc else "cuda_cores") + (
        "" if ready else "_copy")


def _library(route: str, tc_lib) -> ctypes.CDLL:
    """The library of a route: `tc_lib` (the tensor cores') or the
    CUDA-core one."""
    return tc_lib() if route.startswith("tensor_cores") else build_kernels()


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(scale if scale is not None else q.shape[-1] ** -0.5)


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, in its cast order.

    q, k, v (..., S, D) -> o (..., S, D) in q's dtype and lse (..., S) fp32.
    s = (fp32 q · scale) kᵀ, not rounded to q's dtype (:47); the row sum is
    over fp32 p; p·v runs on p cast to v's dtype (:59-61); o = acc /
    max(l, 1e-30) and lse = m + log(max(l, 1e-30)) (:69-73)."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs(q, k, lse, scale):
    """p = exp((q kᵀ in fp32) · scale - lse) (:132-138)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.exp(s - lse.unsqueeze(-1))


def _ds(p, v, do, delta):
    """bf16(p (dO vᵀ - delta)), bf16 meaning the inputs' dtype."""
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return (p * (dp - delta.unsqueeze(-1))).to(v.dtype).float()


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel (K5), in its cast order:
    dv = bf16(p)ᵀ dO (:140-143), dk = bf16(ds)ᵀ q · scale (:147-149)."""
    p = _probs(q, k, lse, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(_ds(p, v, do, delta).transpose(-1, -2),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel (K6), in its cast order:
    dq = bf16(ds) k · scale (:185-187)."""
    p = _probs(q, k, lse, scale)
    return (torch.matmul(_ds(p, v, do, delta), k.float()) * scale).to(q.dtype)


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = Σ fp32(dO)·fp32(O) over the head dim (:199-200), (B, H, S)
    fp32 and contiguous; a torch op, as JAX computes it outside Pallas."""
    return (do.float() * o.float()).sum(dim=-1).contiguous()


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, q, k, v, o, do (..., S, D) and
    lse (..., S) fp32 -> dq, dk, dv in the inputs' dtypes."""
    delta = flash_delta(o, do)
    dk, dv = flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale)
    return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale), dk, dv


def _layout(t: torch.Tensor):
    return tuple(int(x) for x in t.stride()[:3])


def _check_cuda(name: str, tensors) -> None:
    """The kernels' contract; raises on what they do not take: tensors of
    one dtype among KERNEL_DTYPES, a head dim <= MAX_CUDA_CORE_HEAD_DIM."""
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not "
                         f"{[str(t.device) for t in tensors]}")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= set(KERNEL_DTYPES):
        raise TypeError(f"the blocked attention kernels take tensors of one "
                        f"of {KERNEL_DTYPES}, not {[t.dtype for t in tensors]}")
    if tensors[0].shape[-1] > MAX_CUDA_CORE_HEAD_DIM:
        raise ValueError(f"head_dim {tensors[0].shape[-1]} must be <= "
                         f"{MAX_CUDA_CORE_HEAD_DIM}")


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.vtx_cuda_error_string(rc).decode())


def _same_shape(q, k, v) -> None:
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(f"q, k, v must be (B, H, S, D) of one shape, not "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _tma_layout(t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, head, row) element strides as the kernels take them (the
    tensor maps of the bf16 ones, the CUDA-core loops). A dimension of size
    1 is never stepped, so its stride is arbitrary in torch; it takes the
    row width, which TMA accepts."""
    fill = -(-t.shape[-1] // TMA_ALIGN) * TMA_ALIGN
    return tuple(int(x) if n > 1 else fill
                 for n, x in zip(t.shape[:3], t.stride()[:3]))


def tma_ready(*tensors: torch.Tensor) -> bool:
    """Whether the tensor-core kernels' tensor maps read `tensors` (q, k, v
    here; also dO and O for ops/flash_attention.py's K2) in place: one
    layout, a contiguous head dim that is a multiple of 8, 16-byte-aligned
    data and strides."""
    layouts = {_tma_layout(t) for t in tensors}
    return (len(layouts) == 1 and tensors[0].shape[-1] % TMA_ALIGN == 0
            and all(x % TMA_ALIGN == 0 for x in layouts.pop())
            and all(t.stride(-1) == 1 and t.data_ptr() % (2 * TMA_ALIGN) == 0
                    for t in tensors))


def _in_place(tc: bool, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> bool:
    """Whether a kernel reads q, k and v in place: TMA's rule for the
    tensor cores' (tc, `tma_ready`); one layout with a contiguous head dim
    for the CUDA-core kernels."""
    if tc:
        return tma_ready(q, k, v)
    return (_tma_layout(q) == _tma_layout(k) == _tma_layout(v)
            and all(t.stride(-1) == 1 for t in (q, k, v)))


def _writable(route: str, outs) -> bool:
    """Whether the kernels of `route` write `outs` in place: one layout
    with a contiguous head dim; the tensor-core kernels store pairs, so
    also even strides and 4-byte-aligned data."""
    if len({_layout(t) for t in outs}) != 1 or any(
            t.stride(-1) != 1 for t in outs):
        return False
    return not route.startswith("tensor_cores") or all(
        t.data_ptr() % 4 == 0 and all(x % 2 == 0 for x in _layout(t))
        for t in outs)


def _copy_multiple(route: str) -> int:
    """The head-dim multiple a copy pads to: TMA's 8 for the tensor cores'
    kernels, none for the CUDA-core ones."""
    return TMA_ALIGN if route.startswith("tensor_cores") else 1


def padded_copy(tensors, multiple: int, name: str):
    """(B, H, S, D) tensors copied once into new contiguous buffers, the
    head dim zero-padded to a multiple of `multiple`, for a kernel that
    cannot read them in place: zero columns add nothing to q·kᵀ and give
    zero columns of o and of the gradients. Counted in `COPIES` and
    logged."""
    global COPIES
    COPIES += 1
    d = tensors[0].shape[-1]
    log.info("%s: tensors of strides %s and head dim %d are copied for the "
             "kernel", name, [t.stride() for t in tensors], d)
    dp = -(-d // multiple) * multiple
    out = []
    for t in tensors:
        buf = t.new_zeros((*t.shape[:-1], dp))
        buf[..., :d] = t
        out.append(buf)
    return out


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention, q, k, v (B, H, S, D) -> o (B, H, S, D), a view of
    (B, S, H, D) memory, and the row logsumexp lse (B, H, S) fp32. On the
    card, q, k and v that the kernel cannot read in place (`kernel_route`)
    are copied once first; D > MAX_CUDA_CORE_HEAD_DIM raises."""
    global FLASH_FWD_LAUNCHES
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale)
    _same_shape(q, k, v)
    _check_cuda("flash_fwd", (q, k, v))
    b, h, s, d = q.shape
    route = kernel_route("flash_fwd", q, k, v)
    if route.endswith("_copy"):
        q, k, v = padded_copy((q, k, v), _copy_multiple(route), "flash_fwd")
    dp = q.shape[-1]
    o = torch.empty((b, s, h, dp), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _library(route, build_fwd_kernels)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vtx_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), lse.data_ptr(), b, h, s, dp,
                               scale, *_tma_layout(q), *_layout(o),
                               cuda_build.dtype_code(q.dtype), stream)
    _raise_on(lib, rc, "blocked attention forward")
    FLASH_FWD_LAUNCHES += 1
    return (o[..., :d] if dp != d else o), lse


def _bwd_checks(name, q, k, v, do, lse, delta, outs) -> None:
    """The backward kernels' contract on their inputs and the outputs they
    write."""
    _same_shape(q, k, v)
    if do.shape != q.shape or any(t.shape != q.shape for t in outs):
        raise ValueError(f"do {tuple(do.shape)} and the outputs "
                         f"{[tuple(t.shape) for t in outs]} must be of q's "
                         f"shape {tuple(q.shape)}")
    if lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError(f"lse {tuple(lse.shape)} and delta "
                         f"{tuple(delta.shape)} must be (B, H, S) = "
                         f"{tuple(q.shape[:3])}")
    _check_cuda(name, (q, k, v, do, *outs))
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"lse and delta must be float32, not {lse.dtype}, "
                        f"{delta.dtype}")
    if lse.device != q.device or delta.device != q.device:
        raise ValueError(f"lse and delta must be on {q.device}")
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError(f"{name} takes contiguous lse and delta")


def _launch_bwd(name: str, fn: str, q, k, v, do, lse, delta, outs,
                scale: float) -> None:
    """One launch of backward kernel `name` (C function `fn`) of q's dtype,
    writing `outs`, in its own route's library. q, k, v and do that it
    cannot read in place are copied once (`padded_copy`); outputs it cannot
    write in place, or of a padded head dim, go through temporaries that
    are then copied into `outs`."""
    _bwd_checks(name, q, k, v, do, lse, delta, outs)
    route = kernel_route(name, q, k, v, do)
    if route.endswith("_copy"):
        q, k, v, do = padded_copy((q, k, v, do), _copy_multiple(route), name)
    b, h, s, dp = q.shape
    d = outs[0].shape[-1]
    direct = dp == d and _writable(route, outs)
    dst = outs if direct else [torch.empty(q.shape, dtype=q.dtype,
                                           device=q.device) for _ in outs]
    lib = _library(route, build_bwd_kernels)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in dst),
            b, h, s, dp, scale, *_tma_layout(q), *_tma_layout(do),
            *_layout(dst[0]), cuda_build.dtype_code(q.dtype), stream)
    _raise_on(lib, rc, f"blocked attention backward ({name})")
    if not direct:
        for t, tmp in zip(outs, dst):
            t.copy_(tmp[..., :d])


def flash_bwd_dkdv(q, k, v, do, lse, delta, dk, dv,
                   scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv of the blocked attention (K5), from lse and delta (B, H, S)
    fp32, written into the (B, H, S, D) tensors dk and dv."""
    global FLASH_BWD_DKDV_LAUNCHES
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        dk_r, dv_r = flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale)
        return dk.copy_(dk_r), dv.copy_(dv_r)
    _launch_bwd("flash_bwd_dkdv", "vtx_flash_bwd_dkdv", q, k, v, do, lse,
                delta, (dk, dv), scale)
    FLASH_BWD_DKDV_LAUNCHES += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, dq,
                 scale: Optional[float] = None) -> torch.Tensor:
    """dq of the blocked attention (K6), from lse and delta (B, H, S) fp32,
    written into the (B, H, S, D) tensor dq."""
    global FLASH_BWD_DQ_LAUNCHES
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return dq.copy_(flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                               scale))
    _launch_bwd("flash_bwd_dq", "vtx_flash_bwd_dq", q, k, v, do, lse, delta,
                (dq,), scale)
    FLASH_BWD_DQ_LAUNCHES += 1
    return dq


def heads(qkv: torch.Tensor, num_heads: int):
    """q, k, v: (B, H, S, D) views of a (B, S, 3·H·D) buffer laid out
    [q heads | k heads | v heads]."""
    b, s, c = qkv.shape
    return qkv.reshape(b, s, 3, num_heads, c // (3 * num_heads)).permute(
        2, 0, 3, 1, 4).unbind(0)


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """Gradient of `flash_fwd` from its o and lse: delta, then K5 and K6,
    each on the library its own rule names (both on the tensor cores in
    bf16 and fp16 to a head dim of 256). Returns dqkv (B, S, 3·H·D): dq, dk, dv
    laid out as the fused qkv projection, each written once."""
    b, h, s, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    dqkv = torch.empty((b, s, 3 * h * d), dtype=q.dtype, device=q.device)
    dq, dk, dv = heads(dqkv, h)
    delta = flash_delta(o, do)
    flash_bwd_dkdv(q, k, v, do, lse, delta, dk, dv, scale)
    flash_bwd_dq(q, k, v, do, lse, delta, dq, scale)
    return dqkv


class FlashAttentionBlocked(torch.autograd.Function):
    """The JAX custom VJP `_flash_attention_padded` on a fused (B, S, 3·H·D)
    qkv buffer: the kernels read q, k, v from it by stride, the forward
    saves it with o and lse and returns o (B, S, H·D); the backward returns
    the buffer's gradient, written once by K5 and K6."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float):
        o, lse = flash_fwd(*heads(qkv, num_heads), scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        b, s, _ = qkv.shape
        return o.transpose(1, 2).reshape(b, s, -1)

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        b, h, s, d = o.shape
        do = do.contiguous().view(b, s, h, d).transpose(1, 2)
        return (flash_bwd(*heads(qkv, ctx.num_heads), o, lse, do, ctx.scale),
                None, None)


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: Optional[float] = None
                            ) -> torch.Tensor:
    """Blocked flash attention. q, k, v: (B, H, S, D) -> (B, H, S, D).

    They are packed into one (B, S, 3·H·D) buffer for
    `FlashAttentionBlocked`; the model's path hands it the projection's own
    buffer (ops/flash_attention.py::fused_attention_qkv_cols)."""
    b, h, s, d = q.shape
    qkv = torch.stack((q, k, v), dim=1).permute(0, 3, 1, 2, 4).reshape(
        b, s, 3 * h * d)
    o = FlashAttentionBlocked.apply(qkv, h, _scale(q, scale))
    return o.view(b, s, h, d).transpose(1, 2)
