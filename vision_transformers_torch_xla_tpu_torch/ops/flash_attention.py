"""Attention over the fused qkv projection: Hopper kernels and plain versions.

Counterpart of vision_transformers_torch_xla_tpu/ops/flash_attention.py
::qkv_proj_attention (:703) and its custom VJP `_qkv_proj_attention`
(:630-700). The projection x·W (+b) runs in the compute dtype through
torch.matmul, as XLA ran it outside the Pallas calls. The attention reads
q, k and v straight from the (B, S, 3·H·D) projection output:

* `attn_fwd`, the port of `_hp_fwd_stats_kernel` (:291, ROADMAP K1), which
  also writes the softmax row stats;
* `attn_bwd`, the port of `_hp_bwd_pi_kernel` (:495, ROADMAP K2), which
  recomputes the probabilities from those stats and writes dqkv in the
  standard column order plus fp32 qkv-bias partials.

Their bf16 and fp16 kernels run on the tensor cores (TMA, mbarriers,
wgmma): csrc/attn_fwd_tc.cu and csrc/attn_bwd_tc.cu. The fp32 ones run on
the CUDA cores, csrc/attn_fwd.cu (csrc/attn_fwd_simt.cuh's register tiles
in K1's order, a block per (b, h, 64-row query tile)) and csrc/attn_bwd.cu
(a block per (b, h) over register-tiled 64-row tiles,
csrc/flash_blocked.cu's tiling; past MAX_HEAD_DIM csrc/attn_bwd_simt.cu,
linked in: 32-key blocks on csrc/simt_wide.cuh's wide register tiles):
the JAX kernels round nothing in fp32,
and a tensor-core product of fp32 operands, TF32, would. Wider heads take
other sources (below).
`attn_kernel_route` decides before the launch, by dtype and shape: the
tensor-core kernels read q, k and v in place through TMA tensor maps,
which need a head dim that is a multiple of 8 and 16-byte-aligned data;
other calls copy q, k, v (and dO, O) once with ops/flash_blocked.py's
`padded_copy` (counted in `COPIES`) and run the same kernels.

`fused_attention_qkv_cols` (:459) is attention off a qkv buffer the caller
projected. For S <= MAX_SEQ it is the head-pair custom VJP
`_hp_partitioned` (:437-456) as the autograd Function `HeadPairAttention`:

* `hp_fwd`, K1's launch without stats, the port of `_hp_fwd_kernel` (:171,
  ROADMAP K9): the same function as K1's o, in the same cast order;
* `hp_bwd`, the port of `_hp_bwd_kernel` (:212, ROADMAP K10), which
  recomputes the probabilities from q, k, v and dO alone (K8's launch, below).

Longer sequences go to the blocked kernels of ops/flash_blocked.py (K4-K6).

The op-level entry points `fused_attention` (:880, reached through
`ops/attention.py::multi_head_attention(use_pallas=True)`) and
`fused_attention_qkv` (:857) are the custom VJPs `_fused_attention_padded`
(:153-168) and `_fused_attention_qkv_padded` (:841-854), here the autograd
Functions `FusedAttention` and `FusedAttentionQkv`. Their kernels compute
one function over two layouts, in the cast order of `_reference_attention`
(p normalised in fp32 before its bf16 cast), which is not K1's:

* `fused_fwd` (K7, `_fwd_kernel` :36) on (B, H, S, D) q, k, v and `qkv_fwd`
  (K11, `_qkv_fwd_kernel` :740) on a (B, S, 3, H, D) qkv buffer -> in bf16
  and fp16 csrc/attn_fwd_tc.cu in K7's cast order (TMA, mbarriers, wgmma),
  in fp32 csrc/fused_attn_fwd.cu (CUDA cores: K1's register-tiled kernel,
  csrc/attn_fwd_simt.cuh, in K7's cast order), as `fused_kernel_route`
  decides; plain version `fused_fwd_reference`;
* `fused_bwd` (K8, `_bwd_kernel` :61) and `qkv_bwd` (K12, `_qkv_bwd_kernel`
  :764), whose function is K10's, and `hp_bwd` (K10) -> in bf16 and fp16
  csrc/hp_bwd_tc.cu (TMA, mbarriers, wgmma), in fp32 the CUDA cores
  (csrc/hp_bwd_simt.cu's register tiles at D <= MAX_WIDE_HEAD_DIM, linked
  into csrc/hp_bwd.cu's library, whose loops take wider heads), as
  `bwd_kernel_route` decides; plain version
  `fused_bwd_reference`, which `hp_bwd_reference` shares.

The tensor-core kernels of K7-K12 read q, k and v in place through tensor
maps with one set of strides, whether separate tensors or views of one qkv
buffer (the backward reads dO through a map of its own), and write their
outputs in place; operands that TMA cannot read (`tma_ready`: another
layout each, a head dim not a multiple of 8, unaligned data) are copied
once by ops/flash_blocked.py's `padded_copy`. The CUDA-core sources take
every tensor as a base pointer and (batch, head, token) strides; views
they cannot take in place (an odd head dim, odd or unaligned strides) are
copied once, the head dim zero-padded to even, as JAX pads it to 8, and
the results sliced back (`_launch_views`). Every grid of every source is
one-dimensional over (b, h, tile), so B and H are not bound by the grid's
y and z limits. The TPU kernels' padding of S to 128 and D to 8 and the G
batching of `_pick_g` have no counterpart: the kernels loop over the S real
keys.

The kernels take S <= MAX_SEQ, and their wrappers raise on more; the
entry points `fused_attention` and `fused_attention_qkv` route S > MAX_SEQ
to `reference_attention` under autograd, as JAX routes it, by a shape rule
decided before any launch (`fused_kernel_route`, `bwd_kernel_route` say
'reference'). JAX pads any head dim and runs its kernels; every kernel
here takes an even head dim <= MAX_CUDA_CORE_HEAD_DIM (1024), on these
sources (the routes say which, before the launch):

* bf16, fp16 at D <= MAX_HEAD_DIM (128): the tensor-core tiles of
  csrc/attn_fwd_tc.cu (K1, K7, K9, K11), csrc/attn_bwd_tc.cu (K2) and
  csrc/hp_bwd_tc.cu (K8, K10, K12);
* bf16, fp16 at MAX_HEAD_DIM < D <= MAX_WIDE_HEAD_DIM (256): the wide
  tensor-core tiles of the same three sources (64-row stationary tiles;
  K2's dk/dv streams 32-query tiles);
* fp32 at any D, and every dtype at D > MAX_WIDE_HEAD_DIM: the CUDA
  cores, csrc/attn_fwd.cu (K1, K9), csrc/attn_bwd.cu (K2; fp32 at
  MAX_HEAD_DIM < D <= MAX_WIDE_HEAD_DIM in csrc/attn_bwd_simt.cu, linked
  in),
  csrc/fused_attn_fwd.cu (K7, K11) and csrc/hp_bwd.cu (K8, K10, K12; fp32
  at D <= MAX_WIDE_HEAD_DIM in csrc/hp_bwd_simt.cu, linked in: its
  register tiles, wide ones past MAX_HEAD_DIM); the fp32 K1, K9, K7 and
  K11 at D <= MAX_WIDE_HEAD_DIM run one register-tiled kernel in two cast
  orders, csrc/attn_fwd_simt.cuh, which both forward sources include, and
  past it those sources' run-time head-dim loops.

Every kernel takes bf16, fp16 and fp32 on the card, as the JAX kernels take
any float dtype: the CUDA sources are templated on the element type, compute
in fp32 and round where the JAX kernels cast to the inputs' dtype (an
identity in fp32). Each wrapper picks the instantiation by dtype; tensors of
mixed dtypes, or of another dtype, raise TypeError before any launch. Which
route a model takes is decided where it is built
(`models/layers.py::attention_route`, `launch/main.py::setup`).

Each wrapper runs its plain version (`attn_fwd_reference`,
`attn_bwd_reference`, `hp_bwd_reference`, `fused_fwd_reference`,
`fused_bwd_reference`) only for tensors on the CPU, which take any float
dtype, as the JAX kernels do. For CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vision_transformers_torch_xla_tpu_torch.ops import cuda_build
from vision_transformers_torch_xla_tpu_torch.ops.attention import (
    reference_attention,
)
from vision_transformers_torch_xla_tpu_torch.ops.bias_grad import bias_add
from vision_transformers_torch_xla_tpu_torch.ops.cuda_build import (
    KERNEL_DTYPES,
)
from vision_transformers_torch_xla_tpu_torch.ops.flash_blocked import (
    MAX_CUDA_CORE_HEAD_DIM,
    TMA_ALIGN,
    FlashAttentionBlocked,
    _tma_layout,
    heads,
    padded_copy,
    tma_ready,
)

MAX_SEQ = 1024       # longer sequences are ops/flash_blocked.py's (K4-K6)
MAX_HEAD_DIM = 128   # the narrow tiles' widest head
MAX_WIDE_HEAD_DIM = 256  # the wide tiles' (tensor cores: K1, K2, K7-K12)

# Launches of the attention kernels in this process. Only the wrappers'
# launches add to them; callers may reset them to 0.
ATTN_FWD_LAUNCHES = 0
ATTN_BWD_LAUNCHES = 0
HP_FWD_LAUNCHES = 0
HP_BWD_LAUNCHES = 0
FUSED_FWD_LAUNCHES = 0
FUSED_BWD_LAUNCHES = 0
QKV_FWD_LAUNCHES = 0
QKV_BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_L3 = [ctypes.c_longlong] * 3  # element strides of batch, head and row


def _load(name: str, fn: str, argtypes, sources=None) -> ctypes.CDLL:
    lib = cuda_build.load_library(name, sources or (f"{name}.cu",))
    getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, fn).argtypes = argtypes
    lib.vtx_cuda_error_string.restype = ctypes.c_char_p
    lib.vtx_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


# Every host function ends with (element type's code, stream).
def build_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the CUDA-core forward's library (K1,
    K9: fp32 on csrc/attn_fwd_simt.cuh's register tiles to
    MAX_WIDE_HEAD_DIM, every dtype past it on run-time loops)."""
    return _load("attn_fwd", "vtx_attn_fwd",
                 [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P])


# the CUDA-core K2's sources: fp32 to MAX_HEAD_DIM and every dtype past
# MAX_WIDE_HEAD_DIM, and the fp32 register tiles at head dims between them
# linked in
ATTN_BWD_SOURCES = ("attn_bwd.cu", "attn_bwd_simt.cu")


def build_bwd_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the CUDA-core backward's library (K2
    in fp32, and past MAX_WIDE_HEAD_DIM), from ATTN_BWD_SOURCES."""
    lib = _load("attn_bwd", "vtx_attn_bwd",
                [_P] * 7 + [_I, _I, _I, _I, ctypes.c_float, _I, _P],
                ATTN_BWD_SOURCES)
    lib.vtx_attn_bwd_smem.restype = ctypes.c_int
    lib.vtx_attn_bwd_smem.argtypes = [_I]
    lib.vtx_attn_bwd_scratch.restype = ctypes.c_longlong
    lib.vtx_attn_bwd_scratch.argtypes = [_I] * 5
    return lib


def build_tc_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the bf16 and fp16 forwards' library:
    K1, K9 (`vtx_attn_fwd_tc`) and K7, K11 (`vtx_fused_attn_fwd_tc`, K7's
    cast order) on the tensor cores."""
    lib = _load("attn_fwd_tc", "vtx_attn_fwd_tc",
                [_P] * 5 + [_I] * 4 + [ctypes.c_float] + _L3 * 2 + [_I, _P])
    lib.vtx_fused_attn_fwd_tc.restype = ctypes.c_int
    lib.vtx_fused_attn_fwd_tc.argtypes = \
        [_P] * 4 + [_I] * 4 + [ctypes.c_float] + _L3 * 2 + [_I, _P]
    return lib


def build_tc_bwd_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the bf16 and fp16 backward's library
    (K2 on the tensor cores)."""
    lib = _load("attn_bwd_tc", "vtx_attn_bwd_tc",
                [_P] * 3 + _L3 + [_P] * 2 + _L3 + [_P] * 4 + _L3
                + [_P] * 4 + [_I, _P, _P] + [_I] * 4
                + [ctypes.c_float, _I, _P])
    lib.vtx_attn_bwd_tc_tiles.restype = ctypes.c_int
    lib.vtx_attn_bwd_tc_tiles.argtypes = [_I, _I]
    return lib


def attn_kernel_route(qkv: torch.Tensor, num_heads: int,
                      do: Optional[torch.Tensor] = None,
                      o: Optional[torch.Tensor] = None) -> str:
    """The kernel a CUDA call of K1 or K9 (on `qkv`) or K2 (also on `do`
    and `o`) launches, decided before the launch: 'tensor_cores' (bf16,
    fp16 at a head dim <= MAX_WIDE_HEAD_DIM: csrc/attn_fwd_tc.cu and
    csrc/attn_bwd_tc.cu, wide tiles past MAX_HEAD_DIM, reading the
    buffers in place), 'tensor_cores_copy' (the same kernels after one
    `padded_copy`, when TMA cannot read q, k, v or dO, O in place:
    `tma_ready`) or 'cuda_cores' (fp32, and every dtype past
    MAX_WIDE_HEAD_DIM: csrc/attn_fwd.cu, whose fp32 forward to
    MAX_WIDE_HEAD_DIM is csrc/attn_fwd_simt.cuh's attn_fwd_simt_kernel in
    K1's order, and csrc/attn_bwd.cu)."""
    if qkv.dtype == torch.float32 or \
            _head_dim(qkv, num_heads) > MAX_WIDE_HEAD_DIM:
        return "cuda_cores"
    groups = [heads(qkv, num_heads)]
    if do is not None:
        groups.append((_head_major(do, num_heads), _head_major(o, num_heads)))
    if all(tma_ready(*g) for g in groups):
        return "tensor_cores"
    return "tensor_cores_copy"


def fused_kernel_route(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> str:
    """The kernel a call of K7 or K11 on (B, H, S, D) q, k, v launches on
    the card, decided before the launch: 'reference' (S > MAX_SEQ:
    `fused_attention` and `fused_attention_qkv` take `reference_attention`,
    as JAX routes it, on the CPU too, and launch nothing), 'tensor_cores'
    (bf16, fp16: csrc/attn_fwd_tc.cu in K7's cast order, reading q, k, v in
    place, at a head dim <= MAX_WIDE_HEAD_DIM), 'tensor_cores_copy' (the
    same kernel after one `padded_copy`, when TMA cannot read them in
    place: `tma_ready`) or 'cuda_cores' (fp32, or a head dim over
    MAX_WIDE_HEAD_DIM in any dtype: csrc/fused_attn_fwd.cu, whose fp32
    forward to MAX_WIDE_HEAD_DIM is csrc/attn_fwd_simt.cuh's
    attn_fwd_simt_kernel in K7's order, reading q, k and v in place where
    `_launch_views` lets it). The output is the wrapper's own, which the
    kernel writes in place at every even head dim."""
    if q.shape[-2] > MAX_SEQ:
        return "reference"
    if q.dtype == torch.float32 or q.shape[-1] > MAX_WIDE_HEAD_DIM:
        return "cuda_cores"
    return "tensor_cores" if tma_ready(q, k, v) else "tensor_cores_copy"


# the CUDA-core backward's sources: the loops of every dtype past the
# tensor cores' head dims, and fp32 at a head dim <= MAX_WIDE_HEAD_DIM
# linked in
HP_BWD_SOURCES = ("hp_bwd.cu", "hp_bwd_simt.cu")


def build_hp_bwd_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the fp32 backward of K8, K10 and K12
    (CUDA cores), from HP_BWD_SOURCES."""
    lib = _load("hp_bwd", "vtx_hp_bwd",
                [_P] * 8 + [_STRIDES, _I, _I, _I, _I, ctypes.c_float, _I,
                            _P], HP_BWD_SOURCES)
    lib.vtx_hp_bwd_scratch.restype = ctypes.c_longlong
    lib.vtx_hp_bwd_scratch.argtypes = [_I] * 5
    return lib


def build_hp_bwd_tc_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the bf16 and fp16 backward of K8, K10
    and K12 (tensor cores)."""
    return _load("hp_bwd_tc", "vtx_hp_bwd_tc",
                 [_P] * 3 + _L3 + [_P] + _L3 + [_P] * 3 + _L3
                 + [_P, _I, _I, _I, _I, ctypes.c_float, _I, _P])


def bwd_kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor) -> str:
    """The kernel a call of K8, K10 or K12 on (B, H, S, D) q, k, v and dO
    launches on the card, decided before the launch: 'reference' (S >
    MAX_SEQ: the entry points' forward took `reference_attention`, whose
    gradient is autograd's), 'tensor_cores' (bf16, fp16: csrc/hp_bwd_tc.cu,
    at a head dim <= MAX_WIDE_HEAD_DIM, reading q, k, v as one group and dO
    as another in place), 'tensor_cores_copy' (the same kernels after one
    `padded_copy` of all four, when TMA cannot read a group in place:
    `tma_ready`) or 'cuda_cores' (fp32, or a head dim over
    MAX_WIDE_HEAD_DIM in any dtype: csrc/hp_bwd.cu's library, whose fp32
    kernels at D <= MAX_WIDE_HEAD_DIM are csrc/hp_bwd_simt.cu's). The
    outputs
    are the wrappers' own, which the kernels write in place at every even
    head dim."""
    if q.shape[-2] > MAX_SEQ:
        return "reference"
    if q.dtype == torch.float32 or q.shape[-1] > MAX_WIDE_HEAD_DIM:
        return "cuda_cores"
    if tma_ready(q, k, v) and tma_ready(do):
        return "tensor_cores"
    return "tensor_cores_copy"


def build_fused_fwd_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the CUDA-core forward of K7 and K11
    (fp32 on csrc/attn_fwd_simt.cuh's register tiles to MAX_WIDE_HEAD_DIM,
    every dtype past it on run-time loops)."""
    return _load("fused_attn_fwd", "vtx_fused_attn_fwd",
                 [_P] * 4 + [_STRIDES, _I, _I, _I, _I, ctypes.c_float, _I,
                             _P])


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
                num_heads: int, views: bool = False) -> None:
    """The kernels' contract; raises on what they do not take: S <=
    MAX_SEQ and D <= MAX_CUDA_CORE_HEAD_DIM. `views`: the tensors are (B,
    H, S, D) views of one dtype that the kernels (K7, K8, K10-K12) take in
    place or copied; else contiguous tensors whose first three share one
    dtype, with an even D (K1, K2, K9, and K10's qkv buffer). The dtype is
    one of KERNEL_DTYPES. B and H are bound by no grid dimension."""
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not "
                         f"{[str(t.device) for t in tensors]}")
    typed = tensors if views else tensors[:3]
    dtypes = {t.dtype for t in typed}
    if len(dtypes) != 1 or not dtypes <= set(KERNEL_DTYPES):
        raise TypeError(f"the attention kernels take tensors of one of "
                        f"{KERNEL_DTYPES}, not {[t.dtype for t in typed]}")
    if s > MAX_SEQ:
        raise ValueError(
            f"sequence {s} > {MAX_SEQ}: {name} takes S <= {MAX_SEQ}; longer "
            f"sequences go through fused_attention_qkv_cols to "
            f"ops/flash_blocked.py, or through fused_attention and "
            f"fused_attention_qkv to reference_attention")
    if d > MAX_CUDA_CORE_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be <= {MAX_CUDA_CORE_HEAD_DIM}")
    if views:
        return
    if d % 2:
        raise ValueError(f"head_dim {d} must be even and <= "
                         f"{MAX_CUDA_CORE_HEAD_DIM}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _stride_array(tensors, s: int, d: int):
    """The (batch, head, token) element strides of (B, H, S, D) views, 0
    for a dimension of size 1 (its stride is arbitrary), as the kernels'
    int64 array; None where the kernels cannot take the views in place.
    They read and write rows as pairs of elements and one head's rows by
    int offsets: an even, contiguous head dim, even strides, data aligned
    to a pair and < 2^31 elements over one head's rows."""
    if d % 2:
        return None
    vals = []
    for t in tensors:
        st = [x if n > 1 else 0 for n, x in zip(t.shape[:3], t.stride()[:3])]
        if t.stride(-1) != 1 or t.data_ptr() % (2 * t.element_size()) \
                or any(x % 2 for x in st) or st[2] * (s - 1) + d >= 2 ** 31:
            return None
        vals += st
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch_views(launch, ins, outs, name: str) -> None:
    """Run a strided kernel on (B, H, S, D) views: `launch(ins, outs,
    strides)` is one launch. Views the kernel cannot take in place
    (`_stride_array`: an odd head dim, odd strides, data not aligned to a
    pair of elements) are copied once by `padded_copy`, the head dim
    zero-padded to even (zero columns add nothing to q·kᵀ and give zero
    columns of o and of the gradients), and the outputs sliced back into
    `outs`. The kernels read the views they take in pieces their rows
    allow: csrc/attn_fwd_simt.cuh copies 16 bytes at a time where every row
    is 16-byte aligned, else 8 (a head dim of 130, views two floats late),
    so no view of a pair-aligned layout is copied in Python."""
    _, _, s, d = ins[0].shape
    strides = _stride_array((*ins, *outs), s, d)
    if strides is not None:
        launch(ins, outs, strides)
        return
    pads = padded_copy(ins, 2, name)
    tmp = [torch.empty(pads[0].shape, dtype=t.dtype, device=t.device)
           for t in outs]
    launch(pads, tmp, _stride_array((*pads, *tmp), s, pads[0].shape[-1]))
    for t, p in zip(outs, tmp):
        t.copy_(p[..., :d])


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.vtx_cuda_error_string(rc).decode())


def _q_hat(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q̂ = T(q · T(scale)) in fp32, T q's dtype: K1, K2 and K9 scale q in
    its dtype (:305, :535), as JAX multiplies a T array by a Python float,
    so the scale is rounded to T first (exact at a power of two)."""
    s_t = torch.tensor(scale, dtype=q.dtype).float()
    return (q.float() * s_t).to(q.dtype).float()


def attn_fwd_reference(qkv: torch.Tensor, num_heads: int, scale: float,
                       with_stats: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the forward kernel, in its cast order.

    qkv: (B, S, 3·H·D) -> o (B, S, H·D) in qkv's dtype, and with_stats the
    (B, H, S, 2) fp32 row stats [m, 1/Σp]."""
    b, s, c = qkv.shape
    d = c // (3 * num_heads)
    t = qkv.reshape(b, s, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q = _q_hat(t[0], scale)
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
    """One launch of the forward kernel of qkv's dtype
    (`attn_kernel_route`); the stats pointer is null without stats."""
    b, s, _ = qkv.shape
    d = _head_dim(qkv, num_heads)
    _check_cuda(name, (qkv,), s, d, b, num_heads)
    o = torch.empty((b, s, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    st = torch.empty((b, num_heads, s, 2), dtype=torch.float32,
                     device=qkv.device) if with_stats else None
    st_ptr = st.data_ptr() if st is not None else None
    code = cuda_build.dtype_code(qkv.dtype)
    route = attn_kernel_route(qkv, num_heads)
    if route != "cuda_cores":
        q, k, v = heads(qkv, num_heads)
        if route == "tensor_cores_copy":
            q, k, v = padded_copy((q, k, v), TMA_ALIGN, name)
        lib = build_tc_kernels()
    else:
        lib = build_kernels()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        if route == "cuda_cores":
            rc = lib.vtx_attn_fwd(qkv.data_ptr(), o.data_ptr(), st_ptr, b, s,
                                  num_heads, d, scale, code, stream)
        else:
            rc = lib.vtx_attn_fwd_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                st_ptr, b, num_heads, s, d, scale, *_tma_layout(q),
                *_head_major(o, num_heads).stride()[:3], code, stream)
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
    `_hp_fwd_stats_kernel`'s cast order, so its kernel is K1's launch with
    the stats pointer null and its plain version
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
    q = _q_hat(t[0], scale)                                    # q̂
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
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((b, c), dtype=torch.float32, device=qkv.device)
    route = attn_kernel_route(qkv, num_heads, do, o)
    if route == "cuda_cores":
        _launch_bwd_cuda_cores(qkv, do, o, st, dqkv, dbias, num_heads, scale)
    else:
        _launch_bwd_tc(qkv, do, o, st, dqkv, dbias, num_heads, scale,
                       route == "tensor_cores_copy")
    ATTN_BWD_LAUNCHES += 1
    return dqkv, dbias


def _launch_bwd_cuda_cores(qkv, do, o, st, dqkv, dbias, num_heads: int,
                           scale: float) -> None:
    """csrc/attn_bwd.cu's library (fp32; every dtype at a head dim over
    MAX_WIDE_HEAD_DIM) with the fp32 scratch its `vtx_attn_bwd_scratch`
    asks for: one launch, a block per (b, h) (and 64-column chunk of a head
    over MAX_WIDE_HEAD_DIM), whose scratch is t·k summed over the key
    tiles; or in fp32 at MAX_HEAD_DIM < D <= MAX_WIDE_HEAD_DIM
    csrc/attn_bwd_simt.cu's four launches, whose scratch holds each row's
    stats and delta, each 32-key block's part of dq and the bias partials
    of each 32-row tile."""
    b, s, c = qkv.shape
    d = c // (3 * num_heads)
    dev = qkv.device
    lib = build_bwd_kernels()
    dq_sum = torch.empty(
        lib.vtx_attn_bwd_scratch(b, s, num_heads, d,
                                 cuda_build.dtype_code(qkv.dtype)),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vtx_attn_bwd(
            qkv.data_ptr(), do.data_ptr(), o.data_ptr(), st.data_ptr(),
            dqkv.data_ptr(), dbias.data_ptr(), dq_sum.data_ptr(), b, s,
            num_heads, d, scale, cuda_build.dtype_code(qkv.dtype), stream)
    _raise_on(lib, rc, "attention backward")


def _launch_bwd_tc(qkv, do, o, st, dqkv, dbias, num_heads: int,
                   scale: float, copy: bool) -> None:
    """csrc/attn_bwd_tc.cu (bf16, fp16): q, k, v read as head views of
    qkv, dO and O as head views of their (B, S, H·D) buffers, or all five
    from one `padded_copy` when `copy`; dq, dk and dv written into dqkv's
    head views."""
    b, s, c = qkv.shape
    h = num_heads
    d = c // (3 * h)
    dev = qkv.device
    q, k, v = heads(qkv, h)
    g, out = _head_major(do, h), _head_major(o, h)
    if copy:
        q, k, v, g, out = padded_copy((q, k, v, g, out), TMA_ALIGN,
                                      "attn_bwd")
    dq, dk, dv = heads(dqkv, h)
    lib = build_tc_bwd_kernels()
    # scratch: q̂, q̂/Σp and dO/Σp with rows TMA reads, rowsum(dO·O), and
    # the bias partials of each of the kernels' row tiles (128 rows to
    # MAX_HEAD_DIM, 64 past it)
    dsc = -(-d // TMA_ALIGN) * TMA_ALIGN
    scratch = torch.empty((3, b, h, s, dsc), dtype=qkv.dtype, device=dev)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    part = torch.empty((b, lib.vtx_attn_bwd_tc_tiles(s, d), c),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vtx_attn_bwd_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *_tma_layout(q),
            g.data_ptr(), out.data_ptr(), *_tma_layout(g), st.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dq.stride()[:3],
            dbias.data_ptr(), *(t.data_ptr() for t in scratch), dsc,
            delta.data_ptr(), part.data_ptr(), b, h, s, d, scale,
            cuda_build.dtype_code(qkv.dtype), stream)
    _raise_on(lib, rc, "attention backward")


def _softmax_rows(s: torch.Tensor) -> torch.Tensor:
    """exp(s - rowmax) / its row sum, normalised in fp32 (:734-737)."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def fused_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch version of K7 and K11, in their cast order (:47-56,
    :753-759), which is not K1's: s = (q·kᵀ in fp32 from the raw values)
    ·scale; p = exp(s - m) / Σ, normalised in fp32; o = bf16(p)·v with an
    fp32 accumulator. q, k, v: (..., S, D) -> (..., S, D) in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = _softmax_rows(s)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def fused_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8, K10 and K12, in their cast order
    (:72-90, :223-245, :776-786), which is not K2's.

    q, k, v, do: (..., S, D) -> dq, dk, dv in q's dtype. s = (q·kᵀ in fp32
    from the raw values)·scale; p = exp(s - m) / Σ, normalised in fp32;
    dv = bf16(p)ᵀ·dO; dp = dO·vᵀ; ds = bf16(p (dp - Σ dp·p)); dq =
    ds·k·scale and dk = dsᵀ·q·scale."""
    dt = q.dtype
    q, k, v, g = (t.float() for t in (q, k, v, do))
    p = _softmax_rows(torch.matmul(q, k.transpose(-1, -2)) * scale)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def hp_bwd_reference(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                     scale: float) -> torch.Tensor:
    """Plain PyTorch version of the head-pair backward kernel (K10):
    `fused_bwd_reference` over the heads of a qkv buffer.

    qkv (B, S, 3·H·D), do (B, S, H·D) -> dqkv (B, S, 3·H·D) in qkv's dtype,
    columns [dq | dk | dv]."""
    b, s, c = qkv.shape
    g = do.reshape(b, s, num_heads, -1).transpose(1, 2)
    grads = fused_bwd_reference(*heads(qkv, num_heads), g, scale)
    return torch.stack(grads).permute(1, 3, 0, 2, 4).reshape(b, s, c)


def _launch_bwd(ins, outs, scale: float, name: str) -> None:
    """One call of K8's function (two launches): q, k, v, dO in and dq, dk,
    dv out, all (B, H, S, D) of one dtype, the outputs of one layout, on
    the kernels of `bwd_kernel_route`. The tensor-core kernels read q, k, v
    and dO through tensor maps (after one `padded_copy` of all four to a
    multiple of 8 when TMA cannot read them in place, the maps keeping the
    real head dim as their extent) and write the outputs in place; an odd
    head dim runs at the next even one, the copies' zero column, into
    temporary outputs that are sliced back. The fp32 kernels read and
    write by stride (`_launch_views`)."""
    b, h, s, d = ins[0].shape
    _check_cuda(name, (*ins, *outs), s, d, b, h, views=True)
    route = bwd_kernel_route(*ins)
    dev = ins[0].device
    code = cuda_build.dtype_code(ins[0].dtype)
    if route == "cuda_cores":
        lib = build_hp_bwd_kernels()

        def launch(ins, outs, strides):
            b, h, s, d = ins[0].shape
            # scratch: the rows' softmax stats, and for the fp32 kernels at
            # D <= MAX_WIDE_HEAD_DIM each key block's part of dq
            stats = torch.empty(lib.vtx_hp_bwd_scratch(b, s, h, d, code),
                                dtype=torch.float32, device=dev)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = lib.vtx_hp_bwd(*(t.data_ptr() for t in (*ins, *outs)),
                                    stats.data_ptr(), strides, b, s, h, d,
                                    scale, code, stream)
            _raise_on(lib, rc, f"{name} attention backward")

        _launch_views(launch, ins, outs, name)
        return
    if route == "tensor_cores_copy":
        ins = padded_copy(ins, TMA_ALIGN, name)
    q, k, v, g = ins
    de = d + d % 2   # the kernels' head dim: even
    dst = outs if de == d else [
        torch.empty((b, h, s, de), dtype=t.dtype, device=dev) for t in outs]
    # scratch: each query row's [m, Σ exp, Σ dp·p] from the dq launch
    stats = torch.empty((b, h, s, 3), dtype=torch.float32, device=dev)
    lib = build_hp_bwd_tc_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vtx_hp_bwd_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *_tma_layout(q),
            g.data_ptr(), *_tma_layout(g), *(t.data_ptr() for t in dst),
            *dst[0].stride()[:3], stats.data_ptr(), b, h, s, de, scale, code,
            stream)
    _raise_on(lib, rc, f"{name} attention backward")
    if dst is not outs:
        for t, tmp in zip(outs, dst):
            t.copy_(tmp[..., :d])


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
    _launch_bwd((*heads(qkv, num_heads), _head_major(do, num_heads)),
                heads(dqkv, num_heads), scale, "hp_bwd")
    HP_BWD_LAUNCHES += 1
    return dqkv


def _head_major(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, H, S, D) view of a (B, S, H·D) tensor."""
    b, s, c = x.shape
    return x.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)


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


def _launch_fused_fwd(q, k, v, o, scale: float, name: str) -> None:
    """One launch of K7's function: q, k, v in and o out, all (B, H, S, D)
    of one dtype, on the kernel of `fused_kernel_route`. The tensor-core
    kernel reads q, k, v through tensor maps (after one `padded_copy` to a
    multiple of 8 when TMA cannot read them in place, the maps keeping the
    real head dim as their extent) and writes o in place; an odd head dim
    runs at the next even one, the copies' zero column, into a temporary o
    that is sliced back. The fp32 kernel reads and writes by stride
    (`_launch_views`)."""
    b, h, s, d = q.shape
    _check_cuda(name, (q, k, v, o), s, d, b, h, views=True)
    route = fused_kernel_route(q, k, v)
    dev = q.device
    if route == "cuda_cores":
        lib = build_fused_fwd_kernels()

        def launch(ins, outs, strides):
            b, h, s, d = ins[0].shape
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = lib.vtx_fused_attn_fwd(
                    *(t.data_ptr() for t in (*ins, *outs)), strides, b, s, h,
                    d, scale, cuda_build.dtype_code(ins[0].dtype), stream)
            _raise_on(lib, rc, f"{name} attention forward")

        _launch_views(launch, (q, k, v), (o,), name)
        return
    if route == "tensor_cores_copy":
        q, k, v = padded_copy((q, k, v), TMA_ALIGN, name)
    de = d + d % 2   # the kernel's head dim: even
    dst = o if de == d else torch.empty((b, h, s, de), dtype=o.dtype,
                                        device=dev)
    lib = build_tc_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vtx_fused_attn_fwd_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dst.data_ptr(), b, h, s,
            de, scale, *_tma_layout(q), *dst.stride()[:3],
            cuda_build.dtype_code(q.dtype), stream)
    _raise_on(lib, rc, f"{name} attention forward")
    if dst is not o:
        o.copy_(dst[..., :d])


def _same_shape(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    if q.dim() != 4 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{name} takes (B, H, S, D) tensors of one shape, "
                         f"not {[tuple(t.shape) for t in (q, *others)]}")


def fused_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """K7: softmax attention of (B, H, S, D) q, k, v -> (B, H, S, D)."""
    global FUSED_FWD_LAUNCHES
    _same_shape("fused_fwd", q, k, v)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return fused_fwd_reference(q, k, v, scale)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_fused_fwd(q, k, v, o, scale, "fused_fwd")
    FUSED_FWD_LAUNCHES += 1
    return o


def fused_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8: the gradient of `fused_fwd` from q, k, v and dO, all (B, H, S,
    D); returns dq, dk, dv."""
    global FUSED_BWD_LAUNCHES
    _same_shape("fused_bwd", q, k, v, do)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return fused_bwd_reference(q, k, v, do, scale)
    grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    _launch_bwd((q, k, v, do), grads, scale, "fused_bwd")
    FUSED_BWD_LAUNCHES += 1
    return grads


def _qkv_heads(qkv: torch.Tensor, num_heads: Optional[int]):
    """q, k, v: (B, H, S, D) views of a (B, S, 3, H, D) qkv buffer, or of its
    (B, S, 3·H·D) view given num_heads."""
    if qkv.dim() == 5 and qkv.shape[2] == 3 and num_heads in (
            None, qkv.shape[3]):
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)
    if qkv.dim() == 3 and num_heads is not None:
        _head_dim(qkv, num_heads)
        return heads(qkv, num_heads)
    raise ValueError(f"qkv {tuple(qkv.shape)} is neither (B, S, 3, H, D) nor "
                     f"(B, S, 3·H·D) with num_heads={num_heads}")


def qkv_fwd(qkv: torch.Tensor, num_heads: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """K11: softmax attention of the heads of a (B, S, 3, H, D) qkv buffer
    (or its (B, S, 3·H·D) view) -> (B, S, H·D), read in place."""
    global QKV_FWD_LAUNCHES
    q, k, v = _qkv_heads(qkv, num_heads)
    b, h, s, d = q.shape
    scale = float(scale if scale is not None else d ** -0.5)
    if qkv.device.type == "cpu":
        o = fused_fwd_reference(q, k, v, scale)
        return o.transpose(1, 2).reshape(b, s, h * d)
    o = torch.empty((b, s, h * d), dtype=qkv.dtype, device=qkv.device)
    _launch_fused_fwd(q, k, v, _head_major(o, h), scale, "qkv_fwd")
    QKV_FWD_LAUNCHES += 1
    return o


def qkv_bwd(qkv: torch.Tensor, do: torch.Tensor,
            num_heads: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """K12: the gradient of `qkv_fwd` with respect to its qkv buffer, from
    qkv and dO (B, S, H·D) alone: dqkv of qkv's shape, [dq | dk | dv]."""
    global QKV_BWD_LAUNCHES
    q, k, v = _qkv_heads(qkv, num_heads)
    b, h, s, d = q.shape
    scale = float(scale if scale is not None else d ** -0.5)
    if do.shape != (b, s, h * d):
        raise ValueError(f"do {tuple(do.shape)} does not fit qkv "
                         f"{tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        # K12's function is K10's, over the same [q | k | v] layout
        return hp_bwd_reference(qkv.reshape(b, s, 3 * h * d), do, h,
                                scale).reshape(qkv.shape)
    if do.stride(-1) != 1:
        raise ValueError(f"qkv_bwd takes a dO whose last dimension has "
                         f"stride 1, not {do.stride()}")
    dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    _launch_bwd((q, k, v, _head_major(do, h)), _qkv_heads(dqkv, num_heads),
                scale, "qkv_bwd")
    QKV_BWD_LAUNCHES += 1
    return dqkv


class FusedAttention(torch.autograd.Function):
    """The custom VJP `_fused_attention_padded` (:153-168): forward
    `fused_fwd` (K7), which saves only q, k and v; backward `fused_bwd`
    (K8)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return fused_fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*fused_bwd(q, k, v, do.contiguous(), ctx.scale), None)


class FusedAttentionQkv(torch.autograd.Function):
    """The custom VJP `_fused_attention_qkv_padded` (:841-854): forward
    `qkv_fwd` (K11), which saves only qkv; backward `qkv_bwd` (K12)."""

    @staticmethod
    def forward(ctx, qkv, scale: float):
        ctx.save_for_backward(qkv)
        ctx.scale = scale
        return qkv_fwd(qkv, scale=scale)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return qkv_bwd(qkv, do.contiguous(), scale=ctx.scale), None


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
    head_dim <= MAX_CUDA_CORE_HEAD_DIM and any head count."""
    _, s, _ = qkv.shape
    scale = _scale(qkv, num_heads, scale)
    if s <= MAX_SEQ:
        return HeadPairAttention.apply(qkv, num_heads, scale)
    return FlashAttentionBlocked.apply(qkv, num_heads, scale)


def fused_attention_qkv(qkv: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention from a fused qkv tensor (B, S, 3, H, D) -> (B, S, H·D)
    (:857). `FusedAttentionQkv` (K11 forward, K12 backward), reading the
    heads in place; where `fused_kernel_route` says 'reference' (S >
    MAX_SEQ, as the JAX function routes it) `reference_attention` under
    autograd."""
    b, s, three, h, d = qkv.shape
    if three != 3:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (B, S, 3, H, D)")
    scale = float(scale if scale is not None else d ** -0.5)
    heads5 = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    if fused_kernel_route(*heads5) == "reference":
        o = reference_attention(*heads5, scale)
        return o.transpose(1, 2).reshape(b, s, h * d)
    return FusedAttentionQkv.apply(qkv, scale)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention, q, k, v: (B, H, S, D) -> (B, H, S, D) (:880).
    `FusedAttention` (K7 forward, K8 backward), which reads q, k and v by
    stride, so views of one qkv buffer need no copy; where
    `fused_kernel_route` says 'reference' (S > MAX_SEQ, as the JAX function
    routes it) `reference_attention` under autograd."""
    d = q.shape[-1]
    scale = float(scale if scale is not None else d ** -0.5)
    if fused_kernel_route(q, k, v) == "reference":
        return reference_attention(q, k, v, scale)
    return FusedAttention.apply(q, k, v, scale)
