"""The model axis: the collectives of tensor and sequence parallelism.

In JAX the params carry logical axes and GSPMD inserts every collective
(parallel/mesh.py:29-51, models/vit.py:282). Here each rank of the
`model` axis runs its part of the model and the layers call these
autograd-aware collectives themselves (models/layers.py, models/vit.py):

  * tensor parallelism (the rules map `heads`, `mlp` and `qkv_out` to
    `model`; docs/PARALLELISM.md: "qkv/fc1 column-parallel, proj/fc2
    row-parallel"). A rank holds q, k and v of its own H/M heads and its
    own H/M of the MLP's hidden columns as plain tensors
    (parallel/sharding.py::split_heads): its model is a narrower model, so
    DDP and FSDP2 on the data axis wrap it as they wrap any model. A split
    layer's input goes through `copy_in` (forward the identity, backward
    the sum of the ranks' input gradients) and its row-parallel product
    through `reduce_out` (forward the sum, backward the identity), and the
    kernels run unchanged on the rank's heads and columns. JAX's GSPMD
    gathers the qkv weight in front of the TPU kernel
    (ops/flash_attention.py:379-436) and computes every head on every
    model rank; the port keeps each rank on its own heads (ROADMAP §3).
  * sequence parallelism (--param_sharding sp: `seq_act` to `model`,
    params replicated there). Each block's input holds this rank's
    ceil(S/M) tokens (the last rank's tail padded with zeros, as GSPMD
    pads); attention gathers the whole sequence (`gather_tokens`), runs
    the unsplit model's route on it and keeps this rank's query rows.

The gradient rule under sp: every gather's backward sums the ranks'
gradients. The last gather hands each peer the same loss, so every
parameter's gradient on a peer is M times its share and the peers' sum is
M times the one-process gradient; the data-parallel wrapper averages over
all D x M ranks of the mesh (parallel/sharding.py::wrap_model), which
leaves the mean over the data axis, the one-process gradient on the
global batch.

`Split` says how a parameter is cut over the model axis; `rows` takes a
rank's part of a whole tensor and `join` puts the parts back together (a
collective), so checkpoints and `full` give timm's whole tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the `model` axis: its `index` of `count`
    peers, joined by `group`."""

    group: object
    index: int
    count: int


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' sum of x, added in fp32, in x's dtype."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _all_gather(x: torch.Tensor, group, count: int) -> torch.Tensor:
    """(count, *x.shape): every rank's x in rank order (gathered into one
    buffer along dim 0, the layout gloo takes too; bf16 and fp16 travel as
    fp32, which holds them exactly, as every backend takes fp32)."""
    wire = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    out = wire.new_empty((count * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, wire.contiguous(), group=group)
    return out.view((count,) + tuple(x.shape)).to(x.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: ModelAxis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: ModelAxis):
        return _all_reduce(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: ModelAxis):
        ctx.axis = axis
        x = x.contiguous()
        out = _all_gather(x, axis.group, axis.count)
        b, n = x.shape[:2]
        return out.transpose(0, 1).reshape((b, axis.count * n)
                                           + tuple(x.shape[2:]))

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        n = g.shape[1] // axis.count
        return _all_reduce(g, axis.group).narrow(1, axis.index * n, n), None


def copy_in(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """x into a split region: the identity; its gradient is the model
    ranks' sum (each rank's part of the layer gives part of it)."""
    return _CopyIn.apply(x, axis)


def reduce_out(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """A row-parallel product out of a split region: the model ranks' sum
    of their partial products (in fp32); the gradient passes as it is."""
    return _ReduceOut.apply(x, axis)


def gather_tokens(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """(B, n, ...) token slices -> (B, M·n, ...), rank order along the
    tokens; the gradient is the ranks' sum, narrowed to this rank's
    slice."""
    return _GatherTokens.apply(x, axis)


def token_slice(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """This rank's ceil(S/M) tokens of (B, S, ...), the tail padded with
    zeros. The gradient of the rest is zero: each peer's gradient counts
    its own tokens only."""
    s = x.shape[1]
    n = -(-s // axis.count)
    pad = n * axis.count - s
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
    return x.narrow(1, axis.index * n, n)


# the unpadded token count of the sequence being split (`tokens_of`)
_TOKENS: List[int] = []


@contextlib.contextmanager
def tokens_of(length: Optional[int]):
    """Within the block, attention under sp trims what it gathers to
    `length` tokens (the padding never becomes a key); None changes
    nothing."""
    if length is None:
        yield None
        return
    _TOKENS.append(length)
    try:
        yield length
    finally:
        _TOKENS.pop()


def current_tokens() -> Optional[int]:
    """The innermost `tokens_of` length, or None."""
    return _TOKENS[-1] if _TOKENS else None


def token_count() -> int:
    if not _TOKENS:
        raise RuntimeError("attention split over the tokens outside "
                           "tokens_of()")
    return _TOKENS[-1]


@dataclasses.dataclass(frozen=True)
class Split:
    """How a parameter is cut over the model axis: along `dim`, in `parts`
    equal blocks, the rank holding piece `axis.index` of `axis.count` of
    every block. qkv's rows are three blocks (q | k | v), so a rank holds
    q, k and v of the same heads; a packed SwiGLU fc1 two (gate | value)."""

    dim: int
    parts: int
    axis: ModelAxis

    def rows(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole tensor."""
        c, i = self.axis.count, self.axis.index
        return torch.cat([block.chunk(c, self.dim)[i] for block in
                          whole.chunk(self.parts, self.dim)], self.dim)

    def join(self, part: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's part (a collective)."""
        out = _all_gather(part.contiguous(), self.axis.group, self.axis.count)
        pieces = [p.chunk(self.parts, self.dim) for p in out.unbind(0)]
        return torch.cat([pieces[r][j] for j in range(self.parts)
                          for r in range(self.axis.count)], self.dim)
