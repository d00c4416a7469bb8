"""The optimizers of the JAX factory as plain PyTorch updates.

Counterpart of the optax 0.2.6 transforms that
vision_transformers_torch_xla_tpu/train/optim.py::_lookup and
::create_optimizer chain (:158-192, :217-373), with their numerics:
`ScaleByAdam` (adam, adamw, lamb; nadam's nesterov form), `ScaleByRadam`,
`ScaleByAdadelta`, `ScaleByRss` (adagrad), `ScaleByAdamax`,
`ScaleByFactoredRms`, `ClipByBlockRms` and `ScaleByParamBlockRms`
(adafactor), `ScaleByRms` (rmsprop, rmsproptf), `Trace` (momentum),
`ScaleByNovograd`, `ScaleByTrustRatio` (lamb, lars), `ScaleByLion`,
`AddDecayedWeights`, `ScaleByLearningRate`, `ClipByGlobalNorm`,
`LayerDecay`, and the wrappers `Lookahead` (JAX optim.py:158-192) and
`MultiSteps` (optax.MultiSteps: `--update_freq`).

An element maps the updates `u` (name -> fp32 tensor) to new ones and
keeps its state in a dict of tensors by parameter name; `count` is the
number of updates its chain has applied, which the schedules (JAX's
inject_hyperparams and scale_by_schedule) and the bias corrections read.
Under MultiSteps the chain runs once per real update, so its count, and
with it the lr and wd schedules, advance once every k micro-steps.
`Optimizer` runs a chain over the params in place, with the train step's
`fused_update` interface (train/fused.py::FusedAdamW's). Its moments
are fp32 whatever the param dtype, as FusedAdamW's.

In the JAX package this is XLA's elementwise work, not a Pallas kernel,
so here it is torch ops on each tensor. Under FSDP2 the params and the
state are DTensor shards and an element works on the local shard
(parallel/sharding.py::local); on the mesh's model axis the split tensors
are each rank's part. The elements that read a whole tensor (a norm, a
mean over rows or columns: `whole_tensor`) refuse both.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (
    is_sharded,
    local,
)
from vision_transformers_torch_xla_tpu_torch.train.fused import global_norm

Tensors = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[int], float]]


def at(value: Schedule, count: int) -> float:
    """A schedule's value at `count`, or the constant."""
    return float(value(count)) if callable(value) else value


def zeros(params: Mapping[str, torch.Tensor]) -> Tensors:
    """fp32 zeros like each param (a DTensor shard for a shard)."""
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


class Transform:
    """init(params) -> state; update(u, state, params, count, **extra) ->
    new updates. `params` maps names to fp32 local tensors in `update`,
    to the live params in `init`."""
    whole_tensor = False

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return {}

    def update(self, u: Tensors, state: dict, params: Tensors, count: int,
               **extra) -> Tensors:
        raise NotImplementedError


def _moment(t: torch.Tensor, g: torch.Tensor, decay: float) -> torch.Tensor:
    """t <- (1 − decay)·g + decay·t in place (optax update_moment)."""
    return t.mul_(decay).add_(g, alpha=1.0 - decay)


def _sq_moment(t: torch.Tensor, g: torch.Tensor, decay: float
               ) -> torch.Tensor:
    """t <- (1 − decay)·g² + decay·t in place."""
    return t.mul_(decay).addcmul_(g, g, value=1.0 - decay)


class ScaleByAdam(Transform):
    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, nesterov=False):
        self.b1, self.b2, self.eps, self.nesterov = b1, b2, eps, nesterov

    def init(self, params):
        return {"mu": zeros(params), "nu": zeros(params)}

    def update(self, u, state, params, count, **extra):
        b1, b2, t = self.b1, self.b2, count + 1
        out = {}
        for k, g in u.items():
            m = _moment(local(state["mu"][k]), g, b1)
            v = _sq_moment(local(state["nu"][k]), g, b2)
            if self.nesterov:
                mh = b1 * (m / (1 - b1 ** (t + 1))) + \
                    (1 - b1) * (g / (1 - b1 ** t))
            else:
                mh = m / (1 - b1 ** t)
            out[k] = mh / ((v / (1 - b2 ** t)).sqrt() + self.eps)
        return out


class ScaleByRadam(Transform):
    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, threshold=5.0):
        self.b1, self.b2, self.eps, self.threshold = b1, b2, eps, threshold

    def init(self, params):
        return {"mu": zeros(params), "nu": zeros(params)}

    def update(self, u, state, params, count, **extra):
        b1, b2, t = self.b1, self.b2, count + 1
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = np.float32(b2) ** np.float32(t)
        ro = float(np.float32(ro_inf) - 2 * np.float32(t) * b2t / (1 - b2t))
        r = ((ro - 4.0) * (ro - 2.0) * ro_inf
             / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)) ** 0.5 \
            if ro >= self.threshold else None
        out = {}
        for k, g in u.items():
            m = _moment(local(state["mu"][k]), g, b1)
            v = _sq_moment(local(state["nu"][k]), g, b2)
            mh = m / (1 - b1 ** t)
            out[k] = mh if r is None else \
                r * mh / ((v / (1 - b2 ** t)).sqrt() + self.eps)
        return out


class ScaleByAdadelta(Transform):
    def __init__(self, rho=0.9, eps=1e-6):
        self.rho, self.eps = rho, eps

    def init(self, params):
        return {"e_g": zeros(params), "e_x": zeros(params)}

    def update(self, u, state, params, count, **extra):
        out = {}
        for k, g in u.items():
            e_g = _sq_moment(local(state["e_g"][k]), g, self.rho)
            e_x = local(state["e_x"][k])
            step = (e_x + self.eps).sqrt() / (e_g + self.eps).sqrt() * g
            _sq_moment(e_x, step, self.rho)
            out[k] = step
        return out


class ScaleByRss(Transform):
    def __init__(self, initial_accumulator_value=0.1, eps=1e-7):
        self.init_value, self.eps = initial_accumulator_value, eps

    def init(self, params):
        return {"sum_of_squares": {k: z.fill_(self.init_value)
                                   for k, z in zeros(params).items()}}

    def update(self, u, state, params, count, **extra):
        out = {}
        for k, g in u.items():
            s = local(state["sum_of_squares"][k]).addcmul_(g, g)
            out[k] = torch.where(s > 0, torch.rsqrt(s + self.eps),
                                 torch.zeros_like(s)) * g
        return out


class ScaleByAdamax(Transform):
    def __init__(self, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"mu": zeros(params), "nu": zeros(params)}

    def update(self, u, state, params, count, **extra):
        t = count + 1
        out = {}
        for k, g in u.items():
            m = _moment(local(state["mu"][k]), g, self.b1)
            v = local(state["nu"][k])
            v.copy_(torch.maximum(g.abs() + self.eps, self.b2 * v))
            out[k] = (m / (1 - self.b1 ** t)) / v
        return out


class ScaleByRms(Transform):
    def __init__(self, decay=0.9, eps=1e-8, initial_scale=0.0):
        self.decay, self.eps, self.initial_scale = decay, eps, initial_scale

    def init(self, params):
        return {"nu": {k: z.fill_(self.initial_scale)
                       for k, z in zeros(params).items()}}

    def update(self, u, state, params, count, **extra):
        return {k: torch.rsqrt(_sq_moment(local(state["nu"][k]), g,
                                          self.decay) + self.eps) * g
                for k, g in u.items()}


class Trace(Transform):
    """Momentum: t <- g + decay·t; the update is t, or g + decay·t under
    nesterov."""

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov

    def init(self, params):
        return {"trace": zeros(params)}

    def update(self, u, state, params, count, **extra):
        out = {}
        for k, g in u.items():
            t = local(state["trace"][k])
            t.copy_(g + self.decay * t)
            out[k] = g + self.decay * t if self.nesterov else t.clone()
        return out


class ScaleByNovograd(Transform):
    """Layer-wise second moment: one ‖g‖² a tensor; the first update
    starts both moments (optax's lax.cond on count 1)."""
    whole_tensor = True

    def __init__(self, b1=0.95, b2=0.98, eps=1e-8,
                 weight_decay: Schedule = 0.0):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def init(self, params):
        return {"mu": zeros(params),
                "nu": {k: torch.zeros((), device=p.device)
                       for k, p in params.items()}}

    def update(self, u, state, params, count, **extra):
        wd = at(self.wd, count)
        out = {}
        for k, g in u.items():
            n, m = state["nu"][k], local(state["mu"][k])
            sq = torch.linalg.vector_norm(g) ** 2
            if count == 0:
                n.copy_(sq)
            else:
                _moment(n, sq, self.b2)
            step = g / (n.sqrt() + self.eps) + wd * params[k]
            m.copy_(step if count == 0 else self.b1 * m + step)
            out[k] = m.clone()
        return out


class ScaleByTrustRatio(Transform):
    """u · coef‖p‖ / (‖u‖ + eps), or u where either norm is 0."""
    whole_tensor = True

    def __init__(self, trust_coefficient=1.0, eps=0.0):
        self.coef, self.eps = trust_coefficient, eps

    def update(self, u, state, params, count, **extra):
        out = {}
        for k, g in u.items():
            pn = torch.linalg.vector_norm(params[k])
            un = torch.linalg.vector_norm(g)
            ratio = self.coef * pn / (un + self.eps)
            out[k] = g * torch.where((pn == 0) | (un == 0),
                                     torch.ones_like(ratio), ratio)
        return out


class ScaleByLion(Transform):
    def __init__(self, b1=0.9, b2=0.99):
        self.b1, self.b2 = b1, b2

    def init(self, params):
        return {"mu": zeros(params)}

    def update(self, u, state, params, count, **extra):
        out = {}
        for k, g in u.items():
            m = local(state["mu"][k])
            out[k] = torch.sign((1.0 - self.b1) * g + self.b1 * m)
            _moment(m, g, self.b2)
        return out


def _factored_dims(shape, min_dim: int):
    """optax factorized._factored_dims: (d1, d0), the second largest and
    the largest axes, or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class ScaleByFactoredRms(Transform):
    """Adafactor's factored second moment (optax factorized.py). The
    tensors in `dense_views` (a conv-shaped weight that the JAX model
    holds as a (p·p·C, O) dense kernel) take the factoring of that
    matrix, as (O, p·p·C)."""
    whole_tensor = True

    def __init__(self, decay_rate=0.8, min_dim_size_to_factor=128,
                 eps=1e-30, dense_views: Sequence[str] = ()):
        self.decay_rate, self.min_dim = decay_rate, min_dim_size_to_factor
        self.eps, self.dense_views = eps, set(dense_views)

    def _view(self, k: str, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t.shape[0], -1) if k in self.dense_views else t

    def init(self, params):
        state = {"v_row": {}, "v_col": {}, "v": {}}
        for k, p in params.items():
            shape = tuple(self._view(k, p).shape)
            dims = _factored_dims(shape, self.min_dim)
            z = dict(dtype=torch.float32, device=p.device)
            if dims is None:
                state["v"][k] = torch.zeros(shape, **z)
            else:
                d1, d0 = dims
                state["v_row"][k] = torch.zeros(np.delete(shape, d0).tolist(),
                                                **z)
                state["v_col"][k] = torch.zeros(np.delete(shape, d1).tolist(),
                                                **z)
        return state

    def update(self, u, state, params, count, **extra):
        t = np.float32(count + 1)
        dr = float(np.float32(1.0) - t ** np.float32(-self.decay_rate))
        out = {}
        for k, g in u.items():
            gv = self._view(k, g)
            sq = gv * gv + self.eps
            dims = _factored_dims(tuple(gv.shape), self.min_dim)
            if dims is None:
                v = state["v"][k]
                v.copy_(dr * v + (1.0 - dr) * sq)
                upd = gv * v ** -0.5
            else:
                d1, d0 = dims
                row, col = state["v_row"][k], state["v_col"][k]
                row.copy_(dr * row + (1.0 - dr) * sq.mean(dim=d0))
                col.copy_(dr * col + (1.0 - dr) * sq.mean(dim=d1))
                rd1 = d1 - 1 if d1 > d0 else d1
                row_factor = (row / row.mean(dim=rd1, keepdim=True)) ** -0.5
                upd = gv * row_factor.unsqueeze(d0) * \
                    (col ** -0.5).unsqueeze(d1)
            out[k] = upd.reshape(g.shape)
        return out


class ClipByBlockRms(Transform):
    whole_tensor = True

    def __init__(self, threshold: float):
        self.threshold = threshold

    def update(self, u, state, params, count, **extra):
        return {k: g / torch.clamp(g.square().mean().sqrt() / self.threshold,
                                   min=1.0) for k, g in u.items()}


class ScaleByParamBlockRms(Transform):
    """u · max(rms(p), min_scale) (optax safe_root_mean_squares)."""
    whole_tensor = True

    def __init__(self, min_scale: float = 1e-3):
        self.min_scale = min_scale

    def update(self, u, state, params, count, **extra):
        return {k: g * torch.clamp(params[k].square().mean().sqrt(),
                                   min=self.min_scale)
                for k, g in u.items()}


class AddDecayedWeights(Transform):
    """u + wd·p where `mask` says (None: everywhere); wd may be a
    schedule, read at the chain's count (JAX's inject_hyperparams)."""

    def __init__(self, weight_decay: Schedule,
                 mask: Optional[Mapping[str, bool]] = None):
        self.wd, self.mask = weight_decay, mask

    def update(self, u, state, params, count, **extra):
        wd = at(self.wd, count)
        return {k: g + wd * params[k]
                if self.mask is None or self.mask[k] else g
                for k, g in u.items()}


class ScaleByLearningRate(Transform):
    """u · (−lr), or u · lr with flip_sign False; lr read at the count."""

    def __init__(self, learning_rate: Schedule, flip_sign: bool = True):
        self.lr, self.sign = learning_rate, -1.0 if flip_sign else 1.0

    def update(self, u, state, params, count, **extra):
        s = self.sign * at(self.lr, count)
        return {k: g * s for k, g in u.items()}


class Scale(Transform):
    def __init__(self, factor: float):
        self.factor = factor

    def update(self, u, state, params, count, **extra):
        return {k: g * self.factor for k, g in u.items()}


class ClipByGlobalNorm(Transform):
    """u, or u / ‖u‖ · max_norm when ‖u‖ ≥ max_norm; the norm over the
    whole of every tensor (train/fused.py::global_norm sums the shards'
    squares over the axes that cut them)."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def update(self, u, state, params, count, splits=None, **extra):
        norm = global_norm(u, splits)
        keep = norm < self.max_norm
        return {k: torch.where(keep, g, g / norm * self.max_norm)
                for k, g in u.items()}


class LayerDecay(Transform):
    """u · scale by parameter name (optim.py::scale_by_layer_decay)."""

    def __init__(self, scales: Mapping[str, float]):
        self.scales = scales

    def update(self, u, state, params, count, **extra):
        return {k: g * self.scales[k] for k, g in u.items()}


class Chain(Transform):
    """The elements in order; the state holds the chain's update count."""

    def __init__(self, *elements: Transform):
        self.elements = elements
        self.whole_tensor = any(e.whole_tensor for e in elements)

    def init(self, params):
        state = {"count": 0}
        for i, e in enumerate(self.elements):
            s = e.init(params)
            if s:
                state[str(i)] = s
        return state

    def update(self, u, state, params, count=None, **extra):
        count = state["count"]
        for i, e in enumerate(self.elements):
            u = e.update(u, state.get(str(i), {}), params, count, **extra)
        state["count"] = count + 1
        return u


class Lookahead(Transform):
    """JAX optim.py::lookahead (:158-192): every `sync_period`-th update
    the params move to slow + α·(fast − slow), which becomes the slow
    copy; the slow weights live in the state."""

    def __init__(self, inner: Transform, sync_period: int = 5,
                 slow_step_size: float = 0.5):
        self.inner, self.k, self.alpha = inner, sync_period, slow_step_size
        self.whole_tensor = inner.whole_tensor

    def init(self, params):
        return {"inner": self.inner.init(params), "count": 0,
                "slow": {k: p.detach().float().clone()
                         for k, p in params.items()}}

    def update(self, u, state, params, count=None, **extra):
        u = self.inner.update(u, state["inner"], params, **extra)
        state["count"] += 1
        if state["count"] % self.k:
            return u
        out = {}
        for k, g in u.items():
            s, p = local(state["slow"][k]), params[k]
            out[k] = s + self.alpha * (p + g - s) - p
            s.copy_(p + out[k])
        return out


class MultiSteps(Transform):
    """optax.MultiSteps (JAX optim.py:371-372): the running mean of k
    micro-steps' gradients goes to the inner chain on every k-th; the
    other micro-steps update nothing (None)."""

    def __init__(self, inner: Transform, every_k: int):
        self.inner, self.k = inner, every_k
        self.whole_tensor = inner.whole_tensor

    def init(self, params):
        return {"inner": self.inner.init(params), "acc": zeros(params),
                "mini_step": 0, "gradient_step": 0}

    def update(self, u, state, params, count=None, **extra):
        n = state["mini_step"]
        acc = {k: local(a) for k, a in state["acc"].items()}
        for k, g in u.items():
            acc[k].add_((g - acc[k]) / (n + 1))
        if n < self.k - 1:
            state["mini_step"] = n + 1
            return None
        out = self.inner.update({k: a.clone() for k, a in acc.items()},
                                state["inner"], params, **extra)
        for a in acc.values():
            a.zero_()
        state["mini_step"] = 0
        state["gradient_step"] += 1
        return out


class Optimizer:
    """A transform applied to the params in place, with the step's
    interface: `init(params)`, `fused_update(grads, state, params, ema,
    splits, **extra)` -> the global grad norm (before any clip) as a
    device scalar. The EMA is the step's (`ema_decay` None): it moves on
    every micro-step, as in the JAX step (steps.py:121-124)."""
    ema_decay = None

    def __init__(self, name: str, tx: Transform):
        self.name, self.tx = name, tx

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        self.check_unsharded(params)
        return self.tx.init(params)

    def check_unsharded(self, params: Mapping[str, torch.Tensor],
                        splits: Optional[Mapping] = None) -> None:
        """Raise when a whole-tensor update would see a shard or a part."""
        if self.tx.whole_tensor and (
                splits or any(is_sharded(p) for p in params.values())):
            raise NotImplementedError(
                f"optimizer {self.name!r} reads whole tensors (a norm or a "
                f"factored mean), which FSDP's shards and the model axis's "
                f"parts cut; on those meshes it is not in the port yet "
                f"(ROADMAP M7): train it without --param_sharding fsdp and "
                f"the model axis")

    @torch.no_grad()
    def fused_update(self, grads: Mapping[str, torch.Tensor], state: dict,
                     params: Mapping[str, torch.Tensor], ema=None,
                     splits: Optional[Mapping] = None, **extra
                     ) -> torch.Tensor:
        self.check_unsharded(params, splits)
        norm = global_norm(grads, splits)
        p32 = {k: local(p).float() for k, p in params.items()}
        extra = {k: {n: local(t).float() for n, t in v.items()}
                 for k, v in extra.items() if v is not None}
        u = self.tx.update({k: local(g).float() for k, g in grads.items()},
                           state, p32, splits=splits, **extra)
        if u is not None:
            for k, p in params.items():
                local(p).copy_(p32[k] + u[k])
        return norm
