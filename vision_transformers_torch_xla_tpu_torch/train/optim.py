"""Optimizer factory.

Counterpart of vision_transformers_torch_xla_tpu/train/optim.py over timm
parameter names (`blocks.N.…`, `stages.S.blocks.B.…`) instead of flax
paths:

* `wd_mask`: weight decay applies where ndim > 1 and no
  NO_WEIGHT_DECAY_KEYWORDS fragment is in the name (:36-46);
* `vit_layer_id`, `convnext_layer_id` (JAX's 14 ConvNeXt groups) and
  `scale_by_layer_decay`: per-parameter update scales
  decay^(num_layers − 1 − layer id), the kind detected from the names
  (:49-155);
* `create_optimizer` over every name of JAX `_lookup` (:217-270), each
  with an optional `lookahead_` prefix, in `create_optimizer`'s chain
  (:310-373): [clip] -> [masked L2 for the optimizers without their own
  decay] -> the optimizer -> [layer decay], then lookahead, then
  `--update_freq`'s MultiSteps. Plain adamw with no wd schedule, layer
  decay, lookahead or accumulation takes train/fused.py::FusedAdamW, as
  JAX `maybe_fused_optimizer` (:272-300) decides; the rest run the plain
  updates of train/transforms.py, train/adamp.py and train/adahessian.py.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import torch

from vision_transformers_torch_xla_tpu_torch.models.vit import (
    NO_WEIGHT_DECAY_KEYWORDS,
)
from vision_transformers_torch_xla_tpu_torch.train import transforms as T
from vision_transformers_torch_xla_tpu_torch.train.adahessian import (
    adahessian,
)
from vision_transformers_torch_xla_tpu_torch.train.adamp import AdamP, SGDP
from vision_transformers_torch_xla_tpu_torch.train.fused import FusedAdamW

ScalarOrSchedule = Union[float, Callable[[int], float]]


def wd_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies: ndim > 1 and no skip keyword."""
    return {k: p.ndim > 1 and not any(s in k for s in NO_WEIGHT_DECAY_KEYWORDS)
            for k, p in params.items()}


def vit_layer_id(name: str, depth: int) -> int:
    """Layer id for layer decay: embeddings 0, block i -> i + 1, the rest
    depth + 1."""
    if any(k in name for k in ("patch_embed", "cls_token", "pos_embed",
                               "reg_token")):
        return 0
    m = re.match(r"blocks\.(\d+)\.", name)
    return int(m.group(1)) + 1 if m else depth + 1


#: group count of the reference's ConvNeXt assigner (JAX optim.py:69)
CONVNEXT_NUM_GROUPS = 12


def convnext_layer_id(name: str) -> int:
    """JAX `convnext_layer_id` (:72-100) over timm names: the stem 0,
    stage 0's and 1's blocks 1 and 2, stage 2's block b 3 + b // 3, stage
    3's 12; a downsample rides its stage (0, 2, 3, 12); the head and
    the rest 13."""
    if name.startswith("stem."):
        return 0
    m = re.match(r"stages\.(\d+)\.downsample\.", name)
    if m:
        return {0: 0, 1: 2, 2: 3}.get(int(m.group(1)), CONVNEXT_NUM_GROUPS)
    m = re.match(r"stages\.(\d+)\.blocks\.(\d+)\.", name)
    if m:
        stage, block = int(m.group(1)), int(m.group(2))
        if stage < 2:
            return stage + 1
        return 3 + block // 3 if stage == 2 else CONVNEXT_NUM_GROUPS
    return CONVNEXT_NUM_GROUPS + 1


def detect_layer_id_kind(params: Mapping[str, torch.Tensor]) -> str:
    """'convnext' for stage-structured names (`stages.S.…`), else 'vit'."""
    return "convnext" if any(k.startswith("stages.") for k in params) \
        else "vit"


def scale_by_layer_decay(params: Mapping[str, torch.Tensor], decay: float,
                         depth: int, kind: str = "auto") -> Dict[str, float]:
    """Per-parameter update scale decay^(num_layers − 1 − layer id): the
    ViT's num_layers = depth + 2, ConvNeXt's 14 (JAX :126-146)."""
    kind = detect_layer_id_kind(params) if kind == "auto" else kind
    if kind == "convnext":
        return {k: decay ** (CONVNEXT_NUM_GROUPS + 1 - convnext_layer_id(k))
                for k in params}
    num_layers = depth + 2
    return {k: decay ** (num_layers - 1 - vit_layer_id(k, depth))
            for k in params}


def is_second_order(opt: str) -> bool:
    """True when the optimizer needs a Hessian-diagonal estimate each step
    (JAX :204-214)."""
    return opt.lower().removeprefix("lookahead_") == "adahessian"


def _lookup(name: str) -> Callable:
    """The optimizer of JAX `_lookup` (:217-270): (lr, cfg, mask) ->
    transform."""
    def betas(cfg):
        return cfg.get("betas", (0.9, 0.999))

    def lr_after(make):
        """make(cfg) -> the elements before the learning rate"""
        return lambda lr, cfg, mask: T.Chain(*make(cfg),
                                             T.ScaleByLearningRate(lr))

    def adam_decayed(nesterov):
        return lambda lr, cfg, mask: T.Chain(
            T.ScaleByAdam(*betas(cfg), cfg["eps"], nesterov=nesterov),
            T.AddDecayedWeights(cfg["weight_decay"], mask),
            T.ScaleByLearningRate(lr))

    def rmsprop(initial_scale):
        return lambda lr, cfg, mask: T.Chain(
            T.ScaleByRms(0.9, cfg["eps"], initial_scale),
            T.ScaleByLearningRate(lr), T.Trace(cfg["momentum"]))

    table = {
        "sgd": lambda lr, cfg, mask: T.Chain(
            T.Trace(cfg["momentum"], nesterov=True), T.ScaleByLearningRate(lr)),
        "nesterov": lambda lr, cfg, mask: T.Chain(
            T.Trace(cfg["momentum"], nesterov=True), T.ScaleByLearningRate(lr)),
        "momentum": lambda lr, cfg, mask: T.Chain(
            T.Trace(cfg["momentum"]), T.ScaleByLearningRate(lr)),
        "adam": lr_after(lambda cfg: (
            T.ScaleByAdam(*betas(cfg), cfg["eps"]),)),
        "adamw": adam_decayed(False),
        # optax.nadam / nadamw / radam with JAX's arguments: their betas
        # stay optax's defaults
        "nadam": lr_after(lambda cfg: (
            T.ScaleByAdam(eps=cfg["eps"], nesterov=True),)),
        "nadamw": lambda lr, cfg, mask: T.Chain(
            T.ScaleByAdam(eps=cfg["eps"], nesterov=True),
            T.AddDecayedWeights(cfg["weight_decay"], mask),
            T.ScaleByLearningRate(lr)),
        "radam": lr_after(lambda cfg: (T.ScaleByRadam(eps=cfg["eps"]),)),
        "adadelta": lr_after(lambda cfg: (T.ScaleByAdadelta(),)),
        "adagrad": lr_after(lambda cfg: (T.ScaleByRss(),)),
        "adamax": lr_after(lambda cfg: (
            T.ScaleByAdamax(eps=cfg["eps"]),)),
        "adafactor": lambda lr, cfg, mask: T.Chain(
            T.ScaleByFactoredRms(dense_views=cfg["dense_views"]),
            T.ClipByBlockRms(1.0), T.ScaleByLearningRate(lr, flip_sign=False),
            T.ScaleByParamBlockRms(), T.Scale(-1.0)),
        "rmsprop": rmsprop(0.0),
        "rmsproptf": rmsprop(1.0),
        "novograd": lr_after(lambda cfg: (T.ScaleByNovograd(
            0.95, 0.98, cfg["eps"], cfg["weight_decay"]),)),
        "lamb": lambda lr, cfg, mask: T.Chain(
            T.ScaleByAdam(eps=cfg["eps"]),
            T.AddDecayedWeights(cfg["weight_decay"], mask),
            T.ScaleByTrustRatio(), T.ScaleByLearningRate(lr)),
        # optax.lars: decay and trust ratio on every param (its masks True)
        "lars": lambda lr, cfg, mask: T.Chain(
            T.AddDecayedWeights(cfg["weight_decay"]),
            T.ScaleByTrustRatio(0.001), T.ScaleByLearningRate(lr),
            T.Trace(0.9)),
        "lion": lambda lr, cfg, mask: T.Chain(
            T.ScaleByLion(), T.AddDecayedWeights(cfg["weight_decay"], mask),
            T.ScaleByLearningRate(lr)),
        "adamp": lambda lr, cfg, mask: AdamP(
            lr, *betas(cfg), eps=cfg["eps"], weight_decay=cfg["weight_decay"],
            mask=mask),
        "sgdp": lambda lr, cfg, mask: SGDP(
            lr, momentum=cfg["momentum"], weight_decay=cfg["weight_decay"],
            mask=mask),
        "adahessian": lambda lr, cfg, mask: adahessian(
            lr, *betas(cfg), eps=cfg["eps"], weight_decay=cfg["weight_decay"],
            mask=mask),
    }
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unsupported optimizer {name!r}; supported: "
                         f"{sorted(table)}") from None


#: the optimizers with their own (decoupled) weight decay; the rest get a
#: masked L2 term chained before them (JAX :342-346)
DECOUPLED = ("adamw", "nadamw", "novograd", "lamb", "lars", "lion", "adamp",
             "sgdp", "adahessian")


def maybe_fused_optimizer(
    opt: str,
    learning_rate: ScalarOrSchedule,
    params: Mapping[str, torch.Tensor],
    weight_decay: float = 0.0,
    weight_decay_schedule: Optional[Callable] = None,
    opt_eps: float = 1e-8,
    opt_betas: Optional[tuple] = None,
    clip_grad: Optional[float] = None,
    layer_decay: float = 1.0,
    update_freq: int = 1,
    ema_decay: Optional[float] = None,
) -> Optional[FusedAdamW]:
    """The one-pass AdamW(+EMA) when the recipe is plain adamw (no wd
    schedule, no layer decay, no accumulation), else None."""
    if opt.lower().removeprefix("fused") != "adamw" or \
            weight_decay_schedule is not None or layer_decay < 1.0 or \
            update_freq > 1:
        return None
    b1, b2 = opt_betas if opt_betas is not None else (0.9, 0.999)
    return FusedAdamW(learning_rate, weight_decay=weight_decay, b1=b1, b2=b2,
                      eps=opt_eps, ema_decay=ema_decay, clip_grad=clip_grad,
                      mask=wd_mask(params))


def create_optimizer(
    opt: str,
    learning_rate: ScalarOrSchedule,
    params: Mapping[str, torch.Tensor],
    weight_decay: float = 0.0,
    weight_decay_schedule: Optional[Callable] = None,
    opt_eps: float = 1e-8,
    opt_betas: Optional[tuple] = None,
    momentum: float = 0.9,
    clip_grad: Optional[float] = None,
    layer_decay: float = 1.0,
    model_depth: int = 12,
    update_freq: int = 1,
    ema_decay: Optional[float] = None,
    dense_views: Sequence[str] = (),
) -> Union[FusedAdamW, T.Optimizer]:
    """The optimizer of `opt` (`lookahead_` and `fused` prefixes as in
    JAX). FusedAdamW carries the EMA when `ema_decay` is given (the JAX
    step applies it after the update, steps.py:126-129); the other route
    leaves it to the step, on every micro-step. `dense_views` names the
    conv-shaped weights that the JAX model holds as dense kernels (the
    patch stems; adafactor factors them as that matrix)."""
    if not opt.lower().startswith("lookahead_"):
        fused = maybe_fused_optimizer(
            opt, learning_rate, params, weight_decay, weight_decay_schedule,
            opt_eps, opt_betas,
            clip_grad if clip_grad is not None and clip_grad > 0 else None,
            layer_decay, update_freq, ema_decay)
        if fused is not None:
            return fused
    name = opt.lower()
    use_lookahead = name.startswith("lookahead_")
    name = name.removeprefix("lookahead_").removeprefix("fused")
    mask = wd_mask(params)
    cfg = {"eps": opt_eps, "momentum": momentum, "weight_decay": weight_decay,
           "dense_views": tuple(dense_views)}
    if opt_betas is not None:
        cfg["betas"] = tuple(opt_betas)
    l2 = None
    if name in DECOUPLED:
        if weight_decay_schedule is not None:
            cfg["weight_decay"] = weight_decay_schedule
    else:
        cfg["weight_decay"] = 0.0
        if weight_decay_schedule is not None or weight_decay > 0:
            l2 = T.AddDecayedWeights(weight_decay_schedule or weight_decay,
                                     mask)
    tx = _lookup(name)(learning_rate, cfg, mask)
    chain = []
    if clip_grad is not None and clip_grad > 0:
        chain.append(T.ClipByGlobalNorm(clip_grad))
    if l2 is not None:
        chain.append(l2)
    chain.append(tx)
    if layer_decay < 1.0:
        chain.append(T.LayerDecay(scale_by_layer_decay(params, layer_decay,
                                                       model_depth)))
    tx = T.Chain(*chain)
    if use_lookahead:
        tx = T.Lookahead(tx, sync_period=5, slow_step_size=0.5)
    if update_freq > 1:
        tx = T.MultiSteps(tx, update_freq)
    return T.Optimizer(opt, tx)
