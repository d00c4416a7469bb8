"""The port's fused-backward MLP against the JAX package's, on the CPU.

ops/mlp_fused.py's plain fc2 backward (what `fc2_bwd` runs on the CPU)
against JAX `_fc2_bwd_call` in interpret mode, as tests/test_mlp_fused.py
runs it; `mlp_gelu`'s value and all five cotangents against JAX
`mlp_gelu`; the routing of models/layers.py::Mlp; and a tiny ViT with
use_pallas_mlp=True (widths 128 and 512, so every MLP takes the fused
route) against the JAX ViT with the same flag: logits and grads. Inputs
come from a numpy seed. The `cuda` cases hold the kernel (K3) against its
plain version on the card and skip without one. The JAX package is
imported inside the JAX helpers, so that the `cuda` cases also run where
flax is missing.

Tolerances, relative to the largest |value| of the JAX side:
* fp32: 1e-4. The math is the same; only the fp32 summation order of the
  products and the tanh implementation differ.
* bf16 inputs, dh and a: 1e-2. Both compute in fp32 from the same bf16
  values and round once, so a flipped rounding moves a value by one bf16
  ulp (2^-8 of it). db1 stays 1e-4: it sums the fp32 dh, before rounding.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
    flax_to_state_dict,
)
from vision_transformers_torch_xla_tpu_torch.models import layers
from vision_transformers_torch_xla_tpu_torch.models.vit import (
    VisionTransformer,
)
from vision_transformers_torch_xla_tpu_torch.ops import mlp_fused as mf

FP32_RTOL = 1e-4
BF16_RTOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, rtol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=name)


def _jax_fc2_bwd(dy, w2, h, bf16):
    """JAX `_fc2_bwd_call` in interpret mode; w2 in the port's (O, K)
    layout, transposed to the JAX (K, O) one. db1 summed over its rows."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.mlp_fused import _fc2_bwd_call

    dt = jnp.bfloat16 if bf16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        dh, a, db1 = _fc2_bwd_call(jnp.asarray(dy, dt),
                                   jnp.asarray(w2.T, dt), jnp.asarray(h, dt))
    return (np.asarray(dh.astype(jnp.float32)),
            np.asarray(a.astype(jnp.float32)),
            np.asarray(db1).sum(axis=(0, 1)))


@pytest.mark.parametrize("b,s", [(2, 197), (3, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fc2_bwd_reference_matches_jax(dtype, b, s):
    o, k = 128, 256
    bf16 = dtype == "bfloat16"
    dt = getattr(torch, dtype)
    # the bf16 case feeds both sides the same bf16 values
    dy, w2, h = (torch.from_numpy(x).to(dt) for x in (
        _rand((b, s, o), s), _rand((o, k), s + 1, 0.2),
        _rand((b, s, k), s + 2, 2.0)))
    want = _jax_fc2_bwd(*(x.float().numpy() for x in (dy, w2, h)), bf16)
    before = mf.FC2_BWD_LAUNCHES
    dh, a, db1 = mf.fc2_bwd(dy, w2, h)
    assert mf.FC2_BWD_LAUNCHES == before  # the plain version launches nothing
    assert dh.dtype == a.dtype == dt and db1.dtype == torch.float32
    assert dh.shape == a.shape == (b, s, k) and db1.shape == (k,)
    rtol = BF16_RTOL if bf16 else FP32_RTOL
    _close(dh.float(), want[0], rtol, "dh")
    _close(a.float(), want[1], rtol, "a")
    _close(db1, want[2], FP32_RTOL, "db1")


def _mlp_inputs(bias, seed=7, b=2, s=197, d=128, hidden=256):
    x = _rand((b, s, d), seed)
    w1 = _rand((d, hidden), seed + 1, 0.1)
    w2 = _rand((hidden, d), seed + 2, 0.1)
    b1 = _rand((hidden,), seed + 3, 0.05) if bias else None
    b2 = _rand((d,), seed + 4, 0.05) if bias else None
    return [x, w1, b1, w2, b2], _rand((b, s, d), seed + 5)


@pytest.mark.parametrize("bias", [True, False])
def test_mlp_gelu_value_and_grads_match_jax_fp32(bias):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.ops.mlp_fused import (
        mlp_gelu as jax_mlp_gelu,
    )

    args, cot = _mlp_inputs(bias)
    live = [i for i, a in enumerate(args) if a is not None]

    def jax_loss(*vals):
        full = list(args)
        for i, v in zip(live, vals):
            full[i] = v
        y = jax_mlp_gelu(*full)
        return jnp.sum(y * cot), y

    with pltpu.force_tpu_interpret_mode():
        (_, want_y), want_g = jax.value_and_grad(
            jax_loss, argnums=tuple(range(len(live))), has_aux=True)(
                *(jnp.asarray(args[i]) for i in live))

    t = [torch.from_numpy(a).requires_grad_() if a is not None else None
         for a in args]
    y = mf.mlp_gelu(*t)
    assert type(y.grad_fn).__name__ == "MlpGeluBackward"
    (y * torch.from_numpy(cot)).sum().backward()
    _close(y.detach(), want_y, FP32_RTOL, "y")
    for i, g in zip(live, want_g):
        _close(t[i].grad, g, FP32_RTOL, ["x", "w1", "b1", "w2", "b2"][i])


def test_mlp_gelu_refuses_what_the_jax_function_refuses():
    args, _ = _mlp_inputs(True, s=5)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="both present or both absent"):
        mf.mlp_gelu(t[0], t[1], t[2], t[3], None)
    with pytest.raises(ValueError, match="multiples of 128"):
        mf.mlp_gelu(t[0], t[1][:, :200], t[2][:200], t[3][:200], t[4])


@pytest.mark.parametrize("act,hidden,drop,fused", [
    ("gelu_tanh", 256, 0.0, True), ("gelu", 256, 0.0, False),
    ("gelu_tanh", 200, 0.0, False), ("gelu_tanh", 256, 0.1, False)])
def test_mlp_routes_by_the_jax_rule(act, hidden, drop, fused):
    mlp = layers.Mlp(128, hidden, 128, act=act, drop=drop,
                     dtype=torch.float32, use_pallas=True)
    plain = layers.Mlp(128, hidden, 128, act=act, drop=drop,
                       dtype=torch.float32)
    layers.init_weights(mlp, torch.Generator().manual_seed(0))
    assert list(mlp.state_dict()) == list(plain.state_dict())
    plain.load_state_dict(mlp.state_dict(), strict=True)
    x = torch.from_numpy(_rand((2, 9, 128), 3))
    y = mlp(x.requires_grad_())
    assert (type(y.grad_fn).__name__ == "MlpGeluBackward") == fused
    torch.testing.assert_close(y, plain(x), rtol=0, atol=1e-6)
    # 2-D input: the rule asks for (B, S, D)
    y2 = mlp(x[0])
    assert type(y2.grad_fn).__name__ != "MlpGeluBackward"


@pytest.mark.parametrize("kw", [dict(glu=True), dict(use_norm=True)],
                         ids=["glu", "use_norm"])
def test_glu_and_the_mlp_norm_leave_the_fused_route(kw):
    # JAX's rule (layers.py:199-203): `not glu and not use_norm`, whatever
    # the other terms say
    mlp = layers.Mlp(128, 512, 128, act="gelu_tanh", dtype=torch.float32,
                     use_pallas=True, **kw)
    layers.init_weights(mlp, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_rand((2, 9, 128), 3)).requires_grad_()
    assert not mlp._fused(x)
    assert type(mlp(x).grad_fn).__name__ != "MlpGeluBackward"


# a tiny ViT whose every MLP takes the fused route: widths 128 and 512
CFG = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
           num_classes=10, act_layer="gelu_tanh", global_pool="avg")


def _counting(fn, calls):
    def wrapped(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return fn(*args, **kwargs)

    return wrapped


@pytest.fixture(scope="module")
def jax_vit():
    """The JAX ViT with use_pallas_mlp=True: params, logits and grads of
    sum(logits * w), and the inputs its mlp_gelu saw."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.models.vit import (
        VisionTransformer as JaxViT,
    )
    from vision_transformers_torch_xla_tpu.ops import mlp_fused as jmf

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((2, 10)).astype(np.float32)
    model = JaxViT(**CFG, dtype=jnp.float32, use_pallas_mlp=True)
    calls = []
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(jmf, "mlp_gelu", _counting(jmf.mlp_gelu, calls))
        variables = model.init(jax.random.key(0), jnp.asarray(images))
        params = nn.meta.unbox(variables)["params"]
        del calls[:]

        def loss(p):
            logits = model.apply({"params": p}, jnp.asarray(images))
            return (logits * w).sum(), logits

        (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return dict(params=jax.tree.map(np.asarray, params), images=images, w=w,
                logits=np.asarray(logits), calls=list(calls),
                grads=flax_to_state_dict(jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module")
def port_vit(jax_vit):
    calls, bwd_calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "mlp_gelu", _counting(layers.mlp_gelu, calls))
        mp.setattr(mf, "fc2_bwd", _counting(mf.fc2_bwd, bwd_calls))
        model = VisionTransformer(**CFG, use_pallas_mlp=True,
                                  dtype=torch.float32)
        model.load_state_dict(flax_to_state_dict(jax_vit["params"]),
                              strict=True)
        logits = model(torch.from_numpy(jax_vit["images"]))
        (logits * torch.from_numpy(jax_vit["w"])).sum().backward()
    return dict(logits=logits.detach().numpy(), calls=calls,
                bwd_calls=bwd_calls,
                grads={k: p.grad.numpy() for k, p in model.named_parameters()})


def test_both_vits_took_the_fused_route(jax_vit, port_vit):
    # 16 patches + the class token, one call per block
    assert jax_vit["calls"] == [(2, 17, 128)] * CFG["depth"]
    assert port_vit["calls"] == [(2, 17, 128)] * CFG["depth"]
    assert port_vit["bwd_calls"] == [(2, 17, 128)] * CFG["depth"]


def test_vit_logits_match_jax_fp32(jax_vit, port_vit):
    assert port_vit["logits"].shape == (2, 10)
    _close(port_vit["logits"], jax_vit["logits"], FP32_RTOL)


@pytest.mark.parametrize("part", ["mlp.fc1", "mlp.fc2", "attn", "norm",
                                  "patch_embed", "pos_embed"])
def test_vit_grads_match_jax_fp32(jax_vit, port_vit, part):
    names = [k for k in jax_vit["grads"] if part in k]
    assert names and set(jax_vit["grads"]) == set(port_vit["grads"])
    for k in names:
        _close(port_vit["grads"][k], jax_vit["grads"][k].numpy(), FP32_RTOL,
               k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("b,s,o,k", [(128, 197, 768, 3072),
                                     (64, 197, 768, 3072),
                                     (3, 77, 768, 3072), (3, 130, 128, 256),
                                     (1, 5, 256, 128)])
def test_fc2_bwd_kernel_matches_plain(cuda_device, b, s, o, k, dtype):
    # the tensor-core K3 (TMA, wgmma) on the same 16-bit inputs and cast
    # order; dh and a move by a flipped rounding (fp32 summation order of
    # da), db1 by fp32 summation order; two runs are bitwise equal
    dy, w2, h = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
                 for x in (_rand((b, s, o), 1), _rand((o, k), 2, 0.05),
                           _rand((b, s, k), 3, 2.0)))
    before = mf.FC2_BWD_LAUNCHES
    got = mf.fc2_bwd(dy, w2, h)
    again = mf.fc2_bwd(dy, w2, h)
    torch.cuda.synchronize()
    assert mf.FC2_BWD_LAUNCHES == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = mf.fc2_bwd_reference(dy, w2, h)
    for name, g, r, rtol in zip(("dh", "a", "db1"), got, want,
                                (2e-2, 2e-2, 1e-3)):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        err = (g.float() - r.float()).abs().max().item()
        assert err <= rtol * r.float().abs().max().item(), (name, err)


@pytest.mark.cuda
def test_fc2_bwd_contract_on_cuda(cuda_device):
    x = torch.zeros((2, 5, 128), device=cuda_device)
    w = torch.zeros((128, 256), device=cuda_device)
    h = torch.zeros((2, 5, 256), device=cuda_device)
    with pytest.raises(TypeError, match="float64"):
        mf.fc2_bwd(x.double(), w.double(), h.double())
    # fp32 is a kernel dtype: the CUDA-core K3 launches and matches its
    # plain version (summation order only)
    dy, w2, hid = (torch.from_numpy(a).to(cuda_device)
                   for a in (_rand((3, 77, 128), 4), _rand((128, 256), 5, 0.05),
                             _rand((3, 77, 256), 6, 2.0)))
    before = mf.FC2_BWD_LAUNCHES
    got = mf.fc2_bwd(dy, w2, hid)
    torch.cuda.synchronize()
    assert mf.FC2_BWD_LAUNCHES == before + 1
    for name, g, r in zip(("dh", "a", "db1"), got,
                          mf.fc2_bwd_reference(dy, w2, hid)):
        assert g.dtype == r.dtype == torch.float32, name
        err = (g - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item(), (name, err)
    xb, wb = x.bfloat16(), w.bfloat16()
    with pytest.raises(ValueError, match="multiples of 128"):
        mf.fc2_bwd(xb, wb[:, :200].contiguous(),
                   h.bfloat16()[..., :200].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        mf.fc2_bwd(xb, wb, h.bfloat16().transpose(0, 1).contiguous()
                   .transpose(0, 1))
    # the bf16/fp16 kernel's tensor maps read 16-byte-aligned data
    odd = torch.zeros(2 * 5 * 256 + 1, device=cuda_device,
                      dtype=torch.bfloat16)[1:].view(2, 5, 256)
    with pytest.raises(ValueError, match="aligned"):
        mf.fc2_bwd(xb, wb, odd)


# ---- the fp32 K3 at ragged row counts: M = B·S against its 128-row
# tiles (one row, one short of a tile, one past it, a few images)
FP32_EDGE_ROWS = [(1, 1), (1, 127), (1, 129), (3, 77)]
K3_FP32_EDGE_REL = 1e-5  # of the largest magnitude: fp32 summation order


def _fp32_inputs(b, s, o, k, seed):
    return (_rand((b, s, o), seed), _rand((o, k), seed + 1, 0.05),
            _rand((b, s, k), seed + 2, 2.0))


@pytest.mark.parametrize("b,s", FP32_EDGE_ROWS)
def test_fp32_fc2_bwd_reference_matches_jax_at_ragged_rows(b, s):
    dy, w2, h = _fp32_inputs(b, s, 128, 256, seed=b * 1000 + s)
    want = _jax_fc2_bwd(dy, w2, h, False)
    got = mf.fc2_bwd(*(torch.from_numpy(x) for x in (dy, w2, h)))
    for name, g, w in zip(("dh", "a", "db1"), got, want):
        assert g.dtype == torch.float32, name
        _close(g.numpy(), w, FP32_RTOL, name)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,o,k", [(b, s, 128, 256)
                                     for b, s in FP32_EDGE_ROWS]
                         + [(1, 129, 768, 3072), (128, 197, 768, 3072)])
@pytest.mark.parametrize("aligned", [True, False])
def test_fp32_fc2_bwd_kernel_matches_plain_at_edges(cuda_device, b, s, o, k,
                                                    aligned):
    # the register-tiled fp32 K3 against its plain version, twice and
    # bitwise equal; tensors that are not 16-byte aligned take its 4-byte
    # accesses
    def place(x):
        t = torch.from_numpy(x).to(cuda_device)
        if aligned:
            return t
        buf = torch.empty(t.numel() + 1, device=cuda_device)[1:]
        return buf.copy_(t.flatten()).view(t.shape)

    dy, w2, h = (place(x) for x in _fp32_inputs(b, s, o, k, seed=s))
    assert aligned == all(t.data_ptr() % 16 == 0 for t in (dy, w2, h))
    before = mf.FC2_BWD_LAUNCHES
    got = mf.fc2_bwd(dy, w2, h)
    again = mf.fc2_bwd(dy, w2, h)
    torch.cuda.synchronize()
    assert mf.FC2_BWD_LAUNCHES == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for name, g, r in zip(("dh", "a", "db1"), got,
                          mf.fc2_bwd_reference(dy, w2, h)):
        assert g.shape == r.shape and g.dtype == r.dtype == torch.float32
        err = (g - r).abs().max().item()
        assert err <= K3_FP32_EDGE_REL * r.abs().max().item(), (name, err)


# in a fresh process: in a long one (the whole cuda suite) torch.profiler's
# sessions stop recording kernels
_K3_TRACE = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from vision_transformers_torch_xla_tpu_torch.ops import mlp_fused as mf
dy, w2, h = (torch.randn(shape, device="cuda")
             for shape in ((3, 77, 768), (768, 3072), (3, 77, 3072)))
mf.fc2_bwd(dy, w2, h)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    mf.fc2_bwd(dy, w2, h)
    torch.cuda.synchronize()
print(json.dumps(sorted(e.key for e in prof.key_averages()
                        if e.device_type.name == "CUDA"
                        and "anonymous namespace" in e.key)))
"""


@pytest.mark.cuda
def test_fp32_fc2_bwd_launches_the_register_tiled_kernel_alone(cuda_device):
    res = subprocess.run([sys.executable, "-c", _K3_TRACE],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr[-3000:]
    ours = json.loads(res.stdout.splitlines()[-1])
    assert len(ours) == 1 and "::fc2_bwd_simt_kernel(" in ours[0], ours
