"""The port's attention route against the JAX layer's rule.

The JAX `Attention` (models/layers.py:296-297) takes a kernel only when
`use_pallas and not qk_norm and not attn_dropping and hd % 64 == 0 and
h % 2 == 0`; `use_pallas_attn` is off by default, the JAX server never sets
it and the JAX trainer sets it for `--pallas_attn on`, or `auto` off the
CPU. The port routes by the same rule (`models/layers.py::attention_route`),
and its trainer's switch (`launch/main.py::pallas_attn_switch`) is JAX's for
every compute dtype: its kernels take bf16, fp16 and fp32 on the card, and
the wrappers raise for tensors of another dtype.

The layer test holds the port's `Attention` against the JAX one in bf16
where the JAX rule takes the plain route (3 heads, head dim 48), with the
port's switch on. Its projection is exact (q, k and v are permutations of
the input's columns, proj is the identity), so only the attention's cast
order can differ: both round at the same points (bf16 q, k, v; fp32 scores
and softmax; bf16(p); an fp32 p·v sum; bf16 o), and an fp32 summation
order can flip one bf16 rounding, which moves an output by at most one
ulp of |o| < 2, 2^-9. At most 1% of the outputs may differ (0.01-0.06%
on the CPU). A layer that took the kernel route where JAX's rule takes the
plain one fails both: K1's cast order (bf16(q·scale), p cast before it is
normalised) differs at 45-52% of the outputs by 2-4 ulps.
"""
import numpy as np
import pytest
import torch

from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
from vision_transformers_torch_xla_tpu_torch.models import create_model, layers
from vision_transformers_torch_xla_tpu_torch.ops import flash_attention as fa

CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return CUDA


def _exact_attention_params(dim, seed):
    """qkv kernel: three column permutations of the identity (q, k, v are
    the input's columns, exactly); proj: the identity; zero biases."""
    rng = np.random.default_rng(seed)
    eye = np.eye(dim, dtype=np.float32)
    sel = np.concatenate([eye[:, rng.permutation(dim)] for _ in range(3)], 1)
    zeros = np.zeros
    return {"qkv": {"kernel": sel, "bias": zeros(3 * dim, np.float32)},
            "proj": {"kernel": eye, "bias": zeros(dim, np.float32)}}


@pytest.mark.parametrize("dim,heads", [(144, 3), (192, 3), (96, 2)],
                         ids=["3_heads_of_48", "3_heads_of_64",
                              "2_heads_of_48"])
def test_attention_matches_jax_plain_route_bf16(dim, heads):
    import jax.numpy as jnp

    from vision_transformers_torch_xla_tpu.models.layers import (
        Attention as JaxAttention,
    )

    x = np.random.default_rng(dim).standard_normal((2, 197, dim)).astype(
        np.float32)
    params = _exact_attention_params(dim, 0)
    jax_layer = JaxAttention(num_heads=heads, dtype=jnp.bfloat16,
                             use_pallas=False)
    want = np.asarray(jax_layer.apply(
        {"params": params}, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    port = layers.Attention(dim, heads, dtype=torch.bfloat16,
                            use_pallas=True)
    port.load_state_dict({
        "qkv.weight": torch.from_numpy(params["qkv"]["kernel"].T.copy()),
        "qkv.bias": torch.from_numpy(params["qkv"]["bias"]),
        "proj.weight": torch.from_numpy(params["proj"]["kernel"].T.copy()),
        "proj.bias": torch.from_numpy(params["proj"]["bias"])}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16()).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -9
    assert (got != want).mean() <= 0.01


# (use_pallas, qk_norm, attn_dropping, heads, head_dim, S) -> JAX's route
ROUTES = [
    ((True, False, False, 12, 64, 197), "qkv_proj"),
    ((True, False, False, 12, 64, 1024), "qkv_proj"),
    ((True, False, False, 12, 64, 1025), "qkv_cols"),
    ((True, False, False, 2, 128, 1370), "qkv_cols"),
    ((False, False, False, 12, 64, 197), "plain"),
    ((False, False, False, 12, 64, 1370), "plain"),
    ((True, True, False, 12, 64, 197), "plain"),
    ((True, False, True, 12, 64, 197), "plain"),
    ((True, False, False, 3, 64, 197), "plain"),
    ((True, False, False, 3, 64, 1370), "plain"),
    ((True, False, False, 2, 48, 197), "plain"),
    ((True, False, False, 4, 72, 197), "plain"),
    ((True, False, False, 4, 60, 1370), "plain"),
]


@pytest.mark.parametrize("args,route", ROUTES)
def test_attention_route_is_jaxs_rule(args, route):
    assert layers.attention_route(*args) == route


# (--pallas_attn, device, compute dtype) -> use_pallas_attn: JAX's rule
# (launch/main.py:207-211), `on`, or `auto` off the CPU, whatever the dtype
SWITCH = [
    ("on", CUDA, torch.bfloat16, True), ("auto", CUDA, torch.bfloat16, True),
    ("off", CUDA, torch.bfloat16, False), ("on", CUDA, torch.float32, True),
    ("on", CUDA, torch.float16, True), ("auto", CUDA, torch.float32, True),
    ("off", CUDA, torch.float32, False), ("on", CPU, torch.bfloat16, True),
    ("on", CPU, torch.float32, True), ("auto", CPU, torch.bfloat16, False),
    ("auto", CPU, torch.float32, False), ("off", CPU, torch.float32, False)]


def _jax_rule(flag, device):
    """The JAX trainer's want_pallas with the backend of `device`."""
    return flag == "on" or (flag == "auto" and device.type not in ("cpu",))


@pytest.mark.parametrize("flag,device,dtype,want", SWITCH)
def test_trainer_switch_by_flag_device_and_dtype(flag, device, dtype, want):
    # the compute dtype does not enter the switch: the precision policy
    # sets the model's dtype, and the kernels take every float dtype
    assert _jax_rule(flag, device) is want
    assert trainer.pallas_attn_switch(flag, device) is want


def _recording(monkeypatch):
    """Patch the layer's two kernel entry points and the plain attention to
    record which one each forward reaches."""
    seen = []
    for name in ("qkv_proj_attention", "fused_attention_qkv_cols",
                 "reference_attention"):
        fn = getattr(layers, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            seen.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(layers, name, wrapped)
    return seen


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("heads,head_dim", [(2, 64), (3, 64), (2, 48)])
@pytest.mark.parametrize("seq", [5, 1025])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_layer_takes_jaxs_route(monkeypatch, dtype, seq, heads,
                                          head_dim, qk_norm):
    # dtype x S x hd x h x qk_norm on the CPU, switch on: the entry point
    # the layer reaches is JAX's, whatever the dtype (the plain versions
    # take any float dtype, as the JAX kernels do)
    seen = _recording(monkeypatch)
    dim = heads * head_dim
    layer = layers.Attention(dim, heads, qk_norm=qk_norm, dtype=dtype,
                             use_pallas=True)
    layers.init_weights(layer, torch.Generator().manual_seed(0))
    x = torch.randn((1, seq, dim), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = layer(x.to(dtype))
    assert out.shape == (1, seq, dim) and out.dtype == dtype
    route = layers.attention_route(True, qk_norm, False, heads, head_dim, seq)
    want = {"qkv_proj": "qkv_proj_attention",
            "qkv_cols": "fused_attention_qkv_cols",
            "plain": "reference_attention"}[route]
    assert seen == [want]


def test_the_switch_reaches_every_block_and_is_off_by_default():
    on = create_model("my_vit_mini", use_pallas_attn=True, device="meta")
    off = create_model("my_vit_mini", device="meta")
    assert all(b.attn.use_pallas for b in on.blocks)
    assert not any(b.attn.use_pallas for b in off.blocks)


def test_the_server_builds_without_the_switch():
    from vision_transformers_torch_xla_tpu_torch.launch.serve import (
        InferenceEngine,
    )

    engine = InferenceEngine("my_vit_mini", image_size=32, num_classes=10,
                             device="cpu")
    assert not any(b.attn.use_pallas for b in engine.model.blocks)


@pytest.mark.parametrize("flag,want", [("off", False), ("auto", False),
                                       ("on", True)])
def test_trainer_sets_the_switch_as_jax_does(flag, want):
    # --device cpu: 'auto' stays off on the CPU, as in the JAX trainer
    from vision_transformers_torch_xla_tpu_torch.core.config import (
        TrainConfig,
    )

    cfg = TrainConfig(model="my_vit_mini", input_size=32, nb_classes=10,
                      data_set="synthetic", batch_size=2, device="cpu",
                      pallas_attn=flag, synthetic_train_size=8,
                      synthetic_val_size=4)
    ctx = trainer.setup(cfg)
    assert [b.attn.use_pallas for b in ctx.model.blocks] == \
        [want] * len(ctx.model.blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.float16, 5e-3)])
def test_fp32_fp16_on_the_card_run_the_kernels(cuda_device, dtype, rel):
    # every entry point on the kernel route launches its kernel for fp32
    # and fp16 CUDA tensors, never a silent plain route, and matches the
    # same call on the CPU (the plain versions) to rel of the largest
    # value; float64 raises TypeError before any launch
    from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked

    counts = ("ATTN_FWD_LAUNCHES", "HP_FWD_LAUNCHES", "FUSED_FWD_LAUNCHES",
              "QKV_FWD_LAUNCHES")

    def launches():
        return [getattr(fa, c) for c in counts] + [
            flash_blocked.FLASH_FWD_LAUNCHES]

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 197, 128), generator=g)
    w = torch.randn((128, 3 * 128), generator=g) * 0.1
    calls = [(lambda t: fa.qkv_proj_attention(t[0], t[1], None, 2), (x, w))]
    for s in (197, 1100):
        qkv = torch.randn((2, s, 3 * 2 * 64), generator=g)
        calls.append((lambda t: fa.fused_attention_qkv_cols(t[0], 2),
                      (qkv,)))
        if s <= fa.MAX_SEQ:
            calls += [(lambda t: fa.fused_attention(
                           *flash_blocked.heads(t[0], 2)), (qkv,)),
                      (lambda t, s=s: fa.fused_attention_qkv(
                          t[0].view(2, s, 3, 2, 64)), (qkv,))]
    for call, args in calls:
        before = launches()
        got = call([a.to(cuda_device, dtype) for a in args])
        torch.cuda.synchronize()
        assert sum(launches()) == sum(before) + 1
        want = call([a.to(dtype) for a in args]).float()
        assert got.dtype == dtype
        err = (got.float().cpu() - want).abs().max().item()
        assert err <= rel * want.abs().max().item()
        with pytest.raises(TypeError, match="float64"):
            call([a.to(cuda_device, torch.float64) for a in args])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("flag,want", [("auto", True), ("on", True),
                                       ("off", False)])
def test_trainer_fp32_on_the_card(cuda_device, flag, want):
    # --precision fp32 on the card: the JAX rule, auto and on build the
    # kernel route
    from vision_transformers_torch_xla_tpu_torch.core.config import (
        TrainConfig,
    )

    cfg = TrainConfig(model="my_vit_mini", input_size=32, nb_classes=10,
                      data_set="synthetic", batch_size=2, device="cuda",
                      precision="fp32", pallas_attn=flag,
                      synthetic_train_size=8, synthetic_val_size=4)
    ctx = trainer.setup(cfg)
    assert [b.attn.use_pallas for b in ctx.model.blocks] == \
        [want] * len(ctx.model.blocks)


# F8: the three route functions at head dims over the tensor cores' 128, in
# each dtype, on CPU tensors. K1 and K9 (attn_kernel_route on the qkv
# buffer), K2 (attn_kernel_route with dO and O), K7 and K11
# (fused_kernel_route) and K8, K10 and K12 (bwd_kernel_route) take the wide
# tensor-core tiles up to 256 in bf16 and fp16; fp32 and every head dim
# past 256 the CUDA cores.
@pytest.mark.parametrize("d", [136, 192, 256, 320])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_wide_head_routes(dtype, d):
    b, s, h = 2, 9, 2
    qkv = torch.zeros((b, s, 3 * h * d), dtype=dtype)
    do = torch.zeros((b, s, h * d), dtype=dtype)
    tc = dtype != torch.float32 and d <= fa.MAX_WIDE_HEAD_DIM
    want = "tensor_cores" if tc else "cuda_cores"
    assert fa.attn_kernel_route(qkv, h) == want
    assert fa.attn_kernel_route(qkv, h, do, do) == want
    q, k, v = fa.heads(qkv, h)
    assert fa.fused_kernel_route(q, k, v) == want
    assert fa.bwd_kernel_route(q, k, v, fa._head_major(do, h)) == want


# A tiny ViT with 2 heads of 192 (a head dim JAX's rule sends to the
# kernels) built with use_pallas_attn=True in both packages: the JAX model
# runs qkv_proj_attention -> K1/K2 in interpret mode, the port its
# qkv_proj_attention (their plain versions on the CPU). fp32 to 1e-4
# (summation order only; tests/test_torch_vit.py's limit); bf16 logits to
# 5e-3 and gradients to 2e-2 of each parameter's largest |grad|: both share
# every rounding point, and another summation order flips a bf16 rounding
# of p, t or a stored value now and then, a few ulps of one term.
WIDE_CFG = dict(img_size=16, patch_size=4, embed_dim=384, depth=1,
                num_heads=2, num_classes=10, init_values=0.5,
                global_pool="token")
WIDE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-3, 2e-2)}


def _counting(fn, calls):
    def wrapped(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return fn(*args, **kwargs)

    return wrapped


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def wide_vit_runs(request):
    """The JAX and the port's logits and grads of sum(logits * w) for the
    wide-head ViT in one dtype, and the qkv_proj_attention calls each saw."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from jax.experimental.pallas import tpu as pltpu

    from vision_transformers_torch_xla_tpu.models.vit import (
        VisionTransformer as JaxViT,
    )
    from vision_transformers_torch_xla_tpu.ops import (
        flash_attention as jfa,
    )
    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        flax_to_state_dict,
    )
    from vision_transformers_torch_xla_tpu_torch.models.vit import (
        VisionTransformer,
    )

    dtype = request.param
    rng = np.random.default_rng(5)
    images = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    w = rng.standard_normal((2, 10)).astype(np.float32)
    model = JaxViT(**WIDE_CFG, dtype=getattr(jnp, dtype),
                   use_pallas_attn=True)
    jax_calls, port_calls = [], []
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(jfa, "qkv_proj_attention",
                   _counting(jfa.qkv_proj_attention, jax_calls))
        variables = model.init(jax.random.key(0), jnp.asarray(images))
        params = nn.meta.unbox(variables)["params"]
        del jax_calls[:]

        def loss(p):
            logits = model.apply({"params": p}, jnp.asarray(images))
            return (logits.astype(jnp.float32) * w).sum(), logits

        (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    params = jax.tree.map(np.asarray, params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "qkv_proj_attention",
                   _counting(layers.qkv_proj_attention, port_calls))
        port = VisionTransformer(**WIDE_CFG, dtype=getattr(torch, dtype),
                                 use_pallas_attn=True)
        port.load_state_dict(flax_to_state_dict(params), strict=True)
        got = port(torch.from_numpy(images))
        (got.float() * torch.from_numpy(w)).sum().backward()
    want_grads = flax_to_state_dict(jax.tree.map(
        lambda g: np.asarray(g.astype(jnp.float32)), grads))
    return dict(dtype=dtype, jax_calls=jax_calls, port_calls=port_calls,
                logits=(got.detach().float().numpy(),
                        np.asarray(logits.astype(jnp.float32))),
                grads={k: (p.grad.float().numpy(), want_grads[k].numpy())
                       for k, p in port.named_parameters()})


def test_wide_head_vit_takes_the_kernel_route(wide_vit_runs):
    seq = (WIDE_CFG["img_size"] // WIDE_CFG["patch_size"]) ** 2 + 1
    assert len(wide_vit_runs["jax_calls"]) == WIDE_CFG["depth"]
    assert wide_vit_runs["port_calls"] == \
        [(2, seq, WIDE_CFG["embed_dim"])] * WIDE_CFG["depth"]


def test_wide_head_vit_logits_match_jax(wide_vit_runs):
    got, want = wide_vit_runs["logits"]
    atol = WIDE_TOL[wide_vit_runs["dtype"]][0]
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_wide_head_vit_grads_match_jax(wide_vit_runs):
    rel = WIDE_TOL[wide_vit_runs["dtype"]][1]
    assert any("attn.qkv" in k for k in wide_vit_runs["grads"])
    for k, (got, want) in wide_vit_runs["grads"].items():
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=rel * np.abs(want).max(), err_msg=k)
