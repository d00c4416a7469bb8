"""The port's attention route against the JAX layer's rule.

The JAX `Attention` (models/layers.py:296-297) takes a kernel only when
`use_pallas and not qk_norm and not attn_dropping and hd % 64 == 0 and
h % 2 == 0`; `use_pallas_attn` is off by default, the JAX server never sets
it and the JAX trainer sets it for `--pallas_attn on`, or `auto` off the
CPU. The port routes by the same rule (`models/layers.py::attention_route`).
Its kernels on the card are bf16 kernels, so its trainer's switch
(`launch/main.py::pallas_attn_switch`) is off there for `auto` with another
compute dtype and raises for `on`; the wrappers raise for such tensors.

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


# (--pallas_attn, device, compute dtype) -> use_pallas_attn, or None: raises
SWITCH = [
    ("on", CUDA, torch.bfloat16, True), ("auto", CUDA, torch.bfloat16, True),
    ("off", CUDA, torch.bfloat16, False), ("on", CUDA, torch.float32, None),
    ("on", CUDA, torch.float16, None), ("auto", CUDA, torch.float32, False),
    ("off", CUDA, torch.float32, False), ("on", CPU, torch.bfloat16, True),
    ("on", CPU, torch.float32, True), ("auto", CPU, torch.bfloat16, False),
    ("auto", CPU, torch.float32, False), ("off", CPU, torch.float32, False)]


@pytest.mark.parametrize("flag,device,dtype,want", SWITCH)
def test_trainer_switch_by_flag_device_and_dtype(flag, device, dtype, want):
    if want is None:
        with pytest.raises(ValueError, match="bfloat16"):
            trainer.pallas_attn_switch(flag, device, dtype)
    else:
        assert trainer.pallas_attn_switch(flag, device, dtype) is want


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
def test_fp32_on_the_card_raises_at_the_kernels(cuda_device):
    # the entry points on the kernel route take bf16 on the card: an fp32
    # tensor raises TypeError before any launch, never a silent plain route
    counts = ("ATTN_FWD_LAUNCHES", "ATTN_BWD_LAUNCHES", "HP_FWD_LAUNCHES",
              "HP_BWD_LAUNCHES", "FUSED_FWD_LAUNCHES", "FUSED_BWD_LAUNCHES",
              "QKV_FWD_LAUNCHES", "QKV_BWD_LAUNCHES")
    from vision_transformers_torch_xla_tpu_torch.ops import flash_blocked

    def launches():
        return [getattr(fa, c) for c in counts] + [
            flash_blocked.FLASH_FWD_LAUNCHES]

    before = launches()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((2, 197, 128), device=cuda_device, generator=g)
    w = torch.randn((128, 3 * 128), device=cuda_device, generator=g)
    calls = [lambda: fa.qkv_proj_attention(x, w, None, 2)]
    for s in (197, 1100):
        qkv = torch.randn((2, s, 3 * 2 * 64), device=cuda_device,
                          generator=g)
        q, k, v = flash_blocked.heads(qkv, 2)
        calls.append(lambda qkv=qkv: fa.fused_attention_qkv_cols(qkv, 2))
        if s <= fa.MAX_SEQ:
            calls += [lambda q=q, k=k, v=v: fa.fused_attention(q, k, v),
                      lambda qkv=qkv, s=s: fa.fused_attention_qkv(
                          qkv.view(2, s, 3, 2, 64))]
    for call in calls:
        with pytest.raises(TypeError, match="bfloat16"):
            call()
    torch.cuda.synchronize()
    assert launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("flag,want", [("auto", False), ("on", None)])
def test_trainer_fp32_on_the_card(cuda_device, flag, want):
    # --precision fp32 on the card: auto builds plain attention, on raises
    from vision_transformers_torch_xla_tpu_torch.core.config import (
        TrainConfig,
    )

    cfg = TrainConfig(model="my_vit_mini", input_size=32, nb_classes=10,
                      data_set="synthetic", batch_size=2, device="cuda",
                      precision="fp32", pallas_attn=flag,
                      synthetic_train_size=8, synthetic_val_size=4)
    if want is None:
        with pytest.raises(ValueError, match="bfloat16"):
            trainer.setup(cfg)
        return
    ctx = trainer.setup(cfg)
    assert not any(b.attn.use_pallas for b in ctx.model.blocks)
