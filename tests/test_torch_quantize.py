"""one2345_tpu_torch's W8A8 int8 layers against the JAX package's
(diffusion/quantize.py; CPU, f32): activation and weight codes and scales
equal, QConv2d (3x3, 1x1, the stride-2 op) and QLinear against QConv /
QDense with the int32 accumulations equal and the outputs within 1e-6,
quantize_unet_state through the converter equal to quantize_unet_params,
a JAX int8 tree loaded with strict=True into the tiny int8 UNet and its
eval against JAX's, and save_params -> restore of an int8 pipeline."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from one2345_tpu.diffusion import quantize as jq
from one2345_tpu.diffusion.unet import UNetModel as JaxUNet
from one2345_tpu_torch.core import checkpoint
from one2345_tpu_torch.diffusion import quantize as q
from one2345_tpu_torch.diffusion.unet import UNetModel
from one2345_tpu_torch.diffusion.zero123 import make_unet
from one2345_tpu_torch.utils.convert_jax import flax_to_state_dict
from tests.torch_port_helpers import max_err, randomize, tiny_config

OUT_TOL = 1e-6  # max abs of the dequantized outputs, relative to max |ref|
# the tiny int8 UNet eval: ulp-level differences upstream can move an
# activation across a rounding tie, so a few codes may differ; the output
# moves by at most a code's share of the next layer
UNET_CODE_SHARE = 1e-3
UNET_TOL = 1e-3  # max abs over max |ref|


@pytest.fixture(autouse=True)
def _full_matmul_precision():
    with jax.default_matmul_precision("highest"):
        yield


def rel_max(a, b) -> float:
    return max_err(a, b) / float(np.abs(np.asarray(b)).max())


def test_quantize_activation_matches_jax():
    """Against the compiled JAX function, as the UNet's apply runs it
    (XLA turns its / 127 into * float32(1/127))."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 6, 6, 16))).astype(np.float32)
    xq, xs = q.quantize_activation(torch.from_numpy(x))
    ref_q, ref_s = jax.jit(jq.quantize_activation)(jnp.asarray(x))
    assert xq.dtype == torch.int8 and xs.dim() == 0
    assert np.array_equal(xq.numpy(), np.asarray(ref_q))
    assert xs.numpy().tobytes() == np.asarray(ref_s, np.float32).tobytes()
    # ties round half to even on both sides: absmax 127 -> scale 1
    ties = np.array([127.0, 2.5, -2.5, 3.5, 0.5, -0.5, 126.5], np.float32)
    assert q.quantize_activation(torch.from_numpy(ties))[0].tolist() == [127, 2, -2, 4, 0, 0, 126]
    assert np.array_equal(q.quantize_activation(torch.from_numpy(ties))[0].numpy(),
                          np.asarray(jax.jit(jq.quantize_activation)(jnp.asarray(ties))[0]))
    # bf16 input: the same codes as its f32 copy
    xb = torch.from_numpy(x).bfloat16()
    assert torch.equal(q.quantize_activation(xb)[0], q.quantize_activation(xb.float())[0])


@pytest.mark.parametrize("shape", [(3, 3, 16, 8), (1, 1, 16, 8), (24, 40)])
def test_quantize_kernel_matches_jax(shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)  # flax layout
    ref_q, ref_s = jax.jit(jq.quantize_kernel)(jnp.asarray(w))
    torch_w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
    wq, ws = q.quantize_kernel(torch.from_numpy(np.ascontiguousarray(torch_w)))
    ref_torch = np.asarray(ref_q).transpose(3, 2, 0, 1) if w.ndim == 4 else np.asarray(ref_q).T
    assert wq.dtype == torch.int8 and np.array_equal(wq.numpy(), ref_torch)
    assert ws.numpy().tobytes() == np.asarray(ref_s).tobytes()


# (kernel, stride, padding as the JAX module takes it, C_in, C_out)
CONV_CASES = {
    "3x3": (3, 1, "SAME", 640, 64),
    "1x1": (1, 1, "SAME", 640, 64),
    "down": (3, 2, ((1, 1), (1, 1)), 64, 64),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_qconv_matches_jax(case):
    k, stride, padding, cin, cout = CONV_CASES[case]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    wq, ws = jax.jit(jq.quantize_kernel)(jnp.asarray(w))
    params = {"params": {"kernel_q": wq, "kernel_scale": ws, "bias": jnp.asarray(b)}}
    qconv = jq.QConv(cout, (k, k), (stride, stride), padding, dtype=jnp.float32)
    ref = np.asarray(jax.jit(qconv.apply)(params, jnp.asarray(x)))
    xq, _ = jax.jit(jq.quantize_activation)(jnp.asarray(x))
    dn = lax.conv_dimension_numbers(x.shape, wq.shape, ("NHWC", "HWIO", "NHWC"))
    ref_acc = lax.conv_general_dilated(xq, wq, (stride, stride), padding, dimension_numbers=dn,
                                       preferred_element_type=jnp.int32)

    port = q.QConv2d(cin, cout, k, stride, 1 if k == 3 else 0)
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    acc, _ = port.accumulate(xt)
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), np.asarray(ref_acc))
    out = port(xt).permute(0, 2, 3, 1)
    assert out.dtype == torch.float32 and rel_max(out, ref) <= OUT_TOL
    port.dtype = torch.bfloat16
    assert port(xt).dtype == torch.bfloat16


def test_qconv_from_float_and_qlinear_match_jax():
    rng = np.random.default_rng(3)
    conv = torch.nn.Conv2d(16, 8, 3, padding=1)
    qc = q.QConv2d.from_float(conv)
    wq, ws = q.quantize_kernel(conv.weight.detach())
    assert torch.equal(qc.weight_q, wq) and torch.equal(qc.weight_scale, ws)
    assert torch.equal(qc.weight_mat, wq.permute(0, 2, 3, 1).reshape(8, -1))

    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    b = (0.1 * rng.standard_normal(40)).astype(np.float32)
    wq, ws = jax.jit(jq.quantize_kernel)(jnp.asarray(w))
    params = {"params": {"kernel_q": wq, "kernel_scale": ws, "bias": jnp.asarray(b)}}
    ref = jax.jit(jq.QDense(40, dtype=jnp.float32).apply)(params, jnp.asarray(x))
    lin = q.QLinear(24, 40)
    lin.load_state_dict(flax_to_state_dict(params), strict=True)
    assert rel_max(lin(torch.from_numpy(x)), ref) <= OUT_TOL
    assert q.dense(True, "to_q", 24, 40).__class__ is torch.nn.Linear  # SKIP_QUANT
    assert q.dense(True, "other", 24, 40).__class__ is q.QLinear


def test_int8_matmul_plain_version_is_exact_and_the_card_route_refuses_others():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(-127, 128, (40, 23040)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (16, 23040)).astype(np.int8))
    a[0], b[0] = 127, 127  # the largest sum: 127^2 * K
    out = q.int8_matmul(a, b)
    assert out.dtype == torch.int32 and torch.equal(out, (a.long() @ b.long().t()).int())
    assert int(out[0, 0]) == 127 * 127 * 23040
    with pytest.raises(TypeError):
        q.int8_matmul(a.float(), b)
    with pytest.raises(RuntimeError, match="CUDA or the CPU"):
        q.int8_matmul(a.to("meta"), b.to("meta"))


def _jax_unet(quant: bool):
    u = tiny_config(torch_side=False).unet
    return JaxUNet(
        in_channels=u.in_channels, out_channels=u.out_channels, model_channels=u.model_channels,
        num_res_blocks=u.num_res_blocks, attention_resolutions=tuple(u.attention_resolutions),
        channel_mult=tuple(u.channel_mult), num_heads=u.num_heads,
        transformer_depth=u.transformer_depth, context_dim=u.context_dim, dtype=jnp.float32,
        quant=quant,
    )


@pytest.fixture(scope="module")
def unet_trees():
    """The tiny UNet's randomized f32 JAX tree and its JAX int8 tree."""
    cfg = tiny_config(torch_side=False)
    L = cfg.latent_size
    shapes = jax.eval_shape(
        _jax_unet(False).init, jax.random.key(0), jnp.zeros((1, L, L, cfg.unet.in_channels)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, cfg.unet.context_dim)),
    )
    f32 = randomize(shapes, seed=11)
    return f32, jq.quantize_unet_params(f32)


def test_quantize_unet_state_matches_jax_and_loads(unet_trees):
    f32, qtree = unet_trees
    ref = flax_to_state_dict(qtree)
    out = q.quantize_unet_state(flax_to_state_dict(f32))
    assert set(out) == set(ref)
    for name, t in ref.items():
        assert out[name].dtype == t.dtype and torch.equal(out[name], t), name
    n_q = sum(k.endswith(".weight_q") for k in out)
    assert n_q > 0 and not any(k.endswith(("to_q.weight_q", "conv_in.weight_q")) for k in out)
    assert q.quantize_unet_state(out) == out  # idempotent
    unet = make_unet(tiny_config(torch_side=True).unet, quant=True)
    unet.load_state_dict(ref, strict=True)  # a JAX int8 tree loads as it is
    assert sum(isinstance(m, q.QConv2d) for m in unet.modules()) == n_q
    assert not any(isinstance(m, q.QLinear) for m in unet.modules())  # conv-only


def test_int8_unet_eval_matches_jax(unet_trees):
    """One eval of the tiny int8 UNet: the inputs of every QConv recorded on
    both sides (JAX through a method interceptor), the share of activation
    codes that differ, and the output."""
    f32, qtree = unet_trees
    cfg = tiny_config(torch_side=True)
    L = cfg.latent_size
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, L, L, cfg.unet.in_channels)).astype(np.float32)
    ts = np.array([977, 500, 21, 977], np.int32)
    ctx = rng.standard_normal((4, 1, cfg.unet.context_dim)).astype(np.float32)

    jax_inputs = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, jq.QConv) and context.method_name == "__call__":
            jax.debug.callback(lambda v: jax_inputs.append(np.asarray(v)), args[0], ordered=True)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        ref = np.asarray(jax.jit(_jax_unet(True).apply)(qtree, x, ts, ctx))

    unet = UNetModel(**_unet_kwargs(cfg), quant=True)
    unet.load_state_dict(flax_to_state_dict(qtree), strict=True)
    port_inputs = []
    for m in unet.modules():
        if isinstance(m, q.QConv2d):
            m.register_forward_pre_hook(lambda mod, args: port_inputs.append(args[0].clone()))
    with torch.inference_mode():
        out = unet(torch.from_numpy(x), torch.from_numpy(ts).long(), torch.from_numpy(ctx))

    assert len(port_inputs) == len(jax_inputs) > 0
    differ = total = 0
    for xp, xj in zip(port_inputs, jax_inputs):
        codes = q.quantize_activation(xp)[0].permute(0, 2, 3, 1).numpy()
        ref_codes = np.asarray(jax.jit(jq.quantize_activation)(jnp.asarray(xj))[0])
        differ += int((codes != ref_codes).sum())
        total += codes.size
    assert differ / total <= UNET_CODE_SHARE, (differ, total)
    assert rel_max(out, ref) <= UNET_TOL
    f32_out = _jax_unet(False).apply(f32, x, ts, ctx)
    assert rel_max(out, f32_out) > 10 * rel_max(out, ref)  # the comparison sees int8


def _unet_kwargs(cfg):
    u = cfg.unet
    return dict(
        in_channels=u.in_channels, out_channels=u.out_channels, model_channels=u.model_channels,
        num_res_blocks=u.num_res_blocks, attention_resolutions=tuple(u.attention_resolutions),
        channel_mult=tuple(u.channel_mult), num_heads=u.num_heads,
        transformer_depth=u.transformer_depth, context_dim=u.context_dim,
    )


def test_int8_pipeline_save_params_round_trip(tmp_path):
    """save_params of an int8 pipeline writes the int8 UNet state (as the
    JAX runner saves its quantized tree); a pipeline built on the restored
    tree gives the same UNet outputs, bit for bit."""
    from one2345_tpu_torch.core.config import PipelineConfig
    from one2345_tpu_torch.diffusion.zero123 import MODULES, Zero123Stage
    from one2345_tpu_torch.pipeline.runner import One2345Pipeline

    d = tiny_config(torch_side=True)
    # f32 weights with no zero-initialised output conv
    seeded = Zero123Stage(d, device="cpu")
    gen = torch.Generator().manual_seed(7)
    params = {
        name: {k: v + 0.05 * torch.randn(v.shape, generator=gen)
               for k, v in getattr(seeded, name).state_dict().items()}
        for name in MODULES
    }
    d = d.replace(unet=d.unet.replace(quant="int8"))
    pipe = One2345Pipeline(PipelineConfig(diffusion=d), params={"zero123": params}, use_sam=False,
                           device="cpu")
    assert pipe.zero123.quant  # build the stage: save_params writes the stages built
    path = str(tmp_path / "params.pt")
    pipe.save_params(path)
    tree = checkpoint.restore(path)
    assert tree["zero123"]["unet"]["in_0_0_res.in_conv.weight_q"].dtype == torch.int8
    again = One2345Pipeline(PipelineConfig(diffusion=d), params=tree, use_sam=False, device="cpu")
    L = d.latent_size
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, L, L, d.unet.in_channels)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 1, d.unet.context_dim)).astype(np.float32))
    ts = torch.tensor([900, 10])
    with torch.inference_mode():
        a = pipe.zero123.unet(x, ts, ctx)
        b = again.zero123.unet(x, ts, ctx)
    assert torch.equal(a, b) and float(a.abs().max()) > 0
