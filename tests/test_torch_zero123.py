"""one2345_tpu_torch's schedule, DDIM loop and Zero123 stages against the
JAX package (tiny config, f32, CPU), with the JAX noise injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.diffusion import ddim as jax_ddim
from one2345_tpu.diffusion import schedule as jax_schedule
from one2345_tpu.diffusion import zero123 as jax_z
from one2345_tpu_torch.diffusion import ddim, schedule
from one2345_tpu_torch.diffusion import zero123 as port_z
from one2345_tpu_torch.utils.convert_jax import zero123_from_jax
from tests.torch_port_helpers import max_err, randomize, tiny_config


@pytest.fixture(autouse=True)
def _full_matmul_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("steps,eta", [(75, 1.0), (50, 1.0), (3, 1.0), (25, 0.0)])
def test_schedule_is_bit_identical(steps, eta):
    ref = jax_schedule.make_ddim_schedule(steps, 1000, eta)
    out = schedule.make_ddim_schedule(steps, 1000, eta)
    for a, b in zip(out.arrays, ref.arrays):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    trimmed, ref_trimmed = ddim.trim_for_sample(out), jax_ddim.trim_for_sample(ref)
    assert trimmed.trimmed and trimmed.num_steps == ref_trimmed.num_steps
    for a, b in zip(trimmed.arrays, ref_trimmed.arrays):
        assert np.array_equal(a, b)
    assert np.array_equal(
        schedule.make_beta_schedule(), jax_schedule.make_beta_schedule()
    )


def test_executed_step_counts():
    """75 and 50 DDIM steps run as 76 and 49 UNet steps."""
    assert ddim.trim_for_sample(schedule.make_ddim_schedule(75)).num_steps == 76
    assert ddim.trim_for_sample(schedule.make_ddim_schedule(50)).num_steps == 49


@pytest.mark.parametrize("with_noise", [True, False])
def test_ddim_loop_matches_jax(with_noise):
    sched = jax_ddim.trim_for_sample(jax_schedule.make_ddim_schedule(10))
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    table = rng.standard_normal((sched.num_steps + 1, 2, 4, 4, 3)).astype(np.float32)

    def jax_eps(x, t):
        return 0.3 * x + jnp.sin(t / 100.0)

    def port_eps(x, t):
        return 0.3 * x + float(np.sin(np.float32(t) / np.float32(100.0)))

    jt = jnp.asarray(table)
    ref = jax_ddim.ddim_sample(
        jax_eps, jnp.asarray(x0), sched, (lambda d, s: jt[d]) if with_noise else None
    )
    out = ddim.ddim_sample(
        port_eps, torch.from_numpy(x0), sched,
        (lambda d, s: torch.from_numpy(table[d])) if with_noise else None,
    )
    assert max_err(out, ref) < 1e-4


def test_view_tables_and_pose_tokens():
    assert port_z.STAGE1_DELTA_X == jax_z.STAGE1_DELTA_X
    assert port_z.STAGE1_DELTA_Y == jax_z.STAGE1_DELTA_Y
    assert port_z.STAGE2_DELTA_X == jax_z.STAGE2_DELTA_X
    assert port_z.STAGE2_DELTA_Y == jax_z.STAGE2_DELTA_Y
    dx, dy = jax_z.STAGE1_DELTA_X, jax_z.STAGE1_DELTA_Y
    assert np.array_equal(port_z.pose_tokens(dx, dy), jax_z.pose_tokens(dx, dy))


def test_cc_projection_identity_init():
    x = torch.randn(2, 1, 772)
    out = port_z.CCProjection()(x)
    assert torch.equal(out, x[..., :768])


@pytest.fixture(scope="module")
def stages():
    jst = jax_z.Zero123Stage(tiny_config(torch_side=False), seed=0)
    jst.params = randomize(jst.params, seed=31)
    pst = port_z.Zero123Stage(
        tiny_config(torch_side=True), params=zero123_from_jax(jst.params), device="cpu"
    )
    return jst, pst


def _jax_noise(jst, key):
    def noise_fn(draw, view_ids, shape):
        return np.array(jst._per_view_noise(key, jnp.asarray(view_ids, jnp.uint32), draw, shape))

    return noise_fn


def _input_image():
    img = np.ones((32, 32, 3), np.float32)  # white background
    yy, xx = np.mgrid[:32, :32]
    blob = (yy - 15.5) ** 2 + (xx - 15.5) ** 2 < 100
    img[blob] = np.random.default_rng(4).uniform(0.1, 0.9, size=(int(blob.sum()), 3))
    return img


def test_encode_conditioning_matches_jax(stages):
    jst, pst = stages
    cond = _input_image()[None].repeat(2, 0) * 2.0 - 1.0
    T = jax_z.pose_tokens([0.0, 30.0], [0.0, 120.0])
    ctx_ref, concat_ref = jst.encode_conditioning(jst.params, jnp.asarray(cond), jnp.asarray(T))
    ctx, concat = pst.encode_conditioning(torch.from_numpy(cond), torch.from_numpy(T))
    assert max_err(ctx, ctx_ref) < 1e-4
    assert max_err(concat, concat_ref) < 1e-4


def test_stage1_and_stage2_match_jax(stages):
    jst, pst = stages
    img = _input_image()
    k1, k2 = jax.random.key(1), jax.random.key(2)
    ref1 = np.asarray(jst.stage1(img, k1, indices=[0, 5], steps=3))
    out1 = pst.stage1(img, seed=0, indices=[0, 5], steps=3, noise_fn=_jax_noise(jst, k1))
    assert out1.shape == (2, 32, 32, 3)
    inside = float(np.mean((ref1 > 0.01) & (ref1 < 0.99)))
    assert inside > 0.2, inside  # not saturated: the comparison has teeth
    assert max_err(out1, ref1) < 2e-3

    parent = ref1[1:].copy()
    ref2 = np.asarray(jst.stage2(parent, k2, steps=2, view_ids=[5]))
    out2 = pst.stage2(parent, seed=0, steps=2, view_ids=[5], noise_fn=_jax_noise(jst, k2))
    assert out2.shape == (1, 4, 32, 32, 3)
    assert max_err(out2, ref2) < 2e-3


def test_noise_is_keyed_by_view_id_not_batch_position(stages):
    _, pst = stages
    a = pst.per_view_noise(3, 1, [4, 5, 6], (4, 4, 4))
    b = pst.per_view_noise(3, 1, [6, 4], (4, 4, 4))
    assert torch.equal(a[2], b[0]) and torch.equal(a[0], b[1])
    assert not torch.equal(a[0], pst.per_view_noise(3, 2, [4], (4, 4, 4))[0])
    assert not torch.equal(a[0], pst.per_view_noise(4, 1, [4], (4, 4, 4))[0])


def _cond_batch():
    img = _input_image()
    return np.stack([img, img[::-1]]) * 2.0 - 1.0, [0.0, 30.0], [0.0, 120.0]


def _draw0(jst, key, ids):
    """The JAX stage's draw-0 noise of views ``ids`` (plms and dpmpp take
    no other draw)."""
    def noise_fn(draw, view_ids, shape):
        assert draw == 0
        return np.array(jst._per_view_noise(key, jnp.asarray(ids, jnp.uint32), draw, shape))

    return noise_fn


MULTISTEP_TOL = 1e-4  # max abs of the [0, 1] images, f32


@pytest.mark.parametrize("sampler", ["plms", "dpmpp"])
def test_multistep_samplers_match_jax(stages, sampler):
    """sample_views with the untrimmed eta=0 schedule of 4 steps (plms: 5
    UNet evals, dpmpp: 4), with the JAX draw-0 noise."""
    jst, pst = stages
    cond, dx, dy = _cond_batch()
    key = jax.random.key(5)
    ref = np.asarray(jst.sample_views(jnp.asarray(cond), dx, dy, key, steps=4, sampler=sampler))
    evals = []
    unet = pst.unet
    hook = unet.register_forward_hook(lambda m, a, o: evals.append(int(a[1][0])))
    try:
        out = pst.sample_views(torch.from_numpy(cond), dx, dy, seed=0, steps=4, sampler=sampler,
                               noise_fn=_draw0(jst, key, [0, 1]))
    finally:
        hook.remove()
    assert float(np.mean((ref > 0.01) & (ref < 0.99))) > 0.2  # not saturated
    assert max_err(out, ref) <= MULTISTEP_TOL
    assert len(evals) == {"plms": 5, "dpmpp": 4}[sampler]


def test_sampler_comes_from_the_config_and_typos_raise(stages):
    jst, pst = stages
    cond, dx, dy = _cond_batch()
    noise = _draw0(jst, jax.random.key(5), [0, 1])
    cfg = tiny_config(torch_side=True).replace(sampler="dpmpp")
    by_config = port_z.Zero123Stage(cfg, params=zero123_from_jax(jst.params), device="cpu")
    a = by_config.sample_views(torch.from_numpy(cond), dx, dy, seed=0, steps=4, noise_fn=noise)
    b = pst.sample_views(torch.from_numpy(cond), dx, dy, seed=0, steps=4, sampler="dpmpp",
                         noise_fn=noise)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown sampler"):
        pst.sample_views(torch.from_numpy(cond), dx, dy, seed=0, steps=2, sampler="DPMPP")
    bad = tiny_config(torch_side=True)
    with pytest.raises(ValueError, match="'none' or 'int8'"):
        port_z.Zero123Stage(bad.replace(unet=bad.unet.replace(quant="w8a8")), device="cpu")


# The int8 stage.  Its first layers see the same inputs on both sides up to
# f32 rounding; once an activation sits within that rounding of a tie its
# code differs, and the layers after it land on other codes: the run then
# moves by the order of the int8 error itself (as far as this stage's int8
# run is from its f32 run).  So the stage is held three
# ways: every int8 layer call of the run replayed through the JAX layer
# (int32 accumulations equal, outputs within 1e-6); the first UNet eval's
# activation codes against JAX's run; the images within INT8_TOL.
INT8_CODE_SHARE = 1e-3  # codes of the first eval that differ from JAX's
INT8_TOL = 0.1  # max abs of the [0, 1] images


def _jax_qconv_replay(module):
    """Jitted (dequantized output, int32 accumulation) of the JAX QConv
    with ``module``'s geometry."""
    from one2345_tpu.diffusion import quantize as jq

    k, s, p = module.kernel_size, module.stride, module.padding
    qconv = jq.QConv(module.out_channels, (k, k), (s, s), ((p, p), (p, p)), dtype=jnp.float32)

    def run(params, x):
        xq, _ = jq.quantize_activation(x)
        wq = params["params"]["kernel_q"]
        dn = jax.lax.conv_dimension_numbers(x.shape, wq.shape, ("NHWC", "HWIO", "NHWC"))
        acc = jax.lax.conv_general_dilated(xq, wq, (s, s), ((p, p), (p, p)), dimension_numbers=dn,
                                           preferred_element_type=jnp.int32)
        return qconv.apply(params, x), acc

    return jax.jit(run)


def test_int8_dpmpp_stage_matches_jax(stages):
    """The int8 stage, each side quantizing the same f32 tree, with dpmpp
    at 4 steps and the JAX stage's conditioning and draw-0 noise."""
    import flax.linen as fnn

    from one2345_tpu.diffusion import quantize as jq
    from one2345_tpu_torch.diffusion import quantize as q

    jst, pst = stages
    jcfg, pcfg = tiny_config(torch_side=False), tiny_config(torch_side=True)
    jq_stage = jax_z.Zero123Stage(jcfg.replace(unet=jcfg.unet.replace(quant="int8")),
                                  params=jst.params)
    pq_stage = port_z.Zero123Stage(pcfg.replace(unet=pcfg.unet.replace(quant="int8")),
                                   params=zero123_from_jax(jst.params), device="cpu")
    qconvs = {m: name for name, m in pq_stage.unet.named_modules() if isinstance(m, q.QConv2d)}
    assert pq_stage.quant and qconvs
    cond, dx, dy = _cond_batch()
    key = jax.random.key(6)
    T = jnp.asarray(jax_z.pose_tokens(dx, dy))
    ctx, concat = (np.array(a) for a in jq_stage.encode_conditioning(jq_stage.params,
                                                                      jnp.asarray(cond), T))
    pq_stage.encode_conditioning = lambda c, t: (torch.from_numpy(ctx), torch.from_numpy(concat))

    jax_inputs = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, jq.QConv) and context.method_name == "__call__":
            jax.debug.callback(lambda v: jax_inputs.append(np.asarray(v)), args[0], ordered=True)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        ref = np.asarray(jq_stage.sample_views(jnp.asarray(cond), dx, dy, key, steps=4,
                                               sampler="dpmpp"))
    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, a: calls.append((mod, a[0].clone())))
             for m in qconvs]
    try:
        out = pq_stage.sample_views(torch.from_numpy(cond), dx, dy, seed=0, steps=4,
                                    sampler="dpmpp", noise_fn=_draw0(jst, key, [0, 1]))
    finally:
        for h in hooks:
            h.remove()
    assert len(calls) == len(jax_inputs) == 4 * len(qconvs)

    replays, unet_params = {}, jq_stage.params["unet"]["params"]
    for module, x in calls:
        name = qconvs[module]
        if name not in replays:
            replays[name] = _jax_qconv_replay(module)
        leaf = unet_params
        for part in name.split("."):
            leaf = leaf[part]
        ref_out, ref_acc = replays[name]({"params": leaf}, x.permute(0, 2, 3, 1).numpy())
        acc, _ = module.accumulate(x)
        assert np.array_equal(acc.numpy(), np.asarray(ref_acc)), name
        y = module(x).permute(0, 2, 3, 1)
        assert max_err(y, ref_out) <= 1e-6 * float(np.abs(np.asarray(ref_out)).max()), name

    differ = total = 0
    for (_, x), xj in zip(calls[: len(qconvs)], jax_inputs):
        codes = q.quantize_activation(x)[0].permute(0, 2, 3, 1).numpy()
        ref_codes = np.asarray(jax.jit(jq.quantize_activation)(jnp.asarray(xj))[0])
        differ += int((codes != ref_codes).sum())
        total += codes.size
    assert differ / total <= INT8_CODE_SHARE, (differ, total)
    assert max_err(out, ref) <= INT8_TOL
    f32_out = pst.sample_views(torch.from_numpy(cond), dx, dy, seed=0, steps=4, sampler="dpmpp",
                               noise_fn=_draw0(jst, key, [0, 1]))
    assert max_err(out, f32_out) > 1e-2  # the int8 layers ran
