"""one2345_tpu_torch's Zero123 finetune step against the JAX trainer (tiny
config, numpy-randomized weights, f32, CPU), with the JAX draws injected:
the training buffers, the posterior sample, the loss and every gradient,
remat on and off, and two optimizer + EMA steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.diffusion import schedule as jax_schedule
from one2345_tpu.diffusion import vae as jax_vae
from one2345_tpu.diffusion import zero123 as jax_z
from one2345_tpu.training import data as jax_data
from one2345_tpu.training.zero123_trainer import Zero123Trainer as JaxTrainer
from one2345_tpu_torch.diffusion import schedule, vae
from one2345_tpu_torch.diffusion import zero123 as port_z
from one2345_tpu_torch.training import data
from one2345_tpu_torch.training.zero123_trainer import Zero123Trainer, make_optimizer
from one2345_tpu_torch.utils.convert_jax import trainable_from_jax, zero123_from_jax
from tests.torch_port_helpers import max_err, randomize, tiny_config

B = 4
# Gradients at or below this are f32 rounding of an analytically zero
# gradient: in the tiny config every UNet GroupNorm has one channel per
# group, which cancels the conv bias and time embedding before it (JAX
# gives them 1e-9..8e-9; the smallest real gradient is 1.4e-3), and the
# one-token cross-attention never reads attn2.to_q / to_k or norm2.
NOISE_GRAD = 1e-6


@pytest.fixture(autouse=True)
def _full_matmul_precision():
    with jax.default_matmul_precision("highest"):
        yield


def test_training_schedule_matches_jax():
    ref = jax_schedule.training_schedule(1000, 0.00085, 0.0120)
    out = schedule.training_schedule(1000, 0.00085, 0.0120)
    assert set(out) == set(ref)
    for name in ref:
        assert out[name].dtype == ref[name].dtype and np.array_equal(out[name], ref[name])


def test_moments_sample_matches_jax():
    rng = np.random.default_rng(3)
    moments = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    moments[..., 4:] *= 40.0  # logvar past both clip bounds
    key = jax.random.key(7)
    ref = jax_vae.moments_sample(jnp.asarray(moments), key)
    noise = np.asarray(jax.random.normal(key, (2, 4, 4, 4)))
    out = vae.moments_sample(torch.from_numpy(moments), torch.from_numpy(noise))
    assert max_err(out, ref) < 1e-5 * float(np.abs(np.asarray(ref)).max())


def test_relative_pose_token_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(8):
        c2w_a, c2w_b = np.eye(4), np.eye(4)
        c2w_a[:3, 3], c2w_b[:3, 3] = rng.normal(size=3) * 2, rng.normal(size=3) * 2
        ref = jax_data.relative_pose_token(c2w_a, c2w_b)
        out = data.relative_pose_token(c2w_a, c2w_b)
        assert out.dtype == ref.dtype and np.array_equal(out, ref)


def test_optimizer_matches_optax_defaults():
    unet, cc = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    opt, sched = make_optimizer(unet, cc, base_lr=1e-4)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([1e-10, 1e-9])
    for g in opt.param_groups:
        assert g["weight_decay"] == 1e-4 and g["eps"] == 1e-8 and g["betas"] == (0.9, 0.999)
    opt.step()
    sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-4 * (1e-6 + (1 - 1e-6) * 0.01))


@pytest.fixture(scope="module")
def setup():
    jst = jax_z.Zero123Stage(tiny_config(torch_side=False), seed=0)
    jst.params = randomize(jst.params, seed=41)
    pst = port_z.Zero123Stage(
        tiny_config(torch_side=True), params=zero123_from_jax(jst.params), device="cpu"
    )
    rng = np.random.default_rng(0)
    cams = []
    for _ in range(2 * B):
        c2w = np.eye(4)
        c2w[:3, 3] = rng.normal(size=3) * 1.5
        cams.append(c2w)
    batch = {
        "image_target": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32),
        "image_cond": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32),
        "T": np.stack(
            [data.relative_pose_token(cams[i], cams[B + i]) for i in range(B)]
        )[:, None, :],
    }
    trainable = {"unet": jst.params["unet"], "cc_projection": jst.params["cc_projection"]}
    frozen = {k: jst.params[k] for k in ("encoder", "clip")}
    return jst, pst, batch, trainable, frozen


def _key_with_some_dropout():
    """A key whose dropout uniforms drop some rows' conditioning and keep
    others', so the comparison covers both branches."""
    for seed in range(100):
        key = jax.random.key(seed)
        u = np.asarray(jax.random.uniform(jax.random.split(key, 5)[3], (B,)))
        if (u < 0.15).any() and (u >= 0.15).any():
            return key
    raise AssertionError("no key with mixed dropout")


def _jax_draws(key):
    """The draws of the JAX loss_fn for ``key``: the same split and calls."""
    k_t, k_noise, k_z, k_drop1, _ = jax.random.split(key, 5)
    return {
        "t": np.asarray(jax.random.randint(k_t, (B,), 0, 1000)),
        "noise": np.asarray(jax.random.normal(k_noise, (B, 4, 4, 4))),
        "z_eps": np.asarray(jax.random.normal(k_z, (B, 4, 4, 4))),
        "u": np.asarray(jax.random.uniform(k_drop1, (B,))),
    }


def _named_grads(trainer):
    """{module: {name: grad}}, zeros where autograd gave none."""
    return {
        name: {
            k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
            for k, p in m.named_parameters()
        }
        for name, m in trainer.modules.items()
    }


def _as_numpy(tree):
    return {m: {k: v.detach().cpu().numpy() for k, v in d.items()} for m, d in tree.items()}


def test_loss_and_gradients_match_jax(setup):
    jst, pst, batch, trainable, frozen = setup
    key = _key_with_some_dropout()
    jt = JaxTrainer(jst, remat=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(jt.loss_fn))(trainable, frozen, jbatch, key)
    grads_ref = _as_numpy(trainable_from_jax(jax.tree_util.tree_map(np.asarray, grads_ref)))

    trainer = Zero123Trainer(pst, trainable_from_jax(trainable), remat=False, device="cpu")
    loss = trainer.loss_fn(batch, _jax_draws(key))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_ref)) < 1e-5 * float(loss_ref)
    grads = _named_grads(trainer)
    assert grads.keys() == grads_ref.keys()
    for name, ref_tree in grads_ref.items():
        assert grads[name].keys() == ref_tree.keys()
        for k, ref in ref_tree.items():
            scale = float(np.abs(ref).max())
            # f32 on both sides; 1e-4 relative, floored at 1e-2 for the
            # rounding-noise gradients (NOISE_GRAD)
            assert max_err(grads[name][k], ref) < 1e-4 * max(scale, 1e-2), (name, k)
    real = [k for k, r in grads_ref["unet"].items() if np.abs(r).max() > NOISE_GRAD]
    assert "in_0_0_attn.block0.attn1.to_q.weight" in real and len(real) > 200


def _counted(fn, calls):
    def wrapper(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    return wrapper


def test_remat_gives_the_same_gradients(setup):
    """The counterpart of tests/test_training.py::test_remat_gradients_match:
    checkpointed blocks run again in the backward pass and recompute the
    same f32 values."""
    _, pst, batch, trainable, _ = setup
    draws = _jax_draws(_key_with_some_dropout())
    outs = []
    for remat in (False, True):
        trainer = Zero123Trainer(pst, trainable_from_jax(trainable), remat=remat, device="cpu")
        calls = []
        for name in ("in_0_0_res", "in_0_0_attn"):
            block = getattr(trainer.unet, name)
            block.forward = _counted(block.forward, calls)
        loss = trainer.loss_fn(batch, draws)
        loss.backward()
        assert len(calls) == (4 if remat else 2)
        outs.append((loss.item(), _named_grads(trainer)))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    for name, tree in outs[0][1].items():
        for k, g in tree.items():
            assert max_err(g, outs[1][1][name][k]) <= 1e-6 * max(1.0, float(g.abs().max()))


def test_two_train_steps_match_jax(setup):
    """Params, EMA and step count after two train_steps: the first at the
    warmup's lr * 1e-6, the second at lr * (1e-6 + 0.01), cc_projection at
    10x, with Adam's bias correction and the LitEma warmup.  base_lr 1e-2
    lifts the updates well above the f32 rounding of the weights; each
    tensor's update (and EMA change) is held in relative L2."""
    jst, pst, batch, trainable, frozen = setup
    base_lr = 1e-2
    jt = JaxTrainer(jst, remat=False, base_lr=base_lr)
    state = jt.init_state()
    trainer = Zero123Trainer(pst, trainable_from_jax(trainable), remat=False, device="cpu",
                             base_lr=base_lr)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for key in (_key_with_some_dropout(), jax.random.key(1000)):
        state, loss_ref = jt.train_step(state, frozen, jbatch, key)
        loss = trainer.train_step(batch, _jax_draws(key))
        assert abs(float(loss) - float(loss_ref)) < 1e-5 * float(loss_ref)
    assert int(state.step) == trainer.step == 2

    def tree(x):
        return _as_numpy(trainable_from_jax(jax.tree_util.tree_map(np.asarray, x)))

    p0, p_ref, ema_ref = tree(trainable), tree(state.params), tree(state.ema_params)
    p_got, ema_got = _as_numpy(trainer.state_dicts()), _as_numpy(trainer.ema)
    grad_scale = {
        name: {k: float(p.grad.abs().max()) for k, p in m.named_parameters()}
        for name, m in trainer.modules.items()
    }
    lr_sum = {"unet": base_lr * 0.010001, "cc_projection": 10 * base_lr * 0.010001}
    n_real = 0
    for name in p0:
        for k, w0 in p0[name].items():
            pairs = ((p_got[name][k] - w0, p_ref[name][k] - w0),
                     (ema_got[name][k] - w0, ema_ref[name][k] - w0))
            if grad_scale[name][k] <= NOISE_GRAD:
                # Adam turns rounding noise into steps of either sign: hold
                # both sides to the size of an Adam step only
                for got, ref in pairs:
                    assert np.abs(got).max() <= 3 * lr_sum[name]
                    assert np.abs(ref).max() <= 3 * lr_sum[name]
                continue
            n_real += 1
            for got, ref in pairs:
                # 5e-3: f32 rounding of weights near 1 against updates near 1e-4
                rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
                assert rel < 5e-3, (name, k, rel)
    assert n_real > 200


def test_trainer_refuses_another_device_than_the_stage(setup):
    _, pst, _, trainable, _ = setup
    with pytest.raises(ValueError):
        Zero123Trainer(pst, trainable_from_jax(trainable), device="meta")


def test_trainer_draws_from_its_generator_without_injected_draws(setup):
    _, pst, batch, trainable, _ = setup
    losses = []
    for _ in range(2):
        trainer = Zero123Trainer(pst, trainable_from_jax(trainable), device="cpu", seed=3)
        losses.append(float(trainer.loss_fn(batch)))
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    with pytest.raises(KeyError):
        trainer.loss_fn(batch, {"noise_typo": np.zeros(1)})


def test_zero123_trainer_rejects_quant_stage():
    """int8 is an inference-only mode: the trainer refuses an int8 stage,
    as the JAX trainer does (tests/test_quantize.py)."""
    cfg = tiny_config(torch_side=True)
    stage = port_z.Zero123Stage(cfg.replace(unet=cfg.unet.replace(quant="int8")), device="cpu")
    assert stage.quant
    with pytest.raises(ValueError, match="f32 param tree"):
        Zero123Trainer(stage, {}, device="cpu")
