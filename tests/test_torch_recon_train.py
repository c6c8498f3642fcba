"""one2345_tpu_torch.training.recon_trainer against the JAX trainer, CPU, f32:
batch norm in train mode (outputs and running statistics, masked too),
``scene_loss`` (loss, metrics, every parameter's gradient, the updated
running statistics) at lod0, at lod1 and with ``fix_lod0_networks``, two
optimizer steps against optax's, and the schedules.  The JAX random draws
(stratified jitter, normal-query mix, sparsity points) are fed to the port.
The JAX trees come from ``jax.eval_shape`` (no init is compiled); each
case compiles JAX's ``value_and_grad(scene_loss)`` once (eager JAX would
compile every op on its first use, ~6x slower here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.core.config import ReconConfig as JaxReconConfig
from one2345_tpu.nn.layers import ConvBnAct as JaxConvBnAct
from one2345_tpu.nn.layers import MaskedBatchNorm as JaxMaskedBatchNorm
from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage
from one2345_tpu.training.recon_trainer import ReconTrainer as JaxReconTrainer
from one2345_tpu.training.recon_trainer import cosine_lr as jax_cosine_lr
from one2345_tpu_torch.core.config import ReconConfig
from one2345_tpu_torch.nn.layers import ConvBnAct, MaskedBatchNorm
from one2345_tpu_torch.recon.pipeline import ReconStage
from one2345_tpu_torch.training.recon_trainer import ReconTrainer, cosine_lr
from one2345_tpu_torch.utils.convert_jax import flax_to_state_dict, recon_from_jax
from tests.torch_port_helpers import max_err, recon_test_params, tiny_recon_scene

# tests/test_training.py's tiny two-lod trainer (8^3 coarse, 16^3 fine, 3
# views at 32^2, 8 + 8 samples), with the mask term ungated and the
# normal-query mix on, so that every branch of the loss runs, and 32 rays
# in place of 8: with 8 the gradients hinge on a few samples next to a
# kink, and JAX's own moved by 4e-3 when its feature maps moved by the
# 4e-5 that separates the port's f32 convs from XLA's

TINY = dict(
    image_hw=(32, 32), vol_dims=(8, 8, 8), voxel_size=2.0 / 7.0,
    lod1_vol_dims=(16, 16, 16), lod1_voxel_size=2.0 / 15.0, lod1_d_compress=8,
    lod1_prune_threshold=0.5, n_samples=8, n_importance=8, n_rays=32,
    anneal_end=100, anneal_end_lod1=50, fg_bg_gate_iter=0, normal_query_prob=0.5,
)
STEP = 60  # lod0 alpha ratio 0.6, lod1 1.0; both anneal weights inside their ramps
LOSS_TOL = 1e-4  # relative, loss and every metric
# relative L2, each parameter's gradient; a gradient below 1e-6 of the
# global norm is f32 noise on both sides (the blend's softmax is shift
# invariant, so render.rgb_fc2.bias's true gradient is 0: ~1e-11 here) and
# is held to GRAD_TOL of that floor instead
GRAD_TOL = 1e-3
STATS_TOL = 1e-5  # max abs, BN running statistics
CASES = {"lod0": dict(num_lods=1), "lod1": dict(num_lods=2),
         "fix_lod0": dict(num_lods=2, fix_lod0_networks=True)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs test files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _full_f32():
    with jax.default_matmul_precision("highest"):
        yield


def jax_draws(key, n_rays: int, n_samples: int, p: float, lods) -> dict:
    """The draws the JAX trainer makes from ``key`` (scene_loss, render_rays,
    _assemble_losses), by the port's names."""
    out = {}
    for lod in lods:
        rkey = key if lod == 0 else jax.random.fold_in(key, 2)
        lkey = jax.random.fold_in(key, 1 if lod == 0 else 3)
        sfx = "" if lod == 0 else "_lod1"
        out["t_rand" + sfx] = jax.random.uniform(rkey, (n_rays, n_samples))
        out["normal_query" + sfx] = jax.random.bernoulli(
            jax.random.fold_in(rkey, 101), p, (n_rays, 1, 1)).reshape(-1)
        out["pts_random" + sfx] = jax.random.uniform(lkey, (1024, 3), minval=-1.0, maxval=1.0)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def base_params():
    return recon_test_params(dict(TINY, num_lods=2), seed=3)


_VALUE_AND_GRAD = {}  # case -> JAX trainer, its jitted value_and_grad(scene_loss)


def _jit_update(tx):
    """optax's update + apply, compiled once (eager, each op of each of
    ~200 leaf shapes would compile on its first use)."""
    import optax

    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return jax.jit(update)


def _pair(params, case: str, **over):
    cfg = dict(TINY, **CASES[case], **over)
    lods = (0, 1) if cfg["num_lods"] > 1 else (0,)
    p = {k: v for k, v in params.items() if lods == (0, 1) or not k.endswith("_lod1")}
    if case not in _VALUE_AND_GRAD:
        jtr = JaxReconTrainer(JaxReconStage(JaxReconConfig(**cfg), params=p))
        _VALUE_AND_GRAD[case] = jtr, jax.jit(jax.value_and_grad(jtr.scene_loss, has_aux=True))
    port = ReconStage(ReconConfig(**cfg), params=recon_from_jax(p), device="cpu")
    return _VALUE_AND_GRAD[case], ReconTrainer(port, ReconConfig(**cfg)), lods


def _scene():
    scene = tiny_recon_scene(N=TINY["n_rays"], spread=0.05)
    return scene, {k: jnp.asarray(v) for k, v in scene.items()}


@pytest.fixture(scope="module", params=list(CASES))
def losses(request, base_params):
    (jtr, value_and_grad), ptr, lods = _pair(base_params, request.param)
    scene, jscene = _scene()
    key = jax.random.key(1)
    state = jtr.init_state()
    (jl, (jm, jstats)), jgrads = value_and_grad(
        state.params, state.batch_stats, jscene, jnp.asarray(STEP), key)
    draws = jax_draws(key, TINY["n_rays"], TINY["n_samples"], TINY["normal_query_prob"], lods)
    if request.param == "fix_lod0":
        draws = {k: v for k, v in draws.items() if k.endswith("_lod1")}
    ptr.start_stats = {k: {n: t.clone() for n, t in m.state_dict().items() if "running" in n}
                       for k, m in ptr.modules.items()}
    loss, metrics = ptr.scene_loss(scene, STEP, draws)
    loss.backward()
    return request.param, (jl, jm, jstats, jgrads), (loss, metrics, ptr)


def test_scene_loss_and_metrics_match_jax(losses):
    case, (jl, jm, _, _), (loss, metrics, _) = losses
    assert set(metrics) == set(jm), case
    assert ("color_loss" in metrics) == (case != "fix_lod0")
    for name, ref in jm.items():
        ref = float(ref)
        assert np.isfinite(ref), name
        assert abs(float(metrics[name]) - ref) <= LOSS_TOL * abs(ref) + 1e-7, (case, name)
    assert float(jm["fg_bg_loss_lod1" if case != "lod0" else "fg_bg_loss"]) > 0  # the mask term ran
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL * abs(float(jl))


def test_scene_loss_gradients_match_jax(losses):
    case, (_, _, _, jgrads), (_, _, ptr) = losses
    ref = recon_from_jax(jgrads)
    assert set(ref) == set(ptr.modules)
    floor = 1e-6 * np.sqrt(sum(float(np.sum(np.square(t.numpy(), dtype=np.float64)))
                               for sd in ref.values() for t in sd.values()))
    worst = {}
    for key, module in ptr.modules.items():
        named = dict(module.named_parameters())
        assert set(named) == set(ref[key]), key
        for name, p in named.items():
            g_ref = ref[key][name].numpy().astype(np.float64)
            frozen = case == "fix_lod0" and not key.endswith("_lod1")
            if frozen:
                assert p.grad is None and not np.any(g_ref), (key, name)
                continue
            g = p.grad.numpy().astype(np.float64)
            norm = np.linalg.norm(g_ref)
            if norm == 0:
                # unread on both sides: at 8^3 the U-Net's coarsest level is
                # one voxel, whose batch statistics zero its conv's gradient
                assert np.linalg.norm(g) <= 1e-6, (key, name)
                continue
            worst[f"{key}.{name}"] = np.linalg.norm(g - g_ref) / max(norm, floor)
    print(case, "worst gradient relative L2:", max(worst.items(), key=lambda kv: kv[1]))
    assert max(worst.values()) <= GRAD_TOL


def test_scene_loss_updates_running_stats_as_jax(losses):
    case, (_, _, jstats, _), (_, _, ptr) = losses
    for key in ("fusion", "sdf", "fusion_lod1", "sdf_lod1"):
        if key not in ptr.modules:
            continue
        ref = flax_to_state_dict({"params": {}, "batch_stats": jstats[key]})
        state = ptr.modules[key].state_dict()
        assert len(ref) > 0
        for name, r in ref.items():
            assert max_err(state[name], r) <= STATS_TOL, (case, key, name)
            # a frozen lod0 still updates its statistics
            assert max_err(state[name], ptr.start_stats[key][name]) > 0, (case, key, name)


def test_batch_norm_train_mode_matches_flax():
    """ConvBnAct and MaskedBatchNorm with batch statistics: outputs, input
    gradients and the updated running statistics (momentum 0.9, biased
    variance; masked over the active voxels)."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, size=(3, 10, 12, 5)).astype(np.float32)
    mod = JaxConvBnAct(7, (3, 3), (2, 2))
    variables = mod.init(jax.random.key(0), jnp.asarray(x))
    variables = {"params": jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), variables["params"]),
        "batch_stats": {"BatchNorm_0": {"mean": rng.normal(size=7).astype(np.float32),
                                        "var": (1 + rng.uniform(size=7)).astype(np.float32)}}}
    dy = rng.standard_normal((3, 5, 6, 7)).astype(np.float32)

    def f(xx):
        y, upd = mod.apply(variables, xx, True, mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, upd)

    (_, (y_ref, upd)), gx_ref = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    port = ConvBnAct(5, 7, (3, 3), (2, 2))
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = port(xt, train=True)
    (y * torch.from_numpy(dy).permute(0, 3, 1, 2)).sum().backward()
    assert max_err(y.permute(0, 2, 3, 1), y_ref) <= 1e-5
    assert max_err(xt.grad.permute(0, 2, 3, 1), gx_ref) <= 1e-5
    stats = flax_to_state_dict({"params": {}, "batch_stats": upd["batch_stats"]})
    for name, ref in stats.items():
        assert max_err(port.state_dict()[name], ref) <= STATS_TOL, name
    # inference uses the updated statistics, train mode did not touch them again
    y_eval, _ = mod.apply({**variables, **upd}, jnp.asarray(x), False, mutable=["batch_stats"])
    assert max_err(port(xt).permute(0, 2, 3, 1), y_eval) <= 1e-5

    vol = rng.normal(0.5, 1.5, size=(6, 6, 6, 4)).astype(np.float32)
    mask = (rng.uniform(size=(6, 6, 6, 1)) > 0.6).astype(np.float32)
    mbn = JaxMaskedBatchNorm()
    v = mbn.init(jax.random.key(0), jnp.asarray(vol), jnp.asarray(mask))
    v = {"params": {"scale": (1 + 0.1 * rng.standard_normal(4)).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(4)).astype(np.float32)},
         "batch_stats": v["batch_stats"]}
    y_ref, upd = mbn.apply(v, jnp.asarray(vol), jnp.asarray(mask), True, mutable=["batch_stats"])
    port = MaskedBatchNorm(4)
    port.load_state_dict(flax_to_state_dict(v), strict=True)
    y = port(torch.from_numpy(vol).permute(3, 0, 1, 2)[None],
             torch.from_numpy(mask).permute(3, 0, 1, 2)[None], train=True)
    assert max_err(y[0].permute(1, 2, 3, 0), y_ref) <= 1e-5
    for name, ref in flax_to_state_dict({"params": {}, "batch_stats": upd["batch_stats"]}).items():
        assert max_err(port.state_dict()[name], ref) <= STATS_TOL, name
    # the active voxels alone set the statistics
    assert float(port.running_mean.abs().max()) > 0


def test_optimizer_step_matches_optax(base_params):
    """The update alone, on JAX's own gradients of two lod1 steps: the
    global-norm clip (the norms here are > 1), Adam at the cosine rate read
    at step 0 and 1 -> the parameters of optax's chain."""
    import optax

    over = dict(learning_rate=1e-3, end_iter=10)
    (jtr, value_and_grad), ptr, _ = _pair(base_params, "lod1", **over)
    tx = JaxReconTrainer(None, JaxReconConfig(**TINY, **CASES["lod1"], **over)).tx
    _, jscene = _scene()
    state = jtr.init_state()
    params, stats, opt_state = state.params, state.batch_stats, tx.init(state.params)
    update = _jit_update(tx)
    norms = []
    for step in range(2):
        (_, (_, stats)), grads = value_and_grad(params, stats, jscene, jnp.asarray(step),
                                                jax.random.key(10 + step))
        norms.append(float(optax.global_norm(grads)))
        for key, sd in recon_from_jax(grads).items():
            for name, p in ptr.modules[key].named_parameters():
                p.grad = sd[name].clone()
        ptr.optimizer_step()
        params, opt_state = update(grads, opt_state, params)
    assert min(norms) > 1.0 and ptr.step == 2
    ref = recon_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for key, module in ptr.modules.items():
        for name, p in module.named_parameters():
            assert max_err(p, ref[key][name]) <= 1e-6, (key, name)


def test_two_train_steps_match_jax(base_params):
    """Two whole lod1 steps, the port's gradients and update against JAX's
    (``_train_step`` for one scene, spelled out with its optax chain): the
    losses of both steps (the second on the first's parameters and running
    statistics) and the parameters after them.  Adam's first steps move
    each element by about lr * sign(g), so an element whose gradient lies
    within its f32 error of zero can step the other way, and one such
    element of a 16-element tensor is most of that tensor's update.  So
    the losses are held to 1e-4, every element to 4 lr of JAX's, at most
    0.5% of the elements to more than 0.1 lr, and the running statistics,
    which the second forward computes on those parameters, to 1e-4."""
    import optax

    over = dict(learning_rate=1e-3, end_iter=10)
    (jtr, value_and_grad), ptr, lods = _pair(base_params, "lod1", **over)
    tx = JaxReconTrainer(None, JaxReconConfig(**TINY, **CASES["lod1"], **over)).tx
    scene, jscene = _scene()
    state = jtr.init_state()
    params, stats, opt_state = state.params, state.batch_stats, tx.init(state.params)
    update = _jit_update(tx)
    for step in range(2):
        key = jax.random.key(20 + step)
        (jl, (_, stats)), grads = value_and_grad(params, stats, jscene, jnp.asarray(step), key)
        params, opt_state = update(grads, opt_state, params)
        draws = jax_draws(key, TINY["n_rays"], TINY["n_samples"], TINY["normal_query_prob"], lods)
        pm = ptr.train_step(scene, draws)
        assert abs(float(pm["loss"]) - float(jl)) <= LOSS_TOL * abs(float(jl)), step
    assert ptr.step == 2
    ref = recon_from_jax(jax.tree_util.tree_map(np.asarray, params))
    off = total = 0
    for key, module in ptr.modules.items():
        for name, p in module.named_parameters():
            d = np.abs(p.detach().numpy() - ref[key][name].numpy())
            off += int(np.sum(d > 0.1 * over["learning_rate"]))
            total += d.size
            assert d.max() <= 4 * over["learning_rate"], (key, name)
    print(f"two steps: {off} of {total} elements off by > 0.1 lr")
    assert off <= 0.005 * total  # 485 of 857776 (0.06%) measured
    for key, sd in recon_from_jax({k: {"params": {}, "batch_stats": v}
                                   for k, v in stats.items() if v}).items():
        for name, r in sd.items():
            assert max_err(ptr.modules[key].state_dict()[name], r) <= 1e-4, (key, name)


def test_schedules_match_jax():
    cfg = dict(learning_rate=2e-4, end_iter=1000, anneal_start=100, anneal_end=300,
               anneal_start_lod1=0, anneal_end_lod1=50)
    jtr = JaxReconTrainer(None, JaxReconConfig(**cfg))
    ptr = ReconTrainer.__new__(ReconTrainer)
    ptr.cfg = ReconConfig(**cfg)
    lr, jlr = cosine_lr(2e-4, 1000), jax_cosine_lr(2e-4, 1000)
    for step in (0, 1, 99, 100, 150, 300, 599, 600, 1000, 1500):
        assert abs(lr(step) - float(jlr(jnp.asarray(step)))) <= 1e-6 * 2e-4, step
        for lod in (0, 1):
            assert ptr.alpha_inter_ratio(step, lod) == pytest.approx(
                float(jtr.alpha_inter_ratio(jnp.asarray(step), lod)), abs=1e-7), (step, lod)
            assert ptr._anneal_weight(step, 0.02, lod) == pytest.approx(
                float(jtr._anneal_weight(jnp.asarray(step), 0.02, lod)), abs=1e-9), (step, lod)
    assert lr(1000) == pytest.approx(0.1 * 2e-4)  # the 0.1 floor
    # the collapsed window (start == end) is a step, end == 0 disables the ramp
    for over, table in (
        (dict(anneal_start=25000, anneal_end=25000), ((0, 0.0), (24999, 0.0), (25000, 1.0))),
        (dict(anneal_start=0, anneal_end=0), ((0, 1.0), (10, 1.0))),
    ):
        ptr.cfg = ReconConfig(**over)
        jtr = JaxReconTrainer(None, JaxReconConfig(**over))
        for step, want in table:
            assert ptr.alpha_inter_ratio(step) == want == float(jtr.alpha_inter_ratio(step))
