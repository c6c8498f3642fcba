"""bf16 reconstruction training against the JAX trainer's, CPU: the port's
``ReconTrainer`` on a ``ReconConfig(dtype='bfloat16')`` stage built with
``f32_weights=True`` (flax's ``dtype=bfloat16`` over f32 parameters) and
the JAX trainer on the same config, at tests/test_torch_recon_train.py's
tiny config (lod0: JAX's compile of ``value_and_grad(scene_loss)`` takes
~17 s here), with JAX's draws for four keys.

Agreement to f32 rounding is not the bar in half precision: the loss, the
metrics and each network's gradient of the port's bf16 run lie at most
twice as far from the f32 run as JAX's own bf16 run does, averaged over
the four keys, with a floor of 1% (relative to the larger of the
quantity and, for a gradient, 1% of the whole gradient's norm: the
blending net's gradient is 1e-5 of it here, the variance's 2e-3, and
bf16 moves them by tens of percent on either side).  The f32 run is the
port's own, which tests/test_torch_recon_train.py holds to JAX's f32
within 1e-4 (loss) and 1e-3 (gradients), far inside bf16's error; one
JAX compile (bf16) is saved so.  The step keeps the weights, the Adam
state and the running statistics in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one2345_tpu.core.config import ReconConfig as JaxReconConfig
from one2345_tpu.recon.pipeline import ReconStage as JaxReconStage
from one2345_tpu.training.recon_trainer import ReconTrainer as JaxReconTrainer
from one2345_tpu_torch.core.config import ReconConfig
from one2345_tpu_torch.recon.pipeline import ReconStage
from one2345_tpu_torch.training.recon_trainer import ReconTrainer
from one2345_tpu_torch.utils.convert_jax import recon_from_jax
from tests.test_torch_recon_train import STEP, TINY, jax_draws
from tests.torch_port_helpers import recon_test_params, tiny_recon_scene

CFG = dict(TINY, num_lods=1)
KEYS = (1, 2, 3, 4)
FLOOR = 1e-2
METRIC_SCALE = 1e-4  # a metric's error is relative to max(|value|, this)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _full_f32():
    with jax.default_matmul_precision("highest"):
        yield


def _grads(tree) -> dict:
    return {k: {n: np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t,
                              np.float64) for n, t in sd.items()} for k, sd in tree.items()}


def _jax_runs(params, dtype, scene):
    """[(loss, metrics, grads)] of JAX's scene_loss for each key, compiled
    once at XLA's lowest optimisation level (the same f32 math)."""
    jtr = JaxReconTrainer(JaxReconStage(JaxReconConfig(**CFG, dtype=dtype), params=params))
    state = jtr.init_state()
    args = (state.params, state.batch_stats, scene, jnp.asarray(STEP))
    fn = jax.jit(jax.value_and_grad(jtr.scene_loss, has_aux=True)).lower(
        *args, jax.random.key(0)).compile(compiler_options={"xla_backend_optimization_level": 0})
    out = []
    for k in KEYS:
        (loss, (metrics, _)), grads = fn(*args, jax.random.key(k))
        out.append((float(loss), {n: float(v) for n, v in metrics.items()},
                    _grads(recon_from_jax(grads))))
    return out


@pytest.fixture(scope="module")
def runs():
    params = recon_test_params(CFG, seed=3)
    scene = tiny_recon_scene(N=TINY["n_rays"], spread=0.05)
    jscene = {k: jnp.asarray(v) for k, v in scene.items()}
    jbf = _jax_runs(params, "bfloat16", jscene)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        runs[dtype] = []
        for k in KEYS:
            stage = ReconStage(ReconConfig(**CFG, dtype=dtype), params=recon_from_jax(params),
                               device="cpu", f32_weights=True)
            trainer = ReconTrainer(stage)
            draws = jax_draws(jax.random.key(k), TINY["n_rays"], TINY["n_samples"],
                              TINY["normal_query_prob"], (0,))
            loss, metrics = trainer.scene_loss(scene, STEP, draws)
            loss.backward()
            for m in trainer.modules.values():
                assert all(p.grad.dtype == torch.float32 for p in m.parameters())
            runs[dtype].append((float(loss.detach()), {n: float(v) for n, v in metrics.items()},
                                _grads({key: {n: p.grad for n, p in m.named_parameters()}
                                        for key, m in trainer.modules.items()})))
    return runs["float32"], jbf, runs["bfloat16"], (trainer, scene, draws)


def _mean_err(runs_a, runs_b, pick, scale) -> float:
    return float(np.mean([np.linalg.norm(pick(a) - pick(b)) / scale(b)
                          for a, b in zip(runs_a, runs_b)]))


def test_bf16_loss_and_metrics_within_twice_jax_s_bf16_error(runs):
    ref, jbf, port, _ = runs
    assert jbf[0][0] != ref[0][0]  # JAX's bf16 run is not the f32 one
    assert set(port[0][1]) == set(ref[0][1])
    assert all(run[1]["loss"] == run[0] for run in port)
    for name in sorted(ref[0][1]):
        def pick(run, name=name):
            return np.float64(run[1][name])

        def scale(run, pick=pick):
            return max(abs(float(pick(run))), METRIC_SCALE)

        e_jax, e_port = _mean_err(jbf, ref, pick, scale), _mean_err(port, ref, pick, scale)
        print(f"{name}: JAX bf16 {e_jax:.2e}, port bf16 {e_port:.2e} from f32")
        assert e_port <= 2 * max(e_jax, FLOOR), name


def test_bf16_gradients_within_twice_jax_s_bf16_error(runs):
    ref, jbf, port, _ = runs
    for key in ref[0][2]:
        def pick(run, key=key):
            return np.concatenate([run[2][key][n].ravel() for n in sorted(run[2][key])])

        def scale(run, pick=pick):
            whole = np.sqrt(sum(float(np.sum(t * t)) for sd in run[2].values()
                                for t in sd.values()))
            return max(float(np.linalg.norm(pick(run))), 1e-2 * whole)

        e_jax, e_port = _mean_err(jbf, ref, pick, scale), _mean_err(port, ref, pick, scale)
        print(f"{key} gradient: JAX bf16 {e_jax:.2e}, port bf16 {e_port:.2e} from f32")
        assert e_port <= 2 * max(e_jax, FLOOR), key


def test_bf16_step_keeps_f32_weights_adam_state_and_statistics(runs):
    *_, (trainer, scene, draws) = runs
    stage = trainer.stage
    assert stage.fusion.fpn.ConvBnAct_0.Conv_0.compute_dtype == torch.bfloat16
    assert stage.render_net.base_fc0.compute_dtype == torch.bfloat16
    assert stage.sdf_net.costreg._MConvBnRelu_0.Conv_0.compute_dtype == torch.bfloat16
    # the SDF MLP and the variance stay f32
    assert not any(hasattr(m, "compute_dtype") for m in stage.sdf_net.sdf_layer.modules())
    with torch.no_grad():
        vol = stage.sdf_net.build_volume(stage.fusion(torch.as_tensor(scene["images"][1:])),
                                         torch.as_tensor(scene["affines"][1:]), (32, 32))
    assert vol["volume"].dtype == torch.bfloat16  # CostRegNet computes in bf16
    metrics = trainer.train_step(scene, draws)
    assert np.isfinite(float(metrics["loss"])) and trainer.step == 1
    for key, m in trainer.modules.items():
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            assert t.dtype == torch.float32, (key, name)
    states = list(trainer.optimizer.state.values())
    assert len(states) == len(trainer._params)
    assert all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32 for s in states)


def test_trainer_refuses_the_inference_stage_s_bf16_weights():
    stage = ReconStage(ReconConfig(**CFG, dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="f32_weights=True"):
        ReconTrainer(stage)
    with pytest.raises(ValueError, match="config dtype"):
        ReconTrainer(ReconStage(ReconConfig(**CFG), device="cpu"),
                     ReconConfig(**CFG, dtype="bfloat16"))
