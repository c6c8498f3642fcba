"""one2345_tpu_torch.utils.convert_weights against the JAX converter, CPU.

The reference's checkpoints are not in the repository, so every case writes
numpy-seeded port weights under the reference's key names with
chip_smoke.py's inverse (the one the card's smoke run writes its
reference-format files with), feeds them to
``one2345_tpu.utils.convert_weights`` (a wrong name raises KeyError there)
and ``utils/convert_jax.py``, and holds the port's converter to the result
bit for bit; the converted weights must also be the seeded ones and load
with ``strict=True``.  The full-width key sets are checked on the meta
device, where no tensor is allocated.  No flax module is built: the JAX
converter is numpy only.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import tree_differences
from one2345_tpu.segmentation.safety import convert_safety_checker as jax_safety
from one2345_tpu.utils import convert_weights as jcw
from one2345_tpu_torch.core import checkpoint
from one2345_tpu_torch.core.config import (
    CLIPVisionConfig,
    DiffusionConfig,
    ElevationConfig,
    PipelineConfig,
    ReconConfig,
    SamConfig,
    UNetConfig,
    VAEConfig,
)
from one2345_tpu_torch.diffusion.zero123 import MODULES, Zero123Stage
from one2345_tpu_torch.elevation.loftr import LoFTRModules
from one2345_tpu_torch.pipeline.runner import One2345Pipeline
from one2345_tpu_torch.recon.pipeline import ReconStage
from one2345_tpu_torch.segmentation.safety import convert_safety_checker
from one2345_tpu_torch.segmentation.sam import SamModules
from one2345_tpu_torch.utils import convert_cli
from one2345_tpu_torch.utils import convert_jax as cj
from one2345_tpu_torch.utils import convert_weights as cw
from tests.torch_port_helpers import tiny_config

# narrow, at the reference's topology (4 levels, attention at ds 1, 2, 4,
# 2 res blocks, 24 CLIP blocks), which convert_zero123 assumes
Z123 = DiffusionConfig(
    image_size=32, latent_size=4,
    unet=UNetConfig(model_channels=32, channel_mult=(1, 2, 2, 2), num_heads=4, dtype="float32"),
    vae=VAEConfig(base_channels=16, channel_mult=(1, 2, 2, 2), dtype="float32"),
    clip=CLIPVisionConfig(image_size=28, patch_size=14, width=32, layers=24, heads=2,
                          dtype="float32"),
)
SAM_TINY = dict(image_size=64, patch_size=16, encoder_dim=32, encoder_heads=2,
                prompt_embed_dim=32, dtype="float32")
SAM_DEPTH2 = SamConfig(encoder_depth=2, global_attn_indexes=(1,), **SAM_TINY)
SAM_DEPTH32 = SamConfig(encoder_depth=32, **SAM_TINY)  # convert_sam's default depth


def seeded(sd: dict, seed: int) -> dict:
    """numpy-seeded f32 tensors of the shapes of ``sd``: weights of rank >= 2
    N(0, 1/fan_in), 1-D weights (norm scales) 1 + N(0, 0.1^2), BN variances
    1 + U(0, 0.5), everything else N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(sd):
        shape, leaf = tuple(sd[name].shape), name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            x = 1.0 + 0.5 * rng.uniform(size=shape)
        elif leaf == "weight" and len(shape) == 1:
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2:
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            x = 0.1 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(np.asarray(x, np.float32))
    return out


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def zero123_weights(cfg, seed: int) -> dict:
    shapes = Zero123Stage(cfg, device="meta")
    return {name: seeded(getattr(shapes, name).state_dict(), seed + i)
            for i, name in enumerate(MODULES)}


def recon_weights(num_lods: int, seed: int) -> dict:
    with torch.device("meta"):
        shapes = ReconStage(ReconConfig(num_lods=num_lods), device="meta").modules()
    return {name: seeded(m.state_dict(), seed + i) for i, (name, m) in enumerate(shapes.items())}


def loftr_weights(seed: int) -> dict:
    with torch.device("meta"):
        return seeded(LoFTRModules().state_dict(), seed)


def sam_weights(cfg, seed: int) -> dict:
    with torch.device("meta"):
        return seeded(SamModules(cfg).state_dict(), seed)


@pytest.fixture(scope="module")
def z123():
    return zero123_weights(Z123, 0)


@pytest.fixture(scope="module")
def loftr():
    """Full-width seeded LoFTR weights and their indoor_ds_new.ckpt state dict."""
    weights = loftr_weights(30)
    return weights, chip_smoke.reference_loftr(weights)["state_dict"]


# ---------------------------------------------------------------- Zero123
@pytest.mark.parametrize("ema", [False, True], ids=["raw", "ema"])
def test_convert_zero123_matches_jax(z123, ema):
    """The whole stage from a LatentDiffusion state dict; with LitEma twins
    the EMA weights win (the raw ones are zeros) and the one key without a
    twin keeps its raw weight."""
    sd = chip_smoke.reference_zero123(z123)["state_dict"]
    if ema:
        sd = chip_smoke.with_ema(sd, keep="model.diffusion_model.out.2.bias")
        assert not torch.equal(sd["model.diffusion_model.input_blocks.0.0.weight"],
                               z123["unet"]["conv_in.weight"])
    got = cw.convert_zero123(sd)
    assert tree_differences(got, cj.zero123_from_jax(jcw.convert_zero123(sd))) == []
    assert tree_differences(got, z123) == []
    stage = Zero123Stage(Z123, params=got, device="cpu")
    assert tree_differences({n: getattr(stage, n).state_dict() for n in MODULES}, z123) == []


@pytest.fixture(scope="module")
def tiny_z123():
    cfg = tiny_config(torch_side=True)
    weights = zero123_weights(cfg, 10)
    return weights, chip_smoke.reference_zero123(weights)["state_dict"], Zero123Stage(
        cfg, device="cpu")


@pytest.mark.parametrize("part", ["unet", "encoder", "decoder", "clip"])
def test_zero123_part_converters_match_jax_at_other_topologies(tiny_z123, part):
    """The part converters' topology arguments: a 2-level UNet with
    attention at ds 1 only, 2 CLIP blocks."""
    weights, sd, stage = tiny_z123
    if part == "unet":
        kw = dict(channel_mult=(1, 2), num_res_blocks=2, attention_resolutions=(1,))
        got, ref = cw.convert_unet(sd, **kw), cj.flax_to_state_dict(jcw.convert_unet(sd, **kw))
    elif part == "clip":
        got = cw.convert_clip_vision(sd, layers=2)
        ref = cj.clip_from_jax(jcw.convert_clip_vision(sd, layers=2))
    else:
        fn = f"convert_vae_{part}"
        got, ref = getattr(cw, fn)(sd), cj.flax_to_state_dict(getattr(jcw, fn)(sd))
    assert tree_differences(got, ref) == []
    assert tree_differences(got, weights[part]) == []
    getattr(stage, part).load_state_dict(got, strict=True)


# -------------------------------------------------------------- SAM, LoFTR
def test_convert_sam_matches_jax():
    """The ConvTranspose2d weights pass unflipped (the JAX converter flips
    them for flax, sam_from_jax flips them back); the box embedding stacks
    point embeddings 2 and 3."""
    weights = sam_weights(SAM_DEPTH2, 20)
    sd = chip_smoke.reference_sam(weights)
    got = cw.convert_sam(sd, depth=2)
    assert tree_differences(got, cj.sam_from_jax(jcw.convert_sam(sd, depth=2))) == []
    assert tree_differences(got, weights) == []
    assert torch.equal(got["decoder.upscale_conv1.weight"],
                       sd["mask_decoder.output_upscaling.0.weight"])
    SamModules(SAM_DEPTH2).load_state_dict(got, strict=True)


@pytest.mark.parametrize("prefix", [True, False], ids=["matcher_prefix", "bare"])
def test_convert_loftr_matches_jax(loftr, prefix):
    """Full width; BN running statistics; the self / cross interleave."""
    weights, sd = loftr
    if not prefix:
        sd = {k[len("matcher."):]: v for k, v in sd.items()}
    assert all(k.startswith("matcher.") == prefix for k in sd)
    got = cw.convert_loftr(sd)
    assert tree_differences(got, cj.loftr_from_jax(jcw.convert_loftr(sd))) == []
    assert tree_differences(got, weights) == []
    LoFTRModules().load_state_dict(got, strict=True)


def test_convert_loftr_prefers_the_matcher_key(loftr):
    weights, sd = loftr
    sd = dict(sd)
    sd["backbone.conv1.weight"] = torch.zeros_like(sd["matcher.backbone.conv1.weight"])
    got = cw.convert_loftr(sd)
    assert torch.equal(got["backbone.conv1.weight"], weights["backbone.conv1.weight"])
    assert tree_differences(got, cj.loftr_from_jax(jcw.convert_loftr(sd))) == []


# ------------------------------------------------------------------ recon
@pytest.mark.parametrize("num_lods", [1, 2], ids=["lod0", "lod0_lod1"])
def test_convert_recon_matches_jax(num_lods):
    """Full width: InPlaceABN gammas (every other one negative), torchsparse
    kernels (the transposed convs flipped), weight_norm's v and g, the
    scalars."""
    weights = recon_weights(num_lods, 40)
    ckpt = chip_smoke.reference_recon(weights)
    gammas = ckpt["pyramid_feature_network_lod0"]["conv0.1.bn.weight"]
    assert (gammas < 0).any() and (gammas > 0).any()
    kernel = ckpt["sdf_network_lod0"]["sparse_costreg_net.conv7.net.0.kernel"]
    assert kernel.shape[0] == 27 and kernel.dim() == 3
    got = cw.convert_recon(ckpt)
    assert tree_differences(got, cj.recon_from_jax(jcw.convert_recon(ckpt))) == []
    assert tree_differences(got, weights) == []
    ReconStage(ReconConfig(num_lods=num_lods), params=got, device="cpu")


def test_sparse_kernel_layout():
    """torchsparse enumerates offsets with x fastest: offset k = x + 3y + 9z
    lands at weight[..., x, y, z]; a transposed conv's at [..., 2-x, 2-y, 2-z]."""
    w = torch.arange(27 * 2 * 3, dtype=torch.float32).reshape(27, 2, 3)
    sd = {"a.kernel": w, "b.1x1.kernel": w[0]}
    fwd = cw._sparse_conv3d(sd, "a")
    tr = cw._sparse_conv3d(sd, "a", transposed=True)
    for x, y, z in ((1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 1, 0)):
        k = x + 3 * y + 9 * z
        assert torch.equal(fwd[:, :, x, y, z], w[k].T)
        assert torch.equal(tr[:, :, 2 - x, 2 - y, 2 - z], w[k].T)
    assert cw._sparse_conv3d(sd, "b.1x1").shape == (3, 2, 1, 1, 1)
    ref = cj.flax_to_state_dict({"c": jcw._sparse_conv3d(sd, "b.1x1")})["c.weight"]
    assert torch.equal(cw._sparse_conv3d(sd, "b.1x1"), ref)


# ----------------------------------------------------------------- safety
def test_convert_safety_checker_flags_as_jax():
    sd = chip_smoke.safety_state_dict()
    port, ref = convert_safety_checker(sd), jax_safety(sd)
    for name in ("concept_embeds", "concept_thresholds", "special_embeds",
                 "special_thresholds"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    np.testing.assert_array_equal(port.concept_thresholds, np.float32(0.5) * 1.2)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((6, 768)).astype(np.float32)
    emb[1] = sd["concept_embeds"][2].numpy() + 0.3 * emb[1]
    emb[4] = sd["special_care_embeds"][0].numpy() + 0.3 * emb[4]
    flags = port.check(emb)
    np.testing.assert_array_equal(flags, ref.check(emb))
    assert flags.tolist() == [False, True, False, False, True, False]


# ----------------------------------------------------- full-width key sets
class Recording(dict):
    """Zero-stride numpy leaves of the reference's shapes; records the keys
    the JAX converter reads."""

    def __init__(self, shapes: dict):
        super().__init__({k: np.broadcast_to(np.float32(0), v) for k, v in shapes.items()})
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


@pytest.mark.parametrize("family", ["zero123", "sam"])
def test_full_width_key_sets(family):
    """At DiffusionConfig() and SamConfig(), on the meta device: the inverse
    names exactly the keys the JAX converter reads, and the port's converter
    gives the meta-built modules' state dicts, shape for shape."""
    if family == "zero123":
        stage = Zero123Stage(DiffusionConfig(), device="meta")
        modules = {n: getattr(stage, n) for n in MODULES}
        sd = chip_smoke.reference_zero123({n: m.state_dict() for n, m in modules.items()})
        sd = sd["state_dict"]
        got = cw.convert_zero123(sd)
        convert = jcw.convert_zero123
    else:
        with torch.device("meta"):
            modules = {"sam": SamModules(SamConfig())}
        sd = chip_smoke.reference_sam(modules["sam"].state_dict())
        got = {"sam": cw.convert_sam(sd)}
        convert = jcw.convert_sam
    for name, module in modules.items():
        want = module.state_dict()
        assert {k: tuple(v.shape) for k, v in got[name].items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        module.load_state_dict(got[name], strict=True)
    recording = Recording({k: tuple(v.shape) for k, v in sd.items()})
    convert(recording)
    assert recording.read == set(sd)


# ----------------------------------------------------- loader and the CLI
@pytest.mark.parametrize("wrapped", [True, False], ids=["state_dict", "bare"])
def test_load_torch_state_dict(tmp_path, wrapped):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
    path = str(tmp_path / "x.ckpt")
    torch.save({"state_dict": sd, "epoch": 3} if wrapped else sd, path)
    for loader in (cw.load_torch_state_dict, jcw.load_torch_state_dict):
        got = loader(path)
        assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """convert_cli.main on the five reference-format files at small width
    (SAM at its default depth 32, LoFTR and recon at full width)."""
    root = tmp_path_factory.mktemp("convert")
    stages = {"zero123": zero123_weights(Z123, 50), "loftr": loftr_weights(51),
              "recon": recon_weights(1, 52)}
    sam = sam_weights(SAM_DEPTH32, 53)
    argv = []
    for name, obj in chip_smoke.reference_checkpoints(stages, sam).items():
        path = str(root / chip_smoke.CONVERT_FILES[name])
        torch.save(obj, path)
        argv += [f"--{name}", path]
    out = str(root / "params.pt")
    convert_cli.main(argv + ["--out", out])
    return out, dict(stages, sam=sam)


def test_convert_cli_writes_a_tree_restore_reads(converted):
    out, weights = converted
    tree = checkpoint.restore(out)  # weights_only=True: tensors and Python scalars only
    assert set(tree) == {"zero123", "sam", "loftr", "recon", "safety"}
    assert tree_differences({k: tree[k] for k in weights}, weights) == []
    assert tree["safety"]["threshold_scale"] == 1.0
    ref = jax_safety(chip_smoke.safety_state_dict())
    for name in ("concept_embeds", "concept_thresholds", "special_embeds", "special_thresholds"):
        assert isinstance(tree["safety"][name], torch.Tensor)
        np.testing.assert_array_equal(tree["safety"][name].numpy(), getattr(ref, name))


def test_convert_cli_refuses_no_input(tmp_path, capsys):
    with pytest.raises(SystemExit):
        convert_cli.main(["--out", str(tmp_path / "p.pt")])
    assert "nothing to convert" in capsys.readouterr().err
    assert not (tmp_path / "p.pt").exists()


def test_pipeline_builds_every_stage_from_the_converted_file(converted):
    """One2345Pipeline(params=restored tree) builds each stage with strict
    loads, on the seeded weights; the safety gate flags what the JAX
    convert_safety_checker flags."""
    out, weights = converted
    cfg = PipelineConfig(diffusion=Z123, sam=SAM_DEPTH32, recon=ReconConfig(),
                         elevation=ElevationConfig(dtype="float32"))
    pipe = One2345Pipeline(cfg, params=checkpoint.restore(out), device="cpu")
    assert tree_differences({n: getattr(pipe.zero123, n).state_dict() for n in MODULES},
                           weights["zero123"]) == []
    assert tree_differences({n: m.state_dict() for n, m in pipe.recon.modules().items()},
                           weights["recon"]) == []
    assert tree_differences(pipe.elevation_estimator.matcher.modules.state_dict(),
                           weights["loftr"]) == []
    sam_state = {k: v.float() for k, v in pipe.sam.modules.state_dict().items()}
    assert tree_differences(sam_state, weights["sam"]) == []
    sd = chip_smoke.safety_state_dict()
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((5, 768)).astype(np.float32)
    emb[0] = sd["concept_embeds"][0].numpy()
    emb[3] = sd["special_care_embeds"][1].numpy() + 0.2 * emb[3]
    flags = pipe.safety.check(emb)
    np.testing.assert_array_equal(flags, jax_safety(sd).check(emb))
    assert flags.tolist() == [True, False, False, True, False]
