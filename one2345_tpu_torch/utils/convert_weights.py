"""The reference's torch checkpoints -> the port's state dicts.

Counterpart of ``one2345_tpu/utils/convert_weights.py``.  The reference
distributes four pretrained checkpoints (download_ckpt.py:21-29):
zero123-xl.ckpt (LatentDiffusion), sam_vit_h_4b8939.pth, LoFTR's
indoor_ds_new.ckpt and the reconstruction's ckpt_215000.pth.  These
functions map their state dicts onto the state dicts of the port's modules,
which load them with ``strict=True``:

- ``convert_zero123`` -> {'unet', 'encoder', 'decoder', 'clip',
  'cc_projection'} (``diffusion.zero123.MODULES``), the UNet from its EMA
  weights where the checkpoint has them;
- ``convert_sam`` -> the state dict of ``segmentation.sam.SamModules``;
- ``convert_loftr`` -> that of ``elevation.loftr.LoFTRModules``;
- ``convert_recon`` -> {'fusion', 'sdf', 'render', 'variance'} and, where
  the checkpoint has them, the '*_lod1' ones (``recon.pipeline.ReconStage``).

The port's modules are named after the JAX package's flax scopes and keep
torch's layouts, so most leaves are a rename: a conv stays OIHW, a Linear
(out, in), a norm's 'weight' stays 'weight', a ConvTranspose2d stays
[I, O, kh, kw].  The exceptions:
- CLIP's packed ``in_proj_weight`` / ``in_proj_bias`` are split into q, k, v;
- the CCProjection kernel is the Linear weight transposed (``x @ kernel``);
- the weight-normalised SDF layers keep 'v' [in, out] and 'g' [out];
- InPlaceABN's effective scale ``|gamma| + eps`` becomes the BN weight;
- torchsparse kernels [K, I, O] become Conv3d weights (O, I, kx, ky, kz);
- SAM's box embedding stacks point embeddings 2 and 3.

Every leaf becomes float32 on its own device.  The result equals the JAX
converter followed by ``utils.convert_jax`` bit for bit.
"""

from __future__ import annotations

import torch

_MATCHER = "matcher."
_INPLACE_ABN_EPS = 1e-5


def _t(x) -> torch.Tensor:
    """A checkpoint leaf (tensor or array) as a float32 tensor."""
    return torch.as_tensor(x).detach().to(torch.float32)


def _layer(out: dict, dst: str, sd, key: str, bias: bool = True):
    """A conv, Linear or norm layer: its 'weight' and, where the checkpoint
    has one, its 'bias'."""
    out[f"{dst}.weight"] = _t(sd[f"{key}.weight"])
    if bias and f"{key}.bias" in sd:
        out[f"{dst}.bias"] = _t(sd[f"{key}.bias"])


def _bn(out: dict, dst: str, sd, key: str):
    """A BatchNorm with its running statistics."""
    _layer(out, dst, sd, key)
    for stat in ("running_mean", "running_var"):
        out[f"{dst}.{stat}"] = _t(sd[f"{key}.{stat}"])


# --------------------------------------------------------------------------
# Zero123-XL (LatentDiffusion checkpoint)
# --------------------------------------------------------------------------


def convert_unet(sd, prefix="model.diffusion_model.", channel_mult=(1, 2, 4, 4),
                 num_res_blocks=2, attention_resolutions=(4, 2, 1)) -> dict:
    """The state dict of ``diffusion.unet.UNetModel`` from the diffusion
    model's keys (openaimodel.py's block numbering; transformer depth 1)."""
    p = prefix
    out: dict = {}
    for dst, key in (("time_embed_0", "time_embed.0"), ("time_embed_2", "time_embed.2"),
                     ("conv_in", "input_blocks.0.0"), ("out_norm", "out.0"),
                     ("conv_out", "out.2")):
        _layer(out, dst, sd, p + key)

    def res_block(dst, key):
        for name, sub in (("in_norm", "in_layers.0"), ("in_conv", "in_layers.2"),
                          ("emb_proj", "emb_layers.1"), ("out_norm", "out_layers.0"),
                          ("out_conv", "out_layers.3")):
            _layer(out, f"{dst}.{name}", sd, f"{key}.{sub}")
        if f"{key}.skip_connection.weight" in sd:
            _layer(out, f"{dst}.skip", sd, f"{key}.skip_connection")

    def attn_block(dst, key):
        for name in ("norm", "proj_in", "proj_out"):
            _layer(out, f"{dst}.{name}", sd, f"{key}.{name}")
        b, tb = f"{dst}.block0", f"{key}.transformer_blocks.0"
        for name in ("norm1", "norm2", "norm3"):
            _layer(out, f"{b}.{name}", sd, f"{tb}.{name}")
        for attn in ("attn1", "attn2"):
            for name in ("to_q", "to_k", "to_v"):
                _layer(out, f"{b}.{attn}.{name}", sd, f"{tb}.{attn}.{name}", bias=False)
            _layer(out, f"{b}.{attn}.to_out", sd, f"{tb}.{attn}.to_out.0")
        _layer(out, f"{b}.ff_geglu.proj", sd, f"{tb}.ff.net.0.proj")
        _layer(out, f"{b}.ff_out", sd, f"{tb}.ff.net.2")

    n_levels = len(channel_mult)
    idx, ds = 1, 1
    for level in range(n_levels):
        for i in range(num_res_blocks):
            res_block(f"in_{level}_{i}_res", f"{p}input_blocks.{idx}.0")
            if ds in attention_resolutions:
                attn_block(f"in_{level}_{i}_attn", f"{p}input_blocks.{idx}.1")
            idx += 1
        if level != n_levels - 1:
            _layer(out, f"down_{level}.op", sd, f"{p}input_blocks.{idx}.0.op")
            idx += 1
            ds *= 2

    res_block("mid_res1", f"{p}middle_block.0")
    attn_block("mid_attn", f"{p}middle_block.1")
    res_block("mid_res2", f"{p}middle_block.2")

    idx = 0
    for level in reversed(range(n_levels)):
        for i in range(num_res_blocks + 1):
            res_block(f"out_{level}_{i}_res", f"{p}output_blocks.{idx}.0")
            sub = 1
            if ds in attention_resolutions:
                attn_block(f"out_{level}_{i}_attn", f"{p}output_blocks.{idx}.1")
                sub = 2
            if i == num_res_blocks and level != 0:
                _layer(out, f"up_{level}.conv", sd, f"{p}output_blocks.{idx}.{sub}.conv")
                ds //= 2
            idx += 1
    return out


def _vae_res(out: dict, dst: str, sd, key: str):
    for name in ("norm1", "conv1", "norm2", "conv2"):
        _layer(out, f"{dst}.{name}", sd, f"{key}.{name}")
    if f"{key}.nin_shortcut.weight" in sd:
        _layer(out, f"{dst}.nin_shortcut", sd, f"{key}.nin_shortcut")


def _vae_trunk(out: dict, sd, p: str):
    """conv_in, the middle blocks, norm_out and conv_out (encoder and decoder)."""
    _layer(out, "conv_in", sd, f"{p}conv_in")
    _vae_res(out, "mid_block_1", sd, f"{p}mid.block_1")
    for name in ("norm", "q", "k", "v", "proj_out"):
        _layer(out, f"mid_attn.{name}", sd, f"{p}mid.attn_1.{name}")
    _vae_res(out, "mid_block_2", sd, f"{p}mid.block_2")
    _layer(out, "norm_out", sd, f"{p}norm_out")
    _layer(out, "conv_out", sd, f"{p}conv_out")


def convert_vae_encoder(sd, prefix="first_stage_model.", channel_mult=(1, 2, 4, 4),
                        num_res_blocks=2) -> dict:
    """The state dict of ``diffusion.vae.Encoder`` (with quant_conv)."""
    p = f"{prefix}encoder."
    out: dict = {}
    _vae_trunk(out, sd, p)
    _layer(out, "quant_conv", sd, f"{prefix}quant_conv")
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            _vae_res(out, f"down_{level}_block_{i}", sd, f"{p}down.{level}.block.{i}")
        if level != len(channel_mult) - 1:
            _layer(out, f"down_{level}_downsample", sd, f"{p}down.{level}.downsample.conv")
    return out


def convert_vae_decoder(sd, prefix="first_stage_model.", channel_mult=(1, 2, 4, 4),
                        num_res_blocks=2) -> dict:
    """The state dict of ``diffusion.vae.Decoder`` (with post_quant_conv)."""
    p = f"{prefix}decoder."
    out: dict = {}
    _layer(out, "post_quant_conv", sd, f"{prefix}post_quant_conv")
    _vae_trunk(out, sd, p)
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks + 1):
            _vae_res(out, f"up_{level}_block_{i}", sd, f"{p}up.{level}.block.{i}")
        if level != 0:
            _layer(out, f"up_{level}_conv", sd, f"{p}up.{level}.upsample.conv")
    return out


def convert_clip_vision(sd, prefix="cond_stage_model.model.visual.", layers=24) -> dict:
    """The state dict of ``diffusion.clip.CLIPVisionTower`` from OpenAI's
    visual tower; each block's packed q/k/v projection is split in thirds."""
    p = prefix
    out = {"patch_embed.weight": _t(sd[f"{p}conv1.weight"])}
    for name in ("class_embedding", "positional_embedding", "proj"):
        out[name] = _t(sd[p + name])
    _layer(out, "ln_pre", sd, f"{p}ln_pre")
    _layer(out, "ln_post", sd, f"{p}ln_post")
    for i in range(layers):
        b, dst = f"{p}transformer.resblocks.{i}", f"resblock_{i}"
        w, bias = _t(sd[f"{b}.attn.in_proj_weight"]), _t(sd[f"{b}.attn.in_proj_bias"])
        C = w.shape[0] // 3
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            rows = slice(j * C, (j + 1) * C if j < 2 else None)
            out[f"{dst}.attn.{name}.weight"] = w[rows]
            out[f"{dst}.attn.{name}.bias"] = bias[rows]
        _layer(out, f"{dst}.attn.out_proj", sd, f"{b}.attn.out_proj")
        _layer(out, f"{dst}.ln_1", sd, f"{b}.ln_1")
        _layer(out, f"{dst}.ln_2", sd, f"{b}.ln_2")
        _layer(out, f"{dst}.fc", sd, f"{b}.mlp.c_fc")
        _layer(out, f"{dst}.proj", sd, f"{b}.mlp.c_proj")
    return out


def convert_zero123(sd) -> dict:
    """{module name: state dict} of ``diffusion.zero123.Zero123Stage`` from a
    LatentDiffusion state dict.

    The UNet takes the EMA weights where the checkpoint has them (the
    weights sampling uses, ema_scope, zero123_utils.py:63): LitEma names
    'model.diffusion_model.a.b' as 'model_ema.diffusion_modelab', every dot
    dropped; a UNet key with no EMA twin keeps its raw weight."""
    if any(k.startswith("model_ema.") for k in sd):
        sd = {**sd, **{
            k: sd.get("model_ema." + k[len("model."):].replace(".", ""), v)
            for k, v in sd.items() if k.startswith("model.diffusion_model.")
        }}
    return {
        "unet": convert_unet(sd),
        "encoder": convert_vae_encoder(sd),
        "decoder": convert_vae_decoder(sd),
        "clip": convert_clip_vision(sd),
        "cc_projection": {"kernel": _t(sd["cc_projection.weight"]).T.contiguous(),
                          "bias": _t(sd["cc_projection.bias"])},
    }


# --------------------------------------------------------------------------
# SAM ViT-H
# --------------------------------------------------------------------------


def convert_sam(sd, depth=32) -> dict:
    """The state dict of ``segmentation.sam.SamModules`` (image encoder,
    mask decoder and the prompt encoder's leaves) from
    sam_vit_h_4b8939.pth."""
    e, d, t = "image_encoder.", "mask_decoder.", "mask_decoder.transformer."
    out = {"encoder.pos_embed": _t(sd[f"{e}pos_embed"])}
    _layer(out, "encoder.patch_embed", sd, f"{e}patch_embed.proj")
    for i, name in enumerate(("neck_conv1", "neck_ln1", "neck_conv2", "neck_ln2")):
        _layer(out, f"encoder.{name}", sd, f"{e}neck.{i}", bias=name.startswith("neck_ln"))
    for i in range(depth):
        b, dst = f"{e}blocks.{i}", f"encoder.block_{i}"
        for name in ("norm1", "norm2", "attn.qkv", "attn.proj"):
            _layer(out, f"{dst}.{name}", sd, f"{b}.{name}")
        for name in ("attn.rel_pos_h", "attn.rel_pos_w"):
            out[f"{dst}.{name}"] = _t(sd[f"{b}.{name}"])
        _layer(out, f"{dst}.mlp_lin1", sd, f"{b}.mlp.lin1")
        _layer(out, f"{dst}.mlp_lin2", sd, f"{b}.mlp.lin2")

    def attention(dst, key):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _layer(out, f"{dst}.{name}", sd, f"{key}.{name}")

    out["decoder.iou_token"] = _t(sd[f"{d}iou_token.weight"])
    out["decoder.mask_tokens"] = _t(sd[f"{d}mask_tokens.weight"])
    for layer in (0, 1):
        dst, key = f"decoder.layer{layer}", f"{t}layers.{layer}"
        attention(f"{dst}.self_attn", f"{key}.self_attn")
        attention(f"{dst}.cross_attn_t2i", f"{key}.cross_attn_token_to_image")
        attention(f"{dst}.cross_attn_i2t", f"{key}.cross_attn_image_to_token")
        for name in ("norm1", "norm2", "norm3", "norm4"):
            _layer(out, f"{dst}.{name}", sd, f"{key}.{name}")
        _layer(out, f"{dst}.mlp_lin1", sd, f"{key}.mlp.lin1")
        _layer(out, f"{dst}.mlp_lin2", sd, f"{key}.mlp.lin2")
    attention("decoder.final_attn", f"{t}final_attn_token_to_image")
    _layer(out, "decoder.norm_final", sd, f"{t}norm_final_attn")
    # both are ConvTranspose2d [I, O, kh, kw]: the JAX converter flips their
    # taps for flax and convert_jax flips them back, so they stay as they are
    for name, i in (("upscale_conv1", 0), ("upscale_ln", 1), ("upscale_conv2", 3)):
        _layer(out, f"decoder.{name}", sd, f"{d}output_upscaling.{i}")
    for i in range(3):
        _layer(out, f"decoder.iou_head.lin{i}", sd, f"{d}iou_prediction_head.layers.{i}")
        for h in range(4):
            _layer(out, f"decoder.hyper_{h}.lin{i}", sd,
                   f"{d}output_hypernetworks_mlps.{h}.layers.{i}")
    out["extra.pe_gaussian"] = _t(
        sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"])
    # box corners use point embeddings 2 and 3 (SAM's _embed_boxes)
    out["extra.box_embed"] = torch.stack(
        [_t(sd[f"prompt_encoder.point_embeddings.{i}.weight"])[0] for i in (2, 3)])
    return out


def load_torch_state_dict(path: str) -> dict:
    """A checkpoint file's state dict: a Lightning file's 'state_dict', else
    the object itself.  The reference's files hold more than tensors
    (Lightning's callbacks and hyperparameters), so this unpickles them in
    full: load only files from a source you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        return obj["state_dict"]
    return obj


# --------------------------------------------------------------------------
# LoFTR (indoor_ds_new.ckpt)
# --------------------------------------------------------------------------


def convert_loftr(sd) -> dict:
    """The state dict of ``elevation.loftr.LoFTRModules`` from
    indoor_ds_new.ckpt's.  Keys may carry Lightning's 'matcher.' prefix
    (the reference strips it, loftr.py:78-82); a prefixed key wins over the
    same key without it."""
    sd = {**{k: v for k, v in sd.items() if not k.startswith(_MATCHER)},
          **{k[len(_MATCHER):]: v for k, v in sd.items() if k.startswith(_MATCHER)}}
    out: dict = {}

    def conv(dst, key):
        _layer(out, dst, sd, key, bias=False)

    conv("backbone.conv1", "backbone.conv1")
    _bn(out, "backbone.bn1", sd, "backbone.bn1")
    for layer in (1, 2, 3):
        for blk in (0, 1):
            dst, key = f"backbone.layer{layer}_{blk}", f"backbone.layer{layer}.{blk}"
            conv(f"{dst}.conv1", f"{key}.conv1")
            conv(f"{dst}.conv2", f"{key}.conv2")
            _bn(out, f"{dst}.bn1", sd, f"{key}.bn1")
            _bn(out, f"{dst}.bn2", sd, f"{key}.bn2")
            if f"{key}.downsample.0.weight" in sd:
                conv(f"{dst}.down_conv", f"{key}.downsample.0")
                _bn(out, f"{dst}.down_bn", sd, f"{key}.downsample.1")
    conv("backbone.layer3_outconv", "backbone.layer3_outconv")
    for layer in (2, 1):
        b = f"backbone.layer{layer}_outconv"
        conv(b, b)
        conv(f"{b}2_0", f"{b}2.0")
        _bn(out, f"{b}2_bn", sd, f"{b}2.1")
        conv(f"{b}2_1", f"{b}2.3")

    def encoder_layer(dst, key):
        for name in ("q_proj", "k_proj", "v_proj", "merge"):
            _layer(out, f"{dst}.{name}", sd, f"{key}.{name}", bias=False)
        _layer(out, f"{dst}.mlp0", sd, f"{key}.mlp.0", bias=False)
        _layer(out, f"{dst}.mlp2", sd, f"{key}.mlp.2", bias=False)
        _layer(out, f"{dst}.norm1", sd, f"{key}.norm1")
        _layer(out, f"{dst}.norm2", sd, f"{key}.norm2")

    # layer_names = ['self', 'cross'] * 4: layers[2i] = self_i, layers[2i+1] = cross_i
    for i in range(4):
        encoder_layer(f"coarse_tf.self_{i}", f"loftr_coarse.layers.{2 * i}")
        encoder_layer(f"coarse_tf.cross_{i}", f"loftr_coarse.layers.{2 * i + 1}")
    encoder_layer("fine_tf.self_0", "loftr_fine.layers.0")
    encoder_layer("fine_tf.cross_0", "loftr_fine.layers.1")
    for name in ("down_proj", "merge_feat"):
        _layer(out, name, sd, f"fine_preprocess.{name}")
    return out


# --------------------------------------------------------------------------
# Reconstruction (ckpt_215000.pth: a dict of per-network state dicts,
# exp_runner_generic_blender_val.py:485-512 save format)
# --------------------------------------------------------------------------


def _convbn(out: dict, dst: str, sd, key_conv: str, key_bn: str):
    """ConvBnAct (Conv_0 + BatchNorm_0) from a conv and an InPlaceABN.

    InPlaceABN's effective scale is ``|gamma| + eps`` (mapillary's
    implementation keeps gamma away from zero so that the in-place op stays
    invertible): that is the BN weight."""
    out[f"{dst}.Conv_0.weight"] = _t(sd[f"{key_conv}.weight"])
    _bn(out, f"{dst}.BatchNorm_0", sd, key_bn)
    out[f"{dst}.BatchNorm_0.weight"] = out[f"{dst}.BatchNorm_0.weight"].abs() + _INPLACE_ABN_EPS


def _sparse_conv3d(sd, key: str, transposed: bool = False) -> torch.Tensor:
    """A torchsparse ``spnn.Conv3d`` kernel [K, I, O] -> a Conv3d weight
    (O, I, kx, ky, kz).

    torchsparse 1.4's ``get_kernel_offsets`` enumerates the K = k^3 offsets
    with x varying fastest, so ``reshape(k, k, k)`` gives the axes (z, y, x),
    which are reversed.  A transposed conv also flips all
    three spatial axes: torchsparse's deconv scatters ``out[p + offset_k] +=
    in[p] @ W[k]``, the port's is a zero-upsample and a forward
    cross-correlation (recon/costreg.py).  A 1x1x1 kernel is stored as
    [I, O]."""
    w = _t(sd[f"{key}.kernel"] if f"{key}.kernel" in sd else sd[f"{key}.weight"])
    if w.dim() == 2:
        return w.T[:, :, None, None, None].contiguous()
    K, ci, co = w.shape
    k = round(K ** (1 / 3))
    w = w.reshape(k, k, k, ci, co).permute(2, 1, 0, 3, 4)
    if transposed:
        w = w.flip(0, 1, 2)
    return w.permute(4, 3, 0, 1, 2).contiguous()


def _wn_dense(out: dict, dst: str, sd, key: str):
    """A torch weight_norm Linear -> 'v' [in, out], 'g' [out] and 'bias'."""
    out[f"{dst}.v"] = _t(sd[f"{key}.weight_v"]).T.contiguous()
    out[f"{dst}.g"] = _t(sd[f"{key}.weight_g"])[:, 0]
    out[f"{dst}.bias"] = _t(sd[f"{key}.bias"])


def convert_recon(ckpt: dict, num_sdf_layers: int = 4) -> dict:
    """The state dicts of ``recon.pipeline.ReconStage`` from ckpt_215000.pth.

    ``ckpt`` holds the state dicts sdf_network_lod0, rendering_network_lod0,
    variance_network_lod0 and pyramid_feature_network_lod0.  A checkpoint
    trained with num_lods=2 (exp_runner load/save at val.py:435-512) also
    holds the '*_lod1' groups, which become 'fusion_lod1', 'sdf_lod1',
    'render_lod1' and 'variance_lod1'."""
    out = _convert_recon_lod(ckpt, "lod0", num_sdf_layers)
    if "sdf_network_lod1" in ckpt:
        lod1 = _convert_recon_lod(ckpt, "lod1", num_sdf_layers)
        out.update({f"{k}_lod1": v for k, v in lod1.items()})
    return out


def _convert_recon_lod(ckpt: dict, lod: str, num_sdf_layers: int) -> dict:
    """One lod's four network groups -> {fusion, sdf, render, variance}."""
    # FeatureNet's FPN (pyramid_feature_network_<lod>)
    fp = ckpt[f"pyramid_feature_network_{lod}"]
    fusion: dict = {}
    n = 0
    for conv_key, count in (("conv0", 2), ("conv1", 3), ("conv2", 3)):
        for i in range(count):
            _convbn(fusion, f"fpn.ConvBnAct_{n}", fp, f"{conv_key}.{i}.conv", f"{conv_key}.{i}.bn")
            n += 1
    for name in ("toplayer", "lat1", "lat0", "smooth1", "smooth0"):
        _layer(fusion, f"fpn.{name}", fp, name)

    # SdfVolumeNetwork (sdf_network_<lod>): the compress layer, the sparse
    # cost-regularisation net (conv0-conv6, deconvs conv7/9/11), the SDF MLP
    sd = ckpt[f"sdf_network_{lod}"]
    sdf: dict = {}
    _convbn(sdf, "compress", sd, "compress_layer.conv", "compress_layer.bn")
    blocks = [(f"_MConvBnRelu_{i}", f"conv{i}", False) for i in range(7)]
    blocks += [(f"_MDeconvBnRelu_{i}", f"conv{c}", True) for i, c in enumerate((7, 9, 11))]
    for dst, name, transposed in blocks:
        key = f"sparse_costreg_net.{name}.net"
        sdf[f"costreg.{dst}.Conv_0.weight"] = _sparse_conv3d(sd, f"{key}.0", transposed)
        _bn(sdf, f"costreg.{dst}.MaskedBatchNorm_0", sd, f"{key}.1")
    for i in range(num_sdf_layers - 1):
        _wn_dense(sdf, f"sdf_layer.lin{i}", sd, f"sdf_layer.lin{i}")

    # GeneralRenderingNetwork (rendering_network_<lod>)
    rn = ckpt[f"rendering_network_{lod}"]
    render = {"s": _t(rn["s"]).reshape(())}
    for dst, key in (("ray_dir_fc0", "ray_dir_fc.0"), ("ray_dir_fc1", "ray_dir_fc.2"),
                     ("base_fc0", "base_fc.0"), ("base_fc1", "base_fc.2"),
                     ("vis_fc0", "vis_fc.0"), ("vis_fc1", "vis_fc.2"),
                     ("vis_fc2_0", "vis_fc2.0"), ("vis_fc2_1", "vis_fc2.2"),
                     ("rgb_fc0", "rgb_fc.0"), ("rgb_fc1", "rgb_fc.2"), ("rgb_fc2", "rgb_fc.4")):
        _layer(render, dst, rn, key)

    variance = {"variance": _t(ckpt[f"variance_network_{lod}"]["variance"]).reshape(())}
    return {"fusion": fusion, "sdf": sdf, "render": render, "variance": variance}
