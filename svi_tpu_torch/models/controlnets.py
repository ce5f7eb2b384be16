"""ControlNets for the SD 1.5 and SDXL UNets, port of
svi_tpu/models/controlnets.py: `sd_controlnet_forward` (the UNet's down and
mid path with a conv conditioning stack and 13 1x1 output convs, whose
residuals enter the UNet after plan entry 30), `sdxl_controlnet_forward`
(ControlNet Union: the SDXL UNet's down and mid path, the condition fused
into the input through task embeddings and a 2-token attention block, a
control-type embedding, 10 output convs entering after plan entry 22), the
config units, the annotators and `MultiControlNetManager`.

The annotators that run a detector (canny, depth, softedge, lineart,
openpose, normal) need the `controlnet_aux` package and its checkpoints and
raise ImportError without it, as the JAX package's do; tile / none /
inpaint pass the frame through. Frames are (H, W, 3) uint8 arrays (a PIL
image is read through np.asarray).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .params import ParamTree, dense
from .sdxl import SDXL_UNET_PLAN, add_embedding
from .sd import (
    SD_UNET_PLAN,
    StateDictMaker,
    _attention_block,
    _layer_norm,
    _block_from,
    _conv2d,
    _Reader,
    _resnet_block,
    _timesteps,
    timestep_embedding,
    sd_params_from_jax,
    unet_time_dim,
)

# the UNet's down path and mid block, then a final push
SD_CONTROLNET_PLAN = SD_UNET_PLAN[:28] + [
    ("res", 1280, 1280), ("attn", 8, 160, 1280), ("res", 1280, 1280), ("push",)
]
SDXL_CONTROLNET_PLAN = SDXL_UNET_PLAN[:20] + [
    ("res", 1280, 1280), ("attn", 20, 64, 1280), ("res", 1280, 1280), ("push",)
]
# the conditioning stack's widths: 3 -> 16 -> 32 -> 96 -> 256 -> the first level's
CONDITIONING_CHANNELS = (16, 32, 96, 256)
# ControlNet Union's task ids by annotator, and its fusing block's heads
SDXL_CONTROLNET_TASK_IDS = {
    "openpose": 0, "depth": 1, "softedge": 2, "canny": 3, "lineart": 3,
    "lineart_anime": 3, "tile": 6, "inpaint": 7,
}
SDXL_CONTROLNET_FUSE_HEADS = 8


class ControlNetConfigUnit:
    def __init__(self, processor_id, model_path=None, scale=1.0, skip_processor=False):
        self.processor_id = processor_id
        self.model_path = model_path
        self.scale = scale
        self.skip_processor = skip_processor


class Annotator:
    """A condition frame's preprocessor: tile / none / inpaint pass the frame
    through; the detectors need controlnet_aux."""

    PASSTHROUGH = ("tile", "none", "inpaint")
    DETECTORS = ("canny", "depth", "softedge", "lineart", "lineart_anime", "openpose", "normal")

    def __init__(self, processor_id, model_path="models/Annotators", detect_resolution=None,
                 device=None, skip_processor=False):
        if processor_id not in self.PASSTHROUGH + self.DETECTORS:
            raise ValueError(f"Unsupported processor_id: {processor_id}")
        self.processor_id = processor_id
        self.detect_resolution = detect_resolution
        self.processor = None
        if not skip_processor and processor_id in self.DETECTORS:
            try:
                import controlnet_aux.processor as cap
            except ImportError as e:
                raise ImportError(
                    f"controlnet_aux is required for the '{processor_id}' annotator "
                    "(host-side preprocessing; pass skip_processor=True to feed "
                    "pre-annotated frames)") from e
            ctor = {"canny": lambda: cap.CannyDetector(),
                    "depth": lambda: cap.MidasDetector.from_pretrained(model_path),
                    "softedge": lambda: cap.HEDdetector.from_pretrained(model_path),
                    "lineart": lambda: cap.LineartDetector.from_pretrained(model_path),
                    "lineart_anime": lambda: cap.LineartAnimeDetector.from_pretrained(model_path),
                    "openpose": lambda: cap.OpenposeDetector.from_pretrained(model_path),
                    "normal": lambda: cap.NormalBaeDetector.from_pretrained(model_path)}
            self.processor = ctor[processor_id]()

    def __call__(self, image, mask=None) -> np.ndarray:
        """(H, W, 3) uint8 -> the annotated frame at the same size."""
        image = np.asarray(image)
        if self.processor is None:
            return image
        from PIL import Image

        height, width = image.shape[:2]
        kwargs = ({"include_body": True, "include_hand": True, "include_face": True}
                  if self.processor_id == "openpose" else {})
        detect_resolution = self.detect_resolution or min(width, height)
        out = self.processor(Image.fromarray(image), detect_resolution=detect_resolution,
                             image_resolution=min(width, height), **kwargs)
        return np.asarray(out.resize((width, height)))


def _conditioning_layer(p, x):
    """The conv-silu chain that brings the condition image down by 8."""
    x = F.silu(_conv2d(p["0"], x))
    for i in range(3):
        x = F.silu(_conv2d(p[f"{2 + i * 4}"], x))
        x = F.silu(_conv2d(p[f"{4 + i * 4}"], x, stride=2))
    return _conv2d(p["14"], x)


def sd_controlnet_forward(params, sample, timestep, encoder_hidden_states, conditioning,
                          global_pool=False, tiled=False, tile_size=64, tile_stride=32):
    """sample (B, 4, h, w) latents, conditioning (B, 3, 8h, 8w) in [0, 1];
    returns the 13 NCHW residuals for `sd.sd_unet_forward(controlnet_res=)`."""
    x = sample
    t = timestep_embedding(_timesteps(timestep, x.device), 320).to(x.dtype)
    t = dense(params["time_embedding"]["2"], F.silu(dense(params["time_embedding"]["0"], t)))
    t = t.expand(x.shape[0], t.shape[-1])
    x = _conv2d(params["conv_in"], x) + _conditioning_layer(params["controlnet_conv_in"],
                                                            conditioning.to(x.dtype))
    res_stack = _down_mid(SD_CONTROLNET_PLAN, params["blocks"], x, t, encoder_hidden_states,
                          tiled, tile_size, tile_stride)
    return _outputs(params, res_stack, global_pool)


def _down_mid(plan, blocks, x, temb, encoder_hidden_states, tiled, tile_size, tile_stride):
    """A ControlNet's copy of the UNet's down and mid path: the stream after
    each push, the input first."""
    res_stack = [x]
    for desc, p in zip(plan, blocks):
        if desc[0] == "res":
            x = _resnet_block(p, x, temb)
        elif desc[0] == "attn":
            x = _attention_block(p, x, temb, encoder_hidden_states, desc[1], desc[2], tiled=tiled,
                                 tile_size=tile_size, tile_stride=tile_stride)
        elif desc[0] == "push":
            res_stack.append(x)
        elif desc[0] == "down":
            x = _conv2d(p["conv"], x, stride=2, padding=desc[2])
    return res_stack


def _outputs(params, res_stack, global_pool):
    out = [_conv2d(cp, r, padding=0) for cp, r in zip(params["controlnet_blocks"], res_stack)]
    if global_pool:
        out = [r.mean(dim=(2, 3), keepdim=True) for r in out]
    return out


def _residual_attention_block(p, x, num_heads=SDXL_CONTROLNET_FUSE_HEADS):
    """CLIP-style attention (a fused in-projection, f32 softmax) and a
    quickGELU MLP on (B, S, D)."""
    b, s, d = x.shape
    hd = d // num_heads
    q, k, v = (t.reshape(b, s, num_heads, hd).transpose(1, 2) for t in
               dense(p["in_proj"], _layer_norm(p["ln_1"], x)).chunk(3, dim=-1))
    logits = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
    o = (torch.softmax(logits, dim=-1).to(v.dtype) @ v).transpose(1, 2).reshape(b, s, d)
    x = x + dense(p["out_proj"], o)
    y = dense(p["c_fc"], _layer_norm(p["ln_2"], x))
    y = y * torch.sigmoid(1.702 * y.float()).to(y.dtype)
    return x + dense(p["c_proj"], y)


def sdxl_controlnet_forward(params, sample, timestep, encoder_hidden_states, conditioning,
                            processor_id, add_time_id, add_text_embeds, global_pool=False,
                            tiled=False, tile_size=64, tile_stride=32):
    """ControlNet Union: sample (B, 4, h, w), conditioning (B, 3, 8h, 8w) in
    [0, 1], the annotator's task; returns the 10 NCHW residuals for
    `sdxl.sdxl_unet_forward(controlnet_res=)`."""
    task_id = SDXL_CONTROLNET_TASK_IDS[processor_id]
    x = sample
    b, dt = x.shape[0], x.dtype
    t = timestep_embedding(_timesteps(timestep, x.device), 320).to(dt)
    t = dense(params["time_embedding"]["2"], F.silu(dense(params["time_embedding"]["0"], t)))
    add = add_embedding(params["add_time_embedding"], add_time_id, add_text_embeds, dt)
    control_type = torch.zeros((b, 8), dtype=dt, device=x.device)
    control_type[:, task_id] = 1
    control = timestep_embedding(control_type.reshape(-1), 256).reshape(b, -1).to(dt)
    control = dense(params["control_type_embedding"]["2"],
                    F.silu(dense(params["control_type_embedding"]["0"], control)))
    temb = t + add + control
    x = _conv2d(params["conv_in"], x)
    # the condition fused into the input through the task's token
    ccond = _conditioning_layer(params["controlnet_conv_in"], conditioning.to(dt))
    feat_seq = ccond.mean(dim=(2, 3)) + params["task_embedding"][task_id].to(dt)
    seq = _residual_attention_block(params["controlnet_transformer"],
                                    torch.stack([feat_seq, x.mean(dim=(2, 3))], 1))
    alpha = dense(params["spatial_ch_projs"], seq[:, 0])[:, :, None, None]
    x = x + (ccond + alpha)
    res_stack = _down_mid(SDXL_CONTROLNET_PLAN, params["blocks"], x, temb,
                          encoder_hidden_states, tiled, tile_size, tile_stride)
    return _outputs(params, res_stack, global_pool)


class MultiControlNetManager:
    """Runs each unit's model and sums the scaled residual stacks. Units:
    (forward_fn, params, scale); processors: Annotators aligned with them."""

    def __init__(self, units=(), processors=None):
        self.units = list(units)
        self.processors = list(processors) if processors else None

    def process_image(self, image, processor_id=None) -> np.ndarray:
        """A frame -> (num_units, 3, H, W) float32 conditioning in [0, 1]."""
        procs = self.processors if processor_id is None else [self.processors[processor_id]]
        return np.stack([np.asarray(proc(image), np.float32).transpose(2, 0, 1) / 255.0
                         for proc in procs], axis=0)

    def __call__(self, sample, timestep, encoder_hidden_states, conditionings, **kwargs):
        total = None
        for unit, conditioning in zip(self.units, conditionings):
            fn, params, scale = unit[0], unit[1], unit[2]
            res = [r * scale for r in fn(params, sample, timestep, encoder_hidden_states,
                                         conditioning, **kwargs)]
            total = res if total is None else [a + b for a, b in zip(total, res)]
        return total


# ---------------------------------------------------------------------------
# checkpoints (diffsynth naming), the JAX pytree, seeded weights
# ---------------------------------------------------------------------------


def sd_controlnet_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> ParamTree:
    r = _Reader(sd, device, dtype)
    n_out = 0
    while f"controlnet_blocks.{n_out}.weight" in r:
        n_out += 1

    def out_conv(i):
        w = r.t(f"controlnet_blocks.{i}.weight")
        b = r.t(f"controlnet_blocks.{i}.bias") if f"controlnet_blocks.{i}.bias" in r \
            else torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)
        return {"w": w, "b": b}

    return ParamTree({
        "time_embedding": {"0": r.lin("time_embedding.0"), "2": r.lin("time_embedding.2")},
        "conv_in": r.conv("conv_in"),
        "controlnet_conv_in": {str(i): r.conv(f"controlnet_conv_in.blocks.{i}")
                               for i in (0, 2, 4, 6, 8, 10, 12, 14)},
        "blocks": [_block_from(r, i, d) for i, d in enumerate(SD_CONTROLNET_PLAN)],
        "controlnet_blocks": [out_conv(i) for i in range(n_out)],
    })


def sdxl_controlnet_params_from_torch(sd: dict, device="cuda",
                                      dtype=torch.float32) -> ParamTree:
    """ControlNet Union's state dict in the reference's naming."""
    r = _Reader(sd, device, dtype)
    n_out = 0
    while f"controlnet_blocks.{n_out}.weight" in r:
        n_out += 1
    mlp = lambda name: {"0": r.lin(f"{name}.0"), "2": r.lin(f"{name}.2")}
    tf = "controlnet_transformer"
    return ParamTree({
        "time_embedding": mlp("time_embedding"),
        "add_time_embedding": mlp("add_time_embedding"),
        "control_type_embedding": mlp("control_type_embedding"),
        "conv_in": r.conv("conv_in"),
        "controlnet_conv_in": {str(i): r.conv(f"controlnet_conv_in.blocks.{i}")
                               for i in (0, 2, 4, 6, 8, 10, 12, 14)},
        "controlnet_transformer": {
            "in_proj": {"w": r.t(f"{tf}.attn.in_proj_weight"),
                        "b": r.t(f"{tf}.attn.in_proj_bias")},
            "out_proj": r.lin(f"{tf}.attn.out_proj"), "ln_1": r.norm(f"{tf}.ln_1"),
            "c_fc": r.lin(f"{tf}.mlp.c_fc"), "c_proj": r.lin(f"{tf}.mlp.c_proj"),
            "ln_2": r.norm(f"{tf}.ln_2")},
        "task_embedding": r.t("task_embedding"),
        "spatial_ch_projs": r.lin("spatial_ch_projs"),
        "blocks": [_block_from(r, i, d) for i, d in enumerate(SDXL_CONTROLNET_PLAN)],
        "controlnet_blocks": [r.conv(f"controlnet_blocks.{i}") for i in range(n_out)],
    })


def sd_controlnet_params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> ParamTree:
    return sd_params_from_jax(params, dtype, device)


def sd_controlnet_state_dict(seed=0, device="cpu", dtype=torch.float32, text_dim=768,
                             conditioning_channels=CONDITIONING_CHANNELS) -> dict:
    """Seeded random SD 1.5 ControlNet weights at `SD_CONTROLNET_PLAN`'s
    widths (the output convs as the zero convs a training run moved away
    from zero: random, like the rest)."""
    plan, m = SD_CONTROLNET_PLAN, StateDictMaker(seed, device, dtype)
    c0, temb = plan[0][1], unet_time_dim(plan)
    m.lin("time_embedding.0", temb, 320)
    m.lin("time_embedding.2", temb, temb)
    m.conv("conv_in", c0, 4)
    _conditioning_state(m, c0, conditioning_channels)
    m.plan_blocks(plan, temb, text_dim)
    _output_convs(m, plan)
    return m.sd


def _conditioning_state(m, c0, conditioning_channels):
    c1, c2, c3, c4 = conditioning_channels
    cond = [(0, c1, 3), (2, c1, c1), (4, c2, c1), (6, c2, c2), (8, c3, c2), (10, c3, c3),
            (12, c4, c3), (14, c0, c4)]
    for i, cout, cin in cond:
        m.conv(f"controlnet_conv_in.blocks.{i}", cout, cin)


def _output_convs(m, plan):
    from .motion import plan_channels

    chans = plan_channels(plan)
    outs = [plan[0][1]] + [chans[i] for i, d in enumerate(plan) if d[0] == "push"]
    for i, c in enumerate(outs):
        m.conv(f"controlnet_blocks.{i}", c, c, k=1)


def sdxl_controlnet_state_dict(seed=0, device="cpu", dtype=torch.float32, text_dim=2048,
                               pooled_dim=1280, conditioning_channels=CONDITIONING_CHANNELS,
                               depth=None) -> dict:
    """Seeded random ControlNet Union (SDXL) weights at
    `SDXL_CONTROLNET_PLAN`'s widths; depth: transformer layers per attention
    block (the UNet's, `sdxl.SDXL_TRANSFORMER_DEPTH`)."""
    from .sdxl import SDXL_TRANSFORMER_DEPTH

    plan, m = SDXL_CONTROLNET_PLAN, StateDictMaker(seed, device, dtype)
    c0, temb = plan[0][1], unet_time_dim(plan)
    m.lin("time_embedding.0", temb, 320)
    m.lin("time_embedding.2", temb, temb)
    m.lin("add_time_embedding.0", temb, pooled_dim + 6 * 256)
    m.lin("add_time_embedding.2", temb, temb)
    m.lin("control_type_embedding.0", temb, 8 * 256)
    m.lin("control_type_embedding.2", temb, temb)
    m.conv("conv_in", c0, 4)
    _conditioning_state(m, c0, conditioning_channels)
    tf = "controlnet_transformer"
    m.lin(f"{tf}.attn.in_proj", 3 * c0, c0)
    m.sd[f"{tf}.attn.in_proj_weight"] = m.sd.pop(f"{tf}.attn.in_proj.weight")
    m.sd[f"{tf}.attn.in_proj_bias"] = m.sd.pop(f"{tf}.attn.in_proj.bias")
    m.lin(f"{tf}.attn.out_proj", c0, c0)
    m.norm(f"{tf}.ln_1", c0)
    m.lin(f"{tf}.mlp.c_fc", 4 * c0, c0)
    m.lin(f"{tf}.mlp.c_proj", c0, 4 * c0)
    m.norm(f"{tf}.ln_2", c0)
    m.sd["task_embedding"] = m.randn((8, c0), 0.02)
    m.lin("spatial_ch_projs", c0, c0)
    m.plan_blocks(plan, temb, text_dim, SDXL_TRANSFORMER_DEPTH if depth is None else depth)
    _output_convs(m, plan)
    return m.sd
