"""The port's parallel inference (svi_tpu_torch.parallel) against svi_tpu's
on the CPU: the port's ranks are gloo processes (tests/torch_parallel_ranks.py),
the JAX package runs on conftest.py's 8 virtual devices, and both get the
same numpy-seeded f32 weights and inputs.

  * forward_sp on meshes (1, 4), (2, 2), (1, 3) and (1, 8), on token counts
    the sp size does not divide (padded, masked by kv_len, dropped after the
    head), with LoRA, the I2V branch, the multitalk and customtalk audio
    branches and the pose tokens; the ring against the all-gather path,
    including 9 tokens over 8 ranks, where whole ring blocks are padding;
  * forward_tp in f32, w8a8 and int8, each rank holding its slice of the
    blocks, and the packed-int4 refusal;
  * forward_tpsp with and without the ring, the audio variants included;
  * the use_usp pipeline on 2 ranks against the single-device pipeline and
    the JAX pipeline over 2 devices.

Tolerance: the sharded forwards sum in other orders than one device (the
gathered keys, the psums, the ring's logsumexp merge); the JAX package holds
its own sharded forwards to 3e-4 of its single-device ones (tests/
test_sequence_parallel.py, test_tensor_parallel.py), and so do these
against the JAX package and the port's single-device forward (measured:
below 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import clip_vision as jclip
from svi_tpu.models import wan_dit as jdit
from svi_tpu.models import wan_vae as jvae
from svi_tpu.parallel.mesh import make_mesh as jmesh
from svi_tpu.parallel.sequence_parallel import forward_sp as jforward_sp
from svi_tpu.parallel.tensor_parallel import forward_tp as jforward_tp
from svi_tpu.parallel.tensor_parallel import shard_dit_params_tp as jshard_tp
from svi_tpu.parallel.tp_sp import forward_tpsp as jforward_tpsp
from svi_tpu.parallel.tp_sp import make_mesh3 as jmesh3
from svi_tpu.parallel.tp_sp import shard_dit_params_tpsp as jshard_tpsp
from svi_tpu.pipelines.svi_video import SVIVideoPipeline as JaxPipeline
from svi_tpu.training import lora as jlora
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.training import lora as tlora
import torch_parallel_ranks as ranks

TOL = 3e-4
BASE = dict(dim=64, in_dim=16, ffn_dim=128, out_dim=16, text_dim=48, freq_dim=32,
            num_layers=2)
I2V = dict(BASE, in_dim=36, has_image_input=True, clip_feature_dim=40)
AUDIO = dict(I2V, audio_hidden_dim=24, audio_context_tokens=8)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _params(cfg_kw, seed=0):
    return jdit.init_params(jax.random.PRNGKey(seed), jdit.WanDiTConfig(dtype=jnp.float32,
                                                                       **cfg_kw))


def _inputs(cfg_kw, b, f, h, w, seed, audio=False, pose=False):
    """Latents of f x h/2 x w/2 tokens; the I2V, audio and pose inputs as the
    configuration takes them."""
    rng = np.random.default_rng(seed)
    inp = dict(x=rng.standard_normal((b, 16, f, h, w)).astype(np.float32),
               t=np.full((b,), 333.0, np.float32),
               ctx=rng.standard_normal((b, 9, 48)).astype(np.float32))
    if cfg_kw.get("has_image_input"):
        inp["clip"] = rng.standard_normal((b, 257, 40)).astype(np.float32)
        inp["y"] = rng.standard_normal((b, 20, f, h, w)).astype(np.float32)
    if audio:
        ad = cfg_kw["audio_hidden_dim"]
        inp["audio"] = (rng.standard_normal((b, 1, 5, 12, ad)).astype(np.float32),
                        rng.standard_normal((b, f - 1, 8, 12, ad)).astype(np.float32))
    if pose:
        inp["cond"] = rng.standard_normal((b, f * h * w // 4, 64)).astype(np.float32)
    return inp


def _jax_kwargs(inp):
    kw = dict(clip_feature=inp.get("clip"), y=inp.get("y"), add_condition=inp.get("cond"))
    if inp.get("audio") is not None:
        kw["audio_embed_tuple"] = inp["audio"]
    return kw


def _port_single(params, cfg_kw, inp, lora=None):
    dit = tdit.params_from_jax(_host(params), tdit.WanDiTConfig(dtype=torch.float32, **cfg_kw))
    t = {k: None if v is None else (tuple(map(torch.from_numpy, v)) if isinstance(v, tuple)
                                     else torch.from_numpy(v)) for k, v in inp.items()}
    kw = dict(lora=None if lora is None else tlora.params_from_jax(_host(lora), device="cpu"), lora_scale=0.5)
    with torch.no_grad():
        return dit(t["x"], t["t"], t["ctx"], t.get("clip"), t.get("y"), t.get("cond"),
                   audio_embed_tuple=t.get("audio"), **kw).numpy()


def _jax_sharded(kind, params, cfg_kw, inp, mesh_shape, lora=None, ring=False):
    """JAX's sharded forward of the case, jitted as its own tests run it."""
    cfg = jdit.WanDiTConfig(dtype=jnp.float32, **cfg_kw)
    devices = jax.devices()[:int(np.prod(mesh_shape))]
    kw = _jax_kwargs(inp)
    if kind == "sp":
        mesh = jmesh(*mesh_shape, devices=devices)
        forward = jforward_sp
        kw["ring"] = ring
        if lora is not None:
            kw.update(lora=lora, lora_scale=0.5)
    elif kind == "tp":
        mesh = jmesh(*mesh_shape, devices=devices)
        params, forward = jshard_tp(params, cfg, mesh), jforward_tp
    else:
        mesh = jmesh3(*mesh_shape, devices=devices)
        params, forward = jshard_tpsp(params, cfg, mesh), jforward_tpsp
        kw["ring"] = ring
    static = {k: v for k, v in kw.items() if k == "ring"}
    arrays = {k: v for k, v in kw.items() if k != "ring"}

    def fn(p, x, t, c, arrays):
        return forward(p, cfg, x, t, c, mesh=mesh, **static, **arrays)

    return np.asarray(jax.jit(fn)(params, inp["x"], inp["t"], inp["ctx"], arrays))


def _case(name, kind, cfg_kw, mesh, inp, heads=2, seed=0, lora=False, ring=False,
          quantize=None, jax_ref=True):
    cfg_kw = dict(cfg_kw, num_heads=heads)
    params = _params(cfg_kw, seed)
    if quantize:
        params = getattr(jdit, f"quantize_params_{quantize}")(params, min_size=1024)
    lora_tree = None
    if lora:
        lora_tree = jax.tree.map(lambda v: v + 0.02, jlora.init_lora_params(
            jax.random.PRNGKey(1), jdit.WanDiTConfig(dtype=jnp.float32, **cfg_kw), rank=4))
    case = dict(name=name, kind=kind, cfg=cfg_kw, params=_host(params), inputs=inp,
                mesh=mesh, kw=dict(ring=ring) if kind != "tp" else {},
                lora=None if lora_tree is None else _host(lora_tree))
    if kind == "sp" and lora:
        case["kw"]["lora_scale"] = 0.5
    refs = dict(single_port=_port_single(params, cfg_kw, inp, lora_tree))
    if jax_ref:
        refs["jax"] = _jax_sharded(kind, params, cfg_kw, inp, mesh, lora_tree, ring)
    return case, refs


# token counts the sp size does not divide: 3 x 2 x 5 = 30 over 4 and 2
# (the (1, 2, 2) meshes take 3 x 3 x 5 = 45), 1 x 2 x 5 = 10 over 3, 60 and 9
# over 8; the tensor-parallel meshes run 72 tokens. Each ring case has the
# inputs of the all-gather case of its name.
def _four_rank_cases():
    flat = _inputs(BASE, 1, 3, 4, 10, 0)
    i2v = _inputs(I2V, 2, 3, 4, 10, 2)
    c = [_case("sp_1x4", "sp", BASE, (1, 4), flat),
         _case("ring_1x4", "sp", BASE, (1, 4), flat, ring=True),
         _case("sp_2x2_i2v_lora", "sp", I2V, (2, 2), i2v, seed=2, lora=True),
         _case("ring_2x2_i2v_lora", "sp", I2V, (2, 2), i2v, seed=2, lora=True, ring=True),
         _case("sp_1x4_pose", "sp", BASE, (1, 4), _inputs(BASE, 1, 3, 4, 10, 6, pose=True))]
    for variant in ("multitalk", "customtalk"):
        kw = dict(AUDIO, **{f"enable_{variant}": True})
        c.append(_case(f"sp_1x4_{variant}", "sp", kw, (1, 4),
                       _inputs(kw, 2, 3, 4, 10, 5, audio=True)))
    # tensor parallel: 8 heads over the tensor axis
    tp_in = _inputs(BASE, 1, 3, 8, 12, 7)
    c += [_case("tp_1x4", "tp", BASE, (1, 4), tp_in, heads=8),
          _case("tp_2x2_i2v", "tp", I2V, (2, 2), _inputs(I2V, 2, 3, 8, 12, 8), heads=8),
          _case("tp_1x4_w8a8", "tp", BASE, (1, 4), tp_in, heads=8, quantize="w8a8"),
          _case("tp_1x4_int8", "tp", BASE, (1, 4), tp_in, heads=8, quantize="int8"),
          _case("tp_2x2_int4", "tp", BASE, (2, 2), _inputs(BASE, 2, 3, 8, 12, 11), heads=8,
                quantize="int4", jax_ref=False)]
    for variant in ("multitalk", "customtalk"):
        kw = dict(AUDIO, **{f"enable_{variant}": True})
        c.append(_case(f"tp_2x2_{variant}", "tp", kw, (2, 2),
                       _inputs(kw, 2, 3, 4, 10, 12, audio=True)))
    # tensor x sequence parallel, the audio variants on both paths
    c += [_case("tpsp_1x2x2", "tpsp", BASE, (1, 2, 2), _inputs(BASE, 1, 3, 6, 10, 13),
                heads=8),
          _case("tpsp_1x2x2_ring", "tpsp", I2V, (1, 2, 2), _inputs(I2V, 1, 3, 6, 10, 14),
                heads=8, ring=True)]
    for variant, ring in (("multitalk", False), ("customtalk", True)):
        kw = dict(AUDIO, **{f"enable_{variant}": True})
        c.append(_case(f"tpsp_1x2x2_{variant}", "tpsp", kw, (1, 2, 2),
                       _inputs(kw, 1, 3, 6, 10, 15, audio=True), ring=ring))
    return c


def _odd_rank_cases(world):
    """(1, world) on a padded sequence, all-gather and ring; with 8 ranks
    also 9 tokens, where the ring's last three blocks are padding only."""
    inp = _inputs(BASE, 1, 3, 8, 10, 28) if world == 8 else _inputs(BASE, 1, 1, 4, 10, 23)
    c = [_case(f"sp_1x{world}", "sp", BASE, (1, world), inp),
         _case(f"ring_1x{world}", "sp", BASE, (1, world), inp, ring=True)]
    if world == 8:
        tiny = _inputs(BASE, 1, 1, 2, 18, 30)  # 1 x 1 x 9 = 9 tokens over 8 ranks
        c += [_case("sp_1x8_9tok", "sp", BASE, (1, 8), tiny),
              _case("ring_1x8_9tok", "sp", BASE, (1, 8), tiny, ring=True)]
    return c


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's per-rank outputs and its references, by name."""
    out = {}
    for world, cases in ((4, _four_rank_cases()), (3, _odd_rank_cases(3)),
                         (8, _odd_rank_cases(8))):
        got = ranks.run_ranks(ranks.forwards, world, tmp_path_factory.mktemp(f"w{world}"),
                              [c for c, _ in cases])
        for i, (case, refs) in enumerate(cases):
            out[case["name"]] = ([r[i] for r in got], refs)
    return out


SP_CASES = ["sp_1x4", "sp_2x2_i2v_lora", "sp_1x4_multitalk", "sp_1x4_customtalk",
            "sp_1x4_pose", "sp_1x3", "sp_1x8", "sp_1x8_9tok"]
RING_CASES = ["ring_1x4", "ring_2x2_i2v_lora", "ring_1x3", "ring_1x8", "ring_1x8_9tok"]
TP_CASES = ["tp_1x4", "tp_2x2_i2v", "tp_1x4_int8", "tp_2x2_multitalk", "tp_2x2_customtalk"]
TPSP_CASES = ["tpsp_1x2x2", "tpsp_1x2x2_ring", "tpsp_1x2x2_multitalk", "tpsp_1x2x2_customtalk"]


def _check(per_rank, refs, against=("jax", "single_port")):
    for r, res in enumerate(per_rank):
        assert np.isfinite(res["out"]).all(), r
        for name in against:
            np.testing.assert_allclose(res["out"], refs[name], rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} against {name}")


@pytest.mark.parametrize("name", SP_CASES)
def test_forward_sp_matches_jax_and_single_device(results, name):
    """Every rank returns the global output: JAX's forward_sp's and the
    port's single-device forward's."""
    _check(*results[name])


@pytest.mark.parametrize("name", RING_CASES)
def test_ring_matches_jax_and_all_gather(results, name):
    """The ring (K2 per block, logsumexp merge) against JAX's ring, the
    single-device forward and the all-gather path; where whole blocks are
    padding (9 tokens over 8 ranks) the kernel's masked blocks merge with
    weight 0 and nothing is NaN."""
    per_rank, refs = results[name]
    _check(per_rank, refs)
    gather, _ = results[name.replace("ring", "sp")]
    for a, b in zip(per_rank, gather):
        np.testing.assert_allclose(a["out"], b["out"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", TP_CASES)
def test_forward_tp_matches_jax(results, name):
    _check(*results[name])


# W8A8 rounds activations to int8 on both sides: a value summed in another
# order can land one level apart and move later layers; the bound of
# tests/test_torch_quant.py's single-device W8A8 parity, relative to the
# output's largest value (a wrong scale or slice gives errors of its size)
W8A8_TOL = 5e-3


def test_forward_tp_w8a8_matches_jax(results):
    """W8A8 under TP: the row sites quantize each rank's slice of the
    activations with its own per-token max, as JAX's forward_tp does, so the
    port is held against JAX's TP forward (the single-device W8A8 forward
    differs by that requantization; JAX's own test allows 5e-2 there)."""
    per_rank, refs = results["tp_1x4_w8a8"]
    for res in per_rank:
        err = np.abs(res["out"] - refs["jax"]).max() / np.abs(refs["jax"]).max()
        assert np.isfinite(res["out"]).all() and err < W8A8_TOL, err


def test_tp_ranks_hold_their_slice(results):
    """Each rank holds 1/4 of every sharded leaf: ffn.0 (f/4, d) and its
    bias, ffn.2 (d, f/4) with the bias whole; the blocks a rank holds are
    under a third of the unsharded ones (counterpart of
    test_tensor_parallel.py's addressable-shard check)."""
    per_rank, _ = results["tp_1x4"]
    for res in per_rank:
        assert sorted(res["ffn"]) == [(32,), (32, 64), (64,), (64, 32)]
        assert res["bytes"] < res["full_bytes"] / 3
    per_rank, _ = results["tp_1x4_w8a8"]
    for res in per_rank:  # int8 weights and their per-channel scales, sharded
        assert sorted(res["ffn"]) == [(32,), (32, 1), (32, 64), (64,), (64, 1), (64, 32)]


def test_tp_int4_row_site_raises(results):
    """Packed int4 cannot be row-sharded (half-split nibble layout)."""
    per_rank, _ = results["tp_2x2_int4"]
    for res in per_rank:
        assert "row-sharded" in res["error"]


@pytest.mark.parametrize("name", TPSP_CASES)
def test_forward_tpsp_matches_jax(results, name):
    _check(*results[name])


# ---------------------------------------------------------------------------
# the use_usp pipeline
# ---------------------------------------------------------------------------

Z, H, W, NF = 4, 48, 48, 9  # 3 x 3 x 3 = 27 tokens: padded over 2 ranks
# f32 through 2 DiT steps, the VAE and CLIP, sums in other orders: the
# bounds of tests/test_torch_pipeline.py
LATENT_TOL, FRAME_LEVELS = 1e-3, 2


def test_usp_pipeline_matches_single_device_and_jax(tmp_path):
    """SVIVideoPipeline(use_usp) on 2 ranks: every rank's clip equals the
    single-device pipeline's and the JAX pipeline's over a 2-device sp mesh
    (counterpart of test_sequence_parallel.py's USP denoise test)."""
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    vae_kw = dict(dim=16, z_dim=Z)
    dit_kw = dict(dim=64, in_dim=Z + 4 + Z, ffn_dim=128, out_dim=Z, text_dim=48, freq_dim=32,
                  num_heads=2, num_layers=2, has_image_input=True, clip_feature_dim=40)
    clip_kw = dict(image_size=28, patch_size=14, dim=40, mlp_ratio=2, num_heads=2, num_layers=2)
    jv = jvae.init_params(k1, jvae.WanVAEConfig(dtype=jnp.float32, **vae_kw))
    jd = jdit.init_params(k2, jdit.WanDiTConfig(dtype=jnp.float32, **dit_kw))
    jc = jclip.init_params(k3, jclip.ClipVisionConfig(dtype=jnp.float32, **clip_kw))
    trees = dict(vae=_host(jv), dit=_host(jd), clip=_host(jc), vae_kw=vae_kw, dit_kw=dit_kw,
                 clip_kw=clip_kw)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    ctx = rng.standard_normal((1, 7, 48)).astype(np.float32)
    call = dict(input_image=[img], random_ref_frame=img, seed=3, height=H, width=W,
                num_frames=NF, cfg_scale=5.0, num_inference_steps=2, tiled=False,
                prompt_emb_posi=ctx, prompt_emb_nega=ctx * 0.5, ref_pad_num=-1)

    jpipe = JaxPipeline(torch_dtype=jnp.float32)
    jpipe.vae = (jv, jvae.WanVAEConfig(dtype=jnp.float32, **vae_kw))
    jpipe.dit = (jd, jdit.WanDiTConfig(dtype=jnp.float32, **dit_kw))
    jpipe.image_encoder = (jc, jclip.ClipVisionConfig(dtype=jnp.float32, **clip_kw))
    jpipe.sp_mesh = jmesh(1, 2, devices=jax.devices()[:2])
    jpipe.use_unified_sequence_parallel = True
    j_frames, j_lat = jpipe(**call, return_latents=True)
    single = ranks._pipeline(trees)
    assert isinstance(single, SVIVideoPipeline) and not single.use_unified_sequence_parallel
    s_frames, s_lat = single(**call, return_latents=True)
    s_frames = np.stack([np.asarray(f) for f in s_frames])
    for frames, lat in ranks.run_ranks(ranks.usp_pipeline, 2, tmp_path, trees, call):
        for ref in (np.asarray(j_lat, np.float32), s_lat.float().numpy()):
            np.testing.assert_allclose(lat, ref, atol=LATENT_TOL, rtol=0)
        for ref in (np.stack([np.asarray(f) for f in j_frames]), s_frames):
            assert np.abs(frames.astype(np.int16) - ref.astype(np.int16)).max() <= FRAME_LEVELS
