"""The port's SVI-Dance and SVI-Talk pieces against svi_tpu's, at tiny sizes
on the CPU: the pose embedding, the audio DiT blocks (multitalk, customtalk
with its block-to-block carry, three blocks), `audio_proj_forward` and the
per-frame audio attention alone, the converters both ways and the config
detection, the int4_w4a8 leaves of a multitalk DiT, the audio window
helpers and `load_audio` on data/toy_test/talk/speech.wav, and the dance and
talk pipelines (TeaCache off and on).

Weights come from svi_tpu's `init_params` and are carried across with the
port's `params_from_jax`; inputs from np.random.default_rng(seed). The audio
width is cut to 32 (the published 768 is the wav2vec2 tower's, held in
tests/test_torch_wav2vec2.py); the 12 layers and the 5 / 8 windows stay.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import clip_vision as jclip
from svi_tpu.models import pose_embedding as jpose
from svi_tpu.models import wan_dit as jdit
from svi_tpu.models import wan_vae as jvae
from svi_tpu.pipelines import svi_video as jsv
from svi_tpu.pipelines.svi_video_dance import SVIDanceVideoPipeline as JaxDance
from svi_tpu.pipelines.svi_video_talk import SVITalkVideoPipeline as JaxTalk
from svi_tpu.utils import audio as jaudio
from svi_tpu_torch.models import clip_vision as tclip
from svi_tpu_torch.models import pose_embedding as tpose
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.models import wan_vae as tvae
from svi_tpu_torch.pipelines.svi_video_dance import SVIDanceVideoPipeline as TorchDance
from svi_tpu_torch.pipelines.svi_video_talk import SVITalkVideoPipeline as TorchTalk
from svi_tpu_torch.utils import audio as taudio

SPEECH = Path(__file__).resolve().parent.parent / "data" / "toy_test" / "talk" / "speech.wav"
# f32 forwards through a few layers of matmuls, norms, convs and attention,
# summed in another order by each framework (as tests/test_torch_models.py)
F32_TOL = 1e-4
# the pose stack: 7 f32 convs of at most 16 x 27 terms, relative to the
# largest output
POSE_REL = 1e-5
# bf16: one rounding of each product's output (2^-8 relative) in other places
BF16_TOL = 2e-2
# f32 pipelines through 3 DiT steps, the VAE and CLIP (as tests/test_torch_pipeline.py)
LATENT_TOL = 1e-3
FRAME_LEVELS = 2
AUDIO = dict(audio_hidden_dim=32, audio_context_tokens=4)
DIT_KW = dict(dim=64, in_dim=12, ffn_dim=128, out_dim=4, text_dim=48, freq_dim=32,
              num_heads=2, num_layers=3, has_image_input=True, clip_feature_dim=40, **AUDIO)
Z, H, W, NF, STEPS = 4, 32, 32, 9, 3


def _host(params):
    return jax.tree.map(np.asarray, params)


def _np(x):
    return np.asarray(x, np.float32)


def _dit_kw(variant):
    return dict(DIT_KW, **{f"enable_{variant}": True}) if variant else DIT_KW


@functools.lru_cache(maxsize=None)
def _jax_dit(variant, dtype):
    """svi_tpu's seeded DiT (cached: its init runs op by op)."""
    cfg_j = jdit.WanDiTConfig(dtype=dtype, **_dit_kw(variant))
    return jdit.init_params(jax.random.PRNGKey(0), cfg_j), cfg_j


def _dit(variant, dtype=(jnp.float32, torch.float32)):
    """(svi_tpu's params, its config, the port's WanDiT of the same weights)."""
    params, cfg_j = _jax_dit(variant, dtype[0])
    cfg_t = tdit.WanDiTConfig(dtype=dtype[1], **_dit_kw(variant))
    return params, cfg_j, tdit.params_from_jax(_host(params), cfg_t)


@pytest.fixture
def real_audio_imports(monkeypatch):
    """tests/reference_loader.py puts librosa and pyloudnorm stubs (which
    raise) into sys.modules for the reference's imports, and a test file run
    earlier in this process may have loaded it: hide such a stub, so that
    both packages' load_audio take the branch this machine's own packages
    give."""
    for name in ("librosa", "pyloudnorm"):
        mod = sys.modules.get(name)
        if mod is not None and getattr(mod, "__file__", None) is None:
            monkeypatch.setitem(sys.modules, name, None)


def _audio_windows(rng, b, lt, ad=32):
    return (rng.standard_normal((b, 1, 5, 12, ad)).astype(np.float32),
            rng.standard_normal((b, lt - 1, 8, 12, ad)).astype(np.float32))


# ---------------------------------------------------------------------------
# the pose embedding
# ---------------------------------------------------------------------------


def test_pose_embedding_matches_svi_tpu():
    params = jpose.init_params(jax.random.PRNGKey(1), dim=32)
    model = tpose.params_from_jax(_host(params))
    pose = np.random.default_rng(1).integers(0, 255, (2, 3, 5, 32, 48)).astype(np.float32)
    want = _np(jpose.forward(params, jnp.asarray(pose)))
    with torch.inference_mode():
        got = model(torch.from_numpy(pose)).numpy()
    assert got.shape == want.shape == (2, 2 * 2 * 3, 32)  # (5 + 3) frames / 4, 32 / 16, 48 / 16
    assert np.abs(got - want).max() <= POSE_REL * np.abs(want).max()
    # the reference's naming, read by both packages' converters
    sd = tpose.torch_state_dict_from_params(model)
    assert sorted(sd) == sorted(f"dwpose_embedding.{2 * i}.{k}" for i in range(7)
                                for k in ("weight", "bias"))
    back = jpose.params_from_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    for a, b in zip(back, params):
        np.testing.assert_array_equal(_np(a["w"]), _np(b["w"]))
        np.testing.assert_array_equal(_np(a["b"]), _np(b["b"]))
    again = tpose.params_from_torch_state_dict({"diffusion_model." + k: v for k, v in sd.items()},
                                               device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), model.parameters()))


def test_encode_pose_rounds_through_bf16():
    """encode_pose rounds the embedding through bf16 in an f32 pipeline, as
    svi_tpu's does: bit-equal to the port's own f32 forward rounded once, and
    to svi_tpu's except where the f32 values sit within their summation
    difference of a bf16 rounding boundary (one ulp, a few elements)."""
    params = jpose.init_params(jax.random.PRNGKey(2), dim=64)
    jpipe, tpipe = JaxDance(torch_dtype=jnp.float32), TorchDance(device="cpu",
                                                                 torch_dtype=torch.float32)
    jpipe.dwpose_embedding = params
    tpipe.dwpose_embedding = tpose.params_from_jax(_host(params))
    pose = np.random.default_rng(2).integers(0, 255, (3, 9, 64, 64)).astype(np.float32)
    got = tpipe.encode_pose(pose)
    assert got.dtype == torch.float32
    with torch.inference_mode():
        plain = tpipe.dwpose_embedding(torch.from_numpy(pose)[None])
    assert torch.equal(got, plain.to(torch.bfloat16).float())
    assert not torch.equal(got, plain)
    want = _np(jpipe.encode_pose(pose))
    off = got.numpy() != want
    assert off.mean() <= 1e-3, off.mean()
    ulp = np.abs(want[off]) * 2.0 ** -7
    assert (np.abs(got.numpy()[off] - want[off]) <= ulp).all()


# ---------------------------------------------------------------------------
# the audio DiT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_audio_proj_forward_matches_svi_tpu(dtype):
    """bf16: the windows are cast to the DiT's dtype before proj1, as in
    svi_tpu; f32 windows through an f32 proj1 would differ by far more than
    the bound."""
    dts = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    params, cfg_j, model = _dit("multitalk", dts)
    first, vf = _audio_windows(np.random.default_rng(3), 2, 3)
    want = _np(jdit.audio_proj_forward(params, cfg_j, jnp.asarray(first), jnp.asarray(vf)))
    with torch.inference_mode():
        got = model.audio_proj_forward(torch.from_numpy(first), torch.from_numpy(vf)).float()
    assert got.shape == want.shape == (2, 3, 4, 32)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_audio_cross_attention_matches_svi_tpu():
    params, cfg_j, model = _dit("multitalk")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3 * 16, 64)).astype(np.float32)
    audio = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    block = jax.tree.map(lambda a: a[1], params["blocks"])
    want = _np(jdit._audio_cross_attention(block["audio_cross_attn"], cfg_j, jnp.asarray(x),
                                           jnp.asarray(audio), 3))
    with torch.inference_mode():
        got = model._audio_cross_attention(model["blocks"][1]["audio_cross_attn"],
                                           torch.from_numpy(x), torch.from_numpy(audio), 3)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    # each latent frame attends to its own audio tokens only
    audio2 = audio.copy()
    audio2[:, 2] += 1.0
    with torch.inference_mode():
        moved = model._audio_cross_attention(model["blocks"][1]["audio_cross_attn"],
                                             torch.from_numpy(x), torch.from_numpy(audio2), 3)
    assert torch.equal(moved[:, :32], got[:, :32]) and not torch.equal(moved[:, 32:], got[:, 32:])


def _dit_inputs(rng, b=2):
    x = rng.standard_normal((b, Z, 3, 8, 8)).astype(np.float32)
    y = rng.standard_normal((b, 8, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((b, 12, 48)).astype(np.float32)
    clip = rng.standard_normal((b, 5, 40)).astype(np.float32)
    return x, np.array([731.0], np.float32), ctx, clip, y


@pytest.mark.parametrize("variant", ["multitalk", "customtalk"])
def test_audio_dit_forward_matches_svi_tpu(variant):
    """Three blocks: a customtalk block's audio output is the next block's
    add_condition, so an off-by-one in the carry shows only from the third."""
    params, cfg_j, model = _dit(variant)
    rng = np.random.default_rng(5)
    x, t, ctx, clip, y = _dit_inputs(rng)
    first, vf = _audio_windows(rng, 2, 3)
    cond = rng.standard_normal((2, 48, 64)).astype(np.float32)
    j = [jnp.asarray(a) for a in (x, t, ctx, clip, y, cond, first, vf)]
    fwd = jax.jit(lambda p, *a: jdit.forward(p, cfg_j, *a[:3], clip_feature=a[3], y=a[4],
                                             add_condition=a[5], audio_embed_tuple=a[6:]))
    want = _np(fwd(params, *j))
    tt = [torch.from_numpy(a) for a in (x, t, ctx, clip, y, cond, first, vf)]
    with torch.inference_mode():
        got = model(*tt[:5], add_condition=tt[5], audio_embed_tuple=tuple(tt[6:])).numpy()
        plain = model(*tt[:5], add_condition=tt[5]).numpy()  # no audio: the plain blocks
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    assert np.abs(got - plain).max() > 1e-2


def test_customtalk_carry_reaches_the_third_block():
    """The carry through forward_blocks against the blocks run by hand: block
    i + 1 takes block i's audio output; a carry that skips a block (every
    block fed the first one's) differs."""
    _, _, model = _dit("customtalk")
    rng = np.random.default_rng(6)
    x, t, ctx, clip, y = (torch.from_numpy(a) for a in _dit_inputs(rng))
    audio = model.audio_proj_forward(*(torch.from_numpy(a) for a in _audio_windows(rng, 2, 3)))
    with torch.inference_mode():
        tokens, c, _, t_mod, grid = model.forward_prelude(x, t, ctx, clip, y)
        got = model.forward_blocks(tokens, c, t_mod, grid, num_img_tokens=5, audio_embed=audio)
        from svi_tpu_torch.ops.rope import rope_angles_for_grid

        cos, sin = (torch.from_numpy(a) for a in rope_angles_for_grid(grid, 32))
        tok, cond, conds = tokens, torch.zeros_like(tokens), []
        for p in model["blocks"]:
            conds.append(cond)
            tok, cond = model.dit_block(p, tok, c, t_mod, cos, sin, 5, audio_embed=audio,
                                        num_frames=3, add_condition=cond)
        stale, tok2 = conds[1], tokens
        for i, p in enumerate(model["blocks"]):
            tok2, _ = model.dit_block(p, tok2, c, t_mod, cos, sin, 5, audio_embed=audio,
                                      num_frames=3, add_condition=conds[0] if i == 0 else stale)
    assert torch.equal(got, tok)
    assert (got - tok2).abs().max() > 1e-3


@pytest.mark.parametrize("variant", ["multitalk", "customtalk"])
def test_audio_dit_converters_and_config_match_svi_tpu(variant):
    params, cfg_j, model = _dit(variant)
    sd = tdit.torch_state_dict_from_params(model)
    assert any(k.startswith("audio_proj.proj1_vf.") for k in sd)
    assert ("blocks.2.customtalk_audio_pre_ffns.2.weight" in sd) == (variant == "customtalk")
    sd_np = {k: v.numpy() for k, v in sd.items()}
    back = jdit.params_from_torch_state_dict(sd_np, cfg_j)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(_np(a), _np(b)), back, params)
    again = dict(tdit.params_from_torch_state_dict(sd, model.cfg, device="cpu").named_parameters())
    mine = dict(model.named_parameters())
    assert sorted(again) == sorted(mine)
    assert all(torch.equal(again[k], mine[k]) for k in mine)
    got, want = tdit.config_from_state_dict(sd), jdit.config_from_state_dict(sd_np)
    for field in ("num_layers", "has_image_input", "enable_multitalk", "enable_customtalk"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.enable_multitalk == (variant == "multitalk")
    assert got.enable_customtalk == (variant == "customtalk")


def test_config_from_keys_detects_multitalk():
    """Key-only detection (svi_tpu's config_from_state_dict_keys): any key
    naming audio makes it multitalk, even customtalk's keys."""
    base = [f"blocks.{i}.self_attn.q.weight" for i in range(40)] + [
        "blocks.0.cross_attn.k_img.weight"]
    for extra in ([], ["blocks.0.audio_cross_attn.q_linear.weight"],
                  ["audio_proj.proj1.weight", "blocks.0.customtalk_context_pre_ffns.0.weight"]):
        got = tdit.config_from_state_dict_keys(base + extra)
        want = jdit.config_from_state_dict_keys(base + extra)
        assert (got.enable_multitalk, got.num_layers, got.dim, got.in_dim) == (
            want.enable_multitalk, want.num_layers, want.dim, want.in_dim) == (
            bool(extra), 40, 5120, 36)


@pytest.mark.parametrize("variant", ["multitalk", "customtalk"])
def test_audio_dit_int4_w4a8_leaves_match_svi_tpu(variant):
    """quantize-on-load's int4_w4a8 leaves of an audio DiT, audio linears
    and audio_proj included, bit for bit against svi_tpu's quantizer."""
    params, _, model = _dit(variant)
    min_size, group = 1024, 16
    want = tdit.params_from_jax(_host(jdit.quantize_params_for_inference(
        params, "int4_w4a8", min_size=min_size, group=group)), model.cfg)
    got = tdit.quantize_to_device(model, "int4_w4a8", "cpu", min_size=min_size, group=group)
    w, g = dict(want.named_parameters()), dict(got.named_parameters())
    assert sorted(w) == sorted(g)
    audio = [k for k in g if k.endswith("w_q4") and ("audio" in k or "customtalk" in k)]
    # audio_proj's 4; per block q, kv, proj (and customtalk's 4 FFN halves)
    assert len(audio) == 4 + 3 * (3 + 4 * (variant == "customtalk")), audio
    for k, t in w.items():
        assert g[k].dtype == t.dtype and torch.equal(g[k], t), k


# ---------------------------------------------------------------------------
# audio helpers
# ---------------------------------------------------------------------------


def test_load_audio_and_windows_match_svi_tpu(real_audio_imports):
    got, want = taudio.load_audio(str(SPEECH)), jaudio.load_audio(str(SPEECH))
    assert got.dtype == np.float32 and got.ndim == 1 and got.size > 16000
    np.testing.assert_array_equal(got, want)
    emb = np.random.default_rng(7).standard_normal((150, 12, 8)).astype(np.float32)
    for nf, start in ((81, 0), (81, 80), (9, 145)):  # the last clamps at the end
        w_t, w_j = taudio.slice_audio_windows(emb, nf, start), jaudio.slice_audio_windows(
            emb, nf, start)
        np.testing.assert_array_equal(w_t, w_j)
        for a, b in zip(taudio.regroup_audio_windows(w_t), jaudio.regroup_audio_windows(w_j)):
            np.testing.assert_array_equal(a, b)
    stored = np.transpose(emb, (1, 0, 2))  # (12, s, 768) as a training file holds it
    for a, b in zip(taudio.cut_audio_embedding(stored, 21, 7),
                    jaudio.cut_audio_embedding(stored, 21, 7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("target", [(64, 64), (368, 640), (480, 832)])
def test_resize_and_pad_matches_svi_tpu(target):
    """The dance driver's pose frames: a 448 x 256 portrait, as
    data/toy_test/dance/pose.mp4's, to the clip's size."""
    from svi_tpu.utils.image_process import resize_and_pad_to_target as jfit
    from svi_tpu_torch.utils.image_process import resize_and_pad_to_target as tfit

    frames = np.random.default_rng(8).integers(0, 255, (3, 3, 448, 256)).astype(np.float32)
    got = tfit(frames, target, pad_value=0)
    np.testing.assert_array_equal(got, jfit(frames, target, pad_value=0))
    assert got.shape == (3, 3, *target)


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders():
    """The VAE and CLIP of both pipelines: the port's init_params, carried to
    svi_tpu through the reference's names (svi_tpu's own VAE init runs op by
    op, ~30 s on the CPU)."""
    vae_cfg = tvae.WanVAEConfig(dim=16, z_dim=Z)
    clip_kw = dict(image_size=28, patch_size=14, dim=40, mlp_ratio=2, num_heads=2, num_layers=2)
    vae = tvae.init_params(vae_cfg, seed=1, device="cpu")
    clip = tclip.init_params(tclip.ClipVisionConfig(**clip_kw), seed=3, device="cpu")
    jv = jvae.WanVAEConfig(dtype=jnp.float32, dim=16, z_dim=Z)
    jc = jclip.ClipVisionConfig(dtype=jnp.float32, **clip_kw)
    to_np = lambda sd: {k: v.float().numpy() for k, v in sd.items()}  # noqa: E731
    return (vae, clip, (jvae.params_from_torch_state_dict(
        to_np(tvae.torch_state_dict_from_params(vae)), jv), jv),
        (jclip.params_from_torch_state_dict(to_np(tclip.torch_state_dict_from_params(clip)),
                                            jc), jc))


def _pipelines(encoders, jcls, tcls, variant):
    vae, clip, jv, jc = encoders
    dparams, cfg_j, tdit_model = _dit(variant)
    jpipe = jcls(torch_dtype=jnp.float32)
    jpipe.vae, jpipe.dit, jpipe.image_encoder = jv, (dparams, cfg_j), jc
    tpipe = tcls(device="cpu", torch_dtype=torch.float32)
    tpipe.vae, tpipe.dit, tpipe.image_encoder = vae, tdit_model, clip
    return jpipe, tpipe


def _clip_kwargs(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    ctx = rng.standard_normal((1, 7, 48)).astype(np.float32)
    return dict(input_image=img, random_ref_frame=img, seed=seed, height=H, width=W,
                num_frames=NF, num_inference_steps=STEPS, tiled=False, prompt_emb_posi=ctx,
                prompt_emb_nega=ctx * 0.5, ref_pad_num=-1, return_latents=True)


def _compare(jout, tout):
    (fj, lj), (ft, lt) = jout, tout
    lt = lt.float().numpy()
    np.testing.assert_allclose(lt, _np(lj), atol=LATENT_TOL, rtol=0)
    fj, ft = np.stack([np.asarray(f) for f in fj]), np.stack(ft)
    assert ft.shape == fj.shape == (NF, H, W, 3)
    assert np.abs(ft.astype(np.int16) - fj.astype(np.int16)).max() <= FRAME_LEVELS
    return lt


def test_dance_pipeline_matches_svi_tpu(encoders):
    """The pose tokens in both CFG branches (cond_wo_pose=True) and in the
    cond branch only; each moves the clip."""
    jpipe, tpipe = _pipelines(encoders, JaxDance, TorchDance, None)
    pose_params = jpose.init_params(jax.random.PRNGKey(11), dim=64)
    jpipe.dwpose_embedding = pose_params
    tpipe.dwpose_embedding = tpose.params_from_jax(_host(pose_params))
    pose = np.random.default_rng(12).integers(0, 255, (3, NF, H, W)).astype(np.float32)
    latents = {}
    for wo in (True, False):
        kw = dict(_clip_kwargs(1), cfg_scale=dict(text=5.0, audio=2.0), humanpose_data=pose,
                  cond_wo_pose=wo)
        latents[wo] = _compare(jpipe(**kw), tpipe(**kw))
    _, plain = tpipe(**dict(_clip_kwargs(1), cfg_scale=5.0))
    assert np.abs(latents[True] - latents[False]).max() > 10 * LATENT_TOL
    assert np.abs(latents[True] - plain.numpy()).max() > 10 * LATENT_TOL


@pytest.mark.parametrize("variant", ["multitalk", "customtalk"])
def test_talk_pipeline_matches_svi_tpu(encoders, variant, monkeypatch):
    """Three CFG branches in one forward, TeaCache off and on (a threshold
    that skips every step but the first and the last: both branches of the
    cache run), the skipped steps counted alike."""
    jpipe, tpipe = _pipelines(encoders, JaxTalk, TorchTalk, variant)
    audio = np.random.default_rng(13).standard_normal((1, NF, 5, 12, 32)).astype(np.float32)
    seen = {}
    check = jsv.TeaCache.check

    def spy(self, *a):
        seen["jax"] = self
        return check(self, *a)

    monkeypatch.setattr(jsv.TeaCache, "check", spy)
    cfg = dict(text=5.0, audio=2.0)
    for thresh in (None, 1e9):
        kw = dict(_clip_kwargs(2), cfg_scale=cfg, audio_embed=audio, tea_cache_l1_thresh=thresh,
                  tea_cache_model_id="Wan2.1-I2V-14B-720P" if thresh else "")
        _compare(jpipe(**kw), tpipe(**kw))
    assert tpipe.last_tea_cache.skipped_steps == seen["jax"].skipped_steps == STEPS - 2
    silent = dict(_clip_kwargs(2), cfg_scale=cfg, audio_embed=np.zeros_like(audio))
    _, loud = tpipe(**dict(_clip_kwargs(2), cfg_scale=cfg, audio_embed=audio))
    assert (tpipe(**silent)[1] - loud).abs().max() > 10 * LATENT_TOL


def test_talk_embeds_each_audio_file_once(monkeypatch):
    pipe = TorchTalk(device="cpu", torch_dtype=torch.float32)
    pipe.wav2vec = object()  # never reached on a cache hit
    calls = []
    emb = np.zeros((40, 12, 8), np.float32)
    emb[:, 0, 0] = np.arange(40)
    monkeypatch.setattr(taudio, "load_audio", lambda path: np.zeros(16000, np.float32))
    monkeypatch.setattr(taudio, "wav2vec_embedding",
                        lambda speech, feature_extractor, model: calls.append(1) or emb)
    a = pipe.get_audio_embedding("x.wav", num_frames=9, audio_start_idx=0)
    b = pipe.get_audio_embedding("x.wav", num_frames=9, audio_start_idx=5)
    assert len(calls) == 1 and a.shape == (1, 9, 5, 12, 8)
    np.testing.assert_array_equal(b, taudio.slice_audio_windows(emb, 9, 5))
    pipe.get_audio_embedding("y.wav", num_frames=9)
    assert len(calls) == 2
