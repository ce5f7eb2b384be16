"""The SD 1.5 family of the port (svi_tpu_torch.models.sd, tiler, motion,
controlnets; the DDIM scheduler; the CLIP tokenizer and SD prompter; the
ModelManager's SD loaders) against svi_tpu on the CPU.

Both packages load the same seeded state dicts in the reference's diffsynth
naming through their own `*_params_from_torch`, at narrow plans patched into
both (tests/torch_sd_fixtures.py). svi_tpu's attention runs its XLA
reference on the CPU, the port's its plain version.

Tolerance of every f32 forward: the largest difference within 1e-4 of the
output's largest magnitude (two f32 implementations: the order of sums,
XLA's and torch's convolution and GEMM algorithms; the UNet's deepest path
is some 60 layers).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svi_tpu.models import controlnets as jcn
from svi_tpu.models import motion as jmo
from svi_tpu.models import sd as jsd
from svi_tpu.models import tiler as jtiler
from svi_tpu_torch.models import controlnets as tcn
from svi_tpu_torch.models import motion as tmo
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.models import tiler as ttiler

import torch_sd_fixtures as fx

F32_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def sds():
    mp = pytest.MonkeyPatch()
    fx.patch_narrow_plans(mp)
    out = fx.state_dicts(seed=3)
    mp.undo()
    return out


@pytest.fixture
def narrow(monkeypatch):
    fx.patch_narrow_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)


def _port(kind, sd):
    loader = {"sd_unet": tsd.sd_unet_params_from_torch,
              "sd_text_encoder": tsd.sd_text_encoder_params_from_torch,
              "sd_vae_encoder": tsd.sd_vae_encoder_params_from_torch,
              "sd_vae_decoder": tsd.sd_vae_decoder_params_from_torch,
              "sd_motion_modules": tmo.motion_params_from_torch,
              "sd_controlnet": tcn.sd_controlnet_params_from_torch}[kind]
    return loader(sd, device="cpu")


def _jax(kind, sd):
    loader = {"sd_unet": jsd.sd_unet_params_from_torch,
              "sd_text_encoder": jsd.sd_text_encoder_params_from_torch,
              "sd_vae_encoder": jsd.sd_vae_encoder_params_from_torch,
              "sd_vae_decoder": jsd.sd_vae_decoder_params_from_torch,
              "sd_motion_modules": jmo.motion_params_from_torch,
              "sd_controlnet": jcn.sd_controlnet_params_from_torch}[kind]
    return loader(fx.to_numpy(sd))


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# scheduler, tokenizer, prompter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beta,snr,pred", [("scaled_linear", False, "epsilon"),
                                           ("linear", False, "epsilon"),
                                           ("scaled_linear", True, "v_prediction")])
def test_ddim_matches_jax(beta, snr, pred):
    """Timesteps and alphas equal; step, return_to_timestep, add_noise and
    the training target within f32 rounding (the same Python-float weights
    on f32 arrays)."""
    from svi_tpu.schedulers.ddim import EnhancedDDIMScheduler as J
    from svi_tpu_torch.schedulers.ddim import EnhancedDDIMScheduler as T

    kw = dict(beta_schedule=beta, rescale_zero_terminal_snr=snr, prediction_type=pred)
    js, ts = J(**kw), T(**kw)
    assert ts.alphas_cumprod == js.alphas_cumprod
    x, e, s = _randn((2, 4, 8, 8), 0), _randn((2, 4, 8, 8), 1), _randn((2, 4, 8, 8), 2)
    for steps, strength in ((20, 1.0), (7, 0.9), (1, 0.5), (3, 0.0)):
        js.set_timesteps(steps, strength)
        ts.set_timesteps(steps, strength)
        assert ts.timesteps.dtype == np.float32
        np.testing.assert_array_equal(ts.timesteps, js.timesteps)
        for i, t in enumerate(ts.timesteps):
            for to_final in (False, True):
                got = ts.step(torch.from_numpy(e), torch.tensor([t]), torch.from_numpy(x),
                              to_final=to_final)
                np.testing.assert_allclose(got.numpy(), js.step(e, np.array([t]), x,
                                                                to_final=to_final),
                                           rtol=1e-6, atol=1e-6)
        t = ts.timesteps[0]
        for fn in ("return_to_timestep", "add_noise"):
            args = (t, torch.from_numpy(x), torch.from_numpy(s)) if fn == "return_to_timestep" \
                else (torch.from_numpy(x), torch.from_numpy(s), t)
            jargs = (t, x, s) if fn == "return_to_timestep" else (x, s, t)
            np.testing.assert_allclose(getattr(ts, fn)(*args).numpy(), getattr(js, fn)(*jargs),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(ts.training_target(torch.from_numpy(x), torch.from_numpy(e), t)),
            js.training_target(x, e, t), rtol=1e-6, atol=1e-6)


PROMPTS = [
    "a photo of an astronaut riding a horse on mars",
    "Hello, World!! it's 2024 — café naïve 東京 <3",
    "masterpiece, best quality, " * 30,  # beyond 77 tokens: truncated, or chunked
    "",
    "   spaces\tand\nnewlines   ",
]


def test_clip_tokenizer_token_for_token():
    """The port's tokenizer against svi_tpu's, token for token, padded and
    truncated at 77, unbounded, chunked by tokenize_long_prompt, and with
    added pseudo-tokens."""
    from svi_tpu.prompters.base_prompter import tokenize_long_prompt as jlong
    from svi_tpu.prompters.clip_tokenizer import ClipBpeTokenizer as J
    from svi_tpu_torch.prompters.base_prompter import tokenize_long_prompt as tlong
    from svi_tpu_torch.prompters.clip_tokenizer import ClipBpeTokenizer as T

    jt, tt = J(), T()
    assert len(jt) == len(tt) == 49408
    for p in PROMPTS:
        for kw in ({}, dict(padding="max_length", max_length=77, truncation=True)):
            np.testing.assert_array_equal(tt(p, **kw).input_ids, jt(p, **kw).input_ids)
        np.testing.assert_array_equal(tlong(tt, p), jlong(jt, p))
    long_ids = tt(PROMPTS[2], padding="max_length", max_length=77, truncation=True).input_ids
    assert long_ids.shape == (1, 77) and long_ids[0, -1] == tt.eos_token_id
    assert tlong(tt, PROMPTS[2]).shape[0] > 1
    for tok in (jt, tt):
        tok.add_tokens(["style_0", "style_1"])
    p = "a portrait in style_0 style_1 colours"
    np.testing.assert_array_equal(tt(p).input_ids, jt(p).input_ids)
    assert tt(p).input_ids[0, 4] == 49408
    # the port's merges file is its own byte-for-byte copy
    from pathlib import Path

    import svi_tpu
    import svi_tpu_torch

    ours = Path(svi_tpu_torch.__file__).parent / "tokenizer_configs" / "clip_merges.txt.gz"
    theirs = Path(svi_tpu.__file__).parent / "tokenizer_configs" / "clip_merges.txt.gz"
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("clip_skip", [1, 2])
def test_text_encoder_matches_jax(sds, clip_skip):
    sd = sds["sd_text_encoder"]
    ids = np.random.default_rng(0).integers(0, 49408, (2, 77))
    want = np.asarray(jsd.sd_text_encoder_forward(_jax("sd_text_encoder", sd), jnp.asarray(ids),
                                                  clip_skip=clip_skip))
    got = tsd.sd_text_encoder_forward(_port("sd_text_encoder", sd), torch.from_numpy(ids),
                                      clip_skip=clip_skip)
    assert got.shape == want.shape == (2, 77, fx.TEXT_DIM)
    assert fx.rel(got.numpy(), want) <= F32_REL


def test_textual_inversion_and_long_prompt_match_jax(sds, tmp_path):
    """A 2-row embedding file: pseudo-tokens, the extended table and the
    chunked encoding of a long prompt through both SD prompters."""
    from svi_tpu.prompters.sd_prompter import SDPrompter as J
    from svi_tpu_torch.prompters.sd_prompter import SDPrompter as T
    from svi_tpu_torch.utils.safetensors_io import save_file

    emb = torch.from_numpy(_randn((2, fx.TEXT_DIM), 5, 0.02))
    path = str(tmp_path / "mystyle.safetensors")
    save_file({"emb_params": emb}, path)
    jp, tp = J(), T()
    jp.load_textual_inversions([path], embedding_dim=fx.TEXT_DIM)
    tp.load_textual_inversions([path], embedding_dim=fx.TEXT_DIM)
    assert tp.keyword_dict == jp.keyword_dict == {"mystyle": " mystyle_0 mystyle_1 "}
    sd = sds["sd_text_encoder"]
    prompt = "a castle in mystyle, " + "detailed, " * 40
    for clip_skip in (1, 2):
        want = np.asarray(jp.encode_prompt(_jax("sd_text_encoder", sd), prompt, clip_skip))
        got = tp.encode_prompt(_port("sd_text_encoder", sd), prompt, clip_skip)
        assert got.shape == want.shape and got.shape[1] == 2 * 77
        assert fx.rel(got.numpy(), want) <= F32_REL


def test_prompt_tools_raise_and_empty_lists_are_no_ops():
    """The prompt tools are ported: each class named is built by its
    `from_model_manager(model_manager)` and chained (refiners on the
    positive branch only, extenders on the prompt dict); empty lists are
    no-ops. (The name is kept from when naming a class raised.)"""
    from svi_tpu_torch.prompters.base_prompter import BasePrompter

    seen = []

    class Upper:
        @staticmethod
        def from_model_manager(mm):
            seen.append(mm)
            return lambda prompt, positive=True: prompt.upper() if positive else prompt

    class Regions:
        @staticmethod
        def from_model_manager(mm):
            seen.append(mm)
            return lambda d: {**d, "prompts": [d["prompt"] + " left"]}

    p = BasePrompter()
    p.load_prompt_refiners("mm", [])
    p.load_prompt_extenders("mm", ())
    assert p.refiners == [] and p.extenders == [] and seen == []
    assert p.process_prompt("a cat") == "a cat"
    p.load_prompt_refiners("mm", [Upper])
    p.load_prompt_extenders("mm", [Regions])
    assert seen == ["mm", "mm"]
    assert p.process_prompt(["a cat", "a dog"]) == ["A CAT", "A DOG"]
    assert p.process_prompt("a cat", positive=False) == "a cat"
    assert p.extend_prompt("a cat") == {"prompt": "a cat", "prompts": ["a cat left"]}


# ---------------------------------------------------------------------------
# UNet, ControlNet, motion, VAE
# ---------------------------------------------------------------------------


def _cn_inputs(b, h, w, seed):
    """latents (b, 4, h, w), a context (1, 77, D) and a [0, 1] condition."""
    lat = _randn((b, 4, h, w), seed)
    ctx = _randn((1, 77, fx.TEXT_DIM), seed + 1)
    cond = np.random.default_rng(seed + 2).random((b, 3, 8 * h, 8 * w)).astype(np.float32)
    return lat, ctx, cond


def test_controlnet_matches_jax(sds, narrow):
    sd = sds["sd_controlnet"]
    lat, ctx, cond = _cn_inputs(2, 8, 8, 10)
    want = jcn.sd_controlnet_forward(_jax("sd_controlnet", sd), jnp.asarray(lat),
                                     jnp.asarray([501.0]), jnp.asarray(ctx), jnp.asarray(cond))
    got = tcn.sd_controlnet_forward(_port("sd_controlnet", sd), torch.from_numpy(lat),
                                    torch.tensor([501.0]), torch.from_numpy(ctx),
                                    torch.from_numpy(cond))
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert fx.rel(g.numpy(), np.asarray(w)) <= F32_REL


@pytest.mark.parametrize("case", ["plain", "controlnet", "motion", "tiled"])
def test_unet_matches_jax(sds, narrow, case):
    """The UNet alone, with ControlNet residuals (the ControlNet run by each
    package), with the 21 AnimateDiff hooks over 2 frames, and with its
    transformer blocks tiled (4-pixel tiles at stride 2), on 2 x 8 x 8
    latents (the pipelines' windows)."""
    lat, ctx, cond = _cn_inputs(2, 8, 8, 20)
    t = 701.0
    jkw, tkw = {}, {}
    if case == "controlnet":
        sd = sds["sd_controlnet"]
        jkw["controlnet_res"] = jcn.sd_controlnet_forward(
            _jax("sd_controlnet", sd), jnp.asarray(lat), jnp.asarray([t]), jnp.asarray(ctx),
            jnp.asarray(cond))
        tkw["controlnet_res"] = tcn.sd_controlnet_forward(
            _port("sd_controlnet", sd), torch.from_numpy(lat), torch.tensor([t]),
            torch.from_numpy(ctx), torch.from_numpy(cond))
    if case == "motion":
        sd = sds["sd_motion_modules"]
        jkw["motion"] = jmo.motion_hooks(_jax("sd_motion_modules", sd))
        tkw["motion"] = tmo.motion_hooks(_port("sd_motion_modules", sd))
        assert len(tkw["motion"]) == 21
    if case == "tiled":
        jkw = tkw = dict(tiled=True, tile_size=4, tile_stride=2)
    want = np.asarray(jsd.sd_unet_forward(_jax("sd_unet", sds["sd_unet"]), jnp.asarray(lat),
                                          jnp.asarray([t]), jnp.asarray(ctx), **jkw))
    got = tsd.sd_unet_forward(_port("sd_unet", sds["sd_unet"]), torch.from_numpy(lat),
                              torch.tensor([t]), torch.from_numpy(ctx), **tkw)
    assert got.shape == want.shape == lat.shape
    assert fx.rel(got.numpy(), want) <= F32_REL


@pytest.mark.parametrize("tiled", [False, True])
def test_vae_encode_decode_matches_jax(sds, narrow, tiled):
    """Encode a 64 x 64 image and decode its latents; tiled: 32-pixel tiles
    at stride 16 for the encoder, 4-latent tiles at stride 2 for the decoder."""
    img = np.clip(_randn((1, 3, 64, 64), 40, 0.5), -1, 1)
    ekw = dict(tiled=True, tile_size=32, tile_stride=16) if tiled else {}
    dkw = dict(tiled=True, tile_size=4, tile_stride=2) if tiled else {}
    jenc, jdec = _jax("sd_vae_encoder", sds["sd_vae_encoder"]), _jax("sd_vae_decoder",
                                                                       sds["sd_vae_decoder"])
    tenc, tdec = _port("sd_vae_encoder", sds["sd_vae_encoder"]), _port("sd_vae_decoder",
                                                                         sds["sd_vae_decoder"])
    want_lat = np.asarray(jsd.sd_vae_encode(jenc, jnp.asarray(img), **ekw))
    got_lat = tsd.sd_vae_encode(tenc, torch.from_numpy(img), **ekw)
    assert got_lat.shape == want_lat.shape == (1, 4, 8, 8)
    assert fx.rel(got_lat.numpy(), want_lat) <= F32_REL
    want_img = np.asarray(jsd.sd_vae_decode(jdec, jnp.asarray(want_lat), **dkw))
    got_img = tsd.sd_vae_decode(tdec, torch.from_numpy(want_lat), **dkw)
    assert got_img.shape == want_img.shape == img.shape
    assert fx.rel(got_img.numpy(), want_img) <= F32_REL


@pytest.mark.parametrize("kind", ["sd_unet", "sd_text_encoder", "sd_vae_encoder",
                                  "sd_vae_decoder", "sd_motion_modules", "sd_controlnet"])
def test_params_from_jax(sds, narrow, kind):
    """`*_params_from_jax` carries svi_tpu's pytree across (conv weights
    HWIO -> OIHW, linears (in, out) -> (out, in), the text encoder's stacked
    layers unstacked): every tensor equal to the one the port's loader reads
    from the same state dict, under the same name."""
    convert = {"sd_unet": tsd.sd_params_from_jax, "sd_vae_encoder": tsd.sd_params_from_jax,
               "sd_vae_decoder": tsd.sd_params_from_jax,
               "sd_text_encoder": tsd.sd_text_encoder_params_from_jax,
               "sd_motion_modules": tmo.motion_params_from_jax,
               "sd_controlnet": tcn.sd_controlnet_params_from_jax}[kind]
    got = dict(convert(_jax(kind, sds[kind]), device="cpu").named_parameters())
    want = dict(_port(kind, sds[kind]).named_parameters())
    assert got.keys() == want.keys() and len(got) > 0
    for name, t in want.items():
        assert torch.equal(got[name], t), name


# ---------------------------------------------------------------------------
# tiler, model manager
# ---------------------------------------------------------------------------


def test_tiler_matches_jax():
    """The three tilers on the same forward: io scale 2 with a batch of
    tiles, the clamped grid given coordinates, the 2D-to-3D video grid."""
    x = _randn((2, 20, 28, 3), 50)
    w = _randn((3, 5), 51)

    def tfn(t):  # (N, h, w, 3) -> (N, 2h, 2w, 5)
        y = torch.einsum("nhwc,cd->nhwd", t, torch.from_numpy(w))
        return y.repeat_interleave(2, 1).repeat_interleave(2, 2)

    def jfn(t):
        y = jnp.einsum("nhwc,cd->nhwd", t, jnp.asarray(w))
        return jnp.repeat(jnp.repeat(y, 2, 1), 2, 2)

    got = ttiler.tiled_forward(tfn, torch.from_numpy(x), 8, 4, tile_batch_size=3)
    want = np.asarray(jtiler.tiled_forward(jfn, jnp.asarray(x), 8, 4, tile_batch_size=3))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    got = ttiler.fast_tiled_forward(lambda a, b, c, d: torch.from_numpy(x)[:, a:b, c:d] * 2,
                                    torch.from_numpy(x), 8, 5)
    want = np.asarray(jtiler.fast_tiled_forward(lambda a, b, c, d: jnp.asarray(x)[:, a:b, c:d]
                                                * 2, jnp.asarray(x), 8, 5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    v = _randn((1, 3, 12, 10, 4), 52)
    scales = (0.5, 1, 2, 2)

    def tv(t):
        return t[..., :2].repeat_interleave(2, 2).repeat_interleave(2, 3) * 3

    def jv(t):
        return jnp.repeat(jnp.repeat(t[..., :2], 2, 2), 2, 3) * 3

    got = ttiler.tiled_forward_2dto3d(tv, torch.from_numpy(v), (6, 6), (4, 3), scales)
    want = np.asarray(jtiler.tiled_forward_2dto3d(jv, jnp.asarray(v), (6, 6), (4, 3), scales))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_model_manager_loads_the_sd_family(sds, narrow, tmp_path):
    """Each diffsynth-named file is detected and loaded (f32, on the
    manager's device) with the tensors that were written."""
    from svi_tpu_torch.models.model_io import ModelManager

    paths = fx.write_files(tmp_path, sds)
    mm = ModelManager(device="cpu")
    mm.load_models(list(paths.values()))
    assert set(mm.models) == set(paths)
    unet = mm.fetch_model("sd_unet")
    assert all(p.dtype == torch.float32 for p in unet.parameters())
    assert torch.equal(unet["blocks"][1]["transformer_blocks"][0]["attn2"]["to_k"]["w"],
                       sds["sd_unet"]["blocks.1.transformer_blocks.0.attn2.to_k.weight"])
    motion = mm.fetch_model("sd_motion_modules")
    assert len(motion["motion_modules"]) == 21
    assert torch.equal(motion["motion_modules"][20]["transformer_blocks"][0]["pe2"],
                       sds["sd_motion_modules"]["motion_modules.20.transformer_blocks.0.pe2"])
    cn = mm.fetch_model("sd_controlnet")
    assert len(cn["controlnet_blocks"]) == 13
