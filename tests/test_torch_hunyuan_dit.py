"""Hunyuan-DiT in the port (svi_tpu_torch.models.hunyuan_dit, the BERT
WordPiece tokenizer of prompters.sp_tokenizer, prompters.hunyuan_dit_prompter,
pipelines.hunyuan_image) against svi_tpu on the CPU.

Both packages load the same seeded state dicts in the reference's diffsynth
names through their own converters (tests/torch_video_fixtures.py): a DiT
128 wide (svi_tpu fixes its 16 heads, so 16 heads of 8) with 4 down and 2
up blocks over 77 BERT and 256 mT5 tokens 32 wide, and the SDXL VAE at a
quarter of SD's channels; svi_tpu's pytree is also carried across by
`params_from_jax`. The text encoders are the caller's in both packages: here
seeded embedding tables (torch), the same callables for both.

Tolerances: the rotary tables and the tokenizer's ids and masks equal; the
(B, N, S, D) route's plain version at D = 88 (the card's f32 D88 kernel is
held against it in tests/test_torch_kernels_cuda.py) within 1e-5 of
svi_tpu's `_flash_fwd_xla` (f32 online softmax over the same key blocks,
sums in other orders), lse within 1e-5; f32 forwards within 1e-4 of the
output's largest magnitude; the pipeline's uint8 image within one level.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import hunyuan_dit as jhy
from svi_tpu.models import sd as jsd
from svi_tpu.ops import attention as jattn
from svi_tpu.pipelines import hunyuan_image as jpipe_mod
from svi_tpu.prompters import hunyuan_dit_prompter as jprompt
from svi_tpu.prompters import sp_tokenizer as jsp
from svi_tpu_torch.models import hunyuan_dit as thy
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.ops import attention as tattn
from svi_tpu_torch.pipelines import hunyuan_image as tpipe_mod
from svi_tpu_torch.prompters import hunyuan_dit_prompter as tprompt
from svi_tpu_torch.prompters import sp_tokenizer as tsp

import torch_sd_fixtures as fx
import torch_video_fixtures as vfx

F32_REL, ATTN_TOL, LEVELS = 1e-4, 1e-5, 1
PROMPTS = ["一只橘色的猫坐在窗台上，阳光明媚", "a cat 在窗台上 sleeping, 4K, 高清!",
           "长城" * 60 + " and a very long English tail " * 10]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


_JITTED = {}


@pytest.fixture
def narrow(monkeypatch):
    """The narrow SD VAE plans in both packages; svi_tpu's DiT block and its
    VAE blocks jitted once per shape, its pipeline's whole-model jits off."""
    fx.patch_narrow_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)
    if not _JITTED:
        _JITTED["block"] = jax.jit(jhy._block, static_argnames=("num_heads", "head_dim"))
    monkeypatch.setattr(jhy, "_block", _JITTED["block"])
    monkeypatch.setattr(jpipe_mod, "jax", types.SimpleNamespace(jit=lambda f, **kw: f,
                                                                tree=jax.tree))


@pytest.fixture(scope="module")
def sds():
    mp = pytest.MonkeyPatch()
    fx.patch_narrow_plans(mp)
    out = vfx.hunyuan_dit_state_dicts(seed=51)
    mp.undo()
    return out


def _inputs(seed, b=2, hw=16):
    rng = np.random.default_rng(seed)
    d = vfx.HY_DIT
    mask = np.ones((b, 77), np.int64)
    mask[:, 40:] = 0
    mask_t5 = np.ones((b, 256), np.int64)
    mask_t5[:, 100:] = 0
    return dict(latents=(rng.standard_normal((b, 4, hw, hw))).astype(np.float32),
                text=(rng.standard_normal((b, 77, d["text_dim"])) * 0.3).astype(np.float32),
                t5=(rng.standard_normal((b, 256, d["t5_dim"])) * 0.3).astype(np.float32),
                mask=mask, mask_t5=mask_t5, t=np.array([391.0] * b, np.float32),
                size=np.array([[128.0, 128, 128, 128, 0, 0]] * b, np.float32))


def test_calc_rope_matches_svi_tpu():
    for h, w in [(512, 512), (768, 1280), (1024, 1024), (64, 96)]:
        for ours, theirs in zip(thy.calc_rope(h, w), jhy.calc_rope(h, w)):
            np.testing.assert_array_equal(ours, theirs)
    assert thy._fill_resize_and_crop((30, 50), 32) == jhy._fill_resize_and_crop((30, 50), 32)


@pytest.mark.parametrize("max_length", [77, 16])
def test_bert_tokenizer_matches_svi_tpu(max_length):
    """Chinese, mixed and over-long prompts (truncated to max_length): ids
    and masks equal, one prompt at a time and as a batch."""
    ours, theirs = tsp.default_bert_tokenizer(), jsp.default_bert_tokenizer()
    for batch in [[p] for p in PROMPTS] + [PROMPTS]:
        a = ours(batch, max_length=max_length)
        b = theirs(batch, max_length=max_length)
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
        np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
    assert ours(PROMPTS[2], max_length=max_length).attention_mask.sum() == max_length


def test_d88_route_plain_version_matches_svi_tpus_xla():
    """flash_fwd_bnsd's plain version (what the CPU runs; the card's D88
    kernel is held against it) at Hunyuan-DiT's head dim, self- (Sq = Sk)
    and cross-attention (Sk = 77 + 256), against svi_tpu's _flash_fwd_xla."""
    assert tattn._fwd_route(torch.float32, 88) == "f32"
    rng = np.random.default_rng(8)
    for sq, sk in ((96, 96), (96, 333)):
        q, k, v = (rng.standard_normal((2, 16, s, 88)).astype(np.float32) for s in (sq, sk, sk))
        want_o, want_l = jattn.flash_attention_with_lse(*map(jnp.asarray, (q, k, v)),
                                                        force_xla=True)
        got_o, got_l = tattn.flash_fwd_bnsd(*map(torch.from_numpy, (q, k, v)))
        np.testing.assert_allclose(fx.np32(got_o), np.asarray(want_o), atol=ATTN_TOL, rtol=0)
        np.testing.assert_allclose(fx.np32(got_l), np.asarray(want_l), atol=ATTN_TOL, rtol=0)


def test_hunyuan_dit_forward_matches_svi_tpu(narrow, sds):
    """Untiled (8 x 8 latents, the pipeline test's shape, so the jitted
    blocks are shared) and tiled (2 x 2-patch tiles, stride 1, one tile's
    tables), B1, loading the reference's names and svi_tpu's pytree."""
    jdit = jhy.hunyuan_dit_params_from_torch(fx.to_numpy(sds["dit"]))
    tdits = (thy.hunyuan_dit_params_from_torch(sds["dit"], device="cpu"),
             thy.params_from_jax(jdit, device="cpu"))
    x = _inputs(52, b=1, hw=8)
    args = [x[k] for k in ("latents", "text", "t5", "mask", "mask_t5", "t", "size")]
    hd = vfx.HY_HEAD
    for freqs, kw in ((jhy.calc_rope(64, 64, head_size=hd), {}),
                      (jhy.calc_rope(32, 32, head_size=hd),
                       dict(tiled=True, tile_size=2, tile_stride=1))):
        a = list(args)
        want = np.asarray(jhy.hunyuan_dit_forward(jdit, *map(jnp.asarray, a), freqs,
                                                  num_layers_down=vfx.HY_DOWN, **kw))
        with torch.no_grad():
            for dit in tdits:
                got = thy.hunyuan_dit_forward(dit, *map(torch.from_numpy, a), freqs,
                                              num_layers_down=vfx.HY_DOWN, **kw)
                assert got.shape == want.shape == (1, 4, 8, 8)
                assert fx.rel(fx.np32(got), want) < F32_REL


class _Encoder:
    """A seeded embedding table standing in for BERT or mT5: (ids, mask,
    clip_skip) -> (B, S, dim) torch states, zero where the mask is 0."""

    def __init__(self, vocab, dim, seed):
        self.table = torch.from_numpy(
            np.random.default_rng(seed).standard_normal((vocab, dim)).astype(np.float32) * 0.3)

    def __call__(self, ids, mask, clip_skip=1):
        return self.table[ids.long() % self.table.shape[0]] * mask[..., None].float() / clip_skip


def _prompters():
    d = vfx.HY_DIT
    bert, t5 = _Encoder(50000, d["text_dim"], 1), _Encoder(32128, d["t5_dim"], 2)
    return (jprompt.HunyuanDiTPrompter(bert, None, t5, jsp.default_t5_tokenizer()),
            tprompt.HunyuanDiTPrompter(bert, None, t5, tsp.default_t5_tokenizer()))


def test_prompter_matches_svi_tpu():
    jp, tp = _prompters()
    for prompt in PROMPTS:
        for a, b in zip(tp(prompt, clip_skip=2), jp(prompt, clip_skip=2)):
            np.testing.assert_array_equal(a, b)


def test_hunyuan_image_pipeline_matches_svi_tpu(narrow, sds, monkeypatch):
    """HunyuanDiTImagePipeline at 64 x 64, 3 steps, CFG 5, through each
    package's prompter wrapper (the rotary tables at the narrow head dim in
    both): the decoded image within F32_REL, the uint8 image within LEVELS."""
    for mod in (jhy, thy):
        monkeypatch.setattr(mod, "calc_rope", functools.partial(mod.calc_rope,
                                                                 head_size=vfx.HY_HEAD))
    jp, tp = _prompters()
    jdit = jhy.hunyuan_dit_params_from_torch(fx.to_numpy(sds["dit"]))
    jdec = jsd.sd_vae_decoder_params_from_torch(fx.to_numpy(sds["vae_decoder"]))
    tdit = thy.hunyuan_dit_params_from_torch(sds["dit"], device="cpu")
    tdec = tsd.sd_vae_decoder_params_from_torch(sds["vae_decoder"], device="cpu")
    kw = dict(negative_prompt="模糊", cfg_scale=5.0, height=64, width=64, num_inference_steps=3,
              seed=9)
    decoded = {}
    jpipe = jpipe_mod.HunyuanDiTImagePipeline(jdit, jpipe_mod.HunyuanTextEncoderWrapper(
        jp.bert_model, None, jp.t5_model, jp.t5_tokenizer), vae_decoder_params=jdec,
        num_layers_down=vfx.HY_DOWN)
    jpipe.vae_output_to_image = lambda out, f=jpipe.vae_output_to_image: (
        decoded.setdefault("jax", np.asarray(out)), f(out))[1]
    want = np.asarray(jpipe(PROMPTS[1], **kw))
    tpipe = tpipe_mod.HunyuanDiTImagePipeline(tdit, tpipe_mod.HunyuanTextEncoderWrapper(
        tp.bert_model, None, tp.t5_model, tp.t5_tokenizer), vae_decoder_params=tdec,
        num_layers_down=vfx.HY_DOWN)
    tpipe.vae_output_to_image = lambda out, f=tpipe.vae_output_to_image: (
        decoded.setdefault("torch", fx.np32(out)), f(out))[1]
    got = tpipe(PROMPTS[1], **kw)
    assert fx.rel(decoded["torch"], decoded["jax"]) < F32_REL
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= LEVELS
