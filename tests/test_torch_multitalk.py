"""The multi-speaker (MultiTalk) pieces of the port against svi_tpu on the
CPU: the helpers of utils/multitalk.py, `WanDiT.single_stream_multi_attention`
with two speakers, and the transformers engine of the wav2vec2 features
against the native tower. Inputs are seeded numpy arrays given to both
packages; everything runs in f32.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svi_tpu.models import wan_dit as jdit
from svi_tpu.utils import multitalk as jmt
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.models import wav2vec2 as tw2v
from svi_tpu_torch.utils import audio as taudio
from svi_tpu_torch.utils import multitalk as tmt
from svi_tpu_torch.utils.safetensors_io import save_file
from torch_checkpoint_files import WAV2VEC_CFG

# f32, the same operations in another order (softmax sums, einsums, the RoPE
# tables' cos / sin): relative to the output's largest value
REL = 1e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30), (
        np.abs(got - want).max(), np.abs(want).max())


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("T,token_frame,world,rank", [(3, 5, 4, 0), (3, 5, 4, 3), (7, 2, 3, 1)])
def test_split_token_counts_and_frame_ids(T, token_frame, world, rank):
    assert tmt.split_token_counts_and_frame_ids(T, token_frame, world, rank) == \
        jmt.split_token_counts_and_frame_ids(T, token_frame, world, rank)


def test_normalize_and_scale():
    col = _rng(0).standard_normal(50).astype(np.float32)
    got = tmt.normalize_and_scale(torch.from_numpy(col), (col.min(), col.max()), (20, 24))
    want = jmt.normalize_and_scale(jnp.asarray(col), (col.min(), col.max()), (20, 24))
    _close(got.numpy(), want)


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_calculate_x_ref_attn_map(mode):
    r = _rng(1)
    q = r.standard_normal((2, 24, 3, 16)).astype(np.float32)
    k = r.standard_normal((2, 10, 3, 16)).astype(np.float32)
    masks = (r.random((2, 10)) > 0.5).astype(np.float32)
    masks[:, 0] = 1
    got = tmt.calculate_x_ref_attn_map(*(torch.from_numpy(a) for a in (q, k, masks)), mode=mode)
    want = jmt.calculate_x_ref_attn_map(*(jnp.asarray(a) for a in (q, k, masks)), mode=mode)
    _close(got.numpy(), want)


def test_get_attn_map_with_target():
    r = _rng(2)
    grid = (3, 2, 4)
    q = r.standard_normal((1, 24, 2, 16)).astype(np.float32)
    k = r.standard_normal((1, 24, 2, 16)).astype(np.float32)
    masks = np.zeros((2, 8), np.float32)
    masks[0, :4], masks[1, 4:] = 1, 1
    got = tmt.get_attn_map_with_target(torch.from_numpy(q), torch.from_numpy(k), grid,
                                       torch.from_numpy(masks))
    want = jmt.get_attn_map_with_target(jnp.asarray(q), jnp.asarray(k), grid, jnp.asarray(masks))
    _close(got.numpy(), want)


def test_rope_1d():
    r = _rng(3)
    x = r.standard_normal((2, 3, 20, 16)).astype(np.float32)
    pos = (r.random(20) * 24).astype(np.float32)  # fractional class labels
    _close(tmt.rope_1d(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
           jmt.rope_1d(jnp.asarray(x), jnp.asarray(pos)))


def test_momentum_buffer():
    vals = [_rng(4 + i).standard_normal((1, 4, 2, 3, 3)).astype(np.float32) for i in range(3)]
    tb, jb = tmt.MomentumBuffer(-0.75), jmt.MomentumBuffer(-0.75)
    for v in vals:
        tb.update(torch.from_numpy(v))
        jb.update(jnp.asarray(v))
    _close(tb.running_average.numpy(), jb.running_average)


def test_project():
    r = _rng(7)
    v0, v1 = (r.standard_normal((2, 4, 3, 5, 5)).astype(np.float32) for _ in range(2))
    for g, w in zip(tmt.project(torch.from_numpy(v0), torch.from_numpy(v1)),
                    jmt.project(jnp.asarray(v0), jnp.asarray(v1))):
        _close(g.numpy(), w)


@pytest.mark.parametrize("momentum,eta,norm_threshold", [(None, 0.0, 55.0), (-0.75, 0.3, 2.0),
                                                         (None, 1.0, 0.0)])
def test_adaptive_projected_guidance(momentum, eta, norm_threshold):
    r = _rng(8)
    diffs = [r.standard_normal((1, 4, 3, 5, 5)).astype(np.float32) for _ in range(2)]
    cond = r.standard_normal((1, 4, 3, 5, 5)).astype(np.float32)
    tb = None if momentum is None else tmt.MomentumBuffer(momentum)
    jb = None if momentum is None else jmt.MomentumBuffer(momentum)
    for d in diffs:  # twice, so the momentum buffer carries a history
        got = tmt.adaptive_projected_guidance(torch.from_numpy(d), torch.from_numpy(cond), tb,
                                              eta=eta, norm_threshold=norm_threshold)
        want = jmt.adaptive_projected_guidance(jnp.asarray(d), jnp.asarray(cond), jb, eta=eta,
                                               norm_threshold=norm_threshold)
        _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# single_stream_multi_attention
# ---------------------------------------------------------------------------

AUDIO_DIT = dict(dim=64, in_dim=12, ffn_dim=128, out_dim=4, text_dim=48, freq_dim=32,
                 num_heads=2, num_layers=1, has_image_input=True, clip_feature_dim=40,
                 enable_multitalk=True, audio_hidden_dim=32)


@pytest.mark.parametrize("human_num,with_map", [(2, True), (1, True), (2, False)])
def test_single_stream_multi_attention_matches_jax(human_num, with_map):
    """Two speakers with a reference map (the 1-D RoPE class labels), and the
    per-frame path it takes with one speaker or no map."""
    import jax

    cfg_j = jdit.WanDiTConfig(dtype=jnp.float32, **AUDIO_DIT)
    cfg_t = tdit.WanDiTConfig(dtype=torch.float32, **AUDIO_DIT)
    params = jdit.init_params(jax.random.PRNGKey(5), cfg_j)
    dit = tdit.params_from_jax(jax.tree.map(np.asarray, params), cfg_t)
    p_j = jax.tree.map(lambda a: a[0], params["blocks"])["audio_cross_attn"]
    p_t = dit["blocks"][0]["audio_cross_attn"]
    r = _rng(9)
    f, s, na = 3, 8, 6
    x = r.standard_normal((2, f * s, 64)).astype(np.float32)
    audio = r.standard_normal((2, f, na, 32)).astype(np.float32)
    ref_map = r.random((2, f * s)).astype(np.float32) if with_map else None
    want = jdit.single_stream_multi_attention(
        p_j, cfg_j, jnp.asarray(x), jnp.asarray(audio), f,
        x_ref_attn_map=None if ref_map is None else jnp.asarray(ref_map), human_num=human_num)
    with torch.inference_mode():
        got = dit.single_stream_multi_attention(
            p_t, torch.from_numpy(x), torch.from_numpy(audio), f,
            x_ref_attn_map=None if ref_map is None else torch.from_numpy(ref_map),
            human_num=human_num)
        per_frame = dit._audio_cross_attention(p_t, torch.from_numpy(x), torch.from_numpy(audio),
                                               f)
    _close(got.numpy(), want)
    # the class labels move the two-speaker output off the per-frame path
    assert (human_num == 2 and with_map) == (not torch.equal(got, per_frame))


# ---------------------------------------------------------------------------
# the transformers wav2vec2 engine
# ---------------------------------------------------------------------------


def _transformers_dir(root, cfg):
    """A wav2vec2 directory that both engines load: the port's seeded tower
    in transformers' naming, with config.json and preprocessor_config.json
    of chinese-wav2vec2-base's kind (group-norm feature extractor, no conv
    bias, post-norm layers), at cfg's widths."""
    model = tw2v.init_params(cfg, seed=8, device="cpu")
    save_file(tw2v.torch_state_dict_from_params(model), str(root / "model.safetensors"))
    config = dict(
        architectures=["Wav2Vec2Model"], model_type="wav2vec2", hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size, hidden_act="gelu",
        conv_dim=list(cfg.conv_dim), conv_stride=list(cfg.conv_stride),
        conv_kernel=list(cfg.conv_kernel), conv_bias=False, feat_extract_norm="group",
        feat_extract_activation="gelu", num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
        do_stable_layer_norm=False, layer_norm_eps=cfg.layer_norm_eps, hidden_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
        mask_time_prob=0.0)
    (root / "config.json").write_text(json.dumps(config))
    (root / "preprocessor_config.json").write_text(json.dumps(dict(
        feature_extractor_type="Wav2Vec2FeatureExtractor", feature_size=1, sampling_rate=16000,
        padding_value=0.0, do_normalize=True, return_attention_mask=False)))
    return str(root)


def test_transformers_engine_matches_the_native_tower(tmp_path, monkeypatch):
    """The same directory through transformers' Wav2Vec2Model (engine "torch")
    and through the port's tower: the 12 hidden states of 0.4 s of audio,
    within REL of the largest state."""
    pytest.importorskip("transformers")
    monkeypatch.setenv("USE_TF", "0")  # transformers' TensorFlow import is not needed here
    path = _transformers_dir(tmp_path, WAV2VEC_CFG)
    speech = _rng(10).standard_normal(6400).astype(np.float32)
    engine = taudio.load_wav2vec(path, device="cpu", engine="torch")
    assert isinstance(engine, taudio.TransformersWav2Vec2)
    got = taudio.wav2vec_embedding(speech, engine)
    want = taudio.wav2vec_embedding(speech, taudio.load_wav2vec(path, device="cpu"))
    assert got.shape == (10, 12, 768)
    _close(got, want)


def test_wav2vec_engine_is_checked(monkeypatch, tmp_path):
    """An unknown engine raises; without transformers the torch engine raises
    an ImportError that names the native tower."""
    import builtins

    with pytest.raises(ValueError, match="engine"):
        taudio.load_wav2vec(str(tmp_path), device="cpu", engine="jax")
    real_import = builtins.__import__

    def no_transformers(name, *args, **kwargs):
        if name.split(".")[0] == "transformers":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="native"):
        taudio.load_wav2vec(str(tmp_path), device="cpu", engine="torch")

