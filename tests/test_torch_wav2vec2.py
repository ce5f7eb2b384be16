"""The port's wav2vec2 tower (svi_tpu_torch/models/wav2vec2.py) against
svi_tpu's, on the CPU, at the fixed full config that svi_tpu's forward always
builds (chinese-wav2vec2-base: 7 convs of 512, 12 layers of 768, 12 heads):
the 12 hidden states of a 0.4 s waveform, the align_corners interpolation,
the input normalization, `wav2vec_embedding`, and both checkpoint formats
that `load_params` reads, written by the port's writer in transformers'
naming and read by both packages.

The weights are the port's seeded `init_params`, given to both packages
through one state dict in transformers' naming.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svi_tpu.models import wav2vec2 as jw2v
from svi_tpu.utils import audio as jaudio
from svi_tpu_torch.models import wav2vec2 as tw2v
from svi_tpu_torch.utils import audio as taudio
from svi_tpu_torch.utils.safetensors_io import save_file

# f32 through 7 convs (the first over 10 taps, then 512-channel sums), the
# grouped positional conv (48 x 128 taps) and 12 post-norm layers, summed in
# another order by each framework; relative to the largest |state|
STATE_REL = 1e-4


@pytest.fixture(scope="module")
def tower():
    model = tw2v.init_params(seed=0, device="cpu")
    sd = tw2v.torch_state_dict_from_params(model)
    return model, sd, jw2v.params_from_torch({k: v.numpy() for k, v in sd.items()})


def test_hidden_states_match_svi_tpu(tower):
    model, _, params = tower
    speech = np.random.default_rng(0).standard_normal(6400).astype(np.float32)  # 0.4 s
    x = tw2v.normalize_input(speech)[None]
    np.testing.assert_array_equal(x[0], jw2v.normalize_input(speech))
    want = np.asarray(jw2v.forward(params, jnp.asarray(x), 10))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), 10).numpy()
    assert got.shape == want.shape == (12, 1, 10, 768)
    assert np.abs(got - want).max() <= STATE_REL * np.abs(want).max()
    # the embedding helper: (frames, 12, 768), as svi_tpu's native engine
    emb_t = taudio.wav2vec_embedding(speech, None, model)
    emb_j = jaudio.wav2vec_embedding(speech, None, ("jax", params))
    assert emb_t.shape == emb_j.shape == (10, 12, 768)
    assert np.abs(emb_t - emb_j).max() <= STATE_REL * np.abs(emb_j).max()


@pytest.mark.parametrize("out_len", [1, 5, 13, 29])
def test_linear_interpolate_matches_svi_tpu_and_torch(out_len):
    """align_corners at s == out_len (no interpolation) and at out_len == 1."""
    x = np.random.default_rng(2).standard_normal((1, 13, 4)).astype(np.float32)
    got = tw2v.linear_interpolate(torch.from_numpy(x), out_len).numpy()
    np.testing.assert_allclose(got, np.asarray(jw2v.linear_interpolate(jnp.asarray(x), out_len)),
                               atol=1e-6, rtol=0)
    ref = torch.nn.functional.interpolate(torch.from_numpy(x).transpose(1, 2), size=out_len,
                                          mode="linear", align_corners=True).transpose(1, 2)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("fmt", ["model.safetensors", "pytorch_model.bin"])
def test_load_params_reads_both_formats(tower, tmp_path, fmt):
    """The directory's checkpoint under the 'wav2vec2.' prefix the reference's
    files may carry; the port's loader gives back every tensor, and svi_tpu's
    loader reads the same file to the same pytree."""
    model, sd, params = tower
    prefixed = {f"wav2vec2.{k}": v for k, v in sd.items()}
    if fmt.endswith(".safetensors"):
        save_file(prefixed, str(tmp_path / fmt))
    else:
        torch.save(prefixed, tmp_path / fmt)
    got = dict(tw2v.load_params(str(tmp_path), device="cpu").named_parameters())
    want = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        # the positional conv is folded from weight_g and weight_v again
        tol = 1e-6 if k.startswith("pos_conv.w") else 0
        torch.testing.assert_close(got[k], t, atol=tol, rtol=tol)
    again = jw2v.load_params(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(again["layers"]["fc2"]["w"]),
                                  np.asarray(params["layers"]["fc2"]["w"]))
    np.testing.assert_allclose(np.asarray(again["pos_conv"]["w"]),
                               np.asarray(params["pos_conv"]["w"]), atol=1e-6, rtol=0)
