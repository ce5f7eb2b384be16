"""The audio features of SVI-Talk (port of svi_tpu/utils/audio.py).

`load_audio` takes the same branches as the JAX package on the same machine:
librosa where it is installed, else scipy's wavfile reader and a polyphase
resample to 16 kHz; then pyloudnorm's loudness normalization where that is
installed. `load_wav2vec` loads the native tower (models.wav2vec2) from a
checkpoint directory, or with engine="torch" transformers' Wav2Vec2Model and
its feature extractor (the JAX package's parity fallback; it raises where
transformers is not installed). The window helpers are numpy, as there.
"""

from __future__ import annotations

from math import gcd
from typing import NamedTuple

import numpy as np
import torch

AUDIO_SR = 16000
AUDIO_FPS = 25
AUDIO_WINDOW = 5
VAE_SCALE = 4


def load_audio(path: str, sr: int = AUDIO_SR) -> np.ndarray:
    """An audio file -> mono float32 at `sr`, loudness-normalized to -23 LUFS
    when pyloudnorm is installed."""
    try:
        import librosa

        wav, _ = librosa.load(path, sr=sr)
    except ImportError:
        from scipy.io import wavfile
        from scipy.signal import resample_poly

        src_sr, wav = wavfile.read(path)
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 2:
            wav = wav.mean(axis=1)
        if wav.dtype.kind != "f":
            wav = wav / 32768.0
        if np.abs(wav).max() > 10:  # int-scaled float
            wav = wav / 32768.0
        if src_sr != sr:
            g = gcd(int(src_sr), sr)
            wav = resample_poly(wav, sr // g, int(src_sr) // g).astype(np.float32)
    try:
        import pyloudnorm as pyln

        meter = pyln.Meter(sr)
        loudness = meter.integrated_loudness(wav)
        if abs(loudness) <= 100:
            wav = pyln.normalize.loudness(wav, loudness, -23)
    except ImportError:
        pass
    return np.asarray(wav, np.float32)


WAV2VEC_ENGINES = ("native", "torch")


class TransformersWav2Vec2(NamedTuple):
    """transformers' Wav2Vec2Model and Wav2Vec2FeatureExtractor (engine="torch")."""

    feature_extractor: object
    model: object


def load_wav2vec(path: str, device="cuda", engine: str = "native"):
    """The wav2vec2 tower from a local chinese-wav2vec2-base directory, on
    `device`: engine "native" (the default) reads model.safetensors or
    pytorch_model.bin into the port's tower (models.wav2vec2); engine "torch"
    builds transformers' Wav2Vec2Model and its feature extractor from the
    directory (config.json and preprocessor_config.json beside the weights),
    the JAX package's parity fallback."""
    if engine == "native":
        from ..models import wav2vec2

        return wav2vec2.load_params(path, device=device)
    if engine != "torch":
        raise ValueError(f"wav2vec2 engine {engine!r}; choose from {WAV2VEC_ENGINES}")
    try:
        from transformers import Wav2Vec2FeatureExtractor, Wav2Vec2Model
    except ImportError as e:
        raise ImportError("the wav2vec2 engine 'torch' needs the transformers package, which "
                          "is not installed; the native tower (engine='native') needs only "
                          "torch") from e
    model = Wav2Vec2Model.from_pretrained(path, local_files_only=True).eval().to(device)
    fe = Wav2Vec2FeatureExtractor.from_pretrained(path, local_files_only=True)
    return TransformersWav2Vec2(fe, model)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def wav2vec_embedding(speech: np.ndarray, feature_extractor, model,
                      sr: int = AUDIO_SR) -> np.ndarray:
    """speech -> (video_frames, 12, 768): the 12 encoder hidden states of the
    normalized waveform, its conv features interpolated to 25 frames a
    second, on the tower's device. `model` is the native tower or the
    TransformersWav2Vec2 pair of `load_wav2vec(engine="torch")`;
    feature_extractor is the transformers engine's input processor (None:
    the pair's own), unused by the native tower, as in the JAX package."""
    video_length = int(len(speech) / sr * AUDIO_FPS)
    if isinstance(model, TransformersWav2Vec2):
        import torch.nn.functional as F

        tower = model.model
        extract = feature_extractor or model.feature_extractor
        inputs = extract(speech, sampling_rate=sr, return_tensors="pt").input_values
        feats = tower.feature_extractor(inputs.to(_model_device(tower)))  # (1, c, s')
        feats = F.interpolate(feats, size=video_length, align_corners=True, mode="linear")
        hidden, _ = tower.feature_projection(feats.transpose(1, 2))
        out = tower.encoder(hidden, output_hidden_states=True)
        emb = torch.stack(out.hidden_states[1:], dim=1)[0]  # (12, s, 768)
        return emb.permute(1, 0, 2).float().cpu().numpy()
    from ..models import wav2vec2

    x = torch.from_numpy(wav2vec2.normalize_input(speech)[None]).to(_model_device(model))
    states = model(x, video_length)  # (12, 1, s, 768)
    return states[:, 0].transpose(0, 1).float().cpu().numpy()


def slice_audio_windows(audio_embed: np.ndarray, num_frames: int,
                        audio_start_idx: int = 0) -> np.ndarray:
    """Per-frame windows of ±2 frames, clamped at the ends:
    (s, 12, 768) -> (1, num_frames, 5, 12, 768)."""
    indices = np.arange(2 * 2 + 1) - 2
    centers = np.arange(audio_start_idx, audio_start_idx + num_frames)[:, None] + indices[None, :]
    centers = np.clip(centers, 0, audio_embed.shape[0] - 1)
    return audio_embed[centers][None, ...]


def regroup_audio_windows(audio_embed: np.ndarray, audio_window: int = AUDIO_WINDOW,
                          vae_scale: int = VAE_SCALE):
    """(1, F, 5, 12, 768) -> (first (1, 1, 5, 12, 768), later (1, (F-1)/4,
    8, 12, 768)): for each group of 4 frames of a latent frame, the first
    frame's leading half-window, the middle frames' centers and the last
    frame's trailing half-window."""
    first = audio_embed[:, :1]
    latter = audio_embed[:, 1:]
    b, fm1, w, blk, c = latter.shape
    n_t = fm1 // vae_scale
    latter = latter.reshape(b, n_t, vae_scale, w, blk, c)
    mid = audio_window // 2
    head = latter[:, :, :1, : mid + 1].reshape(b, n_t, -1, blk, c)
    middle = latter[:, :, 1:-1, mid: mid + 1].reshape(b, n_t, -1, blk, c)
    tail = latter[:, :, -1:, mid:].reshape(b, n_t, -1, blk, c)
    return first, np.concatenate([head, middle, tail], axis=2)


def cut_audio_embedding(audio_embed: np.ndarray, num_frames: int, audio_start_idx: int = 0,
                        audio_end_idx: int = 81):
    """Training-side slicing and grouping of a stored embedding (12, s, 768)
    or (s, 12, 768). Returns (first (1, 5, 12, 768), later (n_t, 8, 12,
    768)), without the batch axis. audio_end_idx is taken and not read, as in
    the JAX package: the window is num_frames long from audio_start_idx."""
    audio_embed = np.asarray(audio_embed, np.float32)
    if audio_embed.shape[0] == 12 and audio_embed.shape[1] != 12:
        audio_embed = np.transpose(audio_embed, (1, 0, 2))  # -> (s, 12, 768)
    first, latter = regroup_audio_windows(
        slice_audio_windows(audio_embed, num_frames, audio_start_idx))
    return first[0], latter[0]
