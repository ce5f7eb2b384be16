"""SVI-Talk: per-clip generation conditioned on speech.

Port of svi_tpu/pipelines/svi_video_talk.py: the three CFG branches (cond,
drop-text, null audio) run as one DiT forward at batch 3; every block of
the audio DiT (multitalk or customtalk) attends per latent frame to the
audio tokens that `audio_proj_forward` makes from wav2vec2 windows. With
TeaCache the audio projection runs once a clip and one cache serves the
batched forward (its decisions depend on the timestep only). The wav2vec2
pass runs once per audio file; later clips re-slice the cached embedding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import audio as audio_utils
from .svi_video import SVIVideoPipeline


class SVITalkVideoPipeline(SVIVideoPipeline):
    def __init__(self, *args, wav2vec_path=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.wav2vec = None  # models.wav2vec2.Wav2Vec2 on the pipeline's device
        if wav2vec_path is not None:
            self.wav2vec = audio_utils.load_wav2vec(wav2vec_path, device=self.device)
        self._audio_emb_cache = {}  # audio_path -> (s, 12, 768)
        self._audio_state = None

    @staticmethod
    def from_model_manager(model_manager, torch_dtype=None, device="cuda", use_usp=False,
                           is_test=False, num_train_timesteps=1000, wav2vec_path=None):
        """use_usp is accepted and ignored, as in the JAX package (its talk
        pipeline has no sequence-parallel forward)."""
        pipe = SVITalkVideoPipeline(device=device, torch_dtype=torch_dtype or model_manager.dtype,
                                    is_test=is_test, num_train_timesteps=num_train_timesteps,
                                    wav2vec_path=wav2vec_path)
        return pipe.fetch_models(model_manager)

    # -- audio ------------------------------------------------------------------

    def get_audio_embedding(self, audio_path, num_frames, audio_start_idx=0) -> np.ndarray:
        """An audio file -> the windows (1, num_frames, 5, 12, 768) of its
        frames from audio_start_idx on. The file's embedding is computed
        once and cached by path."""
        emb = self._audio_emb_cache.get(audio_path)
        if emb is None:
            if self.wav2vec is None:
                raise RuntimeError("pass wav2vec_path, or a precomputed audio_embed")
            emb = audio_utils.wav2vec_embedding(audio_utils.load_audio(audio_path), None,
                                                  self.wav2vec)
            self._audio_emb_cache[audio_path] = emb
        return audio_utils.slice_audio_windows(emb, num_frames, audio_start_idx)

    def preprocess_audio(self, audio_embed, audio_window=5, vae_scale=4):
        """Windows (1, F, audio_window, 12, 768) -> (first, later) groups on
        the device, in the pipeline's dtype (`audio_utils.regroup_audio_windows`)."""
        first, latter = audio_utils.regroup_audio_windows(np.asarray(audio_embed, np.float32),
                                                          audio_window, vae_scale)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device, self.dtype)
                     for a in (first, latter))

    # -- denoising ----------------------------------------------------------------

    def _sample_talk(self, latents, ctx_pos, ctx_neg, image_emb, cfg_text, cfg_audio,
                     audio_tuple, audio_tuple_null, tea_cache=None, progress_bar_cmd=None):
        """Euler loop over one batch-3 DiT forward a step: cond (text, audio),
        drop-text (negative text, audio), uncond (negative text, null audio);
        pred = uncond + cfg_text (cond - drop_text) + cfg_audio (drop_text -
        uncond), in f32."""
        dit = self.dit
        sigmas = self.scheduler.sigmas.to(self.device)
        timesteps = self.scheduler.timesteps.to(self.device)
        n = len(timesteps)
        clip_feature = image_emb.get("clip_feature")
        y = image_emb.get("y")
        b = latents.shape[0]

        def batched(t):
            return None if t is None else torch.cat([t] * 3, dim=0)

        ctx3 = torch.cat([ctx_pos, ctx_neg, ctx_neg], dim=0)
        audio3 = tuple(torch.cat([a, a, a_null], dim=0)
                       for a, a_null in zip(audio_tuple, audio_tuple_null))
        clip3, y3 = batched(clip_feature), batched(y)
        n_img = clip_feature.shape[1] if (dit.cfg.has_image_input
                                          and clip_feature is not None) else 257
        audio_embed = None if tea_cache is None else dit.audio_proj_forward(*audio3)
        for i in (progress_bar_cmd or iter)(range(n)):
            t = timesteps[i:i + 1]
            xin = batched(latents)
            if tea_cache is None:
                out = dit(xin, t, ctx3, clip3, y3, audio_embed_tuple=audio3)
            else:
                tokens, ctx_emb, t_emb, t_mod, grid = dit.forward_prelude(xin, t, ctx3, clip3, y3)
                if tea_cache.check(tokens, t_mod):
                    tokens = tea_cache.update(tokens)
                else:
                    tokens = dit.forward_blocks(tokens, ctx_emb, t_mod, grid,
                                                num_img_tokens=n_img, audio_embed=audio_embed)
                    tea_cache.store(tokens)
                out = dit.forward_head(tokens, t_emb, grid)
            cond, drop_text, uncond = (o.float() for o in out.split(b))
            pred = uncond + cfg_text * (cond - drop_text) + cfg_audio * (drop_text - uncond)
            sig_next = sigmas[i + 1] if i + 1 < n else torch.zeros((), device=self.device)
            latents = (latents.float() + pred * (sig_next - sigmas[i])).to(latents.dtype)
        return latents

    # -- entry ----------------------------------------------------------------------

    def __call__(self, *args, audio_path=None, audio_embed=None, audio_start_idx=0,
                 cfg_scale=None, num_frames=81, **kwargs):
        """The base pipeline's clip, conditioned on audio_path (its windows
        from audio_start_idx on) or on precomputed windows audio_embed (1,
        num_frames, 5, 12, 768); cfg_scale: a number, or dict(text=...,
        audio=...) (audio defaults to text). Without audio, the base
        pipeline's clip at cfg_scale text."""
        if isinstance(cfg_scale, dict):
            cfg_text = cfg_scale.get("text", 5.0)
            cfg_audio = cfg_scale.get("audio", cfg_text)
        else:
            cfg_text = cfg_audio = cfg_scale if cfg_scale is not None else 5.0
        if audio_embed is None and audio_path is not None:
            audio_embed = self.get_audio_embedding(audio_path, num_frames, audio_start_idx)
        if audio_embed is None:
            return super().__call__(*args, cfg_scale=cfg_text, num_frames=num_frames, **kwargs)
        audio_embed = np.asarray(audio_embed, np.float32)
        self._audio_state = (self.preprocess_audio(audio_embed),
                             self.preprocess_audio(np.zeros_like(audio_embed)),
                             cfg_text, cfg_audio)
        try:
            return super().__call__(*args, cfg_scale=cfg_text, num_frames=num_frames, **kwargs)
        finally:
            self._audio_state = None

    def _sample(self, latents, ctx_pos, ctx_neg, image_emb, cfg_scale, tea_cache=None,
                progress_bar_cmd=None, add_condition=None):
        if self._audio_state is None:
            return super()._sample(latents, ctx_pos, ctx_neg, image_emb, cfg_scale, tea_cache,
                                   progress_bar_cmd, add_condition)
        audio_tuple, audio_tuple_null, cfg_text, cfg_audio = self._audio_state
        return self._sample_talk(latents, ctx_pos, ctx_neg, image_emb, cfg_text, cfg_audio,
                                 audio_tuple, audio_tuple_null, tea_cache, progress_bar_cmd)
