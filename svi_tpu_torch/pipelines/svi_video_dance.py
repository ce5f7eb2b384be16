"""SVI-Dance: per-clip generation conditioned on a DWPose skeleton video.

Port of svi_tpu/pipelines/svi_video_dance.py: the pose video is embedded by
the 7-conv stack (models.pose_embedding) into patch-grid tokens that are
added to the DiT's patch tokens (`add_condition`); with cond_wo_pose=True
(the drivers' setting) the uncond CFG branch receives the pose too, else
zeros. The embedding's weights come from the LoRA file, through the model
manager's side modules.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import pose_embedding
from .svi_video import SVIVideoPipeline


class SVIDanceVideoPipeline(SVIVideoPipeline):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dwpose_embedding = None  # models.pose_embedding.PoseEmbedding, f32

    def fetch_models(self, model_manager):
        super().fetch_models(model_manager)
        side = {k: v for k, v in model_manager.state_dict_new_module.items()
                if "dwpose_embedding" in k}
        if side:
            self.dwpose_embedding = pose_embedding.params_from_torch_state_dict(
                side, device=self.device)
        return self

    @staticmethod
    def from_model_manager(model_manager, torch_dtype=None, device="cuda", use_usp=False,
                           is_test=False, num_train_timesteps=1000):
        pipe = SVIDanceVideoPipeline(device=device,
                                     torch_dtype=torch_dtype or model_manager.dtype,
                                     is_test=is_test, num_train_timesteps=num_train_timesteps)
        return pipe.fetch_models(model_manager).enable_usp(use_usp)

    @torch.inference_mode()
    def encode_pose(self, humanpose_data) -> torch.Tensor:
        """Pose video (3, F, H, W) in [0, 255] -> add_condition tokens
        (1, S, dim), rounded through bf16 whatever the pipeline's dtype, as
        the reference's pipeline rounds them."""
        if self.dwpose_embedding is None:
            raise RuntimeError("no dwpose_embedding weights loaded (they come with the "
                               "SVI-Dance LoRA file)")
        pose = torch.from_numpy(np.asarray(humanpose_data, np.float32))[None].to(self.device)
        return self.dwpose_embedding(pose).to(torch.bfloat16).to(self.dtype)

    def __call__(self, *args, humanpose_data=None, cond_wo_pose=True, **kwargs):
        """The base pipeline's clip, with the pose video `humanpose_data`
        (3, num_frames, H, W) in [0, 255] (None: no pose); cond_wo_pose keeps
        the pose in the uncond branch."""
        add_condition = None
        if humanpose_data is not None:
            if isinstance(humanpose_data, torch.Tensor):
                humanpose_data = humanpose_data.cpu().numpy()
            cond = self.encode_pose(humanpose_data)
            add_condition = (cond, cond if cond_wo_pose else None)
        return super().__call__(*args, add_condition=add_condition, **kwargs)
