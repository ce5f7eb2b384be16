"""The video post-processor interface, port of svi_tpu/processors/base.py."""


class VideoProcessor:
    """A callable from a list of (H, W, 3) uint8 frames to a list of frames."""

    def __call__(self, rendered_frames, **kwargs):
        raise NotImplementedError
