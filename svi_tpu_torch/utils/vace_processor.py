"""VACE video / image preprocessing, port of svi_tpu/utils/vace_processor.py:
`VaceImageProcessor` (an aspect-keeping cover resize, a centre crop and
[-1, 1] normalisation, the output size from a latent-token budget),
`VaceVideoProcessor` (frame ids and a crop box chosen from a seq_len token
budget, default or keep-last sampling; the random start drawn from svi_tpu's
numpy generator, in its order) and `prepare_source` (zero / one fills for a
missing video and mask, reference images letterboxed onto a white canvas).

Host-side conditioning preparation: numpy arrays in and out, (C, T, H, W)
in [-1, 1]. Pillow is imported by the functions that need it, not at the
top; videos decode through decord where installed, else imageio. The
letterbox's resize is svi_tpu's `jax.image.resize(..., "bilinear")` written
in torch (`_resize_bilinear`): a triangle kernel widened by the shrink
factor (antialiased) and normalised per output sample, one axis at a time.
"""

from __future__ import annotations

import numpy as np
import torch


def _pillow_convert(image, cvt_type="RGB"):
    """Alpha-aware conversion onto a white background."""
    from PIL import Image

    if image.mode != cvt_type:
        if image.mode == "P":
            image = image.convert(f"{cvt_type}A")
        if image.mode == f"{cvt_type}A":
            bg = Image.new(cvt_type, size=(image.width, image.height),
                           color=(255, 255, 255))
            bg.paste(image, (0, 0), mask=image)
            image = bg
        else:
            image = image.convert(cvt_type)
    return image


class VaceImageProcessor:
    """Reference images at a size within the token budget."""

    def __init__(self, downsample=None, seq_len=None):
        self.downsample = downsample
        self.seq_len = seq_len

    def _load_image(self, img_path):
        from PIL import Image

        if img_path is None or img_path == "":
            return None
        if isinstance(img_path, Image.Image):
            return _pillow_convert(img_path)
        return _pillow_convert(Image.open(img_path))

    def _resize_crop(self, img, oh, ow, normalize=True):
        """Cover-resize (LANCZOS) + center crop; normalized output is
        (C, 1, H, W) in [-1, 1]."""
        from PIL import Image

        iw, ih = img.size
        if iw != ow or ih != oh:
            scale = max(ow / iw, oh / ih)
            img = img.resize((round(scale * iw), round(scale * ih)),
                             resample=Image.Resampling.LANCZOS)
            assert img.width >= ow and img.height >= oh
            x1 = (img.width - ow) // 2
            y1 = (img.height - oh) // 2
            img = img.crop((x1, y1, x1 + ow, y1 + oh))
        if normalize:
            arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
            return ((arr - 0.5) / 0.5)[:, None]
        return img

    def _image_preprocess(self, img, oh, ow, normalize=True, **kwargs):
        return self._resize_crop(img, oh, ow, normalize)

    def load_image(self, data_key, **kwargs):
        return self.load_image_batch(data_key, **kwargs)

    def load_image_pair(self, data_key, data_key2, **kwargs):
        return self.load_image_batch(data_key, data_key2, **kwargs)

    def load_image_batch(self, *data_key_batch, normalize=True, seq_len=None,
                         **kwargs):
        """Output size chosen so (oh/dh)*(ow/dw) <= seq_len."""
        seq_len = self.seq_len if seq_len is None else seq_len
        imgs = [self._load_image(k) for k in data_key_batch]
        w, h = imgs[0].size
        dh, dw = self.downsample[1:]
        scale = min(1.0, np.sqrt(seq_len / ((h / dh) * (w / dw))))
        oh = int(h * scale) // dh * dh
        ow = int(w * scale) // dw * dw
        assert (oh // dh) * (ow // dw) <= seq_len
        imgs = [self._image_preprocess(im, oh, ow, normalize) for im in imgs]
        return (*imgs, (oh, ow))


class VaceVideoProcessor:
    """Video frames chosen within the token budget."""

    def __init__(self, downsample, min_area, max_area, min_fps, max_fps,
                 zero_start, seq_len, keep_last, **kwargs):
        self.downsample = downsample
        self.min_area = min_area
        self.max_area = max_area
        self.min_fps = min_fps
        self.max_fps = max_fps
        self.zero_start = zero_start
        self.keep_last = keep_last
        self.seq_len = seq_len
        assert seq_len >= min_area / (self.downsample[1] * self.downsample[2])

    def set_area(self, area):
        self.min_area = area
        self.max_area = area

    def set_seq_len(self, seq_len):
        self.seq_len = seq_len

    @staticmethod
    def resize_crop(video, oh, ow):
        """(T,H,W,C) uint8 -> (C,T,H,W) f32 in [-1,1]; cover-resize
        (bicubic) + center crop."""
        video = np.asarray(video)
        t, ih, iw, c = video.shape
        if ih != oh or iw != ow:
            from PIL import Image

            scale = max(ow / iw, oh / ih)
            nh, nw = round(scale * ih), round(scale * iw)
            frames = [np.asarray(
                Image.fromarray(f.astype(np.uint8)).resize(
                    (nw, nh), resample=Image.Resampling.BICUBIC),
                np.float32) for f in video]
            video = np.stack(frames, axis=0)
            assert video.shape[2] >= ow and video.shape[1] >= oh
            x1 = (video.shape[2] - ow) // 2
            y1 = (video.shape[1] - oh) // 2
            video = video[:, y1:y1 + oh, x1:x1 + ow]
        video = video.astype(np.float32).transpose(3, 0, 1, 2)
        return video / 127.5 - 1.0

    def _video_preprocess(self, video, oh, ow):
        return self.resize_crop(video, oh, ow)

    def _get_frameid_bbox_default(self, fps, frame_timestamps, h, w,
                                  crop_box, rng):
        """An fps-capped uniform window, a random start unless zero_start."""
        target_fps = min(fps, self.max_fps)
        duration = frame_timestamps[-1].mean()
        x1, x2, y1, y2 = [0, w, 0, h] if crop_box is None else crop_box
        h, w = y2 - y1, x2 - x1
        ratio = h / w
        df, dh, dw = self.downsample

        area_z = min(self.seq_len, self.max_area / (dh * dw),
                     (h // dh) * (w // dw))
        of = min((int(duration * target_fps) - 1) // df + 1,
                 int(self.seq_len / area_z))
        target_area_z = min(area_z, int(self.seq_len / of))
        oh = round(np.sqrt(target_area_z * ratio))
        ow = int(target_area_z / oh)
        of = (of - 1) * df + 1
        oh *= dh
        ow *= dw

        target_duration = of / target_fps
        begin = 0.0 if self.zero_start else rng.uniform(
            0, duration - target_duration)
        timestamps = np.linspace(begin, begin + target_duration, of)
        frame_ids = np.argmax(np.logical_and(
            timestamps[:, None] >= frame_timestamps[None, :, 0],
            timestamps[:, None] < frame_timestamps[None, :, 1]),
            axis=1).tolist()
        return frame_ids, (x1, x2, y1, y2), (oh, ow), target_fps

    def _get_frameid_bbox_adjust_last(self, fps, frame_timestamps, h, w,
                                      crop_box, rng):
        """Span the whole clip; the fps follows from the frame count."""
        duration = frame_timestamps[-1].mean()
        x1, x2, y1, y2 = [0, w, 0, h] if crop_box is None else crop_box
        h, w = y2 - y1, x2 - x1
        ratio = h / w
        df, dh, dw = self.downsample

        area_z = min(self.seq_len, self.max_area / (dh * dw),
                     (h // dh) * (w // dw))
        of = min((len(frame_timestamps) - 1) // df + 1,
                 int(self.seq_len / area_z))
        target_area_z = min(area_z, int(self.seq_len / of))
        oh = round(np.sqrt(target_area_z * ratio))
        ow = int(target_area_z / oh)
        of = (of - 1) * df + 1
        oh *= dh
        ow *= dw

        target_duration = duration
        target_fps = of / target_duration
        timestamps = np.linspace(0.0, target_duration, of)
        frame_ids = np.argmax(np.logical_and(
            timestamps[:, None] >= frame_timestamps[None, :, 0],
            timestamps[:, None] <= frame_timestamps[None, :, 1]),
            axis=1).tolist()
        return frame_ids, (x1, x2, y1, y2), (oh, ow), target_fps

    def _get_frameid_bbox(self, fps, frame_timestamps, h, w, crop_box, rng):
        if self.keep_last:
            return self._get_frameid_bbox_adjust_last(
                fps, frame_timestamps, h, w, crop_box, rng)
        return self._get_frameid_bbox_default(
            fps, frame_timestamps, h, w, crop_box, rng)

    def load_video(self, data_key, crop_box=None, seed=2024, **kwargs):
        return self.load_video_batch(data_key, crop_box=crop_box, seed=seed,
                                     **kwargs)

    def load_video_pair(self, data_key, data_key2, crop_box=None, seed=2024,
                        **kwargs):
        return self.load_video_batch(data_key, data_key2, crop_box=crop_box,
                                     seed=seed, **kwargs)

    def load_video_batch(self, *data_key_batch, crop_box=None, seed=2024,
                         **kwargs):
        """decord when available, else imageio (uniform-fps timestamps)."""
        rng = np.random.default_rng(seed + hash(data_key_batch[0]) % 10000)
        try:
            import decord

            decord.bridge.set_bridge("native")
            readers = [decord.VideoReader(k) for k in data_key_batch]
            fps = readers[0].get_avg_fps()
            length = min(len(r) for r in readers)
            frame_timestamps = np.array(
                [readers[0].get_frame_timestamp(i) for i in range(length)],
                dtype=np.float32)
            h, w = readers[0][0].shape[:2]
            get_batch = [
                (lambda ids, _r=r: np.stack([np.asarray(_r[i]) for i in ids]))
                for r in readers]
        except ImportError:
            import imageio.v2 as imageio

            all_frames, fps = [], None
            for k in data_key_batch:
                reader = imageio.get_reader(k)
                meta = reader.get_meta_data()
                fps = fps or meta.get("fps", 24.0)
                all_frames.append([np.asarray(f) for f in reader])
                reader.close()
            length = min(len(f) for f in all_frames)
            step = 1.0 / fps
            frame_timestamps = np.stack([
                np.arange(length, dtype=np.float32) * step,
                (np.arange(length, dtype=np.float32) + 1) * step], axis=1)
            h, w = all_frames[0][0].shape[:2]
            get_batch = [
                (lambda ids, _f=f: np.stack([_f[i] for i in ids]))
                for f in all_frames]

        frame_ids, (x1, x2, y1, y2), (oh, ow), fps = self._get_frameid_bbox(
            fps, frame_timestamps, h, w, crop_box, rng)
        videos = [gb(frame_ids)[:, y1:y2, x1:x2, :] for gb in get_batch]
        videos = [self._video_preprocess(v, oh, ow) for v in videos]
        return (*videos, frame_ids, (oh, ow), fps)


def _weights(in_size: int, out_size: int) -> torch.Tensor:
    """(in_size, out_size) f32 weights of one axis, as `jax.image.resize`'s
    bilinear method computes them (`compute_weight_mat`): the triangle
    kernel at each output sample's centre, widened by the shrink factor,
    normalised per output sample, zero where the sample lies outside."""
    inv_scale = 1.0 / (out_size / in_size)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    x = x / max(inv_scale, 1.0)
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(C, H, W) f32 -> (C, nh, nw): each axis whose size changes through its
    weight matrix, in f32."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    if nh != x.shape[1]:
        x = torch.einsum("chw,hi->ciw", x, _weights(x.shape[1], nh))
    if nw != x.shape[2]:
        x = torch.einsum("chw,wj->chj", x, _weights(x.shape[2], nw))
    return x.numpy()


def prepare_source(src_video, src_mask, src_ref_images, num_frames,
                   image_size, device=None):
    """Missing videos -> zeros, missing masks -> ones; reference images are
    letterboxed onto a white [-1,1] canvas with an antialiased bilinear
    resize. numpy in and out (`device` is accepted and unused, as in
    svi_tpu)."""
    for i, (sub_v, sub_m) in enumerate(zip(src_video, src_mask)):
        if sub_v is None and sub_m is None:
            src_video[i] = np.zeros(
                (3, num_frames, image_size[0], image_size[1]), np.float32)
            src_mask[i] = np.ones(
                (1, num_frames, image_size[0], image_size[1]), np.float32)
    for i, ref_images in enumerate(src_ref_images):
        if ref_images is None:
            continue
        for j, ref_img in enumerate(ref_images):
            if ref_img is None or ref_img.shape[-2:] == tuple(image_size):
                continue
            canvas_h, canvas_w = image_size
            ref_h, ref_w = ref_img.shape[-2:]
            white = np.ones((3, 1, canvas_h, canvas_w), np.float32)
            scale = min(canvas_h / ref_h, canvas_w / ref_w)
            nh, nw = int(ref_h * scale), int(ref_w * scale)
            resized = _resize_bilinear(
                np.asarray(ref_img, np.float32).reshape(ref_img.shape[0], ref_h, ref_w), nh, nw)
            top = (canvas_h - nh) // 2
            left = (canvas_w - nw) // 2
            white[:, 0, top:top + nh, left:left + nw] = resized
            src_ref_images[i][j] = white
    return src_video, src_mask, src_ref_images
