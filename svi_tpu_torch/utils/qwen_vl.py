"""Qwen2.5-VL vision-input preparation for the prompt expander, port of
svi_tpu/utils/qwen_vl.py: `smart_resize` (factor-aligned sizes within a
pixel budget, aspect kept), `smart_nframes` (an fps- or nframes-driven frame
count rounded to FRAME_FACTOR), `fetch_image` (a PIL image, a local path, a
file:// or http(s) URL, a base64 data URI), `fetch_video`,
`extract_vision_info` and `process_vision_info` (walk chat messages and
collect their media).

Host-side preprocessing, numpy and Pillow. Pillow is imported by the
functions that need it, not at the top, so importing the module loads none;
videos decode through decord where installed, else imageio; an http(s)
URL needs `requests` (imported there).
"""

from __future__ import annotations

import base64
import math
from io import BytesIO

import numpy as np

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


def round_by_factor(number, factor):
    """Closest integer divisible by factor."""
    return round(number / factor) * factor


def ceil_by_factor(number, factor):
    return math.ceil(number / factor) * factor


def floor_by_factor(number, factor):
    return math.floor(number / factor) * factor


def smart_resize(height, width, factor=IMAGE_FACTOR, min_pixels=MIN_PIXELS,
                 max_pixels=MAX_PIXELS):
    """Both dims divisible by factor, pixel count within [min_pixels,
    max_pixels], aspect preserved."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"absolute aspect ratio must be smaller than {MAX_RATIO}, got "
            f"{max(height, width) / min(height, width)}")
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def fetch_image(ele, size_factor=IMAGE_FACTOR):
    """Accepts a PIL image, a path, a file:// or http(s) URL or a data: URI;
    returns the RGB image resized by `smart_resize`."""
    from PIL import Image

    image = ele["image"] if "image" in ele else ele["image_url"]
    image_obj = None
    if isinstance(image, Image.Image):
        image_obj = image
    elif image.startswith("http://") or image.startswith("https://"):
        import requests

        image_obj = Image.open(requests.get(image, stream=True).raw)
    elif image.startswith("file://"):
        image_obj = Image.open(image[7:])
    elif image.startswith("data:image"):
        if "base64," in image:
            _, base64_data = image.split("base64,", 1)
            image_obj = Image.open(BytesIO(base64.b64decode(base64_data)))
    else:
        image_obj = Image.open(image)
    if image_obj is None:
        raise ValueError(
            "Unrecognized image input, support local path, http url, base64 "
            f"and PIL.Image, got {image}")
    image = image_obj.convert("RGB")
    if "resized_height" in ele and "resized_width" in ele:
        resized_height, resized_width = smart_resize(
            ele["resized_height"], ele["resized_width"], factor=size_factor)
    else:
        width, height = image.size
        resized_height, resized_width = smart_resize(
            height, width, factor=size_factor,
            min_pixels=ele.get("min_pixels", MIN_PIXELS),
            max_pixels=ele.get("max_pixels", MAX_PIXELS))
    return image.resize((resized_width, resized_height))


def smart_nframes(ele, total_frames, video_fps):
    """The number of frames to sample: `nframes`, or the video's duration at
    `fps` within [min_frames, max_frames], rounded to FRAME_FACTOR."""
    assert not ("fps" in ele and "nframes" in ele), \
        "Only accept either `fps` or `nframes`"
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", FPS)
        min_frames = ceil_by_factor(
            ele.get("min_frames", FPS_MIN_FRAMES), FRAME_FACTOR)
        max_frames = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
            FRAME_FACTOR)
        nframes = total_frames / video_fps * fps
        nframes = min(max(nframes, min_frames), max_frames)
        nframes = round_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes should in interval [{FRAME_FACTOR}, {total_frames}], "
            f"but got {nframes}.")
    return int(nframes)


def _read_video(ele):
    """Decode `ele['video']` (path) -> (T,C,H,W) uint8 numpy at
    smart_nframes uniformly-spaced indices."""
    path = ele["video"]
    if path.startswith("file://"):
        path = path[7:]
    try:
        import decord

        vr = decord.VideoReader(path)
        total_frames, video_fps = len(vr), vr.get_avg_fps()
        nframes = smart_nframes(ele, total_frames, video_fps)
        idx = np.linspace(0, total_frames - 1, nframes).round().astype(int)
        frames = np.stack([np.asarray(vr[int(i)]) for i in idx])
    except ImportError:
        import imageio.v2 as imageio

        reader = imageio.get_reader(path)
        video_fps = reader.get_meta_data().get("fps", 24.0)
        all_frames = [np.asarray(f) for f in reader]
        reader.close()
        total_frames = len(all_frames)
        nframes = smart_nframes(ele, total_frames, video_fps)
        idx = np.linspace(0, total_frames - 1, nframes).round().astype(int)
        frames = np.stack([all_frames[int(i)] for i in idx])
    return frames.transpose(0, 3, 1, 2)


def fetch_video(ele, image_factor=IMAGE_FACTOR):
    """path -> (T,C,H,W) float numpy resized per the video pixel budget;
    frame list -> list of fetched images padded to FRAME_FACTOR."""
    if isinstance(ele["video"], str):
        from PIL import Image

        video = _read_video(ele)
        nframes, _, height, width = video.shape
        min_pixels = ele.get("min_pixels", VIDEO_MIN_PIXELS)
        total_pixels = ele.get("total_pixels", VIDEO_TOTAL_PIXELS)
        max_pixels = max(
            min(VIDEO_MAX_PIXELS, total_pixels / nframes * FRAME_FACTOR),
            int(min_pixels * 1.05))
        max_pixels = ele.get("max_pixels", max_pixels)
        if "resized_height" in ele and "resized_width" in ele:
            resized_height, resized_width = smart_resize(
                ele["resized_height"], ele["resized_width"],
                factor=image_factor)
        else:
            resized_height, resized_width = smart_resize(
                height, width, factor=image_factor,
                min_pixels=min_pixels, max_pixels=max_pixels)
        out = np.stack([
            np.asarray(Image.fromarray(
                f.transpose(1, 2, 0).astype(np.uint8)).resize(
                (resized_width, resized_height),
                resample=Image.Resampling.BICUBIC), np.float32)
            for f in video]).transpose(0, 3, 1, 2)
        return out
    assert isinstance(ele["video"], (list, tuple))
    process_info = {k: v for k, v in ele.items()
                    if k not in ("type", "video")}
    images = [fetch_image({"image": v, **process_info},
                          size_factor=image_factor)
              for v in ele["video"]]
    nframes = ceil_by_factor(len(images), FRAME_FACTOR)
    if len(images) < nframes:
        images.extend([images[-1]] * (nframes - len(images)))
    return images


def extract_vision_info(conversations):
    """The image / video elements of one conversation or a list of them."""
    vision_infos = []
    if isinstance(conversations[0], dict):
        conversations = [conversations]
    for conversation in conversations:
        for message in conversation:
            if isinstance(message["content"], list):
                for ele in message["content"]:
                    if ("image" in ele or "image_url" in ele
                            or "video" in ele
                            or ele["type"] in ("image", "image_url",
                                               "video")):
                        vision_infos.append(ele)
    return vision_infos


def process_vision_info(conversations):
    """-> (image_inputs or None, video_inputs or None)."""
    vision_infos = extract_vision_info(conversations)
    image_inputs, video_inputs = [], []
    for vision_info in vision_infos:
        if "image" in vision_info or "image_url" in vision_info:
            image_inputs.append(fetch_image(vision_info))
        elif "video" in vision_info:
            video_inputs.append(fetch_video(vision_info))
        else:
            raise ValueError("image, image_url or video should in content.")
    return (image_inputs or None, video_inputs or None)
