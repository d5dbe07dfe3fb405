"""Encoded-video decode and temporal sampling (counterpart of
``svit_tpu/data/decoder.py``, reference ``slowfast/datasets/decoder.py``).

Decoding runs on the host's CPU, as in the reference: the card never
touches encoded video.  Backend order: the libav shim
(``native/video.py``), then PyAV where it is installed.  Frame-directory
datasets (SSv2) need neither, so the imports are lazy; a clip that cannot
be decoded is None (the dataset retries), with the reason logged.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def temporal_sampling(
    frames: np.ndarray, start_idx: float, end_idx: float, num_samples: int
) -> np.ndarray:
    """linspace index_select (reference decoder.py:11-29)."""
    index = np.linspace(start_idx, end_idx, num_samples)
    index = np.clip(index, 0, frames.shape[0] - 1).astype(np.int64)
    return frames[index]


def get_start_end_idx(
    video_size: float,
    clip_size: float,
    clip_idx: int,
    num_clips: int,
    rng: Optional[np.random.Generator] = None,
    use_offset: bool = False,
) -> Tuple[float, float]:
    """Random (train) vs uniformly-placed (test) clip window
    (reference decoder.py:31-74)."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        rng = rng or np.random.default_rng()
        start_idx = rng.uniform(0, delta)
    else:
        if use_offset:
            if num_clips == 1:
                start_idx = math.floor(delta / 2)
            else:
                start_idx = clip_idx * math.floor(delta / (num_clips - 1))
        else:
            start_idx = delta * clip_idx / num_clips
    end_idx = start_idx + clip_size - 1
    return start_idx, end_idx


def pyav_decode(
    container,
    sampling_rate: int,
    num_frames: int,
    clip_idx: int,
    num_clips: int = 10,
    target_fps: int = 30,
    use_offset: bool = False,
    rng=None,
):
    """Decode a clip with PyAV (reference decoder.py:148-233 semantics):
    fps-normalized clip span, seek to the window when indexable."""
    fps = float(container.streams.video[0].average_rate)
    frames_length = container.streams.video[0].frames
    duration = container.streams.video[0].duration

    if duration is None or frames_length == 0:
        # decode everything (unknown length)
        decode_all = True
        video_start_pts, video_end_pts = 0, math.inf
    else:
        decode_all = False
        clip_size = sampling_rate * num_frames / target_fps * fps
        start_idx, end_idx = get_start_end_idx(
            frames_length, clip_size, clip_idx, num_clips, rng, use_offset
        )
        timebase = duration / frames_length
        video_start_pts = int(start_idx * timebase)
        video_end_pts = int(end_idx * timebase)

    stream = container.streams.video[0]
    frames = {}
    if not decode_all:
        seek_offset = max(video_start_pts - 1024, 0)
        container.seek(seek_offset, any_frame=False, backward=True, stream=stream)
    for frame in container.decode(stream):
        if frame.pts is None:
            continue
        if frame.pts < video_start_pts:
            continue
        if frame.pts > video_end_pts:
            break
        frames[frame.pts] = frame
    container.close()
    ordered = [frames[pts] for pts in sorted(frames)]
    video = np.stack([f.to_rgb().to_ndarray() for f in ordered])
    return video, fps, decode_all


def native_decode(
    path: str,
    sampling_rate: int,
    num_frames: int,
    clip_idx: int,
    num_clips: int = 10,
    target_fps: int = 30,
    use_offset: bool = False,
    rng=None,
):
    """``pyav_decode`` semantics through the libav shim
    (``native/video.py``): the same fps-normalized window math here, the
    seek and the pts-filtered RGB decode in C."""
    from svit_tpu_torch.native import video as nv

    meta = nv.probe(path)
    if meta is None:
        return None, 0.0, True
    fps, frames_length, duration = meta
    if duration is None or frames_length == 0:
        decode_all = True
        res = nv.decode_window(path)
    else:
        decode_all = False
        clip_size = sampling_rate * num_frames / target_fps * fps
        start_idx, end_idx = get_start_end_idx(
            frames_length, clip_size, clip_idx, num_clips, rng, use_offset
        )
        timebase = duration / frames_length
        res = nv.decode_window(
            path, int(start_idx * timebase), int(end_idx * timebase)
        )
    if res is None:
        return None, fps, decode_all
    video, _pts = res
    return video, fps, decode_all


def decode(
    path: str,
    sampling_rate: int,
    num_frames: int,
    clip_idx: int = -1,
    num_clips: int = 10,
    target_fps: int = 30,
    backend: str = "pyav",
    use_offset: bool = False,
    rng=None,
) -> Optional[np.ndarray]:
    """Decode + temporally sample a clip; returns uint8 [T, H, W, C] or None."""
    assert clip_idx >= -1, f"Not a valid clip_idx {clip_idx}"
    try:
        if backend in ("pyav", "torchvision", "native"):
            # one host decode path serves every backend name, as in the
            # JAX package: the libav shim, then PyAV
            from svit_tpu_torch.native import video as nv

            if nv.available():
                frames, fps, decode_all = native_decode(
                    path, sampling_rate, num_frames, clip_idx, num_clips,
                    target_fps, use_offset, rng,
                )
            else:
                try:
                    import av
                except ImportError as e:
                    raise RuntimeError(
                        "no video backend: the libav shim is missing "
                        f"({nv.SHIM.error}) and PyAV is not installed") from e

                container = av.open(path)
                frames, fps, decode_all = pyav_decode(
                    container, sampling_rate, num_frames, clip_idx, num_clips,
                    target_fps, use_offset, rng,
                )
        else:
            raise NotImplementedError(f"Unknown decoding backend {backend}")
    except Exception as e:
        logger.warning("decode failed for %s: %s", path, e)
        return None

    if frames is None or len(frames) == 0:
        return None

    # Reference decoder.py:380-389: the clip span is ALWAYS fps-normalized
    # (a 60 fps source spans twice the frames of a 30 fps one); for a
    # windowed decode the window itself was already placed by pyav/native
    # decode, so sampling restarts at clip 0-of-1 inside it.
    clip_size = sampling_rate * num_frames / target_fps * (fps or target_fps)
    start_idx, end_idx = get_start_end_idx(
        len(frames),
        clip_size,
        clip_idx if decode_all else 0,
        num_clips if decode_all else 1,
        rng,
        use_offset,
    )
    return temporal_sampling(frames, start_idx, end_idx, num_frames)
