"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and the run's seed make the inputs, on the device, in a few large calls of
one ``torch.Generator``.  The same seed gives the same inputs; the program
and the reference are handed the same tensors.

Kinds of mix:

- ``train``: a pool of ``pool`` distinct joint batches (``video_batch``
  clips of the configuration's frames and ``image_batch`` one-frame
  images, at the crop size, pixels normalised: standard normal, stored in
  the dtype the train loop ships pixels in), class labels uniform over
  the classes, per image four HAOG boxes (centres uniform in
  ``box_centre``, sides in ``box_side``, each present with probability
  ``box_present``, else all zero) and two contact states drawn from
  ``contact_states`` with ``contact_weights``;
- ``test``: a pool of ``pool`` distinct batches of ``batch`` views (f32,
  as the test loader hands them over) of videos of ``views_per_video`` =
  temporal x spatial views; the window's views cycle through the pool, and
  view ``i`` of the window belongs to video ``i // views_per_video``
  modulo ``videos``, whose label is drawn once.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.core.weights import TRAFFIC, sub_seed


def _gen(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, TRAFFIC))
    return g


def train_pool(mix: dict, arch, seed: int, device, pixel_dtype):
    """A list of ``mix['pool']`` (video, image) batches on ``device``, the
    weights on the host as the loaders hand them over."""
    g = _gen(seed, device)
    P, Bv, Bi = int(mix["pool"]), int(mix["video_batch"]), int(mix["image_batch"])
    T, S, O = arch.num_frames, arch.crop_size, arch.num_obj_per_frame
    clips = torch.randn((P, Bv, T, S, S, 3), generator=g, device=device)
    clips = clips.to(pixel_dtype)
    frames = torch.randn((P, Bi, 1, S, S, 3), generator=g,
                         device=device).to(pixel_dtype)
    labels = torch.randint(0, arch.num_classes, (P, Bv), generator=g,
                           device=device)
    lo, hi = mix["box_centre"]
    centre = lo + (hi - lo) * torch.rand((P, Bi, 1, O, 2), generator=g,
                                         device=device)
    lo, hi = mix["box_side"]
    side = lo + (hi - lo) * torch.rand((P, Bi, 1, O, 2), generator=g,
                                       device=device)
    present = torch.rand((P, Bi, 1, O, 1), generator=g,
                         device=device) < float(mix["box_present"])
    boxes = torch.where(present, torch.cat([centre, side], -1),
                        torch.zeros((), device=device))
    states = torch.tensor(mix["contact_states"], device=device)
    w = torch.tensor(mix["contact_weights"], dtype=torch.float32,
                     device=device)
    pick = torch.multinomial(w, P * Bi * 2, replacement=True, generator=g)
    contact = states[pick].view(P, Bi, 2)
    pool = []
    for p in range(P):
        video = {"clips": clips[p], "labels": labels[p],
                 "weight": np.ones(Bv, np.float32)}
        image = {"frames": frames[p], "haog_bboxes": boxes[p],
                 "contact_state": contact[p],
                 "weight": np.ones(Bi, np.float32)}
        pool.append((video, image))
    return pool


def test_pool(mix: dict, arch, seed: int, device):
    """(``mix['pool']`` batches of views [batch, T, S, S, 3] f32 on
    ``device``, the videos' labels on the host)."""
    g = _gen(seed, device)
    P, N = int(mix["pool"]), int(mix["batch"])
    T, S = arch.num_frames, arch.crop_size
    views = torch.randn((P, N, T, S, S, 3), generator=g, device=device)
    labels = torch.randint(0, arch.num_classes, (int(mix["videos"]),),
                           generator=g, device=device).cpu().numpy()
    return list(views), labels


def views_per_video(mix: dict) -> int:
    return int(mix["temporal_views"]) * int(mix["spatial_crops"])


def test_ids(mix: dict, k: int):
    """The clip ids of the window's batch ``k`` (views of the ensemble)."""
    n, per = int(mix["batch"]), views_per_video(mix)
    return (k * n + np.arange(n)) % (int(mix["videos"]) * per)
