"""Host-side batch loader (counterpart of ``svit_tpu/data/loader.py``).

Replaces the reference's torch DataLoader + DistributedSampler stack
(reference ``slowfast/datasets/loader.py``), as the JAX package does:

- batches are padded to a fixed size with zero-weight samples and carry an
  explicit ``weight`` vector (see ``engine/steps.py``), so the last batch
  keeps the shape of the others;
- worker parallelism through a process pool (spawned interpreters) or
  threads, with a bounded prefetch queue.

Under data parallelism (``shard``: this rank's index and the data axis's
size, ``parallel/mesh.py:data_sharding``) every rank walks the same
shuffled order (one seed for all) and reads its share of each global
batch: the batch's items padded to a multiple of the axis, cut in equal
runs, the pads (zero weight) on the last ranks.  Concatenated in rank
order, the shares are the one-process batch with its pads.  The
reference's rank-heterogeneous
``construct_loader_train`` (``loader.py:175-256``) is, as in the JAX
package, two loaders (video and image) that feed the fused train step.
The datasets are numpy and PIL only, and process workers are spawned, so a
worker never touches the card.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from svit_tpu_torch.data.build import build_dataset
from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def collate_video(samples, pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    # repeated augmentation yields a list of samples per item
    # (reference ``multiple_samples_collate``, loader.py:20-42)
    flat = []
    for s in samples:
        flat.extend(s) if isinstance(s, list) else flat.append(s)
    samples = flat
    frames = np.stack([s[0] for s in samples])
    labels = np.asarray([s[1] for s in samples], np.int32)
    index = np.asarray([s[2] for s in samples], np.int32)
    weight = np.ones(len(samples), np.float32)
    batch = {"clips": frames, "labels": labels, "index": index, "weight": weight}
    return _pad(batch, pad_to)


def collate_image(samples, pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    frames = np.stack([s[0] for s in samples])
    labels = np.asarray([s[1] for s in samples], np.int32)
    index = np.asarray([s[2] for s in samples], np.int32)
    meta = [s[3] for s in samples]
    batch = {
        "frames": frames,
        "labels": labels,
        "index": index,
        "haog_bboxes": np.stack([m["haog_bboxes"] for m in meta]).astype(np.float32),
        "contact_state": np.stack([m["contact_state"] for m in meta]).astype(np.int32),
        "weight": np.ones(len(samples), np.float32),
    }
    return _pad(batch, pad_to)


def _pad(batch: Dict[str, np.ndarray], pad_to: Optional[int]):
    if pad_to is None:
        return batch
    b = len(batch["weight"])
    if b == pad_to:
        return batch
    assert b < pad_to, (b, pad_to)
    out = {}
    for k, v in batch.items():
        pad_shape = (pad_to - b,) + v.shape[1:]
        filler = np.zeros(pad_shape, v.dtype)
        if k == "contact_state":
            filler -= 1  # -1 = ignore
        out[k] = np.concatenate([v, filler], axis=0)
    out["weight"][b:] = 0.0
    return out


# ---------------------------------------------------------------------------
# Persistent process workers.  Each worker deserializes the dataset ONCE (in
# the pool initializer) and tasks ship only (index, epoch) — the earlier
# ``pool.map(dataset.__getitem__, ...)`` re-pickled the whole dataset (frame
# lists, box jsons, augment policies) into every single task.
# ---------------------------------------------------------------------------

_WORKER_DATASET = None
_WORKER_EPOCH = None


def _worker_init(pickled_dataset: bytes):
    import pickle

    global _WORKER_DATASET, _WORKER_EPOCH
    _WORKER_DATASET = pickle.loads(pickled_dataset)
    _WORKER_EPOCH = None


def _worker_fetch(task):
    idx, epoch = task
    global _WORKER_EPOCH
    if epoch != _WORKER_EPOCH:
        if hasattr(_WORKER_DATASET, "set_epoch"):
            _WORKER_DATASET.set_epoch(epoch)
        _WORKER_EPOCH = epoch
    return _WORKER_DATASET[idx]


class Loader:
    """Iterable over collated batches with background prefetch.

    ``pad_to`` rounds every batch (including the last when not dropped) up to
    a fixed size so jit sees one static shape.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool,
        drop_last: bool,
        num_workers: int = 0,
        seed: int = 0,
        collate_fn=collate_video,
        pad_to: Optional[int] = None,
        prefetch: int = 2,
        use_processes: bool = False,
        shard=(0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.collate_fn = collate_fn
        self.pad_to = pad_to if pad_to is not None else batch_size
        self.prefetch = prefetch
        self.use_processes = use_processes
        self.shard_index, self.shard_count = shard
        if self.shard_count > 1:
            # items of this rank's share, and its rows (``pad_to`` is
            # per item: ``samples_per_item`` rows each)
            per = -(-batch_size // self.shard_count)
            self.pad_to = self.pad_to // batch_size * per
            self.share = per
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """reference ``loader.shuffle_dataset`` -> ``sampler.set_epoch``.

        Propagates to the dataset so per-item augmentation rngs advance
        per epoch."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def _collate(self, samples):
        """A batch (or this rank's share) padded to ``pad_to`` rows; a share
        with no item is all pads, cut from a collated one."""
        if samples:
            return self.collate_fn(samples, self.pad_to)
        one = self.collate_fn([self.dataset[0]], None)
        return _pad({k: v[:0] for k, v in one.items()}, self.pad_to)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_batches(0)

    def iter_batches(self, start_iter: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate from batch ``start_iter`` onward (mid-epoch resume).

        Skipped batches are never fetched/decoded; the epoch's batch order is
        deterministic given (seed, epoch), so the resumed stream is identical
        to the uninterrupted one.
        """
        indices = self._indices()
        n_batches = len(self)
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(start_iter, n_batches)
        ]
        if self.shard_count > 1:
            lo = self.shard_index * self.share
            batches = [b[lo:lo + self.share] for b in batches]

        if self.num_workers <= 0:
            for b in batches:
                yield self._collate([self.dataset[int(i)] for i in b])
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        epoch = self._epoch

        def producer():
            try:
                if self.use_processes:
                    import multiprocessing
                    import pickle

                    # fork would clone this multi-threaded process (and
                    # its CUDA context); spawn starts clean interpreters.
                    ctx = multiprocessing.get_context("spawn")
                    pool = ProcessPoolExecutor(
                        max_workers=self.num_workers,
                        mp_context=ctx,
                        initializer=_worker_init,
                        initargs=(pickle.dumps(self.dataset),),
                    )
                    fetch = _worker_fetch
                    tasks = lambda b: [(int(i), epoch) for i in b]
                else:
                    pool = ThreadPoolExecutor(max_workers=self.num_workers)
                    fetch = self.dataset.__getitem__
                    tasks = lambda b: [int(i) for i in b]
                with pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(fetch, tasks(b)))
                        out_q.put(self._collate(samples))
            except Exception as e:  # surface worker errors to the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # an iterator left before its end (the image loader's, every
            # epoch): a producer blocked on the full queue gets room, sees
            # ``stop`` and shuts its pool down.  Its workers would outlive
            # it otherwise, and a spawned process (a rank of launch_job)
            # waits for its children at exit before the pool is told to end
            while t.is_alive():
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass


def construct_loader(cfg, split: str, shard=(0, 1)):
    """The loader(s) of ``split`` (reference ``loader.py:84-256``).

    - ``train``: ``(video_loader, image_loader or None)``, shuffled by
      ``RNG_SEED`` and ``RNG_SEED + 1`` and the epoch, the last partial
      batch dropped; the video batch is ``TRAIN.BATCH_SIZE`` times the
      dataset's repeated-augmentation multiplicity (``samples_per_item``);
      the image loader (``multi_images`` over ``IMAGE_TRAIN.DATASETS``)
      exists when the config has image ranks;
    - ``val``: ``TRAIN.DATASET``'s val split at ``TRAIN.BATCH_SIZE``;
    - ``image_val``: ``multi_images``' val split at
      ``IMAGE_TRAIN.BATCH_SIZE``, None when it is empty;
    - ``test``: ``TEST.DATASET`` at ``TEST.BATCH_SIZE``, every video
      replicated ``NUM_ENSEMBLE_VIEWS x NUM_SPATIAL_CROPS`` times.
    The evaluation splits run in order, the last batch padded with
    zero-weight samples.  ``shard`` (this rank's data index and the data
    axis's size, ``parallel/mesh.py:data_sharding``) gives each rank its
    share of every global batch."""
    from svit_tpu_torch.config.defaults import num_image_ranks

    if split == "train":
        video_ds = build_dataset(cfg.TRAIN.DATASET, cfg, "train")
        num_sample = int(getattr(video_ds, "samples_per_item", 1))
        video_loader = Loader(
            video_ds, cfg.TRAIN.BATCH_SIZE, shuffle=True, drop_last=True,
            num_workers=cfg.DATA_LOADER.NUM_WORKERS, seed=cfg.RNG_SEED,
            collate_fn=collate_video,
            pad_to=cfg.TRAIN.BATCH_SIZE * num_sample,
            prefetch=cfg.TPU.PREFETCH_DEPTH,
            use_processes=bool(cfg.DATA_LOADER.USE_PROCESSES), shard=shard)
        image_loader = None
        if num_image_ranks(cfg) > 0:
            image_ds = build_dataset("multi_images", cfg, "train")
            image_loader = Loader(
                image_ds, cfg.IMAGE_TRAIN.BATCH_SIZE, shuffle=True,
                drop_last=True, num_workers=cfg.DATA_LOADER.NUM_WORKERS,
                seed=cfg.RNG_SEED + 1, collate_fn=collate_image,
                pad_to=cfg.IMAGE_TRAIN.BATCH_SIZE,
                prefetch=cfg.TPU.PREFETCH_DEPTH,
                use_processes=bool(cfg.DATA_LOADER.USE_PROCESSES),
                shard=shard)
        return video_loader, image_loader
    collate = collate_video
    if split == "val":
        ds = build_dataset(cfg.TRAIN.DATASET, cfg, "val")
        workers = cfg.DATA_LOADER.NUM_WORKERS_VAL
        if workers < 0:
            workers = cfg.DATA_LOADER.NUM_WORKERS
        batch = cfg.TRAIN.BATCH_SIZE
    elif split == "image_val":
        ds = build_dataset("multi_images", cfg, "val")
        if len(ds) == 0:
            return None
        workers = cfg.DATA_LOADER.NUM_WORKERS_VAL
        if workers < 0:
            workers = cfg.DATA_LOADER.NUM_WORKERS
        batch, collate = cfg.IMAGE_TRAIN.BATCH_SIZE, collate_image
    elif split == "test":
        ds = build_dataset(cfg.TEST.DATASET, cfg, "test")
        workers = cfg.DATA_LOADER.NUM_WORKERS
        batch = cfg.TEST.BATCH_SIZE
    else:
        raise NotImplementedError(split)
    return Loader(ds, batch, shuffle=False, drop_last=False,
                  num_workers=workers, seed=cfg.RNG_SEED,
                  collate_fn=collate, pad_to=batch,
                  prefetch=cfg.TPU.PREFETCH_DEPTH, shard=shard)


def shuffle_dataset(loader, cur_epoch: int):
    """reference ``loader.py:258-289``."""
    if isinstance(loader, tuple):
        for l in loader:
            if l is not None:
                l.set_epoch(cur_epoch)
    else:
        loader.set_epoch(cur_epoch)
