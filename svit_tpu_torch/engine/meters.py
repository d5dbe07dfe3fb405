"""Training/eval meters (counterpart of ``svit_tpu/engine/meters.py``,
reference ``slowfast/utils/meters.py``).

Same measurement protocol as the reference — iter/data/net timers with
tic/toc, windowed medians of arbitrary loss dicts, ETA, epoch stats — all
emitted as ``json_stats:`` lines.  ``TestMeter`` implements the multi-view
ensembling: per-clip softmax scores are summed (or maxed) into their video
slot ``clip_id // num_clips`` and finalized into top-k numbers
(reference ``meters.py:237-398``).
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict

import numpy as np

from svit_tpu_torch.engine import metrics
from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._paused = None
        self._total = 0.0

    def pause(self):
        self._paused = time.perf_counter()

    def resume(self):
        """Count again after ``pause``, keeping the seconds counted so
        far."""
        if self._paused is not None:
            self._total += self._paused - self._start
            self._start = time.perf_counter()
            self._paused = None

    def seconds(self) -> float:
        end = self._paused if self._paused is not None else time.perf_counter()
        return end - self._start + self._total


class ScalarMeter:
    """Windowed scalar with median/avg (reference meters.py:401-450)."""

    def __init__(self, window_size: int):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_win_median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_win_avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    def get_global_avg(self):
        return self.total / max(self.count, 1)


class MultiLossMeter:
    """Windowed medians over arbitrary loss dicts (meters.py:793-846)."""

    def __init__(self, window_size: int):
        self.window_size = window_size
        self.meters: Dict[str, ScalarMeter] = {}
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def reset(self):
        self.meters.clear()
        self.totals.clear()
        self.counts.clear()

    def update(self, loss_dict: Dict[str, float], weight: float = 1.0):
        for k, v in loss_dict.items():
            if k not in self.meters:
                self.meters[k] = ScalarMeter(self.window_size)
            self.meters[k].add_value(float(v))
            self.totals[k] += float(v) * weight
            self.counts[k] += weight

    def get_win_medians(self):
        return {k: m.get_win_median() for k, m in self.meters.items()}

    def get_global_avgs(self):
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}


class TrainMeter:
    def __init__(self, epoch_iters: int, cfg):
        self.cfg = cfg
        self.epoch_iters = epoch_iters
        self.max_iter = cfg.SOLVER.MAX_EPOCH * epoch_iters
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.loss_meter = MultiLossMeter(cfg.LOG_PERIOD)
        self.lr = None
        self.num_samples = 0

    def reset(self):
        self.loss_meter.reset()
        self.num_samples = 0

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

    def data_resume(self):
        """Count a wait for data inside the step's window (the next batch,
        fetched while the step runs) until the next ``data_toc``."""
        self.data_timer.resume()

    def update_stats(self, lr: float, mb_size: int, dloss: Dict[str, float]):
        self.lr = lr
        self.loss_meter.update(dloss)
        self.num_samples += mb_size

    def log_iter_stats(self, cur_epoch: int, cur_iter: int):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        iter_sec = self.iter_timer.seconds()
        eta_sec = iter_sec * (
            self.max_iter - (cur_epoch * self.epoch_iters + cur_iter + 1)
        )
        stats = {
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": iter_sec,
            "dt_data": self.data_timer.seconds(),
            "eta": str(datetime.timedelta(seconds=int(eta_sec))),
            "lr": self.lr,
        }
        stats.update(self.loss_meter.get_win_medians())
        logging.log_json_stats(stats)

    def log_epoch_stats(self, cur_epoch: int):
        stats = {
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "dt": self.iter_timer.seconds(),
            "lr": self.lr,
        }
        stats.update(self.loss_meter.get_global_avgs())
        logging.log_json_stats(stats)


class ValMeter:
    def __init__(self, max_iter: int, cfg):
        self.cfg = cfg
        self.max_iter = max_iter
        self.iter_timer = Timer()
        self.num_top1_correct = 0.0
        self.num_top5_correct = 0.0
        self.num_samples = 0.0
        self.min_top1_err = 100.0
        self.min_top5_err = 100.0
        self.extra = MultiLossMeter(cfg.LOG_PERIOD)
        # multitask: per-task weighted correct counts {name: [c1, c5]}
        self.task_correct = {}

    def reset(self):
        self.num_top1_correct = 0.0
        self.num_top5_correct = 0.0
        self.num_samples = 0.0
        self.extra.reset()
        self.task_correct = {}

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, top1_correct, top5_correct, count, extra=None,
                     task_correct=None):
        """``task_correct`` (multitask): {task: (c1, c5)} weighted correct
        counts; the primary top1/top5 slots then carry the JOINT (action)
        counts — reference EPIC protocol, ``tools/train_net.py:275-300``."""
        self.num_top1_correct += float(top1_correct)
        self.num_top5_correct += float(top5_correct)
        self.num_samples += float(count)
        if task_correct:
            for name, (c1, c5) in task_correct.items():
                acc = self.task_correct.setdefault(name, [0.0, 0.0])
                acc[0] += float(c1)
                acc[1] += float(c5)
        if extra:
            self.extra.update(extra)

    def update_image_stats(self, count, losses):
        """Image-branch val losses (HAOG); weighted into the same extra
        meter so they appear in the val_epoch json_stats line."""
        self.extra.update(losses, weight=count)

    def log_iter_stats(self, cur_epoch: int, cur_iter: int):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        logging.log_json_stats(
            {
                "_type": "val_iter",
                "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
                "iter": f"{cur_iter + 1}/{self.max_iter}",
                "dt": self.iter_timer.seconds(),
            }
        )

    def log_epoch_stats(self, cur_epoch: int):
        top1_err = (1.0 - self.num_top1_correct / max(self.num_samples, 1)) * 100
        top5_err = (1.0 - self.num_top5_correct / max(self.num_samples, 1)) * 100
        self.min_top1_err = min(self.min_top1_err, top1_err)
        self.min_top5_err = min(self.min_top5_err, top5_err)
        stats = {
            "_type": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "top1_err": top1_err,
            "top5_err": top5_err,
            "min_top1_err": self.min_top1_err,
            "min_top5_err": self.min_top5_err,
        }
        if self.task_correct:
            # reference EPIC logging names: {task}_top{k}_acc per task plus
            # action_top{k}_acc for the joint metric (train_net.py:296-313)
            n = max(self.num_samples, 1)
            for name, (c1, c5) in self.task_correct.items():
                stats[f"{name}_top1_acc"] = c1 / n * 100
                stats[f"{name}_top5_acc"] = c5 / n * 100
            stats["action_top1_acc"] = self.num_top1_correct / n * 100
            stats["action_top5_acc"] = self.num_top5_correct / n * 100
        stats.update(self.extra.get_global_avgs())
        logging.log_json_stats(stats)
        return stats


class TestMeter:
    """Multi-view ensembler (reference meters.py:237-398)."""

    def __init__(
        self,
        num_videos: int,
        num_clips: int,
        num_cls: int,
        overall_iters: int,
        ensemble_method: str = "sum",
    ):
        assert ensemble_method in ("sum", "max")
        self.num_clips = num_clips
        self.overall_iters = overall_iters
        self.ensemble_method = ensemble_method
        self.video_preds = np.zeros((num_videos, num_cls), np.float32)
        self.video_labels = np.zeros(num_videos, np.int64)
        self.clip_count = np.zeros(num_videos, np.int64)
        self.iter_timer = Timer()
        self.stats = {}

    def reset(self):
        self.video_preds[:] = 0
        self.video_labels[:] = 0
        self.clip_count[:] = 0

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, preds, labels, clip_ids):
        for i, clip_id in enumerate(clip_ids):
            vid_id = int(clip_id) // self.num_clips
            if self.video_labels[vid_id] != 0 and self.clip_count[vid_id] > 0:
                assert self.video_labels[vid_id] == int(labels[i]), (
                    f"label mismatch for video {vid_id}"
                )
            self.video_labels[vid_id] = int(labels[i])
            if self.ensemble_method == "sum":
                self.video_preds[vid_id] += preds[i]
            else:
                self.video_preds[vid_id] = np.maximum(
                    self.video_preds[vid_id], preds[i]
                )
            self.clip_count[vid_id] += 1

    def log_iter_stats(self, cur_iter: int, log_period: int = 10):
        if (cur_iter + 1) % log_period != 0:
            return
        logging.log_json_stats(
            {
                "_type": "test_iter",
                "cur_iter": f"{cur_iter + 1}/{self.overall_iters}",
                "time_diff": self.iter_timer.seconds(),
            }
        )

    def finalize_metrics(self, ks=(1, 5)):
        if not np.all(self.clip_count == self.num_clips):
            bad = np.argwhere(self.clip_count != self.num_clips).flatten()
            logger.warning(
                "clip count incomplete for %d videos (e.g. %s)",
                len(bad), bad[:5],
            )
        num_topks = metrics.topks_correct(self.video_preds, self.video_labels, ks)
        n = len(self.video_labels)
        stats = {"_type": "test_final"}
        for k, cnt in zip(ks, num_topks):
            stats[f"top{k}_acc"] = f"{float(cnt) / n * 100.0:.2f}"
        logging.log_json_stats(stats)
        self.stats = stats
        return stats


class AVAMeter:
    """AVA detection meter (reference meters.py:52-234): accumulates per-clip
    box predictions + ground truth and computes mAP via the compact PASCAL
    evaluator (`engine/ava_eval.py`)."""

    def __init__(self, overall_iters: int, cfg, mode: str):
        self.cfg = cfg
        self.mode = mode
        self.overall_iters = overall_iters
        self.iter_timer = Timer()
        self.loss_meter = MultiLossMeter(cfg.LOG_PERIOD)
        self.groundtruth = {}
        self.detections = {}
        self.full_map = 0.0

    def reset(self):
        self.groundtruth.clear()
        self.detections.clear()
        self.loss_meter.reset()

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(
        self, image_keys, pred_boxes, pred_scores, pred_classes,
        gt_boxes=None, gt_classes=None, dloss=None,
    ):
        """Per-batch: predicted (box, score, class) triples per image key,
        optional ground-truth boxes/classes."""
        from collections import defaultdict

        for i, key in enumerate(image_keys):
            det = self.detections.setdefault(key, defaultdict(list))
            det[int(pred_classes[i])].append(
                (np.asarray(pred_boxes[i], np.float64), float(pred_scores[i]))
            )
            if gt_boxes is not None:
                gt = self.groundtruth.setdefault(key, defaultdict(list))
                gt[int(gt_classes[i])].append(
                    (np.asarray(gt_boxes[i], np.float64), 1.0)
                )
        if dloss:
            self.loss_meter.update(dloss)

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        logging.log_json_stats(
            {
                "_type": f"ava_{self.mode}_iter",
                "cur_iter": cur_iter + 1,
                "time_diff": self.iter_timer.seconds(),
            }
        )

    def finalize_metrics(self, log: bool = True):
        from svit_tpu_torch.engine.ava_eval import evaluate_detections

        results = evaluate_detections(self.groundtruth, self.detections)
        self.full_map = results["PascalBoxes_Precision/mAP@0.5IOU"]
        if log:
            logging.log_json_stats(
                {"_type": f"ava_{self.mode}_final", "mAP": self.full_map}
            )
        return self.full_map


class EpochTimer:
    """Per-epoch wall-clock stats (reference meters.py:738-790)."""

    def __init__(self):
        self.timer = Timer()
        self.epoch_times = []

    def reset(self):
        self.timer.reset()
        self.epoch_times = []

    def epoch_tic(self):
        self.timer.reset()

    def epoch_toc(self):
        self.epoch_times.append(self.timer.seconds())

    def last_epoch_time(self):
        return self.epoch_times[-1]

    def avg_epoch_time(self):
        return float(np.mean(self.epoch_times))

    def median_epoch_time(self):
        return float(np.median(self.epoch_times))
