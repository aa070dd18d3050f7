"""Whole-scene voting inference (``tumseg/infer/voting.py``), host
re-blocking path.

For each scene, ``num_votes`` random re-blockings from ``TestGridDataset``
run through the model in ``batch_size`` chunks and every point's class votes
pool on the device; the label is the argmax of the pool, and per-class IoU
is tallied against the scene's ground truth. The next vote's host
re-blocking overlaps the device work of the current one.

Not in this slice, each raising ``NotImplementedError``: on-device
featurization and re-blocking, the single-dispatch vote scan, the device
mesh and bf16 compute (ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

from tumseg_torch.utils.progress import progress
from tumseg_torch.viz.writers import write_labels_txt, write_obj_pointcloud
from tumseg_torch.train import metrics as M

_NOT_PORTED = ("is not ported to tumseg_torch yet (ROADMAP Queue 1, item 7)")


def _scatter_votes(pool: torch.Tensor, point_idx: torch.Tensor,
                   pred: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """pool [N_scene, C] += one_hot(pred) at point_idx where keep, in place.
    Counts are integers below 2**24 in f32, so the order of the atomic adds
    on the card cannot change the pool."""
    pool.index_put_((point_idx.reshape(-1).long(), pred.reshape(-1).long()),
                    keep.reshape(-1).to(pool.dtype), accumulate=True)
    return pool


class InferenceRunner:
    """Batched forward of an ``nn.Module`` on ``device`` + device vote
    pooling. The model is moved to ``device`` and put in eval mode."""

    def __init__(self, model: torch.nn.Module, num_classes: int,
                 batch_size: int = 32, device="cuda", mesh=None,
                 compute_dtype=None, device_features: bool = False,
                 device_reblock: bool = False):
        for name, value in (("mesh", mesh), ("compute_dtype", compute_dtype),
                            ("device_features", device_features),
                            ("device_reblock", device_reblock)):
            if value:
                raise NotImplementedError(f"InferenceRunner {name} "
                                          + _NOT_PORTED)
        # full f32 everywhere: TF32 would cost the parity with tumseg
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.num_classes = num_classes
        self.batch_size = batch_size

    def predict_blocks(self, scene_data: np.ndarray) -> np.ndarray:
        """scene_data [num_blocks, N, C] -> predicted labels [num_blocks, N].
        Pads the block axis up to a batch multiple; padded rows are dropped."""
        preds = [p[:real].cpu().numpy()
                 for p, real in self._predict_chunks(scene_data)]
        return np.concatenate(preds, axis=0)

    def _predict_chunks(self, scene_data: np.ndarray):
        """Yield (device predictions [bs, N] int64, real_rows) per chunk;
        a short last chunk is padded by repeating its last block."""
        bs = self.batch_size
        for s in range(0, scene_data.shape[0], bs):
            chunk = scene_data[s:s + bs]
            real = chunk.shape[0]
            if real < bs:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], bs - real, axis=0)])
            x = torch.as_tensor(np.ascontiguousarray(chunk, np.float32),
                                device=self.device)
            with torch.inference_mode():
                pred = self.model(x)[0].argmax(dim=-1)
            yield pred, real

    def infer_scene(self, dataset, scene_idx: int, num_votes: int = 5,
                    gt_weight_gate: bool = True) -> np.ndarray:
        """Run ``num_votes`` re-blocked passes and return per-point labels
        for the whole scene [N_scene]. ``gt_weight_gate`` counts a point's
        votes only where ``labelweights[gt]`` is finite and nonzero, as the
        reference does."""
        n_scene = dataset.semantic_labels_list[scene_idx].shape[0]
        pool = torch.zeros((n_scene, self.num_classes), dtype=torch.float32,
                           device=self.device)
        executor = ThreadPoolExecutor(max_workers=1)
        try:
            fut = executor.submit(dataset.__getitem__, scene_idx)
            bs = self.batch_size
            for vote in progress(range(num_votes), desc="votes"):
                scene_data, _, scene_smpw, scene_index = fut.result()
                if vote + 1 < num_votes:
                    fut = executor.submit(dataset.__getitem__, scene_idx)
                if gt_weight_gate:
                    keep = (scene_smpw != 0) & ~np.isinf(scene_smpw)
                else:
                    keep = np.ones_like(scene_smpw, dtype=bool)
                # padded rows of a short last chunk cast no vote
                for ci, (pred, real) in enumerate(
                        self._predict_chunks(scene_data)):
                    s = ci * bs
                    _scatter_votes(
                        pool,
                        torch.as_tensor(scene_index[s:s + real],
                                        device=self.device),
                        pred[:real],
                        torch.as_tensor(keep[s:s + real],
                                        device=self.device))
        finally:
            executor.shutdown(wait=False)
        return pool.argmax(dim=1).cpu().numpy()


def run_testing(dataset, runner: InferenceRunner, *, num_votes: int,
                visual_dir=None, visual: bool = False,
                seg_label_to_cat: Dict = None, label2color: Dict = None,
                result_color: bool = True, log_string=print):
    """Voting inference over every scene, the per-scene and aggregate IoU
    report, ``visual/<scene>.txt`` label dumps and optional coloured .obj
    files (``tumseg/infer/voting.py:741-824``). The result also carries
    ``infer_seconds``, the wall time spent in ``infer_scene``."""
    num_classes = runner.num_classes
    scene_ids = [os.path.basename(str(f))[:-4] for f in dataset.file_list]
    totals = M.zero_tallies(num_classes)
    per_scene_miou = []
    infer_seconds = 0.0

    log_string("---- EVALUATION WHOLE SCENE----")
    for batch_idx in range(len(dataset)):
        print("Inference [%d/%d] %s ..." % (batch_idx + 1, len(dataset),
                                            scene_ids[batch_idx]))
        whole_scene_label = dataset.semantic_labels_list[batch_idx].astype(int)
        whole_scene_data = dataset.scene_points_list[batch_idx]

        t0 = time.perf_counter()
        pred_label = runner.infer_scene(dataset, batch_idx, num_votes)
        infer_seconds += time.perf_counter() - t0

        t = M.confusion_tallies(torch.as_tensor(pred_label),
                                torch.as_tensor(whole_scene_label),
                                num_classes)
        scene_iou = M.iou_from_tallies(t)
        totals = M.accumulate_host(totals, t)
        seen = np.asarray(t["seen"])
        tmp_iou = (float(np.mean(scene_iou[seen != 0]))
                   if (seen != 0).any() else 0.0)
        print(scene_iou)
        per_scene_miou.append(tmp_iou)
        log_string("Mean IoU of %s: %.4f" % (scene_ids[batch_idx], tmp_iou))
        print("----------------------------")

        if visual_dir is not None:
            write_labels_txt(os.path.join(str(visual_dir),
                                          scene_ids[batch_idx] + ".txt"),
                             pred_label)
            if visual:
                kw = (dict(labels=pred_label, label2color=label2color)
                      if result_color else {})
                kw_gt = (dict(labels=whole_scene_label,
                              label2color=label2color)
                         if result_color else {})
                write_obj_pointcloud(
                    os.path.join(str(visual_dir),
                                 scene_ids[batch_idx] + "_pred.obj"),
                    whole_scene_data, **kw)
                write_obj_pointcloud(
                    os.path.join(str(visual_dir),
                                 scene_ids[batch_idx] + "_gt.obj"),
                    whole_scene_data, **kw_gt)

    iou = M.iou_from_tallies(totals)
    iou_str = "------- IoU --------\n"
    for l in range(num_classes):
        if (totals["seen"][l] + totals["predicted"][l]) == 0:
            continue
        name = seg_label_to_cat[l] if seg_label_to_cat else str(l)
        iou_str += "class %s, IoU: %.3f \n" % (name + " " * (14 - len(name)),
                                               iou[l])
    log_string(iou_str)
    log_string("eval point avg class IoU: %f" % float(np.mean(iou)))
    log_string("eval whole scene point avg class acc: %f"
               % M.class_avg_accuracy(totals))
    total_seen = int(np.asarray(totals["seen"]).sum())
    log_string("eval whole scene point accuracy: %f"
               % (np.asarray(totals["correct"]).sum()
                  / float(total_seen + 1e-6)))
    return {"iou": iou, "miou": float(np.mean(iou)),
            "per_scene_miou": per_scene_miou, "tallies": totals,
            "infer_seconds": infer_seconds}
