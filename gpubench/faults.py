"""Faults planted in the program's timed path, for the check's own tests
and for reading on the chip what the check's numbers give under them
(``run.py --fault``; the benchmark's runs plant none). ``plant(kind,
fault)`` patches the program's class for the rest of the process, or
through ``monkeypatch`` where given.

Serving: ``unchanged`` (a vote leaves the pool as it was), ``half`` (a
vote's second half of blocks left out), ``altered`` (every served label
moved to the next class), ``late`` (every label served after the
warm-up tile moved to the next class). Training:
``unchanged`` (the optimizer's step leaves the parameters), ``half`` (each
step on the first half of its batch, the loss its mean), ``altered`` (each
call's losses 1% off), ``late`` (from the third call on, each call trains
on the room ids of the first: stale inputs once the window runs). The
``late`` faults leave the set-up's calls and tiles sound: only a check of
the window's own work sees them."""

from __future__ import annotations


def _serve():
    from tumseg_torch.infer.voting import InferenceRunner

    vote, finish = InferenceRunner._vote, InferenceRunner._finish
    infer = InferenceRunner.infer_scene

    def unchanged(self, *a, **k):
        return None

    def half(self, scene, idx_blocks, offsets, *a, **k):
        n = idx_blocks.shape[0] // 2
        return vote(self, scene, idx_blocks[:n], offsets[:n], *a, **k)

    def altered(self, *a, **k):
        return (finish(self, *a, **k) + 1) % self.num_classes

    def late(self, dataset, scene_idx, *a, **k):
        labels = infer(self, dataset, scene_idx, *a, **k)
        return (labels + 1) % self.num_classes if scene_idx >= 1 else labels

    return InferenceRunner, {"unchanged": ("_vote", unchanged),
                             "half": ("_vote", half),
                             "altered": ("_finish", altered),
                             "late": ("infer_scene", late)}


def _train():
    from tumseg_torch.train.loop import TrainEngine

    init, step = TrainEngine.__init__, TrainEngine._train_step
    multi = TrainEngine.train_batch_rooms_multi

    def unchanged(self, *a, **k):
        init(self, *a, **k)
        self.optimizer.step = lambda *a, **k: None

    def half(self, points, target, generator):
        b = points.shape[0] // 2
        return step(self, points[:b], target[:b], generator)

    def altered(self, *a, **k):
        losses, corrects = multi(self, *a, **k)
        return losses * 1.01, corrects

    def late(self, room_ids_k, *a, **k):
        seen = self.__dict__.setdefault("_fault_ids", [])
        seen.append(room_ids_k)
        return multi(self, seen[0] if len(seen) > 2 else room_ids_k, *a, **k)

    return TrainEngine, {"unchanged": ("__init__", unchanged),
                         "half": ("_train_step", half),
                         "altered": ("train_batch_rooms_multi", altered),
                         "late": ("train_batch_rooms_multi", late)}


def plant(loop: str, fault: str, monkeypatch=None) -> None:
    cls, faults = _serve() if loop == "serve_tiles" else _train()
    name, fn = faults[fault]
    if monkeypatch is not None:
        monkeypatch.setattr(cls, name, fn)
    else:
        setattr(cls, name, fn)
