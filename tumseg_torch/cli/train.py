"""Training CLI of the port: ``python -m tumseg_torch.cli.train``.

Same flags as ``tumseg/cli/train.py`` (the parser is repeated because that
module imports JAX; a test keeps the two equal) and the same flow: LAS tiles
of ``--rootdir`` except ``--test_area`` become a ``TrainBlockDataset``
split 70/30 into train and eval, a loader feeds
``tumseg_torch.train.fit``, and checkpoints are ``tumseg-ckpt-v2`` files
that ``tumseg`` and the port both read. A checkpoint at
``<exp_dir>/sem_seg/<log_dir>/checkpoints<output_model>`` is resumed.

It trains on ``cuda:<gpu>``, and on the CPU only with ``--gpu cpu`` (without
a CUDA device any other ``--gpu`` raises), with f32 weights and TF32 off,
the train step on the single-pass bf16 gathers of the engine's default.
``--bf16`` computes in bf16 (``TrainEngine(compute_dtype=torch.bfloat16)``)
in the train step and in eval; the checkpoints stay f32.

``--data_pipeline device`` uploads the rooms once into a
``DeviceBlockSampler`` and feeds room ids (``DeviceSampleLoader``): blocks
are sampled and featurized on the device, ``--superstep k`` steps at a
time. ``host`` is the NumPy ``BatchLoader``; ``auto`` picks device on a
CUDA device and host on the CPU. ``--visualizeModel`` logs the parameter
counts by module.

``--num_devices D`` trains on a ``D``-device ``data`` mesh
(``tumseg_torch.parallel``): ``D`` ranks on this host, one a device (all on
the CPU with ``--gpu cpu``), each taking ``B / D`` rows of every batch.
``--coordinator_address`` with ``--num_processes`` and ``--process_id``
joins a multi-process mesh instead, this process one rank on ``--gpu``.
Every rank reads the data and the checkpoint; only rank 0 writes the log,
the checkpoints and the saved datasets. Without ``--seed`` rank 0 draws one
for every rank, so the ranks draw the same batches. On GPUs the ranks form
an NCCL mesh, whose steps run as CUDA graphs with their collectives inside
(``TrainEngine``); with ``--gpu cpu`` a gloo mesh steps eagerly.
"""

from __future__ import annotations

import argparse
import copy
import glob
import os
import time

import numpy as np
import torch

from tumseg_torch.cli.common import make_experiment_dirs
from tumseg_torch.data.dataset import TrainBlockDataset
from tumseg_torch.data.device_sampler import (DeviceBlockSampler,
                                              DeviceSampleLoader)
from tumseg_torch.data.features import GEO_FEATURE_NAMES, attach_geofeatures
from tumseg_torch.data.loader import BatchLoader
from tumseg_torch.utils.labels import CLASSES_18, CLASSES_8
from tumseg_torch.utils.timing import current_time, time_print
from tumseg_torch import models
from tumseg_torch.cli.test import resolve_device, rank_logger
from tumseg_torch.parallel import mesh as pmesh
from tumseg_torch.train import checkpoint as ckpt
from tumseg_torch.train.loop import TrainEngine, fit
from tumseg_torch.utils.debug import summarize_model

saveTrain = "traindataset.pkl"
saveEval = "evaldataset.pkl"
saveDir = os.environ.get("TUMSEG_SAVE_DIR", "./data/saved_data/")
train_ratio = 0.7


def parse_args(argv=None):
    parser = argparse.ArgumentParser("Model")
    parser.add_argument("--model", type=str, default="pointnet2_sem_seg",
                        help="model name [default: pointnet_sem_seg]")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Batch Size during training [default: 16]")
    parser.add_argument("--epoch", default=32, type=int,
                        help="Epoch to run [default: 32]")
    parser.add_argument("--learning_rate", default=0.001, type=float,
                        help="Initial learning rate [default: 0.001]")
    parser.add_argument("--gpu", type=str, default="0",
                        help="GPU to use [default: GPU 0]")
    parser.add_argument("--optimizer", type=str, default="Adam",
                        help="Adam or SGD [default: Adam]")
    parser.add_argument("--log_dir", type=str, default="pointnet2_sem_seg",
                        help="Log path [default: None]")
    parser.add_argument("--exp_dir", type=str, default="./log/",
                        help="Log path [default: None]")
    parser.add_argument("--decay_rate", type=float, default=1e-4,
                        help="weight decay [default: 1e-4]")
    parser.add_argument("--npoint", type=int, default=4096,
                        help="Point Number [default: 4096]")
    parser.add_argument("--step_size", type=int, default=10,
                        help="Decay step for lr decay [default: every 10 epochs]")
    parser.add_argument("--lr_decay", type=float, default=0.7,
                        help="Decay rate for lr decay [default: 0.7]")
    parser.add_argument("--output_model", type=str, default="/best_model.pth",
                        help="model output name")
    parser.add_argument("--test_area", type=str,
                        default="cc_o_clipped_Local_DEBY_LOD2_4959323_cc.las",
                        help="Which area to use for test, option: 1-6 [default: 5]")
    parser.add_argument("--rootdir", type=str,
                        default="/content/drive/MyDrive/ data/tum/tum-facade/"
                                "training/cc_selected/CC/",
                        help="directory to data")
    parser.add_argument("--load", type=bool, default=False,
                        help="load saved data or new")
    parser.add_argument("--save", type=bool, default=False, help="save data")
    parser.add_argument("--visualizeModel", type=str, default=False,
                        help="directory to data")
    parser.add_argument("--extra_features", nargs="+", default=[],
                        help="select which features  to add")
    parser.add_argument("--downsample", type=bool, default=False,
                        help="downsample data")
    parser.add_argument("--calculate_geometry", type=bool, default=False,
                        help="decide where to calculate geometry")
    parser.add_argument("--class8", default=False, action="store_true",
                        help="Select 17 classes or 8 classes data")
    parser.add_argument("--RGB_OFF", default=True, action="store_false",
                        help="Select to use RGB or not")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="shard the batch over this many devices")
    parser.add_argument("--bf16", default=False, action="store_true",
                        help="bfloat16 matmul activations")
    parser.add_argument("--seed", type=int, default=None,
                        help="deterministic data/model seed")
    parser.add_argument("--data_pipeline", choices=["auto", "host", "device"],
                        default="auto",
                        help="block sampling/featurization location: "
                             "'device' uploads rooms once and samples "
                             "blocks on the card (per-step upload: [B] room "
                             "ids), 'host' is the NumPy BatchLoader; 'auto' "
                             "picks device on a CUDA device, host on the CPU")
    parser.add_argument("--superstep", type=int, default=8,
                        help="device-pipeline steps grouped per call (one "
                             "readback a rejection round for all of them; "
                             "the same run); 1 restores per-step calls; "
                             "unused on the host pipeline")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0 for multi-host pods")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="total host processes in the pod")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this host's process index")
    return parser.parse_args(argv)


def uses_device_pipeline(choice: str, device: torch.device) -> bool:
    """``--data_pipeline``: 'device' and 'host' as given; 'auto' is device
    on a CUDA device and host on the CPU."""
    return choice == "device" or (choice == "auto" and device.type == "cuda")


def main(args):
    """Trains on ``--gpu``, or on the mesh of ``--num_devices`` and the
    coordinator flags (rank 0's charts are returned)."""
    return pmesh.run_cli(_run, args, resolve_device(args.gpu))


def _run(args, mesh):
    start = time.time()
    device = resolve_device(args.gpu) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    if mesh is not None:
        args = copy.copy(args)
        args.seed = mesh.broadcast_int(args.seed)
    # f32 throughout: cuBLAS and cuDNN would otherwise round to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.class8 is False:
        classes = CLASSES_18
        NUM_CLASSES = 18
    else:
        classes = CLASSES_8
        NUM_CLASSES = 8
    seg_label_to_cat = {i: c for i, c in enumerate(classes)}
    print(seg_label_to_cat)

    dataColor = bool(args.RGB_OFF)

    root = args.rootdir
    NUM_POINT = args.npoint
    BATCH_SIZE = args.batch_size
    las_file_list = [f for f in glob.glob(root + "/*.las")
                     if not f.endswith(args.test_area)]
    print("Number of Classes = %d" % NUM_CLASSES)

    feature_list = list(args.extra_features)
    if feature_list:
        print("Extra features to be added")
        print(feature_list)
    else:
        print("No extra features")

    experiment_dir, checkpoints_dir, logs_dir = make_experiment_dirs(
        args.exp_dir, args.log_dir)
    log_string = rank_logger("%s/%s.txt" % (logs_dir, args.model), writer)
    log_string("PARAMETER ...")
    log_string(args)

    loadtime = time.time()
    if args.load is False:
        tmp_feature_list = [f for f in feature_list
                            if not (args.calculate_geometry
                                    and f in GEO_FEATURE_NAMES)]
        lidar_dataset = TrainBlockDataset(
            las_file_list, tmp_feature_list, num_classes=NUM_CLASSES,
            num_point=NUM_POINT, color=dataColor, class8=args.class8,
            seed=args.seed)
        print("Dataset taken")

        n = len(lidar_dataset)
        train_size = int(train_ratio * n)
        perm = np.random.default_rng(args.seed).permutation(n)
        train_indices, eval_indices = perm[:train_size], perm[train_size:]

        print("start loading training data ...")
        TRAIN_DATASET = lidar_dataset.copy(indices=train_indices)
        print("start loading eval data ...")
        EVAL_DATASET = lidar_dataset.copy(indices=eval_indices)

        if args.calculate_geometry is True:
            calTime = time.time()
            attach_geofeatures(TRAIN_DATASET, feature_list, args.downsample)
            attach_geofeatures(EVAL_DATASET, feature_list, args.downsample)
            time_print(calTime)
            current_time()
    else:
        print("Load previously saved dataset")
        TRAIN_DATASET = TrainBlockDataset.load_data(saveDir + saveTrain)
        EVAL_DATASET = TrainBlockDataset.load_data(saveDir + saveEval)

    print("Total {} samples in training dataset.".format(len(TRAIN_DATASET)))
    print("Total {} samples in evaluation dataset.".format(len(EVAL_DATASET)))
    time_print(loadtime)
    current_time()

    if args.save is True and writer:
        print("Save Dataset")
        os.makedirs(saveDir, exist_ok=True)
        TRAIN_DATASET.save_data(saveDir + saveTrain)
        EVAL_DATASET.save_data(saveDir + saveEval)

    device_pipeline = uses_device_pipeline(args.data_pipeline, device)
    sampler = None
    if device_pipeline:
        # the sampler is built from the train split and serves the eval
        # split's room ids too: split copies share the room arrays
        sampler = DeviceBlockSampler.from_dataset(TRAIN_DATASET,
                                                  device=device)
        trainDataLoader = DeviceSampleLoader(
            TRAIN_DATASET, batch_size=BATCH_SIZE, shuffle=True,
            drop_last=True, seed=args.seed)
        evalDataLoader = DeviceSampleLoader(
            EVAL_DATASET, batch_size=BATCH_SIZE, shuffle=False,
            drop_last=True)
        print("Device data pipeline: rooms uploaded once (%d bytes), "
              "per-step upload is [B] room ids" % sampler.table_bytes())
    else:
        trainDataLoader = BatchLoader(TRAIN_DATASET, batch_size=BATCH_SIZE,
                                      shuffle=True, num_workers=8,
                                      drop_last=True, seed=args.seed)
        evalDataLoader = BatchLoader(
            EVAL_DATASET, batch_size=BATCH_SIZE, shuffle=False,
            num_workers=8, drop_last=True,
            seed=None if args.seed is None else args.seed + 1)

    log_string("The number of training data is: %d" % len(TRAIN_DATASET))
    train_labelweights = TRAIN_DATASET.calculate_labelweights()
    log_string("The number of eval data is: %d" % len(EVAL_DATASET))
    EVAL_DATASET.calculate_labelweights()

    num_extra_features = TRAIN_DATASET.num_extra_features
    print("number = %d" % num_extra_features)
    torch.manual_seed(args.seed or 0)  # the initial weights
    model = models.get_module(args.model).get_model(NUM_CLASSES,
                                                    num_extra_features)
    engine = TrainEngine(model, NUM_CLASSES, train_labelweights,
                         optimizer=args.optimizer,
                         weight_decay=args.decay_rate, seed=args.seed or 0,
                         device=device,
                         compute_dtype=torch.bfloat16 if args.bf16 else None,
                         sampler=sampler, mesh=mesh)

    model_name = args.output_model
    resume_path = str(experiment_dir) + "/checkpoints" + model_name
    try:
        state = ckpt.load_checkpoint(resume_path)
        start_epoch = engine.load_state(state)
        log_string("Use pretrain model")
    except ValueError as e:
        # a checkpoint exists but cannot be loaded: starting over would
        # overwrite it at the first best-mIoU save
        raise SystemExit(f"Cannot resume: {e}")
    except Exception:  # missing or unreadable: a fresh start
        log_string("No existing model, starting training from scratch...")
        start_epoch = 0

    if args.visualizeModel:
        log_string("Model parameter summary:")
        summarize_model(engine.variables(), log=log_string)

    print("Identified Weights")
    print(train_labelweights)
    print("Data Preparation Complete")
    time_print(start)
    current_time()

    return fit(engine, trainDataLoader, evalDataLoader,
               start_epoch=start_epoch, end_epoch=args.epoch,
               learning_rate=args.learning_rate, lr_decay=args.lr_decay,
               step_size=args.step_size, batch_size=BATCH_SIZE,
               num_point=NUM_POINT, checkpoints_dir=checkpoints_dir,
               model_name=model_name, seg_label_to_cat=seg_label_to_cat,
               log_string=log_string,
               superstep=args.superstep if device_pipeline else 1)


def _console_main():
    """The ``tumseg-torch-train`` console script."""
    args = parse_args()
    start = time.time()
    accuracyChart, MLChart, IoUChart = main(args)
    if accuracyChart:
        max_value = max(accuracyChart)
        print("best accuracy epoch = %d" % accuracyChart.index(max_value))
    time_print(start)
    current_time()


if __name__ == "__main__":
    _console_main()
