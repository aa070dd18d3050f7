"""Testing CLI of the port: ``python -m tumseg_torch.cli.test``.

Same flags as ``tumseg/cli/test.py`` (the parser is repeated because that
module imports JAX; a test keeps the two equal), same report and the same
``visual/<scene>.txt`` label dumps: whole-scene multi-vote inference of the
``--test_area`` tiles with the ``tumseg-ckpt-v2`` checkpoint of
``<exp_dir><log_dir>/checkpoints<output_model>``.

It runs on ``cuda:<gpu>``, and on the CPU only with ``--gpu cpu``; without
a CUDA device any other ``--gpu`` raises. The runner keeps its "auto"
defaults, as ``tumseg``'s CLI does: on CUDA it serves through the device
re-blocking path (scene uploaded once, re-blocking, featurization and vote
pooling on the device), on the CPU through host re-blocking. ``--bf16``
serves in bf16 compute (``compute_dtype=torch.bfloat16``), with the
single-pass bf16 gathers, as ``tumseg``'s ``--bf16`` does; the f32
checkpoint serves either way.

``--num_devices`` and the coordinator flags serve on a ``data`` mesh as the
training CLI trains on one (``tumseg_torch.parallel``): every rank votes its
share of each vote's blocks (``--batch_size`` a multiple of the mesh size),
and only rank 0 writes the log and the label dumps.
"""

from __future__ import annotations

import argparse
import copy
import glob
import os
import time
from pathlib import Path

import torch

from tumseg_torch.cli.common import make_logger
from tumseg_torch.data.dataset import TestGridDataset
from tumseg_torch.data.features import GEO_FEATURE_NAMES, attach_geofeatures
from tumseg_torch.utils.labels import class_tables
from tumseg_torch.utils.timing import current_time, time_print
from tumseg_torch import models
from tumseg_torch.infer.voting import InferenceRunner, run_testing
from tumseg_torch.models.convert import state_dict_from_variables
from tumseg_torch.parallel import mesh as pmesh
from tumseg_torch.train import checkpoint as ckpt

saveTest = "testdataset.pkl"
saveDir = os.environ.get("TUMSEG_SAVE_DIR", "./data/saved_data/")


def parse_args(argv=None):
    parser = argparse.ArgumentParser("Model")
    parser.add_argument("--model", type=str, default="pointnet2_sem_seg",
                        help="model name [default: pointnet_sem_seg]")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="batch size in testing [default: 32]")
    parser.add_argument("--gpu", type=str, default="0",
                        help="specify gpu device")
    parser.add_argument("--num_point", type=int, default=4096,
                        help="point number [default: 4096]")
    parser.add_argument("--log_dir", type=str, default="pointnet2_sem_seg",
                        help="log directory")
    parser.add_argument("--exp_dir", type=str, default="log/sem_seg/",
                        help="Log path [default: None]")
    parser.add_argument("--visual", action="store_true", default=False,
                        help="visualize result [default: False]")
    parser.add_argument("--num_votes", type=int, default=5,
                        help="aggregate segmentation scores with voting "
                             "[default: 5]")
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
                        help="shard blocks over this many devices")
    parser.add_argument("--bf16", default=False, action="store_true",
                        help="bfloat16 matmul activations")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0 for multi-host pods")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser.parse_args(argv)


def resolve_device(gpu: str) -> torch.device:
    """``cuda:<gpu>``, or the CPU when ``--gpu cpu`` asks for it. Without a
    CUDA device anything but ``cpu`` raises: the entry points never fall
    back to the CPU on their own."""
    if gpu == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--gpu {gpu}: no CUDA device is available "
                           "(pass --gpu cpu to run on the CPU)")
    return torch.device(f"cuda:{gpu}")


def rank_logger(log_file: str, writer: bool):
    """``make_logger``'s ``log_string`` on the rank that writes; a no-op on
    the other ranks of a mesh, so each log is written once."""
    if not writer:
        return lambda s: None
    return make_logger(log_file)[1]


def main(args):
    """Serves on ``--gpu``, or on the mesh of ``--num_devices`` and the
    coordinator flags (rank 0's result is returned)."""
    return pmesh.run_cli(_run, args, resolve_device(args.gpu))


def _run(args, mesh):
    device = resolve_device(args.gpu) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    if mesh is not None:
        args = copy.copy(args)
        args.seed = mesh.broadcast_int(args.seed)
    print(args.class8)
    classes, NUM_CLASSES, label2color = class_tables(bool(args.class8))
    dataColor = bool(args.RGB_OFF)
    seg_label_to_cat = {i: c for i, c in enumerate(classes)}
    print(seg_label_to_cat)

    root = args.rootdir
    test_file = glob.glob(os.path.join(root, args.test_area)) or \
        glob.glob(root + args.test_area)
    print("Number of Classes = %d" % NUM_CLASSES)

    feature_list = list(args.extra_features)
    if feature_list:
        print("Extra features to be added")
        print(feature_list)
    else:
        print("No extra features")

    experiment_dir = (args.exp_dir if args.exp_dir is not None
                      else "log/sem_seg/") + args.log_dir
    print("Logging Directory = " + str(experiment_dir))
    visual_dir = Path(experiment_dir + "/visual/")
    visual_dir.mkdir(exist_ok=True, parents=True)

    log_string = rank_logger("%s/eval.txt" % experiment_dir, writer)
    log_string("PARAMETER ...")
    log_string(args)

    testdatatime = time.time()
    print("start loading test data ...")
    if args.load is False:
        tmp_feature_list = [f for f in feature_list
                            if not (args.calculate_geometry
                                    and f in GEO_FEATURE_NAMES)]
        dataset = TestGridDataset(
            root=root, las_file_list=test_file, feature_list=tmp_feature_list,
            num_classes=NUM_CLASSES, block_points=args.num_point,
            color=dataColor, class8=args.class8, seed=args.seed)
        if args.calculate_geometry is True:
            attach_geofeatures(dataset, feature_list, args.downsample)
    else:
        dataset = TestGridDataset.load_data(saveDir + saveTest)

    log_string("The number of test data is: %d" % len(dataset))
    dataset.calculate_labelweights()
    time_print(testdatatime)
    current_time()

    if args.save is True and writer:
        print("Save Test dataset")
        os.makedirs(saveDir, exist_ok=True)
        dataset.save_data(saveDir + saveTest)

    num_extra_features = dataset.num_extra_features
    print("number = %d" % num_extra_features)
    model = models.get_module(args.model).get_model(NUM_CLASSES,
                                                    num_extra_features)
    ckpt_path = str(experiment_dir) + "/checkpoints" + args.output_model
    state = ckpt.load_checkpoint(ckpt_path)
    model.load_state_dict(state_dict_from_variables(state["model_state_dict"]))

    runner = InferenceRunner(
        model, NUM_CLASSES, batch_size=args.batch_size, device=device,
        mesh=mesh, compute_dtype=torch.bfloat16 if args.bf16 else None)
    print("Begin testing")
    out = run_testing(
        dataset, runner, num_votes=args.num_votes,
        visual_dir=visual_dir, visual=args.visual,
        seg_label_to_cat=seg_label_to_cat, label2color=label2color,
        result_color=True, log_string=log_string)
    print("Done!")
    return out


def _console_main():
    """The ``tumseg-torch-test`` console script."""
    args = parse_args()
    start = time.time()
    main(args)
    time_print(start)
    current_time()


if __name__ == "__main__":
    _console_main()
