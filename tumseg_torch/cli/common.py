"""Shared CLI plumbing: experiment directory layout and logging, mirroring
the reference's conventions (sem_seg_training.py:376-407,
sem_seg_testing.py:399-423)."""

from __future__ import annotations

import datetime
import logging
from pathlib import Path


def make_experiment_dirs(exp_dir, log_dir):
    experiment_dir = Path(exp_dir if exp_dir is not None else "./log/")
    experiment_dir.mkdir(exist_ok=True, parents=True)
    experiment_dir = experiment_dir.joinpath("sem_seg")
    experiment_dir.mkdir(exist_ok=True)
    if log_dir is None:
        timestr = str(datetime.datetime.now().strftime("%Y-%m-%d_%H-%M"))
        experiment_dir = experiment_dir.joinpath(timestr)
    else:
        experiment_dir = experiment_dir.joinpath(log_dir)
    print("Logging Directory = " + str(experiment_dir))
    experiment_dir.mkdir(exist_ok=True)
    checkpoints_dir = experiment_dir.joinpath("checkpoints/")
    checkpoints_dir.mkdir(exist_ok=True)
    logs_dir = experiment_dir.joinpath("logs/")
    logs_dir.mkdir(exist_ok=True)
    print("Logs Directory = " + str(logs_dir))
    return experiment_dir, checkpoints_dir, logs_dir


def make_logger(log_file: str):
    logger = logging.getLogger("Model")
    logger.setLevel(logging.INFO)
    formatter = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    file_handler = logging.FileHandler(log_file)
    file_handler.setLevel(logging.INFO)
    file_handler.setFormatter(formatter)
    logger.addHandler(file_handler)

    def log_string(s):
        logger.info(s)
        print(s)

    return logger, log_string
