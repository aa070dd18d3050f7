#!/usr/bin/env python
"""Drop-in entry point named like the reference's training script, for the
PyTorch port; forwards to tumseg_torch.cli.train (flag surface is
identical)."""

from tumseg_torch.cli.train import main, parse_args

if __name__ == "__main__":
    import time

    from tumseg_torch.utils.timing import current_time, time_print

    args = parse_args()
    start = time.time()
    accuracyChart, MLChart, IoUChart = main(args)
    if accuracyChart:
        max_value = max(accuracyChart)
        print("best accuracy epoch = %d" % accuracyChart.index(max_value))
    time_print(start)
    current_time()
