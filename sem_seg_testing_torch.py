#!/usr/bin/env python
"""Drop-in entry point named like the reference's testing script, for the
PyTorch port; forwards to tumseg_torch.cli.test (flag surface is
identical)."""

from tumseg_torch.cli.test import main, parse_args

if __name__ == "__main__":
    import time

    from tumseg_torch.utils.timing import current_time, time_print

    args = parse_args()
    start = time.time()
    main(args)
    time_print(start)
    current_time()
