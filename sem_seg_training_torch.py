#!/usr/bin/env python
"""Drop-in entry point named like the reference's training script, for the
PyTorch port; forwards to tumseg_torch.cli.train (flag surface is
identical)."""

from tumseg_torch.cli.train import _console_main, main, parse_args  # noqa: F401

if __name__ == "__main__":
    _console_main()
