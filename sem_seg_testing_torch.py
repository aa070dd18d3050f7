#!/usr/bin/env python
"""Drop-in entry point named like the reference's testing script, for the
PyTorch port; forwards to tumseg_torch.cli.test (flag surface is
identical)."""

from tumseg_torch.cli.test import _console_main, main, parse_args  # noqa: F401

if __name__ == "__main__":
    _console_main()
