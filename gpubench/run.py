"""Runs one cell of the benchmark once:

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From ``BENCHMARK.json`` it takes the cell, its configuration
(``configs/``), its traffic mix (``traffic/``) and the loop that the mix
names (``loops/``); with ``--trace 1`` it also runs the reader of each of
the cell's per-layer metrics (``metrics/``). Its last line on standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown`` and, where a roofline
was read, ``roofline_families`` (each point-kernel family's launches,
device seconds and whether its least time was counted), and last
``checks``,
each number compared with its limit (``limits/<workload>.json``), which
are also the last lines on standard error.

It exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), and when the process holds ``jax``,
``jaxlib``, ``flax`` or ``tumseg`` (``tumseg_torch`` is allowed) at the start
or after the window. ``--control bf16`` runs the program in bf16 compute,
the lower precision that the check has to refuse, and ``--fault`` plants a
fault in its timed path (``faults.py``); the benchmark's own runs take
neither.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


T0 = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):      # run as a file: python3 gpubench/run.py
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpubench import guard, spec  # noqa: E402


class Env:
    """What a loop is given: the cell's configuration and mix, the run's
    seed, window and trace flag, the device and the compute dtype."""

    def __init__(self, cell, cfg, mix, seed, seconds, trace, device,
                 compute_dtype=None):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.compute_dtype = device, compute_dtype

    def window(self) -> float:
        """Seconds of the window: ``--seconds``, and in a traced run at
        most the mix's ``trace_seconds``, which bounds the trace that the
        run reads after it."""
        if self.trace:
            return min(self.seconds, self.mix["trace_seconds"])
        return self.seconds

    def free(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("none", "bf16"), default="none")
    ap.add_argument("--fault", choices=("none", "unchanged", "half",
                                        "altered", "late"), default="none")
    return ap.parse_args(argv)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def execute(args, device, bench=None, cfg=None, mix=None,
            limits=None) -> dict:
    """One run on ``device`` after the checks on the machine: -> the
    result's line (without printing it)."""
    import torch

    bench = bench or spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = cfg or spec.config(cell["config"])
    mix = mix or spec.traffic(cell["traffic"])
    limits = limits or spec.limits(cell["name"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = Env(cell, cfg, mix, args.seed, args.seconds, bool(args.trace),
              device, torch.bfloat16 if args.control == "bf16" else None)
    if args.fault != "none":
        from gpubench import faults

        faults.plant(mix["loop"], args.fault)
    out = spec.loop(mix["loop"]).run(env)
    setup_s = out.pop("window_start") - T0
    if args.trace:
        ctx = dict(out["ctx"], trace=out["trace"])
        metrics = {}
        for m in spec.metrics_of(bench, "per_layer", cell["name"]):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_of(bench, "end_to_end",
                                            cell["name"])}
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in out["checks"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        tr = out["trace"]
        print("trace: stop %.1f s, reduce %.1f s" % (tr["stop_s"],
                                                    tr["reduce_s"]),
              file=sys.stderr)
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
        if "roofline_families" in ctx:
            line["roofline_families"] = ctx["roofline_families"]
            print("roofline families: " + json.dumps(
                ctx["roofline_families"]), file=sys.stderr)
    line["card"] = card_line() if device.type == "cuda" else "cpu"
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    bad = guard.loaded()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print("no CUDA device, or fewer than the %d the cell asks for"
              % cell["chips"], file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print("card: " + card_line(), file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    line = execute(args, device, bench)
    print("run: %.1f s" % (time.perf_counter() - t0), file=sys.stderr)
    bad = guard.loaded()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
