"""The synthetic facade tiles that both traffic mixes are made of, from a
mix's parameters and the run's seed, made in bulk on the device.

A tile of ``n`` points is a wall ``L`` m long, ``depth_m`` deep and
``height_m`` high, ``L = n / (points_per_m2 * height_m)``: a share
``wall_share`` of the points lies on the plane y = ``wall_y_m`` with
Gaussian noise of ``wall_noise_m``, the rest uniform in the box; x and z
are uniform. Colours are integers in [0, 255] as f64 columns (red, blue,
green, as the CLIs order them), labels uniform over the classes. The tiles
of a list of sizes come from one generator seeded from the run's seed, so
a seed gives the same tiles, and every seed tiles of the same sizes."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

COLOURS = ("red", "blue", "green")


def make_tiles(mix: Dict, seed: int, sizes: Sequence[int], num_classes: int,
               device) -> List[Dict]:
    """Host arrays of tiles of ``sizes`` points: {"xyz" [n, 3] f64,
    "extra" [3 x [n]] f64, "labels" [n] int64}."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = int(sum(sizes))
    lengths = torch.tensor([s / (mix["points_per_m2"] * mix["height_m"])
                            for s in sizes], dtype=torch.float64,
                           device=device)
    length = torch.repeat_interleave(
        lengths, torch.tensor(list(sizes), device=device), output_size=n)
    u = torch.rand(4, n, generator=g, device=device, dtype=torch.float64)
    noise = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    y = torch.where(u[0] < mix["wall_share"],
                    mix["wall_y_m"] + mix["wall_noise_m"] * noise,
                    u[1] * mix["depth_m"])
    xyz = torch.stack([u[2] * length, y, u[3] * mix["height_m"]], 1)
    colours = torch.randint(0, 256, (len(COLOURS), n), generator=g,
                            device=device).double()
    labels = torch.randint(0, num_classes, (n,), generator=g, device=device)
    xyz, colours, labels = (t.cpu().numpy() for t in (xyz, colours, labels))
    out, start = [], 0
    for s in sizes:
        stop = start + int(s)
        out.append({"xyz": xyz[start:stop],
                    "extra": [c[start:stop] for c in colours],
                    "labels": labels[start:stop]})
        start = stop
    return out


def cycle(mix: Dict, count: int) -> List[int]:
    """The sizes of the mix's first ``count`` tiles: its cycle of sizes."""
    sizes = mix["tile_points"]
    return [int(sizes[i % len(sizes)]) for i in range(count)]
