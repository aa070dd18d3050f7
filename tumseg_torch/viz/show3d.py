"""Interactive point-cloud viewer: OpenCV window + native sphere-sprite
renderer (render_balls.cpp via ctypes).

Capability parity with the reference viewer
(visualizer/show3d_balls.py:31-164): mouse-drag rotation,
keyboard controls q/Q quit, t ground-truth colors, p predicted colors,
n/m zoom in/out, r reset zoom, s save PNG snapshot.

The renderer .so is built on demand with build.sh (g++ one-liner); rendering
also works headless via :func:`render_frame`, which the tests and snapshot
writers use without a GUI.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
import sys

import numpy as np

BASE_DIR = os.path.dirname(os.path.abspath(__file__))
_SO_PATH = os.path.join(BASE_DIR, "render_balls.so")
_dll = None


def _load_renderer():
    global _dll
    if _dll is None:
        if not os.path.exists(_SO_PATH):
            subprocess.run(["sh", os.path.join(BASE_DIR, "build.sh")],
                           check=True)
        _dll = np.ctypeslib.load_library("render_balls", BASE_DIR)
    return _dll


def render_frame(xyz: np.ndarray, colors: np.ndarray, *, size: int = 800,
                 ballradius: int = 10, background=(0, 0, 0),
                 rot: np.ndarray = None, zoom: float = 1.0) -> np.ndarray:
    """Render one frame to an [size, size, 3] uint8 image (BGR like cv2)."""
    dll = _load_renderer()
    xyz = np.asarray(xyz, dtype=np.float64)
    xyz = xyz - xyz.mean(axis=0)
    radius = np.sqrt((xyz ** 2).sum(axis=-1)).max()
    xyz = xyz / ((radius * 2.2) / size)
    if rot is not None:
        xyz = xyz @ (rot * zoom)
    else:
        xyz = xyz * zoom
    ixyz = (xyz + [size / 2, size / 2, 0]).astype(np.int32)

    colors = np.require(np.asarray(colors, dtype=np.float32), "float32", "C")
    c0 = np.require(colors[:, 0], "float32", "C")
    c1 = np.require(colors[:, 1], "float32", "C")
    c2 = np.require(colors[:, 2], "float32", "C")
    show = np.zeros((size, size, 3), dtype="uint8")
    show[:] = background
    ixyz = np.require(ixyz, "int32", "C")
    dll.render_ball(
        ct.c_int(size), ct.c_int(size),
        show.ctypes.data_as(ct.c_void_p),
        ct.c_int(ixyz.shape[0]),
        ixyz.ctypes.data_as(ct.c_void_p),
        c0.ctypes.data_as(ct.c_void_p),
        c1.ctypes.data_as(ct.c_void_p),
        c2.ctypes.data_as(ct.c_void_p),
        ct.c_int(ballradius))
    return show


def _rotation(xangle: float, yangle: float) -> np.ndarray:
    rx = np.array([
        [1.0, 0.0, 0.0],
        [0.0, np.cos(xangle), -np.sin(xangle)],
        [0.0, np.sin(xangle), np.cos(xangle)],
    ])
    ry = np.array([
        [np.cos(yangle), 0.0, -np.sin(yangle)],
        [0.0, 1.0, 0.0],
        [np.sin(yangle), 0.0, np.cos(yangle)],
    ])
    return rx @ ry


def _normalize_colors(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float32).copy()
    for ch in range(3):
        c[:, ch] /= (c[:, ch].max() + 1e-14) / 255.0
    return c


def showpoints(xyz, c_gt=None, c_pred=None, waittime=0, showrot=False,
               magnifyBlue=0, freezerot=False, background=(0, 0, 0),
               normalizecolor=True, ballradius=10):
    """Interactive loop (requires a display); key bindings as in the
    reference. Returns the last pressed key code."""
    import cv2

    size = 800
    state = {"mx": 0.5, "my": 0.5, "zoom": 1.0, "changed": True}

    def onmouse(*args):
        state["my"], state["mx"] = args[1] / size, args[2] / size
        state["changed"] = True

    cv2.namedWindow("show3d")
    cv2.moveWindow("show3d", 0, 0)
    cv2.setMouseCallback("show3d", onmouse)

    white = np.full((len(xyz), 3), 255.0, dtype=np.float32)
    palette = {"t": c_gt if c_gt is not None else white,
               "p": c_pred if c_pred is not None else white}
    colors = palette["t"]
    if normalizecolor:
        colors = _normalize_colors(colors)

    show = None
    cmd = 0
    while True:
        if state["changed"] or show is None:
            if freezerot:
                xangle = yangle = 0.0
            else:
                xangle = (state["mx"] - 0.5) * np.pi * 1.2
                yangle = (state["my"] - 0.5) * np.pi * 1.2
            show = render_frame(xyz, colors, size=size, ballradius=ballradius,
                                background=background,
                                rot=_rotation(xangle, yangle),
                                zoom=state["zoom"])
            if magnifyBlue > 0:
                for ax, shifts in ((0, (1, -1)), (1, (1, -1))):
                    for sh in shifts[: 2 if magnifyBlue >= 2 else 1]:
                        show[:, :, 0] = np.maximum(
                            show[:, :, 0], np.roll(show[:, :, 0], sh, axis=ax))
            state["changed"] = False
        cv2.imshow("show3d", show)
        cmd = cv2.waitKey(waittime if waittime else 10) % 256
        if cmd == ord("q"):
            break
        if cmd == ord("Q"):
            sys.exit(0)
        if cmd in (ord("t"), ord("p")):
            colors = palette[chr(cmd)]
            if normalizecolor:
                colors = _normalize_colors(colors)
            state["changed"] = True
        elif cmd == ord("n"):
            state["zoom"] *= 1.1
            state["changed"] = True
        elif cmd == ord("m"):
            state["zoom"] /= 1.1
            state["changed"] = True
        elif cmd == ord("r"):
            state["zoom"] = 1.0
            state["changed"] = True
        elif cmd == ord("s"):
            cv2.imwrite("show3d.png", show)
        if waittime != 0:
            break
    return cmd


def demo(argv=None):
    """Runnable demo entry point, the counterpart of the reference viewer's
    ``__main__`` (visualizer/show3d_balls.py:167-223): load a
    cloud, resample ``--npoints`` points, color them with a label cmap and
    drive :func:`showpoints`. Upstream the demo imports a ShapeNetDataLoader
    that does not exist in the repository, so it cannot actually run there;
    this one works: ``--dataset`` takes a LAS tile (labels from its
    classification field), and with no dataset a synthetic labeled facade is
    generated. ``--snapshot PATH`` renders headlessly instead of opening a
    window (no display needed)."""
    import argparse

    parser = argparse.ArgumentParser(description=demo.__doc__)
    parser.add_argument("--dataset", type=str, default=None,
                        help="LAS tile to view (default: synthetic facade)")
    parser.add_argument("--npoints", type=int, default=2500,
                        help="resample points number")
    parser.add_argument("--ballradius", type=int, default=10,
                        help="ballradius")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--snapshot", type=str, default=None,
                        help="write one rendered frame to this PNG/JPG and "
                             "exit instead of opening a window")
    opt = parser.parse_args(argv)

    rng = np.random.default_rng(opt.seed)
    if opt.dataset:
        from tumseg_torch.data.las import read_las

        las = read_las(opt.dataset)
        point_set = np.asarray(las.xyz, dtype=np.float64)
        seg = np.asarray(las.classification, dtype=np.int64)
    else:  # synthetic facade: wall plane + window grid + terrain strip
        n = 20000
        x = rng.uniform(0, 4.0, n)
        z = rng.uniform(0, 3.0, n)
        y = rng.normal(0.0, 0.02, n)
        seg = np.ones(n, dtype=np.int64)
        seg[z < 0.3] = 2
        seg[(np.floor(x / 0.8) % 2 == 0) & (np.floor(z / 0.9) % 2 == 1)] = 0
        point_set = np.stack([x, y, z], axis=1)

    choice = rng.choice(point_set.shape[0], opt.npoints, replace=True)
    point_set, seg = point_set[choice, :], seg[choice]
    seg = seg - seg.min()

    # reference demo cmap (10 entries, reused cyclically for higher labels)
    cmap = np.array([[1.0, 0.0, 0.0],
                     [3.12493437e-02, 1.0, 1.31250131e-06],
                     [0.0, 6.25019688e-02, 1.0]] + [[1.0, 0.0, 0.09375]] * 7)
    gt = cmap[seg % len(cmap), :]

    if opt.snapshot:
        import cv2

        frame = render_frame(point_set, _normalize_colors(gt),
                             background=(255, 255, 255),
                             ballradius=opt.ballradius)
        cv2.imwrite(opt.snapshot, frame)
        print(f"wrote {opt.snapshot}")
        return

    showpoints(point_set, gt, c_pred=gt, waittime=0, showrot=False,
               magnifyBlue=0, freezerot=False, background=(255, 255, 255),
               normalizecolor=True, ballradius=opt.ballradius)


if __name__ == "__main__":
    demo()
