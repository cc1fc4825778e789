"""ICL-NUIM dataset loading (Handa et al. 2014) — config 5 names "TUM +
ICL-NUIM" (BASELINE.json:11).

The reference evaluates on TUM-style RGB-D data; ICL-NUIM is the synthetic
benchmark the north-star adds for BA. Two on-disk layouts exist publicly and
both are supported, auto-detected:

1. **TUM-compatible release** (``rgb.txt``/``depth.txt``/16-bit PNG depth at
   1/5000): loaded by delegating to :class:`~.tum.TumSequence` — identical
   association/decode semantics, ICL intrinsics.
2. **Raw POV-Ray release**: per-frame ``scene_XX_NNN.depth`` text files whose
   values are **Euclidean ray lengths** (distance along the pixel ray, NOT
   planar z) plus same-stem ``.png`` color and a ``*.gt.freiburg``
   ground-truth file (TUM trajectory format, timestamp = frame number).
   Ray lengths are converted to planar depth here — the well-known ICL
   pitfall — via ``z = r / ||((u-cx)/fx, (v-cy)/fy, 1)||``.

Intrinsics: the TUM-compatible release documents fx=481.20 fy=480.0
cx=319.50 cy=239.50. The **raw POV-Ray camera has fy = -480** — its frames
are stored y-flipped relative to the ``.gt.freiburg`` ground-truth
convention (the TUM-compatible PNGs are the row-flipped version of the raw
frames). The raw loader therefore defaults to the negative-fy model and
un-flips each frame on load, publishing the positive-fy camera downstream,
so odometry-vs-GT evaluation sees a consistent orientation. A shipped
``intrinsics.txt`` always wins; write fy<0 there to request the flip
explicitly, fy>0 for already-upright data (the hermetic fixtures do the
latter).
"""

from __future__ import annotations

import os
import re

import numpy as np

from rgbd_pose_estimation_tpu.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu.data.tum import TumSequence
from rgbd_pose_estimation_tpu.eval.traj_io import (
    associate_timestamps,
    read_tum_trajectory,
)


def icl_nuim_intrinsics(
    width: int = 640, height: int = 480, raw: bool = False
) -> CameraIntrinsics:
    """The published ICL-NUIM pinhole model.

    ``raw=False``: TUM-compatible convention (positive fy, upright frames).
    ``raw=True``: the raw POV-Ray render camera — fy is **negative** because
    the raw release stores frames y-flipped; the loader keys the un-flip off
    the fy sign.
    """
    s = width / 640.0
    fy = -480.0 if raw else 480.0
    return CameraIntrinsics(
        481.20 * s, fy * s, 319.50 * s, 239.50 * s, width, height
    )


def euclidean_ray_to_planar_depth(ray_len: np.ndarray, cam: CameraIntrinsics):
    """Convert ICL ``.depth`` Euclidean ray lengths to planar z depth.

    ``ray_len`` is (H, W); each value is the distance from the optical
    center to the surface along the ray through that pixel.  Planar depth is
    the ray length divided by the ray direction's norm at unit z.
    """
    h, w = ray_len.shape
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    norm = np.sqrt(x * x + y * y + 1.0).astype(np.float32)
    return (ray_len.astype(np.float32) / norm).astype(np.float32)


def _read_cam_file(root: str) -> CameraIntrinsics | None:
    """Load ``intrinsics.txt`` (fx fy cx cy w h) when the sequence ships one.

    The public raw release uses the published model (640×480); synthetic
    fixtures and re-rendered sequences record theirs here. The conversion in
    :meth:`IclNuimSequence.frame` is only correct with the camera that
    rendered the ray lengths, so a shipped file always wins over defaults.
    """
    path = os.path.join(root, "intrinsics.txt")
    if not os.path.exists(path):
        return None
    vals = [float(x) for x in open(path).read().split()]
    return CameraIntrinsics(*vals[:4], int(vals[4]), int(vals[5]))


def _frame_number(path: str) -> int:
    m = re.search(r"(\d+)\.(?:depth|png)$", os.path.basename(path))
    return int(m.group(1)) if m else -1


def is_raw_icl_dir(root: str) -> bool:
    """True when ``root`` holds the raw POV-Ray layout (``*.depth`` files)."""
    try:
        return any(f.endswith(".depth") for f in os.listdir(root))
    except OSError:
        return False


class IclNuimSequence:
    """An ICL-NUIM sequence on disk, either layout.

    Exposes the same surface as :class:`TumSequence` (``__len__``,
    ``frame(i) -> (ts, gray, depth)``, ``groundtruth_aligned()``) so the
    odometry/BA pipelines take either interchangeably.
    """

    def __init__(self, root: str, cam: CameraIntrinsics | None = None):
        self.root = root
        self._raw = is_raw_icl_dir(root)
        self.cam = (
            cam
            or _read_cam_file(root)
            or icl_nuim_intrinsics(raw=self._raw)
        )
        # fy < 0 marks y-flipped storage (the public raw release): frames
        # are un-flipped on load and the published camera has positive fy.
        self._vflip = self.cam.fy < 0
        if self._vflip:
            self.cam = CameraIntrinsics(
                self.cam.fx, -self.cam.fy, self.cam.cx, self.cam.cy,
                self.cam.width, self.cam.height,
            )
        if self._raw:
            self._init_raw(root)
        else:
            self._tum = TumSequence(root)
            self.timestamps = self._tum.timestamps

    # --- raw POV-Ray layout ---------------------------------------------
    def _init_raw(self, root: str):
        depth_files = sorted(
            (
                os.path.join(root, f)
                for f in os.listdir(root)
                if f.endswith(".depth")
            ),
            key=_frame_number,
        )
        if not depth_files:
            raise FileNotFoundError(f"no .depth files under {root}")
        self.depth_files = depth_files
        self.rgb_files = [p[: -len(".depth")] + ".png" for p in depth_files]
        # Raw ICL ground truth uses the frame number as the timestamp.
        self.timestamps = np.asarray(
            [float(_frame_number(p)) for p in depth_files]
        )
        gt = [
            os.path.join(root, f)
            for f in os.listdir(root)
            if f.endswith(".gt.freiburg") or f == "groundtruth.txt"
        ]
        if gt:
            self.gt_timestamps, self.gt_poses = read_tum_trajectory(gt[0])
        else:
            self.gt_timestamps, self.gt_poses = None, None

    def __len__(self):
        return len(self.timestamps)

    def frame(self, i: int):
        """``(timestamp, gray float32 (H,W) in [0,1], planar depth meters)``."""
        if not self._raw:
            return self._tum.frame(i)
        from rgbd_pose_estimation_tpu.data.native_loader import decode_gray8

        ray = np.loadtxt(self.depth_files[i], dtype=np.float32)
        if ray.ndim == 1:  # single-line stream variant of the raw release
            ray = ray.reshape(self.cam.height, self.cam.width)
        elif ray.shape != (self.cam.height, self.cam.width):
            raise ValueError(
                f"{self.depth_files[i]}: shape {ray.shape} does not match "
                f"camera {(self.cam.height, self.cam.width)}; ship an "
                "intrinsics.txt or pass cam= explicitly"
            )
        if self._vflip:
            # Raw release rows are stored y-flipped vs the ground truth;
            # un-flip before conversion (cy is the exact image center so
            # ray→planar commutes with the flip — values are identical).
            ray = ray[::-1]
        depth = euclidean_ray_to_planar_depth(ray, self.cam)
        depth[~np.isfinite(depth)] = 0.0
        depth[depth < 0] = 0.0
        depth = np.ascontiguousarray(depth)
        if os.path.exists(self.rgb_files[i]):
            gray = decode_gray8(self.rgb_files[i]).astype(np.float32) / 255.0
            if self._vflip:
                gray = np.ascontiguousarray(gray[::-1])
        else:  # depth-only raw dumps exist; synthesize flat intensity
            gray = np.zeros_like(depth)
        return float(self.timestamps[i]), gray, depth

    def groundtruth_aligned(self):
        if not self._raw:
            return self._tum.groundtruth_aligned()
        if self.gt_timestamps is None:
            return np.zeros(0, np.int64), np.zeros((0, 4, 4), np.float32)
        ia, ib = associate_timestamps(
            self.timestamps, self.gt_timestamps, max_difference=0.5
        )
        return ia, self.gt_poses[ib]


def open_sequence(root: str, cam: CameraIntrinsics | None = None):
    """Open a dataset directory as TUM or ICL-NUIM, auto-detected.

    Raw ICL layout → :class:`IclNuimSequence`; anything with ``rgb.txt`` is
    loaded as TUM (covers both real TUM and ICL's TUM-compatible release —
    pass ``cam=icl_nuim_intrinsics()`` downstream for the latter).
    """
    if is_raw_icl_dir(root):
        return IclNuimSequence(root, cam)
    return TumSequence(root)


def write_synthetic_icl(
    root: str,
    n_frames: int = 8,
    size=(160, 120),
    motion_scale: float = 0.01,
    seed: int = 0,
):
    """Render the analytic test scene into a *raw* ICL-format directory.

    Writes ``scene_00_N.depth`` (Euclidean ray lengths, text), ``.png``
    color, and ``scene_00.gt.freiburg`` — byte-compatible with the public
    raw release — so the loader (including the ray→planar conversion) is
    testable hermetically. Returns the CameraIntrinsics used.
    """
    import jax
    import jax.numpy as jnp

    from rgbd_pose_estimation_tpu.data.png import write_png
    from rgbd_pose_estimation_tpu.data.synthetic import synthetic_sequence
    from rgbd_pose_estimation_tpu.eval.traj_io import write_tum_trajectory

    w, h = size
    cam = CameraIntrinsics(w * 1.0, w * 1.0, w / 2 - 0.5, h / 2 - 0.5, w, h)
    poses, depths, intensities = synthetic_sequence(
        cam, jax.random.key(seed), n_frames, motion_scale
    )
    os.makedirs(root, exist_ok=True)
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    ray_norm = np.sqrt(
        ((u - cam.cx) / cam.fx) ** 2 + ((v - cam.cy) / cam.fy) ** 2 + 1.0
    )
    ts = np.arange(n_frames, dtype=np.float64)
    for i in range(n_frames):
        z = np.asarray(depths[i], dtype=np.float32)
        np.savetxt(os.path.join(root, f"scene_00_{i}.depth"), z * ray_norm, fmt="%.6f")
        gray8 = np.asarray(
            jnp.clip(intensities[i] * 255.0, 0, 255).astype(jnp.uint8)
        )
        write_png(
            os.path.join(root, f"scene_00_{i}.png"),
            np.repeat(gray8[..., None], 3, -1),
        )
    write_tum_trajectory(os.path.join(root, "scene_00.gt.freiburg"), ts, poses)
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write(f"{cam.fx} {cam.fy} {cam.cx} {cam.cy} {cam.width} {cam.height}\n")
    return cam
