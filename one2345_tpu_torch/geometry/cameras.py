"""Camera rig synthesis and normalization for the 1 + 32-view reconstruction.

A copy of ``build_recon_cameras`` and ``pose_dict`` / ``write_pose_json``
of ``one2345_tpu/geometry/cameras.py`` and what they call (numpy only; the
port imports nothing of the JAX package).  It follows the reference's pose pipeline:

- spherical look-at pose synthesis        (utils/utils.py:80-128)
- the 8 first-stage + 32 second-stage rig (utils/utils.py:106-128)
- scene normalization via view-frustum bounding boxes
  (reconstruction/data/scene.py:48-101, One2345_eval_new_data.py:125-134,
   242-274) — done analytically instead of cv2.decomposeProjectionMatrix.

Conventions: poses produced by `spherical_look_at_poses` are "blender"-style
camera-to-world matrices (camera looks along -z toward the origin); the
reconstruction stage converts them to OpenCV convention with BLENDER2OPENCV
(One2345_eval_new_data.py:160-162).
"""

from __future__ import annotations

import json
import os

import numpy as np

# Default rig constants (utils/utils.py:130-145).
FOCAL = 560.0 / 2.0
IMAGE_HW = (256, 256)
NEAR_FAR = (1.2 - 0.7, 1.2 + 0.6)
CAMERA_RADIUS = 1.2

BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float64
)


def intrinsic_matrix(focal: float = FOCAL, h: int = 256, w: int = 256) -> np.ndarray:
    return np.array(
        [[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float64,
    )


def spherical_look_at_poses(
    polar: np.ndarray, azimuth: np.ndarray, radius: float = CAMERA_RADIUS
) -> np.ndarray:
    """Camera-to-world look-at poses on a sphere, z-up.

    ``polar`` is the angle from the +z pole, ``azimuth`` rotates about z; both
    in radians.  Matches utils/utils.py:80-104 (`calc_pose`): the camera sits
    at radius*[sin(az)sin(polar), -cos(az)sin(polar), cos(polar)] looking at
    the origin, with the world +z as the up hint.

    Returns [N, 4, 4] float64 c2w matrices (blender convention: columns are
    right/up/backward, i.e. the camera looks along -forward... here `forward`
    points *from the origin to the camera*, so the view direction is -forward).
    """
    polar = np.asarray(polar, dtype=np.float64)
    azimuth = np.asarray(azimuth, dtype=np.float64)
    n = polar.shape[0]

    centers = np.stack(
        [
            radius * np.sin(azimuth) * np.sin(polar),
            -radius * np.cos(azimuth) * np.sin(polar),
            radius * np.cos(polar),
        ],
        axis=-1,
    )  # [N, 3]

    def _normalize(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    forward = _normalize(centers)
    up = np.broadcast_to(np.array([0.0, 0.0, 1.0]), (n, 3))
    right = np.cross(up, forward)
    # degenerate pole handling (reference uses a global fallback; per-row here)
    deg = np.linalg.norm(right, axis=-1, keepdims=True) < 0.1
    right = np.where(deg, np.array([0.0, 1.0, 0.0]), right)
    right = _normalize(right)
    up = _normalize(np.cross(forward, right))

    poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    poses[:, :3, :3] = np.stack([right, up, forward], axis=-1)
    poses[:, :3, 3] = centers
    return poses


def rig_view_angles(init_elev_deg: float) -> tuple[list[str], np.ndarray, np.ndarray]:
    """The 8 stage-1 + 32 stage-2 view directions given the input elevation.

    Mirrors utils/utils.py:106-128 (`get_poses`): two rings of 4 azimuths
    (offset 30 deg and 60 deg) at the estimated elevation and at +/-30 deg,
    plus 4 nearby views (elev -/+10, az -/+10) per stage-1 view.  Returns
    (image ids, polar angles [40] rad, azimuths [40] rad).
    """
    mid = float(init_elev_deg)
    deg = 10.0
    if mid <= 75:
        second = mid + 30.0
        ids_main = list(range(8))
    else:
        second = mid - 30.0
        ids_main = list(range(4)) + list(range(8, 12))

    polar_deg = (
        [mid] * 4
        + [second] * 4
        + [mid - deg, mid + deg, mid, mid] * 4
        + [second - deg, second + deg, second, second] * 4
    )
    img_ids = [f"{i}.png" for i in ids_main] + [
        f"{i}_{j}.png" for i in ids_main for j in range(4)
    ]
    overlook = [30.0 + 90.0 * k for k in range(4)]
    eyelevel = [60.0 + 90.0 * k for k in range(4)]
    source_delta = [0.0, 0.0, -deg, deg]
    azim_deg = (
        overlook
        + eyelevel
        + [t + s for t in overlook for s in source_delta]
        + [t + s for t in eyelevel for s in source_delta]
    )
    return img_ids, np.radians(polar_deg), np.radians(azim_deg)


def rig_poses(init_elev_deg: float) -> tuple[list[str], np.ndarray]:
    """(image ids, [40,4,4] blender-convention c2w) for the full rig."""
    img_ids, polar, azim = rig_view_angles(init_elev_deg)
    return img_ids, spherical_look_at_poses(polar, azim)


# ---------------------------------------------------------------------------
# Scene normalization (scale-mat) — analytic replacement of the reference's
# cv2.decomposeProjectionMatrix round-trip (One2345_eval_new_data.py:242-274).
# ---------------------------------------------------------------------------


def pose_dict(init_elev_deg: float) -> dict:
    """pose.json-compatible payload (utils/utils.py:130-145)."""
    img_ids, poses = rig_poses(init_elev_deg)
    return {
        "intrinsics": intrinsic_matrix().tolist(),
        "near_far": list(NEAR_FAR),
        "c2ws": {img_id: poses[i].tolist() for i, img_id in enumerate(img_ids)},
    }


def write_pose_json(shape_dir: str, init_elev_deg: float) -> str:
    """Write ``pose_dict`` to ``shape_dir/pose.json``; returns the path."""
    path = os.path.join(shape_dir, "pose.json")
    with open(path, "w") as f:
        json.dump(pose_dict(init_elev_deg), f, indent=4)
    return path


def view_frustum_points(
    intrinsic: np.ndarray, c2w: np.ndarray, near: float, far: float, img_hw=IMAGE_HW
) -> np.ndarray:
    """[8, 3] world-space corners of a camera frustum (scene.py:15-36)."""
    h, w = img_hw
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    xs = np.array([0, 0, w, w, 0, 0, w, w], dtype=np.float64)
    ys = np.array([0, h, 0, h, 0, h, 0, h], dtype=np.float64)
    zs = np.array([near] * 4 + [far] * 4, dtype=np.float64)
    pts_cam = np.stack([(xs - cx) * zs / fx, (ys - cy) * zs / fy, zs], axis=-1)
    pts_h = np.concatenate([pts_cam, np.ones((8, 1))], axis=-1)
    return (c2w @ pts_h.T).T[:, :3]


def scene_scale_mat(
    intrinsics: np.ndarray,
    w2cs: np.ndarray,
    near_fars: np.ndarray,
    img_hw=IMAGE_HW,
    factor: float = 1.1,
) -> tuple[np.ndarray, float]:
    """Scale matrix mapping the normalized unit cube to world space.

    The bounding box is the union of all view frustums; radius is half the
    largest box edge times ``factor`` (scene.py:48-101 + cal_scale_mat
    factor=1.1 at One2345_eval_new_data.py:244).  Returns (scale_mat [4,4],
    1/radius).
    """
    pts = []
    for K, w2c, nf in zip(intrinsics, w2cs, near_fars):
        c2w = np.linalg.inv(w2c)
        pts.append(view_frustum_points(K[:3, :3], c2w, nf[0], nf[1], img_hw))
    pts = np.concatenate(pts, axis=0)
    bb_min, bb_max = pts.min(axis=0), pts.max(axis=0)
    center = (bb_min + bb_max) / 2.0
    radius = float((bb_max - bb_min).max() / 2.0) * factor
    scale_mat = np.diag([radius, radius, radius, 1.0]).astype(np.float64)
    scale_mat[:3, 3] = center
    return scale_mat, 1.0 / radius


def apply_scale_mat(
    intrinsics: np.ndarray, w2cs: np.ndarray, scale_mat: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-express cameras in the normalized (unit-cube) space.

    The reference composes P = K @ w2c @ S and re-decomposes with
    cv2.decomposeProjectionMatrix (One2345_eval_new_data.py:258-267).  For
    S = diag(r,r,r,1) + translation this has the closed form used here:
    the rotation is unchanged and the camera center maps through S^-1.
    Returns (new w2cs [V,4,4], new c2ws, affine projection mats K@w2c [V,4,4]).
    """
    V = w2cs.shape[0]
    r = scale_mat[0, 0]
    t = scale_mat[:3, 3]
    new_w2cs = np.zeros_like(w2cs)
    new_c2ws = np.zeros_like(w2cs)
    affines = np.zeros_like(w2cs)
    for i in range(V):
        R = w2cs[i, :3, :3]
        c = np.linalg.inv(w2cs[i])[:3, 3]
        c_new = (c - t) / r
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = -R @ c_new
        c2w = np.linalg.inv(w2c)
        new_w2cs[i] = w2c
        new_c2ws[i] = c2w
        aff = np.eye(4)
        aff[:3, :4] = intrinsics[i][:3, :3] @ w2c[:3, :4]
        affines[i] = aff
    return new_w2cs, new_c2ws, affines


def normalized_near_far(c2ws: np.ndarray) -> np.ndarray:
    """Per-view [near, far] = cam distance -/+ 1, widened by 5%
    (One2345_eval_new_data.py:269-274)."""
    dists = np.linalg.norm(c2ws[:, :3, 3], axis=-1)
    near = 0.95 * (dists - 1.0)
    far = 1.05 * (dists + 1.0)
    return np.stack([near, far], axis=-1)


def build_recon_cameras(
    init_elev_deg: float, factor: float = 1.1
) -> dict[str, np.ndarray]:
    """Assemble the normalized 1+32-view camera pack the reconstruction stage
    consumes (ref view 0 + 32 stage-2 views), mirroring BlenderPerView
    (One2345_eval_new_data.py:143-307).

    Returns dict with: 'w2cs' [33,4,4], 'c2ws' [33,4,4], 'intrinsics'
    [33,3,3], 'affines' [33,4,4], 'near_fars' [33,2], 'scale_mat' [4,4],
    'trans_mat' [4,4] (w2c_ref_inv), 'target_w2cs' [8,4,4] (normalized
    stage-1 views), 'query_*' entries for the reference view.
    """
    img_ids, poses_blender = rig_poses(init_elev_deg)
    c2ws_cv = poses_blender @ BLENDER2OPENCV  # [40,4,4] opencv convention
    w2cs_cv = np.linalg.inv(c2ws_cv)

    w2c_ref = w2cs_cv[0]
    trans_mat = np.linalg.inv(w2c_ref)  # w2c_ref_inv

    K = intrinsic_matrix()
    # selected views: ref (0) + the 32 stage-2 views (ids 8..39)
    sel = [0] + list(range(8, 40))
    w2cs = np.stack([w2cs_cv[i] @ trans_mat for i in sel])
    intrinsics = np.stack([np.block([[K, np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]])] * len(sel))
    near_fars = np.stack([np.array(NEAR_FAR)] * len(sel))

    scale_mat, scale_factor = scene_scale_mat(intrinsics, w2cs, near_fars, factor=factor)
    new_w2cs, new_c2ws, affines = apply_scale_mat(intrinsics, w2cs, scale_mat)
    near_fars_n = normalized_near_far(new_c2ws)

    # stage-1 target views (candidate render poses), normalized the same way
    tgt_w2cs_raw = np.stack([w2cs_cv[i] @ trans_mat for i in range(8)])
    tgt_w2cs, _, _ = apply_scale_mat(intrinsics[:8], tgt_w2cs_raw, scale_mat)

    return {
        "img_ids": img_ids,
        "w2cs": new_w2cs.astype(np.float32),
        "c2ws": new_c2ws.astype(np.float32),
        "intrinsics": intrinsics[:, :3, :3].astype(np.float32),
        "affines": affines.astype(np.float32),
        "near_fars": near_fars_n.astype(np.float32),
        "scale_mat": scale_mat.astype(np.float32),
        "trans_mat": trans_mat.astype(np.float32),
        "target_w2cs": tgt_w2cs.astype(np.float32),
        "query_c2w": new_c2ws[0].astype(np.float32),
        "query_w2c": new_w2cs[0].astype(np.float32),
        "query_near_far": near_fars_n[0].astype(np.float32),
    }
