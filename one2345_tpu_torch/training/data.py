"""Relative camera pose tokens of the Zero123 finetune data.

Counterpart of the pose helpers of ``one2345_tpu/training/data.py`` (numpy
only): the pose token T = (d_polar, sin d_azimuth, cos d_azimuth,
d_radius) between a conditioning and a target view, the convention of
ObjaverseData.get_T (ldm/data/simple.py).  The dataset readers (rendered
view PNGs, tar shards) are not ported yet.
"""

from __future__ import annotations

import numpy as np


def cartesian_to_spherical(xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(theta_polar, azimuth, radius) of camera positions [.., 3]."""
    xy = xyz[..., 0] ** 2 + xyz[..., 1] ** 2
    z = np.sqrt(xy + xyz[..., 2] ** 2)
    theta = np.arctan2(np.sqrt(xy), xyz[..., 2])  # polar from +z
    azimuth = np.arctan2(xyz[..., 1], xyz[..., 0])
    return theta, azimuth, z


def relative_pose_token(cond_c2w: np.ndarray, target_c2w: np.ndarray) -> np.ndarray:
    """[4] = (d_theta, sin d_az, cos d_az, d_radius) between two views, from
    their camera-to-world matrices."""
    t_cond, az_cond, r_cond = cartesian_to_spherical(cond_c2w[:3, 3])
    t_tgt, az_tgt, r_tgt = cartesian_to_spherical(target_c2w[:3, 3])
    d_t = t_tgt - t_cond
    d_az = (az_tgt - az_cond) % (2 * np.pi)
    return np.array([d_t, np.sin(d_az), np.cos(d_az), r_tgt - r_cond], np.float32)
