"""Elevation estimation by pose-hypothesis search over LoFTR matches.

Counterpart of ``one2345_tpu/elevation/solver.py`` (reference:
elevation_estimate/utils/elev_est_api.py): 6 pairwise LoFTR matchings of
the 4 nearby views of stage-1 view 0; for each candidate elevation the
4-pose hypothesis (elev -+ 10 at azimuth 30, elev at azimuth 20 and 40),
two-view DLT triangulation of pair (0, 1), transfer of the matches to views
2 and 3 by the nearest view-0 keypoint, and the confidence-weighted
reprojection error, summed over three rotations of the 4-view chain; a
coarse 10-degree sweep over [30, 150), then a 1-degree sweep of 20 values
from 10 below its minimum (get_elev_est:172-193, find_optim_elev:148-169,
ba_error_general:121-145).

Every candidate elevation of a sweep is one batch: the poses are
[E, 4, 4, 4] and the DLT systems [E, K, 4, 4] (``torch.linalg.svd``).  The
nearest-keypoint transfer does not depend on the elevation, so it is
computed once per sweep.  Match slates are fixed-K with validity masks (see
``loftr.py``).

Known divergence from the reference (the JAX package's too): its
background filter indexes ``mask0[y0, x1]``, mixing coordinates of both
images (elev_est_api.py:89); here the mask of each image is read at its own
keypoint.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from one2345_tpu_torch.elevation.loftr import LoFTRMatcher

PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
MATCH_SIZE = 480  # the matcher's square grayscale frame
GRAY = (0.299, 0.587, 0.114)  # cv2.COLOR_RGB2GRAY weights


def pose_hypothesis(elev_deg: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4, 4] OpenCV-convention c2w poses of the 4 nearby views at
    candidate elevations [...] (gen_pose_hypothesis, elev_est_api.py:
    110-118): (elev - 10, elev + 10) at azimuth 30, elev at azimuth 20, 40."""
    e = torch.as_tensor(elev_deg, dtype=torch.float32)
    polar = torch.deg2rad(torch.stack([e - 10.0, e + 10.0, e, e], dim=-1))
    azim = torch.deg2rad(torch.tensor([30.0, 30.0, 20.0, 40.0], device=e.device))
    centers = 1.2 * torch.stack(
        [torch.sin(azim) * torch.sin(polar), -torch.cos(azim) * torch.sin(polar),
         torch.cos(polar)],
        dim=-1,
    )
    fwd = centers / (torch.linalg.vector_norm(centers, dim=-1, keepdim=True) + 1e-10)
    up = torch.tensor([0.0, 0.0, 1.0], device=e.device).expand_as(fwd)
    right = torch.linalg.cross(up, fwd)
    right = right / (torch.linalg.vector_norm(right, dim=-1, keepdim=True) + 1e-10)
    up2 = torch.linalg.cross(fwd, right)
    up2 = up2 / (torch.linalg.vector_norm(up2, dim=-1, keepdim=True) + 1e-10)
    R = torch.stack([right, up2, fwd], dim=-1)  # columns
    # blender -> opencv: negate the up and backward columns (elev_est_api.py:116-117)
    R = R * torch.tensor([1.0, -1.0, -1.0], device=e.device)
    poses = torch.eye(4, device=e.device).expand(*R.shape[:-2], 4, 4).clone()
    poses[..., :3, :3] = R
    poses[..., :3, 3] = centers
    return poses


def triangulate_dlt(P0, P1, pts0, pts1):
    """Two-view DLT triangulation (cv2.triangulatePoints parity).

    :param P0, P1: [..., 3, 4] projection matrices
    :param pts0, pts1: [K, 2] pixel coordinates
    :return: [..., K, 3] world points
    """
    def rows(P, pts, axis):
        return pts[:, axis, None] * P[..., None, 2, :] - P[..., None, axis, :]

    A = torch.stack(
        [rows(P0, pts0, 0), rows(P0, pts0, 1), rows(P1, pts1, 0), rows(P1, pts1, 1)], dim=-2
    )  # [..., K, 4, 4]
    _, _, vh = torch.linalg.svd(A)
    X = vh[..., -1, :]
    w = X[..., 3:4]
    return X[..., :3] / (w + torch.where(w.abs() < 1e-12, 1e-12, 0.0))


def _transfer(k0_01, valid01, k0_x, valid_x):
    """Nearest view-0 keypoint of slate x for every entry of slate (0, 1)
    (under 1 px): (index [K], keep [K] bool).  Independent of the
    elevation."""
    d = torch.linalg.vector_norm(k0_01[:, None, :] - k0_x[None, :, :], dim=-1)
    d = torch.where(valid_x[None, :], d, 1e9)
    idx = torch.argmin(d, dim=1)
    dmin = torch.gather(d, 1, idx[:, None])[:, 0]
    return idx, (dmin < 1.0) & valid01


def _chain_error(K_mat, k0_01, k1_01, conf01, valid01, others, poses):
    """Reprojection error of one rotation of the 4-view chain at every
    candidate elevation (ba_error_general): ``others`` = [(k0, k1, conf,
    valid)] of pairs (0, 2) and (0, 3) of the rotated chain; ``poses``
    [E, 4, 4, 4] -> [E]."""
    P0 = K_mat @ torch.linalg.inv(poses[:, 0])[:, :3, :4]
    P1 = K_mat @ torch.linalg.inv(poses[:, 1])[:, :3, :4]
    Xref = triangulate_dlt(P0, P1, k0_01, k1_01)  # [E, K, 3]

    err_total = 0.0
    for (k0_x, k1_x, conf_x, valid_x), pose_x in zip(others, (poses[:, 2], poses[:, 3])):
        idx, keep = _transfer(k0_01, valid01, k0_x, valid_x)
        w2c = torch.linalg.inv(pose_x)  # [E, 4, 4]
        Xc = Xref @ w2c[:, :3, :3].transpose(1, 2) + w2c[:, None, :3, 3]
        xh = Xc @ K_mat.T
        z = xh[..., 2:3]
        x_img = xh[..., :2] / torch.clamp(z.abs(), min=1e-9) * torch.sign(z)
        tgt = k1_x[idx]
        conf = conf_x[idx] * keep.to(torch.float32)
        e = torch.linalg.vector_norm(tgt - x_img, dim=-1)  # [E, K]
        err_total = err_total + (e * conf).sum(dim=-1) / (conf.sum() + 1e-8)
    return err_total


def elevation_error(elev_deg, K_mat, match_pack):
    """Total chain error at candidate elevations [E] -> [E]
    (find_optim_elev's inner loop: 3 rotations of the 4-view chain)."""
    poses_all = pose_hypothesis(elev_deg)  # [E, 4, 4, 4]

    def pack(i, j):
        if (i, j) in match_pack:
            return match_pack[(i, j)]
        k0, k1, c, v = match_pack[(j, i)]
        return (k1, k0, c, v)

    err = 0.0
    for start in range(3):
        ids = [(start + i) % 4 for i in range(4)]
        p01 = pack(ids[0], ids[1])
        others = [pack(ids[0], ids[2]), pack(ids[0], ids[3])]
        err = err + _chain_error(K_mat, *p01, others, poses_all[:, ids])
    return err


def grayscale_480(images: torch.Tensor) -> torch.Tensor:
    """[V, H, W, 3] f32 in [0, 1] -> [V, 480, 480] grayscale (the cv2
    weights), by a linear resize with half-pixel centres (jax.image.resize
    'linear'; from 256^2 an upsampling, so no antialiasing)."""
    gray = images @ torch.tensor(GRAY, device=images.device)
    return F.interpolate(
        gray[:, None], size=(MATCH_SIZE, MATCH_SIZE), mode="bilinear", align_corners=False
    )[:, 0]


@torch.no_grad()
def _sweep(elevs, K_mat, packed, n_pairs):
    """Chain error at each elevation of ``elevs`` [E] -> [E].

    :param packed: (kpts0 [P, K, 2], kpts1 [P, K, 2], conf [P, K],
        valid [P, K]) of the pairs ``PAIRS[:n_pairs]``"""
    match_pack = {PAIRS[i]: tuple(x[i] for x in packed) for i in range(n_pairs)}
    return elevation_error(elevs, K_mat, match_pack)


@torch.no_grad()
def _sweep_two_stage(K_mat, packed, n_pairs):
    """Coarse 10-degree sweep over [30, 150), then a 1-degree sweep of 20
    values from 10 below its minimum (get_elev_est:172-193) -> the
    elevation (0-d tensor)."""
    dev = K_mat.device
    coarse = torch.arange(30.0, 150.0, 10.0, device=dev)
    e1 = coarse[torch.argmin(_sweep(coarse, K_mat, packed, n_pairs))]
    fine = e1 - 10.0 + torch.arange(0.0, 20.0, 1.0, device=dev)
    return fine[torch.argmin(_sweep(fine, K_mat, packed, n_pairs))]


class ElevationEstimator:
    """4 nearby views -> elevation in degrees (elev_est_api semantics).

    :param matcher: a ``LoFTRMatcher``; None -> ``LoFTRMatcher(device=
        device)`` (seeded weights, f32)
    :param device: where a default matcher is built; None -> 'cuda'
    """

    def __init__(self, matcher: LoFTRMatcher | None = None, focal: float = 280.0,
                 image_size: int = 256, device=None):
        self.matcher = matcher or LoFTRMatcher(device=device)
        self.device = self.matcher.device
        self.K = np.array(
            [[focal, 0, image_size / 2.0], [0, focal, image_size / 2.0], [0, 0, 1]],
            np.float32,
        )
        self.image_size = image_size

    @torch.no_grad()
    def _match_views(self, images: torch.Tensor, masks: torch.Tensor):
        """Grayscale, resize to 480^2, the six matchings and the foreground
        filter, on the matcher's device -> (kpts0, kpts1 [6, K, 2] in the
        input frame, conf [6, K] zero where invalid, valid [6, K]).

        :param images: [4, H, W, 3] f32 in [0, 1]
        :param masks: [4, H, W] bool foreground
        """
        _, H, W, _ = images.shape
        res = self.matcher.match_views(grayscale_480(images), PAIRS)
        scale = torch.tensor([W / MATCH_SIZE, H / MATCH_SIZE], device=images.device)
        k0s = res.kpts0 * scale
        k1s = res.kpts1 * scale
        i0 = torch.tensor([i for i, _ in PAIRS], device=images.device)
        i1 = torch.tensor([j for _, j in PAIRS], device=images.device)

        def fg_at(view_ids, kpts):
            xi = kpts.to(torch.int32)  # truncation, as astype(int32)
            x = xi[..., 0].clamp(0, W - 1).long()
            y = xi[..., 1].clamp(0, H - 1).long()
            return masks[view_ids[:, None], y, x]

        valid = res.valid & fg_at(i0, k0s) & fg_at(i1, k1s)
        return k0s, k1s, res.conf * valid, valid

    @staticmethod
    def _foreground(imgs: torch.Tensor, masks):
        """Foreground mask for match filtering: the caller's masks, or the
        near-white background threshold (elev_est_api mask handling)."""
        if masks is None:
            return ~torch.all(imgs > 245.0 / 255.0, dim=-1)
        return torch.as_tensor(masks, device=imgs.device) > 0

    def match_views(self, images, masks=None):
        """The six pairwise matchings of ``PAIRS``, rescaled to the input
        frame and filtered by the foreground (get_feature_matching): a list
        of (kpts0, kpts1, conf, valid) numpy arrays per pair."""
        imgs = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if imgs.shape[0] != 4:
            raise ValueError(f"match_views takes the 4 nearby views, got {imgs.shape[0]}")
        arrs = [x.cpu().numpy() for x in self._match_views(imgs, self._foreground(imgs, masks))]
        return [tuple(a[p] for a in arrs) for p in range(len(PAIRS))]

    def save_match_visualizations(self, images, out_dir: str, masks=None) -> list[str]:
        """One matching figure per pair of ``PAIRS``, ``match_{i}_{j}.png``
        under ``out_dir`` (the reference's elevation debugging tool,
        elevation_estimate/utils/plotting.py:154); returns their paths.

        :param images: [4, H, W, 3] f32 in [0, 1], a tensor or an array"""
        from one2345_tpu_torch.elevation.plotting import save_match_figures

        packed = self.match_views(images, masks)
        views = torch.as_tensor(images, dtype=torch.float32).cpu().numpy()
        return save_match_figures(views, dict(zip(PAIRS, packed)), out_dir)

    def estimate(self, images, masks=None):
        """:param images: [4, H, W, 3] f32 in [0, 1] (the nearby views of
        view 0), a tensor or an array
        :return: elevation in degrees, or None when some pair has no valid
            match.

        The slates stay on the device and feed the two-stage sweep; only
        the six validity counts and the elevation are read on the host."""
        imgs = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        arrs = self._match_views(imgs, self._foreground(imgs, masks))
        if bool((arrs[3].sum(dim=1) == 0).any()):
            return None
        K = torch.from_numpy(self.K).to(self.device)
        return float(_sweep_two_stage(K, arrs, len(PAIRS)))
