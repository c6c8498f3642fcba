"""Training data: pose tokens, the reconstruction scenes, a prefetcher.

Counterpart of ``one2345_tpu/training/data.py``:
- the pose token T = (d_polar, sin d_azimuth, cos d_azimuth, d_radius)
  between a conditioning and a target view (ObjaverseData.get_T,
  ldm/data/simple.py);
- the Zero123 finetune readers (ObjaverseData, ldm/data/simple.py:208):
  ``ObjaverseViewsDataset`` over per-object view folders and
  ``ObjaverseTarShards`` over tar shards read in stream mode with the
  standard library's ``tarfile`` (the reference's webdataset ingestion);
  they draw from ``np.random.default_rng(seed)`` in the JAX readers'
  order, so the same files and seed give the same batches bit for bit;
- ``ReconScenesDataset``: reconstruction-training scenes from shape
  directories in the layout ``One2345Pipeline.run`` writes (stage1_8/,
  stage2_8/, pose.json);
- ``Prefetcher``: a background thread that keeps the next items ready.

Views are read with the port's PNG reader and resized with its LANCZOS
(PIL's, RGBA premultiplied as PIL resamples it) when their size differs.
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch


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


def _decode_view(arr: np.ndarray, size: int = 256, bg: float = 1.0) -> np.ndarray:
    """An 8-bit [H, W, 3 or 4] view -> [size, size, 3] in [-1, 1], alpha
    composited over ``bg``; resized first (PIL's LANCZOS) when its size
    differs."""
    from one2345_tpu_torch.utils.resample import pil_resize

    if arr.shape[:2] != (size, size):
        arr = pil_resize(arr, (size, size), "lanczos", device="cpu")
    arr = arr.astype(np.float32) / 255.0
    if arr.shape[-1] == 4:
        arr = arr[..., :3] * arr[..., 3:] + bg * (1.0 - arr[..., 3:])
    return arr * 2.0 - 1.0


def _load_view(path: str, size: int = 256, bg: float = 1.0) -> np.ndarray:
    from one2345_tpu_torch.utils.png import read_png

    return _decode_view(read_png(path), size, bg)


def _c2w(m: np.ndarray) -> np.ndarray:
    """A [3, 4] or [4, 4] camera-to-world matrix as [4, 4]."""
    if m.shape == (3, 4):
        m = np.concatenate([m, [[0, 0, 0, 1]]], axis=0)
    return m


def _stack(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]).astype(np.float32) for k in samples[0]}


class ObjaverseViewsDataset:
    """Zero123 finetune samples from a root of per-object view folders:
    ``root/<uid>/000.png ... 011.png`` (RGBA renders) and ``000.npy ...
    011.npy`` ([3, 4] or [4, 4] camera-to-world matrices), the reference's
    views_whole_sphere layout.  A sample is a random object and two
    distinct random views of it: {'image_cond', 'image_target' [size,
    size, 3] in [-1, 1], 'T' [1, 4] the pose token}."""

    def __init__(self, root_dir: str, total_views: int = 12, image_size: int = 256,
                 paths: list[str] | None = None, seed: int = 0):
        self.root = root_dir
        if paths is None:
            paths = sorted(
                d for d in os.listdir(root_dir) if os.path.isdir(os.path.join(root_dir, d))
            )
        self.paths = paths
        self.total_views = total_views
        self.image_size = image_size
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def sample(self, idx: int | None = None) -> dict:
        if idx is None:
            idx = int(self.rng.integers(len(self.paths)))
        obj = os.path.join(self.root, self.paths[idx])
        ic, it = self.rng.choice(self.total_views, 2, replace=False)

        def cam(i):
            return _c2w(np.load(os.path.join(obj, f"{i:03d}.npy")))

        return {
            "image_cond": _load_view(os.path.join(obj, f"{ic:03d}.png"), self.image_size),
            "image_target": _load_view(os.path.join(obj, f"{it:03d}.png"), self.image_size),
            "T": relative_pose_token(cam(ic), cam(it))[None],
        }

    def batches(self, batch_size: int) -> Iterator[dict]:
        """Endless [B, ...] f32 batches of ``sample()``."""
        while True:
            yield _stack([self.sample() for _ in range(batch_size)])


class ObjaverseTarShards:
    """Zero123 finetune samples streamed from tar shards (the reference's
    webdataset ingestion, ObjaverseDataModuleFromConfig, ldm/data/simple.py:168).

    Shard layout (views_release packing): members ``<uid>/<idx>.png`` (RGBA
    render) and ``<uid>/<idx>.npy`` ([3, 4] or [4, 4] camera-to-world).  An
    object is complete when the next uid starts (or its shard ends); objects
    with fewer than two views holding both files are skipped.  A shuffle
    buffer of ``shuffle_buffer`` objects decorrelates neighbours: once full,
    each new object sends a random one out.  The shards are walked in a
    random order each pass; with ``loop=False`` one pass, then the buffer
    drains in random order."""

    def __init__(self, shard_paths: list[str], image_size: int = 256,
                 shuffle_buffer: int = 256, seed: int = 0, loop: bool = True):
        if not shard_paths:
            raise ValueError("no shards given")
        self.shards = list(shard_paths)
        self.image_size = image_size
        self.shuffle_buffer = shuffle_buffer
        self.loop = loop
        self.rng = np.random.default_rng(seed)

    def _iter_objects(self) -> Iterator[dict]:
        """{'pngs': {idx: bytes}, 'cams': {idx: [4, 4]}} per object."""
        import tarfile

        while True:
            order = list(self.shards)
            self.rng.shuffle(order)
            for shard in order:
                with tarfile.open(shard, "r|*") as tf:  # a stream: no seeks
                    current_uid, pngs, cams = None, {}, {}
                    for m in tf:
                        if not m.isfile() or "/" not in m.name:
                            continue
                        uid, fname = m.name.split("/", 1)
                        if current_uid is not None and uid != current_uid:
                            if pngs and cams:
                                yield {"pngs": pngs, "cams": cams}
                            pngs, cams = {}, {}
                        current_uid = uid
                        stem, ext = os.path.splitext(fname)
                        data = tf.extractfile(m).read()
                        if ext == ".png":
                            pngs[stem] = data
                        elif ext == ".npy":
                            cams[stem] = _c2w(np.load(io.BytesIO(data)))
                    if pngs and cams:
                        yield {"pngs": pngs, "cams": cams}
            if not self.loop:
                return

    def samples(self) -> Iterator[dict]:
        from one2345_tpu_torch.utils.png import decode_png

        def emit(obj):
            keys = sorted(set(obj["pngs"]) & set(obj["cams"]))
            ic, it = self.rng.choice(len(keys), 2, replace=False)
            kc, kt = keys[int(ic)], keys[int(it)]
            return {
                "image_cond": _decode_view(decode_png(obj["pngs"][kc]), self.image_size),
                "image_target": _decode_view(decode_png(obj["pngs"][kt]), self.image_size),
                "T": relative_pose_token(obj["cams"][kc], obj["cams"][kt])[None],
            }

        buf: list[dict] = []
        for obj in self._iter_objects():
            if len(set(obj["pngs"]) & set(obj["cams"])) < 2:
                continue
            buf.append(obj)
            if len(buf) < self.shuffle_buffer:
                continue
            yield emit(buf.pop(int(self.rng.integers(len(buf)))))
        while buf:  # one pass (loop=False): drain the buffer
            yield emit(buf.pop(int(self.rng.integers(len(buf)))))

    def batches(self, batch_size: int) -> Iterator[dict]:
        """[B, ...] f32 batches of ``samples()``; ends with the samples (a
        short last batch is dropped)."""
        it = self.samples()
        while True:
            samples = []
            for _ in range(batch_size):
                try:
                    samples.append(next(it))
                except StopIteration:
                    return
            yield _stack(samples)


class ReconScenesDataset:
    """Reconstruction-training scenes from shape directories (stage1_8/,
    stage2_8/, pose.json: the pipeline's own artifact layout, One2345_train.py's
    reference + source view assembly).

    The scene order follows a numpy generator seeded with ``seed``, as in
    the JAX dataset; each scene's rays are drawn with a ``torch.Generator``
    seeded from the same numpy generator, where the JAX dataset seeds a
    PRNG key."""

    def __init__(self, root_dir: str, n_rays: int = 512, seed: int = 0,
                 shape_dirs: list[str] | None = None):
        self.root = root_dir
        if shape_dirs is None:
            shape_dirs = sorted(
                d for d in os.listdir(root_dir) if os.path.isdir(os.path.join(root_dir, d))
            )
        self.shape_dirs = shape_dirs
        self.n_rays = n_rays
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.shape_dirs)

    def load_scene(self, idx: int) -> dict:
        """{'images' [33, 256, 256, 3] in [0, 1] (the reference view, then
        the 32 stage-2 views), 'cameras': ``build_recon_cameras`` at the
        polar angle of the first pose}."""
        from one2345_tpu_torch.geometry import cameras as cam

        shape_dir = os.path.join(self.root, self.shape_dirs[idx])
        with open(os.path.join(shape_dir, "pose.json")) as f:
            meta = json.load(f)
        c2w0 = np.asarray(meta["c2ws"]["0.png"] if "0.png" in meta["c2ws"]
                          else list(meta["c2ws"].values())[0])
        polar = np.degrees(np.arccos(np.clip(c2w0[2, 3] / 1.2, -1, 1)))
        pack = cam.build_recon_cameras(float(polar))
        imgs = [_load_view(os.path.join(shape_dir, "stage1_8", pack["img_ids"][0]))]
        for img_id in pack["img_ids"][8:]:
            imgs.append(_load_view(os.path.join(shape_dir, "stage2_8", img_id)))
        images = (np.stack(imgs) + 1.0) / 2.0
        return {"images": images.astype(np.float32), "cameras": pack}

    def sample_scene(self, idx: int | None = None, generator: torch.Generator | None = None,
                     ray_idx=None) -> dict:
        """A scene in the ``ReconTrainer`` format: random rays of the
        reference view, half of them on its foreground (non-white pixels:
        the renders are on white).  ``ray_idx`` gives the [n_rays] pixel
        indices instead of a draw."""
        from one2345_tpu_torch.geometry.rays import random_rays_from_image

        if idx is None:
            idx = int(self.rng.integers(len(self.shape_dirs)))
        sc = self.load_scene(idx)
        pack = sc["cameras"]
        img0 = sc["images"][0]
        mask = (~np.all(img0 > 245 / 255.0, axis=-1)).astype(np.float32)
        if generator is None and ray_idx is None:
            generator = torch.Generator().manual_seed(int(self.rng.integers(1 << 31)))
        rays = random_rays_from_image(
            generator, self.n_rays, torch.from_numpy(img0),
            torch.from_numpy(pack["intrinsics"][0]), torch.from_numpy(pack["c2ws"][0]),
            mask=torch.from_numpy(mask), idx=ray_idx,
        )
        return {
            "images": sc["images"],
            "affines": pack["affines"],
            "w2cs": pack["w2cs"],
            "intrinsics": pack["intrinsics"],
            "near_far": pack["query_near_far"],
            **{k: rays[k].numpy().astype(np.float32)
               for k in ("rays_o", "rays_v", "rays_color", "rays_mask")},
        }


class Prefetcher:
    """Background-thread prefetch of an iterator's items (host IO overlaps
    the card's steps).  An exception of the iterator is raised by the
    ``__next__`` that reaches it, and its end by StopIteration; the JAX
    prefetcher's thread dies there and its ``__next__`` waits forever."""

    _END = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False

        def work():
            try:
                for item in iterator:
                    if self._stop:
                        return
                    self.q.put((item, None))
                self.q.put((self._END, None))
            except BaseException as e:  # handed to the consumer
                self.q.put((None, e))

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item, err = self.q.get()
        if err is not None:
            raise err
        if item is self._END:
            raise StopIteration
        return item

    def close(self):
        """Stop the thread after the item it is making (a full queue is
        drained so that it can see the request)."""
        self._stop = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
