"""Downloader of the reference's published checkpoints (download_ckpt.py:21-29).

    python -m one2345_tpu_torch.utils.download_ckpt --out ckpts/

Counterpart of ``one2345_tpu/utils/download_ckpt.py`` with its table, flags
and errors, on the standard library alone.  It fetches the four files from
the One-2-3-45 HuggingFace repository, resuming a partial ``.part`` file
with an HTTP ``Range`` request, rejects a result below the file's plausible
size (an HTML error page served in place of weights) and writes each file's
sha256 into a ``<name>.sha256`` sidecar.  Without network access it fails
at once with a message that says where to put a file obtained elsewhere;
``examples/torch_validate_real_weights.py`` then goes on from that
directory.
"""

from __future__ import annotations

import hashlib
import os
import urllib.error
import urllib.request

_HF = "https://huggingface.co/One-2-3-45/code/resolve/main"

# name -> (url, minimum plausible size in MB).  Upstream publishes no
# hashes: the sha256 of the first good fetch goes into <name>.sha256, so a
# later fetch or copy can be held to it.
CKPTS: dict[str, tuple[str, int]] = {
    "zero123-xl.ckpt": (f"{_HF}/zero123-xl.ckpt", 7000),
    "sam_vit_h_4b8939.pth": (f"{_HF}/sam_vit_h_4b8939.pth", 2000),
    "indoor_ds_new.ckpt": (
        f"{_HF}/elevation_estimate/utils/weights/indoor_ds_new.ckpt",
        10,
    ),
    "ckpt_215000.pth": (
        f"{_HF}/SparseNeuS_demo_v1/exp/lod0/checkpoints/ckpt_215000.pth",
        1,
    ),
}


class DownloadError(RuntimeError):
    """Raised when a checkpoint cannot be fetched (typically: no egress)."""


def _sha256(path: str, chunk: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def download_one(name: str, out_dir: str, timeout: float = 30.0) -> str:
    """Fetch one checkpoint (resuming a partial file); returns its path.

    :raises KeyError: for a name not in ``CKPTS``
    :raises DownloadError: on a network failure or an implausibly small file
    """
    if name not in CKPTS:
        raise KeyError(f"unknown checkpoint {name!r}; choose from {sorted(CKPTS)}")
    url, min_mb = CKPTS[name]
    os.makedirs(out_dir, exist_ok=True)
    dest = os.path.join(out_dir, name)
    part = dest + ".part"
    if os.path.isfile(dest) and os.path.getsize(dest) >= min_mb << 20:
        return dest

    def promote() -> str:
        size = os.path.getsize(part)
        os.replace(part, dest)
        digest = _sha256(dest)
        with open(dest + ".sha256", "w") as f:
            f.write(f"{digest}  {name}\n")
        print(f"{name}: {size / 1e6:.1f} MB sha256={digest}")
        return dest

    start = os.path.getsize(part) if os.path.isfile(part) else 0
    if start >= min_mb << 20:
        # an earlier run wrote the whole file and died before the rename:
        # a request for bytes=<full size>- would get HTTP 416
        return promote()
    req = urllib.request.Request(url)
    if start:
        req.add_header("Range", f"bytes={start}-")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            # 206: the server resumes; 200: it sends the whole file again
            mode = "ab" if start and r.status == 206 else "wb"
            with open(part, mode) as f:
                while True:
                    b = r.read(1 << 22)
                    if not b:
                        break
                    f.write(b)
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise DownloadError(
            f"could not fetch {name} from {url} ({e}). "
            f"If this environment has no egress, obtain the file elsewhere "
            f"and place it at {dest}."
        ) from e

    size = os.path.getsize(part)
    if size < min_mb << 20:
        # removed now: a resume would append real bytes to an HTML error
        # page and promote a corrupt checkpoint
        os.unlink(part)
        raise DownloadError(
            f"{name}: got {size / 1e6:.1f} MB, expected >= {min_mb} MB — "
            f"the server likely returned an error page, not weights"
        )
    return promote()


def download_all(out_dir: str, names=None) -> dict[str, str]:
    """Fetch every (or the selected) checkpoint; returns name -> path."""
    return {n: download_one(n, out_dir) for n in (names or CKPTS)}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default="ckpts")
    p.add_argument(
        "--only", nargs="*", default=None,
        help=f"subset of {sorted(CKPTS)} (default: all four)",
    )
    args = p.parse_args(argv)
    try:
        paths = download_all(args.out, args.only)
    except DownloadError as e:
        raise SystemExit(f"download failed: {e}")
    print(f"done: {sorted(paths)}")


if __name__ == "__main__":
    main()
