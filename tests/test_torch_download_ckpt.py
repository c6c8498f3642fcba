"""one2345_tpu_torch.utils.download_ckpt against the JAX package's downloader,
offline: every case of tests/test_download_ckpt.py, and the resume paths,
runs on both modules under the same monkeypatched ``urlopen``; both must
give the same outcome (the same exception type and message, the same files
left behind, byte for byte).  No case touches the network."""

import hashlib
import io
import os
import urllib.error

import pytest

from one2345_tpu.utils import download_ckpt as jax_dl
from one2345_tpu_torch.utils import download_ckpt as torch_dl

MODULES = pytest.mark.parametrize("dl", [jax_dl, torch_dl], ids=["jax", "torch"])
NAME = "ckpt_215000.pth"  # the smallest plausibility floor: 1 MB
MB = 1 << 20


class FakeResponse(io.BytesIO):
    def __init__(self, body: bytes, status: int = 200):
        super().__init__(body)
        self.status = status

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def serve(dl, monkeypatch, body: bytes, status: int = 200) -> list:
    """Answer every request with ``body``; returns the list of requests."""
    requests = []

    def urlopen(req, timeout=None):
        requests.append(req)
        return FakeResponse(body, status)

    monkeypatch.setattr(dl.urllib.request, "urlopen", urlopen)
    return requests


def deny(dl, monkeypatch):
    def urlopen(req, timeout=None):
        raise urllib.error.URLError(OSError("network unreachable"))

    monkeypatch.setattr(dl.urllib.request, "urlopen", urlopen)


def forbid(dl, monkeypatch):
    def urlopen(*a, **k):
        raise AssertionError("must not hit the network")

    monkeypatch.setattr(dl.urllib.request, "urlopen", urlopen)


def files(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


# ---------------------------------------- the cases of tests/test_download_ckpt.py
def test_ckpt_tables_are_equal():
    assert torch_dl.CKPTS == jax_dl.CKPTS
    assert issubclass(torch_dl.DownloadError, RuntimeError)


@MODULES
def test_url_table_matches_reference(dl):
    assert set(dl.CKPTS) == {"zero123-xl.ckpt", "sam_vit_h_4b8939.pth", "indoor_ds_new.ckpt",
                             "ckpt_215000.pth"}
    for url, min_mb in dl.CKPTS.values():
        assert url.startswith("https://huggingface.co/One-2-3-45/code/resolve/main")
        assert min_mb >= 1


@MODULES
def test_no_egress_fails_fast_with_guidance(dl, tmp_path, monkeypatch):
    deny(dl, monkeypatch)
    with pytest.raises(dl.DownloadError) as e:
        dl.download_one("indoor_ds_new.ckpt", str(tmp_path))
    msg = str(e.value)
    assert "indoor_ds_new.ckpt" in msg and "place it at" in msg
    assert files(tmp_path) == {}


@MODULES
def test_small_response_rejected(dl, tmp_path, monkeypatch):
    serve(dl, monkeypatch, b"<html>rate limited</html>")
    with pytest.raises(dl.DownloadError, match="error page"):
        dl.download_one(NAME, str(tmp_path))
    # the partial file is dropped, never promoted to the final name
    assert files(tmp_path) == {}


@MODULES
def test_existing_file_short_circuits(dl, tmp_path, monkeypatch):
    dest = tmp_path / NAME
    dest.write_bytes(b"\0" * (2 * MB))  # above the 1 MB plausibility floor
    forbid(dl, monkeypatch)
    assert dl.download_one(NAME, str(tmp_path)) == str(dest)
    assert list(files(tmp_path)) == [NAME]


@MODULES
def test_unknown_name_rejected(dl, tmp_path):
    with pytest.raises(KeyError):
        dl.download_one("nope.ckpt", str(tmp_path))


# --------------------------------------------------------------- the resume paths
def _sidecar(body: bytes) -> bytes:
    return f"{hashlib.sha256(body).hexdigest()}  {NAME}\n".encode()


@MODULES
def test_resume_appends_on_206(dl, tmp_path, monkeypatch):
    """A partial file is resumed with a Range request; the server's 206
    body is appended, the whole promoted with its sha256 sidecar."""
    head, tail = b"a" * (MB // 2), b"b" * (MB // 2 + 10)
    (tmp_path / (NAME + ".part")).write_bytes(head)
    requests = serve(dl, monkeypatch, tail, status=206)
    assert dl.download_one(NAME, str(tmp_path)) == str(tmp_path / NAME)
    assert [r.get_header("Range") for r in requests] == [f"bytes={len(head)}-"]
    assert files(tmp_path) == {NAME: head + tail, NAME + ".sha256": _sidecar(head + tail)}


@MODULES
def test_resume_restarts_on_200(dl, tmp_path, monkeypatch):
    """A server that ignores the Range header (200) sends the whole file:
    it replaces the partial one."""
    (tmp_path / (NAME + ".part")).write_bytes(b"a" * 1000)
    body = b"c" * (MB + 1)
    requests = serve(dl, monkeypatch, body, status=200)
    dl.download_one(NAME, str(tmp_path))
    assert [r.get_header("Range") for r in requests] == ["bytes=1000-"]
    assert files(tmp_path) == {NAME: body, NAME + ".sha256": _sidecar(body)}


@MODULES
def test_full_part_is_promoted_without_a_request(dl, tmp_path, monkeypatch):
    """A .part of the full size (an earlier run died before the rename)
    is promoted: a Range request from its end would get HTTP 416."""
    body = b"d" * (MB + 7)
    (tmp_path / (NAME + ".part")).write_bytes(body)
    forbid(dl, monkeypatch)
    assert dl.download_one(NAME, str(tmp_path)) == str(tmp_path / NAME)
    assert files(tmp_path) == {NAME: body, NAME + ".sha256": _sidecar(body)}


@MODULES
def test_download_all_and_main_select_files(dl, tmp_path, monkeypatch, capsys):
    body = b"e" * (MB + 3)
    serve(dl, monkeypatch, body)
    assert dl.download_all(str(tmp_path), [NAME]) == {NAME: str(tmp_path / NAME)}
    deny(dl, monkeypatch)
    dl.main(["--out", str(tmp_path), "--only", NAME])  # present: no request
    assert f"done: ['{NAME}']" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="download failed"):
        dl.main(["--out", str(tmp_path), "--only", "indoor_ds_new.ckpt"])


# ------------------------------------------------------ one outcome on both modules
def _outcome(dl, root, monkeypatch, case: str):
    """Run one case on ``dl`` in ``root``: (exception type name or None,
    its message with the directory masked, the files left behind)."""
    os.makedirs(root)
    if case == "no_egress":
        deny(dl, monkeypatch)
    elif case == "error_page":
        serve(dl, monkeypatch, b"<html>rate limited</html>")
    elif case == "resume_206":
        with open(os.path.join(root, NAME + ".part"), "wb") as f:
            f.write(b"a" * 1000)
        serve(dl, monkeypatch, b"b" * MB, status=206)
    elif case == "full_part":
        with open(os.path.join(root, NAME + ".part"), "wb") as f:
            f.write(b"d" * MB)
        forbid(dl, monkeypatch)
    try:
        dl.download_one(NAME, root)
        error = None
    except dl.DownloadError as e:
        error = (type(e).__name__, str(e).replace(root, "<dir>"))
    return error, files(root)


@pytest.mark.parametrize("case", ["no_egress", "error_page", "resume_206", "full_part"])
def test_both_modules_leave_the_same_outcome(case, tmp_path, monkeypatch):
    got = _outcome(torch_dl, str(tmp_path / "torch"), monkeypatch, case)
    want = _outcome(jax_dl, str(tmp_path / "jax"), monkeypatch, case)
    assert got == want
    assert (got[0] is None) == (case in ("resume_206", "full_part"))
