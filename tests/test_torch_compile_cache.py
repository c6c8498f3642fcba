"""one2345_tpu_torch.core.compile_cache: where the port's compiled kernels
persist (the nvcc builds of ops/_build.py and the g++ builds of
native/build.py), and that the entry points choose it at start-up, before
any build, as the JAX entry points enable XLA's cache."""

import importlib
import os

import pytest

from one2345_tpu_torch.core import compile_cache
from one2345_tpu_torch.native import build as native_build
from one2345_tpu_torch.ops import _build

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(compile_cache.__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No enable() of another test leaks in or out; no variable set."""
    monkeypatch.setattr(compile_cache, "_dir", None)
    monkeypatch.delenv(compile_cache.ENV, raising=False)


def test_default_is_the_checkout_s_build_directory():
    default = os.path.join(PACKAGE, "_build")
    assert str(compile_cache.DEFAULT_DIR) == default
    assert str(_build.library_path("flash_attention_fwd").parent) == default
    assert str(native_build.library_path(native_build.PNG_SOURCE).parent) == default
    assert compile_cache.enable() == default  # no argument, no variable
    assert str(_build.library_path("flash_attention_bwd").parent) == default


def test_enable_moves_every_library(tmp_path):
    before = _build.library_path("flash_attention_fwd")
    target = tmp_path / "cache" / "nested"
    assert compile_cache.enable(str(target)) == str(target)
    assert target.is_dir()
    for lib in (_build.library_path("flash_attention_fwd"),
                native_build.library_path(native_build.SOURCE)):
        assert lib.parent == target
    # the name (the sources' hash) is unchanged: only the directory moves
    assert _build.library_path("flash_attention_fwd").name == before.name


def test_environment_variable_moves_them(tmp_path, monkeypatch):
    """The variable holds in every process that has it set, whether or not
    it calls enable()."""
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "env_cache"))
    assert compile_cache.build_dir() == tmp_path / "env_cache"
    assert _build.library_path("flash_attention_bwd").parent == tmp_path / "env_cache"
    assert compile_cache.enable() == str(tmp_path / "env_cache")
    assert (tmp_path / "env_cache").is_dir()
    # an explicit directory wins over the variable
    assert compile_cache.enable(str(tmp_path / "explicit")) == str(tmp_path / "explicit")
    assert compile_cache.build_dir() == tmp_path / "explicit"


def test_a_build_lands_in_the_enabled_directory(tmp_path, monkeypatch):
    """g++ builds the PNG unfilter into the enabled directory (the nvcc
    builds go through the same ``library_path``; there is no nvcc here)."""
    monkeypatch.setattr(native_build, "_libs", {})
    compile_cache.enable(str(tmp_path))
    lib = native_build.build(native_build.PNG_SOURCE)
    assert lib.parent == tmp_path and lib.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == [lib.name]


def test_the_server_path_builds_in_the_variable_s_directory(tmp_path, monkeypatch):
    """The server never calls enable(); the PNG decoder of its requests
    still builds into ``$ONE2345_COMPILE_CACHE``."""
    import base64

    import numpy as np

    from one2345_tpu_torch.pipeline import server
    from one2345_tpu_torch.utils.png import encode_png

    monkeypatch.setattr(native_build, "_libs", {})
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "env_cache"))
    image = np.arange(8 * 8 * 4, dtype=np.uint8).reshape(8, 8, 4)
    decoded = server._decode_image(base64.b64encode(encode_png(image)).decode())
    np.testing.assert_array_equal(decoded, image)
    assert [p.name for p in (tmp_path / "env_cache").iterdir()] == [
        native_build.library_path(native_build.PNG_SOURCE).name]


class Stop(Exception):
    pass


def test_cli_enables_the_cache_before_any_build(monkeypatch, capsys, tmp_path):
    from one2345_tpu_torch.pipeline import cli, runner

    events = []
    enable = compile_cache.enable

    def recorded(cache_dir=None):
        events.append("enable")
        return enable(str(tmp_path))

    monkeypatch.setattr(compile_cache, "enable", recorded)
    monkeypatch.setattr(_build, "build_all", lambda *a, **k: events.append("nvcc"))
    monkeypatch.setattr(native_build, "build", lambda *a, **k: events.append("g++"))

    def pipeline(cfg, params, use_sam, device):
        events.append("pipeline")
        raise Stop

    monkeypatch.setattr(runner, "One2345Pipeline", pipeline)
    with pytest.raises(Stop):
        cli.main(["--img_path", "unused.png"], device="cpu")
    assert events == ["enable", "pipeline"]
    assert capsys.readouterr().out.splitlines()[0] == f"compile cache: {tmp_path}"


@pytest.mark.parametrize("entry", ["train_recon", "train_zero123", "torch_demo"])
def test_other_entry_points_enable_it_first(entry, monkeypatch, tmp_path):
    """The trainers and the demo twin call enable() at start-up, where the
    JAX entry points do (before their device is even resolved)."""
    def stop(d=None):
        raise Stop

    monkeypatch.setattr(compile_cache, "enable", stop)
    if entry == "torch_demo":
        from examples import torch_demo

        monkeypatch.setattr(torch_demo, "enable_cache", stop)
        argv, main = ["--img_path", "unused.png"], torch_demo.main
    else:
        main = importlib.import_module(f"one2345_tpu_torch.training.{entry}").main
        argv = ["--data_root", str(tmp_path), "--exp_dir", str(tmp_path / "exp")]
    with pytest.raises(Stop):
        main(argv)
    assert not (tmp_path / "exp").exists()
