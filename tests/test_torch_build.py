"""Where the port builds its libraries (ops/_build.build_dir): inside the
package when the package directory is writable, else a per-user cache;
never a ``build/`` beside the package, which in an installed wheel is
``site-packages/build/``."""
from pathlib import Path

import pytest

from sdr_receiver_dvb_t2_tpu_torch.io import native
from sdr_receiver_dvb_t2_tpu_torch.ops import _build

PKG = "sdr_receiver_dvb_t2_tpu_torch"


@pytest.fixture
def package(tmp_path, monkeypatch):
    """A package directory of the test's own, with its user cache and
    home under tmp_path too."""
    pkg = tmp_path / "site-packages" / PKG
    pkg.mkdir(parents=True)
    monkeypatch.setattr(_build, "PACKAGE_DIR", pkg)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    yield pkg
    pkg.chmod(0o755)


def test_build_dir_inside_a_writable_package(package):
    assert _build.build_dir("torch_native") == package / "_build" / \
        "torch_native"
    # an existing build directory is used as it is
    (package / "_build").mkdir()
    assert _build.build_dir("torch_kernels") == package / "_build" / \
        "torch_kernels"


@pytest.mark.parametrize("cache", ["xdg", "home"])
def test_build_dir_user_cache_for_a_read_only_package(package, tmp_path,
                                                      monkeypatch, cache):
    package.chmod(0o555)
    if cache == "home":
        monkeypatch.delenv("XDG_CACHE_HOME")
        want = tmp_path / "home" / ".cache" / PKG / "torch_kernels"
    else:
        want = tmp_path / "cache" / PKG / "torch_kernels"
    assert _build.build_dir("torch_kernels") == want
    # a read-only build directory inside a writable package likewise
    package.chmod(0o755)
    (package / "_build").mkdir(mode=0o555)
    assert _build.build_dir("torch_kernels") == want
    (package / "_build").chmod(0o755)


def test_libraries_build_inside_the_package():
    """The kernels and the native runtime of this checkout build into the
    package's own _build/, never into <repo>/build/."""
    pkg = Path(_build.__file__).resolve().parents[1]
    beside = pkg.parent / "build"
    for d in (_build.BUILD_DIR, native.BUILD_DIR):
        assert d.parent == pkg / "_build", d
        assert beside not in d.parents, d
    # and the CUDA sources are the package's
    assert _build.CSRC == pkg / "ops" / "csrc"
    assert (_build.CSRC / "ldpc_layered.cu").is_file()
