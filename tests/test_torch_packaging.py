"""The port as `pyproject.toml` packages it.

`utils/package_copy.py` selects the files a `pip install .` installs
(setuptools' package finder and `package-data`) and copies them: the copy
holds every source of `straps_tpu_torch/csrc/` that the port builds at
first use, and nothing of `_build/`.  A fresh process whose only copy of
the port is that one builds the PNG unfilter with g++ from the copy's own
`csrc/` into the copy's `_build/`, and decodes a committed fixture as the
repository tree does.  The `*-torch` console scripts name the port's CLIs.
Where setuptools imports, a wheel that it builds from the tree holds the
same files.
"""

import glob
import os
import pathlib
import shutil
import subprocess
import sys
import tomllib
import zipfile

import numpy as np
import pytest

from straps_tpu_torch.utils.package_copy import copy_package, package_files
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = sorted(p.name for p in (ROOT / "straps_tpu_torch" / "csrc").iterdir())
FIXTURE = ROOT / "tests" / "torch_png" / "palette2_adam7.png"


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_the_copy_holds_every_kernel_source(tmp_path):
    assert CSRC == ["jpeg_aritab.h", "jpeg_decode.cpp", "png_decode.cpp", "raster_faceid.cu",
                    "raster_packed.cu", "raster_span.cuh", "straps_io.cpp", "zstd_decode.cpp"]
    files = copy_package(str(ROOT), str(tmp_path))
    assert [f for f in files if f.startswith("straps_tpu_torch/csrc/")] == \
        [f"straps_tpu_torch/csrc/{name}" for name in CSRC]
    for name in CSRC:
        assert (tmp_path / "straps_tpu_torch" / "csrc" / name).read_bytes() == \
            (ROOT / "straps_tpu_torch" / "csrc" / name).read_bytes()
    port = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "straps_tpu_torch").rglob("*.py")
                  if "__pycache__" not in p.parts)
    assert [f for f in files if f.startswith("straps_tpu_torch/") and f.endswith(".py")] == port
    assert not any({"_build", "__pycache__"} & set(f.split("/")) for f in files)
    assert files == package_files(str(ROOT))


def test_console_scripts_name_the_port_clis(monkeypatch):
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert {k: v for k, v in scripts.items() if not k.endswith("-torch")} == {
        "straps-train": "straps_tpu.cli.run_train:main",
        "straps-predict": "straps_tpu.cli.run_predict:main",
        "straps-eval": "straps_tpu.cli.run_eval:main"}
    import importlib
    for cli in ("train", "predict", "eval"):
        module, _, attr = scripts[f"straps-{cli}-torch"].partition(":")
        assert module == f"straps_tpu_torch.cli.run_{cli}"
        mod = importlib.import_module(module)
        calls = []
        monkeypatch.setattr(mod, "main", lambda argv=None: calls.append(argv) or {"pves": 1.0})
        assert getattr(mod, attr)() == 0 and calls == [None]


def test_a_process_on_the_copy_builds_from_its_own_sources(tmp_path):
    from straps_tpu_torch.utils.png import decode_png
    site = tmp_path / "site"
    copy_package(str(ROOT), str(site))
    out = tmp_path / "decoded.npy"
    code = f"""
import os, sys
sys.path.insert(0, {str(site)!r})
import numpy as np
import straps_tpu_torch
from straps_tpu_torch.utils import native_build
from straps_tpu_torch.utils.png import decode_png
assert os.path.dirname(straps_tpu_torch.__file__) == {str(site / "straps_tpu_torch")!r}
np.save({str(out)!r}, decode_png({str(FIXTURE)!r}))
print(native_build._HOST_LIBS["png_decode"]._name)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_env(),
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = proc.stdout.strip()
    assert os.path.dirname(lib) == str(site / "straps_tpu_torch" / "_build")
    assert os.path.basename(lib).startswith("png_decode_") and os.path.exists(lib)
    np.testing.assert_array_equal(np.load(out), decode_png(str(FIXTURE)))


def test_a_wheel_holds_the_same_files(tmp_path):
    """setuptools' own selection: a wheel built (no index, no isolation)
    from a copy of the tree, `_build/` and `__pycache__/` included."""
    pytest.importorskip("setuptools")
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, src / name)
    for package in ("straps_tpu", "straps_tpu_torch"):
        shutil.copytree(ROOT / package, src / package)
    (src / "straps_tpu_torch" / "_build").mkdir(exist_ok=True)
    (src / "straps_tpu_torch" / "_build" / "stale.so").write_bytes(b"")
    proc = subprocess.run([sys.executable, "-m", "pip", "wheel", ".", "--no-deps",
                           "--no-build-isolation", "--no-index", "--no-cache-dir", "-q",
                           "-w", str(tmp_path / "out")],
                          cwd=src, env=_env(), capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (wheel,) = glob.glob(str(tmp_path / "out" / "*.whl"))
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
        (entry_points,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
        scripts = z.read(entry_points).decode()
    listed = sorted(n for n in names if ".dist-info/" not in n)
    assert listed == package_files(str(src)) == package_files(str(ROOT))
    assert [n for n in listed if "/csrc/" in n] == [f"straps_tpu_torch/csrc/{c}" for c in CSRC]
    for cli in ("train", "predict", "eval"):
        assert f"straps-{cli}-torch = straps_tpu_torch.cli.run_{cli}:script" in scripts
