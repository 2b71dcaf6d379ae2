"""The files that `pip install .` of the repository installs, selected and
copied without pip or setuptools.

`pyproject.toml`'s `[tool.setuptools.packages.find]` names the packages
as setuptools' namespace finder does: every directory below `where` whose
dotted name matches an `include` pattern and no `exclude` pattern
(`__pycache__` never).  Each package ships its `*.py` files and the files
that its `[tool.setuptools.package-data]` patterns select.  So the copy
holds the kernel sources of `csrc/` that the port builds at first use,
and none of `_build/`.

`chip_smoke.py` runs the port from such a copy, and
`tests/test_torch_packaging.py` holds the selection to a wheel built by
setuptools.
"""

import fnmatch
import glob
import os
import shutil
import tomllib
from typing import List

_ALWAYS_EXCLUDE = ("ez_setup", "*__pycache__")


def _packages(base: str, include, exclude, namespaces: bool) -> List[str]:
    """Dotted names of the packages below `base`, as setuptools finds them."""
    def matches(name, patterns):
        return any(fnmatch.fnmatchcase(name, p) for p in patterns)

    found, todo = [], [""]
    while todo:
        rel = todo.pop()
        for entry in sorted(os.scandir(os.path.join(base, rel)), key=lambda e: e.name):
            if not entry.is_dir() or "." in entry.name:
                continue
            path = os.path.join(rel, entry.name)
            if not namespaces and not os.path.isfile(os.path.join(entry.path, "__init__.py")):
                continue
            name = path.replace(os.sep, ".")
            if matches(name, include) and not matches(name, exclude):
                found.append(name)
            if f"{name}*" not in exclude and f"{name}.*" not in exclude:
                todo.append(path)
    return sorted(found)


def _project(root: str):
    """(the directory the packages are found in, the `packages.find`
    table, the `package-data` table) of `root/pyproject.toml`."""
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        tool = tomllib.load(f).get("tool", {}).get("setuptools", {})
    find = tool.get("packages", {}).get("find")
    if find is None:
        raise ValueError(f"{root}/pyproject.toml: no [tool.setuptools.packages.find]")
    (where,) = find.get("where", ["."])
    return os.path.join(root, where), find, tool.get("package-data", {})


def package_files(root: str) -> List[str]:
    """Paths, relative to the install root, of every file that the
    project at `root` installs; sorted."""
    base, find, data = _project(root)
    exclude = tuple(find.get("exclude", ())) + _ALWAYS_EXCLUDE
    files = set()
    for name in _packages(base, tuple(find.get("include", ("*",))), exclude,
                          find.get("namespaces", True)):
        pkg = name.replace(".", os.sep)
        patterns = ["*.py"] + data.get(name, []) + data.get("*", []) + data.get("", [])
        for pattern in patterns:
            for path in glob.glob(pattern, root_dir=os.path.join(base, pkg), recursive=True):
                if os.path.isfile(os.path.join(base, pkg, path)):
                    files.add(os.path.normpath(os.path.join(pkg, path)))
    return sorted(files)


def copy_package(root: str, dest: str) -> List[str]:
    """Copy the files of `package_files(root)` into `dest` (the install
    root: `dest/straps_tpu_torch/...`); returns their relative paths."""
    base = _project(root)[0]
    files = package_files(root)
    for rel in files:
        os.makedirs(os.path.join(dest, os.path.dirname(rel)), exist_ok=True)
        shutil.copy2(os.path.join(base, rel), os.path.join(dest, rel))
    return files
