"""Import guard of the PyTorch port: no file of `straps_tpu_torch/` (the
detector front end in `perception/`, DensePose included, the image IO,
the synthetic body model's generator in `smpl/fixtures.py`, the orbax
checkpoint reader in `utils/` and the dataset loaders in `eval_harness/`
included), nor `chip_smoke.py`, imports JAX, flax, orbax,
tensorstore, zstandard, numcodecs, ml_dtypes, cv2, matplotlib, PIL or
the JAX package (the machine with the card has none of them), nor the orbax
export tool `tools/export_jax_checkpoint.py`, which runs where JAX is
installed and lies outside the package."""

import ast
import os
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "cv2", "matplotlib", "PIL",
             "straps_tpu", "tools", "export_jax_checkpoint", "tensorstore", "zstandard",
             "numcodecs", "ml_dtypes")
FILES = sorted((ROOT / "straps_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


PERCEPTION = ("__init__", "anchors", "convert_d2", "densepose", "densepose_structures", "fpn",
              "frontend", "heads",
              "ops", "pointrend", "rcnn", "rpn")


def test_port_files_exist():
    assert len(FILES) > 20 and all(f.exists() for f in FILES)
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for module in ([f"perception/{m}" for m in PERCEPTION]
                   + ["utils/image", "utils/png", "eval_harness/datasets",
                      "render/soft_silhouette", "utils/model_utils", "utils/profiling",
                      "parallel/__init__", "parallel/mesh", "parallel/dryrun",
                      "utils/jpeg", "utils/native_build", "data/native_io", "render/figures",
                      "render/tick_glyphs", "cli/run_parity_gate", "utils/zstd",
                      "utils/ocdbt", "utils/checkpoints", "smpl/fixtures", "smpl/assets",
                      "ops/__init__", "utils/bands"]):
        assert f"straps_tpu_torch/{module}.py" in names, module
    for source in ("jpeg_decode.cpp", "jpeg_aritab.h", "png_decode.cpp", "straps_io.cpp",
                   "zstd_decode.cpp"):
        assert (ROOT / "straps_tpu_torch" / "csrc" / source).exists(), source


def test_host_libraries_build_from_the_port_sources_only():
    """The host C++ is the port's own (`straps_tpu_torch/csrc/`: the JPEG
    decoder and its arithmetic table, the PNG unfilter, the npy reader, the
    zstd decoder), built into
    `straps_tpu_torch/_build/`: no port file names the JAX package's
    `native/` directory or its library, and each library's key hashes its
    own source."""
    from straps_tpu_torch.utils import native_build
    assert native_build.CSRC_DIR == str(ROOT / "straps_tpu_torch" / "csrc")
    assert native_build.BUILD_DIR == str(ROOT / "straps_tpu_torch" / "_build")
    for path in FILES:
        text = path.read_text()
        assert "libstraps_io" not in text and '"native"' not in text, path
    csrc = ROOT / "straps_tpu_torch" / "csrc"
    for name in ("png_decode", "straps_io", "zstd_decode"):
        source = csrc / f"{name}.cpp"
        assert native_build.local_includes(str(source)) == [str(source)], name
    assert native_build.local_includes(str(csrc / "jpeg_decode.cpp")) == [
        str(csrc / "jpeg_decode.cpp"), str(csrc / "jpeg_aritab.h")]
    from straps_tpu_torch.utils import zstd
    lib = zstd._lib()
    assert os.path.dirname(lib._name) == native_build.BUILD_DIR
    assert os.path.basename(lib._name).startswith("zstd_decode_")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _module_level_imports(node):
    """Modules imported outside every function body of `node`."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(child, ast.Import):
            yield from (alias.name for alias in child.names)
        elif isinstance(child, ast.ImportFrom) and child.level == 0:
            yield child.module
        yield from _module_level_imports(child)


LOWER_LAYERS = ("models", "smpl", "render", "geometry", "perception", "utils")


@pytest.mark.parametrize("layer", LOWER_LAYERS)
def test_lower_layers_do_not_import_training_at_module_level(layer):
    """The predict and eval paths load weights and render through these
    layers; importing them must not pull in the training state or Adam."""
    for path in sorted((ROOT / "straps_tpu_torch" / layer).rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        bad = [m for m in _module_level_imports(tree)
               if m.startswith(("straps_tpu_torch.train", "straps_tpu_torch.losses",
                                "straps_tpu_torch.augment"))]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module level"


def test_yaml_is_imported_only_inside_functions():
    """PyYAML is imported lazily (`config.load_config` with a YAML file):
    the card's machine has none, and `chip_smoke.py` passes overrides only."""
    lazy = []
    for path in FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        assert "yaml" not in [m.split(".")[0] for m in _module_level_imports(tree)], path
        lazy += [path.name for m in _imported_modules(path) if m == "yaml"]
    assert lazy == ["config.py"]


def test_orbax_export_tool_lies_outside_the_port():
    tool = ROOT / "tools" / "export_jax_checkpoint.py"
    assert tool.exists() and tool not in FILES
    imported = set(_imported_modules(tool))
    assert {"straps_tpu.utils.checkpoints", "straps_tpu_torch.utils.checkpoints"} <= imported
