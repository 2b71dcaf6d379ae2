"""The port's DensePose annotation structures (`straps_tpu_torch/
perception/densepose_structures.py`) against the JAX package's module on
the same seeded inputs: the COCO RLE codec (compressed and uncompressed),
the flip symmetry tables (a `scipy.io.savemat` file in the dataset's
layout, and the synthetic stand-in), and `DensePoseDataRelative` (fields,
segmentation, validation, `apply_hflip`), all exact."""

import numpy as np
import pytest

from straps_tpu.perception import densepose_structures as JS
from straps_tpu_torch.perception import densepose_structures as TS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _leb128(counts):
    """pycocotools' compressed string of RLE counts: each value (from the
    third on, less the one two before) in 5-bit groups, 0x20 continuation,
    0x10 sign, offset by 48."""
    out = bytearray()
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        more = True
        while more:
            b = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not b & 0x10) or (x == -1 and b & 0x10))
            out.append(48 + (b | 0x20 if more else b))
    return bytes(out)


def _masks(seed, n=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        h, w = rng.randint(1, 40, 2)
        m = (rng.rand(h, w) > rng.uniform(0.2, 0.8)).astype(np.uint8)
        if rng.rand() < 0.3:
            m[:] = m[0, 0]
        out.append(m)
    return out


def test_constants_are_the_jax_modules():
    for name in ("MASK_LABEL_SYMMETRIES", "POINT_LABEL_SYMMETRIES", "N_BODY_PARTS",
                 "N_PART_LABELS", "MASK_SIZE"):
        assert getattr(TS, name) == getattr(JS, name), name


def test_rle_uncompressed_encode_and_decode_match_jax():
    for m in _masks(0):
        rle = TS.rle_encode(m)
        assert rle == JS.rle_encode(m)
        np.testing.assert_array_equal(TS.rle_decode(rle), m)
        np.testing.assert_array_equal(TS.rle_decode(rle), JS.rle_decode(rle))


@pytest.mark.parametrize("as_str", [False, True])
def test_rle_compressed_decode_matches_jax(as_str):
    """Strings pycocotools writes (multi-byte runs, negative deltas), and
    the JAX suite's hand-made vectors."""
    specs = [({"size": [2, 2], "counts": b"121"}), ({"size": [2, 7], "counts": b"2342"}),
             ({"size": [43, 1], "counts": b"X112O"})]
    for m in _masks(1) + [np.pad(np.ones((30, 30), np.uint8), 40)]:
        specs.append({"size": list(m.shape), "counts": _leb128(TS.rle_encode(m)["counts"])})
        np.testing.assert_array_equal(TS.rle_decode(specs[-1]), m)
    for spec in specs:
        if as_str:
            spec = dict(spec, counts=spec["counts"].decode("ascii"))
        np.testing.assert_array_equal(TS.rle_decode(spec), JS.rle_decode(spec))


def test_transform_data_load_of_a_savemat_file(tmp_path):
    scipy_io = pytest.importorskip("scipy.io")
    rng = np.random.RandomState(0)
    cells = {}
    for key in ("U_transforms", "V_transforms"):
        cell = np.empty((1, TS.N_PART_LABELS), dtype=object)
        for i in range(TS.N_PART_LABELS):
            cell[0, i] = rng.rand(256, 256)
        cells[key] = cell
    path = str(tmp_path / "UV_symmetry_transforms.mat")
    scipy_io.savemat(path, cells)
    got, want = TS.DensePoseTransformData.load(path), JS.DensePoseTransformData.load(path)
    for key in ("U_transforms", "V_transforms"):
        assert len(got.uv_symmetries[key]) == TS.N_PART_LABELS
        for a, b, c in zip(got.uv_symmetries[key], want.uv_symmetries[key], cells[key][0]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c.astype(np.float32))
    assert got.mask_label_symmetries == want.mask_label_symmetries
    assert got.point_label_symmetries == want.point_label_symmetries
    np.testing.assert_array_equal(TS.load_transform_data(path).uv_symmetries["V_transforms"][3],
                                  want.uv_symmetries["V_transforms"][3])
    fallback = TS.load_transform_data(str(tmp_path / "absent.mat"))
    for key in ("U_transforms", "V_transforms"):
        np.testing.assert_array_equal(
            np.stack(fallback.uv_symmetries[key]),
            np.stack(JS.DensePoseTransformData.synthetic().uv_symmetries[key]))


def _annotation(rng, use_rle):
    n = 64
    masks = []
    for i in range(TS.N_BODY_PARTS):
        m = np.zeros((TS.MASK_SIZE, TS.MASK_SIZE), np.uint8)
        if i % 3 != 2:
            r, c = rng.randint(0, 200, 2)
            m[r:r + rng.randint(10, 60), c:c + rng.randint(10, 60)] = 1
        masks.append(TS.rle_encode(m) if use_rle and i % 2 else m)
    if use_rle:
        masks[4] = []                       # an absent part
    return {"dp_x": rng.uniform(0, 256, n).astype(np.float32),
            "dp_y": rng.uniform(0, 256, n).astype(np.float32),
            "dp_I": rng.randint(1, 25, n).astype(np.int32),
            "dp_U": rng.uniform(0, 1, n).astype(np.float32),
            "dp_V": rng.uniform(0, 1, n).astype(np.float32),
            "dp_masks": masks}


FIELDS = ("x", "y", "i", "u", "v", "segm")


@pytest.mark.parametrize("use_rle", [False, True])
@pytest.mark.parametrize("tables", ["synthetic", "random"])
def test_data_relative_fields_and_hflip_match_jax(use_rle, tables):
    rng = np.random.RandomState(2)
    ann = _annotation(rng, use_rle)
    ann["dp_I"][:5] = 0                      # points without a part keep their U/V
    if tables == "synthetic":
        td_t, td_j = TS.DensePoseTransformData.synthetic(), JS.DensePoseTransformData.synthetic()
    else:
        uv = {k: [rng.rand(256, 256).astype(np.float32) for _ in range(TS.N_PART_LABELS)]
              for k in ("U_transforms", "V_transforms")}
        td_t, td_j = TS.DensePoseTransformData(uv), JS.DensePoseTransformData(uv)
    got = TS.DensePoseDataRelative(dict(ann))
    want = JS.DensePoseDataRelative(dict(ann))
    for step in ("read", "flipped", "flipped twice"):
        for f in FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, (step, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{step} {f}")
        got.apply_hflip(td_t)
        want.apply_hflip(td_j)
    assert set(np.unique(got.segm)) <= set(range(15))


def test_cleanup_and_validation_match_jax():
    ann = _annotation(np.random.RandomState(3), True)
    kept = dict(ann)
    TS.DensePoseDataRelative(kept, cleanup=True)
    assert set(kept) == set(ann) - {"dp_x", "dp_y", "dp_I", "dp_U", "dp_V", "dp_masks"}
    for drop in ("dp_x", "dp_V", "dp_masks"):
        bad = {k: v for k, v in ann.items() if k != drop}
        assert TS.DensePoseDataRelative.validate_annotation(bad) == \
            JS.DensePoseDataRelative.validate_annotation(bad)
        with pytest.raises(AssertionError, match=f"no {drop} data"):
            TS.DensePoseDataRelative(bad)
        with pytest.raises(AssertionError, match=f"no {drop} data"):
            JS.DensePoseDataRelative(bad)
