"""The port's JPEG decoder on the codings that cv2 reads and cv2 and
Pillow do not write, against `cv2.imread`, bit for bit: arithmetic-coded
sequential and progressive files (SOF9, SOF10) with restarts and DAC
conditioning, lossless files (SOF3) at every predictor, point transform
and precision cv2 reads, progressive files cut before their low
frequencies are complete (libjpeg-turbo's block smoothing), and the codings
cv2 reads no image from, which raise naming the file and the marker.

The files are written by libjpeg-turbo's own compressor, driven through
`tests/torch_jpeg/write_codings.c` (`write_codings.py` builds it against
the libjpeg-turbo that Pillow bundles); the committed ones and their cv2
hashes are in `tests/torch_jpeg/` (`CODINGS`, `expected.json`).  The
arithmetic decoder's table is held to what `tools/derive_jpeg_aritab.py`
derives from the installed libjpeg binaries.
"""

import hashlib
import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest

from straps_tpu_torch.utils.jpeg import decode_jpeg, decode_jpeg_bytes
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "torch_jpeg")
sys.path.insert(0, FIXTURE_DIR)
import write_codings as W  # noqa: E402


def _cv2_rgb(data: bytes, tmp_path):
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    img = cv2.imread(path)
    return None if img is None else img[:, :, ::-1]


def _assert_decodes_as_cv2(data: bytes, tmp_path, msg=""):
    want = _cv2_rgb(data, tmp_path)
    assert want is not None, f"cv2 reads no image: {msg}"
    got = decode_jpeg_bytes(data, msg)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("name", sorted(W.CODINGS))
def test_coding_fixtures_decode_as_cv2_and_expected_json(name):
    with open(os.path.join(FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)[name]
    path = os.path.join(FIXTURE_DIR, name)
    assert W.cv2_digest(path) == expected
    if expected is None:
        with pytest.raises(ValueError, match=f"{name}: "):
            decode_jpeg(path)
        return
    px = decode_jpeg(path)
    assert list(px.shape) == expected["shape"]
    assert hashlib.sha256(px.tobytes()).hexdigest() == expected["sha256"]


def test_coding_fixtures_are_what_write_codings_writes(tmp_path):
    with open(os.path.join(FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)
    assert W.write_fixtures(str(tmp_path)) == {n: expected[n] for n in W.CODINGS}
    for name in W.CODINGS:
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read(), name
    assert sum(os.path.getsize(os.path.join(FIXTURE_DIR, n)) for n in W.CODINGS) < 100_000


def test_arithmetic_table_is_what_the_tool_derives(capsys):
    spec = importlib.util.spec_from_file_location(
        "derive_jpeg_aritab", os.path.join(ROOT, "tools", "derive_jpeg_aritab.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(tool.OUT) as f:
        assert f.read() == tool.header_text(tool.read_table())


SIZES = ((1, 1), (7, 9), (16, 16), (17, 33), (45, 61))


@pytest.mark.parametrize("progressive", (0, 1))
@pytest.mark.parametrize("sampling", (11, 22, 21, 12))
def test_arithmetic_codings_are_bit_exact(sampling, progressive, tmp_path):
    """SOF9 and SOF10 at every size, quality and sampling, with and without
    restart intervals and non-default DAC conditioning."""
    rng = np.random.default_rng(10 * sampling + progressive)
    for k, (h, w) in enumerate(SIZES):
        img = W.scene(h, w, k + sampling)
        for restart, dac in ((0, None), (int(rng.integers(1, 5)),
                                         (int(rng.integers(0, 4)), int(rng.integers(4, 12)),
                                          int(rng.integers(1, 64))))):
            opts = dict(arith=1, progressive=progressive, sampling=sampling, restart=restart,
                        quality=int(rng.integers(10, 100)))
            if dac:
                opts["dac"] = dac
            _assert_decodes_as_cv2(W.write_jpeg(img, **opts), tmp_path, f"{h}x{w} {opts}")


@pytest.mark.parametrize("progressive", (0, 1))
def test_arithmetic_greyscale_is_replicated(progressive, tmp_path):
    for k, (h, w) in enumerate(SIZES):
        data = W.write_jpeg(W.grey(W.scene(h, w, k)), arith=1, progressive=progressive,
                            restart=k % 2)
        _assert_decodes_as_cv2(data, tmp_path, f"{h}x{w}")


@pytest.mark.parametrize("precision", (6, 8))
@pytest.mark.parametrize("pt", (0, 2))
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_codings_are_bit_exact(psv, pt, precision, tmp_path):
    """SOF3 at every predictor, point transforms 0 and 2, 6- and 8-bit
    samples (stored values, not rescaled), RGB and CMYK, with restart
    intervals of one and two rows."""
    rng = np.random.default_rng(100 * psv + 10 * pt + precision)
    for k, (h, w) in enumerate(SIZES[1:]):
        img = W.scene(h, w, k + psv) >> (8 - precision)
        opts = dict(lossless=(psv, pt), precision=precision,
                    restart=int(rng.choice([0, w, 2 * w])))
        if k == 3:
            img = np.concatenate([img, img[..., 1:2]], -1)
            opts["cmyk"] = 1
        data = W.write_jpeg(img, **opts)
        _assert_decodes_as_cv2(data, tmp_path, f"{h}x{w} {opts}")
        if pt == 0 and precision == 8 and k < 3:
            np.testing.assert_array_equal(decode_jpeg_bytes(data), img)   # lossless indeed


@pytest.mark.parametrize("sampling", (11, 22, 21))
@pytest.mark.parametrize("arith", (0, 1))
def test_cut_progressive_files_decode_as_cv2(arith, sampling, tmp_path):
    """Progressive files cut anywhere: in a marker segment (cv2 reads no
    image, the port raises), or in a scan, where the decoder runs out of
    data as libjpeg does and libjpeg-turbo smooths the blocks whose
    coefficients 1-9 are incomplete."""
    rng = np.random.default_rng(10 * arith + sampling)
    decoded = 0
    for k, (h, w) in enumerate(((64, 48), (45, 61), (17, 9), (130, 200))):
        data = W.write_jpeg(W.scene(h, w, k), arith=arith, progressive=1, sampling=sampling,
                            quality=int(rng.integers(30, 98)))
        for frac in rng.uniform(0.05, 0.99, 6):
            cut = data[:int(len(data) * frac)]
            want = _cv2_rgb(cut, tmp_path)
            if want is None:
                with pytest.raises(ValueError):
                    decode_jpeg_bytes(cut)
                continue
            np.testing.assert_array_equal(decode_jpeg_bytes(cut), want, err_msg=f"{h}x{w} {frac}")
            decoded += 1
    assert decoded >= 8


@pytest.mark.parametrize("restart", (0, 2))
def test_cut_arithmetic_sequential_files_decode_as_cv2(restart, tmp_path):
    """libjpeg feeds zero bytes to the arithmetic decoder past the end of
    the data; the coefficients it then decodes can leave 16 bits, where
    libjpeg-turbo's SIMD inverse DCT wraps and saturates."""
    rng = np.random.default_rng(restart)
    for k, (h, w) in enumerate(((52, 88), (81, 55), (39, 110))):
        data = W.write_jpeg(W.scene(h, w, k), arith=1, quality=int(rng.integers(50, 98)),
                            sampling=11 + 11 * (k % 2), restart=restart)
        for frac in rng.uniform(0.05, 0.99, 5):
            cut = data[:int(len(data) * frac)]
            want = _cv2_rgb(cut, tmp_path)
            if want is not None:
                np.testing.assert_array_equal(decode_jpeg_bytes(cut), want, err_msg=str(frac))


def _sof_patched(data: bytes, sof: int) -> bytes:
    """`data` with its frame header's marker replaced."""
    out = bytearray(data)
    for m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
        at = out.find(bytes([0xFF, m]))
        if at >= 0:
            out[at + 1] = sof
            return bytes(out)
    raise ValueError("no frame header")


@pytest.mark.parametrize("case,pattern", [
    ("sof1_12bit", "SOF1 precision 12"),
    ("sof2_12bit", "SOF2 precision 12"),
    ("sof9_12bit", "SOF9 precision 12"),
    ("sof10_12bit", "SOF10 precision 12"),
    ("sof3_12bit", "SOF3 precision 12"),
    ("sof3_10bit", "SOF3 precision 10"),
    ("sof3_grey", "lossless JPEG of one \\(greyscale\\) component"),
    ("sof11", "SOF11 \\(arithmetic-coded lossless\\)"),
    ("sof7", "SOF7 \\(differential lossless\\)"),
])
def test_codings_cv2_refuses_are_refused_by_name(case, pattern, tmp_path):
    """Each coding cv2.imread reads no image from raises a ValueError
    naming the file and the marker.  The writer writes the 12-bit and
    10-bit frames and the greyscale lossless one; SOF11 and SOF7 are a
    lossless file's marker changed, as no libjpeg writes them."""
    img = W.scene(24, 32, 5)
    wide = img.astype(np.uint16) << 4
    data = {
        "sof1_12bit": lambda: W.write_jpeg(wide, precision=12),
        "sof2_12bit": lambda: W.write_jpeg(wide, precision=12, progressive=1),
        "sof9_12bit": lambda: W.write_jpeg(wide, precision=12, arith=1),
        "sof10_12bit": lambda: W.write_jpeg(wide, precision=12, arith=1, progressive=1),
        "sof3_12bit": lambda: W.write_jpeg(wide, precision=12, lossless=(1, 0)),
        "sof3_10bit": lambda: W.write_jpeg(wide >> 2, precision=10, lossless=(1, 0)),
        "sof3_grey": lambda: W.write_jpeg(W.grey(img), lossless=(1, 0)),
        "sof11": lambda: _sof_patched(W.write_jpeg(img, lossless=(1, 0)), 0xCB),
        "sof7": lambda: _sof_patched(W.write_jpeg(img, lossless=(1, 0)), 0xC7),
    }[case]()
    assert _cv2_rgb(data, tmp_path) is None
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{case}.jpg: .*{pattern}"):
        decode_jpeg(str(path))
