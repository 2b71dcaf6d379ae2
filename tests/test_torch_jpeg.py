"""The port's JPEG reader (`straps_tpu_torch/utils/jpeg.py` over
`csrc/jpeg_decode.cpp`) against `cv2.imread(path)[:, :, ::-1]`, bit for
bit.

The fixtures in `tests/torch_jpeg/` were written with cv2 (libjpeg-turbo)
by `write_fixtures` below from `scene`, seeded RGB scenes with gradients,
hard-edged shapes, shading and mild noise, at sizes that do not fill whole
MCUs: a 4:2:0 baseline (600 x 452, quality 80), a 4:2:2 baseline with a
restart interval of 7 MCUs (333 x 517), a 4:4:4 progressive (517 x 333),
a 4:2:0 progressive (600 x 452), a greyscale baseline (245 x 301), and a
baseline of 60 x 100 with a hand-made APP1 Exif block of orientation 6
inserted after SOI (`exif_app1`), which cv2.imread turns to 100 x 60, and
a four-component Adobe CMYK baseline (86 x 58, quality 85) that Pillow
writes (`cmyk_jpeg`; inverted CMYK, Adobe transform 0, as print workflows
write it), which cv2.imread converts to BGR.
`expected.json` holds each file's decoded shape and the SHA-256 of
`cv2.imread(path)[:, :, ::-1]`; the first test holds it to the cv2 of
this run.  (It also holds the entries of the arithmetic, lossless, cut and
12-bit files of `write_codings.py`, which `test_torch_jpeg_codings.py`
checks.)  The other tests write their JPEGs at test time.
"""

import hashlib
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from straps_tpu_torch.utils import native_build
from straps_tpu_torch.utils import jpeg as JPEG
from straps_tpu_torch.utils.jpeg import decode_jpeg, decode_jpeg_bytes
from torch_jpeg.write_codings import scene
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg")


def exif_app1(orientation: int, little_endian: bool = True) -> bytes:
    """An APP1 segment holding a TIFF IFD0 with one Orientation tag."""
    bo = "<" if little_endian else ">"
    tiff = (b"II*\x00" if little_endian else b"MM\x00*") + struct.pack(bo + "I", 8)
    tiff += struct.pack(bo + "H", 1) + struct.pack(bo + "HHI", 0x0112, 3, 1)
    tiff += struct.pack(bo + "HH", orientation, 0) + struct.pack(bo + "I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


_Q, _SF, _PROG, _RST = (cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        cv2.IMWRITE_JPEG_PROGRESSIVE, cv2.IMWRITE_JPEG_RST_INTERVAL)
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
FIXTURES = {
    "baseline_420.jpg": ((452, 600), 1, [_Q, 80, _SF, SAMPLING["420"]]),
    "restart_422.jpg": ((517, 333), 2, [_Q, 75, _SF, SAMPLING["422"], _RST, 7]),
    "progressive_444.jpg": ((333, 517), 3, [_Q, 70, _SF, SAMPLING["444"], _PROG, 1]),
    "progressive_420.jpg": ((452, 600), 4, [_Q, 80, _SF, SAMPLING["420"], _PROG, 1]),
    "grey.jpg": ((301, 245), 5, [_Q, 85]),
    "exif_orientation6.jpg": ((100, 60), 6, [_Q, 90]),
    "cmyk_adobe.jpg": ((58, 86), 7, {"quality": 85}),
}


def cmyk_scene(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded (h, w, 4) uint8 CMYK scene: the inks of `scene`'s colours
    and a black plate from a second scene."""
    k = scene(h, w, seed + 50)[..., 1].astype(np.int64) * 3 // 4
    return np.concatenate([255 - scene(h, w, seed), k[..., None].astype(np.uint8)], -1)


def cmyk_jpeg(img: np.ndarray, **params) -> bytes:
    """A four-component JPEG of a CMYK array as Pillow writes it (inverted
    CMYK under an Adobe APP14 marker of transform 0)."""
    buf = io.BytesIO()
    h, w = img.shape[:2]
    Image.frombytes("CMYK", (w, h), np.ascontiguousarray(img).tobytes()).save(
        buf, "JPEG", **params)
    return buf.getvalue()


def _digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def write_fixtures(directory: str) -> dict:
    """Write the fixtures of `FIXTURES` with cv2 and return what
    expected.json holds for them."""
    expected = {}
    for name, ((h, w), seed, params) in FIXTURES.items():
        img = scene(h, w, seed)
        img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if name.startswith("grey") else img[:, :, ::-1]
        if name.startswith("cmyk"):
            data = cmyk_jpeg(cmyk_scene(h, w, seed), **params)
        else:
            data = cv2.imencode(".jpg", img, params)[1].tobytes()
        if "exif" in name:
            data = data[:2] + exif_app1(6) + data[2:]
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(data)
        px = cv2.imread(path)[:, :, ::-1]
        expected[name] = {"shape": list(px.shape), "sha256": _digest(px)}
    return expected


def _encode(img: np.ndarray, params) -> bytes:
    return cv2.imencode(".jpg", img, params)[1].tobytes()


def _cv2_rgb(data: bytes, tmp_path) -> np.ndarray:
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    return cv2.imread(path)[:, :, ::-1]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixtures_decode_as_cv2_and_expected_json(name):
    with open(os.path.join(FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)[name]
    path = os.path.join(FIXTURE_DIR, name)
    want = cv2.imread(path)[:, :, ::-1]
    assert list(want.shape) == expected["shape"] and _digest(want) == expected["sha256"]
    got = decode_jpeg(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_fixtures_are_what_write_fixtures_writes(tmp_path):
    with open(os.path.join(FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)
    # expected.json also holds the entries of `write_codings.py`'s files.
    assert write_fixtures(str(tmp_path)) == {name: expected[name] for name in FIXTURES}
    assert sum(os.path.getsize(os.path.join(FIXTURE_DIR, n)) for n in FIXTURES) < 300_000


SIZES = ((1, 1), (7, 9), (16, 16), (17, 33), (250, 251))


@pytest.mark.parametrize("quality", (30, 75, 95))
@pytest.mark.parametrize("progressive", (0, 1))
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_generated_jpegs_are_bit_exact(sampling, progressive, quality, tmp_path):
    """Every size, with and without a restart interval of 2 MCUs."""
    for k, (h, w) in enumerate(SIZES):
        img = scene(h, w, seed=100 * k + quality)[:, :, ::-1]
        for rst in (0, 2):
            data = _encode(img, [_Q, quality, _SF, SAMPLING[sampling], _PROG, progressive,
                                 _RST, rst])
            np.testing.assert_array_equal(decode_jpeg_bytes(data), _cv2_rgb(data, tmp_path),
                                          err_msg=f"{h}x{w} rst={rst}")


@pytest.mark.parametrize("progressive", (0, 1))
def test_greyscale_is_replicated_to_three_channels(progressive, tmp_path):
    for k, (h, w) in enumerate(SIZES):
        grey = cv2.cvtColor(scene(h, w, k), cv2.COLOR_RGB2GRAY)
        data = _encode(grey, [_Q, 80, _PROG, progressive, _RST, k % 2])
        got = decode_jpeg_bytes(data)
        np.testing.assert_array_equal(got, _cv2_rgb(data, tmp_path))
        assert (got == got[..., :1]).all()


@pytest.mark.parametrize("little_endian", (True, False))
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(orientation, little_endian, tmp_path):
    img = scene(100, 60, orientation)[:, :, ::-1]
    base = _encode(img, [_Q, 90, _SF, SAMPLING["420"]])
    data = base[:2] + exif_app1(orientation, little_endian) + base[2:]
    got = decode_jpeg_bytes(data)
    np.testing.assert_array_equal(got, _cv2_rgb(data, tmp_path))
    assert got.shape == ((60, 100, 3) if orientation >= 5 else (100, 60, 3))


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """`data` with byte `offset` of the first segment of `marker` set."""
    at = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[at + offset] = value
    return bytes(out)


def _four_components(data: bytes) -> bytes:
    """The frame header rewritten to declare a fourth component."""
    at = data.index(b"\xff\xc0")
    seg = int.from_bytes(data[at + 2:at + 4], "big")
    body = bytearray(data[at + 4:at + 2 + seg])
    body[5] = 4
    body += bytes([4, 0x11, 0])
    return data[:at] + b"\xff\xc0" + (len(body) + 2).to_bytes(2, "big") + bytes(body) \
        + data[at + 2 + seg:]


@pytest.mark.parametrize("case,pattern", [
    ("sof5", "SOF5 \\(differential sequential\\)"),
    ("sof11", "SOF11 \\(arithmetic-coded lossless\\)"),
    ("12bit", "precision 12"),
    ("2comp", "2 components in SOF0"),
])
def test_unsupported_codings_are_refused_by_name(case, pattern, tmp_path):
    data = _encode(scene(32, 48, 0)[:, :, ::-1], [_Q, 80])
    if case.startswith("sof"):
        data = _patched(data, 0xC0, 1, 0xC0 + int(case[3:]))
    elif case == "12bit":
        data = _patched(data, 0xC0, 4, 12)
    else:
        data = _patched(data, 0xC0, 9, 2)
    assert _cv2_rgb_or_none(data, tmp_path) is None
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{case}.jpg: .*{pattern}"):
        decode_jpeg(str(path))


def _cv2_rgb_or_none(data: bytes, tmp_path):
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    img = cv2.imread(path)
    return None if img is None else img[:, :, ::-1]


@pytest.mark.parametrize("case", ["sof9", "sof10", "sof3", "dac"])
def test_once_refused_codings_decode_as_cv2(case, tmp_path):
    """Arithmetic-coded sequential (SOF9) and progressive (SOF10) and
    lossless (SOF3) files, written by libjpeg-turbo
    (`tests/torch_jpeg/write_codings.py`), and a Huffman file carrying a DAC
    segment (which libjpeg parses and the Huffman decoder ignores), decode
    as cv2 decodes them."""
    from torch_jpeg.write_codings import write_jpeg
    img = scene(32, 48, 0)
    if case == "dac":
        data = _encode(img[:, :, ::-1], [_Q, 80])
        data = data[:2] + b"\xff\xcc\x00\x04\x00\x11" + data[2:]
    else:
        data = write_jpeg(img, **{"sof9": dict(arith=1), "sof10": dict(arith=1, progressive=1),
                                  "sof3": dict(lossless=(4, 0))}[case])
        assert bytes([0xFF, 0xC0 + int(case[3:])]) in data
    want = _cv2_rgb_or_none(data, tmp_path)
    assert want is not None
    np.testing.assert_array_equal(decode_jpeg_bytes(data), want)


def _adobe_transform(data: bytes, transform: int) -> bytes:
    """`data` with its Adobe APP14 segment's colour transform set."""
    return _patched(data, 0xEE, 15, transform)


@pytest.mark.parametrize("case", ["cmyk", "pillow_cmyk", "pillow_cmyk_progressive",
                                  "pillow_cmyk_subsampled", "ycck"])
def test_four_component_jpegs_decode_as_cv2(case, tmp_path):
    """cv2.imread reads four components as CMYK (YCCK under an Adobe
    transform other than 0, turned into CMYK by libjpeg) and converts them
    to BGR.  `cmyk` is a cv2 JPEG whose frame header declares a fourth
    component that no scan carries: libjpeg keeps its coefficients at zero
    (mid-grey K) and cv2 decodes it.  The Pillow files are inverted CMYK
    under Adobe transform 0, at every size, progressive, and with the first
    component at 2x2; `ycck` is the baseline with its transform set to 2."""
    if case == "cmyk":
        datas = [_four_components(_encode(scene(32, 48, 0)[:, :, ::-1], [_Q, 80]))]
    else:
        params = {"quality": 80, "progressive": case.endswith("progressive"),
                  "subsampling": 2 if case.endswith("subsampled") else 0}
        datas = [cmyk_jpeg(cmyk_scene(h, w, k), **params) for k, (h, w) in enumerate(SIZES)]
        if case == "ycck":
            datas = [_adobe_transform(d, 2) for d in datas]
    for data in datas:
        want = _cv2_rgb(data, tmp_path)
        got = decode_jpeg_bytes(data)
        assert got.shape == want.shape and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("restart", (0, 4))
def test_cut_short_sequential_files_decode_as_cv2(restart, tmp_path):
    """libjpeg reads the rest of a cut sequential file as zero bits (grey
    MCUs up to the next restart marker), and cv2 returns that image."""
    data = _encode(scene(200, 300, 9)[:, :, ::-1], [_Q, 80, _RST, restart])
    for frac in (0.3, 0.77, 0.95):
        cut = data[:int(len(data) * frac)]
        np.testing.assert_array_equal(decode_jpeg_bytes(cut), _cv2_rgb(cut, tmp_path))


def test_cut_short_progressive_files_raise_unless_complete(tmp_path):
    """Once refused, now decoded: libjpeg-turbo smooths the blocks of a
    progressive file cut before its low-frequency coefficients are
    complete, and the port smooths them as it does; cut inside its last
    scans, the file decodes as cv2 does too.  (Only a file cut inside a
    marker segment still raises, as cv2 reads no image from it.)"""
    data = _encode(scene(200, 300, 9)[:, :, ::-1], [_Q, 80, _PROG, 1])
    for frac in (0.5, 0.95):
        cut = data[:int(len(data) * frac)]
        np.testing.assert_array_equal(decode_jpeg_bytes(cut, "cut.jpg"), _cv2_rgb(cut, tmp_path))


def test_not_a_jpeg_raises_naming_the_file(tmp_path):
    path = tmp_path / "fake.jpg"
    path.write_bytes(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="fake.jpg: not a JPEG file"):
        decode_jpeg(str(path))


def test_decoder_is_built_from_the_port_sources():
    lib = native_build.host_library("jpeg_decode", JPEG._SIGNATURES)
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.realpath(native_build.BUILD_DIR)
    digest = native_build.source_digest(
        os.path.join(native_build.CSRC_DIR, "jpeg_decode.cpp"), native_build.HOST_FLAGS)
    assert os.path.basename(path) == f"jpeg_decode_{digest}.so"
