"""The port's PNG reader (`straps_tpu_torch/utils/png.py` over
`csrc/png_decode.cpp`) against `cv2.imread`, bit for bit, on every PNG
variant cv2 reads: colour reads (`decode_png`, `IMREAD_COLOR` in RGB
order) and grey reads (`decode_png_grey`, `IMREAD_GRAYSCALE`), the
release-layout silhouettes of `eval_harness/datasets.py::load_ssp3d`
against the JAX loader's, and the predict's `read_image`/`read_images`
against the JAX pipeline's read, pad and resize.

The fixtures in `tests/torch_png/` were written by
`tests/torch_png/write_variants.py` (a numpy PNG writer, `pngwriter.py`);
`expected.json` holds cv2.imread's hashes of both reads.  The other tests
write their PNGs at test time, at seeded random sizes of 40 pixels or
under.
"""

import hashlib
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from straps_tpu_torch.utils import native_build
from straps_tpu_torch.utils.png import (decode_png, decode_png_bytes, decode_png_grey,
                                        decode_png_grey_bytes)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_png")
sys.path.insert(0, FIXTURE_DIR)
import write_variants  # noqa: E402
from pngwriter import CHANNELS, chunk, png_bytes  # noqa: E402


def _digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2_reads(data: bytes, tmp_path):
    """cv2.imread's colour (RGB order) and grey reads of `data`, or None."""
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    colour = cv2.imread(path, cv2.IMREAD_COLOR)
    grey = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    return (None if colour is None else colour[:, :, ::-1]), grey


def _assert_reads_as_cv2(data: bytes, tmp_path, msg=""):
    colour, grey = _cv2_reads(data, tmp_path)
    assert colour is not None and grey is not None, msg
    got = decode_png_bytes(data)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, colour, err_msg=f"colour {msg}")
    np.testing.assert_array_equal(decode_png_grey_bytes(data), grey, err_msg=f"grey {msg}")


@pytest.mark.parametrize("name", sorted(write_variants.VARIANTS))
def test_fixtures_decode_as_cv2_and_expected_json(name):
    with open(os.path.join(FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)[name]
    path = os.path.join(FIXTURE_DIR, name)
    assert write_variants.cv2_entry(path) == expected
    colour, grey = decode_png(path), decode_png_grey(path)
    assert list(colour.shape) == expected["shape"] and grey.shape == colour.shape[:2]
    assert _digest(colour) == expected["sha256"] and _digest(grey) == expected["grey_sha256"]


def test_fixtures_are_what_write_variants_writes(tmp_path):
    with open(os.path.join(FIXTURE_DIR, "expected.json")) as f:
        assert write_variants.write_fixtures(str(tmp_path)) == json.load(f)
    for name in write_variants.VARIANTS:
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read(), name
    assert sum(os.path.getsize(os.path.join(FIXTURE_DIR, n))
               for n in write_variants.VARIANTS) < 80_000


FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", (0, 1))
@pytest.mark.parametrize("color_type,depth", FORMS)
def test_every_form_decodes_as_cv2(color_type, depth, interlace, tmp_path):
    """Each colour type at each bit depth, at seeded random sizes (1-40
    pixels a side, so Adam7's empty passes occur), some with a palette
    shorter than the depth allows (indices past it read black), tRNS, or
    the data over several IDAT chunks."""
    rng = np.random.default_rng(100 * color_type + depth + 7 * interlace)
    for _ in range(4):
        h, w = (int(x) for x in rng.integers(1, 41, 2))
        px = rng.integers(0, 1 << depth, (h, w, CHANNELS[color_type]))
        pal = trns = None
        if color_type == 3:
            pal = rng.integers(0, 256, (int(rng.integers(1, (1 << depth) + 1)), 3))
            trns = bytes(rng.integers(0, 256, len(pal)).astype(np.uint8)) if rng.random() < .5 else None
        data = png_bytes(px, color_type, depth, palette=pal, trns=trns, interlace=interlace,
                         idat_parts=int(rng.integers(1, 4)))
        _assert_reads_as_cv2(data, tmp_path, f"{h}x{w}")


@pytest.mark.parametrize("color_type,depth", [(2, 8), (2, 16), (3, 8), (6, 8), (6, 16)])
@pytest.mark.parametrize("chunks", [
    "gama45455", "gama20000", "gama250000", "gama100000", "srgb", "srgb_after_gama",
    "two_gama", "gama_zero", "sbit", "iccp", "chrm", "gama_after_idat"])
def test_gamma_chunks_change_only_the_grey_read(color_type, depth, chunks, tmp_path):
    """A gAMA chunk other than 1 (or sRGB, which stands for 1/2.2 whatever
    gAMA says; the first valid gAMA counts) makes libpng weigh linear values
    in cv2's grey read; sBIT changes its 16-bit tables; iCCP and cHRM
    change nothing, nor does a gAMA after the image data."""
    g = lambda v: (b"gAMA", struct.pack(">I", v))  # noqa: E731
    srgb = (b"sRGB", b"\x00")
    sets = {"gama45455": [g(45455)], "gama20000": [g(20000)], "gama250000": [g(250000)],
            "gama100000": [g(100000)], "srgb": [srgb], "srgb_after_gama": [g(20000), srgb],
            "two_gama": [g(20000), g(60000)], "gama_zero": [g(0)],
            "sbit": [g(45455), (b"sBIT", bytes([9] * (4 if color_type == 6 else 3)))],
            "iccp": [(b"iCCP", b"profile\x00\x00" + zlib.compress(b"\x00" * 132))],
            "chrm": [(b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000, 30000, 60000,
                                           15000, 6000))],
            "gama_after_idat": []}
    rng = np.random.default_rng(len(chunks) + color_type + depth)
    px = rng.integers(0, 1 << depth, (23, 37, CHANNELS[color_type]))
    px[:5, :, 1:3] = px[:5, :, :1]                 # grey pixels take another table
    pal = rng.integers(0, 256, (256, 3)) if color_type == 3 else None
    data = png_bytes(px, color_type, depth, palette=pal, chunks=sets[chunks])
    if chunks == "gama_after_idat":
        end = data.rindex(b"IEND") - 4
        data = data[:end] + chunk(b"gAMA", struct.pack(">I", 20000)) + data[end:]
    _assert_reads_as_cv2(data, tmp_path, chunks)


def _broken(case: str) -> bytes:
    px = np.random.default_rng(3).integers(0, 256, (20, 30, 3))
    data = png_bytes(px, 2, 8)
    idat = data.index(b"IDAT")
    raw = zlib.decompress(data[idat + 4:idat + 4 + struct.unpack(">I", data[idat - 4:idat])[0]])
    head = data[:8 + 25]
    if case == "truncated":
        return data[:len(data) * 2 // 3]
    if case == "no_iend":
        return data[:-12]
    if case == "idat_crc":
        out = bytearray(data)
        out[data.index(b"IEND") - 5] ^= 1
        return bytes(out)
    if case == "bad_filter":
        bad = bytearray(raw)
        bad[(1 + 90) * 5] = 7
        return head + chunk(b"IDAT", zlib.compress(bytes(bad))) + chunk(b"IEND", b"")
    if case == "short_data":
        return head + chunk(b"IDAT", zlib.compress(raw[:-40])) + chunk(b"IEND", b"")
    if case == "no_plte":
        return png_bytes(px[..., :1] % 4, 3, 8)
    if case == "bad_depth":
        out = bytearray(data)
        out[8 + 8 + 8] = 3                         # 3-bit RGB
        crc = zlib.crc32(bytes(out[12:29])) & 0xFFFFFFFF
        out[29:33] = struct.pack(">I", crc)
        return bytes(out)
    raise ValueError(case)


@pytest.mark.parametrize("case,pattern", [
    ("truncated", "ends"), ("no_iend", "ends before IEND"), ("idat_crc", "CRC error"),
    ("bad_filter", "unknown PNG row filter"), ("short_data", "not enough PNG image data"),
    ("no_plte", "without a PLTE"), ("bad_depth", "bit depth 3")])
def test_what_cv2_does_not_read_raises_naming_the_file(case, pattern, tmp_path):
    data = _broken(case)
    assert _cv2_reads(data, tmp_path) == (None, None)
    path = tmp_path / f"{case}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{case}.png: .*{pattern}"):
        decode_png(str(path))
    with pytest.raises(ValueError, match=f"{case}.png: .*{pattern}"):
        decode_png_grey(str(path))


def test_ancillary_chunk_with_a_bad_crc_is_skipped(tmp_path):
    """libpng drops an ancillary chunk whose CRC is wrong: a broken gAMA
    leaves the grey read ungamma'd."""
    px = np.random.default_rng(4).integers(0, 256, (17, 19, 3))
    data = bytearray(png_bytes(px, 2, 8, chunks=[(b"gAMA", struct.pack(">I", 20000))]))
    data[data.index(b"gAMA") + 8] ^= 1
    _assert_reads_as_cv2(bytes(data), tmp_path)


def test_large_palette_adam7_image(tmp_path):
    """A 1024x768 interlaced palette image, the size chip_smoke times."""
    rng = np.random.default_rng(5)
    data = png_bytes(rng.integers(0, 256, (768, 1024, 1)), 3, 8,
                     palette=rng.integers(0, 256, (256, 3)), interlace=1)
    _assert_reads_as_cv2(data, tmp_path)


def test_decoder_is_built_from_the_port_sources():
    lib = native_build.host_library("png_decode")
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.realpath(native_build.BUILD_DIR)
    digest = native_build.source_digest(
        os.path.join(native_build.CSRC_DIR, "png_decode.cpp"), native_build.HOST_FLAGS)
    assert os.path.basename(path) == f"png_decode_{digest}.so"


# ------------------------------------------------- the release layout --

SILHOUETTE_FORMS = ("rgb_green", "rgb_dark_blue", "palette", "grey16", "rgb16", "grey1",
                    "rgba_srgb", "grey8")


def _silhouette_png(form: str, mask: np.ndarray, rng) -> bytes:
    """A silhouette (True = person) written in one of the forms a release
    could ship; colours chosen so that channel 0 and the grey read differ."""
    h, w = mask.shape
    m = mask[..., None]
    if form == "rgb_green":           # green 200: grey 117, red 0
        return png_bytes(np.where(m, [0, 200, 0], 0), 2, 8)
    if form == "rgb_dark_blue":       # blue 8 is background, blue 9 foreground
        return png_bytes(np.where(m, [0, 0, 9], [0, 0, 8]), 2, 8)
    if form == "palette":
        pal = np.array([[0, 0, 0], [0, 0, 255], [0, 3, 0], [200, 0, 0]])
        idx = np.where(mask, rng.integers(1, 4, mask.shape), 0)
        return png_bytes(idx[..., None], 3, 2, palette=pal)
    if form == "grey16":
        return png_bytes(np.where(m, rng.integers(256, 65536, (h, w, 1)),
                                  rng.integers(0, 256, (h, w, 1))), 0, 16)
    if form == "rgb16":
        return png_bytes(np.where(m, [0, 40000, 0], [65535 // 255 - 1, 0, 0]), 2, 16)
    if form == "grey1":
        return png_bytes(m.astype(np.int64), 0, 1, interlace=1)
    if form == "rgba_srgb":
        return png_bytes(np.where(m, [0, 60, 0, 255], [0, 0, 0, 0]), 6, 8,
                         chunks=[(b"sRGB", b"\x00")])
    return png_bytes(m.astype(np.int64) * 255, 0, 8)


@pytest.mark.parametrize("form", SILHOUETTE_FORMS)
def test_ssp3d_silhouettes_match_the_jax_loader(form, tmp_path):
    """`load_ssp3d` thresholds the grey read (> 0) as the JAX loader's
    `cv2.imread(png, IMREAD_GRAYSCALE) > 0` does, on silhouettes that are
    coloured, palette, 16-bit, 1-bit or sRGB."""
    from straps_tpu.eval_harness.datasets import load_ssp3d as jax_load_ssp3d
    from straps_tpu_torch.eval_harness.datasets import load_ssp3d
    rng = np.random.default_rng(len(form))
    n, h, w = 3, 24, 20
    sil_dir = tmp_path / "silhouettes"
    sil_dir.mkdir()
    fnames = [f"img_{i}.png" for i in range(n)]
    for f in fnames:
        yy, xx = np.mgrid[0:h, 0:w]
        mask = (yy - rng.integers(6, 18)) ** 2 + (xx - rng.integers(5, 15)) ** 2 < 40
        (sil_dir / f).write_bytes(_silhouette_png(form, mask, rng))
    labels = tmp_path / "labels.npz"
    np.savez(labels, pose=rng.normal(size=(n, 72)).astype(np.float32),
             shape=rng.normal(size=(n, 10)).astype(np.float32),
             gender=np.array(["m", "f", "m"]), fnames=np.array(fnames))
    ours = load_ssp3d(str(labels), str(sil_dir))
    theirs = jax_load_ssp3d(str(labels), str(sil_dir))
    np.testing.assert_array_equal(ours["silhouettes"], np.asarray(theirs["silhouettes"]))
    assert ours["silhouettes"].any() and not ours["silhouettes"].all()


# ---------------------------------------------------- the predict read --

def test_read_images_matches_the_jax_read_on_a_mixed_folder(tmp_path):
    """`read_images` over PNGs of every form and JPEGs of the new codings
    (a JPEG saved as `.png` and a PNG saved as `.jpg` included) equals the
    JAX predict's read: cv2.imread, padded to a square, resized with
    INTER_LINEAR; names and order as its glob gives them."""
    from straps_tpu.geometry.bbox import pad_to_square_params
    from straps_tpu_torch.predict import pipeline as TP
    jpeg_dir = os.path.join(os.path.dirname(FIXTURE_DIR), "torch_jpeg")
    folder = tmp_path / "mixed"
    folder.mkdir()
    for name in ("palette2_adam7.png", "grey16.png", "grey1.png", "rgba16_adam7.png"):
        os.symlink(os.path.join(FIXTURE_DIR, name), folder / name)
    for name in ("arith_seq_444_rst_dac.jpg", "arith_prog_444_rst.jpg", "lossless_p1.jpg",
                 "huff_prog_420_cut.jpg"):
        os.symlink(os.path.join(jpeg_dir, name), folder / name)
    os.symlink(os.path.join(jpeg_dir, "lossless_p5_6bit.jpg"), folder / "jpeg_named.png")
    os.symlink(os.path.join(FIXTURE_DIR, "rgb16_sbit.png"), folder / "png_named.jpg")
    size = 48
    names, frames = TP.read_images(str(folder), size, "cpu")
    import glob
    paths = sorted(glob.glob(str(folder / "*.png")) + glob.glob(str(folder / "*.jpg")))
    assert names == [os.path.splitext(os.path.basename(p))[0] for p in paths]
    for path, frame in zip(paths, frames.numpy()):
        img = cv2.imread(path)[:, :, ::-1]
        top, left = pad_to_square_params(*img.shape[:2])
        img = np.pad(img, ((top, top), (left, left), (0, 0)))
        want = cv2.resize(np.ascontiguousarray(img), (size, size), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(frame, want, err_msg=path)


def test_read_image_chooses_the_decoder_by_content(tmp_path):
    from straps_tpu_torch.predict.pipeline import read_image
    jpeg = os.path.join(os.path.dirname(FIXTURE_DIR), "torch_jpeg", "arith_prog_444_rst.jpg")
    png = os.path.join(FIXTURE_DIR, "palette8_trns.png")
    for src, name in ((jpeg, "a.png"), (png, "b.jpg")):
        with open(src, "rb") as f:
            (tmp_path / name).write_bytes(f.read())
        np.testing.assert_array_equal(read_image(str(tmp_path / name)),
                                      cv2.imread(str(tmp_path / name))[:, :, ::-1])
    (tmp_path / "c.png").write_bytes(b"not an image, whatever its name says")
    assert cv2.imread(str(tmp_path / "c.png")) is None
    with pytest.raises(ValueError, match="c.png: neither a JPEG nor a PNG"):
        read_image(str(tmp_path / "c.png"))


def test_read_images_raises_for_the_first_image_that_does_not_decode(tmp_path):
    """`read_images` decodes in threads, yet a folder with two unreadable
    files raises for the first in the folder's order, as a loop over the
    folder would, whichever decode ends first."""
    from straps_tpu_torch.predict.pipeline import read_images
    src = os.path.join(FIXTURE_DIR, "palette8_trns.png")
    with open(src, "rb") as f:
        good = f.read()
    for i in range(12):
        (tmp_path / f"img_{i:02d}.png").write_bytes(good)
    (tmp_path / "img_05b.png").write_bytes(b"not an image")
    (tmp_path / "img_09b.png").write_bytes(good[:8])
    with pytest.raises(ValueError, match="img_05b.png"):
        read_images(str(tmp_path), 32, "cpu")
