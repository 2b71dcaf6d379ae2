"""The port's zstd decoder (`straps_tpu_torch/utils/zstd.py` over
`csrc/zstd_decode.cpp`) against the `zstandard` package, which is only an
oracle here: on a seeded corpus (levels 1, 3, 4, 9, 19 and 22, long-distance
matching, content size written and omitted, checksums on and off, several
frames and skippable frames, empty input, inputs of 1 B to 4 MB of random
bytes, float32 weights, zeros and repeated rows, and hypothesis-drawn
inputs) the output is bit-identical, and the corpus reaches every block,
literals and sequence-table mode.  Dictionary frames, truncated input and
a flipped checksum raise a ValueError that names the cause, and mutated
frames decode as `zstandard` decodes them or raise; the raw-block frames
the checkpoint writer makes are read by `zstandard`.
"""

import struct

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from straps_tpu_torch.utils import zstd
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _corpus():
    rng = np.random.RandomState(0)
    weights = (rng.randn(1 << 20) * 0.05).astype(np.float32).tobytes()          # 4 MB
    rows = np.tile((rng.randn(1, 3000) * 0.02).astype(np.float32), (40, 1))
    rows[:, ::7] += 1e-3 * rng.randn(40, 1).astype(np.float32)
    seed = rng.bytes(4096)
    runs = seed + b"".join(seed[(i * 97) % 3000:(i * 97) % 3000 + 50 + i % 40] + b"Z"
                           for i in range(6000))
    text = " ".join(rng.choice(["zarr", "chunk", "ocdbt", "node", "leaf", "key", "value"],
                               40000)).encode()
    return {
        "one_byte": b"\x2a",
        "random_100": rng.bytes(100),
        "random_300k": rng.bytes(300_000),
        "weights_4mb": weights,
        "weights_64k": weights[:65536],
        "zeros_1m": bytes(1 << 20),
        "random_then_zeros": rng.bytes(1000) + bytes(300_000),
        "repeated_rows": rows.tobytes(),
        "ramp": np.repeat(np.arange(200, dtype=np.uint8), 37).tobytes(),
        "int64_high_bytes": (np.arange(20000, dtype=np.int64) << 56).tobytes(),
        "runs": runs,
        "text": text,
    }


CORPUS = _corpus()
LEVELS = (1, 3, 4, 9, 19, 22)      # level 4 writes RLE literals for `runs`
# Levels 19 and 22 compress slowly: they take the inputs up to 430 KB.
SLOW_LEVEL_MAX = 430_000


def _compress(data: bytes, level: int, checksum: bool = False, content_size: bool = True,
              **params) -> bytes:
    p = zstandard.ZstdCompressionParameters.from_level(
        level, source_size=len(data), write_checksum=checksum, write_content_size=content_size,
        **params)
    return zstandard.ZstdCompressor(compression_params=p).compress(data)


CASES = [(level, name) for level in LEVELS for name in CORPUS
         if level < 19 or len(CORPUS[name]) <= SLOW_LEVEL_MAX]


@pytest.mark.parametrize("level,name", CASES, ids=[f"{lv}-{n}" for lv, n in CASES])
def test_matches_zstandard(level, name):
    data = CORPUS[name]
    frame = _compress(data, level, checksum=level % 2 == 1, content_size=level not in (4, 9))
    assert zstd.decompress(frame) == data == zstandard.decompress(frame, max_output_size=1 << 23)


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_frame_header_flags(checksum, content_size):
    data = CORPUS["text"]
    frame = _compress(data, 3, checksum=checksum, content_size=content_size)
    fhd = frame[4]
    assert bool(fhd & 4) == checksum and bool(fhd >> 6 or fhd & 0x20) == content_size
    assert zstd.decompress(frame) == data


def test_streamed_frame_without_content_size():
    data = CORPUS["weights_64k"] + CORPUS["text"]
    cobj = zstandard.ZstdCompressor(level=3).compressobj()
    frame = b"".join([cobj.compress(data[:70000]), cobj.compress(data[70000:]), cobj.flush()])
    assert frame[4] >> 6 == 0 and not frame[4] & 0x20
    assert zstd.decompress(frame) == data


def test_long_distance_matching():
    data = CORPUS["random_300k"] * 3
    frame = _compress(data, 19, enable_ldm=True, window_log=27)
    assert zstd.decompress(frame) == data


def test_several_frames_and_skippable_frames():
    parts = [b"first", CORPUS["text"], b"", CORPUS["random_then_zeros"]]
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"notes"
    stream = (_compress(parts[0], 1) + skippable + _compress(parts[1], 3, checksum=True)
              + _compress(parts[2], 1) + _compress(parts[3], 9))
    zstd.mode_counts(reset=True)
    assert zstd.decompress(stream) == b"".join(parts)
    counts = zstd.mode_counts()
    assert counts["frames"] == 4 and counts["skippable_frames"] == 1
    assert counts["checksums"] == 1


def test_empty_input():
    assert zstd.decompress(zstandard.compress(b"")) == b""
    assert zstd.decompress(_compress(b"", 19, checksum=True, content_size=False)) == b""
    with pytest.raises(ValueError, match="empty input"):
        zstd.decompress(b"")


@settings(max_examples=40, deadline=None, derandomize=True)
@given(data=st.binary(min_size=0, max_size=3000), level=st.sampled_from([1, 3, 9, 19]),
       repeat=st.integers(1, 40))
def test_hypothesis_drawn_inputs(data, level, repeat):
    payload = (data * repeat)[:50_000]
    assert zstd.decompress(_compress(payload, level, checksum=True)) == payload


def test_corpus_reaches_every_mode():
    """Every count `decompress` keeps is non-zero over the corpus: raw,
    RLE and compressed blocks; raw, RLE, Huffman and treeless literals;
    1 and 4 Huffman streams; predefined, RLE, FSE and repeat tables."""
    zstd.mode_counts(reset=True)
    for level, name in CASES:
        zstd.decompress(_compress(CORPUS[name], level, checksum=True))
    zstd.decompress(struct.pack("<II", 0x184D2A50, 0))
    counts = zstd.mode_counts()
    missing = [name for name in zstd.count_names() if counts[name] == 0]
    assert not missing, (missing, counts)


def test_dictionary_frames_are_refused():
    dictionary = zstandard.train_dictionary(4096, [CORPUS["text"][i:i + 500]
                                                   for i in range(0, 200_000, 500)])
    frame = zstandard.ZstdCompressor(level=3, dict_data=dictionary).compress(b"zarr chunk" * 50)
    with pytest.raises(ValueError, match="dictionar"):
        zstd.decompress(frame)


@pytest.mark.parametrize("cut", [1, 5, 12, 200, -1])
def test_truncated_input_is_refused(cut):
    frame = _compress(CORPUS["weights_64k"], 3, checksum=True)
    with pytest.raises(ValueError, match="truncated|runs past|ends before"):
        zstd.decompress(frame[:cut])


def test_flipped_checksum_is_refused():
    frame = bytearray(_compress(CORPUS["text"], 3, checksum=True))
    frame[-2] ^= 0x10
    with pytest.raises(ValueError, match="checksum mismatch"):
        zstd.decompress(bytes(frame))


def test_mutated_frames_decode_as_zstandard_or_are_refused():
    """2,000 frames with 1-3 bytes changed (a fifth also cut short): each
    either decodes to what `zstandard` decodes or raises a ValueError;
    none returns bytes that `zstandard` refuses."""
    rng = np.random.RandomState(11)
    frames = [_compress(CORPUS[name], level, checksum=checksum)
              for name in ("weights_64k", "text", "ramp") for level in (1, 3, 19)
              for checksum in (False, True)]
    decoded = 0
    for _ in range(2000):
        frame = bytearray(frames[rng.randint(len(frames))])
        for _ in range(rng.randint(1, 4)):
            frame[rng.randint(len(frame))] = rng.randint(256)
        if rng.rand() < 0.2:
            frame = frame[:rng.randint(len(frame))]
        try:
            got = zstd.decompress(bytes(frame))
        except ValueError:
            continue
        assert got == zstandard.ZstdDecompressor().decompress(bytes(frame),
                                                              max_output_size=1 << 24)
        decoded += 1
    assert 0 < decoded < 2000


def test_garbage_is_refused():
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"not a zstd frame at all")


@pytest.mark.parametrize("size", [0, 1, 131072, 131073, 400_000])
def test_raw_frames_read_by_zstandard(size):
    data = np.random.RandomState(size).bytes(size)
    frame = zstd.frame_raw(data)
    assert zstandard.decompress(frame) == data == zstd.decompress(frame)


def test_crc32c():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
