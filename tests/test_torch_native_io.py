"""The port's native host reader (`straps_tpu_torch/data/native_io.py` over
`csrc/straps_io.cpp`, its own copy of the JAX package's `native/`) against
the JAX package's `straps_tpu/data/native_io.py`.

`shuffled_indices` is compared with the JAX library's C++ path (the JAX
function falls back to numpy's RandomState when its library is missing,
which gives other orders).  `load_npy_batch` returns float32 of every
dtype it reads, as the JAX function does through its numpy branch.
"""

import os

import numpy as np
import pytest
import torch

from straps_tpu.data import native_io as JIO
from straps_tpu_torch.data import native_io as TIO
from straps_tpu_torch.predict import pipeline as TP
from straps_tpu_torch.utils import native_build
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 0), (2, 0), (17, 0), (513, 7), (1000, 3),
                                    (4096, 2 ** 63 + 11), (65, 1)])
def test_shuffled_indices_equal_the_jax_library(n, seed):
    assert JIO.get_library() is not None, "the JAX package's native library did not build"
    want = JIO.shuffled_indices(n, seed)
    got = TIO.shuffled_indices(n, seed)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))


def _write(path, a):
    np.save(path, a)
    return str(path)


DTYPES = ["<f4", "<f8", "|u1", "|b1"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_load_npy_batch_equals_jax_per_dtype(dtype, tmp_path):
    rng = np.random.default_rng(DTYPES.index(dtype))
    paths = []
    for i in range(5):
        a = rng.normal(0, 300, (6, 17, 2))
        a = a > 0 if dtype == "|b1" else a.astype(dtype) if dtype != "|u1" else \
            np.abs(a).astype(np.uint8)
        paths.append(_write(tmp_path / f"{i}.npy", a))
    got = TIO.load_npy_batch(paths, (6, 17, 2))
    assert got.dtype == np.float32 and got.shape == (5, 6, 17, 2)
    np.testing.assert_array_equal(got, JIO.load_npy_batch(paths, (6, 17, 2)))


def test_load_npy_batch_reads_mixed_orders_and_byte_orders(tmp_path):
    rng = np.random.default_rng(9)
    paths = [_write(tmp_path / "c.npy", rng.normal(size=(4, 3)).astype(np.float32)),
             _write(tmp_path / "f.npy", np.asfortranarray(rng.normal(size=(4, 3)))),
             _write(tmp_path / "be.npy", rng.normal(size=(4, 3)).astype(">f8")),
             _write(tmp_path / "i.npy", rng.integers(-9, 9, (4, 3)).astype(">i4"))]
    np.testing.assert_array_equal(TIO.load_npy_batch(paths, (4, 3), threads=2),
                                  JIO.load_npy_batch(paths, (4, 3)))


def test_load_npy_batch_names_the_file_it_cannot_read(tmp_path):
    good = [_write(tmp_path / f"{i}.npy", np.ones((4, 3), np.float32)) for i in range(3)]
    bad = _write(tmp_path / "bad.npy", np.ones((3, 4), np.float32))
    with pytest.raises(ValueError, match="bad.npy"):
        TIO.load_npy_batch(good + [bad], (4, 3))
    cplx = _write(tmp_path / "cplx.npy", np.ones((4, 3), np.complex64))
    with pytest.raises(ValueError, match="cplx.npy: dtype not read"):
        TIO.load_npy_batch(good + [cplx], (4, 3))
    assert TIO.load_npy_batch([], (4, 3)).shape == (0, 4, 3)


@pytest.mark.parametrize("a", [np.arange(60, dtype=np.float32).reshape(3, 4, 5) / 7,
                               np.arange(100, dtype=np.int64).reshape(10, 10) - 50,
                               np.arange(24, dtype=np.int16).reshape(2, 3, 4),
                               np.asfortranarray(np.arange(12.0).reshape(3, 4))],
                         ids=["f4", "i8", "i2", "f8-fortran"])
def test_mmap_npy_equals_jax(a, tmp_path):
    path = _write(tmp_path / "m.npy", a)
    got = TIO.mmap_npy(path)
    want = JIO.mmap_npy(path)
    assert got.dtype == np.asarray(want).dtype and not got.flags.writeable
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("a", [np.arange(12, dtype=np.uint8).reshape(3, 4),
                               np.arange(12).reshape(3, 4) % 3 == 0,
                               np.arange(6, dtype=">f4")],
                         ids=["u1", "b1", "f4-big-endian"])
def test_mmap_npy_reads_one_byte_and_big_endian_files(a, tmp_path):
    """The JAX function raises a TypeError on one-byte dtypes (its dtype
    table builds '<f1'); the port reads them, and big-endian files, as
    np.load does."""
    path = _write(tmp_path / "m.npy", a)
    got = TIO.mmap_npy(path)
    assert got.dtype == a.dtype and not got.flags.writeable
    np.testing.assert_array_equal(got, a)


def test_library_is_built_from_the_port_sources():
    """The port loads `straps_tpu_torch/csrc/straps_io.cpp` built into
    `straps_tpu_torch/_build/`, never the JAX package's `native/`."""
    lib = TIO.get_library()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.realpath(native_build.BUILD_DIR)
    source = os.path.join(REPO, "straps_tpu_torch", "csrc", "straps_io.cpp")
    digest = native_build.source_digest(source, native_build.HOST_FLAGS)
    assert os.path.basename(path) == f"straps_io_{digest}.so"
    assert not path.startswith(os.path.realpath(os.path.join(REPO, "native")))


def test_cached_proxies_load_through_the_native_reader(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    sils = (rng.random((3, 40, 40)) > 0.5).astype(np.float32)
    joints = rng.uniform(0, 40, (3, 17, 2)).astype(np.float32)
    TP.save_proxies(str(tmp_path), ["a", "b", "c"], sils, joints)
    calls = []
    real = TIO.load_npy_batch

    def counting(paths, shape, threads=8):
        calls.append(len(paths))
        return real(paths, shape, threads)

    monkeypatch.setattr(TP, "load_npy_batch", counting)
    names, proxies = TP.load_cached_proxies(str(tmp_path), 32, device="cpu")
    assert names == ["a", "b", "c"] and calls == [3, 3]
    assert proxies.shape == (3, 32, 32, 18) and proxies.dtype == torch.float32
