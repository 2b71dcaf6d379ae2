"""The port's data-parallel building blocks (`straps_tpu_torch/parallel/`):
the collectives over two gloo ranks on the CPU, the mesh's checks, the
per-host shards of `epoch_batches` against the JAX function, and the
`SyntheticDraws` row slicing that a rank's share of the draws goes
through."""

import numpy as np
import pytest
import torch

from straps_tpu.data import SyntheticTrainingDataset as JaxDataset
from straps_tpu.data import epoch_batches as jax_epoch_batches
from straps_tpu_torch.config import TrainConfig
from straps_tpu_torch.data.dataset import SyntheticTrainingDataset, epoch_batches
from straps_tpu_torch.data.fixtures import write_synthetic_corpus
from straps_tpu_torch.parallel import DataMesh, launch, make_mesh, requested_devices, shard_batch
from straps_tpu_torch.parallel.dryrun import collectives_check
from straps_tpu_torch.train.synthetic import draw_synthetic, shard_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def two_ranks():
    return launch(collectives_check, 2, "cpu", timeout_s=120)


def test_all_reduce_sum_sums_forward_and_backward(two_ranks):
    """y = all_reduce(2x) over two ranks (x = 1 and 2): y = 6, and the
    backward pass sums the ranks' cotangents of y.sum(): x.grad = 4."""
    for r in two_ranks:
        np.testing.assert_array_equal(r["y"], np.full(3, 6.0, np.float32))
        np.testing.assert_array_equal(r["x_grad"], np.full(3, 4.0, np.float32))


def test_gather_replicate_and_sum_over_ranks(two_ranks):
    for rank, r in enumerate(two_ranks):
        assert (r["rank"], r["size"]) == (rank, 2)
        want_rows = np.concatenate([np.arange(6.0).reshape(3, 2) + 10.0 * k for k in range(2)])
        np.testing.assert_array_equal(r["gathered"]["rows"], want_rows.astype(np.float32))
        np.testing.assert_array_equal(r["gathered"]["ids"], np.float32([0, 0, 0, 1, 1, 1]))
        np.testing.assert_array_equal(r["shard"], np.arange(8)[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(r["weight"], np.zeros((2, 2), np.float32))
        np.testing.assert_array_equal(r["summed"][0], np.ones(2, np.float32))
        np.testing.assert_array_equal(r["summed"][1], np.full(3, 2.0, np.float32))
    # all_reduce_sum forward and backward, gather, 2 broadcasts (weight and
    # bias), all_reduce_, barrier.
    assert two_ranks[0]["collectives"] == two_ranks[1]["collectives"] == 7


def test_mesh_checks(monkeypatch):
    """Without a process group one device is no mesh, and more are refused;
    more CUDA devices than are visible are refused unless every rank shares
    one named card; a batch must split evenly."""
    assert make_mesh(0, "cpu") is None and make_mesh(1, "cpu") is None
    assert requested_devices(0, "cpu") == 1 and requested_devices(3, "cpu") == 3
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(2, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert requested_devices(0, "cuda") == 1
    with pytest.raises(ValueError, match="requested a 2-device mesh but only 1 device"):
        requested_devices(2, "cuda")
    assert requested_devices(2, "cuda:0") == 2
    mesh = DataMesh(rank=1, size=2, device=torch.device("cpu"))
    np.testing.assert_array_equal(shard_batch({"a": np.arange(6)}, mesh)["a"], [3, 4, 5])
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        shard_batch(np.arange(5), mesh)


def test_no_group_is_one_process_on_a_host_of_many_cards(monkeypatch):
    """Without a process group the default 0 (and 1) is this process alone,
    however many cards are visible (what 0 launches is the CLIs' call); a
    larger count needs its processes, and more cards than are visible are
    refused first."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert make_mesh(0, "cuda") is None and make_mesh(1, "cuda") is None
    assert requested_devices(0, "cuda") == 4
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(2, "cuda")
    with pytest.raises(ValueError, match="requested a 5-device mesh but only 4 device"):
        make_mesh(5, "cuda")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpora")
    return {n: str(write_synthetic_corpus(str(d / f"c{n}.npz"), n=n)) for n in (10, 11)}


@pytest.mark.parametrize("num_hosts", [1, 2, 3])
@pytest.mark.parametrize("n", [10, 11])
def test_host_shards_match_jax(corpora, n, num_hosts):
    """Every host's batches, shuffled and not, with and without the tail,
    equal the JAX function's; each host keeps n // num_hosts samples."""
    tds, jds = SyntheticTrainingDataset(corpora[n]), JaxDataset(corpora[n])
    kept = set()
    for host in range(num_hosts):
        for kw in ({}, {"shuffle": False, "drop_last": False}):
            got = list(epoch_batches(tds, 2, np.random.RandomState(host + 7), host_id=host,
                                     num_hosts=num_hosts, **kw))
            want = list(jax_epoch_batches(jds, 2, np.random.RandomState(host + 7),
                                          host_id=host, num_hosts=num_hosts, **kw))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for k in ("pose", "shape"):
                    np.testing.assert_array_equal(g[k], w[k])
        kept.add(sum(len(b["pose"]) for b in epoch_batches(
            tds, 1, np.random.RandomState(0), host_id=host, num_hosts=num_hosts)))
    assert kept == {n // num_hosts}


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_shard_draws_slices_the_batch_axis_of_every_field(rank):
    """`proxy.remove` is (n_classes, B): its rows are columns."""
    cfg = TrainConfig(img_wh=64, batch_size=9)
    draws = draw_synthetic(torch.Generator().manual_seed(3), 9, 40, cfg, "cpu")
    assert draws.proxy.remove.shape == (6, 9)         # six classes, nine rows
    part = shard_draws(draws, DataMesh(rank=rank, size=3, device=torch.device("cpu")))
    rows = slice(3 * rank, 3 * rank + 3)
    for name, whole, got in (list(zip(draws._fields[:-1], draws[:-1], part[:-1]))
                             + list(zip(draws.proxy._fields, draws.proxy, part.proxy))):
        want = whole[:, rows] if name == "remove" else whole[rows]
        assert torch.equal(got, want), name
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        shard_draws(draws, DataMesh(rank=0, size=4, device=torch.device("cpu")))
