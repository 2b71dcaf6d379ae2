"""The frozen yardsticks against hand counts."""

import pytest
import torch

from portbench import counters


def test_resnet18_macs_match_the_hand_count():
    parts = counters.regressor_macs(18, 18, 256)
    assert parts["stem"] == 18 * 64 * 7 * 7 * 128 * 128 == 924_844_032
    assert parts["layer1"] == 4 * 64 * 64 * 9 * 64 * 64 == 603_979_776
    for stage in ("layer2", "layer3", "layer4"):
        assert parts[stage] == pytest.approx(536.9e6, rel=1e-3)
    assert parts["ief"] == 3 * ((512 + 157) * 512 + 512 * 512 + 512 * 157)
    total = sum(parts.values())
    assert total == pytest.approx(3.14e9, rel=2e-3)
    assert counters.regressor_flops(18, 18, 256) == 2 * total
    assert counters.regressor_flops(18, 18, 256, train=True) == 6 * total


def test_resnet50_macs_follow_torchvision_widths():
    # torchvision's ResNet-50 at 224 px, 3 channels: 4.09 GMAC without its
    # classifier (4.11 with the 2048 x 1000 head).
    parts = counters.regressor_macs(50, 3, 224)
    body = sum(v for k, v in parts.items() if k != "ief")
    assert body == pytest.approx(4.089e9, rel=2e-3)


def _planes_of(tris):
    """(1, F, 12) planes of screen-space triangles, counter-clockwise."""
    rows = []
    for (x0, y0), (x1, y1), (x2, y2) in tris:
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        s = 1.0 if area > 0 else -1.0

        def edge(ax, ay, bx, by):
            return [-(by - ay) * s, (bx - ax) * s, (ax * (by - ay) - ay * (bx - ax)) * s]

        rows.append(edge(x0, y0, x1, y1) + edge(x1, y1, x2, y2) + edge(x2, y2, x0, y0)
                    + [0.0, 0.0, 5.0])
    return torch.tensor([rows], dtype=torch.float32)


def test_bbox_pairs_count_pixel_centres_by_hand():
    # Triangle (1, 1), (4.2, 1), (1, 3.7): x in [1, 4.2] holds centres 1.5,
    # 2.5, 3.5; y in [1, 3.7] holds 1.5, 2.5, 3.5: 9 pairs.  A triangle
    # hanging over the left edge, (-3, 0.2)..(0.7, 0.2)..(-3, 1.9): centre
    # 0.5 in x, 0.5 and 1.5 in y: 2 pairs.  A killed face: none.
    planes = _planes_of([((1, 1), (4.2, 1), (1, 3.7)), ((-3, 0.2), (0.7, 0.2), (-3, 1.9))])
    kill = torch.tensor([[[0.0, 0.0, -1.0] * 3 + [0.0, 0.0, 0.0]]])
    planes = torch.cat([planes, kill], dim=1)
    assert counters.bbox_pixel_faces(planes, 8, 8) == 9 + 2


def test_least_time_counts_bytes_once_and_names_its_bound():
    planes = _planes_of([((1, 1), (4.2, 1), (1, 3.7))])
    t, side, nbytes, ops = counters.raster_least_time_s(planes, 2, 4, 8, 8, 4)
    assert nbytes == 12 * 4 + 2 * 4 + 4 + 8 * 8 * 4
    assert ops == 6 * 9
    assert side == "bytes" and t == nbytes / counters.HBM_BYTES_S
