"""The plain reference on tiny scenes checked by hand."""

import math

import pytest
import torch

from cellbench import scene
from cellbench.reference import network, raster


def _rows(*splats):
    """rows (E, 6) [x, y, a, b, c, op] of isotropic unit splats."""
    return torch.tensor([[x, y, 1.0, 0.0, 1.0, op] for x, y, op in splats])


def test_blend_of_one_splat():
    rows = _rows((5.0, 7.0, 0.5))
    feats = torch.tensor([[1.0]])
    img, walked, live, tiles = raster.blend(
        rows, feats, torch.tensor([0]), 1, 1, torch.tensor([0.25]), None)
    assert img.shape == (1, 16, 16)
    assert img[0, 7, 5] == pytest.approx(0.5 + 0.5 * 0.25)
    a = 0.5 * math.exp(-0.5)
    assert img[0, 7, 6] == pytest.approx(a + (1 - a) * 0.25, rel=1e-6)
    assert img[0, 15, 15] == pytest.approx(0.25)  # alpha < 1/255
    assert tiles == 1 and walked == 256
    assert live == int((img[0] != 0.25).sum())


def test_front_to_back_and_the_stop_rule():
    rows = _rows((3.0, 3.0, 0.9), (3.0, 3.0, 0.99), (3.0, 3.0, 0.95))
    feats = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    img, walked, live, _ = raster.blend(
        rows, feats, torch.tensor([0, 0, 0]), 1, 1, torch.zeros(3), None)
    # T: 1 -> 0.1 -> 0.001; the third would take it to 5e-5 < 1e-4: stop
    assert img[:, 3, 3].tolist() == pytest.approx([0.9, 0.099, 0.0])
    assert walked >= 3 and live >= 2


def test_the_tile_budget_renders_the_busiest_tiles_only():
    rows = _rows((3.0, 3.0, 0.5), (20.0, 3.0, 0.5), (21.0, 3.0, 0.5))
    feats = torch.ones((3, 1))
    img, _, _, tiles = raster.blend(
        rows, feats, torch.tensor([0, 1, 1]), 2, 2, torch.zeros(1), 1)
    assert tiles == 1
    assert float(img[0, 3, 3]) == 0.0 and float(img[0, 3, 20]) > 0.5


def test_binning_caps_sorts_and_budgets():
    scr = {"depth": torch.tensor([2.0, 1.0, 3.0]),
           "valid": torch.tensor([True, True, False]),
           "rect": torch.tensor([[0, 0, 2, 2], [1, 0, 2, 1], [0, 0, 1, 1]])}
    gidx, tile, dropped = raster.binned(scr, 3, None, 4, grid_x=2)
    # splat 1 (nearer) first in tile 1; splat 0 keeps tiles 0, 1, 2 of 4
    assert tile.tolist() == [0, 1, 1, 2] and dropped == 1
    assert gidx.tolist() == [0, 1, 0, 0]
    _, tile, dropped = raster.binned(scr, 3, 1, 2, grid_x=2)
    assert tile.tolist() == [0, 1] and dropped == 3


def test_a_point_on_the_axis_projects_to_the_centre():
    pose = torch.as_tensor(scene.ring_poses(torch.zeros(1).numpy(), 1,
                                            3.0)[0, 0])
    sp = {"means": torch.zeros((1, 3)), "scales": torch.full((1, 3), 0.01),
          "rotation": torch.tensor([[1.0, 0, 0, 0]]),
          "opacity": torch.ones(1), "valid": torch.ones(1, dtype=torch.bool)}
    scr = raster.project(sp, pose, 45.0, 64, 64, False)
    assert scr["mean2d"][0].tolist() == pytest.approx([31.5, 31.5], abs=1e-4)
    assert float(scr["depth"][0]) == pytest.approx(3.0, rel=1e-6)
    assert bool(scr["valid"][0])


def test_ring_poses_are_rigid_and_look_at_the_origin():
    poses = scene.ring_poses(torch.tensor([0.3, 1.7]).numpy(), 5, 3.0)
    for p in poses.reshape(-1, 4, 4):
        r = torch.as_tensor(p[:3, :3], dtype=torch.float64)
        assert torch.allclose(r @ r.T, torch.eye(3, dtype=torch.float64),
                              atol=1e-6)
        assert float(torch.det(r)) == pytest.approx(1.0, abs=1e-6)
        t = torch.as_tensor(p[:3, 3], dtype=torch.float64)
        assert torch.allclose(r[:, 2], -t / 3.0, atol=1e-6)


def test_voxelize_averages_duplicates_in_order():
    coords = torch.tensor([[2.2, 0.0, 0.0], [1.9, 0.1, 0.0], [0.4, 0.0, 5.0]])
    feats = torch.tensor([[1.0], [3.0], [7.0]])
    vox, f = network.voxelize(coords, feats)
    assert vox.tolist() == [[0, 0, 5], [2, 0, 0]]
    assert f[:, 0].tolist() == [7.0, 2.0]


def test_kernel_map_offsets_are_first_axis_fastest():
    # voxels in ascending (x, y, z) order, as every level keeps them
    lvl = network.Level(torch.tensor([[0, 0, 0], [0, 1, 0], [1, 0, 0]]))
    # offset index ix + 3 iy + 9 iz, each in (-1, 0, +1)
    rows, nbr = lvl.pairs[2 + 3 * 1 + 9 * 1]  # (+1, 0, 0)
    assert rows.tolist() == [0] and nbr.tolist() == [2]
    rows, nbr = lvl.pairs[1 + 3 * 2 + 9 * 1]  # (0, +1, 0)
    assert rows.tolist() == [0] and nbr.tolist() == [1]
    rows, nbr = lvl.pairs[0 + 3 * 1 + 9 * 1]  # (-1, 0, 0)
    assert rows.tolist() == [2] and nbr.tolist() == [0]
    rows, nbr = lvl.pairs[13]
    assert rows.tolist() == nbr.tolist() == [0, 1, 2]
    # centre 3, +-x 2, +-y 2, and (+1, -1, 0) / (-1, +1, 0) between 1 and 2
    assert lvl.hits == 3 + 2 + 2 + 2
    assert lvl.hits == 3 + 2 + 2 + 2  # centre, +-x, +-y, (-1, +1, 0)...


def test_one_conv_by_hand():
    lvl = network.Level(torch.tensor([[0, 0, 0], [1, 0, 0]]))
    w = torch.zeros((27, 1, 1))
    w[13] = 2.0  # centre
    w[2 + 3 + 9] = 10.0  # +x neighbour
    net = network.UNet({"c.kernel": w, "c.bias": torch.tensor([0.5])},
                       [lvl], [])
    out = net.conv3("c", torch.tensor([[1.0], [3.0]]), 0)
    assert out[:, 0].tolist() == [2 + 30 + 0.5, 6 + 0.5]
    assert net.flops == 2 * 4  # pairs: 2 centres, +x of 0, -x of 1


def test_weights_are_seeded_and_shaped():
    ch = [9, 8, 8, 8, 8, 8]
    a = network.make_weights(ch, 13, scene.generator(5, 2, "cpu"), "cpu")
    b = network.make_weights(ch, 13, scene.generator(5, 2, "cpu"), "cpu")
    c = network.make_weights(ch, 13, scene.generator(6, 2, "cpu"), "cpu")
    assert a["conv0.kernel"].shape == (27, 9, 8)
    assert a["conv_3.kernel"].shape == (27, 8, 13)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv0.kernel"], c["conv0.kernel"])
