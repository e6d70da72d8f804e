"""Data pipeline + native C++ components."""

import os
import tempfile

import numpy as np
import pytest

from occuseg.data.prepare import read_ply, prepare_scene
from occuseg.data.scannet import ScanNetData, elastic
from occuseg.data.supervoxel_gen import segment_supervoxels
from occuseg.native import have_native, voxelize_points_native


def _write_binary_ply(path, coords, colors):
    n = coords.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = coords.T
    rec["red"], rec["green"], rec["blue"] = colors.T
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def test_ply_reader_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 5, (100, 3)).astype(np.float32)
    colors = rng.integers(0, 255, (100, 3)).astype(np.uint8)
    p = str(tmp_path / "test.ply")
    _write_binary_ply(p, coords, colors)
    v = read_ply(p)
    np.testing.assert_allclose(v["x"], coords[:, 0], rtol=1e-6)
    np.testing.assert_array_equal(v["red"], colors[:, 0])


def test_prepare_scene_without_annotations(tmp_path):
    rng = np.random.default_rng(1)
    coords = rng.uniform(0, 3, (500, 3)).astype(np.float32)
    colors = rng.integers(0, 255, (500, 3)).astype(np.uint8)
    p = str(tmp_path / "scene0000_00_vh_clean_2.ply")
    _write_binary_ply(p, coords, colors)
    out = prepare_scene(p, str(tmp_path / "out"))
    z = np.load(out)
    assert z["coords"].shape == (500, 3)
    assert z["region"].shape == (500,)
    assert z["region"].min() >= 0


def test_native_library_builds():
    assert have_native(), "C++ native library failed to build"


def test_native_voxelizer_matches_numpy():
    rng = np.random.default_rng(2)
    coords = np.concatenate([
        rng.integers(0, 2, (1000, 1)),
        rng.integers(0, 10, (1000, 3))], axis=1).astype(np.int32)
    coords[995:] = -1
    p2v = voxelize_points_native(coords)
    assert p2v is not None
    # same-coordinate points share ids; ids dense in first-appearance order
    seen = {}
    for i in range(995):
        k = tuple(coords[i])
        if k in seen:
            assert p2v[i] == seen[k]
        else:
            assert p2v[i] == len(seen)
            seen[k] = p2v[i]
    assert np.all(p2v[995:] == -1)


def test_supervoxels_respect_surfaces():
    """Two parallel planes 0.5m apart must not share a supervoxel."""
    rng = np.random.default_rng(3)
    n = 2000
    p1 = np.stack([rng.uniform(0, 2, n), rng.uniform(0, 2, n),
                   np.zeros(n)], axis=1)
    p2 = p1.copy()
    p2[:, 2] = 0.5
    pts = np.concatenate([p1, p2]).astype(np.float32)
    labels = segment_supervoxels(pts, cell=0.1, k_thresh=0.5, min_size=10)
    assert labels.shape == (2 * n,)
    top = set(np.unique(labels[:n]))
    bottom = set(np.unique(labels[n:]))
    assert not (top & bottom), "supervoxels bled across disconnected surfaces"


def test_elastic_distortion_is_smooth():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 100, (500, 3))
    out = elastic(x, 6, 10, rng)
    assert out.shape == x.shape
    d = out - x
    assert np.abs(d).max() < 60
    # nearby points move together (smooth field)
    x2 = x + 0.5
    rng2 = np.random.default_rng(4)
    out2 = elastic(x2, 6, 10, rng2)
    # same seed, nearly same position -> nearly same displacement
    np.testing.assert_allclose(out2 - x2, d, atol=5.0)


def test_scannet_dataset_collate(tmp_path):
    rng = np.random.default_rng(5)
    for split in ("train", "val"):
        os.makedirs(tmp_path / split)
        for s in range(2):
            n = 800
            np.savez(tmp_path / split / f"scene{s}.npz",
                     coords=rng.uniform(0, 4, (n, 3)).astype(np.float32),
                     colors=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                     labels=rng.integers(0, 20, n).astype(np.int32),
                     instance_id=rng.integers(0, 5, n).astype(np.int32),
                     region=(np.arange(n) // 16).astype(np.int32))
    config = dict(data_dir=str(tmp_path), scale=50, full_scale=4096,
                  use_feature="c", val_reps=1, regress_sigma=0.2,
                  use_rotation_noise=False, use_elastic=False)
    ds = ScanNetData(config)
    ds.load_data()
    assert len(ds.train) == 2 and len(ds.val) == 2
    batches = list(ds.train_batches(rng, p_cap=4096, i_cap=16, batch_size=2))
    assert len(batches) == 1
    b = batches[0]
    assert b["coords"].shape == (4096, 4)
    n_real = int((b["labels"] >= 0).sum())
    assert 0 < n_real <= 1600
    assert b["features"].shape == (4096, 3)
    real = b["coords"][b["coords"][:, 0] >= 0]
    assert real[:, 1:].min() >= 0 and real[:, 1:].max() < 4096
    # instance GT: occupancy is log-size, constant within instance
    iid = b["instance_id"]
    for k in np.unique(iid[iid >= 0]):
        occ = b["occupancy"][iid == k, 0]
        assert np.allclose(occ, occ[0])
    vb = list(ds.val_batches(p_cap=4096, i_cap=16, batch_size=2))
    assert len(vb) == 1


def test_s3dis_room_prep(tmp_path):
    from occuseg.data.s3dis import prepare_room

    rng = np.random.default_rng(7)
    ann = tmp_path / "office_1" / "Annotations"
    os.makedirs(ann)
    for name, n in [("chair_1", 120), ("table_1", 150), ("clutter_3", 80)]:
        data = np.concatenate(
            [rng.uniform(0, 4, (n, 3)),
             rng.integers(0, 255, (n, 3))], axis=1)
        np.savetxt(ann / f"{name}.txt", data, fmt="%.3f")
    out = prepare_room(str(tmp_path / "office_1"), str(tmp_path / "out"))
    z = np.load(out)
    assert z["coords"].shape == (350, 3)
    assert set(np.unique(z["instance_id"])) == {0, 1, 2}
    assert z["labels"].min() >= 0 and z["region"].min() >= 0
