"""The port's kd-tree (``torch_robotics_tpu_torch/native``) against brute
force, as tests/test_native_kdtree.py holds the JAX package's, and against
the JAX package's ``KdTree`` index for index on the same inserts and
queries; a build without g++ raises (the port has no numpy fallback)."""
import numpy as np
import pytest

from torch_robotics_tpu.native import KdTree as JKdTree
from torch_robotics_tpu_torch import native
from torch_robotics_tpu_torch.native import KdTree


def brute_nearest(pts, q):
    return int(np.argmin(np.linalg.norm(np.asarray(pts) - q, axis=-1)))


@pytest.mark.parametrize("dim", [2, 7])
def test_kdtree_matches_brute_force(dim):
    rng = np.random.RandomState(0)
    tree = KdTree(dim)
    pts = []
    for i in range(2000):
        p = rng.uniform(-3, 3, dim).astype(np.float32)
        assert tree.insert(p) == i
        pts.append(p)
        if i % 100 == 0:
            q = rng.uniform(-3, 3, dim).astype(np.float32)
            i_tree = tree.nearest(q)
            d_tree = np.linalg.norm(pts[i_tree] - q)
            d_ref = np.linalg.norm(pts[brute_nearest(pts, q)] - q)
            np.testing.assert_allclose(d_tree, d_ref, rtol=1e-6)
    assert len(tree) == 2000
    np.testing.assert_array_equal(tree.get_point(5), pts[5])


def test_kdtree_matches_the_jax_package_index_for_index():
    """Same inserts, same queries (every 7th insert, past several
    rebuilds): the same nearest index every time, the same stored points."""
    rng = np.random.RandomState(3)
    ours, theirs = KdTree(4), JKdTree(4)
    for i in range(1500):
        p = rng.uniform(-1, 1, 4).astype(np.float32)
        assert ours.insert(p) == theirs.insert(p) == i
        if i % 7 == 0:
            q = rng.uniform(-1.2, 1.2, 4).astype(np.float32)
            assert ours.nearest(q) == theirs.nearest(q)
    assert len(ours) == len(theirs) == 1500
    for i in (0, 17, 1499):
        np.testing.assert_array_equal(ours.get_point(i), theirs.get_point(i))


def test_build_without_gxx_raises(tmp_path, monkeypatch):
    """No library in the build directory and no g++ on PATH: RuntimeError,
    never a fallback."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        KdTree(3)
    assert not (tmp_path / "_build").exists()


def test_failed_build_raises_with_the_compiler_message(tmp_path,
                                                       monkeypatch):
    """A g++ that fails: RuntimeError carrying its output."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'kdtree.cpp:1: error: stand-in' >&2\n"
                   "exit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(bin_dir))
    with pytest.raises(RuntimeError, match="error: stand-in"):
        KdTree(3)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_library_is_built_into_the_build_dir_by_source_hash(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    lib = native.kdtree_library()
    built = sorted((tmp_path / "_build").iterdir())
    assert [p.name for p in built] == [native._library_path(
        tmp_path / "_build").name]
    assert built[0].name.startswith("kdtree-") and built[0].suffix == ".so"
    assert native.kdtree_library() is lib
    assert not (native._SRC.parent / "_kdtree.so").exists()
