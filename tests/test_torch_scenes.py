"""PyTorch port vs JAX: the synthetic scene kinds.

For solids / facing / parallax (and the blobs), the port's make_scene
against JAX's make_scene at 16x16, 3 views: poses and intrinsics equal,
images within 1e-5 (float32 quadrature sums in another order).  JAX's
scene cache points at tmp_path, and its render pads each chunk to 256 rays
instead of 65536 (the padding changes no ray's value, only the time).
The loader maps names outside the four kinds (a Blender scene inherited
from a parent config) to the blobs, as JAX's does, and every scene keeps
the caller's near/far.
"""
import functools

import numpy as np
import pytest

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.data import synthetic as jsynthetic
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.data import synthetic


@pytest.fixture
def jax_scene(tmp_path, monkeypatch):
    monkeypatch.setenv("JTF_SCENE_CACHE", str(tmp_path))
    monkeypatch.setattr(jsynthetic, "render_analytic", functools.partial(
        jsynthetic.render_analytic, chunk=256))
    return jsynthetic.make_scene


@pytest.mark.parametrize("kind", ["solids", "facing", "parallax", "blobs"])
def test_scene_kind_matches_jax(jax_scene, kind):
    want = jax_scene(n_views=3, H=16, W=16, seed=0, kind=kind)
    got = synthetic.make_scene(n_views=3, H=16, W=16, seed=0, kind=kind,
                               device="cpu")
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.intr, want.intr)
    np.testing.assert_array_equal(got.intr_inv, want.intr_inv)
    assert got.near_far == want.near_far == (2.0, 6.0)
    assert got.images.dtype == np.float32
    np.testing.assert_allclose(got.images, want.images, atol=1e-5)
    # a scene with content: not a blank (white) image
    assert got.images.min() < 0.9


@pytest.mark.parametrize("scene,split", [("solids", "val"), ("lego", "train")])
def test_load_matches_jax(jax_scene, scene, split):
    args = ["--data.dataset=synthetic", f"--data.scene={scene}",
            "--data.image_size=[12,12]", "--data.n_views=3",
            "--data.val_sub=2", "--nerf.depth.range=[2.5,5.5]"]
    want = jsynthetic.load(jset_options("configs/bat_blender_VM.yaml", args),
                           split)
    got = synthetic.load(set_options("configs/bat_blender_VM.yaml", args),
                         split, device="cpu")
    assert got.n_views == want.n_views
    assert got.near_far == want.near_far == (2.5, 5.5)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_allclose(got.images, want.images, atol=1e-5)
