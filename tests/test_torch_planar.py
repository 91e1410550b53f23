"""PyTorch port vs JAX: the planar 2D stack (geometry/warp2d.py,
models/planar.py, train/planar_trainer.py, the planar CLI) and the
pieces it adds to shared modules (ops/sampling.sample_image,
ops/blur.blur_matrix's zero padding, Adam on complex leaves).

* the four warp types, warped grids (atol 1e-6) and the gradient of a
  weighted sum to the warp (rtol 1e-4; the homography's matrix
  exponential is torch.linalg.matrix_exp against jax.scipy.linalg.expm,
  two algorithms that agree to float32 rounding);
* check_corners_in_range on 200 warps of each type, equal decisions;
* sample_image bilinear and nearest, values and gradients to the image
  and to the coordinates (atol 1e-5), coordinates past the border too;
* blur_matrix with zero padding (exact);
* the SVD image (both interp_before_product branches, bilinear and
  nearest, blurred, rank-masked), the FFT image (blurred, rank-masked)
  and the MLP image (c2f), and svd_tv_loss / fft_parseval_loss: forward
  (atol 1e-5) and gradients (within 1e-4 of each leaf's max; for complex
  leaves the real parts, since torch's gradient is the conjugate of
  JAX's);
* Adam on a complex leaf: the imaginary part dropped, as JAX's astype
  drops it (1+2j with gradient 0.5+0.5j -> 0.9+0j at lr 0.1);
* the perturbations equal to JAX's bit for bit, and the warped GT
  patches within 1e-5 (the two matrix exponentials), at the test's seed
  and at each full config's seed;
* 10 trainer steps of each planar model from JAX's initial image, loss
  at rtol 1e-4 and every parameter after each step within 1e-5 (an Adam
  step moves a leaf by about lr = 1e-3), the warp_error; the first warp
  stays exactly zero;
* load_image checks the file before importing imageio (JAX imports
  first and raises without imageio even where the file is absent);
* the planar CLI's log.jsonl and quant.json for the three configs.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_barf import carry, jax_state  # noqa: F401
from test_torch_eval import one_torch_thread  # noqa: F401

from joint_tensorf_tpu.config import set_options as jset_options
from joint_tensorf_tpu.geometry import warp2d as jwarp
from joint_tensorf_tpu.models import planar as jplanar
from joint_tensorf_tpu.ops import blur as jblur
from joint_tensorf_tpu.ops.kernels import gaussian_kernel as jgauss
from joint_tensorf_tpu.ops.sampling import sample_image as jsample_image
from joint_tensorf_tpu.train import planar_trainer as jpt
from joint_tensorf_tpu.train.optim import adam_init as jadam_init
from joint_tensorf_tpu.train.optim import adam_update as jadam_update
from joint_tensorf_tpu_torch import planar as planar_cli
from joint_tensorf_tpu_torch.config import set_options
from joint_tensorf_tpu_torch.convert import simple_to_numpy
from joint_tensorf_tpu_torch.geometry import warp2d
from joint_tensorf_tpu_torch.models import planar
from joint_tensorf_tpu_torch.ops import blur
from joint_tensorf_tpu_torch.ops.kernels import gaussian_kernel
from joint_tensorf_tpu_torch.ops.sampling import sample_image
from joint_tensorf_tpu_torch.train import planar_trainer
from joint_tensorf_tpu_torch.train.optim import adam_init, adam_update
from joint_tensorf_tpu_torch.utils import setup_torch, tree

setup_torch()

CFGS = {"planar_svd": "configs/planar_bat.yaml",
        "planar_fft": "configs/planar_fft.yaml",
        "planar": "configs/planar_barf.yaml"}
SMALL = ["--max_iter=40", "--batch_size=3", "--data.image_size=[24,32]",
         "--data.patch_crop=[12,12]", "--warp.noise_h=0.05",
         "--warp.noise_t=0.1", "--freq.scalar=5"]
MODEL_ARGS = {
    "planar_svd": ["--arch.resolution=[32,32]", "--arch.max_ranks=12",
                   "--arch.kernel_size=16", "--c2f_schedule.rank=[4,12]",
                   "--c2f_schedule.kernel_t=[8,4,0,0]"],
    "planar_fft": ["--arch.resolution=[24,24]", "--arch.kernel_size=8",
                   "--c2f_schedule.rank=[2,4]",
                   "--c2f_schedule.kernel_t=[4,2,0,0]"],
    "planar": ["--arch.layers=[null,32,32,3]", "--arch.posenc.L_2D=4",
               "--barf_c2f=[0.1,0.5]"]}
WARPS = {"translation": 2, "rotation": 1, "rigid": 3, "homography": 8}


def _rel_close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3g} > {rel} x {scale:.3g}"


# ---------------------------------------------------------------- warps
@pytest.mark.parametrize("warp_type", list(WARPS))
def test_warp_grid(warp_type):
    rng = np.random.default_rng(1)
    dof = WARPS[warp_type]
    grid = np.asarray(jwarp.normalized_pixel_grid_crop(24, 32, 12, 12))
    np.testing.assert_array_equal(
        warp2d.normalized_pixel_grid_crop(24, 32, 12, 12).numpy(), grid)
    np.testing.assert_array_equal(warp2d.normalized_pixel_grid(24, 32).numpy(),
                                  np.asarray(jwarp.normalized_pixel_grid(24, 32)))
    g = np.broadcast_to(grid, (3,) + grid.shape).copy()
    w = (rng.normal(size=(3, dof)) * 0.1).astype(np.float32)
    cot = rng.normal(size=g.shape).astype(np.float32)

    def jf(w):
        out = jwarp.warp_grid(jnp.asarray(g), w, warp_type)
        return jnp.sum(out * cot), out

    (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(w))
    tw = torch.as_tensor(w).requires_grad_(True)
    out = warp2d.warp_grid(torch.as_tensor(g), tw, warp_type)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    tg, = torch.autograd.grad(torch.sum(out * torch.as_tensor(cot)), [tw])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("warp_type", list(WARPS))
def test_check_corners_in_range(warp_type):
    rng = np.random.default_rng(2)
    hits = 0
    for _ in range(200):
        p = (rng.normal(size=WARPS[warp_type])
             * rng.uniform(0.05, 1.0)).astype(np.float32)
        want = jwarp.check_corners_in_range(jnp.asarray(p)[None], warp_type,
                                            36, 48, 30, 30)
        got = warp2d.check_corners_in_range(torch.as_tensor(p)[None],
                                            warp_type, 36, 48, 30, 30)
        assert got == want
        hits += want
    assert 0 < hits < 200


# ------------------------------------------------------- image sampling
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_sample_image(mode):
    rng = np.random.default_rng(3)
    img = rng.normal(size=(3, 9, 13)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (200, 2)).astype(np.float32)
    cot = rng.normal(size=(200, 3)).astype(np.float32)

    def jf(img, c):
        out = jsample_image(img, c, mode=mode)
        return jnp.sum(out * cot), out

    (_, jout), (jgi, jgc) = jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(img), jnp.asarray(coords))
    ti = torch.as_tensor(img).requires_grad_(True)
    tc = torch.as_tensor(coords).requires_grad_(True)
    out = sample_image(ti, tc, mode=mode)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    gi, gc = torch.autograd.grad(torch.sum(out * torch.as_tensor(cot)),
                                 [ti, tc], allow_unused=True)
    np.testing.assert_allclose(gi.numpy(), np.asarray(jgi), atol=1e-5)
    # nearest: no gradient reaches the coordinates (JAX's is zeros)
    gc = torch.zeros_like(tc) if gc is None else gc
    np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), atol=1e-4)


def test_blur_matrix_zero_padding():
    k = jgauss(jnp.float32(2.5), 8)
    want = jblur.blur_matrix(k, 20, padding="zero")
    got = blur.blur_matrix(gaussian_kernel(2.5, 8), 20, padding="zero")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # replicate stays the default
    np.testing.assert_array_equal(
        blur.blur_matrix(gaussian_kernel(2.5, 8), 20).numpy(),
        np.asarray(jblur.blur_matrix(k, 20)))


# ------------------------------------------------------------- images
def _image_case(kind):
    rng = np.random.default_rng(4)
    coords = rng.uniform(-1.1, 1.1, (2, 60, 2)).astype(np.float32)
    if kind.startswith("svd"):
        p = {"rank1": rng.normal(size=(3, 6, 20)) * 0.3,
             "rank2": rng.normal(size=(3, 6, 16)) * 0.3}
        p = {k: v.astype(np.float32) for k, v in p.items()}
    elif kind == "fft":
        p = {k: (rng.normal(size=s) + 1j * rng.normal(size=s)).astype(
            np.complex64) * 0.1 for k, s in (("rank1", (3, 4, 20)),
                                             ("rank2", (3, 4, 20)))}
    else:
        jp = jplanar.init_mlp_image(jax.random.PRNGKey(5), [16, 16, 3], 3,
                                    skip=(1,), barf_c2f=(0.1, 0.5))
        p = [{k: np.asarray(v) for k, v in layer.items()} for layer in jp]
    return p, coords


def _j_image(kind, p, coords, tv):
    if kind.startswith("svd"):
        interp, mode = kind.split("_")[1:]
        k = jgauss(jnp.float32(1.5), 6)
        out = jplanar.svd_image_forward(p, coords, kernel=k, cur_rank=4,
                                        interp_before_product=interp == "ip",
                                        mode=mode)
        reg = jplanar.svd_tv_loss(p, 6) if tv else 0.0
    elif kind == "fft":
        out = jplanar.fft_image_forward(p, coords, cur_rank=3,
                                        kernel=jgauss(jnp.float32(1.5), 6))
        reg = jplanar.fft_parseval_loss(p) if tv else 0.0
    else:
        out = jplanar.mlp_image_forward(p, coords, 3, skip=(1,),
                                        barf_c2f=(0.1, 0.5),
                                        progress=jnp.float32(0.3))
        reg = 0.0
    return out, reg


def _t_image(kind, p, coords, tv):
    if kind.startswith("svd"):
        interp, mode = kind.split("_")[1:]
        out = planar.svd_image_forward(p, coords, kernel=gaussian_kernel(
            1.5, 6), cur_rank=4, interp_before_product=interp == "ip",
            mode=mode)
        reg = planar.svd_tv_loss(p, 6) if tv else 0.0
    elif kind == "fft":
        out = planar.fft_image_forward(p, coords, cur_rank=3,
                                       kernel=gaussian_kernel(1.5, 6))
        reg = planar.fft_parseval_loss(p) if tv else 0.0
    else:
        out = planar.mlp_image_forward(p, coords, 3, skip=(1,),
                                       barf_c2f=(0.1, 0.5), progress=0.3)
        reg = 0.0
    return out, reg


@pytest.mark.parametrize("kind", ["svd_ip_bilinear", "svd_ip_nearest",
                                  "svd_img_bilinear", "svd_img_nearest",
                                  "fft", "mlp"])
def test_planar_images(kind):
    p, coords = _image_case(kind)
    cot = np.random.default_rng(6).normal(size=(2, 60, 3)).astype(np.float32)

    def jf(p):
        out, reg = _j_image(kind, p, jnp.asarray(coords), True)
        return jnp.sum(out * cot) + 0.3 * reg, (out, reg)

    (_, (jout, jreg)), jg = jax.value_and_grad(jf, has_aux=True)(
        jax.tree.map(jnp.asarray, p))
    flat = {k: torch.as_tensor(np.array(v)).requires_grad_(True)
            for k, v in tree.flatten(p).items()}
    out, reg = _t_image(kind, tree.unflatten(flat), torch.as_tensor(coords),
                        True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    np.testing.assert_allclose(float(torch.as_tensor(reg).detach()),
                               float(jreg), rtol=1e-5)
    loss = torch.sum(out * torch.as_tensor(cot)) + 0.3 * reg
    names = list(flat)
    want = tree.flatten(jax.tree.map(np.asarray, jg))
    for k, g in zip(names, torch.autograd.grad(loss,
                                               [flat[k] for k in names])):
        _rel_close(np.real(g.numpy()), np.real(want[k]), 1e-4, k)


def test_parseval_gradient_is_zero_at_zero():
    z = {k: torch.zeros((3, 4, 20), dtype=torch.complex64,
                        requires_grad=True) for k in ("rank1", "rank2")}
    g = torch.autograd.grad(planar.fft_parseval_loss(z), list(z.values()))
    assert all(torch.equal(x, torch.zeros_like(x)) for x in g)


def test_adam_complex_leaf_keeps_real_part():
    jp = {"a": jnp.asarray([1 + 2j], jnp.complex64)}
    jg = {"a": jnp.asarray([0.5 + 0.5j], jnp.complex64)}
    want, _ = jadam_update(jg, jadam_init(jp), jp, 0.1)
    p = {"a": torch.tensor([1 + 2j], dtype=torch.complex64)}
    # torch's gradient of a real loss is the conjugate of JAX's
    got, st = adam_update({"a": torch.tensor([0.5 - 0.5j],
                                             dtype=torch.complex64)},
                          adam_init(p), p, 0.1)
    assert got["a"].dtype == torch.complex64 and st.mu["a"].dtype == \
        torch.float32
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6)
    assert float(got["a"].imag[0]) == 0.0


# ------------------------------------------------------------- trainer
def _opts(model, extra=()):
    args = SMALL + MODEL_ARGS[model] + list(extra)
    return jset_options(CFGS[model], args), set_options(CFGS[model], args)


@pytest.mark.parametrize("model,extra", [
    ("planar_svd", SMALL), ("planar_fft", SMALL), ("planar", SMALL),
    ("planar_svd", []), ("planar_fft", []), ("planar", [])])
def test_perturbations_and_patches(model, extra):
    """At the test's sizes, and at each config's own sizes and seed."""
    args = list(extra) + (MODEL_ARGS[model] if extra else [])
    jt = jpt.PlanarTrainer(jset_options(CFGS[model], args))
    pt = planar_trainer.PlanarTrainer(set_options(CFGS[model], args),
                                      device="cpu")
    np.testing.assert_array_equal(pt.image_raw.numpy(),
                                  np.asarray(jt.image_raw))
    np.testing.assert_array_equal(pt.warp_pert.numpy(),
                                  np.asarray(jt.warp_pert))
    np.testing.assert_allclose(pt.image_pert.numpy(),
                               np.asarray(jt.image_pert), atol=1e-5)
    assert pt.rng_np.bit_generator.state == jt.rng_np.bit_generator.state


@pytest.mark.parametrize("model", list(CFGS))
def test_planar_trainer_steps_match_jax(model):
    jopt, opt = _opts(model, ["--max_iter=10"])
    jt = jpt.PlanarTrainer(jopt)
    pt = planar_trainer.PlanarTrainer(opt, device="cpu")
    carry(jt, pt)
    for _ in range(10):
        jm = jt.train_iteration()
        pm = pt.train_iteration()
        for k in ("loss", "mse", "sigma", "rank"):
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
        jt.it += 1
        pt.it += 1
        want = tree.flatten(jax_state(jt)["params"])
        got = tree.flatten(simple_to_numpy(pt.params, pt.opt_state)["params"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        assert np.all(got["warp"][0] == 0)
    np.testing.assert_allclose(pt.warp_error(), jt.warp_error(), rtol=1e-4)
    np.testing.assert_allclose(pt.predict_entire_image(),
                               jt.predict_entire_image(), atol=1e-4)
    if model == "planar_fft":     # the coefficients stay real in both
        assert float(np.abs(np.imag(got["image.rank1"])).max()) == 0.0
        assert float(np.abs(np.real(got["image.rank1"])).max()) > 0.0


def test_load_image_checks_the_file_before_imageio(monkeypatch):
    jopt, opt = _opts("planar")
    assert not os.path.exists(opt.data.image_fname)
    want = jpt._load_image(jopt)              # imageio imports here
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    np.testing.assert_array_equal(planar_trainer.load_image(opt), want)
    with pytest.raises(ImportError):
        jpt._load_image(jopt)


# ------------------------------------------------------------- the CLI
@pytest.mark.parametrize("model", list(CFGS))
def test_planar_cli_writes_its_outputs(tmp_path, model):
    result = planar_cli.main([f"--yaml={CFGS[model]}", "--device=cpu",
                              f"--output_root={tmp_path}"]
                             + SMALL + MODEL_ARGS[model] + ["--max_iter=10"])
    name = set_options(CFGS[model], []).name
    out = os.path.join(str(tmp_path), "default", name)
    with open(os.path.join(out, "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["it"] for r in rows] == [0, 5]
    assert all(np.isfinite(r["warp_error"]) for r in rows)
    with open(os.path.join(out, "quant.json")) as f:
        quant = json.load(f)
    assert quant == result and quant["iters"] == 10
    assert np.isfinite(quant["warp_error"]) and np.isfinite(quant["psnr"])
