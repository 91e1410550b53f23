from .quality import lpips_fn, psnr, ssim  # noqa: F401
