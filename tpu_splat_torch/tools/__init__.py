"""Entry points above the Trainer, the counterparts of the repository's `tools/`:

- `eval_raytraced`: trains on the raytraced capture and prints PSNR/SSIM at its eval steps;
- `eval_mipnerf360`: the 7-scene MipNeRF360 protocol;
- `synth_capture`: the raytraced COLMAP capture (checkerboard ground, three spheres, sky)
  written with numpy and the port's PNG encoder (`tests/synth_data.py`'s counterpart).

Run the two scripts with `python -m tpu_splat_torch.tools.<name>`.
"""
