"""Evaluation metrics: PSNR, SSIM, LPIPS and the evaluator's CSV (port of
`tpu_splat/training/metrics.py`).

PSNR and SSIM run on the render's device (SSIM through `ops/ssim.py`, the training
loss's). LPIPS needs VGG weights, which the repository does not ship (reference:
`weights/lpips_vgg.pt`, metrics.hpp:54-67): `LPIPSModel` reads the .npz beside that path
first (`training/lpips.py`, on the render's device), then the reference's TorchScript
file; with neither, LPIPS is None and its CSV column stays empty, as in the JAX package.
A weights file that exists but does not load raises: the JAX package's silent fallback to
None is not copied. The evaluator walks the val split, renders, and writes metrics.csv
and side-by-side images, like MetricsEvaluator::evaluate (metrics.cpp:389+).
"""

from __future__ import annotations

import csv
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.ssim import ssim as ssim_fn
from .lpips import LPIPSTorch


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(1.0 / torch.clamp_min(mse, 1e-12))


class LPIPSModel:
    """LPIPS from `weights_path`'s .npz (the JAX package's weights, `lpips.LPIPSTorch`),
    else from the TorchScript file at `weights_path`, else unavailable."""

    def __init__(self, weights_path: str | Path = "weights/lpips_vgg.pt",
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self._npz = LPIPSTorch(Path(weights_path).with_suffix(".npz"), self.device)
        self._model = None
        p = Path(weights_path)
        if not self._npz.available and p.exists():
            self._model = torch.jit.load(str(p), map_location=self.device).eval()

    @property
    def available(self) -> bool:
        return self._npz.available or self._model is not None

    @torch.no_grad()
    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> Optional[float]:
        """a, b [3,H,W] in [0,1] on the model's device."""
        if self._npz.available:
            return self._npz(a, b)
        if self._model is None:
            return None
        return float(self._model(a[None], b[None]).item())


@dataclass
class EvalResult:
    iteration: int
    psnr: float
    ssim: float
    lpips: Optional[float]
    num_images: int
    elapsed_s: float
    per_image: list[dict] = field(default_factory=list)


class MetricsEvaluator:
    def __init__(self, output_path: str | Path, lpips_weights: str = "weights/lpips_vgg.pt",
                 device: str | torch.device | None = None):
        self.output_path = Path(output_path)
        self.lpips = LPIPSModel(lpips_weights, device)
        self.results: list[EvalResult] = []

    def evaluate(self, iteration: int, render_fn, val_samples,
                 save_images: bool = False) -> EvalResult:
        """render_fn(sample) -> image tensor [3,H,W]; val_samples yields CameraSample."""
        t0 = time.time()
        rows = []
        psnrs, ssims, lpipss = [], [], []
        img_dir = self.output_path / f"eval_step_{iteration}"
        if save_images:
            img_dir.mkdir(parents=True, exist_ok=True)
        for sample in val_samples:
            with torch.no_grad():
                rendered = torch.clamp(render_fn(sample), 0.0, 1.0)
                gt = torch.as_tensor(sample.image, device=rendered.device)
                p = float(psnr(rendered, gt))
                s = float(ssim_fn(rendered, gt))
                lp = self.lpips(rendered, gt) if self.lpips.available else None
            psnrs.append(p)
            ssims.append(s)
            if lp is not None:
                lpipss.append(lp)
            rows.append({"image": sample.camera.image_name, "psnr": p, "ssim": s,
                         "lpips": lp})
            if save_images:
                from ..io.image import save_image
                from ..utils.async_io import writer

                side = np.concatenate([rendered.cpu().numpy(), gt.cpu().numpy()], axis=2)
                writer().submit(
                    save_image,
                    str(img_dir / f"{Path(sample.camera.image_name).stem}.png"), side,
                )

        result = EvalResult(
            iteration=iteration,
            psnr=float(np.mean(psnrs)) if psnrs else 0.0,
            ssim=float(np.mean(ssims)) if ssims else 0.0,
            lpips=float(np.mean(lpipss)) if lpipss else None,
            num_images=len(psnrs),
            elapsed_s=time.time() - t0,
            per_image=rows,
        )
        self.results.append(result)
        return result

    def save_report(self) -> None:
        self.output_path.mkdir(parents=True, exist_ok=True)
        with open(self.output_path / "metrics.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["iteration", "psnr", "ssim", "lpips", "num_images", "elapsed_s"])
            for r in self.results:
                w.writerow([r.iteration, f"{r.psnr:.4f}", f"{r.ssim:.4f}",
                            "" if r.lpips is None else f"{r.lpips:.4f}",
                            r.num_images, f"{r.elapsed_s:.1f}"])
