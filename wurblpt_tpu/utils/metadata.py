"""Render output metadata stamping + progress reporting.

The reference stamps every rendered image with CPU time, CPU model, compiler and
sampling parameters as TGD tags (``libwurblpt/wurblpt.hpp:393-435``) and
reports per-block progress to stderr (``:370-387``). The analog here: a
`RenderStats` record captured around a render call, written as PNG tEXt
chunks and/or a JSON sidecar next to the image, and a host-side progress
callback driven by the progressive pass loop
(:func:`wurblpt_tpu.render.integrator.render_frame_progressive`).
"""

from __future__ import annotations

import json
import os
import platform
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class RenderStats:
    """What the reference's TGD tags record (wurblpt.hpp:425-435), with the
    device in place of the CPU model."""

    samples_per_pixel: int = 0
    max_path_components: int = 0
    rr_threshold: float = 1.0
    width: int = 0
    height: int = 0
    wall_seconds: float = 0.0
    device: str = "unknown"
    backend: str = "unknown"
    jax_version: str = ""
    host: str = ""
    total_casts: int = 0           # closest + shadow casts (integrator stats)
    mrays_per_s: float = 0.0
    extra: Dict[str, str] = field(default_factory=dict)

    def as_tags(self) -> Dict[str, str]:
        d = asdict(self)
        extra = d.pop("extra")
        tags = {f"WURBLPT/{k.upper()}": str(v) for k, v in d.items()}
        for k, v in extra.items():
            tags[f"WURBLPT/{k.upper()}"] = str(v)
        return tags


def capture_env() -> Dict[str, str]:
    """Device/backend facts for stamping (the CPU-model/compiler analog).

    A backend that fails to initialize raises here: a stamp that says
    "unknown" would hide which device a number came from."""
    import jax

    dev = jax.devices()[0]
    return {"host": platform.node(), "jax_version": jax.__version__,
            "device": dev.device_kind, "backend": dev.platform}


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s "name, power.limit" line for the first card, the tag
    every GPU measurement carries (a card set below its top power limit runs
    slower under load). Raises if nvidia-smi is missing or fails."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class timed_render:
    """Context manager filling a RenderStats with wall time + environment.

    >>> with timed_render(spp=16, params=params, width=w, height=h) as st:
    ...     img, casts = render(...)
    ...     st.total_casts = int(casts[1])
    >>> save_png_with_metadata(path, img, st)
    """

    def __init__(self, spp=0, params=None, width=0, height=0, **extra):
        env = capture_env()
        self.stats = RenderStats(
            samples_per_pixel=spp,
            max_path_components=getattr(params, "max_path_components", 0),
            rr_threshold=getattr(params, "rr_threshold", 1.0),
            width=width, height=height,
            device=env["device"], backend=env["backend"],
            jax_version=env["jax_version"], host=env["host"],
            extra={k: str(v) for k, v in extra.items()},
        )

    def __enter__(self) -> RenderStats:
        self._t0 = time.perf_counter()
        return self.stats

    def __exit__(self, *exc):
        self.stats.wall_seconds = time.perf_counter() - self._t0
        if self.stats.total_casts and self.stats.wall_seconds > 0:
            self.stats.mrays_per_s = (
                self.stats.total_casts / self.stats.wall_seconds / 1e6)
        return False


def save_png_with_metadata(path: str, img, stats: Optional[RenderStats] = None,
                           tonemap: bool = True, sidecar: bool = True):
    """Tonemap + save PNG with WURBLPT/* tEXt chunks and a .json sidecar.

    The image file itself carries the provenance (like the reference's TGD
    tags), so every perf/quality claim about an artifact is self-documenting.
    """
    from PIL import Image
    from PIL.PngImagePlugin import PngInfo

    from . import postproc

    a = np.asarray(img)[..., :3]
    if tonemap:
        a = np.asarray(postproc.uniform_rational_quantization(a))
    a = np.asarray(postproc.to_srgb(np.clip(a, 0.0, 1.0)))
    pil = Image.fromarray((np.clip(a, 0, 1) * 255 + 0.5).astype(np.uint8))
    info = PngInfo()
    tags = stats.as_tags() if stats is not None else {}
    for k, v in tags.items():
        info.add_text(k, v)
    pil.save(path, pnginfo=info)
    if sidecar and stats is not None:
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump(asdict(stats), f, indent=1)
    return tags


def read_png_metadata(path: str) -> Dict[str, str]:
    from PIL import Image

    with Image.open(path) as im:
        return {k: v for k, v in (im.text or {}).items()
                if k.startswith("WURBLPT/")}
