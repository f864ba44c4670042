"""Color science: CIE color matching, XYZ<->linear-RGB, sRGB transfer.

Covers the semantics of the reference's ``libwurblpt/color.hpp``: analytic CIE 1931
color-matching-function approximation (``color.hpp:37-66``; multi-lobe Gaussian fit
of Wyman, Sloan & Shirley JCGT 2013), D65 illuminant (``:183-224``; analytic CIE
daylight-series approximation here), XYZ<->RGB with Rec.709 primaries (``:247-263``),
and the sRGB transfer functions (``:265-285``).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .vecmath import matvec

# Rec.709 / sRGB primaries, D65 white (row-major 3x3). HOST arrays, not jnp:
# a module-level device array (a) becomes a hoisted const_arg that the jax
# 0.9.0 dispatch fastpath can drop (tests/conftest.py), and (b) initializes
# the XLA backend at package-import time, which breaks the multi-host rule
# that jax.distributed.initialize must run before any backend use
# (tools/multiproc_smoke.py).
_XYZ_TO_RGB = np.array(
    [
        [3.2406255, -1.5372080, -0.4986286],
        [-0.9689307, 1.8757561, 0.0415175],
        [0.0557101, -0.2040211, 1.0569959],
    ],
    np.float32,
)
_RGB_TO_XYZ = np.array(
    [
        [0.4124, 0.3576, 0.1805],
        [0.2126, 0.7152, 0.0722],
        [0.0193, 0.1192, 0.9505],
    ],
    np.float32,
)


def xyz_to_rgb(xyz):
    return matvec(_XYZ_TO_RGB, xyz)


def rgb_to_xyz(rgb):
    return matvec(_RGB_TO_XYZ, rgb)


def _gauss(x, alpha, mu, s1, s2):
    s = jnp.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * jnp.exp(-0.5 * t * t)


def color_matching_function(lambda_nm):
    """Approximate CIE 1931 2-deg CMFs (Wyman et al. JCGT 2013 multi-lobe fit).

    Input wavelength in nm; returns [..., 3] = (xbar, ybar, zbar).
    """
    lam = jnp.asarray(lambda_nm, jnp.float32)
    x = (
        _gauss(lam, 1.056, 599.8, 37.9, 31.0)
        + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
        + _gauss(lam, -0.065, 501.1, 20.4, 26.2)
    )
    y = _gauss(lam, 0.821, 568.8, 46.9, 40.5) + _gauss(lam, 0.286, 530.9, 16.3, 31.1)
    z = _gauss(lam, 1.217, 437.0, 11.8, 36.0) + _gauss(lam, 0.681, 459.0, 26.0, 13.8)
    return jnp.stack([x, y, z], axis=-1)


def d65(lambda_nm):
    """Approximate relative spectral power of CIE D65, normalized to 100 at 560nm.

    Smooth blackbody(6504K)-based approximation adequate for spectral->RGB
    integration of reflectance data (used by the RGL spectral material path).
    """
    lam = jnp.asarray(lambda_nm, jnp.float32)
    # Planck radiator at CCT ~6504K, normalized at 560nm.
    lam_m = lam * 1e-9
    c2 = 1.4388e-2
    T = 6503.5
    planck = (lam_m ** -5.0) / (jnp.exp(c2 / (lam_m * T)) - 1.0)
    lam560 = 560e-9
    planck560 = (lam560 ** -5.0) / (jnp.exp(c2 / (lam560 * T)) - 1.0)
    return 100.0 * planck / planck560


def rgb_to_srgb(rgb):
    """Linear RGB -> sRGB-encoded (color.hpp:265-275)."""
    rgb = jnp.clip(rgb, 0.0, 1.0)
    lo = 12.92 * rgb
    hi = 1.055 * jnp.power(jnp.maximum(rgb, 1e-8), 1.0 / 2.4) - 0.055
    return jnp.where(rgb <= 0.0031308, lo, hi)


def srgb_to_rgb(srgb):
    """sRGB-encoded -> linear RGB (color.hpp:277-285)."""
    srgb = jnp.asarray(srgb, jnp.float32)
    lo = srgb / 12.92
    hi = jnp.power((jnp.maximum(srgb, 0.0) + 0.055) / 1.055, 2.4)
    return jnp.where(srgb <= 0.04045, lo, hi)


def rgb_luminance(rgb):
    return rgb_to_xyz(rgb)[..., 1]


def byte_to_float(b):
    return jnp.asarray(b, jnp.float32) / 255.0


def float_to_byte(f):
    return jnp.clip(jnp.round(f * 255.0), 0, 255).astype(jnp.uint8)
