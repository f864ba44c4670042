"""Counter-based, stateless random number generation.

The reference uses a sequential per-pixel xoshiro128+ stream seeded by
splitmix64(pixelIndex + 42) (``libwurblpt/prng.hpp:47-101``). A sequential stream is
the wrong design for a wavefront renderer: lanes would need mutable per-ray
state and results would depend on evaluation order and sharding.

Instead every random draw is a pure function of a *counter tuple*
``(pixel, sample, depth, salt)`` hashed with PCG4D (Jarzynski & Olano, JCGT 2020,
"Hash Functions for GPU Rendering") — the standard counter-based generator for
GPU wavefront path tracers. Properties we rely on:

* reproducible regardless of chip count, sharding, or evaluation order
  (required for the 1-chip vs N-host parity tests, SURVEY.md section 7);
* no carried state: the bounce loop stays a clean ``lax.while_loop``;
* vectorizes perfectly on the VPU (pure uint32 ALU ops, no gathers).

Floats use the same 24-bit-mantissa construction as the reference's
``Prng::in01()`` (``prng.hpp:91-99``): take the top 24 bits, scale by 2^-24,
giving uniforms in [0, 1).
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def _pcg4d(v0, v1, v2, v3):
    """PCG4D hash: 4 x uint32 -> 4 x uint32 (Jarzynski & Olano 2020)."""
    m = _U32(1664525)
    a = _U32(1013904223)
    v0 = v0 * m + a
    v1 = v1 * m + a
    v2 = v2 * m + a
    v3 = v3 * m + a
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def hash4(pixel, sample, depth, salt):
    """Hash a counter tuple to 4 uint32 words. Inputs may be any integer dtype."""
    return _pcg4d(
        jnp.asarray(pixel).astype(_U32),
        jnp.asarray(sample).astype(_U32),
        jnp.asarray(depth).astype(_U32),
        jnp.asarray(salt).astype(_U32),
    )


def _to_unit_float(u):
    """uint32 -> float32 in [0, 1) with 24-bit mantissa (prng.hpp:91-99 semantics)."""
    return (u >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def uniform4(pixel, sample, depth, salt):
    """Four independent uniforms in [0,1) for the given counter tuple.

    Returns an array shaped ``broadcast(pixel,...) + (4,)``.
    """
    v0, v1, v2, v3 = hash4(pixel, sample, depth, salt)
    return jnp.stack(
        [_to_unit_float(v0), _to_unit_float(v1), _to_unit_float(v2), _to_unit_float(v3)],
        axis=-1,
    )


def uniform2(pixel, sample, depth, salt):
    v0, v1, _, _ = hash4(pixel, sample, depth, salt)
    return jnp.stack([_to_unit_float(v0), _to_unit_float(v1)], axis=-1)


def uniform1(pixel, sample, depth, salt):
    v0, _, _, _ = hash4(pixel, sample, depth, salt)
    return _to_unit_float(v0)


# Salt namespaces: one per randomized decision in the integrator, so each decision
# reads an independent stream (the reference instead advances one sequential
# stream; the *set* of decisions per bounce matches wurblpt.hpp:108-275).
class Salt:
    PIXEL_JITTER = 0x01
    LENS = 0x02
    TIME = 0x03
    BSDF = 0x10
    BSDF_LOBE = 0x11
    BSDF_CHANNEL = 0x12  # glass dispersion channel pick (material_glass.hpp:97-106)
    # One fused draw whose four PCG4D output words serve the per-bounce
    # SCALAR decisions (lobe pick, dispersion channel, Russian roulette) —
    # the words of one hash are independent, so one hash4 replaces three.
    BSDF_AUX = 0x13
    NEE_PICK = 0x20
    NEE_SAMPLE = 0x21
    ENVMAP_SAMPLE = 0x22
    RR = 0x30
    MEDIUM = 0x40
    NOISE = 0x50
