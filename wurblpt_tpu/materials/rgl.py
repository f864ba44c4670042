"""RGL (EPFL) measured-material BRDFs, evaluated as batched array gathers.

The reference evaluates measured BRDFs through the vendored powitacq library
(``material_rgl.hpp:46-261`` + ``powitacq*.inl``): the Dupuy-Jakob adaptive
parameterization stores, per incident direction (phi_i, theta_i), a visible-NDF
warp, a luminance warp and RGB (or spectral) reflectance tables, all as
piecewise-bilinear 2D distributions ("Marginal2D") with marginal/conditional
CDFs for sample warping.  That structure is already table-based, so this
design keeps the exact numerics but re-expresses every operation as
vectorized gathers over the whole ray wavefront:

* host side (numpy): the ``tensor_file`` binary format is parsed, per-slice
  CDFs are prebuilt exactly like Marginal2D's constructor
  (``powitacq_rgb.inl:242-283``), spectral datasets are integrated to RGB with
  the D65 illuminant and CIE color-matching functions at *load* time (the
  integration in ``material_rgl.hpp:137-153`` is linear in the spectra, so it
  commutes with the bilinear interpolation), and the near-infrared channel is
  appended as a 4th reflectance channel (average of RGB for RGB datasets,
  nearest-wavelength slice for spectral ones, ``material_rgl.hpp:45-46,151``);

* device side (jnp): ``sample`` / ``invert`` / ``eval`` of the warps become
  masked binary searches plus bilinear gathers batched over all RGL lanes of
  the wavefront (``powitacq_rgb.inl:326-583`` semantics), with every material's
  tables stacked (zero-padded) along a leading axis selected by
  ``materials.rgl_id``.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..core.onb import onb_from_normal_tangent, to_local, to_world
from ..core.vecmath import dot, normalize

_f32 = np.float32
_i32 = np.int32
_PI = float(np.pi)
# powitacq_rgb.inl:22
_ONE_MINUS_EPS = 0.999999940395355225


# ---------------------------------------------------------------------------
# Host side: tensor_file parsing + table preparation (numpy)
# ---------------------------------------------------------------------------

_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16, 5: np.uint32,
    6: np.int32, 7: np.uint64, 8: np.int64, 9: np.float16, 10: np.float32,
    11: np.float64,
}


def read_tensor_file(path: str) -> dict:
    """Parse the RGL 'tensor_file' container (``powitacq_rgb.inl:729-801``)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:12] != b"tensor_file\x00":
        raise ValueError(f"{path}: not a tensor_file")
    ver0, ver1 = raw[12], raw[13]
    if (ver0, ver1) != (1, 0):
        raise ValueError(f"{path}: unsupported tensor_file version {ver0}.{ver1}")
    (n_fields,) = struct.unpack_from("<I", raw, 14)
    pos = 18
    fields = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", raw, pos)
        pos += 2
        name = raw[pos:pos + name_len].decode("utf-8")
        pos += name_len
        ndim, dtype = struct.unpack_from("<HB", raw, pos)
        pos += 3
        (offset,) = struct.unpack_from("<Q", raw, pos)
        pos += 8
        shape = struct.unpack_from(f"<{ndim}Q", raw, pos)
        pos += 8 * ndim
        dt = np.dtype(_DTYPES[dtype])
        count = int(np.prod(shape)) if ndim else 1
        data = np.frombuffer(raw, dt, count=count, offset=offset).reshape(shape)
        fields[name] = np.array(data)
    return fields


def _build_cdfs(data: np.ndarray):
    """Per-slice normalization + marginal/conditional CDFs, exactly like
    Marginal2D's build_cdf constructor path (``powitacq_rgb.inl:242-283``).

    data: [..., H, W] -> (data_norm [..., H, W], marg [..., H], cond [..., H, W]).
    """
    d = np.asarray(data, np.float64)
    cond = np.zeros_like(d)
    cond[..., 1:] = np.cumsum(0.5 * (d[..., :-1] + d[..., 1:]), axis=-1)
    last = cond[..., -1]                                   # [..., H]
    marg = np.zeros(last.shape, np.float64)
    marg[..., 1:] = np.cumsum(0.5 * (last[..., :-1] + last[..., 1:]), axis=-1)
    norm = 1.0 / np.maximum(marg[..., -1:], 1e-30)
    return (
        (d * norm[..., None]).astype(_f32),
        (marg * norm).astype(_f32),
        (cond * norm[..., None]).astype(_f32),
    )


def _spectra_to_rgb4(spectra: np.ndarray, wavelengths: np.ndarray,
                     nir_wavelength: float = 850.0) -> np.ndarray:
    """Integrate spectral tables to RGB+NIR at load time.

    Reproduces ``MaterialRGLSpectral::toAttenuation`` (material_rgl.hpp:137-153):
    XYZ integration of the visible range against D65 * CMF, xyz->rgb, plus the
    nearest-wavelength slice as NIR.  The whole pipeline is linear in the
    spectra, so precomputing it per table texel is exact.
    spectra: [P, T, S, H, W] -> [P, T, 4, H, W].
    """
    from ..core.color import color_matching_function, d65, xyz_to_rgb

    wl = np.asarray(wavelengths, np.float64)
    first = int(np.argmax(wl >= 360.0)) if np.any(wl >= 360.0) else 0
    below = np.nonzero(wl <= 780.0)[0]
    last = int(below[-1]) if below.size else len(wl) - 1
    nearest = int(np.argmin(np.abs(wl - nir_wavelength)))

    sel = np.arange(first, last + 1)
    lam = wl[sel]
    illum = np.asarray(d65(jnp.asarray(lam)), np.float64)                 # [S']
    cmf = np.asarray(color_matching_function(jnp.asarray(lam)), np.float64)  # [S', 3]
    n_norm = float(np.sum(illum * cmf[:, 1]))
    # The reference's integrationFactor multiplies both xyz and N, so it
    # cancels out of xyz * 100/N; only the per-wavelength weights remain.
    # Its xyz scale is Y in [0,100] with a compensating 0.01 inside
    # color.hpp:255-262's xyz_to_rgb; our color.xyz_to_rgb uses Y in [0,1],
    # so the net weight is illum*cmf/N (flat unit spectrum -> Y=1 -> white).
    w_xyz = illum[:, None] * cmf * (1.0 / max(n_norm, 1e-30))            # [S', 3]
    w_rgb = np.asarray(xyz_to_rgb(jnp.asarray(w_xyz)), np.float64)       # linear map
    rgb = np.einsum("ptshw,sc->ptchw", spectra[:, :, sel].astype(np.float64), w_rgb)
    nir = spectra[:, :, nearest:nearest + 1].astype(np.float64)
    return np.concatenate([rgb, nir], axis=2).astype(_f32)


def load_rgl_material(source, nir_wavelength: float = 850.0) -> dict:
    """Load one RGL dataset (path or pre-parsed field dict) into plain numpy
    tables ready for stacking (ctor semantics of ``powitacq_rgb.inl:891-1007``)."""
    fields = read_tensor_file(source) if isinstance(source, str) else dict(source)

    phi_i = np.asarray(fields["phi_i"], _f32).reshape(-1)
    theta_i = np.asarray(fields["theta_i"], _f32).reshape(-1)
    ndf = np.asarray(fields["ndf"], _f32)
    sigma = np.asarray(fields["sigma"], _f32)
    vndf = np.asarray(fields["vndf"], _f32)
    lum = np.asarray(fields["luminance"], _f32)
    if vndf.shape[:2] != (len(phi_i), len(theta_i)):
        raise ValueError("vndf shape does not match phi_i/theta_i grids")

    if "rgb" in fields:
        rgb = np.asarray(fields["rgb"], _f32)     # [P, T, 3, H, W]
        nir = rgb.mean(axis=2, keepdims=True)     # fake NIR = avg RGB (material_rgl.hpp:45-46)
        rgb4 = np.concatenate([rgb, nir], axis=2)
    elif "spectra" in fields:
        rgb4 = _spectra_to_rgb4(np.asarray(fields["spectra"], _f32),
                                np.asarray(fields["wavelengths"], _f32),
                                nir_wavelength)
    else:
        raise ValueError("RGL dataset has neither 'rgb' nor 'spectra' field")

    vndf_d, vndf_m, vndf_c = _build_cdfs(vndf)
    lum_d, lum_m, lum_c = _build_cdfs(lum)
    return dict(
        phi_i=phi_i, theta_i=theta_i, ndf=ndf, sigma=sigma,
        vndf_data=vndf_d, vndf_marg=vndf_m, vndf_cond=vndf_c,
        lum_data=lum_d, lum_marg=lum_m, lum_cond=lum_c,
        rgb=np.maximum(rgb4, 0.0),
        isotropic=bool(len(phi_i) <= 2),
    )


class RGLTables(NamedTuple):
    """All RGL materials of a scene, stacked (zero-padded) along axis 0."""

    phi_i: jnp.ndarray      # [M, P]
    theta_i: jnp.ndarray    # [M, T]
    n_phi: jnp.ndarray      # [M] int32 actual counts
    n_theta: jnp.ndarray    # [M]
    ndf: jnp.ndarray        # [M, Hn, Wn] raw values
    sigma: jnp.ndarray      # [M, Hs, Ws]
    ndf_hw: jnp.ndarray     # [M, 2] actual (h, w)
    sigma_hw: jnp.ndarray   # [M, 2]
    vndf_data: jnp.ndarray  # [M, P, T, Hv, Wv] normalized density
    vndf_marg: jnp.ndarray  # [M, P, T, Hv]
    vndf_cond: jnp.ndarray  # [M, P, T, Hv, Wv]
    vndf_hw: jnp.ndarray    # [M, 2]
    lum_data: jnp.ndarray   # [M, P, T, Hl, Wl]
    lum_marg: jnp.ndarray   # [M, P, T, Hl]
    lum_cond: jnp.ndarray   # [M, P, T, Hl, Wl]
    lum_hw: jnp.ndarray     # [M, 2]
    rgb: jnp.ndarray        # [M, P, T, 4, Hl, Wl] RGB + NIR reflectance
    isotropic: jnp.ndarray  # [M] bool

    @property
    def count(self):
        return self.phi_i.shape[0]


def _pad_to(a: np.ndarray, shape) -> np.ndarray:
    out = np.zeros(shape, a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def stack_rgl_tables(mats) -> RGLTables:
    """Stack per-material table dicts into one padded RGLTables pytree."""
    mats = list(mats)
    if not mats:
        return empty_rgl_tables()

    def mx(key, axis):
        return max(m[key].shape[axis] for m in mats)

    P, T = mx("phi_i", 0), mx("theta_i", 0)
    hn, wn = mx("ndf", 0), mx("ndf", 1)
    hs, ws = mx("sigma", 0), mx("sigma", 1)
    hv, wv = mx("vndf_data", 2), mx("vndf_data", 3)
    hl, wl = mx("lum_data", 2), mx("lum_data", 3)

    def stack(key, shape):
        return jnp.asarray(np.stack([_pad_to(m[key], shape) for m in mats]))

    return RGLTables(
        phi_i=stack("phi_i", (P,)),
        theta_i=stack("theta_i", (T,)),
        n_phi=jnp.asarray([len(m["phi_i"]) for m in mats], jnp.int32),
        n_theta=jnp.asarray([len(m["theta_i"]) for m in mats], jnp.int32),
        ndf=stack("ndf", (hn, wn)),
        sigma=stack("sigma", (hs, ws)),
        ndf_hw=jnp.asarray([m["ndf"].shape for m in mats], jnp.int32),
        sigma_hw=jnp.asarray([m["sigma"].shape for m in mats], jnp.int32),
        vndf_data=stack("vndf_data", (P, T, hv, wv)),
        vndf_marg=stack("vndf_marg", (P, T, hv)),
        vndf_cond=stack("vndf_cond", (P, T, hv, wv)),
        vndf_hw=jnp.asarray([m["vndf_data"].shape[2:] for m in mats], jnp.int32),
        lum_data=stack("lum_data", (P, T, hl, wl)),
        lum_marg=stack("lum_marg", (P, T, hl)),
        lum_cond=stack("lum_cond", (P, T, hl, wl)),
        lum_hw=jnp.asarray([m["lum_data"].shape[2:] for m in mats], jnp.int32),
        rgb=stack("rgb", (P, T, 4, hl, wl)),
        isotropic=jnp.asarray([m["isotropic"] for m in mats], bool),
    )


def empty_rgl_tables() -> RGLTables:
    """Minimal placeholder so SceneArrays stays a uniform pytree."""
    z2 = np.zeros((1, 2, 2), _f32)
    z5 = np.zeros((1, 1, 1, 2, 2), _f32)
    return RGLTables(
        phi_i=jnp.zeros((1, 1), jnp.float32),
        theta_i=jnp.zeros((1, 1), jnp.float32),
        n_phi=jnp.ones((1,), jnp.int32),
        n_theta=jnp.ones((1,), jnp.int32),
        ndf=jnp.asarray(z2), sigma=jnp.asarray(z2),
        ndf_hw=jnp.full((1, 2), 2, jnp.int32),
        sigma_hw=jnp.full((1, 2), 2, jnp.int32),
        vndf_data=jnp.asarray(z5),
        vndf_marg=jnp.zeros((1, 1, 1, 2), jnp.float32),
        vndf_cond=jnp.asarray(z5),
        vndf_hw=jnp.full((1, 2), 2, jnp.int32),
        lum_data=jnp.asarray(z5),
        lum_marg=jnp.zeros((1, 1, 1, 2), jnp.float32),
        lum_cond=jnp.asarray(z5),
        lum_hw=jnp.full((1, 2), 2, jnp.int32),
        rgb=jnp.zeros((1, 1, 1, 4, 2, 2), jnp.float32),
        isotropic=jnp.ones((1,), bool),
    )


# ---------------------------------------------------------------------------
# Device side: batched Marginal2D ops (powitacq_rgb.inl:183-630 semantics)
# ---------------------------------------------------------------------------

def _steps(k: int) -> int:
    return max(int(np.ceil(np.log2(max(k, 2)))) + 1, 1)


def _search(fetch, n, u, max_size: int, strict: bool):
    """find_interval (powitacq_rgb.inl:132-151): largest i in [0, n-2] with
    fetch(i) < u (strict) or <= u; branchless bisection, batched over lanes."""
    lo = jnp.zeros_like(n)
    hi = jnp.maximum(n - 1, 1)
    for _ in range(_steps(max_size)):
        mid = (lo + hi) >> 1
        v = fetch(mid)
        pred = (v < u) if strict else (v <= u)
        adv = pred & (mid > lo)
        lo = jnp.where(adv, mid, lo)
        hi = jnp.where(pred, hi, mid)
    return jnp.clip(lo, 0, jnp.maximum(n - 2, 0))



def _extract(rowvals, idx):
    """rowvals[..., idx] WITHOUT a per-lane gather: one-hot reduce over the
    (small, static) grid axis. Once a whole row is fetched, point lookups
    inside it are arithmetic, not more per-lane gathers."""
    S = rowvals.shape[-1]
    iota = jnp.arange(S, dtype=jnp.int32)
    oh = (iota == idx[..., None]).astype(rowvals.dtype)
    while oh.ndim < rowvals.ndim:
        oh = oh[..., None, :]
    return jnp.sum(rowvals * oh, axis=-1)


def _search_row(rowvals, n, u, strict: bool):
    """find_interval (powitacq_rgb.inl:132-151) over a PRE-FETCHED row:
    largest i in [0, n-2] with row[i] < u (strict) or <= u. For the sorted /
    CDF rows this is a vectorized count — identical to the bisection the
    reference runs, minus one gather per bisection step."""
    S = rowvals.shape[-1]
    iota = jnp.arange(S, dtype=jnp.int32)
    within = iota < n[..., None]
    pred = (rowvals < u[..., None]) if strict else (rowvals <= u[..., None])
    cnt = jnp.sum((pred & within).astype(jnp.int32), axis=-1)
    return jnp.clip(cnt - 1, 0, jnp.maximum(n - 2, 0))

def _pair_rows(a):
    """Pack each bilinear row PAIR into one row: out[..., y, :] =
    [row y | row y+1 (clamped)] along the last axis.

    Every bilinear fetch needs rows y0 and y0+1, so one 2W-wide gather
    replaces two W-wide ones. Pure function of
    the loop-invariant tables — XLA hoists it out of the wavefront loop
    (mat_packed precedent) and CSEs the repeated pack expressions."""
    nxt = jnp.concatenate([a[..., 1:, :], a[..., -1:, :]], axis=-2)
    return jnp.concatenate([a, nxt], axis=-1)


def _param_weights(vals, nvals, mid, x, max_size: int):
    """Parameter lookup: index + lerp weight into a sorted grid
    (powitacq_rgb.inl:335-355). ONE row gather (count packed into the row as
    an exact float value) + vectorized search."""
    packed = jnp.concatenate([vals, nvals.astype(vals.dtype)[:, None]], 1)
    rowp = packed[mid]
    row = rowp[..., :-1]
    n = rowp[..., -1].astype(jnp.int32)
    i0 = _search_row(row, n, x, strict=False)
    p0 = _extract(row, i0)
    p1 = _extract(row, jnp.minimum(i0 + 1, jnp.maximum(n - 1, 0)))
    w1 = jnp.clip((x - p0) / jnp.where(p1 == p0, 1.0, p1 - p0), 0.0, 1.0)
    w1 = jnp.where(n <= 1, 0.0, w1)
    return i0, w1


class _Warp2(NamedTuple):
    """One param-conditioned warp, bound to per-lane material/param indices."""

    data: jnp.ndarray   # [M, P, T, H, W]
    marg: jnp.ndarray   # [M, P, T, H]
    cond: jnp.ndarray   # [M, P, T, H, W]
    mid: jnp.ndarray    # [N]
    pi: jnp.ndarray     # [N] phi_i grid cell
    ti: jnp.ndarray     # [N] theta_i grid cell
    wp1: jnp.ndarray    # [N] phi lerp weight
    wt1: jnp.ndarray    # [N]
    h: jnp.ndarray      # [N] actual rows
    w: jnp.ndarray      # [N] actual cols

    def _g(self, arr, *idx):
        """Param-bilinear gather: sum over the (phi,theta) slice corners.

        Corners along a SINGLETON parameter axis are skipped STATICALLY:
        when the padded axis length is 1, every material's count is <= 1, so
        `_param_weights` returns weight exactly 0 for the +1 corner — and
        most RGL materials are isotropic (P == 1), halving (or with T == 1
        quartering) the row gathers per fetch."""
        p_single = arr.shape[1] == 1
        t_single = arr.shape[2] == 1
        pi1 = jnp.minimum(self.pi + 1, arr.shape[1] - 1)
        ti1 = jnp.minimum(self.ti + 1, arr.shape[2] - 1)
        wp0, wp1 = 1.0 - self.wp1, self.wp1
        wt0, wt1 = 1.0 - self.wt1, self.wt1
        if p_single and t_single:
            corners = [(jnp.ones_like(wp0), self.pi, self.ti)]
        elif t_single:
            corners = [(wp0, self.pi, self.ti), (wp1, pi1, self.ti)]
        elif p_single:
            corners = [(wt0, self.pi, self.ti), (wt1, self.pi, ti1)]
        else:
            corners = [(wp0 * wt0, self.pi, self.ti),
                       (wp0 * wt1, self.pi, ti1),
                       (wp1 * wt0, pi1, self.ti),
                       (wp1 * wt1, pi1, ti1)]
        m = self.mid
        out = None
        for w_, p_, t_ in corners:
            v = arr[(m, p_, t_) + idx]
            if v.ndim > w_.ndim:  # trailing channel axis (rgb gathers)
                w_ = w_.reshape(w_.shape + (1,) * (v.ndim - w_.ndim))
            out = w_ * v if out is None else out + w_ * v
        return out

    @property
    def _area(self):
        return ((self.w - 1) * (self.h - 1)).astype(jnp.float32)

    def _cell(self, pos):
        fx = pos[..., 0] * (self.w - 1).astype(jnp.float32)
        fy = pos[..., 1] * (self.h - 1).astype(jnp.float32)
        x0 = jnp.clip(fx.astype(jnp.int32), 0, self.w - 2)
        y0 = jnp.clip(fy.astype(jnp.int32), 0, self.h - 2)
        return x0, y0, fx - x0, fy - y0

    def eval(self, pos):
        """Bilinear density at pos in the unit square (powitacq_rgb.inl:530-583).

        ONE row-PAIR fetch + one-hot column extraction instead of four point
        gathers (_extract / _pair_rows rationale)."""
        x0, y0, sx, sy = self._cell(pos)
        W = self.data.shape[-1]
        dr = self._g(_pair_rows(self.data), y0)
        dr0, dr1 = dr[..., :W], dr[..., W:]
        v00 = _extract(dr0, x0)
        v10 = _extract(dr0, x0 + 1)
        v01 = _extract(dr1, x0)
        v11 = _extract(dr1, x0 + 1)
        return ((1 - sy) * ((1 - sx) * v00 + sx * v10)
                + sy * ((1 - sx) * v01 + sx * v11)) * self._area

    def invert(self, pos):
        """Map a warped position back to the uniform domain + density
        (powitacq_rgb.inl:434-527). Row-pair fetches + one-hot extraction."""
        x0, y0, sx, sy = self._cell(pos)
        W = self.data.shape[-1]
        dr = self._g(_pair_rows(self.data), y0)
        dr0, dr1 = dr[..., :W], dr[..., W:]
        v00 = _extract(dr0, x0)
        v10 = _extract(dr0, x0 + 1)
        v01 = _extract(dr1, x0)
        v11 = _extract(dr1, x0 + 1)
        c0 = (1 - sy) * v00 + sy * v01
        c1 = (1 - sy) * v10 + sy * v11
        pdf = (1 - sx) * c0 + sx * c1

        ux = sx * (c0 + 0.5 * sx * (c1 - c0))
        # cond row pair + the marginal CDF value packed into one fetched row
        crm = self._g(jnp.concatenate(
            [_pair_rows(self.cond), self.marg[..., None]], -1), y0)
        cr0, cr1, marg0 = crm[..., :W], crm[..., W:2 * W], crm[..., 2 * W]
        v0 = _extract(cr0, x0)
        v1 = _extract(cr1, x0)
        ux = ux + ((1 - sy) * v0 + sy * v1)
        wlast = jnp.maximum(self.w - 1, 0)
        r0 = _extract(cr0, wlast)
        r1 = _extract(cr1, wlast)
        ux = ux / jnp.maximum((1 - sy) * r0 + sy * r1, 1e-20)
        uy = sy * (r0 + 0.5 * sy * (r1 - r0)) + marg0
        return jnp.stack([ux, uy], -1), pdf * self._area

    def sample(self, u, max_h: int, max_w: int):
        """Warp a uniform sample; returns (position, density)
        (powitacq_rgb.inl:326-432)."""
        u = jnp.clip(u, 1.0 - _ONE_MINUS_EPS, _ONE_MINUS_EPS)
        ux, uy = u[..., 0], u[..., 1]

        marg_row = self._g(self.marg)                 # whole [N, H] CDF row
        row = _search_row(marg_row, self.h, uy, True)
        uy = uy - _extract(marg_row, row)

        W = self.cond.shape[-1]
        cr = self._g(_pair_rows(self.cond), row)
        cr0, cr1 = cr[..., :W], cr[..., W:]
        wlast = jnp.maximum(self.w - 1, 0)
        r0 = _extract(cr0, wlast)
        r1 = _extract(cr1, wlast)
        is_const = jnp.abs(r0 - r1) < 1e-4 * (r0 + r1)
        disc = jnp.sqrt(jnp.maximum(r0 * r0 - 2.0 * uy * (r0 - r1), 0.0))
        uy = jnp.where(is_const,
                       2.0 * uy / jnp.maximum(r0 + r1, 1e-20),
                       (r0 - disc) / jnp.where(is_const, 1.0, jnp.where(r0 == r1, 1.0, r0 - r1)))

        ux = ux * ((1 - uy) * r0 + uy * r1)

        fc_row = (1 - uy)[..., None] * cr0 + uy[..., None] * cr1
        col = _search_row(fc_row, self.w, ux, True)
        ux = ux - _extract(fc_row, col)

        dr = self._g(_pair_rows(self.data), row)
        dr0, dr1 = dr[..., :W], dr[..., W:]
        v00 = _extract(dr0, col)
        v10 = _extract(dr0, col + 1)
        v01 = _extract(dr1, col)
        v11 = _extract(dr1, col + 1)
        c0 = (1 - uy) * v00 + uy * v01
        c1 = (1 - uy) * v10 + uy * v11
        is_const2 = jnp.abs(c0 - c1) < 1e-4 * (c0 + c1)
        disc2 = jnp.sqrt(jnp.maximum(c0 * c0 - 2.0 * ux * (c0 - c1), 0.0))
        ux = jnp.where(is_const2,
                       2.0 * ux / jnp.maximum(c0 + c1, 1e-20),
                       (c0 - disc2) / jnp.where(is_const2, 1.0, jnp.where(c0 == c1, 1.0, c0 - c1)))

        pos = jnp.stack([
            (col.astype(jnp.float32) + ux) / (self.w - 1).astype(jnp.float32),
            (row.astype(jnp.float32) + uy) / (self.h - 1).astype(jnp.float32),
        ], -1)
        pdf = ((1 - ux) * c0 + ux * c1) * self._area
        return pos, pdf


def _eval0(arr, hw, mid, pos):
    """Warp2D0 with normalize=build_cdf=false: plain bilinear of the raw table
    (the ctor pre-divides by the patch area and eval re-multiplies,
    powitacq_rgb.inl:286-312,530-583)."""
    h = hw[mid, 0]
    w = hw[mid, 1]
    fx = jnp.clip(pos[..., 0], 0.0, 1.0) * (w - 1).astype(jnp.float32)
    fy = jnp.clip(pos[..., 1], 0.0, 1.0) * (h - 1).astype(jnp.float32)
    x0 = jnp.clip(fx.astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(fy.astype(jnp.int32), 0, h - 2)
    sx, sy = fx - x0, fy - y0
    W = arr.shape[-1]
    rp = _pair_rows(arr)[mid, y0]          # ONE [N, 2W] row-pair fetch
    r0, r1 = rp[..., :W], rp[..., W:]      # (was 2 gathers, was 4 points)
    v00 = _extract(r0, x0)
    v10 = _extract(r0, x0 + 1)
    v01 = _extract(r1, x0)
    v11 = _extract(r1, x0 + 1)
    return (1 - sy) * ((1 - sx) * v00 + sx * v10) + sy * ((1 - sx) * v01 + sx * v11)


def _rgb_eval(tables: RGLTables, wrp: _Warp2, pos):
    """All 4 reflectance channels at a warp position (Warp2D3 with the channel
    as an exact grid parameter, powitacq_rgb.inl:995-1007,1084-1099)."""
    x0, y0, sx, sy = wrp._cell(pos)
    rgb = tables.rgb

    W = rgb.shape[-1]
    rr = _Warp2._g(wrp, _pair_rows(rgb), slice(None), y0)  # [N, 4, 2W] pair
    rr0, rr1 = rr[..., :W], rr[..., W:]
    v00, v10 = _extract(rr0, x0), _extract(rr0, x0 + 1)
    v01, v11 = _extract(rr1, x0), _extract(rr1, x0 + 1)
    sx = sx[..., None]
    sy = sy[..., None]
    out = (1 - sy) * ((1 - sx) * v00 + sx * v10) + sy * ((1 - sx) * v01 + sx * v11)
    return jnp.maximum(out, 0.0)  # POWITACQ_CLIP_RGB


# ---------------------------------------------------------------------------
# BRDF-level operations (powitacq_rgb.inl:1016-1190 semantics)
# ---------------------------------------------------------------------------

def _u2theta(u):
    return u * u * (_PI / 2.0)


def _u2phi(u):
    return (2.0 * u - 1.0) * _PI


def _theta2u(theta):
    return jnp.sqrt(jnp.maximum(theta, 0.0) * (2.0 / _PI))


def _phi2u(phi):
    return (phi + _PI) / (2.0 * _PI)


def _elevation(d):
    """Robust acos(d.z) (powitacq_rgb.inl:1016-1018)."""
    dz = d[..., 2] - 1.0
    return 2.0 * jnp.arcsin(jnp.clip(
        0.5 * jnp.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + dz * dz), -1.0, 1.0))


class _Frame(NamedTuple):
    tables: RGLTables
    mid: jnp.ndarray
    pi: jnp.ndarray
    ti: jnp.ndarray
    wp1: jnp.ndarray
    wt1: jnp.ndarray
    phi_i: jnp.ndarray
    theta_i: jnp.ndarray
    u_wi: jnp.ndarray
    iso: jnp.ndarray


def _prepare(tables: RGLTables, mid, wi):
    theta_i = _elevation(wi)
    phi_i = jnp.arctan2(wi[..., 1], wi[..., 0])
    pi, wp1 = _param_weights(tables.phi_i, tables.n_phi, mid, phi_i,
                             tables.phi_i.shape[1])
    ti, wt1 = _param_weights(tables.theta_i, tables.n_theta, mid, theta_i,
                             tables.theta_i.shape[1])
    u_wi = jnp.stack([_theta2u(theta_i), _phi2u(phi_i)], -1)
    return _Frame(tables, mid, pi, ti, wp1, wt1, phi_i, theta_i, u_wi,
                  tables.isotropic[mid])


def _warp(fr: _Frame, which: str) -> _Warp2:
    t = fr.tables
    data, marg, cond, hw = {
        "vndf": (t.vndf_data, t.vndf_marg, t.vndf_cond, t.vndf_hw),
        "lum": (t.lum_data, t.lum_marg, t.lum_cond, t.lum_hw),
    }[which]
    return _Warp2(data, marg, cond, fr.mid, fr.pi, fr.ti, fr.wp1, fr.wt1,
                  hw[fr.mid, 0], hw[fr.mid, 1])


def _u_wm(fr: _Frame, wm):
    theta_m = _elevation(wm)
    phi_m = jnp.arctan2(wm[..., 1], wm[..., 0])
    um_y = _phi2u(jnp.where(fr.iso, phi_m - fr.phi_i, phi_m))
    um_y = um_y - jnp.floor(um_y)
    return jnp.stack([_theta2u(theta_m), um_y], -1)


def _fr_common(fr: _Frame, wi, wm, vndf_warp_pos, u_wm):
    """Shared tail of eval/sample: reflectance * ndf / (4 sigma(wi))."""
    t = fr.tables
    fval = _rgb_eval(t, _warp(fr, "lum"), vndf_warp_pos)
    ndf_v = _eval0(t.ndf, t.ndf_hw, fr.mid, u_wm)
    sigma_v = _eval0(t.sigma, t.sigma_hw, fr.mid, fr.u_wi)
    scale = ndf_v / jnp.maximum(4.0 * sigma_v, 1e-12)
    return fval * scale[..., None]


def _jacobian(wi, wm, u_wm):
    sin_theta_m = jnp.sqrt(wm[..., 0] ** 2 + wm[..., 1] ** 2)
    return (jnp.maximum(2.0 * _PI * _PI * u_wm[..., 0] * sin_theta_m, 1e-6)
            * 4.0 * dot(wi, wm))


def rgl_eval(tables: RGLTables, mid, wi, wo):
    """(f*cos [N,4], pdf [N]) for tangent-space wi (toward viewer) and wo
    (scatter direction), batched; powitacq_rgb eval() + pdf()."""
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    wm = normalize(wi + wo)
    fr = _prepare(tables, mid, wi)
    u_wm = _u_wm(fr, wm)
    vndf = _warp(fr, "vndf")
    warp_pos, vndf_pdf = vndf.invert(u_wm)
    fval = _fr_common(fr, wi, wm, warp_pos, u_wm)
    lum_pdf = _warp(fr, "lum").eval(warp_pos)
    pdf = vndf_pdf * lum_pdf / _jacobian(wi, wm, u_wm)
    fval = jnp.where(valid[..., None], fval, 0.0)
    pdf = jnp.where(valid, jnp.maximum(pdf, 0.0), 0.0)
    return fval, pdf


def rgl_sample(tables: RGLTables, mid, wi, u2):
    """Sample wo from the measured BRDF; returns (wo [N,3], f*cos [N,4],
    pdf [N], valid [N]); powitacq_rgb sample()."""
    fr = _prepare(tables, mid, wi)
    sample = jnp.stack([u2[..., 1], u2[..., 0]], -1)
    t = fr.tables
    lum = _warp(fr, "lum")
    sample, lum_pdf = lum.sample(sample, t.lum_marg.shape[3], t.lum_cond.shape[4])
    vndf = _warp(fr, "vndf")
    u_wm, ndf_pdf = vndf.sample(sample, t.vndf_marg.shape[3], t.vndf_cond.shape[4])

    phi_m = _u2phi(u_wm[..., 1])
    theta_m = _u2theta(u_wm[..., 0])
    phi_m = jnp.where(fr.iso, phi_m + fr.phi_i, phi_m)
    sin_t, cos_t = jnp.sin(theta_m), jnp.cos(theta_m)
    wm = jnp.stack([jnp.cos(phi_m) * sin_t, jnp.sin(phi_m) * sin_t, cos_t], -1)
    wo = 2.0 * dot(wm, wi)[..., None] * wm - wi

    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    fval = _fr_common(fr, wi, wm, sample, u_wm)
    pdf = ndf_pdf * lum_pdf / _jacobian(wi, wm, u_wm)
    ok = valid & (pdf > 0) & jnp.all(jnp.isfinite(fval), axis=-1)
    return wo, jnp.where(ok[..., None], fval, 0.0), jnp.where(ok, pdf, 0.0), ok


# ---------------------------------------------------------------------------
# Wavefront lane adapters (called from render.bsdf dispatch)
# ---------------------------------------------------------------------------

def _lane_frame(scene, hr, wo_world, rgl_id=None):
    if rgl_id is None:
        rgl_id = scene.materials.rgl_id[hr.mat]
    mid = jnp.maximum(rgl_id, 0)
    t, b = onb_from_normal_tangent(hr.normal, hr.tangent)
    # RGL convention: "wi" is the direction toward the viewer (material_rgl.hpp:67-70).
    wi = to_local(wo_world, t, b, hr.normal)
    return mid, t, b, wi


def rgl_sample_lanes(scene, hr, wo_world, u2, rgl_id=None):
    """(direction, f*cos, pdf, ok) for RGL lanes (MaterialRGL::scatter)."""
    mid, t, b, wi = _lane_frame(scene, hr, wo_world, rgl_id)
    wo, fval, pdf, ok = rgl_sample(scene.rgl, mid, wi, u2)
    ok = ok & (~hr.backside)
    d = normalize(to_world(wo, t, b, hr.normal))
    return d, fval, pdf, ok


def rgl_eval_lanes(scene, hr, wo_world, wd, rgl_id=None):
    """(f*cos, pdf, ok) toward wd (MaterialRGL::scatterToDirection)."""
    mid, t, b, wi = _lane_frame(scene, hr, wo_world, rgl_id)
    wo = to_local(wd, t, b, hr.normal)
    fval, pdf = rgl_eval(scene.rgl, mid, wi, wo)
    ok = (~hr.backside) & (dot(wd, hr.normal) > 0)
    return (jnp.where(ok[..., None], fval, 0.0),
            jnp.where(ok, pdf, 0.0), ok)
