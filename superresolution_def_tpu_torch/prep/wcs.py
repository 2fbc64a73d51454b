"""TAN (gnomonic) WCS — the projection the whole reference pipeline lives in.

A copy of the JAX ``prep/wcs.py``: the standard FITS TAN convention
without astropy. CRPIXn are 1-based, intermediate coordinates are
CD @ (pixel - crpix) in degrees, projected gnomonically around CRVAL.
Covers every operation the reference performs on WCS objects:

- construction from / export to FITS headers (CDn_n or CDELTn forms);
- pixel<->world transforms (vectorized numpy);
- `wcs[y0:y0+H, x0:x0+W]` slicing = crpix shift (astropy slice semantics,
  Dataset_step3:235);
- the step-3 aligned-LR derivation: CD (or CDELT) x factor, CRPIX / factor
  (create_aligned_lr_wcs, Dataset_step3:212-221);
- the step-1 registration target: fresh TAN centered on a reference CRVAL
  at native scale with CRPIX at the image center
  (register_single_image_smart, Dataset_step1:236-240);
- pixel scale in arcsec (proj_plane_pixel_scales equivalent) and
  angular separation for the step-3 distance filter (:401-409);
- SIP distortion polynomials (Shupe et al. 2005, the 'RA---TAN-SIP'
  convention ASTAP can write and astropy honors in the reference's
  registration, Dataset_step1:224-248): forward A/B terms are applied in
  pixel_to_world, the inverse uses AP/BP when present and fixed-point
  iteration otherwise. Registration targets are clean TAN, so SIP only
  matters when READING solved headers — exactly where astropy used it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _sip_poly(coeffs: np.ndarray, u, v):
    """Evaluate sum_{p,q} coeffs[p, q] * u^p * v^q (SIP polynomial)."""
    out = np.zeros(np.broadcast(u, v).shape, np.float64)
    n = coeffs.shape[0]
    for p in range(n):
        for q in range(n - p):
            c = coeffs[p, q]
            if c != 0.0:
                out = out + c * (u ** p) * (v ** q)
    return out


def _parse_sip_coeffs(header: dict, prefix: str) -> np.ndarray | None:
    """Read {prefix}_ORDER + {prefix}_p_q keywords into an (n+1, n+1) matrix."""
    order_key = f"{prefix}_ORDER"
    if order_key not in header:
        return None
    order = int(header[order_key])
    coeffs = np.zeros((order + 1, order + 1), np.float64)
    for p in range(order + 1):
        for q in range(order + 1 - p):
            key = f"{prefix}_{p}_{q}"
            if key in header:
                coeffs[p, q] = float(header[key])
    return coeffs


@dataclasses.dataclass
class TanWCS:
    crval: np.ndarray  # (ra0, dec0) deg
    crpix: np.ndarray  # (x0, y0), 1-based FITS convention
    cd: np.ndarray     # 2x2 CD matrix, deg/pixel: [[cd1_1, cd1_2], [cd2_1, cd2_2]]
    # SIP forward (A, B) / inverse (AP, BP) coefficient matrices, or None
    sip_a: np.ndarray | None
    sip_b: np.ndarray | None
    sip_ap: np.ndarray | None
    sip_bp: np.ndarray | None

    def __init__(self, crval, crpix, cd=None, cdelt=None,
                 sip_a=None, sip_b=None, sip_ap=None, sip_bp=None):
        self.crval = np.asarray(crval, np.float64)
        self.crpix = np.asarray(crpix, np.float64)
        if cd is not None:
            self.cd = np.asarray(cd, np.float64).reshape(2, 2)
        else:
            cdelt = np.asarray(cdelt, np.float64)
            self.cd = np.diag(cdelt)
        self.sip_a = None if sip_a is None else np.asarray(sip_a, np.float64)
        self.sip_b = None if sip_b is None else np.asarray(sip_b, np.float64)
        self.sip_ap = None if sip_ap is None else np.asarray(sip_ap, np.float64)
        self.sip_bp = None if sip_bp is None else np.asarray(sip_bp, np.float64)

    @property
    def has_sip(self) -> bool:
        return self.sip_a is not None or self.sip_b is not None

    # ------------------------------------------------------------------ #
    @classmethod
    def from_header(cls, header: dict) -> "TanWCS":
        ctype1 = str(header.get("CTYPE1", ""))
        if "TAN" not in ctype1 and ctype1:
            raise ValueError(f"unsupported projection {ctype1!r} (TAN only)")
        crval = [float(header["CRVAL1"]), float(header["CRVAL2"])]
        crpix = [float(header.get("CRPIX1", 1.0)), float(header.get("CRPIX2", 1.0))]
        # SIP distortion (present when ASTAP writes a distorted solve;
        # astropy honors it in the reference's registration) — parse it
        # like astropy does rather than silently dropping the terms
        sip = dict(
            sip_a=_parse_sip_coeffs(header, "A"),
            sip_b=_parse_sip_coeffs(header, "B"),
            sip_ap=_parse_sip_coeffs(header, "AP"),
            sip_bp=_parse_sip_coeffs(header, "BP"),
        )
        if "CD1_1" in header:
            cd = [
                [float(header["CD1_1"]), float(header.get("CD1_2", 0.0))],
                [float(header.get("CD2_1", 0.0)), float(header["CD2_2"])],
            ]
            return cls(crval, crpix, cd=cd, **sip)
        cdelt = [float(header.get("CDELT1", 1.0)), float(header.get("CDELT2", 1.0))]
        if "PC1_1" in header:
            pc = np.array(
                [
                    [float(header.get("PC1_1", 1.0)), float(header.get("PC1_2", 0.0))],
                    [float(header.get("PC2_1", 0.0)), float(header.get("PC2_2", 1.0))],
                ]
            )
            return cls(crval, crpix, cd=np.diag(cdelt) @ pc, **sip)
        return cls(crval, crpix, cdelt=cdelt, **sip)

    def to_header(self) -> dict:
        suffix = "-SIP" if self.has_sip else ""
        h = {
            "CTYPE1": "RA---TAN" + suffix,
            "CTYPE2": "DEC--TAN" + suffix,
            "CRVAL1": float(self.crval[0]),
            "CRVAL2": float(self.crval[1]),
            "CRPIX1": float(self.crpix[0]),
            "CRPIX2": float(self.crpix[1]),
            "CD1_1": float(self.cd[0, 0]),
            "CD1_2": float(self.cd[0, 1]),
            "CD2_1": float(self.cd[1, 0]),
            "CD2_2": float(self.cd[1, 1]),
        }
        for prefix, coeffs in (
            ("A", self.sip_a), ("B", self.sip_b),
            ("AP", self.sip_ap), ("BP", self.sip_bp),
        ):
            if coeffs is None:
                continue
            order = coeffs.shape[0] - 1
            h[f"{prefix}_ORDER"] = order
            for p in range(order + 1):
                for q in range(order + 1 - p):
                    if coeffs[p, q] != 0.0:
                        h[f"{prefix}_{p}_{q}"] = float(coeffs[p, q])
        return h

    @classmethod
    def has_celestial(cls, header: dict) -> bool:
        return (
            "CRVAL1" in header
            and "CRVAL2" in header
            and "TAN" in str(header.get("CTYPE1", ""))
        )

    # ------------------------------------------------------------------ #
    def pixel_to_world(self, px, py):
        """0-based pixel coords -> (ra, deg) arrays. Vectorized."""
        px = np.asarray(px, np.float64)
        py = np.asarray(py, np.float64)
        # FITS crpix is 1-based; 0-based pixel p maps via (p + 1 - crpix)
        pu = px + 1 - self.crpix[0]
        pv = py + 1 - self.crpix[1]
        if self.has_sip:
            # SIP forward: (u, v) -> (u + A(u,v), v + B(u,v)) before CD
            du = _sip_poly(self.sip_a, pu, pv) if self.sip_a is not None else 0.0
            dv = _sip_poly(self.sip_b, pu, pv) if self.sip_b is not None else 0.0
            pu, pv = pu + du, pv + dv
        u = self.cd[0, 0] * pu + self.cd[0, 1] * pv
        v = self.cd[1, 0] * pu + self.cd[1, 1] * pv
        xi = np.deg2rad(u)
        eta = np.deg2rad(v)
        ra0 = np.deg2rad(self.crval[0])
        dec0 = np.deg2rad(self.crval[1])
        denom = np.cos(dec0) - eta * np.sin(dec0)
        ra = ra0 + np.arctan2(xi, denom)
        dec = np.arctan(
            (np.sin(dec0) + eta * np.cos(dec0))
            / np.sqrt(xi**2 + denom**2)
        )
        return np.rad2deg(ra) % 360.0, np.rad2deg(dec)

    def world_to_pixel(self, ra, dec):
        """(ra, dec) deg -> 0-based pixel coords. Vectorized."""
        ra = np.deg2rad(np.asarray(ra, np.float64))
        dec = np.deg2rad(np.asarray(dec, np.float64))
        ra0 = np.deg2rad(self.crval[0])
        dec0 = np.deg2rad(self.crval[1])
        dra = ra - ra0
        den = np.sin(dec0) * np.sin(dec) + np.cos(dec0) * np.cos(dec) * np.cos(dra)
        xi = np.cos(dec) * np.sin(dra) / den
        eta = (np.cos(dec0) * np.sin(dec) - np.sin(dec0) * np.cos(dec) * np.cos(dra)) / den
        uv = np.stack([np.rad2deg(xi), np.rad2deg(eta)])
        inv = np.linalg.inv(self.cd)
        p = inv @ uv.reshape(2, -1)
        pu = p[0].reshape(np.shape(xi))
        pv = p[1].reshape(np.shape(eta))
        if self.has_sip:
            pu, pv = self._sip_inverse(pu, pv)
        px = pu + self.crpix[0] - 1
        py = pv + self.crpix[1] - 1
        return px, py

    def _sip_inverse(self, fu, fv):
        """Undistorted intermediate pixel (f, g) -> raw (u, v).

        Uses AP/BP inverse polynomials when the header provides them
        (u = f + AP(f, g), v = g + BP(f, g)); otherwise fixed-point
        iteration on the forward polynomials (astropy's
        all_world2pix-style refinement: u_{k+1} = f - A(u_k, v_k)),
        which converges fast because SIP corrections are small."""
        if self.sip_ap is not None or self.sip_bp is not None:
            du = _sip_poly(self.sip_ap, fu, fv) if self.sip_ap is not None else 0.0
            dv = _sip_poly(self.sip_bp, fu, fv) if self.sip_bp is not None else 0.0
            return fu + du, fv + dv
        u, v = np.array(fu, np.float64), np.array(fv, np.float64)
        for _ in range(20):
            du = _sip_poly(self.sip_a, u, v) if self.sip_a is not None else 0.0
            dv = _sip_poly(self.sip_b, u, v) if self.sip_b is not None else 0.0
            nu, nv = fu - du, fv - dv
            if np.max(np.abs(nu - u)) < 1e-10 and np.max(np.abs(nv - v)) < 1e-10:
                u, v = nu, nv
                break
            u, v = nu, nv
        return u, v

    # ------------------------------------------------------------------ #
    def _require_clean_tan(self, op: str) -> None:
        # Step-1 registration writes clean TAN targets, so step-3 slicing /
        # LR derivation never see SIP in the reference flow; if they ever
        # do, shifting/scaling crpix would silently move the distortion
        # origin — refuse loudly instead.
        if self.has_sip:
            raise ValueError(
                f"TanWCS.{op} on a SIP-distorted WCS: reproject onto a "
                "clean TAN target first (registration does this)"
            )

    def slice(self, y0: int, x0: int) -> "TanWCS":
        """astropy `wcs[y0:..., x0:...]` equivalent: shift crpix."""
        self._require_clean_tan("slice")
        return TanWCS(self.crval, self.crpix - np.array([x0, y0]), cd=self.cd)

    def scaled_lr(self, factor: float) -> "TanWCS":
        """Reference create_aligned_lr_wcs: CD * factor, CRPIX / factor."""
        self._require_clean_tan("scaled_lr")
        return TanWCS(self.crval, self.crpix / factor, cd=self.cd * factor)

    @classmethod
    def registration_target(cls, ref_crval, shape, native_scale_deg: float) -> "TanWCS":
        """Step-1 target: centered on master CRVAL at native scale
        (Dataset_step1:236-240; note crpix = shape/2, astropy convention)."""
        h, w = shape
        return cls(
            ref_crval,
            [w / 2, h / 2],
            cdelt=[-native_scale_deg, native_scale_deg],
        )

    # ------------------------------------------------------------------ #
    def pixel_scale_arcsec(self) -> float:
        """sqrt of column norms like proj_plane_pixel_scales()[0] * 3600."""
        return float(np.sqrt(self.cd[0, 0] ** 2 + self.cd[1, 0] ** 2) * 3600.0)

    def center_world(self, shape) -> tuple[float, float]:
        h, w = shape
        ra, dec = self.pixel_to_world(np.array([(w - 1) / 2]), np.array([(h - 1) / 2]))
        return float(ra[0]), float(dec[0])


def angular_separation_deg(ra1, dec1, ra2, dec2) -> float:
    """Great-circle separation (haversine), degrees."""
    ra1, dec1, ra2, dec2 = map(np.deg2rad, (ra1, dec1, ra2, dec2))
    sd = np.sin((dec2 - dec1) / 2) ** 2
    sr = np.sin((ra2 - ra1) / 2) ** 2
    h = sd + np.cos(dec1) * np.cos(dec2) * sr
    return float(np.rad2deg(2 * np.arcsin(np.sqrt(np.clip(h, 0, 1)))))
