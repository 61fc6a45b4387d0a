"""Frame-to-frame registration: star pattern matching + similarity solve
(the JAX package's ``ops/register.py``), batched over frames.

Method: take each frame's top-k brightest stars; every ordered
reference star pair against every ordered target pair gives a candidate
similarity (scale and rotation from the segments, translation from the
first endpoints), gated to plausible scale; each candidate is scored by
the number of reference stars landing within ``inlier_tol`` of a target
star; the best (first on ties, as ``jnp.argmax``) is refined twice by
nearest-neighbour matching and a weighted closed-form (Umeyama) refit.

Convention: the transform maps REFERENCE coordinates to TARGET
coordinates, x_tgt = s*R @ x_ref + t, which is the inverse map the warp
needs to bring the target onto the reference grid.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import numpy_inputs
from ..utils.timing import span

#: translation sentinel marking a REJECTED registration solve; callers
#: detecting rejected frames compare against this
REJECTED_TRANSLATION = 1e9

#: bound on the (frames, k, k, candidates) scoring temporary
_SCORE_ELEMS = 1 << 25


class Similarity(NamedTuple):
    """x' = scale * R(theta) @ x + (tx, ty); each field (...,)."""

    scale: torch.Tensor
    theta: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    n_inliers: torch.Tensor
    rms: torch.Tensor            # inlier residual rms (pixels)

    def matrix(self) -> torch.Tensor:
        """(..., 2, 3) matrices [A | t] with x' = A @ x + t."""
        c = self.scale * torch.cos(self.theta)
        s = self.scale * torch.sin(self.theta)
        return torch.stack([torch.stack([c, -s, self.tx], dim=-1),
                            torch.stack([s, c, self.ty], dim=-1)], dim=-2)

    def apply(self, x: torch.Tensor, y: torch.Tensor):
        c = self.scale * torch.cos(self.theta)
        s = self.scale * torch.sin(self.theta)
        return c * x - s * y + self.tx, s * x + c * y + self.ty

    def inverse(self) -> "Similarity":
        inv_scale = 1.0 / self.scale
        c = torch.cos(-self.theta) * inv_scale
        s = torch.sin(-self.theta) * inv_scale
        tx = -(c * self.tx - s * self.ty)
        ty = -(s * self.tx + c * self.ty)
        return Similarity(inv_scale, -self.theta, tx, ty,
                          self.n_inliers, self.rms)


def _top_k_stars(x, y, flux, valid, k):
    """The k brightest valid stars of each row (ties and invalid
    entries in index order, as ``jax.lax.top_k``)."""
    score = torch.where(valid, flux, -torch.inf)
    idx = torch.sort(score, dim=-1, descending=True, stable=True) \
        .indices[..., :k]
    return (torch.gather(x, -1, idx), torch.gather(y, -1, idx),
            torch.gather(valid, -1, idx))


@numpy_inputs("src_xy", "dst_xy", "weights")
def solve_similarity(src_xy: torch.Tensor, dst_xy: torch.Tensor,
                     weights: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Weighted closed-form similarity fit src -> dst (Umeyama), over
    (..., M, 2) points and (..., M) weights.  Returns (scale, theta, tx,
    ty), each (...,)."""
    w = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-12)
    mu_s = (src_xy * w[..., None]).sum(dim=-2)
    mu_d = (dst_xy * w[..., None]).sum(dim=-2)
    sc = src_xy - mu_s[..., None, :]
    dc = dst_xy - mu_d[..., None, :]
    # complex-number formulation of 2-D similarity: z' = a z + b
    a_re = (w * (dc[..., 0] * sc[..., 0] + dc[..., 1] * sc[..., 1])).sum(-1)
    a_im = (w * (dc[..., 1] * sc[..., 0] - dc[..., 0] * sc[..., 1])).sum(-1)
    denom = torch.clamp((w * (sc[..., 0] ** 2 + sc[..., 1] ** 2)).sum(-1),
                        min=1e-12)
    re = a_re / denom
    im = a_im / denom
    scale = torch.sqrt(re * re + im * im)
    theta = torch.atan2(im, re)
    c = scale * torch.cos(theta)
    s = scale * torch.sin(theta)
    tx = mu_d[..., 0] - (c * mu_s[..., 0] - s * mu_s[..., 1])
    ty = mu_d[..., 1] - (s * mu_s[..., 0] + c * mu_s[..., 1])
    return scale, theta, tx, ty


def _segments(x, y, v, min_seg):
    """(B, k, k) lengths, angles and validity of the ordered pairs i->j."""
    dx = x[:, None, :] - x[:, :, None]
    dy = y[:, None, :] - y[:, :, None]
    length = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)
    ok = v[:, :, None] & v[:, None, :] & (length > min_seg)
    return length, ang, ok


@numpy_inputs("ref_x", "ref_y", "ref_flux", "ref_valid", "tgt_x", "tgt_y", "tgt_flux", "tgt_valid")
def estimate_similarity(
    ref_x: torch.Tensor, ref_y: torch.Tensor, ref_flux: torch.Tensor,
    ref_valid: torch.Tensor,
    tgt_x: torch.Tensor, tgt_y: torch.Tensor, tgt_flux: torch.Tensor,
    tgt_valid: torch.Tensor,
    k: int = 16,
    scale_tol: float = 0.1,
    inlier_tol: float = 2.0,
    min_seg: float = 10.0,
    refine_iters: int = 2,
) -> Similarity:
    """Similarities mapping reference coords to target coords for a batch
    of frames: star tables (B, S) (a (S,) reference broadcasts).
    Returns a :class:`Similarity` of (B,) tensors; a solve with fewer
    than 2 distinct matched target stars or a scale off by more than
    3*scale_tol is rejected (unit scale, translation
    ``REJECTED_TRANSLATION``)."""
    tables = [torch.as_tensor(t) for t in (ref_x, ref_y, ref_flux, ref_valid,
                                           tgt_x, tgt_y, tgt_flux, tgt_valid)]
    batch = max(t.shape[0] for t in tables if t.dim() == 2) \
        if any(t.dim() == 2 for t in tables) else None
    if batch is None:
        return Similarity(*(f[0] for f in estimate_similarity(
            *(t[None] for t in tables), k=k, scale_tol=scale_tol,
            inlier_tol=inlier_tol, min_seg=min_seg,
            refine_iters=refine_iters)))
    tables = [t.expand(batch, -1) if t.dim() == 1 else t for t in tables]
    with span("apt.register.match"):
        rx, ry, rv = _top_k_stars(*tables[0:4], k)
        tx_, ty_, tv = _top_k_stars(*tables[4:8], k)
        b = rx.shape[0]
        rlen, rang, rok = (a.reshape(b, -1)
                           for a in _segments(rx, ry, rv, min_seg))
        tlen, tang, tok = (a.reshape(b, -1)
                           for a in _segments(tx_, ty_, tv, min_seg))
        # candidate (ref pair p, tgt pair q) -> flattened p * k^2 + q
        ri = torch.arange(k, device=rx.device).repeat_interleave(k)
        scale_c = tlen[:, None, :] / torch.clamp(rlen[:, :, None], min=1e-9)
        theta_c = tang[:, None, :] - rang[:, :, None]
        cand_ok = (rok[:, :, None] & tok[:, None, :]
                   & ((scale_c - 1.0).abs() < scale_tol))
        c_c = scale_c * torch.cos(theta_c)
        s_c = scale_c * torch.sin(theta_c)
        rx_i = rx[:, ri][:, :, None]
        ry_i = ry[:, ri][:, :, None]
        tx_i = tx_[:, ri][:, None, :]
        ty_i = ty_[:, ri][:, None, :]
        flat_c = c_c.reshape(b, -1)
        flat_s = s_c.reshape(b, -1)
        flat_tx = (tx_i - (c_c * rx_i - s_c * ry_i)).reshape(b, -1)
        flat_ty = (ty_i - (s_c * rx_i + c_c * ry_i)).reshape(b, -1)

        # score: reference stars within inlier_tol of some target star
        pair_ok = (rv[:, :, None] & tv[:, None, :])[..., None]
        tol2 = inlier_tol ** 2
        n_cand = flat_c.shape[1]
        chunk = max(1, _SCORE_ELEMS // max(b * k * k, 1))
        scores = []
        for o in range(0, n_cand, chunk):
            cc = flat_c[:, None, o:o + chunk]
            sc = flat_s[:, None, o:o + chunk]
            mx = cc * rx[:, :, None] - sc * ry[:, :, None] \
                + flat_tx[:, None, o:o + chunk]                    # (B, k, C)
            my = sc * rx[:, :, None] + cc * ry[:, :, None] \
                + flat_ty[:, None, o:o + chunk]
            d2 = ((mx[:, :, None, :] - tx_[:, None, :, None]) ** 2
                  + (my[:, :, None, :] - ty_[:, None, :, None]) ** 2)
            d2 = torch.where(pair_ok, d2, torch.inf)
            scores.append((d2.amin(dim=2) < tol2).sum(dim=1))
        scores = torch.where(cand_ok.reshape(b, -1),
                             torch.cat(scores, dim=1), -1)
        best = torch.argmax(scores, dim=1, keepdim=True)
        c = torch.gather(flat_c, 1, best)[:, 0]
        s = torch.gather(flat_s, 1, best)[:, 0]
        t_x = torch.gather(flat_tx, 1, best)[:, 0]
        t_y = torch.gather(flat_ty, 1, best)[:, 0]

    with span("apt.register.refine"):
        # refinement: nearest-neighbour matching + weighted closed-form refit
        both = rv[:, :, None] & tv[:, None, :]
        src = torch.stack([rx, ry], dim=-1)
        for _ in range(refine_iters):
            mx = c[:, None] * rx - s[:, None] * ry + t_x[:, None]
            my = s[:, None] * rx + c[:, None] * ry + t_y[:, None]
            d2 = ((mx[:, :, None] - tx_[:, None, :]) ** 2
                  + (my[:, :, None] - ty_[:, None, :]) ** 2)
            d2 = torch.where(both, d2, torch.inf)
            nn_d2 = d2.amin(dim=2)
            nn = torch.argmin(d2, dim=2)      # first on ties, as jnp.argmin
            wgt = (nn_d2 < tol2).to(torch.float32)
            dst = torch.stack([torch.gather(tx_, 1, nn),
                               torch.gather(ty_, 1, nn)], dim=-1)
            scale, theta, t_x, t_y = solve_similarity(src, dst, wgt)
            c, s = scale * torch.cos(theta), scale * torch.sin(theta)
        # count DISTINCT matched target stars: a degenerate transform can
        # drag many reference stars onto one target
        n_in = torch.zeros((b, k), dtype=torch.float32, device=rx.device) \
            .scatter_reduce(1, nn, wgt, reduce="amax", include_self=True) \
            .sum(dim=1)
        rms = torch.sqrt(torch.where(wgt > 0, nn_d2, 0.0).sum(dim=1)
                         / torch.clamp(n_in, min=1.0))
    scale_f = torch.sqrt(c * c + s * s)
    theta_f = torch.atan2(s, c)
    ok = (n_in >= 2) & ((scale_f - 1.0).abs() < 3.0 * scale_tol)
    return Similarity(
        scale=torch.where(ok, scale_f, 1.0),
        theta=torch.where(ok, theta_f, 0.0),
        tx=torch.where(ok, t_x, REJECTED_TRANSLATION),
        ty=torch.where(ok, t_y, REJECTED_TRANSLATION),
        n_inliers=n_in.to(torch.int32), rms=rms)
