"""Frame-to-frame registration: star pattern matching + similarity solve
(the JAX package's ``ops/register.py``), batched over frames.

Method: take each frame's top-k brightest stars; every ordered
reference star pair against every ordered target pair gives a candidate
similarity (scale and rotation from the segments, translation from the
first endpoints), gated to plausible scale; each candidate is scored by
the number of reference stars landing within ``inlier_tol`` of a target
star; the best (first on ties, as ``jnp.argmax``) is refined twice by
nearest-neighbour matching and a weighted closed-form (Umeyama) refit.
A batch the vote turns past 2 deg anywhere (an alt-az session's) is
solved again by :func:`solve_turned`, which the reference has not: a
wider vote, whose best candidates are each refitted to every star of the
tables (:func:`refit_similarity`, the pairs a blend of stars throws off
clipped) and the best fit kept.

Convention: the transform maps REFERENCE coordinates to TARGET
coordinates, x_tgt = s*R @ x_ref + t, which is the inverse map the warp
needs to bring the target onto the reference grid.
"""

from __future__ import annotations

import math
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


def _mapped(fit, rx, ry):
    """Reference stars (B, S) under x' = [[c, -s], [s, c]] x + t, with
    ``fit`` = (c, s, tx, ty), each (B,): (x, y), each (B, S)."""
    c, s, t_x, t_y = fit
    return (c[:, None] * rx - s[:, None] * ry + t_x[:, None],
            s[:, None] * rx + c[:, None] * ry + t_y[:, None])


def _nearest(fit, rx, ry, tx_, ty_, both):
    """Squared distances (B, S, T) from each reference star mapped by
    ``fit`` (:func:`_mapped`) to each target star, inf where ``both`` is
    False; each reference star's nearest target star (first on ties, as
    ``jnp.argmin``) and its squared distance, each (B, S)."""
    mx, my = _mapped(fit, rx, ry)
    d2 = ((mx[:, :, None] - tx_[:, None, :]) ** 2
          + (my[:, :, None] - ty_[:, None, :]) ** 2)
    d2 = torch.where(both, d2, torch.inf)
    return d2, torch.argmin(d2, dim=2), d2.amin(dim=2)


def _fit_to(src, tx_, ty_, nn, wgt):
    """The target stars ``nn`` (B, S) picks, (B, S, 2), and the weighted
    similarity fit ``src`` -> them (:func:`solve_similarity`)."""
    dst = torch.stack([torch.gather(tx_, 1, nn),
                       torch.gather(ty_, 1, nn)], dim=-1)
    return dst, solve_similarity(src, dst, wgt)


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
    candidates: int = 1,
    pair_k: int = None,
    tgt_k: int = None,
) -> Similarity:
    """Similarities mapping reference coords to target coords for a batch
    of frames: star tables (B, S) (a (S,) reference broadcasts).
    Returns a :class:`Similarity` of (B,) tensors; a solve with fewer
    than 2 distinct matched target stars or a scale off by more than
    3*scale_tol is rejected (unit scale, translation
    ``REJECTED_TRANSLATION``).  With ``candidates`` M > 1, each field is
    (B, M): the vote's best candidate first, then the next M - 1 by
    score, each refined alike (for :func:`refit_similarity` to choose
    among).  ``pair_k`` and ``tgt_k`` (each ``k`` by default, the
    reference's vote) widen the vote: candidates come from the pairs of
    the reference's ``pair_k`` brightest stars against the pairs of the
    target's ``tgt_k`` brightest, and each is scored by the reference's
    ``k`` brightest landing on the target's ``tgt_k``."""
    tables = [torch.as_tensor(t) for t in (ref_x, ref_y, ref_flux, ref_valid,
                                           tgt_x, tgt_y, tgt_flux, tgt_valid)]
    batch = max(t.shape[0] for t in tables if t.dim() == 2) \
        if any(t.dim() == 2 for t in tables) else None
    if batch is None:
        return Similarity(*(f[0] for f in estimate_similarity(
            *(t[None] for t in tables), k=k, scale_tol=scale_tol,
            inlier_tol=inlier_tol, min_seg=min_seg,
            refine_iters=refine_iters, candidates=candidates,
            pair_k=pair_k, tgt_k=tgt_k)))
    tables = [t.expand(batch, -1) if t.dim() == 1 else t for t in tables]
    with span("apt.register.match"):
        rx, ry, rv = _top_k_stars(*tables[0:4], k)
        tx_, ty_, tv = _top_k_stars(*tables[4:8], tgt_k or k)
        b = rx.shape[0]
        pk, tk = pair_k or k, tx_.shape[1]
        rlen, rang, rok = (a.reshape(b, -1) for a in _segments(
            rx[:, :pk], ry[:, :pk], rv[:, :pk], min_seg))
        tlen, tang, tok = (a.reshape(b, -1)
                           for a in _segments(tx_, ty_, tv, min_seg))
        # candidate (ref pair p, tgt pair q) -> flattened p * tk^2 + q
        ri = torch.arange(pk, device=rx.device).repeat_interleave(pk)
        ti = torch.arange(tk, device=rx.device).repeat_interleave(tk)
        if pair_k is not None or tgt_k is not None:
            # the widened vote: each reference pair once against each
            # target pair both ways, the same transforms as every ordered
            # pair against every ordered pair, in a quarter of the work
            rp = torch.triu_indices(pk, pk, 1, device=rx.device)
            tp = torch.triu_indices(tk, tk, 1, device=rx.device)
            tp = torch.cat([tp, tp.flip(0)], dim=1)
            rlen, rang, rok = (a[:, rp[0] * pk + rp[1]]
                               for a in (rlen, rang, rok))
            tlen, tang, tok = (a[:, tp[0] * tk + tp[1]]
                               for a in (tlen, tang, tok))
            ri, ti = rp[0], tp[0]
        scale_c = tlen[:, None, :] / torch.clamp(rlen[:, :, None], min=1e-9)
        theta_c = tang[:, None, :] - rang[:, :, None]
        cand_ok = (rok[:, :, None] & tok[:, None, :]
                   & ((scale_c - 1.0).abs() < scale_tol))
        c_c = scale_c * torch.cos(theta_c)
        s_c = scale_c * torch.sin(theta_c)
        rx_i = rx[:, ri][:, :, None]
        ry_i = ry[:, ri][:, :, None]
        tx_i = tx_[:, ti][:, None, :]
        ty_i = ty_[:, ti][:, None, :]
        flat_c = c_c.reshape(b, -1)
        flat_s = s_c.reshape(b, -1)
        flat_tx = (tx_i - (c_c * rx_i - s_c * ry_i)).reshape(b, -1)
        flat_ty = (ty_i - (s_c * rx_i + c_c * ry_i)).reshape(b, -1)

        # score: reference stars within inlier_tol of some target star
        pair_ok = (rv[:, :, None] & tv[:, None, :])[..., None]
        tol2 = inlier_tol ** 2
        n_cand = flat_c.shape[1]
        chunk = max(1, _SCORE_ELEMS // max(b * k * tk, 1))
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
        if candidates > 1:
            best = torch.cat([best, torch.topk(
                scores, candidates - 1, dim=1).indices], dim=1)
            # each candidate a row of its own: (B * M,) from here
            rx, ry, rv, tx_, ty_, tv = (t.repeat_interleave(candidates, 0)
                                        for t in (rx, ry, rv, tx_, ty_, tv))
        c = torch.gather(flat_c, 1, best).reshape(-1)
        s = torch.gather(flat_s, 1, best).reshape(-1)
        t_x = torch.gather(flat_tx, 1, best).reshape(-1)
        t_y = torch.gather(flat_ty, 1, best).reshape(-1)

    with span("apt.register.refine"):
        # refinement: nearest-neighbour matching + weighted closed-form refit
        both = rv[:, :, None] & tv[:, None, :]
        src = torch.stack([rx, ry], dim=-1)
        for _ in range(refine_iters):
            _d2, nn, nn_d2 = _nearest((c, s, t_x, t_y), rx, ry, tx_, ty_,
                                      both)
            wgt = (nn_d2 < tol2).to(torch.float32)
            dst, (scale, theta, t_x, t_y) = _fit_to(src, tx_, ty_, nn, wgt)
            c, s = scale * torch.cos(theta), scale * torch.sin(theta)
        # count DISTINCT matched target stars: a degenerate transform can
        # drag many reference stars onto one target
        n_in = torch.zeros((rx.shape[0], tk), dtype=torch.float32,
                           device=rx.device) \
            .scatter_reduce(1, nn, wgt, reduce="amax", include_self=True) \
            .sum(dim=1)
        rms = torch.sqrt(torch.where(wgt > 0, nn_d2, 0.0).sum(dim=1)
                         / torch.clamp(n_in, min=1.0))
    scale_f = torch.sqrt(c * c + s * s)
    theta_f = torch.atan2(s, c)
    ok = (n_in >= 2) & ((scale_f - 1.0).abs() < 3.0 * scale_tol)
    out = Similarity(
        scale=torch.where(ok, scale_f, 1.0),
        theta=torch.where(ok, theta_f, 0.0),
        tx=torch.where(ok, t_x, REJECTED_TRANSLATION),
        ty=torch.where(ok, t_y, REJECTED_TRANSLATION),
        n_inliers=n_in.to(torch.int32), rms=rms)
    if candidates > 1:
        out = Similarity(*(f.view(b, candidates) for f in out))
    return out


#: a refit drops a pair whose residual exceeds this many times the
#: median residual of its frame's pairs (a 2-D residual's median lies at
#: 1.18 sigma, so 3 medians is 3.5 sigma: 0.2 % of sound pairs) ...
_REFIT_CLIP_MEDIANS = 3.0
#: ... and never one within this many px (a pair this close moves no
#: frame corner by a hundredth of a pixel among a refit's 20-40 pairs)
_REFIT_CLIP_FLOOR_PX = 0.05
#: a refit that keeps fewer pairs leaves the vote's solve as it was
_REFIT_MIN_STARS = 3
#: a batch in which the vote turns no frame past this against the
#: reference (an equatorial mount's stack) keeps the vote's solves: the
#: reference's solve, which the parity tests hold the port to within
#: 0.05 px on frames turned up to 1.15 deg.  A batch with a frame turned
#: further (a field that rotates, an alt-az mount) is solved again by
#: :func:`solve_turned`
_TURN_RAD = math.radians(2.0)
#: :func:`solve_turned`'s vote: candidates from the pairs of the
#: reference's 6 brightest stars against those of the target's 24
#: brightest, scored by the reference's ``k`` brightest landing on the
#: target's 24, and its 16 best candidates refitted.  Star fluxes that
#: differ by ~10 % shuffle the ranks of a turned frame's brightest
#: stars against the reference's, and the reference's vote (the 10
#: brightest on each side) then finds as few as 2 stars in common
_TURNED_PAIR_K, _TURNED_TGT_K, _TURNED_CANDIDATES = 6, 24, 16


def _cs(scale, theta, t_x, t_y):
    """(scale, theta, tx, ty) as :func:`_mapped`'s (c, s, tx, ty)."""
    return scale * torch.cos(theta), scale * torch.sin(theta), t_x, t_y


def _pairs(fit, rx, ry, rv, tx_, ty_, tv, tol2):
    """Each reference star's mutual nearest target star under ``fit``
    (:func:`_mapped`), within sqrt(tol2): (index (B, S), kept (B, S))."""
    d2, nn, nn_d2 = _nearest(fit, rx, ry, tx_, ty_,
                             rv[:, :, None] & tv[:, None, :])
    back = torch.gather(d2.argmin(dim=1), 1, nn)
    mine = torch.arange(rx.shape[1], device=rx.device)[None, :]
    return nn, (nn_d2 < tol2) & (back == mine)


def _residuals(fit, src, dst):
    """(B, S) distances from each reference star ``src`` (B, S, 2) mapped
    by ``fit`` = (scale, theta, tx, ty) to its target star ``dst``."""
    mx, my = _mapped(_cs(*fit), src[..., 0], src[..., 1])
    return torch.hypot(mx - dst[..., 0], my - dst[..., 1])


@numpy_inputs("ref_x", "ref_y", "ref_valid", "tgt_x", "tgt_y", "tgt_valid")
def refit_similarity(
    sims: Similarity,
    ref_x: torch.Tensor, ref_y: torch.Tensor, ref_valid: torch.Tensor,
    tgt_x: torch.Tensor, tgt_y: torch.Tensor, tgt_valid: torch.Tensor,
    inlier_tol: float = 2.0,
) -> Similarity:
    """Refit accepted solves to every star of the tables (B, S) (a (S,)
    reference broadcasts), not only to the k brightest that
    :func:`estimate_similarity`'s vote and refinement use.  ``sims`` is
    (B,), or (B, M) candidates (``estimate_similarity(candidates=M)``),
    the vote's best first: each is refitted, and the one with the most
    pairs kept (the first on ties), so that a chance match the vote
    scored as high as the true one gives way to it.

    Each reference star is paired with its mutual nearest target star
    within ``inlier_tol`` under the solve, and the pairs are fitted as
    the refinement fits (:func:`_fit_to`, unit weights).  Pairs whose
    residual under that fit exceeds 3 times the frame's median residual
    (and 0.05 px) are dropped, and the rest fitted again: a blended pair
    of stars, whose centroid sits ~0.5 px off in one frame and elsewhere
    in a frame turned against it, would otherwise move every frame
    solved against it.  A frame whose kept candidate is rejected or
    left with fewer than 3 pairs keeps the vote's best solve as it came.
    ``n_inliers`` and ``rms`` are the last fit's pairs and their
    residual rms."""
    m = sims.tx.shape[1] if sims.tx.dim() == 2 else 1
    vote = Similarity(*(f[:, 0] for f in sims)) if m > 1 else sims
    ref = [torch.as_tensor(t) for t in (ref_x, ref_y, ref_valid)]
    tgt = [torch.as_tensor(t) for t in (tgt_x, tgt_y, tgt_valid)]
    if m > 1:
        tgt = [t.repeat_interleave(m, 0) for t in tgt]
    rows = tgt[0].shape[0]
    rx, ry, rv = (t.expand(rows, -1) if t.dim() == 1 else t for t in ref)
    tx_, ty_, tv = tgt
    flat = Similarity(*(f.reshape(-1) for f in sims))
    with span("apt.register.refit"):
        nn, keep = _pairs(_cs(*flat[:4]), rx, ry, rv, tx_, ty_, tv,
                          inlier_tol ** 2)
        src = torch.stack([rx, ry], dim=-1)
        dst, fit = _fit_to(src, tx_, ty_, nn, keep.to(torch.float32))
        res = _residuals(fit, src, dst)
        med = torch.nanmedian(torch.where(keep, res, torch.nan), dim=1).values
        bound = torch.clamp(_REFIT_CLIP_MEDIANS * med,
                            min=_REFIT_CLIP_FLOOR_PX)
        keep = keep & (res <= bound[:, None])
        fit = solve_similarity(src, dst, keep.to(torch.float32))
        res = _residuals(fit, src, dst)
        n_in = keep.sum(dim=1)
        rms = torch.sqrt(torch.where(keep, res * res, 0.0).sum(dim=1)
                         / torch.clamp(n_in, min=1).to(res.dtype))
        accepted = flat.tx != REJECTED_TRANSLATION
        new = (*fit, n_in.to(sims.n_inliers.dtype), rms)
        if m > 1:
            score = torch.where(accepted, n_in, -1).view(-1, m)
            best = torch.argmax(score, dim=1, keepdim=True)

            def kept(f):
                return torch.gather(f.view(-1, m), 1, best)[:, 0]

            new = [kept(f) for f in new]
            accepted, n_in = kept(accepted), kept(n_in)
        ok = accepted & (n_in >= _REFIT_MIN_STARS)
        return Similarity(*(torch.where(ok, a, b) for a, b in zip(new, vote)))


def turned_past(sims: Similarity) -> torch.Tensor:
    """Whether ``sims`` turn any accepted frame past 2 deg against the
    reference: a 0-d bool tensor on their device."""
    return ((sims.tx != REJECTED_TRANSLATION)
            & (sims.theta.abs() > _TURN_RAD)).any()


@numpy_inputs("ref_x", "ref_y", "ref_flux", "ref_valid", "tgt_x", "tgt_y", "tgt_flux", "tgt_valid")
def solve_turned(
    ref_x: torch.Tensor, ref_y: torch.Tensor, ref_flux: torch.Tensor,
    ref_valid: torch.Tensor,
    tgt_x: torch.Tensor, tgt_y: torch.Tensor, tgt_flux: torch.Tensor,
    tgt_valid: torch.Tensor, k: int = 10,
) -> Similarity:
    """The solves (B,) of a batch whose field turns, star tables as
    :func:`estimate_similarity` takes them: its vote widened
    (``_TURNED_PAIR_K``, ``_TURNED_TGT_K``), its best candidates each
    refitted to every star (:func:`refit_similarity`)."""
    cands = estimate_similarity(
        ref_x, ref_y, ref_flux, ref_valid, tgt_x, tgt_y, tgt_flux,
        tgt_valid, k=k, candidates=_TURNED_CANDIDATES,
        pair_k=_TURNED_PAIR_K, tgt_k=_TURNED_TGT_K)
    return refit_similarity(cands, ref_x, ref_y, ref_valid, tgt_x, tgt_y,
                            tgt_valid)
