"""Single-pass masked sigma-clipped mean over the frame axis (the JAX
package's ``ops/pallas_combine.py``, kernel K3).

Per pixel of an (N, H, W) stack with a validity mask: the median of the
valid samples, the MAD of their deviations times 1.4826, a clip at
med -/+ sigma * std, then the mean of the kept samples; NaN where nothing
is kept.  :func:`clip_combine` runs the hand-written CUDA kernel
(``csrc/clip_combine.cu``) on CUDA tensors and :func:`clip_combine_plain`
on CPU tensors.

The rounding order is K3's own, not the fused warp+combine's: the median
is 0.5 * (lo + hi), the std is 1.4826 * MAD, and the kept samples are
summed in frame order.  The reference writes that sum as ``acc + f * kf``
with ``kf`` the 0/1 keep flag; XLA rewrites a product with a converted
predicate into a select, so a sample that is not kept adds exactly 0 even
when it is inf or NaN.  The port sums ``acc + where(keep, f, 0)``, which
is that compiled behaviour.  Valid NaN samples are outside the contract:
the reference's min/max sorting network and a comparison sort place them
differently.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import numpy_inputs
from .stats import _MAD_TO_STD

#: sentinel of an invalid sample in the sorts
_BIG = 3.4e38


def _valid(stack: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The validity mask as bool: a bool mask as it is, a numeric one
    where it is > 0.5, everything without a mask."""
    if mask is None:
        return torch.ones_like(stack, dtype=torch.bool)
    return mask if mask.dtype == torch.bool else mask > 0.5


def _validate(stack: torch.Tensor, mask: Optional[torch.Tensor]) -> None:
    if stack.dim() != 3 or stack.shape[0] < 1:
        raise ValueError(f"stack must be (N, H, W) with N >= 1, got "
                         f"{tuple(stack.shape)}")
    if mask is not None and tuple(mask.shape) != tuple(stack.shape):
        raise ValueError(f"mask must have the stack's shape "
                         f"{tuple(stack.shape)}, got {tuple(mask.shape)}")


@numpy_inputs("stack", "mask")
def clip_combine_plain(stack: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       sigma_lower: float = 5.0,
                       sigma_upper: float = 5.0) -> torch.Tensor:
    """Plain PyTorch twin of the K3 kernel, on any device, in the
    reference kernel's operation order.  Same arguments and result as
    :func:`clip_combine`."""
    _validate(stack, mask)
    stack = stack.to(torch.float32)
    n = stack.shape[0]
    valid = _valid(stack, mask)
    count = valid.sum(dim=0)
    lo_i = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"),
                       min=0)[None]
    hi_i = torch.clamp(torch.div(count, 2, rounding_mode="floor"),
                       min=0)[None]
    srt = torch.sort(torch.where(valid, stack, _BIG), dim=0).values
    med = (0.5 * (srt.gather(0, lo_i) + srt.gather(0, hi_i)))[0]
    del srt
    devs = torch.where(valid, (stack - med).abs(), _BIG)
    dsrt = torch.sort(devs, dim=0).values
    del devs
    mad = (0.5 * (dsrt.gather(0, lo_i) + dsrt.gather(0, hi_i)))[0]
    del dsrt
    std = _MAD_TO_STD * mad
    lo = med - sigma_lower * std
    hi = med + sigma_upper * std
    acc = torch.zeros_like(med)
    cnt = torch.zeros_like(med)
    for f in range(n):
        keep = valid[f] & (stack[f] >= lo) & (stack[f] <= hi)
        acc = acc + torch.where(keep, stack[f], 0.0)
        cnt = cnt + keep.to(torch.float32)
    return torch.where(cnt > 0, acc / torch.clamp(cnt, min=1.0), torch.nan)


def mad_ranks_by_merging(srt: torch.Tensor, count: torch.Tensor,
                         med: torch.Tensor):
    """The MAD's two ranks without a second sort, as the K3 kernel takes
    them; a plain statement of the rule for the tests, used by no path.

    ``srt`` (N, ...) holds each pixel's samples sorted ascending with the
    invalid ones last, ``count`` (...) the number of valid ones and ``med``
    (...) their median.  The deviations ``|srt - med|`` of the valid
    samples fall to the median and rise after it: two monotone runs.
    Merging them, smallest first, from the median outwards yields the
    sorted deviations; a deviation past the valid samples is +3.4e38.
    Returns the deviations at ranks ``max((count - 1) // 2, 0)`` and
    ``count // 2``, equal to those ranks of the sorted deviations
    because a rank of a multiset does not depend on its order."""
    n = srt.shape[0]
    lo_i = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), min=0)
    hi_i = torch.clamp(torch.div(count, 2, rounding_mode="floor"), min=0)
    rank = torch.arange(n, device=srt.device).reshape((n,) + (1,) * med.dim())
    # first valid sample that is not below the median
    b = ((srt < med) & (rank < count)).sum(dim=0)
    a = b - 1
    big = torch.full_like(med, _BIG)
    d_lo, d_hi = big.clone(), big.clone()

    def dev(i, inside):
        s = srt.gather(0, i.clamp(0, n - 1)[None])[0]
        return torch.where(inside, (s - med).abs(), big)

    for k in range(n // 2 + 1):
        da, db = dev(a, a >= 0), dev(b, b < count)
        take_a = da <= db
        d = torch.where(take_a, da, db)
        a = torch.where(take_a, a - 1, a)
        b = torch.where(take_a, b, b + 1)
        d_lo = torch.where(lo_i == k, d, d_lo)
        d_hi = torch.where(hi_i == k, d, d_hi)
    return d_lo, d_hi


def mad_ranks_by_search(srt: torch.Tensor, count: torch.Tensor,
                        med: torch.Tensor, end: Optional[torch.Tensor] = None):
    """The MAD's two ranks as the 'cols' routes of K2 and K3 take them
    (``kth_dev`` in csrc/warp_sort.cuh); a plain statement of the rule for
    the tests, used by no path.

    Same arguments and result as :func:`mad_ranks_by_merging`, with
    ``end`` (default ``count``) the samples whose deviations take part
    (K2 passes N: its uncovered samples' deviations rank too).  With
    ``p`` the first of them not below the median, the deviations form two
    ascending runs, A(i) = |srt[p-1-i] - med| and B(j) = |srt[p+j] - med|;
    the k-th smallest of their union takes i of the first k + 1 from A,
    where i is the first with A(i) >= B(k-i), found by bisection.  It is
    the k-th of the merged runs whatever order ties take."""
    n = srt.shape[0]
    end = count if end is None else end
    lo_i = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), min=0)
    hi_i = torch.clamp(torch.div(count, 2, rounding_mode="floor"), min=0)
    rank = torch.arange(n, device=srt.device).reshape((n,) + (1,) * med.dim())
    p = ((srt < med) & (rank < end)).sum(dim=0)

    def dev(i):
        s = srt.gather(0, i.clamp(0, n - 1)[None])[0]
        return (s - med).abs()

    def kth(k):
        na, nb = p, end - p
        lo = torch.clamp(k + 1 - nb, min=0)
        hi = torch.minimum(k + 1, na)
        for _ in range(max(n, 1).bit_length() + 1):
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            more = (lo < hi) & (dev(p - 1 - mid) < dev(p + k - mid))
            lo, hi = torch.where(more, mid + 1, lo), \
                torch.where((lo < hi) & ~more, mid, hi)
        j = k + 1 - lo
        a = torch.where(lo > 0, dev(p - lo), 0.0)
        b = torch.where(j > 0, dev(p + j - 1), 0.0)
        return torch.maximum(a, b)

    return kth(lo_i), kth(hi_i)


def float_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone integer keys of float32 values (``float_key`` in
    csrc/warp_sort.cuh): key(x) < key(y) exactly when x < y, -0 and +0
    one key.  int64 holding the unsigned 32-bit key."""
    x = torch.where(x == 0, torch.zeros_like(x), x.to(torch.float32))
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def float_of_keys(t: torch.Tensor) -> torch.Tensor:
    """float32 values of :func:`float_keys` (a zero comes back +0)."""
    u = torch.where(t >= 0x80000000, t & 0x7FFFFFFF, 0xFFFFFFFF - t)
    return torch.where(u >= 0x80000000, u - (1 << 32), u) \
        .to(torch.int32).view(torch.float32)


def rank_by_bisection(values: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The value at rank ``k`` (...) of each column of ``values`` (N,
    ...) without a sort, as K2's runs past the 'cols' reach take it; a
    plain statement of the rule for the tests, used by no path.  It is
    the smallest key t whose count of keys at or below it exceeds k,
    bisected over the 32 key bits: the key of the sorted column's
    element k, so the sort's value (a zero as +0)."""
    keys = float_keys(values)
    lo = torch.zeros_like(k, dtype=torch.int64)
    hi = torch.full_like(lo, 0xFFFFFFFF)
    for _ in range(32):
        mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        many = (keys <= mid[None]).sum(dim=0) > k
        lo, hi = torch.where(many, lo, mid + 1), torch.where(many, mid, hi)
    return float_of_keys(lo)


def pair_by_radix(values: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor):
    """The values at ranks ``lo`` and ``hi`` (...), hi = lo or lo + 1, of
    each column of ``values`` (N, ...) without a sort, as K3's 'select'
    route takes them; a plain statement of the rule for the tests, used by
    no path.  An MSB-first radix select over the monotone keys
    (:func:`float_keys`), one 8-bit digit a pass: count the digits of the
    keys that match the digits found so far, walk the counts to the
    bucket of lo's rank.  hi shares lo's walk while it shares lo's bucket;
    where it leaves it, it is the first key of the next non-empty bucket,
    so the next pass takes it as the least key with that prefix (a split
    at the last digit is the key itself).  Returns the two values (a zero
    as +0)."""
    keys = float_keys(values)
    n = keys.shape[0]
    keys = keys.reshape(n, -1)
    ra = lo.reshape(-1).to(torch.int64).clone()
    off = (hi.reshape(-1) - lo.reshape(-1)).to(torch.int64)
    pa = torch.zeros_like(ra)
    pb = torch.zeros_like(ra)
    mode = torch.zeros_like(ra)          # 0 shared, 1 takes a min, 2 done
    for level in range(4):
        up, dn = 32 - 8 * level, 24 - 8 * level
        match = torch.ones_like(keys, dtype=torch.bool) if level == 0 \
            else (keys >> up) == pa[None]
        digit = (keys >> dn) & 0xFF
        hist = torch.zeros((256, keys.shape[1]), dtype=torch.int64,
                           device=keys.device)
        hist.scatter_add_(0, digit, match.to(torch.int64))
        if level > 0:
            in_b = (keys >> up) == pb[None]
            hmin = torch.where(in_b, keys, 0xFFFFFFFF).min(dim=0).values
            pb = torch.where(mode == 1, hmin, pb)
        cum = hist.cumsum(0)
        shared = (mode == 0) & (off == 1)
        da = (cum <= ra[None]).sum(0)
        db = (cum <= torch.where(shared, ra + 1, ra)[None]).sum(0)
        split = shared & (db != da)
        pb = torch.where(split, (pa << 8) | db, pb)
        mode = torch.where(mode == 1, 2, torch.where(
            split, 1 if level < 3 else 2, mode))
        ra = ra - (cum - hist).gather(0, da[None])[0]
        pa = (pa << 8) | da
    kb = torch.where(mode == 2, pb, pa)
    shape = values.shape[1:]
    return (float_of_keys(pa).reshape(shape),
            float_of_keys(kb).reshape(shape))


@numpy_inputs("stack", "mask")
def clip_combine(stack: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 sigma_lower: float = 5.0,
                 sigma_upper: float = 5.0) -> torch.Tensor:
    """Sigma-clipped average of an (N, H, W) float32 stack over axis 0.

    ``mask`` (N, H, W) marks valid samples: bool, or numeric with > 0.5
    valid; None = all valid.  Returns (H, W) float32, NaN where no
    sample is kept.  CUDA tensors run the hand-written kernel; CPU
    tensors run :func:`clip_combine_plain`."""
    _validate(stack, mask)
    if stack.device.type == "cpu":
        return clip_combine_plain(stack, mask, sigma_lower, sigma_upper)
    if stack.device.type != "cuda":
        raise ValueError(f"no clip_combine kernel for device {stack.device}")
    from .. import kernels

    return kernels.clip_combine_cuda(stack, mask, float(sigma_lower),
                                     float(sigma_upper))
