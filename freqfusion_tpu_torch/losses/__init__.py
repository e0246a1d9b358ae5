"""Training losses: the weight-driven combined loss of the reference, on NHWC tensors.

Twin of ``freqfusion_tpu/losses/__init__.py``: L1 / L2 / Charbonnier / SSIM (11x11 sigma 1.5
window, zero-padded same filtering) / FFT (ortho ``torch.fft.fft2`` + fftshift, magnitude +
0.1 phase, radial 2x high-frequency weighting) / SWT (stationary wavelet by dilated
depthwise convs with reflect padding, band weights a 0.5, h 1.5, v 1.5, d 2.0) / Sobel
edge, dispatched by ``CombinedLoss``, which computes a component only when its weight is
positive and swaps weights per training stage (``set_weights``).

The VGG and CLIP perceptual losses (``losses/vgg.py``, ``losses/clip.py``) go live where
``FREQFUSION_VGG19_WEIGHTS`` / ``FREQFUSION_CLIP_WEIGHTS`` name a checkpoint; without a
backbone, or with a checkpoint that fails to load, their weight moves to the FFT loss with a
warning, as in the JAX package.

The wavelet filters are built in numpy, as the JAX package builds them (the port keeps its
own copy of those functions).
"""

from __future__ import annotations

import functools
import re
import warnings
from itertools import product as _product
from math import comb
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.common import gaussian_blur
from .clip import CLIPPerceptualLoss
from .vgg import VGGPerceptualLoss

# pywt wavelet decomposition filters. haar/db4 are the shipped-recipe pair
# (pinned published constants); every other dbN is constructed on demand —
# see wavelet_filters below. The reference accepts any pywt wavelet name
# (perceptual_loss.py:625-682); pywt isn't installed here, so the Daubechies
# construction itself is implemented.
_WAVELETS = {
    "haar": ([0.7071067811865476, 0.7071067811865476],
             [-0.7071067811865476, 0.7071067811865476]),
    "db4": ([-0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
             -0.18703481171888114, -0.027983769416983849, 0.63088076792959036,
             0.71484657055291582, 0.23037781330885523],
            [-0.23037781330885523, 0.71484657055291582, -0.63088076792959036,
             -0.027983769416983849, 0.18703481171888114, 0.030841381835986965,
             -0.032883011666982945, -0.010597401784997278]),
}


# Pinned published pywt dec_lo tables for the non-dbN orthogonal families
# the reference accepts through pywt (perceptual_loss.py:661-683). sym4-10
# and coif1-3 are the published constants; coif4/coif5 were generated by
# solving the defining coiflet system (orthonormality + 2N wavelet moments +
# 2N-1 scaling moments about k=2N, Gauss-Newton continuation from coif3 —
# reproduces the published coif2/coif3 to 1e-13 and coif4's published
# endpoint digits to 6e-12).
_DEC_LO = {
    "sym4": [-0.07576571478927333, -0.02963552764599851, 0.49761866763201545,
        0.8037387518059161, 0.29785779560527736, -0.09921954357684722,
        -0.012603967262037833, 0.0322231006040427],
    "sym5": [0.027333068345077982, 0.029519490925774643,
        -0.039134249302383094, 0.1993975339773936, 0.7234076904024206,
        0.6339789634582119, 0.01660210576452232, -0.17532808990845047,
        -0.021101834024758855, 0.019538882735286728],
    "sym6": [0.015404109327027373, 0.0034907120842174702,
        -0.11799011114819057, -0.048311742585633, 0.4910559419267466,
        0.787641141030194, 0.3379294217276218, -0.07263752278646252,
        -0.021060292512300564, 0.04472490177066578, 0.0017677118642428036,
        -0.007800708325034148],
    "sym7": [0.002681814568257878, -0.0010473848886829163,
        -0.01263630340325193, 0.03051551316596357, 0.0678926935013727,
        -0.049552834937127255, 0.017441255086855827, 0.5361019170917628,
        0.767764317003164, 0.2886296317515146, -0.14004724044296152,
        -0.10780823770381774, 0.004010244871533663, 0.010268176708511255],
    "sym8": [-0.0033824159510061256, -0.0005421323317911481,
        0.03169508781149298, 0.007607487324917605, -0.1432942383508097,
        -0.061273359067658524, 0.4813596512583722, 0.7771857517005235,
        0.3644418948353314, -0.05194583810770904, -0.027219029917056003,
        0.049137179673607506, 0.003808752013890615, -0.01495225833704823,
        -0.0003029205147213668, 0.0018899503327594609],
    "sym9": [0.0014009155259146807, 0.0006197808889855868,
        -0.013271967781817119, -0.01152821020767923, 0.03022487885827568,
        0.0005834627461258068, -0.05456895843083407, 0.238760914607303,
        0.717897082764412, 0.6173384491409358, 0.035272488035271894,
        -0.19155083129728512, -0.018233770779395985, 0.06207778930288603,
        0.008859267493400484, -0.010264064027633142, -0.0004731544986800831,
        0.0010694900329086053],
    "sym10": [0.0007701598091144901, 9.563267072289475e-05,
        -0.008641299277022422, -0.0014653825813050513, 0.0459272392310922,
        0.011609893903711381, -0.15949427888491757, -0.07088053578324385,
        0.47169066693843925, 0.7695100370211071, 0.38382676106708546,
        -0.03553674047381755, -0.0319900568824278, 0.04999497207737669,
        0.005764912033581909, -0.02035493981231129, -0.0008043589320165449,
        0.004593173585311828, 5.7036083618494284e-05, -0.0004593294210046588],
    "coif1": [-0.015655728135791993, -0.07273261951252645, 0.3848648468648578,
        0.8525720202116004, 0.3378976624574818, -0.07273261951252645],
    "coif2": [-0.000720549445520347, -0.0018232088709110323,
        0.005611434819368834, 0.02368017194684777, -0.05943441864643109,
        -0.07648859907828076, 0.4170051844232391, 0.8127236354494135,
        0.3861100668227629, -0.0673725547237256, -0.04146493678687178,
        0.01638733646320364],
    "coif3": [-3.459977319727278e-05, -7.0983302506379e-05,
        0.0004662169598204029, 0.0011175187708306303, -0.0025745176881367972,
        -0.009007976136730624, 0.015880544863669452, 0.03455502757329774,
        -0.08230192710629983, -0.07179982161915484, 0.42848347637737,
        0.7937772226260872, 0.40517690240911824, -0.06112339000297255,
        -0.06577191128146936, 0.023452696142077168, 0.007782596425672746,
        -0.003793512864380802],
    "coif4": [-1.7849909148405889e-06, -3.2596479409959243e-06,
        3.122986160406981e-05, 6.233885432043716e-05, -0.0002599743371403529,
        -0.0005890202247032636, 0.001266561079017235, 0.0037514346974983305,
        -0.005658283800681649, -0.015211728188593872, 0.025082253339896752,
        0.03933442260672615, -0.09622042453998508, -0.06662747236719112,
        0.4343860331195488, 0.7822389344233617, 0.4153084269964363,
        -0.05607731960210315, -0.08126671024703892, 0.026682304668614754,
        0.016068947130954785, -0.007346167935931499, -0.0016294924251495162,
        0.0008923139024901496],
    "coif5": [-9.05951149045319e-08, -1.5706551799969984e-07,
        1.992811788378845e-06, 3.5443398591502924e-06,
        -2.0678356078841527e-05, -4.010242476571412e-05,
        0.00013787806624868172, 0.000294987848869635, -0.0006285602376936251,
        -0.0016270840241063842, 0.0023856938246119676, 0.006649284169435578,
        -0.00896388342858171, -0.019536968892774224, 0.03212947467074835,
        0.041043695882243776, -0.10455990482157826, -0.06196313249035991,
        0.436726464330325, 0.7744832033274632, 0.42265414921556366,
        -0.052371087303500034, -0.09255769655914568, 0.028426921424944473,
        0.02365230886887117, -0.010249145249390154, -0.004214556292529639,
        0.002208207618317769, 0.00036418968940358853, -0.000215385973881033],
}


def _qmf_hi(dec_lo):
    """Orthogonal high-pass from dec_lo, pywt convention (see _daubechies)."""
    L = len(dec_lo)
    return [(-1.0) ** (k + 1) * dec_lo[L - 1 - k] for k in range(L)]


@functools.lru_cache(maxsize=None)
def wavelet_filters(name: str):
    """(dec_lo, dec_hi) for a pywt wavelet name, matching pywt's layout.

    Families (the reference accepts any pywt wavelet through
    perceptual_loss.py:661-683; pywt isn't installed here, so each family
    is constructed or pinned):
    - haar / dbN (N≤20): spectral factorization of the half-band polynomial
      P(y)=Σ C(N-1+k,k)·yᵏ, minimal-phase root selection — exactly how the
      published tables are generated.
    - symN: sym1-3 alias db1-3 (identical filters); sym4-10 are the pinned
      published tables; sym11-20 use the same factorization machinery with
      least-asymmetric root selection (minimal L2 phase nonlinearity).
      pywt's tabulated choice for N>10 may differ in near-tie cases — all
      selections satisfy orthonormality + N vanishing moments exactly.
    - coif1-5: pinned tables (see _DEC_LO provenance note).
    - biorNr.Nd / rbioNr.Nd: exact CDF B-spline construction (1.1-3.9);
      bior4.4 is the 9/7 factorization (real root of P₄ to the synthesis
      side). bior5.5/6.8 use non-spline constructions and are not
      supported. dec_hi is zero-padded to dec_lo's length as pywt does;
      the high-pass global sign matches the qmf convention (band-invariant
      for the SWT loss — both operands transform identically).
    """
    if name in _WAVELETS:
        return _WAVELETS[name]
    if name in _DEC_LO:
        lo = list(_DEC_LO[name])
        return (lo, _qmf_hi(lo))
    alias = {"db1": "haar", "sym1": "haar", "sym2": "db2", "sym3": "db3"}
    if name in alias:
        return wavelet_filters(alias[name])
    m = re.fullmatch(r"(db|sym)(\d+)", name)
    if m and 1 <= int(m.group(2)) <= 20:
        n = int(m.group(2))
        return (_daubechies(n) if m.group(1) == "db"
                else _symlet(n))
    m = re.fullmatch(r"(bior|rbio)(\d)\.(\d)", name)
    if m:
        return _bior(int(m.group(2)), int(m.group(3)),
                     reverse=m.group(1) == "rbio")
    raise ValueError(
        f"unsupported wavelet {name!r}: haar, dbN/symN (N<=20), coif1-5, "
        "biorNr.Nd / rbioNr.Nd (spline family + 4.4)")


def _halfband_roots(n: int):
    """Roots of P(y)=Σ C(N-1+k,k)·yᵏ grouped for spectral factorization:
    [(z_in, z_out, is_complex_pair)] — z_in/z_out are the reciprocal z-roots
    of z² − (2−4y)z + 1 (|z_in| < 1); complex y-roots are kept once (the
    conjugate is implied)."""
    p = np.array([comb(n - 1 + k, k) for k in range(n - 1, -1, -1)], float)
    groups = []
    for y0 in (np.roots(p) if n > 1 else []):
        if abs(np.imag(y0)) > 1e-10 and np.imag(y0) < 0:
            continue                       # conjugate handled with its twin
        zs = np.roots([1.0, -(2.0 - 4.0 * y0), 1.0])
        groups.append((zs[np.argmin(np.abs(zs))], zs[np.argmax(np.abs(zs))],
                       abs(np.imag(y0)) > 1e-10))
    return groups


def _assemble(n: int, selection, groups):
    """(1+z)^n times the selected z-roots (conjugate-closed), Σh=√2."""
    poly = np.poly1d([1.0])
    for _ in range(n):
        poly = poly * np.poly1d([1.0, 1.0])
    for sel, (z_in, z_out, is_c) in zip(selection, groups):
        z = z_in if sel == 0 else z_out
        if is_c:
            poly = poly * np.poly1d(
                np.real(np.poly(np.array([z, np.conj(z)]))))
        else:
            poly = poly * np.poly1d([1.0, -np.real(z)])
    h = np.real(poly.coeffs)
    return h * (np.sqrt(2.0) / h.sum())


def _daubechies(n: int):
    """Minimal-phase Daubechies-n (dec_lo, dec_hi), pywt layout."""
    groups = _halfband_roots(n)
    h = _assemble(n, [0] * len(groups), groups)   # all |z| < 1: min phase
    dec_lo = h[::-1]
    return (dec_lo.tolist(), _qmf_hi(dec_lo.tolist()))


def _symlet(n: int):
    """Least-asymmetric Daubechies-n: same half-band factorization, root
    selection minimizing the L2 phase nonlinearity over all conjugate-closed
    reciprocal choices (2^G combos, G≤10). Used for sym11-20; sym4-10 ship
    as pinned published tables (_DEC_LO) since pywt's tabulated choice is
    not reproducible from a single closed-form criterion in tie cases."""
    groups = _halfband_roots(n)
    w = np.linspace(1e-4, np.pi - 1e-4, 512)
    ew = np.exp(-1j * w)
    A = np.vstack([w, np.ones_like(w)]).T
    pinvA = np.linalg.pinv(A)
    best = None
    for combo in _product([0, 1], repeat=len(groups)):
        h = _assemble(n, combo, groups)
        ph = np.unwrap(np.angle(np.polyval(h, ew)))
        dev = float(np.sum((ph - A @ (pinvA @ ph)) ** 2))
        if best is None or dev < best[0] - 1e-12:
            best = (dev, h)
    h = best[1]
    # orientation is a free reflection; fix it deterministically (energy
    # center in the first half). Band-invariant for the SWT loss.
    k = np.arange(len(h))
    if float(np.sum(k * h * h)) > (len(h) - 1) / 2:
        h = h[::-1]
    dec_lo = h[::-1]
    return (dec_lo.tolist(), _qmf_hi(dec_lo.tolist()))


# pywt's bior catalogue: the B-spline CDF family plus the 9/7 (4.4).
_BIOR_SUPPORTED = {(1, 1), (1, 3), (1, 5), (2, 2), (2, 4), (2, 6), (2, 8),
                   (3, 1), (3, 3), (3, 5), (3, 7), (3, 9), (4, 4)}


def _bior(nr: int, nd: int, reverse: bool = False):
    """CDF biorthogonal spline filters (dec_lo, dec_hi), pywt layout.

    rec_lo = √2·((1+z)/2)^Nr (B-spline); dec_lo = √2·((1+z)/2)^Nd ·
    P_q((2−z−z⁻¹)/4) with q=(Nr+Nd)/2 — exact polynomial arithmetic
    (verified: reproduces the published bior1.3/2.2 tables). bior4.4 is
    the 9/7 split: P₄'s complex pair goes to the analysis side, the real
    root to the synthesis side. dec_hi comes from rec_lo by the qmf rule
    and is zero-padded (centered) to dec_lo's length, as pywt does.
    bior5.5/6.8 use non-spline constructions pywt tabulates; unsupported.
    """
    if (nr, nd) not in _BIOR_SUPPORTED:
        raise ValueError(
            f"unsupported bior/rbio order {nr}.{nd}: spline family "
            f"{sorted(_BIOR_SUPPORTED)} only (5.5/6.8 are non-spline)")
    q = (nr + nd) // 2

    def y_to_z(y0):
        return np.roots([1.0, -(2.0 - 4.0 * y0), 1.0])

    def spline(npow):
        poly = np.poly1d([1.0])
        for _ in range(npow):
            poly = poly * np.poly1d([1.0, 1.0])
        return poly

    p = np.array([comb(q - 1 + k, k) for k in range(q - 1, -1, -1)], float)
    roots_y = np.roots(p) if q > 1 else []
    if (nr, nd) == (4, 4):
        # 9/7: complex pair → analysis (9 taps), real root → synthesis (7)
        dec = spline(nd)
        rec = spline(nr)
        for y0 in roots_y:
            if abs(np.imag(y0)) < 1e-10:
                rec = rec * np.poly1d([1.0, -(2.0 - 4.0 * np.real(y0)), 1.0])
            elif np.imag(y0) > 0:
                zs = np.concatenate([y_to_z(y0), y_to_z(np.conj(y0))])
                dec = dec * np.poly1d(np.real(np.poly(zs)))
    else:
        dec = spline(nd)
        rec = spline(nr)
        for y0 in roots_y:
            if abs(np.imag(y0)) < 1e-10:
                dec = dec * np.poly1d([1.0, -(2.0 - 4.0 * np.real(y0)), 1.0])
            elif np.imag(y0) > 0:
                zs = np.concatenate([y_to_z(y0), y_to_z(np.conj(y0))])
                dec = dec * np.poly1d(np.real(np.poly(zs)))
    dec_lo = np.real(dec.coeffs)
    dec_lo = dec_lo * (np.sqrt(2.0) / dec_lo.sum())
    rec_lo = np.real(rec.coeffs)
    rec_lo = rec_lo * (np.sqrt(2.0) / rec_lo.sum())
    if reverse:                      # rbio: decomposition uses the dual pair
        dec_lo, rec_lo = rec_lo, dec_lo
    dec_hi = np.asarray(_qmf_hi(rec_lo.tolist()))
    # equalize lengths (centered zero pad) for the separable SWT build
    if len(dec_hi) < len(dec_lo):
        d = len(dec_lo) - len(dec_hi)
        dec_hi = np.pad(dec_hi, (d // 2, d - d // 2))
    elif len(dec_lo) < len(dec_hi):
        d = len(dec_hi) - len(dec_lo)
        dec_lo = np.pad(dec_lo, (d // 2, d - d // 2))
    return (dec_lo.tolist(), dec_hi.tolist())


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().mean()


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.sqrt((pred - target).square() + eps * eps).mean()


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """1 - mean SSIM with an 11x11 sigma 1.5 window, zero-padded same filtering (the JAX
    package's banded-matrix blur is a TPU form of the same conv)."""
    def filt(x):
        return gaussian_blur(x, window_size, 1.5)

    mu1, mu2 = filt(pred), filt(target)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(pred * pred) - mu1_sq
    s2 = filt(target * target) - mu2_sq
    s12 = filt(pred * target) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    smap = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return 1.0 - smap.mean()


@functools.lru_cache(maxsize=None)
def _radial_weights(h: int, w: int, high_weight: float) -> np.ndarray:
    cy, cx = h // 2, w // 2
    yy, xx = np.meshgrid(np.arange(h) - cy, np.arange(w) - cx, indexing="ij")
    dist = np.sqrt(xx ** 2 + yy ** 2) / np.sqrt(cy ** 2 + cx ** 2)
    return (1.0 + (high_weight - 1.0) * dist).astype(np.float32)


def fft_loss(pred: torch.Tensor, target: torch.Tensor,
             high_freq_weight: float = 2.0) -> torch.Tensor:
    """L1 on the centered spectrum's magnitude + 0.1 phase, radially weighted."""
    def spectrum(x):
        f = torch.fft.fftshift(torch.fft.fft2(x, dim=(1, 2), norm="ortho"), dim=(1, 2))
        return f.real, f.imag

    pre, pim = spectrum(pred)
    tre, tim = spectrum(target)
    pmag = torch.sqrt(pre ** 2 + pim ** 2 + 1e-12)
    tmag = torch.sqrt(tre ** 2 + tim ** 2 + 1e-12)
    wts = torch.from_numpy(_radial_weights(pred.shape[1], pred.shape[2],
                                           high_freq_weight)).to(pred)[None, :, :, None]
    mag = ((pmag - tmag).abs() * wts).mean()
    phase = ((torch.atan2(pim, pre) - torch.atan2(tim, tre)).abs() * wts).mean()
    return mag + 0.1 * phase


def _swt_coeffs(x: torch.Tensor, wavelet: str, level: int):
    """Stationary wavelet coefficients by dilated depthwise convs with reflect padding: a
    list over levels of (approximation, horizontal, vertical, diagonal), each NHWC."""
    lo, hi = (np.asarray(f, np.float32) for f in wavelet_filters(wavelet))
    k = len(lo)
    base = np.stack([np.outer(lo, lo), np.outer(hi, lo), np.outer(lo, hi), np.outer(hi, hi)])
    b, h, w, c = x.shape
    kern = torch.from_numpy(base).to(x)[:, None].repeat(c, 1, 1, 1)   # [4c,1,k,k]
    coeffs, current = [], x
    for lvl in range(level):
        dil = 2 ** lvl
        pad = (k - 1) * dil
        xp = F.pad(current.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
        out = F.conv2d(xp, kern, dilation=dil, groups=c)[:, :, :h, :w]
        out = out.reshape(b, c, 4, h, w).permute(2, 0, 3, 4, 1)        # [4,B,H,W,C]
        coeffs.append(tuple(out))
        current = out[0]
    return coeffs


def swt_loss(pred: torch.Tensor, target: torch.Tensor, wavelet: str = "db4", level: int = 2,
             band_weights=(0.5, 1.5, 1.5, 2.0)) -> torch.Tensor:
    pc = _swt_coeffs(pred, wavelet, level)
    tc = _swt_coeffs(target, wavelet, level)
    loss = 0.0
    for lvl in range(level):
        for band in range(4):
            loss = loss + band_weights[band] * (pc[lvl][band] - tc[lvl][band]).abs().mean()
    return loss / level


_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)


def edge_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sobel gradient L1, zero-padded same convs."""
    c = pred.shape[-1]

    def grads(x):
        xn = x.permute(0, 3, 1, 2)
        return [F.conv2d(xn, torch.from_numpy(k).to(x).expand(c, 1, 3, 3), padding=1, groups=c)
                for k in (_SOBEL_X, _SOBEL_Y)]

    pgx, pgy = grads(pred)
    tgx, tgy = grads(target)
    return (pgx - tgx).abs().mean() + (pgy - tgy).abs().mean()


DEFAULT_WEIGHTS = {
    "l1": 1.0, "charbonnier": 0.5, "l2": 0.5, "vgg": 0.1, "swt": 0.2,
    "fft": 0.15, "edge": 0.1, "ssim": 0.1, "clip": 0.0,
}

_UNAVAILABLE = ("vgg", "clip")   # need pretrained backbones


class CombinedLoss:
    """Weight-driven multi-loss dispatcher. Only components with a positive weight are
    computed. The perceptual components go live where ``FREQFUSION_VGG19_WEIGHTS`` /
    ``FREQFUSION_CLIP_WEIGHTS`` name a checkpoint; a component without a backbone, or whose
    checkpoint is rejected (with a warning), moves its weight to FFT."""

    def __init__(self, weights: Optional[Dict[str, float]] = None, swt_wavelet: str = "db4",
                 swt_level: int = 2):
        self.swt_wavelet = swt_wavelet
        self.swt_level = swt_level
        self._perceptual = {"vgg": None, "clip": None}
        self.weights: Dict[str, float] = dict(DEFAULT_WEIGHTS)
        if weights is not None:
            self.set_weights(weights)

    def set_weights(self, weights: Dict[str, float]) -> None:
        for k in weights:
            if k not in DEFAULT_WEIGHTS:
                raise KeyError(f"unknown loss component {k!r}")
        self.weights.update(weights)
        makers = {"vgg": VGGPerceptualLoss, "clip": CLIPPerceptualLoss}
        for k in _UNAVAILABLE:
            if self.weights.get(k, 0.0) <= 0 or self._perceptual[k] is not None:
                continue
            try:   # live where the variable names a checkpoint
                self._perceptual[k] = makers[k]()
            except (RuntimeError, KeyError, ValueError, OSError) as e:
                # a malformed or incomplete checkpoint degrades instead of crashing the run
                if not isinstance(e, RuntimeError):
                    warnings.warn(f"{k.upper()} checkpoint rejected: {e!r}")
            if self._perceptual[k] is None:
                warnings.warn(f"{k} perceptual loss unavailable (no pretrained backbone in "
                              "this environment); redirecting its weight to FFT loss")
                self.weights["fft"] = self.weights.get("fft", 0.0) + self.weights[k]
                self.weights[k] = 0.0

    def __call__(self, pred: torch.Tensor,
                 target: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        fns = {
            "l1": l1_loss,
            "l2": l2_loss,
            "charbonnier": charbonnier_loss,
            "ssim": ssim_loss,
            "fft": fft_loss,
            "edge": edge_loss,
            "swt": lambda p, t: swt_loss(p, t, self.swt_wavelet, self.swt_level),
        }
        fns.update((k, fn) for k, fn in self._perceptual.items() if fn is not None)
        total = pred.new_zeros(())
        components = {}
        for name, fn in fns.items():
            wt = float(self.weights.get(name, 0.0))
            if wt > 0.0:
                val = fn(pred, target)
                components[name] = val
                total = total + wt * val
        components["total"] = total
        return total, components
