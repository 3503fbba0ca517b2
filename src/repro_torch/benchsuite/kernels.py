"""PyTorch implementations of the benchmark kernels (paper §V-B).

Kernels are pure functions of the device values of their argument list (in
argument order, including output placeholders) and return the new values of
their writable arguments — the executor installs results into the
ManagedArray handles.  Taken/derived from the open-source suites the paper
cites (CUDA samples, LightSpMV, cuda-gaussian-blur, Kepler reduction post).

Each is a few torch ops on the tensors' own device; none reads a value back
to the host, so a lane's stream never waits on the host inside a kernel.
Output placeholders are read for their shape only (the executor hands a
never-uploaded ``out`` argument over as an uninitialized tensor).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- VEC ----
def k_square(x, _y):
    return x * x


def k_reduce_diff(y1, y2, _z):
    return torch.sum(y1 - y2).reshape(1)


# ---------------------------------------------------------------- B&S ----
def _ndtr(x):
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0)))


def k_black_scholes(s, _out):
    """European call, CUDA-samples parameterization, in the dtype of ``s``
    (float64 in the benchmark, as declared)."""
    K, r, sigma, T = 60.0, 0.035, 0.2, 1.0
    sqrt_t = math.sqrt(T)
    d1 = (torch.log(s / K) + (r + 0.5 * sigma * sigma) * T) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s * _ndtr(d1) - K * math.exp(-r * T) * _ndtr(d2)


# ---------------------------------------------------------------- IMG ----
def _gauss_kernel(ksize: int, sigma: float) -> np.ndarray:
    ax = np.arange(ksize) - (ksize - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k2 = np.outer(g, g)
    return (k2 / k2.sum()).astype(np.float32)


def _sobel_x() -> np.ndarray:
    return np.asarray([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)


_FILTERS: Dict[Tuple, torch.Tensor] = {}


def _filter(name: str, make, device, dtype) -> torch.Tensor:
    """A constant filter, made in numpy and uploaded once per device and
    dtype: an upload from pageable memory on every call would synchronize
    the calling lane's stream."""
    key = (name, torch.device(device), dtype)
    w = _FILTERS.get(key)
    if w is None:
        w = torch.from_numpy(make()).to(device=device, dtype=dtype)
        if w.is_cuda:   # complete before another lane's stream reads it
            torch.cuda.current_stream(w.device).synchronize()
        _FILTERS[key] = w
    return w


def _conv2d_same(img, kern):
    """img: (H, W); kern: (k, k) — SAME padding, NCHW conv underneath.
    Like ``lax.conv_general_dilated`` a cross-correlation (the filter is
    not flipped), zero-padded, at stride 1."""
    return F.conv2d(img[None, None], kern[None, None], padding="same")[0, 0]


def k_gaussian_blur(img, _out, *, ksize: int, sigma: float):
    kern = _filter(f"gauss{ksize}/{sigma}",
                   lambda: _gauss_kernel(ksize, sigma), img.device, img.dtype)
    return _conv2d_same(img, kern)


def k_sobel(img, _out):
    gx = _filter("sobel_x", _sobel_x, img.device, img.dtype)
    gy = _filter("sobel_y", lambda: _sobel_x().T.copy(), img.device,
                 img.dtype)
    ex = _conv2d_same(img, gx)
    ey = _conv2d_same(img, gy)
    g = torch.sqrt(ex * ex + ey * ey)
    return g / (torch.max(g) + 1e-6)


def k_extend_mask(mask, _out):
    """Dilate + normalize the edge mask (paper's `extend` kernel): a 5x5
    max window, SAME, padded with -inf."""
    m = F.max_pool2d(mask[None, None], 5, stride=1, padding=2)[0, 0]
    lo, hi = torch.min(m), torch.max(m)
    return (m - lo) / (hi - lo + 1e-6)


def k_unsharpen(img, blur, _out):
    return torch.clamp(img + 0.5 * (img - blur), 0.0, 1.0)


def k_combine(sharp, blur_med, mask, _out):
    return sharp * mask + blur_med * (1.0 - mask)


def k_combine_low(comb, blur_low, mask, _out):
    return comb * mask + blur_low * (1.0 - mask)


# ----------------------------------------------------------------- ML ----
def k_nb_scores(x, feat_logprob, class_logprior, _out):
    """Categorical Naive-Bayes log-posteriors — the tall-matrix low-IPC
    kernel of §V-F (rows >> classes)."""
    return x @ feat_logprob.T + class_logprior[None, :]


def k_ridge_scores(x, w, b, _out):
    return x @ w.T + b[None, :]


def k_softmax_norm(scores, _out):
    m = torch.amax(scores, dim=1, keepdim=True)
    e = torch.exp(scores - m)
    return e / torch.sum(e, dim=1, keepdim=True)


def k_ensemble_avg(p1, p2, _out):
    # argmax picks the first maximum, as jnp.argmax does
    return torch.argmax(0.5 * (p1 + p2), dim=1).to(torch.int32)


# --------------------------------------------------------------- HITS ----
def k_spmv(vals, cols, rows, x, _y):
    """CSR-ish SpMV (COO row index + segment sum), LightSpMV-derived.  On
    CUDA ``index_add_`` sums by atomics, so the order of the sums (and the
    last bits) may differ from run to run."""
    n = _y.shape[0]
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, rows, vals * x.index_select(0, cols))


def k_l2_norm(x, _out):
    return torch.sqrt(torch.sum(x * x)).reshape(1)


def k_divide(x, norm, _out):
    return x / (norm[0] + 1e-12)


# ----------------------------------------------------------------- DL ----
def k_conv_relu_pool(x, w, _out, *, stride: int = 1):
    """x: (N,C,H,W), w: (O,C,k,k) -> conv + relu + 2x2 maxpool."""
    if stride != 1:     # F.conv2d pads "same" at stride 1 only
        raise ValueError(f"k_conv_relu_pool: stride {stride} is not "
                         f"supported (SAME padding at stride 1 only)")
    y = torch.relu(F.conv2d(x, w, padding="same"))
    return F.max_pool2d(y, 2, stride=2)     # VALID: the odd edge is dropped


def k_dense_embed(x, w, _out):
    flat = x.reshape((x.shape[0], -1))
    return torch.tanh(flat @ w)


def k_concat_dense(e1, e2, w, _out):
    h = torch.cat([e1, e2], dim=1) @ w
    return 1.0 / (1.0 + torch.exp(-h))


# ======================================================================
# Declared GrFunctions (the polyglot frontend surface, paper §III-IV)
# ======================================================================
# Access modes are declared exactly once, here with the kernel; the
# benchmark builders then call these like plain functions — per-call
# const/out annotation boilerplate is gone.  ``with_options`` attaches the
# per-call cost model / occupancy / display name without forking identity.
from ..core.frontend import function as _gr_function

SQUARE = _gr_function(k_square, modes=("const", "out"), outputs=0,
                      name="SQ")
REDUCE_DIFF = _gr_function(k_reduce_diff, modes=("const", "const", "out"),
                           name="RED")
BLACK_SCHOLES = _gr_function(k_black_scholes, modes=("const", "out"),
                             outputs=0, name="BS")
BLUR_S = _gr_function(functools.partial(k_gaussian_blur, ksize=3, sigma=1.0),
                      modes=("const", "out"), name="BLUR_S")
BLUR_M = _gr_function(functools.partial(k_gaussian_blur, ksize=7, sigma=2.5),
                      modes=("const", "out"), name="BLUR_M")
BLUR_L = _gr_function(functools.partial(k_gaussian_blur, ksize=13, sigma=5.0),
                      modes=("const", "out"), name="BLUR_L")
SOBEL = _gr_function(k_sobel, modes=("const", "out"), name="SOBEL")
EXTEND_MASK = _gr_function(k_extend_mask, modes=("const", "out"),
                           name="EXTEND")
UNSHARPEN = _gr_function(k_unsharpen, modes=("const", "const", "out"),
                         name="UNSHARP")
COMBINE = _gr_function(k_combine, modes=("const", "const", "const", "out"),
                       name="COMBINE")
COMBINE_LOW = _gr_function(k_combine_low,
                           modes=("const", "const", "const", "out"),
                           name="COMBINE_LOW")
NB_SCORES = _gr_function(k_nb_scores,
                         modes=("const", "const", "const", "out"), name="NB")
RIDGE_SCORES = _gr_function(k_ridge_scores,
                            modes=("const", "const", "const", "out"),
                            name="RIDGE")
SOFTMAX_NORM = _gr_function(k_softmax_norm, modes=("const", "out"),
                            name="SOFTMAX")
ENSEMBLE_AVG = _gr_function(k_ensemble_avg, modes=("const", "const", "out"),
                            name="ARGMAX")
SPMV = _gr_function(k_spmv,
                    modes=("const", "const", "const", "const", "out"),
                    name="SPMV",
                    lint_shapes=(((8,), np.float32), ((8,), np.int32),
                                 ((8,), np.int32), ((8,), np.float32),
                                 ((8,), np.float32)))
L2_NORM = _gr_function(k_l2_norm, modes=("const", "out"), name="NORM")
# DIVIDE never reads the prior value of its destination (pure x/norm
# store); ``inout`` here forced a spurious prefetch of dead data.  The
# WAR edges against this iteration's SpMV readers come from the *write*
# and are identical under ``out``.
DIVIDE = _gr_function(k_divide, modes=("const", "const", "out"),
                      name="DIV")
CONV_RELU_POOL = _gr_function(k_conv_relu_pool,
                              modes=("const", "const", "out"), name="CONV",
                              lint_shapes=(((1, 1, 8, 8), np.float32),
                                           ((1, 1, 3, 3), np.float32),
                                           ((1, 1, 4, 4), np.float32)))
DENSE_EMBED = _gr_function(k_dense_embed, modes=("const", "const", "out"),
                           name="DENSE")
CONCAT_DENSE = _gr_function(k_concat_dense,
                            modes=("const", "const", "const", "out"),
                            name="HEAD",
                            lint_shapes=(((8, 4), np.float32),
                                         ((8, 4), np.float32),
                                         ((8, 1), np.float32),
                                         ((8, 1), np.float32)))
