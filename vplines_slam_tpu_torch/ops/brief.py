"""FAST corners, BRIEF binary descriptors, Hamming matching and the SimHash
place signature: the keyframe features of loop closure.

Port of ``vplines_slam_tpu/ops/brief.py`` (``_CIRCLE``, ``fast_score``,
``detect_fast``, ``brief_pattern``, ``describe_brief``, ``_popcount32``,
``hamming_matrix``, ``match_descriptors``, ``_random_vocab``,
``SIG_CELLS``/``SIG_DIM``, ``global_signature``).  Images are float [H, W]
in [0, 1].

Descriptors are 8 words of 32 bits per keypoint.  The reference stores them
as uint32; the port stores the same bit patterns as int32 (torch's uint32
has no shifts on the CPU), bit j of word w being pattern bit 32·w + j.  The
plain versions popcount in int64 after masking to 32 bits, so no arithmetic
right shift ever sees a negative word.

Three kernels, each a public function here that launches it on a CUDA
tensor and runs its ``*_plain`` twin on a CPU tensor:

- K15 (``csrc/fast.cu``): the whole of ``detect_fast`` in two launches,
  ``fast_tiles`` (the FAST-9 score, the 7x7 max-NMS and a 64-bit key for
  each kept corner, a CTA a 32x32 tile, and a histogram of the keys) and
  ``fast_select`` (one CTA: each of the top-``max_corners`` keys placed at
  its bin's slots by its rank there, in the order of ``lax.top_k`` -- the
  lower index first among equal scores -- and the zero-score fill, with no
  sort); ``fast_score`` is ``fast_tiles`` alone;
- K16 (``csrc/brief.cu``): the 256 bilinear pair tests of
  ``describe_brief``, each keypoint blurring (7 taps, sigma 2) only the
  patch they read, one launch for the two point sets of a keyframe
  (``describe_brief_pair``);
- K17 (``csrc/hamming.cu``): ``match_descriptors`` (and ``hamming_matrix``)
  and the SimHash codes + 2x2 cell pooling + L2 norm of
  ``global_signature``.

``kernels.TWIN_CALLS`` counts the twins' calls, so a run on the card can
show that none was taken.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from .image import bilinear_sample, gaussian_blur, gaussian_kernel1d

FAST_TILES = kernels.Kernel(
    "vp_fast_tiles", "vplines_slam_tpu_torch/csrc/fast.cu", "vplines_slam_tpu/ops/brief.py:34",
    [kernels.P, kernels.I, kernels.I, kernels.F, kernels.I, kernels.P, kernels.P, kernels.P],
)
FAST_SELECT = kernels.Kernel(
    "vp_fast_select", "vplines_slam_tpu_torch/csrc/fast.cu", "vplines_slam_tpu/ops/brief.py:70",
    [kernels.P, kernels.P, kernels.I, kernels.I, kernels.I, kernels.P, kernels.P],
)
MAX_FAST_CORNERS = 4096  # fast_select's largest max_corners (csrc/fast.cu kMaxCorners)
BRIEF = kernels.Kernel(
    "vp_brief_patch", "vplines_slam_tpu_torch/csrc/brief.cu", "vplines_slam_tpu/ops/brief.py:94",
    [kernels.P, kernels.I, kernels.I, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
     kernels.I, kernels.P, kernels.P, kernels.I, kernels.P],
)
HAMMING_MATCH = kernels.Kernel(
    "vp_hamming_match_tiles", "vplines_slam_tpu_torch/csrc/hamming.cu",
    "vplines_slam_tpu/ops/brief.py:128",
    [kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.I, kernels.I, kernels.I,
     kernels.I, kernels.P, kernels.P, kernels.P],
)
SIMHASH = kernels.Kernel(
    "vp_simhash_signature", "vplines_slam_tpu_torch/csrc/hamming.cu",
    "vplines_slam_tpu/ops/brief.py:185",
    [kernels.P, kernels.P, kernels.P, kernels.I, kernels.F, kernels.F, kernels.P, kernels.I,
     kernels.P, kernels.P, kernels.P],
)

# 16-point Bresenham circle of radius 3 (FAST), (dx, dy)
_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
])

_MASK32 = 0xFFFFFFFF


def _f32_only(name, t):
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")


# ---------------------------------------------------------------------------
# K15: FAST-9 + NMS
# ---------------------------------------------------------------------------


def fast_score_plain(img, thresh=0.05):
    """FAST-9 response of every pixel: 0 unless a circular run of >= 9 ring
    pixels is all brighter than center + thresh or all darker than center -
    thresh; else the larger margin sum, summed in ring order.  The 16 px
    border is zero."""
    kernels.TWIN_CALLS["fast"] += 1
    H, W = img.shape
    c = img
    hi, lo = c + thresh, c - thresh
    bright, dark = [], []
    m_b = m_d = None
    for dx, dy in _CIRCLE:
        ring = torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1))
        bright.append(ring > hi)
        dark.append(ring < lo)
        tb = torch.clamp(ring - c - thresh, min=0.0)
        td = torch.clamp(lo - ring, min=0.0)
        m_b = tb if m_b is None else m_b + tb
        m_d = td if m_d is None else m_d + td

    def arc9(masks):
        m = torch.stack(masks, dim=-1)
        acc = m
        for k in range(1, 9):
            acc = acc & torch.roll(m, -k, dims=-1)
        return torch.any(acc, dim=-1)

    is_corner = arc9(bright) | arc9(dark)
    score = torch.where(is_corner, torch.maximum(m_b, m_d), torch.zeros_like(img))
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inb = (yy >= 16) & (yy < H - 16) & (xx >= 16) & (xx < W - 16)
    return torch.where(inb, score, torch.zeros_like(score))


def _nms_plain(score, nms_radius):
    """Keep score where it is the maximum of its (2r+1)^2 window (out-of-image
    neighbours are -inf, ties all survive), else 0."""
    kernels.TWIN_CALLS["nms"] += 1
    k = 2 * nms_radius + 1
    mx = F.max_pool2d(score[None, None], k, stride=1, padding=nms_radius)[0, 0]
    return torch.where(score >= mx, score, torch.zeros_like(score))


_FAST_SCRATCH = {}
FAST_STATE = 3 + 16384  # K15's state: count, bin range, histogram (csrc/fast.cu)


def _fast_scratch(dev, n_px):
    """The device and stream's scratch of K15: its state (the candidate
    count, their bins' range and histogram; 0 between calls:
    ``fast_select`` clears it) and one 64-bit key slot a pixel, so no image
    can overflow it.  Made (one fill launch) the first time, or larger."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    s = _FAST_SCRATCH.get(key)
    if s is None or s[1].numel() < n_px:
        s = (torch.zeros(FAST_STATE, dtype=torch.int32, device=dev),
             torch.empty(n_px, dtype=torch.int64, device=dev))
        _FAST_SCRATCH[key] = s
    return s


def _fast_cuda(img, thresh, max_corners=None):
    """K15 on a CUDA image: the score map (max_corners None, one launch), or
    detect_fast's (xy, valid) in two launches.  Raises before any launch on
    what the kernels do not take."""
    _f32_only("img", img)
    H, W = img.shape
    n_px = H * W
    img = img.contiguous()
    if max_corners is None:
        score = torch.empty_like(img)
        FAST_TILES(kernels.check(img, "img", ndim=2), H, W, float(thresh), 0,
                   kernels.check(score, "score"), None, None)
        return score
    k = int(max_corners)
    if not 1 <= k <= min(MAX_FAST_CORNERS, n_px) or n_px >= 2 ** 24:
        raise ValueError(f"K15 takes 1 <= max_corners <= min({MAX_FAST_CORNERS}, H * W) and "
                         f"H * W < 2**24, got max_corners {k} at {H}x{W}")
    state, keys = _fast_scratch(img.device, n_px)
    xy = torch.empty(k, 2, dtype=img.dtype, device=img.device)
    valid = torch.empty(k, dtype=torch.bool, device=img.device)
    FAST_TILES(kernels.check(img, "img", ndim=2), H, W, float(thresh), 1, None,
               keys.data_ptr(), state.data_ptr())
    try:
        FAST_SELECT(keys.data_ptr(), state.data_ptr(), H, W, k, kernels.check(xy, "xy"),
                    kernels.check(valid, "valid", torch.bool))
    except RuntimeError:
        state.zero_()  # the keys of this call must not reach the next one
        raise
    return xy, valid


def fast_score(img, thresh=0.05):
    """K15's score mode (``fast_tiles`` alone).  CPU tensor:
    ``fast_score_plain``."""
    if not img.is_cuda:
        return fast_score_plain(img, thresh)
    return _fast_cuda(img, thresh)


def _top_corners(score, max_corners, dtype):
    """The plain top-k of a kept map: (xy [k, 2], valid [k])."""
    W = score.shape[1]
    # stable descending sort == lax.top_k's lower-index-first tie order
    top, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    top, idx = top[:max_corners], idx[:max_corners]
    xy = torch.stack([(idx % W).to(dtype), (idx // W).to(dtype)], dim=-1)
    return xy, top > 0.0


def detect_fast_plain(img, max_corners=500, thresh=0.05, nms_radius=3):
    """K15's twin: the plain score, the plain NMS, then the top-k."""
    return _top_corners(_nms_plain(fast_score_plain(img, thresh), nms_radius), max_corners,
                        img.dtype)


def detect_fast(img, max_corners=500, thresh=0.05, nms_radius=3):
    """Top-``max_corners`` FAST corners after NMS.  Returns (xy [K, 2] in
    img's dtype, valid [K]).  CPU tensor: ``detect_fast_plain``.  CUDA
    tensor: K15's two launches and nothing else (its 7x7 window is built
    in)."""
    if not img.is_cuda:
        return detect_fast_plain(img, max_corners, thresh, nms_radius)
    if nms_radius != 3:
        raise ValueError("K15's NMS window is 7x7 (nms_radius=3)")
    return _fast_cuda(img, thresh, max_corners)


# ---------------------------------------------------------------------------
# K16: blur + BRIEF-256
# ---------------------------------------------------------------------------


def brief_pattern(n_bits=256, patch=31, seed=7):
    """Deterministic Gaussian BRIEF pattern (pairs within a patch x patch
    box), as two float64 numpy arrays [n_bits, 2] of (dx, dy)."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    a = np.clip(rng.normal(0, sigma, (n_bits, 2)), -(patch // 2), patch // 2)
    b = np.clip(rng.normal(0, sigma, (n_bits, 2)), -(patch // 2), patch // 2)
    return a, b


_PATTERN_CACHE = {}


def _pattern_tensors(dtype, device):
    key = (dtype, str(device))
    if key not in _PATTERN_CACHE:
        pa, pb = brief_pattern()
        t = lambda a: torch.from_numpy(a).to(dtype=dtype, device=device).contiguous()
        _PATTERN_CACHE[key] = (t(pa), t(pb))
    return _PATTERN_CACHE[key]


def _pack_bits(bits):
    """bits [..., 256] bool -> [..., 8] int32 words (bit j of word w = bit
    32·w + j), as the reference's uint32 bit patterns."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def describe_brief_plain(img, xy, valid):
    """BRIEF-256 at keypoints xy [K, 2]: blur (7 taps, sigma 2), then bit i =
    blurred(xy + pa_i) < blurred(xy + pb_i), bilinear with a zero pad; rows
    of invalid keypoints are 0.  Returns int32 [K, 8]."""
    kernels.TWIN_CALLS["brief"] += 1
    pa, pb = _pattern_tensors(img.dtype, img.device)
    imgs = gaussian_blur(img, 7, 2.0)
    va = bilinear_sample(imgs, xy[:, None, :] + pa[None])
    vb = bilinear_sample(imgs, xy[:, None, :] + pb[None])
    desc = _pack_bits(va < vb)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


_TAPS_CACHE = {}


def _brief_cuda(img, xy, valid, xy2, valid2):
    """K16's launch over one point set, or two (xy2 not None): [K (+ K2), 8]."""
    _f32_only("img", img)
    H, W = img.shape
    dev = img.device
    pa, pb = _pattern_tensors(img.dtype, dev)
    if str(dev) not in _TAPS_CACHE:
        _TAPS_CACHE[str(dev)] = torch.tensor(gaussian_kernel1d(7, 2.0), dtype=torch.float32,
                                             device=dev)
    taps = _TAPS_CACHE[str(dev)]
    img = img.contiguous()
    sets = [(xy.contiguous(), kernels.as_u8(valid))]
    if xy2 is not None:
        sets.append((xy2.contiguous(), kernels.as_u8(valid2)))
    args = []
    for p, v in sets:
        K = p.shape[0]
        args += [kernels.check(p, "xy", shape=(K, 2)),
                 kernels.check(v, "valid", torch.uint8, shape=(K,)), K]
    args += [None, None, 0] * (2 - len(sets))
    desc = torch.empty(args[2] + args[5], 8, dtype=torch.int32, device=dev)
    if desc.shape[0] == 0:
        return desc
    BRIEF(kernels.check(img, "img", ndim=2), H, W, kernels.check(taps, "taps", shape=(7,)),
          kernels.check(pa, "pa", shape=(256, 2)), kernels.check(pb, "pb", shape=(256, 2)),
          *args, kernels.check(desc, "desc", torch.int32))
    return desc


def describe_brief(img, xy, valid):
    """K16.  CPU tensors: ``describe_brief_plain``.  CUDA tensors: one launch,
    a CTA a keypoint blurring its patch, a warp a word packed with a
    ballot."""
    if not img.is_cuda:
        return describe_brief_plain(img, xy, valid)
    return _brief_cuda(img, xy, valid, None, None)


def describe_brief_pair(img, xy, valid, xy2, valid2):
    """``describe_brief`` at two point sets: (desc [K, 8], desc2 [K2, 8]).
    Row k depends on xy[k] and valid[k] alone, so this equals two calls.
    CPU tensors: one plain call on the concatenated sets.  CUDA tensors: one
    launch of K16 over both sets (no concatenation)."""
    K = xy.shape[0]
    if not img.is_cuda:
        d = describe_brief_plain(img, torch.cat([xy, xy2.to(xy.dtype)]),
                                 torch.cat([valid, valid2]))
    else:
        d = _brief_cuda(img, xy, valid, xy2, valid2)
    return d[:K], d[K:]


# ---------------------------------------------------------------------------
# K17: Hamming matching and the SimHash signature
# ---------------------------------------------------------------------------


def _popcount32(x):
    """Bits set in the low 32 bits of each int64 of x."""
    x = x & _MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK32) >> 24


def hamming_matrix_plain(da, db):
    """Pairwise Hamming distances: da [N, 8], db [M, 8] -> [N, M] int32."""
    x = da.to(torch.int64)[:, None, :] ^ db.to(torch.int64)[None, :, :]
    return torch.sum(_popcount32(x), dim=-1).to(torch.int32)


def match_descriptors_plain(da, va, db, vb, max_dist=80, margin=0, mutual=False):
    """Best db column of each da row (first argmin; invalid columns at
    10,000), gated by ``va & dist < max_dist``; margin > 0 adds the
    second-best test (only the best column excluded), mutual the
    cross-check.  Returns (idx [N] int64 or -1, dist [N] int32)."""
    kernels.TWIN_CALLS["match"] += 1
    big = torch.tensor(10_000, dtype=torch.int32, device=da.device)
    d = torch.where(vb[None, :], hamming_matrix_plain(da, db), big)
    dist, best = torch.min(d, dim=1)  # torch.min: the first index among ties
    ok = va & (dist < max_dist)
    if margin > 0:
        d2 = d.scatter(1, best[:, None], 10_000)
        second = torch.min(d2, dim=1).values
        ok = ok & (second - dist >= margin)
    if mutual:
        col_best = torch.argmin(torch.where(va[:, None], d, big), dim=0)
        ok = ok & (col_best[best] == torch.arange(d.shape[0], device=d.device))
    return torch.where(ok, best, torch.full_like(best, -1)), dist


def _hamming_cuda(da, va, db, vb, max_dist, margin, mutual, want_d):
    """K17's match: one launch that reads the bool masks as bytes and writes
    the int64 index itself (N = 0 launches nothing)."""
    N, M = da.shape[0], db.shape[0]
    dev = da.device
    if M < 1 or M > 65535 or N > 4096:
        raise ValueError(f"K17's match takes 1 <= M <= 65,535 columns and N <= 4,096 rows, "
                         f"got N {N}, M {M}")
    da, db = da.to(torch.int32).contiguous(), db.to(torch.int32).contiguous()
    va8, vb8 = kernels.as_u8(va), kernels.as_u8(vb)
    idx = torch.empty(N, dtype=torch.int64, device=dev)
    dist = torch.empty(N, dtype=torch.int32, device=dev)
    d = torch.empty(N, M, dtype=torch.int32, device=dev) if want_d else None
    if N == 0:
        return idx, dist, d
    HAMMING_MATCH(kernels.check(da, "da", torch.int32, shape=(N, 8)),
                  kernels.check(va8, "va", torch.uint8, shape=(N,)),
                  kernels.check(db, "db", torch.int32, shape=(M, 8)),
                  kernels.check(vb8, "vb", torch.uint8, shape=(M,)), N, M, int(max_dist),
                  int(margin), int(bool(mutual)), kernels.check(idx, "idx", torch.int64),
                  kernels.check(dist, "dist", torch.int32),
                  None if d is None else kernels.check(d, "d", torch.int32))
    return idx, dist, d


def hamming_matrix(da, db):
    """K17 (match mode, writing its distance table) on CUDA tensors,
    ``hamming_matrix_plain`` on CPU tensors."""
    if not da.is_cuda:
        return hamming_matrix_plain(da, db)
    va = torch.ones(da.shape[0], dtype=torch.bool, device=da.device)
    vb = torch.ones(db.shape[0], dtype=torch.bool, device=da.device)
    return _hamming_cuda(da, va, db, vb, 80, 0, False, True)[2]


def match_descriptors(da, va, db, vb, max_dist=80, margin=0, mutual=False):
    """K17's match mode.  CPU tensors: ``match_descriptors_plain``.  CUDA
    tensors: one launch of a cluster of CTAs over column tiles, each
    computing its block of distances once (each column's best row, each
    row's best and second over the tile), the tiles merged exactly, then
    the gates."""
    if not da.is_cuda:
        return match_descriptors_plain(da, va, db, vb, max_dist, margin, mutual)
    idx, dist, _ = _hamming_cuda(da, va, db, vb, max_dist, margin, mutual, False)
    return idx, dist


_VOCAB_CACHE = {}


def _random_vocab(dim, n_words):
    """The fixed random ±1 projection vocabulary [dim, n_words] (numpy f64),
    drawn as the reference draws it."""
    key = (dim, n_words)
    if key not in _VOCAB_CACHE:
        rng = np.random.default_rng(20260821)
        _VOCAB_CACHE[key] = rng.choice([-1.0, 1.0], size=(dim, n_words))
    return _VOCAB_CACHE[key]


_WORDS_CACHE = {}


def _vocab_words(n_words, device):
    """Column j of the vocabulary packed as a 256-bit descriptor (bit i set
    where W[i, j] > 0): [n_words, 8] int32 on device."""
    key = (n_words, str(device))
    if key not in _WORDS_CACHE:
        Wv = torch.from_numpy(_random_vocab(256, n_words) > 0).T.contiguous()
        _WORDS_CACHE[key] = _pack_bits(Wv).to(device)
    return _WORDS_CACHE[key]


SIG_CELLS = 4  # 2x2 spatial pyramid
SIG_DIM = SIG_CELLS * 256
SIG_CHUNK = 16  # descriptors a CTA of K17's signature mode (csrc/hamming.cu kSigChunk)


def _unpack_bits(desc, dim=256):
    """[N, 8] words -> [N, dim] float32 bits, bit i = word i // 32, bit i % 32
    (the reference's little-endian uint8 view + little bit order)."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int64)
    bits = (desc.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], 32 * desc.shape[-1])[..., :dim].to(torch.float32)


def simhash_codes_plain(desc, valid, n_words=256):
    """SimHash code of each descriptor: sign((bits - 0.5) @ W) times valid,
    [N, n_words] float32."""
    centered = _unpack_bits(desc) - 0.5
    Wv = torch.from_numpy(_random_vocab(256, n_words)).to(torch.float32).to(desc.device)
    return torch.sign(centered @ Wv) * valid.to(torch.float32)[:, None]


def _cells(xy, N, img_hw, device):
    if xy is None:
        return torch.zeros(N, dtype=torch.int64, device=device)
    H, Wd = img_hw
    cy = torch.clamp((xy[:, 1] * (2.0 / H)).to(torch.int32), 0, 1)
    cx = torch.clamp((xy[:, 0] * (2.0 / Wd)).to(torch.int32), 0, 1)
    return (cy * 2 + cx).to(torch.int64)


def global_signature_plain(desc, valid, dim=256, n_words=256, xy=None, img_hw=None):
    """SimHash codes pooled per 2x2 image cell, concatenated and
    L2-normalized: [SIG_CELLS * n_words] float32.  Without xy every
    keypoint pools into cell 0."""
    kernels.TWIN_CALLS["signature"] += 1
    if dim != 256:
        raise ValueError("descriptors are 256 bits")
    codes = simhash_codes_plain(desc, valid, n_words)
    cell = _cells(xy, codes.shape[0], img_hw, desc.device)
    sig = torch.zeros(SIG_CELLS, n_words, dtype=torch.float32, device=desc.device)
    sig = sig.index_add(0, cell, codes).reshape(-1)
    # the sums are integers: their squares sum exactly in f64
    n = torch.sqrt(torch.sum(sig.double() ** 2).float())
    return sig / torch.clamp(n, min=1e-9)


def global_signature(desc, valid, dim=256, n_words=256, xy=None, img_hw=None,
                     codes_out=None):
    """K17's signature mode.  CPU tensors: ``global_signature_plain``.  CUDA
    tensors: a CTA per SIG_CHUNK descriptors codes sign(128 - popcount(desc ^
    w_j)) and sums the codes per cell in integers into its slice of a
    scratch, then one CTA adds the slices and normalizes.  codes_out ([N,
    n_words] int8, CUDA only) receives the codes."""
    if not desc.is_cuda:
        return global_signature_plain(desc, valid, dim, n_words, xy, img_hw)
    if dim != 256:
        raise ValueError("descriptors are 256 bits")
    N = desc.shape[0]
    dev = desc.device
    desc = desc.to(torch.int32).contiguous()
    v8 = kernels.as_u8(valid)
    sy = sx = 0.0
    xy_p = None
    if xy is not None:
        _f32_only("xy", xy)
        xy = xy.contiguous()
        xy_p = kernels.check(xy, "xy", shape=(N, 2))
        sy, sx = 2.0 / img_hw[0], 2.0 / img_hw[1]
    words = _vocab_words(n_words, dev)
    sig = torch.empty(SIG_CELLS * n_words, dtype=torch.float32, device=dev)
    partial = torch.empty(max(-(-N // SIG_CHUNK), 1), SIG_CELLS, n_words, dtype=torch.int32,
                          device=dev)
    SIMHASH(kernels.check(desc, "desc", torch.int32, shape=(N, 8)),
            kernels.check(v8, "valid", torch.uint8, shape=(N,)), xy_p, N, sy, sx,
            kernels.check(words, "words", torch.int32, shape=(n_words, 8)), n_words,
            partial.data_ptr(), kernels.check(sig, "sig"),
            None if codes_out is None else kernels.check(codes_out, "codes", torch.int8,
                                                         shape=(N, n_words)))
    return sig
