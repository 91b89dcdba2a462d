"""Bit-level reference oracle for parity testing.

A verbatim copy of the JAX package's ``utils/oracle.py`` (numpy only; the
port cannot import the original, whose package imports jax), pinned equal
to it by ``tests/test_torch_oracle_parity.py``.

It is a standalone numpy/python float64 re-derivation of the reference
pipeline's *numeric semantics* (evaluation order, rounding, border rules)
from reference/src/sift.js, reference/src/matrix2d.js and
reference/background.js. JS numbers and python floats are both IEEE-754
binary64, and every accumulation below follows the same op order as the
JS source, so results agree bit-for-bit with a browser run up to libm ulp
differences in ``exp``/``pow``.

This oracle is deliberately slow and scalar-ordered: the port's float64
``blur="exact"`` path must match it exactly on the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

JS_EPSILON = 2.0 ** -52  # Number.EPSILON (reference/src/matrix2d.js:482)


def js_round(x: float) -> int:
    """JavaScript Math.round: floor(x + 0.5)."""
    return int(math.floor(x + 0.5))


# ---------------------------------------------------------------------------
# Kernels and blur (reference/src/sift.js:22-149)
# ---------------------------------------------------------------------------


def gaussian_kernel(sigma: float) -> np.ndarray:
    """2-D kernel, size 2*round(3σ)+1, sum-normalized in row-major order."""
    radius = js_round(3 * sigma)
    size = 2 * radius + 1
    kernel = np.empty((size, size), dtype=np.float64)
    total = 0.0
    for i in range(size):
        for j in range(size):
            ii = i - radius
            jj = j - radius
            value = math.exp(
                (((ii * ii) + (jj * jj)) / (sigma * sigma)) * -0.5
            ) / (2.0 * math.pi * (sigma * sigma))
            kernel[i, j] = value
            total += value
    for i in range(size):
        for j in range(size):
            kernel[i, j] = kernel[i, j] / total
    return kernel


def blur(image: np.ndarray, sigma: float) -> np.ndarray:
    """Full 2-D convolution, clamp-to-edge, reference accumulation order.

    Reference inner loop (src/sift.js:96-131): for each pixel,
    ``pixel_sum += input[clamp(y+(j-R))][clamp(x+(i-R))] * k[i][j]`` with
    ``i`` outer (x offset) and ``j`` inner (y offset). Vectorizing over
    pixels keeps each pixel's accumulation sequence identical.
    """
    h, w = image.shape
    radius = js_round(3 * sigma)
    size = 2 * radius + 1
    kernel = gaussian_kernel(sigma)
    padded = np.pad(image, radius, mode="edge")
    acc = np.zeros((h, w), dtype=np.float64)
    for i in range(size):  # x offset index
        for j in range(size):  # y offset index
            acc += padded[j : j + h, i : i + w] * kernel[i, j]
    return acc


# ---------------------------------------------------------------------------
# Resize (reference/src/matrix2d.js:112-138)
# ---------------------------------------------------------------------------


def linear_resize(matrix: np.ndarray, sampling_rate: float) -> np.ndarray:
    """Fractional-stride nearest-neighbor resample (floor indexing)."""
    rows, cols = matrix.shape
    row_idx = []
    i = 0.0
    while i < rows:
        row_idx.append(int(math.floor(i)))
        i += sampling_rate
    col_idx = []
    j = 0.0
    while j < cols:
        col_idx.append(int(math.floor(j)))
        j += sampling_rate
    return matrix[np.ix_(row_idx, col_idx)].copy()


# ---------------------------------------------------------------------------
# Stage 1: Gaussian scale space (reference/background.js:71-237)
# ---------------------------------------------------------------------------


def compute_scale_space(
    input_image: np.ndarray,
    number_of_octaves: int = 5,
    scales_per_octave: int = 3,
    min_blur_level: float = 0.8,
    assumed_blur: float = 0.5,
) -> list[list[dict[str, Any]]]:
    scale_space: list[list[dict[str, Any]]] = []
    base_image = linear_resize(input_image, 0.5)
    base_blur_level = min_blur_level
    k = math.pow(2.0, 1.0 / scales_per_octave)

    for octave in range(number_of_octaves):
        octave_images: list[dict[str, Any]] = []
        for scale in range(scales_per_octave + 3):
            if octave > 0 and scale == 0:
                seed = scale_space[octave - 1][scales_per_octave]
                base_image = linear_resize(seed["image"], 2.0)
                base_blur_level = seed["blurLevel"]
                octave_images.append(
                    {"blurLevel": base_blur_level, "image": base_image}
                )
            else:
                current_k = math.pow(k, scale)
                target_sigma = base_blur_level * current_k
                base_sigma = assumed_blur if octave == 0 else base_blur_level
                offset_sigma = math.sqrt(
                    (target_sigma * target_sigma) - (base_sigma * base_sigma)
                )
                output = blur(base_image, offset_sigma)
                octave_images.append({"blurLevel": target_sigma, "image": output})
        scale_space.append(octave_images)
    return scale_space


# ---------------------------------------------------------------------------
# Stage 2: DoG (reference/background.js:258-354)
# ---------------------------------------------------------------------------


def compute_difference_of_gaussians(
    scale_space: list[list[dict[str, Any]]],
) -> list[list[dict[str, Any]]]:
    dog: list[list[dict[str, Any]]] = []
    for octave_images in scale_space:
        octave_dogs: list[dict[str, Any]] = []
        for scale in range(1, len(octave_images)):
            base = octave_images[scale - 1]["image"]
            adjacent = octave_images[scale]["image"]
            # pair[0] - pair[1] (reference/src/sift.js:172): the negative
            # of the conventional DoG (SURVEY.md §2.3 stage 2).
            octave_dogs.append(
                {
                    "blurLevel": octave_images[scale - 1]["blurLevel"],
                    "image": base - adjacent,
                }
            )
        dog.append(octave_dogs)
    return dog


# ---------------------------------------------------------------------------
# Stage 3: extrema scan (reference/src/sift.js:212-316)
# ---------------------------------------------------------------------------


def find_extremas(
    image_trio: list[np.ndarray], scales_per_octave: int
) -> dict[str, list[dict[str, Any]]]:
    """26-neighbor strict extrema + contrast pre-filter, row-major order."""
    below, center, above = image_trio
    h, w = center.shape
    c = center[1 : h - 1, 1 : w - 1]

    neighbors = []
    for plane in (center, below, above):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if plane is center and dy == 0 and dx == 0:
                    continue
                neighbors.append(plane[1 + dy : h - 1 + dy, 1 + dx : w - 1 + dx])
    stack = np.stack(neighbors)
    is_minima = np.all(stack > c, axis=0)
    is_maxima = np.all(stack < c, axis=0)
    is_extremum = is_minima | is_maxima

    threshold = (
        (math.pow(2.0, 1.0 / scales_per_octave) - 1.0)
        / (math.pow(2.0, 1.0 / 3.0) - 1.0)
    ) * 0.015
    pixel_threshold = threshold * 0.8
    passes = np.abs(c) >= pixel_threshold

    candidate_keypoints = []
    low_contrast_keypoints = []
    for yy, xx in np.argwhere(is_extremum):  # row-major like the JS scan
        record = {
            "x": int(xx) + 1,
            "y": int(yy) + 1,
            "value": float(c[yy, xx]),
        }
        if passes[yy, xx]:
            candidate_keypoints.append(record)
        else:
            low_contrast_keypoints.append(record)
    return {
        "candidateKeypoints": candidate_keypoints,
        "lowContrastKeypoints": low_contrast_keypoints,
    }


def find_candidate_keypoints(
    dog: list[list[dict[str, Any]]], scales_per_octave: int
) -> list[list[dict[str, Any]]]:
    """Per-octave, per-trio candidate extraction (background.js:359-450)."""
    extremas = []
    for octave_dogs in dog:
        octave_scales = []
        for scale in range(1, len(octave_dogs) - 1):
            found = find_extremas(
                [
                    octave_dogs[scale - 1]["image"],
                    octave_dogs[scale]["image"],
                    octave_dogs[scale + 1]["image"],
                ],
                scales_per_octave,
            )
            octave_scales.append(
                {
                    "scaleLevel": scale,
                    "localExtremas": found["candidateKeypoints"],
                    "lowContrastCount": len(found["lowContrastKeypoints"]),
                    "lowContrastKeypoints": found["lowContrastKeypoints"],
                }
            )
        extremas.append(octave_scales)
    return extremas


# ---------------------------------------------------------------------------
# Stage 4: quadratic refinement (reference/background.js:455-685)
# ---------------------------------------------------------------------------


def _gradient(dog_octave, s, m, n):
    """Central differences [∂s, ∂m, ∂n]/2 (reference/src/sift.js:333-353)."""
    d = dog_octave
    return [
        (d[s + 1][m][n] - d[s - 1][m][n]) / 2,
        (d[s][m + 1][n] - d[s][m - 1][n]) / 2,
        (d[s][m][n + 1] - d[s][m][n - 1]) / 2,
    ]


def _hessian(dog_octave, s, m, n):
    """3×3 symmetric finite-difference Hessian (reference/src/sift.js:377-446)."""
    d = dog_octave
    h11 = d[s + 1][m][n] + d[s - 1][m][n] - (2 * d[s][m][n])
    h22 = d[s][m + 1][n] + d[s][m - 1][n] - (2 * d[s][m][n])
    h33 = d[s][m][n + 1] + d[s][m][n - 1] - (2 * d[s][m][n])
    h12 = (
        d[s + 1][m + 1][n] - d[s + 1][m - 1][n] - d[s - 1][m + 1][n] + d[s - 1][m - 1][n]
    ) / 4
    h13 = (
        d[s + 1][m][n + 1] - d[s + 1][m][n - 1] - d[s - 1][m][n + 1] + d[s - 1][m][n - 1]
    ) / 4
    h23 = (
        d[s][m + 1][n + 1] - d[s][m + 1][n - 1] - d[s][m - 1][n + 1] + d[s][m - 1][n - 1]
    ) / 4
    return [[h11, h12, h13], [h12, h22, h23], [h13, h23, h33]]


def _det2(a, b, c, d):
    """2x2 determinant (ad)-(bc) (reference/src/matrix2d.js:211)."""
    return (a * d) - (b * c)


def _minor(mat, i, j):
    rows = [r for r in range(3) if r != i]
    cols = [c for c in range(3) if c != j]
    return _det2(
        mat[rows[0]][cols[0]],
        mat[rows[0]][cols[1]],
        mat[rows[1]][cols[0]],
        mat[rows[1]][cols[1]],
    )


def _inverse3x3(mat):
    """Adjugate inverse (reference/src/matrix2d.js:464-509).

    Returns None when |det| < Number.EPSILON — the reference returns null
    and then *crashes* in the caller (background.js:546-554); the rebuild
    rejects such keypoints instead (SURVEY.md §5.3).
    """
    minors_top = [_minor(mat, 0, 0), _minor(mat, 0, 1), _minor(mat, 0, 2)]
    det = (
        (mat[0][0] * minors_top[0])
        - (mat[0][1] * minors_top[1])
        + (mat[0][2] * minors_top[2])
    )
    if abs(det) < JS_EPSILON:
        return None
    minors = [minors_top, [0.0] * 3, [0.0] * 3]
    for i in (1, 2):
        for j in range(3):
            minors[i][j] = _minor(mat, i, j)
    cof = [[minors[i][j] * math.pow(-1.0, i + j) for j in range(3)] for i in range(3)]
    adj = [[cof[j][i] for j in range(3)] for i in range(3)]
    return [[adj[i][j] / det for j in range(3)] for i in range(3)]


def refine_candidate_keypoints(
    dog: list[list[dict[str, Any]]],
    candidate_keypoints: list[list[dict[str, Any]]],
    scales_per_octave: int = 3,
    number_of_octaves: int = 5,
    min_blur_level: float = 0.8,
    min_interpixel_distance: float = 0.5,
    edge_ratio: float = 10.0,
    max_iterations: int = 5,
) -> dict[str, Any]:
    """Newton refinement with the reference's exact accept/reject ladder.

    Returns the accepted keypoints plus a rejection-reason histogram
    mirroring the reference's console.log taxonomy (SURVEY.md §5.5).
    """
    refined = []
    decisions = []  # per-candidate fate, in the reference's iteration order
    counts = {
        "accepted": 0,
        "low_contrast": 0,
        "edge": 0,
        "out_of_bounds": 0,
        "max_iterations": 0,
        "singular_hessian": 0,
    }
    threshold = (
        (math.pow(2.0, 1.0 / scales_per_octave) - 1.0)
        / (math.pow(2.0, 1.0 / 3.0) - 1.0)
    ) * 0.015
    edge_threshold = ((edge_ratio + 1) * (edge_ratio + 1)) / edge_ratio

    for octave in range(number_of_octaves):
        dog_octave = [entry["image"] for entry in dog[octave]]
        n_dog = len(dog_octave)
        for scale_i in range(scales_per_octave):
            for extrema in candidate_keypoints[octave][scale_i]["localExtremas"]:
                s = candidate_keypoints[octave][scale_i]["scaleLevel"]
                m = extrema["y"]
                n = extrema["x"]
                s0, m0, n0 = s, m, n  # initial identity for decision log
                reason = "max_iterations"
                for _ in range(max_iterations):
                    g = _gradient(dog_octave, s, m, n)
                    hess = _hessian(dog_octave, s, m, n)
                    inv = _inverse3x3(hess)
                    if inv is None:
                        reason = "singular_hessian"
                        break
                    alpha = [
                        ((inv[i][0] * -1) * g[0])
                        + ((inv[i][1] * -1) * g[1])
                        + ((inv[i][2] * -1) * g[2])
                        for i in range(3)
                    ]
                    if all(abs(a) < 0.6 for a in alpha):
                        omega = extrema["value"] + (
                            ((0.5 * alpha[0]) * g[0])
                            + ((0.5 * alpha[1]) * g[1])
                            + ((0.5 * alpha[2]) * g[2])
                        )
                        if abs(omega) < threshold:
                            reason = "low_contrast"
                            break
                        tr = hess[1][1] + hess[2][2]
                        det2 = _det2(hess[1][1], hess[1][2], hess[2][1], hess[2][2])
                        edgeness = (tr * tr) / det2
                        if edgeness > edge_threshold:
                            reason = "edge"
                            break
                        reason = "accepted"
                        delta = math.pow(2.0, octave - 1)
                        refined.append(
                            {
                                "octave": octave,
                                "scaleLevel": s,
                                "localX": n,
                                "localY": m,
                                "absoluteSigma": (delta / min_interpixel_distance)
                                * min_blur_level
                                * math.pow(2.0, (alpha[0] + s) / scales_per_octave),
                                "absoluteX": delta * (alpha[2] + n),
                                "absoluteY": delta * (alpha[1] + m),
                                "interpolatedValue": omega,
                            }
                        )
                        break
                    s = js_round(s + alpha[0])
                    m = js_round(m + alpha[1])
                    n = js_round(n + alpha[2])
                    if s < 1 or s >= n_dog - 1:
                        reason = "out_of_bounds"
                        break
                    if m < 1 or m >= dog_octave[s].shape[0] - 1:
                        reason = "out_of_bounds"
                        break
                    if n < 1 or n >= dog_octave[s].shape[1] - 1:
                        reason = "out_of_bounds"
                        break
                counts[reason] += 1
                decisions.append(
                    {
                        "octave": octave,
                        "scaleLevel": s0,
                        "y": m0,
                        "x": n0,
                        "reason": reason,
                    }
                )
    return {
        "refinedKeypoints": refined,
        "rejectionCounts": counts,
        "decisions": decisions,
    }


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


def detect(
    gray_image: np.ndarray,
    number_of_octaves: int = 5,
    scales_per_octave: int = 3,
    min_blur_level: float = 0.8,
    assumed_blur: float = 0.5,
    min_interpixel_distance: float = 0.5,
) -> dict[str, Any]:
    """Run all four reference stages on a [0,1] grayscale float64 image."""
    scale_space = compute_scale_space(
        gray_image,
        number_of_octaves,
        scales_per_octave,
        min_blur_level,
        assumed_blur,
    )
    dog = compute_difference_of_gaussians(scale_space)
    candidates = find_candidate_keypoints(dog, scales_per_octave)
    refined = refine_candidate_keypoints(
        dog,
        candidates,
        scales_per_octave,
        number_of_octaves,
        min_blur_level,
        min_interpixel_distance,
    )
    return {
        "scaleSpace": scale_space,
        "differenceOfGaussians": dog,
        "candidateKeypoints": candidates,
        "refinedKeypoints": refined["refinedKeypoints"],
        "rejectionCounts": refined["rejectionCounts"],
        "decisions": refined["decisions"],
    }
