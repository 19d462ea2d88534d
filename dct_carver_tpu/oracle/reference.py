"""Executable specification ("oracle") of the dct-carver pipeline, in NumPy.

This module is the ground-truth, scalar-semantics re-derivation of the
reference plugin's behavior (avivrosenberg/dct-carver + liblqr).  It is a
*spec*, written fresh from the observed semantics — not a port of the C code.
Every rule below cites the reference file:line it was derived from.  The JAX
fast paths (XLA and the GPU seam-DP kernel) are tested seam-for-seam against
this module.

Semantics captured (reference citations):

* DCT conventions (``src/dct.c:77-94``):
  - N in {8, 16}: Ooura's *normalized* (orthonormal) 2-D DCT-II
    (``src/fft2d/shrtdct.c:23-28, 190-205``) == ``scipy.fft.dctn(norm='ortho')``.
  - N in {2, 4}: Ooura's ``ddct2d(n, n, -1, ...)`` which is the *unnormalized*
    DCT-II: ``C[k1,k2] = sum a[j1,j2] cos(pi (j1+.5) k1 / n) cos(pi (j2+.5) k2 / n)``
    (``src/fft2d/fftsg2d.c:200-211``).  The missing 2/n and 1/sqrt(2) factors
    change the relative coefficient magnitudes, hence the argmax — so the two
    conventions must be preserved per-blocksize.

* Energy (``src/dct.c:96-110``, callback ``src/render.c:134-157``):
  - Window: offsets ``-r+1 .. r`` with ``r = blocksize/2`` around the pixel, on
    both axes, positions clamped to the image border
    (``src/render.c:122-132,146-151`` clamp_offset_to_border == edge replicate).
  - The reference stores the window TRANSPOSED w.r.t. image orientation:
    ``data[i][j]`` has rows indexed by the *x* (column) offset
    (``src/render.c:146-151``).  Hence the tie-break scan below runs over
    (kx, ky) = (horizontal frequency, vertical frequency), kx outer.
  - Score: max |coefficient| over all atoms except DC, scanned row-major over
    the transposed block with ``max <= currval`` (``src/dct.c:100-108``):
    ties are won by the LAST tied atom in (kx, ky) row-major order.
  - Weight: ``edges`` if the winning atom is (0,1) or (1,0) (the only nonzero
    entries of every LUT, ``src/dct.c:10-43``), else ``textures``.
  - Return type is 32-bit float (gfloat, ``src/dct.c:96``).

* Luma (carve path): liblqr reads LQR_ER_LUMA (``src/render.c:314-315``); the
  liblqr convention is Rec.709 luma on [0,1]-normalized channels.  Seam
  selection is invariant to a global scale of the energy, so the [0,1]
  normalization is immaterial to parity; we fix luma = (0.2126 R + 0.7152 G +
  0.0722 B)/255 as the spec.  The preview path's distinct BT.601 studio luma
  (``src/render.h:5``) is provided separately as `luma_bt601_studio`.

* Carving (liblqr call sites, ``src/render.c:312-315,377``):
  ``lqr_carver_init(carver, delta_x=1, rigidity=0)`` → classic seam-carving DP
  over rows: ``M[i,j] = E[i,j] + min(M[i-1,j-1], M[i-1,j], M[i-1,j+1])``.
  Tie conventions (this spec's choice, applied identically in all paths):
  end column = leftmost argmin of the last row; each backtrack step picks the
  leftmost minimum among the (clamped) 3 candidates.

* Visibility map (``src/render.c:204-240``): int32 per ORIGINAL pixel; 0 =
  never carved, k>0 = removed as the k-th seam; depth = total seams.

* Enlargement (positive seams_number, ``src/render.c:358-364``): the first
  `n` removal seams are computed on the unmodified image, then each seam pixel
  is duplicated with neighbor averaging (liblqr insertion semantics): the
  inserted pixel value is the mean of the seam pixel and its right neighbor
  (clamped at the border).

* `vertically=True` changes the image HEIGHT (``src/render.c:358-364``):
  implemented by transposing, carving width-wise, transposing back — as liblqr
  does internally.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "dct_matrix_reference",
    "luma_bt709",
    "luma_bt601_studio",
    "energy_map",
    "cumulative_energy",
    "backtrack_seam",
    "find_seam",
    "carve_seams",
    "insert_seams",
    "carve",
    "normalize_to_u8",
]

#: Atoms weighted by `edges` — the only nonzero LUT entries (src/dct.c:10-43).
EDGE_ATOM_RANKS = lambda n: (1, n)  # rank = kx*n + ky for (0,1) and (1,0)


def dct_matrix_reference(n: int, dtype=np.float64) -> np.ndarray:
    """The 1-D DCT-II basis matrix D with the reference's per-size convention.

    Rows index frequency k, columns index sample j.  The 2-D transform of a
    block B is ``D @ B @ D.T``.

    - n in {8, 16}: orthonormal (src/fft2d/shrtdct.c:190-205).
    - n in {2, 4}: unnormalized case-2 ddct2d (src/fft2d/fftsg2d.c:200-211).
    """
    if n not in (2, 4, 8, 16):
        raise ValueError(f"blocksize must be one of 2,4,8,16, got {n}")
    j = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)
    D = np.cos(np.pi * (j[None, :] + 0.5) * k[:, None] / n)
    if n in (8, 16):
        scale = np.full(n, np.sqrt(2.0 / n))
        scale[0] = np.sqrt(1.0 / n)
        D = D * scale[:, None]
    return D.astype(dtype)


def luma_bt709(image: np.ndarray) -> np.ndarray:
    """Carve-path luma: Rec.709 on [0,1] (liblqr LQR_ER_LUMA; src/render.c:314).

    `image` is (H, W) or (H, W, C) uint8 (or float already in [0,255]).
    Returns float64 (H, W) in [0, 1].
    """
    img = np.asarray(image, dtype=np.float64)
    if img.ndim == 2:
        return img / 255.0
    c = img.shape[2]
    if c == 1:
        return img[..., 0] / 255.0
    # channels 3 or 4 (alpha ignored, as liblqr's luma reader does)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return (0.2126 * r + 0.7152 * g + 0.0722 * b) / 255.0


def luma_bt601_studio(image: np.ndarray) -> np.ndarray:
    """Preview-path luma (src/render.h:5): u8 = (guchar)(16 + .2568r + .5041g + .0979b).

    The C cast truncates toward zero.  Returns float64 (H, W) of u8 values
    (0..255 scale — the preview feeds raw u8 into the DCT, src/render.c:43-49).
    """
    img = np.asarray(image, dtype=np.float64)
    if img.ndim == 2 or img.shape[2] == 1:
        out = img if img.ndim == 2 else img[..., 0]
        return np.floor(out).astype(np.float64)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return np.floor(16.0 + r * 0.2568 + g * 0.5041 + b * 0.0979)


def window_offset(n: int, center: str = "carve") -> int:
    """First window offset relative to the pixel.

    * "carve": liblqr reading window, offsets -r+1..r with r = n//2
      (src/render.c:146-151).
    * "preview": the GUI preview path, offsets -(C-1)..n-C with
      C = (n-1)//2 in C integer division (CENTER_ROW/COL, src/dct.h:8-9;
      window loop src/render.c:43-49) — off by one vs the carve path for
      even n (SURVEY §3.2's "two near-duplicate definitions").
    """
    if center == "carve":
        return -(n // 2 - 1)
    if center == "preview":
        return -((n - 1) // 2 - 1)
    raise ValueError(f"center must be 'carve' or 'preview', got {center!r}")


def _sliding_windows(luma: np.ndarray, n: int, center: str = "carve") -> np.ndarray:
    """All n×n windows, edge-clamped.  Returns (H, W, n, n) with axes
    [y, x, dy, dx] in IMAGE orientation.  (The reference stores the
    transposed block; the transpose is applied in `energy_map` via the
    tie-break rank layout instead.)
    """
    co = window_offset(n, center)
    H, W = luma.shape
    yy = np.clip(np.arange(H)[:, None] + co + np.arange(n)[None, :], 0, H - 1)
    xx = np.clip(np.arange(W)[:, None] + co + np.arange(n)[None, :], 0, W - 1)
    return luma[yy[:, None, :, None], xx[None, :, None, :]]


def energy_map(
    luma: np.ndarray,
    blocksize: int,
    edges: float,
    textures: float,
    row_chunk: int = 128,
    center: str = "carve",
) -> np.ndarray:
    """Per-pixel weighted max-|AC-DCT| energy (src/dct.c:96-110). Returns f32 (H,W).

    Implements exactly: block DCT with the per-size convention, max |c| over
    non-DC atoms with last-tie-wins in (kx, ky) row-major order (kx = horizontal
    frequency, because the reference block is transposed, src/render.c:146-151),
    then ×edges if the winner is atom (0,1)/(1,0) else ×textures.
    """
    n = blocksize
    D = dct_matrix_reference(n)
    H, W = luma.shape
    luma = np.asarray(luma, dtype=np.float64)

    # rank[ky, kx] = kx*n + ky  (reference scan order over the transposed block)
    ky, kx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    rank = (kx * n + ky).reshape(-1)  # flattened over (ky, kx) image order
    dc = (ky == 0) & (kx == 0)
    ac_mask = ~dc.reshape(-1)
    edge_ranks = EDGE_ATOM_RANKS(n)

    co = window_offset(n, center)
    xx = np.clip(np.arange(W)[:, None] + co + np.arange(n)[None, :], 0, W - 1)
    out = np.empty((H, W), dtype=np.float32)
    for y0 in range(0, H, row_chunk):
        y1 = min(y0 + row_chunk, H)
        yy = np.clip(
            np.arange(y0, y1)[:, None] + co + np.arange(n)[None, :], 0, H - 1
        )
        wnd = luma[yy[:, None, :, None], xx[None, :, None, :]]
        # coeff[y, x, ky, kx] = (D @ wnd @ D.T)
        coeff = np.einsum("ka,yxab,lb->yxkl", D, wnd, D, optimize=True)
        absc = np.abs(coeff).reshape(coeff.shape[0], W, n * n)
        absc_ac = absc[..., ac_mask]
        maxval = absc_ac.max(axis=-1)
        # last-tie-wins: largest rank among exact-equal maxima
        tied = absc_ac == maxval[..., None]
        winner = np.where(tied, rank[ac_mask], -1).max(axis=-1)
        is_edge = np.isin(winner, edge_ranks)
        w = np.where(is_edge, np.float64(edges), np.float64(textures))
        out[y0:y1] = (maxval * w).astype(np.float32)
    return out


def gradient_energy_map(luma: np.ndarray, kind: str) -> np.ndarray:
    """Scalar spec for the builtin gradient energies (ops/energy_fn.py) —
    liblqr-style non-custom energies: forward differences with the clamped
    border (dx = 0 at the last column, dy = 0 at the last row), computed in
    f32 like the carver's stored energy (gfloat, src/dct.c:96)."""
    x = np.asarray(luma, dtype=np.float32)
    H, W = x.shape
    right = x[:, np.minimum(np.arange(W) + 1, W - 1)]
    down = x[np.minimum(np.arange(H) + 1, H - 1), :]
    dx = right - x
    dy = down - x
    if kind == "grad_xabs":
        return np.abs(dx)
    if kind == "grad_sumabs":
        return (np.abs(dx) + np.abs(dy)) * np.float32(0.5)
    if kind == "grad_norm":
        return np.sqrt(dx * dx + dy * dy)
    if kind == "null":
        return np.zeros_like(x)
    raise ValueError(f"unknown gradient energy {kind!r}")


def rigidity_penalty(dx: int, delta_x: int, rigidity: float) -> float:
    """This framework's spec of the liblqr `lqr_carver_init(delta_x,
    rigidity)` generalization: a seam may step up to `delta_x` columns per
    row and a step of |dx| costs ``rigidity * |dx| / delta_x``.  The
    reference plugin always runs (1, 0) (src/render.c:313) — the
    parity-tested configuration, where the penalty vanishes."""
    return rigidity * abs(dx) / delta_x


def cumulative_energy(E: np.ndarray, delta_x: int = 1,
                      rigidity: float = 0.0) -> np.ndarray:
    """DP cumulative energy; defaults are the reference's delta_x=1,
    rigidity=0 (src/render.c:313). f32 in/out."""
    E = np.asarray(E, dtype=np.float32)
    H, W = E.shape
    M = np.empty_like(E)
    M[0] = E[0]
    INF = np.float32(np.inf)
    for i in range(1, H):
        prev = M[i - 1]
        best = None
        for dx in range(-delta_x, delta_x + 1):
            if dx < 0:
                cand = np.concatenate((np.full(-dx, INF), prev[:dx]))
            elif dx > 0:
                cand = np.concatenate((prev[dx:], np.full(dx, INF)))
            else:
                cand = prev
            pen = rigidity_penalty(dx, delta_x, rigidity)
            if pen != 0.0:
                cand = cand + np.float32(pen)
            best = cand if best is None else np.minimum(best, cand)
        M[i] = E[i] + best
    return M


def _argmin_tie(x: np.ndarray, tie: str) -> int:
    """Index of the minimum; ties per `tie` ("leftmost"/"rightmost") — the
    S1/S2 spec knob of docs/PARITY.md (the real convention lives inside
    external liblqr and is unobservable here)."""
    if tie == "leftmost":
        return int(np.argmin(x))
    if tie == "rightmost":
        return int(len(x) - 1 - np.argmin(x[::-1]))
    raise ValueError(f"tie must be 'leftmost' or 'rightmost', got {tie!r}")


def backtrack_seam(M: np.ndarray, delta_x: int = 1,
                   rigidity: float = 0.0, tie: str = "leftmost") -> np.ndarray:
    """`tie`-most-argmin backtrack over the (penalized) candidate window.
    Returns seam column per row, int32 (H,)."""
    H, W = M.shape
    seam = np.empty(H, dtype=np.int32)
    j = _argmin_tie(M[-1], tie)
    seam[-1] = j
    pen = np.asarray(
        [rigidity_penalty(dx, delta_x, rigidity)
         for dx in range(-delta_x, delta_x + 1)], np.float32,
    )
    INF = np.float32(np.inf)
    for i in range(H - 2, -1, -1):
        cand = np.full(2 * delta_x + 1, INF)
        for k, dx in enumerate(range(-delta_x, delta_x + 1)):
            c = j + dx
            if 0 <= c < W:
                cand[k] = M[i, c] + pen[k] if rigidity != 0.0 else M[i, c]
        j = j - delta_x + _argmin_tie(cand, tie)
        seam[i] = j
    return seam


def find_seam(E: np.ndarray, delta_x: int = 1, rigidity: float = 0.0,
              tie: str = "leftmost") -> np.ndarray:
    return backtrack_seam(cumulative_energy(E, delta_x, rigidity),
                          delta_x, rigidity, tie)


def _remove_seam(arr: np.ndarray, seam: np.ndarray) -> np.ndarray:
    """Remove one pixel per row at `seam` columns. arr is (H, W[, C])."""
    H, W = arr.shape[:2]
    cols = np.arange(W - 1)[None, :] + (np.arange(W - 1)[None, :] >= seam[:, None])
    return np.take_along_axis(
        arr, cols[..., None] if arr.ndim == 3 else cols, axis=1
    )


def carve_seams(
    image: np.ndarray,
    n_seams: int,
    blocksize: int,
    edges: float,
    textures: float,
    luma_fn=luma_bt709,
    delta_x: int = 1,
    rigidity: float = 0.0,
    tie: str = "leftmost",
):
    """Remove `n_seams` vertical seams. Returns (carved_image, vmap, first_energy).

    vmap is int32 (H, W_original): 0 = kept, k>0 = removed as k-th seam
    (src/render.c:204-240 consumer semantics).  Energy is fully recomputed
    after each removal (equivalent to liblqr's strip update, since the energy
    is a pure per-pixel function of the current image).
    """
    image = np.asarray(image)
    H, W = image.shape[:2]
    if n_seams >= W:
        raise ValueError("cannot remove >= width seams")
    luma = luma_fn(image)
    origcol = np.broadcast_to(np.arange(W, dtype=np.int32), (H, W)).copy()
    vmap = np.zeros((H, W), dtype=np.int32)
    first_energy = None
    cur = image.copy()
    for k in range(1, n_seams + 1):
        E = energy_map(luma, blocksize, edges, textures)
        if first_energy is None:
            first_energy = E
        seam = find_seam(E, delta_x, rigidity, tie)
        vmap[np.arange(H), origcol[np.arange(H), seam]] = k
        cur = _remove_seam(cur, seam)
        luma = _remove_seam(luma, seam)
        origcol = _remove_seam(origcol, seam)
    return cur, vmap, first_energy


def insert_seams(
    image: np.ndarray,
    n_seams: int,
    blocksize: int,
    edges: float,
    textures: float,
    luma_fn=luma_bt709,
):
    """Enlarge width by n_seams (liblqr enlargement semantics; see module doc).

    Returns (enlarged_image, vmap).  Inserted pixel = mean of the seam pixel
    and its right neighbor (border-clamped), rounded half-up for integer dtypes.
    """
    image = np.asarray(image)
    H, W = image.shape[:2]
    _, vmap, _ = carve_seams(image, n_seams, blocksize, edges, textures, luma_fn)
    out_w = W + n_seams
    if image.ndim == 3:
        out = np.empty((H, out_w, image.shape[2]), dtype=image.dtype)
    else:
        out = np.empty((H, out_w), dtype=image.dtype)
    for i in range(H):
        row = image[i]
        pos = 0
        for j in range(W):
            out[i, pos] = row[j]
            pos += 1
            if vmap[i, j] > 0:
                nbr = row[min(j + 1, W - 1)]
                val = (row[j].astype(np.float64) + nbr.astype(np.float64)) / 2.0
                if np.issubdtype(out.dtype, np.integer):
                    val = np.floor(val + 0.5)
                out[i, pos] = val.astype(out.dtype)
                pos += 1
    return out, vmap


def carve(
    image: np.ndarray,
    seams_number: int,
    blocksize: int = 8,
    edges: float = 0.0,
    textures: float = 1.0,
    vertically: bool = False,
    luma_fn=luma_bt709,
):
    """Full reference pipeline: signed seams_number, optional vertical mode.

    Mirrors render() (src/render.c:327-419): negative seams shrink, positive
    enlarge; `vertically` retargets the HEIGHT (transpose internally).
    Returns (output_image, vmap).
    """
    image = np.asarray(image)
    if seams_number == 0:
        return image.copy(), np.zeros(image.shape[:2], dtype=np.int32)
    if vertically:
        img_t = np.swapaxes(image, 0, 1)
        out_t, vmap_t = carve(img_t, seams_number, blocksize, edges, textures, False, luma_fn)
        return np.swapaxes(out_t, 0, 1), np.swapaxes(vmap_t, 0, 1)
    if seams_number < 0:
        out, vmap, _ = carve_seams(image, -seams_number, blocksize, edges, textures, luma_fn)
        return out, vmap
    out, vmap = insert_seams(image, seams_number, blocksize, edges, textures, luma_fn)
    return out, vmap


def normalize_to_u8(energy: np.ndarray) -> np.ndarray:
    """Min-max normalize to u8 with round-half-up (DOUBLE2GUCHAR, src/render.h:6)."""
    e = np.asarray(energy, dtype=np.float64)
    mn, mx = e.min(), e.max()
    if mx == mn:
        return np.zeros(e.shape, dtype=np.uint8)
    return np.floor(255.0 * (e - mn) / (mx - mn) + 0.5).astype(np.uint8)
