"""Sigma-dependent attenuation caches for the FMM operator.

The caches store the attenuation line integrals **E** -- which are *mode-independent* -- instead of per-mode
fused kernel operators.  The per-mode kernel factors cos(m theta)/r are tiny
static tables (fmm.apply), folded in at apply time as fused elementwise work:

  far field (M2L):  smooth + real = (expm1(-E) + 1) cos(m theta)/r
                                  =  exp(-E) cos(m theta)/r
  near field      :  expm1(-E) cos(m theta)/r  (+ sigma_hat on the m=0 diag;
                     the 1/r part is carried by the refined+Duffy stencil)

One E tensor per level serves every Fourier mode -- the reference instead
caches a full operator per mode (runKernelsCache per id, AnisoWrapper.cpp:
72-90; GBs at scale, Aniso.cpp:19-47).

E assembly is a fixed einsum of *static, sigma-independent* segment-
quadrature weights (ops.segment_stencil) with patches of the sigma_t
Legendre coefficient field:

  * near pairs and fine M2L levels (box size B in {1, 2} squares): weights
    are built once per (deg, np_cheb, B) in numpy (sub-second, lru-cached,
    grid-size independent) and the per-sigma einsum runs on device --
    one compiled program per (B, grid) shape shared by all 4 parity classes;
  * coarse M2L levels (B >= 4): per-offset restructured contractions run
    ON DEVICE in f64 (build_m2l_E_coarse_device; sigma-independent weight
    blocks lru-cached on the host, deduped across parity classes); the
    very coarse levels with a handful of boxes use per-pair exact line
    integrals on the host native OpenMP engine (csrc/aniso_host.cpp; JAX
    fallback), overlapping the async device dispatch.  The chosen paths
    are logged.

Reference counterpart for all of this: the four cache passes
KernelFactory.cpp:279-334 (runKernelsCache/CacheSing) and :550-788
(refineAddOnCache / singularAddCache).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import Grid, make_grid
from ..ops.segment_stencil import near_pair_weights, segment_weights
from ..ops.attenuation import make_line_integral
from ..ops.stencil import patches_3x3
from ..utils.logging import log
from .cheb import cheb_grid_2d

# true f32 products: E feeds exp()/expm1() in the operator, and a reduced-
# precision f32 product (TF32 on an NVIDIA GPU) would perturb it by ~1e-3
HIGHEST = jax.lax.Precision.HIGHEST
from .structure import TreeConfig, coarsest_m2l_level, vlist_offsets


# ---------------------------------------------------------------------------
# Static (sigma-independent) weight tables -- numpy f64, cached per geometry
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def near_weights_np(deg: int) -> np.ndarray:
    """(3,3,nq,nq,3,3,nq) static E weights for the 3x3 near node pairs.

    Grid-size independent (cell units); any sz works for the builder grid.
    """
    return near_pair_weights(make_grid(4, deg))


@functools.lru_cache(maxsize=None)
def _fine_W_flat_np(deg: int, np_cheb: int, B: int, dtype_str: str):
    """(4, Q, P) factored-layout weight operator in CELL units, host
    numpy, lru-cached per dtype and uploaded per set_coeff call, so the
    device holds it only while a build or a factored level needs it."""
    W = fine_m2l_weights_np(deg, np_cheb, B)
    nq = deg * deg
    PX = 7 * B
    Wr = W.transpose(0, 4, 2, 3, 1).reshape(4, nq * PX * PX, -1)
    return np.ascontiguousarray(Wr.astype(np.dtype(dtype_str)))


def _fine_W_device(grid: Grid, np_cheb: int, B: int, dtype) -> jnp.ndarray:
    """Upload the cell-units W operator for one fine level."""
    return jnp.asarray(
        _fine_W_flat_np(grid.deg, np_cheb, B, jnp.dtype(dtype).str)
    )


@functools.lru_cache(maxsize=None)
def fine_m2l_weights_np(deg: int, np_cheb: int, B: int) -> np.ndarray:
    """(4, r*27*r, 7B, 7B, nq) static E weights for fine-level M2L pairs.

    Class order c = 2*px + py; every parity class has exactly 27 V-list
    offsets.  Weights are relative to the target box corner with the common
    patch covering cells [-3B, 4B) per axis; grid-size independent.

    The pair axis is ordered (a, o, b) -- target point major, offset,
    source point minor -- matching the E-cache storage layout (see
    build_m2l_E_fine).
    """
    g = make_grid(4, deg)  # only deg-dependent tables are used
    r = np_cheb * np_cheb
    cheb = (cheb_grid_2d(np_cheb) + 1.0) / 2.0 * B
    PX = 7 * B
    out = np.empty((4, 27 * r * r, PX, PX, deg * deg))
    for px in (0, 1):
        for py in (0, 1):
            offs = vlist_offsets(px, py)
            p0 = np.empty((len(offs), r, r, 2))
            p1 = np.empty((len(offs), r, r, 2))
            for oi, (di, dj) in enumerate(offs):
                src = cheb[None, :, :] + np.array([di * B, dj * B])
                p0[oi] = np.broadcast_to(src, (r, r, 2))
                p1[oi] = np.broadcast_to(cheb[:, None, :], (r, r, 2))
            out[2 * px + py] = segment_weights(
                g,
                p0.reshape(-1, 2),
                p1.reshape(-1, 2),
                patch_lo=np.array([-3 * B, -3 * B]),
                patch_shape=(PX, PX),
            )
    # reorder pairs (o, a, b) -> (a, o, b) to match the cache layout
    perm = (
        np.arange(27 * r * r).reshape(27, r, r).transpose(1, 0, 2).reshape(-1)
    )
    return out[:, perm]


# ---------------------------------------------------------------------------
# Near-field E: one einsum over all squares
# ---------------------------------------------------------------------------


def near_pair_geometry(grid: Grid):
    """Static physical (dx_vec, dy_vec, r) for near pairs (3,3,nq_t,nq_s)."""
    dx = grid.dx
    tx = 0.5 * dx + 0.5 * grid.qx * dx
    ty = 0.5 * dx + 0.5 * grid.qy * dx
    offs = np.array([-1.0, 0.0, 1.0])
    sx = (0.5 + offs)[:, None] * dx + 0.5 * grid.qx[None, :] * dx  # (3, nq)
    sy = (0.5 + offs)[:, None] * dx + 0.5 * grid.qy[None, :] * dx
    dxv = sx[:, None, None, :] - tx[None, None, :, None]   # (3,1,nq_t,nq_s)
    dxv = np.broadcast_to(dxv, (3, 3, grid.nq, grid.nq))
    dyv = sy[None, :, None, :] - ty[None, None, :, None]
    dyv = np.broadcast_to(dyv, (3, 3, grid.nq, grid.nq))
    r = np.sqrt(dxv ** 2 + dyv ** 2)
    return dxv, dyv, r


@functools.partial(jax.jit, static_argnums=())
def _near_E_einsum(W: jnp.ndarray, coeffs: jnp.ndarray) -> jnp.ndarray:
    """E for all near pairs: (sz, sz, 3, 3, nq_t, nq_s) (in units of dx)."""
    patch = patches_3x3(jnp.pad(coeffs, ((1, 1), (1, 1), (0, 0))))
    return jnp.einsum("abtscdq,qcdij->abtsij", W, patch, precision=HIGHEST)


def build_near_E(grid: Grid, coeffs: jnp.ndarray, dtype=jnp.float32):
    """E for all near pairs: (3, 3, nq_t, nq_s, sz, sz), physical units.

    Spatial dims last, so the sharded layout (parallel.api.shard_pytree)
    splits the two minor dims."""
    W = jnp.asarray(near_weights_np(grid.deg), dtype=dtype)
    return _near_E_einsum(W, coeffs.astype(dtype)) * grid.dx


# ---------------------------------------------------------------------------
# M2L E per level
# ---------------------------------------------------------------------------


def build_m2l_patch_fine(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs: jnp.ndarray, dtype=jnp.float32, store_patch: bool = True,
) -> dict:
    """Factored E at a fine level: {'patch': (4, m2, m2, Q), 'W': (4, Q, P)}
    (per-parity-class factors; the apply side indexes W[c]).

    E is *exactly* a linear map of the local sigma_t coefficient patch
    (Q = (7B)^2 * nq values per box): E[c, x, y, :] = patch @ W.  Storing
    the factors instead of the dense (4, m2, m2, P= r*27*r) tensor is a
    16x footprint cut at the leaf (Q = 441 vs P = 6912 for deg 3, np 4) --
    the dense form is 7.2 GB at 512^2; the factors are 462 MB + 12 MB.
    fmm.apply._m2l_translate re-forms E chunk-by-chunk inside the matvec
    (recompute-E-on-the-fly, chosen over a lossy SVD because the
    factorization is exact).  Same (a, o, b)
    pair layout and dx scaling as build_m2l_E_fine (folded into W).
    """
    B = tcfg.box_size_squares(level)
    W = _fine_W_device(grid, np_cheb, B, dtype) * jnp.asarray(
        grid.dx, dtype=dtype
    )
    out = {"W": W}                                         # (4, Q, P)
    if store_patch:
        out["patch"] = patch_for_level(coeffs.astype(dtype), level)
    return out


def patch_for_level(coeffs, level: int) -> jnp.ndarray:
    """(4, m2, m2, Q) per-box coefficient patches at a fine level, straight
    from the (sz, sz, nq) coefficient field.  Pure data movement -- the
    'virtual' cache representation recomputes this inside the matvec
    instead of storing it (926 MB f64 per level at 512^2).

    Built from STATIC box-plane slices, not a strided window conv: the
    (7B, 7B)-window stride-2B `conv_general_dilated_patches` form defeats
    GSPMD partitioning and re-gathers the whole sharded coefficient field
    (62 all-gathers x 2.75 GB/shard at 1024^2 on the virtual CPU mesh).
    The patch of box (x, y) in class (px, py) covers cells
    [px*B + 2Bx - 3B, px*B + 2Bx + 4B) per axis = a fixed 4-box window
    on the 2B-cell box plane (offsets px-2 .. px+1), so the assembly is
    8 zero-padded shifted slices per axis -- a halo-2 stencil GSPMD
    lowers to O(halo) collective-permutes, exactly like _vlist_gather.
    """
    sz, nq = coeffs.shape[0], coeffs.shape[-1]
    B = sz >> level
    m2 = (1 << level) // 2
    PX = 7 * B
    S = 2 * B                   # box-plane pitch in cells
    Cb = coeffs.reshape(m2, S, m2, S, nq)
    padB = jnp.pad(Cb, ((2, 2), (0, 0), (2, 2), (0, 0), (0, 0)))
    patches = []
    for px in (0, 1):
        # 4 consecutive boxes on the row axis: boxes x+px-2 .. x+px+1,
        # i.e. cells [2Bx + (px-2)*2B, ... + 8B); trim to the 7B window
        rows = jnp.concatenate(
            [padB[px + s : px + s + m2] for s in range(4)], axis=1
        )                                       # (m2, 8B, m2+4, S, nq)
        rows = rows[:, B:] if px == 0 else rows[:, :PX]
        for py in (0, 1):
            cols = jnp.concatenate(
                [rows[:, :, py + s : py + s + m2] for s in range(4)],
                axis=3,
            )                                   # (m2, PX, m2, 8B, nq)
            cols = cols[:, :, :, B:] if py == 0 else cols[:, :, :, :PX]
            # -> (m2, m2, nq, PX, PX) -> flat (q, a, b) minor order,
            # matching the W operator layout (_fine_W_flat_np)
            patches.append(
                cols.transpose(0, 2, 4, 1, 3).reshape(m2, m2, nq * PX * PX)
            )
    return jnp.stack(patches)


@functools.partial(jax.jit, static_argnums=(3,))
def _fine_E_build_jit(coeffs, W, dx, level):
    """ONE jitted program per (level shape, dtype) for the whole fine-level
    dense build: patch assembly + per-class contraction + the reshape to
    (m2, m2, r, 27r).  One program rather than dozens of small eager
    dispatches, so the persistent compilation cache holds it and a second
    process pays only the dispatch."""
    patch = patch_for_level(coeffs, level)
    P = W.shape[-1]
    r = int(np.sqrt(P // 27))
    out = []
    for c in range(4):
        E = jnp.einsum("xyq,qp->xyp", patch[c], W[c], precision=HIGHEST)
        m2 = E.shape[0]
        out.append((E * dx).reshape(m2, m2, r, P // r))
    return tuple(out)


def build_m2l_E_fine(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs: jnp.ndarray, dtype=jnp.float32,
) -> tuple:
    """Tuple of 4 per-parity-class (m2, m2, r, 27r) E tensors at a fine
    level (B in {1, 2}), physical units; the pair axis is (a, o, b) --
    target point, then offset and source point.

    One batched patch @ W contraction per class, sharing the factored-
    layout weight operator (the dense and factored representations are
    the same linear map -- dense just materializes it at set_coeff time
    instead of per matvec).

    Stored per CLASS, never stacked, so that no single array holds more
    than a quarter of the level.  Row-major (m2, m2, r, 27r) is the one
    orientation: on an H100 the y-minor (m2, r, 27r, m2) and flat
    (m2, m2, P) alternatives ran no faster (all-dense forward at 128^2
    and 512^2).
    """
    B = tcfg.box_size_squares(level)
    W = _fine_W_device(grid, np_cheb, B, dtype)        # (4, Q, P), cell units
    dx = jnp.asarray(grid.dx, dtype=dtype)
    return _fine_E_build_jit(coeffs.astype(dtype), W, dx, level)


def unsharded_build() -> bool:
    """True when caches are built for single-device use: fine levels
    evicted from the dense budget then take the fast per-offset
    recompute form (its strided window extraction would re-gather a
    GSPMD-sharded field).  Sharded builders/fixtures declare themselves
    with ANISO_UNSHARDED=0 (env) or _UNSHARDED_BUILD=False and keep the
    GSPMD-safe factored patch fallback."""
    return _os.environ.get("ANISO_UNSHARDED", "1") != "0" and _UNSHARDED_BUILD


_UNSHARDED_BUILD = True


@functools.lru_cache(maxsize=None)
def _fine_offset_entries(np_cheb: int):
    """Canonical per-offset plan shared by build_m2l_offsets_fine and
    fmm.apply._m2l_translate_offsets: (entries, keys, mirrors) with
    entries = ((c, o, px, py, di, dj, ki), ...) over canonical (class,
    offset) blocks, keys = the distinct physical offsets (di, dj) in
    upload order (the weight geometry drops the parity class), and
    mirrors[(c, o)] = (c2, o2, sx, sy) from coarse_mirror_table."""
    entries = []
    keys = []
    mirrors = {}
    for (c, o, canonical, c2, o2, sx, sy) in coarse_mirror_table(np_cheb):
        if not canonical:
            continue
        px, py = c >> 1, c & 1
        di, dj = vlist_offsets(px, py)[o]
        if (di, dj) not in keys:
            keys.append((di, dj))
        entries.append((c, o, px, py, di, dj, keys.index((di, dj))))
        mirrors[(c, o)] = (c2, o2, sx, sy)
    return tuple(entries), tuple(keys), mirrors


def build_m2l_offsets_fine(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    dtype=jnp.float32,
) -> dict:
    """Per-offset VIRTUAL representation of a fine level: {'Wo': tuple of
    (r*r, bbx, bby, nq) weight blocks}, one per distinct canonical
    physical offset, grid.dx folded in.  ~MBs resident (vs 97-390 MB for
    the factored W and GBs for dense E).

    fmm.apply._m2l_translate_offsets re-forms each canonical (class,
    offset) E block inside the matvec from bounding-box windows of the
    coefficient field -- the same restructuring that makes the coarse
    levels cheap (_coarse_offset_weight_cached: the bbox patch is ~5-6x
    smaller than the 27-offset union patch (7B)^2, so the re-form costs
    ~5-6x fewer flops than the factored patch @ W form) -- and reuses
    exp(-E) TRANSPOSED for the block's mirror partner (line-integral
    symmetry E(a->b) = E(b->a), coarse_mirror_table), halving both the
    quadrature flops and the exp work.  Chosen for the f64 refinement
    twin's fine levels and for f32 fine levels evicted from the dense
    budget on single-device configs.
    NOT used under a mesh: the strided box-plane window extraction would
    re-gather a GSPMD-sharded coefficient field (the factored patch form
    stays the sharded fallback, patch_for_level)."""
    _, keys, _ = _fine_offset_entries(np_cheb)
    B = tcfg.box_size_squares(level)
    dxv = np.asarray(grid.dx)
    r2 = (np_cheb * np_cheb) ** 2
    # stored flat (r*r, bbx*bby*nq), the contraction axis minor; bbx/bby
    # are re-derived at apply time from (di, dj) and B.
    return {
        "Wo": tuple(
            jnp.asarray(
                (_coarse_offset_weight_cached(
                    grid.deg, np_cheb, B, di, dj)[0] * dxv).reshape(r2, -1),
                dtype=dtype,
            )
            for (di, dj) in keys
        )
    }


def build_near_E_np(grid: Grid, coeffs_np: np.ndarray) -> np.ndarray:
    """Host (numpy/BLAS) twin of build_near_E, f64: (3,3,nq,nq,sz,sz).

    Used for the refinement twin: pure numpy means zero XLA compiles and
    the work is a single dgemm-backed einsum (~seconds at 512^2)."""
    W = near_weights_np(grid.deg)
    pad = np.pad(np.asarray(coeffs_np, np.float64), ((1, 1), (1, 1), (0, 0)))
    win = np.lib.stride_tricks.sliding_window_view(pad, (3, 3), axis=(0, 1))
    # win[i, j, q, c, d] = pad[i + c, j + d, q]
    E = np.einsum("abtscdq,ijqcd->abtsij", W, win, optimize=True)
    return E * grid.dx


def build_m2l_E_fine_np(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs_np: np.ndarray,
) -> np.ndarray:
    """Host (numpy/BLAS) twin of build_m2l_E_fine, f64: (4, m2, m2, P)."""
    B = tcfg.box_size_squares(level)
    m2 = tcfg.boxes(level) // 2
    PX = 7 * B
    W = fine_m2l_weights_np(grid.deg, np_cheb, B)
    pad = np.pad(
        np.asarray(coeffs_np, np.float64),
        ((3 * B, 4 * B), (3 * B, 4 * B), (0, 0)),
    )
    ext = 2 * m2 * B + 5 * B
    P = W.shape[1]
    out = np.empty((4, m2, m2, P))
    for px in (0, 1):
        for py in (0, 1):
            sl = pad[px * B : px * B + ext, py * B : py * B + ext]
            win = np.lib.stride_tricks.sliding_window_view(
                sl, (PX, PX), axis=(0, 1)
            )[:: 2 * B, :: 2 * B]
            # win[x, y, q, a, b] = sl[2Bx + a, 2By + b, q]
            out[2 * px + py] = np.einsum(
                "pabq,xyqab->xyp", W[2 * px + py], win, optimize=True
            )
    return out * grid.dx


@functools.lru_cache(maxsize=None)
def coarse_mirror_table(np_cheb: int) -> tuple:
    """Per (class, offset): the line-integral symmetry E(a->b) = E(b->a).

    Entry (c, o) with absolute offset d pairs with entry (c', o') where the
    roles of target and source box swap: c' is the parity class of I + d,
    o' indexes -d in c''s V list, and the paired box plane is shifted by
    (sx, sy) = ((p + d - p') / 2) per axis (always in {-1, 0, 1}: every
    V-list source is at most one box away on its parity plane, cf.
    parity_shift_table_np).  The pairing is a fixed-point-free involution
    (d = -d would need d = 0, never a V offset), so computing only the
    lexicographically-canonical half of the blocks and transposing the
    (a, b) point axes into the mirror halves the integral count.

    Returns tuple of (c, o, canonical, c2, o2, sx, sy)."""
    out = []
    for px in (0, 1):
        for py in (0, 1):
            c = 2 * px + py
            offs = vlist_offsets(px, py)
            for o, (di, dj) in enumerate(offs):
                qx, qy = (px + di) & 1, (py + dj) & 1
                c2 = 2 * qx + qy
                o2 = vlist_offsets(qx, qy).index((-di, -dj))
                sx = (px + di - qx) // 2
                sy = (py + dj - qy) // 2
                canonical = (di, dj) > (-di, -dj)
                out.append((c, o, canonical, c2, o2, sx, sy))
    return tuple(out)


def mirror_fill_coarse(E6: np.ndarray) -> None:
    """Fill non-canonical (class, offset) blocks of E6 (4, m2, m2, 27, r, r)
    in place from their canonical mirrors (transposed point axes, shifted
    box plane).  Entries whose mirror source falls off the plane are
    zeroed: they correspond to out-of-domain boxes whose multipoles are
    zero-padded in the V-list gather (fmm.apply._vlist_gather), so their E
    value is never observable."""
    m2 = E6.shape[1]
    r = E6.shape[-1]
    for (c, o, canonical, c2, o2, sx, sy) in coarse_mirror_table(
        int(np.sqrt(r))
    ):
        if not canonical:
            continue
        blk = E6[c, :, :, o]                      # (m2, m2, r, r)
        dst = np.zeros_like(blk)
        xd = slice(max(0, sx), m2 + min(0, sx))
        yd = slice(max(0, sy), m2 + min(0, sy))
        xs = slice(max(0, -sx), m2 + min(0, -sx))
        ys = slice(max(0, -sy), m2 + min(0, -sy))
        dst[xd, yd] = blk[xs, ys].transpose(0, 1, 3, 2)
        E6[c2, :, :, o2] = dst


# per-offset dgemm coarse levels: cap on one (class, offset) weight block
# (r^2 pairs x bounding-box cells x nq, f64) -- beyond it (B >= 64) the
# native per-pair engine takes over (few boxes there)
_COARSE_DGEMM_MAX_W_BLOCK_BYTES = 400 * 1024 * 1024

# cap on a LEVEL's total per-offset W bytes for the DEVICE dgemm path.
# The W tables scale as B^2 per cell count: at 512^2 deg 3 np_cheb 4 the
# B=32 level alone is 3.17 GB and B=16 is 0.79 GB of f64 weights.
# W-heavy levels run the HOST dgemm (same flops, no upload; they overlap
# the device dispatch), and the W-light device levels cache their
# weights ON DEVICE for the process (sigma-independent; ~0.25 GB at deg 3
# np_cheb 4).  Whether the device should take the W-heavy levels too is
# open (ROADMAP D2).
import os as _os  # noqa: E402

_COARSE_DEVICE_MAX_W_LEVEL_BYTES = (
    int(_os.environ.get("ANISO_COARSE_DEVICE_W_MB", 400)) * 1024 * 1024
)

_DEVICE_W_CACHE: dict = {}


def _coarse_level_W_bytes(deg: int, np_cheb: int, B: int) -> int:
    """Total f64 bytes of the distinct canonical per-offset W blocks."""
    _, keys, _ = _fine_offset_entries(np_cheb)
    r2 = (np_cheb * np_cheb) ** 2
    return sum(
        r2 * ((abs(di) + 1) * B) * ((abs(dj) + 1) * B) * deg * deg * 8
        for (di, dj) in keys
    )


def _coarse_offset_weight_device(deg: int, np_cheb: int, B: int,
                                 di: int, dj: int) -> jnp.ndarray:
    """Device-resident f64 W block, uploaded once per process."""
    key = (deg, np_cheb, B, di, dj)
    W = _DEVICE_W_CACHE.get(key)
    if W is None:
        W = jnp.asarray(
            _coarse_offset_weight_cached(deg, np_cheb, B, di, dj)[0]
        )
        _DEVICE_W_CACHE[key] = W
    return W


@functools.lru_cache(maxsize=None)
def _coarse_offset_weight_cached(
    deg: int, np_cheb: int, B: int, di: int, dj: int
):
    """Static E weights for ONE V-list offset at box size B.

    Pairs (a, b) = (target cheb, source cheb); the patch is the bounding
    box of the two boxes ((|di|+1)B x (|dj|+1)B cells -- ~8x smaller than
    the 27-offset union patch (7B)^2, which is what makes per-offset
    weights affordable at B in {4..32} where the union table would be GBs).
    Returns (W, ox0, oy0) with W: (r*r, bbx, bby, nq), origin relative to
    the target box corner in cell units.

    Sigma-independent, hence lru-cached for the process (the rebuild
    would otherwise dominate a warm set_coeff), and the key
    deliberately drops the parity class (the geometry depends only on
    (di, dj)), deduping the 54 canonical (class, offset) builds to the
    ~20 distinct canonical physical offsets.  segment_weights reads the
    grid only through its deg-rule tables (cell units), so a fixed tiny
    builder grid serves every domain size."""
    g = make_grid(4, deg)
    r = np_cheb * np_cheb
    cheb = (cheb_grid_2d(np_cheb) + 1.0) / 2.0 * B
    ox0, oy0 = min(0, di * B), min(0, dj * B)
    bbx, bby = (abs(di) + 1) * B, (abs(dj) + 1) * B
    p1 = np.broadcast_to(cheb[:, None, :], (r, r, 2)).reshape(-1, 2)
    src = cheb[None, :, :] + np.array([di * B, dj * B])
    p0 = np.broadcast_to(src, (r, r, 2)).reshape(-1, 2)
    W = segment_weights(
        g, p0, p1, patch_lo=np.array([ox0, oy0]), patch_shape=(bbx, bby)
    )
    return W, ox0, oy0


def _coarse_offset_weight(grid: Grid, np_cheb: int, B: int, di: int, dj: int):
    """Back-compat shim over the cached per-offset weight builder."""
    return _coarse_offset_weight_cached(grid.deg, np_cheb, B, di, dj)


def _coarse_dgemm_level_np(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs_np: np.ndarray,
) -> np.ndarray:
    """(4, m2, m2, 27, r, r) f64 E at a coarse level via per-offset static
    weights x sliding coefficient windows (host BLAS dgemm).  Exact: the
    same piecewise-Gauss quadrature as the per-pair engine, restructured
    as 54 canonical (class, offset) matmuls + the mirror pass.  ~10x the
    per-pair throughput on this host at B in {4, 8, 16} (measured: 280 s
    -> ~30 s for all coarse levels at 512^2)."""
    B = tcfg.box_size_squares(level)
    r = np_cheb * np_cheb
    m2 = tcfg.boxes(level) // 2
    cf = np.asarray(coeffs_np, np.float64)
    pad = np.pad(cf, ((3 * B, 4 * B), (3 * B, 4 * B), (0, 0)))
    E6 = np.empty((4, m2, m2, 27, r, r), dtype=np.float64)
    for (c, o, canonical, _, _, _, _) in coarse_mirror_table(np_cheb):
        if not canonical:
            continue
        px, py = c >> 1, c & 1
        di, dj = vlist_offsets(px, py)[o]
        W, ox0, oy0 = _coarse_offset_weight(grid, np_cheb, B, di, dj)
        bbx, bby = W.shape[1], W.shape[2]
        x0 = px * B + ox0 + 3 * B
        y0 = py * B + oy0 + 3 * B
        sl = pad[x0 : x0 + 2 * B * (m2 - 1) + bbx,
                 y0 : y0 + 2 * B * (m2 - 1) + bby]
        win = np.lib.stride_tricks.sliding_window_view(
            sl, (bbx, bby), axis=(0, 1)
        )[:: 2 * B, :: 2 * B]
        # win[x, y, q, a, b] = sl[2Bx + a, 2By + b, q]
        E6[c, :, :, o] = np.einsum(
            "pabq,xyqab->xyp", W, win, optimize=True
        ).reshape(m2, m2, r, r)
    mirror_fill_coarse(E6)
    return E6 * grid.dx


def _coarse_dgemm_eligible(grid: Grid, tcfg: TreeConfig, level: int,
                           np_cheb: int) -> bool:
    """The per-offset-weights restructuring pays off when boxes are many
    and the weight blocks bounded; beyond (B >= 64 here) the per-pair
    engine takes over.  Shared by the host and device builders so both
    agree on which levels they own."""
    B = tcfg.box_size_squares(level)
    r = np_cheb * np_cheb
    m2 = tcfg.boxes(level) // 2
    w_block_bytes = r * r * (4 * B) * (4 * B) * grid.nq * 8
    return w_block_bytes <= _COARSE_DGEMM_MAX_W_BLOCK_BYTES and m2 >= 8


@functools.lru_cache(maxsize=None)
def _coarse_device_level_fn(deg: int, np_cheb: int, B: int, m2: int, nq: int):
    """One jitted f64 program per (geometry, level shape): all canonical
    per-offset contractions + the mirror fill + (a, o, b) assembly.

    A single jit per level (not per offset) keeps the compile count at
    one program per level; the W blocks ride as ARGUMENTS (a tuple
    pytree), never as baked constants (GB programs).  Window extraction
    is B-granular box-plane slicing -- strided static slices and f64
    dot_generals, no f64 convolutions."""
    r = np_cheb * np_cheb
    entries = []          # (c, o, di, dj, key_index) for canonical blocks
    keys = []             # distinct (di, dj) in upload order
    for (c, o, canonical, *_rest) in coarse_mirror_table(np_cheb):
        if not canonical:
            continue
        px, py = c >> 1, c & 1
        di, dj = vlist_offsets(px, py)[o]
        if (di, dj) not in keys:
            keys.append((di, dj))
        entries.append((c, o, px, py, di, dj, keys.index((di, dj))))
    mirror = coarse_mirror_table(np_cheb)

    def impl(pad, Ws, dx):
        # pad: (2B*m2 + 7B, same, nq) f64; Ws: tuple of (r*r, bbx, bby, nq)
        LX = pad.shape[0] // B
        pb = pad.reshape(LX, B, LX, B, nq)
        blocks = {}
        for (c, o, px, py, di, dj, ki) in entries:
            W = Ws[ki]
            bbx, bby = W.shape[1], W.shape[2]
            ox0, oy0 = min(0, di * B), min(0, dj * B)
            ux = (px * B + ox0 + 3 * B) // B
            uy = (py * B + oy0 + 3 * B) // B
            nbx, nby = bbx // B, bby // B
            rows = jnp.concatenate(
                [pb[ux + s : ux + s + 2 * m2 : 2] for s in range(nbx)],
                axis=1,
            )                               # (m2, bbx, LX, B, nq)
            win = jnp.concatenate(
                [rows[:, :, uy + s : uy + s + 2 * m2 : 2]
                 for s in range(nby)],
                axis=3,
            )                               # (m2, bbx, m2, bby, nq)
            E = jnp.einsum(
                "xaybq,pabq->xyp", win, W, precision=HIGHEST
            )
            blocks[(c, o)] = E.reshape(m2, m2, r, r)
        # mirror fill: E(a -> b) = E(b -> a) with the box plane shifted
        # (same table as mirror_fill_coarse; off-plane sources are zero)
        for (c, o, canonical, c2, o2, sx, sy) in mirror:
            if not canonical:
                continue
            blk = blocks[(c, o)]
            dst = jnp.zeros_like(blk)
            xd = slice(max(0, sx), m2 + min(0, sx))
            yd = slice(max(0, sy), m2 + min(0, sy))
            xs = slice(max(0, -sx), m2 + min(0, -sx))
            ys = slice(max(0, -sy), m2 + min(0, -sy))
            blocks[(c2, o2)] = dst.at[xd, yd].set(
                blk[xs, ys].transpose(0, 1, 3, 2)
            )
        E6 = jnp.stack([
            jnp.stack([blocks[(c, o)] for o in range(27)], axis=2)
            for c in range(4)
        ])                                  # (4, m2, m2, 27, r, r)
        return (
            E6.transpose(0, 1, 2, 4, 3, 5).reshape(4, m2, m2, -1) * dx
        )

    return jax.jit(impl), keys


def build_m2l_E_coarse_device(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs_np: np.ndarray,
) -> jnp.ndarray:
    """f64 DEVICE (4, m2, m2, r*27*r) E at a dgemm-eligible coarse level:
    the same per-offset restructured quadrature as _coarse_dgemm_level_np,
    executed as one jitted program of f64 dot_generals on the device.
    The reference's runKernelsCache passes (KernelFactory.cpp:279-334) ran
    this work on host threads.

    Requires x64 mode; the result feeds the f32 cache by an on-device
    cast and the f64 refinement twin as-is.  Weight blocks are lru-cached
    on the host (sigma-independent) and uploaded per call (~f64 bytes of
    the distinct canonical offsets; freed after the build)."""
    assert jax.dtypes.canonicalize_dtype(jnp.float64) == jnp.float64, \
        "device coarse E needs jax x64 mode"
    B = tcfg.box_size_squares(level)
    m2 = tcfg.boxes(level) // 2
    fn, keys = _coarse_device_level_fn(
        grid.deg, np_cheb, B, m2, grid.nq
    )
    pad = jnp.asarray(np.pad(
        np.asarray(coeffs_np, np.float64),
        ((3 * B, 4 * B), (3 * B, 4 * B), (0, 0)),
    ))
    # W blocks are sigma-independent: device-resident for the process
    # (see _COARSE_DEVICE_MAX_W_LEVEL_BYTES)
    Ws = tuple(
        _coarse_offset_weight_device(grid.deg, np_cheb, B, di, dj)
        for (di, dj) in keys
    )
    return fn(pad, Ws, jnp.float64(grid.dx))


def build_m2l_E_coarse_oracle_np(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs: jnp.ndarray, chunk: int = 4096, coeffs_np=None,
) -> np.ndarray:
    """f64 numpy (4, m2, m2, r*27*r) E at a coarse level (B >= 4) via exact
    per-pair line integrals on the host (native OpenMP engine; JAX
    fallback).  Same (a, o, b) pair-axis layout as build_m2l_E_fine.

    Demoted to an oracle / very-coarse-level path: production coarse
    levels with B <= 32 use _coarse_dgemm_level_np (identical quadrature,
    ~10x faster); `canonical_only` + the mirror pass halve this path's
    integral count when it does run (build_m2l_E_coarse_np).

    coeffs_np: optional host copy of coeffs (avoids a device read-back)."""
    return _coarse_perpair_level_np(
        grid, tcfg, level, np_cheb, coeffs, chunk, coeffs_np,
        canonical_only=False,
    )


def _coarse_perpair_level_np(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs, chunk: int, coeffs_np, canonical_only: bool,
) -> np.ndarray:
    B = tcfg.box_size_squares(level)
    r = np_cheb * np_cheb
    dx = grid.dx
    cheb = (cheb_grid_2d(np_cheb) + 1.0) / 2.0 * B    # cell units in box
    m2 = tcfg.boxes(level) // 2
    canon = {
        (c, o): canonical
        for (c, o, canonical, *_rest) in coarse_mirror_table(np_cheb)
    }

    from .. import native
    use_native = native.available()
    if use_native:
        if coeffs_np is None:
            coeffs_np = np.asarray(coeffs, np.float64)
        coeffs_np = np.asarray(coeffs_np, np.float64)
        pair_E = None
    else:
        if coeffs is None:
            coeffs = jnp.asarray(coeffs_np)
        span = 5 * B
        n_pieces = max(1, -(-span // 6))
        li = make_line_integral(grid, 8, n_pieces=n_pieces)
        pair_E = jax.jit(
            jax.vmap(lambda c, a, b: li(c, a[0], a[1], b[0], b[1]),
                     in_axes=(None, 0, 0))
        )

    E_out = np.empty((4, m2, m2, 27, r, r), dtype=np.float64)
    for px in (0, 1):
        for py in (0, 1):
            offs = vlist_offsets(px, py)
            I2 = np.arange(m2)
            bx = ((2 * I2 + px) * B)[:, None]
            by = ((2 * I2 + py) * B)[None, :]
            for oi, (di, dj) in enumerate(offs):
                if canonical_only and not canon[(2 * px + py, oi)]:
                    continue
                src_rel = cheb[None, :, :] + np.array([di * B, dj * B])
                tgt_rel = cheb[:, None, :]
                tgt = np.empty((m2, m2, r, r, 2))
                src = np.empty((m2, m2, r, r, 2))
                tgt[..., 0] = (bx[:, :, None, None] + tgt_rel[None, None, :, :, 0]) * dx
                tgt[..., 1] = (by[:, :, None, None] + tgt_rel[None, None, :, :, 1]) * dx
                src[..., 0] = (bx[:, :, None, None] + src_rel[None, None, :, :, 0]) * dx
                src[..., 1] = (by[:, :, None, None] + src_rel[None, None, :, :, 1]) * dx
                flat_s = src.reshape(-1, 2)
                flat_t = tgt.reshape(-1, 2)
                n_pairs = flat_s.shape[0]
                if use_native:
                    Es = native.attenuation_batch(grid, coeffs_np, flat_s, flat_t)
                else:
                    Es = np.empty(n_pairs)
                    for st in range(0, n_pairs, chunk):
                        en = min(st + chunk, n_pairs)
                        seg_s = np.zeros((chunk, 2)); seg_s[: en - st] = flat_s[st:en]
                        seg_t = np.zeros((chunk, 2)); seg_t[: en - st] = flat_t[st:en]
                        Ec = pair_E(coeffs,
                                    jnp.asarray(seg_s, dtype=coeffs.dtype),
                                    jnp.asarray(seg_t, dtype=coeffs.dtype))
                        Es[st:en] = np.asarray(Ec, np.float64)[: en - st]
                E_out[2 * px + py, :, :, oi] = Es.reshape(m2, m2, r, r)
    if canonical_only:
        mirror_fill_coarse(E_out)
    return E_out.transpose(0, 1, 2, 4, 3, 5).reshape(4, m2, m2, -1)


def build_m2l_E_coarse_np(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs: jnp.ndarray, chunk: int = 4096, coeffs_np=None,
) -> np.ndarray:
    """f64 (4, m2, m2, r*27*r) E at a coarse level (B >= 4): the
    production path.  B <= 32 runs the per-offset dgemm restructuring
    (_coarse_dgemm_level_np); very coarse levels (B >= 64, a handful of
    boxes) run the per-pair engine on the canonical half of the (class,
    offset) blocks and mirror the rest.  Both are the exact piecewise
    Gauss quadrature of the reference lineIntegral (KernelFactory.cpp:
    67-190); build_m2l_E_coarse_oracle_np retains the brute-force
    all-pairs path as the test oracle."""
    # dgemm pays a fixed per-offset weight-build cost; with few boxes the
    # canonical per-pair engine is cheaper (and exactly as accurate)
    if _coarse_dgemm_eligible(grid, tcfg, level, np_cheb):
        if coeffs_np is None:
            coeffs_np = np.asarray(coeffs, np.float64)
        E6 = _coarse_dgemm_level_np(grid, tcfg, level, np_cheb, coeffs_np)
        m2 = tcfg.boxes(level) // 2
        return E6.transpose(0, 1, 2, 4, 3, 5).reshape(4, m2, m2, -1)
    return _coarse_perpair_level_np(
        grid, tcfg, level, np_cheb, coeffs, chunk, coeffs_np,
        canonical_only=True,
    )


def build_m2l_E_coarse(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs: jnp.ndarray, dtype=jnp.float32, chunk: int = 4096,
    coeffs_np=None, precomputed_np=None,
) -> jnp.ndarray:
    """Device-dtype coarse-level E; `precomputed_np` reuses an
    already-built f64 host tensor (refine mode builds it once for both
    the f32 cache and the f64 twin)."""
    if precomputed_np is None:
        precomputed_np = build_m2l_E_coarse_np(
            grid, tcfg, level, np_cheb, coeffs, chunk, coeffs_np
        )
    return jnp.asarray(precomputed_np, dtype=dtype)


# Dense vs recompute fine levels.  Dense streams E from device memory once
# per matvec; the recompute forms (factored patch@W, per-offset) trade
# re-form flops per matvec for a 16x smaller footprint.  Policy: a level
# stores dense iff it fits the cumulative budget (what the device can hold
# next to everything else resident during a solve -- solver.operator
# subtracts that), allocated coarsest-first so the big leaf, whose
# recompute costs the same flops as any other level's, is the first to
# fall back.

# Optional per-array cap (one parity class of one fine level); None means
# no cap.  Tests set it to force recompute levels at small sizes.
_DENSE_E_LEVEL_CAP_BYTES = None

# The CPU backend reports no memory limit.  Its builds -- the test suite
# and CPU rehearsals at small sizes -- take this budget.
CPU_TEST_BUDGET_BYTES = 8 << 30


def device_memory_budget(device=None) -> int:
    """Bytes the process may allocate on `device` (default: this
    process's first device, where set_coeff builds): its allocator's
    `bytes_limit`.  The CPU backend reports none and gets
    CPU_TEST_BUDGET_BYTES; an accelerator without one is an error,
    because every representation choice rests on this number."""
    device = jax.local_devices()[0] if device is None else device
    stats = device.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if device.platform == "cpu":
        return CPU_TEST_BUDGET_BYTES
    raise RuntimeError(
        f"{device.platform} device {device.device_kind!r} reports no "
        f"bytes_limit in memory_stats(); cannot size the E caches"
    )


def fine_dense_level_bytes(m2: int, np_cheb: int, itemsize: int) -> int:
    """Bytes of one fine dense level: 4 parity classes of (m2, m2, r*27r)."""
    r = np_cheb * np_cheb
    return 4 * m2 * m2 * r * 27 * r * itemsize


def coarse_m2l_levels(tcfg: TreeConfig) -> list:
    return [
        lv for lv in range(coarsest_m2l_level(), tcfg.leaf_level + 1)
        if tcfg.box_size_squares(lv) > 2
    ]


def coarse_dense_bytes(tcfg: TreeConfig, np_cheb: int, itemsize: int) -> int:
    """Footprint of the (always dense) coarse-level E tensors."""
    r = np_cheb * np_cheb
    return sum(
        4 * (tcfg.boxes(lv) // 2) ** 2 * (r * 27 * r) * itemsize
        for lv in coarse_m2l_levels(tcfg)
    )


def build_m2l_E_coarse_all_np(
    grid: Grid, tcfg: TreeConfig, np_cheb: int, coeffs_np: np.ndarray,
) -> dict:
    """f64 host E for every coarse level (the all-host path: refinement
    host twin, and the fallback when x64 mode is off)."""
    return {
        lv: build_m2l_E_coarse_np(
            grid, tcfg, lv, np_cheb, None, coeffs_np=coeffs_np
        )
        for lv in coarse_m2l_levels(tcfg)
    }


def build_m2l_E_coarse_all(
    grid: Grid, tcfg: TreeConfig, np_cheb: int, coeffs_np: np.ndarray,
    allow_device: bool = True,
) -> dict:
    """f64 E for every coarse level, shared by the f32 cache (on-device
    cast) and the f64 refinement twin: dgemm-eligible levels run ON
    DEVICE (build_m2l_E_coarse_device; needs x64 mode), the very coarse
    per-pair levels (a handful of boxes) stay on the host native engine.
    Device work is dispatched FIRST and left ASYNC so the host per-pair
    levels overlap the accelerator; values are device jnp arrays or host
    numpy accordingly.  Opt out with ANISO_COARSE_DEVICE=0 (A/B and
    oracle runs)."""
    use_dev = (
        allow_device
        and _os.environ.get("ANISO_COARSE_DEVICE", "1") != "0"
        and jax.dtypes.canonicalize_dtype(jnp.float64) == jnp.float64
    )
    out = {}
    host_levels = []
    for lv in coarse_m2l_levels(tcfg):
        B = tcfg.box_size_squares(lv)
        if (
            use_dev
            and _coarse_dgemm_eligible(grid, tcfg, lv, np_cheb)
            and _coarse_level_W_bytes(grid.deg, np_cheb, B)
            <= _COARSE_DEVICE_MAX_W_LEVEL_BYTES
        ):
            out[lv] = build_m2l_E_coarse_device(
                grid, tcfg, lv, np_cheb, coeffs_np
            )
        else:
            # W-heavy dgemm levels run the HOST dgemm (same quadrature,
            # no weight upload), the very coarse few-box levels the
            # per-pair engine; both overlap the async device dispatch
            host_levels.append(lv)
    if host_levels:
        path = "native-openmp"
        from .. import native
        if not native.available():
            path = "jax-chunked"
        log.info(f"m2l E coarse host levels {host_levels}: dgemm-or-{path}")
    for lv in host_levels:
        out[lv] = build_m2l_E_coarse_np(
            grid, tcfg, lv, np_cheb, None, coeffs_np=coeffs_np
        )
    return out


def build_m2l_E(
    grid: Grid, tcfg: TreeConfig, np_cheb: int, coeffs: jnp.ndarray,
    dtype=jnp.float32, coeffs_np=None, dense_cap_bytes=None,
    coarse_np=None, store_patch: bool = True, budget_bytes=None,
    fine_fallback: str = "factored",
) -> dict:
    """Full per-level M2L E cache: coarse levels as stacked
    (4, m2, m2, r*27*r) dense tensors, fine levels as per-class 4D dense
    tuples (build_m2l_E_fine), or -- when dense would blow the per-array
    cap or the cumulative total budget (the 512^2 leaf alone is 7.25 GB
    f32) -- one of two recompute representations chosen by
    `fine_fallback`:

      'factored': {'patch', 'W'} (build_m2l_patch_fine) -- GSPMD-safe
        (the box-plane patch assembly shards O(halo)).
      'offsets': {'Wo'} per-offset virtual (build_m2l_offsets_fine) --
        ~5-6x fewer re-form flops + mirror-shared exp; single-device
        only (strided window extraction re-gathers sharded fields).

    Allocation is coarsest-first, which is also optimal: a factored or
    per-offset level costs the SAME total recompute flops whatever its
    depth (entries x bbox work is depth-invariant), so the budget should
    dense the cheap-in-bytes coarse/mid levels first and leave the big
    leaf to the recompute path.

    Mode-independent; serves every Fourier kernel (cf. the reference's
    per-mode cache passes, AnisoWrapper.cpp:72-90).
    """
    from .. import native

    r = np_cheb * np_cheb
    cache = {}
    coarse_levels = coarse_m2l_levels(tcfg)
    if coarse_levels and not coarse_np:
        path = "native-openmp" if native.available() else "jax-chunked"
        log.info(
            f"m2l E coarse levels {coarse_levels}: per-pair path = {path}"
        )
    if dense_cap_bytes is None:
        dense_cap_bytes = _DENSE_E_LEVEL_CAP_BYTES
    if dense_cap_bytes is None:
        dense_cap_bytes = float("inf")
    if budget_bytes is None:
        budget_bytes = device_memory_budget()
    itemsize = jnp.dtype(dtype).itemsize
    spent = 0
    for level in range(coarsest_m2l_level(), tcfg.leaf_level + 1):
        m2 = tcfg.boxes(level) // 2
        if tcfg.box_size_squares(level) <= 2:
            # fine levels store per CLASS: the cap applies to one class
            dense_bytes = fine_dense_level_bytes(m2, np_cheb, itemsize)
            if dense_bytes // 4 > dense_cap_bytes or \
               spent + dense_bytes > budget_bytes:
                log.info(
                    f"m2l E level {level}: {fine_fallback} (dense "
                    f"{dense_bytes / 1e9:.2f} GB vs remaining budget "
                    f"{max(0, budget_bytes - spent) / 1e9:.2f} GB)"
                )
                if fine_fallback == "offsets":
                    cache[level] = build_m2l_offsets_fine(
                        grid, tcfg, level, np_cheb, dtype
                    )
                else:
                    cache[level] = build_m2l_patch_fine(
                        grid, tcfg, level, np_cheb, coeffs, dtype,
                        store_patch=store_patch,
                    )
            else:
                spent += dense_bytes
                cache[level] = build_m2l_E_fine(
                    grid, tcfg, level, np_cheb, coeffs, dtype
                )
        else:
            # coarse levels are always dense, stored stacked flat-P
            spent += 4 * m2 * m2 * (r * 27 * r) * itemsize
            cache[level] = build_m2l_E_coarse(
                grid, tcfg, level, np_cheb, coeffs, dtype,
                coeffs_np=coeffs_np,
                precomputed_np=None if not coarse_np else coarse_np.get(level),
            )
    return cache


def build_m2l_E_host(
    grid: Grid, tcfg: TreeConfig, np_cheb: int, coeffs_np: np.ndarray,
    coarse_np=None,
) -> dict:
    """Host-resident f64 M2L E cache (refinement twin): numpy/BLAS fine
    levels + native coarse levels, returned as CPU-device jnp arrays.
    `coarse_np` shares coarse-level tensors already built for the f32
    cache (they are f64 host integrals either way)."""
    cache = {}
    for level in range(coarsest_m2l_level(), tcfg.leaf_level + 1):
        if tcfg.box_size_squares(level) <= 2:
            cache[level] = jnp.asarray(
                build_m2l_E_fine_np(grid, tcfg, level, np_cheb, coeffs_np),
                dtype=jnp.float64,
            )
        else:
            cache[level] = build_m2l_E_coarse(
                grid, tcfg, level, np_cheb, None,
                dtype=jnp.float64, coeffs_np=coeffs_np,
                precomputed_np=None if not coarse_np else coarse_np.get(level),
            )
    return cache


def m2l_cache_bytes(cache: dict) -> int:
    """Total bytes of the per-level E tensors (the reference prints the
    analogous per-mode cache report in Aniso.cpp:19-47 -- ours is
    mode-count independent).  Factored levels count their (patch, W)
    factors, per-offset levels their weight blocks."""

    def nbytes(a):
        return int(np.prod(a.shape)) * a.dtype.itemsize

    total = 0
    for v in cache.values():
        leaves = jax.tree_util.tree_leaves(v)
        total += sum(nbytes(a) for a in leaves)
    return total
