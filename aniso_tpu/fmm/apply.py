"""The implicit-quadtree Chebyshev FMM matvec as batched tensor sweeps.

Reference counterpart: bbfmm.h upPass/downPass (:825-945) -- recursive
pointer-tree traversals with per-node dgemv.  Here each phase is a handful
of einsums over whole levels:

  P2M   one (r, nq) matrix shared by every leaf (weights folded in)
  M2M   4 static (r, r) tensor-product transfers, level -> level-1
  M2L   per level: exp(-E) * cos(m theta)/r applied as one batched
        contraction per parity class; E is the sigma-dependent cache
        (fmm.smooth, mode-independent), cos(m theta)/r a tiny static table
  L2L   transpose of M2M
  L2T   transpose of P2M (no weights)

plus the U-list near field: expm1(-E) * cos(m theta)/r blocks fused with the
translation-invariant refined+Duffy correction stencil (ops.near), and the
m = 0 self-node diagonal sigma_hat * w (KernelFactory.cpp:260).  The real
kernel's own U-list is *omitted*: the reference subtracts those coarse 3x3
contributions right back out in nearRemoval (KernelFactory.cpp:445-478), so
skipping both is exact.

In the far field the smooth and singular kernels recombine:
(expm1(-E) + 1) cos(m theta)/r = exp(-E) cos(m theta)/r, so M2L needs no
separate "real" pass at all -- one fused contraction per level/class.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import Grid
from ..ops.stencil import patches_3x3
from .cheb import cheb_grid_2d, m2m_tensor, p2m_matrix

# Every contraction here is accuracy-critical (the operator itself), so
# each pins true f32 products: the default precision may run an f32
# matmul in reduced precision (TF32 on an NVIDIA GPU), and a GMRES solve
# then converges by its internal estimate while the true residual stalls.
HIGHEST = jax.lax.Precision.HIGHEST
from .structure import TreeConfig, coarsest_m2l_level, vlist_offsets


def build_fmm_static(grid: Grid, np_cheb: int, dtype=jnp.float32) -> dict:
    """Static sweep operators shared by every mode and every sigma."""
    p2m = p2m_matrix(grid.qx, grid.qy, np_cheb)      # (r, nq)
    wglob = grid.w2d * 0.25 * grid.dx * grid.dx
    return {
        "p2m_w": jnp.asarray(p2m * wglob[None, :], dtype=dtype),
        "l2t": jnp.asarray(p2m.T, dtype=dtype),
        "m2m": jnp.asarray(m2m_tensor(np_cheb), dtype=dtype),
    }


@functools.lru_cache(maxsize=None)
def m2l_pair_geometry_np(np_cheb: int):
    """Static V-list pair geometry in *box units*: (rr, ang), each
    (4, 27, r, r) with class order c = 2*px + py.

    Scale invariance: physical distance = rr * B * dx, angle unchanged, so
    one table serves every level (multiply rr by B * dx at use sites).
    """
    r = np_cheb * np_cheb
    cheb = (cheb_grid_2d(np_cheb) + 1.0) / 2.0       # box units [0, 1]
    rr = np.empty((4, 27, r, r))
    ang = np.empty((4, 27, r, r))
    for px in (0, 1):
        for py in (0, 1):
            for oi, (di, dj) in enumerate(vlist_offsets(px, py)):
                src = cheb[None, :, :] + np.array([di, dj])
                tgt = cheb[:, None, :]
                d = src - tgt                         # (r, r, 2)
                rr[2 * px + py, oi] = np.hypot(d[..., 0], d[..., 1])
                ang[2 * px + py, oi] = np.arctan2(d[..., 1], d[..., 0])
    return rr, ang


def build_mode_static(
    grid: Grid, tcfg: TreeConfig, np_cheb: int, mode: int,
    stencil: np.ndarray, dtype=jnp.float32,
) -> dict:
    """Per-mode static tables (geometry-only, tiny).

    m2l_cosr: dict level -> (4, r*27*r) = cos(m ang) / r_phys flattened in
      the cache's (a, o, b) pair order; multiplied by exp(-E) at apply time
      this is the full far-field kernel.
    near_cosrw: (3, 3, nq, nq) = cos(m ang) / r * w_src (0 at r = 0);
      multiplied by expm1(-E) at apply time.
    near_static: (3, 3, nq, nq) refined+Duffy stencil (ops.near), folded
      into the same contraction.
    """
    from .smooth import near_pair_geometry

    rr, ang = m2l_pair_geometry_np(np_cheb)
    cosr = {}
    for level in range(coarsest_m2l_level(), tcfg.leaf_level + 1):
        B = tcfg.box_size_squares(level)
        tab = np.cos(mode * ang) / (rr * B * grid.dx)   # (4, 27, r, r)
        cosr[level] = jnp.asarray(
            tab.transpose(0, 2, 1, 3).reshape(4, -1), dtype=dtype
        )
    dxv, dyv, r = near_pair_geometry(grid)
    wsrc = grid.w2d * 0.25 * grid.dx * grid.dx        # (nq_s,)
    safe = np.where(r == 0.0, 1.0, r)
    ncos = np.where(
        r == 0.0, 0.0, np.cos(mode * np.arctan2(dyv, dxv)) / safe
    ) * wsrc
    return {
        "m2l_cosr": cosr,
        "near_cosrw": jnp.asarray(ncos, dtype=dtype),
        "near_static": jnp.asarray(stencil, dtype=dtype),
    }


@functools.lru_cache(maxsize=None)
def parity_shift_table_np() -> np.ndarray:
    """(4, 27, 4) int: per class c = 2px+py and V offset o, the source
    parity plane and its box-grid shift: (sx, sy, shx+1, shy+1).

    Source box 2x+px+di has absolute axis index a = px+di in [-2, 3]
    (structure.axis_offsets), i.e. parity sx = a mod 2 on the coarse
    (m/2, m/2) plane shifted by shx = (a - sx)/2 in {-1, 0, 1}: every
    V-list source is at most ONE box away on its parity plane.  This is
    what makes M2L a halo-1 stencil under spatial sharding (GSPMD's
    supported halo regime) instead of a stride-2 window conv.
    """
    out = np.empty((4, 27, 4), dtype=np.int64)
    for px in (0, 1):
        for py in (0, 1):
            for o, (di, dj) in enumerate(vlist_offsets(px, py)):
                ax, ay = px + di, py + dj
                sx, sy = ax & 1, ay & 1
                out[2 * px + py, o] = (
                    sx, sy, (ax - sx) // 2 + 1, (ay - sy) // 2 + 1
                )
    return out


def _up_pass(static, leaf_level: int, u: jnp.ndarray):
    """Leaf charges -> multipoles per level: dict level -> (m, m, r).

    One einsum per level: the 4 child->parent transfers are batched through
    the (2, 2, r, r) m2m tensor acting on (m2, 2, m2, 2, r) children.
    """
    m2m = static["m2m"]
    M = {leaf_level: jnp.einsum("ck,ijk->ijc", static["p2m_w"], u, precision=HIGHEST)}
    for level in range(leaf_level, coarsest_m2l_level(), -1):
        child = M[level]
        m2 = child.shape[0] // 2
        r = child.shape[-1]
        c4 = child.reshape(m2, 2, m2, 2, r)
        M[level - 1] = jnp.einsum("hgac,xhygc->xya", m2m, c4, precision=HIGHEST)
    return M


def _vlist_gather(M_l: jnp.ndarray):
    """Parity-plane V-list gather at one level.

    Returns gsel: (4, m2, m2, 27*r) -- for each target parity class c, the
    27 source-box coefficient planes, offset-major in the minor dim (the
    cache's (a, o, b) pair layout contracts (o, b) jointly).  Multipoles are
    split into the 4 box parity planes; every V-list source is then a <=
    1-box shift of one plane (parity_shift_table_np), so the whole gather is
    36 static zero-padded slices (lazy XLA slices fused into the consuming
    stack) -- a halo-1 stencil that shards cleanly over a device mesh.
    Shared by every Fourier mode at this level.
    """
    m = M_l.shape[0]
    r = M_l.shape[-1]
    m2 = m // 2
    P4 = M_l.reshape(m2, 2, m2, 2, r)
    shifted = [[None] * 2 for _ in range(2)]
    for gx in (0, 1):
        for gy in (0, 1):
            pad = jnp.pad(P4[:, gx, :, gy], ((1, 1), (1, 1), (0, 0)))
            shifted[gx][gy] = [
                [pad[a : a + m2, b : b + m2] for b in range(3)]
                for a in range(3)
            ]
    tab = parity_shift_table_np()
    return jnp.stack(
        [
            jnp.stack(
                [
                    shifted[tab[c, o, 0]][tab[c, o, 1]][tab[c, o, 2]][tab[c, o, 3]]
                    for o in range(27)
                ],
                axis=2,
            ).reshape(m2, m2, 27 * r)
            for c in range(4)
        ]
    )


# cap on the materialized re-formed-E transient per parity class in the
# FACTORED path; rows are processed in lax.map chunks beyond it (XLA keeps
# a few such temps live inside a GMRES-loop matvec).
#
# DENSE levels are never chunked: a dynamic_slice chunk consumption can
# make XLA re-lay every dense E argument into a full-size program temp.
# Consumed whole, the elementwise exp(-E)*cosr producer reads the argument
# in place and the per-class split bounds the fused-operator transient to
# a quarter level.
import os as _os_caps

_M2L_TRANSIENT_CAP_BYTES = (
    int(_os_caps.environ.get("ANISO_M2L_TRANSIENT_CAP_MB", 256))
    * 1024 * 1024
)


def _interleave_classes(outs, m2, r):
    """Interleave the 4 parity classes: L[2x+px, 2y+py] = outs[2px+py][x, y]."""
    return (
        jnp.stack(outs)
        .reshape(2, 2, m2, m2, r)
        .transpose(2, 0, 3, 1, 4)
        .reshape(2 * m2, 2 * m2, r)
    )


def _row_chunk(m2, P, itemsize, n_shards=1):
    """Rows per streamed chunk so the materialized transient stays bounded.

    n_shards > 1 disables chunking entirely: a dynamic_slice along a
    GSPMD-sharded axis forces an all-gather of the operand (2.75 GB/shard
    re-gathered at 1024^2 on the virtual CPU mesh), while the
    partitioner already bounds every per-device transient to 1/n_shards
    of the global footprint.  Under a mesh, locality comes from the
    sharding itself, never from host-chosen chunks."""
    if n_shards > 1:
        return m2
    class_bytes = m2 * m2 * P * itemsize
    chunk = m2
    while chunk > 1 and (class_bytes // (m2 // chunk)) > _M2L_TRANSIENT_CAP_BYTES:
        chunk //= 2
    return chunk


def _loop_variant_zero(u):
    """An exact 0 of u's dtype that XLA cannot prove loop-invariant.

    Added to the E caches before exp/expm1 (and to factored patches
    before the re-form matmul), it defeats loop-invariant code motion:
    inside a GMRES while-loop or a chained scan, exp(-E) of the
    loop-invariant cache is otherwise HOISTED and materialized -- a
    second full-size copy of every dense level.  Recomputing exp per
    apply rides on the stream of E it is fused with.  The clip guards a
    hypothetical +-inf iterate (0 * inf = NaN would poison the
    operator)."""
    # static corner index, not reshape(-1)[0]: flattening a GSPMD-sharded
    # field re-gathers it; the corner slice costs one scalar broadcast
    anchor = jnp.clip(u[(0,) * u.ndim], -1.0, 1.0)
    return jax.lax.optimization_barrier(anchor * 0.0)


def _m2l_translate(E_l, cosr_l, gsel, n_shards=1, z=0.0):
    """Fused V-list translation at one level -> local expansions (m, m, r).

    E_l: dense (4, m2, m2, r*27*r) with pair axis (a, o, b) -- stacked
    (coarse levels) or a per-class tuple of 4 (m2, m2, P) blocks (fine
    levels, fmm.smooth.build_m2l_E_fine) -- or the factored
    {'patch': (4, m2, m2, Q), 'W': (4, Q, P)} form (fmm.smooth.
    build_m2l_patch_fine), in which case each streamed chunk first re-forms
    its E rows as one (chunk*m2, Q) @ (Q, P) matmul.  cosr_l:
    (4, r*27*r); gsel: (4, m2, m2, 27*r) from _vlist_gather.  The fused
    far-field operator exp(-E) cos/r is formed on the fly (fused
    elementwise on the cache read) and contracted as one batched
    (r x 27r) @ (27r,) matvec per box per parity class.  Large factored
    levels stream in row chunks to bound the transient.
    """
    factored = isinstance(E_l, dict)
    if factored and "Wo" in E_l:
        return _m2l_translate_offsets(E_l, cosr_l, gsel, z)
    if factored:
        patch, W = E_l["patch"], E_l["W"]
        m2, P = patch.shape[1], W.shape[-1]
        itemsize = patch.dtype.itemsize
    else:
        # dense: E_l[c] is per-class (m2, m2, r, 27r) (fmm.smooth.
        # build_m2l_E_fine) or a slice of a stacked (4, m2, m2, P) array
        # (coarse levels and the numpy host twin)
        E0 = E_l[0]
        m2 = gsel.shape[1]
        P = E0.shape[-1] * (E0.shape[-2] if E0.ndim == 4 else 1)
        itemsize = E0.dtype.itemsize
    ob = gsel.shape[-1]
    r = P // ob

    if not factored:
        # DENSE: one fully-fused exp * cosr * gather multiply-reduce per
        # class over the pair axis -- E is read in place and nothing else
        # is materialized (the output is the (m2, m2, r) locals).  The
        # reduce is an explicit jnp.sum, NOT an einsum: einsum lowers to
        # dot_general, which cannot fuse its elementwise producers.  The
        # multiplies are elementwise f32 and the 27r-term f32 sum matches
        # a dot's f32 accumulator.  z: loop-variant zero keeps exp
        # un-hoisted.
        outs = []
        for c in range(4):
            E4 = E_l[c]
            if E4.ndim == 3:      # stacked coarse / host-twin flat form
                E4 = E4.reshape(m2, m2, r, ob)
            op = jnp.exp(-(E4 + z)) * cosr_l[c].reshape(r, ob) \
                * gsel[c][:, :, None, :]
            outs.append(jnp.sum(op, axis=-1))
        return _interleave_classes(outs, m2, r)

    # FACTORED: re-form E row chunks by matmul, bounded by the transient
    # cap (the re-formed chunk is a fresh temp, so its (rows, m2, r, ob)
    # view needs no argument copy).
    chunk = _row_chunk(m2, P, itemsize, n_shards)

    def one_chunk(c, Eb, gb):
        rows = Eb.shape[0]
        # + z keeps the patch @ W re-form and its exp loop-variant
        # (otherwise LICM hoists the re-formed E -- the very tensor the
        # factored representation exists not to store)
        Eb = jnp.einsum("xyq,qp->xyp", Eb + z, W[c], precision=HIGHEST)
        op = (jnp.exp(-Eb) * cosr_l[c]).reshape(rows, m2, r, ob)
        return jnp.einsum("xyaq,xyq->xya", op, gb, precision=HIGHEST)

    outs = []
    for c in range(4):
        if chunk == m2:
            outs.append(one_chunk(c, patch[c], gsel[c]))
        else:
            nb = m2 // chunk
            # scan over CHUNK INDICES and dynamic-slice the cache inside
            # the body: scanning over a reshaped view of the cache makes
            # XLA materialize it as a scan operand in the loop's layout
            def one_idx(i, c=c):
                Eb = jax.lax.dynamic_slice_in_dim(
                    patch[c], i * chunk, chunk, axis=0
                )
                gb = jax.lax.dynamic_slice_in_dim(
                    gsel[c], i * chunk, chunk, axis=0
                )
                return one_chunk(c, Eb, gb)

            out_c = jax.lax.map(one_idx, jnp.arange(nb))
            outs.append(out_c.reshape(m2, m2, r))
    return _interleave_classes(outs, m2, r)


def _level_E(m2l_E, level, coeffs):
    """Resolve a level's E representation; 'virtual' factored levels
    ({'W'} only) get their coefficient patches re-formed from the field
    (fmm.smooth.patch_for_level) -- pure data movement, traded for not
    storing GB-scale patch tensors; per-offset levels ({'Wo'}) carry the
    coefficient field through to _m2l_translate_offsets."""
    E_l = m2l_E[level]
    if isinstance(E_l, dict) and "Wo" in E_l:
        return {"Wo": E_l["Wo"], "coeffs": coeffs}
    if isinstance(E_l, dict) and "patch" not in E_l:
        from .smooth import patch_for_level

        return {"W": E_l["W"], "patch": patch_for_level(coeffs, level)}
    return E_l


def _m2l_translate_offsets_multi(E_l, cosr_list, gsel, z=0.0):
    """Multi-mode per-offset translation: one E re-form + one exp PER
    CANONICAL BLOCK shared by every Fourier mode (the E cache is
    mode-independent; only the tiny cos(m theta)/r tables differ), so
    the D-mode sweep pays the quadrature once, not D times.  Returns a
    list of (m, m, r) locals, one per entry of cosr_list."""
    return _offsets_translate_impl(E_l, list(cosr_list), gsel, z)


def _m2l_translate_offsets(E_l, cosr_l, gsel, z=0.0):
    return _offsets_translate_impl(E_l, [cosr_l], gsel, z)[0]


def _offsets_translate_impl(E_l, cosr_list, gsel, z=0.0):
    """Fused V-list translation at one fine level in the PER-OFFSET
    virtual representation (fmm.smooth.build_m2l_offsets_fine): each
    canonical (class, offset) E block is re-formed from bounding-box
    windows of the coefficient field -- ~5-6x fewer re-form flops than
    the factored patch @ W (the bbox of one offset is that much smaller
    than the 27-offset union patch) -- and its exp(-E) is reused
    TRANSPOSED for the mirror partner (line-integral symmetry, fmm.
    smooth.coarse_mirror_table), halving quadrature and exp work again.
    Entries whose mirror source falls off the box plane pair with
    zero-padded multipoles in gsel, so restricting the mirror add to the
    on-plane slice is exact (same argument as mirror_fill_coarse).

    Single-device only: the strided box-plane window extraction would
    re-gather a GSPMD-sharded coefficient field (sharded configs keep
    the factored patch form -- see _row_chunk's n_shards note).
    """
    from .smooth import _fine_offset_entries

    coeffs = E_l["coeffs"]
    Wo = E_l["Wo"]
    nq = coeffs.shape[-1]
    m2 = gsel.shape[1]
    ob = gsel.shape[-1]
    r = ob // 27
    np_cheb = int(np.sqrt(r))
    entries, keys, mirrors = _fine_offset_entries(np_cheb)
    B = coeffs.shape[0] // (2 * m2)
    pad = jnp.pad(coeffs, ((3 * B, 4 * B), (3 * B, 4 * B), (0, 0)))
    LX = pad.shape[0] // B
    pb = pad.reshape(LX, B, LX, B, nq)
    g4 = [gsel[c].reshape(m2, m2, 27, r) for c in range(4)]
    D = len(cosr_list)
    cos4 = [
        [cosr_l[c].reshape(r, 27, r) for c in range(4)]
        for cosr_l in cosr_list
    ]
    T = [
        [jnp.zeros((m2, m2, r), dtype=coeffs.dtype) for _ in range(4)]
        for _ in range(D)
    ]
    for (c, o, px, py, di, dj, ki) in entries:
        W = Wo[ki]                          # flat (r*r, bbx*bby*nq)
        bbx = (abs(di) + 1) * B
        bby = (abs(dj) + 1) * B
        ox0, oy0 = min(0, di * B), min(0, dj * B)
        ux = (px * B + ox0 + 3 * B) // B
        uy = (py * B + oy0 + 3 * B) // B
        nbx, nby = bbx // B, bby // B
        rows = jnp.concatenate(
            [pb[ux + s : ux + s + 2 * m2 : 2] for s in range(nbx)], axis=1,
        )                                   # (m2, bbx, LX, B, nq)
        win = jnp.concatenate(
            [rows[:, :, uy + s : uy + s + 2 * m2 : 2] for s in range(nby)],
            axis=3,
        )                                   # (m2, bbx, m2, bby, nq)
        win = jnp.transpose(win, (0, 2, 1, 3, 4)).reshape(m2, m2, -1)
        # + z keeps the whole block loop-variant (no LICM hoist of the
        # re-formed E or its exp inside GMRES loops)
        E = jnp.einsum(
            "xyk,pk->xyp", win + z, W, precision=HIGHEST
        ).reshape(m2, m2, r, r)
        X = jnp.exp(-E)                     # shared: mirror AND all modes
        c2, o2, sx, sy = mirrors[(c, o)]
        xd = slice(max(0, sx), m2 + min(0, sx))
        yd = slice(max(0, sy), m2 + min(0, sy))
        xs = slice(max(0, -sx), m2 + min(0, -sx))
        ys = slice(max(0, -sy), m2 + min(0, -sy))
        XT = jnp.swapaxes(X, 2, 3)[xs, ys]  # exp(-E)(b -> a), shifted
        for d in range(D):
            T[d][c] = T[d][c] + jnp.sum(
                X * cos4[d][c][None, None, :, o, :]
                * g4[c][:, :, None, o, :],
                axis=-1,
            )
            contrib = jnp.sum(
                XT * cos4[d][c2][None, None, :, o2, :]
                * g4[c2][xd, yd][:, :, None, o2, :],
                axis=-1,
            )
            T[d][c2] = T[d][c2].at[xd, yd].add(contrib)
    return [_interleave_classes(T[d], m2, r) for d in range(D)]


def _down_pass(static, leaf_level: int, M, m2l_E, m2l_cosr, coeffs=None,
               n_shards=1, z=0.0, translate_fn=None):
    """M2L + L2L sweep; one fused M2L and one L2L einsum per level.

    translate_fn: optional hand-scheduled override (parallel.halo's
    shard_map + ppermute variant): called (level, E_l, cosr_l, M_l, z)
    and may return None to fall back to the GSPMD path at that level.
    """
    m2m = static["m2m"]
    lo = coarsest_m2l_level()
    L = None
    for level in range(lo, leaf_level + 1):
        T = None
        if translate_fn is not None:
            T = translate_fn(level, _level_E(m2l_E, level, coeffs),
                             m2l_cosr[level], M[level], z)
        if T is None:
            gsel = _vlist_gather(M[level])
            T = _m2l_translate(_level_E(m2l_E, level, coeffs),
                               m2l_cosr[level], gsel, n_shards, z)
        if L is None:
            L = T
        else:
            m2 = L.shape[0]
            r = L.shape[-1]
            Lc = jnp.einsum("hgac,xya->xhygc", m2m, L, precision=HIGHEST)
            L = Lc.reshape(2 * m2, 2 * m2, r) + T
    return L


def _patch_3x3(u: jnp.ndarray) -> jnp.ndarray:
    """(sz, sz, q) -> (q, 3, 3, sz, sz) zero-padded neighbour windows."""
    return patches_3x3(jnp.pad(u, ((1, 1), (1, 1), (0, 0))))


# bound on the materialized near-E temp in the virtual (re-formed)
# representation; beyond it the apply streams row blocks (the unchunked
# f64 form at 512^2 needs a 5.7 GB temp, which XLA may copy again).
_NEAR_VIRTUAL_CHUNK_CAP_BYTES = (
    int(_os_caps.environ.get("ANISO_NEAR_CHUNK_CAP_MB", 256))
    * 1024 * 1024
)


def _near_block_contract(near_E, mode_static, u_patch, z=0.0):
    # + z: loop-variant zero so expm1 of the stored cache is recomputed
    # per apply instead of LICM-hoisted (see _loop_variant_zero)
    block = (
        jnp.expm1(-(near_E + z)) * mode_static["near_cosrw"][..., None, None]
        + mode_static["near_static"][..., None, None]
    )
    return jnp.einsum(
        "abtsij,sabij->ijt", block, u_patch, precision=HIGHEST
    )


def _near_apply_chunked(caches, mode_static, u, rows, virtual, z=0.0):
    """Stream the near field in row blocks of `rows` target rows: each
    block's near-E slice is re-formed from the coefficient field
    (virtual; one halo row each side) or dynamic-sliced from the stored
    tensor, and contracted immediately -- the live temp is
    (3, 3, nq, nq, rows, sz) instead of the full field (765 MB f32 /
    1.5 GB f64 at 512^2, of which XLA kept two copies alive inside the
    GMRES loop).  Index-scan + dynamic_slice keeps the stored cache a
    loop-invariant operand."""
    sz, nq = u.shape[0], u.shape[-1]
    pad_u = jnp.pad(u, ((1, 1), (1, 1), (0, 0)))
    if virtual:
        W = caches["near_W"]          # grid.dx pre-folded at cache build
        pad_c = jnp.pad(caches["coeffs"], ((1, 1), (1, 1), (0, 0)))
    nb = sz // rows

    def one(i):
        i0 = i * rows
        if virtual:
            # the slice carries its own halo: patches via VALID conv
            # (re-padding through _near_E_einsum would zero the halo)
            cb = jax.lax.dynamic_slice_in_dim(pad_c, i0, rows + 2, axis=0)
            cpatch = patches_3x3(cb)     # (q, 3, 3, rows, sz)
            E = jnp.einsum(
                "abtscdq,qcdij->abtsij", W, cpatch, precision=HIGHEST
            )
        else:
            E = jax.lax.dynamic_slice_in_dim(
                caches["near_E"], i0, rows, axis=4
            )
        ub = jax.lax.dynamic_slice_in_dim(pad_u, i0, rows + 2, axis=0)
        up = patches_3x3(ub)
        return _near_block_contract(E, mode_static, up, z)

    out = jax.lax.map(one, jnp.arange(nb))
    return out.reshape(sz, sz, nq)


def _near_apply(caches, mode_static, mode: int, u: jnp.ndarray,
                n_shards: int = 1, z=0.0):
    """U-list near field: fused smooth blocks + static correction stencil.

    block = expm1(-E_near) * cos(m theta)/r * w_src + static stencil; the
    m = 0 self-node diagonal adds sigma_hat * w * u elementwise (reference
    KernelFactory.cpp:260).  near_E is stored (3, 3, nq_t, nq_s, sz, sz)
    (spatial minor-most; see fmm.smooth.build_near_E), or re-formed from
    the coefficient field in the virtual representation (chunked over
    target rows when the temp would exceed the cap).
    """
    sz, nq = u.shape[0], u.shape[-1]
    virtual = "near_E" not in caches
    itemsize = (
        caches["coeffs"] if virtual else caches["near_E"]
    ).dtype.itemsize
    # chunking a GSPMD-sharded axis with dynamic_slice would all-gather
    # the operand; under a mesh the partitioner bounds per-device temps
    # already, so the row streaming is single-device-only (see _row_chunk)
    full_bytes = 9 * nq * nq * sz * sz * itemsize
    rows = sz
    while n_shards == 1 and rows > 8 and full_bytes // (sz // rows) > \
            _NEAR_VIRTUAL_CHUNK_CAP_BYTES:
        rows //= 2
    if rows < sz:
        out = _near_apply_chunked(caches, mode_static, u, rows, virtual, z)
    elif virtual:
        from .smooth import _near_E_einsum

        # near_W carries grid.dx already (solver.operator cache build)
        near_E = _near_E_einsum(caches["near_W"], caches["coeffs"])
        out = _near_block_contract(near_E, mode_static, _patch_3x3(u), z)
    else:
        out = _near_block_contract(
            caches["near_E"], mode_static, _patch_3x3(u), z
        )
    if mode == 0:
        out = out + caches["sigma_w"] * u
    duffy = mode_static.get("duffy")
    if duffy is not None:
        # duffy stored (nq_t, nq_s, sz, sz): spatial dims minor-most
        out = out + jnp.einsum("tsij,ijs->ijt", duffy, u, precision=HIGHEST)
    return out


def fmm_apply_mode(leaf_level, static, caches, mode_static, mode, u,
                   n_shards: int = 1, translate_fn=None, near_fn=None):
    """Corrected mode matvec K_m u including the 1/2pi scaling.

    caches: {'near_E', 'm2l_E', 'sigma_w'[, 'duffy']} from
    solver.operator._build_fmm_caches (sigma-dependent, mode-independent);
    mode_static: per-mode static tables from build_mode_static.
    n_shards: mesh device count when the caches/field are sharded (the
    transient-cap chunking then applies per shard, see _row_chunk).
    translate_fn / near_fn: optional hand-scheduled shard_map + ppermute
    overrides (parallel.halo, wired by parallel.api.sharded_solver with
    halo='shardmap'); either may return None to fall back to GSPMD.
    (The reference's six-pass corrected matvec, main.cpp:78-119, collapsed
    into one up sweep, one fused translation per level, and one U-list
    contraction.)
    """
    z = _loop_variant_zero(u)
    M = _up_pass(static, leaf_level, u)
    L = _down_pass(
        static, leaf_level, M, caches["m2l_E"], mode_static["m2l_cosr"],
        coeffs=caches.get("coeffs"), n_shards=n_shards, z=z,
        translate_fn=translate_fn,
    )
    far = jnp.einsum("kc,ijc->ijk", static["l2t"], L, precision=HIGHEST)
    near = near_fn(caches, mode_static, mode, u, z) if near_fn else None
    if near is None:
        near = _near_apply(caches, mode_static, mode, u, n_shards, z)
    return (far + near) / (2.0 * jnp.pi)


def fmm_apply_all_modes(leaf_level, static, caches, mode_statics, u,
                        n_shards: int = 1):
    """K_d u for every mode d at once, sharing the up sweep and V-list
    gathers across modes: returns a LIST of D (sz, sz, nq) fields.

    This is the building block of the one-program multi-mode forward
    (aniso.m:121-156 issues a separate MEX `mapping` crossing per (i, j)
    pair; here all modes of one charge ride one compiled sweep).

    The per-mode locals are carried as a python list, never stacked into
    one (D, m, m, r) array: a stacked carry keeps every mode's locals
    live through every level (and its dynamic-update-slice makes a
    full-size temp).  As a list, each mode's L2L/add chain schedules
    independently.
    """
    z = _loop_variant_zero(u)
    M = _up_pass(static, leaf_level, u)
    lo = coarsest_m2l_level()
    m2m = static["m2m"]
    L = None
    for level in range(lo, leaf_level + 1):
        gsel = _vlist_gather(M[level])
        E_l = _level_E(caches["m2l_E"], level, caches.get("coeffs"))
        if isinstance(E_l, dict) and "Wo" in E_l:
            # per-offset levels: ONE E re-form + exp shared by all modes
            T = _m2l_translate_offsets_multi(
                E_l, [ms["m2l_cosr"][level] for ms in mode_statics],
                gsel, z,
            )
        else:
            T = [
                _m2l_translate(E_l, ms["m2l_cosr"][level], gsel,
                               n_shards, z)
                for ms in mode_statics
            ]
        if L is None:
            L = T
        else:
            m = L[0].shape[0]
            r = L[0].shape[-1]
            L = [
                jnp.einsum(
                    "hgac,xya->xhygc", m2m, Ld, precision=HIGHEST
                ).reshape(2 * m, 2 * m, r) + Td
                for Ld, Td in zip(L, T)
            ]
    return [
        (
            jnp.einsum("kc,ijc->ijk", static["l2t"], Ld, precision=HIGHEST)
            + _near_apply(caches, ms, d, u, n_shards, z)
        ) / (2.0 * jnp.pi)
        for d, (ms, Ld) in enumerate(zip(mode_statics, L))
    ]
