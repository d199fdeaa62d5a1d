"""Device-resident restarted GMRES with Givens rotations.

Reference semantics: gmres.cpp:53-169 (restarted GMRES(m), modified
Gram-Schmidt, Givens rotations, relative residual |Ax-b|/|b|).  Differences
here:

  * the whole solve lives in one `lax.while_loop` under jit -- no host
    round-trips between iterations (the reference prints per iteration);
  * orthogonalization is CGS2 (two-pass classical Gram-Schmidt): two batched
    (m+1, n) @ (n,) GEMVs instead of the reference's sequential
    ddot/daxpy chain (gmres.cpp:116-119); numerically as robust as MGS and
    collective-friendly when the basis is sharded (two psums per iteration
    instead of 2(i+1));
  * static shapes: the Krylov basis is a fixed (m+1, *field) buffer, updated
    with dynamic_update_slice;
  * the iterate keeps its NATURAL field shape throughout -- no reshape(-1).
    Flattening a GSPMD-sharded (sz, sz, nq) field merges the sharded dims
    and forces volume all-gathers in every basis update (144 all-gathers x
    8.6 MB/shard per 256^2 sharded solve on the virtual CPU mesh); in
    natural shape the basis shards with the field and each CGS2 pass is a
    per-shard contraction + an (m+1)-scalar psum.

An optional *left* preconditioner supports the DSA analogue: MATLAB's
gmres(A, b, ..., M) solves inv(M) A x = inv(M) b, which is how the reference
applies its FEM diffusion solve (aniso.m:111-119, :165).  `precond` is the
action of inv(M); the reported residual is the preconditioned one, as in
MATLAB.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

# true f32 products for the Arnoldi GEMVs: with reduced-precision products
# (TF32 on an NVIDIA GPU) the basis loses orthogonality at ~1e-3 and the
# computed solution is wrong while the Givens estimate still "converges"
HIGHEST = lax.Precision.HIGHEST


def _dots(V, w):
    """(m+1, *field) x (*field) -> (m+1,) batched inner products."""
    nd = w.ndim
    return jnp.tensordot(
        V, w, axes=(tuple(range(1, nd + 1)), tuple(range(nd))),
        precision=HIGHEST,
    )


def _comb(V, h):
    """(m+1,) coefficients against the basis -> (*field)."""
    return jnp.tensordot(h, V, axes=((0,), (0,)), precision=HIGHEST)


class GmresResult(NamedTuple):
    x: jnp.ndarray
    residual: jnp.ndarray      # final relative residual estimate
    iterations: jnp.ndarray    # total matvec count (inner iterations)
    converged: jnp.ndarray     # bool


def _givens(dx, dy):
    """Generate a plane rotation (gmres.cpp:26-39)."""
    def dy_zero(_):
        return jnp.ones_like(dx), jnp.zeros_like(dx)

    def dy_big(_):
        t = dx / dy
        sn = 1.0 / jnp.sqrt(1.0 + t * t)
        return t * sn, sn

    def dx_big(_):
        t = dy / dx
        cs = 1.0 / jnp.sqrt(1.0 + t * t)
        return cs, t * cs

    return lax.cond(
        dy == 0.0,
        dy_zero,
        lambda _: lax.cond(jnp.abs(dy) > jnp.abs(dx), dy_big, dx_big, None),
        None,
    )


def gmres(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    restart: int = 80,
    max_iter: int = 400,
    tol: float = 1e-12,
    precond: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
) -> GmresResult:
    """Solve A x = b.  b/x may be any pytree-free ndarray shape (flattened).

    max_iter counts inner iterations (matvecs), as in the reference where
    `j` increments per Arnoldi step (gmres.cpp:106).
    """
    shape = b.shape
    dtype = b.dtype
    m = restart

    if x0 is None:
        x0 = jnp.zeros_like(b)
    else:
        x0 = x0.reshape(shape)

    def A(v):
        out = matvec(v)
        if precond is not None:
            out = precond(out)
        return out.reshape(shape)

    if precond is not None:
        b = precond(b).reshape(shape)

    normb = jnp.linalg.norm(b)
    normb = jnp.where(normb == 0.0, 1.0, normb)

    r0 = b - A(x0)
    beta0 = jnp.linalg.norm(r0)

    class Carry(NamedTuple):
        x: jnp.ndarray
        r: jnp.ndarray
        beta: jnp.ndarray
        j: jnp.ndarray
        resid: jnp.ndarray
        done: jnp.ndarray

    # Hessenberg/rotation bookkeeping in f64 (tiny (m+1) x m arrays; with
    # x64 disabled this canonicalizes back to f32 and changes nothing).
    # Over m = 80 Givens steps the f32 recurrence drifts the residual
    # ESTIMATE by ~1e-5 relative; f64 keeps the estimate honest while the
    # Krylov basis and matvecs stay in operand dtype.
    hdtype = jax.dtypes.canonicalize_dtype(jnp.float64)

    def inner_cycle(x, r, beta, j_start):
        """One restart cycle; returns updated x, r, beta, j, resid, done."""
        V = jnp.zeros((m + 1,) + shape, dtype=dtype)
        V = V.at[0].set(r / beta)
        H = jnp.zeros((m + 1, m), dtype=hdtype)
        s = jnp.zeros((m + 1,), dtype=hdtype).at[0].set(
            beta.astype(hdtype)
        )
        cs = jnp.zeros((m,), dtype=hdtype)
        sn = jnp.zeros((m,), dtype=hdtype)

        def cond(st):
            i, j, _, _, _, _, _, done = st
            return (i < m) & (j <= max_iter) & (~done)

        def body(st):
            i, j, V, H, s, cs, sn, done = st
            w = A(V[i])
            # CGS2: mask rows > i
            mask = (jnp.arange(m + 1) <= i).astype(dtype)
            h1 = _dots(V, w) * mask
            w = w - _comb(V, h1)
            h2 = _dots(V, w) * mask
            w = w - _comb(V, h2)
            h = h1 + h2
            wnorm = jnp.linalg.norm(w)
            V = V.at[i + 1].set(w / jnp.where(wnorm == 0.0, 1.0, wnorm))
            col = h.astype(hdtype).at[i + 1].set(wnorm.astype(hdtype))

            # apply previous rotations to the new column -- O(i) work per
            # step (a traced upper bound lowers to while_loop, fine here)
            def rot_body(k, colv):
                t = cs[k] * colv[k] + sn[k] * colv[k + 1]
                upd = -sn[k] * colv[k] + cs[k] * colv[k + 1]
                return colv.at[k].set(t).at[k + 1].set(upd)

            col = lax.fori_loop(0, i, rot_body, col)

            c_new, s_new = _givens(col[i], col[i + 1])
            cs = cs.at[i].set(c_new)
            sn = sn.at[i].set(s_new)
            col = col.at[i].set(c_new * col[i] + s_new * col[i + 1])
            col = col.at[i + 1].set(0.0)
            s_i = c_new * s[i] + s_new * s[i + 1]
            s_i1 = -s_new * s[i] + c_new * s[i + 1]
            s = s.at[i].set(s_i).at[i + 1].set(s_i1)
            H = H.at[:, i].set(col)

            resid = jnp.abs(s_i1) / normb
            done = resid < tol
            return (i + 1, j + 1, V, H, s, cs, sn, done)

        i0 = jnp.array(0, jnp.int32)
        st = (i0, j_start, V, H, s, cs, sn, jnp.array(False))
        i, j, V, H, s, cs, sn, done = lax.while_loop(cond, body, st)

        # back-substitution on the leading i x i block (gmres.cpp:12-24)
        k = i  # number of columns built
        idx = jnp.arange(m)
        Hm = H[:m, :]
        diag_mask = idx < k
        Hm = jnp.where(
            (idx[:, None] == idx[None, :]) & (~diag_mask)[None, :],
            1.0,
            Hm,
        )
        # zero strictly-upper entries in unused columns to keep solve stable
        Hm = jnp.where(diag_mask[None, :] | (idx[:, None] == idx[None, :]), Hm, 0.0)
        rhs = jnp.where(diag_mask, s[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Hm, rhs, lower=False)
        x_new = x + _comb(V[:m], y.astype(dtype))

        r_new = b - A(x_new)
        beta_new = jnp.linalg.norm(r_new)
        resid = jnp.where(done, jnp.abs(s[k]) / normb, beta_new / normb)
        done = resid < tol
        return x_new, r_new, beta_new, j, resid, done

    def outer_cond(c: Carry):
        return (c.j <= max_iter) & (~c.done)

    def outer_body(c: Carry):
        x, r, beta, j, resid, done = inner_cycle(c.x, c.r, c.beta, c.j)
        return Carry(x, r, beta, j, resid, done)

    init = Carry(
        x=x0,
        r=r0,
        beta=beta0,
        j=jnp.array(1, jnp.int32),
        resid=(beta0 / normb).astype(hdtype),
        done=beta0 / normb <= tol,
    )
    out = lax.while_loop(outer_cond, outer_body, init)
    return GmresResult(
        x=out.x.reshape(shape),
        residual=out.resid,
        iterations=out.j - 1,
        converged=out.done,
    )
