"""Plane-layout (SoA) linear algebra for tiny matrices.

Storing batched tiny matrices as ``[..., D, D]`` puts D (= 1..3) in the
innermost axis, so every op works on a tiny trailing dimension and every
slice/stack is a relayout copy.  The framework therefore stores all
per-landmark quantities as **component planes**: a mean is ``[D, P, M]``
(leading static component axis, full ``[P, M]`` planes behind it) and a
symmetric matrix is its packed upper triangle ``[T, P, M]`` with
``T = D (D + 1) / 2``.  This module provides the closed-form linear algebra
over such planes (inverse, determinant, quadratic form, matrix products) as
python-unrolled elementwise programs that XLA fuses into the surrounding
computation.

The dense <-> planar converters are for boundaries only (IO, tests, the
object-style API); nothing in a filter hot loop should call them.

Equivalent reference functionality: RandomVec's cached covariance
inverse/determinant/Cholesky (reference: RandomVec.hpp:297-328) — here the
"cache" is XLA common-subexpression elimination across the fused program.

Packing order is row-major over the upper triangle:
D=2 -> [(0,0), (0,1), (1,1)]; D=3 -> [(0,0), (0,1), (0,2), (1,1), (1,2), (2,2)].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tri_size(d: int) -> int:
    return d * (d + 1) // 2


def tri_index(i: int, j: int, d: int) -> int:
    """Index of (i, j) in the packed upper triangle (order-insensitive)."""
    if i > j:
        i, j = j, i
    return i * d - i * (i - 1) // 2 + (j - i)


def sym_rows(s, d: int):
    """Packed planes ``s[T, ...]`` -> nested list ``rows[i][j]`` of planes."""
    return [[s[tri_index(i, j, d)] for j in range(d)] for i in range(d)]


def from_rows_sym(rows):
    """Nested list (symmetric; upper triangle read) -> packed ``[T, ...]``."""
    d = len(rows)
    return jnp.stack(
        [rows[i][j] for i in range(d) for j in range(i, d)], axis=0
    )


def pack_sym(S: jax.Array) -> jax.Array:
    """Dense ``[..., D, D]`` -> packed ``[T, ...]`` (boundary use only)."""
    d = S.shape[-1]
    return jnp.stack(
        [S[..., i, j] for i in range(d) for j in range(i, d)], axis=0
    )


def unpack_sym(s: jax.Array, d: int) -> jax.Array:
    """Packed ``[T, ...]`` -> dense ``[..., D, D]`` (boundary use only)."""
    rows = sym_rows(s, d)
    return jnp.stack(
        [jnp.stack([rows[i][j] for j in range(d)], axis=-1) for i in range(d)],
        axis=-2,
    )


def pack_vec(v: jax.Array) -> jax.Array:
    """Dense ``[..., D]`` -> planes ``[D, ...]`` (boundary use only)."""
    return jnp.moveaxis(v, -1, 0)


def unpack_vec(p: jax.Array) -> jax.Array:
    """Planes ``[D, ...]`` -> dense ``[..., D]`` (boundary use only)."""
    return jnp.moveaxis(p, 0, -1)


# --------------------------------------------------------------------- algebra
def det_sym(s, d: int):
    """Determinant of a packed symmetric ``[T, ...]``, D in 1..3."""
    m = sym_rows(s, d)
    if d == 1:
        return m[0][0]
    if d == 2:
        return m[0][0] * m[1][1] - m[0][1] * m[0][1]
    if d == 3:
        return (
            m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[1][2])
            - m[0][1] * (m[0][1] * m[2][2] - m[1][2] * m[0][2])
            + m[0][2] * (m[0][1] * m[1][2] - m[1][1] * m[0][2])
        )
    raise NotImplementedError(f"det_sym: D={d}")


def inv_sym(s, d: int):
    """Inverse of a packed symmetric ``[T, ...]`` via the adjugate, D in 1..3."""
    m = sym_rows(s, d)
    dt = det_sym(s, d)
    if d == 1:
        return jnp.stack([1.0 / m[0][0]])
    if d == 2:
        return jnp.stack([m[1][1] / dt, -m[0][1] / dt, m[0][0] / dt])
    if d == 3:
        c00 = m[1][1] * m[2][2] - m[1][2] * m[1][2]
        c01 = m[0][2] * m[1][2] - m[0][1] * m[2][2]
        c02 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
        c11 = m[0][0] * m[2][2] - m[0][2] * m[0][2]
        c12 = m[0][2] * m[0][1] - m[0][0] * m[1][2]
        c22 = m[0][0] * m[1][1] - m[0][1] * m[0][1]
        return jnp.stack([c00 / dt, c01 / dt, c02 / dt,
                          c11 / dt, c12 / dt, c22 / dt])
    raise NotImplementedError(f"inv_sym: D={d}")


def sym_vec(s, v, d: int):
    """(packed symmetric) @ (vector planes ``[D, ...]``) -> ``[D, ...]``."""
    m = sym_rows(s, d)
    return jnp.stack(
        [sum(m[i][j] * v[j] for j in range(d)) for i in range(d)]
    )


def quad_sym(s, v, d: int):
    """v^T S v for packed symmetric S and vector planes v, fully fused."""
    m = sym_rows(s, d)
    out = 0.0
    for i in range(d):
        out = out + m[i][i] * v[i] * v[i]
        for j in range(i + 1, d):
            out = out + 2.0 * m[i][j] * v[i] * v[j]
    return out


def mat_from_rows(rows):
    """Nested list of planes -> general matrix ``[R*C, ...]`` row-major."""
    return jnp.stack([p for row in rows for p in row], axis=0)


def mat_rows(a, r: int, c: int):
    """General matrix planes ``[R*C, ...]`` -> nested list rows[i][j]."""
    return [[a[i * c + j] for j in range(c)] for i in range(r)]


def matmul(A, B):
    """Row-list x row-list matrix product -> row-list."""
    r, k = len(A), len(A[0])
    c = len(B[0])
    return [
        [sum(A[i][t] * B[t][j] for t in range(k)) for j in range(c)]
        for i in range(r)
    ]


def transpose_rows(A):
    return [[A[i][j] for i in range(len(A))] for j in range(len(A[0]))]


def sandwich_sym(H, s, d_in: int, R=None):
    """H S H^T (+ R) for row-list H (rows x d_in) and packed symmetric s.

    Returns the packed upper triangle of the (rows x rows) result.  This is
    the innovation-covariance form S = H Sigma H^T + R
    (reference: MeasurementModel_RngBrg.cpp:96-103).
    """
    Sm = sym_rows(s, d_in)
    HS = matmul(H, Sm)                   # rows x d_in
    r = len(H)
    out = []
    for i in range(r):
        for j in range(i, r):
            v = sum(HS[i][t] * H[j][t] for t in range(d_in))
            if R is not None:
                v = v + R[i][j]
            out.append(v)
    return jnp.stack(out, axis=0)


def onehot(idx: jax.Array, m: int, dtype=jnp.float32) -> jax.Array:
    """One-hot of ``idx`` over size ``m``: ``[..., K] -> [..., K, m]``.

    Used for gathers and scatters along the minor (landmark) axis as a
    one-hot multiply-reduce, which is exact (each row has exactly one 1.0,
    so products/sums introduce no rounding) and fuses with its neighbours.
    """
    return (idx[..., None] == jnp.arange(m, dtype=idx.dtype)).astype(dtype)


def take_lane(a: jax.Array, oh: jax.Array) -> jax.Array:
    """Gather along the last axis with a precomputed one-hot.

    ``a``: [..., M] with batch dims broadcast-compatible against
    ``oh``: [..., K, M].  Returns [..., K].

    INVARIANT: ``a`` must be finite in EVERY lane (including dead/padded
    slots) — the multiply-reduce makes NaN * 0 = NaN poison all gathered
    values.  Producers of plane data scrub non-finite entries at the source
    (see :func:`rfs_slam_tpu.ops.ekf.correct_all`).
    """
    return jnp.sum(a[..., None, :] * oh, axis=-1)


def put_lane(dst: jax.Array, idx: jax.Array, src: jax.Array,
             valid: jax.Array | None = None) -> jax.Array:
    """Scatter along the last axis via one-hot multiply-reduce.

    ``dst``: [..., M]; ``idx``: [..., K] slot index per entry (an index == M
    or an entry with ``valid`` False is dropped); ``src``: [..., K] values.
    Entries of one row MUST target distinct slots.

    Equivalent to ``dst.at[..., idx].set(src)`` bit for bit (the product
    runs at full float32 precision), written as a one-hot reduce so that
    per-row indices under vmap/batching need no batched scatter.
    """
    m = dst.shape[-1]
    oh = (idx[..., None] == jnp.arange(m, dtype=idx.dtype)).astype(dst.dtype)
    if valid is not None:
        oh = oh * valid[..., None].astype(dst.dtype)
    hit = jnp.sum(oh, axis=-2)                       # [..., M]
    # full f32 precision: a TF32 product would round every value it puts
    put = jnp.einsum("...km,...k->...m", oh, src,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.where(hit > 0.5, put, dst)            # inf-safe vs dst*(1-hit)


def chol_sym(s, d: int):
    """Lower Cholesky factor (row-list) of packed symmetric, D in 1..3."""
    m = sym_rows(s, d)
    if d == 1:
        return [[jnp.sqrt(m[0][0])]]
    if d == 2:
        l00 = jnp.sqrt(m[0][0])
        l10 = m[0][1] / l00
        l11 = jnp.sqrt(jnp.maximum(m[1][1] - l10 * l10, 0.0))
        z = jnp.zeros_like(l00)
        return [[l00, z], [l10, l11]]
    if d == 3:
        l00 = jnp.sqrt(m[0][0])
        l10 = m[0][1] / l00
        l20 = m[0][2] / l00
        l11 = jnp.sqrt(jnp.maximum(m[1][1] - l10 * l10, 0.0))
        l21 = (m[1][2] - l20 * l10) / l11
        l22 = jnp.sqrt(jnp.maximum(m[2][2] - l20 * l20 - l21 * l21, 0.0))
        z = jnp.zeros_like(l00)
        return [[l00, z, z], [l10, l11, z], [l20, l21, l22]]
    raise NotImplementedError(f"chol_sym: D={d}")
