"""Distributed tall-skinny QR (TSQR) with a tree-reduction combine.

The factorization workhorse replacing LAPACK ``geqrf`` inside the
reference's ``np.linalg.svd`` call (/root/reference/src/dmd_era5/era5_svd/
era5_svd.py:251).  The snapshot matrix is row-sharded over the ``space``
mesh axis; each shard factors its local block, and the small R factors
combine in a **butterfly ladder** (``ppermute`` exchanges with
partner ``idx XOR 2^level``, log2 P rounds of pairwise stack-and-QR).

Communication and compute per device:

- tree combine:  <= ceil(log2 P) + 1 rounds x rk*T floats moved, each
  round factoring one (2rk, T) stack — O(log P * T^2) comm,
  O(log P * T^3) redundant flops, for ANY P.  A power-of-two P is the
  pure butterfly; otherwise the rem = P - 2^floor(log2 P) highest
  shards fold their R into a low partner in ONE pre-exchange, the
  butterfly runs over the 2^floor(log2 P) low shards, and one packed
  post-exchange returns the folded shards' chain block and the final R
  (R is row-permutation invariant, so the fold order is immaterial).
  Every device in a merge group computes the *same* stacked matrix
  (lower index always on top), so R ends bit-identical everywhere with
  no broadcast.

The global Q is recovered shard-locally: each round contributes a small
(rk, rk') block of the merge Q, accumulated as a *chain product* kept
separate from the tall leaf Q1 so (a) the tall (m_loc, rk) GEMM happens
exactly once at the end, and (b) the chain update of round s is
independent of round s+1's ppermute — XLA overlaps the small GEMM with
the in-flight exchange (SURVEY.md section 7, hard part d).

Deterministic sign convention: every QR is normalized so diag(R) >= 0.
The global reduced QR of a full-column-rank matrix is unique under that
convention, so tree and flat combines agree to roundoff and results are
reproducible across mesh shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from dmd_era5_tpu.parallel.mesh import AXIS_SPACE

__all__ = [
    "qr_positive",
    "tsqr",
    "tsqr_orthonormalize",
    "default_qr_method",
]

HIGHEST = lax.Precision.HIGHEST


def qr_positive(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reduced QR with the diag(R) >= 0 sign convention."""
    q, r = jnp.linalg.qr(x, mode="reduced")
    signs = jnp.sign(jnp.diagonal(r))
    signs = jnp.where(signs == 0, 1.0, signs).astype(r.dtype)
    return q * signs[None, :], r * signs[:, None]


def _local_factor(x: jnp.ndarray, method: str):
    """Local tall-skinny factorization for the TSQR leaves.

    "householder" is XLA's QR (cuSOLVER ``geqrf`` on the GPU, LAPACK on
    the CPU): backward stable at any conditioning.  "cholqr2" is the
    Gram route (ops.qr_panel): two Gram GEMMs, a k x k Cholesky and two
    whitening GEMMs; "cholqr2_split" takes its Gram products in the
    bf16 hi/lo split.  The CholQR leaves need cond(x) < ~1e4.
    """
    if method == "householder":
        return qr_positive(x)
    if method == "cholqr2":
        from dmd_era5_tpu.ops.qr_panel import cholqr2

        return cholqr2(x)
    if method == "cholqr2_split":
        from dmd_era5_tpu.ops.qr_panel import cholqr2_split

        return cholqr2_split(x)
    raise ValueError(
        f"qr_method must be householder/cholqr2/cholqr2_split, got {method!r}"
    )


def default_qr_method() -> str:
    """The TSQR leaf every backend uses unless a caller names one.

    Householder (cuSOLVER ``geqrf`` on the GPU): exact for any panel,
    including local blocks shorter than they are wide and rank-deficient
    sketches, where the CholQR leaves break.  On an H100 (700 W) CholQR2
    factors a tall 3,893,400 x 168 f32 panel in 27.4 ms against 149.9 ms
    (scripts/plain_kernel_times.py); a shape/conditioning guard that
    would let it take the tall well-conditioned panels is ROADMAP work.
    """
    return "householder"


def _combine_tree(r1: jnp.ndarray, axis_name: str, p: int):
    """Tree R combine for ANY p: fold + butterfly + packed return.

    Returns (chain, R): ``chain`` (rk0, rk_final) maps the leaf Q1 onto
    the global Q rows (Q_local = Q1 @ chain); ``R`` (rk_final, T) is
    identical on every shard.  Exchange count: log2(p) ppermutes for a
    power-of-two p, ceil(log2 p) + 1 otherwise (one fold down, one
    packed result back up) — never the O(P) all-gather of a flat
    combine.

    Non-power-of-two handling: with q = 2^floor(log2 p) and
    rem = p - q > 0, shard q+j folds its R into shard j (one QR of the
    pair stack on the low shard, which stashes the high shard's Q2
    block); low shards rem..q-1 'merge with a phantom zero block'
    (exactly: R pads with zero rows, chain with an [I 0] block — those
    rows never existed, and a full-column-rank stack puts no Q mass on
    zero rows, SURVEY.md section 7 hard part a).  The butterfly then
    runs over the q low shards, and one packed ppermute returns
    (stashed block @ butterfly chain, R) to each folded shard.  R is
    invariant to row permutations of the global stack (G = X^T X fixes
    R under the diag >= 0 convention), so folding order is immaterial.
    """
    idx = lax.axis_index(axis_name)
    t_cols = r1.shape[1]
    q_pow = 1 << (p.bit_length() - 1)  # largest power of two <= p
    rem = p - q_pow

    r = r1
    chain_pre = None
    stash = None
    if rem:
        rk = r.shape[0]
        rk_next = min(2 * rk, t_cols)
        perm = [(q_pow + j, j) for j in range(rem)]
        r_other = lax.ppermute(r, axis_name, perm)  # zeros if no source
        q2, r_merge = qr_positive(jnp.concatenate([r, r_other], axis=0))
        eye_pad = jnp.concatenate(
            [
                jnp.eye(rk, dtype=r.dtype),
                jnp.zeros((rk, rk_next - rk), r.dtype),
            ],
            axis=1,
        )
        r_pad = jnp.concatenate(
            [r, jnp.zeros((rk_next - rk, t_cols), r.dtype)], axis=0
        )
        folded = idx < rem
        chain_pre = jnp.where(folded, q2[:rk, :rk_next], eye_pad)
        stash = q2[rk : 2 * rk, :rk_next]  # the folded shard's block
        r = jnp.where(folded, r_merge, r_pad)

    chain_bfly = None
    stage = 1
    while stage < q_pow:
        rk = r.shape[0]
        rk_next = min(2 * rk, t_cols)
        perm = [(i, i ^ stage) for i in range(q_pow)]
        r_other = lax.ppermute(r, axis_name, perm)
        am_low = (idx & stage) == 0
        # lower index always on top -> every member of a merge group
        # factors the identical stack, so R stays replicated for free
        top = jnp.where(am_low, r, r_other)
        bot = jnp.where(am_low, r_other, r)
        q2, r = qr_positive(jnp.concatenate([top, bot], axis=0))
        my_block = jnp.where(
            am_low, q2[:rk, :rk_next], q2[rk : 2 * rk, :rk_next]
        )
        # chain product stays (rk0, .)-small; independent of the next
        # round's ppermute, so it overlaps with the in-flight exchange
        chain_bfly = (
            my_block
            if chain_bfly is None
            else jnp.matmul(chain_bfly, my_block, precision=HIGHEST)
        )
        stage *= 2

    if chain_pre is None:
        chain = chain_bfly
    elif chain_bfly is None:
        chain = chain_pre
    else:
        chain = jnp.matmul(chain_pre, chain_bfly, precision=HIGHEST)

    if rem:
        # pack (folded shard's chain, R) into one buffer -> one exchange
        rk0 = r1.shape[0]
        rk_f = r.shape[0]
        m_up = stash if chain_bfly is None else jnp.matmul(
            stash, chain_bfly, precision=HIGHEST
        )  # (rk0, rk_f)
        m_pad = jnp.concatenate(
            [m_up, jnp.zeros((rk_f - rk0, rk_f), m_up.dtype)], axis=0
        )
        payload = jnp.concatenate([m_pad, r], axis=1)  # (rk_f, rk_f + T)
        perm_up = [(j, q_pow + j) for j in range(rem)]
        received = lax.ppermute(payload, axis_name, perm_up)
        is_folded_src = idx >= q_pow
        chain = jnp.where(is_folded_src, received[:rk0, :rk_f], chain)
        r = jnp.where(is_folded_src, received[:, rk_f:], r)
    return chain, r


def _combine(r1: jnp.ndarray, axis_name: str):
    p = lax.axis_size(axis_name)
    if p == 1:
        # nothing to combine: chain is the identity on the leaf rank
        return jnp.eye(r1.shape[0], dtype=r1.dtype), r1
    return _combine_tree(r1, axis_name, p)


def _tsqr_body(x_block: jnp.ndarray, axis_name: str, method: str = "householder"):
    q1, r1 = _local_factor(x_block, method)  # (m_loc, rk), (rk, T)
    chain, r = _combine(r1, axis_name)
    q = jnp.matmul(q1, chain, precision=HIGHEST)
    return q, r


def tsqr_orthonormalize(
    y_block: jnp.ndarray, axis_name: str, method: str
) -> jnp.ndarray:
    """Orthonormalize a row-sharded tall-skinny matrix, Q only.

    The re-orthonormalization primitive of the randomized-SVD power
    iterations: local factor -> tree-reduced R combine -> shard-local
    Q recovery.  For use inside ``shard_map`` bodies.
    """
    q1, r1 = _local_factor(y_block, method)
    chain, _ = _combine(r1, axis_name)
    return jnp.matmul(q1, chain, precision=HIGHEST)


def tsqr(
    x: jax.Array,
    mesh: Mesh | None = None,
    axis_name: str = AXIS_SPACE,
    method: str | None = None,
):
    """QR of a row-sharded tall-skinny matrix.

    Args:
        x: (S, T) matrix, row-sharded over ``axis_name`` when a mesh is
           given (S need not be divisible; the caller pads via
           ``parallel.shard_rows``).
        mesh: device mesh; None (or a size-1 axis) means single-device.

    Returns:
        (Q, R): Q (S, rk) sharded like x, R (rk, T) replicated, with
        rk = min(S_local, T) * ... == min(S, T) when every local block is
        at least as tall as it is wide (the tall-skinny regime).
    """
    method = method or default_qr_method()
    if mesh is None or mesh.shape.get(axis_name, 1) == 1:
        return _local_factor(x, method)

    body = partial(_tsqr_body, axis_name=axis_name, method=method)
    # check_vma=False: R is replicated by construction (every merge
    # group factors the identical stack), but the static varying-axes
    # analysis cannot prove that.
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(axis_name, None),
        out_specs=(P(axis_name, None), P(None, None)),
        check_vma=False,
    )(x)
