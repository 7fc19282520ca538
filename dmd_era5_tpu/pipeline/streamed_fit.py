"""Out-of-core decomposition: stream a packed snapshot file through the
randomized SVD without ever holding X in device memory.

The pipeline-parallel ingest mandated by SURVEY.md section 2b ("PP:
stage pipeline ... with double-buffered snapshot blocks"): row blocks of
the packed artifact stream disk -> host -> device on a prefetch thread
while the device runs the current block's GEMM.

Pass schedule (n_iter + 2 disk passes total):
  passes 1..n_iter:  Z <- X^T (X Z) fused per block visit (Z_0 = Omega;
                     Z re-orthonormalized between passes, T x r QR)
  pass n_iter + 1:   Gy += y^T y, P += y^T X per block (y = X_blk Z) —
                     the range basis Q = Y W^T stays IMPLICIT through
                     the r x r whitener W = gram_whiten(Gy), so B =
                     Q^T X = W P needs no resident Y and no extra pass
  pass n_iter + 2:   U_blk = X_blk (Z W^T Ub), streamed back to HOST.

Device residency is O(one block + r x T factors) — never an S-sized
array, in any pass.  (An earlier design materialized Y, Q1, Q2 on
device: three S x r f32 arrays, 21 GB at the 0.25-degree-ERA5-week
shape — OOM in exactly the regime the backend exists for.)
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from dmd_era5_tpu.core.logging import log_and_print, setup_logger
from dmd_era5_tpu.ops.svd import SVDResult, sklearn_n_iter
from dmd_era5_tpu.ops.tsqr import _local_factor
from dmd_era5_tpu.utils.linalg import gram_whiten
from dmd_era5_tpu.snapmat.loader import packed_info, read_packed_rows

logger = setup_logger("StreamedFit", "streamed_fit.log")

__all__ = [
    "streamed_randomized_svd",
    "streamed_exact_gram_svd",
    "streamed_onepass_svd",
    "prefetched_row_blocks",
]


def prefetched_row_blocks(
    path: str | Path,
    n_rows: int,
    block_rows: int,
    depth: int = 2,
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (row_start, block) with a background prefetch thread.

    The reader thread stays ``depth`` blocks ahead of the consumer, so
    disk IO overlaps host->device transfer and device compute
    (double-buffering with depth=2).
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def reader():
        try:
            for r0 in range(0, n_rows, block_rows):
                r1 = min(r0 + block_rows, n_rows)
                q.put((r0, read_packed_rows(path, r0, r1)))
        finally:
            q.put(stop)

    thread = threading.Thread(target=reader, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is stop:
            break
        yield item
    thread.join()


def streamed_randomized_svd(
    path: str | Path,
    n_components: int,
    block_rows: int = 1 << 16,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int = 0,
    device=None,
    qr_method: str | None = None,
    block_dtype=None,
    u_dtype: str | None = "auto",
    u_out=None,
    col_limit: int | None = None,
) -> SVDResult:
    """Randomized truncated SVD of a packed snapshot artifact, streamed.

    Power iterations are FUSED: one streamed pass computes
    Y_blk = X_blk @ Z and accumulates Z_next += X_blk^T Y_blk in the
    same block visit — i.e. Z_next = (X^T X) Z from a single disk read,
    with Z re-orthonormalized between passes (a T x r Householder QR,
    free next to the stream).  Total disk passes: **n_iter + 2** —
    pass 1 seeds Z from the Gaussian sketch, passes 2..n_iter iterate,
    pass n_iter+1 accumulates the r-sized range factors (Gy, Y^T X),
    and pass n_iter+2 streams U = X (Z W^T Ub) back to HOST.  (The
    unfused schedule re-read the file twice per iteration: 2 n_iter +
    2 passes.)  U returns as a host numpy array.

    ``block_dtype``: on-device dtype of the streamed blocks.  Default
    keeps the file's dtype — a bf16-packed artifact (the packer's
    native output) streams bf16, halving host->device and HBM traffic;
    every GEMM accumulates fp32 regardless.

    ``u_dtype``: wire dtype of the U stream-back (pass n_iter + 2).
    The default ``"auto"`` returns U as bf16 over the wire when the
    packed file itself is bf16 — the decomposition's precision is
    already bounded by the bf16 X read, and U is the one S-sized
    device->host transfer (6.2 GB f32 at the 0.25-degree-ERA5-week
    shape).  ``"float32"`` forces the full-precision wire;
    the returned host array is float32 either way.

    ``u_out``: optional preallocated (n_rows, n_components) array-like
    (numpy array, ``np.memmap``, or h5py dataset) that receives U
    blockwise — no (S, k) host array is ever allocated here, so U can
    stream straight into the output artifact file.  Returned as
    ``SVDResult.U`` verbatim.

    ``col_limit``: decompose only the LEADING ``col_limit`` columns
    (e.g. the training window of a holdout split) — trailing columns
    are sliced off each streamed block before any factor touches them.
    """
    (n_rows, t_cols), _, _bf16 = packed_info(path)
    if col_limit is not None:
        if not 0 < col_limit <= t_cols:
            raise ValueError(
                f"col_limit must be in (0, {t_cols}]; got {col_limit}"
            )
        t_cols = col_limit
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (n_rows, t_cols))
    # qr_method kept for API compatibility: the range basis is now
    # whitened implicitly in the r x r space (gram_whiten), so no tall
    # QR runs at all
    del qr_method
    device = device or jax.devices()[0]

    key = jax.random.key(seed)
    omega = jax.device_put(
        jax.random.normal(key, (t_cols, n_random), dtype=jnp.float32), device
    )

    def to_dev(blk: np.ndarray) -> jax.Array:
        if blk.dtype == np.uint16:  # bf16-packed storage (loader contract)
            blk = blk.view(np.dtype(jnp.bfloat16))
        if col_limit is not None and blk.shape[1] > t_cols:
            blk = blk[:, :t_cols]
        arr = jnp.asarray(blk)
        if block_dtype is not None:
            arr = arr.astype(block_dtype)
        return jax.device_put(arr, device)

    def sketch_blk(blk, om):
        return jnp.matmul(
            blk, om.astype(blk.dtype),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    # ONE jitted program per block visit (not three eager/jit
    # dispatches): a pass visits hundreds of blocks.
    @jax.jit
    def gram_apply_fused_blk(blk, target, acc):
        y_blk = sketch_blk(blk, target)
        return acc + jnp.matmul(
            blk.T.astype(jnp.float32), y_blk,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    @jax.jit
    def range_factors_blk(blk, target, gy, p):
        """Per-block accumulate of the range basis SMALL factors:
        Gy += y^T y and P += y^T X from the block's y = X_blk @ target
        — Y itself is never resident (device holds one block)."""
        y_blk = sketch_blk(blk, target)
        gy = gy + jnp.matmul(
            y_blk.T, y_blk,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        p = p + jnp.matmul(
            y_blk.T, blk.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return gy, p

    def stream_range_factors(target: jax.Array):
        """One pass: (Gy, P) = (Y^T Y, Y^T X) with Y = X @ target."""
        gy = jax.device_put(
            jnp.zeros((target.shape[1], target.shape[1]), jnp.float32),
            device,
        )
        p = jax.device_put(
            jnp.zeros((target.shape[1], t_cols), jnp.float32), device
        )
        for i, (r0, blk) in enumerate(
            prefetched_row_blocks(path, n_rows, block_rows)
        ):
            gy, p = range_factors_blk(to_dev(blk), target, gy, p)
            _throttle(gy, i)
        return gy, p

    # wire dtype of the U stream-back: bf16 halves the one S-sized d2h
    # transfer when the source bytes are bf16 anyway ("auto")
    if u_dtype == "auto":
        u_wire = jnp.bfloat16 if _bf16 else jnp.float32
    elif u_dtype in (None, "float32"):
        u_wire = jnp.float32
    elif u_dtype in ("bfloat16", "bf16"):
        u_wire = jnp.bfloat16
    else:
        raise ValueError(f"u_dtype must be auto/float32/bfloat16, got {u_dtype!r}")

    @jax.jit
    def lift_blk(blk, m_lift):
        u = jnp.matmul(
            blk.astype(jnp.float32), m_lift,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return u.astype(u_wire)

    def stream_lift_to_host(m_lift: jax.Array) -> np.ndarray:
        """One pass: U = X @ m_lift, streamed back to HOST block by
        block — the device never holds an (S, k) array, so matrices far
        beyond HBM (in any dimension) decompose.  Blocks land in
        ``u_out`` when given (memmap / h5py dataset), else a fresh f32
        host array."""
        dest = (
            u_out
            if u_out is not None
            else np.empty((n_rows, m_lift.shape[1]), np.float32)
        )
        for r0, blk in prefetched_row_blocks(path, n_rows, block_rows):
            u_blk = lift_blk(to_dev(blk), m_lift)
            dest[r0 : r0 + u_blk.shape[0]] = np.asarray(u_blk, np.float32)
        return dest

    def _throttle(acc: jax.Array, i: int, every: int = 4) -> None:
        """Bound the async dispatch queue: without a periodic sync the
        Python loop can read and enqueue a whole pass of blocks ahead of
        the device, and each enqueued host block stays alive until its
        transfer completes — host RAM on the scale of the artifact.  A
        scalar fetch every few blocks caps in-flight blocks at O(every)
        with the transfer/compute overlap intact."""
        if i % every == every - 1:
            jax.device_get(acc[0, 0])

    def stream_gram_apply(target: jax.Array) -> jax.Array:
        """One FUSED pass: Z_next = X^T (X @ target) — the sketch and
        its transposed re-projection share each block visit, so a power
        iteration costs one disk read instead of two."""
        acc = jax.device_put(
            jnp.zeros((t_cols, target.shape[1]), jnp.float32), device
        )
        for i, (r0, blk) in enumerate(
            prefetched_row_blocks(path, n_rows, block_rows)
        ):
            acc = gram_apply_fused_blk(to_dev(blk), target, acc)
            _throttle(acc, i)
        return acc

    log_and_print(
        logger,
        f"Streaming SVD: {n_rows} x {t_cols} in {block_rows}-row blocks "
        f"({(n_rows + block_rows - 1) // block_rows} blocks/pass, "
        f"{n_iter + 2} passes)",
    )
    if n_iter > 0:
        z = stream_gram_apply(omega)  # pass 1: Z = (X^T X) Omega
        for _ in range(n_iter - 1):  # passes 2..n_iter
            z, _ = _local_factor(z, "householder")
            z = stream_gram_apply(z)
        z, _ = _local_factor(z, "householder")
    else:
        z = omega

    # pass n_iter + 1: small range factors.  Q = Y W^T is IMPLICIT —
    # W = gram_whiten(Y^T Y) is the CholQR2-quality whitener wholly in
    # the r x r space (utils.linalg), so B = Q^T X = W (Y^T X) needs no
    # resident Y and no second projection pass.  (The previous design
    # materialized Y, Q1, Q2 on device: three S x r f32 arrays, 21 GB
    # at the 0.25-degree-week shape — the streamed backend OOMed in
    # exactly the regime it exists for.)
    gy, p = stream_range_factors(z)
    w_whiten = gram_whiten(gy)  # (r, r)
    b = jnp.matmul(
        w_whiten, p,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    s = s[:n_components]
    vt_k = vt[:n_components, :]
    # deterministic signs from V alone (sklearn flip_sign parity),
    # applied to the lift matrix BEFORE the U pass
    max_idx = jnp.argmax(jnp.abs(vt_k), axis=1)
    signs = jnp.sign(vt_k[jnp.arange(n_components), max_idx])
    signs = jnp.where(signs == 0, 1.0, signs)
    vt_k = vt_k * signs[:, None]
    m_lift = jnp.matmul(
        z,
        jnp.matmul(
            w_whiten.T, u_b[:, :n_components] * signs[None, :],
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (T, k)
    # pass n_iter + 2: U streamed to host
    u_host = stream_lift_to_host(m_lift)
    return SVDResult(u_host, s, vt_k)


def streamed_exact_gram_svd(
    path: str | Path,
    n_components: int,
    block_rows: int = 1 << 18,
    device=None,
    u_dtype: str | None = "auto",
    u_out=None,
    col_limit: int | None = None,
) -> SVDResult:
    """EXACT truncated SVD of a packed artifact in TWO disk passes.

    The out-of-core Gram route: because T is small next to S, the whole
    spectrum lives in the (T, T) Gram —

      pass 1: G += X_blk^T X_blk per block (device GEMM, f32-exact on
              bf16 operands), each block's partial Gram fetched to host
              and accumulated in FLOAT64 (~2 MB per block — exactly the
              oracle-grade scheme of scripts/era5_scale_bench.py);
      host:   eigh(G) -> s = sqrt(eigenvalues), V (deterministic, f64);
      pass 2: U = X (V_k S^-1), streamed back blockwise (bf16 wire on
              bf16 files — see ``u_dtype`` in
              :func:`streamed_randomized_svd`; ``u_out`` supported).

    Versus the randomized path's n_iter + 2 passes this is both exact
    AND moves (n_iter)x less data, so it is the route for
    ``svd_type=standard`` at out-of-core scale.

    Accuracy: the Gram squares conditioning, so tail components below
    ~sqrt(eps_f64) of s[0] are noise-floor — at f64 accumulation that
    is far below the bf16 storage quantization that dominates here.
    """
    (n_rows, t_cols), _, _bf16 = packed_info(path)
    if col_limit is not None:
        if not 0 < col_limit <= t_cols:
            raise ValueError(
                f"col_limit must be in (0, {t_cols}]; got {col_limit}"
            )
        t_cols = col_limit
    device = device or jax.devices()[0]

    if u_dtype == "auto":
        u_wire = jnp.bfloat16 if _bf16 else jnp.float32
    elif u_dtype in (None, "float32"):
        u_wire = jnp.float32
    elif u_dtype in ("bfloat16", "bf16"):
        u_wire = jnp.bfloat16
    else:
        raise ValueError(f"u_dtype must be auto/float32/bfloat16, got {u_dtype!r}")

    def to_dev(blk: np.ndarray) -> jax.Array:
        if blk.dtype == np.uint16:
            blk = blk.view(np.dtype(jnp.bfloat16))
        if col_limit is not None and blk.shape[1] > t_cols:
            blk = blk[:, :t_cols]
        return jax.device_put(jnp.asarray(blk), device)

    @jax.jit
    def block_gram(blk):
        bf = blk.astype(jnp.float32) if blk.dtype != jnp.float32 else blk
        return jnp.matmul(
            bf.T, bf,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    @jax.jit
    def block_gram_acc(blk, acc):
        return acc + block_gram(blk)

    log_and_print(
        logger,
        f"Streamed exact Gram SVD: {n_rows} x {t_cols} in "
        f"{block_rows}-row blocks (2 disk passes)",
    )
    # Gram accumulation strategy: per-block d2h + f64 host accumulation
    # is the oracle-grade scheme, but the partial Gram is T^2 floats —
    # at a long time axis (T = 8760: 307 MB) fetching it per block
    # through a slow d2h path dominates the whole run.  Past ~8 MB the
    # accumulator stays ON DEVICE in f32 (per-block products are still
    # HIGHEST-precision; only the cross-block additions round) and
    # comes home once.
    host_accumulate = t_cols * t_cols * 4 <= (8 << 20)
    if host_accumulate:
        gram = np.zeros((t_cols, t_cols), np.float64)
        for _r0, blk in prefetched_row_blocks(path, n_rows, block_rows):
            gram += np.asarray(block_gram(to_dev(blk)), np.float64)
    else:
        acc = jax.device_put(
            jnp.zeros((t_cols, t_cols), jnp.float32), device
        )
        for i, (_r0, blk) in enumerate(
            prefetched_row_blocks(path, n_rows, block_rows)
        ):
            acc = block_gram_acc(to_dev(blk), acc)
            if i % 4 == 3:  # bound the dispatch queue
                jax.device_get(acc[0, 0])
        gram = np.asarray(acc, np.float64)

    evals, vecs = np.linalg.eigh(gram)  # ascending, f64
    idx = np.argsort(evals)[::-1][:n_components]
    s = np.sqrt(np.maximum(evals[idx], 0.0))
    v_cols = vecs[:, idx]  # (T, k)
    # deterministic signs from V (sklearn svd_flip parity)
    max_idx = np.argmax(np.abs(v_cols), axis=0)
    signs = np.sign(v_cols[max_idx, np.arange(len(idx))])
    signs = np.where(signs == 0, 1.0, signs)
    v_cols = v_cols * signs[None, :]
    m_lift = jnp.asarray(
        (v_cols / np.maximum(s, 1e-300)[None, :]).astype(np.float32)
    )  # (T, k)

    @jax.jit
    def lift_blk(blk, m):
        u = jnp.matmul(
            blk.astype(jnp.float32), m,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return u.astype(u_wire)

    dest = (
        u_out
        if u_out is not None
        else np.empty((n_rows, len(idx)), np.float32)
    )
    for r0, blk in prefetched_row_blocks(path, n_rows, block_rows):
        u_blk = lift_blk(to_dev(blk), m_lift)
        dest[r0 : r0 + u_blk.shape[0]] = np.asarray(u_blk, np.float32)
    return SVDResult(
        dest, s.astype(np.float32), v_cols.T.astype(np.float32)
    )


def streamed_onepass_svd(
    path: str | Path,
    n_components: int,
    block_rows: int = 1 << 16,
    n_oversamples: int | None = None,
    l_sketch: int | None = None,
    seed: int = 0,
    center: bool = False,
    device=None,
    info: dict | None = None,
    warn_tail_rel_err: float = 0.1,
) -> SVDResult:
    """Randomized truncated SVD of a packed artifact in ONE disk pass.

    The two-sided-sketch route (ops.onepass): the co-range sketch
    W = Psi X accumulates alongside the range sketch per row block, so
    the projection step never re-reads the file.  Use this when the
    matrix is too large (or too remote) to stream twice; accuracy
    trades a constant-factor residual inflation for the saved pass —
    ``streamed_randomized_svd`` remains the high-accuracy option.

    ``info``: optional dict that receives ``onepass_tail_rel_err_est``
    — the posterior estimate of the rank-k Frobenius reconstruction
    error computed from the sketches (ops.onepass.onepass_core).  A
    warning is logged when it exceeds ``warn_tail_rel_err``: the
    one-pass tail trade is real (rel err 0.61 over 100 components at
    the 0.25-degree week, BASELINE.md) and must not be silent.
    """
    from dmd_era5_tpu.ops.onepass import OnePassSketch

    (n_rows, t_cols), _, _ = packed_info(path)
    sk = OnePassSketch(
        t_cols,
        n_components,
        n_oversamples=n_oversamples,
        l_sketch=l_sketch,
        seed=seed,
        center=center,
        device=device,
        # the out-of-core contract: device residency O(one block) —
        # range-sketch rows stage to host RAM and the U lift runs as
        # blocked host GEMMs (an (S, r) device Y breaks exactly at the
        # larger-than-HBM scales this entry point exists for)
        y_store="host",
    )
    log_and_print(
        logger,
        f"One-pass streaming SVD: {n_rows} x {t_cols} in "
        f"{block_rows}-row blocks (single disk pass)",
    )
    for r0, blk in prefetched_row_blocks(path, n_rows, block_rows):
        if blk.dtype == np.uint16:  # bf16-packed storage (loader contract)
            blk = blk.view(np.dtype(jnp.bfloat16))
        sk.update(r0, jnp.asarray(blk).astype(jnp.float32))
    res = sk.finalize()
    err_est = sk.tail_rel_err_est
    if info is not None:
        info["onepass_tail_rel_err_est"] = round(err_est, 6)
    if err_est > warn_tail_rel_err:
        log_and_print(
            logger,
            f"One-pass SVD posterior error estimate {err_est:.3f} exceeds "
            f"{warn_tail_rel_err:.2f}: the trailing components of this "
            "decomposition are sketch-noise-dominated (the one-pass "
            "accuracy trade).  Reduce n_components, raise l_sketch, or "
            "use svd_backend='streamed' for a high-accuracy fit.",
            "warning",
        )
    return res
