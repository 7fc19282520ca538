"""Fused fit step: correctness vs numpy oracle + mesh parity + entry."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dmd_era5_tpu.parallel import make_mesh
from dmd_era5_tpu.pipeline.train_step import example_batch, fit_step, make_fit_step


def numpy_oracle(x: np.ndarray, omega: np.ndarray, k: int):
    """Reference computation with explicit centering + orthonormalization."""
    xc = x - x.mean(axis=-1, keepdims=True)
    out = []
    for b in range(x.shape[0]):
        y = xc[b] @ omega
        q, _ = np.linalg.qr(y)
        bm = q.T @ xc[b]
        ub, s, vt = np.linalg.svd(bm, full_matrices=False)
        u = q @ ub[:, :k]
        z = s[:k, None] * vt[:k]
        rel = np.linalg.norm(xc[b] - u @ z) / np.linalg.norm(xc[b])
        out.append((u, s[:k], vt[:k], rel))
    return out


def test_fit_step_matches_oracle(rng):
    mesh = make_mesh(devices=jax.devices()[:1])
    B, S, T, r, k = 2, 256, 64, 24, 12
    # low-rank signal so truncation is meaningful
    x = np.einsum(
        "bsr,brt->bst",
        rng.standard_normal((B, S, 16)),
        rng.standard_normal((B, 16, T)),
    ).astype(np.float32)
    omega = rng.standard_normal((T, r)).astype(np.float32)

    state = fit_step(jnp.asarray(x), jnp.asarray(omega), mesh=mesh, n_components=k)
    oracle = numpy_oracle(x, omega, k)

    for b in range(B):
        u_o, s_o, vt_o, rel_o = oracle[b]
        np.testing.assert_allclose(np.asarray(state.s)[b], s_o, rtol=1e-3)
        # subspace match of the POD basis
        qa, _ = np.linalg.qr(np.asarray(state.u)[b])
        qb, _ = np.linalg.qr(u_o)
        sv = np.linalg.svd(qa.T @ qb, compute_uv=False)
        assert sv.min() > 1 - 1e-3
    # loss matches the oracle's mean relative error formulation
    rels = np.asarray([o[3] for o in oracle])
    total = np.sqrt(
        sum(
            np.linalg.norm(
                x[b] - x[b].mean(-1, keepdims=True)
            )
            ** 2
            * rels[b] ** 2
            for b in range(B)
        )
        / sum(
            np.linalg.norm(x[b] - x[b].mean(-1, keepdims=True)) ** 2
            for b in range(B)
        )
    )
    np.testing.assert_allclose(float(state.loss), total, atol=5e-3)


def test_fit_step_orthonormal_u(rng):
    mesh = make_mesh(devices=jax.devices()[:1])
    x, omega = example_batch(1, 512, 96, 16, seed=1)
    state = fit_step(x, omega, mesh=mesh, n_components=8)
    u = np.asarray(state.u)[0]
    np.testing.assert_allclose(u.T @ u, np.eye(8), atol=1e-3)


def test_fit_step_reduced_operator_dynamics(rng):
    """a_red should propagate the projected coordinates one step."""
    mesh = make_mesh(devices=jax.devices()[:1])
    B, S, T = 1, 128, 48
    t = np.arange(T) * 0.1
    # two decaying oscillators -> rank-4 real dynamics
    sig = np.stack(
        [
            np.exp(-0.1 * t) * np.cos(2.0 * t),
            np.exp(-0.1 * t) * np.sin(2.0 * t),
            np.exp(-0.3 * t) * np.cos(0.7 * t),
            np.exp(-0.3 * t) * np.sin(0.7 * t),
        ]
    )
    modes = rng.standard_normal((S, 4))
    x = (modes @ sig)[None].astype(np.float32)
    omega = rng.standard_normal((T, 8)).astype(np.float32)
    state = fit_step(jnp.asarray(x), jnp.asarray(omega), mesh=mesh, n_components=4)
    z = np.asarray(state.s)[0][:, None] * np.asarray(state.v)[0]
    a = np.asarray(state.a_red)[0]
    pred = a @ z[:, :-1]
    rel = np.linalg.norm(pred - z[:, 1:]) / np.linalg.norm(z[:, 1:])
    assert rel < 5e-2


def test_fit_step_fused_matches_mesh_version(rng):
    from dmd_era5_tpu.pipeline.train_step import fit_step_fused

    mesh = make_mesh(devices=jax.devices()[:1])
    B, S, T, r, k = 1, 512, 128, 24, 12
    x = np.einsum(
        "sr,rt->st",
        rng.standard_normal((S, 16)),
        rng.standard_normal((16, T)),
    ).astype(np.float32)
    omega = rng.standard_normal((T, r)).astype(np.float32)

    ref = fit_step(
        jnp.asarray(x)[None], jnp.asarray(omega), mesh=mesh, n_components=k
    )
    # the fused variant returns UNBATCHED leaves (no leading data dim)
    fused = fit_step_fused(jnp.asarray(x), jnp.asarray(omega), n_components=k)
    np.testing.assert_allclose(
        np.asarray(fused.s), np.asarray(ref.s)[0], rtol=1e-3
    )
    np.testing.assert_allclose(
        float(fused.loss), float(ref.loss), atol=1e-3
    )
    # same POD subspace
    qa, _ = np.linalg.qr(np.asarray(fused.u))
    qb, _ = np.linalg.qr(np.asarray(ref.u)[0])
    sv = np.linalg.svd(qa.T @ qb, compute_uv=False)
    assert sv.min() > 1 - 1e-3
    # a_red is defined up to the SVD's per-component sign ambiguity:
    # flipping (u_i, v_i) conjugates A by diag(+-1). Align signs via vt.
    signs = np.sign(
        np.sum(np.asarray(fused.v) * np.asarray(ref.v)[0], axis=1)
    )
    d = np.diag(signs)
    np.testing.assert_allclose(
        d @ np.asarray(fused.a_red) @ d,
        np.asarray(ref.a_red)[0],
        atol=5e-3,
    )


def test_fit_step_sharded_fused_matches_single(rng):
    """time-unsharded meshes take the shard_map path: per-shard fused
    sketch+Gram / projection pass, psum of the small factors.
    Must agree with the single-device run."""
    mesh = make_mesh("data=2,space=4")
    assert mesh.shape["time"] == 1
    B, S, T, r, k = 4, 256, 64, 16, 8
    x = np.einsum(
        "bsr,brt->bst",
        rng.standard_normal((B, S, 12)),
        rng.standard_normal((B, 12, T)),
    ).astype(np.float32)
    omega = rng.standard_normal((T, r)).astype(np.float32)
    step = make_fit_step(mesh, n_components=k)
    state = step(jnp.asarray(x), jnp.asarray(omega))
    single = fit_step(
        jnp.asarray(x),
        jnp.asarray(omega),
        mesh=make_mesh(devices=jax.devices()[:1]),
        n_components=k,
    )
    np.testing.assert_allclose(
        np.asarray(state.s), np.asarray(single.s), rtol=2e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        float(state.loss), float(single.loss), atol=1e-3
    )
    for b in range(B):
        qa, _ = np.linalg.qr(np.asarray(state.u)[b])
        qb, _ = np.linalg.qr(np.asarray(single.u)[b])
        sv = np.linalg.svd(qa.T @ qb, compute_uv=False)
        assert sv.min() > 1 - 1e-3


def test_fit_step_fused_bf16_precision_parity(rng):
    """bf16-resident X: same algorithm on quantized inputs.  The top
    singular values must match f32 to input-quantization order, and U
    must stay orthonormal (the Gram is computed from the STORED
    quantized Yc, keeping the whitening self-consistent)."""
    from dmd_era5_tpu.pipeline.train_step import fit_step_fused

    S, T, r, k = 1024, 128, 32, 16
    x = np.einsum(
        "sr,rt->st",
        rng.standard_normal((S, 12)) * (np.arange(12, 0, -1) ** 2),
        rng.standard_normal((12, T)),
    ).astype(np.float32)
    x += 0.01 * rng.standard_normal((S, T)).astype(np.float32)
    omega = rng.standard_normal((T, r)).astype(np.float32)

    f32 = fit_step_fused(jnp.asarray(x), jnp.asarray(omega), n_components=k)
    b16 = fit_step_fused(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(omega),
        n_components=k,
        gemm_dtype=jnp.bfloat16,
    )
    s32, s16 = np.asarray(f32.s), np.asarray(b16.s)
    # bf16 has an 8-bit mantissa: rel err of the dominant values is
    # O(2^-8); the tail is noise-dominated in both precisions
    np.testing.assert_allclose(s16[:4], s32[:4], rtol=2e-2)
    u16 = np.asarray(b16.u)
    g = u16.T @ u16
    # leading modes must be cleanly orthonormal; trailing directions
    # sit at the data's noise floor, where input quantization bounds
    # what ANY whitening can recover (measured ~6e-2 here)
    np.testing.assert_allclose(g[:8, :8], np.eye(8), atol=1e-2)
    np.testing.assert_allclose(g, np.eye(k), atol=1.5e-1)
    assert abs(float(b16.loss) - float(f32.loss)) < 5e-2


def test_fit_step_multi_axis_mesh():
    mesh = make_mesh("data=2,space=2,time=2")
    step = make_fit_step(mesh, n_components=4)
    x, omega = example_batch(4, 128, 32, 8)
    state = step(x, omega)
    single = fit_step(
        x, omega, mesh=make_mesh(devices=jax.devices()[:1]), n_components=4
    )
    np.testing.assert_allclose(
        np.asarray(state.s), np.asarray(single.s), rtol=2e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        float(state.loss), float(single.loss), atol=1e-3
    )


def test_graft_entry_contract():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(float(out.loss))
    g.dryrun_multichip(8)
    g.dryrun_multichip(3)


def test_fit_step_fused_stats_from_sketch_parity(rng):
    """stats_from_sketch spends omega's last column on an all-ones probe
    (row sums ride the MXU); results must match the plain path run with
    the SAME effective sketch, and the stats must be exact."""
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project
    from dmd_era5_tpu.pipeline.train_step import fit_step_fused

    # k stays below the data rank: values past it are noise-floor zeros
    # whose relative error is meaningless
    S, T, r, k = 768, 96, 32, 8
    x = np.einsum(
        "sr,rt->st",
        rng.standard_normal((S, 10)) * (np.arange(10, 0, -1) ** 2),
        rng.standard_normal((10, T)),
    ).astype(np.float32)
    # noise floor keeps the 32-wide sketch Gram away from exact rank
    # deficiency (a ridge-dominated whitening costs ~1e-2 in the tail
    # regardless of how the row stats are computed)
    x += 0.1 * rng.standard_normal((S, T)).astype(np.float32)
    omega = rng.standard_normal((T, r)).astype(np.float32)

    # kernel-level: stats exactly match numpy, Yc last column is zero
    yc, rs, rss, g, c = sketch_center_gram_project(
        jnp.asarray(x), jnp.asarray(omega), stats_col=True
    )
    # dot-derived rowsum differs from numpy's pairwise sum in the last
    # ulp of a large cancellation-prone total
    np.testing.assert_allclose(np.asarray(rs), x.sum(axis=1), rtol=3e-5)
    np.testing.assert_allclose(
        np.asarray(rss), (x * x).sum(axis=1), rtol=1e-4
    )
    # zero to roundoff: rs*(1/T)*T != rs exactly when T is not a power
    # of two, so the dead column sits at ~eps * |rowsum|
    dead_tol = 1e-6 * np.abs(x.sum(axis=1)).max()
    np.testing.assert_allclose(np.asarray(yc)[:, -1], 0.0, atol=dead_tol)

    # step-level: identical to the plain path given the same sketch
    omega_ones = np.concatenate([omega[:, :-1], np.ones((T, 1), np.float32)], 1)
    a = fit_step_fused(
        jnp.asarray(x), jnp.asarray(omega), n_components=k,
        stats_from_sketch=True,
    )
    b = fit_step_fused(
        jnp.asarray(x), jnp.asarray(omega_ones), n_components=k
    )
    np.testing.assert_allclose(np.asarray(a.s), np.asarray(b.s), rtol=1e-4)
    # the loss numerator ||Xc||^2 - ||Z||^2 is a large cancellation:
    # the last-ulp rowsum difference shows up at ~1e-3 relative
    np.testing.assert_allclose(
        float(a.loss), float(b.loss), rtol=3e-3, atol=1e-6
    )
    # and the decomposition itself is still correct vs the numpy oracle
    xc = x - x.mean(axis=1, keepdims=True)
    s_ref = np.linalg.svd(xc, compute_uv=False)[:k]
    np.testing.assert_allclose(np.asarray(a.s), s_ref, rtol=2e-3)
    u = np.asarray(a.u)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=2e-3)


def test_fit_step_fused_t_valid_column_padding(rng):
    """Zero-padding the time axis to a lane multiple with t_valid set
    is EXACT: identical factors and loss to the unpadded fit (the
    padding exists so a T=168-style matrix's native layout matches the
    Mosaic operand constraint instead of costing a full X relayout
    copy inside every step)."""
    import jax.numpy as jnp

    from dmd_era5_tpu.pipeline.train_step import fit_step_fused

    s_rows, t_true, t_pad, k = 512, 40, 64, 6
    # well-separated spectrum: near-degenerate noise singular values
    # make the vectors themselves ill-determined and the comparison
    # meaningless
    uu, _ = np.linalg.qr(rng.standard_normal((s_rows, 8)))
    vv, _ = np.linalg.qr(rng.standard_normal((t_true, 8)))
    sig = np.geomspace(50.0, 2.0, 8)
    x = ((uu * sig) @ vv.T).astype(np.float32)
    x += 0.01 * rng.standard_normal((s_rows, t_true)).astype(np.float32)
    omega = rng.standard_normal((t_true, 16)).astype(np.float32)
    x_pad = np.zeros((s_rows, t_pad), np.float32)
    x_pad[:, :t_true] = x
    om_pad = np.zeros((t_pad, 16), np.float32)
    om_pad[:t_true] = omega

    ref = fit_step_fused(jnp.asarray(x), jnp.asarray(omega), n_components=k)
    got = fit_step_fused(
        jnp.asarray(x_pad), jnp.asarray(om_pad), n_components=k,
        t_valid=t_true,
    )
    assert got.v.shape == (k, t_true)
    np.testing.assert_allclose(np.asarray(got.s), np.asarray(ref.s), rtol=1e-5)
    np.testing.assert_allclose(
        float(got.loss), float(ref.loss), rtol=1e-4
    )
    np.testing.assert_allclose(
        np.abs(np.asarray(got.v)), np.abs(np.asarray(ref.v)), atol=1e-4
    )
    np.testing.assert_allclose(
        np.abs(np.asarray(got.u)), np.abs(np.asarray(ref.u)), atol=1e-4
    )


def test_fit_step_fused_small_algebra_eigh2(rng):
    """small_algebra='eigh2' (two r x r eighs, no Cholesky/tri_inv/wide
    SVD custom calls — the headline-step candidate, review r4 item 3)
    matches the numpy oracle and the cholqr route within the eigh
    sensitivity floor (~1e-3 relative on mid-spectrum values)."""
    from dmd_era5_tpu.pipeline.train_step import fit_step_fused

    S, T, k = 768, 96, 8
    # moderate spectrum: eigh2's domain is cond(G) within the f32 eigh
    # noise floor (~1e6); the cholqr route stays the default beyond it
    x = np.einsum(
        "sr,rt->st",
        rng.standard_normal((S, 10)) * np.linspace(12.0, 2.0, 10),
        rng.standard_normal((10, T)),
    ).astype(np.float32)
    x += 0.1 * rng.standard_normal((S, T)).astype(np.float32)
    omega = rng.standard_normal((T, 32)).astype(np.float32)

    a = fit_step_fused(
        jnp.asarray(x), jnp.asarray(omega), n_components=k,
        small_algebra="eigh2",
    )
    b = fit_step_fused(jnp.asarray(x), jnp.asarray(omega), n_components=k)
    np.testing.assert_allclose(np.asarray(a.s), np.asarray(b.s), rtol=2e-3)
    np.testing.assert_allclose(float(a.loss), float(b.loss), rtol=1e-2, atol=1e-6)

    xc = x - x.mean(axis=1, keepdims=True)
    s_ref = np.linalg.svd(xc, compute_uv=False)[:k]
    np.testing.assert_allclose(np.asarray(a.s), s_ref, rtol=2e-3)
    u = np.asarray(a.u)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=2e-3)
    # vt rows come from B / s: tail orthogonality degrades with the
    # component's conditioning (s_k / s_0), not to machine precision
    v = np.asarray(a.v)
    np.testing.assert_allclose(v @ v.T, np.eye(k), atol=2e-2)


def test_fit_step_fused_small_algebra_hybrid(rng):
    """small_algebra='hybrid' (CholQR whitener + one r x r eigh of
    B B^T) matches the numpy oracle and the cholqr route within the
    eigh sensitivity floor — same parity bars as the eigh2 route."""
    from dmd_era5_tpu.pipeline.train_step import fit_step_fused

    S, T, k = 768, 96, 8
    x = np.einsum(
        "sr,rt->st",
        rng.standard_normal((S, 10)) * np.linspace(12.0, 2.0, 10),
        rng.standard_normal((10, T)),
    ).astype(np.float32)
    x += 0.1 * rng.standard_normal((S, T)).astype(np.float32)
    omega = rng.standard_normal((T, 32)).astype(np.float32)

    a = fit_step_fused(
        jnp.asarray(x), jnp.asarray(omega), n_components=k,
        small_algebra="hybrid",
    )
    b = fit_step_fused(jnp.asarray(x), jnp.asarray(omega), n_components=k)
    np.testing.assert_allclose(np.asarray(a.s), np.asarray(b.s), rtol=2e-3)
    np.testing.assert_allclose(
        float(a.loss), float(b.loss), rtol=1e-2, atol=1e-6
    )

    xc = x - x.mean(axis=1, keepdims=True)
    s_ref = np.linalg.svd(xc, compute_uv=False)[:k]
    np.testing.assert_allclose(np.asarray(a.s), s_ref, rtol=2e-3)
    u = np.asarray(a.u)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=2e-3)
    v = np.asarray(a.v)
    np.testing.assert_allclose(v @ v.T, np.eye(k), atol=2e-2)


def test_hybrid_ill_conditioned_damps_not_explodes(rng):
    """hybrid squares B's conditioning in K = B B^T: past the noise
    floor it must damp (shrunk tail), never inject spurious values."""
    from dmd_era5_tpu.pipeline.train_step import fit_step_fused

    S, T, k = 768, 96, 8
    x = np.einsum(
        "sr,rt->st",
        rng.standard_normal((S, 10)) * (np.arange(10, 0, -1) ** 2),
        rng.standard_normal((10, T)),
    ).astype(np.float32)
    x += 0.1 * rng.standard_normal((S, T)).astype(np.float32)
    omega = rng.standard_normal((T, 32)).astype(np.float32)

    a = fit_step_fused(
        jnp.asarray(x), jnp.asarray(omega), n_components=k,
        small_algebra="hybrid",
    )
    xc = x - x.mean(axis=1, keepdims=True)
    s_ref = np.linalg.svd(xc, compute_uv=False)
    np.testing.assert_allclose(np.asarray(a.s)[:3], s_ref[:3], rtol=5e-3)
    assert float(np.asarray(a.s)[0]) <= 1.01 * s_ref[0]
    assert np.all(np.diff(np.asarray(a.s)) <= 1e-3 * s_ref[0])


def test_reduced_factors_unknown_method_raises(rng):
    from dmd_era5_tpu.pipeline.train_step import fit_step_fused

    x = rng.standard_normal((64, 16)).astype(np.float32)
    omega = rng.standard_normal((16, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="small_algebra"):
        fit_step_fused(
            jnp.asarray(x), jnp.asarray(omega), n_components=4,
            small_algebra="nope",
        )


def test_eigh2_ill_conditioned_damps_not_explodes(rng):
    """Past the f32 eigh noise floor the eigh2 route must DAMP junk
    directions (shrunk-tail, like the CholQR ridge), never inject
    spurious singular values above the true head."""
    from dmd_era5_tpu.pipeline.train_step import fit_step_fused

    S, T, k = 768, 96, 8
    # huge spread -> cond(G) ~ 1e9: the adversarial regime
    x = np.einsum(
        "sr,rt->st",
        rng.standard_normal((S, 10)) * (np.arange(10, 0, -1) ** 2),
        rng.standard_normal((10, T)),
    ).astype(np.float32)
    x += 0.1 * rng.standard_normal((S, T)).astype(np.float32)
    omega = rng.standard_normal((T, 32)).astype(np.float32)

    a = fit_step_fused(
        jnp.asarray(x), jnp.asarray(omega), n_components=k,
        small_algebra="eigh2",
    )
    xc = x - x.mean(axis=1, keepdims=True)
    s_ref = np.linalg.svd(xc, compute_uv=False)
    # head components still accurate; no value exceeds the true maximum
    np.testing.assert_allclose(np.asarray(a.s)[:3], s_ref[:3], rtol=5e-3)
    assert float(np.asarray(a.s)[0]) <= 1.01 * s_ref[0]
    assert np.all(np.diff(np.asarray(a.s)) <= 1e-3 * s_ref[0])  # sorted


def test_stats_col_with_t_valid_dead_column(rng):
    """stats_col + t_valid combined (review r4): the ones column's pad
    rows must be zeroed so colw[-1] == t_valid and the stats column of
    Yc dies exactly — otherwise it carries a rowsum-proportional residue
    into G and C."""
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project

    s_rows, t_true, t_pad, r = 512, 40, 64, 16
    x = rng.standard_normal((s_rows, t_true)).astype(np.float32)
    omega = rng.standard_normal((t_true, r)).astype(np.float32)
    x_pad = np.zeros((s_rows, t_pad), np.float32)
    x_pad[:, :t_true] = x
    om_pad = np.zeros((t_pad, r), np.float32)
    om_pad[:t_true] = omega

    yc, rs, rss, g, c = sketch_center_gram_project(
        jnp.asarray(x_pad), jnp.asarray(om_pad),
        stats_col=True, t_valid=t_true,
    )
    # row stats exact over the true columns
    np.testing.assert_allclose(np.asarray(rs), x.sum(axis=1), rtol=3e-5)
    # the stats column of Yc is dead to roundoff
    dead_tol = 1e-6 * np.abs(x.sum(axis=1)).max()
    np.testing.assert_allclose(np.asarray(yc)[:, -1], 0.0, atol=dead_tol)
    # and a dead column contributes nothing to G or C
    np.testing.assert_allclose(np.asarray(g)[-1, :], 0.0, atol=2e-4)
    np.testing.assert_allclose(np.asarray(c)[-1, :], 0.0, atol=2e-4)

    # parity with the unpadded stats_col path on the shared columns
    yc0, rs0, _, g0, c0 = sketch_center_gram_project(
        jnp.asarray(x), jnp.asarray(omega), stats_col=True
    )
    np.testing.assert_allclose(
        np.asarray(yc)[:, :-1], np.asarray(yc0)[:, :-1], atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(g)[:-1, :-1], np.asarray(g0)[:-1, :-1], rtol=1e-4,
        atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(c)[:-1, :t_true], np.asarray(c0)[:-1, :], rtol=1e-4,
        atol=1e-3,
    )


def test_fit_step_lean_matches_fused(rng):
    """The memory-lean path (no Yc residency, centering folded into the
    small lift matrix) produces the same factors as the fused path."""
    import jax.numpy as jnp

    from dmd_era5_tpu.pipeline.train_step import (
        fit_step_fused,
        fit_step_lean,
    )

    s_rows, t_true, t_pad, k = 512, 40, 64, 6
    uu, _ = np.linalg.qr(rng.standard_normal((s_rows, 8)))
    vv, _ = np.linalg.qr(rng.standard_normal((t_true, 8)))
    sig = np.geomspace(50.0, 2.0, 8)
    x = ((uu * sig) @ vv.T).astype(np.float32)
    x += 0.01 * rng.standard_normal((s_rows, t_true)).astype(np.float32)
    omega = rng.standard_normal((t_true, 16)).astype(np.float32)

    ref = fit_step_fused(jnp.asarray(x), jnp.asarray(omega), n_components=k)
    lean = fit_step_lean(jnp.asarray(x), jnp.asarray(omega), n_components=k)
    np.testing.assert_allclose(
        np.asarray(lean.s), np.asarray(ref.s), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(lean.loss), float(ref.loss), rtol=1e-4
    )
    np.testing.assert_allclose(
        np.abs(np.asarray(lean.u)), np.abs(np.asarray(ref.u)), atol=1e-4
    )

    # padded time axis, exact via t_valid
    x_pad = np.zeros((s_rows, t_pad), np.float32)
    x_pad[:, :t_true] = x
    om_pad = np.zeros((t_pad, 16), np.float32)
    om_pad[:t_true] = omega
    lp = fit_step_lean(
        jnp.asarray(x_pad), jnp.asarray(om_pad), n_components=k,
        t_valid=t_true,
    )
    assert lp.v.shape == (k, t_true)
    np.testing.assert_allclose(np.asarray(lp.s), np.asarray(ref.s), rtol=1e-5)
    np.testing.assert_allclose(
        np.abs(np.asarray(lp.u)), np.abs(np.asarray(ref.u)), atol=1e-4
    )
