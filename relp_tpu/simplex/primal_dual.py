"""Primal-dual interior-point engine (Mehrotra predictor-corrector).

The reference reserves an empty module for a future primal-dual algorithm
(``src/algorithm/primal_dual/mod.rs:1-3``).  This makes it real, designed
hardware-first: an IPM is the one LP algorithm whose per-iteration work is
a large dense matmul — forming the normal-equation matrix K = A·D·Aᵀ + δI
is an (m×n)·(n×m) GEMM, its Cholesky factorization is m³/3 FLOPs,
and the iteration count is O(√n·log(1/ε)) ≈ 20–60 regardless of problem
degeneracy (where simplex pivots are inherently sequential and PDHG needs
10⁴–10⁵ bandwidth-bound SpMV sweeps).

Problem shape (the scaled/padded computational form all engines consume):

    min cᵀx   s.t.  A x = b,   lb ≤ x ≤ ub

with per-variable bound classes (both/lower/upper/free/fixed).  Bounds are
handled natively via two slack/multiplier pairs (s_l = x−lb ⟂ z_l ≥ 0,
s_u = ub−x ⟂ z_u ≥ 0) masked by bound finiteness — variable bounds never
become rows (the same invariant as the simplex core).  Free variables get
a large temporary box (verified inactive at the end — the dual engine's
``dual_box`` pattern); fixed and padded columns are pinned by zeroing
their diagonal scaling d_j, so Δx_j ≡ 0.

Precision:
- state, residuals and all A matvecs are f64,
- K is formed as (A·√d)·(A·√d)ᵀ with ``Precision.HIGHEST`` at the current
  factorization precision (a TF32/bf16-truncated product stalls the
  Newton direction the same way it stalled the fleet PDHG),
- the Cholesky factor is Jacobi-equilibrated for conditioning, and every
  triangular solve is wrapped in f64 iterative refinement against the
  EXACT operator K·v = A(d·(Aᵀv)) + δv — the factor is a preconditioner,
  not the truth,
- the factor is f64 by default; ``ipm_ladder="mixed"`` starts on an f32
  factor and escalates to f64 when the f32 preconditioner stops
  contracting (refinement residual ≥1e-2 or NaN directions).

Regularization: primal ρ enters as d = 1/(z_l/s_l + z_u/s_u + ρ), dual δ
on K's diagonal (Saunders-style quasi-definiteness); the host loop raises
δ and retries the same iteration when the factorization fails, and both
shrink with μ.

Termination: relative primal/dual infeasibility and duality gap below
``tol`` (the PDLP engine's criteria, so driver acceptance logic is
shared).  The caller (simplex/driver.py ``_run_ipm``) Ruiz-equilibrates,
runs the loop, and feeds the returned (x, y) to the shared simplex
crossover for an exact vertex.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


HIGHEST = jax.lax.Precision.HIGHEST


class IpmState(NamedTuple):
    x: jax.Array   # f64[n]
    y: jax.Array   # f64[m]
    zl: jax.Array  # f64[n]  multipliers of x ≥ lb (0 where no lower bound)
    zu: jax.Array  # f64[n]  multipliers of x ≤ ub


class IpmDiag(NamedTuple):
    mu: jax.Array        # average complementarity
    rp: jax.Array        # relative primal infeasibility (∞-norm)
    rd: jax.Array        # relative dual infeasibility (∞-norm)
    gap: jax.Array       # relative duality gap
    pobj: jax.Array      # primal objective (scaled space)
    dobj: jax.Array      # dual objective
    alpha_p: jax.Array   # last primal step
    alpha_d: jax.Array   # last dual step
    sigma: jax.Array     # centering parameter used
    ir_err: jax.Array    # worst normal-equation refinement residual (rel)


def _max_step(s, ds, mask):
    """Largest α ∈ (0,1] with s + α·ds ≥ 0 on the masked entries."""
    blocking = mask & (ds < 0)
    ratios = jnp.where(blocking, -s / jnp.where(blocking, ds, -1.0), jnp.inf)
    return jnp.minimum(1.0, jnp.min(ratios))


def _factor(Afac, d, delta, fdt):
    """Form and factor K = (A√d)(A√d)ᵀ + δI with Jacobi equilibration.

    ``Afac`` is A at the factorization precision (f32 normally; the host
    loop escalates to the f64 copy when f32 refinement stalls — see
    ``solve_ipm``'s precision ladder).  Returns ``(L, js)`` where ``js``
    is the Jacobi scale: the factored matrix is S·K·S with S = diag(js),
    js = 1/√diag(K) — the Cholesky is far more robust on the equilibrated
    matrix when d spans 10⁻⁸..10⁸ late in the interior-point path.
    """
    w = jnp.sqrt(d).astype(Afac.dtype)
    B = Afac * w[None, :]
    K = jnp.matmul(B, B.T, precision=HIGHEST).astype(fdt)
    m = K.shape[0]
    K = K + delta.astype(fdt) * jnp.eye(m, dtype=fdt)
    dg = jnp.diagonal(K)
    js = jnp.where(dg > 0, 1.0 / jnp.sqrt(jnp.where(dg > 0, dg, 1.0)), 1.0)
    Ks = K * js[:, None] * js[None, :]
    L = jnp.linalg.cholesky(Ks)
    return L, js


def _solve_normal(L, js, A64, d, delta, rhs, n_ir):
    """Solve (A·D·Aᵀ + δI)·t = rhs: equilibrated-factor solve + f64
    iterative refinement against the exact operator (panel-looped f64
    matvecs).  Returns ``(t, rel_resid)``."""
    from jax.scipy.linalg import cho_solve

    fdt = L.dtype

    def apply_K(v):
        return A64 @ (d * (v @ A64)) + delta * v

    def precond(r):
        return (js * cho_solve((L, True), (js * r).astype(fdt))).astype(
            jnp.float64
        )

    t = precond(rhs)
    r = rhs - apply_K(t)
    for _ in range(n_ir):
        t = t + precond(r)
        r = rhs - apply_K(t)
    scale = jnp.maximum(jnp.max(jnp.abs(rhs)), 1e-30)
    return t, jnp.max(jnp.abs(r)) / scale


def _step_math(
    A64, Afac, b, c, lbf, ubf, hl, hu, dmask,
    state: IpmState, delta, rho, nb, gamma, fdt, n_ir,
):
    """One Mehrotra predictor-corrector iteration (pure math; jitted by
    :func:`ipm_step` and scanned by :func:`ipm_chunk`).

    ``hl``/``hu`` are f64 0/1 masks of finite lower/upper bounds,
    ``lbf``/``ubf`` the bounds with ±inf replaced by 0 (so masked
    arithmetic never produces inf·0), ``dmask`` the 0/1 mask of movable
    (non-fixed, non-padded) columns, ``nb`` the number of finite-bound
    pairs, ``gamma`` the fraction-to-boundary, ``delta``/``rho`` the
    dual/primal regularizations.  ``fdt``/``n_ir`` are static: the
    Cholesky dtype and refinement step count.
    """
    x, y, zl, zu = state
    one = jnp.float64(1.0)

    sl = jnp.where(hl > 0, x - lbf, one)
    su = jnp.where(hu > 0, ubf - x, one)

    ax = A64 @ x
    aty = y @ A64
    r_p = b - ax
    r_d = (c - aty - zl + zu) * dmask
    mu = (jnp.sum(hl * sl * zl) + jnp.sum(hu * su * zu)) / nb

    dinv = hl * zl / sl + hu * zu / su + rho
    d = dmask / dinv

    L, js = _factor(Afac, d, delta, fdt)

    def direction(rcl, rcu, ir_acc):
        g = r_d - hl * rcl / sl + hu * rcu / su
        h = r_p + A64 @ (d * g)
        dy, ir = _solve_normal(L, js, A64, d, delta, h, n_ir)
        dx = d * (dy @ A64 - g)
        dzl = hl * (rcl - zl * dx) / sl
        dzu = hu * (rcu + zu * dx) / su
        return dx, dy, dzl, dzu, jnp.maximum(ir_acc, ir)

    # -- predictor (affine scaling): pure Newton on the KKT residuals --
    rcl_aff = -sl * zl
    rcu_aff = -su * zu
    dx_a, dy_a, dzl_a, dzu_a, ir1 = direction(rcl_aff, rcu_aff, 0.0)

    ap = jnp.minimum(_max_step(sl, dx_a, hl > 0), _max_step(su, -dx_a, hu > 0))
    ad = jnp.minimum(_max_step(zl, dzl_a, hl > 0), _max_step(zu, dzu_a, hu > 0))
    mu_aff = (
        jnp.sum(hl * (sl + ap * dx_a) * (zl + ad * dzl_a))
        + jnp.sum(hu * (su - ap * dx_a) * (zu + ad * dzu_a))
    ) / nb
    sigma = jnp.clip((mu_aff / mu) ** 3, 1e-8, 1.0)

    # -- corrector: recentre to σμ and cancel the affine second-order term
    rcl = sigma * mu - sl * zl - dx_a * dzl_a
    rcu = sigma * mu - su * zu + dx_a * dzu_a
    dx, dy, dzl, dzu, ir_err = direction(rcl, rcu, ir1)

    ap = gamma * jnp.minimum(
        _max_step(sl, dx, hl > 0), _max_step(su, -dx, hu > 0)
    )
    ad = gamma * jnp.minimum(
        _max_step(zl, dzl, hl > 0), _max_step(zu, dzu, hu > 0)
    )

    x1 = x + ap * dx
    y1 = y + ad * dy
    zl1 = zl + ad * dzl
    zu1 = zu + ad * dzu

    # -- diagnostics at the NEW point (what the host loop steers on) --
    sl1 = jnp.where(hl > 0, x1 - lbf, one)
    su1 = jnp.where(hu > 0, ubf - x1, one)
    ax1 = A64 @ x1
    aty1 = y1 @ A64
    r_p1 = b - ax1
    r_d1 = (c - aty1 - zl1 + zu1) * dmask
    mu1 = (jnp.sum(hl * sl1 * zl1) + jnp.sum(hu * su1 * zu1)) / nb
    pobj = jnp.dot(c, x1)
    # fixed columns (dmask=0, incl. padded) enter the dual objective with
    # their exact multiplier c_j − a_jᵀy
    dobj = (
        jnp.dot(b, y1)
        + jnp.sum(hl * lbf * zl1)
        - jnp.sum(hu * ubf * zu1)
        + jnp.sum((1.0 - dmask) * (c - aty1) * x1)
    )
    rp_rel = jnp.max(jnp.abs(r_p1)) / (1.0 + jnp.max(jnp.abs(b)))
    rd_rel = jnp.max(jnp.abs(r_d1)) / (1.0 + jnp.max(jnp.abs(c)))
    gap_rel = jnp.abs(pobj - dobj) / (1.0 + jnp.abs(pobj) + jnp.abs(dobj))

    diag = IpmDiag(
        mu=mu1, rp=rp_rel, rd=rd_rel, gap=gap_rel, pobj=pobj, dobj=dobj,
        alpha_p=ap, alpha_d=ad, sigma=sigma, ir_err=ir_err,
    )
    return IpmState(x1, y1, zl1, zu1), diag


ipm_step = functools.partial(jax.jit, static_argnames=("fdt", "n_ir"))(
    _step_math
)


class IpmChunkOut(NamedTuple):
    state: IpmState
    delta: jax.Array      # f64 — regularization after the chunk
    rho: jax.Array
    committed: jax.Array  # i32 — healthy iterations applied
    bad: jax.Array        # i32 — consecutive unhealthy directions at exit
    best_x: jax.Array     # best-KKT committed point within the chunk
    best_y: jax.Array
    best_kkt: jax.Array
    diag: IpmDiag         # last committed iteration's diagnostics


@functools.partial(jax.jit, static_argnames=("fdt", "n_ir", "k_max"))
def ipm_chunk(
    A64, Afac, b, c, lbf, ubf, hl, hu, dmask,
    state: IpmState, delta, rho, nb, gamma, tol, kkt_ref, fdt, n_ir, k_max,
):
    """Up to ``k_max`` Mehrotra iterations in ONE bounded device call.

    The per-iteration host loop pays a dispatch round trip per
    iteration; this runs the same host policy in-graph instead: an
    unhealthy direction (non-finite, or a normal-equation refinement
    residual that is ≥1e-2 absolute OR ≥3% of the last
    committed KKT — a direction solved with error at the current KKT
    level cannot improve it, it only walks the iterate off the central
    path, which is exactly how GREENBEA's f32 rung poisoned the f64
    handoff at μ≈1) leaves the state unchanged and raises δ ×100
    (ρ = max(ρ, δ/100)); a healthy one commits and lets δ/ρ shrink with
    μ.  ``kkt_ref`` seeds the relative gate (host passes the last
    committed KKT, ``inf`` on the first chunk).  The chunk exits early
    on KKT ≤ tol or 3 consecutive unhealthy retries (the host then
    escalates the precision ladder).  The best committed point is
    tracked in-graph so a late blow-up never loses the certificate
    candidate.
    """
    big = jnp.float64(jnp.inf)

    def kkt_of(diag):
        return jnp.maximum(jnp.maximum(diag.rp, diag.rd), diag.gap)

    def cond(carry):
        _, _, _, attempts, _, bad, _, _, _, _, diag, stop = carry
        return (attempts < k_max) & ~stop

    def body(carry):
        (state, delta, rho, attempts, committed, bad,
         best_x, best_y, best_kkt, kkt_ref, _diag, _stop) = carry
        new_state, diag = _step_math(
            A64, Afac, b, c, lbf, ubf, hl, hu, dmask,
            state, delta, rho, nb, gamma, fdt, n_ir,
        )
        kkt = kkt_of(diag)
        healthy = (
            jnp.isfinite(diag.mu) & jnp.isfinite(kkt)
            & (diag.ir_err < 1e-2)
            & (diag.ir_err < jnp.maximum(0.03 * kkt_ref, 1e-13))
        )
        state1 = jax.tree.map(
            lambda new, old: jnp.where(healthy, new, old), new_state, state
        )
        delta1 = jnp.where(
            healthy,
            jnp.clip(delta, 1e-12, jnp.maximum(diag.mu * 1e-4, 1e-12)),
            # data is O(1)-equilibrated: δ beyond ~1e2 only buries the
            # Newton direction, never rescues the factorization
            jnp.minimum(delta * 100.0, 1e2),
        )
        rho1 = jnp.where(
            healthy,
            jnp.clip(rho, 1e-12, jnp.maximum(diag.mu * 1e-6, 1e-12)),
            jnp.maximum(rho, delta1 * 1e-2),
        )
        bad1 = jnp.where(healthy, 0, bad + 1).astype(jnp.int32)
        improved = healthy & (kkt < best_kkt)
        best_x1 = jnp.where(improved, state1.x, best_x)
        best_y1 = jnp.where(improved, state1.y, best_y)
        best_kkt1 = jnp.where(improved, kkt, best_kkt)
        kkt_ref1 = jnp.where(healthy, kkt, kkt_ref)
        stop = (healthy & (kkt <= tol)) | (bad1 >= 3)
        diag1 = jax.tree.map(
            lambda new, old: jnp.where(healthy, new, old), diag, _diag
        )
        return (
            state1, delta1, rho1, attempts + 1,
            committed + healthy.astype(jnp.int32), bad1,
            best_x1, best_y1, best_kkt1, kkt_ref1, diag1, stop,
        )

    zero_diag = IpmDiag(*([jnp.float64(jnp.nan)] * 10))
    init = (
        state, delta, rho, jnp.int32(0), jnp.int32(0), jnp.int32(0),
        state.x, state.y, big, jnp.float64(kkt_ref), zero_diag,
        jnp.bool_(False),
    )
    (state, delta, rho, _attempts, committed, bad,
     best_x, best_y, best_kkt, _kkt_ref, diag, _stop) = jax.lax.while_loop(
        cond, body, init
    )
    return IpmChunkOut(
        state=state, delta=delta, rho=rho, committed=committed, bad=bad,
        best_x=best_x, best_y=best_y, best_kkt=best_kkt, diag=diag,
    )


@functools.partial(jax.jit, static_argnames=("fdt", "n_ir"))
def ls_start(A64, Afac, b, c, lbf, ubf, hl, hu, dmask, xfix, fdt, n_ir):
    """Mehrotra-style least-squares starting point.

    x̃ minimizes ‖x − x_fix‖ s.t. Ax = b (movable coordinates only); ỹ the
    least-squares dual of c.  Both come from ONE factorization of AAᵀ+δI.
    The iterate is then shifted into the interior of the box.
    """
    delta0 = jnp.float64(1e-6)
    L, js = _factor(Afac, dmask.astype(Afac.dtype), delta0, fdt)

    r0 = b - A64 @ xfix
    t, _ = _solve_normal(L, js, A64, dmask, delta0, r0, n_ir)
    xt = xfix + dmask * (t @ A64)
    yt, _ = _solve_normal(
        L, js, A64, dmask, delta0, A64 @ (dmask * c), n_ir
    )
    zt = c - yt @ A64

    # interior shift: margin 1 in Ruiz-scaled space for one-sided bounds;
    # boxed variables clip to the middle half of their box
    w = ubf - lbf
    margin = jnp.minimum(1.0, 0.25 * w)
    both = (hl > 0) & (hu > 0)
    x0 = jnp.where(
        both,
        jnp.clip(xt, lbf + margin, ubf - margin),
        jnp.where(
            hl > 0,
            jnp.maximum(xt, lbf + 1.0),
            jnp.where(hu > 0, jnp.minimum(xt, ubf - 1.0), xt),
        ),
    )
    x0 = jnp.where(dmask > 0, x0, xfix)
    zl0 = hl * (jnp.maximum(zt, 0.0) + 1.0)
    zu0 = hu * (jnp.maximum(-zt, 0.0) + 1.0)
    return IpmState(x0, yt, zl0, zu0)


class IpmInfo(NamedTuple):
    iterations: int
    kkt: float          # max(rp, rd, gap) of the returned point
    converged: bool
    mu: float


def precision_ladder(kind: str, A64, make_a32):
    """The Cholesky precision ladder ``[(dtype, factor matrix, refinement
    steps), ...]`` for ``config.ipm_ladder``: "f64" (also "auto") factors
    in f64 with one refinement step; "mixed" starts on an f32 factor with
    three and escalates to f64 with two (``make_a32()`` builds the f32
    copy of A).  On the H100 the f64 ladder was the faster one (PERF.md,
    bring-up), as it is on the CPU."""
    if kind in ("auto", "f64"):
        return [(jnp.float64, A64, 1)]
    if kind != "mixed":
        raise ValueError(f"ipm_ladder must be auto, f64 or mixed, not {kind!r}")
    return [(jnp.float32, make_a32(), 3), (jnp.float64, A64, 2)]


# Above this many rows a mixed ladder starts on its f64 rung: DFL001-class
# operators NaN the f32 rung from the very start (the f32 GEMM's ~6e-8·√n
# rounding exceeds the start regularization on near-dependent rows).
_F32_RUNG_MAX_M = 4096


def solve_ipm(
    A_dense: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    lb: np.ndarray,
    ub: np.ndarray,
    *,
    tol: float = 1e-8,
    accept: float = 1e-6,
    max_iter: int = 200,
    free_box: float = 1e5,
    ladder: str = "auto",
    log=None,
):
    """Host loop: run Mehrotra iterations until the relative KKT criteria
    reach ``tol`` (or stall above ``accept`` → ``None``).

    ``A_dense`` is the (m_pad, n_pad) scaled dense matrix (host numpy or
    device array).  Returns ``(x, y, IpmInfo)`` in the same scaled space,
    or ``None`` when the method cannot certify (caller falls back).
    """
    import os

    m, n = A_dense.shape
    A64 = jax.device_put(jnp.asarray(A_dense, jnp.float64))
    # precision ladder for the factorization: (fdt, factor matrix, n_ir)
    ladder = precision_ladder(
        ladder, A64,
        lambda: jax.device_put(jnp.asarray(A_dense, jnp.float32)),
    )
    rung = 1 if (len(ladder) > 1 and m > _F32_RUNG_MAX_M) else 0
    fdt, Afac, n_ir = ladder[rung]

    lb = np.asarray(lb, np.float64).copy()
    ub = np.asarray(ub, np.float64).copy()
    fixed = lb == ub
    free = ~np.isfinite(lb) & ~np.isfinite(ub) & ~fixed
    # temporary box for free columns — verified inactive on acceptance
    lb_w = np.where(free, -free_box, lb)
    ub_w = np.where(free, free_box, ub)

    hl = (np.isfinite(lb_w) & ~fixed).astype(np.float64)
    hu = (np.isfinite(ub_w) & ~fixed).astype(np.float64)
    dmask = (~fixed).astype(np.float64)
    lbf = np.where(hl > 0, lb_w, 0.0)
    ubf = np.where(hu > 0, ub_w, 0.0)
    xfix = np.where(fixed, lb, 0.0)
    nb = float(hl.sum() + hu.sum())
    if nb == 0:
        return None

    args = tuple(
        jax.device_put(jnp.asarray(v, jnp.float64))
        for v in (b, c, lbf, ubf, hl, hu, dmask)
    )
    xfix_d = jax.device_put(jnp.asarray(xfix, jnp.float64))

    state = ls_start(A64, Afac, *args, xfix_d, fdt=fdt, n_ir=n_ir)
    while not np.isfinite(float(jnp.max(jnp.abs(state.x)))):
        # a NaN start poisons every later iterate (the health policy
        # keeps the previous state — which IS the NaN start); escalate
        # the factor precision and restart
        if rung + 1 >= len(ladder):
            return None
        rung += 1
        fdt, Afac, n_ir = ladder[rung]
        if log:
            log.info(
                "ipm ls_start NaN — precision ladder → %s",
                np.dtype(fdt).name,
            )
        state = ls_start(A64, Afac, *args, xfix_d, fdt=fdt, n_ir=n_ir)

    delta = 1e-8
    rho = 1e-10
    gamma = 0.9995
    best = None  # (kkt, x, y, mu)
    best_kkt = np.inf
    rung_best = np.inf  # stall reference local to the current rung
    stall = 0
    it = 0
    retries = 0
    def _escalate(reason: str, mu: float | None = None) -> bool:
        nonlocal rung, fdt, Afac, n_ir, rung_best, stall
        if rung + 1 >= len(ladder):
            return False
        rung += 1
        fdt, Afac, n_ir = ladder[rung]
        if log:
            log.info(
                "ipm precision ladder → %s (%s)", np.dtype(fdt).name, reason
            )
        # give the new rung a fresh stall reference: its early chunks
        # must not be judged against a floor-level best the old rung
        # could only *measure*, not hold
        rung_best = np.inf
        stall = 0
        return True

    restarted = False

    def _cold_restart(reason: str) -> bool:
        """One-shot restart from a fresh least-squares start at the TOP
        rung — a state poisoned beyond warm recovery (f32-floor commits
        walked it off the central path) still beats falling back to a
        full simplex solve, and the best-point tracking keeps whatever
        the failed path achieved."""
        nonlocal state, delta, rho, stall, retries, restarted, kkt_ref
        nonlocal rung_best
        if restarted or rung + 1 < len(ladder):
            return False
        restarted = True
        if log:
            log.info("ipm cold restart at top rung (%s)", reason)
        state = ls_start(A64, Afac, *args, xfix_d, fdt=fdt, n_ir=n_ir)
        if not np.isfinite(float(jnp.max(jnp.abs(state.x)))):
            return False
        delta, rho = 1e-8, 1e-10
        stall = 0
        retries = 0
        rung_best = np.inf
        kkt_ref = np.inf
        return True

    # the in-graph chunk already applies the per-iteration health policy
    # (commit/retry, δ/ρ adaptation, best tracking); the host loop only
    # steers the CHUNK-level decisions: the precision ladder, stall
    # detection, cold restart, and termination.  On an accelerator k=8
    # spreads each host round trip over 8 iterations; on the CPU backend
    # there is no round trip to save, and the host steers every iteration.
    on_cpu = jax.default_backend() == "cpu"
    k_chunk = int(
        os.environ.get("RELP_TPU_IPM_CHUNK", "1" if on_cpu else "8")
    )
    kkt_ref = np.inf  # last committed KKT — seeds the relative ir gate
    while it < max_iter:
        out = ipm_chunk(
            A64, Afac, *args, state,
            jnp.float64(delta), jnp.float64(rho), jnp.float64(nb),
            jnp.float64(gamma), jnp.float64(tol), jnp.float64(kkt_ref),
            fdt=fdt, n_ir=n_ir, k_max=k_chunk,
        )
        diag = out.diag
        committed = int(out.committed)
        it += committed
        delta, rho = float(out.delta), float(out.rho)
        chunk_kkt = float(out.best_kkt)
        mu = float(diag.mu)
        kkt = max(float(diag.rp), float(diag.rd), float(diag.gap))
        if log:
            log.info(
                "ipm it=%d mu=%.3e rp=%.2e rd=%.2e gap=%.2e ap=%.2f "
                "ad=%.2f sig=%.2e ir=%.1e best=%.2e",
                it, mu, float(diag.rp), float(diag.rd), float(diag.gap),
                float(diag.alpha_p), float(diag.alpha_d),
                float(diag.sigma), float(diag.ir_err), chunk_kkt,
            )
        if chunk_kkt < best_kkt:
            best_kkt = chunk_kkt
            best = (
                chunk_kkt, np.asarray(out.best_x), np.asarray(out.best_y), mu
            )
        # stall bookkeeping is RUNG-LOCAL: after an escalation the new
        # rung's progress is judged against its own best, not against a
        # floor-level number the old rung briefly measured
        if chunk_kkt < 0.9 * rung_best:
            stall = 0
        elif chunk_kkt >= rung_best:
            stall += committed
        if chunk_kkt < rung_best:
            rung_best = chunk_kkt
        if committed:
            state = out.state
            if np.isfinite(kkt):
                kkt_ref = kkt
        if int(out.bad) >= 3 or committed == 0:
            # the current rung's preconditioner stopped producing usable
            # directions: escalate; at the top rung count hard retries
            retries += 1
            if _escalate(
                f"it={it} unhealthy (mu={mu:.2e} "
                f"ir={float(diag.ir_err):.2e})",
                mu=mu,
            ):
                continue
            if retries > 6:
                if best_kkt > accept and _cold_restart(
                    f"it={it} retries exhausted, best={best_kkt:.2e}"
                ):
                    continue
                break
            continue
        if np.isfinite(kkt) and kkt <= tol:
            break
        if stall >= 4 and _escalate(
            f"it={it} stalled at kkt={best_kkt:.2e}", mu=mu
        ):
            continue
        if stall >= 12:
            if best_kkt > accept and _cold_restart(
                f"it={it} stalled at kkt={best_kkt:.2e}"
            ):
                continue
            break

    if best is None:
        return None
    kkt, x, y, mu = best
    if kkt > accept:
        return None
    if free.any() and np.max(np.abs(x[free])) >= 0.5 * free_box:
        return None  # temporary free-variable box binds: not a certificate
    return x, y, IpmInfo(
        iterations=it, kkt=kkt, converged=kkt <= tol, mu=mu
    )
