"""Solver configuration.

The reference chooses number type, inverse maintainer, basis-inverse backend
and pivot rule as compile-time *type parameters* at the call site (e.g.
``Carry<RationalBig, LUDecomposition<_>>`` in reference ``src/bin/main.rs:52``).
Here the analogue is a frozen (hashable) dataclass whose fields are static
arguments to the jitted solve — each distinct config compiles its own
specialized XLA program, which is the device form of static dispatch.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Tolerances and policies for the float64 revised simplex.

    The reference needs no tolerances (exact rational arithmetic); these
    fields replace exact comparisons, and ``refactor_period`` generalizes the
    reference's refactor-after-10-eta-updates policy
    (``lower_upper/mod.rs:199-202``).
    """

    # Iteration limits. ``max_iter <= 0`` means: choose ``max_iter_factor *
    # (m + n)`` at solve time.
    max_iter: int = 0
    max_iter_factor: int = 40

    # Iterations per device call: long solves are split into bounded
    # executions continued via exact warm starts (simplex/driver.py scales
    # it down with the row count).
    device_chunk_iters: int = 8000

    # Rebuild the basis inverse from scratch every this many pivots.
    refactor_period: int = 64

    # Dual feasibility: reduced costs within [-eps_dual, eps_dual] count as 0.
    eps_dual: float = 1e-7
    # Minimum acceptable pivot magnitude in the ratio test (data is
    # equilibrated to O(1) entries, so this is effectively relative).
    eps_pivot: float = 1e-7
    # Absolute tie tolerance when choosing the leaving row (Bland mode).
    eps_ratio: float = 1e-9
    # Harris ratio test: bound violation allowed in pass 1 while searching
    # for a large pivot (tiny infeasibilities are cleaned up at the next
    # refactorization).
    harris_delta: float = 1e-8
    # Phase-1 infeasibility threshold: artificial mass below this is "zero".
    eps_feas: float = 1e-7
    # Steps smaller than this count as degenerate.
    eps_zero: float = 1e-11
    # A Gauss-Jordan pivot below this at refactorization marks the basis as
    # numerically singular and triggers a basis repair.
    singular_tol: float = 1e-9

    # Basis-inverse maintenance backend (the reference's Carry<F, BI>
    # parameterization, inverse_maintenance/carry/lower_upper/mod.rs:35-391):
    # - "dense": explicit B⁻¹ updated eagerly by one rank-1 outer product per
    #   pivot (reference BasisInverseRows analogue).  O(m²) memory traffic
    #   per pivot — best for small/medium m.
    # - "eta": block product-form — per pivot an O(m) eta vector is composed
    #   into an (m × eta_block) pending block (the reference's EtaFile
    #   algebra, eta_file.rs:14-134, kept in *composed* form so applying it
    #   is one gather + small matmul, not a sequential scan), folded into
    #   B⁻¹ every eta_block pivots by ONE (m,T)@(T,m) matmul.  Cuts
    #   per-pivot memory traffic by ~eta_block× — the large-m backend.
    inverse: str = "dense"
    eta_block: int = 16

    # Refactorize via f32 LU seed + f64 Newton-Schulz refinement (matmul
    # heavy) with Gauss-Jordan as the ill-conditioned fallback; False
    # forces plain Gauss-Jordan.
    newton_refactor: bool = True

    # Above this padded row count the simplex leaves the in-loop form:
    # the host sparse-LU dual runs first, and the device engines run with
    # the refactorization OUT of the jitted while-loop (the loop exits when
    # one is pending; the host runs it as separate device programs,
    # dual_xl_*/primal_xl_*).  On an H100 at m_pad 16384 the external
    # device primal ran 177 pivots/s over a 2000-pivot window, the in-loop
    # one 39 (PERF.md); where between 2048 and 16384 the two cross is not
    # measured.
    refactor_external_m: int = 12288

    # XL simplex engine (m_pad > refactor_external_m): "lu" (default via
    # "auto") = the host sparse-LU dual simplex (simplex/lu_host.py —
    # native FT-LU or scipy splu refactorization + eta product form, the
    # reference's Markowitz-LU counterpart; O(nnz) per pivot where the
    # dense device inverse pays O(m²) memory traffic);
    # "dense" = the round-2 externally-refactorized device DUAL path;
    # "primal" = the externally refactorized device PRIMAL at any size
    # (primal_xl_* in simplex/core.py — no host-LU routing; also forces
    # that path below the threshold, which is how CPU tests exercise it).
    xl_engine: str = "auto"

    # How the periodic refactorization obtains the inverse:
    # - "polish": ONE Newton-Schulz step on the MAINTAINED inverse against
    #   the freshly gathered basis columns (3 m³ matmuls incl. the residual
    #   check) — removes the rank-1/eta drift at ~⅓ the cost of a from-
    #   scratch rebuild; falls back to the full path when the residual
    #   check fails (singular/badly drifted basis, placeholder warm inverse).
    # - "full": always rebuild from scratch (f32 LU + Newton / GJ).
    refactor_mode: str = "polish"

    # Price the column pool in f32 with f64 confirmation of the chosen
    # column and a full-f64 fallback pass near optimality (half the bytes
    # of the pricing scan; not yet measured against f64 on the H100).
    mixed_pricing: bool = True

    # Record a per-iteration metric stream on device (phase, partial
    # objective, artificial mass, reduced cost, step, entering/leaving
    # indices, event bits) into a bounded ring buffer returned with the
    # solve — the structured observability the reference lacks entirely
    # (SURVEY §5) and the basis of the perf-hunt tooling.  Buffer length is
    # trace_capacity (>= one device chunk).
    trace_iters: bool = False
    trace_capacity: int = 8192

    # Every N iterations, recompute the cheap BFS invariants in-loop (row
    # residual of the current point, basic-bound violation) and carry the
    # worst value into the solve output — the float-world analogue of the
    # reference's every-debug-iteration is_in_basic_feasible_solution_state
    # (tableau/mod.rs:253-289, called at phase_one.rs:136).  0 = off.
    check_every_n: int = 0

    # Switch to Bland's rule after this many consecutive degenerate pivots
    # (anti-cycling; the reference relies on Bland tie-breaking plus exact
    # arithmetic, tableau/mod.rs:221-247).
    bland_trigger: int = 100

    # Partial pricing: split the column pool into this many blocks and
    # price only one block per iteration (block-cyclic rotation), falling
    # back to a full scan when the block has no improving candidate — the
    # SURVEY §7 pivot-rule mapping's "partial pricing = block-cyclic
    # masking" (the reference's FirstProfitableWithMemory circular scan,
    # pivot_rule.rs:62-94, is the sequential ancestor).  Requires
    # mixed_pricing; 1 = full pricing.  Termination is unaffected: OPTIMAL
    # is only ever declared off a full f64 pass.
    price_blocks: int = 1

    # Pricing rule: "devex" (approximate steepest edge, Harris 1973 —
    # typically 2-3x fewer iterations), "dantzig" (most negative reduced
    # cost; reference `SteepestDescent`, pivot_rule.rs:97-127) or "bland".
    pricing: str = "devex"

    # Device representation of A: "dense" (padded f64 + f32 shadow — best
    # for small/dense pools where fused matvecs win), "ell" (column-major
    # ELL sparse — O(nnz) gather pricing/FTRAN, unlocks DFL001/STOCFOR3-class
    # sizes where O(m·n) dense work and memory are prohibitive; the analogue
    # of the reference's sparse L1, matrix.rs:23-77), "hybrid" (ELL plus a
    # small dense block for high-fill spill columns — FIT2P-class instances
    # with a few full columns), or "auto" (by size and per-column fill;
    # picks hybrid itself when spill columns exist).
    matrix_format: str = "auto"

    # Main algorithm: "primal" (two-phase primal simplex) or "dual" (dual
    # simplex from scratch: all-artificial basis is trivially DUAL feasible
    # once each nonbasic sits on the bound matching sign(c_j); columns with
    # no suitable finite bound get a temporary box that is verified
    # inactive at optimality).  The dual's exact steepest-edge + BFRT
    # typically needs far fewer iterations on degenerate instances; falls
    # back to the primal on failure.
    # "pdlp" selects the first-order restarted-PDHG engine (fom/pdhg.py):
    # two SpMVs + vector ops per iteration, no basis inverse — the scale
    # path for hyper-sparse XL instances where per-pivot O(m²) dense-
    # inverse work dominates; converges to pdlp_tol relative KKT and
    # falls back to simplex when it cannot certify optimality.
    # "ipm" selects the primal-dual interior-point engine
    # (simplex/primal_dual.py): Mehrotra predictor-corrector whose
    # per-iteration work is ONE dense normal-equation GEMM + Cholesky
    # (O(√n) iterations regardless of
    # degeneracy); shares the PDLP crossover/fallback plumbing.
    algorithm: str = "primal"
    pdlp_tol: float = 1e-8
    pdlp_round: int = 256
    # PDHG can floor above pdlp_tol (DFL001's f64 relative-KKT floor is
    # ~1.2e-7 against the 1e-8 default — measured over 141k iterations).
    # When the best KKT hasn't improved by ≥10% within pdlp_plateau
    # iterations (0 = never), the driver stops and accepts the point iff
    # KKT ≤ pdlp_accept (the crossover/exact-verify path still applies);
    # otherwise it falls back to simplex as usual.
    pdlp_accept: float = 1e-6
    pdlp_plateau: int = 32768
    # restart scheme: "halpern" = reflected Halpern iteration (cuPDLP+
    # accelerant, restarts to T(z)); "avg" = classic PDLP running-average
    # restarts (fom/pdhg.py docstring)
    pdlp_variant: str = "halpern"
    # rescaling before the first-order solve: "ruiz" = 10 ∞-norm Ruiz
    # passes; "ruiz+pc" adds one Pock–Chambolle (α=1) 1-norm pass on top
    # (the cuPDLP recipe)
    pdlp_scale: str = "ruiz+pc"
    # After PDLP certifies its KKT tolerance, warm-start the primal
    # simplex from a basis guess at the first-order point (near-bound
    # variables snapped nonbasic, the m most interior basic) to recover
    # an EXACT vertex optimum — typically a handful of pivots.  Applies
    # when the in-loop primal is available (m_pad ≤ 12288).
    pdlp_crossover: bool = True
    # Iterate precision for the first-order engine.  "auto" = "f64" =
    # everything in f64 (the faster choice on the H100, PERF.md).
    # "mixed" = f32 rounds with f64 KKT verification at chunk boundaries
    # and an f64 endgame once f32 stalls (its fixed-point floor is ~1e-6
    # relative).  Acceptance ALWAYS uses the f64 KKT.
    pdlp_precision: str = "auto"
    # Iterative refinement for the mixed-precision PDLP path: once the f32
    # stage floors, zoom into the RESIDUAL problem (min dᵀe s.t. Ae = r,
    # lb−x ≤ e ≤ ub−x with r = b−Ax, d = c−Aᵀy in f64; rhs/bounds scaled
    # by 1/‖r‖∞ so the f32 iteration works at O(1) magnitudes — the LP
    # iterative-refinement scheme of Gleixner et al., primal zoom) instead
    # of switching to f64 rounds.  The SAME device operator
    # serves every subproblem (only O(n+m) vectors change → no
    # recompilation).  Value = max refinement rounds; 0 disables (the f64
    # endgame path is the fallback either way).
    pdlp_refine: int = 4
    # Fleet solves (solve_general_forms_batched with algorithm="pdlp"):
    # warm-start every scenario from ONE host (scipy HiGHS) solve of
    # scenario 0 — the scenario-analysis workload perturbs a common base,
    # so the fleet only iterates out the perturbation delta.  The base
    # solve's wall is inside the fleet call (timed with it).
    pdlp_fleet_warm: bool = True
    # Interior-point engine (algorithm="ipm") criteria: iterate until the
    # relative KKT (max of primal/dual infeasibility and duality gap)
    # reaches ipm_tol; on stall, accept the best point iff ≤ ipm_accept
    # (the crossover/exact-verify path still applies), else fall back to
    # simplex.  ipm_max_iter bounds the Mehrotra iterations (each is one
    # normal-equation GEMM + Cholesky; 20-60 typical).
    ipm_tol: float = 1e-8
    ipm_accept: float = 1e-6
    # 200 leaves room for the one-shot cold restart at the top rung
    # (decentred f32→f64 handoffs restart from a fresh start point and
    # need ~50 more iterations; healthy instances converge in 20-60)
    ipm_max_iter: int = 200
    # Cholesky precision ladder: "auto" = "f64" = the f64-only rung (the
    # faster choice on the H100 and on the CPU; GREENBEA-class instances
    # also need it: the f32 rung's escape-phase directions walk the iterate
    # into a badly-centered region); "mixed" = the f32→f64 two-rung ladder.
    ipm_ladder: str = "auto"
    # Branch-and-bound variable selection: "pseudo" = pseudo-cost product
    # rule (per-variable average LP-bound degradation per unit fractional
    # distance, learned online; Achterberg); "fractional" = the round-2
    # most-fractional rule.
    mip_branch: str = "pseudo"
    # PDHG device matrix: "auto" = "ell" (row- and column-major ELL
    # twins); "bricks" re-tiles the nonzeros into (8, 128) dense bricks
    # gathered as rows (ops/bricks.py), slower than ELL on the H100
    # (PERF.md).
    pdlp_matrix: str = "auto"
    # temporary-box magnitude for the dual start (data is equilibrated to
    # O(1), so this is effectively absolute in scaled space)
    dual_box: float = 1e7
    # Dual row-pricing weights: "dse" maintains EXACT dual-steepest-edge
    # norms β_i = ‖B⁻¹[i,:]‖² via the Forrest–Goldfarb identity — one extra
    # full B⁻¹ matvec (τ = B⁻¹ρᵀ) per pivot, the only remaining O(m²)
    # matvec per iteration at XL scale.  "devex" replaces the update with
    # the reference-weight approximation γ_i' = max(γ_i, (u_i/p)²γ_r),
    # γ_r' = max(γ_r/p², 1) (Forrest–Goldfarb 1992 "devex" variant) which
    # needs ONLY the FTRAN column u — no τ; the periodic refactorization's
    # _derived_state resets γ to the exact row norms, bounding the
    # approximation drift to one refactor period.
    dual_pricing: str = "dse"
    # BFRT implementation: "sort" materializes the candidates in ratio order
    # (one O(n log n) argsort + gathers per iteration) or "bisect" which
    # finds the blocking ratio t* = min{t : Σ_{ratio≤t} cap ≥ viol_r} by ~60 scalar bisection steps of masked
    # O(n) reductions — same selected pivot up to ties, no sort.
    dual_ratio: str = "bisect"

    # Anti-degeneracy bound perturbation (relative magnitude; 0 = off).
    # Finite non-fixed bounds are expanded by deterministic pseudo-random
    # amounts in [0.5, 1]·perturb·(1+|bound|) before the solve, breaking the
    # massive primal-degeneracy ties that stall instances like DFL001/QAP;
    # the driver then re-solves with the TRUE bounds warm-started from the
    # perturbed optimum — the SAME compiled program, typically a handful of
    # cleanup iterations.
    perturb: float = 0.0

    # Shard the column pool of a SINGLE solve over this many devices along
    # the mesh's 'cols' axis (pricing-parallel; XLA/GSPMD inserts the
    # cross-chip argmax/gather collectives).  1 = single device, -1 = all
    # visible devices.  The padded column count must divide by it (the
    # col_align=128 buckets divide by any power of two ≤ 128).
    mesh_cols: int = 1

    # Apply geometric-mean equilibration scaling before solving.
    scale: bool = True

    # Run the presolve framework before lowering to computational form.
    presolve: bool = True

    # Start from a slack crash basis (reference PartialInitialBasis):
    # rows whose slack can feasibly carry the initial residual skip phase 1.
    # Off by default: with devex pricing the effect is problem-dependent
    # (helps ADLITTLE, slows SHARE1B/25FV47 slightly).
    crash_basis: bool = False

    # Pad row/column counts up to multiples of these (jit-cache bucketing;
    # the values are not measured on a GPU yet).
    row_align: int = 8
    col_align: int = 128
    # Pad shapes to powers of two (floors row_align*8 / col_align*2) so many
    # problems share one compiled program; each distinct shape costs a full
    # XLA compile.
    bucket_shapes: bool = True

    def resolve_max_iter(self, m: int, n: int) -> int:
        if self.max_iter > 0:
            return self.max_iter
        return max(1000, self.max_iter_factor * (m + n))


DEFAULT_CONFIG = SolverConfig()
