"""Levenberg-Marquardt driver with reference-parity control flow.

Host-driven outer loop calling jitted kernels (linearize / solve / cost /
retract), mirroring reference lib/small_thing/Optimizer.cpp:768-1106 exactly:

  - damping schedule: init 1e-5, x2.5 on fail, x0.7 on good, x1.5 on average,
    abort above 1e8 (Settings, Optimizer.h:40-91)
  - model-cost-reduction sanity retry (Optimizer.cpp:835-854)
  - step-factor retries with gradient-interpolated shrink factor and optional
    "sub-step" re-solve reusing the factorization (Optimizer.cpp:907-1011)
  - failure-rate policy: new invalid rate < 3% and < 2*prev + 50
    (Optimizer.cpp:888-891)
  - comparable-cost caching for factors with optional errors (Factor.h:391-417)
  - dontRetryFailed freezing of failing factors after a failed retry
    (Optimizer.cpp:1002-1007)
  - troubled-sequence accounting and the tolerance-held-for-N-iterations stop
    (Optimizer.cpp:1032-1096)

The linear solve is the Schur-reduced PCG of engine.py; solver "direct" mode
is PCG run to tight tolerance with a high iteration cap (the accelerator
equivalent of the reference's small-problem supernodal Cholesky).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from . import engine
from .structure import Masks, VariableTables, retract, step_to_var_ratios, t_dot, t_scale


@dataclasses.dataclass
class LMSettings:
    """Reference lib/small_thing/Optimizer.h:40-91 defaults."""

    max_iterations: int = 50
    pcg_max_iterations: int = 40
    pcg_tol: float = 1e-10
    direct_mode: bool = True  # small problems: PCG to tight tolerance
    direct_pcg_iterations: int = 500
    # preconditioner family: gauss_seidel | jacobi | lower_prec | identity
    # (reference Preconditioner.h; solver auto-pick in pick_solver below)
    preconditioner: str = "gauss_seidel"

    absolute_cost_tolerance: float = 1e-8
    relative_cost_tolerance: float = 1e-10
    variables_tolerance: float = 1e-5

    stop_if_no_improvement_for: int = 3
    distance_from_troubled_iteration: int = 3
    damping: float = 1e-5
    damping_adjust_on_fail: float = 2.5
    damping_adjust_on_good_step: float = 0.7
    damping_adjust_on_average_step: float = 1.5
    damping_max: float = 1e8
    damping_min: float = 1e-9

    min_relative_cost_reduction: float = 0.3
    step_factor_decrease: float = 0.3
    max_step_factor_attempts: int = 2
    try_sub_step: bool = True
    min_step_factor_for_good: float = 0.7

    log: Optional[Callable[[str], None]] = None
    pre_step_callback: Optional[Callable[[int, "Problem"], None]] = None
    # called at the end of every iteration with a monitoring dict (the GUI
    # publication point, main_AriaKit_ViBa_GUI.cpp:104-130); see
    # utils/monitoring.Monitor.make_callback
    iteration_callback: Optional[Callable[[dict], None]] = None


@dataclasses.dataclass
class Summary:
    initial_cost: float = 0.0
    final_cost: float = 0.0
    num_troubled_seqs: int = 0
    largest_troubled_seq: int = 0
    num_iterations: int = 0
    iteration_times: list = dataclasses.field(default_factory=list)
    carry_iterations: int = 0  # iterations served by the carry program


class Problem:
    """A factor graph: variable tables + masks + factor batches.

    The device-facing analog of reference SingleSessionProblem + Optimizer
    ownership of stores (Optimizer.h:332-335). Batches with zero factors are
    dropped at finalize time so all jitted shapes are non-degenerate.
    """

    def __init__(self, variables: VariableTables, masks: Masks):
        self.variables = variables
        self.masks = masks
        self.cfgs: list = []
        self.datas: list = []
        self._jits = None
        self._k_iter = None
        self._k_carry = None

    def add_batch(self, cfg, data):
        import numpy as np

        n = 0
        for a in data.values():
            if hasattr(a, "shape") and getattr(a, "ndim", 0) >= 1:
                n = a.shape[0]
                break
        if n == 0:
            return
        self.cfgs.append(cfg)
        self.datas.append(data)
        self._jits = None
        self._k_iter = None
        self._k_carry = None

    # -- jitted kernels (built once per batch structure) --------------------

    def _build(self):
        if self._jits is not None:
            return self._jits
        import dataclasses as _dc

        import numpy as _np

        from . import factors as _fct
        from . import rcs as _rcs

        if getattr(self, "mesh", None) is not None:
            # tile-sharded blocked engine over the device mesh
            from ..parallel.sharding import build_sharded_kernels

            self._k_iter = None
            self._k_carry = None
            self._jits = build_sharded_kernels(self)
            return self._jits

        # blocked layout for large visual batches (rcs.finalize_blocks);
        # skipped under mesh sharding (the factor axis shards instead)
        if (getattr(self, "use_blocked_engine", True)
                and getattr(self, "use_transpose_plans", True)
                and not getattr(self, "_blocked_done", False)):
            self._blocked_done = True
            _rcs.finalize_blocks(self)

        # statically drop tangents of fully-constant groups (masks all zero)
        group_active = {
            g: bool(_np.asarray(getattr(self.masks, g)).any())
            for g in _fct.GROUP_DIMS
            if g != _fct.POINTS
        }
        group_active[_fct.POINTS] = bool(_np.asarray(self.masks.points).any())
        # ELL transpose plans (gather-sum scatters); skipped under sharding
        if getattr(self, "use_transpose_plans", True):
            rows = {
                _fct.RIG: self.variables.pose_q.shape[0],
                _fct.POINTS: self.variables.points.shape[0],
                _fct.CAM_INTR: self.variables.cam_intr.shape[0],
                _fct.CAM_EXTR: self.variables.cam_extr_q.shape[0],
                _fct.IMU_CALIB: self.variables.imu_calib.shape[0],
                _fct.IMU_EXTR: self.variables.imu_extr_q.shape[0],
                _fct.DET_BIAS: self.variables.det_bias.shape[0],
                _fct.GRAVITY: 1,
            }
            _fct.build_transpose_plans(self.cfgs, self.datas, rows)
        cfgs = tuple(
            _dc.replace(
                cfg,
                active_groups=tuple(
                    g
                    for g, _ in _fct.REGISTRY[cfg.kind]["tangents"]
                    if group_active[g]
                ),
            )
            for cfg in self.cfgs
        )

        blocked = any(getattr(c, "block_info", None) for c in cfgs)
        resolve_impl = _rcs.solve_with_system if blocked else engine.solve_with_system

        # linearize + lambda-independent assembly fused into ONE dispatch
        # (the host loop pays a dispatch and a sync per jit call); the assembly
        # is still split from the per-lambda solve so damping retries reuse
        # it (reference keeps grad/Hess fixed and refactors with new damping,
        # Optimizer.cpp:826-854)
        @jax.jit
        def k_lin_assemble(datas, v, masks, alive):
            lg = engine.linearize(cfgs, datas, v, masks, alive)
            if blocked:
                return lg, _rcs.assemble(cfgs, datas, lg, v, masks)
            return lg, jnp.zeros(())  # generic path assembles inside k_solve

        def k_linearize(datas, v, masks, alive):
            lg, asm = k_lin_assemble(datas, v, masks, alive)
            self._last_asm = asm
            return lg

        def k_assemble(datas, lg, v, masks):
            return self._last_asm

        @partial(jax.jit, static_argnames=("max_iters", "precond"))
        def k_solve(asm, datas, lg, v, masks, lam, max_iters, rel_tol,
                    precond="gauss_seidel"):
            if blocked:
                return _rcs.solve_assembled(asm, v, masks, lam, max_iters,
                                            rel_tol, precond)
            return engine.solve_step(cfgs, datas, lg, v, masks, lam, max_iters,
                                     rel_tol, precond=precond)

        @partial(jax.jit, static_argnames=("max_iters",))
        def k_resolve(lg, v, rs, g_r, g_l, max_iters, rel_tol):
            return resolve_impl(lg, v, rs, g_r, g_l, max_iters, rel_tol)

        @jax.jit
        def k_cost(datas, v, lg):
            return engine.comparable_cost(cfgs, datas, v, lg)

        @jax.jit
        def k_grad(datas, v, masks):
            return engine.gradient_tangent(cfgs, datas, v, masks)

        @jax.jit
        def k_retract(v, t, tp, masks, scale):
            t2 = t_scale(t, scale)
            v2 = retract(v, t2, tp * scale, masks)
            ratios = step_to_var_ratios(v, t2, tp * scale)
            return v2, ratios

        # fused happy-path LM attempt: solve + retract + comparable cost +
        # norms in ONE dispatch — the host loop otherwise pays a dispatch
        # per kernel call and a device sync per float() scalar read
        def _attempt(asm, datas, lg, v, masks, lam, max_iters, rel_tol,
                     precond):
            if blocked:
                out = _rcs.solve_assembled(asm, v, masks, lam, max_iters,
                                           rel_tol, precond)
            else:
                out = engine.solve_step(cfgs, datas, lg, v, masks, lam,
                                        max_iters, rel_tol, precond=precond)
            x_r, x_l, model_red, pcg_rel, pcg_it, rs, (g_r, g_l) = out
            step_r, step_l = t_scale(x_r, -1.0), -x_l
            v_new = retract(v, step_r, step_l, masks)
            ratios = step_to_var_ratios(v, step_r, step_l)
            stats = engine.comparable_cost(cfgs, datas, v_new, lg)
            grad_norm = jnp.sqrt(t_dot(g_r, g_r) + jnp.vdot(g_l, g_l))
            step_norm = jnp.sqrt(t_dot(step_r, step_r) + jnp.vdot(step_l, step_l))
            return (x_r, x_l, model_red, pcg_rel, pcg_it, rs, (g_r, g_l),
                    v_new, ratios, stats, grad_norm, step_norm)

        @partial(jax.jit, static_argnames=("max_iters", "precond"))
        def k_step(asm, datas, lg, v, masks, lam, max_iters, rel_tol,
                   precond="gauss_seidel"):
            return _attempt(asm, datas, lg, v, masks, lam, max_iters,
                            rel_tol, precond)

        # the whole LM iteration — linearize + assemble + attempt — in ONE
        # jit call: one dispatch and one sync per iteration instead of two
        @partial(jax.jit, static_argnames=("max_iters", "precond"))
        def k_iter_jit(datas, v, masks, alive, lam, max_iters, rel_tol,
                       precond="gauss_seidel"):
            lg = engine.linearize(cfgs, datas, v, masks, alive)
            asm = (_rcs.assemble(cfgs, datas, lg, v, masks) if blocked
                   else jnp.zeros(()))
            return lg, asm, _attempt(asm, datas, lg, v, masks, lam,
                                     max_iters, rel_tol, precond)

        def k_iter(datas, v, masks, alive, lam, max_iters, rel_tol,
                   precond="gauss_seidel"):
            lg, asm, out = k_iter_jit(datas, v, masks, alive, lam,
                                      max_iters, rel_tol, precond)
            self._last_asm = asm
            return lg, asm, out

        # carry iteration: the λ-independent assembly (RcsAsm) and the
        # linearization both survive across host iterations — an accepted
        # step carries (lg_next, asm_next) computed here at v_new, a
        # rejected one re-passes (lg, asm) unchanged (the reference keeps
        # grad/Hess fixed across damping retries, Optimizer.cpp:826-854).
        # comparable_cost's res-only kernel pass is replaced by pure
        # bookkeeping over the two linearizations' stored costs
        # (engine.comparable_from_linearized), so the only per-factor work
        # per iteration is ONE linearize + assemble + solve. alive is not
        # threaded here: once dontRetryFailed engages, optimize() drops back
        # to the k_iter path, whose comparable_cost carries the alive
        # semantics exactly.
        @partial(jax.jit, static_argnames=("max_iters", "precond"))
        def k_carry_jit(datas, lg, asm, v, masks, lam, max_iters, rel_tol,
                        precond="gauss_seidel"):
            if blocked:
                out = _rcs.solve_assembled(asm, v, masks, lam, max_iters,
                                           rel_tol, precond)
            else:
                out = engine.solve_step(cfgs, datas, lg, v, masks, lam,
                                        max_iters, rel_tol, precond=precond)
            x_r, x_l, model_red, pcg_rel, pcg_it, rs, (g_r, g_l) = out
            step_r, step_l = t_scale(x_r, -1.0), -x_l
            v_new = retract(v, step_r, step_l, masks)
            ratios = step_to_var_ratios(v, step_r, step_l)
            lg_next = engine.linearize(cfgs, datas, v_new, masks, None)
            asm_next = (_rcs.assemble(cfgs, datas, lg_next, v_new, masks)
                        if blocked else jnp.zeros(()))
            stats = engine.comparable_from_linearized(cfgs, lg, lg_next)
            grad_norm = jnp.sqrt(t_dot(g_r, g_r) + jnp.vdot(g_l, g_l))
            step_norm = jnp.sqrt(t_dot(step_r, step_r)
                                 + jnp.vdot(step_l, step_l))
            return ((x_r, x_l, model_red, pcg_rel, pcg_it, rs, (g_r, g_l),
                     v_new, ratios, stats, grad_norm, step_norm),
                    lg_next, asm_next)

        def k_carry(datas, lg, asm, v, masks, lam, max_iters, rel_tol,
                    precond="gauss_seidel"):
            out, lg_next, asm_next = k_carry_jit(
                datas, lg, asm, v, masks, lam, max_iters, rel_tol, precond)
            self._last_asm = asm
            return out, lg_next, asm_next

        self._k_carry = k_carry
        self._k_iter = k_iter
        self._jits = (k_linearize, k_solve, k_resolve, k_cost, k_grad, k_retract,
                      k_assemble, k_step)
        return self._jits

    def initial_alive(self):
        from . import factors as _fct

        return tuple(
            jnp.ones(_fct._batch_size(d), self.variables.points.dtype) for d in self.datas
        )


def optimize(problem: Problem, settings: LMSettings) -> Summary:
    (k_lin, k_solve, k_resolve, k_cost, k_grad, k_retract,
     k_assemble, k_step) = problem._build()
    log = settings.log or (lambda s: None)
    datas = tuple(problem.datas)
    masks = problem.masks
    v = problem.variables
    alive = problem.initial_alive()

    damping = settings.damping
    pcg_iters = (
        settings.direct_pcg_iterations if settings.direct_mode else settings.pcg_max_iterations
    )

    summary = Summary()
    iteration = 0
    last_improvement_iteration = 0
    last_troubled_iteration = -10
    troubled_seq_start_damping = damping
    troubled_seq_start = 0
    dont_retry_failed = False
    initial_cost = None
    final_cost = None

    carry = None  # (lg, asm) at the current v, produced by a k_carry call

    while True:
        t_it = time.time()
        if settings.pre_step_callback is not None:
            settings.pre_step_callback(iteration, problem)
            datas = tuple(problem.datas)
            carry = None  # the callback may mutate factor data in place

        # carry path: reuse the linearization+assembly carried from the
        # previous iteration (accepted step: computed at v_new inside
        # k_carry; rejected step: unchanged — the reference equally keeps
        # grad/Hess across damping retries, Optimizer.cpp:826-854). Once
        # dontRetryFailed engages, fall back to the k_iter path whose
        # comparable_cost threads the alive mask exactly.
        k_carry = getattr(problem, "_k_carry", None)
        use_carry = k_carry is not None and not dont_retry_failed
        lg_next = asm_next = None
        v_new_from_carry = False
        if use_carry:
            summary.carry_iterations += 1
            if carry is None:
                lg = k_lin(datas, v, masks, None)
                asm = k_assemble(datas, lg, v, masks)
            else:
                lg, asm = carry
            out0, lg_next, asm_next = k_carry(
                datas, lg, asm, v, masks, jnp.asarray(damping),
                pcg_iters, settings.pcg_tol, settings.preconditioner)
            v_new_from_carry = True
        else:
            k_iter = getattr(problem, "_k_iter", None)
            if k_iter is not None:
                # whole iteration in ONE jit call
                lg, asm, out0 = k_iter(
                    datas, v, masks, alive if dont_retry_failed else None,
                    jnp.asarray(damping), pcg_iters, settings.pcg_tol,
                    settings.preconditioner)
            else:
                lg = k_lin(datas, v, masks,
                           alive if dont_retry_failed else None)
                asm = k_assemble(datas, lg, v, masks)
                out0 = None
        if dont_retry_failed:
            alive = lg.valid0

        # fused solve + retract + cost, with model-cost sanity retry
        # (Optimizer.cpp:835-854; on the rare model_red < 0 the retract/cost
        # computed alongside are discarded). ONE host sync fetches every
        # scalar of the attempt.
        while True:
            if out0 is None:
                if use_carry:
                    out0, lg_next, asm_next = k_carry(
                        datas, lg, asm, v, masks, jnp.asarray(damping),
                        pcg_iters, settings.pcg_tol, settings.preconditioner)
                    v_new_from_carry = True
                else:
                    out0 = k_step(
                        asm, datas, lg, v, masks, jnp.asarray(damping),
                        pcg_iters, settings.pcg_tol, settings.preconditioner,
                    )
            (x_r, x_l, model_red, pcg_rel, pcg_it, rs, (g_r, g_l), v_new,
             (ratio_inf, ratio_2), stats, grad_norm, step_norm) = out0
            out0 = None
            (prev_cost, model_red, pcg_rel_f, pcg_it_f, new_cost, grad_norm,
             step_norm, ratio_inf, ratio_2, s_inv, s_pinv, s_tot) = (
                float(x) for x in jax.device_get(
                    (lg.cost, model_red, pcg_rel, pcg_it, stats.cost,
                     grad_norm, step_norm, ratio_inf, ratio_2,
                     stats.num_invalid, stats.num_prev_invalid,
                     stats.num_total)))
            pcg_rel, pcg_it = pcg_rel_f, pcg_it_f
            stats = engine.CostStats(new_cost, s_inv, s_pinv, s_tot)
            if model_red >= 0:
                break
            damping *= settings.damping_adjust_on_fail
            log(f" ?:# quadratic model failing numerically, retrying... (damping: {damping:g})")
            if damping > settings.damping_max:
                break
        if initial_cost is None:
            initial_cost = prev_cost
        if final_cost is None:
            final_cost = prev_cost
        if model_red < 0:
            log("damping out of range, quadratic model failing?!")
            break

        # step = -H^-1 g
        step_r, step_l = t_scale(x_r, -1.0), -x_l
        cost_reduction = prev_cost - new_cost
        ratio_reduction_to_cost = cost_reduction / new_cost if new_cost else 0.0
        ratio_reduction_to_expected = cost_reduction / model_red if model_red else 0.0
        applied_step_factor = 1.0

        def failure_rate_ok(st):
            inv = float(st.num_invalid)
            prev_inv = float(st.num_prev_invalid)
            tot = float(st.num_total)
            return (inv / (tot + 1.0) < 0.03) and (inv < prev_inv * 2.0 + 50)

        failure_ok = failure_rate_ok(stats)

        # step-factor retries (Optimizer.cpp:907-1011)
        if settings.max_step_factor_attempts > 0 and (
            ratio_reduction_to_expected < settings.min_relative_cost_reduction or not failure_ok
        ):
            g_new_r, g_new_l = k_grad(datas, v_new, masks)
            back_red = -0.5 * float(t_dot(g_new_r, step_r) + jnp.vdot(g_new_l, step_l))
            step_factor = (
                model_red / (model_red + back_red)
                if back_red > 0
                else settings.step_factor_decrease
            )
            for _ in range(settings.max_step_factor_attempts):
                applied_step_factor *= step_factor
                v_new_from_carry = False  # carried lg_next is for the unscaled step
                v_new, (ratio_inf, ratio_2) = k_retract(
                    v, step_r, step_l, masks, jnp.asarray(applied_step_factor)
                )
                stats_f = k_cost(datas, v_new, lg)
                new_cost_f = float(stats_f.cost)
                red_f = prev_cost - new_cost_f
                rel_f = red_f / (model_red * applied_step_factor) if model_red else 0.0
                if rel_f >= settings.min_relative_cost_reduction and failure_rate_ok(stats_f):
                    new_cost, stats = new_cost_f, stats_f
                    cost_reduction = red_f
                    ratio_reduction_to_expected = rel_f
                    failure_ok = True
                    log(f" \\!/ cost reduction obtained applying factor {applied_step_factor:.2f}")
                    break

                if settings.try_sub_step:
                    g2_r, g2_l = k_grad(datas, v_new, masks)
                    s2_r, s2_l = k_resolve(lg, v, rs, g2_r, g2_l, pcg_iters, settings.pcg_tol)
                    v_sub, _ = k_retract(v_new, t_scale(s2_r, -1.0), -s2_l, masks, jnp.asarray(1.0))
                    stats_s = k_cost(datas, v_sub, lg)
                    new_cost_s = float(stats_s.cost)
                    red_s = prev_cost - new_cost_s
                    rel_s = red_s / (model_red * applied_step_factor) if model_red else 0.0
                    if rel_s >= settings.min_relative_cost_reduction and failure_rate_ok(stats_s):
                        v_new = v_sub
                        new_cost, stats = new_cost_s, stats_s
                        cost_reduction = red_s
                        ratio_reduction_to_expected = rel_s
                        failure_ok = True
                        log(
                            f" \\!/ cost reduction obtained applying factor "
                            f"{applied_step_factor:.2f} + sub-step"
                        )
                        break

                if not dont_retry_failed:
                    dont_retry_failed = True
                    log(" \\!/ failing factors will no longer be retried!")
                step_factor = settings.step_factor_decrease

        tolerance_hit = None
        if ratio_reduction_to_cost < settings.relative_cost_tolerance:
            tolerance_hit = "relative cost"
        elif cost_reduction < settings.absolute_cost_tolerance:
            tolerance_hit = "absolute cost"
        elif float(ratio_2) < settings.variables_tolerance:
            tolerance_hit = "variable"

        if new_cost > prev_cost or not failure_ok:  # failure
            if last_troubled_iteration != iteration - 1:
                troubled_seq_start_damping = damping
                troubled_seq_start = iteration
            smiley = ":'("
            damping *= settings.damping_adjust_on_fail
            # v unchanged (functional restore); lg/asm stay valid at v
            carry = (lg, asm) if use_carry else None
            if damping > settings.damping_max:
                log("damping out of range, quadratic model failing?!")
                iteration += 1
                break
            last_troubled_iteration = iteration
        else:
            if last_troubled_iteration == iteration - 1:
                if troubled_seq_start_damping < 1e1 and damping > 1e-3:
                    summary.num_troubled_seqs += 1
                    summary.largest_troubled_seq = max(
                        summary.largest_troubled_seq, iteration - troubled_seq_start
                    )
            if (
                ratio_reduction_to_expected >= settings.min_relative_cost_reduction
                and applied_step_factor > settings.min_step_factor_for_good
            ):
                smiley = ";-|" if tolerance_hit else ":-)"
                damping = max(
                    damping * settings.damping_adjust_on_good_step, settings.damping_min
                )
            else:
                smiley = ":-/"
                damping *= settings.damping_adjust_on_average_step
            v = v_new
            final_cost = new_cost
            # accepted unscaled step: (lg_next, asm_next) were linearized at
            # exactly this v inside k_carry — next iteration skips linearize
            carry = ((lg_next, asm_next)
                     if (v_new_from_carry and lg_next is not None) else None)

        iteration += 1
        dt = time.time() - t_it
        summary.iteration_times.append(dt)
        if settings.iteration_callback is not None:
            settings.iteration_callback(dict(
                iteration=iteration,
                cost=new_cost if new_cost <= prev_cost else prev_cost,
                prev_cost=prev_cost,
                damping=damping,
                accepted=new_cost <= prev_cost and failure_ok,
                model_cost_reduction=model_red,
                applied_step_factor=applied_step_factor,
                pcg_iters=int(pcg_it),
                pcg_rel_residual=float(pcg_rel),
                grad_norm=grad_norm,
                step_norm=step_norm,
                num_failing=int(stats.num_invalid),
                num_failing_prev=int(stats.num_prev_invalid),
                num_optional_total=int(stats.num_total),
                iter_time_sec=dt,
            ))
        log(
            f" {smiley} cost: {prev_cost:.6g} -> {new_cost:.6g} "
            f"({(new_cost / prev_cost - 1.0) * 100:.2f}%), t: {dt:.3f}s\n"
            f"     n.{iteration}; pcg: {int(pcg_it)} iters, rel {float(pcg_rel):.2e}\n"
            f"     lmbd: {damping:.3g}, relRed: {ratio_reduction_to_expected * 100:.1f}%, "
            f"improv: {cost_reduction:.6g}, modelImprov: {model_red:.6g}\n"
            f"    |G|: {grad_norm:.4g}, |S|: {step_norm:.4g}, "
            f"|s/v|_inf: {float(ratio_inf):.3g}, |_2: {float(ratio_2):.3g}\n"
            f"    Failing factors: {int(stats.num_prev_invalid)} -> {int(stats.num_invalid)}"
            f" / {int(stats.num_total)}"
        )

        if not tolerance_hit:
            last_improvement_iteration = iteration
        if (
            iteration >= last_improvement_iteration + settings.stop_if_no_improvement_for
            and iteration >= last_troubled_iteration + settings.distance_from_troubled_iteration
        ):
            log(
                f" >_< converged! (hit {tolerance_hit} tolerance, for "
                f"{settings.stop_if_no_improvement_for} iterations)"
            )
            break
        if iteration >= settings.max_iterations:
            log(f" X-| iteration limit reached! ({settings.max_iterations} iterations)")
            break

    problem.variables = v
    summary.initial_cost = initial_cost or 0.0
    summary.final_cost = final_cost if final_cost is not None else (initial_cost or 0.0)
    summary.num_iterations = iteration
    return summary


# reference viba/common/Settings.cpp:296-320 + Constants.h:15: the direct
# solver is used below 20000 rigs, Gauss-Seidel-preconditioned PCG above
PCG_NUM_RIGS_THRESHOLD = 20_000


def pick_solver(settings: LMSettings, num_rigs: int, solver_type: str = "auto") -> LMSettings:
    """Resolve the CLI solver choice (auto/direct/gauss-seidel/jacobi/identity/
    lower-prec) into LMSettings, mirroring pickSolverType."""
    st = solver_type.replace("-", "_")
    if st == "auto":
        st = "direct" if num_rigs < PCG_NUM_RIGS_THRESHOLD else "gauss_seidel"
    if st == "direct":
        settings.direct_mode = True
        settings.preconditioner = "gauss_seidel"
    else:
        settings.direct_mode = False
        settings.preconditioner = st
    return settings
