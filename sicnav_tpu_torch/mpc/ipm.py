"""Primal-dual interior-point NLP solver (twin of ``sicnav_tpu/mpc/ipm.py``).

A Newton-KKT interior-point method with slacked inequalities, adaptive mu,
Levenberg damping and a fraction-to-boundary line search, for

    min f(z)  s.t.  c_E(z) = 0,  c_I(z) <= 0.

The reference's derivatives become ``torch.func``'s, in reverse mode:
``jax.grad`` -> ``grad_and_value``, the constraint Jacobian ``jax.jacfwd``
-> ``jacrev``, the Lagrangian Hessian ``jax.hessian`` (forward over
reverse) -> ``jacrev(jacrev)``. They are the same derivatives up to
rounding; reverse mode is the one torch runs fast here: its forward mode
takes elementwise ops through Python reference decompositions (torch
2.13), three times slower on this problem, and gives a 0-d tensor times a
Python float a float64 tangent. The (n + m_eq) KKT block is factored once
per iteration with ``torch.linalg.lu_factor_ex`` and solved with
``lu_solve``. The line
search's seven trial steps are one ``torch.func.vmap`` evaluation.

The reference's fixed-trip ``lax.scan`` and early-exit ``lax.while_loop``
are one host loop here. Every branch inside an iteration is a
``torch.where``, so no iteration waits on the device: an early exit freezes
the iterate (as the while loop stops changing it) and counts the
iterations it ran, and the loop runs its full trip count. A per-episode
iteration budget (a tensor ``n_iter_dyn`` under ``torch.func.vmap``) works
the same way: the loop runs the static bound the caller names and an
episode's iterate is frozen once its budget is spent, as the reference's
while loop under ``jax.vmap`` runs until the last episode's budget is spent
with the others frozen.

With ``utils.tracing`` on, a solve records an ``ipm.precond`` span and, per
iteration, ``ipm.grad``, ``ipm.jac``, ``ipm.hess``, ``ipm.kkt`` (from the
barrier parameter through the LU to the step limits) and ``ipm.search``
(the merits, the trial steps, the second-order correction and the update).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.func import grad_and_value, jacrev, vmap

from sicnav_tpu_torch.utils import cuda_graph, tracing


@dataclasses.dataclass(frozen=True)
class IPMSettings:
    """The reference's settings, field for field. Why each default is what
    it is (the early-exit tolerances, the preconditioning of the 1e6-range
    slack curvature, the best-feasible fallback) is documented at
    ``sicnav_tpu.mpc.ipm.IPMSettings``."""
    n_iter: int = 30
    mu_init: float = 1e-1
    mu_min: float = 1e-9
    sigma: float = 0.2          # centering: mu <- sigma * s.T lam / m
    mu_schedule: str = "adaptive"   # "adaptive" | "geometric"
    tau: float = 0.995          # fraction-to-boundary
    s_min: float = 1e-8
    lam_init: float = 0.1
    delta_init: float = 1e-4    # LM damping
    delta_max: float = 1e4
    delta_min: float = 1e-8
    reg_eq: float = 1e-8        # dual regularization of the eq block
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003)
    soc: bool = False           # second-order correction
    early_exit_tol: float = 0.0
    early_exit_comp_tol: float = 1e-3
    exact_hessian: bool = True
    precondition: bool = True
    keep_best_feasible: bool = False
    feas_tol: float = 1e-3


def realtime_settings(num_hums: int, with_mid: bool = False,
                      base: IPMSettings = None) -> IPMSettings:
    """Per-crowd-size iteration caps, mirroring the reference's real-time
    tuning: smaller crowds afford more solver iterations per control
    period. The with-MID table equals the plain one, as in the reference."""
    if base is None:
        base = IPMSettings()
    table = {1: 24, 2: 20, 3: 15}
    return dataclasses.replace(base, n_iter=table.get(num_hums, 12))


@contextlib.contextmanager
def batched_lu_threads(device):
    """On the CPU, one intra-op thread while the block runs. torch's CPU
    LU of a batch of matrices over ~128 rows (LAPACK getrf in a parallel
    loop over the batch) prints DLASWP parameter errors and never returns
    when it runs on more than one thread (torch 2.13); the vmapped IPM
    factors B KKT matrices of ~300 rows at once. CUDA is untouched."""
    if torch.device(device).type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def cusolver_lu(device):
    """On CUDA, torch.linalg's LU takes the route of its cuSOLVER backend
    while the block runs: for the batched controller's ten 317 x 317 KKT
    matrices that is cuBLAS's batched getrf and getrs, whose workspace
    comes from torch's allocator. The default route there (MAGMA's batched
    LU) allocates its own workspace with cudaMalloc and cudaFree at every
    factorization, which a CUDA graph cannot hold. The CPU is untouched."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


class IPMState(NamedTuple):
    z: torch.Tensor
    y: torch.Tensor       # eq multipliers
    lam: torch.Tensor     # ineq multipliers  (> 0)
    s: torch.Tensor       # ineq slacks       (> 0)
    delta: torch.Tensor   # LM damping
    merit: torch.Tensor


class IPMInfo(NamedTuple):
    obj: torch.Tensor
    eq_viol: torch.Tensor     # max |c_E|
    ineq_viol: torch.Tensor   # max(0, c_I) max
    comp: torch.Tensor        # mean s*lam
    iters: torch.Tensor       # iterations actually run (int32)


def _amax0(x):
    """``jnp.max(x, initial=0.0)``."""
    if x.numel() == 0:
        return x.new_zeros(())
    return torch.clamp(torch.amax(x), min=0.0)


def _merit(f_val, c_e, c_i, s, mu, nu):
    barrier = -mu * torch.sum(torch.log(torch.clamp(s, min=1e-20)),
                              dim=-1)
    infeas = torch.sum(torch.abs(c_e), dim=-1) + \
        torch.sum(torch.abs(c_i + s), dim=-1)
    return f_val + barrier + nu * infeas


def _step_limit(v, dv, tau):
    """Largest alpha in [0, 1] keeping v + alpha dv >= (1 - tau) v."""
    neg = dv < 0
    a = torch.amin(torch.where(neg, -tau * v / torch.where(neg, dv, -1.0),
                               1.0))
    return torch.clamp(a, 0.0, 1.0)


def _full(value: float, dtype, device):
    """A 0-d tensor of ``value``, filled on the device."""
    return torch.full((), value, dtype=dtype, device=device)


def _all_finite(*xs):
    ok = torch.ones((), dtype=torch.bool, device=xs[0].device)
    for x in xs:
        ok = ok & torch.isfinite(x).all()
    return ok


def solve(f_fn: Callable, c_fn: Callable, z0: torch.Tensor,
          settings: IPMSettings = IPMSettings(), return_trace: bool = False,
          return_duals: bool = False, n_iter_dyn=None,
          n_iter_bound: int = None):
    """Solve one NLP: ``f_fn`` maps z -> f(z), ``c_fn`` maps z -> (c_E(z),
    c_I(z)) in one evaluation, so that both row blocks are differentiated
    in one pass. Returns (z, IPMInfo), then the trace with
    ``return_trace``, then (y, lam, s) with ``return_duals``.

    ``return_trace``: the reference's nine per-iteration rows (obj, merit,
    alpha, mu, delta, eq_viol, ineq_viol, kkt_stat, kkt_comp), each
    (settings.n_iter,), of a fixed-trip solve: as in the reference, the
    early exit does not apply to a traced solve.

    ``n_iter_dyn``: an iteration budget that overrides ``settings.n_iter``
    (the adaptive-effort lever). An int is a host value: the loop runs
    that many iterations. A tensor (one per episode under ``vmap``) needs
    ``n_iter_bound``, the most it can be: the loop runs that many and an
    iterate is frozen once ``it >= n_iter_dyn``. Like the reference's, it
    cannot be combined with ``return_trace``.
    """
    if return_trace and n_iter_dyn is not None:
        raise ValueError(
            "n_iter_dyn is unsupported with return_trace=True: the traced "
            "path runs a fixed-trip loop of settings.n_iter iterations and "
            "would not reflect the escalated budget. Pass "
            "settings=replace(settings, n_iter=<escalated>) to trace an "
            "adaptive-effort solve.")
    budget = torch.is_tensor(n_iter_dyn)
    if budget and n_iter_bound is None:
        raise ValueError("a tensor n_iter_dyn needs n_iter_bound, the "
                         "static bound of the loop")
    st = settings
    n = z0.shape[0]
    dtype, device = z0.dtype, z0.device

    if st.precondition:
        # diagonal scaling so every variable sees O(1) curvature; solve in
        # y = z / D, return D * y
        with tracing.span("ipm.precond"):
            h_diag = torch.diagonal(jacrev(jacrev(f_fn))(z0))
        D_pre = 1.0 / torch.sqrt(torch.clamp(torch.abs(h_diag), 1.0, 1e10))
        f_raw, c_raw = f_fn, c_fn
        f_fn = lambda y: f_raw(D_pre * y)         # noqa: E731
        c_fn = lambda y: c_raw(D_pre * y)         # noqa: E731
        z0 = z0 / D_pre
    else:
        D_pre = None

    c_e0, c_i0 = c_fn(z0)
    m_e = c_e0.shape[0]
    m_i = c_i0.shape[0]

    def c_with_value(z):
        c_e, c_i = c_fn(z)
        c = torch.cat([c_e, c_i])
        return c, c

    jac_c = jacrev(c_with_value, has_aux=True)
    grad_f = grad_and_value(f_fn)

    def lagrangian(z, y, lam):
        c_e, c_i = c_fn(z)
        val = f_fn(z)
        if m_e:
            val = val + torch.dot(y, c_e)
        return val + torch.dot(lam, c_i)

    if st.exact_hessian:
        hess_l = jacrev(jacrev(lagrangian))
    else:
        hess_f = jacrev(jacrev(f_fn))
        hess_l = lambda z, y, lam: hess_f(z)     # noqa: E731

    def merit_at(z_t, s_t, mu, nu):
        c_e_t, c_i_t = c_fn(z_t)
        return _merit(f_fn(z_t), c_e_t, c_i_t, s_t, mu, nu)

    merits_at = vmap(merit_at, in_dims=(0, 0, None, None))

    s0 = torch.clamp(-c_i0, min=1e-2)
    # complementarity-consistent multiplier init: s_i * lam_i = mu_init
    lam0 = torch.clamp(st.mu_init / s0, 1e-6, 1e3)
    y0 = torch.zeros((m_e,), dtype=dtype, device=device)
    # constants are filled on the device, never copied from the host: a
    # copy waits for the device, and a CUDA graph cannot hold it
    alphas = torch.stack([_full(a, dtype, device) for a in st.alphas])
    eye_n = torch.eye(n, dtype=dtype, device=device)
    reg_block = -st.reg_eq * torch.eye(m_e, dtype=dtype, device=device)
    if st.mu_schedule == "geometric":
        mu_decay = (st.mu_min / st.mu_init) ** (1.0 / max(st.n_iter - 1, 1))

    def step(state: IPMState, it: int):
        z, y, lam, s, delta, _ = state
        with tracing.span("ipm.grad"):
            g, f_val = grad_f(z)
        with tracing.span("ipm.jac"):
            J, c = jac_c(z)
            c_e, c_i = c[:m_e], c[m_e:]
            J_e, J_i = J[:m_e], J[m_e:]

        with tracing.span("ipm.hess"):
            W = hess_l(z, y, lam)
            # symmetrize + damp
            W = 0.5 * (W + W.T) + delta * eye_n

        with tracing.span("ipm.kkt"):
            if st.mu_schedule == "geometric":
                mu = torch.clamp(st.mu_init * _full(
                    mu_decay, dtype, device) ** it, min=st.mu_min)
            else:
                mu = torch.clamp(st.sigma * torch.dot(s, lam) / m_i,
                                 min=st.mu_min)
            D = lam / torch.clamp(s, min=st.s_min)
            r_d = g + J_e.T @ y + J_i.T @ lam
            # scaled KKT error of the current iterate: the 1e6-range
            # slack-penalty gradients force a relative measure in f32
            kkt_scale = 1.0 + _amax0(torch.abs(g))
            kkt_stat = _amax0(torch.abs(r_d)) / kkt_scale
            kkt_comp = _amax0(s * lam) / kkt_scale
            corr = (mu / torch.clamp(s, min=st.s_min) - lam) + D * (c_i + s)

            H_red = W + (J_i.T * D) @ J_i
            rhs_z = -(r_d + J_i.T @ corr)
            if m_e:
                M = torch.cat([torch.cat([H_red, J_e.T], dim=1),
                               torch.cat([J_e, reg_block], dim=1)], dim=0)
                rhs = torch.cat([rhs_z, -c_e])
                LU, piv, _ = torch.linalg.lu_factor_ex(M)
                sol = torch.linalg.lu_solve(LU, piv, rhs[:, None])[:, 0]
                dz, dy = sol[:n], sol[n:]
            else:
                dz = torch.linalg.solve_ex(H_red, rhs_z)[0]
                dy = y
            ds = -(c_i + s) - J_i @ dz
            dlam = (mu / torch.clamp(s, min=st.s_min) - lam) - D * ds

            # NaN/Inf guard: a singular KKT system yields non-finite
            # directions; zero the step so the iterate is kept
            step_ok = _all_finite(dz, ds, dlam, dy)
            dz = torch.where(step_ok, dz, 0.0)
            ds = torch.where(step_ok, ds, 0.0)
            dlam = torch.where(step_ok, dlam, 0.0)
            if m_e:
                dy = torch.where(step_ok, dy, 0.0)

            a_p = _step_limit(s, ds, st.tau)
            a_d = _step_limit(lam, dlam, st.tau)

        with tracing.span("ipm.search"):
            nu = 10.0 * (_amax0(torch.abs(lam)) +
                         _amax0(torch.abs(y))) + 10.0
            merit_now = _merit(f_val, c_e, c_i, s, mu, nu)

            steps = (alphas * a_p)[:, None]
            merits = merits_at(z + steps * dz,
                               torch.clamp(s + steps * ds, min=st.s_min),
                               mu, nu)
            merits = torch.where(torch.isfinite(merits), merits, torch.inf)
            best = torch.argmin(merits)
            merit_best = merits[best]
            improved = merit_best < merit_now
            alpha = torch.where(improved, alphas[best], 0.0)

            step_z = alpha * a_p * dz
            step_s = alpha * a_p * ds
            step_lam = alpha * a_d * dlam
            step_y = alpha * a_d * dy if m_e else dy

            if st.soc and m_e:
                # second-order correction: the same factorization, the
                # equality residual re-evaluated at the trial point
                c_e_t, _ = c_fn(z + a_p * dz)
                rhs_soc = torch.cat([rhs_z, -(a_p * c_e + c_e_t)])
                sol2 = torch.linalg.lu_solve(LU, piv,
                                             rhs_soc[:, None])[:, 0]
                dz2, dy2 = sol2[:n], sol2[n:]
                ds2 = -(c_i + s) - J_i @ dz2
                dlam2 = (mu / torch.clamp(s, min=st.s_min) - lam) - D * ds2
                ok2 = _all_finite(dz2, ds2, dlam2, dy2)
                dz2 = torch.where(ok2, dz2, 0.0)
                ds2 = torch.where(ok2, ds2, 0.0)
                dlam2 = torch.where(ok2, dlam2, 0.0)
                dy2 = torch.where(ok2, dy2, 0.0)
                a_p2 = _step_limit(s, ds2, st.tau)
                a_d2 = _step_limit(lam, dlam2, st.tau)
                merit_soc = merit_at(
                    z + a_p2 * dz2,
                    torch.clamp(s + a_p2 * ds2, min=st.s_min), mu, nu)
                merit_soc = torch.where(torch.isfinite(merit_soc) & ok2,
                                        merit_soc, torch.inf)
                use_soc = merit_soc < torch.minimum(merit_best, merit_now)
                step_z = torch.where(use_soc, a_p2 * dz2, step_z)
                step_s = torch.where(use_soc, a_p2 * ds2, step_s)
                step_lam = torch.where(use_soc, a_d2 * dlam2, step_lam)
                step_y = torch.where(use_soc, a_d2 * dy2, step_y)
                improved = improved | use_soc
                merit_best = torch.minimum(merit_best, merit_soc)
                alpha = torch.where(use_soc, a_p2, alpha)

            z_new = z + step_z
            s_new = torch.clamp(s + step_s, min=st.s_min)
            lam_new = torch.clamp(lam + step_lam, min=1e-12)
            y_new = y + step_y if m_e else y

            # LM damping adaptation (a non-finite step counts as a failure)
            delta_new = torch.where(
                improved & step_ok, torch.clamp(delta / 3.0, min=st.delta_min),
                torch.clamp(delta * 10.0, max=st.delta_max))
            new_state = IPMState(z_new, y_new, lam_new, s_new, delta_new,
                                 merit_best)
            # the reference's trace row; the best-feasible tracker and the
            # early exit read its f, eq and ineq, of the pre-step iterate
            row = (f_val, merit_best, alpha, mu, delta,
                   _amax0(torch.abs(c_e)), _amax0(c_i), kkt_stat, kkt_comp)
            return new_state, row

    init = IPMState(z0, y0, lam0, s0, _full(st.delta_init, dtype, device),
                    _full(torch.inf, dtype, device))
    false = torch.zeros((), dtype=torch.bool, device=device)
    best = (z0, _full(torch.inf, dtype, device), false)

    def track_best(state, best, tr):
        # best-feasible-iterate tracker: the checks' f/eq/ineq belong to
        # the pre-step iterate state.z
        z_b, f_b, has_b = best
        f_val, eq_v, ineq_v = tr[0], tr[5], tr[6]
        feas = (eq_v < st.feas_tol) & (ineq_v < st.feas_tol)
        better = feas & ((~has_b) | (f_val < f_b))
        return (torch.where(better, state.z, z_b),
                torch.where(better, f_val, f_b), has_b | feas)

    early = (st.early_exit_tol > 0.0 or n_iter_dyn is not None) and \
        not return_trace
    limit = (st.n_iter if n_iter_dyn is None else
             n_iter_bound if budget else int(n_iter_dyn))
    state = init
    done = false
    n_used = torch.zeros((), dtype=torch.int32, device=device)
    rows = []
    # a plain fixed-trip loop launches the same kernels every iteration: a
    # CUDA graph of the solve captures one iteration and replays it
    plain = not (early or return_trace or st.keep_best_feasible or
                 st.mu_schedule == "geometric")
    if plain:
        state = cuda_graph.repeat(lambda s: step(s, None)[0], state, limit)
    for it in range(0 if plain else limit):
        new_state, tr = step(state, it)
        if return_trace:
            rows.append(tr)
        frozen = done | (it >= n_iter_dyn) if budget else done
        if st.keep_best_feasible:
            new_best = track_best(state, best, tr)
            best = tuple(torch.where(frozen, b, nb)
                         for b, nb in zip(best, new_best))
        if early:
            # the while loop's semantics: once done or out of budget, the
            # iterate is frozen
            state = IPMState(*[torch.where(frozen, a, b)
                               for a, b in zip(state, new_state)])
            n_used = n_used + (~frozen).to(torch.int32)
            if st.early_exit_tol > 0.0:
                eq_v, ineq_v, kkt_stat, kkt_comp = tr[5:]
                tol = st.early_exit_tol
                done = done | ((kkt_stat < tol) & (eq_v < tol) &
                               (ineq_v < tol) &
                               (kkt_comp < st.early_exit_comp_tol))
        else:
            state = new_state
    if not early:
        n_used = torch.full((), st.n_iter, dtype=torch.int32, device=device)

    z_fin = state.z
    if st.keep_best_feasible:
        z_b, f_b, has_b = best
        c_e_f, c_i_f = c_fn(z_fin)
        fin_feas = ((_amax0(torch.abs(c_e_f)) < st.feas_tol) &
                    (_amax0(c_i_f) < st.feas_tol))
        use_best = has_b & ~(fin_feas & (f_fn(z_fin) <= f_b))
        z_fin = torch.where(use_best, z_b, z_fin)

    c_e, c_i = c_fn(z_fin)
    info = IPMInfo(obj=f_fn(z_fin), eq_viol=_amax0(torch.abs(c_e)),
                   ineq_viol=_amax0(c_i),
                   comp=torch.dot(state.s, state.lam) / m_i, iters=n_used)
    z_out = z_fin * D_pre if D_pre is not None else z_fin
    out = (z_out, info)
    if return_trace:
        out += (tuple(torch.stack(r) for r in zip(*rows)),)
    if return_duals:
        out += ((state.y, state.lam, state.s),)
    return out
