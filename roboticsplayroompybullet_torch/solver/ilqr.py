"""iLQR over the differentiable control step (port of
roboticsplayroompybullet_tpu/solver/ilqr.py).

JAX linearises with `jacrev` / `hessian` of the vmap oracle
`core.step_physics_only`. The port has no oracle: its dynamics are the
lane twin, so its Jacobians are autograd's through the plain twin at the
trajectory's points (ops/grad_step.py). Every forward pass, the nominal
rollout and the line search, goes through the `step` kernel on the card;
the plain twin runs there only inside the linearisation's backward pass
(one CUDA graph replay per linearisation). The twin's values agree with
the oracle's to 1.78e-5; its derivatives part from the oracle's at a
contact switch.

Design, as JAX's:
  * The differentiable state x is the DYNAMIC slice of EnvState (q, qd,
    ctrl_q, grip, object pose/vel, articulated q/qd), in JAX's flat layout
    element for element; goal, rng and the continuity buffers are frozen
    from the nominal state.
  * Linearisation: f runs once on H·n one-hot copies of the trajectory's
    points and one backward pass gives every A_t and B_t
    (grad_step.jacobians); the stage and final costs' gradients and
    Hessians come the same way from their autograd gradients.
  * Backward pass: the regularised Riccati recursion over the horizon.
  * Forward pass: batched line search, every step size rolled out at once
    (H launches of the step kernel at B = len(alphas)), the best one taken
    with argmin.

f, stage and final take a leading batch axis here: f((B, n), (B, A)) →
(B, n), stage((B, n), (B, A)) → (B,), final((B, n)) → (B,).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..envs import core
from ..envs.core import EnvModel
from ..envs.obs import achieved_goal
from ..envs.state import EnvState
from ..ops import fused_step as fs
from ..ops.grad_step import _grads, jacobians, rollout_states
from .cost import CostWeights, goal_distance


# ---------------------------------------------------------------------------
# flat dynamic-state view
# ---------------------------------------------------------------------------

_DYN_FIELDS = ("q", "qd", "ctrl_q", "grip", "obj_pos", "obj_quat",
               "obj_vel", "obj_angvel", "art_q", "art_qd")


def _extract(state: EnvState) -> torch.Tensor:
    """(B, n) float32: each env's dynamic fields, raveled and joined."""
    B = state.q.shape[0]
    return torch.cat([getattr(state, f).reshape(B, -1).to(torch.float32)
                      for f in _DYN_FIELDS], dim=-1)


def _inject(template: EnvState, x: torch.Tensor) -> EnvState:
    """x (B, n) written into the dynamic fields of `template` (B envs or
    one, broadcast to x's B)."""
    B = x.shape[0]
    kw = {}
    for f in template.__dataclass_fields__:
        v = getattr(template, f)
        kw[f] = v.expand((B,) + v.shape[1:])
    idx = 0
    for f in _DYN_FIELDS:
        ref = getattr(template, f)
        n = ref[0].numel()
        kw[f] = x[:, idx:idx + n].reshape(kw[f].shape).to(ref.dtype)
        idx += n
    return EnvState(**kw)


def make_flat_dynamics(m: EnvModel, template: EnvState):
    """f(x (B, n), u (B, A)) → x' (B, n): core.step_physics_only (clip,
    control, the physics through the model's differentiable step, t + 1)
    between inject and extract, as JAX's; template freezes the non-dynamic
    fields (goal, rng, buffers)."""

    def f(x, u):
        return _extract(core.step_physics_only(m, _inject(template, x), u))

    return f


def make_stage_cost(m: EnvModel, template: EnvState,
                    w: CostWeights = CostWeights()):
    goal = template.goal

    def stage(x, u):
        s = _inject(template, x)
        ag = achieved_goal(m.cfg, m.tree, m.arm, s)
        return (goal_distance(m.cfg, ag, goal, w)
                + w.action * torch.sum(u * u, dim=-1))

    def final(x):
        s = _inject(template, x)
        ag = achieved_goal(m.cfg, m.tree, m.arm, s)
        return w.terminal * goal_distance(m.cfg, ag, goal, w)

    return stage, final


# ---------------------------------------------------------------------------
# generic iLQR core (flat vectors)
# ---------------------------------------------------------------------------

class ILQRConfig(NamedTuple):
    iters: int = 10
    reg_init: float = 1.0
    reg_min: float = 1e-6
    reg_max: float = 1e6
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)


class ILQRResult(NamedTuple):
    us: torch.Tensor       # (H, A) optimized controls
    xs: torch.Tensor       # (H+1, n) optimized trajectory
    cost: torch.Tensor     # () final total cost
    cost_trace: torch.Tensor  # (iters,)


def _rollout_flat(f, stage, final, x0, us):
    """(xs (H+1, n), total cost ()) of x0 (n,) under us (H, A);
    differentiable in x0 and us (grad_step.rollout_states)."""
    xs = torch.cat([x0[None], rollout_states(f, x0, us)])
    return xs, stage(xs[:-1], us).sum() + final(xs[-1:])[0]


def _cost_derivatives(cost, x, u):
    """Gradient and Hessian of a batched scalar cost((B, n), (B, A)) → (B,)
    at the K points (x, u): (g (K, n + A), Hess (K, n + A, n + A)),
    variables ordered (x, u)."""
    def grad(xb, ub):
        return torch.cat(_grads(cost(xb, ub).sum(), (xb, ub), None,
                                create_graph=True), dim=-1)
    hx, hu, g = jacobians(grad, x, u, x.shape[1] + u.shape[1])
    return g, torch.cat([hx, hu], dim=-1)


def _linearize(f, stage, final, xs, us):
    """A_t, B_t of f and the stage costs' and final cost's gradients and
    Hessians along (xs (H+1, n), us (H, A))."""
    n = xs.shape[1]
    As, Bs, _ = jacobians(f, xs[:-1], us, n)
    g, Hs = _cost_derivatives(stage, xs[:-1], us)
    none = us.new_zeros((1, 0))
    gf, Hf = _cost_derivatives(lambda x, u: final(x), xs[-1:], none)
    return (As, Bs, g[:, :n], g[:, n:], Hs[:, :n, :n], Hs[:, n:, n:],
            Hs[:, n:, :n], gf[0], Hf[0])


def _cholesky(Q):
    """Cholesky factor of Q, NaN where Q is not positive definite (as
    JAX's), without reading the device back."""
    L, info = torch.linalg.cholesky_ex(Q)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _riccati(lin, reg):
    """The regularised Riccati recursion → (ks (H, A), Ks (H, A, n), dV)."""
    As, Bs, lxs, lus, lxxs, luus, luxs, Vx, Vxx = lin
    H, A = lus.shape
    eye = torch.eye(A, dtype=Vx.dtype, device=Vx.device)
    dV = Vx.new_zeros(())
    ks, Ks = [None] * H, [None] * H
    for t in reversed(range(H)):
        A_, B_ = As[t], Bs[t]
        Qx = lxs[t] + A_.T @ Vx
        Qu = lus[t] + B_.T @ Vx
        Qxx = lxxs[t] + A_.T @ Vxx @ A_
        Quu = luus[t] + B_.T @ Vxx @ B_ + reg * eye
        Qux = luxs[t] + B_.T @ Vxx @ A_
        # solve with symmetrization for numerical hygiene
        Quu = 0.5 * (Quu + Quu.T)
        L = _cholesky(Quu + 1e-9 * eye)
        k = -torch.cholesky_solve(Qu[:, None], L)[:, 0]
        K = -torch.cholesky_solve(Qux, L)
        Vx = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
        Vxx = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
        Vxx = 0.5 * (Vxx + Vxx.T)
        dV = dV + k @ Qu
        ks[t], Ks[t] = k, K
    return torch.stack(ks), torch.stack(Ks), dV


def _line_search(f, stage, final, xs, us, ks, Ks, alphas, clamp):
    """Every step size at once: (xs (P, H+1, n), us (P, H, A), costs
    (P,)) for the P alphas, f stepping the P rollouts as one batch."""
    x = xs[0].expand(alphas.shape[0], -1)
    xs2, us2, cost = [x], [], 0.0
    for t in range(us.shape[0]):
        u = clamp(us[t] + alphas[:, None] * ks[t] + (x - xs[t]) @ Ks[t].T)
        cost = cost + stage(x, u)
        x = f(x, u)
        xs2.append(x)
        us2.append(u)
    return (torch.stack(xs2, 1), torch.stack(us2, 1),
            cost + final(x))


def ilqr(f, stage, final, x0: torch.Tensor, us0: torch.Tensor,
         cfg: ILQRConfig = ILQRConfig(),
         u_low=None, u_high=None) -> ILQRResult:
    """Regularized iLQR. f/stage/final operate on batched flat vectors (see
    the module's docstring); x0 (n,), us0 (H, A)."""
    def clamp(u):
        if u_low is None:
            return u
        return torch.clamp(u, u_low, u_high)

    alphas = torch.as_tensor(cfg.alphas, dtype=torch.float32,
                             device=x0.device)
    with torch.no_grad():
        xs, cost = _rollout_flat(f, stage, final, x0, us0)
    us = us0
    reg = torch.tensor(cfg.reg_init, dtype=torch.float32, device=x0.device)
    trace = []
    for _ in range(cfg.iters):
        ks, Ks, _ = _riccati(_linearize(f, stage, final, xs, us), reg)
        with torch.no_grad():
            xs_c, us_c, costs = _line_search(f, stage, final, xs, us, ks,
                                             Ks, alphas, clamp)
        best = torch.argmin(costs)
        c_new = costs[best]
        improved = c_new < cost
        xs = torch.where(improved, xs_c[best], xs)
        us = torch.where(improved, us_c[best], us)
        cost = torch.where(improved, c_new, cost)
        reg = torch.clamp(torch.where(improved, reg * 0.5, reg * 4.0),
                          cfg.reg_min, cfg.reg_max)
        trace.append(cost)
    return ILQRResult(us=us, xs=xs, cost=cost, cost_trace=torch.stack(trace))


# ---------------------------------------------------------------------------
# env-level wrapper
# ---------------------------------------------------------------------------

def ilqr_plan(m: EnvModel, state: EnvState, us0: torch.Tensor,
              cfg: ILQRConfig = ILQRConfig(),
              w: CostWeights = CostWeights()) -> ILQRResult:
    """Refine an (H, A) action sequence from `state` (one env, B=1) with
    iLQR, on the state's device."""
    f = make_flat_dynamics(m, state)
    stage, final = make_stage_cost(m, state, w)
    high = fs.const_on(m.cfg.action_high, state.q.device)
    x0 = _extract(state)[0]
    return ilqr(f, stage, final, x0, us0.to(x0), cfg, u_low=-high,
                u_high=high)
