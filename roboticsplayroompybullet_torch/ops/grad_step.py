"""Derivatives of the control step: the `step` kernel's forward, the plain
twin's VJP.

The JAX package takes its gradient solvers' derivatives (solver/ilqr.py's
jacrev / hessian, solver/gradient.py's value_and_grad) by XLA autodiff of
plain JAX code, the vmap oracle `core.step_physics_only`; no Pallas kernel
has a backward pass. The port carries one physics, the lane twin
(envs/physics.py), so it differentiates the plain twin
(fused_step.make_reference_step), whose values agree with the oracle's to
1.78e-5 but whose derivatives part from the oracle's at a contact switch.

`KernelStep` is the one differentiable control step:

* forward: `(X (NF, B), actions (A, B)) → (X', C (n_arm + 1, B))`, through
  the `step` kernel (fused_step.make_cuda_step) on CUDA tensors and the
  plain twin on CPU tensors (parallel/fused.py's "auto" dispatch);
* backward: the plain twin recomputed at the saved inputs under autograd,
  and its VJP. On the card that recompute and its backward are one CUDA
  graph per batch width (`TwinVJP`), captured the first time a forward
  at that width has inputs that require grad, after a warm-up forward of
  the twin; every backward replays it. Eagerly the twin is host-bound,
  ~10^5 small launches a control step.

So on the card the plain twin runs only inside a backward pass (and its
capture), never in place of a kernel forward. `jacobians` turns any
batched function into its Jacobians with one call on one-hot copies and
one backward pass; `rollout_states` is a whole rollout of a flat dynamics
function, linearised at every step in one such call, with the adjoint
recursion as its backward.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from . import fused_step as fs


def _grads(out, inputs, cotangents, create_graph=False):
    """torch.autograd.grad with zeros for the inputs `out` does not reach
    (all of them where `out` is constant)."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if not any(o.requires_grad for o in outs):
        return tuple(torch.zeros_like(x) for x in inputs)
    gs = torch.autograd.grad(out, inputs, cotangents, allow_unused=True,
                             create_graph=create_graph)
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(gs, inputs))


class TwinVJP:
    """vjp(X, actions, gX, gC) → (∂/∂X, ∂/∂actions): the VJP of the plain
    twin `twin` (make_reference_step with with_ctrl) at (X, actions),
    gC of n_ctrl rows.

    On CPU tensors every call runs eagerly. On CUDA tensors the recompute
    and its backward are captured as a CUDA graph on static buffers, once
    per batch width (`prepare`, after one plain forward on the device
    makes the constants the twin caches), and every call copies its
    inputs in and replays the graph. Counts: `eager`, `captures`,
    `replays`."""

    def __init__(self, twin: Callable, n_ctrl: int):
        self.twin = twin
        self.n_ctrl = n_ctrl             # rows of C: n_arm + 1
        self.graphs: Dict[Tuple, tuple] = {}
        self.warm = set()
        self.eager = self.captures = self.replays = 0

    def _vjp(self, X, actions, gX, gC):
        with torch.enable_grad():
            X = X.detach().requires_grad_()
            actions = actions.detach().requires_grad_()
            return _grads(self.twin(X, actions), (X, actions), (gX, gC))

    def prepare(self, X, actions):
        """Capture the graph for X's device and batch width, if not yet
        done. Called from the forward pass, on the caller's thread: the
        eager twin runs ~3x slower on autograd's device thread, where a
        backward pass runs."""
        key = (X.device, X.shape[1])
        if not X.is_cuda or key in self.graphs:
            return
        if X.device not in self.warm:
            with torch.no_grad():
                self.twin(X, actions)
            self.warm.add(X.device)
        static = [X.detach().clone(), actions.detach().clone(),
                  torch.zeros_like(X), X.new_zeros((self.n_ctrl, X.shape[1]))]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._vjp(*static)
        self.graphs[key] = (graph, static, out)
        self.captures += 1

    def __call__(self, X, actions, gX, gC):
        if not X.is_cuda:
            self.eager += 1
            return self._vjp(X, actions, gX, gC)
        self.prepare(X, actions)
        graph, static, out = self.graphs[(X.device, X.shape[1])]
        for dst, src in zip(static, (X, actions, gX, gC)):
            dst.copy_(src)
        graph.replay()
        self.replays += 1
        return tuple(o.clone() for o in out)


class KernelStep(torch.autograd.Function):
    """(X (NF, B), actions (A, B), step) → (X', C): `step.forward` (the
    kernel on the card) forward, `step.vjp` (the plain twin) backward."""

    @staticmethod
    def forward(ctx, X, actions, step):
        ctx.save_for_backward(X, actions)
        ctx.step = step
        return step.forward(X, actions)

    @staticmethod
    def backward(ctx, gX, gC):
        X, actions = ctx.saved_tensors
        dX, da = ctx.step.vjp(X, actions, gX, gC)
        return dX, da, None


class GradStep:
    """The model's differentiable control step at the env step's fidelity:
    step(X (NF, B), actions (A, B)) → (X', C (n_arm + 1, B)), C the servo
    targets and gripper command the step's control chose. It is the env
    step's stepper (envs/core.py::_stepper): with autograd off, or on
    inputs that do not require grad, it is one kernel forward and
    nothing more."""

    def __init__(self, m):
        from ..parallel import fused
        self.forward = fused._stepper(m, "auto", with_ctrl=True)
        self.vjp = TwinVJP(fs.make_reference_step(*m, with_ctrl=True),
                           m.arm.n_arm + 1)

    def __call__(self, X, actions):
        if torch.is_grad_enabled() and (X.requires_grad
                                        or actions.requires_grad):
            self.vjp.prepare(X, actions)
        return KernelStep.apply(X, actions, self)


def jacobians(fn: Callable, x: torch.Tensor, u: torch.Tensor, n_out: int):
    """Jacobians of a batched fn((B, n), (B, A)) → (B, n_out) at the K
    points (x (K, n), u (K, A)): (∂fn/∂x (K, n_out, n), ∂fn/∂u (K, n_out,
    A), fn's value (K, n_out)). fn runs once on K·n_out copies of the
    points, and one backward pass with a one-hot cotangent per copy gives
    every row; the copies are independent rows of the batch."""
    K = x.shape[0]
    with torch.enable_grad():
        xr = x.detach().repeat_interleave(n_out, 0).requires_grad_()
        ur = u.detach().repeat_interleave(n_out, 0).requires_grad_()
        y = fn(xr, ur)
        eye = torch.eye(n_out, dtype=y.dtype, device=y.device).repeat(K, 1)
        gx, gu = _grads(y, (xr, ur), eye)
    return (gx.reshape(K, n_out, -1), gu.reshape(K, n_out, -1),
            y.detach().reshape(K, n_out, n_out)[:, 0])


class _FlatRollout(torch.autograd.Function):
    """(x0 (n,), us (H, A), f) → xs (H, n), x_{t+1} = f(x_t, u_t)."""

    @staticmethod
    def forward(ctx, x0, us, f):
        x, xs = x0[None], []
        for u in us:
            x = f(x, u[None])
            xs.append(x[0])
        xs = torch.stack(xs)
        if any(ctx.needs_input_grad[:2]):
            # linearised here, on the caller's thread (see TwinVJP.prepare)
            As, Bs, _ = jacobians(f, torch.cat([x0[None], xs[:-1]]), us,
                                  x0.shape[0])
            ctx.save_for_backward(As, Bs)
        return xs

    @staticmethod
    def backward(ctx, gxs):
        As, Bs = ctx.saved_tensors
        lam = torch.zeros_like(gxs[0])
        gus = [None] * As.shape[0]
        for t in reversed(range(As.shape[0])):
            lam = lam + gxs[t]                 # ∂/∂x_{t+1}
            gus[t] = Bs[t].T @ lam
            lam = As[t].T @ lam
        return lam, torch.stack(gus), None


def rollout_states(f: Callable, x0: torch.Tensor,
                   us: torch.Tensor) -> torch.Tensor:
    """xs (H, n): the states after each of the H steps of the batched flat
    dynamics f((B, n), (B, A)) → (B, n) from x0 (n,) under us (H, A).
    Differentiable in x0 and us: when either requires grad, the forward
    also linearises all H steps in one `jacobians` call (H·n copies, one
    VJP) and the backward runs the adjoint recursion, so a gradient costs
    one batched backward of f, not H."""
    return _FlatRollout.apply(x0, us, f)
