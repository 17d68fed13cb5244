"""PyTorch port: the gradient solvers (solver/ilqr.py, solver/gradient.py,
ops/grad_step.py) against the JAX package's, on the cases of
tests/test_ilqr.py.

JAX's outputs come from committed fixtures (tools/gen_port_fixtures.py
--only ilqr: ilqr_di, ilqr_reach, ilqr_pinch, ilqr_refine), so no JAX env
physics is compiled here. JAX linearises the vmap oracle; the port
differentiates its one physics, the lane twin, so its Jacobians are held
to JAX's lane twin's (the same algorithm; the fixture takes them in
forward mode) and, at UR5Reach, to the oracle's. On these CPU tensors the differentiable step's forward is the
plain twin too; on the card it is the `step` kernel (chip_smoke.py
[ilqr])."""
import dataclasses
import importlib
from unittest import mock

import numpy as np
import pytest
import torch

from roboticsplayroompybullet_torch import interop
from roboticsplayroompybullet_torch.envs import core
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.ops import fused_step as fs
from roboticsplayroompybullet_torch.ops import grad_step as gs
from roboticsplayroompybullet_torch.solver.cost import CostWeights

import _torch_port as tp

IL = importlib.import_module("roboticsplayroompybullet_torch.solver.ilqr")
GR = importlib.import_module("roboticsplayroompybullet_torch.solver.gradient")

torch.set_num_threads(1)

# Tolerances, each beside what this host measured. Jacobians, max |Δ| over
# the largest |entry|, against JAX's lane twin (reach 1.2e-7, the pinch
# 2.7e-6: the port's control runs in float64, JAX's in float32) and
# against the oracle at UR5Reach (2.3e-7: away from contact the two
# physics agree to float32 rounding)
JAC_LANE = 1e-5
JAC_ORACLE = 1e-5
# costs relative to JAX's: c0 (reach 3.8e-7, the pinch 0), the iLQR cost
# traces (1.2e-7, 6e-8) and refine's losses (2.9e-6)
COST_REL = 1e-5
# ilqr_plan's controls against JAX's, absolute (reach 2.3e-7, the pinch
# 5.8e-6)
US_ABS = 1e-4


def _model(env_id, substeps):
    return core.build_model(dataclasses.replace(CATALOG[env_id],
                                                substeps=int(substeps)))


def _case(name, env_id):
    d = tp.load(name)
    st = interop.state_from_numpy({f: d[f] for f in interop.FIELDS},
                                  device="cpu")
    return _model(env_id, d["substeps"]), st, d


@pytest.fixture(scope="module")
def reach():
    return _case("ilqr_reach", "UR5Reach-v0")


@pytest.fixture(scope="module")
def pinch():
    return _case("ilqr_pinch", "pandaPick-v0")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_ilqr_double_integrator():
    """Point mass must brake to the origin (JAX's criteria), on JAX's
    path: us, xs and the cost trace within float32 rounding of the
    Riccati recursion (measured: trace 4.8e-7, xs 1.8e-4, us 1.8e-3 of
    controls ~0.3: the last steps' gains are ill-conditioned)."""
    z = tp.load("ilqr_di")
    dt = 0.1

    def f(x, u):
        return torch.stack([x[:, 0] + x[:, 1] * dt, x[:, 1] + u[:, 0] * dt],
                           -1)

    def stage(x, u):
        return 0.1 * (x * x).sum(-1) + 0.01 * (u * u).sum(-1)

    def final(x):
        return 100.0 * (x * x).sum(-1)

    x0, us0 = torch.as_tensor(z["x0"]), torch.as_tensor(z["us0"])
    res = IL.ilqr(f, stage, final, x0, us0, IL.ILQRConfig(iters=15))
    _, c0 = IL._rollout_flat(f, stage, final, x0, us0)
    assert float(c0) == pytest.approx(float(z["c0"]), rel=1e-6)
    assert float(res.cost) < 0.05 * float(c0)
    assert abs(float(res.xs[-1, 0])) < 0.05
    np.testing.assert_allclose(res.cost_trace, z["cost_trace"], rtol=1e-5)
    np.testing.assert_allclose(res.xs, z["xs"], atol=1e-3)
    np.testing.assert_allclose(res.us, z["us"], atol=1e-2)


@pytest.mark.parametrize("case", ["reach", "pinch"])
def test_extract_inject_layout(case, request):
    """The flat view is JAX's element for element, and inject ∘ extract is
    the identity; a perturbation flows into its field."""
    m, st, d = request.getfixturevalue(case)
    x = IL._extract(st)
    np.testing.assert_array_equal(x[0].numpy(), d["x0"])
    s2 = IL._inject(st, x)
    for f in interop.FIELDS:
        assert torch.equal(getattr(s2, f), getattr(st, f)), f
    s3 = IL._inject(st, x + torch.nn.functional.one_hot(
        torch.tensor(0), x.shape[1]) * 0.5)
    assert float(s3.q[0, 0]) == pytest.approx(float(st.q[0, 0]) + 0.5)


# each case's ilqr_plan (JAX's: reach from the zero plan with the default
# weights, 4 iterations; the pinch from the hold plan with the goal-only
# cost, 3 iterations), run once for the module
PLANS = {"reach": (4, CostWeights()), "pinch": (3, CostWeights(action=0.0))}


@pytest.fixture(scope="module")
def planned():
    """case → (ilqr_plan's result, c0: the cost of its nominal rollout,
    x1: that rollout's first state, and (A, B): its first linearisation's
    Jacobians of make_flat_dynamics at (x0, us0[0])), planned once."""
    made = {}

    def get(case, m, st, d):
        if case not in made:
            seen = {}

            def first(name, fn):
                def call(*a):
                    out = fn(*a)
                    seen.setdefault(name, out)
                    return out
                return call

            iters, w = PLANS[case]
            with mock.patch.object(IL, "_rollout_flat",
                                   first("roll", IL._rollout_flat)), \
                    mock.patch.object(IL, "_linearize",
                                      first("lin", IL._linearize)):
                res = IL.ilqr_plan(m, st, torch.as_tensor(d["us0"]),
                                   IL.ILQRConfig(iters=iters), w)
            xs, c0 = seen["roll"]
            As, Bs = seen["lin"][:2]
            made[case] = (res, float(c0), xs[1].numpy(), As[0].numpy(),
                          Bs[0].numpy())
        return made[case]
    return get


@pytest.mark.parametrize("case,ref,tol", [("reach", "lane", JAC_LANE),
                                          ("reach", "oracle", JAC_ORACLE),
                                          ("pinch", "lane", JAC_LANE)])
def test_twin_jacobians_match_jax(case, ref, tol, request, planned):
    """∂f/∂x and ∂f/∂u of the port's flat dynamics (autograd through the
    plain twin; ilqr_plan's first linearisation) against JAX's lane
    twin's, and at UR5Reach the oracle's that JAX's iLQR linearises; every
    entry finite (the pinch has floor and pad contact rows active, the
    gripper command at its bound)."""
    m, st, d = request.getfixturevalue(case)
    _, _, x1, A, B = planned(case, m, st, d)
    assert np.isfinite(A).all() and np.isfinite(B).all()
    np.testing.assert_allclose(x1, d[f"x1_{ref}"], atol=1e-4)
    assert _rel(A, d[f"A_{ref}"]) <= tol
    assert _rel(B, d[f"B_{ref}"]) <= tol


def test_kernel_step_gradient_matches_plain_autograd(pinch):
    """The differentiable step (its forward, then the twin recomputed in
    the backward) through H=2 steps from the pinch gives plain autograd's
    gradient through the twin itself, bit for bit here; rollout_states'
    batched linearisation and adjoint give it to float32 rounding. The
    model is built at 1 substep to keep it fast: the claim is about the
    mechanism, not the model."""
    _, st, d = pinch
    m = _model("pandaPick-v0", 1)
    n_arm = m.arm.n_arm

    def flat(step):
        def f(x, u):
            s = IL._inject(st, x)
            X2, C = step(fs.pack_state(m.cfg, m.tree, s), u.T.contiguous())
            s2 = fs.unpack_state(m.cfg, m.tree, X2, s)
            return IL._extract(s2.replace(ctrl_q=C[:n_arm].T, grip=C[n_arm]))
        return f

    f_k = flat(core._stepper(m))
    f_p = flat(fs.make_reference_step(*m, with_ctrl=True))
    us0 = torch.as_tensor(d["us0"][:2])
    v = torch.as_tensor(np.random.RandomState(1).standard_normal(
        (2, d["x0"].size)), dtype=torch.float32)

    def grad(roll):
        x0 = IL._extract(st)[0].clone().requires_grad_()
        us = us0.clone().requires_grad_()
        return torch.autograd.grad((roll(x0, us) * v).sum(), (x0, us))

    def stepwise(f):
        def roll(x0, us):
            x, xs = x0[None], []
            for t in range(us.shape[0]):
                x = f(x, us[t:t + 1])
                xs.append(x[0])
            return torch.stack(xs)
        return roll

    g_plain = grad(stepwise(f_p))
    g_step = grad(stepwise(f_k))
    g_roll = grad(lambda x0, us: gs.rollout_states(f_k, x0, us))
    for p, k, r in zip(g_plain, g_step, g_roll):
        assert torch.isfinite(p).all() and float(p.abs().max()) > 0
        assert torch.equal(k, p)
        assert _rel(r, p) <= 1e-5


def test_ilqr_plan_improves_reach(reach, planned):
    """JAX's test at 3 substeps, H=4, iters=4: strict improvement, finite
    controls; c0 of the zero plan, the cost trace and the controls are
    JAX's (the Jacobians agree there, see above)."""
    m, st, d = reach
    res, c0, _, _, _ = planned("reach", m, st, d)
    assert c0 == pytest.approx(float(d["c0"]), rel=COST_REL)
    assert float(res.cost) < c0
    assert torch.isfinite(res.us).all()
    assert res.us.shape == d["us0"].shape
    assert res.xs.shape == (5, d["x0"].size)
    np.testing.assert_allclose(res.cost_trace, d["cost_trace"],
                               rtol=COST_REL)
    np.testing.assert_allclose(res.us, d["us"], atol=US_ABS)


def test_ilqr_plan_improves_pick_contact(pinch, planned):
    """iLQR THROUGH contact, JAX's criteria: from the scripted pinch (floor
    and pad rows active), at 2 substeps, the goal-only cost's gradient is
    finite and informative, and ilqr_plan (H=3, iters=3) improves the hold
    plan's cost by more than 5 % (1.90 → 1.54, JAX's own figure); c0, the
    gradient, the trace and the controls are held to JAX's."""
    m, st, d = pinch
    us0 = torch.as_tensor(d["us0"])
    f = IL.make_flat_dynamics(m, st)
    stage, final = IL.make_stage_cost(m, st, PLANS["pinch"][1])
    x0 = IL._extract(st)[0].clone().requires_grad_()
    u0 = us0.clone().requires_grad_()
    _, c0 = IL._rollout_flat(f, stage, final, x0, u0)
    gx, gu = torch.autograd.grad(c0, (x0, u0))
    c0 = float(c0.detach())
    assert c0 == pytest.approx(float(d["c0"]), rel=COST_REL)
    assert torch.isfinite(gx).all(), "NaN/inf d cost/d x0 through contact"
    assert torch.isfinite(gu).all(), "NaN/inf d cost/d us through contact"
    assert float(gu.abs().max()) > 1e-3, "dead action gradient"
    assert int((gx != 0).sum()) > 0, "dead state gradient"
    # JAX's gradient is the oracle's: the action gradient within 5.6e-6 of
    # its largest entry, the state gradient (through the contact rows the
    # two physics compute by other algorithms) within 2.6e-4
    assert _rel(gu, d["gu"]) <= 1e-4
    assert _rel(gx, d["gx"]) <= 1e-3
    res, c0_plan, _, _, _ = planned("pinch", m, st, d)
    assert c0_plan == c0
    assert torch.isfinite(res.us).all()
    assert torch.isfinite(res.cost_trace).all()
    assert float(res.cost) < 0.95 * c0
    np.testing.assert_allclose(res.cost_trace, d["cost_trace"],
                               rtol=COST_REL)
    np.testing.assert_allclose(res.us, d["us"], atol=US_ABS)


def test_gradient_refine_improves_reach():
    """refine on JAX's reset state (PRNGKey 5) at JAX's learning rate: the
    first three losses are JAX's (the same zero plan and Adam steps through
    the lane twin instead of the oracle), and the
    third is below the first, as in JAX's trace (Adam's first step of lr
    in every coordinate overshoots: 2.05 → 2.99 → 2.03)."""
    m, st, d = _case("ilqr_refine", "UR5Reach-v0")
    a, trace = GR.refine(m, st, torch.as_tensor(d["us0"]),
                         GR.GradConfig(iters=3, lr=float(d["lr"])))
    np.testing.assert_allclose(trace, d["trace"][:3], rtol=COST_REL)
    assert float(trace[-1]) < float(trace[0])
    assert torch.isfinite(a).all()
    assert a.shape == d["us0"].shape
