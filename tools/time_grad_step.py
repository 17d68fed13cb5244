"""Time the gradient solvers' derivative paths on the card.

    python3 tools/time_grad_step.py

On UR5Reach-v0 at the env step's fidelity (12 substeps), from the
committed JAX reset state of tests/torch_fixtures/ilqr_refine.npz:

* the plain twin's VJP (make_reference_step, with_ctrl) at B = 10 x 52,
  eagerly on the caller's thread, then the same call inside the backward
  of an autograd Function, where autograd runs it on its device thread:
  why ops/grad_step.py captures the VJP's CUDA graph from the forward;
* the gradient of the iLQR cost of an H=10 plan two ways: per step
  (autograd through H KernelStep nodes, H replays of the twin's VJP at
  B=1) and rollout-level (grad_step.rollout_states: one linearisation at
  B = H x 52, then the adjoint recursion), three calls each, the first
  with its capture. refine's Adam step runs the rollout-level one.

Times are host seconds between synchronizations. Needs one CUDA card; the
kernels build at first use (ops/cuda_build.py).
"""
import importlib
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

H = 10


def sync():
    torch.cuda.synchronize()
    return time.perf_counter()


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this times the card")
    import _torch_port as tp
    from roboticsplayroompybullet_torch import interop
    from roboticsplayroompybullet_torch.envs import core
    from roboticsplayroompybullet_torch.envs.config import CATALOG
    from roboticsplayroompybullet_torch.ops import fused_step as fs
    IL = importlib.import_module("roboticsplayroompybullet_torch.solver.ilqr")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    m = core.build_model(CATALOG["UR5Reach-v0"])
    d = tp.load("ilqr_refine")
    st = interop.state_from_numpy({f: d[f] for f in interop.FIELDS},
                                  device=dev)
    x0 = IL._extract(st)[0]
    n = x0.shape[0]

    # the twin's VJP on the caller's thread and on autograd's
    B = H * n
    X = fs.pack_state(m.cfg, m.tree, IL._inject(st, x0.expand(B, n)))
    a = torch.zeros((m.cfg.action_dim, B), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    gX = torch.randn(X.shape, generator=g, device=dev)
    gC = torch.randn((m.arm.n_arm + 1, B), generator=g, device=dev)
    twin = fs.make_reference_step(*m, with_ctrl=True)
    with torch.no_grad():
        twin(X, a)                        # the constants the twin caches

    def vjp():
        with torch.enable_grad():
            Xg, ag = X.clone().requires_grad_(), a.clone().requires_grad_()
            t0 = sync()
            out = twin(Xg, ag)
            t1 = sync()
            torch.autograd.grad(out, (Xg, ag), (gX, gC))
            return t1 - t0, sync() - t1

    class InBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, grad):
            ctx.times = vjp()
            return grad

    fwd, bwd = vjp()
    print(f"[vjp] B={B}, caller's thread: forward {fwd:.2f} s, backward "
          f"{bwd:.2f} s", flush=True)
    probe = torch.zeros(1, device=dev, requires_grad=True)
    out = InBackward.apply(probe)
    torch.autograd.grad(out.sum(), probe)
    fwd, bwd = out.grad_fn.times
    print(f"[vjp] B={B}, inside a backward (autograd's device thread): "
          f"forward {fwd:.2f} s, backward {bwd:.2f} s", flush=True)

    # refine's gradient, per step and rollout-level
    f = IL.make_flat_dynamics(m, st)
    stage, final = IL.make_stage_cost(m, st)

    def per_step(us):
        x, c = x0[None], 0.0
        for t in range(H):
            c = c + stage(x, us[t:t + 1]).sum()
            x = f(x, us[t:t + 1])
        return c + final(x).sum()

    def rollout_level(us):
        return IL._rollout_flat(f, stage, final, x0, us)[1]

    for name, loss in (("rollout-level", rollout_level),
                       ("per-step", per_step)):
        for i in range(3):
            us = torch.full((H, m.cfg.action_dim), 0.01 * i, device=dev,
                            requires_grad=True)
            t0 = sync()
            c = loss(us)
            t1 = sync()
            grad, = torch.autograd.grad(c, us)
            t2 = sync()
            print(f"[grad] {name} H={H} call {i}: forward {t1 - t0:.3f} s, "
                  f"backward {t2 - t1:.3f} s, max |d/dus| "
                  f"{float(grad.abs().max()):.4f}", flush=True)
    v = core._stepper(m).vjp
    print(f"[grad] the twin's VJP graphs: widths "
          f"{sorted(k[1] for k in v.graphs)}, {v.captures} captures, "
          f"{v.replays} replays, {v.eager} eager calls", flush=True)


if __name__ == "__main__":
    main()
