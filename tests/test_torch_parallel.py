"""PyTorch port: the multi-device layer (parallel/mesh.py, the sharded
rollouts and step, the population-sharded planners and their collectives,
tools/launch_distributed_torch.py) on the CPU over gloo.

The checks run once, in processes spawned together (`spawned`): two gloo
ranks for the world-size-2 checks and, beside them, the launcher in a
world of one, followed by the scaling tool in a world of two; each is joined with a timeout and hands its arrays back
through a file, which the tests below read. The JAX side comes from committed fixtures
(tools/gen_port_fixtures.py: JAX's sharded planners on a 2-device CPU
mesh, a checkpoint written by tools/launch_distributed.py); no JAX runs
here.

Tolerances: the sharded rollouts, step and the gathered costs equal the
unsharded calls at the shard's width bit for bit, and the unsharded call
on the whole batch bit for bit where there is no contact; the plain
twin's contact arithmetic rounds by batch width (up to 7e-8 on the
flagship's block velocities at 4 against 2 envs), so there atol 1e-6
(on the card the kernel is width-invariant: chip_smoke.py's [multi]
holds it bit for bit at B=4096); the
grouped MPPI/CEM updates against the ungrouped ones on the whole
population atol 1e-5 (float32 sums in another order; CEM's threshold, a
gathered cost, exact); the planners against JAX's at
tests/test_torch_mpc.py's bounds: plan means p99 <= 1e-3 and max <= 5e-2,
best costs rtol 1e-4.
"""
import os
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from roboticsplayroompybullet_torch import interop
from roboticsplayroompybullet_torch.envs import core
from roboticsplayroompybullet_torch.envs.config import CATALOG
from roboticsplayroompybullet_torch.envs.state import EnvState

import _torch_port as tp

torch.set_num_threads(1)
T = torch.tensor
WORLD = 2
JOIN_S = 240                 # a hung collective fails the fixture, no more
MESHES = (("env", 1), ("dcn_env", 2))
# the fixtures' algorithms: the fused planner both, make_sharded_planner
# CEM (the dryrun's; it scores at the env step's full IK, seconds a call)
ALGOS = {"fused": ("mppi", "cem"), "plan": ("cem",)}


def _state(z, n=None, device="cpu"):
    return interop.state_from_numpy(
        {k[3:]: (v if n is None else v[:n]) for k, v in z.items()
         if k.startswith("in_")}, device)


def _np(tree, prefix):
    """{prefix + field: numpy} of an EnvState, a PlanState, a dict of
    tensors or a tensor."""
    if isinstance(tree, EnvState):
        tree = vars(tree)
    if isinstance(tree, dict):
        return {f"{prefix}.{k}": v.numpy() for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f"{prefix}.{k}": getattr(tree, k).numpy()
                for k in tree._fields}
    return {prefix: tree.numpy()}


# ---------------------------------------------------------------------------
# the two ranks
# ---------------------------------------------------------------------------

def _jax_planners(rank, out):
    """Both sharded planners on JAX's normals, each mesh, MPPI and CEM."""
    import dataclasses
    from roboticsplayroompybullet_torch.parallel import mesh as M
    from roboticsplayroompybullet_torch.solver import mpc
    draw = mpc._normals
    for name, make in (("fused", "make_sharded_fused_planner"),
                       ("plan", "make_sharded_planner")):
        z = tp.load(f"parallel_{name}_UR5Reach")
        cfg0 = CATALOG["UR5Reach-v0"]
        if name == "plan":
            cfg0 = dataclasses.replace(cfg0, substeps=int(z["substeps"]))
        m = core.build_model(cfg0)
        st = interop.state_from_numpy(
            {k[3:]: v[None] for k, v in z.items() if k.startswith("in_")},
            "cpu")
        for mesh_name, hosts in MESHES:
            mesh = M.make_mesh(n_hosts=hosts, device="cpu")
            for algo in ALGOS[name]:
                kw = dict(horizon=int(z["horizon"]), pop=int(z["pop"]),
                          iters=int(z["iters"]), algorithm=algo)
                if name == "fused":
                    kw.update(preview_ik_iters=int(z["preview_ik_iters"]),
                              preview_solve_iters=int(
                                  z["preview_solve_iters"]))
                    extra = dict(n_substeps=int(z["n_substeps"]))
                else:
                    extra = {}
                cfg = mpc.MPCConfig(**kw)
                normals = iter(T(z["normals"]))
                mpc._normals = (lambda gen, shape, device:
                                next(normals).reshape(shape))
                try:
                    with torch.no_grad():
                        pl, best = getattr(mpc, make)(m, cfg, mesh, **extra)(
                            st, mpc.init_plan(m, cfg, device="cpu"),
                            torch.Generator())
                finally:
                    mpc._normals = draw
                assert next(normals, None) is None   # one draw an iteration
                key = f"{name}_{mesh_name}_{algo}"
                out.update(_np(pl, key))
                out[f"{key}_best"] = best.numpy()


def _sharded_paths(rank, out):
    """Sharded rollout / step / fused rollout on this rank's block of 4
    envs, gathered; then the unsharded calls: rank 0 on all 4 envs
    ("all"), rank 1 the fused rollout on each 2-env block ("blk")."""
    import dataclasses
    from roboticsplayroompybullet_torch.parallel import fused as F
    from roboticsplayroompybullet_torch.parallel import mesh as M
    from roboticsplayroompybullet_torch.parallel import rollout as R
    mesh = M.make_mesh(n_hosts=2, device="cpu")
    B = 4
    z = tp.load("rollout_UR5Reach")
    m = core.build_model(dataclasses.replace(CATALOG["UR5Reach-v0"],
                                             substeps=2))
    st, acts = _state(z, B), T(z["actions"][:B])
    zf = tp.load("rollout_UR5PlayAbsRPY1Obj")
    mf = core.build_model(CATALOG["UR5PlayAbsRPY1Obj-v0"])
    stf, actsf = _state(zf, B), T(zf["actions"][:B])
    kw = dict(ik_iters=2, solve_iters=4, n_substeps=2)
    H = acts.shape[1]
    calls = {
        "rollout": (R.make_sharded_rollout(m, mesh),
                    lambda s, a: R.batched_rollout(m, s, a), st, acts),
        "step": (R.make_sharded_step(m, mesh),
                 lambda s, a: R.batched_step(m, s, a), st, acts[:, 0]),
        "fused": (F.make_sharded_fused_rollout(mf, mesh, H, **kw),
                  F.make_fused_rollout_whole(mf, H, **kw), stf, actsf)}

    def flat(res, tag):
        for i, x in enumerate(res):              # step: obs, info are dicts
            out.update(_np(x, f"{tag}{i}"))

    def gathered(x):
        if isinstance(x, dict):
            return {k: M.gather_batch(v, mesh) for k, v in x.items()}
        return M.gather_batch(x, mesh)

    with torch.no_grad():
        for name, (sharded, whole, s, a) in calls.items():
            res = sharded(M.shard_batch(s, mesh), M.shard_batch(a, mesh))
            flat([gathered(x) for x in res], f"{name}_sh")
            if rank == 0:
                flat(whole(s, a), f"{name}_all")
            elif name == "fused":
                for blk in range(2):
                    rows = slice(2 * blk, 2 * blk + 2)
                    flat(whole(EnvState(**{k: v[rows] for k, v in
                                           vars(s).items()}), a[rows]),
                         f"{name}_blk{blk}_")


def _collectives(rank, out):
    """Mesh order, the grouped updates, success_rate, the refusal of a
    CUDA device on a gloo group."""
    from roboticsplayroompybullet_torch.parallel import mesh as M
    from roboticsplayroompybullet_torch.parallel import rollout as R
    from roboticsplayroompybullet_torch.solver import mpc
    for name, hosts in MESHES:
        mesh = M.make_mesh(n_hosts=hosts, device="cpu")
        glob = torch.arange(8.0).reshape(8, 1)
        sh = M.shard_batch(glob, mesh)
        out[f"{name}_rank"] = np.asarray(M.mesh_rank(mesh))
        out[f"{name}_shard"] = sh.numpy()
        out[f"{name}_gathered"] = M.gather_batch(sh, mesh).numpy()
    sub = M.make_mesh(n_devices=1, device="cpu")
    out["sub_rank"] = np.asarray(-1 if M.mesh_rank(sub) is None
                                 else M.mesh_rank(sub))
    try:
        M.make_mesh(device="cuda")
        out["cuda_refused"] = np.asarray(False)
    except ValueError:
        out["cuda_refused"] = np.asarray(True)

    mesh = M.make_mesh(n_hosts=2, device="cpu")
    group = M.mesh_group(mesh)
    acts, costs, mean, sigma = _update_inputs()
    n = costs.shape[-1] // WORLD
    mine = slice(rank * n, (rank + 1) * n)
    out["gathered_costs"] = mpc._all_gather_last(costs[:, mine], group).numpy()
    for algo in ("mppi", "cem"):
        cfg = mpc.MPCConfig(pop=costs.shape[-1], elite_frac=0.3,
                            algorithm=algo)
        update = mpc._update_fn(cfg)
        pl = mpc.PlanState(mean, sigma)
        for tag, args in (("grouped", (acts[:, mine], costs[:, mine], group)),
                          ("whole", (acts, costs))):
            new, best = update(pl, cfg, *args)
            out.update(_np(new, f"{algo}_{tag}"))
            out[f"{algo}_{tag}_best"] = best.numpy()
    rewards = T([0.0, 0.0, -1.0]) if rank == 0 else T([-1.0, -1.0, 0.0])
    out["local_rate"] = R.success_rate(rewards).numpy()
    out["global_rate"] = R.success_rate(rewards, mesh).numpy()


def _update_inputs():
    """2 envs x 10 candidates (5 a rank); costs with the elite's 3rd
    smallest cost on both ranks (a tie at the threshold)."""
    rs = np.random.RandomState(5)
    E, n, H, A = 2, 10, 3, 4
    acts = rs.uniform(-1, 1, (E, n, H, A)).astype(np.float32)
    costs = rs.uniform(0.5, 2.0, (E, n)).astype(np.float32)
    costs[:, [0, 6]] = [0.1, 0.2]
    costs[:, [2, 8]] = 0.3
    mean = rs.uniform(-0.5, 0.5, (E, H, A)).astype(np.float32)
    sigma = rs.uniform(0.1, 0.5, (E, H, A)).astype(np.float32)
    return T(acts), T(costs), T(mean), T(sigma)


ARGV = ["--device", "cpu", "--env", "UR5Reach-v0", "--ckpt-every", "1",
        "--pop", "8", "--horizon", "2", "--iters", "1", "--dryrun"]


def _scaling(rank, store, out_dir):
    """tools/scaling_torch.py in a gloo world of two (UR5Reach, 2 envs a
    rank, H=1), mesh sizes 1 and 3: a one-rank mesh inside the world,
    rank 1 off it, then a size the world lacks. Rank 0 writes
    out_dir/scaling.json; the tool ends the process group."""
    sys.path.insert(0, os.path.join(tp.ROOT, "tools"))
    import scaling_torch
    dist.init_process_group("gloo", init_method=f"file://{store}_scaling",
                            rank=rank, world_size=2)
    scaling_torch.main(["--device", "cpu", "--env", "UR5Reach-v0",
                        "--horizon", "1", "--per-device", "2", "--reps", "1",
                        "--devices", "1", "3", "--out",
                        os.path.join(out_dir, "scaling.json")])


def _launcher(store, out_dir):
    """tools/launch_distributed_torch.py in a world of one (tests/
    test_tools.py's launcher test): 2 steps with a checkpoint every step,
    a relaunch to 4; then JAX's checkpoint restored (`restore`) and
    resumed for one step. The checkpoints and summaries go to out_dir;
    then, as rank 0 of a world of two, tools/scaling_torch.py
    (`_scaling`)."""
    import json
    import shutil
    sys.path.insert(0, os.path.join(tp.ROOT, "tools"))
    import launch_distributed_torch as ld
    from roboticsplayroompybullet_torch.solver import mpc
    ck, summ = os.path.join(out_dir, "mpc_ckpt.npz"), {}
    for steps in (2, 4):
        summ[steps] = ld.run_loop(ld.parse_args(
            ARGV + ["--steps", str(steps), "--ckpt", ck]))
        dist.destroy_process_group()
        shutil.copy(ck, os.path.join(out_dir, f"port_step{steps}.npz"))
    z = tp.load("launch_ckpt_UR5Reach")
    jck = os.path.join(out_dir, "jax_ckpt.npz")
    with open(jck, "wb") as f:
        f.write(z["ckpt"].tobytes())
    m = core.build_model(CATALOG["UR5Reach-v0"])
    cfg = mpc.MPCConfig(horizon=int(z["horizon"]))
    st, plan, step = ld.restore(jck, tp.zero_state(m.cfg, m.tree, 1),
                                mpc.init_plan(m, cfg, device="cpu"))
    snap = ld.snapshot(st, plan, step)
    np.savez(os.path.join(out_dir, "jax_restored.npz"),
             **{f"leaf_{i}": np.asarray(v) for i, v in
                enumerate(snap.values())}, __n_leaves__=len(snap))
    summ["jax"] = ld.run_loop(ld.parse_args(
        ARGV + ["--steps", str(step + 1), "--ckpt", jck]))
    summ["jax_step"] = step
    dist.destroy_process_group()
    with open(os.path.join(out_dir, "launcher.json"), "w") as f:
        json.dump(summ, f)
    _scaling(0, store, out_dir)


def _run(rank, world, store, out_dir):
    """Process `rank` of the spawn: a gloo rank of the world-2 checks;
    (rank == world) the launcher in its own world of one, then rank 0 of
    the scaling tool's world of two; (rank == world + 1) that world's
    rank 1."""
    torch.set_num_threads(1)
    name = {world: "launcher", world + 1: "scaling"}.get(rank, f"rank{rank}")
    try:
        if rank == world:
            _launcher(store, out_dir)
            return
        if rank == world + 1:
            _scaling(1, store, out_dir)
            return
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        out = {}
        for part in (_collectives, _sharded_paths, _jax_planners):
            part(rank, out)
        np.savez(os.path.join(out_dir, f"{name}.npz"), **out)
    except BaseException:
        with open(os.path.join(out_dir, f"{name}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The directory of the spawned checks' results: rank0.npz,
    rank1.npz, the launcher's checkpoints, launcher.json and
    scaling.json."""
    d = tmp_path_factory.mktemp("world2")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_run,
                         args=(r, WORLD, str(d / "store"), str(d)))
             for r in range(WORLD + 2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errs = "\n".join(open(f).read() for f in sorted(map(str, d.glob("*.err"))))
    assert not hung, f"{len(hung)} process(es) still running after {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), errs
    return d


@pytest.fixture(scope="module")
def world2(spawned):
    """The per-rank results of the world-size-2 checks: [rank 0, rank 1]."""
    res = []
    for r in range(WORLD):
        with np.load(spawned / f"rank{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return res


# ---------------------------------------------------------------------------
# mesh order, refusal, collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [name for name, _ in MESHES])
def test_shard_batch_follows_jax_order(world2, mesh):
    """Rank r is linear mesh index r and holds global rows [4r, 4r + 4),
    as JAX's P(("dcn", "env")); gather_batch gives the batch back."""
    for r, res in enumerate(world2):
        assert int(res[f"{mesh}_rank"]) == r
        np.testing.assert_array_equal(res[f"{mesh}_shard"][:, 0],
                                      np.arange(4 * r, 4 * r + 4))
        np.testing.assert_array_equal(res[f"{mesh}_gathered"][:, 0],
                                      np.arange(8))


def test_smaller_mesh_leaves_ranks_off_it(world2):
    """A 1-D mesh of one rank in a world of two: rank 0 is its index 0,
    rank 1 holds no coordinate."""
    assert [int(res["sub_rank"]) for res in world2] == [0, -1]


def test_cuda_device_on_a_gloo_group_raises(world2):
    assert all(bool(res["cuda_refused"]) for res in world2)


def test_success_rate_is_global(world2):
    """Each rank's 3 rewards: 2/3 and 1/3 succeed locally, 1/2 globally."""
    np.testing.assert_allclose([float(r["local_rate"]) for r in world2],
                               [2 / 3, 1 / 3], rtol=1e-6)
    for res in world2:
        assert float(res["global_rate"]) == 0.5


@pytest.mark.parametrize("algo", ["mppi", "cem"])
def test_grouped_update_equals_whole_population(world2, algo):
    """_mppi_update / _cem_update over a process group, each rank 5 of
    the 10 candidates of 2 envs, against the ungrouped update on all 10;
    CEM's 3rd smallest cost ties across the ranks (4 elite). The gathered
    costs are the whole population's, in rank order, and the best cost
    each update returns is the whole population's least."""
    _, costs, _, _ = _update_inputs()
    for res in world2:
        np.testing.assert_array_equal(res["gathered_costs"], costs.numpy())
        for tag in ("grouped", "whole"):
            np.testing.assert_array_equal(res[f"{algo}_{tag}_best"],
                                          costs.numpy().min(-1))
        for f in ("mean", "sigma"):
            np.testing.assert_allclose(res[f"{algo}_grouped.{f}"],
                                       res[f"{algo}_whole.{f}"], rtol=0,
                                       atol=1e-5, err_msg=f)
    for f in ("mean", "sigma"):
        np.testing.assert_array_equal(world2[0][f"{algo}_grouped.{f}"],
                                      world2[1][f"{algo}_grouped.{f}"])


@pytest.mark.parametrize("path", ["rollout", "step", "fused"])
def test_sharded_path_equals_unsharded(world2, path):
    """make_sharded_rollout and make_sharded_step (UR5Reach, 2 substeps)
    and make_sharded_fused_rollout (the flagship, preview IK 2 / solve 4,
    2 substeps) on a 2x1 ("dcn", "env") mesh, gathered, against the
    unsharded call on all 4 envs: bit for bit without contact; through the
    flagship's contact bit for bit the unsharded call on each rank's 2
    envs, and within 1e-6 the one on all 4 (see the module's
    tolerances)."""
    res, res1 = world2
    sh = sorted(k for k in res if k.startswith(f"{path}_sh"))
    assert sh and len(sh) == len([k for k in res
                                  if k.startswith(f"{path}_all")])
    for k in sh:
        np.testing.assert_array_equal(res[k], res1[k], err_msg=k)
        whole = res[k.replace("_sh", "_all", 1)]
        if path != "fused":
            np.testing.assert_array_equal(res[k], whole, err_msg=k)
            continue
        blocks = np.concatenate([res1[k.replace("_sh", f"_blk{b}_", 1)]
                                 for b in range(2)])
        np.testing.assert_array_equal(res[k], blocks, err_msg=k)
        np.testing.assert_allclose(res[k], whole, rtol=0, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the sharded planners against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mesh,algo", [
    (n, mesh, a) for n, algos in ALGOS.items() for mesh, _ in MESHES
    for a in algos])
def test_sharded_planner_matches_jax(world2, name, mesh, algo):
    """make_sharded_fused_planner (UR5Reach, pop 256 = 2 x 128, H=2, 2
    substeps, preview IK 2 / solve 4, 2 iterations, MPPI and CEM) and
    make_sharded_planner (CEM, pop 4, H=2, 2 substeps, 2 iterations) on 2
    gloo ranks and JAX's shards' normals, against JAX's sharded planners
    on a 2-device mesh of the same shape. Both ranks return the same
    plan."""
    z = tp.load(f"parallel_{name}_UR5Reach")
    key, jkey = f"{name}_{mesh}_{algo}", f"{mesh}_{algo}"
    r0, r1 = world2
    for f in ("mean", "sigma"):
        np.testing.assert_array_equal(r0[f"{key}.{f}"], r1[f"{key}.{f}"])
        d = np.abs(r0[f"{key}.{f}"] - z[f"{jkey}_{f}"])
        assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 5e-2, (f, d.max())
    np.testing.assert_allclose(r0[f"{key}_best"], z[f"{jkey}_best"],
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the launcher (world size 1)
# ---------------------------------------------------------------------------

def _leaves(path):
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(int(z["__n_leaves__"]))]


def _summaries(spawned):
    import json
    with open(spawned / "launcher.json") as f:
        return json.load(f)


def test_launcher_restart_resumes(spawned):
    """Abort-and-restart (tests/test_tools.py's launcher test, world of
    one): 2 steps with a checkpoint every step, then a relaunch to 4
    resumes at step 2. The checkpoint has the JAX launcher's leaves:
    count, shapes, dtypes."""
    out = _summaries(spawned)
    assert out["2"]["start"] == 0 and out["2"]["steps_run"] == 2
    assert out["2"]["mesh"] == {"env": 1}
    assert out["4"]["start"] == 2 and out["4"]["steps_run"] == 2
    step2, step4 = (_leaves(spawned / f"port_step{n}.npz") for n in (2, 4))
    assert (int(step2[-1]), int(step4[-1])) == (2, 4)
    jax = [np.asarray(v) for v in _leaves(spawned / "jax_restored.npz")]
    assert [(a.shape, a.dtype) for a in step2] == [(a.shape, a.dtype)
                                                  for a in jax]


def test_launcher_restores_a_jax_checkpoint(spawned):
    """A checkpoint tools/launch_distributed.py wrote (1 dryrun step on
    UR5Reach) restores in the port's launcher leaf for leaf, dtypes
    included, and the relaunch resumes at its step."""
    z = tp.load("launch_ckpt_UR5Reach")
    path = spawned / "jax_written.npz"
    path.write_bytes(z["ckpt"].tobytes())
    jax, mine = _leaves(path), _leaves(spawned / "jax_restored.npz")
    assert len(mine) == len(jax)
    for i, (a, b) in enumerate(zip(mine, jax)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    out = _summaries(spawned)
    step = int(z["steps"])
    assert out["jax_step"] == step
    assert out["jax"]["start"] == step and out["jax"]["steps_run"] == 1
    assert int(_leaves(spawned / "jax_ckpt.npz")[-1]) == step + 1


def test_scaling_tool_skips_what_the_world_lacks(spawned):
    """tools/scaling_torch.py in a world of two, mesh sizes 1 and 3: one
    row for 1, a one-rank mesh inside the world (its own efficiency 1;
    rank 1 off it, adding no time), none for 3 (printed as skipped)."""
    import json
    with open(spawned / "scaling.json") as f:
        out = json.load(f)
    assert out["meta"]["device"] == "cpu" and out["meta"]["weak_scaling"]
    (row,) = out["rows"]
    assert row["devices"] == 1 and row["batch"] == 2
    assert row["mesh"] == {"env": 1} and row["efficiency"] == 1.0
    assert row["rollouts_per_s"] > 0


# ---------------------------------------------------------------------------
# process-group start, profiling
# ---------------------------------------------------------------------------

def test_initialize_refuses_what_it_cannot_start(monkeypatch):
    """No backend for another device; a world of several processes needs
    a rendezvous (torchrun's or an init_method)."""
    from roboticsplayroompybullet_torch.parallel import mesh as M
    assert (M.backend_for("cuda"), M.backend_for("cpu")) == ("nccl", "gloo")
    with pytest.raises(ValueError):
        M.backend_for("meta")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="rendezvous|MASTER_ADDR"):
        M.initialize("cpu", rank=0, world_size=2)
    assert not dist.is_initialized()


def test_profiling_timeit_and_trace(tmp_path):
    """timeit: the best of its reps, each call waited for; trace: a
    Chrome trace of the block."""
    from roboticsplayroompybullet_torch.utils import profiling
    x = torch.ones(64, 64)
    calls = []

    def fn(a):
        calls.append(1)
        return {"y": (a @ a,)}

    secs = profiling.timeit(fn, x, warmup=2, reps=3)
    assert len(calls) == 5 and 0.0 < secs < 10.0
    with profiling.trace(str(tmp_path / "tb")) as prof:
        fn(x)
    assert prof.key_averages()
    assert (tmp_path / "tb" / "trace.json").stat().st_size > 0
