// Fused playroom physics for NVIDIA Hopper (sm_90a): one warp per env.
//
// Replaces the three Pallas TPU kernels of
// roboticsplayroompybullet_tpu/ops/fused_step.py, which share one body (the
// "lane twin"):
//   fs_sim      <- make_pallas_sim      12 substeps from given servo targets
//   fs_step     <- make_pallas_step     control (decode + DLS IK) + substeps
//   fs_rollout  <- make_pallas_rollout  H x [control + substeps + ag] in one
//                                       launch
// The plain PyTorch version of the same body is
// roboticsplayroompybullet_torch/ops/fused_step.py (make_reference_*); the
// wrappers there build the model constants, allocate outputs and launch.
//
// What bounds it on this card: not memory. Each env reads its packed state
// (NF floats, 45 for the UR5 playroom) and its actions once per launch and
// writes the state (and the achieved goals) once, ~0.4 KB per control step,
// against ~1.8 MFLOP of float32 work per env and control step (12 x [FK,
// ABA over a 12-link tree with 6x6 articulated inertias, ~76 contact rows,
// 9 Jacobi sweeps] + 24 IK iterations; PERF.md counts it). So the bound is
// the FP32 pipes (control, ~3 % of the FLOPs, runs in double: see
// control below). The work is tree-structured recurrence on 6x6 and 3x3
// blocks held at full float32, not matrix products: the tensor cores do
// not apply (TF32 would drop the precision the twin bounds hold, and 6x6
// tiles are far below an mma tile), and neither TMA nor cp.async pays for
// ~0.4 KB per env and control step.
//
// The design: a team of FS_TEAM = 32 lanes (one warp) owns one env, and
// FS_ENVS = 4 envs share a block. The working set lives in registers and
// shared memory, never in local memory (chip_smoke.py fails the build on
// a stack frame over 1 KB or any spill):
// - the model constants: one copy per block in shared memory, loaded by the
//   whole block at its start;
// - the env's state, link kinematics, ABA arrays, solver context and body
//   velocities: one EnvSh per env in shared memory (FS_ENV_FIELDS);
// - the contact rows and their warm-started impulses λ: in registers of
//   the lane that owns them. The rows of a model are static (the host
//   writes their table, row_code); lane l owns rows l, l + 32, ... in
//   FS_SLOTS compile-time slots, gathers them (deepest-box selection
//   included, first max wins), computes their effective masses and their
//   part of every Jacobi sweep. The per-body sums of a sweep (and the
//   mass-splitting counts) are butterfly reductions over the warp
//   (__shfl_xor_sync), which leave the same bits in every lane. One kernel
//   has one register count, so the slot count is that of the largest model
//   (FS_MAX_ROWS = 136 rows: 5 slots); unused slots are predicated off.
// - ABA's backward pass spreads the 36 entries of each link's 6x6 products
//   (Ia - U U^T / D, Ia X, X^T Ia X) over the lanes; IK spreads the
//   Jacobian columns, the 21 entries of J J^T and the joint updates. What
//   is serial along the tree (FK, ABA's forward passes, the 6x6 Cholesky,
//   integration) runs in lane 0, and __syncwarp publishes it. Every
//   entry a lane computes sums in the order the one-thread body did, so
//   only the sweep's per-body sums and the counts change the order.
// Occupancy (sm_90a, PERF.md): 249-251 registers a thread, so 8 warps an
// SM (2 blocks); 37,696 bytes of shared memory a block; B=4096 takes 3.9
// waves of 1056 envs. Measured, more resident warps do not help: 3 row
// slots (168 registers, 12 warps an SM) run no faster, the rows in shared
// memory (94 registers, 12 warps) 1.7x slower, and B=1024 (one wave)
// already reaches the rollouts/s of B=16384. The lanes of a warp share
// its instruction slots, so work that only lane 0 does costs the warp:
// what can run per link or per item (joint rotations and transforms, pad
// kinematics, solver context, Jacobian columns) is spread over the lanes.
// ABA's forward passes stay in lane 0: spread over six lanes a link, with
// two more syncs a link, they ran 3.6 % slower.
// State is read and written as X[r*B + b] (lane r reads row r). The rollout
// loops over the horizon inside the warp, so the state never returns to
// device memory between control steps, and its body is the step's body:
// rollout == H launches of step, bit for bit.
//
// Numerics: float32 throughout, constants folded in float64 on the host as
// the JAX trace folds them. Built without --use_fast_math; nvcc contracts
// a*b+c into FMAs by default, which moves results at the rounding level;
// the tolerances the kernel is held to (chip_smoke.py) absorb this
// (-fmad=false is for diagnosing a mismatch only). Python floor-mod is
// x - 2 floor(x/2), never fmodf. First-max ties in the deepest-contact
// selection take the lowest index, as the JAX twin's mask does.
//
// The body is plain C++ behind FS_DEV and the Team struct: without
// __CUDACC__ it compiles with g++ for a one-lane team (FS_G = 1), where
// every reduction is the identity, so a host harness can hold it to the
// plain twin on a machine without a card.

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FS_DEV __device__ __forceinline__
#else
#define FS_DEV static inline
#endif

// compile-time maxima (shared-memory arrays and row slots); loop counts are
// runtime
#define FS_MAX_DOF 12
#define FS_MAX_ARM 7
#define FS_MAX_OBJ 2
#define FS_MAX_STATIC 11
#define FS_N_ART 4
#define FS_MAX_ART_BOXES 6
#define FS_N_PADS 4
#define FS_MAX_GRIP 2
#define FS_MAX_ACT 8
#define FS_MAX_ROWS (FS_MAX_OBJ * (8 + 8 + FS_N_ART * 8 + FS_N_PADS) + 8 \
                     + FS_N_ART * FS_N_PADS + 2 * FS_N_PADS)
// lanes per env on the card, and envs per block
#define FS_TEAM 32
#define FS_ENVS 4
// mass-splitting counts: blocks, articulated elements, gripper, arm
#define FS_N_CNT (FS_MAX_OBJ + FS_N_ART + FS_MAX_GRIP + 1)

#ifdef __CUDACC__
#define FS_G FS_TEAM
#elif !defined(FS_G)
#define FS_G 1
#endif
#define FS_SLOTS ((FS_MAX_ROWS + FS_G - 1) / FS_G)

// action decode modes (envs/config.py action_type)
#define FS_ABS_QUAT 0
#define FS_REL_QUAT 1
#define FS_REL_JOINTS 2
#define FS_ABS_JOINTS 3
#define FS_ABS_RPY 4
#define FS_REL_RPY 5
#define FS_REL_CART 6

// contact-row kinds, in gather_bundles' order
#define FS_ROW_FLOOR 0        // block corner vs floor
#define FS_ROW_STATIC 1       // block corner vs deepest static box
#define FS_ROW_ART 2          // block corner vs deepest box of element k
#define FS_ROW_PAD_BLOCK 3    // pad sphere vs block
#define FS_ROW_BB 4           // block 0's corner vs block 1
#define FS_ROW_PAD_ART 5      // pad vs deepest box of element k
#define FS_ROW_PAD_FLOOR 6    // pad vs floor
#define FS_ROW_PAD_STATIC 7   // pad vs deepest static box
// row_code bits (ops/cuda_build.py::row_table packs them): kind 0-2,
// corner or pad 3-5, object 6, then each solver index + 1: a 7-8, b 9-10,
// articulated element 11-13, gripper slot 14-15, arm-coupled pad 16-18,
// pad velocity 19-21
FS_DEV int row_kind(int c) { return c & 7; }
FS_DEV int row_idx(int c) { return (c >> 3) & 7; }
FS_DEV int row_obj(int c) { return (c >> 6) & 1; }
FS_DEV int row_a(int c) { return ((c >> 7) & 3) - 1; }
FS_DEV int row_b(int c) { return ((c >> 9) & 3) - 1; }
FS_DEV int row_k(int c) { return ((c >> 11) & 7) - 1; }
FS_DEV int row_g(int c) { return ((c >> 14) & 3) - 1; }
FS_DEV int row_pj(int c) { return ((c >> 16) & 7) - 1; }
FS_DEV int row_vk(int c) { return ((c >> 19) & 7) - 1; }

// Model constants: one POD struct. The Python wrapper parses this field
// list (S = scalar, A = array) to lay out the same struct with ctypes, and
// checks the offsets against fs_model_layout().
#define FS_MODEL_FIELDS(S, A)                                               \
  S(int, n_dof) S(int, n_arm) S(int, n_obj) S(int, n_static)                \
  S(int, n_sub) S(int, solve_iters) S(int, ik_iters) S(int, action_type)    \
  S(int, use_orientation) S(int, play) S(int, with_ee) S(int, has_art)      \
  S(int, nf) S(int, action_dim) S(int, ag_dim) S(int, panda)                \
  S(int, n_grip) S(int, ee_parent) S(int, n_rows)                           \
  A(int, parent, FS_MAX_DOF) A(int, revolute, FS_MAX_DOF)                   \
  A(int, ee_anc, FS_MAX_ARM) A(int, pad_parent, FS_N_PADS)                  \
  A(int, pad_slot, FS_N_PADS) A(int, pad_anc, FS_N_PADS * FS_MAX_ARM)       \
  A(int, grip_dof, FS_MAX_GRIP) A(int, servo_kind, FS_MAX_DOF)              \
  A(int, art_rev, FS_N_ART) A(int, art_nb, FS_N_ART)                        \
  A(int, row_code, FS_MAX_ROWS)                                             \
  S(float, dt) S(float, half_dt) S(float, plane_z) S(float, inv_m_blk)      \
  S(float, mu_world) S(float, mu_pad) S(float, mu_art) S(float, mu_bb)      \
  S(float, dial_mul) S(float, dial_div)                                     \
  A(float, base_pos, 3) A(float, base_quat, 4)                              \
  A(float, pre_pos, FS_MAX_DOF * 3) A(float, pre_quat, FS_MAX_DOF * 4)      \
  A(float, axis, FS_MAX_DOF * 3) A(float, lower, FS_MAX_DOF)                \
  A(float, upper, FS_MAX_DOF) A(float, damping, FS_MAX_DOF)                 \
  A(float, inertia6, FS_MAX_DOF * 36) A(float, pris_E, FS_MAX_DOF * 9)      \
  A(float, pris_rax, FS_MAX_DOF * 3) A(float, a_base, 6)                    \
  A(float, ee_pos, 3) A(float, ee_quat, 4)                                  \
  A(float, pad_site_pos, FS_N_PADS * 3) A(float, pad_site_quat, FS_N_PADS * 4) \
  A(float, pad_off, FS_N_PADS * 3) A(float, pad_r, FS_N_PADS)               \
  A(float, servo_a, FS_MAX_DOF) A(float, servo_b, FS_MAX_DOF)               \
  A(float, servo_f, FS_MAX_DOF)                                             \
  A(float, action_high, FS_MAX_ACT) A(float, ctrl_lower, FS_MAX_ARM)        \
  A(float, ctrl_upper, FS_MAX_ARM) A(float, rate_limit, FS_MAX_ARM)         \
  A(float, rest, FS_MAX_ARM)                                                \
  A(float, static_pos, FS_MAX_STATIC * 3) A(float, static_half, FS_MAX_STATIC * 3) \
  A(float, block_half, 3) A(float, block_inv_I, 3)                          \
  A(float, art_anchor, FS_N_ART * 3) A(float, art_axis, FS_N_ART * 3)       \
  A(float, art_box_pos, FS_N_ART * FS_MAX_ART_BOXES * 3)                    \
  A(float, art_box_half, FS_N_ART * FS_MAX_ART_BOXES * 3)                   \
  A(float, art_lower, FS_N_ART) A(float, art_upper, FS_N_ART)               \
  A(float, art_motor_target, FS_N_ART) A(float, art_motor_force, FS_N_ART)  \
  A(float, art_g, FS_N_ART) A(float, art_damp, FS_N_ART)                    \
  A(float, art_motor, FS_N_ART) A(float, art_m, FS_N_ART)                   \
  A(float, inv_m_art, FS_N_ART)

#define FS_DECL_S(t, name) t name;
#define FS_DECL_A(t, name, n) t name[n];
struct Model {
  FS_MODEL_FIELDS(FS_DECL_S, FS_DECL_A)
};

// One env's working set in shared memory: control's in double (first, so
// every array stays aligned; see control below), the rest float arrays, no
// padding (ops/cuda_build.py::launch_smem_bytes lays out the same struct).
// Row-major flat arrays: pos[3*i + c], IA[36*i + 6*r + c], padJ[(7*p + j)*3
// + c], ...
#define FS_ENV_FIELDS(A)                                                    \
  A(double, dpos, FS_MAX_DOF * 3) A(double, dquat, FS_MAX_DOF * 4)          \
  A(double, djrot, FS_MAX_DOF * 4)                                          \
  A(double, tp, 3) A(double, tq, 4) A(double, qs, FS_MAX_DOF)               \
  A(double, xp, 3) A(double, err, 6) A(double, cols, FS_MAX_ARM * 6)        \
  A(double, jjt, 36) A(double, jdn, 6) A(double, wsol, 12)                  \
  A(float, q, FS_MAX_DOF) A(float, qd, FS_MAX_DOF)                          \
  A(float, op, FS_MAX_OBJ * 3) A(float, oq, FS_MAX_OBJ * 4)                 \
  A(float, ov, FS_MAX_OBJ * 3) A(float, ow, FS_MAX_OBJ * 3)                 \
  A(float, aq, FS_N_ART) A(float, aqd, FS_N_ART)                            \
  A(float, pos, FS_MAX_DOF * 3) A(float, quat, FS_MAX_DOF * 4)              \
  A(float, jrot, FS_MAX_DOF * 4)                                            \
  A(float, lv, FS_MAX_DOF * 3) A(float, av, FS_MAX_DOF * 3)                 \
  A(float, E, FS_MAX_DOF * 9) A(float, p, FS_MAX_DOF * 3)                   \
  A(float, c6, FS_MAX_DOF * 6) A(float, v6, FS_MAX_DOF * 6)                 \
  A(float, IA, FS_MAX_DOF * 36) A(float, pA, FS_MAX_DOF * 6)                \
  A(float, U, FS_MAX_DOF * 6) A(float, u, FS_MAX_DOF)                       \
  A(float, D, FS_MAX_DOF) A(float, qdd, FS_MAX_DOF)                         \
  A(float, Ia, 36) A(float, Xs, 36) A(float, IaX, 36)                       \
  A(float, qd_arm, FS_MAX_DOF) A(float, pc, FS_N_PADS * 3)                  \
  A(float, pv, FS_N_PADS * 3) A(float, invI, FS_MAX_OBJ * 9)                \
  A(float, ug, FS_MAX_GRIP * 3) A(float, padv, FS_N_PADS * 3)               \
  A(float, padJ, FS_N_PADS * FS_MAX_ARM * 3)                                \
  A(float, inv_m_grip, FS_MAX_GRIP) A(float, inv_D_arm, FS_MAX_ARM)         \
  A(float, cnt, FS_N_CNT) A(float, at_low, FS_N_ART)                        \
  A(float, at_high, FS_N_ART)                                               \
  A(float, vov, FS_MAX_OBJ * 3) A(float, vow, FS_MAX_OBJ * 3)               \
  A(float, vaqd, FS_N_ART) A(float, vgqd, FS_MAX_GRIP)                      \
  A(float, vadqd, FS_MAX_ARM)                                               \
  A(float, act, FS_MAX_ACT) A(float, ctrl, FS_MAX_ARM) A(float, grip, 1)

struct EnvSh {
  FS_ENV_FIELDS(FS_DECL_A)
#ifdef FS_PROFILE
  long long t_mark;
#endif
};

// Phase profile (a build with FS_PROFILE defined; tools/time_fused_kernel.py
// --profile): lane 0 of every env adds the SM clocks since the last mark to
// its phase's counter.
enum { FS_P_IO, FS_P_CONTROL, FS_P_IK, FS_P_ABA, FS_P_SERVO, FS_P_CONTEXT,
       FS_P_GATHER, FS_P_KDIR, FS_P_WARM, FS_P_SWEEPS, FS_P_INTEGRATE,
       FS_P_AG, FS_P_N };
#if defined(FS_PROFILE) && defined(__CUDACC__)
__device__ unsigned long long fs_prof[FS_P_N];
__device__ __forceinline__ void fs_mark(EnvSh& S, int lane, int phase) {
  if (lane != 0) return;
  long long t = clock64();
  if (phase >= 0) atomicAdd(&fs_prof[phase], (unsigned long long)(t - S.t_mark));
  S.t_mark = t;
}
#define FS_MARK(phase) fs_mark(S, T.lane, phase)
#else
#define FS_MARK(phase) ((void)0)
#endif

// ---------------------------------------------------------------------------
// the team of lanes that owns one env: sync() orders its shared-memory
// writes before the other lanes' reads; sum() leaves the same bits in
// every lane (a butterfly: each step adds two partial sums, a + b == b + a)
// ---------------------------------------------------------------------------

#ifndef FS_TEAM_DEFINED
struct Team {
  int lane;
#ifdef __CUDACC__
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ float sum(float v) const {
#pragma unroll
    for (int m = FS_G / 2; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
  }
#else
  void sync() const {}
  float sum(float v) const { return v; }
#endif
};
#endif

// ---------------------------------------------------------------------------
// small vector / quaternion helpers (xyzw), mirroring ops/lane.py
// ---------------------------------------------------------------------------

FS_DEV float clipf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
FS_DEV float signf(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }
FS_DEV float sgn_nz(float x) { return x < 0.0f ? -1.0f : 1.0f; }
FS_DEV float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
FS_DEV void cross3(const float* a, const float* b, float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}
FS_DEV void sub3(const float* a, const float* b, float* o) {
  o[0] = a[0] - b[0]; o[1] = a[1] - b[1]; o[2] = a[2] - b[2];
}
FS_DEV void copy3(const float* a, float* o) { o[0] = a[0]; o[1] = a[1]; o[2] = a[2]; }
FS_DEV void copy4(const float* a, float* o) {
  o[0] = a[0]; o[1] = a[1]; o[2] = a[2]; o[3] = a[3];
}
FS_DEV void qmul(const float* a, const float* b, float* o) {
  float ax = a[0], ay = a[1], az = a[2], aw = a[3];
  float bx = b[0], by = b[1], bz = b[2], bw = b[3];
  o[0] = aw * bx + ax * bw + ay * bz - az * by;
  o[1] = aw * by - ax * bz + ay * bw + az * bx;
  o[2] = aw * bz + ax * by - ay * bx + az * bw;
  o[3] = aw * bw - ax * bx - ay * by - az * bz;
}
FS_DEV void qnormalize(float* q) {
  float s = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + 1e-12f);
  q[0] /= s; q[1] /= s; q[2] /= s; q[3] /= s;
}
// 2(u.v)u + (w^2 - u.u)v + 2w(u x v)
FS_DEV void qrot(const float* q, const float* v, float* o) {
  float uv = dot3(q, v), uu = dot3(q, q), w = q[3];
  float c[3];
  cross3(q, v, c);
  float s = w * w - uu;
  float r0 = (2.0f * uv) * q[0] + s * v[0] + (2.0f * w) * c[0];
  float r1 = (2.0f * uv) * q[1] + s * v[1] + (2.0f * w) * c[1];
  float r2 = (2.0f * uv) * q[2] + s * v[2] + (2.0f * w) * c[2];
  o[0] = r0; o[1] = r1; o[2] = r2;
}
FS_DEV void qrot_inv(const float* q, const float* v, float* o) {
  float c[4] = {-q[0], -q[1], -q[2], q[3]};
  qrot(c, v, o);
}
FS_DEV void q_axis_angle(const float* axis, float angle, float* o) {
  float half = 0.5f * angle;
  float s = sinf(half), c = cosf(half);
  o[0] = axis[0] * s; o[1] = axis[1] * s; o[2] = axis[2] * s; o[3] = c;
}
FS_DEV void quat_to_mat33(const float* q, float* R) {
  float x = q[0], y = q[1], z = q[2], w = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz); R[1] = 2.0f * (xy - wz); R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz); R[4] = 1.0f - 2.0f * (xx + zz); R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy); R[7] = 2.0f * (yz + wx); R[8] = 1.0f - 2.0f * (xx + yy);
}
FS_DEV void mat33_vec(const float* M, const float* v, float* o) {
  float a = M[0] * v[0] + M[1] * v[1] + M[2] * v[2];
  float b = M[3] * v[0] + M[4] * v[1] + M[5] * v[2];
  float c = M[6] * v[0] + M[7] * v[1] + M[8] * v[2];
  o[0] = a; o[1] = b; o[2] = c;
}
FS_DEV float floor_mod2(float x) { return x - 2.0f * floorf(x * 0.5f); }

// ---------------------------------------------------------------------------
// per-env state: packed row r of X (one column per env) <-> EnvSh
// ---------------------------------------------------------------------------

FS_DEV float* state_row(const Model& M, EnvSh& S, int r) {
  int n = M.n_dof, no = M.n_obj;
  if (r < n) return S.q + r;
  r -= n;
  if (r < n) return S.qd + r;
  r -= n;
  if (r < 3 * no) return S.op + r;
  r -= 3 * no;
  if (r < 4 * no) return S.oq + r;
  r -= 4 * no;
  if (r < 3 * no) return S.ov + r;
  r -= 3 * no;
  if (r < 3 * no) return S.ow + r;
  r -= 3 * no;
  if (r < FS_N_ART) return S.aq + r;
  return S.aqd + (r - FS_N_ART);
}

FS_DEV void load_state(const Model& M, EnvSh& S, const Team& T, const float* X,
                       long b, long B) {
  FS_MARK(-1);
  for (int r = T.lane; r < M.nf; r += FS_G) *state_row(M, S, r) = X[r * B + b];
  T.sync();
  FS_MARK(FS_P_IO);
}

FS_DEV void store_state(const Model& M, EnvSh& S, const Team& T, float* Y,
                        long b, long B) {
  T.sync();
  for (int r = T.lane; r < M.nf; r += FS_G) Y[r * B + b] = *state_row(M, S, r);
  FS_MARK(FS_P_IO);
}

// ---------------------------------------------------------------------------
// FK (lane_fk_vel / lane_fk_links) and pad kinematics (lane_pad_kinematics):
// the chain is serial along the tree and runs in lane 0
// ---------------------------------------------------------------------------

// the chain of links 0..nl-1, run by one lane (the joint rotations of the
// revolute links already in S.jrot)
FS_DEV void fk_chain(const Model& M, EnvSh& S, const float* q, const float* qd,
                     int nl) {
  for (int i = 0; i < nl; ++i) {
    int p = M.parent[i];
    float pp[3], pq[4], plv[3] = {0.0f, 0.0f, 0.0f}, pav[3] = {0.0f, 0.0f, 0.0f};
    if (p < 0) {
      copy3(M.base_pos, pp); copy4(M.base_quat, pq);
    } else {
      copy3(S.pos + 3 * p, pp); copy4(S.quat + 4 * p, pq);
      if (qd != nullptr) { copy3(S.lv + 3 * p, plv); copy3(S.av + 3 * p, pav); }
    }
    const float* ax = M.axis + 3 * i;
    float t[3], jp[3], jq[4];
    qrot(pq, M.pre_pos + 3 * i, t);
    jp[0] = pp[0] + t[0]; jp[1] = pp[1] + t[1]; jp[2] = pp[2] + t[2];
    qmul(pq, M.pre_quat + 4 * i, jq);
    if (M.revolute[i]) {
      float dq[4], m[4];
      copy4(S.jrot + 4 * i, dq);
      qmul(jq, dq, m);
      qnormalize(m);
      copy4(m, jq);
    } else {
      float a[3] = {ax[0] * q[i], ax[1] * q[i], ax[2] * q[i]};
      qrot(jq, a, t);
      jp[0] += t[0]; jp[1] += t[1]; jp[2] += t[2];
    }
    if (qd != nullptr) {
      float d[3], c[3], aw[3];
      sub3(jp, pp, d);
      cross3(pav, d, c);
      float vl[3] = {plv[0] + c[0], plv[1] + c[1], plv[2] + c[2]};
      float va[3] = {pav[0], pav[1], pav[2]};
      qrot(jq, ax, aw);
      if (M.revolute[i]) {
        for (int k = 0; k < 3; ++k) va[k] = va[k] + aw[k] * qd[i];
      } else {
        for (int k = 0; k < 3; ++k) vl[k] = vl[k] + aw[k] * qd[i];
      }
      copy3(vl, S.lv + 3 * i);
      copy3(va, S.av + 3 * i);
    }
    copy3(jp, S.pos + 3 * i);
    copy4(jq, S.quat + 4 * i);
  }
}

// Links 0..nl-1 (parents come before children). The joint rotations
// depend on q alone, so the lanes make them first; lane 0 then runs the
// chain. qd == nullptr: positions/orientations only.
FS_DEV void fk(const Model& M, EnvSh& S, const Team& T, const float* q,
               const float* qd, int nl) {
  for (int i = T.lane; i < nl; i += FS_G)
    if (M.revolute[i]) q_axis_angle(M.axis + 3 * i, q[i], S.jrot + 4 * i);
  T.sync();
  if (T.lane == 0) fk_chain(M, S, q, qd, nl);
  T.sync();
}

FS_DEV void site_pose(const Model& M, const EnvSh& S, float* xp, float* xq) {
  int par = M.ee_parent;
  float t[3];
  qrot(S.quat + 4 * par, M.ee_pos, t);
  xp[0] = S.pos[3 * par] + t[0]; xp[1] = S.pos[3 * par + 1] + t[1];
  xp[2] = S.pos[3 * par + 2] + t[2];
  qmul(S.quat + 4 * par, M.ee_quat, xq);
}

// pad sphere p: center and velocity
FS_DEV void pad_kin(const Model& M, EnvSh& S, int p) {
  int par = M.pad_parent[p];
  float t[3], spos[3], squat[4], c[3], d[3], w[3];
  qrot(S.quat + 4 * par, M.pad_site_pos + 3 * p, t);
  for (int k = 0; k < 3; ++k) spos[k] = S.pos[3 * par + k] + t[k];
  qmul(S.quat + 4 * par, M.pad_site_quat + 4 * p, squat);
  qrot(squat, M.pad_off + 3 * p, t);
  for (int k = 0; k < 3; ++k) c[k] = spos[k] + t[k];
  sub3(c, S.pos + 3 * par, d);
  cross3(S.av + 3 * par, d, w);
  for (int k = 0; k < 3; ++k) {
    S.pc[3 * p + k] = c[k];
    S.pv[3 * p + k] = S.lv[3 * par + k] + w[k];
  }
}

// ---------------------------------------------------------------------------
// ABA (lane_aba): qdd and the joint-space diagonal D, no external forces
// ---------------------------------------------------------------------------

// entry (r, c) of X = [[E, 0], [-E p~, E]] with p~ = skew(p)
FS_DEV float x_entry(const float* E, const float* p, int r, int c) {
  if (r < 3) return c < 3 ? E[r * 3 + c] : 0.0f;
  if (c >= 3) return E[(r - 3) * 3 + c - 3];
  // column c of skew(p), picked without indexing a local array
  float k0 = c == 0 ? 0.0f : (c == 1 ? -p[2] : p[1]);
  float k1 = c == 0 ? p[2] : (c == 1 ? 0.0f : -p[0]);
  float k2 = c == 0 ? -p[1] : (c == 1 ? p[0] : 0.0f);
  int e = r - 3;
  float s = E[e * 3 + 0] * k0 + E[e * 3 + 1] * k1 + E[e * 3 + 2] * k2;
  return -s;
}

FS_DEV void build_X(const float* E, const float* p, float* X) {
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int c = 0; c < 6; ++c) X[r * 6 + c] = x_entry(E, p, r, c);
}

FS_DEV void m6v(const float* A, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s += A[i * 6 + j] * v[j];
    o[i] = s;
  }
}
FS_DEV void m6Tv(const float* A, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s += A[j * 6 + i] * v[j];
    o[i] = s;
  }
}

FS_DEV void motion_S(const Model& M, int i, float* S6) {
  const float* ax = M.axis + 3 * i;
#pragma unroll
  for (int k = 0; k < 6; ++k) S6[k] = 0.0f;
  if (M.revolute[i]) { S6[0] = ax[0]; S6[1] = ax[1]; S6[2] = ax[2]; }
  else { S6[3] = ax[0]; S6[4] = ax[1]; S6[5] = ax[2]; }
}

// q, qd: shared arrays. Leaves qdd in S.qdd, D in S.D.
FS_DEV void aba(const Model& M, EnvSh& S, const Team& T, const float* q,
                const float* qd) {
  const int n = M.n_dof;
  for (int t = T.lane; t < n * 36; t += FS_G) S.IA[t] = M.inertia6[t];
  // joint transforms: each depends on its own q alone, one lane a link
  for (int i = T.lane; i < n; i += FS_G) {
    const float* ax = M.axis + 3 * i;
    float* Ei = S.E + 9 * i;
    float* pi = S.p + 3 * i;
    if (M.revolute[i]) {
      float dq[4], jq[4], cq[4];
      q_axis_angle(ax, q[i], dq);
      qmul(M.pre_quat + 4 * i, dq, jq);
      cq[0] = -jq[0]; cq[1] = -jq[1]; cq[2] = -jq[2]; cq[3] = jq[3];
      float R[9];
      quat_to_mat33(cq, R);
      for (int k = 0; k < 9; ++k) Ei[k] = R[k];
      copy3(M.pre_pos + 3 * i, pi);
    } else {
      for (int k = 0; k < 9; ++k) Ei[k] = M.pris_E[9 * i + k];
      for (int k = 0; k < 3; ++k)
        pi[k] = M.pre_pos[3 * i + k] + M.pris_rax[3 * i + k] * q[i];
    }
  }
  T.sync();
  if (T.lane == 0) {
    for (int i = 0; i < n; ++i) {
      // velocities, bias terms and articulated bias forces down the tree
      float S6[6];
      motion_S(M, i, S6);
      const float* Ei = S.E + 9 * i;
      const float* pi = S.p + 3 * i;
      float X[36], vi[6], E[9], p[3];
      for (int k = 0; k < 9; ++k) E[k] = Ei[k];
      copy3(pi, p);
      build_X(E, p, X);
      int par = M.parent[i];
      if (par >= 0) {
        float vp[6];
        for (int k = 0; k < 6; ++k) vp[k] = S.v6[6 * par + k];
        m6v(X, vp, vi);
      } else {
        for (int k = 0; k < 6; ++k) vi[k] = 0.0f;
      }
      float sqd[6];
      for (int k = 0; k < 6; ++k) { sqd[k] = S6[k] * qd[i]; vi[k] = vi[k] + sqd[k]; }
      // c = v x (S qd) (motion cross)
      float cx[3], c1[3], c2[3];
      cross3(vi, sqd, cx);
      cross3(vi + 3, sqd, c1);
      cross3(vi, sqd + 3, c2);
      float* c6 = S.c6 + 6 * i;
      c6[0] = cx[0]; c6[1] = cx[1]; c6[2] = cx[2];
      c6[3] = c1[0] + c2[0]; c6[4] = c1[1] + c2[1]; c6[5] = c1[2] + c2[2];
      // p = v x* (I v)
      float I6[36], Iv[6], pn1[3], pn2[3], pf[3];
      for (int k = 0; k < 36; ++k) I6[k] = M.inertia6[36 * i + k];
      m6v(I6, vi, Iv);
      cross3(vi, Iv, pn1);
      cross3(vi + 3, Iv + 3, pn2);
      cross3(vi, Iv + 3, pf);
      float* pA = S.pA + 6 * i;
      pA[0] = pn1[0] + pn2[0]; pA[1] = pn1[1] + pn2[1]; pA[2] = pn1[2] + pn2[2];
      pA[3] = pf[0]; pA[4] = pf[1]; pA[5] = pf[2];
      for (int k = 0; k < 6; ++k) S.v6[6 * i + k] = vi[k];
    }
  }
  T.sync();

  // backward: the 6x6 products entry by entry over the lanes
  for (int i = n - 1; i >= 0; --i) {
    const int par = M.parent[i];
    if (T.lane == 0) {
      float S6[6], Ui[6], IAi[36];
      motion_S(M, i, S6);
      for (int k = 0; k < 36; ++k) IAi[k] = S.IA[36 * i + k];
      m6v(IAi, S6, Ui);
      float sU = 0.0f, sp = 0.0f;
      for (int k = 0; k < 6; ++k) { sU += S6[k] * Ui[k]; sp += S6[k] * S.pA[6 * i + k]; }
      for (int k = 0; k < 6; ++k) S.U[6 * i + k] = Ui[k];
      S.D[i] = sU + 1e-9f;
      S.u[i] = (-M.damping[i]) * qd[i] - sp;
    }
    T.sync();
    if (par < 0) continue;
    const float invD = 1.0f / S.D[i];
    const float* Ui = S.U + 6 * i;
    for (int t = T.lane; t < 36; t += FS_G) {
      int r = t / 6, c = t % 6;
      S.Ia[t] = S.IA[36 * i + t] - (Ui[r] * invD) * Ui[c];
      S.Xs[t] = x_entry(S.E + 9 * i, S.p + 3 * i, r, c);
    }
    T.sync();
    if (T.lane == 0) {
      float Ia[36], X[36], c6[6], Iac[6], pa[6], Xtpa[6];
      for (int k = 0; k < 36; ++k) { Ia[k] = S.Ia[k]; X[k] = S.Xs[k]; }
      for (int k = 0; k < 6; ++k) c6[k] = S.c6[6 * i + k];
      m6v(Ia, c6, Iac);
      float uD = S.u[i] * invD;
      for (int k = 0; k < 6; ++k) pa[k] = (S.pA[6 * i + k] + Iac[k]) + Ui[k] * uD;
      m6Tv(X, pa, Xtpa);
      for (int k = 0; k < 6; ++k) S.pA[6 * par + k] += Xtpa[k];
    }
    for (int t = T.lane; t < 36; t += FS_G) {
      int r = t / 6, c = t % 6;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) s += S.Ia[r * 6 + k] * S.Xs[k * 6 + c];
      S.IaX[t] = s;
    }
    T.sync();
    for (int t = T.lane; t < 36; t += FS_G) {
      int r = t / 6, c = t % 6;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) s += S.Xs[k * 6 + r] * S.IaX[k * 6 + c];
      S.IA[36 * par + t] += s;
    }
    T.sync();
  }

  // forward: accelerations (a6 reuses v6's storage)
  if (T.lane == 0) {
    for (int i = 0; i < n; ++i) {
      float S6[6], X[36], E[9], p[3], ap[6], ai[6];
      motion_S(M, i, S6);
      for (int k = 0; k < 9; ++k) E[k] = S.E[9 * i + k];
      copy3(S.p + 3 * i, p);
      build_X(E, p, X);
      int par = M.parent[i];
      for (int k = 0; k < 6; ++k) ap[k] = par >= 0 ? S.v6[6 * par + k] : M.a_base[k];
      m6v(X, ap, ai);
      float Ua = 0.0f;
      for (int k = 0; k < 6; ++k) {
        ai[k] = ai[k] + S.c6[6 * i + k];
        Ua += S.U[6 * i + k] * ai[k];
      }
      float qddi = (S.u[i] - Ua) / S.D[i];
      for (int k = 0; k < 6; ++k) S.v6[6 * i + k] = ai[k] + S6[k] * qddi;
      S.qdd[i] = qddi;
    }
  }
  T.sync();
}

// ---------------------------------------------------------------------------
// collision primitives (lane_sphere_aabox / lane_points_aabox(_ref) and their
// oriented-box forms); boxes are given in their own frame here
// ---------------------------------------------------------------------------

// sphere (center d relative to the box center) vs axis-aligned box
FS_DEV void sphere_aabox(const float* c, const float* d, float r, const float* h,
                         float* pt, float* n, float* depth) {
  float out[3];
  for (int k = 0; k < 3; ++k) out[k] = d[k] - clipf(d[k], -h[k], h[k]);
  float dist = sqrtf(out[0] * out[0] + out[1] * out[1] + out[2] * out[2] + 1e-12f);
  float g0 = h[0] - fabsf(d[0]), g1 = h[1] - fabsf(d[1]), g2 = h[2] - fabsf(d[2]);
  float gmin = fminf(g0, fminf(g1, g2));
  bool a0 = g0 <= fminf(g1, g2);
  bool a1 = !a0 && (g1 <= g2);
  bool a2 = !a0 && !a1;
  if (dist < 1e-5f) {
    n[0] = a0 ? signf(d[0]) : 0.0f;
    n[1] = a1 ? signf(d[1]) : 0.0f;
    n[2] = a2 ? signf(d[2]) : 0.0f;
    *depth = r + gmin;
  } else {
    float m = fmaxf(dist, 1e-9f);
    n[0] = out[0] / m; n[1] = out[1] / m; n[2] = out[2] / m;
    *depth = r - dist;
  }
  for (int k = 0; k < 3; ++k) pt[k] = c[k] - n[k] * r;
}

// point (dp relative to the box center) vs box: face chosen from the owning
// body's center (d_ref), min-axis fallback when that center is inside
FS_DEV void points_aabox_ref(const float* dp, const float* d_ref, const float* h,
                             float* n, float* depth) {
  float r0 = fabsf(d_ref[0]) / fmaxf(h[0], 1e-6f);
  float r1 = fabsf(d_ref[1]) / fmaxf(h[1], 1e-6f);
  float r2 = fabsf(d_ref[2]) / fmaxf(h[2], 1e-6f);
  if (r0 < 1.0f && r1 < 1.0f && r2 < 1.0f) {
    float g0 = h[0] - fabsf(dp[0]), g1 = h[1] - fabsf(dp[1]), g2 = h[2] - fabsf(dp[2]);
    bool a0 = g0 <= fminf(g1, g2);
    bool a1 = !a0 && (g1 <= g2);
    bool a2 = !a0 && !a1;
    n[0] = a0 ? sgn_nz(dp[0]) : 0.0f;
    n[1] = a1 ? sgn_nz(dp[1]) : 0.0f;
    n[2] = a2 ? sgn_nz(dp[2]) : 0.0f;
    *depth = fminf(g0, fminf(g1, g2));
    return;
  }
  bool b0 = r0 >= fmaxf(r1, r2);
  bool b1 = !b0 && (r1 >= r2);
  bool b2 = !b0 && !b1;
  n[0] = b0 ? sgn_nz(d_ref[0]) : 0.0f;
  n[1] = b1 ? sgn_nz(d_ref[1]) : 0.0f;
  n[2] = b2 ? sgn_nz(d_ref[2]) : 0.0f;
  float an[3] = {fabsf(n[0]), fabsf(n[1]), fabsf(n[2])};
  float face = (h[0] * an[0] + h[1] * an[1] + h[2] * an[2])
             - (dp[0] * n[0] + dp[1] * n[1] + dp[2] * n[2]);
  bool inside_other = true;
  for (int k = 0; k < 3; ++k)
    inside_other = inside_other
        && (fabsf(dp[k]) * (1.0f - an[k]) <= h[k] * (1.0f - an[k]) + 1e-6f);
  *depth = inside_other ? face : -1.0f;
}

// sphere vs oriented box (bp, bq, h): world point, normal, depth
FS_DEV void sphere_obox(const float* c, float r, const float* bp, const float* bq,
                        const float* h, float* pt, float* n, float* depth) {
  float d[3], local[3], lp[3], ln_[3];
  sub3(c, bp, d);
  qrot_inv(bq, d, local);
  sphere_aabox(local, local, r, h, lp, ln_, depth);
  qrot(bq, lp, pt);
  pt[0] += bp[0]; pt[1] += bp[1]; pt[2] += bp[2];
  qrot(bq, ln_, n);
}

// box corner vs oriented box, face from the reference point
FS_DEV void points_obox_ref(const float* p, const float* ref, const float* bp,
                            const float* bq, const float* h, float* pt, float* n,
                            float* depth) {
  float d[3], lp[3], lr[3], ln_[3];
  sub3(p, bp, d);
  qrot_inv(bq, d, lp);
  sub3(ref, bp, d);
  qrot_inv(bq, d, lr);
  points_aabox_ref(lp, lr, h, ln_, depth);
  qrot(bq, lp, pt);
  pt[0] += bp[0]; pt[1] += bp[1]; pt[2] += bp[2];
  qrot(bq, ln_, n);
}

// pose of articulated element k (physics.art_box_pose)
FS_DEV void art_pose(const Model& M, int k, float aq, float* pos, float* quat) {
  const float* ax = M.art_axis + 3 * k;
  const float* an = M.art_anchor + 3 * k;
  if (M.art_rev[k]) {
    q_axis_angle(ax, aq, quat);
    copy3(an, pos);
  } else {
    for (int c = 0; c < 3; ++c) pos[c] = an[c] + ax[c] * aq;
    quat[0] = 0.0f; quat[1] = 0.0f; quat[2] = 0.0f; quat[3] = 1.0f;
  }
}

// ---------------------------------------------------------------------------
// contact rows (gather_bundles): row i of the model's static table, made by
// the lane that owns it, into that lane's registers
// ---------------------------------------------------------------------------

struct Row {
  float pt[3], n[3], t1[3], t2[3];
  float vt, af, kn, kt1, kt2;
  int code;
};

FS_DEV float row_mu(const Model& M, int kind) {
  if (kind == FS_ROW_FLOOR || kind == FS_ROW_STATIC) return M.mu_world;
  if (kind == FS_ROW_ART) return M.mu_art;
  if (kind == FS_ROW_PAD_BLOCK) return M.mu_pad;
  if (kind == FS_ROW_BB) return M.mu_bb;
  return 0.6f;
}

FS_DEV void corner(const Model& M, const EnvSh& S, int o, int c, float* out) {
  float local[3] = {((c >> 2) & 1 ? 1.0f : -1.0f) * M.block_half[0],
                    ((c >> 1) & 1 ? 1.0f : -1.0f) * M.block_half[1],
                    (c & 1 ? 1.0f : -1.0f) * M.block_half[2]};
  float t[3];
  qrot(S.oq + 4 * o, local, t);
  for (int k = 0; k < 3; ++k) out[k] = S.op[3 * o + k] + t[k];
}

// first-max selection helper: keep candidate i if strictly deeper
#define FS_KEEP(cond_deeper) (best < 0 || (cond_deeper))

FS_DEV void make_row(const Model& M, const EnvSh& S, int code, Row& w) {
  const int kind = row_kind(code), idx = row_idx(code), o = row_obj(code);
  const int ak = row_k(code);
  float pt[3] = {0.0f, 0.0f, 0.0f}, n[3] = {0.0f, 0.0f, 0.0f}, depth = 0.0f;
  float cp[3];
  if (kind <= FS_ROW_ART || kind == FS_ROW_BB) corner(M, S, o, idx, cp);
  if (kind == FS_ROW_FLOOR) {
    copy3(cp, pt);
    n[2] = 1.0f;
    depth = M.plane_z - cp[2];
  } else if (kind == FS_ROW_STATIC) {         // deepest static box
    int best = -1;
    float bd = 0.0f, bn[3] = {0, 0, 0};
    for (int s = 0; s < M.n_static; ++s) {
      float dp[3], dr[3], nn[3], d;
      sub3(cp, M.static_pos + 3 * s, dp);
      sub3(S.op + 3 * o, M.static_pos + 3 * s, dr);
      points_aabox_ref(dp, dr, M.static_half + 3 * s, nn, &d);
      if (FS_KEEP(d > bd)) { best = s; bd = d; copy3(nn, bn); }
    }
    copy3(cp, pt); copy3(bn, n); depth = bd;
  } else if (kind == FS_ROW_ART || kind == FS_ROW_PAD_ART) {
    // deepest real box of element ak: for a block corner or a pad sphere
    float bpos[3], bq[4];
    art_pose(M, ak, S.aq[ak], bpos, bq);
    int best = -1;
    float bd = 0.0f, bn[3] = {0, 0, 0}, bp[3] = {0, 0, 0};
    for (int b = 0; b < M.art_nb[ak]; ++b) {
      int j = ak * FS_MAX_ART_BOXES + b;
      float center[3], t[3], pp[3], nn[3], d;
      qrot(bq, M.art_box_pos + 3 * j, t);
      for (int e = 0; e < 3; ++e) center[e] = bpos[e] + t[e];
      if (kind == FS_ROW_ART) {
        points_obox_ref(cp, S.op + 3 * o, center, bq, M.art_box_half + 3 * j, pp,
                        nn, &d);
      } else {
        sphere_obox(S.pc + 3 * idx, M.pad_r[idx], center, bq,
                    M.art_box_half + 3 * j, pp, nn, &d);
        nn[0] = -nn[0]; nn[1] = -nn[1]; nn[2] = -nn[2];
      }
      if (FS_KEEP(d > bd)) { best = b; bd = d; copy3(nn, bn); copy3(pp, bp); }
    }
    copy3(bp, pt); copy3(bn, n); depth = bd;
  } else if (kind == FS_ROW_PAD_BLOCK) {      // normal flipped INTO the block
    sphere_obox(S.pc + 3 * idx, M.pad_r[idx], S.op + 3 * o, S.oq + 4 * o,
                M.block_half, pt, n, &depth);
    n[0] = -n[0]; n[1] = -n[1]; n[2] = -n[2];
  } else if (kind == FS_ROW_BB) {
    points_obox_ref(cp, S.op, S.op + 3, S.oq + 4, M.block_half, pt, n, &depth);
  } else if (kind == FS_ROW_PAD_FLOOR) {
    float r = M.pad_r[idx];
    const float* pc = S.pc + 3 * idx;
    pt[0] = pc[0] - 0.0f * r; pt[1] = pc[1] - 0.0f * r; pt[2] = pc[2] - 1.0f * r;
    n[0] = -0.0f; n[1] = -0.0f; n[2] = -1.0f;
    depth = r - (pc[2] - M.plane_z);
  } else {                                    // FS_ROW_PAD_STATIC
    float r = M.pad_r[idx];
    const float* pc = S.pc + 3 * idx;
    int best = -1;
    float bd = 0.0f, bn[3] = {0, 0, 0}, bp[3] = {0, 0, 0};
    for (int s = 0; s < M.n_static; ++s) {
      float d3[3], qq[3], nn[3], d;
      sub3(pc, M.static_pos + 3 * s, d3);
      sphere_aabox(pc, d3, r, M.static_half + 3 * s, qq, nn, &d);
      if (FS_KEEP(d > bd)) {
        best = s; bd = d; copy3(qq, bp);
        bn[0] = -nn[0]; bn[1] = -nn[1]; bn[2] = -nn[2];
      }
    }
    copy3(bp, pt); copy3(bn, n); depth = bd;
  }
  // put_row: activity, Baumgarte target, tangent basis
  copy3(pt, w.pt);
  copy3(n, w.n);
  w.af = depth > 0.0f ? 1.0f : 0.0f;
  w.vt = fminf(0.2f * fmaxf(depth - 5e-4f, 0.0f) / M.dt, 0.05f);
  bool nz = fabsf(n[2]) < 0.9f;
  float ax[3] = {nz ? 0.0f : 1.0f, 0.0f, nz ? 1.0f : 0.0f};
  float t1[3];
  cross3(n, ax, t1);
  float s = sqrtf(dot3(t1, t1) + 1e-12f);
  t1[0] /= s; t1[1] /= s; t1[2] /= s;
  copy3(t1, w.t1);
  cross3(n, t1, w.t2);
  w.code = code;
}

// ---------------------------------------------------------------------------
// warm-started Jacobi impulse solve (lane_solve); the solver context and
// the body velocities live in EnvSh (cnt: blocks, elements, gripper, arm)
// ---------------------------------------------------------------------------

#define FS_CNT_ART FS_MAX_OBJ
#define FS_CNT_GRIP (FS_MAX_OBJ + FS_N_ART)
#define FS_CNT_ARM (FS_MAX_OBJ + FS_N_ART + FS_MAX_GRIP)

FS_DEV void row_u_art(const Model& M, const float* pt, int k, float* u) {
  const float* ax = M.art_axis + 3 * k;
  if (M.art_rev[k]) {
    float d[3];
    sub3(pt, M.art_anchor + 3 * k, d);
    cross3(ax, d, u);
  } else {
    copy3(ax, u);
  }
}

FS_DEV float art_mobile(const EnvSh& S, int k, float j) {
  bool blocked = (S.at_low[k] != 0.0f && j < 0.0f) || (S.at_high[k] != 0.0f && j > 0.0f);
  return blocked ? 0.0f : 1.0f;
}

// effective inverse mass of a row along direction d (k_dir)
FS_DEV float k_dir(const Model& M, const EnvSh& S, const Row& w, const float* d) {
  const int a = row_a(w.code), b = row_b(w.code), ak = row_k(w.code);
  const int g = row_g(w.code), pj = row_pj(w.code);
  float k = 0.0f;
  if (a >= 0) {
    float r[3], u[3], Iu[3];
    sub3(w.pt, S.op + 3 * a, r);
    cross3(r, d, u);
    mat33_vec(S.invI + 9 * a, u, Iu);
    k += (M.inv_m_blk + dot3(u, Iu)) * fmaxf(S.cnt[a], 1.0f);
  }
  if (b >= 0) {
    float r[3], u[3], Iu[3];
    sub3(w.pt, S.op + 3 * b, r);
    cross3(r, d, u);
    mat33_vec(S.invI + 9 * b, u, Iu);
    k += (M.inv_m_blk + dot3(u, Iu)) * fmaxf(S.cnt[b], 1.0f);
  }
  if (ak >= 0) {
    float u[3];
    row_u_art(M, w.pt, ak, u);
    float ja = dot3(u, d);
    float sign = a >= 0 ? -1.0f : 1.0f;
    float mob = art_mobile(S, ak, ja * sign);
    k += ja * ja * M.inv_m_art[ak] * mob * fmaxf(S.cnt[FS_CNT_ART + ak], 1.0f);
  }
  if (g >= 0) {
    float jg = dot3(S.ug + 3 * g, d);
    k += jg * jg * S.inv_m_grip[g] * fmaxf(S.cnt[FS_CNT_GRIP + g], 1.0f);
  }
  if (pj >= 0) {
    float split = fmaxf(S.cnt[FS_CNT_ARM], 1.0f);
    for (int j = 0; j < M.n_arm; ++j) {
      if (!M.pad_anc[pj * FS_MAX_ARM + j]) continue;
      float jd = dot3(S.padJ + 3 * (pj * FS_MAX_ARM + j), d);
      k += jd * jd * S.inv_D_arm[j] * split;
    }
  }
  return fmaxf(k, 1e-8f);
}

// relative velocity at a row: side A minus side B (rel_vel)
FS_DEV void rel_vel(const Model& M, const EnvSh& S, const Row& w, float* out) {
  const int a = row_a(w.code), b = row_b(w.code), ak = row_k(w.code);
  const int g = row_g(w.code), pj = row_pj(w.code), vk = row_vk(w.code);
  float vB[3] = {0.0f, 0.0f, 0.0f}, t[3], r[3];
  float u[3] = {0.0f, 0.0f, 0.0f};
  if (ak >= 0) row_u_art(M, w.pt, ak, u);
  if (b >= 0) {
    sub3(w.pt, S.op + 3 * b, r);
    cross3(S.vow + 3 * b, r, t);
    for (int c = 0; c < 3; ++c) vB[c] += S.vov[3 * b + c] + t[c];
  }
  if (ak >= 0 && a >= 0)
    for (int c = 0; c < 3; ++c) vB[c] += u[c] * S.vaqd[ak];
  if (g >= 0)
    for (int c = 0; c < 3; ++c) vB[c] += S.ug[3 * g + c] * S.vgqd[g];
  if (pj >= 0)
    for (int j = 0; j < M.n_arm; ++j)
      if (M.pad_anc[pj * FS_MAX_ARM + j])
        for (int c = 0; c < 3; ++c)
          vB[c] += S.padJ[3 * (pj * FS_MAX_ARM + j) + c] * S.vadqd[j];
  if (vk >= 0)
    for (int c = 0; c < 3; ++c) vB[c] += S.padv[3 * vk + c];
  float vA[3] = {0.0f, 0.0f, 0.0f};
  if (a >= 0) {
    sub3(w.pt, S.op + 3 * a, r);
    cross3(S.vow + 3 * a, r, t);
    for (int c = 0; c < 3; ++c) vA[c] = S.vov[3 * a + c] + t[c];
  } else if (ak >= 0) {
    for (int c = 0; c < 3; ++c) vA[c] = u[c] * S.vaqd[ak];
  }
  for (int c = 0; c < 3; ++c) out[c] = vA[c] - vB[c];
}

// One Jacobi sweep: every lane updates λ of its rows against the
// velocities at the sweep's start, the per-body sums of the impulses are
// reduced over the team, and lane 0 applies them (apply_all + gear
// projection). warm: the warm-start pass (re-mask / re-cap the carried λ
// and apply it).
FS_DEV void sweep(const Model& M, EnvSh& S, const Team& T, const Row (&R)[FS_SLOTS],
                  float (&lam)[FS_SLOTS][3], bool warm) {
  float s_v[FS_MAX_OBJ][3], s_t[FS_MAX_OBJ][3];
  float s_k[FS_N_ART], s_g[FS_MAX_GRIP], s_j[FS_MAX_ARM];
#pragma unroll
  for (int o = 0; o < FS_MAX_OBJ; ++o)
#pragma unroll
    for (int c = 0; c < 3; ++c) { s_v[o][c] = 0.0f; s_t[o][c] = 0.0f; }
#pragma unroll
  for (int k = 0; k < FS_N_ART; ++k) s_k[k] = 0.0f;
#pragma unroll
  for (int g = 0; g < FS_MAX_GRIP; ++g) s_g[g] = 0.0f;
#pragma unroll
  for (int j = 0; j < FS_MAX_ARM; ++j) s_j[j] = 0.0f;

#pragma unroll
  for (int sl = 0; sl < FS_SLOTS; ++sl) {
    if (sl * FS_G + T.lane >= M.n_rows) continue;
    const Row& w = R[sl];
    float* l = lam[sl];
    const float mu = row_mu(M, row_kind(w.code));
    float imp[3];
    if (warm) {
      float ln_w = fmaxf(l[0], 0.0f) * w.af;
      float cap0 = mu * ln_w;
      float lt1 = clipf(l[1], -cap0, cap0) * w.af;
      float lt2 = clipf(l[2], -cap0, cap0) * w.af;
      for (int c = 0; c < 3; ++c)
        imp[c] = ln_w * w.n[c] + lt1 * w.t1[c] + lt2 * w.t2[c];
      l[0] = ln_w; l[1] = lt1; l[2] = lt2;
    } else {
      float v[3];
      rel_vel(M, S, w, v);
      float vn = dot3(v, w.n);
      float dln = (w.vt - vn) / w.kn;
      float new_ln = fmaxf(l[0] + dln, 0.0f) * w.af;
      dln = new_ln - l[0];
      float vt1 = dot3(v, w.t1), vt2 = dot3(v, w.t2);
      float cap = mu * new_ln;
      float lt1 = clipf(l[1] + (-vt1) / w.kt1, -cap, cap) * w.af;
      float lt2 = clipf(l[2] + (-vt2) / w.kt2, -cap, cap) * w.af;
      float d1 = lt1 - l[1], d2 = lt2 - l[2];
      for (int c = 0; c < 3; ++c)
        imp[c] = dln * w.n[c] + d1 * w.t1[c] + d2 * w.t2[c];
      l[0] = new_ln; l[1] = lt1; l[2] = lt2;
    }
    const int a = row_a(w.code), b = row_b(w.code), ak = row_k(w.code);
    const int g = row_g(w.code), pj = row_pj(w.code);
    if (a >= 0) {
      float r[3], t[3];
      sub3(w.pt, S.op + 3 * a, r);
      cross3(r, imp, t);
#pragma unroll
      for (int o = 0; o < FS_MAX_OBJ; ++o)
        if (a == o)
#pragma unroll
          for (int c = 0; c < 3; ++c) { s_v[o][c] += imp[c]; s_t[o][c] += t[c]; }
    }
    if (b >= 0) {
      float r[3], t[3], ni[3] = {-imp[0], -imp[1], -imp[2]};
      sub3(w.pt, S.op + 3 * b, r);
      cross3(r, ni, t);
#pragma unroll
      for (int o = 0; o < FS_MAX_OBJ; ++o)
        if (b == o)
#pragma unroll
          for (int c = 0; c < 3; ++c) { s_v[o][c] -= imp[c]; s_t[o][c] += t[c]; }
    }
    if (ak >= 0) {
      float u[3];
      row_u_art(M, w.pt, ak, u);
      float jrow = dot3(u, imp) * (a >= 0 ? -1.0f : 1.0f);
      float jm = jrow * art_mobile(S, ak, jrow);
#pragma unroll
      for (int k = 0; k < FS_N_ART; ++k)
        if (ak == k) s_k[k] += jm;
    }
    if (g >= 0) {
      float jg = dot3(S.ug + 3 * g, imp);
#pragma unroll
      for (int gg = 0; gg < FS_MAX_GRIP; ++gg)
        if (g == gg) s_g[gg] += jg;
    }
    if (pj >= 0) {
#pragma unroll
      for (int j = 0; j < FS_MAX_ARM; ++j)
        if (j < M.n_arm && M.pad_anc[pj * FS_MAX_ARM + j])
          s_j[j] += dot3(S.padJ + 3 * (pj * FS_MAX_ARM + j), imp);
    }
  }
  // per-body sums over the team (the same bits in every lane)
#pragma unroll
  for (int o = 0; o < FS_MAX_OBJ; ++o)
    if (o < M.n_obj)
#pragma unroll
      for (int c = 0; c < 3; ++c) { s_v[o][c] = T.sum(s_v[o][c]); s_t[o][c] = T.sum(s_t[o][c]); }
  if (M.has_art)
#pragma unroll
    for (int k = 0; k < FS_N_ART; ++k) s_k[k] = T.sum(s_k[k]);
#pragma unroll
  for (int g = 0; g < FS_MAX_GRIP; ++g)
    if (g < M.n_grip) s_g[g] = T.sum(s_g[g]);
#pragma unroll
  for (int j = 0; j < FS_MAX_ARM; ++j)
    if (j < M.n_arm) s_j[j] = T.sum(s_j[j]);
  T.sync();                             // every lane has read the velocities
  if (T.lane == 0) {
#pragma unroll
    for (int o = 0; o < FS_MAX_OBJ; ++o) {
      if (o >= M.n_obj) continue;
      float dw[3];
      mat33_vec(S.invI + 9 * o, s_t[o], dw);
      for (int c = 0; c < 3; ++c) {
        S.vov[3 * o + c] += s_v[o][c] * M.inv_m_blk;
        S.vow[3 * o + c] += dw[c];
      }
    }
#pragma unroll
    for (int k = 0; k < FS_N_ART; ++k)      // elements with rows only
      if (M.has_art && M.art_nb[k] > 0) S.vaqd[k] += s_k[k] * M.inv_m_art[k];
#pragma unroll
    for (int g = 0; g < FS_MAX_GRIP; ++g)
      if (g < M.n_grip) S.vgqd[g] += (-s_g[g]) * S.inv_m_grip[g];
#pragma unroll
    for (int j = 0; j < FS_MAX_ARM; ++j)
      if (j < M.n_arm) S.vadqd[j] += (-s_j[j]) * S.inv_D_arm[j];
    if (M.n_grip == 2) {                // gear projection
      float w0 = S.inv_m_grip[0], w1 = S.inv_m_grip[1];
      float p = (S.vgqd[0] - S.vgqd[1]) / (w0 + w1);
      float g0 = S.vgqd[0] - p * w0, g1 = S.vgqd[1] + p * w1;
      S.vgqd[0] = g0; S.vgqd[1] = g1;
    }
  }
  T.sync();
}

// ---------------------------------------------------------------------------
// one substep (make_lane_substep) and the control interval (make_lane_sim)
// ---------------------------------------------------------------------------

// servo targets in S.ctrl, the gripper command in S.grip; λ in the lanes
FS_DEV void substep(const Model& M, EnvSh& S, const Team& T,
                    float (&lam)[FS_SLOTS][3]) {
  const int n = M.n_dof, na = M.n_arm;
  const float dt = M.dt;

  // ---- ABA, then the servos (one lane per dof)
  aba(M, S, T, S.q, S.qd);
  FS_MARK(FS_P_ABA);
  const float grip = S.grip[0];
  const float amount = M.panda ? grip : grip - 0.2f;
  for (int i = T.lane; i < n; i += FS_G) {
    float qd_free = S.qd[i] + dt * S.qdd[i];
    int kind = M.servo_kind[i];
    float target;
    if (kind == 0) target = S.ctrl[(int)M.servo_a[i]];
    else if (kind == 1) target = M.servo_a[i] * amount + M.servo_b[i];
    else if (kind == 2) target = S.q[(int)M.servo_a[i]];
    else target = 0.0f;
    float f = M.servo_f[i];
    float v_star = 0.1f * (target - S.q[i]) / dt;
    float imp = clipf(S.D[i] * (v_star - qd_free), -f * dt, f * dt);
    S.qd_arm[i] = qd_free + imp / fmaxf(S.D[i], 1e-9f);
  }
  T.sync();
  FS_MARK(FS_P_SERVO);

  // ---- contacts on the post-servo kinematics: the solver context, one
  // lane an item (stage 1: free update, pads, block inertias, gripper, arm,
  // element limits; stage 2: pad Jacobians and pad velocities)
  fk(M, S, T, S.q, S.qd_arm, n);
  for (int t = T.lane; t < 20; t += FS_G) {
    if (t == 0) {                       // scene free update
      for (int o = 0; o < M.n_obj; ++o) {
        S.vov[3 * o + 0] = S.ov[3 * o + 0] + dt * 0.0f;
        S.vov[3 * o + 1] = S.ov[3 * o + 1] + dt * 0.0f;
        S.vov[3 * o + 2] = S.ov[3 * o + 2] + dt * -9.8f;
        copy3(S.ow + 3 * o, S.vow + 3 * o);
      }
      for (int k = 0; k < FS_N_ART; ++k) {
        float aqd = (S.aqd[k] + dt * M.art_g[k]) * M.art_damp[k];
        float v_star = 0.1f * (M.art_motor_target[k] - S.aq[k]) / dt;
        float mf = M.art_motor_force[k], m = M.art_m[k];
        float imp = clipf(m * (v_star - aqd), -mf * dt, mf * dt);
        S.vaqd[k] = aqd + M.art_motor[k] * imp / m;
      }
    } else if (t < 1 + FS_N_PADS) {
      pad_kin(M, S, t - 1);
    } else if (t < 5 + FS_MAX_OBJ) {
      int o = t - 5;
      if (o >= M.n_obj) continue;
      float R[9];
      quat_to_mat33(S.oq + 4 * o, R);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          S.invI[9 * o + r * 3 + c] = R[r * 3 + 0] * M.block_inv_I[0] * R[c * 3 + 0]
                                    + R[r * 3 + 1] * M.block_inv_I[1] * R[c * 3 + 1]
                                    + R[r * 3 + 2] * M.block_inv_I[2] * R[c * 3 + 2];
    } else if (t < 7 + FS_MAX_GRIP) {
      int g = t - 7;
      if (g >= M.n_grip) continue;
      int d = M.grip_dof[g];
      qrot(S.quat + 4 * d, M.axis + 3 * d, S.ug + 3 * g);
      S.inv_m_grip[g] = 1.0f / fmaxf(S.D[d], 1e-4f);
      S.vgqd[g] = S.qd_arm[d];
    } else if (t < 9 + FS_MAX_ARM) {
      int j = t - 9;
      if (j >= na) continue;
      S.inv_D_arm[j] = 1.0f / fmaxf(S.D[j], 1e-4f);
      S.vadqd[j] = 0.0f;
    } else {
      int k = t - 16;
      S.at_low[k] = S.aq[k] <= (float)((double)M.art_lower[k] + 1e-4) ? 1.0f : 0.0f;
      S.at_high[k] = S.aq[k] >= (float)((double)M.art_upper[k] - 1e-4) ? 1.0f : 0.0f;
    }
  }
  T.sync();
  for (int t = T.lane; t < FS_N_PADS * (FS_MAX_ARM + 1); t += FS_G) {
    if (t < FS_N_PADS * FS_MAX_ARM) {   // pad p's Jacobian column j
      int p = t / FS_MAX_ARM, j = t % FS_MAX_ARM;
      if (j >= na || !M.pad_anc[p * FS_MAX_ARM + j]) continue;
      float aw[3];
      float* J = S.padJ + 3 * (p * FS_MAX_ARM + j);
      qrot(S.quat + 4 * j, M.axis + 3 * j, aw);
      if (M.revolute[j]) {
        float d[3];
        sub3(S.pc + 3 * p, S.pos + 3 * j, d);
        cross3(aw, d, J);
      } else {
        copy3(aw, J);
      }
    } else {                            // pad p's velocity without the gripper
      int p = t - FS_N_PADS * FS_MAX_ARM;
      const float* u = S.ug + 3 * M.pad_slot[p];
      float v = S.qd_arm[M.pad_parent[p]];
      for (int c = 0; c < 3; ++c) S.padv[3 * p + c] = S.pv[3 * p + c] - u[c] * v;
    }
  }
  T.sync();
  FS_MARK(FS_P_CONTEXT);

  // ---- each lane gathers its rows; mass-splitting counts over the team
  Row R[FS_SLOTS];
  float cnt[FS_N_CNT];
#pragma unroll
  for (int c = 0; c < FS_N_CNT; ++c) cnt[c] = 0.0f;
#pragma unroll
  for (int sl = 0; sl < FS_SLOTS; ++sl) {
    const int i = sl * FS_G + T.lane;
    if (i >= M.n_rows) continue;
    make_row(M, S, M.row_code[i], R[sl]);
    const int code = R[sl].code;
    const float af = R[sl].af;
    const int a = row_a(code), b = row_b(code), ak = row_k(code), g = row_g(code);
#pragma unroll
    for (int o = 0; o < FS_MAX_OBJ; ++o) {
      if (a == o) cnt[o] += af;
      if (b == o) cnt[o] += af;
    }
#pragma unroll
    for (int k = 0; k < FS_N_ART; ++k)
      if (ak == k) cnt[FS_CNT_ART + k] += af;
#pragma unroll
    for (int gg = 0; gg < FS_MAX_GRIP; ++gg)
      if (g == gg) cnt[FS_CNT_GRIP + gg] += af;
    if (row_pj(code) >= 0) cnt[FS_CNT_ARM] += af;
  }
#pragma unroll
  for (int c = 0; c < FS_N_CNT; ++c) cnt[c] = T.sum(cnt[c]);
  if (T.lane == 0)
#pragma unroll
    for (int c = 0; c < FS_N_CNT; ++c) S.cnt[c] = cnt[c];
  T.sync();
  FS_MARK(FS_P_GATHER);
#pragma unroll
  for (int sl = 0; sl < FS_SLOTS; ++sl) {
    if (sl * FS_G + T.lane >= M.n_rows) continue;
    R[sl].kn = k_dir(M, S, R[sl], R[sl].n);
    R[sl].kt1 = k_dir(M, S, R[sl], R[sl].t1);
    R[sl].kt2 = k_dir(M, S, R[sl], R[sl].t2);
  }
  FS_MARK(FS_P_KDIR);
  sweep(M, S, T, R, lam, true);
  FS_MARK(FS_P_WARM);
  for (int it = 0; it < M.solve_iters; ++it) sweep(M, S, T, R, lam, false);
  FS_MARK(FS_P_SWEEPS);

  // ---- write back solved velocities, integrate
  if (T.lane == 0) {
    for (int i = 0; i < n; ++i) {
      float v = S.qd_arm[i];
      int slot = -1;
      for (int g = 0; g < M.n_grip; ++g) if (M.grip_dof[g] == i) slot = g;
      if (slot >= 0) v = S.vgqd[slot];
      else if (i < na) v = S.qd_arm[i] + S.vadqd[i];
      float qn = S.q[i] + dt * v;
      float lo = M.lower[i], hi = M.upper[i];
      S.q[i] = clipf(qn, lo, hi);
      S.qd[i] = qn < lo ? fmaxf(v, 0.0f) : (qn > hi ? fminf(v, 0.0f) : v);
    }
    for (int o = 0; o < M.n_obj; ++o) {
      float w_[3];
      copy3(S.vow + 3 * o, w_);
      for (int c = 0; c < 3; ++c) {
        S.ov[3 * o + c] = S.vov[3 * o + c];
        S.ow[3 * o + c] = w_[c];
        S.op[3 * o + c] = S.op[3 * o + c] + dt * S.vov[3 * o + c];
      }
      // exponential-map quaternion update (spatial.quat_integrate)
      float angle = sqrtf(dot3(w_, w_) + 1e-12f);
      float m = fmaxf(angle, 1e-9f);
      float half = angle * M.half_dt;
      float s = sinf(half);
      float dq[4] = {w_[0] / m * s, w_[1] / m * s, w_[2] / m * s, cosf(half)};
      float oq[4], nq[4];
      copy4(S.oq + 4 * o, oq);
      qmul(dq, oq, nq);
      qnormalize(nq);
      copy4(nq, S.oq + 4 * o);
    }
    for (int k = 0; k < FS_N_ART; ++k) {
      float a = S.aq[k] + dt * S.vaqd[k];
      float c = clipf(a, M.art_lower[k], M.art_upper[k]);
      S.aqd[k] = a != c ? 0.0f : S.vaqd[k];
      S.aq[k] = c;
    }
  }
  T.sync();
  FS_MARK(FS_P_INTEGRATE);
}

// λ is warm-started across the substeps of one control interval and starts
// at zero in each
FS_DEV void run_sim(const Model& M, EnvSh& S, const Team& T) {
  float lam[FS_SLOTS][3];
#pragma unroll
  for (int sl = 0; sl < FS_SLOTS; ++sl)
#pragma unroll
    for (int c = 0; c < 3; ++c) lam[sl][c] = 0.0f;
  for (int s = 0; s < M.n_sub; ++s) substep(M, S, T, lam);
}

// ---------------------------------------------------------------------------
// control: action decode + DLS IK (make_lane_control / lane_ik_dls), in
// double. The DLS iteration is ill-conditioned where a joint limit or the
// step clamp cuts it (the Panda at the edge of its reach): there two float32
// orders of the same sums part by up to 1e-2 rad in the servo targets, and
// any one of them by as much from the float64 answer. So control, like the
// plain twin's, widens q and the action, runs in double, and rounds only
// the servo targets and the gripper command it hands the physics.
// ---------------------------------------------------------------------------

#define FS_IK_DAMP 0.05    // lane_ik_dls's damping and null-space gain
#define FS_IK_NULL 0.05

FS_DEV double clipd(double x, double lo, double hi) { return fmin(fmax(x, lo), hi); }
FS_DEV void load3(const float* a, double* o) { o[0] = a[0]; o[1] = a[1]; o[2] = a[2]; }
FS_DEV void load4(const float* a, double* o) {
  o[0] = a[0]; o[1] = a[1]; o[2] = a[2]; o[3] = a[3];
}
FS_DEV void qmul(const double* a, const double* b, double* o) {
  double ax = a[0], ay = a[1], az = a[2], aw = a[3];
  double bx = b[0], by = b[1], bz = b[2], bw = b[3];
  o[0] = aw * bx + ax * bw + ay * bz - az * by;
  o[1] = aw * by - ax * bz + ay * bw + az * bx;
  o[2] = aw * bz + ax * by - ay * bx + az * bw;
  o[3] = aw * bw - ax * bx - ay * by - az * bz;
}
FS_DEV void qnormalize(double* q) {
  double s = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + 1e-12);
  q[0] /= s; q[1] /= s; q[2] /= s; q[3] /= s;
}
FS_DEV void qrot(const double* q, const double* v, double* o) {
  double uv = q[0] * v[0] + q[1] * v[1] + q[2] * v[2];
  double uu = q[0] * q[0] + q[1] * q[1] + q[2] * q[2], w = q[3];
  double c0 = q[1] * v[2] - q[2] * v[1];
  double c1 = q[2] * v[0] - q[0] * v[2];
  double c2 = q[0] * v[1] - q[1] * v[0];
  double s = w * w - uu;
  double r0 = (2.0 * uv) * q[0] + s * v[0] + (2.0 * w) * c0;
  double r1 = (2.0 * uv) * q[1] + s * v[1] + (2.0 * w) * c1;
  double r2 = (2.0 * uv) * q[2] + s * v[2] + (2.0 * w) * c2;
  o[0] = r0; o[1] = r1; o[2] = r2;
}

FS_DEV void quat_from_euler(const double* rpy, double* o) {
  double r = rpy[0] * 0.5, p = rpy[1] * 0.5, y = rpy[2] * 0.5;
  double cr = cos(r), sr = sin(r), cp = cos(p), sp = sin(p);
  double cy = cos(y), sy = sin(y);
  o[0] = sr * cp * cy - cr * sp * sy;
  o[1] = cr * sp * cy + sr * cp * sy;
  o[2] = cr * cp * sy - sr * sp * cy;
  o[3] = cr * cp * cy + sr * sp * sy;
}

FS_DEV void quat_to_euler(const double* q, double* o) {
  double x = q[0], y = q[1], z = q[2], w = q[3];
  o[0] = atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y));
  o[1] = asin(clipd(2.0 * (w * y - z * x), -1.0 + 1e-7, 1.0 - 1e-7));
  o[2] = atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z));
}

// link poses 0..nl-1 at S.qs (lane_fk_links) in S.dpos / S.dquat: the
// lanes make the joint rotations, lane 0 runs the chain
FS_DEV void fk_links(const Model& M, EnvSh& S, const Team& T, int nl) {
  for (int i = T.lane; i < nl; i += FS_G) {
    if (!M.revolute[i]) continue;
    double half = 0.5 * S.qs[i], sn = sin(half);
    for (int c = 0; c < 3; ++c) S.djrot[4 * i + c] = M.axis[3 * i + c] * sn;
    S.djrot[4 * i + 3] = cos(half);
  }
  T.sync();
  if (T.lane == 0) {
    for (int i = 0; i < nl; ++i) {
      int p = M.parent[i];
      double pp[3], pq[4], pre[3], preq[4], t[3], jp[3], jq[4];
      if (p < 0) {
        load3(M.base_pos, pp); load4(M.base_quat, pq);
      } else {
        for (int c = 0; c < 3; ++c) pp[c] = S.dpos[3 * p + c];
        for (int c = 0; c < 4; ++c) pq[c] = S.dquat[4 * p + c];
      }
      load3(M.pre_pos + 3 * i, pre); load4(M.pre_quat + 4 * i, preq);
      qrot(pq, pre, t);
      for (int c = 0; c < 3; ++c) jp[c] = pp[c] + t[c];
      qmul(pq, preq, jq);
      if (M.revolute[i]) {
        double m[4];
        qmul(jq, S.djrot + 4 * i, m);
        qnormalize(m);
        for (int c = 0; c < 4; ++c) jq[c] = m[c];
      } else {
        double a[3];
        for (int c = 0; c < 3; ++c) a[c] = M.axis[3 * i + c] * (double)S.qs[i];
        qrot(jq, a, t);
        for (int c = 0; c < 3; ++c) jp[c] += t[c];
      }
      for (int c = 0; c < 3; ++c) S.dpos[3 * i + c] = jp[c];
      for (int c = 0; c < 4; ++c) S.dquat[4 * i + c] = jq[c];
    }
  }
  T.sync();
}

FS_DEV void site_pose_d(const Model& M, const EnvSh& S, double* xp, double* xq) {
  int par = M.ee_parent;
  double ep[3], eq[4], t[3];
  load3(M.ee_pos, ep); load4(M.ee_quat, eq);
  qrot(S.dquat + 4 * par, ep, t);
  for (int c = 0; c < 3; ++c) xp[c] = S.dpos[3 * par + c] + t[c];
  qmul(S.dquat + 4 * par, eq, xq);
}

// Cholesky of the SPD 6x6 A in place (_chol6_solve): L in the lower
// triangle, the upper one left as it was
FS_DEV void chol6_factor(double* A) {
  for (int j = 0; j < 6; ++j) {
    double acc = A[j * 6 + j];
    for (int k = 0; k < j; ++k) acc = acc - A[j * 6 + k] * A[j * 6 + k];
    double Ljj = sqrt(fmax(acc, 1e-12));
    A[j * 6 + j] = Ljj;
    double inv = 1.0 / Ljj;
    for (int i = j + 1; i < 6; ++i) {
      double a = A[i * 6 + j];
      for (int k = 0; k < j; ++k) a = a - A[i * 6 + k] * A[j * 6 + k];
      A[i * 6 + j] = a * inv;
    }
  }
}

// one right-hand side b through the factor L (lower triangle) into x
FS_DEV void chol6_solve(const double* L, const double* b, double* x) {
  double y[6];
  for (int i = 0; i < 6; ++i) {
    double acc = b[i];
    for (int k = 0; k < i; ++k) acc = acc - L[i * 6 + k] * y[k];
    y[i] = acc / L[i * 6 + i];
  }
  for (int i = 5; i >= 0; --i) {
    double acc = y[i];
    for (int k = i + 1; k < 6; ++k) acc = acc - L[k * 6 + i] * x[k];
    x[i] = acc / L[i * 6 + i];
  }
}

// damped least squares toward (S.tp, S.tq) with a rest-pose null space on
// S.qs; only the first n_arm dofs move. Lane i owns Jacobian column i and
// joint i, lane t < 21 entry t of J J^T's upper triangle.
FS_DEV void ik_dls(const Model& M, EnvSh& S, const Team& T) {
  const int n = M.n_dof, na = M.n_arm;
  for (int it = 0; it < M.ik_iters; ++it) {
    fk_links(M, S, T, M.ee_parent + 1);
    if (T.lane == 0) {
      double xp[3], xq[4];
      site_pose_d(M, S, xp, xq);
      double cq[4] = {-xq[0], -xq[1], -xq[2], xq[3]}, dq4[4];
      qmul(S.tq, cq, dq4);
      double e = dq4[3] + 1e-12;
      double sgn = e > 0.0 ? 1.0 : (e < 0.0 ? -1.0 : 0.0);
      for (int c = 0; c < 3; ++c) {
        S.xp[c] = xp[c];
        S.err[c] = S.tp[c] - xp[c];
        S.err[c + 3] = 2.0 * dq4[c] * sgn;
      }
    }
    T.sync();
    for (int i = T.lane; i < na; i += FS_G) {
      if (!M.ee_anc[i]) continue;
      double ax[3], aw[3];
      double* col = S.cols + 6 * i;
      load3(M.axis + 3 * i, ax);
      qrot(S.dquat + 4 * i, ax, aw);
      if (M.revolute[i]) {
        double d[3];
        for (int c = 0; c < 3; ++c) d[c] = S.xp[c] - S.dpos[3 * i + c];
        col[0] = aw[1] * d[2] - aw[2] * d[1];
        col[1] = aw[2] * d[0] - aw[0] * d[2];
        col[2] = aw[0] * d[1] - aw[1] * d[0];
        for (int c = 0; c < 3; ++c) col[c + 3] = aw[c];
      } else {
        for (int c = 0; c < 3; ++c) { col[c] = aw[c]; col[c + 3] = 0.0; }
      }
    }
    T.sync();
    for (int t = T.lane; t < 27; t += FS_G) {
      if (t < 21) {                     // A = J J^T + λ² I, entry (r, c), r <= c
        int r = 0, e = t;
        while (e >= 6 - r) { e -= 6 - r; ++r; }
        int c = r + e;
        double acc = r == c ? FS_IK_DAMP * FS_IK_DAMP : 0.0;
        for (int i = 0; i < na; ++i)
          if (M.ee_anc[i]) acc += S.cols[6 * i + r] * S.cols[6 * i + c];
        S.jjt[r * 6 + c] = acc;
        S.jjt[c * 6 + r] = acc;
      } else {                          // J dq_null, row r
        int r = t - 21;
        double acc = 0.0;
        for (int i = 0; i < na; ++i)
          if (M.ee_anc[i])
            acc += S.cols[6 * i + r] * (FS_IK_NULL * ((double)M.rest[i] - S.qs[i]));
        S.jdn[r] = acc;
      }
    }
    T.sync();
    if (T.lane == 0) {
      chol6_factor(S.jjt);
      chol6_solve(S.jjt, S.err, S.wsol);
      chol6_solve(S.jjt, S.jdn, S.wsol + 6);
    }
    T.sync();
    for (int i = T.lane; i < n; i += FS_G) {
      double qi = S.qs[i];
      if (i < na) {
        double d = FS_IK_NULL * ((double)M.rest[i] - qi);
        if (M.ee_anc[i]) {
          double je = 0.0, jn = 0.0;
          for (int r = 0; r < 6; ++r) {
            je += S.cols[6 * i + r] * S.wsol[r];
            jn += S.cols[6 * i + r] * S.wsol[6 + r];
          }
          d = (je + d) - jn;
        }
        S.qs[i] = clipd(qi + clipd(d, -0.5, 0.5), M.lower[i], M.upper[i]);
      } else {
        S.qs[i] = clipd(qi + 0.0, M.lower[i], M.upper[i]);
      }
    }
    T.sync();
  }
}

// the raw action in S.act -> servo targets in S.ctrl, gripper in S.grip
FS_DEV void control(const Model& M, EnvSh& S, const Team& T) {
  const int na = M.n_arm, A = M.action_dim, at = M.action_type;
  const bool joints = at == FS_REL_JOINTS || at == FS_ABS_JOINTS;
  for (int i = T.lane; i < M.n_dof; i += FS_G) S.qs[i] = S.q[i];
  T.sync();
  fk_links(M, S, T, M.ee_parent + 1);
  if (T.lane == 0) {
    double a[FS_MAX_ACT];
    for (int i = 0; i < A; ++i)
      a[i] = clipd(S.act[i], -(double)M.action_high[i], M.action_high[i]);
    S.grip[0] = (float)a[A - 1];
    double ee[3], eq[4];
    site_pose_d(M, S, ee, eq);
    if (at == FS_REL_JOINTS) {
      for (int j = 0; j < na; ++j) S.qs[j] = S.qs[j] + a[j];
    } else if (at == FS_ABS_JOINTS) {
      for (int j = 0; j < na; ++j) S.qs[j] = a[j];
    } else {
      double quat[4] = {0.0, 0.0, 0.0, 1.0};
      bool rel = at == FS_REL_QUAT || at == FS_REL_RPY || at == FS_REL_CART;
      for (int c = 0; c < 3; ++c) S.tp[c] = rel ? a[c] + ee[c] : a[c];
      if (at == FS_ABS_QUAT) {
        if (M.use_orientation) {
          for (int c = 0; c < 4; ++c) quat[c] = a[3 + c];
          qnormalize(quat);
        }
      } else if (at == FS_REL_QUAT) {
        // the reference adds quaternions componentwise
        for (int c = 0; c < 4; ++c) quat[c] = a[3 + c] + eq[c];
        qnormalize(quat);
      } else if (at == FS_ABS_RPY) {
        double rpy[3] = {a[3], a[4], a[5]};
        quat_from_euler(rpy, quat);
      } else if (at == FS_REL_RPY || M.use_orientation) {
        double rpy[3];
        quat_to_euler(eq, rpy);
        for (int c = 0; c < 3; ++c) rpy[c] = rpy[c] + a[3 + c];
        quat_from_euler(rpy, quat);
      }
      for (int c = 0; c < 4; ++c) S.tq[c] = quat[c];
    }
  }
  T.sync();
  FS_MARK(FS_P_CONTROL);
  if (!joints) ik_dls(M, S, T);
  FS_MARK(FS_P_IK);
  if (T.lane == 0) {
    for (int j = 0; j < na; ++j) {
      double t = clipd(S.qs[j], M.ctrl_lower[j], M.ctrl_upper[j]);
      double q = S.q[j], inc = M.rate_limit[j];
      S.ctrl[j] = (float)clipd(t, q - inc, q + inc);
    }
  }
  T.sync();
  FS_MARK(FS_P_CONTROL);
}

// achieved goal of one env (make_pallas_rollout's ag_of), by lane 0
FS_DEV void write_ag(const Model& M, EnvSh& S, const Team& T, float* ags,
                     long h, long b, long B) {
  const bool reach = M.n_obj == 0 && !M.play;
  if (reach || M.with_ee) fk(M, S, T, S.q, nullptr, M.ee_parent + 1);
  if (T.lane == 0) {
    long base = h * M.ag_dim;
    int r = 0;
    float ee[3], eq[4];
    if (reach) {
      site_pose(M, S, ee, eq);
      for (int c = 0; c < 3; ++c) ags[(base + r++) * B + b] = ee[c];
    } else {
      for (int o = 0; o < M.n_obj; ++o) {
        for (int c = 0; c < 3; ++c) ags[(base + r++) * B + b] = S.op[3 * o + c];
        if (M.play || M.use_orientation)
          for (int c = 0; c < 4; ++c) ags[(base + r++) * B + b] = S.oq[4 * o + c];
      }
      if (M.play) {
        for (int k = 0; k < 3; ++k) ags[(base + r++) * B + b] = S.aq[k];
        // dial_to_0_1_range, precedence bug included: ((x % 2)·π)/(2.2·π)
        ags[(base + r++) * B + b] = floor_mod2(S.aq[3]) * M.dial_mul / M.dial_div;
      }
      if (M.with_ee) {
        site_pose(M, S, ee, eq);
        for (int c = 0; c < 3; ++c) ags[(base + r++) * B + b] = ee[c];
      }
    }
  }
  T.sync();
  FS_MARK(FS_P_AG);
}

// ---------------------------------------------------------------------------
// per-env bodies of the three kernels (run by every lane of the team)
// ---------------------------------------------------------------------------

FS_DEV void load_actions(const Model& M, EnvSh& S, const Team& T, const float* act,
                         long b, long B) {
  for (int i = T.lane; i < M.action_dim; i += FS_G) S.act[i] = act[i * B + b];
  T.sync();
  FS_MARK(FS_P_IO);
}

FS_DEV void env_sim(const Model& M, EnvSh& S, const Team& T, const float* X,
                    const float* ctrl, const float* grip, float* Y, long b, long B) {
  load_state(M, S, T, X, b, B);
  for (int j = T.lane; j < M.n_arm; j += FS_G) S.ctrl[j] = ctrl[j * B + b];
  if (T.lane == 0) S.grip[0] = grip[b];
  T.sync();
  FS_MARK(FS_P_IO);
  run_sim(M, S, T);
  store_state(M, S, T, Y, b, B);
}

// C (n_arm + 1, B), when given, receives the servo targets and the
// gripper command that control() chose (the env step's ctrl_q and grip)
FS_DEV void env_step(const Model& M, EnvSh& S, const Team& T, const float* X,
                     const float* act, float* Y, float* C, long b, long B) {
  load_state(M, S, T, X, b, B);
  load_actions(M, S, T, act, b, B);
  control(M, S, T);
  if (C) {
    for (int j = T.lane; j < M.n_arm; j += FS_G) C[j * B + b] = S.ctrl[j];
    if (T.lane == 0) C[M.n_arm * B + b] = S.grip[0];
  }
  run_sim(M, S, T);
  store_state(M, S, T, Y, b, B);
}

FS_DEV void env_rollout(const Model& M, EnvSh& S, const Team& T, const float* X,
                        const float* act, float* Y, float* ags, int H, long b,
                        long B) {
  load_state(M, S, T, X, b, B);
  for (int h = 0; h < H; ++h) {
    load_actions(M, S, T, act + (long)h * M.action_dim * B, b, B);
    control(M, S, T);
    run_sim(M, S, T);
    write_ag(M, S, T, ags, h, b, B);
  }
  store_state(M, S, T, Y, b, B);
}

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes)
// ---------------------------------------------------------------------------

#define FS_OFF_S(t, name) if (i < cap) offs[i] = (int)offsetof(Model, name); ++i;
#define FS_OFF_A(t, name, n) if (i < cap) offs[i] = (int)offsetof(Model, name); ++i;

// byte offset of every Model field in declaration order, then sizeof(Model);
// returns the number of entries written (fields + 1)
extern "C" int fs_model_layout(int* offs, int cap) {
  int i = 0;
  FS_MODEL_FIELDS(FS_OFF_S, FS_OFF_A)
  if (i < cap) offs[i] = (int)sizeof(Model);
  return i + 1;
}

#ifdef __CUDACC__

// Block: FS_ENVS warps, one env each. Dynamic shared memory: the Model
// (rounded up to 16 bytes), then one EnvSh per warp.
#define FS_THREADS (FS_ENVS * FS_TEAM)
#define FS_MODEL_SMEM ((sizeof(Model) + 15) / 16 * 16)
#define FS_SMEM_BYTES (FS_MODEL_SMEM + FS_ENVS * sizeof(EnvSh))
static_assert(FS_G == 32, "one env per warp on the card");
static_assert(FS_SMEM_BYTES <= 232448, "shared memory of one block");

__device__ __forceinline__ unsigned char* fs_smem() {
  extern __shared__ __align__(16) unsigned char fs_shared[];
  return fs_shared;
}

// the block copies the model into shared memory; every warp then reads it
__device__ __forceinline__ const Model& block_model(const Model* __restrict__ Mg) {
  Model* Ms = reinterpret_cast<Model*>(fs_smem());
  const int* src = reinterpret_cast<const int*>(Mg);
  int* dst = reinterpret_cast<int*>(Ms);
  for (int i = threadIdx.x; i < (int)(sizeof(Model) / 4); i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  return *Ms;
}

__device__ __forceinline__ EnvSh& warp_env() {
  return reinterpret_cast<EnvSh*>(fs_smem() + FS_MODEL_SMEM)[threadIdx.x / FS_TEAM];
}

__global__ void __launch_bounds__(FS_THREADS)
fs_sim_kernel(const Model* __restrict__ Mg, const float* __restrict__ X,
              const float* __restrict__ ctrl, const float* __restrict__ grip,
              float* __restrict__ Y, int B) {
  const Model& M = block_model(Mg);
  long b = (long)blockIdx.x * FS_ENVS + threadIdx.x / FS_TEAM;
  if (b >= B) return;
  Team T{(int)(threadIdx.x % FS_TEAM)};
  env_sim(M, warp_env(), T, X, ctrl, grip, Y, b, B);
}

__global__ void __launch_bounds__(FS_THREADS)
fs_step_kernel(const Model* __restrict__ Mg, const float* __restrict__ X,
               const float* __restrict__ act, float* __restrict__ Y,
               float* __restrict__ C, int B) {
  const Model& M = block_model(Mg);
  long b = (long)blockIdx.x * FS_ENVS + threadIdx.x / FS_TEAM;
  if (b >= B) return;
  Team T{(int)(threadIdx.x % FS_TEAM)};
  env_step(M, warp_env(), T, X, act, Y, C, b, B);
}

__global__ void __launch_bounds__(FS_THREADS)
fs_rollout_kernel(const Model* __restrict__ Mg, const float* __restrict__ X,
                  const float* __restrict__ act, float* __restrict__ Y,
                  float* __restrict__ ags, int H, int B) {
  const Model& M = block_model(Mg);
  long b = (long)blockIdx.x * FS_ENVS + threadIdx.x / FS_TEAM;
  if (b >= B) return;
  Team T{(int)(threadIdx.x % FS_TEAM)};
  env_rollout(M, warp_env(), T, X, act, Y, ags, H, b, B);
}

static unsigned fs_blocks(int B) { return (unsigned)((B + FS_ENVS - 1) / FS_ENVS); }

// Each launcher enqueues on the given stream, does not synchronise, and
// returns the first CUDA error (0 = launched); an empty batch is refused.
template <typename K>
static int fs_allow_smem(K kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)FS_SMEM_BYTES);
}

extern "C" int fs_sim(const void* M, const void* X, const void* ctrl,
                      const void* grip, void* Y, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  int code = fs_allow_smem(fs_sim_kernel);
  if (code != 0) return code;
  fs_sim_kernel<<<fs_blocks(B), FS_THREADS, FS_SMEM_BYTES, (cudaStream_t)stream>>>(
      (const Model*)M, (const float*)X, (const float*)ctrl, (const float*)grip,
      (float*)Y, B);
  return (int)cudaGetLastError();
}

// C (n_arm + 1, B), when not null, receives the servo targets and gripper
// command that control chose
extern "C" int fs_step(const void* M, const void* X, const void* act, void* Y,
                       void* C, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  int code = fs_allow_smem(fs_step_kernel);
  if (code != 0) return code;
  fs_step_kernel<<<fs_blocks(B), FS_THREADS, FS_SMEM_BYTES, (cudaStream_t)stream>>>(
      (const Model*)M, (const float*)X, (const float*)act, (float*)Y, (float*)C, B);
  return (int)cudaGetLastError();
}

extern "C" int fs_rollout(const void* M, const void* X, const void* act, void* Y,
                          void* ags, int H, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  int code = fs_allow_smem(fs_rollout_kernel);
  if (code != 0) return code;
  fs_rollout_kernel<<<fs_blocks(B), FS_THREADS, FS_SMEM_BYTES, (cudaStream_t)stream>>>(
      (const Model*)M, (const float*)X, (const float*)act, (float*)Y,
      (float*)ags, H, B);
  return (int)cudaGetLastError();
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef FS_PROFILE
// copy out the phase counters (FS_P_N of them) and zero them; synchronises
extern "C" int fs_profile_read(unsigned long long* out) {
  unsigned long long zero[FS_P_N] = {0};
  int code = (int)cudaMemcpyFromSymbol(out, fs_prof, sizeof(zero));
  if (code == 0) code = (int)cudaMemcpyToSymbol(fs_prof, zero, sizeof(zero));
  return code;
}
#endif

#endif  // __CUDACC__
