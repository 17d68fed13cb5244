// Fused playroom physics for NVIDIA Hopper (sm_90a): one CUDA thread per env.
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
// against ~1.5 MFLOP of scalar float32 work per env and control step
// (12 x [FK, ABA over a 12-link tree with 6x6 articulated inertias, ~76
// contact rows, 8 Jacobi sweeps] + 24 IK iterations). The work is
// branchy, tree-structured scalar recurrence, not matrix products, so the
// tensor cores do not apply; the limit is the FP32 pipes and, above all,
// the per-thread working set (6x6 inertias of every link, the contact rows
// and their warm-started impulses, ~16 KB), which lives in local memory
// (L1/L2-cached) rather than registers.
//
// What the design does about it, for now: the simple form first. One
// thread owns one env for the whole launch (the TPU kernel's "one env
// scalar = one lane", with the lanes becoming threads), so nothing crosses
// threads or blocks and no sync is needed. State is read as X[r*B + b]:
// neighbouring threads touch neighbouring addresses (coalesced). The
// rollout kernel loops over the horizon inside the thread, so the state
// never returns to device memory between control steps. Model constants sit
// in one read-only struct that every thread reads at the same addresses
// (broadcast through the cache). Local-memory pressure and occupancy are
// the next PRs' work (ROADMAP: the ABA rewrite first).
//
// Numerics: float32 throughout, constants folded in float64 on the host as
// the JAX trace folds them. Built without --use_fast_math; nvcc contracts
// a*b+c into FMAs by default, which moves results at the rounding level;
// the tolerances the kernel is held to (chip_smoke.py) absorb this
// (-fmad=false is for diagnosing a mismatch only). Python floor-mod is
// x - 2 floor(x/2), never fmodf. First-max ties in the deepest-contact
// selection take the lowest index, as the JAX twin's mask does.

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FS_DEV __device__ __forceinline__
#define FS_BIG __device__ __noinline__
#else
#define FS_DEV static inline
#define FS_BIG static
#endif

// compile-time maxima (per-thread arrays); loop counts are runtime
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

// action decode modes (envs/config.py action_type)
#define FS_ABS_QUAT 0
#define FS_REL_QUAT 1
#define FS_REL_JOINTS 2
#define FS_ABS_JOINTS 3
#define FS_ABS_RPY 4
#define FS_REL_RPY 5
#define FS_REL_CART 6

// Model constants: one POD struct. The Python wrapper parses this field
// list (S = scalar, A = array) to lay out the same struct with ctypes, and
// checks the offsets against fs_model_layout().
#define FS_MODEL_FIELDS(S, A)                                               \
  S(int, n_dof) S(int, n_arm) S(int, n_obj) S(int, n_static)                \
  S(int, n_sub) S(int, solve_iters) S(int, ik_iters) S(int, action_type)    \
  S(int, use_orientation) S(int, play) S(int, with_ee) S(int, has_art)      \
  S(int, nf) S(int, action_dim) S(int, ag_dim) S(int, panda)                \
  S(int, n_grip) S(int, ee_parent)                                          \
  A(int, parent, FS_MAX_DOF) A(int, revolute, FS_MAX_DOF)                   \
  A(int, ee_anc, FS_MAX_ARM) A(int, pad_parent, FS_N_PADS)                  \
  A(int, pad_slot, FS_N_PADS) A(int, pad_anc, FS_N_PADS * FS_MAX_ARM)       \
  A(int, grip_dof, FS_MAX_GRIP) A(int, servo_kind, FS_MAX_DOF)              \
  A(int, art_rev, FS_N_ART) A(int, art_nb, FS_N_ART)                        \
  S(float, dt) S(float, half_dt) S(float, plane_z) S(float, inv_m_blk)      \
  S(float, mu_world) S(float, mu_pad) S(float, mu_art) S(float, mu_bb)      \
  S(float, ik_damp2) S(float, dial_mul) S(float, dial_div)                  \
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
// per-env state (the packed rows of one column of X)
// ---------------------------------------------------------------------------

struct State {
  float q[FS_MAX_DOF], qd[FS_MAX_DOF];
  float op[FS_MAX_OBJ][3], oq[FS_MAX_OBJ][4], ov[FS_MAX_OBJ][3], ow[FS_MAX_OBJ][3];
  float aq[FS_N_ART], aqd[FS_N_ART];
};

FS_DEV void load_state(const Model* M, const float* X, long b, long B, State* s) {
  int n = M->n_dof, no = M->n_obj, r = 0;
  for (int i = 0; i < n; ++i) s->q[i] = X[(r++) * B + b];
  for (int i = 0; i < n; ++i) s->qd[i] = X[(r++) * B + b];
  for (int o = 0; o < no; ++o) for (int c = 0; c < 3; ++c) s->op[o][c] = X[(r++) * B + b];
  for (int o = 0; o < no; ++o) for (int c = 0; c < 4; ++c) s->oq[o][c] = X[(r++) * B + b];
  for (int o = 0; o < no; ++o) for (int c = 0; c < 3; ++c) s->ov[o][c] = X[(r++) * B + b];
  for (int o = 0; o < no; ++o) for (int c = 0; c < 3; ++c) s->ow[o][c] = X[(r++) * B + b];
  for (int k = 0; k < FS_N_ART; ++k) s->aq[k] = X[(r++) * B + b];
  for (int k = 0; k < FS_N_ART; ++k) s->aqd[k] = X[(r++) * B + b];
}

FS_DEV void store_state(const Model* M, const State* s, long b, long B, float* Y) {
  int n = M->n_dof, no = M->n_obj, r = 0;
  for (int i = 0; i < n; ++i) Y[(r++) * B + b] = s->q[i];
  for (int i = 0; i < n; ++i) Y[(r++) * B + b] = s->qd[i];
  for (int o = 0; o < no; ++o) for (int c = 0; c < 3; ++c) Y[(r++) * B + b] = s->op[o][c];
  for (int o = 0; o < no; ++o) for (int c = 0; c < 4; ++c) Y[(r++) * B + b] = s->oq[o][c];
  for (int o = 0; o < no; ++o) for (int c = 0; c < 3; ++c) Y[(r++) * B + b] = s->ov[o][c];
  for (int o = 0; o < no; ++o) for (int c = 0; c < 3; ++c) Y[(r++) * B + b] = s->ow[o][c];
  for (int k = 0; k < FS_N_ART; ++k) Y[(r++) * B + b] = s->aq[k];
  for (int k = 0; k < FS_N_ART; ++k) Y[(r++) * B + b] = s->aqd[k];
}

// ---------------------------------------------------------------------------
// FK (lane_fk_vel / lane_fk_links) and pad kinematics (lane_pad_kinematics)
// ---------------------------------------------------------------------------

struct Kin {
  float pos[FS_MAX_DOF][3], quat[FS_MAX_DOF][4], lv[FS_MAX_DOF][3], av[FS_MAX_DOF][3];
};

// qd == nullptr: positions/orientations only
FS_BIG void fk(const Model* M, const float* q, const float* qd, Kin* K) {
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < M->n_dof; ++i) {
    int p = M->parent[i];
    const float *pp, *pq, *plv, *pav;
    if (p < 0) {
      pp = M->base_pos; pq = M->base_quat; plv = zero3; pav = zero3;
    } else {
      pp = K->pos[p]; pq = K->quat[p]; plv = K->lv[p]; pav = K->av[p];
    }
    const float* ax = M->axis + 3 * i;
    float t[3], jp[3], jq[4];
    qrot(pq, M->pre_pos + 3 * i, t);
    jp[0] = pp[0] + t[0]; jp[1] = pp[1] + t[1]; jp[2] = pp[2] + t[2];
    qmul(pq, M->pre_quat + 4 * i, jq);
    if (M->revolute[i]) {
      float dq[4], m[4];
      q_axis_angle(ax, q[i], dq);
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
      if (M->revolute[i]) {
        for (int k = 0; k < 3; ++k) va[k] = va[k] + aw[k] * qd[i];
      } else {
        for (int k = 0; k < 3; ++k) vl[k] = vl[k] + aw[k] * qd[i];
      }
      copy3(vl, K->lv[i]);
      copy3(va, K->av[i]);
    }
    copy3(jp, K->pos[i]);
    copy4(jq, K->quat[i]);
  }
}

FS_DEV void site_pose(const Model* M, const Kin* K, float* xp, float* xq) {
  int par = M->ee_parent;
  float t[3];
  qrot(K->quat[par], M->ee_pos, t);
  xp[0] = K->pos[par][0] + t[0]; xp[1] = K->pos[par][1] + t[1]; xp[2] = K->pos[par][2] + t[2];
  qmul(K->quat[par], M->ee_quat, xq);
}

FS_DEV void pad_kin(const Model* M, const Kin* K, float (*pc)[3], float (*pv)[3]) {
  for (int p = 0; p < FS_N_PADS; ++p) {
    int par = M->pad_parent[p];
    float t[3], spos[3], squat[4], c[3], d[3], w[3];
    qrot(K->quat[par], M->pad_site_pos + 3 * p, t);
    for (int k = 0; k < 3; ++k) spos[k] = K->pos[par][k] + t[k];
    qmul(K->quat[par], M->pad_site_quat + 4 * p, squat);
    qrot(squat, M->pad_off + 3 * p, t);
    for (int k = 0; k < 3; ++k) c[k] = spos[k] + t[k];
    sub3(c, K->pos[par], d);
    cross3(K->av[par], d, w);
    for (int k = 0; k < 3; ++k) { pc[p][k] = c[k]; pv[p][k] = K->lv[par][k] + w[k]; }
  }
}

// ---------------------------------------------------------------------------
// ABA (lane_aba): qdd and the joint-space diagonal D, no external forces
// ---------------------------------------------------------------------------

struct AbaWork {
  float E[FS_MAX_DOF][9], p[FS_MAX_DOF][3];
  float c6[FS_MAX_DOF][6], v6[FS_MAX_DOF][6];
  float IA[FS_MAX_DOF][36], pA[FS_MAX_DOF][6];
  float U[FS_MAX_DOF][6], u[FS_MAX_DOF];
};

// X = [[E, 0], [-E p~, E]] with p~ = skew(p)
FS_DEV void build_X(const float* E, const float* p, float* X) {
  float Sk[9] = {0.0f, -p[2], p[1], p[2], 0.0f, -p[0], -p[1], p[0], 0.0f};
  for (int r = 0; r < 6; ++r) for (int c = 0; c < 6; ++c) X[r * 6 + c] = 0.0f;
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) {
      X[r * 6 + c] = E[r * 3 + c];
      X[(r + 3) * 6 + c + 3] = E[r * 3 + c];
      float e = E[r * 3 + 0] * Sk[0 * 3 + c] + E[r * 3 + 1] * Sk[1 * 3 + c]
              + E[r * 3 + 2] * Sk[2 * 3 + c];
      X[(r + 3) * 6 + c] = -e;
    }
  }
}

FS_DEV void m6v(const float* A, const float* v, float* o) {
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
    for (int j = 0; j < 6; ++j) s += A[i * 6 + j] * v[j];
    o[i] = s;
  }
}
FS_DEV void m6Tv(const float* A, const float* v, float* o) {
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
    for (int j = 0; j < 6; ++j) s += A[j * 6 + i] * v[j];
    o[i] = s;
  }
}

FS_BIG void aba(const Model* M, const float* q, const float* qd, AbaWork* W,
                float* qdd, float* D) {
  int n = M->n_dof;
  for (int i = 0; i < n; ++i) {
    // joint transform and motion subspace
    float S[6] = {0, 0, 0, 0, 0, 0};
    const float* ax = M->axis + 3 * i;
    if (M->revolute[i]) {
      float dq[4], jq[4], cq[4];
      q_axis_angle(ax, q[i], dq);
      qmul(M->pre_quat + 4 * i, dq, jq);
      cq[0] = -jq[0]; cq[1] = -jq[1]; cq[2] = -jq[2]; cq[3] = jq[3];
      quat_to_mat33(cq, W->E[i]);
      copy3(M->pre_pos + 3 * i, W->p[i]);
      S[0] = ax[0]; S[1] = ax[1]; S[2] = ax[2];
    } else {
      for (int k = 0; k < 9; ++k) W->E[i][k] = M->pris_E[9 * i + k];
      for (int k = 0; k < 3; ++k)
        W->p[i][k] = M->pre_pos[3 * i + k] + M->pris_rax[3 * i + k] * q[i];
      S[3] = ax[0]; S[4] = ax[1]; S[5] = ax[2];
    }
    float X[36], vi[6];
    build_X(W->E[i], W->p[i], X);
    int par = M->parent[i];
    if (par >= 0) m6v(X, W->v6[par], vi);
    else for (int k = 0; k < 6; ++k) vi[k] = 0.0f;
    float sqd[6];
    for (int k = 0; k < 6; ++k) { sqd[k] = S[k] * qd[i]; vi[k] = vi[k] + sqd[k]; }
    // c = v x (S qd) (motion cross)
    float cx[3], c1[3], c2[3];
    cross3(vi, sqd, cx);
    cross3(vi + 3, sqd, c1);
    cross3(vi, sqd + 3, c2);
    W->c6[i][0] = cx[0]; W->c6[i][1] = cx[1]; W->c6[i][2] = cx[2];
    W->c6[i][3] = c1[0] + c2[0]; W->c6[i][4] = c1[1] + c2[1]; W->c6[i][5] = c1[2] + c2[2];
    // p = v x* (I v)
    const float* I6 = M->inertia6 + 36 * i;
    float Iv[6], pn1[3], pn2[3], pf[3];
    m6v(I6, vi, Iv);
    cross3(vi, Iv, pn1);
    cross3(vi + 3, Iv + 3, pn2);
    cross3(vi, Iv + 3, pf);
    W->pA[i][0] = pn1[0] + pn2[0]; W->pA[i][1] = pn1[1] + pn2[1]; W->pA[i][2] = pn1[2] + pn2[2];
    W->pA[i][3] = pf[0]; W->pA[i][4] = pf[1]; W->pA[i][5] = pf[2];
    for (int k = 0; k < 36; ++k) W->IA[i][k] = I6[k];
    for (int k = 0; k < 6; ++k) W->v6[i][k] = vi[k];
  }

  for (int i = n - 1; i >= 0; --i) {
    const float* ax = M->axis + 3 * i;
    float S[6] = {0, 0, 0, 0, 0, 0};
    if (M->revolute[i]) { S[0] = ax[0]; S[1] = ax[1]; S[2] = ax[2]; }
    else { S[3] = ax[0]; S[4] = ax[1]; S[5] = ax[2]; }
    float* Ui = W->U[i];
    m6v(W->IA[i], S, Ui);
    float sU = 0.0f, sp = 0.0f;
    for (int k = 0; k < 6; ++k) { sU += S[k] * Ui[k]; sp += S[k] * W->pA[i][k]; }
    float Di = sU + 1e-9f;
    float ui = (-M->damping[i]) * qd[i] - sp;
    D[i] = Di;
    W->u[i] = ui;
    int par = M->parent[i];
    if (par >= 0) {
      float invD = 1.0f / Di;
      float Ia[36], Iac[6], pa[6], X[36], IaX[36], Xtpa[6];
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c)
          Ia[r * 6 + c] = W->IA[i][r * 6 + c] - (Ui[r] * invD) * Ui[c];
      m6v(Ia, W->c6[i], Iac);
      float uD = ui * invD;
      for (int k = 0; k < 6; ++k) pa[k] = (W->pA[i][k] + Iac[k]) + Ui[k] * uD;
      build_X(W->E[i], W->p[i], X);
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) {
          float s = 0.0f;
          for (int k = 0; k < 6; ++k) s += Ia[r * 6 + k] * X[k * 6 + c];
          IaX[r * 6 + c] = s;
        }
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) {
          float s = 0.0f;
          for (int k = 0; k < 6; ++k) s += X[k * 6 + r] * IaX[k * 6 + c];
          W->IA[par][r * 6 + c] += s;
        }
      m6Tv(X, pa, Xtpa);
      for (int k = 0; k < 6; ++k) W->pA[par][k] += Xtpa[k];
    }
  }

  // forward: accelerations (a6 reuses v6's storage)
  for (int i = 0; i < n; ++i) {
    const float* ax = M->axis + 3 * i;
    float S[6] = {0, 0, 0, 0, 0, 0};
    if (M->revolute[i]) { S[0] = ax[0]; S[1] = ax[1]; S[2] = ax[2]; }
    else { S[3] = ax[0]; S[4] = ax[1]; S[5] = ax[2]; }
    int par = M->parent[i];
    float X[36], ai[6];
    build_X(W->E[i], W->p[i], X);
    m6v(X, par >= 0 ? W->v6[par] : M->a_base, ai);
    float Ua = 0.0f;
    for (int k = 0; k < 6; ++k) { ai[k] = ai[k] + W->c6[i][k]; Ua += W->U[i][k] * ai[k]; }
    float qddi = (W->u[i] - Ua) / D[i];
    for (int k = 0; k < 6; ++k) W->v6[i][k] = ai[k] + S[k] * qddi;
    qdd[i] = qddi;
  }
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
FS_DEV void art_pose(const Model* M, int k, float aq, float* pos, float* quat) {
  const float* ax = M->art_axis + 3 * k;
  const float* an = M->art_anchor + 3 * k;
  if (M->art_rev[k]) {
    q_axis_angle(ax, aq, quat);
    copy3(an, pos);
  } else {
    for (int c = 0; c < 3; ++c) pos[c] = an[c] + ax[c] * aq;
    quat[0] = 0.0f; quat[1] = 0.0f; quat[2] = 0.0f; quat[3] = 1.0f;
  }
}

// ---------------------------------------------------------------------------
// contact rows (gather_bundles): one row per manifold point, in the JAX
// twin's bundle order; `last` marks the final row of each bundle
// ---------------------------------------------------------------------------

struct Row {
  float pt[3], n[3], t1[3], t2[3];
  float vt, af, kn, kt1, kt2, mu;
  signed char a, b, k, g, pj, vk, last;
};

struct Rows {
  Row r[FS_MAX_ROWS];
  int n;
};

FS_DEV void put_row(const Model* M, Rows* R, const float* pt, const float* n,
                    float depth, float mu, int a, int b, int k, int g, int pj,
                    int vk, bool last) {
  Row* w = &R->r[R->n++];
  copy3(pt, w->pt);
  copy3(n, w->n);
  w->af = depth > 0.0f ? 1.0f : 0.0f;
  w->vt = fminf(0.2f * fmaxf(depth - 5e-4f, 0.0f) / M->dt, 0.05f);
  // tangent basis (contact_solver._tangent_basis)
  bool nz = fabsf(n[2]) < 0.9f;
  float ax[3] = {nz ? 0.0f : 1.0f, 0.0f, nz ? 1.0f : 0.0f};
  float t1[3];
  cross3(n, ax, t1);
  float s = sqrtf(dot3(t1, t1) + 1e-12f);
  t1[0] /= s; t1[1] /= s; t1[2] /= s;
  copy3(t1, w->t1);
  cross3(n, t1, w->t2);
  w->mu = mu;
  w->a = (signed char)a; w->b = (signed char)b; w->k = (signed char)k;
  w->g = (signed char)g; w->pj = (signed char)pj; w->vk = (signed char)vk;
  w->last = last ? 1 : 0;
}

// first-max selection helper: keep candidate i if strictly deeper
#define FS_KEEP(cond_deeper) (best < 0 || (cond_deeper))

FS_BIG void gather_rows(const Model* M, const State* st, const float (*pc)[3],
                        Rows* R) {
  const float up[3] = {0.0f, 0.0f, 1.0f};
  const float down[3] = {-0.0f, -0.0f, -1.0f};
  const float zero3[3] = {0.0f, 0.0f, 0.0f};
  float corners[FS_MAX_OBJ][8][3];
  R->n = 0;
  for (int o = 0; o < M->n_obj; ++o) {
    for (int c = 0; c < 8; ++c) {
      float local[3] = {((c >> 2) & 1 ? 1.0f : -1.0f) * M->block_half[0],
                        ((c >> 1) & 1 ? 1.0f : -1.0f) * M->block_half[1],
                        (c & 1 ? 1.0f : -1.0f) * M->block_half[2]};
      float t[3];
      qrot(st->oq[o], local, t);
      for (int k = 0; k < 3; ++k) corners[o][c][k] = st->op[o][k] + t[k];
    }
    // floor
    for (int c = 0; c < 8; ++c)
      put_row(M, R, corners[o][c], up, M->plane_z - corners[o][c][2],
              M->mu_world, o, -1, -1, -1, -1, -1, c == 7);
    // statics: deepest static box per corner
    if (M->n_static > 0) {
      for (int c = 0; c < 8; ++c) {
        int best = -1;
        float bd = 0.0f, bn[3] = {0, 0, 0};
        for (int s = 0; s < M->n_static; ++s) {
          float dp[3], dr[3], n[3], d;
          sub3(corners[o][c], M->static_pos + 3 * s, dp);
          sub3(st->op[o], M->static_pos + 3 * s, dr);
          points_aabox_ref(dp, dr, M->static_half + 3 * s, n, &d);
          if (FS_KEEP(d > bd)) { best = s; bd = d; copy3(n, bn); }
        }
        put_row(M, R, corners[o][c], bn, bd, M->mu_world, o, -1, -1, -1, -1, -1,
                c == 7);
      }
    }
    // articulated elements: deepest real box per corner, per element
    if (M->has_art) {
      for (int k = 0; k < FS_N_ART; ++k) {
        int nb = M->art_nb[k];
        if (nb == 0) continue;
        float bpos[3], bq[4];
        art_pose(M, k, st->aq[k], bpos, bq);
        for (int c = 0; c < 8; ++c) {
          int best = -1;
          float bd = 0.0f, bn[3] = {0, 0, 0}, bp[3] = {0, 0, 0};
          for (int b = 0; b < nb; ++b) {
            int j = k * FS_MAX_ART_BOXES + b;
            float center[3], t[3], pt[3], n[3], d;
            qrot(bq, M->art_box_pos + 3 * j, t);
            for (int e = 0; e < 3; ++e) center[e] = bpos[e] + t[e];
            points_obox_ref(corners[o][c], st->op[o], center, bq,
                            M->art_box_half + 3 * j, pt, n, &d);
            if (FS_KEEP(d > bd)) { best = b; bd = d; copy3(n, bn); copy3(pt, bp); }
          }
          put_row(M, R, bp, bn, bd, M->mu_art, o, -1, k, -1, -1, -1, c == 7);
        }
      }
    }
    // pads vs this block (normal flipped INTO the block)
    for (int p = 0; p < FS_N_PADS; ++p) {
      float pt[3], n[3], d;
      sphere_obox(pc[p], M->pad_r[p], st->op[o], st->oq[o], M->block_half, pt, n, &d);
      n[0] = -n[0]; n[1] = -n[1]; n[2] = -n[2];
      put_row(M, R, pt, n, d, M->mu_pad, o, -1, -1, M->pad_slot[p], -1, p, true);
    }
  }
  // block 0's corners vs block 1
  if (M->n_obj == 2) {
    for (int c = 0; c < 8; ++c) {
      float pt[3], n[3], d;
      points_obox_ref(corners[0][c], st->op[0], st->op[1], st->oq[1],
                      M->block_half, pt, n, &d);
      put_row(M, R, pt, n, d, M->mu_bb, 0, 1, -1, -1, -1, -1, c == 7);
    }
  }
  // pads vs articulated elements: deepest real box per pad, arm-coupled
  if (M->has_art) {
    for (int k = 0; k < FS_N_ART; ++k) {
      int nb = M->art_nb[k];
      if (nb == 0) continue;
      float bpos[3], bq[4];
      art_pose(M, k, st->aq[k], bpos, bq);
      for (int p = 0; p < FS_N_PADS; ++p) {
        int best = -1;
        float bd = 0.0f, bn[3] = {0, 0, 0}, bp[3] = {0, 0, 0};
        for (int b = 0; b < nb; ++b) {
          int j = k * FS_MAX_ART_BOXES + b;
          float center[3], t[3], pt[3], n[3], d;
          qrot(bq, M->art_box_pos + 3 * j, t);
          for (int e = 0; e < 3; ++e) center[e] = bpos[e] + t[e];
          sphere_obox(pc[p], M->pad_r[p], center, bq, M->art_box_half + 3 * j,
                      pt, n, &d);
          if (FS_KEEP(d > bd)) {
            best = b; bd = d; copy3(pt, bp);
            bn[0] = -n[0]; bn[1] = -n[1]; bn[2] = -n[2];
          }
        }
        put_row(M, R, bp, bn, bd, 0.6f, -1, -1, k, M->pad_slot[p], p, p, true);
      }
    }
  }
  // pads vs world: floor, then the deepest static box; arm-coupled
  for (int p = 0; p < FS_N_PADS; ++p) {
    float r = M->pad_r[p];
    float pt[3] = {pc[p][0] - up[0] * r, pc[p][1] - up[1] * r, pc[p][2] - up[2] * r};
    put_row(M, R, pt, down, r - (pc[p][2] - M->plane_z), 0.6f, -1, -1, -1,
            M->pad_slot[p], p, p, true);
    if (M->n_static > 0) {
      int best = -1;
      float bd = 0.0f, bn[3] = {0, 0, 0}, bp[3] = {0, 0, 0};
      for (int s = 0; s < M->n_static; ++s) {
        float d3[3], q[3], n[3], d;
        sub3(pc[p], M->static_pos + 3 * s, d3);
        sphere_aabox(pc[p], d3, r, M->static_half + 3 * s, q, n, &d);
        if (FS_KEEP(d > bd)) {
          best = s; bd = d; copy3(q, bp);
          bn[0] = -n[0]; bn[1] = -n[1]; bn[2] = -n[2];
        }
      }
      put_row(M, R, bp, bn, bd, 0.6f, -1, -1, -1, M->pad_slot[p], p, p, true);
    }
  }
  (void)zero3;
}

// ---------------------------------------------------------------------------
// warm-started Jacobi impulse solve (lane_solve)
// ---------------------------------------------------------------------------

struct SolveCtx {
  float invI[FS_MAX_OBJ][9];
  float ug[FS_MAX_GRIP][3];
  float padv[FS_N_PADS][3];
  float padJ[FS_N_PADS][FS_MAX_ARM][3];
  float inv_m_grip[FS_MAX_GRIP], inv_D_arm[FS_MAX_ARM];
  float cnt_blk[FS_MAX_OBJ], cnt_art[FS_N_ART], cnt_grip[FS_MAX_GRIP], cnt_arm;
  bool at_low[FS_N_ART], at_high[FS_N_ART];
};

// solver velocities: blocks, articulated elements, gripper drivers, arm
struct Vel {
  float ov[FS_MAX_OBJ][3], ow[FS_MAX_OBJ][3];
  float aqd[FS_N_ART], gqd[FS_MAX_GRIP], adqd[FS_MAX_ARM];
};

FS_DEV void row_u_art(const Model* M, const Row* w, float* u) {
  const float* ax = M->art_axis + 3 * w->k;
  if (M->art_rev[w->k]) {
    float d[3];
    sub3(w->pt, M->art_anchor + 3 * w->k, d);
    cross3(ax, d, u);
  } else {
    copy3(ax, u);
  }
}

FS_DEV float art_mobile(const SolveCtx* C, int k, float j) {
  bool blocked = (C->at_low[k] && j < 0.0f) || (C->at_high[k] && j > 0.0f);
  return blocked ? 0.0f : 1.0f;
}

// effective inverse mass of a row along direction d (k_dir)
FS_DEV float k_dir(const Model* M, const SolveCtx* C, const State* st,
                   const Row* w, const float* d) {
  float k = 0.0f;
  if (w->a >= 0) {
    float r[3], u[3], Iu[3];
    sub3(w->pt, st->op[w->a], r);
    cross3(r, d, u);
    mat33_vec(C->invI[w->a], u, Iu);
    k += (M->inv_m_blk + dot3(u, Iu)) * fmaxf(C->cnt_blk[w->a], 1.0f);
  }
  if (w->b >= 0) {
    float r[3], u[3], Iu[3];
    sub3(w->pt, st->op[w->b], r);
    cross3(r, d, u);
    mat33_vec(C->invI[w->b], u, Iu);
    k += (M->inv_m_blk + dot3(u, Iu)) * fmaxf(C->cnt_blk[w->b], 1.0f);
  }
  if (w->k >= 0) {
    float u[3];
    row_u_art(M, w, u);
    float ja = dot3(u, d);
    float sign = w->a >= 0 ? -1.0f : 1.0f;
    float mob = art_mobile(C, w->k, ja * sign);
    k += ja * ja * M->inv_m_art[w->k] * mob * fmaxf(C->cnt_art[w->k], 1.0f);
  }
  if (w->g >= 0) {
    float jg = dot3(C->ug[w->g], d);
    k += jg * jg * C->inv_m_grip[w->g] * fmaxf(C->cnt_grip[w->g], 1.0f);
  }
  if (w->pj >= 0) {
    float split = fmaxf(C->cnt_arm, 1.0f);
    for (int j = 0; j < M->n_arm; ++j) {
      if (!M->pad_anc[w->pj * FS_MAX_ARM + j]) continue;
      float jd = dot3(C->padJ[w->pj][j], d);
      k += jd * jd * C->inv_D_arm[j] * split;
    }
  }
  return fmaxf(k, 1e-8f);
}

// relative velocity at a row: side A minus side B (rel_vel)
FS_DEV void rel_vel(const Model* M, const SolveCtx* C, const State* st,
                    const Row* w, const Vel* V, float* out) {
  float vB[3] = {0.0f, 0.0f, 0.0f}, t[3], r[3];
  float u[3] = {0.0f, 0.0f, 0.0f};
  if (w->k >= 0) row_u_art(M, w, u);
  if (w->b >= 0) {
    sub3(w->pt, st->op[w->b], r);
    cross3(V->ow[w->b], r, t);
    for (int c = 0; c < 3; ++c) vB[c] += V->ov[w->b][c] + t[c];
  }
  if (w->k >= 0 && w->a >= 0)
    for (int c = 0; c < 3; ++c) vB[c] += u[c] * V->aqd[w->k];
  if (w->g >= 0)
    for (int c = 0; c < 3; ++c) vB[c] += C->ug[w->g][c] * V->gqd[w->g];
  if (w->pj >= 0)
    for (int j = 0; j < M->n_arm; ++j)
      if (M->pad_anc[w->pj * FS_MAX_ARM + j])
        for (int c = 0; c < 3; ++c) vB[c] += C->padJ[w->pj][j][c] * V->adqd[j];
  if (w->vk >= 0)
    for (int c = 0; c < 3; ++c) vB[c] += C->padv[w->vk][c];
  float vA[3] = {0.0f, 0.0f, 0.0f};
  if (w->a >= 0) {
    sub3(w->pt, st->op[w->a], r);
    cross3(V->ow[w->a], r, t);
    for (int c = 0; c < 3; ++c) vA[c] = V->ov[w->a][c] + t[c];
  } else if (w->k >= 0) {
    for (int c = 0; c < 3; ++c) vA[c] = u[c] * V->aqd[w->k];
  }
  for (int c = 0; c < 3; ++c) out[c] = vA[c] - vB[c];
}

// One Jacobi sweep over all rows against the velocities at its start, then
// the impulses applied per bundle (apply_all + gear projection). warm: the
// warm-start pass (re-mask / re-cap the carried λ and apply it).
FS_BIG void sweep(const Model* M, const SolveCtx* C, const State* st,
                  const Rows* R, float* lam, Vel* V, bool warm) {
  float d_ov[FS_MAX_OBJ][3], d_ow[FS_MAX_OBJ][3];
  float d_aqd[FS_N_ART], d_gqd[FS_MAX_GRIP], d_arm[FS_MAX_ARM];
  for (int o = 0; o < FS_MAX_OBJ; ++o)
    for (int c = 0; c < 3; ++c) { d_ov[o][c] = 0.0f; d_ow[o][c] = 0.0f; }
  for (int k = 0; k < FS_N_ART; ++k) d_aqd[k] = 0.0f;
  for (int g = 0; g < FS_MAX_GRIP; ++g) d_gqd[g] = 0.0f;
  for (int j = 0; j < FS_MAX_ARM; ++j) d_arm[j] = 0.0f;
  // per-bundle sums
  float s_imp[3] = {0, 0, 0}, s_ta[3] = {0, 0, 0}, s_tb[3] = {0, 0, 0};
  float s_jrow = 0.0f, s_jg = 0.0f, s_jj[FS_MAX_ARM];
  for (int j = 0; j < FS_MAX_ARM; ++j) s_jj[j] = 0.0f;

  for (int i = 0; i < R->n; ++i) {
    const Row* w = &R->r[i];
    float* l = lam + 3 * i;
    float imp[3];
    if (warm) {
      float ln_w = fmaxf(l[0], 0.0f) * w->af;
      float cap0 = w->mu * ln_w;
      float lt1 = clipf(l[1], -cap0, cap0) * w->af;
      float lt2 = clipf(l[2], -cap0, cap0) * w->af;
      for (int c = 0; c < 3; ++c)
        imp[c] = ln_w * w->n[c] + lt1 * w->t1[c] + lt2 * w->t2[c];
      l[0] = ln_w; l[1] = lt1; l[2] = lt2;
    } else {
      float v[3];
      rel_vel(M, C, st, w, V, v);
      float vn = dot3(v, w->n);
      float dln = (w->vt - vn) / w->kn;
      float new_ln = fmaxf(l[0] + dln, 0.0f) * w->af;
      dln = new_ln - l[0];
      float vt1 = dot3(v, w->t1), vt2 = dot3(v, w->t2);
      float cap = w->mu * new_ln;
      float lt1 = clipf(l[1] + (-vt1) / w->kt1, -cap, cap) * w->af;
      float lt2 = clipf(l[2] + (-vt2) / w->kt2, -cap, cap) * w->af;
      float d1 = lt1 - l[1], d2 = lt2 - l[2];
      for (int c = 0; c < 3; ++c)
        imp[c] = dln * w->n[c] + d1 * w->t1[c] + d2 * w->t2[c];
      l[0] = new_ln; l[1] = lt1; l[2] = lt2;
    }
    for (int c = 0; c < 3; ++c) s_imp[c] += imp[c];
    if (w->a >= 0) {
      float r[3], t[3];
      sub3(w->pt, st->op[w->a], r);
      cross3(r, imp, t);
      for (int c = 0; c < 3; ++c) s_ta[c] += t[c];
    }
    if (w->b >= 0) {
      float r[3], t[3], ni[3] = {-imp[0], -imp[1], -imp[2]};
      sub3(w->pt, st->op[w->b], r);
      cross3(r, ni, t);
      for (int c = 0; c < 3; ++c) s_tb[c] += t[c];
    }
    if (w->k >= 0) {
      float u[3];
      row_u_art(M, w, u);
      float jrow = dot3(u, imp) * (w->a >= 0 ? -1.0f : 1.0f);
      s_jrow += jrow * art_mobile(C, w->k, jrow);
    }
    if (w->g >= 0) s_jg += dot3(C->ug[w->g], imp);
    if (w->pj >= 0)
      for (int j = 0; j < M->n_arm; ++j)
        if (M->pad_anc[w->pj * FS_MAX_ARM + j]) s_jj[j] += dot3(C->padJ[w->pj][j], imp);

    if (w->last) {                      // flush the bundle
      if (w->a >= 0) {
        float t[3];
        mat33_vec(C->invI[w->a], s_ta, t);
        for (int c = 0; c < 3; ++c) {
          d_ov[w->a][c] += s_imp[c] * M->inv_m_blk;
          d_ow[w->a][c] += t[c];
        }
      }
      if (w->b >= 0) {
        float t[3];
        mat33_vec(C->invI[w->b], s_tb, t);
        for (int c = 0; c < 3; ++c) {
          d_ov[w->b][c] -= s_imp[c] * M->inv_m_blk;
          d_ow[w->b][c] += t[c];
        }
      }
      if (w->k >= 0) d_aqd[w->k] += s_jrow * M->inv_m_art[w->k];
      if (w->g >= 0) d_gqd[w->g] += (-s_jg) * C->inv_m_grip[w->g];
      if (w->pj >= 0)
        for (int j = 0; j < M->n_arm; ++j)
          if (M->pad_anc[w->pj * FS_MAX_ARM + j])
            d_arm[j] += (-s_jj[j]) * C->inv_D_arm[j];
      for (int c = 0; c < 3; ++c) { s_imp[c] = 0.0f; s_ta[c] = 0.0f; s_tb[c] = 0.0f; }
      s_jrow = 0.0f; s_jg = 0.0f;
      for (int j = 0; j < FS_MAX_ARM; ++j) s_jj[j] = 0.0f;
    }
  }
  for (int o = 0; o < M->n_obj; ++o)
    for (int c = 0; c < 3; ++c) { V->ov[o][c] += d_ov[o][c]; V->ow[o][c] += d_ow[o][c]; }
  for (int k = 0; k < FS_N_ART; ++k) V->aqd[k] += d_aqd[k];
  for (int g = 0; g < M->n_grip; ++g) V->gqd[g] += d_gqd[g];
  for (int j = 0; j < M->n_arm; ++j) V->adqd[j] += d_arm[j];
  if (M->n_grip == 2) {                 // gear projection
    float w0 = C->inv_m_grip[0], w1 = C->inv_m_grip[1];
    float p = (V->gqd[0] - V->gqd[1]) / (w0 + w1);
    float g0 = V->gqd[0] - p * w0, g1 = V->gqd[1] + p * w1;
    V->gqd[0] = g0; V->gqd[1] = g1;
  }
}

// ---------------------------------------------------------------------------
// one substep (make_lane_substep) and the control interval (make_lane_sim)
// ---------------------------------------------------------------------------

struct Work {
  Rows R;
  AbaWork W;
  Kin K;
  SolveCtx C;
  float lam[FS_MAX_ROWS * 3];
};

FS_BIG void substep(const Model* M, State* st, const float* ctrl, float grip,
                    Work* w) {
  const int n = M->n_dof, na = M->n_arm;
  const float dt = M->dt;
  float qdd[FS_MAX_DOF], D[FS_MAX_DOF], qd_arm[FS_MAX_DOF];

  // ---- ABA + servos
  aba(M, st->q, st->qd, &w->W, qdd, D);
  float amount = M->panda ? grip : grip - 0.2f;
  for (int i = 0; i < n; ++i) {
    float qd_free = st->qd[i] + dt * qdd[i];
    int kind = M->servo_kind[i];
    float target;
    if (kind == 0) target = ctrl[(int)M->servo_a[i]];
    else if (kind == 1) target = M->servo_a[i] * amount + M->servo_b[i];
    else if (kind == 2) target = st->q[(int)M->servo_a[i]];
    else target = 0.0f;
    float f = M->servo_f[i];
    float v_star = 0.1f * (target - st->q[i]) / dt;
    float imp = clipf(D[i] * (v_star - qd_free), -f * dt, f * dt);
    qd_arm[i] = qd_free + imp / fmaxf(D[i], 1e-9f);
  }

  // ---- scene free update
  Vel V;
  for (int o = 0; o < M->n_obj; ++o) {
    V.ov[o][0] = st->ov[o][0] + dt * 0.0f;
    V.ov[o][1] = st->ov[o][1] + dt * 0.0f;
    V.ov[o][2] = st->ov[o][2] + dt * -9.8f;
    copy3(st->ow[o], V.ow[o]);
  }
  for (int k = 0; k < FS_N_ART; ++k) {
    float aqd = (st->aqd[k] + dt * M->art_g[k]) * M->art_damp[k];
    float v_star = 0.1f * (M->art_motor_target[k] - st->aq[k]) / dt;
    float mf = M->art_motor_force[k], m = M->art_m[k];
    float imp = clipf(m * (v_star - aqd), -mf * dt, mf * dt);
    V.aqd[k] = aqd + M->art_motor[k] * imp / m;
  }

  // ---- contacts on the post-servo kinematics
  Kin* K = &w->K;
  float pc[FS_N_PADS][3], pv[FS_N_PADS][3];
  fk(M, st->q, qd_arm, K);
  pad_kin(M, K, pc, pv);
  gather_rows(M, st, pc, &w->R);

  SolveCtx* C = &w->C;
  for (int o = 0; o < M->n_obj; ++o) {
    float R[9];
    quat_to_mat33(st->oq[o], R);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        C->invI[o][r * 3 + c] = R[r * 3 + 0] * M->block_inv_I[0] * R[c * 3 + 0]
                              + R[r * 3 + 1] * M->block_inv_I[1] * R[c * 3 + 1]
                              + R[r * 3 + 2] * M->block_inv_I[2] * R[c * 3 + 2];
  }
  for (int g = 0; g < M->n_grip; ++g) {
    int d = M->grip_dof[g];
    qrot(K->quat[d], M->axis + 3 * d, C->ug[g]);
    C->inv_m_grip[g] = 1.0f / fmaxf(D[d], 1e-4f);
    V.gqd[g] = qd_arm[d];
  }
  for (int p = 0; p < FS_N_PADS; ++p) {
    const float* u = C->ug[M->pad_slot[p]];
    float v = qd_arm[M->pad_parent[p]];
    for (int c = 0; c < 3; ++c) C->padv[p][c] = pv[p][c] - u[c] * v;
    for (int j = 0; j < na; ++j) {
      if (!M->pad_anc[p * FS_MAX_ARM + j]) continue;
      float aw[3];
      qrot(K->quat[j], M->axis + 3 * j, aw);
      if (M->revolute[j]) {
        float d[3];
        sub3(pc[p], K->pos[j], d);
        cross3(aw, d, C->padJ[p][j]);
      } else {
        copy3(aw, C->padJ[p][j]);
      }
    }
  }
  for (int j = 0; j < na; ++j) {
    C->inv_D_arm[j] = 1.0f / fmaxf(D[j], 1e-4f);
    V.adqd[j] = 0.0f;
  }
  for (int k = 0; k < FS_N_ART; ++k) {
    C->at_low[k] = st->aq[k] <= (float)((double)M->art_lower[k] + 1e-4);
    C->at_high[k] = st->aq[k] >= (float)((double)M->art_upper[k] - 1e-4);
    C->cnt_art[k] = 0.0f;
  }
  for (int o = 0; o < FS_MAX_OBJ; ++o) C->cnt_blk[o] = 0.0f;
  for (int g = 0; g < FS_MAX_GRIP; ++g) C->cnt_grip[g] = 0.0f;
  C->cnt_arm = 0.0f;
  for (int i = 0; i < w->R.n; ++i) {     // mass-splitting counts
    const Row* r = &w->R.r[i];
    if (r->a >= 0) C->cnt_blk[r->a] += r->af;
    if (r->b >= 0) C->cnt_blk[r->b] += r->af;
    if (r->k >= 0) C->cnt_art[r->k] += r->af;
    if (r->g >= 0) C->cnt_grip[r->g] += r->af;
    if (r->pj >= 0) C->cnt_arm += r->af;
  }
  for (int i = 0; i < w->R.n; ++i) {
    Row* r = &w->R.r[i];
    r->kn = k_dir(M, C, st, r, r->n);
    r->kt1 = k_dir(M, C, st, r, r->t1);
    r->kt2 = k_dir(M, C, st, r, r->t2);
  }
  sweep(M, C, st, &w->R, w->lam, &V, true);
  for (int it = 0; it < M->solve_iters; ++it)
    sweep(M, C, st, &w->R, w->lam, &V, false);

  // ---- write back solved velocities, integrate
  for (int i = 0; i < n; ++i) {
    float v = qd_arm[i];
    int slot = -1;
    for (int g = 0; g < M->n_grip; ++g) if (M->grip_dof[g] == i) slot = g;
    if (slot >= 0) v = V.gqd[slot];
    else if (i < na) v = qd_arm[i] + V.adqd[i];
    float qn = st->q[i] + dt * v;
    float lo = M->lower[i], hi = M->upper[i];
    st->q[i] = clipf(qn, lo, hi);
    st->qd[i] = qn < lo ? fmaxf(v, 0.0f) : (qn > hi ? fminf(v, 0.0f) : v);
  }
  for (int o = 0; o < M->n_obj; ++o) {
    const float* w_ = V.ow[o];
    for (int c = 0; c < 3; ++c) {
      st->ov[o][c] = V.ov[o][c];
      st->ow[o][c] = w_[c];
      st->op[o][c] = st->op[o][c] + dt * V.ov[o][c];
    }
    // exponential-map quaternion update (spatial.quat_integrate)
    float angle = sqrtf(dot3(w_, w_) + 1e-12f);
    float m = fmaxf(angle, 1e-9f);
    float half = angle * M->half_dt;
    float s = sinf(half);
    float dq[4] = {w_[0] / m * s, w_[1] / m * s, w_[2] / m * s, cosf(half)};
    float nq[4];
    qmul(dq, st->oq[o], nq);
    qnormalize(nq);
    copy4(nq, st->oq[o]);
  }
  for (int k = 0; k < FS_N_ART; ++k) {
    float a = st->aq[k] + dt * V.aqd[k];
    float c = clipf(a, M->art_lower[k], M->art_upper[k]);
    st->aqd[k] = a != c ? 0.0f : V.aqd[k];
    st->aq[k] = c;
  }
}

FS_DEV void run_sim(const Model* M, State* st, const float* ctrl, float grip,
                    Work* w) {
  for (int i = 0; i < FS_MAX_ROWS * 3; ++i) w->lam[i] = 0.0f;
  for (int s = 0; s < M->n_sub; ++s) substep(M, st, ctrl, grip, w);
}

// ---------------------------------------------------------------------------
// control: action decode + DLS IK (make_lane_control / lane_ik_dls)
// ---------------------------------------------------------------------------

FS_DEV void quat_from_euler(const float* rpy, float* o) {
  float r = rpy[0] * 0.5f, p = rpy[1] * 0.5f, y = rpy[2] * 0.5f;
  float cr = cosf(r), sr = sinf(r), cp = cosf(p), sp = sinf(p);
  float cy = cosf(y), sy = sinf(y);
  o[0] = sr * cp * cy - cr * sp * sy;
  o[1] = cr * sp * cy + sr * cp * sy;
  o[2] = cr * cp * sy - sr * sp * cy;
  o[3] = cr * cp * cy + sr * sp * sy;
}

FS_DEV void quat_to_euler(const float* q, float* o) {
  float x = q[0], y = q[1], z = q[2], w = q[3];
  o[0] = atan2f(2.0f * (w * x + y * z), 1.0f - 2.0f * (x * x + y * y));
  o[1] = asinf(clipf(2.0f * (w * y - z * x), (float)(-1.0 + 1e-7),
                     (float)(1.0 - 1e-7)));
  o[2] = atan2f(2.0f * (w * z + x * y), 1.0f - 2.0f * (y * y + z * z));
}

// Cholesky solve of the SPD 6x6 A for two right-hand sides (_chol6_solve)
FS_DEV void chol6_solve2(const float* A, const float* b0, const float* b1,
                         float* x0, float* x1) {
  float L[36];
  for (int i = 0; i < 36; ++i) L[i] = 0.0f;
  for (int j = 0; j < 6; ++j) {
    float acc = A[j * 6 + j];
    for (int k = 0; k < j; ++k) acc = acc - L[j * 6 + k] * L[j * 6 + k];
    float Ljj = sqrtf(fmaxf(acc, 1e-12f));
    L[j * 6 + j] = Ljj;
    float inv = 1.0f / Ljj;
    for (int i = j + 1; i < 6; ++i) {
      float a = A[i * 6 + j];
      for (int k = 0; k < j; ++k) a = a - L[i * 6 + k] * L[j * 6 + k];
      L[i * 6 + j] = a * inv;
    }
  }
  for (int rhs = 0; rhs < 2; ++rhs) {
    const float* b = rhs ? b1 : b0;
    float* x = rhs ? x1 : x0;
    float y[6];
    for (int i = 0; i < 6; ++i) {
      float acc = b[i];
      for (int k = 0; k < i; ++k) acc = acc - L[i * 6 + k] * y[k];
      y[i] = acc / L[i * 6 + i];
    }
    for (int i = 5; i >= 0; --i) {
      float acc = y[i];
      for (int k = i + 1; k < 6; ++k) acc = acc - L[k * 6 + i] * x[k];
      x[i] = acc / L[i * 6 + i];
    }
  }
}

// damped least squares toward (tp, tq) with a rest-pose null space; only
// the first n_arm dofs move. q is updated in place.
FS_BIG void ik_dls(const Model* M, float* q, const float* tp, const float* tq,
                   Kin* K) {
  const int n = M->n_dof, na = M->n_arm;
  for (int it = 0; it < M->ik_iters; ++it) {
    float xp[3], xq[4];
    fk(M, q, nullptr, K);
    site_pose(M, K, xp, xq);
    float cq[4] = {-xq[0], -xq[1], -xq[2], xq[3]}, dq4[4];
    qmul(tq, cq, dq4);
    float sgn = signf(dq4[3] + 1e-12f);
    float err[6] = {tp[0] - xp[0], tp[1] - xp[1], tp[2] - xp[2],
                    2.0f * dq4[0] * sgn, 2.0f * dq4[1] * sgn, 2.0f * dq4[2] * sgn};
    float cols[FS_MAX_ARM][6];
    for (int i = 0; i < na; ++i) {
      if (!M->ee_anc[i]) continue;
      float aw[3];
      qrot(K->quat[i], M->axis + 3 * i, aw);
      if (M->revolute[i]) {
        float d[3], lin[3];
        sub3(xp, K->pos[i], d);
        cross3(aw, d, lin);
        for (int c = 0; c < 3; ++c) { cols[i][c] = lin[c]; cols[i][c + 3] = aw[c]; }
      } else {
        for (int c = 0; c < 3; ++c) { cols[i][c] = aw[c]; cols[i][c + 3] = 0.0f; }
      }
    }
    float A[36];
    for (int r = 0; r < 6; ++r)
      for (int c = r; c < 6; ++c) {
        float acc = r == c ? M->ik_damp2 : 0.0f;
        for (int i = 0; i < na; ++i)
          if (M->ee_anc[i]) acc += cols[i][r] * cols[i][c];
        A[r * 6 + c] = acc;
        A[c * 6 + r] = acc;
      }
    float dq_null[FS_MAX_ARM], Jdn[6];
    for (int i = 0; i < na; ++i) dq_null[i] = 0.05f * (M->rest[i] - q[i]);
    for (int r = 0; r < 6; ++r) {
      float acc = 0.0f;
      for (int i = 0; i < na; ++i)
        if (M->ee_anc[i]) acc += cols[i][r] * dq_null[i];
      Jdn[r] = acc;
    }
    float w_err[6], w_null[6];
    chol6_solve2(A, err, Jdn, w_err, w_null);
    for (int i = 0; i < na; ++i) {
      float d = dq_null[i];
      if (M->ee_anc[i]) {
        float je = 0.0f, jn = 0.0f;
        for (int r = 0; r < 6; ++r) { je += cols[i][r] * w_err[r]; jn += cols[i][r] * w_null[r]; }
        d = (je + dq_null[i]) - jn;
      }
      q[i] = clipf(q[i] + clipf(d, -0.5f, 0.5f), M->lower[i], M->upper[i]);
    }
    for (int i = na; i < n; ++i) q[i] = clipf(q[i] + 0.0f, M->lower[i], M->upper[i]);
  }
}

// action (A) + q → servo targets (n_arm) and the gripper command
FS_BIG void control(const Model* M, const float* q, const float* action_in,
                    Kin* K, float* targets, float* grip) {
  const int na = M->n_arm, A = M->action_dim, at = M->action_type;
  float a[FS_MAX_ACT];
  for (int i = 0; i < A; ++i) a[i] = clipf(action_in[i], -M->action_high[i], M->action_high[i]);
  *grip = a[A - 1];
  float ee[3], eq[4];
  fk(M, q, nullptr, K);
  site_pose(M, K, ee, eq);
  if (at == FS_REL_JOINTS) {
    for (int j = 0; j < na; ++j) targets[j] = q[j] + a[j];
  } else if (at == FS_ABS_JOINTS) {
    for (int j = 0; j < na; ++j) targets[j] = a[j];
  } else {
    float pos[3], quat[4] = {0.0f, 0.0f, 0.0f, 1.0f};
    bool rel = at == FS_REL_QUAT || at == FS_REL_RPY || at == FS_REL_CART;
    for (int c = 0; c < 3; ++c) pos[c] = rel ? a[c] + ee[c] : a[c];
    if (at == FS_ABS_QUAT) {
      if (M->use_orientation) { copy4(a + 3, quat); qnormalize(quat); }
    } else if (at == FS_REL_QUAT) {
      // the reference adds quaternions componentwise
      for (int c = 0; c < 4; ++c) quat[c] = a[3 + c] + eq[c];
      qnormalize(quat);
    } else if (at == FS_ABS_RPY) {
      quat_from_euler(a + 3, quat);
    } else if (at == FS_REL_RPY || M->use_orientation) {
      float rpy[3];
      quat_to_euler(eq, rpy);
      for (int c = 0; c < 3; ++c) rpy[c] = rpy[c] + a[3 + c];
      quat_from_euler(rpy, quat);
    }
    float qs[FS_MAX_DOF];
    for (int i = 0; i < M->n_dof; ++i) qs[i] = q[i];
    ik_dls(M, qs, pos, quat, K);
    for (int j = 0; j < na; ++j) targets[j] = qs[j];
  }
  for (int j = 0; j < na; ++j) {
    float t = clipf(targets[j], M->ctrl_lower[j], M->ctrl_upper[j]);
    float inc = M->rate_limit[j];
    targets[j] = clipf(t, q[j] - inc, q[j] + inc);
  }
}

// achieved goal of one env (make_pallas_rollout's ag_of)
FS_DEV void write_ag(const Model* M, const State* st, Kin* K, float* ags,
                     long h, long b, long B) {
  long base = h * M->ag_dim;
  int r = 0;
  float ee[3], eq[4];
  if (M->n_obj == 0 && !M->play) {
    fk(M, st->q, nullptr, K);
    site_pose(M, K, ee, eq);
    for (int c = 0; c < 3; ++c) ags[(base + r++) * B + b] = ee[c];
    return;
  }
  for (int o = 0; o < M->n_obj; ++o) {
    for (int c = 0; c < 3; ++c) ags[(base + r++) * B + b] = st->op[o][c];
    if (M->play || M->use_orientation)
      for (int c = 0; c < 4; ++c) ags[(base + r++) * B + b] = st->oq[o][c];
  }
  if (M->play) {
    for (int k = 0; k < 3; ++k) ags[(base + r++) * B + b] = st->aq[k];
    // dial_to_0_1_range, precedence bug included: ((x % 2)·π)/(2.2·π)
    ags[(base + r++) * B + b] = floor_mod2(st->aq[3]) * M->dial_mul / M->dial_div;
  }
  if (M->with_ee) {
    fk(M, st->q, nullptr, K);
    site_pose(M, K, ee, eq);
    for (int c = 0; c < 3; ++c) ags[(base + r++) * B + b] = ee[c];
  }
}

// ---------------------------------------------------------------------------
// per-env bodies of the three kernels
// ---------------------------------------------------------------------------

FS_DEV void env_sim(const Model* M, const float* X, const float* ctrl,
                    const float* grip, float* Y, long b, long B, Work* w) {
  State st;
  float c[FS_MAX_ARM];
  load_state(M, X, b, B, &st);
  for (int j = 0; j < M->n_arm; ++j) c[j] = ctrl[j * B + b];
  run_sim(M, &st, c, grip[b], w);
  store_state(M, &st, b, B, Y);
}

FS_DEV void env_control_sim(const Model* M, State* st, const float* act, long b,
                            long B, Work* w) {
  float a[FS_MAX_ACT], c[FS_MAX_ARM], g;
  for (int i = 0; i < M->action_dim; ++i) a[i] = act[i * B + b];
  control(M, st->q, a, &w->K, c, &g);
  run_sim(M, st, c, g, w);
}

FS_DEV void env_step(const Model* M, const float* X, const float* act, float* Y,
                     long b, long B, Work* w) {
  State st;
  load_state(M, X, b, B, &st);
  env_control_sim(M, &st, act, b, B, w);
  store_state(M, &st, b, B, Y);
}

FS_DEV void env_rollout(const Model* M, const float* X, const float* act,
                        float* Y, float* ags, int H, long b, long B, Work* w) {
  State st;
  load_state(M, X, b, B, &st);
  for (int h = 0; h < H; ++h) {
    env_control_sim(M, &st, act + (long)h * M->action_dim * B, b, B, w);
    write_ag(M, &st, &w->K, ags, h, b, B);
  }
  store_state(M, &st, b, B, Y);
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

#define FS_THREADS 128

__global__ void __launch_bounds__(FS_THREADS)
fs_sim_kernel(const Model* __restrict__ M, const float* __restrict__ X,
              const float* __restrict__ ctrl, const float* __restrict__ grip,
              float* __restrict__ Y, int B) {
  long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Work w;
  env_sim(M, X, ctrl, grip, Y, b, B, &w);
}

__global__ void __launch_bounds__(FS_THREADS)
fs_step_kernel(const Model* __restrict__ M, const float* __restrict__ X,
               const float* __restrict__ act, float* __restrict__ Y, int B) {
  long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Work w;
  env_step(M, X, act, Y, b, B, &w);
}

__global__ void __launch_bounds__(FS_THREADS)
fs_rollout_kernel(const Model* __restrict__ M, const float* __restrict__ X,
                  const float* __restrict__ act, float* __restrict__ Y,
                  float* __restrict__ ags, int H, int B) {
  long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Work w;
  env_rollout(M, X, act, Y, ags, H, b, B, &w);
}

static unsigned fs_blocks(int B) { return (unsigned)((B + FS_THREADS - 1) / FS_THREADS); }

// Each launcher enqueues on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 = launched); an empty batch is refused.
extern "C" int fs_sim(const void* M, const void* X, const void* ctrl,
                      const void* grip, void* Y, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  fs_sim_kernel<<<fs_blocks(B), FS_THREADS, 0, (cudaStream_t)stream>>>(
      (const Model*)M, (const float*)X, (const float*)ctrl, (const float*)grip,
      (float*)Y, B);
  return (int)cudaGetLastError();
}

extern "C" int fs_step(const void* M, const void* X, const void* act, void* Y,
                       int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  fs_step_kernel<<<fs_blocks(B), FS_THREADS, 0, (cudaStream_t)stream>>>(
      (const Model*)M, (const float*)X, (const float*)act, (float*)Y, B);
  return (int)cudaGetLastError();
}

extern "C" int fs_rollout(const void* M, const void* X, const void* act, void* Y,
                          void* ags, int H, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  fs_rollout_kernel<<<fs_blocks(B), FS_THREADS, 0, (cudaStream_t)stream>>>(
      (const Model*)M, (const float*)X, (const float*)act, (float*)Y,
      (float*)ags, H, B);
  return (int)cudaGetLastError();
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
