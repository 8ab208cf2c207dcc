// Batched analytic ray-cast renderer for Hopper.
//
// Replaces the TPU kernel latent_diffusion_planning_tpu/ops/pallas/
// raycast.py (render_pallas / render_batch_pallas -> _render_kernel). Per
// pixel: ground-plane hit with checker tint, then per prim a body-frame ray
// test (box slab with the entering axis as normal, sphere quadric, or the
// generalized slab over k-DOP half-spaces for the first n_convex prims),
// nearest hit, Lambert shading from the light rig plus ambient, sky
// gradient for misses, clip * 255.
//
// What bounds it on H100: by bytes it is the write of the image (N x H x W
// x 3 fp32, 50 MB at 1024 envs of 64x64), but a kernel that spends a few
// hundred instructions a pixel is held by instruction issue long before
// that, so the design removes instructions and waits:
//
//  - Everything that is constant per (env, prim) is computed once, by one
//    thread, in the block's prologue and kept in shared memory as a record
//    of kRec floats: the camera origin in the body frame folded into the
//    slab bounds (-half - ob, half - ob), the sphere's o - c, |o - c|^2 -
//    r^2 and 1/r, and for a k-DOP half-space (n, off - n.ob). The camera
//    origin is one per launch, so none of this depends on the pixel. Per
//    pixel there remain db = R^T d, the slab or quadric test and a compare.
//  - A thread renders kPix = 4 consecutive pixels: it reads their rays as
//    three float4 (the rays are (H*W, 3) floats, so 4 pixels are 48
//    contiguous, 16-byte-aligned bytes) and writes their colours as three
//    float4. Every record read from shared memory (a broadcast, as float4)
//    serves four pixels.
//  - A block keeps its rays in registers and walks over E envs, so the rays
//    are read once, and there is one prologue and one barrier per block,
//    not one per 256 pixels: the prologue fills the records of all E envs
//    at once, then the pixel loop runs with no further barrier. (Measured:
//    2 to 4 envs a block are best at 1024 envs; more leaves too few blocks
//    to balance the SMs.)
//  - The normal of a hit is computed only where the hit is nearer than the
//    best so far (a branch that whole warps skip for the small prims of
//    these scenes), and the winning colour is looked up once at the end.
//  - A box is first held against its bounding sphere (radius inflated by 1%,
//    so rounding can never reject a ray the slab test would accept): 6
//    instructions a pixel decide whether the 45 of the slab test run at all.
//    A warp covers two image rows, and the prims of these scenes cover few
//    rows, so most warps skip most boxes. The result does not change.
//  - Stores: a thread's 4 pixels are 48 contiguous bytes, written as three
//    float4, so a warp's three store instructions together fill every
//    32-byte sector of 1536 contiguous bytes. (Passing a warp's 384 floats
//    through shared memory so that each instruction alone writes 512
//    contiguous bytes was measured, tools/probe_raycast_kernel.py
//    "stagedstore": faster with the prim loop patched out, no faster with
//    it in, so it is not done.)
//  - No IEEE division per pixel per env: the plane's 1/dz is computed once
//    per thread, the checker's x / 0.2 is x * 5, its mod 2 is s - 2
//    floor(s / 2) (exact for the integer s). The slab reciprocals stay
//    correctly rounded (__frcp_rn) and the file is built without
//    --use_fast_math, so hit and miss at a silhouette do not move.
//
// The scene's own tensors are read in place (no packing pass before the
// launch): each field comes with its env stride in elements, which is 0 for
// a field broadcast over envs; within an env a field is dense.
//
// Layouts: pos (N, P, 3), rot (N, P, 3, 3) world-from-body row-major, size
// (N, P, 3), color (N, P, 3), kind (N, P) int32 (0 box, else sphere),
// planes (N, P, K, 4) rows (nx, ny, nz, d), inside iff n.x <= d in the body
// frame; plane_z (N,), plane_color (N, 3); dirs (H*W, 3); light (3 x 4) =
// normalized dir(3), color(1); out (N, H*W, 3).
#include "common.cuh"

namespace {

constexpr float kBig = 1e9f;
constexpr int kThreads = 256;
constexpr int kPix = 4;      // consecutive pixels a thread renders
constexpr int kRec = 28;     // floats per (env, prim) record, see fill_record
constexpr int kMinBlocks = 3;   // resident blocks an SM: at most 85 registers
constexpr int kEnvRec = 4;   // per env: plane_z - oz, plane r, g, b

struct RaycastArgs {
  const float* pos;
  const float* rot;
  const float* size;
  const float* color;
  const int* kind;
  const float* planes;
  const float* plane_z;
  const float* plane_color;
  const float* dirs;
  const float* light;
  long long s_pos, s_rot, s_size, s_color, s_kind, s_planes, s_plane_z,
      s_plane_color;      // env strides in elements (0: shared by all envs)
  float ox, oy, oz, ambient;
  float* out;
  int N, HW, P, K, n_convex, E;
};

// Record of one prim of one env (float index):
//   0..8   R, world-from-body, row-major
//   9..11  lo = -half - ob      with ob = R^T (o - c)
//  12..14  hi =  half - ob
//  15..17  oc = o - c
//  18      |oc|^2 - r^2         r = size[0]
//  19      1 / max(r, 1e-9)
//  20      kind (0 box, else sphere)
//  21..23  colour
//  24      |oc|^2 - (1.01 |half|)^2: the box's bounding sphere
//  25..27  unused
__device__ void fill_record(const RaycastArgs& a, int env, int p, float* rec) {
  const float* c = a.pos + env * a.s_pos + p * 3;
  const float* R = a.rot + env * a.s_rot + p * 9;
  const float* s = a.size + env * a.s_size + p * 3;
  const float* col = a.color + env * a.s_color + p * 3;
  const float relx = a.ox - c[0], rely = a.oy - c[1], relz = a.oz - c[2];
  float ob[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    ob[j] = R[j] * relx + R[3 + j] * rely + R[6 + j] * relz;
#pragma unroll
  for (int i = 0; i < 9; ++i) rec[i] = R[i];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    rec[9 + j] = -s[j] - ob[j];
    rec[12 + j] = s[j] - ob[j];
    rec[21 + j] = col[j];
  }
  rec[15] = relx;
  rec[16] = rely;
  rec[17] = relz;
  rec[18] = (relx * relx + rely * rely + relz * relz) - s[0] * s[0];
  rec[19] = 1.f / fmaxf(s[0], 1e-9f);
  rec[20] = static_cast<float>(a.kind[env * a.s_kind + p]);
  rec[24] = (relx * relx + rely * rely + relz * relz) -
            1.0201f * (s[0] * s[0] + s[1] * s[1] + s[2] * s[2]);
  rec[25] = rec[26] = rec[27] = 0.f;
}

__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) < 1e-9f ? (d >= 0.f ? 1e-9f : -1e-9f) : d;
}

// kVec: float4 loads of the rays and stores of the image (H*W a multiple of
// 4); else scalar ones, for any image size.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
raycast_kernel(RaycastArgs a) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const int P = a.P, K = a.K, E = a.E, nc = a.n_convex;
  float* recs = sh;                            // E x P x kRec
  float* hs = recs + E * P * kRec;             // E x nc x K x 4
  float* envs = hs + E * nc * K * 4;           // E x kEnvRec
  float* lights = envs + E * kEnvRec;          // 12
  const int env0 = blockIdx.y * E;
  const int n_env = min(E, a.N - env0);

  // ---- prologue: the constants of every (env, prim) this block renders
  for (int i = threadIdx.x; i < n_env * P; i += kThreads)
    fill_record(a, env0 + i / P, i % P, recs + i * kRec);
  for (int i = threadIdx.x; i < n_env * nc * K; i += kThreads) {
    const int k = i % K, p = (i / K) % nc, e = i / (K * nc);
    const int env = env0 + e;
    const float* c = a.pos + env * a.s_pos + p * 3;
    const float* R = a.rot + env * a.s_rot + p * 9;
    const float* h = a.planes + env * a.s_planes + (p * K + k) * 4;
    const float relx = a.ox - c[0], rely = a.oy - c[1], relz = a.oz - c[2];
    const float ob0 = R[0] * relx + R[3] * rely + R[6] * relz;
    const float ob1 = R[1] * relx + R[4] * rely + R[7] * relz;
    const float ob2 = R[2] * relx + R[5] * rely + R[8] * relz;
    const float ndoto = h[0] * ob0 + h[1] * ob1 + h[2] * ob2;
    float* o = hs + ((e * nc + p) * K + k) * 4;
    o[0] = h[0];
    o[1] = h[1];
    o[2] = h[2];
    o[3] = h[3] - ndoto;        // < 0 iff the origin is outside this plane
  }
  for (int e = threadIdx.x; e < n_env; e += kThreads) {
    const int env = env0 + e;
    envs[e * kEnvRec] = a.plane_z[env * a.s_plane_z] - a.oz;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      envs[e * kEnvRec + 1 + j] = a.plane_color[env * a.s_plane_color + j];
  }
  if (threadIdx.x < 12) lights[threadIdx.x] = a.light[threadIdx.x];
  __syncthreads();

  // ---- this thread's kPix rays, kept in registers across the envs
  const int pix0 = (blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (pix0 >= a.HW) return;
  float d[kPix][3];
  if (kVec) {
    const float4* src = reinterpret_cast<const float4*>(a.dirs + 3 * pix0);
    const float4 v0 = src[0], v1 = src[1], v2 = src[2];
    const float f[12] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                         v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
#pragma unroll
    for (int j = 0; j < kPix; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c) d[j][c] = f[3 * j + c];
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int pix = min(pix0 + j, a.HW - 1);
#pragma unroll
      for (int c = 0; c < 3; ++c) d[j][c] = a.dirs[3 * pix + c];
    }
  }
  float inv_dz[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j)
    inv_dz[j] = __frcp_rn(fabsf(d[j][2]) < 1e-9f ? -1e-9f : d[j][2]);

  for (int e = 0; e < n_env; ++e) {
    const float4 ev = *reinterpret_cast<const float4*>(envs + e * kEnvRec);
    float best_t[kPix], bn[kPix][3];
    int best_p[kPix];
    // implicit ground plane as the initial nearest hit
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const float t = ev.x * inv_dz[j];
      best_t[j] = t > 1e-4f ? t : kBig;
      bn[j][0] = 0.f;
      bn[j][1] = 0.f;
      bn[j][2] = 1.f;
      best_p[j] = -1;
    }

    for (int p = 0; p < P; ++p) {
      const float4* r4 =
          reinterpret_cast<const float4*>(recs + (e * P + p) * kRec);
      const float4 q0 = r4[0], q1 = r4[1], q2 = r4[2];
      const float R[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
      if (p < nc) {
        const float4* h4 =
            reinterpret_cast<const float4*>(hs + (e * nc + p) * K * 4);
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const float db0 = R[0] * d[j][0] + R[3] * d[j][1] + R[6] * d[j][2];
          const float db1 = R[1] * d[j][0] + R[4] * d[j][1] + R[7] * d[j][2];
          const float db2 = R[2] * d[j][0] + R[5] * d[j][1] + R[8] * d[j][2];
          float t_near = -kBig, t_far = kBig;
          float m0 = 0.f, m1 = 0.f, m2 = 0.f;
          for (int k = 0; k < K; ++k) {
            const float4 h = h4[k];
            const float ndotd = h.x * db0 + h.y * db1 + h.z * db2;
            const bool para = fabsf(ndotd) < 1e-9f;
            const float t_k = __fdiv_rn(h.w, para ? 1e-9f : ndotd);
            const bool entering = (ndotd < 0.f) && !para;
            if (entering && t_k > t_near) {
              m0 = h.x; m1 = h.y; m2 = h.z;
              t_near = t_k;
            }
            if (!entering && !para) t_far = fminf(t_far, t_k);
            if (para && h.w < 0.f) t_near = kBig;
          }
          const bool hit = (t_near <= t_far) && (t_far > 1e-4f);
          float t_p = t_near > 1e-4f ? t_near : t_far;
          t_p = hit ? t_p : kBig;
          if (t_p < best_t[j]) {
            best_t[j] = t_p;
            best_p[j] = p;
            bn[j][0] = R[0] * m0 + R[1] * m1 + R[2] * m2;
            bn[j][1] = R[3] * m0 + R[4] * m1 + R[5] * m2;
            bn[j][2] = R[6] * m0 + R[7] * m1 + R[8] * m2;
          }
        }
        continue;
      }
      const float4 q3 = r4[3], q4 = r4[4];
      if (r4[5].x < 0.5f) {      // kind 0: box slab test
        // bounding sphere first: can any of the four rays reach the box?
        const float c_bound = r4[6].x;
        bool maybe = false;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const float b = q3.w * d[j][0] + q4.x * d[j][1] + q4.y * d[j][2];
          maybe |= (b * b - c_bound >= 0.f) && !(b > 0.f && c_bound > 0.f);
        }
        if (!maybe) continue;
        const float lo[3] = {q2.y, q2.z, q2.w};
        const float hi[3] = {q3.x, q3.y, q3.z};
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          float db[3];
#pragma unroll
          for (int c = 0; c < 3; ++c)
            db[c] = R[c] * d[j][0] + R[3 + c] * d[j][1] + R[6 + c] * d[j][2];
          float t_near = -kBig, t_far = kBig;
          int near_ax = 0;
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const float inv = __frcp_rn(safe_dir(db[ax]));
            const float t1 = lo[ax] * inv, t2 = hi[ax] * inv;
            const float tmin = fminf(t1, t2), tmax = fmaxf(t1, t2);
            if (tmin > t_near) near_ax = ax;
            t_near = fmaxf(t_near, tmin);
            t_far = fminf(t_far, tmax);
          }
          const bool hit = (t_near <= t_far) && (t_far > 1e-4f);
          float t_p = t_near > 1e-4f ? t_near : t_far;
          t_p = hit ? t_p : kBig;
          if (t_p < best_t[j]) {
            best_t[j] = t_p;
            best_p[j] = p;
            const float dn = near_ax == 0 ? db[0] : (near_ax == 1 ? db[1] : db[2]);
            const float sgn = dn > 0.f ? -1.f : (dn < 0.f ? 1.f : 0.f);
            // n = R nb with nb = -sign(db[ax]) e_ax: a column of R
            bn[j][0] = sgn * (near_ax == 0 ? R[0] : (near_ax == 1 ? R[1] : R[2]));
            bn[j][1] = sgn * (near_ax == 0 ? R[3] : (near_ax == 1 ? R[4] : R[5]));
            bn[j][2] = sgn * (near_ax == 0 ? R[6] : (near_ax == 1 ? R[7] : R[8]));
          }
        }
      } else {                   // sphere of radius size[0]
        const float oc[3] = {q3.w, q4.x, q4.y};
        const float c_term = q4.z;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const float b_half =
              oc[0] * d[j][0] + oc[1] * d[j][1] + oc[2] * d[j][2];
          const float disc = b_half * b_half - c_term;
          const float sq = __fsqrt_rn(fmaxf(disc, 0.f));
          const float t0 = -b_half - sq, t1 = -b_half + sq;
          float t_p = t0 > 1e-4f ? t0 : t1;
          t_p = (disc > 0.f && t_p > 1e-4f) ? t_p : kBig;
          if (t_p < best_t[j]) {
            best_t[j] = t_p;
            best_p[j] = p;
#pragma unroll
            for (int c = 0; c < 3; ++c)
              bn[j][c] = (oc[c] + d[j][c] * t_p) * q4.w;
          }
        }
      }
    }

    // ---- shade and write kPix pixels
    float rgb[kPix * 3];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      float diffuse = 0.f;
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const float* L = lights + 4 * l;
        diffuse += fmaxf(-(bn[j][0] * L[0] + bn[j][1] * L[1] + bn[j][2] * L[2]),
                         0.f) * L[3];
      }
      const float shade = a.ambient + diffuse;
      const bool hit = best_t[j] < kBig * 0.5f;
      float cr, cg, cb;
      if (best_p[j] < 0) {
        // the ground plane won: best_t is its hit; checker tint from the
        // hit point, (floor(x / 0.2) + floor(y / 0.2)) mod 2
        const float px = a.ox + d[j][0] * best_t[j];
        const float py = a.oy + d[j][1] * best_t[j];
        const float s = floorf(px * 5.f) + floorf(py * 5.f);
        const float tint = 0.85f + 0.15f * (s - 2.f * floorf(s * 0.5f));
        cr = ev.y * tint;
        cg = ev.z * tint;
        cb = ev.w * tint;
      } else {
        const float* col = recs + (e * P + best_p[j]) * kRec + 21;
        cr = col[0];
        cg = col[1];
        cb = col[2];
      }
      const float sky = 0.6f + 0.4f * fminf(fmaxf(d[j][2], 0.f), 1.f);
      const float r = hit ? cr * shade : 0.7f * sky;
      const float g = hit ? cg * shade : 0.8f * sky;
      const float b = hit ? cb * shade : 0.9f * sky;
      rgb[3 * j] = fminf(fmaxf(r, 0.f), 1.f) * 255.f;
      rgb[3 * j + 1] = fminf(fmaxf(g, 0.f), 1.f) * 255.f;
      rgb[3 * j + 2] = fminf(fmaxf(b, 0.f), 1.f) * 255.f;
    }
    float* o = a.out + (static_cast<size_t>(env0 + e) * a.HW + pix0) * 3;
    if (kVec) {
      float4* o4 = reinterpret_cast<float4*>(o);
      o4[0] = make_float4(rgb[0], rgb[1], rgb[2], rgb[3]);
      o4[1] = make_float4(rgb[4], rgb[5], rgb[6], rgb[7]);
      o4[2] = make_float4(rgb[8], rgb[9], rgb[10], rgb[11]);
    } else {
      const int n_pix = min(kPix, a.HW - pix0);
      for (int i = 0; i < 3 * n_pix; ++i) o[i] = rgb[i];
    }
  }
}

}  // namespace

// Bytes of shared memory a block needs for E envs.
extern "C" int ldp_raycast_smem_bytes(int P, int K, int n_convex, int E) {
  return (E * (P * kRec + n_convex * K * 4 + kEnvRec) + 12) *
         static_cast<int>(sizeof(float));
}

// Each scene field comes with its env stride in elements. planes may be
// null when n_convex == 0. E is the number of envs a block renders.
// Returns a cudaError_t.
extern "C" int ldp_raycast(
    const float* pos, long long s_pos, const float* rot, long long s_rot,
    const float* size, long long s_size, const float* color,
    long long s_color, const int* kind, long long s_kind, const float* planes,
    long long s_planes, const float* plane_z, long long s_plane_z,
    const float* plane_color, long long s_plane_color, const float* dirs,
    const float* light, float ox, float oy, float oz, float ambient,
    float* out, int N, int HW, int P, int K, int n_convex, int E,
    void* stream) {
  if (N == 0 || HW == 0) return 0;
  RaycastArgs a{pos, rot, size, color, kind, planes, plane_z, plane_color,
                dirs, light, s_pos, s_rot, s_size, s_color, s_kind, s_planes,
                s_plane_z, s_plane_color, ox, oy, oz, ambient, out, N, HW, P,
                K, n_convex, E};
  const int smem = ldp_raycast_smem_bytes(P, K, n_convex, E);
  // float4 loads and stores need every env's image and the rays 16-byte
  // aligned: H*W a multiple of 4 (cudaMalloc'ed bases are)
  const bool vec = HW % kPix == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0 &&
                   reinterpret_cast<size_t>(dirs) % 16 == 0;
  auto kernel = vec ? raycast_kernel<true> : raycast_kernel<false>;
  cudaError_t err = ldp::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (HW + kPix - 1) / kPix;
  dim3 grid((groups + kThreads - 1) / kThreads, (N + E - 1) / E);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
