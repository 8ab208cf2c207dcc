// Batched analytic ray-cast renderer: one thread per pixel of one env.
//
// Replaces the TPU kernel latent_diffusion_planning_tpu/ops/pallas/
// raycast.py (render_pallas / render_batch_pallas -> _render_kernel). Per
// pixel: ground-plane hit with checker tint, then per prim a body-frame ray
// test (box slab with the entering axis as normal, sphere quadric, or the
// generalized slab over k-DOP half-spaces for the first n_convex prims),
// nearest hit, Lambert shading from the light rig plus ambient, sky
// gradient for misses, clip * 255.
//
// What bounds it on H100: the write of the image (N x H x W x 3 fp32, 50 MB
// at 1024 envs of 64x64); the arithmetic is a few hundred FLOPs per pixel.
// The design reads each env's packed scene (and half-spaces) into shared
// memory once per block, reads the camera's ray directions (computed once
// per camera by the wrapper) from L2, keeps the running nearest hit in
// registers, and writes each pixel once.
//
// Layouts: scenes (N, P, 22) = pos(3) rot(9, world-from-body, row-major)
// size(3) color(3) kind(1) pad(3); planes (N, P, K, 4) rows (nx, ny, nz, d),
// inside iff n.x <= d in the body frame; plane (N, 4) = z, r, g, b;
// dirs (H*W, 3); light (3 x 4) = normalized dir(3), color(1);
// out (N, H*W, 3).
#include "common.cuh"

namespace {

constexpr float kBig = 1e9f;
constexpr int kThreads = 256;

__device__ __forceinline__ float safe_div_dir(float d) {
  return fabsf(d) < 1e-9f ? (d >= 0.f ? 1e-9f : -1e-9f) : d;
}

__global__ void __launch_bounds__(kThreads) raycast_kernel(
    const float* __restrict__ scenes, const float* __restrict__ planes,
    const float* __restrict__ plane, const float* __restrict__ dirs,
    const float* __restrict__ light, float ox, float oy, float oz,
    float ambient, float* __restrict__ out, int HW, int P, int K,
    int n_convex) {
  extern __shared__ float sh[];
  float* sc = sh;              // P x 22
  float* hs = sh + P * 22;     // n_convex x K x 4
  const int env = blockIdx.y;
  for (int i = threadIdx.x; i < P * 22; i += blockDim.x)
    sc[i] = scenes[static_cast<size_t>(env) * P * 22 + i];
  for (int i = threadIdx.x; i < n_convex * K * 4; i += blockDim.x)
    hs[i] = planes[static_cast<size_t>(env) * P * K * 4 + i];
  __syncthreads();

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= HW) return;
  const float dx = dirs[3 * pix], dy = dirs[3 * pix + 1];
  const float dz = dirs[3 * pix + 2];
  const float plane_z = plane[4 * env];

  // implicit ground plane as the initial nearest hit
  const float safe_dz = fabsf(dz) < 1e-9f ? -1e-9f : dz;
  float t_plane = (plane_z - oz) / safe_dz;
  t_plane = t_plane > 1e-4f ? t_plane : kBig;
  const float px = ox + dx * t_plane, py = oy + dy * t_plane;
  const float checker = fmodf(floorf(px / 0.2f) + floorf(py / 0.2f), 2.f);
  // floor sums are integers; fmod of a negative one is negative
  const float tint = 0.85f + 0.15f * (checker < 0.f ? checker + 2.f : checker);

  float best_t = t_plane;
  float bnx = 0.f, bny = 0.f, bnz = 1.f;
  float br = plane[4 * env + 1] * tint, bg = plane[4 * env + 2] * tint,
        bb = plane[4 * env + 3] * tint;

  for (int p = 0; p < P; ++p) {
    const float* row = sc + p * 22;
    const float cx = row[0], cy = row[1], cz = row[2];
    const float* R = row + 3;  // R[3*i + j] = rot[i][j]
    const float sx = row[12], sy = row[13], sz = row[14];
    const float relx = ox - cx, rely = oy - cy, relz = oz - cz;
    const float ob[3] = {R[0] * relx + R[3] * rely + R[6] * relz,
                         R[1] * relx + R[4] * rely + R[7] * relz,
                         R[2] * relx + R[5] * rely + R[8] * relz};
    const float db[3] = {R[0] * dx + R[3] * dy + R[6] * dz,
                         R[1] * dx + R[4] * dy + R[7] * dz,
                         R[2] * dx + R[5] * dy + R[8] * dz};
    float t_p, n0, n1, n2;
    if (p < n_convex) {
      const float* h = hs + p * K * 4;
      float t_near = -kBig, t_far = kBig;
      float m0 = 0.f, m1 = 0.f, m2 = 0.f;
      for (int k = 0; k < K; ++k) {
        const float nx = h[4 * k], ny = h[4 * k + 1], nz = h[4 * k + 2];
        const float off = h[4 * k + 3];
        const float ndotd = nx * db[0] + ny * db[1] + nz * db[2];
        const float ndoto = nx * ob[0] + ny * ob[1] + nz * ob[2];
        const bool para = fabsf(ndotd) < 1e-9f;
        const float t_k = (off - ndoto) / (para ? 1e-9f : ndotd);
        const bool entering = (ndotd < 0.f) && !para;
        if (entering && t_k > t_near) {
          m0 = nx; m1 = ny; m2 = nz;
          t_near = t_k;
        }
        if (!entering && !para) t_far = fminf(t_far, t_k);
        if (para && ndoto > off) t_near = kBig;
      }
      const bool hit = (t_near <= t_far) && (t_far > 1e-4f);
      t_p = t_near > 1e-4f ? t_near : t_far;
      t_p = hit ? t_p : kBig;
      n0 = R[0] * m0 + R[1] * m1 + R[2] * m2;
      n1 = R[3] * m0 + R[4] * m1 + R[5] * m2;
      n2 = R[6] * m0 + R[7] * m1 + R[8] * m2;
    } else if (row[18] < 0.5f) {
      // box slab test
      const float half[3] = {sx, sy, sz};
      float t_near = -kBig, t_far = kBig;
      int near_ax = 0;
      for (int ax = 0; ax < 3; ++ax) {
        const float inv = 1.f / safe_div_dir(db[ax]);
        const float t1 = (-half[ax] - ob[ax]) * inv;
        const float t2 = (half[ax] - ob[ax]) * inv;
        const float tmin = fminf(t1, t2), tmax = fmaxf(t1, t2);
        if (tmin > t_near) near_ax = ax;
        t_near = fmaxf(t_near, tmin);
        t_far = fminf(t_far, tmax);
      }
      const bool hit = (t_near <= t_far) && (t_far > 1e-4f);
      t_p = t_near > 1e-4f ? t_near : t_far;
      t_p = hit ? t_p : kBig;
      const float dn = db[near_ax];
      const float sgn = dn > 0.f ? 1.f : (dn < 0.f ? -1.f : 0.f);
      float nb[3] = {0.f, 0.f, 0.f};
      nb[near_ax] = -sgn;
      n0 = R[0] * nb[0] + R[1] * nb[1] + R[2] * nb[2];
      n1 = R[3] * nb[0] + R[4] * nb[1] + R[5] * nb[2];
      n2 = R[6] * nb[0] + R[7] * nb[1] + R[8] * nb[2];
    } else {
      // sphere of radius sx
      const float b_half = relx * dx + rely * dy + relz * dz;
      const float c_term = (relx * relx + rely * rely + relz * relz) - sx * sx;
      const float disc = b_half * b_half - c_term;
      const float sq = sqrtf(fmaxf(disc, 0.f));
      const float t0 = -b_half - sq, t1 = -b_half + sq;
      t_p = t0 > 1e-4f ? t0 : t1;
      t_p = (disc > 0.f && t_p > 1e-4f) ? t_p : kBig;
      const float inv_r = 1.f / fmaxf(sx, 1e-9f);
      n0 = ((ox + dx * t_p) - cx) * inv_r;
      n1 = ((oy + dy * t_p) - cy) * inv_r;
      n2 = ((oz + dz * t_p) - cz) * inv_r;
    }
    if (t_p < best_t) {
      best_t = t_p;
      bnx = n0; bny = n1; bnz = n2;
      br = row[15]; bg = row[16]; bb = row[17];
    }
  }

  float diffuse = 0.f;
  for (int l = 0; l < 3; ++l) {
    const float* L = light + 4 * l;
    diffuse += fmaxf(-(bnx * L[0] + bny * L[1] + bnz * L[2]), 0.f) * L[3];
  }
  const float shade = ambient + diffuse;
  const bool hit = best_t < kBig * 0.5f;
  const float sky = 0.6f + 0.4f * fminf(fmaxf(dz, 0.f), 1.f);
  const float r = hit ? br * shade : 0.7f * sky;
  const float g = hit ? bg * shade : 0.8f * sky;
  const float b = hit ? bb * shade : 0.9f * sky;
  float* o = out + (static_cast<size_t>(env) * HW + pix) * 3;
  o[0] = fminf(fmaxf(r, 0.f), 1.f) * 255.f;
  o[1] = fminf(fmaxf(g, 0.f), 1.f) * 255.f;
  o[2] = fminf(fmaxf(b, 0.f), 1.f) * 255.f;
}

}  // namespace

// planes may be null when n_convex == 0. Returns a cudaError_t.
extern "C" int ldp_raycast(const float* scenes, const float* planes,
                           const float* plane, const float* dirs,
                           const float* light, float ox, float oy, float oz,
                           float ambient, float* out, int N, int HW, int P,
                           int K, int n_convex, void* stream) {
  if (N == 0) return 0;
  const int smem =
      (P * 22 + n_convex * K * 4) * static_cast<int>(sizeof(float));
  cudaError_t err = ldp::allow_smem(raycast_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((HW + kThreads - 1) / kThreads, N);
  raycast_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scenes, planes, plane, dirs, light, ox, oy, oz, ambient, out, HW, P, K,
      n_convex);
  return static_cast<int>(cudaGetLastError());
}
