// The LSTM / GravesLSTM time loop for Hopper (sm_90a): a whole layer over
// the T steps of a call in one launch (K11Lf, K11Lb), and the fused cell
// of one step (K11f, K11b), which layers too wide for K11L take.
//
// Replace `_RnnBase.run`'s lax.scan over `LSTM.step` / `GravesLSTM.step`
// in deeplearning4j_tpu/nn/conf/layers.py (:895-914, :951-957, :980-989),
// the mask's `where` included (:905-908), which XLA compiles into one
// device loop on the TPU. The layer's input product X.W over all T stays
// one GEMM before the loop (the caller's), and dW, dRW, db and dX whole-
// chunk GEMMs after the backward's loop.
//
// The cell, per (row n, hidden unit j), gate order (i, f, g, o):
//   z = X.W[t] + h_prev.RW + b;  i = sigm(z_i + pI c_prev);
//   f = sigm(z_f + pF c_prev);  g = tanh(z_g);  c = f c_prev + i g;
//   o = sigm(z_o + pO c);  h = o act(c)
// (pI, pF, pO only for GravesLSTM); the step's output is h * m, the
// carries where(m != 0, h, h_prev) and where(m != 0, c, c_prev), and the
// activated gates are kept for the backward, which reads them instead of
// recomputing. The backward takes the output's gradient dy and the carried
// dh and dc to dz (N, 4H), dc_prev and, under a mask, the part of dh_prev
// that does not go through RW (the carry a masked row passes on); dh_prev
// is that plus dz.RW^T. The peephole gradients' per-row terms are summed
// over t by the thread that owns the row and unit, and over N by the
// caller after the loop, so every sum is deterministic with no atomics.
//
// K11Lf / K11Lb (one launch a layer and call). Batch rows are independent
// through the recurrence, so the grid is a set of thread-block clusters,
// each owning R rows (R = 4 at the char-RNN's N 32: 8 clusters). Inside a
// cluster, CTA q owns the hidden units j in [qU, qU + U), U = ceil(H / C)
// for a cluster of C CTAs, with all four gate columns of them, so the
// cell, the carries, the mask and the peepholes are local to one CTA.
// - Forward: the CTA keeps RW[:, its 4U gate columns] in shared memory for
//   the whole launch (H x 4U f32: 128 KB at H 256 in a cluster of 8) and
//   the cluster's h_{t-1} for its R rows (all H units). A step is the
//   product z[R, 4U] = h_{t-1} . RW_slice (a warp per 32 columns and a
//   share of k, the shares summed in a fixed order), the cell, and the
//   new h written into every CTA's shared memory of the cluster
//   (distributed shared memory, double-buffered), then one cluster
//   barrier. Clusters never wait on each other.
// - Backward, the same transposed: the CTA keeps RW[its U rows, :] (4H x
//   U), runs the cell's backward for its units, writes dz into every
//   CTA's shared memory, meets the cluster barrier, and forms
//   dh_{t-1}[:, its j] = dz_t . RW[its j, :]^T, the units it needs next.
// The product runs in f32 on the FMA units (no operand rounds to TF32),
// every sum in a fixed order, so a relaunch gives the same bits.
//
// K11f / K11b (one launch a step): a thread per hidden unit of a row;
// consecutive threads read consecutive j of each gate column, so every
// load and store is coalesced. The caller adds the recurrent product
// (an addmm a step each way).
//
// Everything is f32 in both of the network's data types (the reference's
// carries are f32 and its recurrent product promotes to f32 under the
// bf16 policy). expf / tanhf are the precise functions.
//
// What bounds them on the H100. K11f at N 32, H 256 reads and writes
// ~0.40 MB (0.12 us at 3.35 TB/s) against ~2-3 us to launch any kernel:
// launch-bound, and the time loop's 4 launches a step and layer (two
// addmms, K11f, K11b) bound the layer by the host. K11L makes that one
// launch a layer and call each way. Its own bound at R1's second layer
// (N 32, T 50, H 256) is the product's 0.84 GFLOP at 67 TFLOP/s (12.5 us)
// over ~17 MB of operands (5.2 us); what holds it above that is the chain
// of T dependent steps, each a shared-memory pass over the CTA's RW slice
// (128 KB at 128 B a clock: ~1000 clocks) and a cluster barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int LAYER_THREADS = 256;
constexpr int LAYER_WARPS = LAYER_THREADS / 32;
// dynamic shared memory one block may take (227 KB on the H100)
constexpr int SMEM_PER_BLOCK = 232448;
constexpr int MAX_CLUSTER = 16;

// activation codes (the Python wrapper's ACTIVATIONS)
enum Act { TANH = 0, IDENTITY = 1, RELU = 2, SIGMOID = 3, HARDTANH = 4,
           SOFTSIGN = 5 };

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float act_f(int code, float x) {
  switch (code) {
    case TANH: return tanhf(x);
    case IDENTITY: return x;
    case RELU: return x > 0.0f ? x : 0.0f;
    case SIGMOID: return sigm(x);
    case HARDTANH: return fminf(fmaxf(x, -1.0f), 1.0f);
    default: return x / (1.0f + fabsf(x));
  }
}

// d act(x) / dx, given a = act(x)
__device__ __forceinline__ float act_d(int code, float x, float a) {
  switch (code) {
    case TANH: return 1.0f - a * a;
    case IDENTITY: return 1.0f;
    case RELU: return x > 0.0f ? 1.0f : 0.0f;
    case SIGMOID: return a * (1.0f - a);
    case HARDTANH: return (x > -1.0f && x < 1.0f) ? 1.0f : 0.0f;
    default: {
      const float d = 1.0f + fabsf(x);
      return 1.0f / (d * d);
    }
  }
}

// One unit's cell forward from its biased pre-activations z (i, f, g, o)
// and c_prev; peep is (pI, pF, pO) or null. Writes the activated gates
// into gt[4], returns h and sets c.
__device__ __forceinline__ float cell_forward(const float (&z)[4], float cp,
                                              const float* peep, int act,
                                              float (&gt)[4], float& c) {
  float zi = z[0], zf = z[1], zo = z[3];
  if (peep != nullptr) {
    zi += peep[0] * cp;
    zf += peep[1] * cp;
  }
  const float i = sigm(zi), f = sigm(zf), g = tanhf(z[2]);
  c = f * cp + i * g;
  if (peep != nullptr) zo += peep[2] * c;
  const float o = sigm(zo);
  gt[0] = i;
  gt[1] = f;
  gt[2] = g;
  gt[3] = o;
  return o * act_f(act, c);
}

// One unit's cell backward: the output's gradient dy (already times the
// mask; 0 with none), the carried dh and dc, the gates, c and c_prev, the
// mask's keep. Writes dz[4] and the peephole terms dp[3] (when peep),
// returns dc_prev; dh_pass (the dh a masked row passes on) is
// keep ? 0 : dh, the caller's.
__device__ __forceinline__ float cell_backward(float dy, float dh, float dc,
                                               const float (&gt)[4], float cv,
                                               float cp, const float* peep,
                                               bool keep, int act,
                                               float (&dz)[4],
                                               float (&dp)[3]) {
  const float i = gt[0], f = gt[1], g = gt[2], o = gt[3];
  const float dhn = dy + (keep ? dh : 0.0f);
  const float dcn = keep ? dc : 0.0f;
  const float a = act_f(act, cv);
  const float dzo = dhn * a * o * (1.0f - o);
  float dct = dcn + dhn * o * act_d(act, cv, a);
  if (peep != nullptr) dct += dzo * peep[2];
  const float dzi = dct * g * i * (1.0f - i);
  const float dzf = dct * cp * f * (1.0f - f);
  const float dzg = dct * i * (1.0f - g * g);
  dz[0] = dzi;
  dz[1] = dzf;
  dz[2] = dzg;
  dz[3] = dzo;
  float dcp = dct * f;
  if (peep != nullptr) dcp += dzi * peep[0] + dzf * peep[1];
  dp[0] = dzi * cp;
  dp[1] = dzf * cp;
  dp[2] = dzo * cv;
  return keep ? dcp : dcp + dc;
}

// ------------------------------------------------------------ K11f, K11b
__global__ void __launch_bounds__(THREADS)
    lstm_fwd_kernel(const float* __restrict__ z, const float* __restrict__ b,
                    const float* __restrict__ c_prev,
                    const float* __restrict__ h_prev,
                    const float* __restrict__ peep,
                    const float* __restrict__ m, float* __restrict__ y,
                    float* __restrict__ h_out, float* __restrict__ c_out,
                    float* __restrict__ gates, int rows, int hd, int act) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)rows * hd) return;
  const int r = (int)(idx / hd), j = (int)(idx % hd);
  const float* zr = z + (long long)r * 4 * hd;
  float zv[4], gt[4], pv[3], c;
  for (int q = 0; q < 4; ++q) {
    zv[q] = zr[q * hd + j];
    if (b != nullptr) zv[q] += b[q * hd + j];
  }
  if (peep != nullptr)
    for (int q = 0; q < 3; ++q) pv[q] = peep[q * hd + j];
  const float cp = c_prev[idx], hp = h_prev[idx];
  const float h = cell_forward(zv, cp, peep != nullptr ? pv : nullptr, act,
                               gt, c);
  float* gr = gates + (long long)r * 4 * hd;
  for (int q = 0; q < 4; ++q) gr[q * hd + j] = gt[q];
  const float mv = m != nullptr ? m[r] : 1.0f;
  const bool keep = mv != 0.0f;
  if (y != nullptr) y[idx] = m != nullptr ? h * mv : h;
  h_out[idx] = keep ? h : hp;
  c_out[idx] = keep ? c : cp;
}

__global__ void __launch_bounds__(THREADS)
    lstm_bwd_kernel(const float* __restrict__ dy,
                    const float* __restrict__ dh,
                    const float* __restrict__ dc,
                    const float* __restrict__ gates,
                    const float* __restrict__ c,
                    const float* __restrict__ c_prev,
                    const float* __restrict__ peep,
                    const float* __restrict__ m, float* __restrict__ dz,
                    float* __restrict__ dc_prev, float* __restrict__ dh_pass,
                    float* __restrict__ dpeep, int rows, int hd, int act) {
  const long long nh = (long long)rows * hd;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= nh) return;
  const int r = (int)(idx / hd), j = (int)(idx % hd);
  const float* gr = gates + (long long)r * 4 * hd;
  float gt[4], pv[3], dzv[4], dp[3];
  for (int q = 0; q < 4; ++q) gt[q] = gr[q * hd + j];
  if (peep != nullptr)
    for (int q = 0; q < 3; ++q) pv[q] = peep[q * hd + j];
  const float mv = m != nullptr ? m[r] : 1.0f;
  const bool keep = mv != 0.0f;
  const float dhv = dh[idx];
  const float dyv =
      dy == nullptr ? 0.0f : (m != nullptr ? dy[idx] * mv : dy[idx]);
  dc_prev[idx] = cell_backward(dyv, dhv, dc[idx], gt, c[idx], c_prev[idx],
                               peep != nullptr ? pv : nullptr, keep, act,
                               dzv, dp);
  float* dzr = dz + (long long)r * 4 * hd;
  for (int q = 0; q < 4; ++q) dzr[q * hd + j] = dzv[q];
  if (m != nullptr) dh_pass[idx] = keep ? 0.0f : dhv;
  if (dpeep != nullptr)
    for (int q = 0; q < 3; ++q) dpeep[q * nh + idx] += dp[q];
}

unsigned blocks(int rows, int hd) {
  return (unsigned)(((long long)rows * hd + THREADS - 1) / THREADS);
}

bool bad(int rows, int hd, int act) {
  return rows < 1 || hd < 1 || (long long)rows * hd > 2147483647LL ||
         act < TANH || act > SOFTSIGN;
}

// ---------------------------------------------------------- K11Lf, K11Lb
// One CTA's share of a layer launch (rnn_cell.py's layer_geometry mirrors
// it): the product out[R, oc] = vec[R, k] . mat[k, oc], with oc the
// forward's 4U gate columns or the backward's U units and k the
// forward's H or the backward's 4H, padded to kp (a multiple of 4) with
// zeros; a warp per 32 columns (ncb blocks, the last one's lanes past oc
// idle) and, over the warps left, ks shares of k of `chunk` each. Shared
// memory: mat [kp][oc], vec [2][R][kp] (the exchanged h or dz,
// double-buffered), part [ks][R][oc] (the shares' sums).
struct Geometry {
  int units, oc, k, kp, ncb, ks, chunk, smem;
};

__host__ __device__ inline Geometry geometry(int bwd, int hd, int cluster,
                                             int rows) {
  Geometry g;
  g.units = (hd + cluster - 1) / cluster;
  g.oc = bwd ? g.units : 4 * g.units;
  g.k = bwd ? 4 * hd : hd;
  g.kp = (g.k + 3) / 4 * 4;
  g.ncb = (g.oc + 31) / 32;
  g.ks = g.ncb <= LAYER_WARPS ? LAYER_WARPS / g.ncb : 0;
  g.chunk = g.ks > 0 ? ((g.kp + g.ks - 1) / g.ks + 3) / 4 * 4 : 0;
  g.smem = 4 * (g.kp * g.oc + 2 * rows * g.kp + g.ks * rows * g.oc);
  return g;
}

// part[s][r][oc] = sum over share s's k of vec[r][k] * mat[k][oc], k in
// increasing order, one FMA at a time
template <int R>
__device__ __forceinline__ void layer_product(const float* __restrict__ vec,
                                              const float* __restrict__ mat,
                                              float* __restrict__ part,
                                              const Geometry& g) {
  const int w = threadIdx.x >> 5;
  if (w >= g.ks * g.ncb) return;
  const int oc = (w % g.ncb) * 32 + (threadIdx.x & 31), s = w / g.ncb;
  const int col = min(oc, g.oc - 1);   // a lane past oc reads, stores not
  const int k0 = s * g.chunk, k1 = min(g.kp, k0 + g.chunk);
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    const float m0 = mat[k * g.oc + col], m1 = mat[(k + 1) * g.oc + col],
                m2 = mat[(k + 2) * g.oc + col], m3 = mat[(k + 3) * g.oc + col];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(vec + r * g.kp + k);
      acc[r] = fmaf(v.x, m0, acc[r]);
      acc[r] = fmaf(v.y, m1, acc[r]);
      acc[r] = fmaf(v.z, m2, acc[r]);
      acc[r] = fmaf(v.w, m3, acc[r]);
    }
  }
  if (oc < g.oc) {
#pragma unroll
    for (int r = 0; r < R; ++r) part[(s * R + r) * g.oc + oc] = acc[r];
  }
}

// the shares of column oc of row r, summed in share order
__device__ __forceinline__ float share_sum(const float* part, int R, int r,
                                           int oc, const Geometry& g) {
  float s = part[r * g.oc + oc];
  for (int q = 1; q < g.ks; ++q) s += part[(q * R + r) * g.oc + oc];
  return s;
}

template <int R>
__global__ void __launch_bounds__(LAYER_THREADS, 1)
    lstm_layer_fwd_kernel(const float* __restrict__ xw,
                          const float* __restrict__ rw,
                          const float* __restrict__ b,
                          const float* __restrict__ peep,
                          const float* __restrict__ m,
                          const float* __restrict__ h0,
                          const float* __restrict__ c0, float* __restrict__ ys,
                          float* __restrict__ hs, float* __restrict__ cs,
                          float* __restrict__ gates, int steps, int rows,
                          int hd, int act) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ncta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Geometry g = geometry(0, hd, ncta, R);
  const int U = g.units, j0 = rank * U;
  const int units = max(0, min(U, hd - j0));
  const int row0 = (int)(blockIdx.x / ncta) * R;
  const long long h4 = 4LL * hd;
  float* mat = reinterpret_cast<float*>(smem4);
  float* vec = mat + g.kp * g.oc;
  float* part = vec + 2 * R * g.kp;
  // RW[:, its gate columns]: local column q U + u is global q H + j0 + u
  for (int i = threadIdx.x; i < g.kp * g.oc; i += LAYER_THREADS) {
    const int k = i / g.oc, lc = i % g.oc, u = lc % U;
    mat[i] = (k < hd && u < units)
                 ? rw[k * h4 + (lc / U) * hd + j0 + u]
                 : 0.0f;
  }
  for (int i = threadIdx.x; i < R * g.kp; i += LAYER_THREADS) {
    const int r = i / g.kp, k = i % g.kp, row = row0 + r;
    vec[i] = (row < rows && k < hd) ? h0[(long long)row * hd + k] : 0.0f;
    vec[R * g.kp + i] = 0.0f;
  }
  // this thread's cell: row r of the block, unit u of the CTA's slice
  const int r = threadIdx.x / U, u = threadIdx.x % U;
  const int row = row0 + r, j = j0 + u;
  const bool live = threadIdx.x < R * U && row < rows && u < units;
  float x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bias[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float pv[3] = {0.0f, 0.0f, 0.0f}, c = 0.0f, mv = 1.0f;
  if (live) {
    for (int q = 0; q < 4; ++q) {
      x[q] = xw[row * h4 + q * hd + j];
      if (b != nullptr) bias[q] = b[q * hd + j];
    }
    if (peep != nullptr)
      for (int q = 0; q < 3; ++q) pv[q] = peep[q * hd + j];
    if (m != nullptr) mv = m[row];
    c = c0[(long long)row * hd + j];
  }
  // every CTA of the cluster is running (and its buffers set) before any
  // writes into another's shared memory
  cluster.sync();
  for (int t = 0; t < steps; ++t) {
    const float* cur = vec + (t & 1) * R * g.kp;
    float* nxt = vec + ((t + 1) & 1) * R * g.kp;
    // the next step's operands, in flight through this step's product
    float nx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, nm = 1.0f;
    if (live && t + 1 < steps) {
      const float* xr = xw + ((long long)(t + 1) * rows + row) * h4;
      for (int q = 0; q < 4; ++q) nx[q] = xr[q * hd + j];
      if (m != nullptr) nm = m[(long long)(t + 1) * rows + row];
    }
    layer_product<R>(cur, mat, part, g);
    __syncthreads();
    if (live) {
      float z[4], gt[4], cn;
      for (int q = 0; q < 4; ++q) {
        z[q] = x[q] + share_sum(part, R, r, q * U + u, g);
        if (b != nullptr) z[q] += bias[q];
      }
      const float h =
          cell_forward(z, c, peep != nullptr ? pv : nullptr, act, gt, cn);
      const long long o = ((long long)t * rows + row) * hd + j;
      float* gr = gates + ((long long)t * rows + row) * h4;
      for (int q = 0; q < 4; ++q) gr[q * hd + j] = gt[q];
      const bool keep = mv != 0.0f;
      if (ys != nullptr) ys[o] = h * mv;
      const float hc = keep ? h : cur[r * g.kp + j];
      c = keep ? cn : c;
      hs[o] = hc;
      cs[o] = c;
      for (int q = 0; q < ncta; ++q)
        cluster.map_shared_rank(nxt, q)[r * g.kp + j] = hc;
    }
    for (int q = 0; q < 4; ++q) x[q] = nx[q];
    mv = nm;
    cluster.sync();
  }
}

template <int R>
__global__ void __launch_bounds__(LAYER_THREADS, 1)
    lstm_layer_bwd_kernel(const float* __restrict__ dy,
                          const float* __restrict__ dh_in,
                          const float* __restrict__ dc_in,
                          const float* __restrict__ gates,
                          const float* __restrict__ cs,
                          const float* __restrict__ c0,
                          const float* __restrict__ rw,
                          const float* __restrict__ peep,
                          const float* __restrict__ m, float* __restrict__ dz,
                          float* __restrict__ dh0, float* __restrict__ dc0,
                          float* __restrict__ dpeep, int steps, int rows,
                          int hd, int act) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ncta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Geometry g = geometry(1, hd, ncta, R);
  const int U = g.units, j0 = rank * U;
  const int units = max(0, min(U, hd - j0));
  const int row0 = (int)(blockIdx.x / ncta) * R;
  const long long h4 = 4LL * hd, nh = (long long)rows * hd;
  float* mat = reinterpret_cast<float*>(smem4);
  float* vec = mat + g.kp * g.oc;
  float* part = vec + 2 * R * g.kp;
  // RW[its rows, :]^T: mat[c][u] = RW[j0 + u][c]
  for (int i = threadIdx.x; i < g.kp * g.oc; i += LAYER_THREADS) {
    const int k = i / g.oc, u = i % g.oc;
    mat[i] = (k < g.k && u < units) ? rw[(j0 + u) * h4 + k] : 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * R * g.kp; i += LAYER_THREADS)
    vec[i] = 0.0f;
  const int r = threadIdx.x / U, u = threadIdx.x % U;
  const int row = row0 + r, j = j0 + u;
  const bool live = threadIdx.x < R * U && row < rows && u < units;
  const long long at = (long long)row * hd + j;
  // the carried gradients, and step T-1's operands
  float dh = 0.0f, dc = 0.0f, pv[3] = {0.0f, 0.0f, 0.0f};
  float dsum[3] = {0.0f, 0.0f, 0.0f};
  float gt[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dyv = 0.0f, cv = 0.0f, cp = 0.0f;
  float mv = 1.0f;
  auto load = [&](int t, float (&gt_)[4], float& dy_, float& c_, float& cp_,
                  float& m_) {
    const long long o = (long long)t * nh + at;
    const float* gr = gates + ((long long)t * rows + row) * h4;
    for (int q = 0; q < 4; ++q) gt_[q] = gr[q * hd + j];
    m_ = m != nullptr ? m[(long long)t * rows + row] : 1.0f;
    dy_ = dy == nullptr ? 0.0f : (m != nullptr ? dy[o] * m_ : dy[o]);
    c_ = cs[o];
    cp_ = t > 0 ? cs[o - nh] : c0[at];
  };
  if (live) {
    dh = dh_in[at];
    dc = dc_in[at];
    if (peep != nullptr)
      for (int q = 0; q < 3; ++q) pv[q] = peep[q * hd + j];
    load(steps - 1, gt, dyv, cv, cp, mv);
  }
  cluster.sync();
  for (int s = 0; s < steps; ++s) {
    const int t = steps - 1 - s;
    float* buf = vec + (s & 1) * R * g.kp;
    float ngt[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ndy = 0.0f, nc = 0.0f,
          ncp = 0.0f, nm = 1.0f;
    float dh_pass = 0.0f;
    if (live) {
      if (t > 0) load(t - 1, ngt, ndy, nc, ncp, nm);
      float dzv[4], dp[3];
      const bool keep = mv != 0.0f;
      dc = cell_backward(dyv, dh, dc, gt, cv, cp,
                         peep != nullptr ? pv : nullptr, keep, act, dzv, dp);
      if (!keep) dh_pass = dh;
      float* dzr = dz + ((long long)t * rows + row) * h4;
      for (int q = 0; q < 4; ++q) dzr[q * hd + j] = dzv[q];
      for (int q = 0; q < 3; ++q) dsum[q] += dp[q];
      for (int q = 0; q < ncta; ++q) {
        float* dst = cluster.map_shared_rank(buf, q) + r * g.kp;
        for (int p = 0; p < 4; ++p) dst[p * hd + j] = dzv[p];
      }
    }
    for (int q = 0; q < 4; ++q) gt[q] = ngt[q];
    dyv = ndy;
    cv = nc;
    cp = ncp;
    mv = nm;
    cluster.sync();
    layer_product<R>(buf, mat, part, g);
    __syncthreads();
    if (live) dh = dh_pass + share_sum(part, R, r, u, g);
  }
  if (live) {
    dh0[at] = dh;
    dc0[at] = dc;
    if (dpeep != nullptr && peep != nullptr)
      for (int q = 0; q < 3; ++q) dpeep[q * nh + at] = dsum[q];
  }
}

const void* layer_kernel(int bwd, int rows_per_cluster) {
  switch (rows_per_cluster) {
    case 1: return bwd ? (const void*)lstm_layer_bwd_kernel<1>
                       : (const void*)lstm_layer_fwd_kernel<1>;
    case 2: return bwd ? (const void*)lstm_layer_bwd_kernel<2>
                       : (const void*)lstm_layer_fwd_kernel<2>;
    case 4: return bwd ? (const void*)lstm_layer_bwd_kernel<4>
                       : (const void*)lstm_layer_fwd_kernel<4>;
    default: return nullptr;
  }
}

bool bad_layer(int bwd, int steps, int rows, int hd, int act, int cluster,
               int rpc) {
  if (steps < 1 || rows < 1 || hd < 1 || act < TANH || act > SOFTSIGN ||
      cluster < 1 || cluster > MAX_CLUSTER ||
      layer_kernel(bwd, rpc) == nullptr)
    return true;
  const Geometry g = geometry(bwd, hd, cluster, rpc);
  return g.ks < 1 || rpc * g.units > LAYER_THREADS ||
         g.smem > SMEM_PER_BLOCK;
}

cudaLaunchConfig_t layer_config(int bwd, int rows, int hd, int cluster,
                                int rpc, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + rpc - 1) / rpc * cluster));
  cfg.blockDim = dim3(LAYER_THREADS);
  cfg.dynamicSmemBytes = (size_t)geometry(bwd, hd, cluster, rpc).smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Plain C interface, loaded with ctypes. Every tensor is contiguous f32:
// z and gates (rows, 4 * hd); c_prev, h_prev, y, h_out, c_out and the
// backward's (rows, hd) tensors; b (4 * hd) or null; peep (3, hd) = (pI,
// pF, pO) or null for LSTM; m (rows) or null; dpeep (3, rows, hd) or
// null, added into. Each returns the launch's cudaError_t (0 on success)
// and never synchronises.

// K11f: one step forward. y null skips the output (the caller reads h).
extern "C" int dl4j_lstm_cell_fwd(const float* z, const float* b,
                                  const float* c_prev, const float* h_prev,
                                  const float* peep, const float* m,
                                  float* y, float* h_out, float* c_out,
                                  float* gates, int rows, int hd, int act,
                                  void* stream) {
  if (bad(rows, hd, act)) return (int)cudaErrorInvalidValue;
  lstm_fwd_kernel<<<blocks(rows, hd), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      z, b, c_prev, h_prev, peep, m, y, h_out, c_out, gates, rows, hd, act);
  return (int)cudaGetLastError();
}

// K11b: one step backward. dy null means the step's output has no
// gradient; c is the step's carried c, c_prev the one before it; dh_pass
// is written only under a mask (it may be null when m is).
extern "C" int dl4j_lstm_cell_bwd(const float* dy, const float* dh,
                                  const float* dc, const float* gates,
                                  const float* c, const float* c_prev,
                                  const float* peep, const float* m,
                                  float* dz, float* dc_prev, float* dh_pass,
                                  float* dpeep, int rows, int hd, int act,
                                  void* stream) {
  if (bad(rows, hd, act)) return (int)cudaErrorInvalidValue;
  lstm_bwd_kernel<<<blocks(rows, hd), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      dy, dh, dc, gates, c, c_prev, peep, m, dz, dc_prev, dh_pass, dpeep,
      rows, hd, act);
  return (int)cudaGetLastError();
}

// K11L's shared memory a block (bytes) for the forward (bwd 0) or the
// backward (1) at hidden width hd, `cluster` CTAs a cluster and rpc rows
// a cluster; the Python side's layer_smem_bytes must agree.
extern "C" int dl4j_lstm_layer_smem(int bwd, int hd, int cluster, int rpc) {
  return geometry(bwd, hd, cluster, rpc).smem;
}

// How many clusters of K11L's shape (bwd, hd, cluster, rpc) the device can
// hold at once, into *out, after setting the kernel's dynamic shared
// memory limit to the block's maximum and allowing non-portable cluster
// sizes; 0 means none fits. Returns the cudaError_t of the query.
extern "C" int dl4j_lstm_layer_clusters(int bwd, int hd, int cluster,
                                        int rpc, int* out) {
  *out = 0;
  const void* fn = layer_kernel(bwd, rpc);
  if (fn == nullptr || hd < 1 || cluster < 1 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_PER_BLOCK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = layer_config(bwd, rpc, hd, cluster, rpc, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

// K11Lf: a whole layer forward over `steps` steps. xw (steps, rows, 4 hd)
// is X.W; rw (hd, 4 hd); b (4 hd) or null; peep (3, hd) or null; m
// (steps, rows) or null; h0, c0 (rows, hd); ys (steps, rows, hd) the
// output h * m, written only under a mask (null otherwise: the output is
// hs); hs, cs (steps, rows, hd) the carries after each step; gates
// (steps, rows, 4 hd). `cluster` CTAs a cluster, rpc (1, 2 or 4) rows a
// cluster; the caller has run dl4j_lstm_layer_clusters for the shape.
extern "C" int dl4j_lstm_layer_fwd(const float* xw, const float* rw,
                                   const float* b, const float* peep,
                                   const float* m, const float* h0,
                                   const float* c0, float* ys, float* hs,
                                   float* cs, float* gates, int steps,
                                   int rows, int hd, int act, int cluster,
                                   int rpc, void* stream) {
  if (bad_layer(0, steps, rows, hd, act, cluster, rpc))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = layer_config(0, rows, hd, cluster, rpc,
                                        static_cast<cudaStream_t>(stream),
                                        attr);
  void* args[] = {&xw, &rw, &b, &peep, &m, &h0, &c0, &ys, &hs,
                  &cs, &gates, &steps, &rows, &hd, &act};
  cudaLaunchKernelExC(&cfg, layer_kernel(0, rpc), args);
  return (int)cudaGetLastError();
}

// K11Lb: the layer's backward over the same steps, last to first. dy
// (steps, rows, hd) the output's gradient or null; dh, dc (rows, hd) the
// final carries' gradients; gates, cs, c0 and m as the forward made and
// took them; rw (hd, 4 hd). Writes dz (steps, rows, 4 hd), dh0 and dc0
// (rows, hd, the initial carries' gradients) and, with peepholes, dpeep
// (3, rows, hd), each row's peephole terms summed over the steps.
extern "C" int dl4j_lstm_layer_bwd(const float* dy, const float* dh,
                                   const float* dc, const float* gates,
                                   const float* cs, const float* c0,
                                   const float* rw, const float* peep,
                                   const float* m, float* dz, float* dh0,
                                   float* dc0, float* dpeep, int steps,
                                   int rows, int hd, int act, int cluster,
                                   int rpc, void* stream) {
  if (bad_layer(1, steps, rows, hd, act, cluster, rpc))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = layer_config(1, rows, hd, cluster, rpc,
                                        static_cast<cudaStream_t>(stream),
                                        attr);
  void* args[] = {&dy, &dh, &dc, &gates, &cs, &c0, &rw, &peep, &m,
                  &dz, &dh0, &dc0, &dpeep, &steps, &rows, &hd, &act};
  cudaLaunchKernelExC(&cfg, layer_kernel(1, rpc), args);
  return (int)cudaGetLastError();
}

extern "C" const char* dl4j_rnn_cell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
