// The fused LSTM / GravesLSTM cell for Hopper (sm_90a): one time step's
// gates, cell and output (K11f) and its backward (K11b).
//
// Replace the body of `_RnnBase.run`'s lax.scan for `LSTM.step` and
// `GravesLSTM.step` in deeplearning4j_tpu/nn/conf/layers.py (:951-957,
// :980-989), the mask's `where` included (:905-908), which XLA fuses into
// one loop body on the TPU. The products stay outside: the layer's input
// product X.W over all T is one GEMM before the loop, and each step's
// recurrent product is one addmm, z = X.W[t] + h_prev.RW, handed to K11f.
//
// K11f, per (row n, hidden unit j), gate order (i, f, g, o):
//   z += b;  i = sigm(z_i + pI c_prev);  f = sigm(z_f + pF c_prev);
//   g = tanh(z_g);  c = f c_prev + i g;  o = sigm(z_o + pO c);  h = o act(c)
// (pI, pF, pO only for GravesLSTM), then writes the step's output h * m,
// the carries where(m != 0, h, h_prev) and where(m != 0, c, c_prev), and
// the activated gates, which the backward reads instead of recomputing.
// K11b takes the output's gradient dy and the carried dh and dc and writes
// dz (N, 4H), dc_prev and, under a mask, the part of dh_prev that does not
// go through RW (the carry a masked row passes on; with no mask it is 0
// and is not written); the caller adds dz.RW^T.
// The peephole gradients' per-row terms are added into (3, N, H) buffers
// that each thread alone owns, so the sums over N and T (taken once after
// the loop) are deterministic with no atomics.
//
// One thread per hidden unit of a row: consecutive threads read
// consecutive j of each of the four gate columns, so every load and store
// is coalesced. Everything is f32, in both of the network's data types
// (the reference's carries are f32 and its recurrent product promotes to
// f32 under the bf16 policy). expf / tanhf are the precise functions.
//
// What bounds them on the H100: memory, and at the char-RNN's shapes not
// even that. K11f at N 32, H 256 with no mask reads z (131 KB), b (4 KB),
// c_prev and h_prev (65 KB) and writes both carries and the gates
// (197 KB; the output is h, not written twice): ~0.40 MB, 0.12 us at
// 3.35 TB/s, against ~2-3 us to launch any kernel.
// Both kernels are launch-bound; what would move them is fewer launches
// (a persistent kernel over the time loop with RW resident), not a
// faster body.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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
  float zi = zr[j], zf = zr[hd + j], zg = zr[2 * hd + j],
        zo = zr[3 * hd + j];
  if (b != nullptr) {
    zi += b[j];
    zf += b[hd + j];
    zg += b[2 * hd + j];
    zo += b[3 * hd + j];
  }
  const float cp = c_prev[idx], hp = h_prev[idx];
  if (peep != nullptr) {
    zi += peep[j] * cp;
    zf += peep[hd + j] * cp;
  }
  const float i = sigm(zi), f = sigm(zf), g = tanhf(zg);
  const float c = f * cp + i * g;
  if (peep != nullptr) zo += peep[2 * hd + j] * c;
  const float o = sigm(zo);
  const float h = o * act_f(act, c);
  float* gr = gates + (long long)r * 4 * hd;
  gr[j] = i;
  gr[hd + j] = f;
  gr[2 * hd + j] = g;
  gr[3 * hd + j] = o;
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
  const float i = gr[j], f = gr[hd + j], g = gr[2 * hd + j],
              o = gr[3 * hd + j];
  const float mv = m != nullptr ? m[r] : 1.0f;
  const bool keep = mv != 0.0f;
  const float dhv = dh[idx], dcv = dc[idx];
  float dhn = keep ? dhv : 0.0f;
  if (dy != nullptr) dhn = (m != nullptr ? dy[idx] * mv : dy[idx]) + dhn;
  const float dcn = keep ? dcv : 0.0f;
  const float cv = c[idx], cp = c_prev[idx];
  const float a = act_f(act, cv);
  const float dzo = dhn * a * o * (1.0f - o);
  float dct = dcn + dhn * o * act_d(act, cv, a);
  if (peep != nullptr) dct += dzo * peep[2 * hd + j];
  const float dzi = dct * g * i * (1.0f - i);
  const float dzf = dct * cp * f * (1.0f - f);
  const float dzg = dct * i * (1.0f - g * g);
  float* dzr = dz + (long long)r * 4 * hd;
  dzr[j] = dzi;
  dzr[hd + j] = dzf;
  dzr[2 * hd + j] = dzg;
  dzr[3 * hd + j] = dzo;
  float dcp = dct * f;
  if (peep != nullptr) dcp += dzi * peep[j] + dzf * peep[hd + j];
  dc_prev[idx] = keep ? dcp : dcp + dcv;
  if (m != nullptr) dh_pass[idx] = keep ? 0.0f : dhv;
  if (dpeep != nullptr) {
    dpeep[idx] += dzi * cp;
    dpeep[nh + idx] += dzf * cp;
    dpeep[2 * nh + idx] += dzo * cv;
  }
}

unsigned blocks(int rows, int hd) {
  return (unsigned)(((long long)rows * hd + THREADS - 1) / THREADS);
}

bool bad(int rows, int hd, int act) {
  return rows < 1 || hd < 1 || (long long)rows * hd > 2147483647LL ||
         act < TANH || act > SOFTSIGN;
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

extern "C" const char* dl4j_rnn_cell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
