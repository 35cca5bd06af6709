// Native host-side 3D augmentation kernels.
//
// The reference runs its augmentation policy (torchio RandomAffine /
// RandomNoise / RandomGamma — k_fold_cross_valid_combined_brats.py:93-97)
// in DataLoader worker processes; this library is the framework's native
// equivalent for the host stage of the input pipeline. The generic
// scipy.ndimage spline machinery costs ~60-240 ms per 96^3 volume on one
// core; these single-pass, auto-vectorised kernels run the same math in a
// few ms, letting a small host keep a TPU chip fed (see
// data/native_augment.py for the Python bindings + distribution parity).
//
// Semantics:
// - affine3d_f32: out(o) = trilinear(in, M @ o + t), exactly
//   scipy.ndimage.affine_transform(order=1, mode='constant', cval=0):
//   out-of-bounds corner voxels read as 0.
// - add_gaussian_noise_f32: buf += N(0, std) per element, xoshiro256++ +
//   Box-Muller (distributional parity with numpy's Generator.normal).
// - gamma_f32: torchio-style intensity power transform on the min-max unit
//   rescale, mapped back to the original range.
// - zscore_f32 / minmax_f32: the dataset normalisations (brats.py:26-32).
//
// Build: g++ -O3 -march=native -shared -fPIC (driven by native_augment.py).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// affine resample, trilinear, constant-0 padding
// ---------------------------------------------------------------------------
void affine3d_f32(const float* in, float* out, int nz, int ny, int nx,
                  const double* mat /* 3x3 row-major */,
                  const double* offset /* 3 */) {
  const double m00 = mat[0], m01 = mat[1], m02 = mat[2];
  const double m10 = mat[3], m11 = mat[4], m12 = mat[5];
  const double m20 = mat[6], m21 = mat[7], m22 = mat[8];
  const int64_t syz = (int64_t)ny * nx;

  for (int oz = 0; oz < nz; ++oz) {
    for (int oy = 0; oy < ny; ++oy) {
      // input coordinate of (oz, oy, 0) and its per-ox increment: the map is
      // affine, so the inner loop is a pure add — no matmul per voxel
      double iz = m00 * oz + m01 * oy + offset[0];
      double iy = m10 * oz + m11 * oy + offset[1];
      double ix = m20 * oz + m21 * oy + offset[2];
      float* dst = out + (int64_t)oz * syz + (int64_t)oy * nx;
      for (int ox = 0; ox < nx; ++ox, iz += m02, iy += m12, ix += m22) {
        // scipy order-1 'constant' semantics: a sample whose coordinate falls
        // outside [0, n-1] on ANY axis is cval entirely (no partial
        // interpolation against the padding value)
        if (iz < 0.0 || iz > nz - 1 || iy < 0.0 || iy > ny - 1 ||
            ix < 0.0 || ix > nx - 1) {
          dst[ox] = 0.0f;
          continue;
        }
        const double fz = std::floor(iz), fy = std::floor(iy), fx = std::floor(ix);
        const int z0 = (int)fz, y0 = (int)fy, x0 = (int)fx;
        const float wz = (float)(iz - fz), wy = (float)(iy - fy), wx = (float)(ix - fx);

        float c[2][2][2];
        for (int dz = 0; dz < 2; ++dz) {
          const int z = z0 + dz;
          const bool zin = (unsigned)z < (unsigned)nz;
          for (int dy = 0; dy < 2; ++dy) {
            const int y = y0 + dy;
            const bool yin = zin && (unsigned)y < (unsigned)ny;
            const float* row = in + (int64_t)z * syz + (int64_t)y * nx;
            for (int dx = 0; dx < 2; ++dx) {
              const int x = x0 + dx;
              c[dz][dy][dx] =
                  (yin && (unsigned)x < (unsigned)nx) ? row[x] : 0.0f;
            }
          }
        }
        const float c00 = c[0][0][0] + wx * (c[0][0][1] - c[0][0][0]);
        const float c01 = c[0][1][0] + wx * (c[0][1][1] - c[0][1][0]);
        const float c10 = c[1][0][0] + wx * (c[1][0][1] - c[1][0][0]);
        const float c11 = c[1][1][0] + wx * (c[1][1][1] - c[1][1][0]);
        const float c0 = c00 + wy * (c01 - c00);
        const float c1 = c10 + wy * (c11 - c10);
        dst[ox] = c0 + wz * (c1 - c0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// xoshiro256++ + Box-Muller gaussian noise
// ---------------------------------------------------------------------------
static inline uint64_t rotl64(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    // splitmix64 expansion of the seed
    uint64_t z = seed;
    for (int i = 0; i < 4; ++i) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
      t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
      s[i] = t ^ (t >> 31);
    }
  }
  inline uint64_t next() {
    const uint64_t result = rotl64(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl64(s[3], 45);
    return result;
  }
  inline double uniform() {  // (0, 1]: never 0, safe for log()
    return ((next() >> 11) + 1) * 0x1.0p-53;
  }
};

void add_gaussian_noise_f32(float* buf, int64_t n, float std_, uint64_t seed) {
  // blockwise: fill uniforms with the (serial) RNG first, then run the
  // Box-Muller transcendentals over the block — that second loop has no
  // loop-carried state, so -ffast-math auto-vectorises logf/sqrtf/sincosf
  // through libmvec (~6x over the fused serial loop)
  Xoshiro rng(seed);
  constexpr int64_t B = 4096;  // pairs per block
  float u1[B], u2[B];
  const float two_pi = 6.2831853071795864769f;
  for (int64_t base = 0; base < n; base += 2 * B) {
    const int64_t pairs = ((n - base) + 1) / 2 < B ? ((n - base) + 1) / 2 : B;
    for (int64_t i = 0; i < pairs; ++i) {
      u1[i] = (float)rng.uniform();
      u2[i] = (float)rng.uniform();
    }
    const int64_t full = (n - base) / 2 < pairs ? (n - base) / 2 : pairs;
    for (int64_t i = 0; i < full; ++i) {
      const float r = std::sqrt(-2.0f * std::log(u1[i])) * std_;
      const float a = two_pi * u2[i];
      buf[base + 2 * i] += r * std::cos(a);
      buf[base + 2 * i + 1] += r * std::sin(a);
    }
    if (full < pairs) {  // odd tail: one leftover sample
      buf[base + 2 * full] += std::sqrt(-2.0f * std::log(u1[full])) * std_ *
                              std::cos(two_pi * u2[full]);
    }
  }
}

// ---------------------------------------------------------------------------
// intensity transforms
// ---------------------------------------------------------------------------
void gamma_f32(float* buf, int64_t n, float gamma) {
  float lo = buf[0], hi = buf[0];
  for (int64_t i = 1; i < n; ++i) {
    lo = buf[i] < lo ? buf[i] : lo;
    hi = buf[i] > hi ? buf[i] : hi;
  }
  const float range = hi - lo;
  if (range <= 0.0f) return;
  const float inv = 1.0f / range;
  for (int64_t i = 0; i < n; ++i) {
    buf[i] = std::pow((buf[i] - lo) * inv, gamma) * range + lo;
  }
}

void zscore_f32(float* buf, int64_t n) {
  double sum = 0.0, sq = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    sum += buf[i];
    sq += (double)buf[i] * buf[i];
  }
  const double mean = sum / n;
  const double var = sq / n - mean * mean;
  const float inv = (float)(1.0 / std::sqrt(var > 0 ? var : 1e-12));
  const float m = (float)mean;
  for (int64_t i = 0; i < n; ++i) buf[i] = (buf[i] - m) * inv;
}

void minmax_f32(float* buf, int64_t n) {  // -> [-1, 1] (brats.py:30-32)
  float lo = buf[0], hi = buf[0];
  for (int64_t i = 1; i < n; ++i) {
    lo = buf[i] < lo ? buf[i] : lo;
    hi = buf[i] > hi ? buf[i] : hi;
  }
  const float range = hi - lo;
  if (range <= 0.0f) return;
  const float inv = 2.0f / range;
  for (int64_t i = 0; i < n; ++i) buf[i] = (buf[i] - lo) * inv - 1.0f;
}

}  // extern "C"
