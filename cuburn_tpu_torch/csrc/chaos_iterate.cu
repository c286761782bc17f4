// The chaos game for Hopper (sm_90a): K steps of every trajectory in one
// launch, writing the records that the flushes read.
//
// Replaces bench/fusedprobe.py::kernel, the Pallas kernel that runs
// cuburn_tpu/ops/iterate.py::iterate_step for T steps on state held in
// VMEM and writes a (T, B) log of packed records (it never reached the
// TPU's main path: Mosaic has no atan2).  Its function is the port's
// iterate_step (ops/iterate.py) repeated n_iters times, op for op:
//   select the xform by CDF (row last_xf under xaos) and fetch its row of
//   build_xform_table; the affine; pre_blur; every variation of the
//   key's union in key order at the lane's weight (0 included: w * inf
//   is NaN and respawns the point, and every variation draws for every
//   lane, so the RNG stays in step with the plain version); the post
//   transform and the colour; the badvalue respawn from the selection
//   draw; the final xform on a copy; project_3d (cam_mode 1, and 2 with
//   its two draws); project; the visibility tests; then the record
//   (addr << tot_bits) | quantize_color(cbits, pcolor), with
//   last_xf << cbits under op_bits, or (unpacked) addr, pcolor and the
//   xform's opacity.
//
// What bounds it on the card: arithmetic.  A lane-step of full_feature
// evaluates ~9 variations, two atan2s, a sqrt and some 20 other
// transcendentals and divisions, against 8 bytes of record written (and
// the lane's 40 bytes of state read and written once per launch).
//
// What the design does about it: one thread per trajectory, its state
// in registers for the whole chunk; the per-xform table and the CDF rows
// are a few hundred bytes, staged in shared memory once a block.  The batch caps the
// parallelism (2^17 lanes is ~8 warps a scheduler), so the latency of
// each lane's chain of libm calls is hidden by instruction-level
// parallelism inside the lane or not at all.  Hence the kernel is
// compiled per structure key, as cuburn's IterCode generates one per
// genome: ops/chaos.py key_defines() turns a StructureKey into -D
// definitions (CHAOS_KEY and the lists below), and the union's
// variations, the final xform's, has_post, has_xaos, cam_mode and
// n_xforms become compile-time constants.  The variations of a stack
// are __forceinline__ calls unrolled from a type list, in key order:
// no switch, no loop over ids, so the compiler interleaves independent
// variations and drops every precalc that none of them reads.  The
// library builds with -fmad=false and without --use_fast_math, so every
// float op rounds as PyTorch's does; the libm calls (sinf, atan2f,
// powf, ...) differ from PyTorch's CPU kernels by a few ulps, which the
// chaos game then amplifies: positions agree step by step within
// rounding, renders by distribution.  On the card the kernel is
// bit-exact to the eager loop, which calls the same libdevice functions.
//
// chaos_accumulate queues a whole accumulation from one host call: per
// chunk a chaos_iterate launch and a launch of the flush it is handed
// (scatter_flush.cu's packed_flush_tally, through a function pointer),
// the state ping-ponging between two buffers, then one single-thread
// kernel that folds the chunks' plotted counts into the float32 total.
// It replaces the per-chunk Python of ops/iterate.py (about ten torch
// operations a chunk) where the flush is the unsorted packed one.
//
// Without CHAOS_KEY the source builds the generic library: every
// variation behind a switch for chaos_variation (one variation at n
// points, for the tests) and no chaos_iterate entry at all, so nothing
// can fall back to an interpreted genome.
//
// Built with -DCHAOS_HOST by a host C++ compiler (c++ -x c++), with or
// without a key's definitions, the same lane code runs in plain loops
// behind the same C entries, for the CPU tests; that build has no
// __global__ function.

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef CHAOS_HOST
#define CB_HD inline __attribute__((always_inline))
typedef void* chaos_stream_t;
#else
#include <cuda_runtime.h>
#define CB_HD __host__ __device__ __forceinline__
typedef cudaStream_t chaos_stream_t;
#endif

namespace {

// float32 values of the constants the port writes as Python floats
constexpr float kEps = 0x1.b7cdfep-34f;        // float32(1e-10)
constexpr float kPi = 0x1.921fb6p+1f;          // float32(pi)
constexpr float kTwoPi = 0x1.921fb6p+2f;       // float32(2 pi)
constexpr float kHalfPi = 0x1.921fb6p+0f;      // float32(pi) / 2
constexpr float kQuarterPi = 0x1.921fb6p-1f;   // float32(pi) / 4
constexpr float k1Pi = 0x1.45f306p-2f;         // float32(1 / pi)
constexpr float k2Pi = 0x1.45f306p-1f;         // float32(2 / pi)
constexpr float kDeg2Rad = 0x1.1df46ap-6f;     // float32(pi / 180)
constexpr float kTenth = 0x1.99999ap-4f;       // float32(0.1)
constexpr float kInv24 = 0x1p-24f;
constexpr float kBadValue = 0x1.2a05f2p+33f;   // float32(1e10)

// The registry, in the port's order (ops/variations.py); a variation's
// id is its place here, and chaos_variation_name() gives it to Python.
#define CHAOS_VARIATIONS(X)                                                 \
  X(linear) X(sinusoidal) X(spherical) X(swirl) X(horseshoe) X(polar)       \
  X(handkerchief) X(heart) X(disc) X(spiral) X(hyperbolic) X(diamond)       \
  X(ex) X(julia) X(bent) X(waves) X(fisheye) X(popcorn) X(exponential)      \
  X(power) X(cosine) X(rings) X(fan) X(blob) X(pdj) X(fan2) X(rings2)       \
  X(eyefish) X(bubble) X(cylinder) X(perspective) X(noise) X(julian)        \
  X(juliascope) X(blur) X(gaussian_blur) X(radial_blur) X(pie) X(ngon)      \
  X(curl) X(rectangles) X(arch) X(tangent) X(square) X(rays) X(blade)       \
  X(secant2) X(twintrian) X(cross) X(disc2) X(super_shape) X(flower)        \
  X(conic) X(parabola) X(bent2) X(bipolar) X(boarders) X(butterfly)         \
  X(cell) X(cpow) X(curve) X(edisc) X(elliptic) X(escher) X(foci)           \
  X(lazysusan) X(loonie) X(pre_blur) X(modulus) X(oscilloscope) X(polar2)   \
  X(unpolar) X(popcorn2) X(scry) X(separation) X(split) X(splits)           \
  X(stripes) X(wedge) X(wedge_julia) X(wedge_sph) X(whorl) X(waves2)        \
  X(exp) X(log) X(sin) X(cos) X(tan) X(sec) X(csc) X(cot) X(sinh) X(cosh)   \
  X(tanh) X(sech) X(csch) X(coth) X(auger) X(flux) X(mobius)

enum VariationId {
#define X(name) kVar_##name,
  CHAOS_VARIATIONS(X)
#undef X
  kNumVariations
};

const char* const kVariationNames[] = {
#define X(name) #name,
    CHAOS_VARIATIONS(X)
#undef X
};

CB_HD bool is_finite(float v) {
  uint32_t b;
  memcpy(&b, &v, sizeof b);
  return (b & 0x7f800000u) != 0x7f800000u;
}

CB_HD bool is_nan(float v) { return v != v; }

// torch.clamp(v, min=lo) and torch.maximum(v, lo): NaN propagates
CB_HD float max_nan(float v, float lo) {
  return is_nan(v) ? v : (v < lo ? lo : v);
}

// torch.clamp(v, lo, hi), NaN propagating
CB_HD float clamp_nan(float v, float lo, float hi) {
  return is_nan(v) ? v : (v < lo ? lo : (v > hi ? hi : v));
}

// torch.remainder: the result takes the divisor's sign
CB_HD float torch_remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// torch's `scalar / tensor` is reciprocal(tensor) * scalar
CB_HD float rdiv(float s, float t) { return (1.0f / t) * s; }

// xorshift128, ops/rng.py: one 32-bit word a step
struct Rng {
  uint32_t x, y, z, w;

  CB_HD uint32_t bits() {
    uint32_t t = x ^ (x << 11);
    t ^= t >> 8;
    const uint32_t n = (w ^ (w >> 19)) ^ t;
    x = y;
    y = z;
    z = w;
    w = n;
    return n;
  }

  CB_HD float uniform() { return static_cast<float>(bits() >> 8) * kInv24; }

  // four uniforms summed left to right, minus 2
  CB_HD float gaussian_ish() {
    float s = uniform();
    s = s + uniform();
    s = s + uniform();
    s = s + uniform();
    return s - 2.0f;
  }
};

// the post-affine point and flam3's precalc values (ops/variations.py
// VarCtx): atan is atan2(tx, ty), flam3's argument order
struct Ctx {
  float tx, ty, r2, r, atan, atanyx;
  const float* aff;     // the xform's own affine (a, b, c, d, e, f)
};

CB_HD Ctx make_ctx(float tx, float ty, const float* aff) {
  Ctx c;
  c.tx = tx;
  c.ty = ty;
  c.r2 = tx * tx + ty * ty;
  c.r = sqrtf(c.r2);
  c.atan = atan2f(tx, ty);
  c.atanyx = atan2f(ty, tx);
  c.aff = aff;
  return c;
}

// One flam3 variation: (dx, dy) = its weighted contribution at the
// context's point; `p` is its block of parametric knobs in the order of
// genome/variations.py VARIATION_PARAMS.  Each body is the torch
// expression of ops/variations.py, with its grouping and its draws in
// order, one statement a draw.
#define VARIATION(name)                                                  \
  CB_HD void v_##name(const Ctx& c, float w, const float* p, Rng& rng,    \
                      float& dx, float& dy)

VARIATION(linear) {
  dx = w * c.tx;
  dy = w * c.ty;
}

VARIATION(sinusoidal) {
  dx = w * sinf(c.tx);
  dy = w * sinf(c.ty);
}

VARIATION(spherical) {
  const float s = w / (c.r2 + kEps);
  dx = s * c.tx;
  dy = s * c.ty;
}

VARIATION(swirl) {
  const float sr = sinf(c.r2), cr = cosf(c.r2);
  dx = w * (sr * c.tx - cr * c.ty);
  dy = w * (cr * c.tx + sr * c.ty);
}

VARIATION(horseshoe) {
  const float s = w / (c.r + kEps);
  dx = s * (c.tx - c.ty) * (c.tx + c.ty);
  dy = s * 2.0f * c.tx * c.ty;
}

VARIATION(polar) {
  dx = w * c.atan * k1Pi;
  dy = w * (c.r - 1.0f);
}

VARIATION(handkerchief) {
  dx = w * c.r * sinf(c.atan + c.r);
  dy = w * c.r * cosf(c.atan - c.r);
}

VARIATION(heart) {
  const float a = c.atan * c.r;
  dx = w * c.r * sinf(a);
  dy = -w * c.r * cosf(a);
}

VARIATION(disc) {
  const float a = c.atan * k1Pi * w;
  const float rpi = kPi * c.r;
  dx = a * sinf(rpi);
  dy = a * cosf(rpi);
}

VARIATION(spiral) {
  const float s = w / (c.r + kEps);
  dx = s * (cosf(c.atan) + sinf(c.r));
  dy = s * (sinf(c.atan) - cosf(c.r));
}

VARIATION(hyperbolic) {
  dx = w * sinf(c.atan) / (c.r + kEps);
  dy = w * cosf(c.atan) * c.r;
}

VARIATION(diamond) {
  dx = w * sinf(c.atan) * cosf(c.r);
  dy = w * cosf(c.atan) * sinf(c.r);
}

VARIATION(ex) {
  const float n0 = sinf(c.atan + c.r);
  const float n1 = cosf(c.atan - c.r);
  const float m0 = n0 * n0 * n0 * c.r;
  const float m1 = n1 * n1 * n1 * c.r;
  dx = w * (m0 + m1);
  dy = w * (m0 - m1);
}

VARIATION(julia) {
  const float branch = static_cast<float>(rng.bits() & 1u) * kPi;
  const float a = 0.5f * c.atan + branch;
  const float sr = w * sqrtf(c.r);
  dx = sr * cosf(a);
  dy = sr * sinf(a);
}

VARIATION(bent) {
  const float nx = c.tx < 0.0f ? c.tx * 2.0f : c.tx;
  const float ny = c.ty < 0.0f ? c.ty * 0.5f : c.ty;
  dx = w * nx;
  dy = w * ny;
}

VARIATION(waves) {
  const float b = c.aff[1], cc = c.aff[2], e = c.aff[4], f = c.aff[5];
  const float dx2 = rdiv(1.0f, cc * cc + kEps);
  const float dy2 = rdiv(1.0f, f * f + kEps);
  dx = w * (c.tx + b * sinf(c.ty * dx2));
  dy = w * (c.ty + e * sinf(c.tx * dy2));
}

VARIATION(fisheye) {
  const float s = 2.0f * w / (c.r + 1.0f);
  dx = s * c.ty;
  dy = s * c.tx;
}

VARIATION(popcorn) {
  const float cc = c.aff[2], f = c.aff[5];
  dx = w * (c.tx + cc * sinf(tanf(3.0f * c.ty)));
  dy = w * (c.ty + f * sinf(tanf(3.0f * c.tx)));
}

VARIATION(exponential) {
  const float d = w * expf(c.tx - 1.0f);
  dx = d * cosf(kPi * c.ty);
  dy = d * sinf(kPi * c.ty);
}

VARIATION(power) {
  const float sa = sinf(c.atan);
  const float pw = w * powf(c.r + kEps, sa);
  dx = pw * cosf(c.atan);
  dy = pw * sa;
}

VARIATION(cosine) {
  const float a = c.tx * kPi;
  dx = w * cosf(a) * coshf(c.ty);
  dy = -w * sinf(a) * sinhf(c.ty);
}

VARIATION(rings) {
  const float cc = c.aff[2];
  const float d = cc * cc + kEps;
  const float rr = fmodf(c.r + d, 2.0f * d) - d + c.r * (1.0f - d);
  dx = w * rr * cosf(c.atan);
  dy = w * rr * sinf(c.atan);
}

VARIATION(fan) {
  const float cc = c.aff[2], f = c.aff[5];
  const float d = kPi * (cc * cc + kEps);
  const float d2 = 0.5f * d;
  float a = c.atan;
  a = fmodf(a + f, d) > d2 ? a - d2 : a + d2;
  dx = w * c.r * cosf(a);
  dy = w * c.r * sinf(a);
}

VARIATION(blob) {
  const float lo = p[0], hi = p[1], waves = p[2];
  const float rr =
      c.r * (lo + (hi - lo) * (0.5f + 0.5f * sinf(waves * c.atan)));
  dx = w * rr * sinf(c.atan);
  dy = w * rr * cosf(c.atan);
}

VARIATION(pdj) {
  const float a = p[0], b = p[1], cc = p[2], d = p[3];
  dx = w * (sinf(a * c.ty) - cosf(b * c.tx));
  dy = w * (sinf(cc * c.tx) - cosf(d * c.ty));
}

VARIATION(fan2) {
  const float px = p[0], py = p[1];
  const float d = kPi * (px * px + kEps);
  const float d2 = 0.5f * d;
  float a = c.atan;
  const float t = a + py - d * truncf((a + py) / d);
  a = t > d2 ? a - d2 : a + d2;
  dx = w * c.r * sinf(a);
  dy = w * c.r * cosf(a);
}

VARIATION(rings2) {
  const float val = p[0];
  const float d = val * val + kEps;
  const float rr =
      c.r - 2.0f * d * truncf((c.r + d) / (2.0f * d)) + c.r * (1.0f - d);
  dx = w * rr * sinf(c.atan);
  dy = w * rr * cosf(c.atan);
}

VARIATION(eyefish) {
  const float s = 2.0f * w / (c.r + 1.0f);
  dx = s * c.tx;
  dy = s * c.ty;
}

VARIATION(bubble) {
  const float s = w / (0.25f * c.r2 + 1.0f);
  dx = s * c.tx;
  dy = s * c.ty;
}

VARIATION(cylinder) {
  dx = w * sinf(c.tx);
  dy = w * c.ty;
}

VARIATION(perspective) {
  const float ang = p[0] * kHalfPi;
  const float dist = p[1];
  const float t = rdiv(1.0f, dist - c.ty * sinf(ang) + kEps);
  dx = w * dist * c.tx * t;
  dy = w * dist * cosf(ang) * c.ty * t;
}

VARIATION(noise) {
  const float r1 = rng.uniform();
  const float a = kTwoPi * rng.uniform();
  dx = w * r1 * c.tx * cosf(a);
  dy = w * r1 * c.ty * sinf(a);
}

VARIATION(julian) {
  const float power = p[0], dist = p[1];
  const float t_rnd = truncf(fabsf(power) * rng.uniform());
  const float a = (c.atanyx + kTwoPi * t_rnd) / power;
  const float rr = w * powf(c.r2 + kEps, dist / power * 0.5f);
  dx = rr * cosf(a);
  dy = rr * sinf(a);
}

VARIATION(juliascope) {
  const float power = p[0], dist = p[1];
  const float t_rnd = truncf(fabsf(power) * rng.uniform());
  const bool parity_even = torch_remainder(t_rnd, 2.0f) < 0.5f;
  const float signed_atan = parity_even ? c.atanyx : -c.atanyx;
  const float a = (kTwoPi * t_rnd + signed_atan) / power;
  const float rr = w * powf(c.r2 + kEps, dist / power * 0.5f);
  dx = rr * cosf(a);
  dy = rr * sinf(a);
}

VARIATION(blur) {
  const float r1 = rng.uniform() * w;
  const float a = kTwoPi * rng.uniform();
  dx = r1 * cosf(a);
  dy = r1 * sinf(a);
}

VARIATION(gaussian_blur) {
  const float g = w * rng.gaussian_ish();
  const float a = kTwoPi * rng.uniform();
  dx = g * cosf(a);
  dy = g * sinf(a);
}

VARIATION(radial_blur) {
  const float ang = p[0] * kHalfPi;
  const float spin = sinf(ang), zoom = cosf(ang);
  const float g = w * rng.gaussian_ish();
  const float a = c.atanyx + spin * g;
  const float rz = zoom * g - 1.0f;
  dx = c.r * cosf(a) + rz * c.tx;
  dy = c.r * sinf(a) + rz * c.ty;
}

VARIATION(pie) {
  const float slices = p[0], rot = p[1], thick = p[2];
  const float sl = truncf(rng.uniform() * slices + 0.5f);
  const float u = rng.uniform();
  const float a = rot + kTwoPi * (sl + u * thick) / slices;
  const float rr = w * rng.uniform();
  dx = rr * cosf(a);
  dy = rr * sinf(a);
}

VARIATION(ngon) {
  const float sides = p[0], power = p[1], circle = p[2], corners = p[3];
  const float cpower = -0.5f * power;
  const float csides = rdiv(kTwoPi, sides);
  const float csidesinv = rdiv(1.0f, csides);
  const float rfac = powf(c.r2 + kEps, cpower);
  float phi = c.atanyx - csides * floorf(c.atanyx * csidesinv);
  phi = phi > 0.5f * csides ? phi - csides : phi;
  const float amp =
      (corners * (rdiv(1.0f, cosf(phi) + kEps) - 1.0f) + circle) * w * rfac;
  dx = amp * c.tx;
  dy = amp * c.ty;
}

VARIATION(curl) {
  const float c1 = p[0], c2 = p[1];
  const float re = 1.0f + c1 * c.tx + c2 * (c.tx * c.tx - c.ty * c.ty);
  const float im = c1 * c.ty + 2.0f * c2 * c.tx * c.ty;
  const float s = w / (re * re + im * im + kEps);
  dx = s * (c.tx * re + c.ty * im);
  dy = s * (c.ty * re - c.tx * im);
}

VARIATION(rectangles) {
  const float px = p[0], py = p[1];
  const float nx =
      fabsf(px) < kEps
          ? c.tx
          : (2.0f * floorf(c.tx / px) + 1.0f) * px - c.tx;
  const float ny =
      fabsf(py) < kEps
          ? c.ty
          : (2.0f * floorf(c.ty / py) + 1.0f) * py - c.ty;
  dx = w * nx;
  dy = w * ny;
}

VARIATION(arch) {
  const float ang = rng.uniform() * w * kPi;
  const float sa = sinf(ang), ca = cosf(ang);
  dx = w * sa;
  dy = w * sa * sa / (ca + kEps);
}

VARIATION(tangent) {
  dx = w * sinf(c.tx) / (cosf(c.ty) + kEps);
  dy = w * tanf(c.ty);
}

VARIATION(square) {
  const float u = rng.uniform();
  dx = w * (u - 0.5f);
  const float v = rng.uniform();
  dy = w * (v - 0.5f);
}

VARIATION(rays) {
  const float ang = w * rng.uniform() * kPi;
  const float rr = w / (c.r2 + kEps);
  const float tanr = w * tanf(ang) * rr;
  dx = tanr * cosf(c.tx);
  dy = tanr * sinf(c.ty);
}

VARIATION(blade) {
  const float rr = rng.uniform() * w * c.r;
  const float sr = sinf(rr), cr = cosf(rr);
  dx = w * c.tx * (cr + sr);
  dy = w * c.tx * (cr - sr);
}

VARIATION(secant2) {
  const float cr = cosf(w * c.r);
  const float safe = cr < 0.0f ? -kEps : kEps;
  const float icr = rdiv(1.0f, fabsf(cr) < kEps ? safe : cr);
  dx = w * c.tx;
  dy = cr < 0.0f ? w * (icr + 1.0f) : w * (icr - 1.0f);
}

VARIATION(twintrian) {
  const float rr = rng.uniform() * w * c.r;
  const float sr = sinf(rr), cr = cosf(rr);
  float diff = log10f(sr * sr + kEps) + cr;
  diff = is_finite(diff) ? diff : -30.0f;
  dx = w * c.tx * diff;
  dy = w * c.tx * (diff - sr * kPi);
}

VARIATION(cross) {
  const float d = c.tx * c.tx - c.ty * c.ty;
  const float s = w * sqrtf(rdiv(1.0f, d * d + kEps));
  dx = s * c.tx;
  dy = s * c.ty;
}

VARIATION(disc2) {
  const float rot = p[0], twist = p[1];
  const float timespi = rot * kPi;
  float sinadd = sinf(twist), cosadd = cosf(twist) - 1.0f;
  const float k_hi = twist > kTwoPi ? 1.0f + twist - kTwoPi : 1.0f;
  const float k_lo = twist < -kTwoPi ? 1.0f + twist + kTwoPi : 1.0f;
  sinadd = sinadd * k_hi * k_lo;
  cosadd = cosadd * k_hi * k_lo;
  const float t = timespi * (c.tx + c.ty);
  const float rr = w * c.atan * k1Pi;
  dx = rr * (sinf(t) + cosadd);
  dy = rr * (cosf(t) + sinadd);
}

VARIATION(super_shape) {
  const float rnd = p[0], m = p[1], n1 = p[2], n2 = p[3], n3 = p[4],
              holes = p[5];
  const float theta = (m / 4.0f) * c.atanyx + kQuarterPi;
  const float t1 = powf(fabsf(cosf(theta)) + kEps, n2);
  const float t2 = powf(fabsf(sinf(theta)) + kEps, n3);
  const float u = rng.uniform();
  const float mix = rnd * u + (1.0f - rnd) * c.r;
  const float rr =
      w * (mix - holes) * powf(t1 + t2, rdiv(-1.0f, n1)) / (c.r + kEps);
  dx = rr * c.tx;
  dy = rr * c.ty;
}

VARIATION(flower) {
  const float petals = p[0], holes = p[1];
  const float u = rng.uniform();
  const float rr = w * (u - holes) * cosf(petals * c.atanyx) / (c.r + kEps);
  dx = rr * c.tx;
  dy = rr * c.ty;
}

VARIATION(conic) {
  const float ecc = p[0], holes = p[1];
  const float ct = c.tx / (c.r + kEps);
  const float u = rng.uniform();
  const float rr =
      w * (u - holes) * ecc / (1.0f + ecc * ct + kEps) / (c.r + kEps);
  dx = rr * c.tx;
  dy = rr * c.ty;
}

VARIATION(parabola) {
  const float h = p[0], wd = p[1];
  const float sr = sinf(c.r), cr = cosf(c.r);
  const float u = rng.uniform();
  dx = h * w * sr * sr * u;
  const float v = rng.uniform();
  dy = wd * w * cr * v;
}

VARIATION(bent2) {
  const float px = p[0], py = p[1];
  const float nx = c.tx < 0.0f ? c.tx * px : c.tx;
  const float ny = c.ty < 0.0f ? c.ty * py : c.ty;
  dx = w * nx;
  dy = w * ny;
}

VARIATION(bipolar) {
  const float shift = p[0];
  const float x2y2 = c.r2;
  const float t = x2y2 + 1.0f;
  const float x2 = 2.0f * c.tx;
  const float ps = -kHalfPi * shift;
  float y = 0.5f * atan2f(2.0f * c.ty, x2y2 - 1.0f) + ps;
  y = y > kHalfPi ? -kHalfPi + fmodf(y + kHalfPi, kPi) : y;
  y = y < -kHalfPi ? kHalfPi - fmodf(kHalfPi - y, kPi) : y;
  const float num = max_nan(t + x2, kEps);
  const float den = max_nan(t - x2, kEps);
  dx = w * 0.25f * k2Pi * logf(num / den);
  dy = w * k2Pi * y;
}

VARIATION(boarders) {
  const float rx = rintf(c.tx), ry = rintf(c.ty);
  const float ox = c.tx - rx, oy = c.ty - ry;
  const float in_x = ox * 0.5f + rx;
  const float in_y = oy * 0.5f + ry;
  const bool absx_ge = fabsf(ox) >= fabsf(oy);
  const float sx = ox >= 0.0f ? 0.25f : -0.25f;
  const float sy = oy >= 0.0f ? 0.25f : -0.25f;
  const float safe_ox = fabsf(ox) < kEps ? kEps : ox;
  const float safe_oy = fabsf(oy) < kEps ? kEps : oy;
  const float ex_x = absx_ge ? ox * 0.5f + rx + sx
                             : ox * 0.5f + rx + sy * ox / safe_oy;
  const float ex_y = absx_ge ? oy * 0.5f + ry + sx * oy / safe_ox
                             : oy * 0.5f + ry + sy;
  const bool inner = rng.uniform() >= 0.75f;
  dx = w * (inner ? in_x : ex_x);
  dy = w * (inner ? in_y : ex_y);
}

VARIATION(butterfly) {
  const float wx = w * 0x1.4d8d7ap+0f;    // float32(1.3029400317...)
  const float y2 = 2.0f * c.ty;
  const float rr =
      wx * sqrtf(fabsf(c.tx * c.ty) / (kEps + c.tx * c.tx + y2 * y2));
  dx = rr * c.tx;
  dy = rr * y2;
}

VARIATION(cell) {
  const float size = p[0];
  const float inv = rdiv(1.0f, fabsf(size) < kEps ? kEps : size);
  const float x = floorf(c.tx * inv);
  const float y = floorf(c.ty * inv);
  const float ddx = c.tx - x * size;
  const float ddy = c.ty - y * size;
  const float x2 = x >= 0.0f ? 2.0f * x : -(2.0f * x + 1.0f);
  const float y2 = y >= 0.0f ? 2.0f * y : -(2.0f * y + 1.0f);
  dx = w * (ddx + x2 * size);
  dy = -w * (ddy + y2 * size);
}

VARIATION(cpow) {
  const float pr = p[0], pi = p[1], power = p[2];
  const float a = c.atanyx;
  const float lnr = 0.5f * logf(c.r2 + kEps);
  const float va = rdiv(kTwoPi, power);
  const float vc = pr / power;
  const float vd = pi / power;
  const float u = rng.uniform();
  const float ang = vc * a + vd * lnr + va * floorf(power * u);
  const float m = w * expf(vc * lnr - vd * a);
  dx = m * cosf(ang);
  dy = m * sinf(ang);
}

VARIATION(curve) {
  const float xa = p[0], ya = p[1], xl = p[2], yl = p[3];
  const float pc_xlen = max_nan(xl * xl, 0x1.79ca10p-67f);  // f32(1e-20)
  const float pc_ylen = max_nan(yl * yl, 0x1.79ca10p-67f);
  dx = w * (c.tx + xa * expf(-c.ty * c.ty / pc_xlen));
  dy = w * (c.ty + ya * expf(-c.tx * c.tx / pc_ylen));
}

VARIATION(edisc) {
  const float tmp = c.r2 + 1.0f;
  const float tmp2 = 2.0f * c.tx;
  const float r1 = sqrtf(max_nan(tmp + tmp2, 0.0f));
  const float r2 = sqrtf(max_nan(tmp - tmp2, 0.0f));
  const float xmax = 0.5f * (r1 + r2);
  const float a1 = logf(xmax + sqrtf(max_nan(xmax - 1.0f, 0.0f)));
  const float a2 =
      -acosf(clamp_nan(c.tx / max_nan(xmax, kEps), -1.0f, 1.0f));
  const float ww = w / 0x1.724046p+3f;    // float32(11.57034632)
  const float snv = c.ty > 0.0f ? -sinf(a1) : sinf(a1);
  dx = ww * coshf(a2) * cosf(a1);
  dy = ww * sinhf(a2) * snv;
}

VARIATION(elliptic) {
  const float tmp = c.r2 + 1.0f;
  const float x2 = 2.0f * c.tx;
  const float xmax = 0.5f * (sqrtf(max_nan(tmp + x2, 0.0f)) +
                             sqrtf(max_nan(tmp - x2, 0.0f)));
  const float a = c.tx / max_nan(xmax, kEps);
  const float b = sqrtf(max_nan(1.0f - a * a, 0.0f));
  const float ssx = sqrtf(max_nan(xmax - 1.0f, 0.0f));
  const float ww = w * k2Pi;
  const float d = ww * logf(xmax + ssx);
  dx = ww * atan2f(a, b);
  dy = c.ty > 0.0f ? d : -d;
}

VARIATION(escher) {
  const float beta = p[0];
  const float a = c.atanyx;
  const float lnr = 0.5f * logf(c.r2 + kEps);
  const float seb = sinf(beta), ceb = cosf(beta);
  const float vc = 0.5f * (1.0f + ceb);
  const float vd = 0.5f * seb;
  const float m = w * expf(vc * lnr - vd * a);
  const float n = vc * a + vd * lnr;
  dx = m * cosf(n);
  dy = m * sinf(n);
}

VARIATION(foci) {
  const float expx = 0.5f * expf(c.tx);
  const float expnx = rdiv(0.25f, max_nan(expx, kEps));
  const float sn = sinf(c.ty), cn = cosf(c.ty);
  const float d = expx + expnx - cn;
  const float tmp = w / (fabsf(d) < kEps ? kEps : d);
  dx = tmp * (expx - expnx);
  dy = tmp * sn;
}

VARIATION(lazysusan) {
  const float spin = p[0], space = p[1], twist = p[2], lx = p[3],
              ly = p[4];
  const float x = c.tx - lx;
  const float y = c.ty + ly;
  const float rr = sqrtf(x * x + y * y);
  const bool inside = rr < w;
  const float a = atan2f(y, x) + spin + twist * (w - rr);
  // weight-independent offsets gated on an active variation
  const float active = w != 0.0f ? 1.0f : 0.0f;
  const float r_in = w * rr;
  const float dx_in = r_in * cosf(a) + active * lx;
  const float dy_in = r_in * sinf(a) - active * ly;
  const float r_out = w * (1.0f + space / (rr + kEps));
  const float dx_out = r_out * x + active * lx;
  const float dy_out = r_out * y - active * ly;
  dx = inside ? dx_in : dx_out;
  dy = inside ? dy_in : dy_out;
}

VARIATION(loonie) {
  const float w2 = w * w;
  const bool inside = c.r2 < w2;
  const float rr = w * sqrtf(max_nan(w2 / max_nan(c.r2, kEps) - 1.0f, 0.0f));
  const float s = inside ? rr : w;
  dx = s * c.tx;
  dy = s * c.ty;
}

// a pre-transform (variation_stack); as a variation it adds nothing
VARIATION(pre_blur) {
  dx = 0.0f;
  dy = 0.0f;
}

VARIATION(modulus) {
  const float mx = p[0], my = p[1];
  const float xr = 2.0f * mx;
  const float yr = 2.0f * my;
  const float safe_xr = fabsf(xr) < kEps ? 1.0f : xr;
  const float safe_yr = fabsf(yr) < kEps ? 1.0f : yr;
  const float nx = c.tx > mx    ? -mx + fmodf(c.tx + mx, safe_xr)
                   : c.tx < -mx ? mx - fmodf(mx - c.tx, safe_xr)
                                : c.tx;
  const float ny = c.ty > my    ? -my + fmodf(c.ty + my, safe_yr)
                   : c.ty < -my ? my - fmodf(my - c.ty, safe_yr)
                                : c.ty;
  dx = w * nx;
  dy = w * ny;
}

VARIATION(oscilloscope) {
  const float sep = p[0], freq = p[1], amp = p[2], damp = p[3];
  const float tpf = kTwoPi * freq;
  const float t =
      fabsf(damp) < kEps
          ? amp * cosf(tpf * c.tx) + sep
          : amp * expf(-fabsf(c.tx) * damp) * cosf(tpf * c.tx) + sep;
  const float ny = fabsf(c.ty) <= t ? -c.ty : c.ty;
  dx = w * c.tx;
  dy = w * ny;
}

VARIATION(polar2) {
  const float vvar = w * k1Pi;
  dx = vvar * c.atan;
  dy = 0.5f * vvar * logf(c.r2 + kEps);
}

VARIATION(unpolar) {
  const float a = kPi * c.tx;
  const float rr = c.ty + 1.0f;
  dx = w * rr * sinf(a);
  dy = w * rr * cosf(a);
}

VARIATION(popcorn2) {
  const float px = p[0], py = p[1], pc = p[2];
  dx = w * (c.tx + px * sinf(tanf(c.ty * pc)));
  dy = w * (c.ty + py * sinf(tanf(c.tx * pc)));
}

VARIATION(scry) {
  const float t = c.r2;
  const float rr =
      rdiv(1.0f, max_nan(c.r * (t + rdiv(1.0f, w + kEps)), kEps));
  dx = rr * c.tx;
  dy = rr * c.ty;
}

VARIATION(separation) {
  const float sx = p[0] * p[0], xin = p[1];
  const float sy = p[2] * p[2], yin = p[3];
  const float nx = c.tx > 0.0f ? sqrtf(c.tx * c.tx + sx) - c.tx * xin
                               : -(sqrtf(c.tx * c.tx + sx) + c.tx * xin);
  const float ny = c.ty > 0.0f ? sqrtf(c.ty * c.ty + sy) - c.ty * yin
                               : -(sqrtf(c.ty * c.ty + sy) + c.ty * yin);
  dx = w * nx;
  dy = w * ny;
}

VARIATION(split) {
  const float xs = p[0], ys = p[1];
  dy = cosf(c.tx * xs * kPi) >= 0.0f ? w * c.ty : -w * c.ty;
  dx = cosf(c.ty * ys * kPi) >= 0.0f ? w * c.tx : -w * c.tx;
}

VARIATION(splits) {
  const float px = p[0], py = p[1];
  dx = w * (c.tx >= 0.0f ? c.tx + px : c.tx - px);
  dy = w * (c.ty >= 0.0f ? c.ty + py : c.ty - py);
}

VARIATION(stripes) {
  const float space = p[0], warp = p[1];
  const float rx = floorf(c.tx + 0.5f);
  const float ox = c.tx - rx;
  dx = w * (ox * (1.0f - space) + rx);
  dy = w * (c.ty + ox * ox * warp);
}

VARIATION(wedge) {
  const float angle = p[0], hole = p[1], count = p[2], swirl = p[3];
  float rr = c.r;
  float a = c.atanyx + swirl * rr;
  const float cc = floorf((count * a + kPi) * k1Pi * 0.5f);
  const float comp = 1.0f - angle * count * k1Pi * 0.5f;
  a = a * comp + cc * angle;
  rr = w * (rr + hole);
  dx = rr * cosf(a);
  dy = rr * sinf(a);
}

VARIATION(wedge_julia) {
  const float angle = p[0], count = p[1], power = p[2], dist = p[3];
  const float cf = 1.0f - angle * count * k1Pi * 0.5f;
  const float rn = fabsf(power);
  const float cn = dist / power / 2.0f;
  const float rr = w * powf(c.r2 + kEps, cn);
  const float t_rnd = truncf(rn * rng.uniform());
  float a = (c.atanyx + kTwoPi * t_rnd) / power;
  const float cc = floorf((count * a + kPi) * k1Pi * 0.5f);
  a = a * cf + cc * angle;
  dx = rr * cosf(a);
  dy = rr * sinf(a);
}

VARIATION(wedge_sph) {
  const float angle = p[0], count = p[1], hole = p[2], swirl = p[3];
  float rr = rdiv(1.0f, c.r + kEps);
  float a = c.atanyx + swirl * rr;
  const float cc = floorf((count * a + kPi) * k1Pi * 0.5f);
  const float comp = 1.0f - angle * count * k1Pi * 0.5f;
  a = a * comp + cc * angle;
  rr = w * (rr + hole);
  dx = rr * cosf(a);
  dy = rr * sinf(a);
}

VARIATION(whorl) {
  const float inside = p[0], outside = p[1];
  float denom = w - c.r;
  denom = fabsf(denom) < kEps ? (denom < 0.0f ? -kEps : kEps) : denom;
  const float a =
      c.atanyx + (c.r < w ? inside / denom : outside / denom);
  dx = w * c.r * cosf(a);
  dy = w * c.r * sinf(a);
}

VARIATION(waves2) {
  const float fx = p[0], sx = p[1], fy = p[2], sy = p[3];
  dx = w * (c.tx + sx * sinf(c.ty * fx));
  dy = w * (c.ty + sy * sinf(c.tx * fy));
}

VARIATION(exp) {
  const float e = w * expf(c.tx);
  dx = e * cosf(c.ty);
  dy = e * sinf(c.ty);
}

VARIATION(log) {
  dx = w * 0.5f * logf(c.r2 + kEps);
  dy = w * c.atanyx;
}

VARIATION(sin) {
  dx = w * sinf(c.tx) * coshf(c.ty);
  dy = w * cosf(c.tx) * sinhf(c.ty);
}

VARIATION(cos) {
  dx = w * cosf(c.tx) * coshf(c.ty);
  dy = -w * sinf(c.tx) * sinhf(c.ty);
}

// the guarded denominator of the complex trig family
CB_HD float guard(float d) { return fabsf(d) < kEps ? kEps : d; }

VARIATION(tan) {
  const float den = w / guard(cosf(2.0f * c.tx) + coshf(2.0f * c.ty));
  dx = den * sinf(2.0f * c.tx);
  dy = den * sinhf(2.0f * c.ty);
}

VARIATION(sec) {
  const float den =
      2.0f * w / guard(cosf(2.0f * c.tx) + coshf(2.0f * c.ty));
  dx = den * cosf(c.tx) * coshf(c.ty);
  dy = den * sinf(c.tx) * sinhf(c.ty);
}

VARIATION(csc) {
  const float den =
      2.0f * w / guard(coshf(2.0f * c.ty) - cosf(2.0f * c.tx));
  dx = den * sinf(c.tx) * coshf(c.ty);
  dy = -den * cosf(c.tx) * sinhf(c.ty);
}

VARIATION(cot) {
  const float den = w / guard(coshf(2.0f * c.ty) - cosf(2.0f * c.tx));
  dx = den * sinf(2.0f * c.tx);
  dy = -den * sinhf(2.0f * c.ty);
}

VARIATION(sinh) {
  dx = w * sinhf(c.tx) * cosf(c.ty);
  dy = w * coshf(c.tx) * sinf(c.ty);
}

VARIATION(cosh) {
  dx = w * coshf(c.tx) * cosf(c.ty);
  dy = w * sinhf(c.tx) * sinf(c.ty);
}

VARIATION(tanh) {
  const float den = w / guard(cosf(2.0f * c.ty) + coshf(2.0f * c.tx));
  dx = den * sinhf(2.0f * c.tx);
  dy = den * sinf(2.0f * c.ty);
}

VARIATION(sech) {
  const float den =
      2.0f * w / guard(cosf(2.0f * c.ty) + coshf(2.0f * c.tx));
  dx = den * cosf(c.ty) * coshf(c.tx);
  dy = -den * sinf(c.ty) * sinhf(c.tx);
}

VARIATION(csch) {
  const float den =
      2.0f * w / guard(coshf(2.0f * c.tx) - cosf(2.0f * c.ty));
  dx = den * sinhf(c.tx) * cosf(c.ty);
  dy = -den * coshf(c.tx) * sinf(c.ty);
}

VARIATION(coth) {
  const float den = w / guard(coshf(2.0f * c.tx) - cosf(2.0f * c.ty));
  dx = den * sinhf(2.0f * c.tx);
  dy = den * sinf(2.0f * c.ty);
}

VARIATION(auger) {
  const float sym = p[0], aw = p[1], freq = p[2], scale = p[3];
  const float s = sinf(freq * c.tx);
  const float t = sinf(freq * c.ty);
  const float ddy = c.ty + aw * (scale * s * 0.5f + fabsf(c.ty) * s);
  const float ddx = c.tx + aw * (scale * t * 0.5f + fabsf(c.tx) * t);
  dx = w * (c.tx + sym * (ddx - c.tx));
  dy = w * ddy;
}

VARIATION(flux) {
  const float spread = p[0];
  const float xpw = c.tx + w;
  const float xmw = c.tx - w;
  const float num = sqrtf(c.ty * c.ty + xpw * xpw);
  const float den = sqrtf(c.ty * c.ty + xmw * xmw);
  const float avgr = w * (2.0f + spread) * sqrtf(num / max_nan(den, kEps));
  const float avga = (atan2f(c.ty, xmw) - atan2f(c.ty, xpw)) * 0.5f;
  dx = avgr * cosf(avga);
  dy = avgr * sinf(avga);
}

VARIATION(mobius) {
  const float ra = p[0], ia = p[1], rb = p[2], ib = p[3], rc = p[4],
              ic = p[5], rd = p[6], id = p[7];
  const float re_u = ra * c.tx - ia * c.ty + rb;
  const float im_u = ra * c.ty + ia * c.tx + ib;
  const float re_v = rc * c.tx - ic * c.ty + rd;
  const float im_v = rc * c.ty + ic * c.tx + id;
  const float rad = w / (re_v * re_v + im_v * im_v + kEps);
  dx = rad * (re_u * re_v + im_u * im_v);
  dy = rad * (im_u * re_v - re_u * im_v);
}

#undef VARIATION

// ops/xform.py apply_variation_stack: pre_blur moves the point first,
// then every other variation of the list adds its term, in list order.
// The list is a structure key's, a type: Stack<0, Ints<id...>,
// Ints<knob offset...>> unrolls it, the K-th entry reading weights[K].
template <int... I> struct Ints {};

template <int K, class Ids, class Pars> struct Stack;

template <int K> struct Stack<K, Ints<>, Ints<>> {
  static CB_HD void pre_blur(const float*, Rng&, float&, float&) {}
  static CB_HD void add(const Ctx&, const float*, const float*, Rng&,
                        float&, float&) {}
};

template <int K, int Id, int... Ids, int Par, int... Pars>
struct Stack<K, Ints<Id, Ids...>, Ints<Par, Pars...>> {
  using Rest = Stack<K + 1, Ints<Ids...>, Ints<Pars...>>;

  static CB_HD void pre_blur(const float* weights, Rng& rng, float& tx,
                             float& ty) {
    if constexpr (Id == kVar_pre_blur) {
      const float g = weights[K] * rng.gaussian_ish();
      const float a = kTwoPi * rng.uniform();
      tx = tx + g * cosf(a);
      ty = ty + g * sinf(a);
    }
    Rest::pre_blur(weights, rng, tx, ty);
  }

  static CB_HD void add(const Ctx& c, const float* weights,
                        const float* params, Rng& rng, float& ox,
                        float& oy) {
    if constexpr (Id != kVar_pre_blur) {
      float dx, dy;
#define X(name)                   \
  if constexpr (Id == kVar_##name) \
    v_##name(c, weights[K], params + Par, rng, dx, dy);
      CHAOS_VARIATIONS(X)
#undef X
      ox = ox + dx;
      oy = oy + dy;
    }
    Rest::add(c, weights, params, rng, ox, oy);
  }
};

template <class Ids, class Pars>
CB_HD void variation_stack(const float* weights, const float* params,
                           const float* aff, float tx, float ty, Rng& rng,
                           float& ox, float& oy) {
  Stack<0, Ids, Pars>::pre_blur(weights, rng, tx, ty);
  const Ctx c = make_ctx(tx, ty, aff);
  ox = 0.0f;
  oy = 0.0f;
  Stack<0, Ids, Pars>::add(c, weights, params, rng, ox, oy);
}

}  // namespace

// Offsets into ChaosArgs::scal, the float scalars of one genome
// evaluation; the final xform's weights and knobs follow at kScalFixed.
enum ScalOffset {
  kFinalAffine = 0, kFinalPost = 6, kFinalColor = 12, kFinalSpeed = 13,
  kCenter = 14, kRotCenter = 16, kPpu = 18, kRotate = 19, kCam3d = 20,
  kScalFixed = 25
};

// What one launch reads at run time: mirrored field for field by
// ops/chaos.py ChaosArgs (ctypes), passed by value as the kernel's
// parameter.  The state, the outputs and the genome evaluation's tables
// as device pointers (host pointers in the host build), the camera and
// the record layout as ints; the structure key is compiled in.  Nothing
// here needs a sync to fill.
struct ChaosArgs {
  const float* x;
  const float* y;
  const float* color;
  const int64_t* last_xf;
  const int64_t* age;
  const int64_t* rng;             // (batch, 4) u32 words
  float* x_out;
  float* y_out;
  float* color_out;
  int64_t* last_xf_out;
  int64_t* age_out;
  int64_t* rng_out;
  int64_t* rec;                   // (n_iters, batch) records or addresses
  float* pcolor;                  // (n_iters, batch), unpacked mode
  float* opacity;                 // (n_iters, batch), unpacked mode
  const float* table;             // (n_xforms, n_cols) build_xform_table
  const float* cdf;               // (n_xforms, n_xforms) xform_cdf_rows
  const float* scal;              // ScalOffset layout
  int batch, n_iters;
  int no_rotation, ss, acc_width, acc_height, full_acc_height;
  int tile_row0, junk_bin, fuse, cbits, tot_bits, op_bits, unpacked;
};

// A chunk's trajectories in ChaosArgs's order: the state one chunk
// writes and the next reads (chaos_accumulate's second buffer).
struct StateBuf {
  float* x;
  float* y;
  float* color;
  int64_t* last_xf;
  int64_t* age;
  int64_t* rng;
};

// The flush chaos_accumulate launches after each chunk: scatter_flush.cu's
// packed_flush_tally, reached through a pointer to its C entry, so the
// flush has one build.  It adds weight * pal4[q] of every record into
// hist and the chunk's plotted count into *count, and returns
// cudaGetLastError().
typedef int (*TallyFlush)(const int64_t* recs, int64_t n, const float* pal4,
                          int cbits, int64_t n_bins, float weight,
                          float* hist, int64_t* count,
                          chaos_stream_t stream);

// One variation alone at n points, for the tests: tx, ty, w per point,
// the variation's knobs and the affine shared; the RNG words advance in
// place.
struct VariationArgs {
  const float* tx;
  const float* ty;
  const float* w;
  const float* params;
  const float* aff;
  int64_t* rng;
  float* dx;
  float* dy;
  int n, id;
};

namespace {

CB_HD void affine(const float* m, float x, float y, float& ox, float& oy) {
  ox = m[0] * x + m[1] * y + m[2];
  oy = m[3] * x + m[4] * y + m[5];
}

#ifdef CHAOS_KEY
// -- the structure key, compile-time -------------------------------------
// ops/chaos.py key_defines() gives:
//   CHAOS_N_XFORMS, CHAOS_N_COLS (the table's columns), CHAOS_HAS_POST,
//   CHAOS_HAS_XAOS, CHAOS_CAM_MODE;
//   CHAOS_VARS, CHAOS_VAR_PARS: the union in key order, V(name) each,
//     and the offset of each one's first knob in the row's knobs, O(n)
//     each (no commas: nvcc splits a -D value at its commas);
//   CHAOS_HAS_FINAL, CHAOS_FINAL_HAS_POST, CHAOS_FINAL_VARS,
//     CHAOS_FINAL_PARS: the final xform's, the same way.
template <int... I, int J>
constexpr Ints<I..., J> operator+(Ints<I...>, Ints<J>) {
  return {};
}

#define V(name) +Ints<kVar_##name>{}
#define O(n) +Ints<n>{}
using UnionIds = decltype(Ints<>{} CHAOS_VARS);
using UnionPars = decltype(Ints<>{} CHAOS_VAR_PARS);
using FinalIds = decltype(Ints<>{} CHAOS_FINAL_VARS);
using FinalPars = decltype(Ints<>{} CHAOS_FINAL_PARS);
#undef V
#undef O

template <int... I>
constexpr int length(Ints<I...>) {
  return sizeof...(I);
}

constexpr int kNXforms = CHAOS_N_XFORMS;
constexpr int kNCols = CHAOS_N_COLS;
constexpr bool kHasPost = CHAOS_HAS_POST;
constexpr bool kHasXaos = CHAOS_HAS_XAOS;
constexpr int kCamMode = CHAOS_CAM_MODE;
constexpr bool kHasFinal = CHAOS_HAS_FINAL;
constexpr bool kFinalHasPost = CHAOS_FINAL_HAS_POST;
// build_xform_table's columns: affine 0:6, colour, speed, opacity, post
// 9:15 when has_post, the union's weights, its knobs
constexpr int kPostCol = 9;
constexpr int kWCol = kHasPost ? 15 : 9;
constexpr int kPCol = kWCol + length(UnionIds{});
constexpr int kFinalWCol = kScalFixed;
constexpr int kFinalPCol = kScalFixed + length(FinalIds{});
static_assert(length(UnionIds{}) == length(UnionPars{}) &&
                  length(FinalIds{}) == length(FinalPars{}),
              "an offset for every variation");
static_assert(kNXforms >= 1 && kNCols > kPCol, "a table row per xform");

// ops/camera.py project: the accumulator address, or the junk bin when
// the point falls outside the (stripe's) accumulator
CB_HD int64_t project(const ChaosArgs& a, float x, float y) {
  const float* s = a.scal;
  const float cx = s[kCenter], cy = s[kCenter + 1];
  float rx, ry;
  if (a.no_rotation) {
    rx = x - cx;
    ry = y - cy;
  } else {
    const float rcx = s[kRotCenter], rcy = s[kRotCenter + 1];
    const float dx = x - rcx, dy = y - rcy;
    const float theta = -s[kRotate] * kDeg2Rad;
    const float ct = cosf(theta), st = sinf(theta);
    rx = ct * dx - st * dy + (rcx - cx);
    ry = st * dx + ct * dy + (rcy - cy);
  }
  const float ppu_ss = s[kPpu] * static_cast<float>(a.ss);
  const int full_h = a.full_acc_height ? a.full_acc_height : a.acc_height;
  const float px = rx * ppu_ss + static_cast<float>(a.acc_width * 0.5);
  const float py = ry * ppu_ss + static_cast<float>(full_h * 0.5);
  const bool in_bounds =
      px >= 0.0f && px < static_cast<float>(a.acc_width) &&
      py >= static_cast<float>(a.tile_row0) &&
      py < static_cast<float>(a.tile_row0 + a.acc_height);
  if (!in_bounds) return a.junk_bin;
  const int64_t ix = static_cast<int64_t>(floorf(px));
  const int64_t iy = static_cast<int64_t>(floorf(py)) - a.tile_row0;
  return iy * a.acc_width + ix;
}

// ops/camera.py project_3d, with the depth-of-field pair drawn under
// cam_mode 2
CB_HD void project_3d(const float* cam3d, Rng& rng, float& x, float& y) {
  const float yaw = cam3d[0], pitch = cam3d[1], persp = cam3d[2],
              zpos = cam3d[3], dof = cam3d[4];
  const float z = -zpos;
  const float cy = cosf(yaw), sy = sinf(yaw);
  const float cp = cosf(pitch), sp = sinf(pitch);
  float x1 = x * cy + y * sy;
  const float y1 = y * cy - x * sy;
  float y2 = y1 * cp - z * sp;
  const float depth = y1 * sp + z * cp;
  const float zr = 1.0f - persp * depth;
  if constexpr (kCamMode >= 2) {
    const float u1 = rng.uniform();
    const float u2 = rng.uniform();
    const float dr = u1 * (kTenth * dof * z);
    const float t = u2 * kTwoPi;
    x1 = x1 + dr * cosf(t);
    y2 = y2 + dr * sinf(t);
  }
  x = x1 / zr;
  y = y2 / zr;
}

// n_iters chaos-game steps of one trajectory (ops/iterate.py
// iterate_step), its state in registers, one record a step
CB_HD void chaos_lane(const ChaosArgs& a, int lane) {
  const float* s = a.scal;
  float x = a.x[lane], y = a.y[lane], color = a.color[lane];
  int last = static_cast<int>(a.last_xf[lane]);
  int64_t age = a.age[lane];
  const int64_t* rw = a.rng + 4 * static_cast<int64_t>(lane);
  Rng rng = {static_cast<uint32_t>(rw[0]), static_cast<uint32_t>(rw[1]),
             static_cast<uint32_t>(rw[2]), static_cast<uint32_t>(rw[3])};
  const float levels = static_cast<float>((1 << a.cbits) - 1);
  for (int k = 0; k < a.n_iters; ++k) {
    // select and fetch: the count of CDF entries <= u
    const uint32_t bits = rng.bits();
    const float u = static_cast<float>(bits >> 8) * kInv24;
    const float* cdf = a.cdf + (kHasXaos ? last * kNXforms : 0);
    int idx = 0;
    for (int j = 0; j < kNXforms; ++j) idx += u >= cdf[j] ? 1 : 0;
    idx = idx < kNXforms - 1 ? idx : kNXforms - 1;
    const float* row = a.table + idx * kNCols;

    float tx, ty, nx, ny;
    affine(row, x, y, tx, ty);
    variation_stack<UnionIds, UnionPars>(row + kWCol, row + kPCol, row, tx,
                                         ty, rng, nx, ny);
    if constexpr (kHasPost) {
      const float ox = nx, oy = ny;
      affine(row + kPostCol, ox, oy, nx, ny);
    }
    const float speed = row[7];
    float ncolor = color * (1.0f - speed) + row[6] * speed;
    const float opacity = row[8];

    // badvalue: respawn from two hashes of the selection word
    const bool bad = !(is_finite(nx) && is_finite(ny)) || fabsf(nx) > kBadValue ||
                     fabsf(ny) > kBadValue;
    if (bad) {
      uint32_t h1 = bits * 0x9E3779B9u;
      h1 = h1 ^ (h1 >> 15);
      uint32_t h2 = (bits ^ 0x5BD1E995u) * 0xC2B2AE35u;
      h2 = h2 ^ (h2 >> 13);
      nx = static_cast<float>(h1 >> 8) * kInv24 * 2.0f - 1.0f;
      ny = static_cast<float>(h2 >> 8) * kInv24 * 2.0f - 1.0f;
      ncolor = u;
      age = 0;
    } else {
      age = age + 1;
    }

    // plot a copy: the final xform, the 3-D camera, the projection
    float px = nx, py = ny, pcolor = ncolor;
    if constexpr (kHasFinal) {
      float tx2, ty2;
      affine(s + kFinalAffine, nx, ny, tx2, ty2);
      variation_stack<FinalIds, FinalPars>(s + kFinalWCol, s + kFinalPCol,
                                           s + kFinalAffine, tx2, ty2, rng,
                                           px, py);
      if constexpr (kFinalHasPost) {
        const float ox = px, oy = py;
        affine(s + kFinalPost, ox, oy, px, py);
      }
      const float fspeed = s[kFinalSpeed];
      pcolor = ncolor * (1.0f - fspeed) + s[kFinalColor] * fspeed;
    }
    if constexpr (kCamMode != 0) project_3d(s + kCam3d, rng, px, py);
    int64_t addr = project(a, px, py);
    if (!(age >= a.fuse && opacity > 0.0f)) addr = a.junk_bin;

    const int64_t at = static_cast<int64_t>(k) * a.batch + lane;
    if (a.unpacked) {
      a.rec[at] = addr;
      a.pcolor[at] = pcolor;
      a.opacity[at] = opacity;
    } else {
      const int64_t q = static_cast<int64_t>(
          clamp_nan(pcolor, 0.0f, 1.0f) * levels + 0.5f);
      int64_t rec = (addr << a.tot_bits) | q;
      if (a.op_bits) rec |= static_cast<int64_t>(idx) << a.cbits;
      a.rec[at] = rec;
    }
    x = nx;
    y = ny;
    color = ncolor;
    last = idx;
  }
  a.x_out[lane] = x;
  a.y_out[lane] = y;
  a.color_out[lane] = color;
  a.last_xf_out[lane] = last;
  a.age_out[lane] = age;
  int64_t* wo = a.rng_out + 4 * static_cast<int64_t>(lane);
  wo[0] = rng.x;
  wo[1] = rng.y;
  wo[2] = rng.z;
  wo[3] = rng.w;
}

// The plotted total as the port's Python loop keeps it: a float32
// running sum of the chunks' exact int64 counts, each rounded to float32
// and added in chunk order (the JAX package's f32 counter).
CB_HD float fold_plotted(const int64_t* counts, int n_chunks) {
  float total = 0.0f;
  for (int k = 0; k < n_chunks; ++k)
    total = total + static_cast<float>(counts[k]);
  return total;
}

#else  // the generic library: one variation at n points

CB_HD void apply_variation(int id, const Ctx& c, float w, const float* p,
                           Rng& rng, float& dx, float& dy) {
  switch (id) {
#define X(name)                             \
  case kVar_##name:                         \
    v_##name(c, w, p, rng, dx, dy);         \
    return;
    CHAOS_VARIATIONS(X)
#undef X
    default:
      dx = dy = NAN;
  }
}

CB_HD void variation_lane(const VariationArgs& a, int i) {
  int64_t* rw = a.rng + 4 * static_cast<int64_t>(i);
  Rng rng = {static_cast<uint32_t>(rw[0]), static_cast<uint32_t>(rw[1]),
             static_cast<uint32_t>(rw[2]), static_cast<uint32_t>(rw[3])};
  const Ctx c = make_ctx(a.tx[i], a.ty[i], a.aff);
  apply_variation(a.id, c, a.w[i], a.params, rng, a.dx[i], a.dy[i]);
  rw[0] = rng.x;
  rw[1] = rng.y;
  rw[2] = rng.z;
  rw[3] = rng.w;
}
#endif  // CHAOS_KEY

#ifndef CHAOS_HOST
// two warps a block: 2^17 lanes are 2048 blocks, ~15.5 a SM (faster
// than 128 and 256 threads, timed in turns on the card; two and four
// lanes a thread, their steps interleaved, were slower)
constexpr int kThreads = 64;

#ifdef CHAOS_KEY
// the xform table and the CDF rows, staged in shared memory once a block
// where they fit 32 KB (faster than reads through L1, timed in turns on
// the card; a lane's row is one of n_xforms, so a warp reads several)
constexpr int kTableFloats = kNXforms * kNCols;
constexpr int kCdfFloats = kNXforms * kNXforms;
constexpr bool kStaged = (kTableFloats + kCdfFloats) * 4 <= 32 * 1024;

__global__ void __launch_bounds__(kThreads)
    chaos_iterate_kernel(const __grid_constant__ ChaosArgs a) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (kStaged) {
    __shared__ float table[kTableFloats], cdf[kCdfFloats];
    for (int i = threadIdx.x; i < kTableFloats; i += kThreads)
      table[i] = a.table[i];
    for (int i = threadIdx.x; i < kCdfFloats; i += kThreads) cdf[i] = a.cdf[i];
    __syncthreads();
    ChaosArgs staged = a;
    staged.table = table;
    staged.cdf = cdf;
    if (lane < a.batch) chaos_lane(staged, lane);
  } else {
    if (lane < a.batch) chaos_lane(a, lane);
  }
}

// chaos_accumulate's last launch: the chunks' counts folded by one thread
__global__ void plotted_fold_kernel(const int64_t* counts, int n_chunks,
                                    float* plotted) {
  *plotted = fold_plotted(counts, n_chunks);
}
#else
__global__ void __launch_bounds__(kThreads)
    chaos_variation_kernel(const __grid_constant__ VariationArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < a.n) variation_lane(a, i);
}
#endif
#endif

}  // namespace

// C entries: each but chaos_accumulate runs one kernel launch on `stream`
// (no sync) and returns cudaGetLastError(); the host build runs the same
// lanes in a loop and returns 0.  A key's library has chaos_iterate and
// chaos_accumulate, the generic one chaos_variation.

extern "C" int chaos_variation_count() { return kNumVariations; }

extern "C" const char* chaos_variation_name(int id) {
  return id >= 0 && id < kNumVariations ? kVariationNames[id] : nullptr;
}

extern "C" int chaos_args_size() { return static_cast<int>(sizeof(ChaosArgs)); }

#ifdef CHAOS_KEY
extern "C" int chaos_iterate(const ChaosArgs* a, chaos_stream_t stream) {
#ifdef CHAOS_HOST
  (void)stream;
  for (int lane = 0; lane < a->batch; ++lane) chaos_lane(*a, lane);
  return 0;
#else
  if (a->batch > 0) {
    const unsigned blocks = (a->batch + kThreads - 1) / kThreads;
    chaos_iterate_kernel<<<blocks, kThreads, 0, stream>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
#endif
}

// a reads its trajectories from `in` and writes them into `out`
static void route_state(ChaosArgs& a, const StateBuf& in,
                        const StateBuf& out) {
  a.x = in.x;
  a.y = in.y;
  a.color = in.color;
  a.last_xf = in.last_xf;
  a.age = in.age;
  a.rng = in.rng;
  a.x_out = out.x;
  a.y_out = out.y;
  a.color_out = out.color;
  a.last_xf_out = out.last_xf;
  a.age_out = out.age;
  a.rng_out = out.rng;
}

// n_chunks chunks of the chaos game, each flushed, from one host call:
// per chunk one chaos_iterate launch of `first`'s plan, then `flush` over
// its records into hist with the chunk's count into counts[k] (zeroed by
// the caller); then one plotted_fold launch writes fold_plotted(counts)
// to *plotted.  The trajectories go from `first`'s input state into its
// output buffer, then back and forth between that buffer and `spare`:
// the final state is in the output buffer for an odd n_chunks, in
// `spare` for an even one, and the input state is never written.  No
// sync.  Returns the first non-zero error; the host build runs the same
// loop over its lane loops and folds on the host.
extern "C" int chaos_accumulate(const ChaosArgs* first, const StateBuf* spare,
                                int n_chunks, TallyFlush flush,
                                const float* pal4, int64_t n_bins,
                                float weight, float* hist, int64_t* counts,
                                float* plotted, chaos_stream_t stream) {
  ChaosArgs a = *first;
  const StateBuf bufs[2] = {{a.x_out, a.y_out, a.color_out, a.last_xf_out,
                             a.age_out, a.rng_out},
                            *spare};
  const int64_t n = static_cast<int64_t>(a.batch) * a.n_iters;
  for (int k = 0; k < n_chunks; ++k) {
    if (k > 0) route_state(a, bufs[(k - 1) & 1], bufs[k & 1]);
    int err = chaos_iterate(&a, stream);
    if (err == 0)
      err = flush(a.rec, n, pal4, a.tot_bits, n_bins, weight, hist,
                  counts + k, stream);
    if (err != 0) return err;
  }
#ifdef CHAOS_HOST
  *plotted = fold_plotted(counts, n_chunks);
  return 0;
#else
  plotted_fold_kernel<<<1, 1, 0, stream>>>(counts, n_chunks, plotted);
  return static_cast<int>(cudaGetLastError());
#endif
}
#else
extern "C" int chaos_variation(const VariationArgs* a,
                               chaos_stream_t stream) {
#ifdef CHAOS_HOST
  (void)stream;
  for (int i = 0; i < a->n; ++i) variation_lane(*a, i);
  return 0;
#else
  if (a->n > 0) {
    const unsigned blocks = (a->n + kThreads - 1) / kThreads;
    chaos_variation_kernel<<<blocks, kThreads, 0, stream>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
#endif
}
#endif
