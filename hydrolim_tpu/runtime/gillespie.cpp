// Exact event-driven Gillespie (CTMC) engine — native validation oracle.
//
// The framework's particle engine is a fixed-Δt synchronous τ-leap
// approximation of the continuous-time Markov chain defined by the
// reference's per-particle rate functions (PARTICLE_solver_CLASS.py:259-351,
// see hydrolim_tpu/particles/stepper.py).  This C++ engine samples the SAME
// generator exactly, one event at a time (exponential waiting times,
// categorical event choice), and is used by the test suite to validate that
// the τ-leap stepper converges to the exact law as Δt→0 (SURVEY.md §7.1).
//
// Implemented channels (matching the Python rate assembly):
//   - symmetric diffusion hops left/right with exclusion freeness,
//   - active forward hops (plus_forward: σ=+1 only; bidirectional: σ-directed),
//   - Curie–Weiss spin flips  c = exp(−β σ m(x)),
//   - anchor binding/unbinding, anchored immobilization, absorbing exits,
//   - site capacity K, optional crowding rate suppression.
// Magnetization: global (σ_kernel ≤ 0) maintained incrementally, or local
// Gaussian smoothing (periodic torus kernel / reflect mode) recomputed per
// event like the reference hot loop (PARTICLE_solver_CLASS.py:511-513).
//
// Build: g++ -O3 -march=native -shared -fPIC gillespie.cpp -o libgillespie.so
// Binding: ctypes (hydrolim_tpu/runtime/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// xoshiro256++ — fast, high-quality 64-bit PRNG
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 seeding
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }
  inline uint64_t next() {
    uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  inline double uniform() {  // in [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
  inline double exponential(double rate) {
    double u;
    do { u = uniform(); } while (u <= 0.0);
    return -std::log(u) / rate;
  }
};

struct Params {
  int64_t L;
  int64_t N;
  double dx;
  double rate_diffusion;  // post scale_rates
  double rate_active;
  double beta;
  double kernel_sigma;    // <= 0 -> global m
  double anchor_radius;   // via precomputed mask instead
  double k_on, k_off, k_exit;
  int64_t K;              // site capacity; <= 0 -> no exclusion
  int32_t periodic;
  int32_t bidirectional;  // 0: plus_forward, 1: bidirectional
  int32_t immobilize_when_anchored;
  int32_t suppress_flip_when_bound;
  int32_t crowding;
};

struct Engine {
  Params p;
  std::vector<int64_t> pos;
  std::vector<int8_t> sigma;
  std::vector<uint8_t> bound, alive;
  std::vector<int64_t> occ, cp, cm;
  std::vector<uint8_t> anchor;
  std::vector<double> kernel;  // truncated gaussian weights, radius R
  int64_t kernel_radius = 0;
  std::vector<double> m_field;
  int64_t n_alive = 0;
  long double sigma_sum = 0;

  void build_kernel() {
    if (p.kernel_sigma <= 0) return;
    double sg = p.kernel_sigma / p.dx;  // grid units
    kernel_radius = (int64_t)(4.0 * sg + 0.5);
    if (kernel_radius > p.L) kernel_radius = p.L;
    kernel.resize(2 * kernel_radius + 1);
    double sum = 0.0;
    for (int64_t j = -kernel_radius; j <= kernel_radius; ++j) {
      double w = std::exp(-0.5 * (double)(j * j) / (sg * sg));
      kernel[j + kernel_radius] = w;
      sum += w;
    }
    for (auto &w : kernel) w /= sum;
  }

  inline int64_t wrap(int64_t i) const {
    int64_t L = p.L;
    return ((i % L) + L) % L;
  }
  // scipy 'reflect' (half-sample symmetric) index fold
  inline int64_t reflect(int64_t i) const {
    int64_t L = p.L;
    int64_t period = 2 * L;
    i = ((i % period) + period) % period;
    return (i < L) ? i : (period - 1 - i);
  }

  void compute_m_field() {
    int64_t L = p.L;
    if (p.kernel_sigma <= 0) {
      double m = (n_alive > 0) ? (double)(sigma_sum / (long double)n_alive)
                               : 0.0;
      std::fill(m_field.begin(), m_field.end(), m);
      return;
    }
    for (int64_t x = 0; x < L; ++x) {
      double s_conv = 0.0, t_conv = 0.0;
      for (int64_t j = -kernel_radius; j <= kernel_radius; ++j) {
        int64_t idx = p.periodic ? wrap(x + j) : reflect(x + j);
        double w = kernel[j + kernel_radius];
        s_conv += w * (double)(cp[idx] - cm[idx]);
        t_conv += w * (double)(cp[idx] + cm[idx]);
      }
      double m = (t_conv > 0.0) ? s_conv / t_conv : 0.0;
      if (m > 1.0) m = 1.0;
      if (m < -1.0) m = -1.0;
      m_field[x] = m;
    }
  }

  // rates per particle into the provided buffers; returns total rate
  double assemble_rates(std::vector<double> &r_left, std::vector<double> &r_right,
                        std::vector<double> &r_act, std::vector<double> &r_flip,
                        std::vector<double> &r_bind, std::vector<double> &r_unbind,
                        std::vector<double> &r_exit) {
    int64_t L = p.L;
    bool excl = p.K > 0;
    double total = 0.0;
    for (int64_t i = 0; i < (int64_t)pos.size(); ++i) {
      r_left[i] = r_right[i] = r_act[i] = r_flip[i] = 0.0;
      r_bind[i] = r_unbind[i] = r_exit[i] = 0.0;
      if (!alive[i]) continue;
      int64_t x = pos[i];
      int s = sigma[i];
      double m = m_field[x];
      double c = std::exp(-p.beta * s * m);
      if (p.suppress_flip_when_bound && bound[i]) c = 0.0;
      r_flip[i] = c;

      int64_t lt = p.periodic ? wrap(x - 1) : std::max<int64_t>(0, x - 1);
      int64_t rt = p.periodic ? wrap(x + 1) : std::min<int64_t>(L - 1, x + 1);
      int fstep = p.bidirectional ? s : (s == 1 ? 1 : 0);
      int64_t ftr = x + fstep;
      int64_t ft = p.periodic ? wrap(ftr)
                              : std::min<int64_t>(L - 1, std::max<int64_t>(0, ftr));
      bool same_l = lt == x, same_r = rt == x, same_f = ft == x;
      bool lfree = !same_l && (!excl || occ[lt] < p.K);
      bool rfree = !same_r && (!excl || occ[rt] < p.K);
      bool ffree = !same_f && (!excl || occ[ft] < p.K);

      double rl = lfree ? p.rate_diffusion : 0.0;
      double rr = rfree ? p.rate_diffusion : 0.0;
      double ra = 0.0;
      if (p.bidirectional) {
        ra = ffree ? p.rate_active : 0.0;
      } else {
        ra = (s == 1 && ffree) ? p.rate_active : 0.0;
      }
      if (p.immobilize_when_anchored && s == -1 && anchor[x] && bound[i]) {
        rl = rr = ra = 0.0;
        r_exit[i] = p.k_exit;
      }
      if (p.crowding && excl) {
        auto frac = [&](int64_t t) {
          double f = 1.0 - (double)occ[t] / (double)p.K;
          return f < 0.0 ? 0.0 : (f > 1.0 ? 1.0 : f);
        };
        ra *= frac(ft);
        rl *= frac(lt);
        rr *= frac(rt);
      }
      r_left[i] = rl;
      r_right[i] = rr;
      r_act[i] = ra;
      if (!bound[i] && s == -1 && anchor[x] && (!excl || occ[x] < p.K))
        r_bind[i] = p.k_on;
      if (bound[i]) r_unbind[i] = p.k_off;

      total += rl + rr + ra + r_flip[i] + r_bind[i] + r_unbind[i] + r_exit[i];
    }
    return total;
  }
};

}  // namespace

extern "C" {

// Runs the exact CTMC; records per-frame counts and m_global.
// Returns number of events executed (negative on error).
long long run_gillespie(
    // config
    long long L, long long N, double dx, double rate_diffusion,
    double rate_active, double beta, double kernel_sigma, long long K,
    int periodic, int bidirectional, int immobilize_when_anchored,
    int suppress_flip_when_bound, int crowding, double k_on, double k_off,
    double k_exit,
    // initial state (length N)
    const long long *pos0, const signed char *sigma0,
    // anchor mask (length L, 0/1)
    const unsigned char *anchor_mask,
    // run
    double T, double obs_dt, unsigned long long seed,
    // outputs
    long long n_frames,
    long long *counts_p_out,  // (n_frames, L)
    long long *counts_m_out,  // (n_frames, L)
    double *m_global_out,     // (n_frames,)
    long long *n_alive_out    // (n_frames,)
) {
  Engine e;
  e.p = Params{L, N, dx, rate_diffusion, rate_active, beta, kernel_sigma,
               0.0, k_on, k_off, k_exit, K, periodic, bidirectional,
               immobilize_when_anchored, suppress_flip_when_bound, crowding};
  e.pos.assign(pos0, pos0 + N);
  e.sigma.assign(sigma0, sigma0 + N);
  e.bound.assign(N, 0);
  e.alive.assign(N, 1);
  e.occ.assign(L, 0);
  e.cp.assign(L, 0);
  e.cm.assign(L, 0);
  e.anchor.assign(anchor_mask, anchor_mask + L);
  e.m_field.assign(L, 0.0);
  e.n_alive = N;
  for (long long i = 0; i < N; ++i) {
    if (e.pos[i] < 0 || e.pos[i] >= L) return -1;
    e.occ[e.pos[i]]++;
    if (e.sigma[i] == 1) e.cp[e.pos[i]]++;
    else e.cm[e.pos[i]]++;
    e.sigma_sum += e.sigma[i];
  }
  e.build_kernel();

  Rng rng(seed);
  std::vector<double> rl(N), rr(N), ra(N), rf(N), rb(N), ru(N), rx(N);

  auto record = [&](long long f) {
    for (long long x = 0; x < L; ++x) {
      counts_p_out[f * L + x] = e.cp[x];
      counts_m_out[f * L + x] = e.cm[x];
    }
    m_global_out[f] =
        e.n_alive > 0 ? (double)(e.sigma_sum / (long double)e.n_alive) : 0.0;
    n_alive_out[f] = e.n_alive;
  };

  double t = 0.0;
  long long frame = 0;
  record(frame++);
  long long events = 0;
  const long long max_events = 400LL * 1000 * 1000;  // hard safety cap

  while (t < T && frame < n_frames && events < max_events) {
    e.compute_m_field();
    double R = e.assemble_rates(rl, rr, ra, rf, rb, ru, rx);
    if (R <= 0.0) break;  // absorbing: no events possible
    double tau = rng.exponential(R);
    t += tau;
    if (t > T) break;
    // frames due at times <= t record the PRE-event state: the event
    // happens AT t, so the state at any earlier due time is the current
    // one.  (Recording after the switch instead — as this loop originally
    // did — stamps every frame with the state just after the first event
    // FOLLOWING its due time, i.e. a one-jump-ahead bias: the sampled
    // distribution becomes the one-step jump-chain evolution of the
    // occupancy law, not the occupancy law.  Invisible at large N — one
    // jump shifts m by 2/N — but exactly wrong; caught by
    // tests/test_native_gillespie.py::test_oracle_matches_exact_
    // stationary_distribution on a 2-particle state space.)
    while (frame < n_frames && (double)frame * obs_dt <= t)
      record(frame++);
    // categorical over particles × channels by a single threshold scan
    double u = rng.uniform() * R;
    double acc = 0.0;
    long long i = -1;
    int channel = -1;
    for (long long j = 0; j < N && channel < 0; ++j) {
      if (!e.alive[j]) continue;
      const double rates_j[7] = {rl[j], rr[j], ra[j], rf[j],
                                 rb[j], ru[j], rx[j]};
      for (int c = 0; c < 7; ++c) {
        acc += rates_j[c];
        if (u < acc) { i = j; channel = c; break; }
      }
    }
    if (channel < 0) {
      // numerical edge: u landed past the scan's accumulated total
      // (summation-order mismatch vs assemble_rates).  Flip the LAST
      // particle that is alive with a nonzero flip rate — blindly flipping
      // index N-1 could act on an exited or zero-rate particle and corrupt
      // the counts/sigma_sum the oracle validates against.
      for (long long j = N - 1; j >= 0; --j) {
        if (e.alive[j] && rf[j] > 0.0) { i = j; channel = 3; break; }
      }
      if (channel < 0)  // no eligible flip: drop the event (state
        continue;       // unchanged; frames due <= t already recorded)
    }

    int64_t x = e.pos[i];
    auto move_to = [&](int64_t nx) {
      e.occ[x]--;
      e.occ[nx]++;
      if (e.sigma[i] == 1) { e.cp[x]--; e.cp[nx]++; }
      else { e.cm[x]--; e.cm[nx]++; }
      e.pos[i] = nx;
    };
    switch (channel) {
      case 0: move_to(e.p.periodic ? e.wrap(x - 1) : x - 1); break;
      case 1: move_to(e.p.periodic ? e.wrap(x + 1) : x + 1); break;
      case 2: {
        int fstep = e.p.bidirectional ? e.sigma[i] : 1;
        move_to(e.p.periodic ? e.wrap(x + fstep) : x + fstep);
        break;
      }
      case 3: {  // flip
        if (e.sigma[i] == 1) { e.cp[x]--; e.cm[x]++; }
        else { e.cm[x]--; e.cp[x]++; }
        e.sigma_sum -= 2 * e.sigma[i];
        e.sigma[i] = -e.sigma[i];
        break;
      }
      case 4: e.bound[i] = 1; break;
      case 5: e.bound[i] = 0; break;
      case 6: {  // exit
        e.occ[x]--;
        if (e.sigma[i] == 1) e.cp[x]--;
        else e.cm[x]--;
        e.sigma_sum -= e.sigma[i];
        e.alive[i] = 0;
        e.n_alive--;
        break;
      }
    }
    events++;
  }
  // fill remaining frames with the final state (run ended / absorbed)
  while (frame < n_frames) record(frame++);
  return events;
}

}  // extern "C"
