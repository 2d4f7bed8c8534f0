// Native oracle kernels for rrmpg-jax.
//
// Independent C++ implementations of the conceptual-model state
// transitions, used as (a) a second, JAX-free oracle for cross-validation
// of the Pallas/XLA kernels in the test suite, and (b) a fast sequential
// CPU fallback (the role numba's LLVM JIT plays in the reference
// package).  The math follows the published model equations (Fiering
// 1967; Perrin et al. 2003; Aghakouchak & Habib 2010; Valery 2010;
// Riboust et al. 2019; Nepal et al. 2017) with the exact branch semantics
// the reference implements (cited per function).
//
// Build: g++ -O3 -march=native -shared -fPIC oracle.cpp -o liboracle.so
// ABI: flat C functions over double buffers, bound via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// ABC model: one linear storage.
// Semantics: rrmpg/models/abcmodel_model.py:53-59 (loop from t=1).
// ---------------------------------------------------------------------
void oracle_abc(const double* prec, int64_t T, double a, double b, double c,
                double initial_state, double* qsim, double* storage) {
  if (T <= 0) return;
  qsim[0] = 0.0;
  storage[0] = initial_state;
  for (int64_t t = 1; t < T; ++t) {
    const double s_prev = storage[t - 1];
    qsim[t] = (1.0 - a - b) * prec[t] + c * s_prev;
    storage[t] = (1.0 - c) * s_prev + a * prec[t];
  }
}

// ---------------------------------------------------------------------
// GR4J: production store + two unit hydrographs + routing store.
// Semantics: rrmpg/models/gr4j_model.py:15-192 (s_init/r_init are
// fractions of x1/x3; UH lengths ceil(x4), ceil(2*x4+1)).
// ---------------------------------------------------------------------
static double sh1(double t, double x4) {
  if (t <= 0.0) return 0.0;
  if (t < x4) return std::pow(t / x4, 2.5);
  return 1.0;
}

static double sh2(double t, double x4) {
  if (t <= 0.0) return 0.0;
  if (t <= x4) return 0.5 * std::pow(t / x4, 2.5);
  if (t < 2.0 * x4) return 1.0 - 0.5 * std::pow(2.0 - t / x4, 2.5);
  return 1.0;
}

void oracle_gr4j(const double* prec, const double* etp, int64_t T,
                 double x1, double x2, double x3, double x4, double s_init,
                 double r_init, double* qsim, double* s_store,
                 double* r_store) {
  const int n1 = static_cast<int>(std::ceil(x4));
  const int n2 = static_cast<int>(std::ceil(2.0 * x4 + 1.0));
  std::vector<double> oh1(n1), oh2(n2), uh1(n1, 0.0), uh2(n2, 0.0);
  for (int j = 1; j <= n1; ++j) oh1[j - 1] = sh1(j, x4) - sh1(j - 1, x4);
  for (int j = 1; j <= n2; ++j) oh2[j - 1] = sh2(j, x4) - sh2(j - 1, x4);

  double s = s_init * x1;
  double r = r_init * x3;
  for (int64_t t = 0; t < T; ++t) {
    const double p = prec[t];
    const double e = etp[t];
    double p_n = 0.0, p_s = 0.0, e_s = 0.0;
    if (p >= e) {
      p_n = p - e;
      const double th = std::tanh(p_n / x1);
      const double sr = s / x1;
      p_s = (x1 * (1.0 - sr * sr) * th) / (1.0 + sr * th);
    } else {
      const double pe_n = e - p;
      const double th = std::tanh(pe_n / x1);
      const double sr = s / x1;
      e_s = (s * (2.0 - sr) * th) / (1.0 + (1.0 - sr) * th);
    }
    s += p_s - e_s;
    const double frac = (4.0 / 9.0) * (s / x1);
    const double perc =
        s * (1.0 - std::pow(1.0 + frac * frac * frac * frac, -0.25));
    s -= perc;
    const double p_r = perc + (p_n - p_s);

    const double pr9 = 0.9 * p_r;
    const double pr1 = 0.1 * p_r;
    for (int j = 0; j < n1 - 1; ++j) uh1[j] = uh1[j + 1] + oh1[j] * pr9;
    uh1[n1 - 1] = oh1[n1 - 1] * pr9;
    for (int j = 0; j < n2 - 1; ++j) uh2[j] = uh2[j + 1] + oh2[j] * pr1;
    uh2[n2 - 1] = oh2[n2 - 1] * pr1;

    const double f = x2 * std::pow(r / x3, 3.5);
    double ri = std::max(0.0, r + uh1[0] + f);
    const double rx = ri / x3;
    const double q_r =
        ri * (1.0 - std::pow(1.0 + rx * rx * rx * rx, -0.25));
    r = ri - q_r;
    const double q_d = std::max(0.0, uh2[0] + f);

    qsim[t] = q_r + q_d;
    s_store[t] = s;
    r_store[t] = r;
  }
}

// ---------------------------------------------------------------------
// HBV-Edu: degree-day snow + soil + two-reservoir cascade.
// Semantics: rrmpg/models/hbvedu_model.py:86-127 (loop from t=1; month
// is 0-based; climatologies are length-12).
// ---------------------------------------------------------------------
void oracle_hbvedu(const double* temp, const double* prec,
                   const int64_t* month, const double* pe_m,
                   const double* t_m, int64_t T, double T_t, double DD,
                   double FC, double Beta, double C, double PWP, double K_0,
                   double K_1, double K_2, double K_p, double L,
                   double snow_init, double soil_init, double s1_init,
                   double s2_init, double* qsim, double* snow, double* soil,
                   double* s1, double* s2) {
  if (T <= 0) return;
  qsim[0] = 0.0;
  snow[0] = snow_init;
  soil[0] = soil_init;
  s1[0] = s1_init;
  s2[0] = s2_init;
  for (int64_t t = 1; t < T; ++t) {
    double liquid = 0.0;
    if (temp[t] < T_t) {
      snow[t] = snow[t - 1] + prec[t];
    } else {
      const double melt_pot = DD * (temp[t] - T_t);
      snow[t] = std::max(0.0, snow[t - 1] - melt_pot);
      liquid = prec[t] + std::min(snow[t - 1], melt_pot);
    }
    const double prec_eff = liquid * std::pow(soil[t - 1] / FC, Beta);
    const double pe =
        (1.0 + C * (temp[t] - t_m[month[t]])) * pe_m[month[t]];
    const double ea =
        (soil[t - 1] > PWP) ? pe : pe * (soil[t - 1] / PWP);
    soil[t] = soil[t - 1] + liquid - prec_eff - ea;
    const double overflow = std::max(0.0, s1[t - 1] - L) * K_0;
    s1[t] = s1[t - 1] + prec_eff - overflow - s1[t - 1] * K_1 -
            s1[t - 1] * K_p;
    s2[t] = s2[t - 1] + s1[t - 1] * K_p - s2[t - 1] * K_2;
    qsim[t] = overflow + s1[t] * K_1 + s2[t] * K_2;
  }
}

// ---------------------------------------------------------------------
// Cemaneige snow routine (per elevation layer).
// Semantics: rrmpg/models/cemaneige_model.py:73-125 (t=0 initializes the
// stores; G_tresh from the mean annual solid precipitation).
// Arrays are (T, L) row-major.
// ---------------------------------------------------------------------
void oracle_cemaneige(const double* prec, const double* mean_temp,
                      const double* frac_solid, int64_t T, int64_t L,
                      double CTG, double Kf, double snow_pack_init,
                      double thermal_state_init, double* outflow, double* G,
                      double* eTG) {
  std::vector<double> g_thresh(L, 0.0);
  for (int64_t l = 0; l < L; ++l) {
    double mean_snow = 0.0;
    for (int64_t t = 0; t < T; ++t)
      mean_snow += prec[t * L + l] * frac_solid[t * L + l];
    g_thresh[l] = 0.9 * 365.25 * (mean_snow / static_cast<double>(T));
  }
  for (int64_t t = 0; t < T; ++t) {
    double total = 0.0;
    for (int64_t l = 0; l < L; ++l) {
      const int64_t i = t * L + l;
      const double snow_t = prec[i] * frac_solid[i];
      const double rain_t = prec[i] - snow_t;
      double g = (t == 0) ? snow_pack_init : G[(t - 1) * L + l] + snow_t;
      double th = (t == 0) ? thermal_state_init
                           : CTG * eTG[(t - 1) * L + l] +
                                 (1.0 - CTG) * mean_temp[i];
      if (th > 0.0) th = 0.0;
      double pot_melt = 0.0;
      if (th == 0.0 && mean_temp[i] > 0.0)
        pot_melt = std::min(Kf * mean_temp[i], g);
      const double ratio = (g < g_thresh[l]) ? g / g_thresh[l] : 1.0;
      const double melt = (0.9 * ratio + 0.1) * pot_melt;
      g -= melt;
      G[i] = g;
      eTG[i] = th;
      total += rain_t + melt;
    }
    outflow[t] = total / static_cast<double>(L);
  }
}

// ---------------------------------------------------------------------
// Cemaneige with SWE-SCA linear hysteresis.
// Semantics: rrmpg/models/cemaneigehyst_model.py:84-164 (sca_init is
// overwritten at t=0 by the accumulation/ablation branch; swe_max resets
// when the pack empties).
// ---------------------------------------------------------------------
void oracle_cemaneigehyst(const double* prec, const double* mean_temp,
                          const double* frac_solid, int64_t T, int64_t L,
                          double CTG, double Kf, double Thacc, double Rsp,
                          double snow_pack_init, double thermal_state_init,
                          double* outflow, double* G, double* eTG,
                          double* sca, double* rain_out) {
  std::vector<double> th_melt(L, 0.0), swe_max(L, 0.0);
  for (int64_t l = 0; l < L; ++l) {
    double mean_snow = 0.0;
    for (int64_t t = 0; t < T; ++t)
      mean_snow += prec[t * L + l] * frac_solid[t * L + l];
    th_melt[l] = 365.25 * (mean_snow / static_cast<double>(T)) * Rsp;
  }
  for (int64_t t = 0; t < T; ++t) {
    double total = 0.0;
    for (int64_t l = 0; l < L; ++l) {
      const int64_t i = t * L + l;
      const double snow_t = prec[i] * frac_solid[i];
      const double rain_t = prec[i] - snow_t;
      double g = (t == 0) ? snow_pack_init : G[(t - 1) * L + l] + snow_t;
      double th = (t == 0) ? thermal_state_init
                           : CTG * eTG[(t - 1) * L + l] +
                                 (1.0 - CTG) * mean_temp[i];
      if (th > 0.0) th = 0.0;
      double pot_melt = 0.0;
      if (th == 0.0 && mean_temp[i] > 0.0)
        pot_melt = std::min(Kf * mean_temp[i], g);

      const double balance = snow_t - pot_melt;
      const double sca_prev = (t == 0) ? 0.0 : sca[(t - 1) * L + l];
      double sc;
      if (balance >= 0.0) {
        sc = sca_prev + balance / Thacc;
        swe_max[l] = std::max(swe_max[l], g);
      } else {
        const double th_max = std::min(swe_max[l], th_melt[l]);
        sc = (th_max > 0.0) ? g / th_max : 0.0;
      }
      sc = std::min(std::max(sc, 0.0), 1.0);

      double melt = (0.9 * sc + 0.1) * pot_melt;
      melt = std::min(melt, g);
      g -= melt;
      if (g == 0.0) swe_max[l] = 0.0;

      G[i] = g;
      eTG[i] = th;
      sca[i] = sc;
      rain_out[i] = rain_t;
      total += rain_t + melt;
    }
    outflow[t] = total / static_cast<double>(L);
  }
}

// ---------------------------------------------------------------------
// Degree-day glacier ice melt (snow > 1 mm shields the ice).
// Semantics: rrmpg/models/icemelt_model.py:54-63.
// ---------------------------------------------------------------------
void oracle_icemelt(const double* temp, const double* snow, int64_t T,
                    int64_t L, double DDF, double* liquid) {
  for (int64_t i = 0; i < T * L; ++i) {
    const double melt = std::max(DDF * temp[i], 0.0);
    liquid[i] = (snow[i] > 1.0) ? 0.0 : melt;
  }
}

}  // extern "C"
