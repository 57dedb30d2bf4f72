// bravais_host — native host core for bravais_tpu.
//
// C++ implementation of the dense Bloch operator assemblers (the
// correctness oracles of SURVEY.md §4.2 item 5) plus periodic
// structured-grid dof indexing. This mirrors the role of the
// reference's C++ assembly layer (SURVEY.md §2.1 #3/#4, §2.2 #8) on the
// host side of the rebuild; the performance-bearing device path is
// XLA on the GPU. Exposed through a plain C API consumed
// via ctypes (bravais_tpu/utils/native.py).
//
// Conventions match the Python oracles exactly:
//  * H1: global dof = C-order index of (N_1..N_d), N_i = n_i * p;
//    Bloch-SHIFTED form: A(k) = ∫ α (∇u + iku)·conj(∇v + ikv).
//  * Nédélec: dof = c * Π N_i + C-order (N_1..N_3); QUASI-PERIODIC
//    form: plain curl-curl, Bloch phase e^{i k·a_i} on wrapped dofs.
//
// Build: make -C csrc   (produces libbravais_host.so)

#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>

using cplx = std::complex<double>;

namespace {

// Accumulate A_loc into the dense global matrix with index map gidx and
// per-dof phases pf: A[g_a, g_b] += conj(pf_a) * A_loc[a, b] * pf_b.
void scatter_dense(cplx* A, int64_t N, const std::vector<int64_t>& gidx,
                   const std::vector<cplx>& pf,
                   const std::vector<cplx>& A_loc) {
  const int64_t nL = (int64_t)gidx.size();
  for (int64_t a = 0; a < nL; ++a) {
    cplx pa = std::conj(pf[a]);
    cplx* row = A + gidx[a] * N;
    const cplx* lrow = A_loc.data() + a * nL;
    for (int64_t b = 0; b < nL; ++b) {
      row[gidx[b]] += pa * lrow[b] * pf[b];
    }
  }
}

struct MultiIdx {
  // odometer over mixed radices
  std::vector<int> radix, idx;
  explicit MultiIdx(std::vector<int> r) : radix(std::move(r)),
                                          idx(radix.size(), 0) {}
  int64_t count() const {
    int64_t c = 1;
    for (int r : radix) c *= r;
    return c;
  }
  void step() {
    for (int i = (int)radix.size() - 1; i >= 0; --i) {
      if (++idx[i] < radix[i]) return;
      idx[i] = 0;
    }
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// Scalar Bloch Helmholtz (SURVEY.md App. B.1), Bloch-shifted form.
// B, D: (q, p+1) row-major 1D tables; qwts: (q,);
// Jinv: (dim, dim) row-major; alpha_q/beta_q: element-major then
// qpt-major, i.e. flattened (nelem, q^dim) with elements in C order of
// shape[] and qpts in C order of (q,)*dim — the caller transposes its
// interleaved layout accordingly.
// A_out, M_out: (N, N) complex128 (interleaved re/im), zero-initialized
// by this function.
int bh_assemble_h1(int dim, const int64_t* shape, int p, int q,
                   const double* B, const double* D, const double* qwts,
                   const double* Jinv, double detJ,
                   const double* alpha_e, const double* beta_e,
                   const double* kvec, double* A_out, double* M_out) {
  const int p1 = p + 1;
  std::vector<int64_t> Nd(dim);
  int64_t N = 1, nelem = 1;
  for (int i = 0; i < dim; ++i) {
    Nd[i] = shape[i] * p;
    N *= Nd[i];
    nelem *= shape[i];
  }
  // strides of the global C-order dof grid
  std::vector<int64_t> stride(dim, 1);
  for (int i = dim - 2; i >= 0; --i) stride[i] = stride[i + 1] * Nd[i + 1];

  MultiIdx qit(std::vector<int>(dim, q));
  MultiIdx lit(std::vector<int>(dim, p1));
  const int64_t nQ = qit.count(), nL = lit.count();

  // Phi[Q, L], Ghat[r, Q, L] (reference), Gphys = Jinv^T Ghat,
  // P[r, Q, L] = Gphys + i k Phi.
  std::vector<double> Phi(nQ * nL), Ghat((size_t)dim * nQ * nL);
  {
    MultiIdx qi(std::vector<int>(dim, q));
    for (int64_t Q = 0; Q < nQ; ++Q, qi.step()) {
      MultiIdx li(std::vector<int>(dim, p1));
      for (int64_t L = 0; L < nL; ++L, li.step()) {
        double phi = 1.0;
        for (int i = 0; i < dim; ++i) phi *= B[qi.idx[i] * p1 + li.idx[i]];
        Phi[Q * nL + L] = phi;
        for (int r = 0; r < dim; ++r) {
          double g = 1.0;
          for (int i = 0; i < dim; ++i) {
            const double* tab = (i == r) ? D : B;
            g *= tab[qi.idx[i] * p1 + li.idx[i]];
          }
          Ghat[((size_t)r * nQ + Q) * nL + L] = g;
        }
      }
    }
  }
  std::vector<cplx> P((size_t)dim * nQ * nL);
  for (int r = 0; r < dim; ++r) {
    for (int64_t Q = 0; Q < nQ; ++Q) {
      for (int64_t L = 0; L < nL; ++L) {
        double gphys = 0.0;
        for (int s = 0; s < dim; ++s) {
          // (Jinv^T)[r, s] = Jinv[s, r]
          gphys += Jinv[s * dim + r] *
                   Ghat[((size_t)s * nQ + Q) * nL + L];
        }
        P[((size_t)r * nQ + Q) * nL + L] =
            cplx(gphys, 0.0) + cplx(0.0, kvec[r]) * Phi[Q * nL + L];
      }
    }
  }
  // quadrature weights over tensor qpts
  std::vector<double> wQ(nQ);
  {
    MultiIdx qi(std::vector<int>(dim, q));
    for (int64_t Q = 0; Q < nQ; ++Q, qi.step()) {
      double w = detJ;
      for (int i = 0; i < dim; ++i) w *= qwts[qi.idx[i]];
      wQ[Q] = w;
    }
  }

  cplx* A = reinterpret_cast<cplx*>(A_out);
  cplx* M = reinterpret_cast<cplx*>(M_out);
  std::memset(A_out, 0, sizeof(double) * 2 * (size_t)N * N);
  std::memset(M_out, 0, sizeof(double) * 2 * (size_t)N * N);

  std::vector<cplx> A_loc(nL * nL), M_loc(nL * nL);
  std::vector<int64_t> gidx(nL);
  std::vector<cplx> pf(nL, cplx(1.0, 0.0));

  std::vector<int> eshape(dim);
  for (int i = 0; i < dim; ++i) eshape[i] = (int)shape[i];
  MultiIdx eit(eshape);
  for (int64_t e = 0; e < nelem; ++e, eit.step()) {
    const double* wa_base = alpha_e + e * nQ;
    const double* wb_base = beta_e + e * nQ;
    // local matrices
    std::fill(A_loc.begin(), A_loc.end(), cplx(0, 0));
    std::fill(M_loc.begin(), M_loc.end(), cplx(0, 0));
    for (int64_t Q = 0; Q < nQ; ++Q) {
      const double wa = wQ[Q] * wa_base[Q];
      const double wb = wQ[Q] * wb_base[Q];
      for (int64_t a = 0; a < nL; ++a) {
        const double phia = Phi[Q * nL + a];
        for (int64_t b = 0; b < nL; ++b) {
          cplx acc(0, 0);
          for (int r = 0; r < dim; ++r) {
            acc += std::conj(P[((size_t)r * nQ + Q) * nL + a]) *
                   P[((size_t)r * nQ + Q) * nL + b];
          }
          A_loc[a * nL + b] += wa * acc;
          M_loc[a * nL + b] += wb * phia * Phi[Q * nL + b];
        }
      }
    }
    // global indices (periodic wrap, no phases in the shifted form)
    MultiIdx li(std::vector<int>(dim, p1));
    for (int64_t L = 0; L < nL; ++L, li.step()) {
      int64_t flat = 0;
      for (int i = 0; i < dim; ++i) {
        int64_t gi = ((int64_t)eit.idx[i] * p + li.idx[i]) % Nd[i];
        flat += gi * stride[i];
      }
      gidx[L] = flat;
    }
    scatter_dense(A, N, gidx, pf, A_loc);
    scatter_dense(M, N, gidx, pf, M_loc);
  }
  return 0;
}

// ---------------------------------------------------------------------
// Maxwell curl-curl on tensor Nédélec, QUASI-PERIODIC form
// (SURVEY.md App. B.2; see operators/curlcurl.py docstring).
// Bc/Dc: (q, p+1); Bo/Do: (q, p); J, Jinv: 3x3 row-major; detJs signed;
// eps_e/mu_e: (nelem, q^3); phases: 3 complex (re, im interleaved).
int bh_assemble_nedelec(const int64_t* shape, int p, int q,
                        const double* Bc, const double* Dc,
                        const double* Bo, const double* Do,
                        const double* qwts, const double* J,
                        const double* Jinv, double detJs,
                        const double* eps_e, const double* mu_e,
                        const double* phases_ri,
                        double* A_out, double* M_out) {
  const int dim = 3, p1 = p + 1;
  int64_t Nd[3], Ncomp = 1, nelem = 1;
  for (int i = 0; i < dim; ++i) {
    Nd[i] = shape[i] * p;
    Ncomp *= Nd[i];
    nelem *= shape[i];
  }
  const int64_t N = 3 * Ncomp;
  int64_t stride[3] = {Nd[1] * Nd[2], Nd[2], 1};
  cplx phases[3] = {cplx(phases_ri[0], phases_ri[1]),
                    cplx(phases_ri[2], phases_ri[3]),
                    cplx(phases_ri[4], phases_ri[5])};

  // local index list: (c, j0, j1, j2), j_c in [0, p), others [0, p1)
  struct LIdx { int c, j[3]; };
  std::vector<LIdx> lidx;
  for (int c = 0; c < 3; ++c) {
    int sz[3];
    for (int i = 0; i < 3; ++i) sz[i] = (i == c) ? p : p1;
    for (int a = 0; a < sz[0]; ++a)
      for (int b = 0; b < sz[1]; ++b)
        for (int d2 = 0; d2 < sz[2]; ++d2) lidx.push_back({c, {a, b, d2}});
  }
  const int64_t nL = (int64_t)lidx.size();
  const int64_t nQ = (int64_t)q * q * q;

  // Val[r, Q, L] (physical value via Jinv^T e_c), Crl[r, Q, L]
  std::vector<double> Val((size_t)3 * nQ * nL), Crl((size_t)3 * nQ * nL);
  {
    for (int64_t Q = 0; Q < nQ; ++Q) {
      int qi[3] = {(int)(Q / (q * q)), (int)((Q / q) % q), (int)(Q % q)};
      for (int64_t L = 0; L < nL; ++L) {
        const LIdx& li = lidx[L];
        double phi = 1.0, grad[3];
        for (int i = 0; i < 3; ++i) {
          const double* tv = (i == li.c) ? Bo : Bc;
          const int w = (i == li.c) ? p : p1;
          phi *= tv[qi[i] * w + li.j[i]];
        }
        for (int s = 0; s < 3; ++s) {
          double g = 1.0;
          for (int i = 0; i < 3; ++i) {
            const int w = (i == li.c) ? p : p1;
            const double* t =
                (i == s) ? ((i == li.c) ? Do : Dc) : ((i == li.c) ? Bo : Bc);
            g *= t[qi[i] * w + li.j[i]];
          }
          grad[s] = g;
        }
        // value: Jinv^T column c times phi
        for (int r = 0; r < 3; ++r)
          Val[((size_t)r * nQ + Q) * nL + L] = Jinv[li.c * 3 + r] * phi;
        // curl: J * (grad x e_c) / detJs
        double gxe[3] = {0, 0, 0};
        // (grad x e_c)_r = grad[s]*e_c[t] - grad[t]*e_c[s], cyclic
        const int cyc[3][3] = {{0, 1, 2}, {1, 2, 0}, {2, 0, 1}};
        for (int row = 0; row < 3; ++row) {
          int r = cyc[row][0], s = cyc[row][1], t = cyc[row][2];
          double ec_t = (t == li.c) ? 1.0 : 0.0;
          double ec_s = (s == li.c) ? 1.0 : 0.0;
          gxe[r] = grad[s] * ec_t - grad[t] * ec_s;
        }
        for (int r = 0; r < 3; ++r) {
          double v = 0.0;
          for (int s = 0; s < 3; ++s) v += J[r * 3 + s] * gxe[s];
          Crl[((size_t)r * nQ + Q) * nL + L] = v / detJs;
        }
      }
    }
  }
  std::vector<double> wQ(nQ);
  for (int64_t Q = 0; Q < nQ; ++Q) {
    int qi[3] = {(int)(Q / (q * q)), (int)((Q / q) % q), (int)(Q % q)};
    wQ[Q] = std::abs(detJs) * qwts[qi[0]] * qwts[qi[1]] * qwts[qi[2]];
  }

  cplx* A = reinterpret_cast<cplx*>(A_out);
  cplx* M = reinterpret_cast<cplx*>(M_out);
  std::memset(A_out, 0, sizeof(double) * 2 * (size_t)N * N);
  std::memset(M_out, 0, sizeof(double) * 2 * (size_t)N * N);

  std::vector<cplx> A_loc(nL * nL), M_loc(nL * nL);
  std::vector<int64_t> gidx(nL);
  std::vector<cplx> pf(nL);

  for (int64_t e = 0; e < nelem; ++e) {
    int ei[3] = {(int)(e / (shape[1] * shape[2])),
                 (int)((e / shape[2]) % shape[1]), (int)(e % shape[2])};
    const double* we = mu_e + e * nQ;
    const double* be = eps_e + e * nQ;
    std::fill(A_loc.begin(), A_loc.end(), cplx(0, 0));
    std::fill(M_loc.begin(), M_loc.end(), cplx(0, 0));
    for (int64_t Q = 0; Q < nQ; ++Q) {
      const double wa = wQ[Q] * we[Q];
      const double wb = wQ[Q] * be[Q];
      for (int64_t a = 0; a < nL; ++a) {
        for (int64_t b = 0; b < nL; ++b) {
          double ca = 0.0, va = 0.0;
          for (int r = 0; r < 3; ++r) {
            ca += Crl[((size_t)r * nQ + Q) * nL + a] *
                  Crl[((size_t)r * nQ + Q) * nL + b];
            va += Val[((size_t)r * nQ + Q) * nL + a] *
                  Val[((size_t)r * nQ + Q) * nL + b];
          }
          A_loc[a * nL + b] += wa * ca;
          M_loc[a * nL + b] += wb * va;
        }
      }
    }
    for (int64_t L = 0; L < nL; ++L) {
      const LIdx& li = lidx[L];
      int64_t flat = 0;
      cplx ph(1.0, 0.0);
      for (int i = 0; i < 3; ++i) {
        int64_t gr = (int64_t)ei[i] * p + li.j[i];
        int64_t gi = gr % Nd[i];
        if (gr >= Nd[i]) ph *= phases[i];
        flat += gi * stride[i];
      }
      gidx[L] = li.c * Ncomp + flat;
      pf[L] = ph;
    }
    scatter_dense(A, N, gidx, pf, A_loc);
    scatter_dense(M, N, gidx, pf, M_loc);
  }
  return 0;
}

// Periodic structured dof index helper (mesh bookkeeping, SURVEY.md
// §2.1 #2): fills gidx[nelem * nloc] with global dof indices for the
// H1 space — exposed for tools/tests.
int bh_h1_dof_map(int dim, const int64_t* shape, int p, int64_t* gidx) {
  const int p1 = p + 1;
  std::vector<int64_t> Nd(dim);
  int64_t nelem = 1;
  for (int i = 0; i < dim; ++i) {
    Nd[i] = shape[i] * p;
    nelem *= shape[i];
  }
  std::vector<int64_t> stride(dim, 1);
  for (int i = dim - 2; i >= 0; --i) stride[i] = stride[i + 1] * Nd[i + 1];
  std::vector<int> eshape(dim);
  for (int i = 0; i < dim; ++i) eshape[i] = (int)shape[i];
  MultiIdx eit(eshape);
  int64_t out = 0;
  for (int64_t e = 0; e < nelem; ++e, eit.step()) {
    MultiIdx li(std::vector<int>(dim, p1));
    const int64_t nL = li.count();
    for (int64_t L = 0; L < nL; ++L, li.step()) {
      int64_t flat = 0;
      for (int i = 0; i < dim; ++i) {
        flat += (((int64_t)eit.idx[i] * p + li.idx[i]) % Nd[i]) * stride[i];
      }
      gidx[out++] = flat;
    }
  }
  return 0;
}

}  // extern "C"
