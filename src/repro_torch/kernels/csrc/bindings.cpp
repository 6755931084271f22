// Python module of the kernels' C launchers, for the
// torch.utils.cpp_extension.load route of repro_torch/kernels/_build.py.
// Pointers and the stream arrive as integers, so this file needs pybind11
// alone and none of PyTorch's headers.
#include <pybind11/pybind11.h>

#include <cstdint>

extern "C" int fold_in_launch(const void* words, const void* valid,
                              const void* z0, const void* u, const void* phi,
                              void* out, void* scratch, float alpha, int D,
                              int L, int T, int J, int sweeps, void* stream);

extern "C" int fold_in_smem_bytes(int L, int T);

extern "C" int fold_in_scratch_bytes(int L, int T);

extern "C" int fused_sweep_launch(
    const void* tok_doc, const void* tok_wrd, const void* tok_valid,
    const void* tok_bound, void* z, const void* u, const void* cot,
    const void* dto, void* n_td, void* n_wt, void* n_t, void* F,
    void* topics, void* counts, void* scratch, int W, int C, int S,
    int n_tiles, int tile, int tile_start, int num_tiles, int r, int k,
    int I_max, int J_max, int T, int cap, int dtile, int n_dt, int doc_rows,
    float alpha, float beta, float beta_bar, void* stream);

extern "C" int fused_sweep_smem_bytes(int T, int cap, int doc_rows,
                                      int sparse);

extern "C" int fused_sweep_scratch_bytes(int T, int cap, int doc_rows,
                                         int sparse);

extern "C" int fused_sweep_placement(int T, int cap, int doc_rows,
                                     int sparse);

extern "C" int lda_scores_launch(const void* n_td, const void* n_wt,
                                 const void* n_t, const void* u,
                                 const void* doc_row, const void* wrd_row,
                                 const void* nt_row, const void* z_in,
                                 void* z_out, void* norm, void* levels,
                                 int slots, std::int64_t N, int T,
                                 float alpha, float beta, float beta_bar,
                                 int smem, void* stream);

extern "C" int ftree_sample_launch(const void* F, const void* u01, void* z,
                                   std::int64_t N, int T, void* stream);

extern "C" int ftree_update_launch(const void* F, const void* ts,
                                   const void* deltas, void* out, int K,
                                   int T, void* stream);

namespace {
void* ptr(std::uintptr_t p) { return reinterpret_cast<void*>(p); }
}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fold_in_launch",
        [](std::uintptr_t words, std::uintptr_t valid, std::uintptr_t z0,
           std::uintptr_t u, std::uintptr_t phi, std::uintptr_t out,
           std::uintptr_t scratch, float alpha, int D, int L, int T, int J,
           int sweeps, std::uintptr_t stream) {
          return fold_in_launch(ptr(words), ptr(valid), ptr(z0), ptr(u),
                                ptr(phi), ptr(out), ptr(scratch), alpha, D,
                                L, T, J, sweeps, ptr(stream));
        });
  m.def("fold_in_smem_bytes", &fold_in_smem_bytes);
  m.def("fold_in_scratch_bytes", &fold_in_scratch_bytes);
  m.def("fused_sweep_launch",
        [](std::uintptr_t tok_doc, std::uintptr_t tok_wrd,
           std::uintptr_t tok_valid, std::uintptr_t tok_bound,
           std::uintptr_t z, std::uintptr_t u, std::uintptr_t cot,
           std::uintptr_t dto, std::uintptr_t n_td, std::uintptr_t n_wt,
           std::uintptr_t n_t, std::uintptr_t F, std::uintptr_t topics,
           std::uintptr_t counts, std::uintptr_t scratch, int W, int C,
           int S, int n_tiles, int tile, int tile_start, int num_tiles, int r,
           int k, int I_max, int J_max, int T, int cap, int dtile, int n_dt,
           int doc_rows, float alpha, float beta, float beta_bar,
           std::uintptr_t stream) {
          return fused_sweep_launch(
              ptr(tok_doc), ptr(tok_wrd), ptr(tok_valid), ptr(tok_bound),
              ptr(z), ptr(u), ptr(cot), ptr(dto), ptr(n_td), ptr(n_wt),
              ptr(n_t), ptr(F), ptr(topics), ptr(counts), ptr(scratch), W, C,
              S, n_tiles, tile, tile_start, num_tiles, r, k, I_max, J_max, T,
              cap, dtile, n_dt, doc_rows, alpha, beta, beta_bar, ptr(stream));
        });
  m.def("fused_sweep_smem_bytes", &fused_sweep_smem_bytes);
  m.def("fused_sweep_scratch_bytes", &fused_sweep_scratch_bytes);
  m.def("fused_sweep_placement", &fused_sweep_placement);
  m.def("lda_scores_launch",
        [](std::uintptr_t n_td, std::uintptr_t n_wt, std::uintptr_t n_t,
           std::uintptr_t u, std::uintptr_t doc_row, std::uintptr_t wrd_row,
           std::uintptr_t nt_row, std::uintptr_t z_in,
           std::uintptr_t z_out, std::uintptr_t norm, std::uintptr_t levels,
           int slots, std::int64_t N, int T, float alpha, float beta,
           float beta_bar, int smem, std::uintptr_t stream) {
          return lda_scores_launch(
              ptr(n_td), ptr(n_wt), ptr(n_t), ptr(u), ptr(doc_row),
              ptr(wrd_row), ptr(nt_row), ptr(z_in), ptr(z_out), ptr(norm),
              ptr(levels), slots, N, T, alpha, beta, beta_bar, smem,
              ptr(stream));
        });
  m.def("ftree_sample_launch",
        [](std::uintptr_t F, std::uintptr_t u01, std::uintptr_t z,
           std::int64_t N, int T, std::uintptr_t stream) {
          return ftree_sample_launch(ptr(F), ptr(u01), ptr(z), N, T,
                                     ptr(stream));
        });
  m.def("ftree_update_launch",
        [](std::uintptr_t F, std::uintptr_t ts, std::uintptr_t deltas,
           std::uintptr_t out, int K, int T, std::uintptr_t stream) {
          return ftree_update_launch(ptr(F), ptr(ts), ptr(deltas), ptr(out),
                                     K, T, ptr(stream));
        });
}
