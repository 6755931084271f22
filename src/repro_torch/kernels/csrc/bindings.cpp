// Python module of the kernels' C launchers, for the
// torch.utils.cpp_extension.load route of repro_torch/kernels/_build.py.
// Pointers and the stream arrive as integers, so this file needs pybind11
// alone and none of PyTorch's headers.
#include <pybind11/pybind11.h>

#include <cstdint>

extern "C" int fold_in_launch(const void* words, const void* valid,
                              const void* z0, const void* u, const void* phi,
                              void* out, float alpha, int D, int L, int T,
                              int J, int sweeps, int smem, void* stream);

namespace {
void* ptr(std::uintptr_t p) { return reinterpret_cast<void*>(p); }
}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fold_in_launch",
        [](std::uintptr_t words, std::uintptr_t valid, std::uintptr_t z0,
           std::uintptr_t u, std::uintptr_t phi, std::uintptr_t out,
           float alpha, int D, int L, int T, int J, int sweeps, int smem,
           std::uintptr_t stream) {
          return fold_in_launch(ptr(words), ptr(valid), ptr(z0), ptr(u),
                                ptr(phi), ptr(out), alpha, D, L, T, J,
                                sweeps, smem, ptr(stream));
        });
}
