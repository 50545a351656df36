// K5s and K3s: the save-state variants of the hyper-connection width
// connection, replacing the TPU kernels e2_tts_tpu/ops/hyper_conn_kernel.py::
// _width_kernel_save and ::_width_fused_kernel_save. They are K5 / K3 (the
// Hopper design of hyper_conn_sm90.cuh on bf16 at 4 streams, the templates of
// hyper_conn.cuh otherwise) with the SAVE flag: the same outputs, bit for
// bit, plus ta (s, M, s+2) and the unrounded inv (s, M) for the adjoint.
// Entered from e2_hc_width / e2_hc_width_fused (hyper_conn.cu) when ta and
// inv are given.
#include "hyper_conn_sm90.cuh"

int e2_hc_width_save_run(const void* params, int s, int fused, int dtype, void* stream) {
  return width_run<true>(*static_cast<const HcParams*>(params), s, fused != 0, dtype, stream);
}
