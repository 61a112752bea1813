// A CUDA device guard that does nothing, for a PyTorch built without
// CUDA: fake CUDA tensors (repro_torch.launch.dryrun) enter a device
// guard on views, copies and indexing, and a CPU build registers none.
// PyTorch's CUDA builds register the same guard themselves when no card
// is visible (torch._C._ensureCUDADeviceGuardSet).  Loading this library
// registers it; nothing runs on any device.
#include <c10/core/impl/DeviceGuardImplInterface.h>

namespace {
C10_REGISTER_GUARD_IMPL(CUDA,
                        c10::impl::NoOpDeviceGuardImpl<c10::DeviceType::CUDA>);
}
