// CUDA build of the BVH walks (bvh_walk.h) as XLA FFI handlers: one thread
// per ray in 128-thread blocks, the per-ray stack in local memory, node and
// triangle records read as float4/int4 through the read-only path.  The
// handlers only enqueue on the stream XLA hands them.
#include <cuda_runtime.h>

#include "bvh_walk.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;

template <typename B>
int64_t count(const B &b) {
    return static_cast<int64_t>(b.element_count());
}

int *stats_ptr(ffi::Result<ffi::Buffer<ffi::S32>> &b) {
    return b->element_count() ? b->typed_data() : nullptr;
}

template <int STACK>
__global__ void __launch_bounds__(kBlock)
    closest_kernel(rtjax::ClosestArgs a, int64_t n) {
    int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
    if (i < n) rtjax::closest_ray<STACK>(a, i);
}

template <int STACK>
__global__ void __launch_bounds__(kBlock)
    anyhit_kernel(rtjax::AnyhitArgs a, int64_t n) {
    int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
    if (i < n) rtjax::anyhit_ray<STACK>(a, i);
}

ffi::Error launched() {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess)
        return ffi::Error::Internal(cudaGetErrorString(err));
    return ffi::Error::Success();
}

unsigned blocks(int64_t n) {
    return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

ffi::Error Closest(cudaStream_t stream, ffi::Buffer<ffi::S32> nodes,
                   ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> ox,
                   ffi::Buffer<ffi::F32> oy, ffi::Buffer<ffi::F32> oz,
                   ffi::Buffer<ffi::F32> dx, ffi::Buffer<ffi::F32> dy,
                   ffi::Buffer<ffi::F32> dz, ffi::Buffer<ffi::F32> tmax,
                   ffi::Buffer<ffi::PRED> active,
                   ffi::Result<ffi::Buffer<ffi::PRED>> hit,
                   ffi::Result<ffi::Buffer<ffi::F32>> t,
                   ffi::Result<ffi::Buffer<ffi::S32>> prim,
                   ffi::Result<ffi::Buffer<ffi::F32>> nx,
                   ffi::Result<ffi::Buffer<ffi::F32>> ny,
                   ffi::Result<ffi::Buffer<ffi::F32>> nz,
                   ffi::Result<ffi::Buffer<ffi::S32>> steps,
                   ffi::Result<ffi::Buffer<ffi::S32>> leafs,
                   int64_t stack_size) {
    rtjax::ClosestArgs a = {
        reinterpret_cast<const int4 *>(nodes.typed_data()),
        reinterpret_cast<const float4 *>(tris.typed_data()),
        ox.typed_data(), oy.typed_data(), oz.typed_data(),
        dx.typed_data(), dy.typed_data(), dz.typed_data(),
        tmax.typed_data(), active.typed_data(),
        hit->typed_data(), t->typed_data(), prim->typed_data(),
        nx->typed_data(), ny->typed_data(), nz->typed_data(),
        stats_ptr(steps), stats_ptr(leafs)};
    int64_t n = count(tmax);
    if (n == 0) return ffi::Error::Success();
#define RTJAX_CASE(S)                                                   \
    if (stack_size == S) {                                              \
        closest_kernel<S><<<blocks(n), kBlock, 0, stream>>>(a, n);      \
        return launched();                                              \
    }
    RTJAX_FOR_EACH_STACK(RTJAX_CASE)
#undef RTJAX_CASE
    return ffi::Error::InvalidArgument("unsupported stack_size");
}

ffi::Error Anyhit(cudaStream_t stream, ffi::Buffer<ffi::S32> nodes,
                  ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> ox,
                  ffi::Buffer<ffi::F32> oy, ffi::Buffer<ffi::F32> oz,
                  ffi::Buffer<ffi::F32> dx, ffi::Buffer<ffi::F32> dy,
                  ffi::Buffer<ffi::F32> dz, ffi::Buffer<ffi::F32> tmax,
                  ffi::Buffer<ffi::S32> exclude, ffi::Buffer<ffi::PRED> active,
                  ffi::Result<ffi::Buffer<ffi::PRED>> occluded,
                  ffi::Result<ffi::Buffer<ffi::S32>> steps,
                  ffi::Result<ffi::Buffer<ffi::S32>> leafs,
                  int64_t stack_size) {
    rtjax::AnyhitArgs a = {
        reinterpret_cast<const int4 *>(nodes.typed_data()),
        reinterpret_cast<const float4 *>(tris.typed_data()),
        ox.typed_data(), oy.typed_data(), oz.typed_data(),
        dx.typed_data(), dy.typed_data(), dz.typed_data(),
        tmax.typed_data(), exclude.typed_data(), active.typed_data(),
        occluded->typed_data(), stats_ptr(steps), stats_ptr(leafs)};
    int64_t n = count(tmax);
    if (n == 0) return ffi::Error::Success();
#define RTJAX_CASE(S)                                                   \
    if (stack_size == S) {                                              \
        anyhit_kernel<S><<<blocks(n), kBlock, 0, stream>>>(a, n);       \
        return launched();                                              \
    }
    RTJAX_FOR_EACH_STACK(RTJAX_CASE)
#undef RTJAX_CASE
    return ffi::Error::InvalidArgument("unsupported stack_size");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    RtjaxClosestCuda, Closest,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()   // nodes [M, 8]
        .Arg<ffi::Buffer<ffi::F32>>()   // tris [P, 12]
        .Arg<ffi::Buffer<ffi::F32>>()   // ox
        .Arg<ffi::Buffer<ffi::F32>>()   // oy
        .Arg<ffi::Buffer<ffi::F32>>()   // oz
        .Arg<ffi::Buffer<ffi::F32>>()   // dx
        .Arg<ffi::Buffer<ffi::F32>>()   // dy
        .Arg<ffi::Buffer<ffi::F32>>()   // dz
        .Arg<ffi::Buffer<ffi::F32>>()   // tmax
        .Arg<ffi::Buffer<ffi::PRED>>()  // active
        .Ret<ffi::Buffer<ffi::PRED>>()  // hit
        .Ret<ffi::Buffer<ffi::F32>>()   // t
        .Ret<ffi::Buffer<ffi::S32>>()   // prim
        .Ret<ffi::Buffer<ffi::F32>>()   // nx
        .Ret<ffi::Buffer<ffi::F32>>()   // ny
        .Ret<ffi::Buffer<ffi::F32>>()   // nz
        .Ret<ffi::Buffer<ffi::S32>>()   // steps (empty: not counted)
        .Ret<ffi::Buffer<ffi::S32>>()   // leafs (empty: not counted)
        .Attr<int64_t>("stack_size"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    RtjaxAnyhitCuda, Anyhit,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()   // nodes [M, 8]
        .Arg<ffi::Buffer<ffi::F32>>()   // tris [P, 12]
        .Arg<ffi::Buffer<ffi::F32>>()   // ox
        .Arg<ffi::Buffer<ffi::F32>>()   // oy
        .Arg<ffi::Buffer<ffi::F32>>()   // oz
        .Arg<ffi::Buffer<ffi::F32>>()   // dx
        .Arg<ffi::Buffer<ffi::F32>>()   // dy
        .Arg<ffi::Buffer<ffi::F32>>()   // dz
        .Arg<ffi::Buffer<ffi::F32>>()   // tmax
        .Arg<ffi::Buffer<ffi::S32>>()   // exclude
        .Arg<ffi::Buffer<ffi::PRED>>()  // active
        .Ret<ffi::Buffer<ffi::PRED>>()  // occluded
        .Ret<ffi::Buffer<ffi::S32>>()   // steps (empty: not counted)
        .Ret<ffi::Buffer<ffi::S32>>()   // leafs (empty: not counted)
        .Attr<int64_t>("stack_size"));
