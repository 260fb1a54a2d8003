// What the runtime knows of one kernel instance at its launch configuration,
// for the kernel audit (src/repro_torch/analysis/kernel_audit.py). Every
// source exports `<name>_instance(i, arg, out, name)`, which picks its i-th
// instance and the threads and dynamic shared memory its launcher gives it,
// and calls query() below. The audit holds these numbers against sm_90's
// limits and each kernel's __launch_bounds__, and the instance's name against
// ptxas's -v lines for it.
#pragma once

#include <cuda_runtime.h>

namespace introspect {

// out[] fields, in order
enum Field {
  kRegs,            // registers per thread
  kLocalBytes,      // local memory per thread (stack frame and spills)
  kStaticSmem,      // static shared memory per block
  kMaxThreads,      // most threads a block of this instance may have
  kDynSmem,         // dynamic shared memory the launcher gives a block
  kThreadsField,    // threads per block the launcher uses
  kBlocksPerSm,     // resident blocks per SM at that launch
  kSms,             // SMs of the current device
  kCluster,         // cluster size asked about (1: no cluster)
  kClusters,        // clusters resident on the device at once (0 when kCluster is 1)
  kPtx,             // PTX version the instance was compiled for (e.g. 90)
  kBinary,          // binary version (e.g. 90)
  kFields
};

// Fills out[kFields] for kernel `fn` launched with `threads` threads and
// `dyn_smem` bytes of dynamic shared memory (set as the launcher sets it),
// and, for cluster > 1, how many clusters of that size fit on the device at
// once. *name gets the instance's mangled name where the runtime can give it
// (cudaFuncGetName, CUDA 12.3 on), else "". Returns the CUDA error, 0 if none.
inline int query(const void* fn, int threads, int dyn_smem, int cluster, int* out,
                 const char** name) {
  *name = "";
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e == cudaSuccess && dyn_smem > 0)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
  int dev = 0, per_sm = 0, sms = 0, clusters = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, dyn_smem);
  if (e == cudaSuccess && cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster * sms, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = dyn_smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  }
#if CUDART_VERSION >= 12030
  if (e == cudaSuccess) {
    const char* n = nullptr;
    if (cudaFuncGetName(&n, fn) == cudaSuccess && n != nullptr) *name = n;
  }
#endif
  cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  out[kRegs] = a.numRegs;
  out[kLocalBytes] = static_cast<int>(a.localSizeBytes);
  out[kStaticSmem] = static_cast<int>(a.sharedSizeBytes);
  out[kMaxThreads] = a.maxThreadsPerBlock;
  out[kDynSmem] = dyn_smem;
  out[kThreadsField] = threads;
  out[kBlocksPerSm] = per_sm;
  out[kSms] = sms;
  out[kCluster] = cluster > 1 ? cluster : 1;
  out[kClusters] = clusters;
  out[kPtx] = a.ptxVersion;
  out[kBinary] = a.binaryVersion;
  return 0;
}

}  // namespace introspect
