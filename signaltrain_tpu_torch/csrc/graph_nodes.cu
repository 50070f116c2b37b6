// The device nodes of the CUDA graph being captured on a stream.
//
// utils/profiling.py marks the train step's phases while the step is
// captured into a CUDA graph (training/graphs.py): each mark records how many
// nodes the graph holds so far that run on the card and that CUPTI traces as
// device events (kernels, memcpys, memsets), child graphs counted through.
// A replay of a single-stream capture runs those nodes in capture order, so
// the marks split each replay's device events by position, whatever the
// kernels are called. Nothing here launches or adds anything: the driver API
// permits every call but destroy and node removal on a graph while its
// capture is in progress.

#include <cuda.h>

#include <vector>

namespace {

constexpr int NOT_CAPTURING = -1;

CUresult device_nodes(CUgraph graph, long long* count) {
  size_t n = 0;
  CUresult r = cuGraphGetNodes(graph, nullptr, &n);
  if (r != CUDA_SUCCESS || n == 0) return r;
  std::vector<CUgraphNode> nodes(n);
  r = cuGraphGetNodes(graph, nodes.data(), &n);
  if (r != CUDA_SUCCESS) return r;
  for (size_t i = 0; i < n; ++i) {
    CUgraphNodeType type;
    r = cuGraphNodeGetType(nodes[i], &type);
    if (r != CUDA_SUCCESS) return r;
    if (type == CU_GRAPH_NODE_TYPE_KERNEL || type == CU_GRAPH_NODE_TYPE_MEMCPY ||
        type == CU_GRAPH_NODE_TYPE_MEMSET) {
      ++*count;
    } else if (type == CU_GRAPH_NODE_TYPE_GRAPH) {
      CUgraph child;
      r = cuGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (r == CUDA_SUCCESS) r = device_nodes(child, count);
      if (r != CUDA_SUCCESS) return r;
    }
  }
  return CUDA_SUCCESS;
}

}  // namespace

extern "C" {

const char* st_error_string(int code) {
  if (code == NOT_CAPTURING) return "the stream is not capturing a CUDA graph";
  const char* s = nullptr;
  cuGetErrorString((CUresult)code, &s);
  return s != nullptr ? s : "unknown CUDA driver error";
}

// *count = the device nodes (kernel, memcpy, memset; through child graphs) of
// the graph being captured on stream. Returns a CUresult, or NOT_CAPTURING.
int st_capture_device_nodes(void* stream, long long* count) {
  CUstreamCaptureStatus status;
  CUgraph graph = nullptr;
#if CUDA_VERSION >= 13000
  CUresult r = cuStreamGetCaptureInfo((CUstream)stream, &status, nullptr, &graph, nullptr,
                                      nullptr, nullptr);
#else
  CUresult r = cuStreamGetCaptureInfo((CUstream)stream, &status, nullptr, &graph, nullptr,
                                      nullptr);
#endif
  if (r != CUDA_SUCCESS) return (int)r;
  if (status != CU_STREAM_CAPTURE_STATUS_ACTIVE || graph == nullptr) return NOT_CAPTURING;
  *count = 0;
  return (int)device_nodes(graph, count);
}

}  // extern "C"
