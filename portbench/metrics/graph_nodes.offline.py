"""graph_nodes.offline: the nodes (kernel and other) of the engine's
captured step, read through libcuda (`cuGraphGetNodes` on the graph kept by
`keep_graph=True`); a count that repeats exactly."""
import ctypes


def read(src):
    graph = src["engine"].graph
    if graph is None:
        return None
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    return float(n.value)
